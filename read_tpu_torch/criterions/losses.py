"""Pixel losses and quality metrics of the training step.

Counterpart of ``read_tpu/criterions/losses.py:28-137``: ``huber_loss``,
``l1_loss``, ``cross_entropy_ignore0``, ``masked_background_loss``,
``psnr`` and ``ssim`` (11x11 Gaussian window, sigma 1.5, VALID, with
the variance and covariance clamps). Images are NHWC ``[B, H, W, C]``
float32, as in JAX; ``per_item=True`` reduces all but the batch axis.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["huber_loss", "l1_loss", "cross_entropy_ignore0",
           "masked_background_loss", "psnr", "ssim"]


def _mean(v: torch.Tensor, per_item: bool) -> torch.Tensor:
    return v.reshape(v.shape[0], -1).mean(dim=1) if per_item else v.mean()


def huber_loss(pred: torch.Tensor, target: torch.Tensor, delta: float = 1.0,
               per_item: bool = False) -> torch.Tensor:
    """``0.5 e^2`` where ``|e| < delta``, else ``delta (|e| - delta/2)``;
    mean reduction."""
    err = pred - target
    abs_err = err.abs()
    v = torch.where(abs_err < delta, 0.5 * torch.square(err),
                    delta * (abs_err - 0.5 * delta))
    return _mean(v, per_item)


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def cross_entropy_ignore0(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Softmax cross entropy over the channel axis of ``logits [B, H, W,
    C]``, ignoring label 0 of ``labels [B, H, W]``."""
    logp = F.log_softmax(logits, dim=-1)
    valid = labels > 0
    safe = torch.where(valid, labels, 0).long()
    picked = torch.gather(logp, -1, safe.unsqueeze(-1))[..., 0]
    n = valid.sum().clamp(min=1)
    return -(picked * valid).sum() / n


def masked_background_loss(pred: torch.Tensor, mask: torch.Tensor,
                           bkg_color=(0.0, 0.0, 0.0),
                           weight: float = 500.0) -> torch.Tensor:
    """``weight * mean(|(pred - bkg) * (1 - mask)|)`` for ``pred [B, H,
    W, 3]`` and ``mask [B, H, W, 1]``: the pull of outside-mask pixels
    toward the background color."""
    bkg = torch.tensor(bkg_color, dtype=pred.dtype, device=pred.device)
    return weight * torch.mean(torch.abs((pred - bkg) * (1.0 - mask)))


def psnr(pred: torch.Tensor, target: torch.Tensor,
         per_item: bool = False) -> torch.Tensor:
    """``-10 log10(mse)`` with ``pred`` clipped to [0, 1]."""
    se = torch.square(torch.clamp(pred, 0.0, 1.0) - target)
    return -10.0 * torch.log10(torch.clamp(_mean(se, per_item), min=1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-0.5 * (x / sigma) ** 2)
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5,
         per_item: bool = False) -> torch.Tensor:
    """Mean SSIM (Wang et al.) of ``[B, H, W, C]`` images over the VALID
    windows, with variances clamped to >= 0 and the covariance to the
    Cauchy-Schwarz bound, so every window's score lies in [-1, 1]."""
    c = pred.shape[-1]
    k = torch.from_numpy(_gaussian_kernel(kernel_size, sigma)).to(
        pred.device)
    kern = k[None, None].expand(c, 1, kernel_size, kernel_size)

    def blur(x):
        return F.conv2d(x.permute(0, 3, 1, 2), kern, groups=c)

    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_p = blur(pred)
    mu_t = blur(target)
    mu_pp = torch.clamp(blur(pred * pred) - mu_p * mu_p, min=0.0)
    mu_tt = torch.clamp(blur(target * target) - mu_t * mu_t, min=0.0)
    cs_bound = torch.sqrt(mu_pp * mu_tt)
    mu_pt = torch.clamp(blur(pred * target) - mu_p * mu_t, -cs_bound,
                        cs_bound)
    num = (2 * mu_p * mu_t + c1) * (2 * mu_pt + c2)
    den = (mu_p ** 2 + mu_t ** 2 + c1) * (mu_pp + mu_tt + c2)
    return _mean(num / den, per_item)
