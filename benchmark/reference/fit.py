"""One fitting step of READ's texture pipeline, plainly, and its first
three steps from a given start.

A step: the exact raster pyramid of the batch's views (no gradient), the
descriptor gather, the UNet in training form, the loss ``1e4 *
huber(im, target) + vgg(im, target)``, gradients of the net's trainable
parameters and of the descriptor table, the guard (NaN to 0, +-inf and
beyond to +-``clip``), Adam on the net (``b1`` 0.9, ``b2`` 0.999, eps
1e-8, bias corrections ``1 - b**t`` in float32, update ``-m_hat /
(sqrt(v_hat) + eps)``) and RMSprop on the table (decay 0.99, eps 1e-8,
``nu`` from 0, update ``-g * rsqrt(nu + eps)``), each scaled by its
learning rate.

The VGG loss is the 13-conv VGG19 prefix through conv5_1 with 2x2
average pools after convs 2, 4, 8 and 12, on 'caffe'-normalized inputs
(``(x - mean_bgr / 255) * 255``, the means applied to RGB channels as
READ does), the L1 distance of each of the 13 ReLU outputs averaged and
summed; the target side runs without gradient.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import raster, unet
from benchmark.reference.prec import conv2d, full_f32

__all__ = ["VGG_CHANNELS", "vgg_loss", "huber", "run_steps"]

VGG_CHANNELS = (64, 64, 128, 128, 256, 256, 256, 256, 512, 512, 512, 512,
                512)
_POOL_AFTER = frozenset({2, 4, 8, 12})
_CAFFE_MEAN = np.array([103.939, 116.779, 123.680], np.float32) / 255.0
HUBER_RATIO = 1e4
# running statistics move, they are not trained
_STATS = ("norm.mean", "norm.var")


def _vgg_taps(vgg, x: torch.Tensor, prec: str) -> List[torch.Tensor]:
    h = ((x - torch.from_numpy(_CAFFE_MEAN).to(x.device)) * 255.0
         ).permute(0, 3, 1, 2)
    taps = []
    for i, (w, b) in enumerate(vgg, start=1):
        h = F.relu(conv2d(h, w.permute(3, 2, 0, 1), b, 1, 1, prec))
        taps.append(h)
        if i in _POOL_AFTER:
            h = F.avg_pool2d(h, 2)
    return taps


def vgg_loss(vgg, pred: torch.Tensor, target: torch.Tensor,
             prec: str = "f32") -> torch.Tensor:
    fp = _vgg_taps(vgg, pred, prec)
    with torch.no_grad():
        ft = _vgg_taps(vgg, target, prec)
    loss = 0.0
    for a, b in zip(fp, ft):
        loss = loss + torch.abs(a - b).mean()
    return loss


def huber(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    err = pred - target
    a = err.abs()
    return torch.where(a < 1.0, 0.5 * torch.square(err), a - 0.5).mean()


def _guard(g: torch.Tensor, clip: float) -> torch.Tensor:
    return torch.nan_to_num(g, nan=0.0, posinf=clip,
                            neginf=-clip).clamp(-clip, clip)


def _bias_correction(decay: float, count: int) -> float:
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def run_steps(params: Dict[str, torch.Tensor], table: torch.Tensor,
              xyz: torch.Tensor, batches: Sequence[dict], vgg, *, lr: float,
              texture_lr: float, levels: int, grad_clip: float = 1e3,
              prec: str = "f32") -> dict:
    """The steps of ``batches`` (each ``total_m [B, 4, 4]``, ``target
    [B, h, w, 3]``) from ``params`` (every parameter and running
    statistic, as :func:`benchmark.reference.unet.param_shapes` names
    them) and ``table [N, C]``. Returns each step's loss, the guarded
    first gradient of each leaf (its norm), and each leaf's change over
    all the steps (its norm). Leaves are the trainable parameters by name
    and ``'texture'``. Nothing given is changed."""
    names = [k for k in params if not k.endswith(_STATS)]
    p = {k: v.detach().clone() for k, v in params.items()}
    tex = table.detach().clone()
    mu = {k: torch.zeros_like(p[k]) for k in names}
    nu = {k: torch.zeros_like(p[k]) for k in names}
    tex_nu = torch.zeros_like(tex)
    losses, first = [], None
    with full_f32():
        for step, batch in enumerate(batches, start=1):
            total_m, target = batch["total_m"], batch["target"]
            h, w = target.shape[1:3]
            leaves = {k: p[k].requires_grad_() for k in names}
            t = tex.requires_grad_()
            pyr = raster.pyramid(xyz, total_m, h, w, levels)
            maps = [raster.gather(t, ix) for ix, _ in pyr]
            im = unet.forward({**p, **leaves}, maps, train=True, prec=prec)
            loss = HUBER_RATIO * huber(im, target) \
                + vgg_loss(vgg, im, target, prec)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names]
                                        + [t])
            losses.append(float(loss.detach()))
            with torch.no_grad():
                g = {k: _guard(gi, grad_clip) for k, gi in zip(names, grads)}
                g_tex = _guard(grads[-1], grad_clip)
                if first is None:
                    first = {k: float(torch.linalg.vector_norm(v))
                             for k, v in g.items()}
                    first["texture"] = float(torch.linalg.vector_norm(g_tex))
                c1 = _bias_correction(0.9, step)
                c2 = _bias_correction(0.999, step)
                for k in names:
                    mu[k] = (1 - 0.9) * g[k] + 0.9 * mu[k]
                    nu[k] = (1 - 0.999) * (g[k] * g[k]) + 0.999 * nu[k]
                    up = -((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + 1e-8))
                    p[k] = p[k].detach() + lr * up
                tex_nu = (1 - 0.99) * (g_tex * g_tex) + 0.99 * tex_nu
                tex = tex.detach() + texture_lr * -(
                    torch.rsqrt(tex_nu + 1e-8) * g_tex)
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(p[k] - params[k]))
                  for k in names}
        change["texture"] = float(torch.linalg.vector_norm(tex - table))
    return {"losses": losses, "first_grad": first, "change": change}
