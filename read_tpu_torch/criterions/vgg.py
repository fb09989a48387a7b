"""The VGG19 perceptual loss of the training step.

Counterpart of ``read_tpu/criterions/vgg.py:38-222``: the
13-conv VGG19 prefix (through conv5_1) with 2x2 **average** pools after
convs 2, 4, 8 and 12, the L1 distance summed over the 13 ReLU taps,
the 'caffe' input normalization (BGR-ordered means applied to RGB
channels, the reference's quirk, kept) and the 'pytorch' one, the
partial first conv of the masked variant, ``vgg_loss_ens`` (the mean
over an ensemble of weight sets, ``--criterion vgg_ens``) and
``vgg_loss_mix``.

Parameters are a list of 13 ``(w [3, 3, Cin, Cout] HWIO, b [Cout])``
tensors, as in JAX; each conv runs as ``F.conv2d`` with the kernel
permuted at the call. Without a weights file the network is random:
:func:`random_vgg_params` draws He-normal weights from a
``torch.Generator`` (not the numbers of ``jax.random``; to reproduce a
JAX run, carry its ``random_vgg_params`` across with
:func:`read_tpu_torch.utils.convert.vgg_params_from_numpy`).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from read_tpu_torch.utils import fp32

__all__ = ["VGG_CHANNELS", "random_vgg_params", "load_vgg_params",
           "partial_conv2d", "vgg19_features", "vgg_loss", "vgg_loss_ens",
           "vgg_loss_mix"]

VggParams = List[Tuple[torch.Tensor, torch.Tensor]]

# Conv output channels of the first 13 convs (through conv5_1), with the
# pools after convs 2, 4, 8 and 12 (1-based), as in VGG19.
VGG_CHANNELS = (64, 64, 128, 128, 256, 256, 256, 256, 512, 512, 512, 512,
                512)
_POOL_AFTER = frozenset({2, 4, 8, 12})

# The reference's normalization constants, computed as JAX computes them.
_CAFFE_MEAN = np.array([103.939, 116.779, 123.680], np.float32) / 255.0
_PYTORCH_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_PYTORCH_STD = np.array([0.229, 0.224, 0.225], np.float32)


def random_vgg_params(generator: torch.Generator,
                      device="cuda") -> VggParams:
    """A He-normal random VGG19 conv stack (biases 0) from
    ``generator``."""
    params, cin = [], 3
    for cout in VGG_CHANNELS:
        w = torch.randn((3, 3, cin, cout), generator=generator)
        w = w * float(np.sqrt(2.0 / (9 * cin)))
        params.append((w.to(device), torch.zeros(cout, device=device)))
        cin = cout
    return params


def load_vgg_params(weights_path: str, device="cuda") -> VggParams:
    """VGG19 conv weights from ``.npz`` (keys ``conv{i}_w`` HWIO and
    ``conv{i}_b``) or from a torch VGG19 state dict (``features.*``,
    OIHW, converted to HWIO)."""
    if weights_path.endswith(".npz"):
        with np.load(weights_path) as data:
            pairs = [(data[f"conv{i}_w"], data[f"conv{i}_b"])
                     for i in range(len(VGG_CHANNELS))]
        return [(torch.from_numpy(np.array(w, np.float32)).to(device),
                 torch.from_numpy(np.array(b, np.float32)).to(device))
                for w, b in pairs]
    # tensors only: a pickled whole model would run code on load
    sd = torch.load(weights_path, map_location="cpu", weights_only=True)
    conv_keys = sorted(
        (k for k in sd if k.endswith(".weight") and sd[k].dim() == 4),
        key=lambda k: int("".join(c for c in k if c.isdigit()) or 0))
    params = []
    for wk in conv_keys[:len(VGG_CHANNELS)]:
        w = sd[wk].float().permute(2, 3, 1, 0).contiguous()  # -> HWIO
        b = sd[wk.replace(".weight", ".bias")].float()
        params.append((w.to(device), b.to(device)))
    return params


def _normalize(x: torch.Tensor, backend: str) -> torch.Tensor:
    if backend == "caffe":
        return (x - torch.from_numpy(_CAFFE_MEAN).to(x.device)) * 255.0
    if backend == "pytorch":
        return ((x - torch.from_numpy(_PYTORCH_MEAN).to(x.device))
                / torch.from_numpy(_PYTORCH_STD).to(x.device))
    raise ValueError(backend)


def _conv(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """'SAME' 3x3 conv of NCHW ``x`` with an HWIO kernel."""
    return F.conv2d(x, w.permute(3, 2, 0, 1), b,
                    padding=(w.shape[0] - 1) // 2)


def partial_conv2d(x: torch.Tensor, mask: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """NVIDIA partial convolution, single-channel mask, NCHW: the conv
    sees ``x * mask``, outputs are renormalized by ``winsize / (window
    occupancy)`` (bias excluded) and re-masked; no gradient flows
    through the mask."""
    kh, kw = w.shape[0], w.shape[1]
    with torch.no_grad():
        ones = torch.ones((kh, kw, 1, 1), dtype=x.dtype, device=x.device)
        upd = _conv(mask, ones)
        ratio = float(kh * kw) / (upd + 1e-8)
        upd_c = torch.clamp(upd, 0.0, 1.0)
        ratio = ratio * upd_c
    raw = _conv(x * mask, w) + b[:, None, None]
    bb = b[:, None, None]
    return ((raw - bb) * ratio + bb) * upd_c


def vgg19_features(params: VggParams, x: torch.Tensor,
                   backend: str = "caffe",
                   mask: Optional[torch.Tensor] = None
                   ) -> List[torch.Tensor]:
    """The 13 ReLU taps (NCHW) of ``x [B, H, W, 3]`` (RGB in [0, 1]);
    ``mask [B, H, W, 1]`` makes the first conv a partial conv."""
    h = _normalize(x, backend).permute(0, 3, 1, 2)
    m = None if mask is None else mask.permute(0, 3, 1, 2)
    taps = []
    for i, (w, b) in enumerate(params, start=1):
        if i == 1 and m is not None:
            h = partial_conv2d(h, m, w, b)
        else:
            h = _conv(h, w) + b[:, None, None]
        h = F.relu(h)
        taps.append(h)
        if i in _POOL_AFTER:
            h = F.avg_pool2d(h, 2)
    return taps


def vgg_loss(params: VggParams, pred: torch.Tensor, target: torch.Tensor,
             backend: str = "caffe", partialconv: bool = False,
             per_item: bool = False) -> torch.Tensor:
    """Sum over the 13 taps of the mean L1 distance between the
    features of ``pred`` and ``target`` (``[B, H, W, 3]``); the target
    side runs without gradient. ``partialconv`` masks both sides' first
    conv with ``target.sum(channels) > 1e-9``. ``per_item=True`` returns
    a ``[B]`` vector. The convolutions run in full float32
    (:func:`read_tpu_torch.utils.fp32.full_f32`), whatever the caller's
    TF32 flags; a backward pass the caller runs later follows the flags
    in force then (the training step runs its own inside ``full_f32``)."""
    with fp32.full_f32():
        mask = None
        if partialconv:
            mask = (target.sum(dim=-1, keepdim=True) > 1e-9).to(pred.dtype)
        fp = vgg19_features(params, pred, backend, mask=mask)
        with torch.no_grad():
            ft = vgg19_features(params, target, backend, mask=mask)
        loss = 0.0
        for a, b in zip(fp, ft):
            d = torch.abs(a - b)
            loss = loss + (d.flatten(1).mean(dim=1)
                           if per_item else d.mean())
        return loss


def vgg_loss_ens(params_list: List[VggParams], pred: torch.Tensor,
                 target: torch.Tensor, backend: str = "caffe",
                 partialconv: bool = False,
                 per_item: bool = False) -> torch.Tensor:
    """The mean of :func:`vgg_loss` over the weight sets of
    ``params_list`` (summed in order, then divided by their count, as
    ``read_tpu`` sums them)."""
    loss = None
    for params in params_list:
        one = vgg_loss(params, pred, target, backend=backend,
                       partialconv=partialconv, per_item=per_item)
        loss = one if loss is None else loss + one
    return loss / len(params_list)


def vgg_loss_mix(params_pytorch: VggParams, params_caffe: VggParams,
                 pred: torch.Tensor, target: torch.Tensor,
                 weight: float = 0.5,
                 per_item: bool = False) -> torch.Tensor:
    """``weight`` x the 'pytorch'-normalized loss + ``1 - weight`` x the
    'caffe'-normalized one (``VGGLossMix``); full float32, as
    :func:`vgg_loss`."""
    return (vgg_loss(params_pytorch, pred, target, "pytorch",
                     per_item=per_item) * weight
            + vgg_loss(params_caffe, pred, target, "caffe",
                       per_item=per_item) * (1.0 - weight))
