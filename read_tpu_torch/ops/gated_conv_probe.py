"""K8: the phase probe of K2 (``csrc/gated_conv_probe.cu``) and its twin.

Counterpart of ``scripts/probe_pack_split.py`` ``variant_kernel``
(:33-69): K2's own tile loops (``csrc/gated_conv_tile.cuh``) on a 3x3,
stride-1, zero-padded conv ``x [B, H, W, Cin] * w [3, 3, Cin, 2*Cout]``
(float32; ``bf16`` rounds the operands and takes K2's tensor-core tile,
as K2 does) with phases stripped, so the difference between the modes'
times bounds what staging and the multiply loop each cost. Output
``[B, H, W, 2*Cout]`` float32:

- ``full``: staging and multiply, the raw conv sums (no bias, no gate);
- ``nopack``: the multiply over shared memory never filled: it has no
  defined output and is for timing only (its twin raises);
- ``packonly``: staging alone; ``out[..., j]`` is the im2col tap matrix's
  column ``j`` (tap-major ``(ky, kx, ci)``) for ``j < min(2*Cout,
  9*Cin)``, zero beyond;
- ``nowin``: every tap reads the centre pixel (no halo staging), masked
  where the shifted tap would leave the image: ``sum_t mask_t * x @ W_t``.

The wrapper sends a CPU tensor to the twin and a CUDA tensor to the
kernel; ``launches`` counts kernel launches. The probe is on no path of
the port but the kernel bench.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from read_tpu_torch import _build
from read_tpu_torch.ops.gated_conv import round_bf16

__all__ = ["MODES", "gated_conv_probe", "gated_conv_probe_plain",
           "launches"]

MODES = ("full", "nopack", "packonly", "nowin")
launches = {"gated_conv_probe": 0}


def _taps(x: torch.Tensor):
    """The 9 zero-padded 3x3 taps of ``x [B, H, W, C]`` in (ky, kx)
    order, each ``[B, H, W, C]``, and their in-image masks ``[H, W]``."""
    _, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    ones = F.pad(torch.ones(h, w, dtype=x.dtype, device=x.device),
                 (1, 1, 1, 1))
    taps = [xp[:, ky:ky + h, kx:kx + w] for ky in range(3)
            for kx in range(3)]
    masks = [ones[ky:ky + h, kx:kx + w] for ky in range(3)
             for kx in range(3)]
    return taps, masks


def gated_conv_probe_plain(x: torch.Tensor, w: torch.Tensor, *,
                           mode: str = "full",
                           bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch twin of :func:`gated_conv_probe` for the modes with
    a defined output (``full``, ``packonly``, ``nowin``)."""
    if bf16:
        x, w = round_bf16(x), round_bf16(w)
    cin, c2 = w.shape[2], w.shape[3]
    if mode == "full":
        return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                        padding=1).permute(0, 2, 3, 1).contiguous()
    taps, masks = _taps(x)
    if mode == "packonly":
        cols = torch.cat(taps, dim=-1)[..., :min(c2, 9 * cin)]
        return F.pad(cols, (0, c2 - cols.shape[-1])).contiguous()
    if mode == "nowin":
        w9 = w.reshape(9, cin, c2)
        out = sum(masks[t][..., None] * torch.matmul(x, w9[t])
                  for t in range(9))
        return out.contiguous()
    raise ValueError(f"gated_conv_probe_plain: mode {mode!r} has no "
                     f"defined output; the twin takes full, packonly, nowin")


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def gated_conv_probe(x: torch.Tensor, w: torch.Tensor, *,
                     mode: str = "full", bf16: bool = False) -> torch.Tensor:
    """K8: ``x [B, H, W, Cin]``, ``w [3, 3, Cin, 2*Cout]`` float32 ->
    ``[B, H, W, 2*Cout]`` float32 by ``mode`` (see the module note)."""
    name = "gated_conv_probe"
    if mode not in MODES:
        raise ValueError(f"{name}: mode {mode!r} not in {MODES}")
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) \
            or w.shape[2] != x.shape[-1] or w.shape[3] % 2:
        raise ValueError(f"{name}: want x [B, H, W, Cin], w [3, 3, Cin, "
                         f"2*Cout]; got {tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"{name}: want float32 tensors")
    if x.device != w.device:
        raise ValueError(f"{name}: tensors on different devices")
    if x.device.type == "cpu":
        return gated_conv_probe_plain(x, w, mode=mode, bf16=bf16)
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name}: tensors must be contiguous")
    bsz, h, wd, cin = x.shape
    cout = w.shape[3] // 2
    alloc = torch.zeros if mode == "packonly" else torch.empty
    out = alloc((bsz, h, wd, 2 * cout), dtype=torch.float32,
                device=x.device)
    fn = _build.function("gated_conv_probe", name, _ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), bsz, h, wd, cin,
             cout, MODES.index(mode), int(bf16),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, name)
    launches[name] += 1
    return out
