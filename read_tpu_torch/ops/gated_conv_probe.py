"""K8: the phase probe of K2 (``csrc/gated_conv_probe.cu``) and its twin.

Counterpart of ``scripts/probe_pack_split.py`` ``variant_kernel``
(:33-69): K2's own loops on a 3x3, stride-1, zero-padded conv ``x [B, H,
W, Cin] * w [3, 3, Cin, 2*Cout]`` (float32; ``bf16`` rounds the operands
to bfloat16 and sums in float32, as K2 does) with phases stripped, so the
difference between the modes' times bounds what staging and the
multiply each cost. Output ``[B, H, W, 2*Cout]`` float32:

- ``full``: staging and multiply, the raw conv sums (no bias, no gate);
- ``nopack``: the multiply over shared memory never filled: it has no
  defined output and is for timing only (its twin raises);
- ``packonly``: staging alone; ``out[..., j]`` is the im2col tap matrix's
  column ``j`` (tap-major ``(ky, kx, ci)``) as the loop staged it, for
  ``j < min(2*Cout, 9*Cin)``, zero beyond;
- ``nowin``: every tap reads the centre pixel (no halo staging), masked
  where the shifted tap would leave the image: ``sum_t mask_t * x @ W_t``.

Two loops (``loop``), as K2 has: ``'wgmma'``, K2's wgmma loop
(``csrc/gated_conv_wgmma.cuh``) with the weight of
``ops.gated_conv.pack_kxk_bf16`` or ``pack_kxk_tf32`` (f32 operands as
three TF32 products, held to the f32 bound); ``'tile'``, the tile loops
K2 keeps for its other calls (``csrc/gated_conv_tile.cuh``). ``loop=None``
routes as K2 routes (:func:`probe_route`): ``Cin % 32 == 0``, ``Cout % 8
== 0`` and a 16-byte aligned ``x`` take the wgmma loop. Forcing
``'wgmma'`` where the loop cannot run raises. On the wgmma loop in f32,
``packonly`` is the sum ``hi + lo`` of the TF32 parts the consumer
splits the staged values into (``ops.gated_conv.tf32_split``), which the
twin computes too.

The wrapper sends a CPU tensor to the twin and a CUDA tensor to a kernel;
``launches['gated_conv_probe']`` counts every launch, ``_wgmma`` and
``_tile`` each loop's. The probe is on no path of the port but the kernel
bench.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from read_tpu_torch import _build
from read_tpu_torch.ops import gated_conv as GC

__all__ = ["MODES", "LOOPS", "gated_conv_probe", "gated_conv_probe_plain",
           "probe_route", "launches"]

MODES = ("full", "nopack", "packonly", "nowin")
LOOPS = ("tile", "wgmma")
launches = {"gated_conv_probe": 0, "gated_conv_probe_wgmma": 0,
            "gated_conv_probe_tile": 0}


def probe_route(x: torch.Tensor, w: torch.Tensor,
                loop: Optional[str] = None) -> str:
    """The loop K8 runs for ``x``, ``w``: ``loop`` where given, else K2's
    route (``ops.gated_conv.kxk_route`` with no epilogue tensors). Raise
    ``ValueError`` for an unknown loop, or for ``'wgmma'`` where the
    wgmma loop cannot take the call."""
    route = GC.kxk_route(x, w)
    if loop is None:
        return route
    if loop not in LOOPS:
        raise ValueError(f"gated_conv_probe: loop {loop!r} not in {LOOPS}")
    if loop == "wgmma" and route != "wgmma":
        raise ValueError(
            f"gated_conv_probe: the wgmma loop takes Cin % 32 == 0, Cout "
            f"% 8 == 0 and a 16-byte aligned x; got x {tuple(x.shape)}, "
            f"w {tuple(w.shape)}")
    return loop


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
                           mode: str = "full", bf16: bool = False,
                           loop: Optional[str] = None) -> torch.Tensor:
    """Plain PyTorch twin of :func:`gated_conv_probe` for the modes with
    a defined output (``full``, ``packonly``, ``nowin``) on the loop
    :func:`probe_route` gives."""
    loop = probe_route(x, w, loop)
    if bf16:
        x, w = GC.round_bf16(x), GC.round_bf16(w)
    cin, c2 = w.shape[2], w.shape[3]
    if mode == "full":
        return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                        padding=1).permute(0, 2, 3, 1).contiguous()
    taps, masks = _taps(x)
    if mode == "packonly":
        cols = torch.cat(taps, dim=-1)[..., :min(c2, 9 * cin)]
        if loop == "wgmma" and not bf16:   # the split TF32 parts
            hi, lo = GC.tf32_split(cols)
            cols = hi + lo
        return F.pad(cols, (0, c2 - cols.shape[-1])).contiguous()
    if mode == "nowin":
        w9 = w.reshape(9, cin, c2)
        out = sum(masks[t][..., None] * torch.matmul(x, w9[t])
                  for t in range(9))
        return out.contiguous()
    raise ValueError(f"gated_conv_probe_plain: mode {mode!r} has no "
                     f"defined output; the twin takes full, packonly, nowin")


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def gated_conv_probe(x: torch.Tensor, w: torch.Tensor, *,
                     mode: str = "full", bf16: bool = False,
                     loop: Optional[str] = None,
                     packed=None) -> torch.Tensor:
    """K8: ``x [B, H, W, Cin]``, ``w [3, 3, Cin, 2*Cout]`` float32 ->
    ``[B, H, W, 2*Cout]`` float32 by ``mode`` on ``loop`` (see the module
    note). ``packed``: ``pack_kxk_bf16`` (``bf16``) or ``pack_kxk_tf32``
    of ``w`` for the wgmma loop, or a function that returns it; packed
    here on every call when None (ignored by the twin and the tile
    loop)."""
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
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name}: no kernel for device {x.device}")
    loop = probe_route(x, w, loop)
    if x.device.type == "cpu":
        return gated_conv_probe_plain(x, w, mode=mode, bf16=bf16, loop=loop)
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name}: tensors must be contiguous")
    bsz, h, wd, cin = x.shape
    cout = w.shape[3] // 2
    if loop == "wgmma":
        packed = GC._resolve_packed(packed, GC.pack_kxk_bf16 if bf16
                                    else GC.pack_kxk_tf32, w)
        GC._check_packed(name, packed, w, 9 * cin, cout,
                         GC.wgmma_tile_n(cout), bf16, x.device)
        w = packed
    out = torch.empty((bsz, h, wd, 2 * cout), dtype=torch.float32,
                      device=x.device)
    if mode == "packonly" and 2 * cout > 9 * cin:
        out[..., 9 * cin:].zero_()   # past K: no staged column
    fn = _build.function("gated_conv_probe", name, _ARGTYPES)
    _build.call(fn, x.device, f"{name} ({loop})", x.data_ptr(),
                w.data_ptr(), out.data_ptr(), bsz, h, wd, cin, cout,
                MODES.index(mode), int(bf16), LOOPS.index(loop))
    launches[name] += 1
    launches[f"{name}_{loop}"] += 1
    return out
