"""K7: the row-band gated convolutions, their CUDA routes and twins.

Counterpart of ``scripts/gated_conv_pallas_r2.py`` ``gated_conv3x3``
(:105-166) and ``gated_conv1x1`` (:179-220), the round-2 design that K2
and K3 superseded; the kernel bench times it beside them at K2's shapes.
Contract, as the script's: one image ``x [H, W, Cin]``, HWIO weights
``w [k, k, Cin, C2]``, stride 1, zero pad ``(k-1)//2``, no residual.
``gated=True``: ``C2 = 2*Cout`` and ``out = act(f) * sigmoid(m) * scale
+ offset``; ``gated=False``: ``C2 = Cout`` and ``out = act(fm) * scale +
offset`` (``scale``/``offset`` have C2 entries). ``act`` is ELU when
``relu``. The input's dtype (float32 or bfloat16) is also the weights'
(cast to it) and the output's; bias, scale and offset are float32 and
every sum is float32.

Each wrapper sends a CPU tensor to its plain twin and a CUDA tensor to a
kernel (anything else raises). On CUDA, :func:`r2_route` chooses it: a
gated call with ``Cout % 8 == 0``, ``Cin % 32 == 0`` (3x3) or ``Cin % 8
== 0`` (1x1), a 16-byte aligned ``x`` and 8-byte aligned bias, scale and
offset takes a wgmma loop, the 3x3 K2's (``csrc/gated_conv_wgmma.cuh``)
and the 1x1 K3's (``csrc/gated_conv_1x1_wgmma.cuh``), with the weight of
:func:`pack_r2`: in float32 as three TF32 products (the loops' f32 mode,
held to the f32 bound, not exact f32 FMA), in bfloat16 in the loops'
bf16-storage mode (bf16 read and written, f32 sums, the output rounded
once). The rest (``gated=False``, other widths, misaligned views) take
the band kernel (``csrc/gated_conv_r2.cu``). A wrapper's ``packed`` is
the packed weight or a function that returns it, called only on a wgmma
route (packed there when not given).

``launches[<wrapper name>]`` counts each wrapper's launches,
``launches[<name>_wgmma]`` those on a wgmma loop and
``launches[<name>_band]`` those of the band kernel, the kernel bench's
direct calls of :func:`_band` among them. ``ops.gated_conv``'s counters
never count K7.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from read_tpu_torch import _build
from read_tpu_torch.ops import gated_conv as GC

__all__ = ["gated_conv3x3_r2", "gated_conv3x3_r2_plain", "gated_conv1x1_r2",
           "gated_conv1x1_r2_plain", "r2_route", "pack_r2", "launches"]

_NAMES = {3: "gated_conv3x3_r2", 1: "gated_conv1x1_r2"}
launches = {name + route: 0 for name in _NAMES.values()
            for route in ("", "_wgmma", "_band")}
_DTYPES = (torch.float32, torch.bfloat16)


def _plain(x, w, b, scale, offset, relu, gated):
    """Twin of both forms: the conv in float32 on the dtype's values."""
    k = w.shape[0]
    xf, wf = x.float(), w.to(x.dtype).float()
    fm = F.conv2d(xf.permute(2, 0, 1)[None], wf.permute(3, 2, 0, 1),
                  padding=(k - 1) // 2)[0].permute(1, 2, 0)
    return GC.gated_epilogue(fm, b, scale, offset, None, relu,
                             gated).to(x.dtype).contiguous()


def gated_conv3x3_r2_plain(x, w, b, scale, offset, *, relu=True,
                           gated=True):
    """Plain PyTorch twin of :func:`gated_conv3x3_r2` (``F.conv2d``)."""
    return _plain(x, w, b, scale, offset, relu, gated)


def gated_conv1x1_r2_plain(x, w, b, scale, offset, *, relu=True,
                           gated=True):
    """Plain PyTorch twin of :func:`gated_conv1x1_r2` (``F.conv2d``)."""
    return _plain(x, w.reshape(1, 1, *w.shape[-2:]), b, scale, offset,
                  relu, gated)


def r2_route(x: torch.Tensor, w: torch.Tensor, gated: bool = True,
             epilogue=()) -> str:
    """Which CUDA kernel K7 runs for ``x [H, W, Cin]``, ``w [k, k, Cin,
    C2]`` (or ``[Cin, C2]``, 1x1) and the ``epilogue`` tensors (bias,
    scale, offset), in either dtype: ``'wgmma'`` for a ``gated`` call
    with ``Cout % 8 == 0``, ``Cin % 32 == 0`` (3x3; a 32-channel f32
    slice is one tap) or ``Cin % 8 == 0`` (1x1; a 16-byte chunk lies in
    one pixel), a 16-byte aligned ``x`` and 8-byte aligned epilogue
    tensors (the loops' epilogue reads channel pairs); ``'band'``
    otherwise."""
    k = w.shape[0] if w.dim() == 4 else 1
    cin, cout = x.shape[-1], w.shape[-1] // 2
    if gated and cout % 8 == 0 and cin % (32 if k == 3 else 8) == 0 \
            and x.data_ptr() % 16 == 0 and GC._epilogue_aligned(epilogue):
        return "wgmma"
    return "band"


def pack_r2(w: torch.Tensor) -> torch.Tensor:
    """The wgmma loop's weight for K7's ``w`` (``[3, 3, Cin, 2*Cout]``,
    or 1x1 ``[1, 1, Cin, 2*Cout]`` / ``[Cin, 2*Cout]``) in the input's
    dtype: bfloat16 -> ``pack_kxk_bf16`` / ``pack_1x1_bf16`` of ``w`` as
    float32 (exact: every bf16 value is a float32 and the pack rounds it
    back unchanged); float32 -> ``pack_kxk_tf32`` / ``pack_1x1_tf32``."""
    wf = w.float()
    if w.dim() == 4 and w.shape[0] == 3:
        return (GC.pack_kxk_bf16 if w.dtype == torch.bfloat16
                else GC.pack_kxk_tf32)(wf)
    return (GC.pack_1x1_bf16 if w.dtype == torch.bfloat16
            else GC.pack_1x1_tf32)(wf)


def _check(name, k, x, w, b, scale, offset, gated):
    """Validate a call: ``(w as [k, k, Cin, C2], Cout, on_cuda)``; False
    on the CPU (the twin runs), True for contiguous CUDA tensors."""
    if w.dim() == 2:
        w = w.reshape(1, 1, *w.shape)
    if x.dim() != 3 or x.dtype not in _DTYPES or w.dim() != 4 \
            or tuple(w.shape[:2]) != (k, k) or w.shape[2] != x.shape[-1]:
        raise ValueError(f"{name}: want x [H, W, Cin] float32/bfloat16 and "
                         f"w [{k}, {k}, Cin, C2]; got {tuple(x.shape)} "
                         f"{x.dtype}, {tuple(w.shape)}")
    c2 = w.shape[-1]
    cout = c2 // 2 if gated else c2
    if (gated and c2 != 2 * cout) or tuple(b.shape) != (c2,) or \
            tuple(scale.shape) != (cout,) or tuple(offset.shape) != (cout,):
        raise ValueError(f"{name}: bias/scale/offset do not fit C2={c2}")
    for t in (b, scale, offset):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: bias/scale/offset must be float32")
    tensors = (x, w, b, scale, offset)
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: tensors on different devices")
    if x.device.type == "cpu":
        return w, cout, False
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {x.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    return w, cout, True


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _launch_band(name, k, x, w, b, scale, offset, out, relu, gated):
    """Launch the band kernel (``csrc/gated_conv_r2.cu``) into ``out``."""
    h, wd, cin = x.shape
    w = w.to(x.dtype).contiguous()
    fn = _build.function("gated_conv_r2", "gated_conv_r2", _ARGTYPES)
    _build.call(fn, x.device, name, x.data_ptr(), w.data_ptr(),
                b.data_ptr(), scale.data_ptr(), offset.data_ptr(),
                out.data_ptr(), h, wd, cin, out.shape[-1], k, int(relu),
                int(gated), int(x.dtype == torch.bfloat16))
    launches[name + "_band"] += 1


def _launch_loop(name, k, x, w, packed, b, scale, offset, out, relu):
    """Launch K7 on its wgmma loop into ``out``: 3x3 on K2's
    (``gated_conv_kxk_wgmma``, B = 1, stride 1), 1x1 on the 1x1 loop
    (``gated_conv_1x1_wgmma``, one input), no residual; f32 as three
    TF32 products, bf16 in bf16 storage."""
    bf16 = x.dtype == torch.bfloat16
    cin, cout = x.shape[-1], out.shape[-1]
    w = w.to(x.dtype)
    packed = GC._resolve_packed(packed, pack_r2, w)
    tile_n = GC.wgmma_tile_n(cout) if k == 3 else GC.CONV1X1_TILE_N
    GC._check_packed(name, packed, w, k * k * cin, cout, tile_n, bf16,
                     x.device)
    ops = GC.OPS_BF16_STORAGE if bf16 else GC.OPS_TF32X3
    if k == 3:
        GC._launch_wgmma(x[None], packed, b, scale, offset, None,
                         out[None], 3, 1, relu, ops, f"{name} (wgmma)")
    else:
        GC._call_1x1_wgmma(f"{name} (wgmma)", [x], packed, b, scale,
                           offset, None, out, relu, ops)
    launches[name + "_wgmma"] += 1


def _run(k, x, w, b, scale, offset, relu, gated, packed):
    name = _NAMES[k]
    w, cout, cuda = _check(name, k, x, w, b, scale, offset, gated)
    if not cuda:
        return _plain(x, w, b, scale, offset, relu, gated)
    out = torch.empty((*x.shape[:2], cout), dtype=x.dtype, device=x.device)
    if r2_route(x, w, gated, (b, scale, offset)) == "wgmma":
        _launch_loop(name, k, x, w, packed, b, scale, offset, out, relu)
    else:
        _launch_band(name, k, x, w, b, scale, offset, out, relu, gated)
    launches[name] += 1
    return out


def _band(k, x, w, b, scale, offset, *, relu=True, gated=True):
    """The band kernel called directly, whatever :func:`r2_route` says:
    the kernel bench's old design beside the loops (the twin on the
    CPU)."""
    name = _NAMES[k]
    w, cout, cuda = _check(name, k, x, w, b, scale, offset, gated)
    if not cuda:
        return _plain(x, w, b, scale, offset, relu, gated)
    out = torch.empty((*x.shape[:2], cout), dtype=x.dtype, device=x.device)
    _launch_band(name, k, x, w, b, scale, offset, out, relu, gated)
    return out


def gated_conv3x3_r2(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     scale: torch.Tensor, offset: torch.Tensor, *,
                     relu: bool = True, gated: bool = True,
                     packed=None) -> torch.Tensor:
    """K7 3x3: ``x [H, W, Cin]``, ``w [3, 3, Cin, C2]`` -> ``[H, W,
    Cout]`` in x's dtype. ``packed``: :func:`pack_r2` of ``w`` in x's
    dtype, or a function that returns it (ignored by the twin and the
    band kernel)."""
    return _run(3, x, w, b, scale, offset, relu, gated, packed)


def gated_conv1x1_r2(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     scale: torch.Tensor, offset: torch.Tensor, *,
                     relu: bool = True, gated: bool = True,
                     packed=None) -> torch.Tensor:
    """K7 1x1: ``x [H, W, Cin]``, ``w [1, 1, Cin, C2]`` or ``[Cin, C2]``
    -> ``[H, W, Cout]`` in x's dtype; ``packed`` as for
    :func:`gated_conv3x3_r2`."""
    return _run(1, x, w, b, scale, offset, relu, gated, packed)
