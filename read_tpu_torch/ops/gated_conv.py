"""K2, K3 and K4: fused gated convolutions (``csrc/gated_conv.cu``) and
twins.

Counterpart of ``read_tpu/ops/gated_conv_pack.py``: ``gated_conv3x3_chw``
(:298-418, the 3x3 stride-1 kernels) together with the strided
transitions ``read_tpu/models/unet_pallas.py`` ``_Ctx.conv`` routes
through space-to-depth or im2col (:178-219) -> :func:`gated_conv_kxk`
(K2); ``gated_conv1x1_chw`` (:441-506) -> :func:`gated_conv_1x1` (K3);
``gated_conv1x1_cat_chw`` (:537-614) -> :func:`gated_conv_1x1_cat` (K4),
the 1x1 conv over a logical channel concat of up to 4 inputs.

One BasicConv of the UNet (``read_tpu/models/unet.py:130-184``) with its
eval BatchNorm folded to ``scale``/``offset``::

    fm  = conv(x, w) + b              # w: HWIO [k, k, Cin, 2*Cout]
    out = act(fm[..., :Cout]) * sigmoid(fm[..., Cout:]) * scale + offset
    out = out + res                   # optional fused residual

``act`` is ELU when ``relu`` else identity; K4 with ``gated=False`` has
no m half (``w [Ctot, Cout]``, ``out = act(fm) * scale + offset``).
Activations are NHWC
``[B, H, W, C]`` float32, as in JAX. ``bf16=True`` rounds both operands
to bfloat16 and accumulates in float32 (JAX's ``bf16_mxu``).

Each wrapper sends a CPU tensor to its plain twin and a CUDA tensor to
its kernel (anything else raises). ``launches[<wrapper name>]`` counts
each wrapper's kernel launches; ``launches['gated_conv_kxk_wgmma']``
counts the K2 launches :func:`kxk_route` sent to the wgmma loop (they
count in ``launches['gated_conv_kxk']`` too).

K2 has two loops on CUDA, chosen by :func:`kxk_route`: bf16 operands with
``Cin % 32 == 0``, ``Cout % 8 == 0`` and a 16-byte aligned ``x`` take the
warp-specialized wgmma loop (``csrc/gated_conv_wgmma.cuh``), whose weight
:func:`pack_kxk_bf16` packs once (``models.unet.BasicConv`` caches it);
the rest take the tile loops of ``csrc/gated_conv_tile.cuh``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from read_tpu_torch import _build

__all__ = ["gated_epilogue", "gated_conv_kxk", "gated_conv_kxk_plain",
           "kxk_route", "wgmma_tile_n", "pack_kxk_bf16", "gated_conv_1x1",
           "gated_conv_1x1_plain", "gated_conv_1x1_cat",
           "gated_conv_1x1_cat_plain", "round_bf16", "launches"]

# kernel launches per wrapper (a CPU call runs the twin and counts nothing)
launches = {"gated_conv_kxk": 0, "gated_conv_kxk_wgmma": 0,
            "gated_conv_1x1": 0, "gated_conv_1x1_cat": 0}
MAX_CAT = 4  # inputs K4 takes in one launch
WGMMA_K = 64  # K slice of the wgmma loop: one 128-byte bf16 row


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """Round float32 values to bfloat16 (nearest even), kept as float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def gated_epilogue(fm: torch.Tensor, b: torch.Tensor, scale: torch.Tensor,
                   offset: torch.Tensor, res: Optional[torch.Tensor],
                   relu: bool, gated: bool = True) -> torch.Tensor:
    """Bias, ELU(f) * sigmoid(m) gate (or act alone when not ``gated``),
    folded BN affine, residual."""
    fm = fm + b
    if gated:
        c = fm.shape[-1] // 2
        f, m = fm[..., :c], fm[..., c:]
        if relu:
            f = F.elu(f)
        out = f * torch.sigmoid(m) * scale + offset
    else:
        out = (F.elu(fm) if relu else fm) * scale + offset
    return out if res is None else out + res


def _on_cuda(name, tensors) -> bool:
    """Check a wrapper's float32 tensors: False on the CPU (the twin
    runs), True when all are contiguous CUDA tensors (the kernel runs);
    raise otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: want float32 tensors, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    return True


def _check_epilogue(name, b, scale, offset, res, c2, cout, out_shape):
    if tuple(b.shape) != (c2,) or tuple(scale.shape) != (cout,) \
            or tuple(offset.shape) != (cout,):
        raise ValueError(f"{name}: bias/scale/offset shapes do not match "
                         f"C2={c2}, Cout={cout}")
    if res is not None and tuple(res.shape) != tuple(out_shape):
        raise ValueError(f"{name}: residual {tuple(res.shape)} != output "
                         f"{tuple(out_shape)}")


def _check(name, x, w, b, scale, offset, res, out_shape):
    cout = w.shape[-1] // 2
    if w.shape[-1] != 2 * cout or w.shape[-2] != x.shape[-1]:
        raise ValueError(f"{name}: weight {tuple(w.shape)} does not fit "
                         f"input {tuple(x.shape)}")
    _check_epilogue(name, b, scale, offset, res, 2 * cout, cout, out_shape)
    return _on_cuda(name, [x, w, b, scale, offset]
                    + ([] if res is None else [res]))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def gated_conv_kxk_plain(x, w, b, scale, offset, res=None, *, stride=1,
                         relu=True, bf16=False, packed=None):
    """Plain PyTorch twin of :func:`gated_conv_kxk` (``F.conv2d``);
    ``packed`` is accepted and ignored (it is the same weight)."""
    k = w.shape[0]
    if bf16:
        x, w = round_bf16(x), round_bf16(w)
    fm = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                  stride=stride, padding=(k - 1) // 2).permute(0, 2, 3, 1)
    return gated_epilogue(fm, b, scale, offset, res, relu).contiguous()


_KXK_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                 + [ctypes.c_void_p])
_WGMMA_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])


def kxk_route(x: torch.Tensor, w: torch.Tensor, bf16: bool) -> str:
    """Which CUDA loop K2 runs for ``x [B, H, W, Cin]`` and ``w [k, k,
    Cin, 2*Cout]``: ``'wgmma'`` for bf16 operands with ``Cin % 32 == 0``,
    ``Cout % 8 == 0`` and a 16-byte aligned ``x``; ``'tile'`` otherwise
    (the 8-channel descriptor inputs, the ``Cout = 3`` heads, f32)."""
    cin, cout = w.shape[-2], w.shape[-1] // 2
    if bf16 and cin % 32 == 0 and cout % 8 == 0 \
            and x.data_ptr() % 16 == 0:
        return "wgmma"
    return "tile"


def wgmma_tile_n(cout: int) -> int:
    """Columns of one N tile of the wgmma loop (f and m together): 64
    for ``Cout <= 32``, else 128: wider layers take several tiles
    (256-column tiles lost at 32 to 128 channels, ``PERF.md``)."""
    return 64 if cout <= 32 else 128


def pack_kxk_bf16(w: torch.Tensor) -> torch.Tensor:
    """The wgmma loop's weight: HWIO ``w [k, k, Cin, 2*Cout]`` (f32) as
    bf16 (round to nearest even) ``[ntiles, slices, tile_n, 64]``, one
    contiguous block per (N tile, K slice) for one bulk copy a stage;
    ``tile_n`` is :func:`wgmma_tile_n` of ``Cout``.

    K = k*k*Cin (tap-major, as ``w.reshape``) is cut into ``slices`` of 64,
    the last zero-padded. Column ``n`` of tile ``t`` holds, by group ``g =
    n // 8``, channel ``c = t*tile_n/2 + 8*(g // 2) + n % 8`` of f (``g``
    even) or m (``g`` odd), zero where ``c >= Cout``: f and m interleave
    in groups of 8. Each row (``n``) stores its 64 K values as eight
    16-byte chunks, chunk ``j`` at position ``j ^ (n % 8)``: the 128-byte
    swizzle the kernel's wgmma descriptors read."""
    k, _, cin, c2 = w.shape
    cout = c2 // 2
    tile_n = wgmma_tile_n(cout)
    half = tile_n // 2
    ntiles = -(-cout // half)
    kk = k * k * cin
    slices = -(-kk // WGMMA_K)
    dev = w.device
    n = torch.arange(ntiles * tile_n, device=dev)
    g = (n % tile_n) // 8
    ch = (n // tile_n) * half + 8 * (g // 2) + n % 8
    col = torch.where(ch < cout, ch + cout * (g % 2),
                      torch.full_like(ch, c2))  # c2: a zero column
    wm = torch.zeros(slices * WGMMA_K, c2 + 1, dtype=torch.float32,
                     device=dev)
    wm[:kk, :c2] = w.reshape(kk, c2)
    b = wm[:, col].reshape(slices, WGMMA_K, ntiles, tile_n)
    b = b.permute(2, 0, 3, 1).reshape(ntiles, slices, tile_n, 8, 8)
    swz = torch.arange(8, device=dev)[None, :] ^ (
        torch.arange(tile_n, device=dev)[:, None] % 8)  # [tile_n, 8]
    b = torch.gather(b, 3, swz[None, None, :, :, None].expand_as(b))
    return b.reshape(ntiles, slices, tile_n, WGMMA_K).to(
        torch.bfloat16).contiguous()


def _launch_wgmma(x, packed, b, scale, offset, res, out, k, stride, relu):
    """Launch ``gated_conv_kxk_wgmma`` into ``out``."""
    bsz, h, wd, cin = x.shape
    cout = out.shape[-1]
    ntiles, _, tile_n, _ = packed.shape
    fn = _build.function("gated_conv", "gated_conv_kxk_wgmma",
                         _WGMMA_ARGTYPES)
    err = fn(x.data_ptr(), packed.data_ptr(), b.data_ptr(),
             scale.data_ptr(), offset.data_ptr(), _ptr(res), out.data_ptr(),
             bsz, h, wd, cin, cout, k, stride, int(relu), tile_n, ntiles,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "gated_conv_kxk (wgmma)")


def gated_conv_kxk(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   scale: torch.Tensor, offset: torch.Tensor,
                   res: Optional[torch.Tensor] = None, *, stride: int = 1,
                   relu: bool = True, bf16: bool = False,
                   packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2: gated k x k conv (k in {3, 4}, stride in {1, 2}, zero pad
    ``(k-1)//2``) of ``x [B, H, W, Cin]`` with ``w [k, k, Cin, 2*Cout]``;
    returns ``[B, Ho, Wo, Cout]``. ``packed`` is ``pack_kxk_bf16(w)``
    for the wgmma loop (packed here when it is needed and not given)."""
    k = w.shape[0]
    if w.dim() != 4 or w.shape[1] != k or k not in (3, 4) \
            or stride not in (1, 2) or x.dim() != 4:
        raise ValueError(f"gated_conv_kxk: unsupported x {tuple(x.shape)}"
                         f", w {tuple(w.shape)}, stride {stride}")
    bsz, h, wd, cin = x.shape
    pad = (k - 1) // 2
    ho = (h + 2 * pad - k) // stride + 1
    wo = (wd + 2 * pad - k) // stride + 1
    cout = w.shape[-1] // 2
    if not _check("gated_conv_kxk", x, w, b, scale, offset, res,
                  (bsz, ho, wo, cout)):
        return gated_conv_kxk_plain(x, w, b, scale, offset, res,
                                    stride=stride, relu=relu, bf16=bf16)
    out = torch.empty((bsz, ho, wo, cout), dtype=torch.float32,
                      device=x.device)
    if kxk_route(x, w, bf16) == "wgmma":
        if packed is None:
            packed = pack_kxk_bf16(w)
        tile_n = wgmma_tile_n(cout)
        want = (-(-cout // (tile_n // 2)), -(-k * k * cin // WGMMA_K),
                tile_n, WGMMA_K)
        if packed.dtype != torch.bfloat16 or packed.device != x.device \
                or not packed.is_contiguous() \
                or tuple(packed.shape) != want:
            raise ValueError(f"gated_conv_kxk: packed weight "
                             f"{tuple(packed.shape)} {packed.dtype} does "
                             f"not fit w {tuple(w.shape)}")
        _launch_wgmma(x, packed, b, scale, offset, res, out, k, stride,
                      relu)
        launches["gated_conv_kxk"] += 1
        launches["gated_conv_kxk_wgmma"] += 1
        return out
    fn = _build.function("gated_conv", "gated_conv_kxk", _KXK_ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), scale.data_ptr(),
             offset.data_ptr(), _ptr(res), out.data_ptr(), bsz, h, wd, cin,
             cout, k, stride, int(relu), int(bf16),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "gated_conv_kxk")
    launches["gated_conv_kxk"] += 1
    return out


def _weight_2d(name: str, w: torch.Tensor) -> torch.Tensor:
    """A 1x1 weight ``[1, 1, Cin, C2]`` as ``[Cin, C2]`` (2-D passes)."""
    if w.dim() == 4:
        if tuple(w.shape[:2]) != (1, 1):
            raise ValueError(f"{name}: weight {tuple(w.shape)} is not 1x1")
        w = w.reshape(w.shape[2], w.shape[3])
    return w


def gated_conv_1x1_plain(x, w, b, scale, offset, res=None, *, relu=True,
                         bf16=False):
    """Plain PyTorch twin of :func:`gated_conv_1x1` (``torch.matmul``)."""
    w2 = w.reshape(w.shape[-2], w.shape[-1])
    if bf16:
        x, w2 = round_bf16(x), round_bf16(w2)
    return gated_epilogue(torch.matmul(x, w2), b, scale, offset, res,
                          relu).contiguous()


_1X1_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p])


def gated_conv_1x1(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   scale: torch.Tensor, offset: torch.Tensor,
                   res: Optional[torch.Tensor] = None, *,
                   relu: bool = True, bf16: bool = False) -> torch.Tensor:
    """K3: gated 1x1 conv, ``[..., Cin] @ [Cin, 2*Cout]`` + epilogue.
    ``w`` is ``[1, 1, Cin, 2*Cout]`` or ``[Cin, 2*Cout]``; returns
    ``[..., Cout]``."""
    w = _weight_2d("gated_conv_1x1", w)
    cout = w.shape[-1] // 2
    out_shape = tuple(x.shape[:-1]) + (cout,)
    if not _check("gated_conv_1x1", x, w, b, scale, offset, res,
                  out_shape):
        return gated_conv_1x1_plain(x, w, b, scale, offset, res,
                                    relu=relu, bf16=bf16)
    cin = x.shape[-1]
    n = x.numel() // max(cin, 1)
    out = torch.empty(out_shape, dtype=torch.float32, device=x.device)
    fn = _build.function("gated_conv", "gated_conv_1x1", _1X1_ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), scale.data_ptr(),
             offset.data_ptr(), _ptr(res), out.data_ptr(), n, cin, cout,
             int(relu), int(bf16),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "gated_conv_1x1")
    launches["gated_conv_1x1"] += 1
    return out


def gated_conv_1x1_cat_plain(xs, w, b, scale, offset, res=None, *,
                             relu=True, gated=True, bf16=False):
    """Plain PyTorch twin of :func:`gated_conv_1x1_cat`: one
    ``torch.matmul`` per input against its rows of ``w``, summed."""
    w2 = _weight_2d("gated_conv_1x1_cat", w)
    acc, off = None, 0
    for x in xs:
        c = x.shape[-1]
        xj, wj = x, w2[off:off + c]
        off += c
        if bf16:
            xj, wj = round_bf16(xj), round_bf16(wj)
        d = torch.matmul(xj, wj)
        acc = d if acc is None else acc + d
    if off != w2.shape[0]:
        raise ValueError(f"gated_conv_1x1_cat: inputs carry {off} "
                         f"channels, weight wants {w2.shape[0]}")
    return gated_epilogue(acc, b, scale, offset, res, relu,
                          gated).contiguous()


_CAT_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p])


def gated_conv_1x1_cat(xs, w: torch.Tensor, b: torch.Tensor,
                       scale: torch.Tensor, offset: torch.Tensor,
                       res: Optional[torch.Tensor] = None, *,
                       relu: bool = True, gated: bool = True,
                       bf16: bool = False) -> torch.Tensor:
    """K4: gated 1x1 conv over the channel concat of ``xs`` (1 to 4
    tensors ``[..., C_j]`` with the same leading shape), never
    materialized: ``sum_j x_j @ w[rows of j]`` + epilogue. ``w`` is
    ``[1, 1, sum C_j, C2]`` or ``[sum C_j, C2]`` with ``C2 = 2*Cout``
    (``Cout`` when not ``gated``); returns ``[..., Cout]``."""
    name = "gated_conv_1x1_cat"
    xs = list(xs)
    if not 1 <= len(xs) <= MAX_CAT:
        raise ValueError(f"{name}: takes 1 to {MAX_CAT} inputs, got "
                         f"{len(xs)}")
    lead = tuple(xs[0].shape[:-1])
    if any(tuple(x.shape[:-1]) != lead for x in xs):
        raise ValueError(f"{name}: inputs {[tuple(x.shape) for x in xs]} "
                         "differ in their leading shape")
    w = _weight_2d(name, w)
    cins = [x.shape[-1] for x in xs]
    c2 = w.shape[-1]
    cout = c2 // 2 if gated else c2
    if w.shape[0] != sum(cins) or (gated and c2 != 2 * cout):
        raise ValueError(f"{name}: weight {tuple(w.shape)} does not fit "
                         f"inputs of {cins} channels")
    out_shape = lead + (cout,)
    _check_epilogue(name, b, scale, offset, res, c2, cout, out_shape)
    if not _on_cuda(name, xs + [w, b, scale, offset]
                    + ([] if res is None else [res])):
        return gated_conv_1x1_cat_plain(xs, w, b, scale, offset, res,
                                        relu=relu, gated=gated, bf16=bf16)
    n = xs[0].numel() // max(cins[0], 1)
    out = torch.empty(out_shape, dtype=torch.float32, device=w.device)
    pad = MAX_CAT - len(xs)
    ptrs = [x.data_ptr() for x in xs] + [None] * pad
    fn = _build.function("gated_conv", name, _CAT_ARGTYPES)
    err = fn(*ptrs, *cins, *([0] * pad), len(xs), w.data_ptr(),
             b.data_ptr(), scale.data_ptr(), offset.data_ptr(), _ptr(res),
             out.data_ptr(), n, cout, int(relu), int(gated), int(bf16),
             torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(err, name)
    launches[name] += 1
    return out
