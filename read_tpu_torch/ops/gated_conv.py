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
counts the K2 launches :func:`kxk_route` sent to the wgmma loop (both
operand modes), ``launches['gated_conv_kxk_wgmma_tma']`` those of them
with f32 operands, which take the loop's f32 kernel (its A operand
copied raw by TMA im2col loads, :func:`im2col_copy_params`), and
``launches['gated_conv_1x1_wgmma']`` the K3 and K4 launches
:func:`conv1x1_route` sent to the 1x1 wgmma loop (they count under their
wrapper's name too).

K2 has two loops on CUDA, chosen by :func:`kxk_route`: a call with
``Cin % 32 == 0``, ``Cout % 8 == 0``, a 16-byte aligned ``x`` and 8-byte
aligned bias, scale, offset and residual takes the warp-specialized
wgmma loop (``csrc/gated_conv_wgmma.cuh``) in either operand mode, with
the weight of :func:`pack_kxk_bf16` or :func:`pack_kxk_tf32`; the rest
take the tile loops of ``csrc/gated_conv_tile.cuh``.

K3 and K4 have two loops on CUDA too, chosen by :func:`conv1x1_route`: a
gated call whose inputs all have ``C % 8 == 0`` and 16-byte aligned
data, with ``Cout % 8 == 0`` and 8-byte aligned bias, scale, offset and
residual, takes the 1x1 wgmma loop (``csrc/gated_conv_1x1_wgmma.cuh``)
in either operand mode, with the weight of :func:`pack_1x1_bf16` or
:func:`pack_1x1_tf32`; the rest take the tile loops.

K7 (``ops.gated_conv_r2``) runs its gated calls on the same two loops,
with a third mode for its bf16 contract (``OPS_BF16_STORAGE``: x, weight
and output bf16), and counts them under its own names.

A wrapper's ``packed`` is the packed weight or a function that returns
it, called only when a wgmma route runs (``models.unet.BasicConv``
passes its cache's getter). With bf16 operands both wgmma loops round
both operands to bf16 and sum in f32. With f32 operands they are **not
exact f32 FMA**: each operand is split into TF32 parts
(:func:`tf32_split`) and three TF32 tensor-core products ``hi*hi + hi*lo
+ lo*hi`` are summed in f32, which holds the f32 bound ``atol 2e-5, rtol
1e-4`` against the twins; the twins stay exact f32.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from read_tpu_torch import _build

__all__ = ["gated_epilogue", "gated_conv_kxk", "gated_conv_kxk_plain",
           "kxk_route", "wgmma_tile_n", "pack_kxk_bf16", "pack_kxk_tf32",
           "im2col_copy_params",
           "conv1x1_route", "pack_1x1_bf16", "pack_1x1_tf32", "tf32_split",
           "gated_conv_1x1", "gated_conv_1x1_plain", "gated_conv_1x1_cat",
           "gated_conv_1x1_cat_plain", "round_bf16", "launches"]

# kernel launches per wrapper (a CPU call runs the twin and counts nothing)
launches = {"gated_conv_kxk": 0, "gated_conv_kxk_wgmma": 0,
            "gated_conv_kxk_wgmma_tma": 0, "gated_conv_1x1": 0,
            "gated_conv_1x1_cat": 0, "gated_conv_1x1_wgmma": 0}
MAX_CAT = 4  # inputs K4 takes in one launch
WGMMA_K = 64  # K slice of the wgmma loops: one 128-byte bf16 row
TF32_K = 32  # K slice of their f32 mode: one 128-byte f32 row
CONV1X1_TILE_N = 64  # f|m columns of a 1x1-loop N tile (PERF.md, PR 6)
# the wgmma loops' modes (`ops` of their C entries): f32 operands as three
# TF32 products; bf16 operands rounded from f32 storage; bf16 storage (x,
# weight and output bf16, no residual: K7's bf16, ops.gated_conv_r2)
OPS_TF32X3, OPS_BF16, OPS_BF16_STORAGE = 0, 1, 2


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """Round float32 values to bfloat16 (nearest even), kept as float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def _rna_tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 mantissa bits) to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32``: the low 13 bits cleared."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(t: torch.Tensor):
    """``(hi, lo)``: ``hi = rna_tf32(t)``, ``lo = rna_tf32(t - hi)``, the
    two TF32 parts the wgmma loops' f32 mode multiplies (``t - hi`` is
    exact, so ``hi + lo`` is ``t`` to within ~2^-22 of ``|t|``)."""
    hi = _rna_tf32(t)
    return hi, _rna_tf32(t - hi)


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
_WGMMA_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 11
                   + [ctypes.c_void_p])


def _epilogue_aligned(epilogue) -> bool:
    """The wgmma loops' epilogue reads bias, scale, offset and the
    residual as channel pairs: each must be 8-byte aligned (None
    skipped)."""
    return all(t.data_ptr() % 8 == 0 for t in epilogue if t is not None)


def kxk_route(x: torch.Tensor, w: torch.Tensor, epilogue=()) -> str:
    """Which CUDA loop K2 runs for ``x [B, H, W, Cin]``, ``w [k, k, Cin,
    2*Cout]`` and the ``epilogue`` tensors (bias, scale, offset,
    residual; None skipped), in either operand mode: ``'wgmma'`` for
    ``Cin % 32 == 0``, ``Cout % 8 == 0``, a 16-byte aligned ``x`` and
    8-byte aligned epilogue tensors; ``'tile'`` otherwise (the 8-channel
    descriptor inputs, the ``Cout = 3`` heads, misaligned views)."""
    cin, cout = w.shape[-2], w.shape[-1] // 2
    if cin % 32 == 0 and cout % 8 == 0 and x.data_ptr() % 16 == 0 \
            and _epilogue_aligned(epilogue):
        return "wgmma"
    return "tile"


def wgmma_tile_n(cout: int) -> int:
    """Columns of one N tile of the wgmma loop (f and m together): 64
    for ``Cout <= 32``, else 128: wider layers take several tiles
    (256-column tiles lost at 32 to 128 channels, ``PERF.md``)."""
    return 64 if cout <= 32 else 128


def _blocks_shape(kk: int, cout: int, row: int, tile_n: int):
    """Shape ``[ntiles, slices, tile_n, row]`` of :func:`_pack_blocks`'
    output for a ``[kk, 2*cout]`` weight."""
    return (-(-cout // (tile_n // 2)), -(-kk // row), tile_n, row)


def _resolve_packed(packed, pack, w):
    """The packed weight a wgmma route launches with: ``packed``, or
    ``packed()`` where it is a function, or ``pack(w)`` where it is
    None."""
    if packed is None:
        return pack(w)
    return packed() if callable(packed) else packed


def _check_packed(name, packed, w, kk, cout, tile_n, bf16, dev):
    """Raise unless ``packed`` is the contiguous blocks of a ``[kk,
    2*cout]`` weight ``w`` on ``dev`` in ``tile_n``-column N tiles: bf16
    ``[ntiles, slices, tile_n, 64]``, or f32 ``[ntiles, slices, 2, tile_n,
    32]`` (hi and lo)."""
    want = list(_blocks_shape(kk, cout, WGMMA_K if bf16 else TF32_K,
                              tile_n))
    if not bf16:
        want.insert(2, 2)   # the hi and the lo block
    if packed.dtype != (torch.bfloat16 if bf16 else torch.float32) \
            or packed.device != dev or not packed.is_contiguous() \
            or list(packed.shape) != want:
        raise ValueError(f"{name}: packed weight {tuple(packed.shape)} "
                         f"{packed.dtype} does not fit w {tuple(w.shape)} "
                         f"({'bf16' if bf16 else 'f32'} operands)")


def _pack_blocks(wm: torch.Tensor, row: int, tile_n: int) -> torch.Tensor:
    """``wm [K, 2*Cout]`` (f32, the f|m columns) as the wgmma loops' blocks
    ``[ntiles, slices, tile_n, row]`` (f32), one per (N tile, K slice) of
    ``tile_n`` columns; a slice is ``row`` K values (one 128-byte row of
    the operand type), the last zero-padded.

    Column ``n`` of tile ``t`` holds, by group ``g = n // 8``, channel ``c
    = t*tile_n/2 + 8*(g // 2) + n % 8`` of f (``g`` even) or m (``g``
    odd), zero where ``c >= Cout``: f and m interleave in groups of 8. Each
    row (``n``) stores its ``row`` K values as eight 16-byte chunks, chunk
    ``j`` at position ``j ^ (n % 8)``: the 128-byte swizzle the kernels'
    wgmma descriptors read."""
    kk, c2 = wm.shape
    cout = c2 // 2
    half = tile_n // 2
    ntiles, slices, _, _ = _blocks_shape(kk, cout, row, tile_n)
    dev = wm.device
    n = torch.arange(ntiles * tile_n, device=dev)
    g = (n % tile_n) // 8
    ch = (n // tile_n) * half + 8 * (g // 2) + n % 8
    col = torch.where(ch < cout, ch + cout * (g % 2),
                      torch.full_like(ch, c2))  # c2: a zero column
    wz = torch.zeros(slices * row, c2 + 1, dtype=torch.float32, device=dev)
    wz[:kk, :c2] = wm
    b = wz[:, col].reshape(slices, row, ntiles, tile_n)
    b = b.permute(2, 0, 3, 1).reshape(ntiles, slices, tile_n, 8, row // 8)
    swz = torch.arange(8, device=dev)[None, :] ^ (
        torch.arange(tile_n, device=dev)[:, None] % 8)  # [tile_n, 8]
    b = torch.gather(b, 3, swz[None, None, :, :, None].expand_as(b))
    return b.reshape(ntiles, slices, tile_n, row)


def _tf32_blocks(wm: torch.Tensor, tile_n: int) -> torch.Tensor:
    """The f32 modes' weight: :func:`_pack_blocks` of ``wm [K, 2*Cout]``
    in 32-deep slices, split by :func:`tf32_split` into ``[ntiles,
    slices, 2, tile_n, 32]``: per (N tile, K slice) the ``hi`` block,
    then the ``lo`` block, for one bulk copy a stage."""
    hi, lo = tf32_split(_pack_blocks(wm, TF32_K, tile_n))
    return torch.stack([hi, lo], 2).contiguous()


def pack_kxk_bf16(w: torch.Tensor) -> torch.Tensor:
    """The wgmma loop's bf16 weight: HWIO ``w [k, k, Cin, 2*Cout]`` (f32)
    as bf16 (round to nearest even) ``[ntiles, slices, tile_n, 64]``, one
    contiguous block per (N tile, K slice) for one bulk copy a stage:
    :func:`_pack_blocks` of ``w`` as ``[k*k*Cin, 2*Cout]`` (tap-major K,
    as ``w.reshape``) in 64-deep slices, ``tile_n`` the
    :func:`wgmma_tile_n` of ``Cout``."""
    k, _, cin, c2 = w.shape
    return _pack_blocks(w.reshape(k * k * cin, c2), WGMMA_K,
                        wgmma_tile_n(c2 // 2)).to(torch.bfloat16).contiguous()


def pack_kxk_tf32(w: torch.Tensor) -> torch.Tensor:
    """The wgmma loop's f32-mode weight: HWIO ``w [k, k, Cin, 2*Cout]``
    as ``[ntiles, slices, 2, tile_n, 32]`` float32: per (N tile, K slice)
    the :func:`tf32_split` ``hi`` block, then the ``lo`` block, each in
    :func:`_pack_blocks`' layout of ``w`` as ``[k*k*Cin, 2*Cout]`` with
    32-deep slices (one 128-byte f32 row), ``tile_n`` the
    :func:`wgmma_tile_n` of ``Cout`` (:func:`pack_1x1_tf32`'s layout)."""
    k, _, cin, c2 = w.shape
    return _tf32_blocks(w.reshape(k * k * cin, c2), wgmma_tile_n(c2 // 2))


IM2COL_PIXELS = 128  # pixels a TMA im2col load: a tile (gcw::TF32_BM)


def im2col_copy_params(x_shape, k: int, stride: int) -> dict:
    """The host-side parameters of the f32 wgmma loop's A copies for
    ``x [B, H, W, Cin]`` float32 and a k x k conv at ``stride``, zero pad
    ``(k-1)//2`` (``csrc/gated_conv_wgmma.cuh``: ``gcw::encode_im2col``'s
    tensor map and the producer's per-load coordinates compute the same),
    and the walk they define:

    - ``dims`` ``(Cin, W, H, B)`` and ``strides`` (bytes a step in W, H
      and B) of x's tensor map, innermost first;
    - ``box``: ``(32, 128)``, channels and pixels a load (one K slice of
      a 128-pixel tile), stored in the 128-byte swizzle;
    - ``lower`` and ``upper``: the bounding box's corners in ``(W, H)``,
      ``-pad`` past the near edge and ``pad - (k-1)`` past the far one, so
      that its positions at the traversal stride are the top-left taps of
      the output pixels;
    - ``element_strides``: ``(1, stride, stride, 1)``, the traversal
      strides;
    - ``slices``: for each K slice (32 channels of one tap, tap-major),
      ``(c, off_w, off_h)``: its first channel and the tap's im2col
      offsets;
    - ``starts``: ``[tiles, 3]`` int64, ``(w, h, n)`` of each tile's first
      output pixel (pixels ``128 t ..``): its top-left tap in image ``n``,
      where the tile's loads start;
    - ``walk``: ``[tiles, 128, 3]`` int64, the ``(w, h, n)`` each row of a
      tile's load reads at (before the slice's offsets): TMA's im2col
      walk from the start along the bounding box's positions at the
      traversal strides, W first, then the next row of positions in H,
      then the next image; rows past the last image have ``n >= B``.

    Out-of-bounds elements read as zero: the padding, and the pixels past
    the last image in the last tile."""
    b, h, w, cin = x_shape
    pad = (k - 1) // 2
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    m0 = torch.arange(-(-b * ho * wo // IM2COL_PIXELS),
                      dtype=torch.int64) * IM2COL_PIXELS
    n, r = m0 // (ho * wo), m0 % (ho * wo)
    lower, upper = -pad, pad - (k - 1)
    starts = torch.stack([(r % wo) * stride + lower,
                          (r // wo) * stride + lower, n], -1)
    slices = []
    for kidx in range(0, k * k * cin, TF32_K):
        tap = kidx // cin
        slices.append((kidx - tap * cin, tap % k, tap // k))
    # the walk: positions of the bounding box along W and H, then images
    nw = (w - 1 + upper - lower) // stride + 1
    nh = (h - 1 + upper - lower) // stride + 1
    first = (starts[:, 2] * nh + (starts[:, 1] - lower) // stride) * nw \
        + (starts[:, 0] - lower) // stride
    pos = first[:, None] + torch.arange(IM2COL_PIXELS)
    rem = pos % (nh * nw)
    walk = torch.stack([lower + stride * (rem % nw),
                        lower + stride * (rem // nw), pos // (nh * nw)], -1)
    return {"dims": (cin, w, h, b),
            "strides": (4 * cin, 4 * w * cin, 4 * h * w * cin),
            "box": (TF32_K, IM2COL_PIXELS), "lower": (lower, lower),
            "upper": (upper, upper),
            "element_strides": (1, stride, stride, 1), "slices": slices,
            "starts": starts, "walk": walk}


def _launch_wgmma(x, packed, b, scale, offset, res, out, k, stride, relu,
                  ops, what="gated_conv_kxk (wgmma)"):
    """Launch ``gated_conv_kxk_wgmma`` in mode ``ops`` (``OPS_*``; a bool
    is bf16 operands or not) into ``out``; ``packed`` is
    :func:`pack_kxk_bf16` (the bf16 modes) or :func:`pack_kxk_tf32` of
    the weight; ``what`` names the call in an error."""
    bsz, h, wd, cin = x.shape
    cout = out.shape[-1]
    ntiles, tile_n = packed.shape[0], packed.shape[-2]
    fn = _build.function("gated_conv", "gated_conv_kxk_wgmma",
                         _WGMMA_ARGTYPES)
    _build.call(fn, x.device, what, x.data_ptr(), packed.data_ptr(),
                b.data_ptr(), scale.data_ptr(), offset.data_ptr(),
                _ptr(res), out.data_ptr(), bsz, h, wd, cin, cout, k, stride,
                int(relu), tile_n, ntiles, int(ops))


def gated_conv_kxk(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   scale: torch.Tensor, offset: torch.Tensor,
                   res: Optional[torch.Tensor] = None, *, stride: int = 1,
                   relu: bool = True, bf16: bool = False,
                   packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2: gated k x k conv (k in {3, 4}, stride in {1, 2}, zero pad
    ``(k-1)//2``) of ``x [B, H, W, Cin]`` with ``w [k, k, Cin, 2*Cout]``;
    returns ``[B, Ho, Wo, Cout]``. ``packed`` is :func:`pack_kxk_bf16`
    (``bf16``) or :func:`pack_kxk_tf32` of ``w`` for the wgmma loop, or
    a function that returns it (packed here when it is needed and not
    given; ignored by the twin)."""
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
    if kxk_route(x, w, (b, scale, offset, res)) == "wgmma":
        packed = _resolve_packed(packed, pack_kxk_bf16 if bf16
                                 else pack_kxk_tf32, w)
        _check_packed("gated_conv_kxk", packed, w, k * k * cin, cout,
                      wgmma_tile_n(cout), bf16, x.device)
        _launch_wgmma(x, packed, b, scale, offset, res, out, k, stride,
                      relu, OPS_BF16 if bf16 else OPS_TF32X3)
        launches["gated_conv_kxk"] += 1
        launches["gated_conv_kxk_wgmma"] += 1
        launches["gated_conv_kxk_wgmma_tma"] += int(not bf16)
        return out
    fn = _build.function("gated_conv", "gated_conv_kxk", _KXK_ARGTYPES)
    _build.call(fn, x.device, "gated_conv_kxk", x.data_ptr(), w.data_ptr(),
                b.data_ptr(), scale.data_ptr(), offset.data_ptr(),
                _ptr(res), out.data_ptr(), bsz, h, wd, cin, cout, k, stride,
                int(relu), int(bf16))
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
                         bf16=False, packed=None):
    """Plain PyTorch twin of :func:`gated_conv_1x1` (``torch.matmul``);
    ``packed`` is accepted and ignored (it is the same weight)."""
    w2 = w.reshape(w.shape[-2], w.shape[-1])
    if bf16:
        x, w2 = round_bf16(x), round_bf16(w2)
    return gated_epilogue(torch.matmul(x, w2), b, scale, offset, res,
                          relu).contiguous()


def conv1x1_route(xs, cout: int, gated: bool = True, epilogue=()) -> str:
    """Which CUDA loop K3 (``xs = [x]``) or K4 runs for inputs ``xs``
    (``[..., C_j]``), ``cout`` output channels and the ``epilogue``
    tensors (bias, scale, offset, residual; None skipped): ``'wgmma'``
    for a ``gated`` call whose inputs all have ``C_j % 8 == 0`` and
    16-byte aligned data, with ``Cout % 8 == 0`` and 8-byte aligned
    epilogue tensors (the 1x1 wgmma loop, either operand type; its
    epilogue reads channel pairs); ``'tile'`` otherwise (``gated=False``,
    other widths, misaligned views)."""
    if gated and cout % 8 == 0 and all(
            x.shape[-1] % 8 == 0 and x.data_ptr() % 16 == 0 for x in xs) \
            and _epilogue_aligned(epilogue):
        return "wgmma"
    return "tile"


def pack_1x1_bf16(w: torch.Tensor) -> torch.Tensor:
    """The 1x1 loop's bf16 weight: ``w [1, 1, K, 2*Cout]`` or ``[K,
    2*Cout]`` (K the concatenated input channels) as bf16 (round to
    nearest even) ``[ceil(Cout / 32), ceil(K / 64), 64, 64]``:
    :func:`_pack_blocks` in 64-deep slices and 64-column N tiles."""
    w2 = _weight_2d("pack_1x1_bf16", w)
    return _pack_blocks(w2, WGMMA_K, CONV1X1_TILE_N).to(
        torch.bfloat16).contiguous()


def pack_1x1_tf32(w: torch.Tensor) -> torch.Tensor:
    """The 1x1 loop's f32-mode weight: ``w [1, 1, K, 2*Cout]`` or ``[K,
    2*Cout]`` as ``[ceil(Cout / 32), ceil(K / 32), 2, 64, 32]`` float32:
    per (N tile, K slice) the :func:`tf32_split` ``hi`` block, then the
    ``lo`` block, each in :func:`_pack_blocks`' layout with 32-deep
    slices (one 128-byte f32 row) and 64-column N tiles."""
    return _tf32_blocks(_weight_2d("pack_1x1_tf32", w), CONV1X1_TILE_N)


_1X1_WGMMA_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])


def _call_1x1_wgmma(what, xs, packed, b, scale, offset, res, out, relu,
                    ops):
    """Launch ``gated_conv_1x1_wgmma`` in mode ``ops`` (``OPS_*``) over
    inputs ``xs`` into ``out`` with the packed weight ``packed``; ``what``
    names the call in an error."""
    cout = out.shape[-1]
    pad = MAX_CAT - len(xs)
    fn = _build.function("gated_conv", "gated_conv_1x1_wgmma",
                         _1X1_WGMMA_ARGTYPES)
    _build.call(fn, out.device, what, *[x.data_ptr() for x in xs],
                *[None] * pad, *[x.shape[-1] for x in xs], *[0] * pad,
                len(xs), packed.data_ptr(), b.data_ptr(), scale.data_ptr(),
                offset.data_ptr(), _ptr(res), out.data_ptr(),
                out.numel() // max(cout, 1), cout, int(relu), ops)


def _launch_1x1_wgmma(name, xs, w2, packed, b, scale, offset, res, out,
                      relu, bf16):
    """Launch ``gated_conv_1x1_wgmma`` over inputs ``xs`` into ``out``;
    ``packed`` is :func:`pack_1x1_bf16` or :func:`pack_1x1_tf32` of
    ``w2``, or a function that returns it (packed here when not
    given)."""
    packed = _resolve_packed(packed, pack_1x1_bf16 if bf16
                             else pack_1x1_tf32, w2)
    _check_packed(name, packed, w2, sum(x.shape[-1] for x in xs),
                  out.shape[-1], CONV1X1_TILE_N, bf16, out.device)
    _call_1x1_wgmma(f"{name} (wgmma)", xs, packed, b, scale, offset, res,
                    out, relu, OPS_BF16 if bf16 else OPS_TF32X3)
    launches[name] += 1
    launches["gated_conv_1x1_wgmma"] += 1


_1X1_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p])


def gated_conv_1x1(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   scale: torch.Tensor, offset: torch.Tensor,
                   res: Optional[torch.Tensor] = None, *,
                   relu: bool = True, bf16: bool = False,
                   packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3: gated 1x1 conv, ``[..., Cin] @ [Cin, 2*Cout]`` + epilogue.
    ``w`` is ``[1, 1, Cin, 2*Cout]`` or ``[Cin, 2*Cout]``; returns
    ``[..., Cout]``. ``packed`` is :func:`pack_1x1_bf16` (``bf16``) or
    :func:`pack_1x1_tf32` of ``w`` for the 1x1 wgmma loop, or a function
    that returns it (packed here when it is needed and not given;
    ignored by the twin)."""
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
    if conv1x1_route([x], cout, epilogue=(b, scale, offset, res)) \
            == "wgmma":
        _launch_1x1_wgmma("gated_conv_1x1", [x], w, packed, b, scale,
                          offset, res, out, relu, bf16)
        return out
    fn = _build.function("gated_conv", "gated_conv_1x1", _1X1_ARGTYPES)
    _build.call(fn, x.device, "gated_conv_1x1", x.data_ptr(), w.data_ptr(),
                b.data_ptr(), scale.data_ptr(), offset.data_ptr(),
                _ptr(res), out.data_ptr(), n, cin, cout, int(relu),
                int(bf16))
    launches["gated_conv_1x1"] += 1
    return out


def gated_conv_1x1_cat_plain(xs, w, b, scale, offset, res=None, *,
                             relu=True, gated=True, bf16=False,
                             packed=None):
    """Plain PyTorch twin of :func:`gated_conv_1x1_cat`: one
    ``torch.matmul`` per input against its rows of ``w``, summed;
    ``packed`` is accepted and ignored."""
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
                       bf16: bool = False,
                       packed: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """K4: gated 1x1 conv over the channel concat of ``xs`` (1 to 4
    tensors ``[..., C_j]`` with the same leading shape), never
    materialized: ``sum_j x_j @ w[rows of j]`` + epilogue. ``w`` is
    ``[1, 1, sum C_j, C2]`` or ``[sum C_j, C2]`` with ``C2 = 2*Cout``
    (``Cout`` when not ``gated``); returns ``[..., Cout]``. ``packed``
    is the 1x1 wgmma loop's weight, as for :func:`gated_conv_1x1`."""
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
    if conv1x1_route(xs, cout, gated, (b, scale, offset, res)) \
            == "wgmma":
        _launch_1x1_wgmma(name, xs, w, packed, b, scale, offset, res, out,
                          relu, bf16)
        return out
    pad = MAX_CAT - len(xs)
    fn = _build.function("gated_conv", name, _CAT_ARGTYPES)
    _build.call(fn, w.device, name, *[x.data_ptr() for x in xs],
                *[None] * pad, *cins, *[0] * pad, len(xs), w.data_ptr(),
                b.data_ptr(), scale.data_ptr(), offset.data_ptr(),
                _ptr(res), out.data_ptr(), n, cout, int(relu), int(gated),
                int(bf16))
    launches[name] += 1
    return out
