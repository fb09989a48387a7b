"""The z-buffer kernels (``csrc/zbuffer.cu``) and their twins.

K1, the packed int32 key: counterpart of ``read_tpu/ops/
rasterize_pallas.py`` ``pack_keys`` (:295-308) and ``zbuffer_pallas2`` /
``_kernel2`` (:145-231) as called by ``rasterize_batch(method='pallas')``
(``rasterize.py:516-545``).

K5, the exact 64-bit key: counterpart of ``rasterize_pallas.py``
``zbuffer_pallas`` / ``_kernel`` (:40-135), which computes what
``rasterize_batch(method='sort')`` does (``rasterize.py:497-515`` ->
``_zbuffer_sort`` :153-177): per pixel the least depth, ties to the
least id, empty pixels -1 with depth 0.

Both CUDA kernels also fuse the projection and pixel mapping that feed
them, one thread a point over all views (see the source's header note).

The pyramid pass turns K1's or K5's key buffer into every level of
``rasterize.py``'s ``rasterize_pyramid_pooled`` (:637-669) in one
launch: level 0's index and exact depth (K1's winner depth re-projected
from its point), and each coarser level as the 2x2 minimum of one key,
the 64-bit exact key for the exact pool (``_pool2x2_zbuffer``
:574-599: the lexicographic (depth, id) minimum) or the packed int32 key
for the packed pool (``_pool2x2_packed`` :602-634). :func:`zbuffer_pyramid`
runs the projection and the pass, :func:`zbuffer_exact` the same with
one level. :func:`zbuffer_pool` runs the pass alone on an exact key
buffer the caller made: the multi-device z-merge
(:mod:`read_tpu_torch.parallel.sharded`) hands it the keys that a MIN
all-reduce merged over the points shards.

The quantized key of ``method='sort1q'`` (``rasterize.py``
``_zbuffer_sort1q`` :204-241, which JAX runs one view at a time): per
pixel the least ``(q, id)``, ``q = clip(round(depth * qq), 0, qq)``
rounded half to even, ``qq = 2^db - 1``, ``db`` the most bits with
``(h*w + 2) << db < 2^31`` (:func:`quant_bits`; 12 at 1216x368, 14 at
256x256). Depths within one bin tie to the least id; the winner's depth
is exact, its point's depth. On the card it is a third key mode of the
projection, of the splat projection and of the pass: the 64-bit key
``(q << 32) | id`` (:func:`pack_quant_keys`) and each point's depth,
which level 0 gathers by the winner's id (:func:`zbuffer_quant`). A
splat's winner depth is its point's depth; JAX's splat re-gathers the
expanded array's first offset copy, 2.0 where that copy missed the
frame, which this module does not copy.

K6, the packed int32 key on keys the caller made: counterpart of
``rasterize_pallas.py`` ``zbuffer_pallas3`` / ``_kernel3`` (:234-292)
and of ``zbuffer_pallas2``'s contract on given keys: K1 without the
fused projection (:func:`zbuffer_keys`). Its user path in the JAX
package is the splat (``rasterize.py`` ``rasterize`` :346-401,
``_rasterize_batch_pallas_splat`` :404-463): each point expanded into
``(2r+1)^2`` offset copies, ``[B, N*K]`` pixel ids and keys handed to
the given-key kernel ('pallas') or sorted ('sort'). Here that path is
:func:`zbuffer_splat`: the splat projection, which expands the square
inside the kernel and z-buffers it with K5's exact key or K1's packed
key, then the pyramid pass; :func:`zbuffer_splat_plain` builds JAX's
expansion as JAX does (:func:`splat_expand`).

K1, K5 and the splat projection take an optional per-point NDC jitter
``[N, 2]`` (``read_tpu/ops/augment.py``'s screen-space perturbation, as
``rasterize.py`` adds it at :328-331, :419-420 and :502-503): one offset
a point for every view, added to the NDC x and y after the clip test and
before the floor; the depth carries none. Every wrapper and twin takes it
as ``jitter`` (None: no jitter).

:func:`zbuffer`, :func:`zbuffer_exact`, :func:`zbuffer_quant`,
:func:`zbuffer_pyramid`, :func:`zbuffer_splat` and :func:`zbuffer_keys`
are the wrappers: a CPU tensor goes to the plain twin, a CUDA tensor to
the kernel, anything else raises. ``launches[<name>]`` counts kernel
launches: ``zbuffer``, ``zbuffer_exact`` and ``zbuffer_quant`` a
projection (K1, K5, the quantized key), ``zbuffer_splat`` a splat
projection (any key), each with ``_jitter`` appended where it ran with a
jitter (and then only there), ``zbuffer_pyramid`` a pass,
``zbuffer_pool`` a pass on given keys.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from read_tpu_torch import _build

__all__ = ["INT32_MAX", "INT64_MAX", "MAX_LEVELS", "METHODS", "key_bits",
           "quant_bits", "pack_keys", "pack_exact_keys", "pack_quant_keys",
           "exact_keys", "unpack_exact", "unpack_packed",
           "scatter_min", "pool_pyramid_plain", "zbuffer", "zbuffer_plain",
           "zbuffer_exact", "zbuffer_exact_plain", "zbuffer_quant",
           "zbuffer_quant_plain", "zbuffer_pyramid",
           "zbuffer_pyramid_plain", "zbuffer_pool", "zbuffer_pool_plain",
           "MAX_SPLAT_RADIUS", "splat_expand",
           "splat_keys", "zbuffer_splat", "zbuffer_splat_plain",
           "zbuffer_keys", "zbuffer_keys_plain", "launches"]

INT32_MAX = 2 ** 31 - 1
INT64_MAX = 2 ** 63 - 1
# pyramid levels the pass takes: a coarse pixel of 8 levels spans 128 x
# 128 pixels of level 0, the largest tile whose keys fit a block's shared
# memory
MAX_LEVELS = 8
# the pyramid's z-buffers by key: K1's packed key, K5's exact key, the
# quantized key (zbuffer.cu KeyMode)
METHODS = {"pallas": 0, "sort": 1, "sort1q": 2}
# the splat projection's largest half-width (zbuffer.cu kMaxRadius)
MAX_SPLAT_RADIUS = 16
# JAX's coverage thresholds, ``max(|dy|, |dx|) - 1e-4`` rounded once to
# float32 (a weakly typed Python float against a float32 radius)
_SPLAT_THR = [float(np.float32(k - 1e-4)) for k in range(MAX_SPLAT_RADIUS + 1)]

# kernel launches (a CPU call runs the twin and counts nothing)
launches = {"zbuffer": 0, "zbuffer_exact": 0, "zbuffer_quant": 0,
            "zbuffer_keys": 0, "zbuffer_pyramid": 0, "zbuffer_splat": 0,
            "zbuffer_jitter": 0, "zbuffer_exact_jitter": 0,
            "zbuffer_quant_jitter": 0, "zbuffer_splat_jitter": 0,
            "zbuffer_pool": 0}
# the projection counter of each method
_PROJECTION = {"pallas": "zbuffer", "sort": "zbuffer_exact",
               "sort1q": "zbuffer_quant"}


def _counted(name: str, jitter) -> str:
    """The launch counter of kernel ``name`` run with or without a
    jitter."""
    return name if jitter is None else name + "_jitter"


def key_bits(n_ids: int):
    """``(idb, qmax)``: id bits and the largest depth bin of the packed
    key, ``idb = max(1, (n_ids - 1).bit_length())``, ``qmax =
    2^(31 - idb) - 1`` (20 id bits and 11 depth bits at 1M points)."""
    idb = max(1, (n_ids - 1).bit_length())
    db = 31 - idb
    if db < 8:
        raise ValueError(
            f"packed z-buffer: only {db} depth bits for {n_ids} ids; more "
            "than 2^23 points need the exact z-buffer (method 'sort', K5)")
    return idb, (1 << db) - 1


def quant_bits(n_pixels: int):
    """``(db, qq)``: the quantized key's depth bits and largest bin, ``db``
    the most with ``(n_pixels + 2) << db < 2^31``, ``qq = 2^db - 1``
    (``_zbuffer_sort1q``'s); fewer than 8 bits raise."""
    db = 0
    while (n_pixels + 2) << (db + 1) < 2 ** 31:
        db += 1
    if db < 8:
        raise ValueError(f"sort1q: only {db} depth bits for {n_pixels} "
                         "pixels; use method='sort'")
    return db, (1 << db) - 1


def pack_keys(pix: torch.Tensor, depth: torch.Tensor, ids: torch.Tensor,
              n_pixels: int, n_ids: int):
    """``key = trunc(clip(depth * qmax, 0, qmax - 1)) << idb | id``;
    points with ``pix >= n_pixels`` get ``INT32_MAX``. Returns
    ``(key, idb)`` (``rasterize_pallas.pack_keys`` parity: the depth is
    truncated, not rounded, and the bin qmax is never used so a covered
    far-plane pixel cannot equal the empty sentinel)."""
    idb, qmax = key_bits(n_ids)
    q = torch.clamp(depth * qmax, 0, qmax - 1).to(torch.int32)
    key = torch.where(pix < n_pixels, (q << idb) | ids.to(torch.int32),
                      INT32_MAX)
    return key, idb


def pack_exact_keys(pix: torch.Tensor, depth: torch.Tensor,
                    ids: torch.Tensor, n_pixels: int) -> torch.Tensor:
    """K5's int64 key ``(float bits of depth) << 32 | id``; points with
    ``pix >= n_pixels`` get ``INT64_MAX``. Depths in [0, 1] are
    non-negative floats, which order like their bits, so the least key
    is the least depth, ties to the least id (ids below 2^31)."""
    bits = depth.to(torch.float32).view(torch.int32).to(torch.int64)
    key = (bits << 32) | ids.to(torch.int64)
    return torch.where(pix < n_pixels, key, INT64_MAX)


def pack_quant_keys(pix: torch.Tensor, depth: torch.Tensor,
                    ids: torch.Tensor, n_pixels: int, qq: int) -> torch.Tensor:
    """The quantized int64 key ``clip(round(depth * qq), 0, qq) << 32 |
    id`` (float32 product, rounded half to even, then clipped, as JAX
    computes the bin); points with ``pix >= n_pixels`` get
    ``INT64_MAX``."""
    qf = torch.full_like(depth, qq)
    q = torch.minimum(torch.round(depth * qf).clamp(min=0.0), qf)
    key = (q.to(torch.int64) << 32) | ids.to(torch.int64)
    return torch.where(pix < n_pixels, key, INT64_MAX)


def exact_keys(index: torch.Tensor, depth: torch.Tensor,
               id_offset: int = 0) -> torch.Tensor:
    """K5's int64 key of a z-buffer's ``(index, depth)`` (-1 = empty):
    ``(float bits of depth) << 32 | (index + id_offset)``, ``INT64_MAX``
    where empty; the inverse of :func:`unpack_exact` for ``id_offset``
    0."""
    bits = depth.view(torch.int32).to(torch.int64)
    return torch.where(index < 0, INT64_MAX,
                       (bits << 32) | (index.to(torch.int64) + id_offset))


def unpack_exact(buf: torch.Tensor):
    """Least-key buffer -> ``(index int32, depth float32)``: -1/0 where
    empty (``INT64_MAX``), else the id and the exact depth."""
    empty = buf == INT64_MAX
    index = torch.where(empty, -1, (buf & 0xFFFFFFFF).to(torch.int32))
    depth = (buf >> 32).to(torch.int32).view(torch.float32)
    return index, torch.where(empty, 0.0, depth)


def unpack_packed(buf: torch.Tensor, idb: int, depth_by_id: torch.Tensor):
    """Min packed-key buffer -> ``(index int32, depth)``: -1/0 where empty
    (the dtype's max: ``INT32_MAX``, or ``INT64_MAX`` for the quantized
    key, whose id bits are 32), else the id bits and the winner's exact
    depth gathered from ``depth_by_id`` (same leading dims as ``buf``)."""
    empty = buf == torch.iinfo(buf.dtype).max
    index = torch.where(empty, -1, buf & ((1 << idb) - 1)).to(torch.int32)
    depth = torch.gather(depth_by_id, -1, index.clamp(min=0).long())
    return index, torch.where(empty, 0.0, depth)


def scatter_min(pix: torch.Tensor, key: torch.Tensor, n_pixels: int):
    """Per-pixel minimum of ``key`` (int32 or int64) over the last dim of
    ``pix [..., N]`` (the dtype's max = empty): ``[..., n_pixels]``.
    Pixel ids ``>= n_pixels`` land in a dump slot that is cut off
    (``rasterize._zbuffer_scatter1`` parity)."""
    buf = torch.full((*pix.shape[:-1], n_pixels + 1),
                     torch.iinfo(key.dtype).max, dtype=key.dtype,
                     device=pix.device)
    buf.scatter_reduce_(-1, pix.clamp(max=n_pixels).long(), key, "amin",
                        include_self=True)
    return buf[..., :n_pixels].contiguous()


def _jittered(ndc: torch.Tensor, jitter) -> torch.Tensor:
    """``ndc [..., N, 3]`` with ``jitter [N, 2]`` added to x and y of
    every view (``ndc.at[..., :2].add(jitter)``); the depth as it is."""
    if jitter is None:
        return ndc
    return torch.cat([ndc[..., :2] + jitter, ndc[..., 2:]], dim=-1)


def _projected(xyz: torch.Tensor, total_m: torch.Tensor, h: int, w: int,
               jitter=None):
    """The twins' projection: ``(pix [B, N], depth [B, N], ndc, valid)``
    with off-frame points in the ``h*w`` dump slot. ``valid`` is the clip
    test on the unjittered NDC; ``pix`` floors the jittered one."""
    # rasterize.py imports this module, so import its helpers lazily
    from read_tpu_torch.ops.rasterize import _pixel_ids, project_points
    ndc, valid = project_points(xyz, total_m)            # [B, N, 3]
    pix, depth = _pixel_ids(_jittered(ndc, jitter), valid, h, w)
    return pix, depth, ndc, valid


def zbuffer_plain(xyz: torch.Tensor, total_m: torch.Tensor, h: int,
                  w: int, jitter=None):
    """Plain PyTorch twin of :func:`zbuffer` (same contract)."""
    b, n = total_m.shape[0], xyz.shape[0]
    pix, depth, ndc, valid = _projected(xyz, total_m, h, w, jitter)
    ids = torch.arange(n, dtype=torch.int32, device=xyz.device)
    key, _ = pack_keys(pix, depth, ids.expand(b, n), h * w, n)
    depth0 = torch.where(valid, (ndc[..., 2] + 1.0) * 0.5, 0.0)
    return scatter_min(pix, key, h * w), depth0


def zbuffer_exact_plain(xyz: torch.Tensor, total_m: torch.Tensor, h: int,
                        w: int, jitter=None):
    """Plain PyTorch twin of :func:`zbuffer_exact` (same contract)."""
    b, n = total_m.shape[0], xyz.shape[0]
    pix, depth, _, _ = _projected(xyz, total_m, h, w, jitter)
    ids = torch.arange(n, dtype=torch.int32, device=xyz.device)
    key = pack_exact_keys(pix, depth, ids.expand(b, n), h * w)
    return unpack_exact(scatter_min(pix, key, h * w))


def zbuffer_quant_plain(xyz: torch.Tensor, total_m: torch.Tensor, h: int,
                        w: int, jitter=None):
    """Plain PyTorch twin of :func:`zbuffer_quant` (same contract):
    :func:`pack_quant_keys`, ``scatter_reduce_`` amin, the winner's depth
    gathered by id."""
    b, n = total_m.shape[0], xyz.shape[0]
    pix, depth, ndc, valid = _projected(xyz, total_m, h, w, jitter)
    ids = torch.arange(n, dtype=torch.int32, device=xyz.device)
    key = pack_quant_keys(pix, depth, ids.expand(b, n), h * w,
                          quant_bits(h * w)[1])
    depth0 = torch.where(valid, (ndc[..., 2] + 1.0) * 0.5, 0.0)
    return unpack_packed(scatter_min(pix, key, h * w), 32, depth0)


def pool_pyramid_plain(index: torch.Tensor, depth: torch.Tensor,
                       num_scales: int, pool_impl: str, n_ids: int):
    """Level 0 ``(index, depth [B, h, w])`` and ``num_scales - 1`` coarser
    levels, each the 2x2 minimum of one key: for ``pool_impl`` 'exact'
    :func:`pack_exact_keys`' (the least depth, ties to the least id), for
    'packed' :func:`pack_keys`' (ties within one depth bin to the least
    id; coarse depths are the bins ``q / qmax``). Empty pixels are -1
    with depth 0 at every level."""
    if pool_impl == "exact":
        key = exact_keys(index, depth)
    else:
        idb, qmax = key_bits(n_ids)
        q = torch.clamp(depth * qmax, 0, qmax - 1).to(torch.int32)
        key = torch.where(index < 0, INT32_MAX, (q << idb) | index)
    out = [(index, depth)]
    for _ in range(1, num_scales):
        b, hh, ww = key.shape
        key = key.reshape(b, hh // 2, 2, ww // 2, 2).amin(dim=(2, 4))
        if pool_impl == "exact":
            out.append(unpack_exact(key))
            continue
        empty = key == INT32_MAX
        ix = torch.where(empty, -1, key & ((1 << idb) - 1))
        # divide by a full tensor: PyTorch's CUDA division by a scalar
        # multiplies by its reciprocal, which rounds differently from
        # JAX's (and the CPU's) true division
        qf = (key >> idb).to(torch.float32)
        out.append((ix, torch.where(empty, 0.0,
                                    qf / torch.full_like(qf, qmax))))
    return out


def zbuffer_pyramid_plain(xyz: torch.Tensor, total_m: torch.Tensor, h: int,
                          w: int, num_scales: int, method: str = "sort",
                          pool_impl: str = "exact", jitter=None):
    """Plain PyTorch twin of :func:`zbuffer_pyramid` (same contract):
    K5's, the quantized key's or K1's twin, then
    :func:`pool_pyramid_plain`."""
    b, n = total_m.shape[0], xyz.shape[0]
    if method == "sort":
        index, depth = zbuffer_exact_plain(xyz, total_m, h, w, jitter)
    elif method == "sort1q":
        index, depth = zbuffer_quant_plain(xyz, total_m, h, w, jitter)
    else:
        buf, depth0 = zbuffer_plain(xyz, total_m, h, w, jitter)
        index, depth = unpack_packed(buf, key_bits(n)[0], depth0)
    return pool_pyramid_plain(index.view(b, h, w), depth.view(b, h, w),
                              num_scales, pool_impl, n)


def _on_cpu(name: str, xyz: torch.Tensor, total_m: torch.Tensor,
            jitter=None) -> bool:
    """Check the wrappers' inputs; True for CPU tensors (the twin runs),
    False for contiguous CUDA tensors (the kernel runs); raise else.
    ``jitter``, where given, is float32 ``[N, 2]`` on ``xyz``'s device."""
    if xyz.dtype != torch.float32 or total_m.dtype != torch.float32:
        raise TypeError(f"{name}: xyz and total_m must be float32")
    if xyz.dim() != 2 or xyz.shape[1] != 3 or total_m.dim() != 3 \
            or tuple(total_m.shape[1:]) != (4, 4):
        raise ValueError(f"{name}: want xyz [N,3], total_m [B,4,4]; got "
                         f"{tuple(xyz.shape)}, {tuple(total_m.shape)}")
    if xyz.device != total_m.device:
        raise ValueError(f"{name}: xyz and total_m on different devices")
    if jitter is not None:
        if jitter.dtype != torch.float32:
            raise TypeError(f"{name}: jitter must be float32")
        if tuple(jitter.shape) != (xyz.shape[0], 2):
            raise ValueError(f"{name}: want jitter [{xyz.shape[0]}, 2]; got "
                             f"{tuple(jitter.shape)}")
        if jitter.device != xyz.device:
            raise ValueError(f"{name}: jitter and xyz on different devices")
    if xyz.device.type == "cpu":
        return True
    if xyz.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {xyz.device}")
    if not (xyz.is_contiguous() and total_m.is_contiguous()
            and (jitter is None or jitter.is_contiguous())):
        raise ValueError(f"{name}: inputs must be contiguous")
    return False


def _ptr(t) -> int:
    """A tensor's device address, or None (a null pointer)."""
    return None if t is None else t.data_ptr()


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p]
_PYRAMID_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 9 \
    + [ctypes.c_void_p] * 5
# zbuffer_quant_pyramid's: xyz, mats, 9 ints (exact_pool in exact_in's
# place, then qq), keys, index, depth, depth0, jitter, stream
_QUANT_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 9 \
    + [ctypes.c_void_p] * 6
# a pyramid entry's, less its stream, then sizes, radius, relative,
# min_size, the thresholds and the stream
_SPLAT_TAIL = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
               ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]
_SPLAT_ARGTYPES = _PYRAMID_ARGTYPES[:-1] + _SPLAT_TAIL
_QUANT_SPLAT_ARGTYPES = _QUANT_ARGTYPES[:-1] + _SPLAT_TAIL


def zbuffer(xyz: torch.Tensor, total_m: torch.Tensor, h: int, w: int,
            jitter=None):
    """Project ``xyz [N, 3]`` by ``total_m [B, 4, 4]`` (float32,
    contiguous) and z-buffer every view at ``h x w``.

    Returns ``(buf [B, h*w] int32, depth0 [B, N] float32)``: the
    per-pixel minimum packed key (``INT32_MAX`` = empty; id bits from
    :func:`key_bits` with ``n_ids = N``) and each point's NDC depth
    (0 for points outside the clip cube), from which callers re-gather
    the winner's exact depth. ``jitter [N, 2]``: NDC offsets (see the
    module's note)."""
    if _on_cpu("zbuffer", xyz, total_m, jitter):
        return zbuffer_plain(xyz, total_m, h, w, jitter)
    n, b = xyz.shape[0], total_m.shape[0]
    idb, qmax = key_bits(n)
    buf = torch.full((b, h * w), INT32_MAX, dtype=torch.int32,
                     device=xyz.device)
    depth0 = torch.empty((b, n), dtype=torch.float32, device=xyz.device)
    fn = _build.function("zbuffer", "zbuffer_project", _ARGTYPES)
    _build.call(fn, xyz.device, "zbuffer", xyz.data_ptr(),
                total_m.data_ptr(), n, b, h, w, idb, qmax, buf.data_ptr(),
                depth0.data_ptr(), _ptr(jitter))
    launches[_counted("zbuffer", jitter)] += 1
    return buf, depth0


def zbuffer_exact(xyz: torch.Tensor, total_m: torch.Tensor, h: int,
                  w: int, jitter=None):
    """Project ``xyz [N, 3]`` by ``total_m [B, 4, 4]`` (float32,
    contiguous) and z-buffer every view at ``h x w`` exactly: per pixel
    the least depth, ties to the least point id (``N < 2^31``).

    Returns ``(index [B, h*w] int32, depth [B, h*w] float32)``: the
    winning point id and its depth ``(ndc_z + 1) / 2``, -1 and 0 where
    no point lands. ``jitter [N, 2]``: NDC offsets (see the module's
    note). On the card: K5 and a one-level pyramid pass."""
    if xyz.shape[0] >= 2 ** 31:
        raise ValueError("zbuffer_exact: point ids must fit in 31 bits")
    if _on_cpu("zbuffer_exact", xyz, total_m, jitter):
        return zbuffer_exact_plain(xyz, total_m, h, w, jitter)
    (index, depth), = _pyramid_launch("zbuffer_exact", xyz, total_m, h, w,
                                      1, "sort", "exact", jitter)
    b = total_m.shape[0]
    return index.view(b, h * w), depth.view(b, h * w)


def zbuffer_quant(xyz: torch.Tensor, total_m: torch.Tensor, h: int,
                  w: int, jitter=None):
    """Project ``xyz [N, 3]`` by ``total_m [B, 4, 4]`` (float32,
    contiguous) and z-buffer every view at ``h x w`` with the quantized
    key (``method='sort1q'``): per pixel the least ``(q, id)``, ``q`` the
    depth's bin of :func:`quant_bits`.

    Returns ``(index [B, h*w] int32, depth [B, h*w] float32)``: the
    winning point id and its exact depth, -1 and 0 where no point lands.
    ``jitter [N, 2]``: NDC offsets (see the module's note). On the card:
    the projection in its quantized mode and a one-level pass."""
    if xyz.shape[0] >= 2 ** 31:
        raise ValueError("zbuffer_quant: point ids must fit in 31 bits")
    quant_bits(h * w)   # raises below 8 depth bits
    if _on_cpu("zbuffer_quant", xyz, total_m, jitter):
        return zbuffer_quant_plain(xyz, total_m, h, w, jitter)
    (index, depth), = _pyramid_launch("zbuffer_quant", xyz, total_m, h, w,
                                      1, "sort1q", "exact", jitter)
    b = total_m.shape[0]
    return index.view(b, h * w), depth.view(b, h * w)


def _check_levels(name: str, h: int, w: int, num_scales: int) -> None:
    """The pass's refusals of a level count and size."""
    if not 1 <= num_scales <= MAX_LEVELS:
        raise ValueError(f"{name}: num_scales {num_scales} not "
                         f"in 1..{MAX_LEVELS}")
    span = 1 << (num_scales - 1)
    if h % span or w % span:
        raise ValueError(f"{name}: {h}x{w} is not divisible by "
                         f"2^(num_scales - 1) = {span}")


def _check_pyramid(xyz: torch.Tensor, h: int, w: int, num_scales: int,
                   method: str, pool_impl: str) -> None:
    """The pyramid's refusals, alike on every device."""
    if method not in METHODS:
        raise ValueError(f"zbuffer_pyramid: method {method!r} is not "
                         "'sort' (K5), 'pallas' (K1) or 'sort1q'")
    if pool_impl not in ("exact", "packed"):
        raise ValueError(f"unknown pool_impl {pool_impl!r}")
    _check_levels("zbuffer_pyramid", h, w, num_scales)
    if xyz.shape[0] >= 2 ** 31:
        raise ValueError("zbuffer_pyramid: point ids must fit in 31 bits")
    if method == "pallas" or pool_impl == "packed":
        key_bits(xyz.shape[0])   # raises above 2^23 ids
    if method == "sort1q":
        quant_bits(h * w)        # raises below 8 depth bits


def _pyramid_launch(name: str, xyz: torch.Tensor, total_m: torch.Tensor,
                    h: int, w: int, num_scales: int, method: str,
                    pool_impl: str, jitter=None, splat=None):
    """K1 (``method`` 'pallas'), K5 ('sort') or the quantized key
    ('sort1q') and the pyramid pass on the card: the levels as views of
    one buffer (every level's index, then every level's depth, then the
    key scratch, then for 'sort1q' each point's depth, each part 16-byte
    aligned). ``splat``: ``(sizes or None, radius, relative, min_size)``
    runs the splat projection in place of the projection."""
    n, b = xyz.shape[0], total_m.shape[0]
    quant = method == "sort1q"
    idb, qmax = (key_bits(n) if method == "pallas" or pool_impl == "packed"
                 else (0, 0))
    words = b * h * w * (1 if method == "pallas" else 2)
    buf, part = _level_buffer(b, h, w, num_scales,
                              words + (b * n if quant else 0), xyz.device)
    base = buf.data_ptr()
    keys, index, depth = base + 8 * part, base, base + 4 * part
    exact_pool = int(pool_impl == "exact")
    if quant:
        args = (xyz.data_ptr(), total_m.data_ptr(), n, b, h, w, num_scales,
                exact_pool, idb, qmax, quant_bits(h * w)[1], keys, index,
                depth, keys + 4 * words, _ptr(jitter))
        entry, argtypes = "zbuffer_quant_pyramid", _QUANT_ARGTYPES
    else:
        args = (xyz.data_ptr(), total_m.data_ptr(), n, b, h, w, num_scales,
                METHODS[method], exact_pool, idb, qmax, keys, index, depth,
                _ptr(jitter))
        entry, argtypes = "zbuffer_pyramid", _PYRAMID_ARGTYPES
    if splat is None:
        fn = _build.function("zbuffer", entry, argtypes)
        _build.call(fn, xyz.device, name, *args)
        launches[_counted(_PROJECTION[method], jitter)] += 1
    else:
        point_sizes, radius, relative, min_size = splat
        fn = _build.function(
            "zbuffer", entry.replace("_pyramid", "_splat_pyramid"),
            _QUANT_SPLAT_ARGTYPES if quant else _SPLAT_ARGTYPES)
        thr = (ctypes.c_float * (radius + 1))(*_SPLAT_THR[:radius + 1])
        _build.call(fn, xyz.device, name, *args,
                    _ptr(point_sizes),
                    radius, int(relative), min_size, thr)
        launches[_counted("zbuffer_splat", jitter)] += 1
    launches["zbuffer_pyramid"] += 1
    return _level_views(buf, part, b, h, w, num_scales)


def _level_buffer(b: int, h: int, w: int, num_scales: int, scratch: int,
                  device):
    """``(buf, part)``: one int32 buffer for every level's index, then
    every level's depth, then ``scratch`` words, each part ``part`` words
    long and 16-byte aligned."""
    total = sum(b * (h >> i) * (w >> i) for i in range(num_scales))
    part = -(-total // 4) * 4     # int32 words, a multiple of 16 B
    return torch.empty(2 * part + scratch, dtype=torch.int32,
                       device=device), part


def _level_views(buf: torch.Tensor, part: int, b: int, h: int, w: int,
                 num_scales: int):
    """The levels ``(index, depth)`` as views of :func:`_level_buffer`'s
    buffer (one as_strided a view: the cheapest on the host)."""
    depth = buf.view(torch.float32)
    out, off = [], 0
    for i in range(num_scales):
        hh, ww = h >> i, w >> i
        shape, stride = (b, hh, ww), (hh * ww, ww, 1)
        out.append((buf.as_strided(shape, stride, off),
                    depth.as_strided(shape, stride, part + off)))
        off += b * hh * ww
    return out


def zbuffer_pool_plain(keys: torch.Tensor, num_scales: int):
    """Plain PyTorch twin of :func:`zbuffer_pool` (same contract):
    :func:`unpack_exact`, then :func:`pool_pyramid_plain`'s exact pool."""
    index, depth = unpack_exact(keys)
    return pool_pyramid_plain(index, depth, num_scales, "exact", 0)


_POOL_ARGTYPES = [ctypes.c_void_p] + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p] * 3


def zbuffer_pool(keys: torch.Tensor, num_scales: int):
    """The pyramid pass alone on a given exact key buffer ``keys [B, h,
    w]`` int64 (:func:`exact_keys`: ``(float bits of depth) << 32 | id``,
    ``INT64_MAX`` where empty; depths non-negative): level 0
    unpacked and ``num_scales - 1`` exact 2x2 pools, as
    :func:`zbuffer_pyramid` returns them (``rasterize_pyramid_pooled``'s
    list of ``(index, depth)``, -1 and 0 where empty). ``h`` and ``w``
    must be divisible by ``2^(num_scales - 1)``, ``num_scales <=
    MAX_LEVELS``. On the card: one pass, no fill and no projection
    (``csrc/zbuffer.cu`` ``zbuffer_pool_keys``); a CUDA buffer must be
    contiguous and 16-byte aligned."""
    if keys.dtype != torch.int64:
        raise TypeError("zbuffer_pool: keys must be int64")
    if keys.dim() != 3:
        raise ValueError(f"zbuffer_pool: want keys [B, h, w]; got "
                         f"{tuple(keys.shape)}")
    b, h, w = keys.shape
    _check_levels("zbuffer_pool", h, w, num_scales)
    if keys.device.type == "cpu":
        return zbuffer_pool_plain(keys, num_scales)
    if keys.device.type != "cuda":
        raise RuntimeError(f"zbuffer_pool: no kernel for device "
                           f"{keys.device}")
    if not keys.is_contiguous() or keys.data_ptr() % 16:
        raise ValueError("zbuffer_pool: keys must be contiguous and "
                         "16-byte aligned")
    buf, part = _level_buffer(b, h, w, num_scales, 0, keys.device)
    fn = _build.function("zbuffer", "zbuffer_pool_keys", _POOL_ARGTYPES)
    _build.call(fn, keys.device, "zbuffer_pool", keys.data_ptr(), b, h, w,
                num_scales, buf.data_ptr(), buf.data_ptr() + 4 * part)
    launches["zbuffer_pool"] += 1
    return _level_views(buf, part, b, h, w, num_scales)


def zbuffer_pyramid(xyz: torch.Tensor, total_m: torch.Tensor, h: int,
                    w: int, num_scales: int, method: str = "sort",
                    pool_impl: str = "exact", jitter=None):
    """Project ``xyz [N, 3]`` by ``total_m [B, 4, 4]`` (float32,
    contiguous), z-buffer every view at ``h x w`` (``method`` 'sort':
    K5's exact key; 'pallas': K1's packed key; 'sort1q': the quantized
    key, :func:`zbuffer_quant`) and pool it to
    ``num_scales`` levels (``pool_impl`` 'exact': the least (depth, id);
    'packed': the least packed key, coarse depths ``q / qmax``).

    Returns ``rasterize_pyramid_pooled``'s list of ``(index [B, h_i,
    w_i] int32, depth float32)``, ``h_i = h >> i``: -1 and 0 where
    empty; level 0's depth is the winner's exact depth. ``h`` and ``w``
    must be divisible by ``2^(num_scales - 1)``, ``num_scales <=
    MAX_LEVELS``; K1 or a packed pool takes at most 2^23 points,
    'sort1q' a frame of at most ``2^23 - 2`` pixels (8 depth bits).
    ``jitter [N, 2]``: NDC offsets (see the module's note). On the
    card: the projection and one pass for every level (three device
    operations: the fill, the projection, the pass)."""
    _check_pyramid(xyz, h, w, num_scales, method, pool_impl)
    if _on_cpu("zbuffer_pyramid", xyz, total_m, jitter):
        return zbuffer_pyramid_plain(xyz, total_m, h, w, num_scales, method,
                                     pool_impl, jitter)
    return _pyramid_launch("zbuffer_pyramid", xyz, total_m, h, w,
                           num_scales, method, pool_impl, jitter)


def _splat_sizes(point_sizes, xyz: torch.Tensor):
    """``point_sizes`` as a float32 ``[N]`` tensor on ``xyz``'s device
    (``jnp.asarray(point_sizes, float32)``), or None."""
    if point_sizes is None:
        return None
    sizes = torch.as_tensor(point_sizes).to(device=xyz.device,
                                            dtype=torch.float32)
    if sizes.numel() != xyz.shape[0]:
        raise ValueError(f"point_sizes: {sizes.numel()} sizes for "
                         f"{xyz.shape[0]} points")
    return sizes.reshape(-1).contiguous()


def splat_expand(xyz: torch.Tensor, total_m: torch.Tensor, h: int, w: int,
                 point_radius: int, point_sizes=None,
                 relative_size: bool = False, min_point_size: float = 1.0,
                 jitter=None):
    """JAX's splat expansion (``rasterize.py`` ``rasterize`` :368-397):
    ``(pix [B, N*K] int32, depth0 [B, N], valid [B, N])``, ``K =
    (2r+1)^2`` offset copies, dy-major then dx-minor, concatenated along
    the point axis (copy ``j`` of point ``i`` at ``j*N + i``); a copy off
    the frame, of an invalid point or failing the coverage test has
    ``pix = h*w``. With ``point_sizes`` or ``relative_size`` a copy at
    ``k = max(|dy|, |dx|) > 0`` needs ``rad >= float32(k - 1e-4)``,
    ``rad = (min(size, 2r+1) - 1) * 0.5``, ``size`` the point's size
    (``2r+1`` without ``point_sizes``), z-scaled as ``max(min_point_size,
    size / max(clip_z, 1e-6))`` with ``relative_size``; NaN propagates
    (``torch.maximum``/``minimum``, as ``jnp``'s). ``jitter [N, 2]``
    moves every centre (``u``, ``v``) by its NDC offset; ``valid`` and
    the depth stay the unjittered ones."""
    from read_tpu_torch.ops.rasterize import project_points
    ndc, valid, clip_z = project_points(xyz, total_m, return_clip_z=True)
    ndc = _jittered(ndc, jitter)
    u = torch.floor(w * (ndc[..., 0] + 1.0) * 0.5).to(torch.int32)
    v = torch.floor(h * (1.0 - ndc[..., 1]) * 0.5).to(torch.int32)
    depth0 = (ndc[..., 2] + 1.0) * 0.5
    rad = None
    sizes = _splat_sizes(point_sizes, xyz)
    if sizes is not None or relative_size:
        cap = torch.full_like(clip_z, float(2 * point_radius + 1))
        size = cap if sizes is None else sizes.expand_as(clip_z)
        if relative_size:
            size = torch.maximum(
                torch.full_like(clip_z, min_point_size),
                size / torch.maximum(clip_z, torch.full_like(clip_z, 1e-6)))
        rad = (torch.minimum(size, cap) - 1.0) * 0.5
    pix = []
    for dy in range(-point_radius, point_radius + 1):
        for dx in range(-point_radius, point_radius + 1):
            uu, vv = u + dx, v + dy
            inside = valid & (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
            if rad is not None and (dy or dx):
                inside &= rad >= _SPLAT_THR[max(abs(dy), abs(dx))]
            pix.append(torch.where(inside, vv * w + uu, h * w))
    return torch.cat(pix, dim=-1), depth0, valid


def splat_keys(xyz: torch.Tensor, total_m: torch.Tensor, h: int, w: int,
               method: str, point_radius: int, point_sizes=None,
               relative_size: bool = False, min_point_size: float = 1.0,
               jitter=None):
    """The ``[B, N*K]`` arrays JAX's splat z-buffers take: ``(pix, key,
    depth0)``, :func:`splat_expand`'s pixel ids, each copy's K5 exact key
    ('sort'), quantized key ('sort1q') or K1 packed key ('pallas', id
    bits from N points), and each point's depth (0 where it is invalid),
    which 'pallas' and 'sort1q' gather by id."""
    b, n, npx = total_m.shape[0], xyz.shape[0], h * w
    pix, depth0, valid = splat_expand(xyz, total_m, h, w, point_radius,
                                      point_sizes, relative_size,
                                      min_point_size, jitter)
    depth0 = torch.where(valid, depth0, 0.0)
    k = pix.shape[-1] // n
    ids = torch.arange(n, dtype=torch.int32, device=xyz.device).repeat(k)
    ids, dep = ids.expand(b, n * k), depth0.repeat(1, k)
    if method == "sort":
        return pix, pack_exact_keys(pix, dep, ids, npx), depth0
    if method == "sort1q":
        return pix, pack_quant_keys(pix, dep, ids, npx,
                                    quant_bits(npx)[1]), depth0
    return pix, pack_keys(pix, dep, ids, npx, n)[0], depth0


def zbuffer_splat_plain(xyz: torch.Tensor, total_m: torch.Tensor, h: int,
                        w: int, num_scales: int, method: str,
                        pool_impl: str, point_radius: int, point_sizes=None,
                        relative_size: bool = False,
                        min_point_size: float = 1.0, jitter=None):
    """Plain PyTorch twin of :func:`zbuffer_splat` (same contract): JAX's
    ``[B, N*K]`` arrays (:func:`splat_keys`), their per-pixel minimum key
    (:func:`scatter_min`), unpacked (the 'pallas' and 'sort1q' winner's
    depth gathered by id), then :func:`pool_pyramid_plain`."""
    b, n = total_m.shape[0], xyz.shape[0]
    pix, key, depth0 = splat_keys(xyz, total_m, h, w, method, point_radius,
                                  point_sizes, relative_size, min_point_size,
                                  jitter)
    buf = scatter_min(pix, key, h * w)
    if method == "sort":
        index, depth = unpack_exact(buf)
    elif method == "sort1q":
        index, depth = unpack_packed(buf, 32, depth0)
    else:
        index, depth = unpack_packed(buf, key_bits(n)[0], depth0)
    return pool_pyramid_plain(index.view(b, h, w), depth.view(b, h, w),
                              num_scales, pool_impl, n)


def zbuffer_splat(xyz: torch.Tensor, total_m: torch.Tensor, h: int, w: int,
                  num_scales: int, method: str, pool_impl: str,
                  point_radius: int, point_sizes=None,
                  relative_size: bool = False, min_point_size: float = 1.0,
                  jitter=None):
    """:func:`zbuffer_pyramid` with every point splatted over the
    ``(2r+1)^2`` square around its pixel, ``r = point_radius`` in
    ``1..MAX_SPLAT_RADIUS``, with JAX's coverage rule (see
    :func:`splat_expand`; ``point_sizes [N]`` per-point sizes,
    ``relative_size`` z-scaled sizes floored at ``min_point_size``, both
    capped at ``2r+1``; ``jitter [N, 2]`` NDC offsets of the centres, see
    the module's note). Returns ``rasterize_pyramid_pooled``'s levels;
    level 0 is splatted, the coarser ones pooled from it. On the card:
    the fill, the splat projection and the pyramid pass, no ``[B, N*K]``
    array."""
    _check_pyramid(xyz, h, w, num_scales, method, pool_impl)
    if not 1 <= point_radius <= MAX_SPLAT_RADIUS:
        raise ValueError(f"zbuffer_splat: point_radius {point_radius} not "
                         f"in 1..{MAX_SPLAT_RADIUS}")
    if _on_cpu("zbuffer_splat", xyz, total_m, jitter):
        return zbuffer_splat_plain(xyz, total_m, h, w, num_scales, method,
                                   pool_impl, point_radius, point_sizes,
                                   relative_size, min_point_size, jitter)
    sizes = _splat_sizes(point_sizes, xyz)
    return _pyramid_launch("zbuffer_splat", xyz, total_m, h, w, num_scales,
                           method, pool_impl, jitter,
                           (sizes, point_radius, relative_size,
                            float(min_point_size)))


def zbuffer_keys_plain(pix: torch.Tensor, key: torch.Tensor,
                       n_pixels: int) -> torch.Tensor:
    """Plain PyTorch twin of :func:`zbuffer_keys` (``scatter_reduce_``
    amin, :func:`scatter_min`)."""
    return scatter_min(pix, key, n_pixels)


_KEYS_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                  ctypes.c_void_p]


def zbuffer_keys(pix: torch.Tensor, key: torch.Tensor,
                 n_pixels: int) -> torch.Tensor:
    """K6: the per-pixel minimum of the packed int32 ``key`` (e.g. from
    :func:`pack_keys`) over points with flat pixel ids ``pix >= 0``,
    both ``[N]`` (one view) or ``[B, N]``. A ``pix >= n_pixels`` is
    dropped. Returns ``[n_pixels]`` or ``[B, n_pixels]`` int32,
    ``INT32_MAX`` where empty."""
    if pix.dtype != torch.int32 or key.dtype != torch.int32:
        raise TypeError("zbuffer_keys: pix and key must be int32")
    if pix.shape != key.shape or pix.dim() not in (1, 2):
        raise ValueError(f"zbuffer_keys: want pix, key both [N] or [B, N];"
                         f" got {tuple(pix.shape)}, {tuple(key.shape)}")
    if pix.device != key.device:
        raise ValueError("zbuffer_keys: pix and key on different devices")
    if pix.device.type == "cpu":
        return zbuffer_keys_plain(pix, key, n_pixels)
    if pix.device.type != "cuda":
        raise RuntimeError(f"zbuffer_keys: no kernel for device "
                           f"{pix.device}")
    if not (pix.is_contiguous() and key.is_contiguous()):
        raise ValueError("zbuffer_keys: inputs must be contiguous")
    b, n = (1, pix.shape[0]) if pix.dim() == 1 else pix.shape
    buf = torch.full((b, n_pixels), INT32_MAX, dtype=torch.int32,
                     device=pix.device)
    fn = _build.function("zbuffer", "zbuffer_keys", _KEYS_ARGTYPES)
    _build.call(fn, pix.device, "zbuffer_keys", pix.data_ptr(),
                key.data_ptr(), n, b, n_pixels, buf.data_ptr())
    launches["zbuffer_keys"] += 1
    return buf if pix.dim() == 2 else buf[0]
