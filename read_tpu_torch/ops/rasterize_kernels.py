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
one level.

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

:func:`zbuffer`, :func:`zbuffer_exact`, :func:`zbuffer_pyramid`,
:func:`zbuffer_splat` and :func:`zbuffer_keys` are the wrappers: a CPU
tensor goes to the plain twin, a CUDA tensor to the kernel, anything
else raises. ``launches[<name>]`` counts kernel launches: ``zbuffer``
and ``zbuffer_exact`` a projection (K1, K5), ``zbuffer_splat`` a splat
projection, ``zbuffer_pyramid`` a pass.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from read_tpu_torch import _build

__all__ = ["INT32_MAX", "INT64_MAX", "MAX_LEVELS", "key_bits",
           "pack_keys", "pack_exact_keys", "unpack_exact", "unpack_packed",
           "scatter_min", "pool_pyramid_plain", "zbuffer", "zbuffer_plain",
           "zbuffer_exact", "zbuffer_exact_plain", "zbuffer_pyramid",
           "zbuffer_pyramid_plain", "MAX_SPLAT_RADIUS", "splat_expand",
           "splat_keys", "zbuffer_splat", "zbuffer_splat_plain", "zbuffer_keys",
           "zbuffer_keys_plain", "launches"]

INT32_MAX = 2 ** 31 - 1
INT64_MAX = 2 ** 63 - 1
# pyramid levels the pass takes: a coarse pixel of 8 levels spans 128 x
# 128 pixels of level 0, the largest tile whose keys fit a block's shared
# memory
MAX_LEVELS = 8
# the splat projection's largest half-width (zbuffer.cu kMaxRadius)
MAX_SPLAT_RADIUS = 16
# JAX's coverage thresholds, ``max(|dy|, |dx|) - 1e-4`` rounded once to
# float32 (a weakly typed Python float against a float32 radius)
_SPLAT_THR = [float(np.float32(k - 1e-4)) for k in range(MAX_SPLAT_RADIUS + 1)]

# kernel launches (a CPU call runs the twin and counts nothing)
launches = {"zbuffer": 0, "zbuffer_exact": 0, "zbuffer_keys": 0,
            "zbuffer_pyramid": 0, "zbuffer_splat": 0}


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


def unpack_exact(buf: torch.Tensor):
    """Least-key buffer -> ``(index int32, depth float32)``: -1/0 where
    empty (``INT64_MAX``), else the id and the exact depth."""
    empty = buf == INT64_MAX
    index = torch.where(empty, -1, (buf & 0xFFFFFFFF).to(torch.int32))
    depth = (buf >> 32).to(torch.int32).view(torch.float32)
    return index, torch.where(empty, 0.0, depth)


def unpack_packed(buf: torch.Tensor, idb: int, depth_by_id: torch.Tensor):
    """Min packed-key buffer -> ``(index, depth)``: -1/0 where empty
    (``INT32_MAX``), else the id bits and the winner's exact depth
    gathered from ``depth_by_id`` (same leading dims as ``buf``)."""
    empty = buf == INT32_MAX
    index = torch.where(empty, -1, buf & ((1 << idb) - 1))
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


def _projected(xyz: torch.Tensor, total_m: torch.Tensor, h: int, w: int):
    """The twins' projection: ``(pix [B, N], depth [B, N], ndc, valid)``
    with off-frame points in the ``h*w`` dump slot."""
    # rasterize.py imports this module, so import its helpers lazily
    from read_tpu_torch.ops.rasterize import _pixel_ids, project_points
    ndc, valid = project_points(xyz, total_m)            # [B, N, 3]
    pix, depth = _pixel_ids(ndc, valid, h, w)
    return pix, depth, ndc, valid


def zbuffer_plain(xyz: torch.Tensor, total_m: torch.Tensor, h: int,
                  w: int):
    """Plain PyTorch twin of :func:`zbuffer` (same contract)."""
    b, n = total_m.shape[0], xyz.shape[0]
    pix, depth, ndc, valid = _projected(xyz, total_m, h, w)
    ids = torch.arange(n, dtype=torch.int32, device=xyz.device)
    key, _ = pack_keys(pix, depth, ids.expand(b, n), h * w, n)
    depth0 = torch.where(valid, (ndc[..., 2] + 1.0) * 0.5, 0.0)
    return scatter_min(pix, key, h * w), depth0


def zbuffer_exact_plain(xyz: torch.Tensor, total_m: torch.Tensor, h: int,
                        w: int):
    """Plain PyTorch twin of :func:`zbuffer_exact` (same contract)."""
    b, n = total_m.shape[0], xyz.shape[0]
    pix, depth, _, _ = _projected(xyz, total_m, h, w)
    ids = torch.arange(n, dtype=torch.int32, device=xyz.device)
    key = pack_exact_keys(pix, depth, ids.expand(b, n), h * w)
    return unpack_exact(scatter_min(pix, key, h * w))


def pool_pyramid_plain(index: torch.Tensor, depth: torch.Tensor,
                       num_scales: int, pool_impl: str, n_ids: int):
    """Level 0 ``(index, depth [B, h, w])`` and ``num_scales - 1`` coarser
    levels, each the 2x2 minimum of one key: for ``pool_impl`` 'exact'
    :func:`pack_exact_keys`' (the least depth, ties to the least id), for
    'packed' :func:`pack_keys`' (ties within one depth bin to the least
    id; coarse depths are the bins ``q / qmax``). Empty pixels are -1
    with depth 0 at every level."""
    if pool_impl == "exact":
        bits = depth.view(torch.int32).to(torch.int64)
        key = torch.where(index < 0, INT64_MAX,
                          (bits << 32) | index.to(torch.int64))
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
                          pool_impl: str = "exact"):
    """Plain PyTorch twin of :func:`zbuffer_pyramid` (same contract):
    K5's or K1's twin, then :func:`pool_pyramid_plain`."""
    b, n = total_m.shape[0], xyz.shape[0]
    if method == "sort":
        index, depth = zbuffer_exact_plain(xyz, total_m, h, w)
    else:
        buf, depth0 = zbuffer_plain(xyz, total_m, h, w)
        index, depth = unpack_packed(buf, key_bits(n)[0], depth0)
    return pool_pyramid_plain(index.view(b, h, w), depth.view(b, h, w),
                              num_scales, pool_impl, n)


def _on_cpu(name: str, xyz: torch.Tensor, total_m: torch.Tensor) -> bool:
    """Check the wrappers' inputs; True for CPU tensors (the twin runs),
    False for contiguous CUDA tensors (the kernel runs); raise else."""
    if xyz.dtype != torch.float32 or total_m.dtype != torch.float32:
        raise TypeError(f"{name}: xyz and total_m must be float32")
    if xyz.dim() != 2 or xyz.shape[1] != 3 or total_m.dim() != 3 \
            or tuple(total_m.shape[1:]) != (4, 4):
        raise ValueError(f"{name}: want xyz [N,3], total_m [B,4,4]; got "
                         f"{tuple(xyz.shape)}, {tuple(total_m.shape)}")
    if xyz.device != total_m.device:
        raise ValueError(f"{name}: xyz and total_m on different devices")
    if xyz.device.type == "cpu":
        return True
    if xyz.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {xyz.device}")
    if not (xyz.is_contiguous() and total_m.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    return False


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_PYRAMID_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 9 \
    + [ctypes.c_void_p] * 4
# zbuffer_pyramid's, less its stream, then sizes, radius, relative,
# min_size, the thresholds and the stream
_SPLAT_ARGTYPES = _PYRAMID_ARGTYPES[:-1] + [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]


def zbuffer(xyz: torch.Tensor, total_m: torch.Tensor, h: int, w: int):
    """Project ``xyz [N, 3]`` by ``total_m [B, 4, 4]`` (float32,
    contiguous) and z-buffer every view at ``h x w``.

    Returns ``(buf [B, h*w] int32, depth0 [B, N] float32)``: the
    per-pixel minimum packed key (``INT32_MAX`` = empty; id bits from
    :func:`key_bits` with ``n_ids = N``) and each point's NDC depth
    (0 for points outside the clip cube), from which callers re-gather
    the winner's exact depth."""
    if _on_cpu("zbuffer", xyz, total_m):
        return zbuffer_plain(xyz, total_m, h, w)
    n, b = xyz.shape[0], total_m.shape[0]
    idb, qmax = key_bits(n)
    buf = torch.full((b, h * w), INT32_MAX, dtype=torch.int32,
                     device=xyz.device)
    depth0 = torch.empty((b, n), dtype=torch.float32, device=xyz.device)
    fn = _build.function("zbuffer", "zbuffer_project", _ARGTYPES)
    _build.call(fn, xyz.device, "zbuffer", xyz.data_ptr(),
                total_m.data_ptr(), n, b, h, w, idb, qmax, buf.data_ptr(),
                depth0.data_ptr())
    launches["zbuffer"] += 1
    return buf, depth0


def zbuffer_exact(xyz: torch.Tensor, total_m: torch.Tensor, h: int,
                  w: int):
    """Project ``xyz [N, 3]`` by ``total_m [B, 4, 4]`` (float32,
    contiguous) and z-buffer every view at ``h x w`` exactly: per pixel
    the least depth, ties to the least point id (``N < 2^31``).

    Returns ``(index [B, h*w] int32, depth [B, h*w] float32)``: the
    winning point id and its depth ``(ndc_z + 1) / 2``, -1 and 0 where
    no point lands. On the card: K5 and a one-level pyramid pass."""
    if xyz.shape[0] >= 2 ** 31:
        raise ValueError("zbuffer_exact: point ids must fit in 31 bits")
    if _on_cpu("zbuffer_exact", xyz, total_m):
        return zbuffer_exact_plain(xyz, total_m, h, w)
    (index, depth), = _pyramid_launch("zbuffer_exact", xyz, total_m, h, w,
                                      1, "sort", "exact")
    b = total_m.shape[0]
    return index.view(b, h * w), depth.view(b, h * w)


def _check_pyramid(xyz: torch.Tensor, h: int, w: int, num_scales: int,
                   method: str, pool_impl: str) -> None:
    """The pyramid's refusals, alike on every device."""
    if method not in ("sort", "pallas"):
        raise ValueError(f"zbuffer_pyramid: method {method!r} is not "
                         "'sort' (K5) or 'pallas' (K1)")
    if pool_impl not in ("exact", "packed"):
        raise ValueError(f"unknown pool_impl {pool_impl!r}")
    if not 1 <= num_scales <= MAX_LEVELS:
        raise ValueError(f"zbuffer_pyramid: num_scales {num_scales} not "
                         f"in 1..{MAX_LEVELS}")
    span = 1 << (num_scales - 1)
    if h % span or w % span:
        raise ValueError(f"zbuffer_pyramid: {h}x{w} is not divisible by "
                         f"2^(num_scales - 1) = {span}")
    if xyz.shape[0] >= 2 ** 31:
        raise ValueError("zbuffer_pyramid: point ids must fit in 31 bits")
    if method == "pallas" or pool_impl == "packed":
        key_bits(xyz.shape[0])   # raises above 2^23 ids


def _pyramid_launch(name: str, xyz: torch.Tensor, total_m: torch.Tensor,
                    h: int, w: int, num_scales: int, method: str,
                    pool_impl: str, splat=None):
    """K1 (``method`` 'pallas') or K5 ('sort') and the pyramid pass on
    the card: the levels as views of one buffer (every level's index,
    then every level's depth, then the key scratch, each part 16-byte
    aligned). ``splat``: ``(sizes or None, radius, relative, min_size)``
    runs the splat projection in place of K1 or K5."""
    n, b = xyz.shape[0], total_m.shape[0]
    exact_in = method == "sort"
    idb, qmax = (key_bits(n) if not exact_in or pool_impl == "packed"
                 else (0, 0))
    sizes = [(h >> i, w >> i) for i in range(num_scales)]
    counts = [b * hh * ww for hh, ww in sizes]
    part = -(-sum(counts) // 4) * 4     # int32 words, a multiple of 16 B
    buf = torch.empty(2 * part + b * h * w * (2 if exact_in else 1),
                      dtype=torch.int32, device=xyz.device)
    base = buf.data_ptr()
    args = (xyz.data_ptr(), total_m.data_ptr(), n, b, h, w, num_scales,
            int(exact_in), int(pool_impl == "exact"), idb, qmax,
            base + 8 * part, base, base + 4 * part)
    if splat is None:
        fn = _build.function("zbuffer", "zbuffer_pyramid", _PYRAMID_ARGTYPES)
        _build.call(fn, xyz.device, name, *args)
        launches["zbuffer_exact" if exact_in else "zbuffer"] += 1
    else:
        point_sizes, radius, relative, min_size = splat
        fn = _build.function("zbuffer", "zbuffer_splat_pyramid",
                             _SPLAT_ARGTYPES)
        thr = (ctypes.c_float * (radius + 1))(*_SPLAT_THR[:radius + 1])
        _build.call(fn, xyz.device, name, *args,
                    None if point_sizes is None else point_sizes.data_ptr(),
                    radius, int(relative), min_size, thr)
        launches["zbuffer_splat"] += 1
    launches["zbuffer_pyramid"] += 1
    # one as_strided a view: the cheapest on the host
    depth = buf.view(torch.float32)
    out, off = [], 0
    for (hh, ww), c in zip(sizes, counts):
        shape, stride = (b, hh, ww), (hh * ww, ww, 1)
        out.append((buf.as_strided(shape, stride, off),
                    depth.as_strided(shape, stride, part + off)))
        off += c
    return out


def zbuffer_pyramid(xyz: torch.Tensor, total_m: torch.Tensor, h: int,
                    w: int, num_scales: int, method: str = "sort",
                    pool_impl: str = "exact"):
    """Project ``xyz [N, 3]`` by ``total_m [B, 4, 4]`` (float32,
    contiguous), z-buffer every view at ``h x w`` (``method`` 'sort':
    K5's exact key; 'pallas': K1's packed key) and pool it to
    ``num_scales`` levels (``pool_impl`` 'exact': the least (depth, id);
    'packed': the least packed key, coarse depths ``q / qmax``).

    Returns ``rasterize_pyramid_pooled``'s list of ``(index [B, h_i,
    w_i] int32, depth float32)``, ``h_i = h >> i``: -1 and 0 where
    empty; level 0's depth is the winner's exact depth. ``h`` and ``w``
    must be divisible by ``2^(num_scales - 1)``, ``num_scales <=
    MAX_LEVELS``; K1 or a packed pool takes at most 2^23 points. On the
    card: K1 or K5 and one pass for every level (three device
    operations: the fill, the projection, the pass)."""
    _check_pyramid(xyz, h, w, num_scales, method, pool_impl)
    if _on_cpu("zbuffer_pyramid", xyz, total_m):
        return zbuffer_pyramid_plain(xyz, total_m, h, w, num_scales, method,
                                     pool_impl)
    return _pyramid_launch("zbuffer_pyramid", xyz, total_m, h, w,
                           num_scales, method, pool_impl)


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
                 relative_size: bool = False, min_point_size: float = 1.0):
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
    (``torch.maximum``/``minimum``, as ``jnp``'s)."""
    from read_tpu_torch.ops.rasterize import project_points
    ndc, valid, clip_z = project_points(xyz, total_m, return_clip_z=True)
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
               relative_size: bool = False, min_point_size: float = 1.0):
    """The ``[B, N*K]`` arrays JAX's splat z-buffers take: ``(pix, key,
    depth0)``, :func:`splat_expand`'s pixel ids, each copy's K5 exact key
    ('sort') or K1 packed key ('pallas', id bits from N points), and each
    point's depth (0 where it is invalid), which 'pallas' gathers by
    id."""
    b, n, npx = total_m.shape[0], xyz.shape[0], h * w
    pix, depth0, valid = splat_expand(xyz, total_m, h, w, point_radius,
                                      point_sizes, relative_size,
                                      min_point_size)
    depth0 = torch.where(valid, depth0, 0.0)
    k = pix.shape[-1] // n
    ids = torch.arange(n, dtype=torch.int32, device=xyz.device).repeat(k)
    ids, dep = ids.expand(b, n * k), depth0.repeat(1, k)
    if method == "sort":
        return pix, pack_exact_keys(pix, dep, ids, npx), depth0
    return pix, pack_keys(pix, dep, ids, npx, n)[0], depth0


def zbuffer_splat_plain(xyz: torch.Tensor, total_m: torch.Tensor, h: int,
                        w: int, num_scales: int, method: str,
                        pool_impl: str, point_radius: int, point_sizes=None,
                        relative_size: bool = False,
                        min_point_size: float = 1.0):
    """Plain PyTorch twin of :func:`zbuffer_splat` (same contract): JAX's
    ``[B, N*K]`` arrays (:func:`splat_keys`), their per-pixel minimum key
    (:func:`scatter_min`), unpacked (the 'pallas' winner's depth gathered
    by id), then :func:`pool_pyramid_plain`."""
    b, n = total_m.shape[0], xyz.shape[0]
    pix, key, depth0 = splat_keys(xyz, total_m, h, w, method, point_radius,
                                  point_sizes, relative_size, min_point_size)
    buf = scatter_min(pix, key, h * w)
    index, depth = (unpack_exact(buf) if method == "sort" else
                    unpack_packed(buf, key_bits(n)[0], depth0))
    return pool_pyramid_plain(index.view(b, h, w), depth.view(b, h, w),
                              num_scales, pool_impl, n)


def zbuffer_splat(xyz: torch.Tensor, total_m: torch.Tensor, h: int, w: int,
                  num_scales: int, method: str, pool_impl: str,
                  point_radius: int, point_sizes=None,
                  relative_size: bool = False, min_point_size: float = 1.0):
    """:func:`zbuffer_pyramid` with every point splatted over the
    ``(2r+1)^2`` square around its pixel, ``r = point_radius`` in
    ``1..MAX_SPLAT_RADIUS``, with JAX's coverage rule (see
    :func:`splat_expand`; ``point_sizes [N]`` per-point sizes,
    ``relative_size`` z-scaled sizes floored at ``min_point_size``, both
    capped at ``2r+1``). Returns ``rasterize_pyramid_pooled``'s levels;
    level 0 is splatted, the coarser ones pooled from it. On the card:
    the fill, the splat projection and the pyramid pass, no ``[B, N*K]``
    array."""
    _check_pyramid(xyz, h, w, num_scales, method, pool_impl)
    if not 1 <= point_radius <= MAX_SPLAT_RADIUS:
        raise ValueError(f"zbuffer_splat: point_radius {point_radius} not "
                         f"in 1..{MAX_SPLAT_RADIUS}")
    if _on_cpu("zbuffer_splat", xyz, total_m):
        return zbuffer_splat_plain(xyz, total_m, h, w, num_scales, method,
                                   pool_impl, point_radius, point_sizes,
                                   relative_size, min_point_size)
    sizes = _splat_sizes(point_sizes, xyz)
    return _pyramid_launch("zbuffer_splat", xyz, total_m, h, w, num_scales,
                           method, pool_impl,
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
