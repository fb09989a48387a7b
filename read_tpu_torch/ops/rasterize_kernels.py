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
them (see the source's header note).

K6, the packed int32 key on keys the caller made: counterpart of
``rasterize_pallas.py`` ``zbuffer_pallas3`` / ``_kernel3`` (:234-292)
and of ``zbuffer_pallas2``'s contract on given keys: K1 without the
fused projection.

:func:`zbuffer`, :func:`zbuffer_exact` and :func:`zbuffer_keys` are the
wrappers: a CPU tensor goes to the plain twin, a CUDA tensor to the
kernel, anything else raises. ``launches[<wrapper name>]`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from read_tpu_torch import _build

__all__ = ["INT32_MAX", "INT64_MAX", "key_bits", "pack_keys",
           "pack_exact_keys", "unpack_exact", "scatter_min", "zbuffer",
           "zbuffer_plain", "zbuffer_exact", "zbuffer_exact_plain",
           "zbuffer_keys", "zbuffer_keys_plain", "launches"]

INT32_MAX = 2 ** 31 - 1
INT64_MAX = 2 ** 63 - 1

# kernel launches (a CPU call runs the twin and counts nothing)
launches = {"zbuffer": 0, "zbuffer_exact": 0, "zbuffer_keys": 0}


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
_EXACT_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]


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
    err = fn(xyz.data_ptr(), total_m.data_ptr(), n, b, h, w, idb, qmax,
             buf.data_ptr(), depth0.data_ptr(),
             torch.cuda.current_stream(xyz.device).cuda_stream)
    _build.check(err, "zbuffer")
    launches["zbuffer"] += 1
    return buf, depth0


def zbuffer_exact(xyz: torch.Tensor, total_m: torch.Tensor, h: int,
                  w: int):
    """Project ``xyz [N, 3]`` by ``total_m [B, 4, 4]`` (float32,
    contiguous) and z-buffer every view at ``h x w`` exactly: per pixel
    the least depth, ties to the least point id (``N < 2^31``).

    Returns ``(index [B, h*w] int32, depth [B, h*w] float32)``: the
    winning point id and its depth ``(ndc_z + 1) / 2``, -1 and 0 where
    no point lands."""
    if xyz.shape[0] >= 2 ** 31:
        raise ValueError("zbuffer_exact: point ids must fit in 31 bits")
    if _on_cpu("zbuffer_exact", xyz, total_m):
        return zbuffer_exact_plain(xyz, total_m, h, w)
    n, b = xyz.shape[0], total_m.shape[0]
    dev = xyz.device
    keys = torch.empty((b, h * w), dtype=torch.int64, device=dev)
    index = torch.empty((b, h * w), dtype=torch.int32, device=dev)
    depth = torch.empty((b, h * w), dtype=torch.float32, device=dev)
    fn = _build.function("zbuffer", "zbuffer_exact_project",
                         _EXACT_ARGTYPES)
    err = fn(xyz.data_ptr(), total_m.data_ptr(), n, b, h, w,
             keys.data_ptr(), index.data_ptr(), depth.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "zbuffer_exact")
    launches["zbuffer_exact"] += 1
    return index, depth


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
    err = fn(pix.data_ptr(), key.data_ptr(), n, b, n_pixels, buf.data_ptr(),
             torch.cuda.current_stream(pix.device).cuda_stream)
    _build.check(err, "zbuffer_keys")
    launches["zbuffer_keys"] += 1
    return buf if pix.dim() == 2 else buf[0]
