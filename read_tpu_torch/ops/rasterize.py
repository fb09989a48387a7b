"""Point projection, the packed z-buffer path and the index pyramid.

Counterpart of ``read_tpu/ops/rasterize.py`` for the serving slice:
``project_points`` (:81-120), ``_pixel_ids`` (:123-131),
``_zbuffer_scatter1`` (:244-284: here ``RK.pack_keys`` ->
``RK.scatter_min`` -> ``_unpack``), ``rasterize_batch`` for
``method in ('pallas', 'scatter1')`` with ``point_radius=0``
(:466-548), ``_pool2x2_zbuffer`` (:574-599), ``_pool2x2_packed``
(:602-634) and ``rasterize_pyramid_pooled`` (:637-669).

Everything here is plain PyTorch except the z-buffer itself, which is
K1 (:mod:`read_tpu_torch.ops.rasterize_kernels`). Semantics are the
JAX package's, bit for bit: min packed key per pixel, ties within one
depth bin broken by the smallest id, empty pixels -1 with depth 0, the
winner's depth re-gathered exactly. Raster methods and options the port
does not have yet raise ``NotImplementedError`` instead of switching to
other semantics.
"""

from __future__ import annotations

from typing import Sequence

import torch

from read_tpu_torch.ops import rasterize_kernels as RK

__all__ = ["RASTER_METHODS", "project_points", "rasterize_batch",
           "rasterize_pyramid_pooled"]

# Sentinel depth for invalid points; any real NDC depth lies in [0, 1].
_FAR = 2.0

# Every name ``read_tpu`` accepts (``rasterize.py:60-61``); only the
# packed-key methods run here.
RASTER_METHODS = ("sort", "sort2", "sort1q", "scatter", "scatter1",
                  "pallas")
K1_METHODS = ("pallas", "scatter1")


def _check_method(method: str) -> None:
    if method not in RASTER_METHODS:
        raise ValueError(f"unknown raster method {method!r}; expected one "
                         f"of {RASTER_METHODS}")
    if method not in K1_METHODS:
        raise NotImplementedError(
            f"raster method {method!r} is not ported: read_tpu_torch runs "
            "the packed-key z-buffer ('pallas'/'scatter1'); the exact "
            "'sort' semantics need K1's 64-bit key mode (ROADMAP queue 2, "
            "K1)")


def project_points(xyz: torch.Tensor, total_m: torch.Tensor):
    """World points to NDC: ``(ndc [..., N, 3], valid [..., N])``.

    ``total_m`` is ``[4, 4]`` or ``[B, 4, 4]`` (row-major world->clip).
    The product is expanded element-wise in JAX's order, ``((m0*x +
    m1*y) + m2*z) + m3``, never as a matmul, so f32 rounding (and with it
    every boundary pixel) matches ``read_tpu`` and the CUDA kernel."""
    xyz = xyz.to(torch.float32)
    m = total_m.to(torch.float32)
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]

    def row(i):
        return (m[..., i, 0, None] * x + m[..., i, 1, None] * y
                + m[..., i, 2, None] * z + m[..., i, 3, None])

    w = row(3)
    ndc = torch.stack([row(0) / w, row(1) / w, row(2) / w], dim=-1)
    valid = torch.all(ndc.abs() <= 1.0, dim=-1) & (w > 0)
    return ndc, valid


def _pixel_ids(ndc: torch.Tensor, valid: torch.Tensor, h: int, w: int):
    """NDC -> flat pixel ids (invalid -> ``h*w`` dump slot) and depths."""
    u = torch.floor(w * (ndc[..., 0] + 1.0) * 0.5).to(torch.int32)
    v = torch.floor(h * (1.0 - ndc[..., 1]) * 0.5).to(torch.int32)
    depth = (ndc[..., 2] + 1.0) * 0.5
    inside = valid & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    pix = torch.where(inside, v * w + u, h * w)
    depth = torch.where(inside, depth, _FAR)
    return pix, depth


def _unpack(buf: torch.Tensor, idb: int, depth_by_id: torch.Tensor):
    """Min-key buffer -> ``(index, depth)``: -1/0 where empty, else the
    id bits and the winner's exact depth gathered from ``depth_by_id``
    (same leading dims as ``buf``)."""
    empty = buf == RK.INT32_MAX
    index = torch.where(empty, -1, buf & ((1 << idb) - 1))
    depth = torch.gather(depth_by_id, -1, index.clamp(min=0).long())
    return index, torch.where(empty, 0.0, depth)


def _unported_options(point_radius, ndc_jitter, point_sizes,
                      relative_size) -> None:
    if point_radius or point_sizes is not None or relative_size:
        raise NotImplementedError(
            "splats and per-point sizes are not ported (ROADMAP queue 1, "
            "item 9)")
    if ndc_jitter is not None:
        raise NotImplementedError(
            "screen-space point jitter is not ported (ROADMAP queue 1, "
            "item 9, ops/augment.py)")


def rasterize_batch(xyz: torch.Tensor, total_m: torch.Tensor, h: int,
                    w: int, point_radius: int = 0, method: str = "sort",
                    ndc_jitter=None, point_sizes=None,
                    relative_size: bool = False,
                    min_point_size: float = 1.0):
    """``total_m [B, 4, 4]`` -> ``(index [B, h, w] int32, depth [B, h, w]
    float32)`` through K1; ``method`` must be 'pallas' or 'scatter1'
    (the JAX default 'sort' raises: it has exact tie semantics)."""
    del min_point_size  # only meaningful with relative_size
    _check_method(method)
    _unported_options(point_radius, ndc_jitter, point_sizes, relative_size)
    b = total_m.shape[0]
    xyz = xyz.to(torch.float32).contiguous()
    total_m = total_m.to(device=xyz.device, dtype=torch.float32
                         ).contiguous()
    buf, depth0 = RK.zbuffer(xyz, total_m, h, w)
    idb, _ = RK.key_bits(xyz.shape[0])
    index, depth = _unpack(buf, idb, depth0)
    return index.view(b, h, w), depth.view(b, h, w)


def _pool2x2_zbuffer(index: torch.Tensor, depth: torch.Tensor):
    """Exact 2x2 (depth, id) lexicographic-min pooling of ``[B, h, w]``
    buffers (the coarse winner is exactly the min of its 4 sub-pixels
    because pixel coordinates are floors of one projection)."""
    b, h, w = index.shape
    ix = index.reshape(b, h // 2, 2, w // 2, 2)
    dp = depth.reshape(b, h // 2, 2, w // 2, 2)
    dp = torch.where(ix < 0, _FAR, dp)  # empty -> +inf for the min
    oi, od = ix[:, :, 0, :, 0], dp[:, :, 0, :, 0]
    for sy, sx in ((0, 1), (1, 0), (1, 1)):
        ic, dc = ix[:, :, sy, :, sx], dp[:, :, sy, :, sx]
        better = (dc < od) | ((dc == od) & (ic < oi))
        oi, od = torch.where(better, ic, oi), torch.where(better, dc, od)
    return oi, torch.where(oi < 0, 0.0, od)


def _pool2x2_packed(index: torch.Tensor, depth: torch.Tensor, n_ids: int,
                    num_scales: int):
    """Coarse levels by 2x2 min-pooling ONE packed int32 key; ties within
    one depth bin break by id (the fine level's own rule), coarse depths
    are bin values ``q / qmax``, level 0 stays exact."""
    idb, qmax = RK.key_bits(n_ids)
    q = torch.clamp(depth * qmax, 0, qmax - 1).to(torch.int32)
    key = torch.where(index < 0, RK.INT32_MAX, (q << idb) | index)
    out = [(index, depth)]
    for _ in range(1, num_scales):
        b, hh, ww = key.shape
        key = key.reshape(b, hh // 2, 2, ww // 2, 2).amin(dim=(2, 4))
        empty = key == RK.INT32_MAX
        ix = torch.where(empty, -1, key & ((1 << idb) - 1))
        # divide by a full tensor: PyTorch's CUDA division by a scalar
        # multiplies by its reciprocal, which rounds differently from
        # JAX's (and the CPU's) true division
        qf = (key >> idb).to(torch.float32)
        dq = torch.where(empty, 0.0, qf / torch.full_like(qf, qmax))
        out.append((ix, dq))
    return out


def rasterize_pyramid_pooled(xyz: torch.Tensor, total_m: torch.Tensor,
                             target_shape: Sequence[int],
                             num_scales: int = 5, point_radius: int = 0,
                             method: str = "sort", ndc_jitter=None,
                             point_sizes=None,
                             relative_size: bool = False,
                             min_point_size: float = 1.0,
                             pool_impl: str = "exact"):
    """One full-resolution raster + 2x2 pooling to ``num_scales``
    levels: a list of ``(index [B, h_i, w_i], depth)``. ``pool_impl``
    'exact' pools the (depth, id) pair, 'packed' one packed key."""
    if pool_impl not in ("exact", "packed"):
        raise ValueError(f"unknown pool_impl {pool_impl!r}")
    h0, w0 = target_shape
    idx, dep = rasterize_batch(xyz, total_m, h0, w0, point_radius, method,
                               ndc_jitter, point_sizes, relative_size,
                               min_point_size)
    if pool_impl == "packed":
        return _pool2x2_packed(idx, dep, xyz.shape[0], num_scales)
    out = [(idx, dep)]
    for _ in range(1, num_scales):
        idx, dep = _pool2x2_zbuffer(idx, dep)
        out.append((idx, dep))
    return out
