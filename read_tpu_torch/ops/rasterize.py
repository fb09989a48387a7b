"""Point projection, the z-buffer paths and the index pyramid.

Counterpart of ``read_tpu/ops/rasterize.py``: ``project_points``
(:81-120), ``_pixel_ids`` (:123-131), ``rasterize_batch`` for
``method in ('sort', 'sort2', 'scatter')`` (:497-515, ``_zbuffer_sort``
:153-177, ``_zbuffer_sort2`` :180-201, ``_zbuffer`` :134-150 and the
splat's two scatter-mins :394-401, one function: here K5), for
``method='sort1q'`` (``_zbuffer_sort1q`` :204-241: here the quantized key
of the projection, the splat and the pass) and for ``method in
('pallas', 'scatter1')`` (:516-545, ``_zbuffer_scatter1`` :244-284: here
K1), with splats and per-point or z-scaled sizes
(``rasterize`` :346-401, ``_rasterize_batch_pallas_splat`` :404-463:
here K6's splat projection), and ``rasterize_pyramid_pooled``
(:637-669) with its pools ``_pool2x2_zbuffer`` (:574-599) and
``_pool2x2_packed`` (:602-634).

Both entry points run :func:`read_tpu_torch.ops.rasterize_kernels.
zbuffer_pyramid` (``point_radius`` 0) or :func:`~read_tpu_torch.ops.
rasterize_kernels.zbuffer_splat` (``point_radius`` > 0): on the card K1,
K5, the quantized key or the splat projection and one pass that writes
every level (``rasterize_batch`` is the one-level case); on the CPU their
plain twins. With ``point_radius`` 0 JAX's offsets are ``(0, 0)`` alone,
so per-point and z-scaled sizes change nothing and the projection runs.
The pass
pools each level as the 2x2 minimum of one key, which is
``_pool2x2_zbuffer``'s pair pool for the exact 64-bit key; that pair
pool stays here as the reference the tests and the kernel bench hold it
to. Semantics are the JAX package's, bit for bit: 'sort', 'sort2' and
'scatter' keep per pixel the least depth, ties to the least id;
'sort1q' the least (depth bin, id) with ``rasterize_kernels.quant_bits``'
bins of the frame, 'pallas'/'scatter1' the min packed key, each with
ties within one depth bin broken by the least id and the winner's depth
exact; empty pixels are -1 with depth 0. One difference is on purpose:
JAX's 'sort1q' splat reads its winner's depth from the expanded
array's first offset copy, 2.0 where that copy missed the frame or the
point's size; here it is the winner's own depth. Supersampling
needs nothing here: the pipeline and the renderer rasterize at ``ss``
times the size. Screen-space point jitter (``ndc_jitter [N, 2]``, from
:mod:`read_tpu_torch.ops.augment`) goes to the kernels, which add it to
each point's NDC x and y after the clip test and before the floor, one
offset a point for every view, as ``rasterize.py:328-331`` does.
"""

from __future__ import annotations

from typing import Sequence

import torch

from read_tpu_torch.ops import rasterize_kernels as RK

__all__ = ["RASTER_METHODS", "project_points", "rasterize_batch",
           "rasterize_pyramid_pooled"]

# Sentinel depth for invalid points; any real NDC depth lies in [0, 1].
_FAR = 2.0

# Every name ``read_tpu`` accepts (``rasterize.py:60-61``) and the
# z-buffer of ``rasterize_kernels`` that computes it: the exact methods
# K5, the packed-key ones K1
RASTER_METHODS = ("sort", "sort2", "sort1q", "scatter", "scatter1",
                  "pallas")
_ZBUFFER = {"sort": "sort", "sort2": "sort", "scatter": "sort",
            "sort1q": "sort1q", "scatter1": "pallas", "pallas": "pallas"}


def _check_method(method: str) -> None:
    if method not in RASTER_METHODS:
        raise ValueError(f"unknown raster method {method!r}; expected one "
                         f"of {RASTER_METHODS}")


def project_points(xyz: torch.Tensor, total_m: torch.Tensor,
                   return_clip_z: bool = False):
    """World points to NDC: ``(ndc [..., N, 3], valid [..., N])``, with
    ``return_clip_z`` also the clip-space z before the divide (what
    z-scaled splat sizes divide by).

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

    w, clip_z = row(3), row(2)
    ndc = torch.stack([row(0) / w, row(1) / w, clip_z / w], dim=-1)
    valid = torch.all(ndc.abs() <= 1.0, dim=-1) & (w > 0)
    if return_clip_z:
        return ndc, valid, clip_z
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


def rasterize_batch(xyz: torch.Tensor, total_m: torch.Tensor, h: int,
                    w: int, point_radius: int = 0, method: str = "sort",
                    ndc_jitter=None, point_sizes=None,
                    relative_size: bool = False,
                    min_point_size: float = 1.0):
    """``total_m [B, 4, 4]`` -> ``(index [B, h, w] int32, depth [B, h, w]
    float32)``: 'sort' (the default), 'sort2' and 'scatter' through K5,
    'sort1q' through the quantized key, 'pallas' or 'scatter1' through
    K1; with ``point_radius`` r > 0 each point covers the
    ``(2r+1)^2`` square around its pixel (per-point ``point_sizes [N]``
    or ``relative_size`` sizes, floored at ``min_point_size``, capped at
    ``2r+1``; JAX's coverage rule) through the splat projection.
    ``ndc_jitter [N, 2]`` moves each point's NDC x and y in every view
    (after the clip test; the depth as it is)."""
    (level0,) = rasterize_pyramid_pooled(
        xyz, total_m, (h, w), 1, point_radius, method, ndc_jitter,
        point_sizes, relative_size, min_point_size)
    return level0


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
    'exact' pools the (depth, id) pair, 'packed' one packed key. Splats
    (``point_radius`` > 0, see :func:`rasterize_batch`) cover level 0
    only; the coarser levels pool it. ``ndc_jitter [N, 2]`` as in
    :func:`rasterize_batch`. On the card: the projection (K1, K5 or the
    quantized key) or the splat projection and one pyramid pass, no
    plain-PyTorch pool."""
    _check_method(method)
    if point_radius < 0:
        raise ValueError(f"point_radius {point_radius} < 0")
    h0, w0 = target_shape
    xyz = xyz.to(torch.float32).contiguous()
    total_m = total_m.to(device=xyz.device, dtype=torch.float32
                         ).contiguous()
    if ndc_jitter is not None:
        ndc_jitter = ndc_jitter.to(device=xyz.device, dtype=torch.float32
                                   ).contiguous()
    zmethod = _ZBUFFER[method]
    if point_radius == 0:
        return RK.zbuffer_pyramid(xyz, total_m, h0, w0, num_scales, zmethod,
                                  pool_impl, jitter=ndc_jitter)
    return RK.zbuffer_splat(xyz, total_m, h0, w0, num_scales, zmethod,
                            pool_impl, point_radius, point_sizes,
                            relative_size, min_point_size,
                            jitter=ndc_jitter)
