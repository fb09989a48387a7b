"""The least work of the triangle raster, from the shapes.

One raster of one view at ``h x w`` over a mesh of ``V`` vertices and
``T`` faces, with its perspective-correct uv map, is counted as the
function's work, whatever computes it (the port's plain raster tests
``samples^2`` candidate pixels a face; a kernel would test fewer):

- bytes, as :mod:`benchmark.flops` counts a conv's: each input read once,
  the vertices (``V x 3`` float32), the faces (``T x 3`` int32) and the
  vertex uv (``V x 2`` float32), and each output written once, the
  face-id map (``h x w`` int32) and the uv map (``h x w x 2`` float32);
- operations: each vertex through the 4x4 matrix (16 multiplies and 12
  adds), divided by its ``w`` (3) and mapped to the screen (4), 35;
  each face's signed area, 5; each pixel's two edge functions (10), two
  barycentric divisions and the third weight (3), its depth (5), the
  perspective weights and their renormalization (8) and the uv blend
  (10), 36.

The bound of a raster is the larger of its operations over the peak and
its bytes over the memory rate, as :func:`benchmark.flops.bound_s`
takes a conv's; a fitting step rasterizes each of its ``batch`` views at
each of ``levels`` sizes ``(h >> i, w >> i)``. P7's raster kernel
(ROADMAP) is read against this count.
"""

from __future__ import annotations

__all__ = ["VERTEX_OPS", "FACE_OPS", "PIXEL_OPS", "raster_ops",
           "raster_bytes", "step_bound_s"]

F32 = I32 = 4
VERTEX_OPS, FACE_OPS, PIXEL_OPS = 35, 5, 36


def raster_ops(verts: int, faces: int, h: int, w: int) -> float:
    return float(VERTEX_OPS * verts + FACE_OPS * faces + PIXEL_OPS * h * w)


def raster_bytes(verts: int, faces: int, h: int, w: int) -> float:
    inputs = F32 * 3 * verts + I32 * 3 * faces + F32 * 2 * verts
    return float(inputs + I32 * h * w + F32 * 2 * h * w)


def step_bound_s(verts: int, faces: int, batch: int, h: int, w: int,
                 levels: int, peak_flops: float, hbm_bytes_s: float) -> float:
    """The least time of a step's rasters: ``batch`` views at each of
    ``levels`` sizes, each the larger of its two bounds, summed."""
    total = 0.0
    for i in range(levels):
        hi, wi = h >> i, w >> i
        total += max(raster_ops(verts, faces, hi, wi) / peak_flops,
                     raster_bytes(verts, faces, hi, wi) / hbm_bytes_s)
    return batch * total
