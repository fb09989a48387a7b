"""READ's neural mesh texture on a triangle raster, plainly.

Deferred Neural Rendering's neural texture (Thies et al., SIGGRAPH 2019,
arXiv 1904.12356) as READ writes it (``MeshTexture``,
``READ/models/texture.py:73-130``): ``levels`` learned ``[s / 2^i, s /
2^i, C]`` tables, each sampled bilinearly at a pixel's uv and summed,
with the per-level regulariser ``reg_weight * sum_i w_i * mean(t_i^2)``,
``w = (8, 2, 1, 0)`` (:105). The uv comes from a raster of the mesh:

- the vertices go through the row-major world-to-clip matrix, element
  by element ``((m0 x + m1 y) + m2 z) + m3``, each divided by its ``w``;
  a face whose three vertices have ``w > 1e-9`` may cover pixels;
- screen coordinates are ``w (x + 1) / 2`` across and ``h (1 - y) / 2``
  down, pixel ``(px, py)`` sampled at its centre ``(px + 0.5, py +
  0.5)``;
- a pixel is covered by a face when its three edge functions have the
  sign of the face's signed area, in either winding, and the area is not
  below 1e-12; its depth is the barycentric blend of the vertices' NDC
  ``z``, ``(z + 1) / 2``, kept where ``|z| <= 1``;
- each pixel takes the least depth, ties to the least face id;
- its uv is the face's vertex uv blended with the barycentrics over each
  vertex's ``w`` and renormalized (perspective correct), 0 where empty;
- the tables are sampled as ``F.grid_sample`` does, ``align_corners=
  False`` and zeros outside, at ``2 uv - 1``, summed, and masked to 0
  where no face covers the pixel.

**Departure from READ.** READ rasterises the mesh with OpenGL, which
covers every pixel of every face. Here, as in the port and in
``read_tpu``, a face is tested only on the ``samples x samples`` pixels
that start at the floor of its screen bounding box's least corner: a face
more than ``samples`` pixels wide or tall leaves its other pixels to
the faces behind it, or empty.

Nothing here imports the port.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

__all__ = ["REG_LEVEL_WEIGHTS", "project", "raster", "uv_map", "sample",
           "reg_loss", "pyramid_maps"]

REG_LEVEL_WEIGHTS = (8.0, 2.0, 1.0, 0.0)
INT64_MAX = 2 ** 63 - 1
# faces a block: a block's candidate arrays are 4M entries at 8 samples
FACES_A_BLOCK = 1 << 16


def project(verts: torch.Tensor, m: torch.Tensor):
    """``(ndc [V, 3], w [V])`` of ``verts [V, 3]`` through ``m [4, 4]``."""
    x, y, z = verts[:, 0], verts[:, 1], verts[:, 2]

    def row(i):
        return m[i, 0] * x + m[i, 1] * y + m[i, 2] * z + m[i, 3]

    w = row(3)
    return torch.stack([row(0) / w, row(1) / w, row(2) / w], dim=-1), w


def _screen(ndc: torch.Tensor, h: int, w: int):
    return w * (ndc[..., 0] + 1.0) * 0.5, h * (1.0 - ndc[..., 1]) * 0.5


def _edge(ax, ay, bx, by, px, py):
    return (bx - ax) * (py - ay) - (by - ay) * (px - ax)


def raster(verts: torch.Tensor, faces: torch.Tensor, m: torch.Tensor,
           h: int, w: int, samples: int = 8) -> torch.Tensor:
    """The face id ``[h, w]`` int32 (-1 where empty) of one view ``m``."""
    ndc, wc = project(verts, m)
    sx, sy = _screen(ndc, h, w)
    best = torch.full((h * w,), INT64_MAX, dtype=torch.int64,
                      device=verts.device)
    grid = torch.arange(samples, device=verts.device)
    for f0 in range(0, faces.shape[0], FACES_A_BLOCK):
        f = faces[f0:f0 + FACES_A_BLOCK].long()
        ax, bx, gx = (sx[f[:, k], None, None] for k in range(3))
        ay, by, gy = (sy[f[:, k], None, None] for k in range(3))
        z0, z1, z2 = (ndc[f[:, k], 2, None, None] for k in range(3))
        x0 = torch.floor(torch.minimum(torch.minimum(ax, bx), gx)).long()
        y0 = torch.floor(torch.minimum(torch.minimum(ay, by), gy)).long()
        px = x0 + grid[None, None, :]
        py = y0 + grid[None, :, None]
        cx, cy = px.float() + 0.5, py.float() + 0.5
        area = _edge(ax, ay, bx, by, gx, gy)
        e0 = _edge(bx, by, gx, gy, cx, cy)
        e1 = _edge(gx, gy, ax, ay, cx, cy)
        e2 = _edge(ax, ay, bx, by, cx, cy)
        s = torch.sign(area)
        b0, b1 = e0 / area, e1 / area
        b2 = 1.0 - b0 - b1
        z = b0 * z0 + b1 * z1 + b2 * z2
        front = (wc[f] > 1e-9).all(dim=1)[:, None, None]
        keep = ((e0 * s >= 0) & (e1 * s >= 0) & (e2 * s >= 0)
                & (area.abs() >= 1e-12) & front & (z.abs() <= 1.0)
                & (px >= 0) & (px < w) & (py >= 0) & (py < h))
        depth = (z + 1.0) * 0.5
        ids = torch.arange(f0, f0 + f.shape[0], device=verts.device
                           )[:, None, None].expand_as(keep)
        key = (depth.view(torch.int32).long() << 32) | ids
        best.scatter_reduce_(0, (py * w + px)[keep], key[keep], "amin")
    face = torch.where(best == INT64_MAX, -1, best & 0xFFFFFFFF)
    return face.to(torch.int32).view(h, w)


def uv_map(verts: torch.Tensor, faces: torch.Tensor, uv: torch.Tensor,
           m: torch.Tensor, face: torch.Tensor) -> torch.Tensor:
    """The perspective-correct uv ``[h, w, 2]`` at each covered pixel of
    ``face [h, w]`` (one view ``m``), 0 where empty."""
    h, w = face.shape
    ndc, wc = project(verts, m)
    sx, sy = _screen(ndc, h, w)
    f = faces.long()[face.clamp(min=0).long()]            # [h, w, 3]
    cx = (torch.arange(w, device=face.device).float() + 0.5)[None, :]
    cy = (torch.arange(h, device=face.device).float() + 0.5)[:, None]
    (ax, bx, gx), (ay, by, gy) = sx[f].unbind(-1), sy[f].unbind(-1)
    area = _edge(ax, ay, bx, by, gx, gy)
    b0 = _edge(bx, by, gx, gy, cx, cy) / area
    b1 = _edge(gx, gy, ax, ay, cx, cy) / area
    p = torch.stack([b0, b1, 1.0 - b0 - b1], dim=-1) / wc[f]
    p = p / p.sum(dim=-1, keepdim=True)
    out = (p[..., None] * uv[f]).sum(dim=-2)
    return torch.where((face >= 0)[..., None], out, 0.0)


def sample(tables: Sequence[torch.Tensor], uv: torch.Tensor,
           face: torch.Tensor) -> torch.Tensor:
    """``[B, h, w, C]``: the tables (``[s, s, C]`` each) sampled at ``uv
    [B, h, w, 2]`` and summed, 0 where ``face [B, h, w]`` is empty."""
    grid = uv * 2.0 - 1.0
    out = 0.0
    for t in tables:
        img = t.permute(2, 0, 1)[None].expand(uv.shape[0], -1, -1, -1)
        out = out + F.grid_sample(img, grid, mode="bilinear",
                                  padding_mode="zeros", align_corners=False)
    return out.permute(0, 2, 3, 1) * (face >= 0)[..., None].to(uv.dtype)


def reg_loss(tables: Sequence[torch.Tensor], reg_weight: float
             ) -> torch.Tensor:
    loss = 0.0
    for i, t in enumerate(tables):
        wi = REG_LEVEL_WEIGHTS[i] if i < len(REG_LEVEL_WEIGHTS) else 0.0
        loss = loss + reg_weight * wi * torch.square(t).mean()
    return loss


def pyramid_maps(verts: torch.Tensor, faces: torch.Tensor,
                 uv: torch.Tensor, total_m: torch.Tensor, h: int, w: int,
                 levels: int, samples: int = 8) -> List[tuple]:
    """``(face [B, h_i, w_i], uv [B, h_i, w_i, 2])`` of each level ``i``
    (``h >> i`` by ``w >> i``), a raster of its own at each."""
    out = []
    for i in range(levels):
        hi, wi = h // 2 ** i, w // 2 ** i
        face = torch.stack([raster(verts, faces, m, hi, wi, samples)
                            for m in total_m])
        out.append((face, torch.stack([uv_map(verts, faces, uv, m, fi)
                                       for m, fi in zip(total_m, face)])))
    return out
