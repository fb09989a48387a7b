"""Exact z-buffer, its 2x2 pyramid and the descriptor gather.

READ's point raster at 1-px points: each world point is projected by the
row-major world-to-clip matrix, divided by its ``w``, kept where the
clip test holds and ``w > 0``, and floored to the pixel it falls in.
Each pixel keeps the least depth ``(z_ndc + 1) / 2``, ties to the least
point id; an empty pixel is -1 with depth 0. Level ``i + 1`` of the
pyramid keeps, for each 2x2 block of level ``i``, the least (depth, id)
of its four pixels. The projection is written element by element,
``((m0 x + m1 y) + m2 z) + m3``, with no fused multiply-add, which is
the arithmetic the configuration's float32 raster states; the least
(depth, id) is one int64 key a pixel, the depth's float bits above the
id (depths in [0, 1] order like their bits).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

__all__ = ["project", "zbuffer", "pyramid", "gather"]

INT64_MAX = 2 ** 63 - 1
_FAR = 2.0


def project(xyz: torch.Tensor, total_m: torch.Tensor):
    """``xyz [N, 3]`` through ``total_m [B, 4, 4]``: ``(ndc [B, N, 3],
    valid [B, N])``."""
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    m = total_m

    def row(i):
        return (m[:, i, 0, None] * x + m[:, i, 1, None] * y
                + m[:, i, 2, None] * z + m[:, i, 3, None])

    w = row(3)
    ndc = torch.stack([row(0) / w, row(1) / w, row(2) / w], dim=-1)
    valid = torch.all(ndc.abs() <= 1.0, dim=-1) & (w > 0)
    return ndc, valid


def _keys(xyz, total_m, h, w):
    """Each (view, point)'s pixel (``h*w`` off the frame) and int64 key."""
    ndc, valid = project(xyz, total_m)
    u = torch.floor(w * (ndc[..., 0] + 1.0) * 0.5).to(torch.int32)
    v = torch.floor(h * (1.0 - ndc[..., 1]) * 0.5).to(torch.int32)
    depth = (ndc[..., 2] + 1.0) * 0.5
    inside = valid & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    pix = torch.where(inside, v * w + u, h * w)
    depth = torch.where(inside, depth, _FAR)
    ids = torch.arange(xyz.shape[0], dtype=torch.int64, device=xyz.device)
    bits = depth.view(torch.int32).to(torch.int64)
    key = torch.where(pix < h * w, (bits << 32) | ids, INT64_MAX)
    return pix, key


def _unpack(key: torch.Tensor):
    empty = key == INT64_MAX
    index = torch.where(empty, -1, (key & 0xFFFFFFFF).to(torch.int32))
    depth = (key >> 32).to(torch.int32).view(torch.float32)
    return index, torch.where(empty, 0.0, depth)


def zbuffer(xyz: torch.Tensor, total_m: torch.Tensor, h: int, w: int
            ) -> torch.Tensor:
    """The least key of every pixel, ``[B, h, w]`` int64 (``INT64_MAX``
    where empty)."""
    b = total_m.shape[0]
    pix, key = _keys(xyz.float(), total_m.float(), h, w)
    buf = torch.full((b, h * w + 1), INT64_MAX, dtype=torch.int64,
                     device=xyz.device)
    buf.scatter_reduce_(1, pix.long(), key, "amin", include_self=True)
    return buf[:, :h * w].reshape(b, h, w)


def pyramid(xyz: torch.Tensor, total_m: torch.Tensor, h: int, w: int,
            levels: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``levels`` maps ``(index [B, h_i, w_i] int32, depth)``, level 0 at
    ``h x w``, each next one the 2x2 least key of the one before."""
    key = zbuffer(xyz, total_m, h, w)
    out = [_unpack(key)]
    for _ in range(1, levels):
        b, hh, ww = key.shape
        key = key.reshape(b, hh // 2, 2, ww // 2, 2).amin(dim=(2, 4))
        out.append(_unpack(key))
    return out


def gather(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``table [N, C]`` at ``index [B, h, w]``: ``[B, h, w, C]``, zeros
    where the index is -1 (differentiable in ``table``)."""
    rows = table[index.clamp(min=0).long()]
    return rows * (index >= 0).unsqueeze(-1).to(table.dtype)
