"""The benchmark's street as a triangle mesh with one uv atlas, from the seed.

The surfaces of :func:`benchmark.scene.street`'s street that a mesh
holds, over its 120 m (z in [0, 120]):

- the road, ``|x| <= 4.5`` at ``y = 0``;
- both sidewalks' tops, ``4.6 <= |x| <= 7.0`` at ``y = 0.12``;
- both facades, ``x = +-7.2`` for ``y`` in [0, 9].

Each surface is a grid of quads about ``edge_m`` on a side (its width
and length each cut into a whole number of them), each quad two
triangles. The seed moves every vertex along its surface's normal by a
uniform amount in ``[-jitter_m, jitter_m]`` (a fitted mesh's
roughness); a vertex shared by two pieces moves alike in both, so the
mesh has no cracks.

The uv atlas: each surface is cut at ``z = 60`` into two halves; the
halves of ``z < 60`` fill the atlas's left column (u in [0, 0.5]), the
others its right one, the five surfaces side by side across a column in
proportion to their widths (31.8 m in all) and ``z`` running along v
(60 m). At ``edge_m`` 0.1 that is 763,200 faces and 388,246 vertices,
and a 512-texel atlas holds about 0.12 m a texel both ways.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

__all__ = ["LENGTH_M", "SURFACES", "counts", "street_mesh"]

LENGTH_M = 120.0
# (lateral from, lateral to, the axis the lateral runs along, the other
# coordinate's axis and value); the normal is that other axis
SURFACES = (("road", -4.5, 4.5, 0, 1, 0.0),
            ("sidewalk_left", -7.0, -4.6, 0, 1, 0.12),
            ("sidewalk_right", 4.6, 7.0, 0, 1, 0.12),
            ("facade_left", 0.0, 9.0, 1, 0, -7.2),
            ("facade_right", 0.0, 9.0, 1, 0, 7.2))
_ATLAS_WIDTH_M = sum(s[2] - s[1] for s in SURFACES)


def _cuts(edge_m: float) -> Tuple[List[int], int]:
    """Quads across each surface, and along the length (even)."""
    across = [max(1, round((hi - lo) / edge_m)) for _, lo, hi, *_ in SURFACES]
    along = 2 * max(1, round(LENGTH_M / 2 / edge_m))
    return across, along


def counts(edge_m: float) -> Tuple[int, int]:
    """``(faces, vertices)`` of the mesh at ``edge_m``."""
    across, along = _cuts(edge_m)
    faces = 2 * sum(across) * along
    return faces, sum(n + 1 for n in across) * 2 * (along // 2 + 1)


def street_mesh(edge_m: float, jitter_m: float, gen: torch.Generator,
                device):
    """``(verts [V, 3] float32, faces [T, 3] int32, uv [V, 2] float32)``
    on ``device``, from ``gen``."""
    across, along = _cuts(edge_m)
    half = along // 2
    verts, faces, uvs = [], [], []
    base, offset = 0, 0.0
    for (_, lo, hi, lat_axis, n_axis, n_value), nu in zip(SURFACES, across):
        lat = torch.linspace(lo, hi, nu + 1, device=device)
        z = torch.linspace(0.0, LENGTH_M, along + 1, device=device)
        jitter = (torch.rand((along + 1, nu + 1), generator=gen,
                             device=device) * 2 - 1) * jitter_m
        for c in (0, 1):
            rows = slice(c * half, (c + 1) * half + 1)
            zz = z[rows, None].expand(half + 1, nu + 1)
            ll = lat[None, :].expand(half + 1, nu + 1)
            p = torch.zeros((half + 1, nu + 1, 3), device=device)
            p[..., 2] = zz
            p[..., lat_axis] = ll
            p[..., n_axis] = n_value + jitter[rows]
            verts.append(p.reshape(-1, 3))
            u = 0.5 * c + 0.5 * (offset + (ll - lo)) / _ATLAS_WIDTH_M
            v = (zz - c * LENGTH_M / 2) / (LENGTH_M / 2)
            uvs.append(torch.stack([u, v], -1).reshape(-1, 2))
            i = torch.arange((half + 1) * (nu + 1), dtype=torch.int32,
                             device=device).view(half + 1, nu + 1) + base
            a, b = i[:-1, :-1], i[:-1, 1:]
            cc, d = i[1:, :-1], i[1:, 1:]
            faces.append(torch.cat([torch.stack([a, b, d], -1).reshape(-1, 3),
                                    torch.stack([a, d, cc], -1).reshape(-1, 3)]))
            base += (half + 1) * (nu + 1)
        offset += hi - lo
    return (torch.cat(verts).contiguous(), torch.cat(faces).contiguous(),
            torch.cat(uvs).contiguous())
