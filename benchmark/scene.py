"""The benchmark's street scene, camera path and crops, from the seed.

:func:`street` builds the driving street of the port's
``make_demo_scene.build_world`` (road with its width, sidewalks, two
building facades, tree crowns, parked cars, in the same shares of the
points and over the same 120 m) in a few large calls on the device, from
a ``torch.Generator``: the same seed gives the same points, but not the
numbers of the numpy generator. :func:`drive` is ``drive_views``'s
trajectory (eye 1.6 m high, a slight weave, looking 12 m ahead) at a
given spacing. :func:`crop_homographies` copies the training dataset's
zoom-and-shift crops (``ViewDataset.random_image_crop`` and the
farthest-centre choice of ``get_transform_crop``). The camera functions
are the GL conventions of READ: ``view`` is camera-to-world, clip =
``proj @ inv(view) @ [p, 1]``.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

__all__ = ["gl_projection", "total_matrix", "look_at", "intrinsics",
           "street", "drive", "crop_homographies"]

ZNEAR, ZFAR = 0.1, 1000.0


def gl_projection(K: np.ndarray, image_size, znear: float = ZNEAR,
                  zfar: float = ZFAR) -> np.ndarray:
    """OpenGL clip projection of pinhole ``K`` for ``image_size`` ``(w,
    h)``, with READ's flipped principal-point offsets."""
    K = np.asarray(K, dtype=np.float64)
    width, height = image_size
    P = np.zeros((4, 4), dtype=np.float64)
    P[0, 0] = 2.0 * K[0, 0] / width
    P[0, 2] = 1.0 - 2.0 * K[0, 2] / width
    P[1, 1] = 2.0 * K[1, 1] / height
    P[1, 2] = 2.0 * K[1, 2] / height - 1.0
    P[2, 2] = (zfar + znear) / (znear - zfar)
    P[2, 3] = 2.0 * zfar * znear / (znear - zfar)
    P[3, 2] = -1.0
    return P


def total_matrix(proj: np.ndarray, view: np.ndarray) -> np.ndarray:
    """World -> clip, ``proj @ inv(view)``, float64."""
    return np.asarray(proj, np.float64) @ np.linalg.inv(
        np.asarray(view, np.float64))


def look_at(eye, center, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Camera-to-world matrix of a GL camera at ``eye`` looking at
    ``center``."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(center, np.float64) - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right = right / np.linalg.norm(right)
    view = np.eye(4)
    view[:3, 0] = right
    view[:3, 1] = np.cross(right, fwd)
    view[:3, 2] = -fwd
    view[:3, 3] = eye
    return view


def intrinsics(width: int, height: int, focal: float) -> np.ndarray:
    return np.array([[focal, 0, width / 2], [0, focal, height / 2],
                     [0, 0, 1]], np.float64)


def street(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """``[n, 3]`` float32 points of the street on ``device``: road 30%,
    sidewalks 10%, facades 35%, tree crowns 15% (one crown a 400
    points), parked cars the rest (one a 3000 points); the road takes
    the points the integer shares leave over."""
    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen,
                                           device=device)

    def side(m):
        return torch.where(torch.rand(m, generator=gen, device=device)
                           < 0.5, -1.0, 1.0)

    parts = []
    n_walk, n_bld, n_tree = int(n * 0.10), int(n * 0.35), int(n * 0.15)
    nt = max(n_tree // 400, 8)
    per_tree = n_tree // nt
    n_car = n - int(n * 0.30) - n_walk - n_bld - nt * per_tree
    ncars = max(n_car // 3000, 2)
    per_car = n_car // ncars
    n_road = n - n_walk - n_bld - nt * per_tree - ncars * per_car

    parts.append(torch.stack([u(-4.5, 4.5, n_road),
                              torch.zeros(n_road, device=device),
                              u(0, 120, n_road)], 1))
    parts.append(torch.stack([side(n_walk) * u(4.6, 7.0, n_walk),
                              torch.full((n_walk,), 0.12, device=device),
                              u(0, 120, n_walk)], 1))
    parts.append(torch.stack([side(n_bld) * u(7.2, 7.5, n_bld),
                              u(0, 9, n_bld), u(0, 120, n_bld)], 1))
    centre = torch.stack([side(nt) * u(5.5, 6.8, nt),
                          torch.full((nt,), 3.2, device=device),
                          u(5, 115, nt)], 1)
    crown = torch.randn(nt, per_tree, 3, generator=gen, device=device) \
        * torch.tensor([0.9, 1.17, 0.9], device=device)
    parts.append((crown + centre[:, None]).reshape(-1, 3))
    centre = torch.stack([side(ncars) * u(3.0, 4.0, ncars),
                          torch.zeros(ncars, device=device),
                          u(5, 115, ncars)], 1)
    body = u(-1, 1, ncars, per_car, 3) * torch.tensor([0.9, 0.7, 2.2],
                                                      device=device)
    body[..., 1] = body[..., 1].abs() + 0.15
    parts.append((body + centre[:, None]).reshape(-1, 3))
    return torch.cat(parts).contiguous()


def drive(n: int, step_m: float) -> List[np.ndarray]:
    """``n`` camera-to-world poses along +z, ``step_m`` apart from z = 2
    m, eye 1.6 m high, weaving 0.35 m, looking 12 m ahead."""
    rate = 0.12 * step_m / 1.5
    views = []
    for i in range(n):
        z = 2.0 + i * step_m
        views.append(look_at([0.35 * math.sin(i * rate), 1.6, z],
                             [0.35 * math.sin((i + 8 * 1.5 / step_m) * rate),
                              1.5, z + 12.0]))
    return views


def _crop(rng, src, tgt, zoom, shift) -> np.ndarray:
    H = np.eye(3)
    z = max(tgt[0] / src[0], tgt[1] / src[1])
    if zoom:
        z = rng.uniform(max(zoom[0], z), zoom[1])
    if shift:
        max_shift = src * z - tgt
        H[0, 2] = -rng.uniform(0, max(max_shift[0], 0))
        H[1, 2] = -rng.uniform(0, max(max_shift[1], 0))
    H[0, 0] = H[1, 1] = z
    return H


def crop_homographies(rng: np.random.Generator, src_wh, tgt_wh, count: int,
                      candidates: int, zoom, shift) -> List[np.ndarray]:
    """``count`` crop homographies of a ``src_wh`` view onto ``tgt_wh``:
    each the farthest, of ``candidates`` draws, from the centres already
    chosen."""
    src, tgt = np.asarray(src_wh, np.float64), np.asarray(tgt_wh, np.float64)
    c = tgt * 0.5
    centres, out = [], []
    for _ in range(count):
        best, best_c, best_d = None, None, -1.0
        for j in range(candidates):
            H = _crop(rng, src, tgt, zoom, shift)
            Hi = np.linalg.inv(H)
            ct = np.array([Hi[0, 0] * c[0] + Hi[0, 2],
                           Hi[1, 1] * c[1] + Hi[1, 2]])
            d = min((np.linalg.norm(ct - c2) for c2 in centres), default=0.0)
            if j == 0 or d > best_d:
                best, best_c, best_d = H, ct, d
        centres.append(best_c)
        out.append(best)
    return out
