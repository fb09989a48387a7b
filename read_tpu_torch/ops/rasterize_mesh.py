"""Triangle-mesh rasterization for mesh textures.

Counterpart of ``read_tpu/ops/rasterize_mesh.py``: ``project_vertices``
(:49-66), ``rasterize_mesh`` (:84-162), ``rasterize_mesh_batch``
(:165-170), ``interpolate_uv`` (:173-210) and the sequential numpy
oracle ``rasterize_mesh_reference`` (:213-248). The JAX version is plain
XLA (no Pallas kernel behind it). Here a CUDA tensor goes to a
hand-written kernel (``csrc/mesh_raster.cu``), a CPU tensor to its plain
PyTorch twin (:func:`rasterize_mesh_plain`), which gives the same maps
bit for bit.

For each face a static ``samples x samples`` grid of candidate pixels,
anchored at the floor of its screen bbox's corner, is tested for
containment with 2D screen-space edge functions (either winding); a
candidate's depth is the barycentric blend of the vertices' NDC z,
``(z + 1) / 2``. Faces whose bbox exceeds ``samples`` pixels are
covered on that subgrid only, exactly as in ``read_tpu``. The winner of
a pixel is the least depth, ties to the least face id, which JAX finds
with a lexicographic sort and a unique scatter. Depths are kept only
where they are ``>= 0``, so they order like their float bits, and the
port takes K5's exact 64-bit key ``(depth bits) << 32 | face id``
(``rasterize_kernels.pack_exact_keys``) and its per-pixel minimum. The
twin takes it with ``scatter_reduce_`` amin. The minimum is
associative, so faces go in chunks of ``CANDIDATES_PER_CHUNK``
candidates into one key buffer and views one after another: the peak
memory is a few arrays of one chunk, whatever the mesh. Most candidates
are rejected (off the face or the frame); they aim at a dump region of
``DUMP_SLOTS`` slots past the frame, spread by candidate, because on the
card one dump slot would take millions of atomics on one address, one
after another. The kernel does one ``atomicMin`` an accepted candidate
and nothing for the others: a fill, the raster and an unpack, three
device operations a view.

``interpolate_uv`` recomputes each winning pixel's screen barycentrics,
weights them by ``1 / w_clip`` and renormalizes (GL's perspective-correct
varyings), then blends the face's vertex uv.

``counts['rasters']`` counts the views :func:`rasterize_mesh` has
rasterized on either route, ``counts['kernel']`` those the kernel
rasterized and ``counts['chunks']`` the twin's chunks of faces, for
tests and ``chip_smoke.py`` (a step of ``B`` views at ``L`` levels
rasterizes ``B * L`` times).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from read_tpu_torch import _build
from read_tpu_torch.ops import rasterize_kernels as RK

__all__ = ["CANDIDATES_PER_CHUNK", "counts", "project_vertices",
           "rasterize_mesh", "rasterize_mesh_plain", "rasterize_mesh_batch",
           "interpolate_uv", "rasterize_mesh_reference"]

_FAR = 2.0
# the twin's candidate pixels a chunk of faces makes (faces * samples^2):
# 64M take a 1M-face mesh in one chunk, each float32 array of a chunk at
# 256 MB; a chunk is ~110 launches (PERF.md)
CANDIDATES_PER_CHUNK = 1 << 26
DUMP_SLOTS = 1 << 16
counts = {"rasters": 0, "kernel": 0, "chunks": 0}


def project_vertices(verts: torch.Tensor, total_m: torch.Tensor):
    """Vertices ``[N, 3]`` by one world->clip matrix ``[4, 4]`` to
    ``(ndc [N, 3], w_clip [N], valid [N])``; ``valid`` is the
    behind-the-eye test ``w > 1e-9`` only (faces are clipped per
    candidate pixel). The product is expanded in JAX's order, ``((m0*x +
    m1*y) + m2*z) + m3``."""
    v = verts.to(torch.float32)
    m = total_m.to(device=v.device, dtype=torch.float32)
    x, y, z = v[:, 0], v[:, 1], v[:, 2]

    def row(i):
        return m[i, 0] * x + m[i, 1] * y + m[i, 2] * z + m[i, 3]

    clip = torch.stack([row(0), row(1), row(2)], dim=-1)
    w = row(3)
    return clip / w[:, None], w, w > 1e-9


def _screen_xy(ndc: torch.Tensor, h: int, w: int):
    """NDC to continuous screen coordinates whose floor is the pixel."""
    return w * (ndc[..., 0] + 1.0) * 0.5, h * (1.0 - ndc[..., 1]) * 0.5


def _edge(ax, ay, bx, by, px, py):
    """Signed area (the edge function)."""
    return (bx - ax) * (py - ay) - (by - ay) * (px - ax)


def _chunk_keys(ndc, vvalid, faces, f0, h, w, samples):
    """The candidates of faces ``f0 .. f0 + len(faces)``: ``(pix, key)``
    flat, rejected candidates at ``h*w + (their index % DUMP_SLOTS)``
    with the empty key."""
    t = faces.shape[0]
    dev = ndc.device
    tri = ndc[faces.long()]                            # [T, 3, 3]
    tvalid = torch.all(vvalid[faces.long()], dim=1)
    sx, sy = _screen_xy(tri, h, w)                     # [T, 3] each
    x0 = torch.floor(torch.amin(sx, dim=1)).to(torch.int32)
    y0 = torch.floor(torch.amin(sy, dim=1)).to(torch.int32)
    grid = torch.arange(samples, dtype=torch.int32, device=dev)
    px = x0[:, None, None] + grid[None, None, :]       # [T, S, S]
    py = y0[:, None, None] + grid[None, :, None]
    cx = px.to(torch.float32) + 0.5
    cy = py.to(torch.float32) + 0.5

    def corner(k):
        return sx[:, k, None, None], sy[:, k, None, None]

    (ax, ay), (bx, by), (gx, gy) = corner(0), corner(1), corner(2)
    area = _edge(ax, ay, bx, by, gx, gy)               # [T, 1, 1]
    e0 = _edge(bx, by, gx, gy, cx, cy)
    e1 = _edge(gx, gy, ax, ay, cx, cy)
    e2 = _edge(ax, ay, bx, by, cx, cy)
    s = torch.sign(area)
    flat = torch.abs(area) < 1e-12
    inside = (e0 * s >= 0) & (e1 * s >= 0) & (e2 * s >= 0) & ~flat
    safe = torch.where(flat, torch.ones_like(area), area)
    b0, b1 = e0 / safe, e1 / safe
    b2 = 1.0 - b0 - b1
    z = (b0 * tri[:, 0, 2, None, None] + b1 * tri[:, 1, 2, None, None]
         + b2 * tri[:, 2, 2, None, None])
    depth = (z + 1.0) * 0.5
    onscreen = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    ok = inside & onscreen & tvalid[:, None, None] & (torch.abs(z) <= 1.0) \
        & (depth >= 0.0)
    dump = h * w + (torch.arange(ok.numel(), dtype=torch.int32, device=dev)
                    & (DUMP_SLOTS - 1)).view(ok.shape)
    pix = torch.where(ok, py * w + px, dump).reshape(-1)
    dep = torch.where(ok, depth, _FAR).reshape(-1)
    ids = (torch.arange(t, dtype=torch.int32, device=dev) + f0)
    ids = ids[:, None].expand(t, samples * samples).reshape(-1)
    return pix, RK.pack_exact_keys(pix, dep, ids, h * w)


def rasterize_mesh_plain(verts: torch.Tensor, faces: torch.Tensor,
                         total_m: torch.Tensor, h: int, w: int,
                         samples: int = 8):
    """Plain PyTorch twin of :func:`rasterize_mesh` (same contract), on
    any device: the faces' candidates chunk by chunk
    (``counts['chunks']``), ``scatter_reduce_`` amin, the unpack."""
    ndc, _, vvalid = project_vertices(verts, total_m)
    faces = faces.to(device=ndc.device)
    buf = torch.full((h * w + DUMP_SLOTS,), RK.INT64_MAX, dtype=torch.int64,
                     device=ndc.device)
    step = max(1, CANDIDATES_PER_CHUNK // (samples * samples))
    for f0 in range(0, faces.shape[0], step):
        pix, key = _chunk_keys(ndc, vvalid, faces[f0:f0 + step], f0, h, w,
                               samples)
        buf.scatter_reduce_(0, pix.long(), key, "amin")
        counts["chunks"] += 1
    index, depth = RK.unpack_exact(buf[:h * w])
    return index.view(h, w), depth.view(h, w)


_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p]


def _raster_kernel(verts, faces, total_m, h, w, samples):
    dev = verts.device
    v = verts.detach().to(torch.float32).contiguous()
    f = faces.to(device=dev, dtype=torch.int32).contiguous()
    m = total_m.to(device=dev, dtype=torch.float32).contiguous()
    keys = torch.empty(h * w, dtype=torch.int64, device=dev)
    index = torch.empty((h, w), dtype=torch.int32, device=dev)
    depth = torch.empty((h, w), dtype=torch.float32, device=dev)
    fn = _build.function("mesh_raster", "mesh_raster", _ARGTYPES)
    _build.call(fn, dev, "rasterize_mesh", v.data_ptr(), v.shape[0],
                f.data_ptr(), f.shape[0], m.data_ptr(), h, w, samples,
                keys.data_ptr(), index.data_ptr(), depth.data_ptr())
    counts["kernel"] += 1
    return index, depth


def rasterize_mesh(verts: torch.Tensor, faces: torch.Tensor,
                   total_m: torch.Tensor, h: int, w: int,
                   samples: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """One view of an indexed triangle mesh: ``verts [N, 3]`` float32,
    ``faces [T, 3]`` int vertex ids (``T < 2^31``), ``total_m [4, 4]``.
    Returns ``(face_idx [h, w] int32, depth [h, w] float32)``, -1 and 0
    where no face covers the pixel. On ``verts``' device: the twin on
    the CPU, the kernel on CUDA (where a face with a vertex id outside
    ``[-N, N)`` covers nothing; the twin's indexing raises)."""
    if faces.shape[0] >= 2 ** 31:
        raise ValueError("rasterize_mesh: face ids must fit in 31 bits")
    counts["rasters"] += 1
    if verts.device.type == "cpu":
        return rasterize_mesh_plain(verts, faces, total_m, h, w, samples)
    if verts.device.type != "cuda":
        raise RuntimeError(f"rasterize_mesh: no kernel for device "
                           f"{verts.device}")
    if verts.dim() != 2 or verts.shape[1] != 3 or faces.dim() != 2 \
            or faces.shape[1] != 3 or tuple(total_m.shape) != (4, 4):
        raise ValueError(f"rasterize_mesh: want verts [N, 3], faces [T, 3], "
                         f"total_m [4, 4]; got {tuple(verts.shape)}, "
                         f"{tuple(faces.shape)}, {tuple(total_m.shape)}")
    return _raster_kernel(verts, faces, total_m, h, w, samples)


def rasterize_mesh_batch(verts: torch.Tensor, faces: torch.Tensor,
                         total_m: torch.Tensor, h: int, w: int,
                         samples: int = 8):
    """Views ``total_m [B, 4, 4]`` one after another: ``(face_idx [B, h,
    w], depth [B, h, w])``."""
    out = [rasterize_mesh(verts, faces, m, h, w, samples) for m in total_m]
    return (torch.stack([i for i, _ in out]),
            torch.stack([d for _, d in out]))


def _interpolate_view(verts, faces, uv, total_m, face_idx):
    h, w = face_idx.shape
    dev = face_idx.device
    ndc, w_clip, _ = project_vertices(verts, total_m)
    fid = torch.clamp(face_idx, 0, faces.shape[0] - 1).long()
    f = faces.to(dev).long()[fid]                   # [h, w, 3]
    tri = ndc[f]                                    # [h, w, 3, 3]
    wc = w_clip[f]                                  # [h, w, 3]
    sx, sy = _screen_xy(tri, h, w)                  # [h, w, 3]
    cx = torch.arange(w, dtype=torch.int32, device=dev).to(
        torch.float32)[None, :].expand(h, w) + 0.5
    cy = torch.arange(h, dtype=torch.int32, device=dev).to(
        torch.float32)[:, None].expand(h, w) + 0.5
    ax, ay = sx[..., 0], sy[..., 0]
    bx, by = sx[..., 1], sy[..., 1]
    gx, gy = sx[..., 2], sy[..., 2]
    area = _edge(ax, ay, bx, by, gx, gy)
    area = torch.where(torch.abs(area) < 1e-12, torch.ones_like(area), area)
    b0 = _edge(bx, by, gx, gy, cx, cy) / area
    b1 = _edge(gx, gy, ax, ay, cx, cy) / area
    b2 = 1.0 - b0 - b1
    bary = torch.stack([b0, b1, b2], dim=-1)        # [h, w, 3]
    pw = bary / torch.clamp(wc, min=1e-9)
    pw = pw / torch.clamp(pw.sum(dim=-1, keepdim=True), min=1e-12)
    uv_tri = uv.to(device=dev, dtype=torch.float32)[f]   # [h, w, 3, 2]
    out = torch.sum(pw[..., None] * uv_tri, dim=-2)
    # empty pixels read face 0's vertices, whose NDC is inf or NaN when
    # one lies on the eye plane (w = 0): read_tpu multiplies by the mask,
    # which keeps that NaN; a select keeps 0
    return torch.where((face_idx >= 0)[..., None], out, 0.0)


def interpolate_uv(verts: torch.Tensor, faces: torch.Tensor,
                   uv: torch.Tensor, total_m: torch.Tensor,
                   face_idx: torch.Tensor) -> torch.Tensor:
    """Perspective-correct uv at the winning pixels of ``face_idx``
    (``[h, w]`` with ``total_m [4, 4]``, or ``[B, h, w]`` with ``[B, 4,
    4]``), from the vertices' ``uv [N, 2]``: ``[..., h, w, 2]``, 0 where
    empty (also where ``read_tpu``'s is NaN: see the source)."""
    if face_idx.dim() == 2:
        return _interpolate_view(verts, faces, uv, total_m, face_idx)
    return torch.stack([_interpolate_view(verts, faces, uv, m, fi)
                        for m, fi in zip(total_m, face_idx)])


def rasterize_mesh_reference(verts: np.ndarray, faces: np.ndarray,
                             total_m: np.ndarray, h: int, w: int):
    """Sequential float64 numpy oracle: per-face bbox scan, screen
    barycentric containment, the least depth (ties to the least face id)
    wins. Returns ``(index int32, depth float32)``."""
    verts = np.asarray(verts, np.float64)
    m = np.asarray(total_m, np.float64)
    n = verts.shape[0]
    hom = np.concatenate([verts, np.ones((n, 1))], axis=1)
    clip = hom @ m.T
    wc = clip[:, 3]
    with np.errstate(divide="ignore", invalid="ignore"):
        ndc = clip[:, :3] / wc[:, None]
    sx = w * (ndc[:, 0] + 1.0) * 0.5
    sy = h * (1.0 - ndc[:, 1]) * 0.5
    index = np.full((h, w), -1, np.int32)
    depth = np.full((h, w), np.inf, np.float64)
    for ti, (i0, i1, i2) in enumerate(np.asarray(faces)):
        if min(wc[i0], wc[i1], wc[i2]) <= 1e-9:
            continue
        axs, ays = sx[i0], sy[i0]
        bxs, bys = sx[i1], sy[i1]
        gxs, gys = sx[i2], sy[i2]
        area = (bxs - axs) * (gys - ays) - (bys - ays) * (gxs - axs)
        if abs(area) < 1e-12:
            continue
        x_lo = max(0, int(np.floor(min(axs, bxs, gxs))))
        x_hi = min(w - 1, int(np.floor(max(axs, bxs, gxs))))
        y_lo = max(0, int(np.floor(min(ays, bys, gys))))
        y_hi = min(h - 1, int(np.floor(max(ays, bys, gys))))
        sgn = np.sign(area)
        for pyy in range(y_lo, y_hi + 1):
            for pxx in range(x_lo, x_hi + 1):
                cx, cy = pxx + 0.5, pyy + 0.5
                e0 = (gxs - bxs) * (cy - bys) - (gys - bys) * (cx - bxs)
                e1 = (axs - gxs) * (cy - gys) - (ays - gys) * (cx - gxs)
                e2 = (bxs - axs) * (cy - ays) - (bys - ays) * (cx - axs)
                if e0 * sgn < 0 or e1 * sgn < 0 or e2 * sgn < 0:
                    continue
                b0, b1 = e0 / area, e1 / area
                b2 = 1.0 - b0 - b1
                z = (b0 * ndc[i0, 2] + b1 * ndc[i1, 2] + b2 * ndc[i2, 2])
                if abs(z) > 1.0:
                    continue
                d = (z + 1.0) * 0.5
                if d < depth[pyy, pxx] or (d == depth[pyy, pxx]
                                           and ti < index[pyy, pxx]):
                    index[pyy, pxx] = ti
                    depth[pyy, pxx] = d
    depth[index < 0] = 0.0
    return index, depth.astype(np.float32)
