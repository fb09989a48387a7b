"""Scene composition tools: stitching, editing, panorama.

The port's copy of ``read_tpu/scene/tools.py``. Novel view synthesis is
the renderer itself; these are the other applications: *stitching*
composites several fitted scenes into one, *editing* moves, removes or
copies objects by operating on point subsets, and *panorama* renders a
camera ring side by side. Each works on ``(xyz, descriptor table)``
pairs, whose rows travel together, so any point-set surgery carries the
fitted appearance with it. numpy in and out; :func:`render_panorama`
drives a :class:`read_tpu_torch.render.NeuralRenderer`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["stitch_scenes", "select_bbox", "select_sphere",
           "transform_points", "delete_points", "duplicate_points",
           "panorama_cameras", "render_panorama"]


def stitch_scenes(scenes: Sequence[Tuple[np.ndarray, np.ndarray,
                                         Optional[np.ndarray]]]):
    """Concatenate fitted scenes into one.

    Args:
      scenes: list of ``(xyz [N,3], texture [N,C], transform 4x4 or
        None)`` — each scene's points are mapped into the common world
        frame by its transform.

    Returns ``(xyz, texture, scene_ids)``; ``scene_ids`` records the
    source scene per point (useful for later un-stitching/editing).
    """
    xyz_all, tex_all, ids = [], [], []
    c = None
    for sid, (xyz, tex, tf) in enumerate(scenes):
        xyz = np.asarray(xyz, np.float32)
        tex = np.asarray(tex)
        assert xyz.shape[0] == tex.shape[0], (
            f"scene {sid}: {xyz.shape[0]} points vs {tex.shape[0]} "
            f"descriptor rows")
        if c is None:
            c = tex.shape[1]
        assert tex.shape[1] == c, "descriptor sizes must match"
        if tf is not None:
            tf = np.asarray(tf, np.float64)
            xyz = (xyz @ tf[:3, :3].T + tf[:3, 3]).astype(np.float32)
        xyz_all.append(xyz)
        tex_all.append(tex)
        ids.append(np.full(xyz.shape[0], sid, np.int32))
    return (np.concatenate(xyz_all), np.concatenate(tex_all),
            np.concatenate(ids))


def select_bbox(xyz: np.ndarray, lo, hi) -> np.ndarray:
    """Boolean mask of points inside an axis-aligned box."""
    lo = np.asarray(lo)
    hi = np.asarray(hi)
    return np.all((xyz >= lo) & (xyz <= hi), axis=1)


def select_sphere(xyz: np.ndarray, center, radius: float) -> np.ndarray:
    c = np.asarray(center)
    return np.linalg.norm(xyz - c, axis=1) <= radius


def transform_points(xyz: np.ndarray, mask: np.ndarray,
                     transform: np.ndarray) -> np.ndarray:
    """Apply a rigid/affine 4x4 to the selected points (move a car)."""
    out = np.array(xyz, np.float32, copy=True)
    tf = np.asarray(transform, np.float64)
    sel = out[mask]
    out[mask] = (sel @ tf[:3, :3].T + tf[:3, 3]).astype(np.float32)
    return out


def delete_points(xyz: np.ndarray, texture: np.ndarray,
                  mask: np.ndarray):
    """Remove the selected points (car removal). Returns filtered
    ``(xyz, texture)``."""
    keep = ~np.asarray(mask)
    return xyz[keep], np.asarray(texture)[keep]


def duplicate_points(xyz: np.ndarray, texture: np.ndarray,
                     mask: np.ndarray, transform: np.ndarray):
    """Copy the selected points under a transform (car insertion)."""
    tf = np.asarray(transform, np.float64)
    sel = xyz[mask]
    moved = (sel @ tf[:3, :3].T + tf[:3, 3]).astype(np.float32)
    return (np.concatenate([xyz, moved]),
            np.concatenate([np.asarray(texture),
                            np.asarray(texture)[mask]]))


def panorama_cameras(view_matrix: np.ndarray, n_views: int = 3,
                     yaw_step_deg: float = 30.0) -> List[np.ndarray]:
    """Camera ring for a wide-FoV panorama: rotate the camera about its
    up axis in ``yaw_step_deg`` increments centered on the input view.
    (The reference achieves panoramas by widening intrinsics,
    ``README.md:126-133``; a camera ring avoids the extreme-fov
    projective distortion and matches its wide-view demo output.)"""
    from read_tpu_torch.scene.trackball import _rotation
    out = []
    m = np.asarray(view_matrix, np.float64)
    up = m[:3, 1]
    mid = (n_views - 1) / 2.0
    for i in range(n_views):
        yaw = np.deg2rad((i - mid) * yaw_step_deg)
        R = _rotation(up, yaw)
        mi = m.copy()
        mi[:3, :3] = R @ m[:3, :3]
        out.append(mi)
    return out


def render_panorama(renderer, view_matrix: np.ndarray, n_views: int = 3,
                    yaw_step_deg: Optional[float] = None) -> np.ndarray:
    """Render a horizontal panorama by concatenating a camera ring.

    ``renderer`` is a ``read_tpu_torch.render.NeuralRenderer``. The yaw step
    defaults to the camera's horizontal FoV so tiles abut.
    """
    if yaw_step_deg is None:
        fx = renderer.K[0, 0]
        yaw_step_deg = float(np.rad2deg(
            2 * np.arctan(renderer.vw / (2 * fx))))
    tiles = [renderer.infer(m) for m in panorama_cameras(
        view_matrix, n_views, yaw_step_deg)]
    return np.concatenate(tiles, axis=1)
