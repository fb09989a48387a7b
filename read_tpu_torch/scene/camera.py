"""Camera and projection math (pure numpy, host side).

The port's copy of ``read_tpu/scene/camera.py`` (``gl_projection``
:38-60, ``rewrite_near_far`` :63-73, ``rescale_K`` :94-103,
``total_matrix`` :122-129, ``look_at`` :142-160), the functions the
renderer, the frame, the scene loader and the scene generator call. All matrices are row-major numpy 4x4 arrays; the
clip position of a world point ``p`` is ``total_m @ [p, 1]`` followed by
the divide by its ``w`` component.
"""

from __future__ import annotations

import numpy as np

__all__ = ["gl_projection", "rewrite_near_far", "rescale_K",
           "total_matrix", "look_at"]


def gl_projection(K: np.ndarray, image_size, znear: float = 0.01,
                  zfar: float = 1000.0) -> np.ndarray:
    """OpenGL clip projection from a pinhole intrinsic matrix.

    ``image_size`` is ``(width, height)``. Returns a row-major 4x4 ``P``
    such that ``clip = P @ cam`` for a camera-space point ``cam`` (GL
    convention: the camera looks down -z), with the reference's flipped
    principal-point offsets."""
    K = np.asarray(K, dtype=np.float64)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    width, height = image_size
    P = np.zeros((4, 4), dtype=np.float64)
    P[0, 0] = 2.0 * fx / width
    P[0, 2] = 1.0 - 2.0 * cx / width
    P[1, 1] = 2.0 * fy / height
    P[1, 2] = 2.0 * cy / height - 1.0
    P[2, 2] = (zfar + znear) / (znear - zfar)
    P[2, 3] = 2.0 * zfar * znear / (znear - zfar)
    P[3, 2] = -1.0
    return P


def rewrite_near_far(P: np.ndarray, znear: float = 0.01,
                     zfar: float = 1000.0) -> np.ndarray:
    """Override the near/far rows of an existing projection matrix."""
    depth = float(zfar - znear)
    out = np.array(P, dtype=np.float64, copy=True)
    out[2, 2] = -(zfar + znear) / depth
    out[2, 3] = -2.0 * zfar * znear / depth
    return out


def rescale_K(K: np.ndarray, sx: float, sy: float,
              keep_fov: bool = True) -> np.ndarray:
    """Scale intrinsics for a resized image."""
    out = np.array(K, dtype=np.float64, copy=True)
    out[0, 2] *= sx
    out[1, 2] *= sy
    if keep_fov:
        out[0, 0] *= sx
        out[1, 1] *= sy
    return out


def total_matrix(proj: np.ndarray, view: np.ndarray) -> np.ndarray:
    """World->clip transform ``proj @ inv(view)``; ``view`` is the
    camera-to-world matrix (GL convention)."""
    return np.asarray(proj, dtype=np.float64) @ np.linalg.inv(
        np.asarray(view, dtype=np.float64))


def look_at(eye, center, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """Camera-to-world matrix of a GL camera (looking down its -z) at
    ``eye`` looking at ``center``: the columns are the world-frame
    right, up and backward axes and the position."""
    eye = np.asarray(eye, dtype=np.float64)
    center = np.asarray(center, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    fwd = center - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    view = np.eye(4)
    view[:3, 0] = right
    view[:3, 1] = true_up
    view[:3, 2] = -fwd
    view[:3, 3] = eye
    return view
