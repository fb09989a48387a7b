"""Camera trajectories: keyframes, smooth sampling, save and load.

The port's copy of ``read_tpu/scene/trajectory.py``: poses are
camera-to-world 4x4 matrices; a path interpolates rotation by quaternion
slerp and translation by Catmull-Rom through its keyframes, sampled at a
fixed frame count, and is saved as a flat txt of ``N*4 x 4`` rows (the
pose-list format ``render --trajectory`` reads).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = ["Trajectory", "slerp", "mat_to_quat", "quat_to_mat"]


def mat_to_quat(m: np.ndarray) -> np.ndarray:
    """Rotation matrix [3,3] -> unit quaternion (w, x, y, z)."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                         (m[0, 2] - m[2, 0]) / s,
                         (m[1, 0] - m[0, 1]) / s])
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-12)) * 2
    q = np.empty(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


def quat_to_mat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    """Spherical interpolation of unit quaternions."""
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    th = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


def _catmull_rom(p0, p1, p2, p3, t):
    t2, t3 = t * t, t * t * t
    return 0.5 * ((2 * p1) + (-p0 + p2) * t
                  + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t2
                  + (-p0 + 3 * p1 - 3 * p2 + p3) * t3)


class Trajectory:
    """An editable keyframe camera path."""

    def __init__(self, keyframes: Optional[Sequence[np.ndarray]] = None):
        if keyframes is None:
            keyframes = []
        self.keyframes: List[np.ndarray] = [
            np.asarray(k, np.float64) for k in keyframes]

    def __len__(self):
        return len(self.keyframes)

    def add(self, pose: np.ndarray) -> int:
        """Append a keyframe; returns its index."""
        self.keyframes.append(np.asarray(pose, np.float64).copy())
        return len(self.keyframes) - 1

    def remove_last(self) -> None:
        if self.keyframes:
            self.keyframes.pop()

    def clear(self) -> None:
        self.keyframes = []

    def sample(self, t: float) -> np.ndarray:
        """Pose at normalized position t in [0, 1] (slerp rotation +
        Catmull-Rom translation through the keyframes)."""
        kf = self.keyframes
        if not kf:
            return np.eye(4)
        if len(kf) == 1:
            return kf[0].copy()
        t = float(np.clip(t, 0.0, 1.0)) * (len(kf) - 1)
        i = min(int(np.floor(t)), len(kf) - 2)
        f = t - i
        p = [kf[max(i - 1, 0)][:3, 3], kf[i][:3, 3],
             kf[i + 1][:3, 3], kf[min(i + 2, len(kf) - 1)][:3, 3]]
        pos = _catmull_rom(*p, f)
        q = slerp(mat_to_quat(kf[i][:3, :3]),
                  mat_to_quat(kf[i + 1][:3, :3]), f)
        out = np.eye(4)
        out[:3, :3] = quat_to_mat(q)
        out[:3, 3] = pos
        return out

    def frames(self, n: int) -> List[np.ndarray]:
        """n interpolated poses along the whole path."""
        if len(self.keyframes) < 2:
            return [self.sample(0.0)] * max(n, 1)
        return [self.sample(i / max(n - 1, 1)) for i in range(n)]

    def save(self, path: str) -> None:
        """Flat txt, N*4 x 4 (the reference pose-list format)."""
        np.savetxt(path, np.concatenate(
            [k.reshape(4, 4) for k in self.keyframes], axis=0))

    @classmethod
    def load(cls, path: str) -> "Trajectory":
        flat = np.loadtxt(path)
        assert flat.shape[0] % 4 == 0 and flat.shape[1] == 4, flat.shape
        return cls(flat.reshape(-1, 4, 4))
