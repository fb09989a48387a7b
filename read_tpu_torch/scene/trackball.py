"""Trackball camera manipulation (pure numpy).

The port's copy of ``read_tpu/scene/trackball.py`` (``Trackball`` and
its ``_rotation`` helper, which the panorama camera ring uses): orbit
about the ground-plane point ahead of the camera, local rotate, roll,
pan, zoom, discrete key turns, WASD-style fly and euler helpers. The
state is a camera-to-world 4x4 (GL convention, the camera looks down
-z), the matrix the renderer takes.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Trackball"]


def _rotation(axis, angle) -> np.ndarray:
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    x, y, z = axis
    c, s = np.cos(angle), np.sin(angle)
    C = 1 - c
    return np.array([
        [x * x * C + c, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, y * y * C + c, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, z * z * C + c]])


def _intersect_plane(origin, direction, plane_point, plane_normal):
    """Ray/plane intersection; returns None when parallel
    (``camera.py:9-24`` behavior)."""
    denom = float(np.dot(direction, plane_normal))
    if abs(denom) < 1e-9:
        return None
    t = float(np.dot(plane_point - origin, plane_normal)) / denom
    if t < 0:
        return None
    return origin + t * direction


class Trackball:
    """Mutable camera controller over a camera-to-world matrix."""

    def __init__(self, view_matrix=None, ground_normal=(0.0, 1.0, 0.0),
                 rotate_speed=0.005, pan_speed=0.01, zoom_speed=0.1,
                 fly_speed=0.5):
        self.m = np.array(view_matrix if view_matrix is not None
                          else np.eye(4), np.float64)
        self.ground_normal = np.asarray(ground_normal, np.float64)
        self.rotate_speed = rotate_speed
        self.pan_speed = pan_speed
        self.zoom_speed = zoom_speed
        self.fly_speed = fly_speed

    # -- accessors --------------------------------------------------------
    @property
    def position(self) -> np.ndarray:
        return self.m[:3, 3].copy()

    @property
    def forward(self) -> np.ndarray:
        return -self.m[:3, 2].copy()  # GL camera looks down -z

    @property
    def right(self) -> np.ndarray:
        return self.m[:3, 0].copy()

    @property
    def up(self) -> np.ndarray:
        return self.m[:3, 1].copy()

    def view_matrix(self) -> np.ndarray:
        return self.m.copy()

    # -- pivot ------------------------------------------------------------
    def _pivot(self) -> np.ndarray:
        """Ground-plane point ahead of the camera (``camera.py:143-158``
        orbits about the ground intersection of the view ray)."""
        hit = _intersect_plane(self.position, self.forward,
                               np.zeros(3), self.ground_normal)
        if hit is None:
            return self.position + self.forward * 5.0
        return hit

    # -- interactions -----------------------------------------------------
    def rotate(self, dx: float, dy: float):
        """Orbit about the ground pivot (mouse drag)."""
        pivot = self._pivot()
        yaw = _rotation(self.ground_normal, -dx * self.rotate_speed)
        pitch = _rotation(self.right, -dy * self.rotate_speed)
        R = yaw @ pitch
        pos = pivot + R @ (self.position - pivot)
        self.m[:3, :3] = R @ self.m[:3, :3]
        self.m[:3, 3] = pos

    def rotate_local(self, dx: float, dy: float):
        """First-person look (``camera.py:167-177``)."""
        yaw = _rotation(self.up, -dx * self.rotate_speed)
        pitch = _rotation(self.right, -dy * self.rotate_speed)
        self.m[:3, :3] = (yaw @ pitch) @ self.m[:3, :3]

    def roll(self, angle: float):
        self.m[:3, :3] = _rotation(self.forward, angle) @ self.m[:3, :3]

    def pan(self, dx: float, dy: float):
        self.m[:3, 3] += (-dx * self.pan_speed) * self.right \
            + (dy * self.pan_speed) * self.up

    def zoom(self, amount: float):
        self.m[:3, 3] += amount * self.zoom_speed * self.forward

    def fly(self, forward=0.0, strafe=0.0, lift=0.0):
        """WASD/QE fly (``viewer.py:366-380,460-468``)."""
        self.m[:3, 3] += (forward * self.forward + strafe * self.right
                          + lift * self.up) * self.fly_speed

    def turn(self, yaw=0.0, pitch=0.0):
        """Discrete key turns (``camera.py:252-287``)."""
        if yaw:
            self.m[:3, :3] = _rotation(self.ground_normal,
                                       yaw) @ self.m[:3, :3]
        if pitch:
            self.m[:3, :3] = _rotation(self.right, pitch) @ self.m[:3, :3]

    # -- euler helpers (camera.py:304-365) ---------------------------------
    def set_yaw_pitch_roll(self, yaw: float, pitch: float, roll: float,
                           position=None):
        Ry = _rotation([0, 1, 0], yaw)
        Rx = _rotation([1, 0, 0], pitch)
        Rz = _rotation([0, 0, 1], roll)
        self.m[:3, :3] = Ry @ Rx @ Rz
        if position is not None:
            self.m[:3, 3] = np.asarray(position, np.float64)
