"""Interactive viewer on the port's renderer (CUDA kernels on a GPU).

Counterpart of ``read_tpu/viewer.py``: ``ViewerApp`` (:55-257) and
``main`` (:260-335). Frames come from
:class:`read_tpu_torch.render.NeuralRenderer` (``infer`` in the neural
mode, ``render_mode`` in the raw modes) and are shown in an OpenCV
window; there is no OpenGL context.

Key bindings, as ``read_tpu``'s:
  w/a/s/d/q/e  fly forward/left/back/right/down/up
  1/2/3/4      turn left/right/up/down
  z/x          roll
  n            neural mode          c   colors mode
  m            cycle normals modes  v   depth mode
  b            xyz mode             l   labels mode
  p            PCA descriptor mode  h   Blinn-Phong lit mode
  u            2D-texture sampling mode
  t            toggle temporal averaging
  +/-          splat point radius up/down (``set_point_radius``)
  g            snap to nearest training pose
  o            print current pose
  i            screenshot (PNG and its pose)
  ESC          quit

Trajectory editing:
  k            add current pose as a trajectory keyframe
  j            remove last keyframe
  r            toggle smooth replay of the recorded trajectory
  y            load trajectory.txt

``read_tpu`` binds ``u`` twice, to the 2D-texture mode and to saving
``trajectory.txt``; the first binding wins there, so a trajectory is
never saved. The port keeps that behaviour: ``u`` is the 2D-texture
mode.

Mouse: left-drag orbits (ground-plane pivot; with shift, a local
rotation), right-drag pans, middle-drag rolls (horizontal) or zooms
(vertical), the wheel zooms.

Usage::

    python -m read_tpu_torch.viewer --scene scene.yaml --ckpt CKPT_DIR \\
        [--viewport WxH] [--offscreen N] [--device cuda]

``--offscreen N`` renders N frames along the scene's trajectory, drives
a few keys and a trajectory replay, and exits without a window: it
needs no ``cv2``. The windowed mode imports ``cv2`` when it starts and
exits naming it if it is missing. Screenshots and the nearest training
photo go through :mod:`read_tpu_torch.data.image_io` (PNG without cv2).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

__all__ = ["ViewerApp", "run_offscreen", "main"]

_NORMALS = ["normals_m", "normals_l", "normals_r", "normals_d"]
_MODE_KEYS = {"n": "neural", "c": "colors", "v": "depth", "b": "xyz",
              "l": "labels", "p": "pca", "h": "lit", "u": "texture2d"}
_FLY = {"w": (1, 0, 0), "s": (-1, 0, 0), "a": (0, -1, 0),
        "d": (0, 1, 0), "q": (0, 0, -1), "e": (0, 0, 1)}
_TURN = {"1": dict(yaw=np.deg2rad(5)), "2": dict(yaw=np.deg2rad(-5)),
         "3": dict(pitch=np.deg2rad(5)), "4": dict(pitch=np.deg2rad(-5))}


def _rgb(img: np.ndarray) -> np.ndarray:
    """``image_io.imread``'s cv2 channel order (BGR, BGRA) as RGB(A)."""
    if img.ndim == 3 and img.shape[2] in (3, 4):
        return img[..., [2, 1, 0, 3][:img.shape[2]]]
    return img


class ViewerApp:
    """The viewer's state: the renderer, the trackball, the mode, the
    trajectory and the frame times. ``device`` defaults to CUDA;
    ``'cpu'`` runs the renderer's plain twins."""

    def __init__(self, scene_path: str, ckpt_path: str, viewport=None,
                 supersampling=None, gt_pattern=None, device="cuda"):
        from read_tpu_torch.render import NeuralRenderer, nearest_train
        from read_tpu_torch.scene.trackball import Trackball
        from read_tpu_torch.scene.trajectory import Trajectory

        self.r = NeuralRenderer(scene_path, ckpt_path, viewport=viewport,
                                supersampling=supersampling, device=device)
        views = self.r.scene_data["view_matrix"]
        self.tb = Trackball(np.asarray(views[0]) if views else np.eye(4))
        self.mode = "neural"
        self._normals_cycle = 0
        self._nearest = nearest_train
        self.frame_times = []
        self.trajectory = Trajectory()
        self.replaying = False
        self._replay_t = 0.0
        self.replay_speed = 1.0 / 180  # path fraction per frame
        self.gt_pattern = gt_pattern
        self._last_gt_path = None
        self._drag = None

    def nearest_gt_image(self):
        """``(path, RGB image)`` of the training photo whose pose is
        nearest the current camera; ``(None, None)`` without a ``--gt``
        pattern or views. ``*`` in the pattern stands for the camera
        label (an integer label also as ``%06d``); the image is read once
        a path."""
        if not self.gt_pattern:
            return None, None
        views = self.r.scene_data["view_matrix"]
        if not views:
            return None, None
        i = self._nearest(views, self.tb.view_matrix())
        labels = self.r.scene_data.get("camera_labels")
        label = labels[i] if labels else i
        cands = [self.gt_pattern.replace("*", str(label))]
        try:
            cands.append(self.gt_pattern.replace("*", f"{int(label):06d}"))
        except (TypeError, ValueError):
            pass
        path = next((p for p in cands if os.path.exists(p)), None)
        if path is None:
            print(f"{cands[0]} NOT FOUND!")
            return cands[0], None
        if path != self._last_gt_path:
            from read_tpu_torch.data import image_io
            self._last_gt_path = path
            self._last_gt_img = _rgb(image_io.imread(path))
        return path, self._last_gt_img

    def render(self) -> np.ndarray:
        """The current frame ``[h, w, 3]`` float32 in [0, 1] (stepping a
        replay first); its wall time joins ``frame_times``."""
        t0 = time.perf_counter()
        if self.replaying and len(self.trajectory) >= 2:
            self.tb.m = self.trajectory.sample(self._replay_t)
            self._replay_t += self.replay_speed
            if self._replay_t > 1.0:
                self._replay_t = 0.0
        pose = self.tb.view_matrix()
        if self.mode == "neural":
            img = self.r.infer(pose)
        else:
            img = self.r.render_mode(self.mode, pose)
        self.frame_times.append(time.perf_counter() - t0)
        return img

    def handle_key(self, key: str) -> bool:
        """Apply one key; False to quit."""
        tb = self.tb
        if key in _FLY:
            tb.fly(*_FLY[key])
        elif key in _TURN:
            tb.turn(**_TURN[key])
        elif key in ("z", "x"):
            tb.roll(np.deg2rad(5 if key == "z" else -5))
        elif key in _MODE_KEYS:
            self.mode = _MODE_KEYS[key]
        elif key == "m":
            self._normals_cycle = (self._normals_cycle + 1) % 4
            self.mode = _NORMALS[self._normals_cycle]
        elif key in ("+", "=", "-"):
            self.r.set_point_radius(self.r.cfg.point_radius
                                    + (-1 if key == "-" else 1))
            print(f"point radius {self.r.cfg.point_radius}")
        elif key == "t":
            self.r.temporal_average = not self.r.temporal_average
            self.r._last_pyr = None
        elif key == "g":
            views = self.r.scene_data["view_matrix"]
            if views:
                i = self._nearest(views, tb.view_matrix())
                tb.m = np.asarray(views[i], np.float64).copy()
                print(f"snapped to training pose {i}")
        elif key == "o":
            print("pose:\n", tb.view_matrix())
        elif key == "i":
            self.screenshot(f"screenshot_{int(time.time())}.png")
        elif key == "k":
            print(f"keyframe {self.trajectory.add(tb.view_matrix())} "
                  "recorded")
        elif key == "j":
            self.trajectory.remove_last()
            print(f"{len(self.trajectory)} keyframes")
        elif key == "r":
            self.replaying = not self.replaying
            self._replay_t = 0.0
            print(f"replay {'on' if self.replaying else 'off'} "
                  f"({len(self.trajectory)} keyframes)")
        elif key == "y":
            from read_tpu_torch.scene.trajectory import Trajectory
            try:
                self.trajectory = Trajectory.load("trajectory.txt")
                print(f"loaded trajectory.txt "
                      f"({len(self.trajectory)} keyframes)")
            except OSError as e:
                print(f"no trajectory.txt: {e}")
        elif key == "\x1b":  # ESC
            return False
        return True

    def screenshot(self, path: str) -> str:
        """Render the current frame and write it as PNG at ``path``, its
        pose beside it (``<path>.pose.txt``)."""
        from read_tpu_torch.data import image_io
        img = self.render()
        image_io.imwrite(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))
        np.savetxt(path + ".pose.txt", self.tb.view_matrix())
        print(f"saved {path} (+pose)")
        return path

    def handle_mouse(self, event: int, x: int, y: int, flags: int):
        """The cv2 mouse callback's body: drags -> trackball moves."""
        import cv2
        if event in (cv2.EVENT_LBUTTONDOWN, cv2.EVENT_RBUTTONDOWN,
                     cv2.EVENT_MBUTTONDOWN):
            self._drag = (x, y)
        elif event == cv2.EVENT_MOUSEMOVE and self._drag is not None:
            dx, dy = x - self._drag[0], y - self._drag[1]
            self._drag = (x, y)
            if flags & cv2.EVENT_FLAG_LBUTTON:
                if flags & cv2.EVENT_FLAG_SHIFTKEY:
                    self.tb.rotate_local(dx * 0.005, dy * 0.005)
                else:
                    self.tb.rotate(dx * 0.005, dy * 0.005)
            elif flags & cv2.EVENT_FLAG_RBUTTON:
                self.tb.pan(-dx * 0.01, dy * 0.01)
            elif flags & cv2.EVENT_FLAG_MBUTTON:
                if abs(dx) >= abs(dy):
                    self.tb.roll(dx * 0.005)
                else:
                    self.tb.zoom(-dy * 0.05)
        elif event in (cv2.EVENT_LBUTTONUP, cv2.EVENT_RBUTTONUP,
                       cv2.EVENT_MBUTTONUP):
            self._drag = None
        elif event == cv2.EVENT_MOUSEWHEEL:
            self.tb.zoom(0.5 if flags > 0 else -0.5)

    @property
    def fps(self) -> float:
        """Frames a second over the last 20 frames (0 before two)."""
        if len(self.frame_times) < 2:
            return 0.0
        return 1.0 / float(np.mean(self.frame_times[-20:]))


def run_offscreen(app: ViewerApp, n: int, nearest_train: bool = False):
    """``read_tpu``'s headless smoke: ``n`` frames along the scene's
    views (at most as many as it has), the keys ``wd1nmcvp`` each with a
    frame, two keyframes and three replayed frames. Returns the line it
    prints."""
    views = app.r.scene_data["view_matrix"]
    for i in range(min(n, len(views))):
        app.tb.m = np.asarray(views[i], np.float64).copy()
        app.render()
    for k in "wd1nmcvp":
        app.handle_key(k)
        app.render()
    for k in "kwkr":
        app.handle_key(k)
    for _ in range(3):
        app.render()
    if nearest_train:
        path, gt = app.nearest_gt_image()
        print(f"nearest-train: {path} "
              f"{'loaded ' + str(gt.shape) if gt is not None else 'missing'}")
    line = (f"offscreen ok: {len(app.frame_times)} frames, "
            f"fps {app.fps:.2f}, mode {app.mode}, "
            f"traj {len(app.trajectory)} kf")
    print(line)
    return line


def _window(app: ViewerApp, nearest_train: bool) -> None:
    try:
        import cv2
    except ImportError:
        raise SystemExit("read_tpu_torch.viewer: the window needs cv2 "
                         "(opencv-python), which is not installed; "
                         "--offscreen N runs without it") from None
    win = "read_tpu_torch viewer (ESC quits)"
    cv2.namedWindow(win, cv2.WINDOW_AUTOSIZE)
    cv2.setMouseCallback(
        win, lambda ev, x, y, flags, _p: app.handle_mouse(ev, x, y, flags))
    running = True
    while running:
        img = app.render()
        bgr = (np.clip(img, 0, 1)[..., ::-1] * 255).astype(np.uint8)
        cv2.putText(bgr, f"{app.fps:5.1f} fps  [{app.mode}]", (8, 18),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 0), 1)
        cv2.imshow(win, bgr)
        if nearest_train:
            _, gt = app.nearest_gt_image()
            if gt is not None:
                s = 1024 / max(gt.shape[:2])
                cv2.imshow("nearest train",
                           cv2.resize(gt[..., :3][..., ::-1], None, None,
                                      s, s))
        k = cv2.waitKey(1) & 0xFF
        if k != 255:
            running = app.handle_key(chr(k))
    cv2.destroyAllWindows()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Interactive neural viewer")
    p.add_argument("--scene", required=True)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--viewport", default=None, help="WxH")
    p.add_argument("--supersampling", type=int, default=None)
    p.add_argument("--offscreen", type=int, default=0,
                   help="render N trajectory frames headless and exit")
    p.add_argument("--nearest-train", action="store_true",
                   help="show the nearest training photo alongside")
    p.add_argument("--gt", default=None,
                   help="GT image path pattern, '*' replaced by the "
                        "camera label (e.g. images/*.png)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default: the kernels) or 'cpu' (their "
                        "plain twins)")
    args = p.parse_args(argv)
    if args.nearest_train and not args.gt:
        p.error("--nearest-train needs --gt (path to gt images)")
    viewport = None
    if args.viewport:
        w, h = args.viewport.lower().split("x")
        viewport = (int(w), int(h))
    app = ViewerApp(args.scene, args.ckpt, viewport=viewport,
                    supersampling=args.supersampling, gt_pattern=args.gt,
                    device=args.device)
    if args.offscreen:
        run_offscreen(app, args.offscreen, args.nearest_train)
    else:
        _window(app, args.nearest_train)
    return 0


if __name__ == "__main__":
    sys.exit(main())
