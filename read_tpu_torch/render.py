"""Checkpoint-driven neural rendering on PyTorch (CUDA kernels on a GPU).

Counterpart of ``read_tpu/render.py``: ``NeuralRenderer`` (:64-300, the
neural path: /16 viewport, ``rescale_K``, ``gl_projection``, the scene's
per-point sizes, ``infer``, ``infer_device``, ``set_point_radius``,
temporal average) and ``main`` (:336-410, ``--mode neural``,
``--fps-report``).

The renderer loads a ``read_tpu`` checkpoint directory (numpy only),
rebuilds the pipeline config from its embedded ``config``, and renders
project -> z-buffer -> exact 2x2 pyramid pool -> descriptor gather ->
UNet (K2, K3). The z-buffer is the checkpoint's own: the default
``sort`` runs K5 (exact), ``pallas``/``scatter1`` K1 (packed key);
``--raster-method`` overrides it, as the JAX CLI's flag does. A
checkpoint whose ``input_format`` splats (``p3`` and up, or ``ps``), or
a scene with per-point ``point_sizes``, runs K6's splat projection in
their place. Frames are written as PNG by
:mod:`read_tpu_torch.data.image_io`.

Usage::

    python -m read_tpu_torch.render --scene scene.yaml --ckpt CKPT_DIR \\
        --out renders --fps-report
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Optional, Union

import numpy as np
import torch

from read_tpu_torch.data import image_io
from read_tpu_torch.scene import camera
from read_tpu_torch.models.unet import unet_from_state
from read_tpu_torch.pipelines import texture_pipeline as TP
from read_tpu_torch.utils import ckpt as CK
from read_tpu_torch.utils import convert as CV

__all__ = ["NeuralRenderer", "main"]


class NeuralRenderer:
    """Render neural frames of one scene from one checkpoint.

    ``scene`` is a scene manifest path (loaded with
    ``read_tpu_torch.scene.io``: YAML, or JSON without PyYAML) or an
    already-loaded scene-data dict with the keys ``load_scene_data``
    returns (``pointcloud['xyz']``,
    ``intrinsic_matrix``, ``config['viewport_size']``, and optionally
    ``view_matrix`` and ``point_sizes``). ``device`` defaults to CUDA;
    ``'cpu'`` runs the plain twins instead of the kernels."""

    def __init__(self, scene: Union[str, dict], ckpt_path: str,
                 viewport: Optional[tuple] = None,
                 supersampling: Optional[int] = None,
                 temporal_average: bool = False,
                 dtype: Optional[str] = None,
                 conv_impl: Optional[str] = None,
                 raster_method: Optional[str] = None,
                 device="cuda"):
        if isinstance(scene, str):
            from read_tpu_torch.scene.io import load_scene_data
            scene = load_scene_data(scene)
        self.scene_data = scene
        self.device = torch.device(device)
        flat, meta = CK.load_checkpoint(ckpt_path)
        self.config = dict(meta.get("config", {}))
        for key, val in (("dtype", dtype), ("conv_impl", conv_impl),
                         ("raster_method", raster_method),
                         ("supersampling", supersampling)):
            if val is not None:            # explicit overrides only
                self.config[key] = val
        vw, vh = viewport or scene["config"]["viewport_size"]
        self.vw, self.vh = (vw // 16) * 16, (vh // 16) * 16
        self.cfg = TP.config_from_dict(self.config,
                                       crop_size=(self.vh, self.vw))
        self.temporal_average = temporal_average
        self._last_pyr = None

        K = camera.rescale_K(np.asarray(scene["intrinsic_matrix"],
                                        np.float64),
                             self.vw / vw, self.vh / vh)
        self.K = K
        self.proj = camera.gl_projection(K, (self.vw, self.vh),
                                         znear=0.1, zfar=1000.0)

        xyz = np.asarray(scene["pointcloud"]["xyz"], np.float32)
        self.xyz = torch.from_numpy(xyz).to(self.device)
        self.point_sizes = None
        if scene.get("point_sizes") is not None:
            self.point_sizes = torch.from_numpy(np.asarray(
                scene["point_sizes"], np.float32).reshape(-1)).to(
                    self.device)
        state, texture = CV.variables_from_flat(flat)
        if texture.shape[0] != xyz.shape[0]:
            raise ValueError(f"texture rows {texture.shape[0]} != points "
                             f"{xyz.shape[0]}")
        self.texture = texture.to(self.device)
        self.net = unet_from_state(state).to(self.device)
        if self.device.type == "cuda":   # fold BNs and pack weights now
            self.net.prepare(self.cfg.operands)

    def total_matrix(self, view_matrix: np.ndarray,
                     K: Optional[np.ndarray] = None) -> np.ndarray:
        proj = self.proj if K is None else camera.gl_projection(
            K, (self.vw, self.vh), 0.1, 1000.0)
        return camera.total_matrix(proj, view_matrix).astype(np.float32)

    def _matrix(self, view_matrix, K) -> torch.Tensor:
        m = self.total_matrix(view_matrix, K)[None]
        return torch.from_numpy(m).to(self.device)

    def pyramid(self, view_matrix: np.ndarray,
                K: Optional[np.ndarray] = None):
        """The net's input pyramid for one view (``[1, h_i, w_i, C]``)."""
        return TP.build_pyramid(self.cfg, self.texture, self.xyz,
                                self._matrix(view_matrix, K),
                                shape=(self.vh, self.vw),
                                point_sizes=self.point_sizes)

    def set_point_radius(self, radius: int) -> None:
        """Change the splat radius live (the viewer's point-size keys);
        clamped at 0, and nothing changes when it is the current one."""
        radius = max(0, int(radius))
        if radius == self.cfg.point_radius:
            return
        self.cfg = dataclasses.replace(self.cfg, point_radius=radius)
        self._last_pyr = None

    def _net(self, pyr) -> torch.Tensor:
        return self.net(*pyr, operands=self.cfg.operands)["im_out"]

    def infer_device(self, view_matrix: np.ndarray,
                     K: Optional[np.ndarray] = None) -> torch.Tensor:
        """One neural frame, ``[1, h, w, 3]`` on the device, unclipped
        and with no host transfer (no temporal average)."""
        return self._net(self.pyramid(view_matrix, K))

    def infer(self, view_matrix: np.ndarray,
              K: Optional[np.ndarray] = None) -> np.ndarray:
        """Render one neural frame: ``[h, w, 3]`` float32 in [0, 1]."""
        pyr = self.pyramid(view_matrix, K)
        if self.temporal_average:
            # average the net INPUT with the previous frame's (averaged)
            # pyramid, as read_tpu does (compose.py:167-171)
            if self._last_pyr is not None:
                pyr = [(a + b) * 0.5 for a, b in zip(pyr, self._last_pyr)]
            self._last_pyr = pyr
        img = self._net(pyr)
        return np.clip(img[0].cpu().numpy(), 0.0, 1.0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Offline trajectory renderer on read_tpu_torch")
    p.add_argument("--scene", required=True)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--out", default="renders")
    p.add_argument("--trajectory", default=None,
                   help="flat txt of 4x4 camera-to-world poses; default: "
                        "the scene's own view matrices")
    p.add_argument("--mode", default="neural",
                   help="neural (the only mode ported so far)")
    p.add_argument("--viewport", default=None, help="WxH override")
    p.add_argument("--supersampling", type=int, default=None)
    p.add_argument("--conv-impl", dest="conv_impl", default=None,
                   choices=["xla", "im2col", "pallas"],
                   help="accepted for read_tpu compatibility; ignored")
    p.add_argument("--dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="bfloat16 = bf16 conv operands, f32 accumulation")
    p.add_argument("--raster-method", "--raster", dest="raster_method",
                   default=None, choices=["sort", "scatter1", "pallas"],
                   help="z-buffer override: 'sort' exact (K5), "
                        "'pallas'/'scatter1' packed key (K1)")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--fps-report", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain twins (slow: "
                        "its fps is not the port's speed)")
    args = p.parse_args(argv)
    if args.mode != "neural":
        raise NotImplementedError(
            f"render mode {args.mode!r} is not ported (ROADMAP queue 1, "
            "item 9)")
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        p.error("no CUDA device; pass --device cpu to render with the "
                "plain PyTorch twins")

    viewport = None
    if args.viewport:
        w, h = args.viewport.lower().split("x")
        viewport = (int(w), int(h))
    r = NeuralRenderer(args.scene, args.ckpt, viewport=viewport,
                       supersampling=args.supersampling,
                       conv_impl=args.conv_impl, dtype=args.dtype,
                       raster_method=args.raster_method,
                       device=args.device)
    if args.trajectory:
        poses = np.loadtxt(args.trajectory).reshape(-1, 4, 4)
    else:
        poses = np.stack(r.scene_data["view_matrix"])
    if args.max_frames:
        poses = poses[:args.max_frames]

    os.makedirs(args.out, exist_ok=True)
    times = []
    for i, pose in enumerate(poses):
        t0 = time.perf_counter()
        img = r.infer(pose)   # ends in a host copy: the frame is done
        times.append(time.perf_counter() - t0)
        image_io.imwrite(os.path.join(args.out, f"{i:06}.png"),
                        (img * 255).astype(np.uint8))
    if args.fps_report and len(times) > 1:
        steady = float(np.mean(times[1:]))
        print(json.dumps({"frames": len(times), "fps": 1.0 / steady,
                          "ms_per_frame": steady * 1e3,
                          "device": str(r.device)}))
    print(f"wrote {len(poses)} frames to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
