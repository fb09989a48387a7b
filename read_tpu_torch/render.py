"""Checkpoint-driven neural rendering on PyTorch (CUDA kernels on a GPU).

Counterpart of ``read_tpu/render.py``: ``pca_color`` (:33-46) and
``nearest_train`` (:49-61), numpy copies; ``NeuralRenderer`` (:64-333:
/16 viewport, ``rescale_K``, ``gl_projection``, the scene's per-point
sizes, supersampling, the point attributes and view matrices of
checkpoints trained with extra input modalities, ``infer``,
``infer_device``, ``set_point_radius``, temporal average, and
``render_mode``, the raw modes) and ``main`` (:336-410, every ``--mode``,
``--fps-report``).

The renderer loads a ``read_tpu`` checkpoint directory (numpy only),
rebuilds the pipeline config from its embedded ``config``, and renders
project -> z-buffer -> exact 2x2 pyramid pool -> descriptor gather ->
UNet (K2, K3). A ``use_mesh`` checkpoint holds mesh tables in place of
the descriptor table; they are sampled at the uv of the scene's triangle
raster when the scene has ``faces`` (``ops.rasterize_mesh``, every
level), else at each level's winning point's ``uv2d``, as
``read_tpu/render.py:134-148`` feeds them (``scene.io.mesh_inputs``: a
manifest's ``mesh`` lends them where the point cloud has none). The
z-buffer is the checkpoint's own: the default
``sort`` (and ``sort2``, ``scatter``) runs K5 (exact), ``sort1q`` the
quantized key, ``pallas``/``scatter1`` K1 (packed key);
``--raster-method`` overrides it, as the JAX CLI's flag does. A
checkpoint whose ``input_format`` splats (``p3`` and up, or ``ps``), or
a scene with per-point ``point_sizes``, runs K6's splat projection in
their place. With ``supersampling`` ss > 1 the pyramid is rasterized
at ss times the viewport and each level resized down before the UNet.

The raw modes (:meth:`NeuralRenderer.render_mode`: ``colors``,
``normals_m/l/r/d``, ``depth``, ``xyz``, ``labels``, ``uv_1d``,
``uv_2d``, ``pca`` descriptors, ``lit``, ``texture2d``) rasterize 1-px
points at the viewport with the checkpoint's z-buffer (never splats,
never supersampled, as ``read_tpu``) and gather per-point attributes
(:mod:`read_tpu_torch.ops.render_modes`). Frames are written as PNG by
:mod:`read_tpu_torch.data.image_io`.

Usage::

    python -m read_tpu_torch.render --scene scene.yaml --ckpt CKPT_DIR \\
        --out renders --fps-report [--mode normals_l] [--supersampling 2]
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
from read_tpu_torch.scene.io import mesh_inputs
from read_tpu_torch.models.unet import unet_from_state
from read_tpu_torch.ops import rasterize as R
from read_tpu_torch.ops import render_modes as RM
from read_tpu_torch.pipelines import texture_pipeline as TP
from read_tpu_torch.utils import ckpt as CK
from read_tpu_torch.utils import convert as CV
from read_tpu_torch.utils.profiling import span

__all__ = ["NeuralRenderer", "pca_color", "nearest_train", "main"]


def pca_color(descriptors: np.ndarray, sample: int = 100_000,
              seed: int = 0) -> np.ndarray:
    """Descriptors ``[N, C]`` to RGB ``[N, 3]`` in [0, 1]: their first
    three principal components (SVD of a ``sample``-row subset drawn
    with ``seed``), each stretched between its 2nd and 98th percentile
    over the subset."""
    rng = np.random.default_rng(seed)
    d = descriptors.astype(np.float64)
    idx = rng.permutation(len(d))[:sample]
    sub = d[idx]
    mu = sub.mean(0)
    _, _, vt = np.linalg.svd(sub - mu, full_matrices=False)
    proj = (d - mu) @ vt[:3].T
    lo, hi = np.percentile(proj[idx], [2, 98], axis=0)
    return np.clip((proj - lo) / np.maximum(hi - lo, 1e-9), 0, 1).astype(
        np.float32)


def nearest_train(view_matrices, query_m: np.ndarray) -> int:
    """Index of the camera-to-world pose among ``view_matrices`` nearest
    ``query_m``: position distance plus forward-axis distance."""
    best, best_d = 0, np.inf
    q_pos = query_m[:3, 3]
    q_fwd = -query_m[:3, 2]
    for i, m in enumerate(view_matrices):
        m = np.asarray(m)
        d = np.linalg.norm(m[:3, 3] - q_pos) \
            + np.linalg.norm(-m[:3, 2] - q_fwd)
        if d < best_d:
            best, best_d = i, d
    return best


class NeuralRenderer:
    """Render neural frames of one scene from one checkpoint.

    ``scene`` is a scene manifest path (loaded with
    ``read_tpu_torch.scene.io``: YAML, or JSON without PyYAML) or an
    already-loaded scene-data dict with the keys ``load_scene_data``
    returns (``pointcloud['xyz']``,
    ``intrinsic_matrix``, ``config['viewport_size']``, and optionally
    ``view_matrix``, ``point_sizes``, the point attributes of the raw
    and extra modes and a ``texture`` image). ``device`` defaults to
    CUDA; ``'cpu'`` runs the plain twins instead of the kernels.
    ``xyz`` and ``texture`` (the tuple of the point table) may be
    reassigned together (as many rows each) to render an edited or
    stitched scene."""

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
        if self.cfg.use_mesh != (texture[0].dim() == 3):
            raise ValueError("the checkpoint's texture does not match its "
                             f"config (use_mesh={self.cfg.use_mesh})")
        if not self.cfg.use_mesh and texture[0].shape[0] != xyz.shape[0]:
            raise ValueError(f"texture rows {texture[0].shape[0]} != "
                             f"points {xyz.shape[0]}")
        self.texture = tuple(t.to(self.device) for t in texture)
        # the mesh path's scene inputs, as the training step got them
        self.uv2d = self.faces = None
        if self.cfg.use_mesh:
            uv2d, faces = mesh_inputs(scene)
            self.uv2d = self._attr(uv2d)
            if faces is not None:
                self.faces = torch.from_numpy(faces).to(self.device)
        self.net = unet_from_state(state).to(self.device)
        if self.device.type == "cuda":   # fold BNs and pack weights now
            self.net.prepare(self.cfg.operands)
        # the point attributes the checkpoint's extra modes read
        pc = scene["pointcloud"]
        need = {m for g in self.cfg.extra_modes for m in g}
        self._needs_view = bool(need & set(RM.VIEW_DEPENDENT))
        self.pc_attrs = {a: self._attr(pc[a])
                         for a in RM.point_attributes(need)
                         if pc.get(a) is not None} if need else None
        self._mode_pc = None

    def _attr(self, a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.float32)).to(self.device)

    def _view_arg(self, view_matrix) -> Optional[torch.Tensor]:
        """``[1, 4, 4]`` camera-to-world for the view-dependent extra
        modes, else None."""
        if not self._needs_view:
            return None
        return self._attr(np.asarray(view_matrix, np.float32)[None])

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
                                point_sizes=self.point_sizes,
                                pointcloud=self.pc_attrs,
                                view_m=self._view_arg(view_matrix),
                                uv2d=self.uv2d, faces=self.faces)

    def index_pyramid(self, view_matrix: np.ndarray,
                      K: Optional[np.ndarray] = None):
        """The index maps ``[1, h_i, w_i]`` of the neural pyramid's
        levels for one view (at ``ss`` times the size, before the
        resize)."""
        cfg, ss = self.cfg, self.cfg.supersampling
        levels = R.rasterize_pyramid_pooled(
            self.xyz, self._matrix(view_matrix, K),
            (self.vh * ss, self.vw * ss), num_scales=cfg.num_scales,
            point_radius=cfg.point_radius, method=cfg.raster_method,
            point_sizes=self.point_sizes,
            relative_size=cfg.relative_point_size,
            min_point_size=cfg.min_point_size)
        return [ix for ix, _ in levels]

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
        with span("read.frame"):
            pyr = self.pyramid(view_matrix, K)
            if self.temporal_average:
                # average the net INPUT with the previous frame's
                # (averaged) pyramid, as read_tpu does (compose.py:167-171)
                if self._last_pyr is not None:
                    pyr = [(a + b) * 0.5
                           for a, b in zip(pyr, self._last_pyr)]
                self._last_pyr = pyr
            img = self._net(pyr)
            with span("read.download"):
                return np.clip(img[0].cpu().numpy(), 0.0, 1.0)

    def raster(self, view_matrix: np.ndarray,
               K: Optional[np.ndarray] = None):
        """``(index [1, h, w], depth [1, h, w])`` of the raw modes: 1-px
        points at the viewport through the checkpoint's z-buffer."""
        return R.rasterize_batch(self.xyz, self._matrix(view_matrix, K),
                                 self.vh, self.vw,
                                 method=self.cfg.raster_method)

    def _mode_pointcloud(self) -> dict:
        """The scene's point attributes on the device (made once) and its
        texture image in [0, 1], as :func:`~read_tpu_torch.ops.
        render_modes.render_mode` takes them."""
        if self._mode_pc is None:
            pc = {k: self._attr(v) for k, v in
                  self.scene_data["pointcloud"].items()
                  if k in ("xyz", "rgb", "xyz_c", "normals", "uv2d",
                           "labels") and v is not None}
            if self.scene_data.get("texture") is not None:
                pc["texture_image"] = self._attr(
                    self.scene_data["texture"]) / 255.0
            self._mode_pc = pc
        return self._mode_pc

    def render_mode(self, mode: str, view_matrix: np.ndarray,
                    K: Optional[np.ndarray] = None) -> np.ndarray:
        """One raw-mode frame ``[h, w, 3]`` float32: the modes of
        :mod:`read_tpu_torch.ops.render_modes` clipped to [0, 1] (one
        channel repeated three times), ``depth`` normalized over the
        covered pixels on the host, ``pca`` the descriptors' first three
        principal components (:func:`pca_color`)."""
        idx, dep = self.raster(view_matrix, K)
        if mode == "pca":
            if self.cfg.use_mesh:
                raise ValueError(
                    "pca descriptor view needs a point texture "
                    "(checkpoint was trained with --use-mesh)")
            colors = pca_color(self.texture[0].cpu().numpy())
            out = RM.gather_attribute(self._attr(colors), idx)
            return out[0].cpu().numpy()
        if mode == "depth":
            d = dep[0].cpu().numpy()
            filled = d > 0
            if filled.any():
                lo, hi = d[filled].min(), d[filled].max()
                d = np.where(filled, (d - lo) / max(hi - lo, 1e-9), 0)
            return np.repeat(d[..., None], 3, -1).astype(np.float32)
        out = RM.render_mode(mode, idx, dep, self._mode_pointcloud(),
                             view_matrix=np.asarray(view_matrix))
        out = out[0].cpu().numpy()
        if out.shape[-1] == 1:
            out = np.repeat(out, 3, -1)
        return np.clip(out.astype(np.float32), 0, 1)


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
                   help="neural | colors | normals_m/l/r/d | depth | xyz "
                        "| labels | uv_1d | uv_2d | pca | lit "
                        "(Blinn-Phong) | texture2d")
    p.add_argument("--viewport", default=None, help="WxH override")
    p.add_argument("--supersampling", type=int, default=None)
    p.add_argument("--conv-impl", dest="conv_impl", default=None,
                   choices=["xla", "im2col", "pallas"],
                   help="accepted for read_tpu compatibility; ignored")
    p.add_argument("--dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="bfloat16 = bf16 conv operands, f32 accumulation")
    p.add_argument("--raster-method", "--raster", dest="raster_method",
                   default=None,
                   choices=["sort", "scatter1", "scatter", "sort1q",
                            "pallas"],
                   help="z-buffer override: 'sort'/'scatter' exact (K5), "
                        "'sort1q' quantized depth bins, "
                        "'pallas'/'scatter1' packed key (K1)")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--fps-report", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain twins (slow: "
                        "its fps is not the port's speed)")
    args = p.parse_args(argv)
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
        # both end in a host copy: the frame is done
        img = r.infer(pose) if args.mode == "neural" else \
            r.render_mode(args.mode, pose)
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
