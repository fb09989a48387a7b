"""A viewer in a closed loop: ``NeuralRenderer.infer`` at batch 1.

Set-up builds the street and the served checkpoint from the seed
(:mod:`benchmark.scene`, :mod:`benchmark.weights`), writes the
checkpoint under ``TMPDIR`` (the renderer takes a path), loads the
renderer, removes the checkpoint and renders the traffic's warm-up
frames. The window then sends one request at a time: each takes the next
pose of the trajectory, from a start drawn from the seed, and ends with
the frame on the host; its latency runs from the call to the returned
array. Every ``check_every``-th frame from a seeded offset, up to
``check_max``, is kept and compared after the window with the reference
at the same pose: the exact raster pyramid, the gather and the UNet in
eval form, float32.
"""

from __future__ import annotations

import math
import os
import shutil
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from benchmark import scene, weights
from benchmark.reference import raster as ref_raster
from benchmark.reference import unet as ref_unet
from benchmark.reference.prec import full_f32

__all__ = ["Cell"]


def net_sizes(cfg: dict) -> dict:
    return dict(cin=cfg["num_input_channels"],
                cout=cfg["num_output_channels"], bc=cfg["base_channel"],
                num_res=cfg["num_res"])


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.width, self.height = cfg["viewport"]
        self.K = scene.intrinsics(self.width, self.height, cfg["focal"])
        self.poses = scene.drive(traffic["poses"], traffic["pose_step_m"])
        rng = np.random.default_rng([self.seed % (1 << 63), 17])
        self.start = int(rng.integers(len(self.poses)))
        self.offset = int(rng.integers(traffic["check_every"]))
        self.kept = []
        self.renderer = None
        self.shape = dict(batch=1, h=self.height, w=self.width,
                          net=net_sizes(cfg))

    # -- the inputs, made alike for the program and the reference ----------
    def inputs(self):
        dev, cfg = self.device, self.cfg
        xyz = scene.street(cfg["points"],
                           weights.generator(self.seed, "scene", dev), dev)
        params = weights.unet_params(net_sizes(cfg), weights.generator(
            self.seed, "net", dev), dev, trained=True)
        table = weights.table(cfg["points"], cfg["descriptor_size"],
                              weights.generator(self.seed, "table", dev), dev)
        return xyz, params, table

    def setup(self) -> None:
        from read_tpu_torch.render import NeuralRenderer
        from read_tpu_torch.utils import ckpt as CK
        t0 = time.perf_counter()
        xyz, params, table = self.inputs()
        t1 = time.perf_counter()
        flat = {(("batch_stats/" if k.endswith((".mean", ".var"))
                  else "params/") + k.replace(".", "/")):
                v.cpu().numpy() for k, v in params.items()}
        flat["texture"] = table.cpu().numpy()
        data = {"pointcloud": {"xyz": xyz.cpu().numpy()},
                "intrinsic_matrix": self.K, "view_matrix": self.poses,
                "point_sizes": None,
                "config": {"viewport_size": (self.width, self.height)}}
        del xyz, params, table
        tmp = tempfile.mkdtemp(prefix="bench_view_")
        try:
            path = os.path.join(tmp, "ckpt")
            CK.save_checkpoint(path, flat, config={
                "raster_method": self.cfg["raster_method"],
                "dtype": self.cfg["dtype"],
                "descriptor_size": self.cfg["descriptor_size"]})
            del flat
            self.renderer = NeuralRenderer(data, path, device=self.device)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        t2 = time.perf_counter()
        for i in range(self.traffic["warmup_frames"]):
            self.renderer.infer(self.poses[(self.start - 1 - i)
                                           % len(self.poses)])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_parts = {"inputs": t1 - t0, "checkpoint_and_load": t2 - t1,
                            "warmup": time.perf_counter() - t2}

    def _keep(self, i: int) -> bool:
        t = self.traffic
        return (i % t["check_every"] == self.offset
                and len(self.kept) < t["check_max"])

    def window(self, seconds: float) -> dict:
        n = len(self.poses)
        lat, failed, i = [], 0, 0
        t0 = time.perf_counter()
        while True:
            k = (self.start + i) % n
            t = time.perf_counter()
            try:
                img = self.renderer.infer(self.poses[k])
            except Exception:           # a request that fails is counted
                img, failed = None, failed + 1
            t1 = time.perf_counter()
            lat.append(t1 - t)
            if img is not None and self._keep(i):
                self.kept.append((k, img))
            i += 1
            if t1 - t0 >= seconds:
                break
        elapsed = t1 - t0
        lat_ms = sorted(x * 1e3 for x in lat)
        p95 = lat_ms[max(0, math.ceil(0.95 * len(lat_ms)) - 1)]
        return {"metrics": {"frame_ms": elapsed / i * 1e3,
                            "frame_p95_ms": p95},
                "attempted": i, "failed": failed, "item_s": elapsed / i}

    def slice(self) -> int:
        """``traced_frames`` requests, as ``infer`` composes them, each
        part in a span of its own."""
        from torch.profiler import record_function
        r, n = self.renderer, self.traffic["traced_frames"]
        for i in range(n):
            pose = self.poses[(self.start + i) % len(self.poses)]
            with record_function("bench.frame"):
                with record_function("bench.pyramid"):
                    pyr = r.pyramid(pose)
                with record_function("bench.net"):
                    img = r.net(*pyr, operands=r.cfg.operands)["im_out"]
                with record_function("bench.download"):
                    np.clip(img[0].cpu().numpy(), 0.0, 1.0)
        return n

    def release(self) -> None:
        self.renderer = None

    # -- correctness --------------------------------------------------------
    def _reference_frame(self, xyz, params, table, pose, prec) -> np.ndarray:
        proj = scene.gl_projection(self.K, (self.width, self.height))
        m = scene.total_matrix(proj, pose).astype(np.float32)[None]
        levels = ref_raster.pyramid(xyz, torch.from_numpy(m).to(self.device),
                                    self.height, self.width,
                                    self.cfg["num_scales"])
        maps = [ref_raster.gather(table, ix) for ix, _ in levels]
        with torch.no_grad():
            out = ref_unet.forward(params, maps, train=False, prec=prec)
        return np.clip(out[0].cpu().numpy(), 0.0, 1.0)

    def readings(self, control: Optional[str] = None) -> dict:
        """``frame_gap``: the largest |program - reference| over the kept
        frames' pixels and channels (both clipped to [0, 1]). With
        ``control`` a precision, the reference in it takes the program's
        place at the poses a run keeps, against the float32 reference."""
        xyz, params, table = self.inputs()
        if control:
            idx = [(self.start + self.offset + j * self.traffic["check_every"])
                   % len(self.poses) for j in range(self.traffic["check_max"])]
        else:
            idx = [k for k, _ in self.kept]
        gap = 0.0 if idx else math.inf
        with full_f32():
            for j, k in enumerate(idx):
                want = self._reference_frame(xyz, params, table,
                                             self.poses[k], "f32")
                got = (self._reference_frame(xyz, params, table,
                                             self.poses[k], control)
                       if control else self.kept[j][1])
                if got.shape != want.shape or not np.isfinite(got).all():
                    return {"frame_gap": math.inf}
                gap = max(gap, float(np.abs(got - want).max()))
        return {"frame_gap": gap}
