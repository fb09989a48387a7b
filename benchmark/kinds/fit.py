"""Fitting a scene: ``make_train_step`` driven step after step.

Set-up builds the street, a fresh net (lecun-normal kernels, zero biases,
BatchNorm the identity), the descriptor table, the VGG convs and the
traffic's batches from the seed: each batch ``batch_size`` views of the
trajectory, each view ``inner_batch`` crops (the dataset's zoom and
shift, farthest centres), each crop's world-to-clip matrix and a target
image uniform in [0, 1) (the step's work does not depend on the target's
content). It hands one train state to the program's step and runs the
first three batches through it: those are the warm-up, and what decides
``correct`` (each step's loss, each leaf's first gradient as the
optimizers hold it after step 1, each leaf's change after step 3). The
window then runs the step on the following batches, cycling, and ends in
a synchronize. After the window the reference runs the same three steps
from the same seeded start.
"""

from __future__ import annotations

import math
import statistics
import time
from typing import Optional

import numpy as np
import torch

from benchmark import scene, weights
from benchmark.kinds.view import net_sizes
from benchmark.reference import fit as ref_fit

__all__ = ["Cell", "compare"]

CHECKED_STEPS = 3
NUMBERS = ("loss1_gap", "grad_gap", "change_gap", "texture_change_gap")
# a leaf whose reference gradient is under this share of the median
# leaf's moves by round-off alone under Adam: its change is not compared
ROUNDOFF_GRAD = 1e-3


def compare(prog: dict, ref: dict) -> dict:
    """The numbers of a fit cell, from two sets of readings (each as
    :func:`benchmark.reference.fit.run_steps` returns them):

    - ``loss1_gap``: the first step's loss, its gap over the reference's;
    - ``grad_gap``: the worst leaf's gap of first-gradient norms over the
      larger of its reference norm and the median leaf's;
    - ``change_gap``: the median leaf's gap of change norms after the
      steps (each over the larger of its reference norm and the median
      leaf's), leaving out leaves whose reference gradient is round-off
      (:data:`ROUNDOFF_GRAD`);
    - ``texture_change_gap``: the same gap of the descriptor table.

    The later steps' losses and the worst leaf's change are not compared:
    Adam's and RMSprop's first updates are near ``-lr * sign(g)``, so
    the few components whose gradient sits at round-off flip from run to
    run, and by step 3 the reference read twice differs as much as the
    control does (PERF.md)."""
    if len(prog["losses"]) != len(ref["losses"]) or \
            set(prog["first_grad"]) != set(ref["first_grad"]):
        return dict.fromkeys(NUMBERS, math.inf)
    leaves = list(ref["first_grad"])
    g_med = statistics.median(ref["first_grad"].values())
    moving = [k for k in leaves if ref["first_grad"][k] >= ROUNDOFF_GRAD
              * g_med]

    def gaps(key, names):
        med = statistics.median(ref[key][k] for k in names)
        return {k: _gap(prog[key][k], ref[key][k], max(ref[key][k], med))
                for k in names}

    change = gaps("change", moving)
    return {"loss1_gap": _gap(prog["losses"][0], ref["losses"][0],
                              abs(ref["losses"][0])),
            "grad_gap": max(gaps("first_grad", leaves).values()),
            "change_gap": statistics.median(change.values()),
            "texture_change_gap": change.get("texture", math.inf)}


def _gap(got: float, want: float, scale: float) -> float:
    """``|got - want| / scale``, infinite where either is not finite."""
    gap = abs(got - want) / max(scale, 1e-30)
    return gap if math.isfinite(gap) else math.inf


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.width, self.height = cfg["viewport"]
        cw, ch = traffic["crop"] or cfg["viewport"]
        self.crop = (int(cw), int(ch))
        self.batch = traffic["batch_size"] * traffic["inner_batch"]
        self.matrices = self._plan()
        self.shape = dict(batch=self.batch, h=ch, w=cw, net=net_sizes(cfg))
        self.state = None
        self.prog = None

    def _plan(self):
        """Each batch's ``[B, 4, 4]`` float32 world-to-clip matrices."""
        t = self.traffic
        rng = np.random.default_rng([self.seed % (1 << 63), 29])
        views = scene.drive(t["views"], t["view_step_m"])
        K = scene.intrinsics(self.width, self.height, self.cfg["focal"])
        out = []
        while len(out) < t["batches"]:
            perm = rng.permutation(len(views))
            for j in range(0, len(perm) - t["batch_size"] + 1,
                           t["batch_size"]):
                ms = []
                for v in perm[j:j + t["batch_size"]]:
                    for H in scene.crop_homographies(
                            rng, (self.width, self.height), self.crop,
                            t["inner_batch"], t["inner_sample"],
                            t["random_zoom"], t["random_shift"]):
                        P = scene.gl_projection(H @ K, self.crop)
                        ms.append(scene.total_matrix(P, views[v]))
                out.append(np.stack(ms).astype(np.float32))
                if len(out) == t["batches"]:
                    break
        return out

    def inputs(self):
        dev, cfg = self.device, self.cfg
        xyz = scene.street(cfg["points"],
                           weights.generator(self.seed, "scene", dev), dev)
        params = weights.unet_params(net_sizes(cfg), weights.generator(
            self.seed, "net", dev), dev, trained=False)
        table = weights.table(cfg["points"], cfg["descriptor_size"],
                              weights.generator(self.seed, "table", dev), dev)
        vgg = weights.vgg_params(weights.generator(self.seed, "vgg", dev), dev)
        cw, ch = self.crop
        targets = torch.rand((len(self.matrices), self.batch, ch, cw, 3),
                             generator=weights.generator(self.seed, "targets",
                                                         dev), device=dev)
        batches = [{"total_m": torch.from_numpy(m).to(dev), "target": t}
                   for m, t in zip(self.matrices, targets)]
        return xyz, params, table, vgg, batches

    def setup(self) -> None:
        from read_tpu_torch.models.unet import UNet
        from read_tpu_torch.pipelines import texture_pipeline as TP
        cfg, dev = self.cfg, self.device
        t0 = time.perf_counter()
        xyz, params, table, vgg, batches = self.inputs()
        t1 = time.perf_counter()
        sizes = net_sizes(cfg)
        net = UNet(num_input_channels=sizes["cin"],
                   num_output_channels=sizes["cout"],
                   base_channel=sizes["bc"], num_res=sizes["num_res"]).to(dev)
        named = {k: params[k] for k, _ in net.named_parameters()}
        layout = TP.ParamLayout.of(named)
        flat = layout.flatten(named)
        state = TP.TrainState(
            step=0, flat_params=flat, layout=layout,
            batch_stats={k: params[k].clone()
                         for k, _ in net.named_buffers()},
            texture=(table,),
            net_opt=TP.AdamState(0, torch.zeros_like(flat),
                                 torch.zeros_like(flat)),
            tex_opt=TP.RmsState((torch.zeros_like(table),)),
            lr_scale=torch.ones((), dtype=torch.float32, device=dev))
        pcfg = TP.config_from_dict({
            "lr": cfg["lr"], "texture_lr": cfg["texture_lr"],
            "descriptor_size": cfg["descriptor_size"],
            "criterion": cfg["criterion"],
            "raster_method": cfg["raster_method"], "dtype": cfg["dtype"],
            "crop_size": f"{self.crop[0]}x{self.crop[1]}"})
        self.step = TP.make_train_step(net, pcfg, vgg)
        self.xyz, self.batches = xyz, batches
        t2 = time.perf_counter()
        s0 = state
        losses, first = [], None
        for i in range(CHECKED_STEPS):
            state, metrics = self.step(state, xyz, batches[i])
            losses.append(metrics["loss"])
            if i == 0:
                first = self._first_grads(state)
        change = self._changes(s0, state)
        self.prog = {"losses": [float(x) for x in losses],
                     "first_grad": first, "change": change}
        self.state, self.next = state, CHECKED_STEPS
        del s0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.setup_parts = {"inputs": t1 - t0, "program": t2 - t1,
                            "checked_steps": time.perf_counter() - t2}

    @staticmethod
    def _first_grads(state) -> dict:
        """The guarded first gradient's norm of each leaf, from the
        optimizers' state after one step: Adam's ``mu = 0.1 g``,
        RMSprop's ``nu = 0.01 g^2``."""
        with torch.no_grad():
            out = {k: float(torch.linalg.vector_norm(v / (1 - 0.9)))
                   for k, v in state.layout.views(state.net_opt.mu).items()}
            out["texture"] = math.sqrt(float(
                state.tex_opt.nu[0].double().sum()) / (1 - 0.99))
        return out

    @staticmethod
    def _changes(s0, s3) -> dict:
        with torch.no_grad():
            d = s3.layout.views(s3.flat_params - s0.flat_params)
            out = {k: float(torch.linalg.vector_norm(v)) for k, v in d.items()}
            out["texture"] = float(torch.linalg.vector_norm(
                s3.texture[0] - s0.texture[0]))
        return out

    def window(self, seconds: float) -> dict:
        n, i0 = len(self.batches), self.next
        t0 = time.perf_counter()
        while True:
            self.state, _ = self.step(self.state, self.xyz,
                                      self.batches[self.next % n])
            self.next += 1
            if time.perf_counter() - t0 >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        steps = self.next - i0
        return {"metrics": {"step_ms": elapsed / steps * 1e3},
                "attempted": steps, "failed": 0, "item_s": elapsed / steps}

    def slice(self) -> int:
        from torch.profiler import record_function
        n = self.traffic["traced_steps"]
        for _ in range(n):
            with record_function("bench.step"):
                self.state, _ = self.step(self.state, self.xyz, self.batches[
                    self.next % len(self.batches)])
                self.next += 1
        return n

    def release(self) -> None:
        self.state = self.step = self.xyz = self.batches = None

    def readings(self, control: Optional[str] = None) -> dict:
        """The numbers of :func:`compare` over the first three steps. With
        ``control`` a precision, the reference in it takes the program's
        place."""
        xyz, params, table, vgg, batches = self.inputs()
        kw = dict(lr=self.cfg["lr"], texture_lr=self.cfg["texture_lr"],
                  levels=self.cfg["num_scales"],
                  grad_clip=self.cfg["grad_clip"])
        ref = ref_fit.run_steps(params, table, xyz, batches[:CHECKED_STEPS],
                                vgg, prec="f32", **kw)
        if control:
            prog = ref_fit.run_steps(params, table, xyz,
                                     batches[:CHECKED_STEPS], vgg,
                                     prec=control, **kw)
        else:
            prog = self.prog
        return compare(prog, ref)

