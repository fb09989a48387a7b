"""Fitting neural mesh textures: ``make_train_step`` with ``use_mesh`` and
the triangle raster, driven step after step.

As :mod:`benchmark.kinds.fit`, but the scene is the street's triangle
mesh with its uv atlas (:mod:`benchmark.street_mesh`) and the texture is
the configuration's four tables (``[s / 2^i, s / 2^i, C]``, uniform in
[0, 1) from the seed, as the pipeline's 'rand' init); every batch
carries the mesh's vertex uv (``uv2d``) and ``faces``, so each step
rasterizes every view at every level (``ops.rasterize_mesh.counts`` holds
the first three steps to it).

The first three steps decide ``correct`` (:data:`NUMBERS`). At a fresh
net this step is chaotic in float32: a perturbation of one rounding
grows through the decoder's layers until the first loss and gradients of
the reference in float32, of the program and of the reference with TF32
operands each lie as far from a float64 run as from one another
(PERF.md). So the first step is held stage by stage
(:mod:`benchmark.reference.mesh_stages`): hooks on the program's net
(:func:`watch`) hand each ``BasicConv``'s input, output and output
gradient, the pyramid and the image to the reference, which recomputes
that stage alone in float32. The changes after three steps, which
Adam's and RMSprop's sign-like first updates keep, are compared with
:func:`benchmark.kinds.fit.compare` (the texture's leaf is the four
tables as one); its first loss and gradient gaps go to standard error.
"""

from __future__ import annotations

import math
import sys
import time
from typing import Optional

import torch

from benchmark import street_mesh, weights
from benchmark.kinds import fit
from benchmark.kinds.fit import CHECKED_STEPS, compare
from benchmark.kinds.view import net_sizes
from benchmark.reference import mesh as ref_mesh
from benchmark.reference import mesh_fit as ref_mesh_fit
from benchmark.reference import mesh_stages

__all__ = ["NUMBERS", "Cell", "mesh_tables", "watch"]

NUMBERS = mesh_stages.NUMBERS + ("change_gap", "texture_change_gap")


def mesh_tables(cfg: dict, gen: torch.Generator, device):
    """The ``texture_levels`` tables ``[s / 2^i, s / 2^i, C]`` (``s`` the
    ``texture_size``), uniform in [0, 1), from one draw."""
    s, c = cfg["texture_size"], cfg["descriptor_size"]
    shapes = [(s >> i, s >> i, c) for i in range(cfg["texture_levels"])]
    draw = torch.rand(sum(math.prod(x) for x in shapes), generator=gen,
                      device=device)
    return [part.view(x) for x, part in zip(shapes, draw.split(
        [math.prod(x) for x in shapes]))]


def _nchw(t):
    return None if t is None else t.permute(0, 3, 1, 2)


def watch(net, stages: "mesh_stages.Stages") -> list:
    """Hooks on the program's UNet ``net`` that hand ``stages`` what its
    next forward and backward make: each ``BasicConv``'s input, residual,
    output and output gradient (as NCHW views), the pyramid the net reads
    and its gradients, the image and its gradient. Returns the handles;
    remove them after the step."""
    from read_tpu_torch.models.unet import BasicConv

    def layer(name):
        def hook(mod, args, kwargs, out):
            res = kwargs.get("res", args[3] if len(args) > 3 else None)
            stages.layer(name, _nchw(args[0]), _nchw(res), mod.stride,
                         mod.relu, _nchw(out))
            if out.requires_grad:
                out.register_hook(
                    lambda g: stages.layer_grad(name, _nchw(g)))
        return hook

    def pyramid(mod, args):
        stages.pyramid(list(args[:4]))
        for i, x in enumerate(args[:4]):
            if x.requires_grad:
                x.register_hook(lambda g, i=i: stages.pyramid_grad(i, g))

    def image(mod, args, out):
        im = out["im_out"]
        stages.image(im)
        if im.requires_grad:
            im.register_hook(stages.image_grad)

    handles = [mod.register_forward_hook(layer(name), with_kwargs=True)
               for name, mod in net.named_modules()
               if isinstance(mod, BasicConv)]
    return handles + [net.register_forward_pre_hook(pyramid),
                      net.register_forward_hook(image)]


class Cell(fit.Cell):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        super().__init__(cfg, traffic, seed, device)
        faces, verts = street_mesh.counts(cfg["mesh_edge_m"])
        self.shape.update(mesh=(verts, faces), levels=cfg["num_scales"])

    def inputs(self):
        dev, cfg = self.device, self.cfg
        verts, faces, uv = street_mesh.street_mesh(
            cfg["mesh_edge_m"], cfg["mesh_jitter_m"],
            weights.generator(self.seed, "scene", dev), dev)
        params = weights.unet_params(net_sizes(cfg), weights.generator(
            self.seed, "net", dev), dev, trained=False)
        tables = mesh_tables(cfg, weights.generator(self.seed, "table", dev),
                             dev)
        vgg = weights.vgg_params(weights.generator(self.seed, "vgg", dev), dev)
        cw, ch = self.crop
        targets = torch.rand((len(self.matrices), self.batch, ch, cw, 3),
                             generator=weights.generator(self.seed, "targets",
                                                         dev), device=dev)
        batches = [{"total_m": torch.from_numpy(m).to(dev), "target": t,
                    "uv2d": uv, "faces": faces}
                   for m, t in zip(self.matrices, targets)]
        return (verts, faces, uv), params, tables, vgg, batches

    def setup(self) -> None:
        from read_tpu_torch.models.unet import UNet
        from read_tpu_torch.ops import rasterize_mesh as RMesh
        from read_tpu_torch.pipelines import texture_pipeline as TP
        cfg, dev = self.cfg, self.device
        rasters = RMesh.counts["rasters"]
        t0 = time.perf_counter()
        mesh, params, tables, vgg, batches = self.inputs()
        verts = mesh[0]
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
            texture=tuple(tables),
            net_opt=TP.AdamState(0, torch.zeros_like(flat),
                                 torch.zeros_like(flat)),
            tex_opt=TP.RmsState(tuple(torch.zeros_like(t) for t in tables)),
            lr_scale=torch.ones((), dtype=torch.float32, device=dev))
        pcfg = TP.config_from_dict({
            "lr": cfg["lr"], "texture_lr": cfg["texture_lr"],
            "descriptor_size": cfg["descriptor_size"],
            "criterion": cfg["criterion"], "dtype": cfg["dtype"],
            "use_mesh": cfg["use_mesh"], "texture_size": cfg["texture_size"],
            "reg_weight": cfg["reg_weight"],
            "crop_size": f"{self.crop[0]}x{self.crop[1]}"})
        self.step = TP.make_train_step(net, pcfg, vgg)
        self.xyz, self.batches = verts, batches
        t2 = time.perf_counter()
        s0 = state
        stages = self._stages(mesh, params, tables, vgg, batches[0])
        hooks = watch(net, stages)
        try:
            state, metrics = self.step(state, verts, batches[0])
        finally:
            for h in hooks:
                h.remove()
        losses, first = [metrics["loss"]], self._first_grads(state)
        staged = self._finish(stages, float(metrics["loss"]), state)
        del stages
        for i in range(1, CHECKED_STEPS):
            state, metrics = self.step(state, verts, batches[i])
            losses.append(metrics["loss"])
        rasters = RMesh.counts["rasters"] - rasters
        if rasters != CHECKED_STEPS * self.batch * cfg["num_scales"]:
            raise RuntimeError(f"fit_mesh: {rasters} triangle rasters in "
                               f"{CHECKED_STEPS} steps, not one a view and "
                               "level")
        change = self._changes(s0, state)
        self.prog = {"losses": [float(x) for x in losses],
                     "first_grad": first, "change": change,
                     "stages": staged}
        self.state, self.next = state, CHECKED_STEPS
        del s0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.setup_parts = {"inputs": t1 - t0, "program": t2 - t1,
                            "checked_steps": time.perf_counter() - t2}

    def _stages(self, mesh, params, tables, vgg, batch):
        """The reference's :class:`mesh_stages.Stages` of the first step,
        with its own raster maps of ``batch``'s views."""
        cfg = self.cfg
        (verts, faces, uv), target = mesh, batch["target"]
        with torch.no_grad():
            maps = ref_mesh.pyramid_maps(
                verts, faces, uv, batch["total_m"], target.shape[1],
                target.shape[2], cfg["num_scales"], cfg["samples"])
        return mesh_stages.Stages(
            params, tables, maps, target, vgg, reg_weight=cfg["reg_weight"],
            grad_clip=cfg["grad_clip"])

    @staticmethod
    def _finish(stages, loss: float, state) -> dict:
        """The first step's stage numbers: the program's guarded first
        gradients are Adam's first moment over ``1 - b1`` and the tables'
        magnitudes RMSprop's ``sqrt(nu / (1 - decay))``."""
        with torch.no_grad():
            grads = {k: v / (1 - 0.9)
                     for k, v in state.layout.views(state.net_opt.mu).items()}
            tex = [torch.sqrt(nu / (1 - 0.99)) for nu in state.tex_opt.nu]
            return stages.finish(loss, grads, tex)

    @staticmethod
    def _first_grads(state) -> dict:
        """As :meth:`benchmark.kinds.fit.Cell._first_grads`, the texture's
        over its four tables."""
        with torch.no_grad():
            out = {k: float(torch.linalg.vector_norm(v / (1 - 0.9)))
                   for k, v in state.layout.views(state.net_opt.mu).items()}
            out["texture"] = math.sqrt(sum(
                float(nu.double().sum()) for nu in state.tex_opt.nu)
                / (1 - 0.99))
        return out

    @staticmethod
    def _changes(s0, s3) -> dict:
        with torch.no_grad():
            d = s3.layout.views(s3.flat_params - s0.flat_params)
            out = {k: float(torch.linalg.vector_norm(v)) for k, v in d.items()}
            out["texture"] = math.sqrt(sum(
                float(torch.square((b - a).double()).sum())
                for a, b in zip(s0.texture, s3.texture)))
        return out

    def readings(self, control: Optional[str] = None) -> dict:
        """:data:`NUMBERS` of :func:`benchmark.kinds.fit.compare` over the
        first three steps (the others to standard error). With
        ``control`` a precision, the reference in it takes the program's
        place."""
        (verts, faces, uv), params, tables, vgg, batches = self.inputs()
        kw = dict(lr=self.cfg["lr"], texture_lr=self.cfg["texture_lr"],
                  levels=self.cfg["num_scales"],
                  reg_weight=self.cfg["reg_weight"],
                  samples=self.cfg["samples"],
                  grad_clip=self.cfg["grad_clip"])
        args = (params, tables, verts, faces, uv, batches[:CHECKED_STEPS],
                vgg)
        ref = ref_mesh_fit.run_steps(*args, prec="f32", **kw)
        prog = ref_mesh_fit.run_steps(*args, prec=control, stages=True,
                                      **kw) if control else self.prog
        nums = {**compare(prog, ref), **prog["stages"]}
        print("not compared: " + ", ".join(
            f"{k} {v!r}" for k, v in nums.items() if k not in NUMBERS),
            file=sys.stderr)
        return {k: nums[k] for k in NUMBERS}
