"""The mesh fit's first step, held stage by stage.

At a fresh net the mesh fit's step is chaotic in float32: a difference of
one rounding grows through the UNet's train-mode BatchNorm layers until
two float32 runs of the same step lie as far apart as a float32 run and
one with TF32 operands (PERF.md). A comparison of the whole step cannot
hold a run to float32 there. :class:`Stages` holds each stage of the
first step instead, against this reference's float32 form of the stage,
run on what the run under test handed that stage; no error crosses from
one stage into the next, so none grows:

- ``pyramid_gap``: the four sampled levels, against the reference's
  raster, uv and sample of the same tables at the same views;
- ``layer_gap``: each gated conv layer's output, against the reference
  layer on the run's own input and residual (the worst layer);
- ``layer_grad_gap``: each layer's parameter gradients, against the
  reference layer's vector-Jacobian product with the gradient that the
  run handed the layer's output (the worst layer);
- ``loss_gap``: the loss, against the reference loss at the run's image;
- ``image_grad_gap``: the loss's gradient at the image, against the
  reference loss's;
- ``texture_grad_gap``: the tables' gradient magnitudes, against the
  reference sample's product with the gradient that the run handed the
  pyramid, plus the regulariser's.

Each gap is a relative L2 distance, infinite where the shapes differ or
a stage never reported. A run reports its stages as it makes them:
:meth:`Stages.layer`, :meth:`Stages.pyramid` and :meth:`Stages.image`
in the forward, the ``*_grad`` methods from gradient hooks, then
:meth:`Stages.finish` with the run's first loss and gradients.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from benchmark.reference import mesh, unet
from benchmark.reference.fit import HUBER_RATIO, _guard, huber, vgg_loss
from benchmark.reference.prec import full_f32

__all__ = ["NUMBERS", "Stages"]

NUMBERS = ("pyramid_gap", "layer_gap", "layer_grad_gap", "loss_gap",
           "image_grad_gap", "texture_grad_gap")
# a layer's trainable parameters
LEAVES = ("conv_fm.kernel", "conv_fm.bias", "norm.scale", "norm.bias")
# the reference layer, as it is before any run watches it
_CONV = unet._Net.conv


def _rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """``|got - want| / |want|`` in float64; infinite where the shapes
    differ, either is not finite, or ``want`` is 0 and ``got`` is not."""
    if tuple(got.shape) != tuple(want.shape):
        return math.inf
    d = float(torch.linalg.vector_norm(got.double() - want.double()))
    n = float(torch.linalg.vector_norm(want.double()))
    if not (math.isfinite(d) and math.isfinite(n)):
        return math.inf
    if n == 0.0:
        return 0.0 if d == 0.0 else math.inf
    return d / n


class Stages:
    """The stages of one run's first step. ``params`` are the net's
    parameters and statistics before the step (the reference's names and
    layouts), ``tables`` the mesh tables, ``maps`` the reference's
    ``(face, uv)`` of each level (:func:`benchmark.reference.mesh.
    pyramid_maps`), ``target [B, h, w, 3]`` and ``vgg`` the step's."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 tables: Sequence[torch.Tensor], maps: List[tuple],
                 target: torch.Tensor, vgg, *, reg_weight: float,
                 grad_clip: float):
        self.params = {k: v.detach() for k, v in params.items()}
        self.tables = [t.detach() for t in tables]
        self.maps, self.target, self.vgg = maps, target, vgg
        self.reg_weight, self.grad_clip = reg_weight, grad_clip
        self.layers = [k[:-len(".conv_fm.kernel")] for k in params
                       if k.endswith(".conv_fm.kernel")]
        self.layer_gaps: Dict[str, float] = {}
        self.local: Dict[str, torch.Tensor] = {}
        self._inputs: Dict[str, tuple] = {}
        self._pyr_grads: Dict[int, torch.Tensor] = {}
        self._gaps: Dict[str, float] = {}
        self._im = None
        self._ref_loss = math.nan

    def _layer(self, name, x, res, stride, relu, leaves=None):
        p = self.params if leaves is None else {**self.params, **leaves}
        return _CONV(unet._Net(p, True, "f32"), name, x, stride, relu, res)

    # -- the forward -----------------------------------------------------
    def layer(self, name: str, x: torch.Tensor, res, stride: int,
              relu: bool, out: torch.Tensor) -> None:
        """Layer ``name`` made ``out`` from ``x`` (and ``res``), all
        NCHW."""
        x = x.detach()
        res = None if res is None else res.detach()
        with torch.no_grad(), full_f32():
            self.layer_gaps[name] = _rel_gap(
                out.detach(), self._layer(name, x, res, stride, relu))
        self._inputs[name] = (x, res, stride, relu)

    def pyramid(self, levels: Sequence[torch.Tensor]) -> None:
        """The sampled levels (NHWC) the run handed the net."""
        with torch.no_grad(), full_f32():
            want = [mesh.sample(self.tables, uv, face)
                    for face, uv in self.maps]
        self._gaps["pyramid_gap"] = max(
            _rel_gap(a.detach(), b) for a, b in zip(levels, want)) \
            if len(levels) == len(want) else math.inf

    def image(self, im: torch.Tensor) -> None:
        """The net's image (NHWC) that the loss reads."""
        self._im = im.detach()

    # -- the backward ----------------------------------------------------
    def layer_grad(self, name: str, g: torch.Tensor) -> None:
        """The gradient the run handed layer ``name``'s output (NCHW)."""
        if name not in self._inputs:
            return
        x, res, stride, relu = self._inputs.pop(name)
        keys = [f"{name}.{leaf}" for leaf in LEAVES]
        leaves = {k: self.params[k].clone().requires_grad_() for k in keys}
        with torch.enable_grad(), full_f32():
            y = self._layer(name, x, res, stride, relu, leaves)
            grads = torch.autograd.grad(y, list(leaves.values()),
                                        g.detach())
        for k, gi in zip(keys, grads):
            self.local[k] = _guard(gi, self.grad_clip)

    def pyramid_grad(self, level: int, g: torch.Tensor) -> None:
        self._pyr_grads[level] = g.detach()

    def image_grad(self, g: torch.Tensor) -> None:
        """The gradient the run handed the image."""
        if self._im is None or self._im.shape != self.target.shape:
            self._gaps["image_grad_gap"] = math.inf
            return
        with torch.enable_grad(), full_f32():
            im = self._im.clone().requires_grad_()
            loss = HUBER_RATIO * huber(im, self.target) \
                + vgg_loss(self.vgg, im, self.target, "f32")
            (want,) = torch.autograd.grad(loss, [im])
        with torch.no_grad():
            self._ref_loss = float(loss) + float(
                mesh.reg_loss(self.tables, self.reg_weight))
        self._gaps["image_grad_gap"] = _rel_gap(g.detach(), want)

    # -- the numbers -----------------------------------------------------
    def finish(self, loss: float, grads: Dict[str, torch.Tensor],
               texture_grads: Sequence[torch.Tensor]) -> Dict[str, float]:
        """:data:`NUMBERS`, given the run's first loss, its guarded first
        gradient of each trainable leaf by name, and the magnitude of its
        guarded first gradient of each table."""
        out = dict.fromkeys(NUMBERS, math.inf)
        out.update(self._gaps)
        if set(self.layer_gaps) == set(self.layers):
            out["layer_gap"] = max(self.layer_gaps.values())
        keys = [f"{n}.{leaf}" for n in self.layers for leaf in LEAVES]
        if all(k in self.local and k in grads for k in keys):
            out["layer_grad_gap"] = max(_rel_gap(
                torch.cat([grads[f"{n}.{leaf}"].reshape(-1)
                           for leaf in LEAVES]),
                torch.cat([self.local[f"{n}.{leaf}"].reshape(-1)
                           for leaf in LEAVES])) for n in self.layers)
        if math.isfinite(self._ref_loss) and math.isfinite(loss):
            out["loss_gap"] = abs(loss - self._ref_loss) / abs(self._ref_loss)
        out["texture_grad_gap"] = self._texture_gap(texture_grads)
        return out

    def _texture_gap(self, got: Sequence[torch.Tensor]) -> float:
        if sorted(self._pyr_grads) != list(range(len(self.maps))) or any(
                tuple(self._pyr_grads[i].shape) != tuple(uv.shape[:-1])
                + (self.tables[0].shape[-1],)
                for i, (_, uv) in enumerate(self.maps)):
            return math.inf
        ts = [t.clone().requires_grad_() for t in self.tables]
        with torch.enable_grad(), full_f32():
            outs = [mesh.sample(ts, uv, face) for face, uv in self.maps]
            outs.append(mesh.reg_loss(ts, self.reg_weight))
            gs = [self._pyr_grads[i] for i in range(len(self.maps))]
            want = torch.autograd.grad(outs, ts, gs + [torch.ones_like(
                outs[-1])])
        return _rel_gap(torch.cat([g.abs().reshape(-1) for g in got]),
                       torch.cat([_guard(w, self.grad_clip).abs().reshape(-1)
                                  for w in want]))
