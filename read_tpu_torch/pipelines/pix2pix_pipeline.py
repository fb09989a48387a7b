"""Pix2PixPipeline: the refinement net trained on raw rendered modalities
(no learnable point texture).

Counterpart of ``read_tpu/pipelines/pix2pix_pipeline.py``:
``Pix2PixConfig`` (:30-31), ``multiscale_inputs`` (:34-51),
``create_pix2pix_state`` (:54-69) and ``make_pix2pix_step`` (:72-106).
The net's input pyramid is a raw render mode (``colors`` by default) of
each level of the exact point pyramid (``rasterize_pyramid_pooled``,
'sort': K5 and the pyramid pass on the card); the UNet trains with
Adam (``optax.adam(lr)``: :func:`~read_tpu_torch.pipelines.
texture_pipeline.adam_update`, then ``-lr``) whose updates the plateau
decay ``lr_scale`` scales, after the same gradient guard and losses as
the texture pipeline's. The state is :class:`Pix2PixState`; its
checkpoint leaves are ``read_tpu``'s (``step``, ``params/``,
``batch_stats/``, ``opt/0/count``, ``opt/0/mu/``, ``opt/0/nu/``,
``lr_scale``), so either package resumes the other's.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List

import numpy as np
import torch

from read_tpu_torch.models.unet import UNet
from read_tpu_torch.ops import rasterize as R
from read_tpu_torch.ops import render_modes as RM
from read_tpu_torch.pipelines import texture_pipeline as TP
from read_tpu_torch.utils import fp32

__all__ = ["Pix2PixConfig", "Pix2PixState", "multiscale_inputs",
           "create_pix2pix_state", "pix2pix_state_from_flat",
           "flat_from_pix2pix_state", "loss_and_grad", "make_pix2pix_step"]

# the same hyperparameters as the texture pipeline
Pix2PixConfig = TP.PipelineConfig


def multiscale_inputs(modes: List[str], levels, pointcloud: Dict,
                      view_matrix=None, input_modality: int = 1):
    """The net's input pyramid from raw render modes: one map a
    ``(mode, (index, depth))`` pair of ``modes`` and ``levels``;
    consecutive groups of ``input_modality`` maps are concatenated along
    the channels, one group a scale."""
    maps = [RM.render_mode(mode, ix, dep, pointcloud, view_matrix)
            for mode, (ix, dep) in zip(modes, levels)]
    return [torch.cat(maps[i:i + input_modality], dim=-1)
            for i in range(0, len(maps), input_modality)]


@dataclasses.dataclass
class Pix2PixState:
    """``read_tpu``'s pix2pix state dict: the UNet's parameters in one
    flat buffer (``layout``'s order, as the texture pipeline's
    ``TrainState``), BatchNorm statistics, Adam's state and the plateau
    factor (a 0-d float32 tensor)."""
    step: int
    flat_params: torch.Tensor
    layout: TP.ParamLayout
    batch_stats: Dict[str, torch.Tensor]
    opt: TP.AdamState
    lr_scale: torch.Tensor

    @functools.cached_property
    def params(self) -> Dict[str, torch.Tensor]:
        return self.layout.views(self.flat_params)

    def replace(self, **changes) -> "Pix2PixState":
        return dataclasses.replace(self, **changes)


def create_pix2pix_state(generator: torch.Generator, cfg: TP.PipelineConfig,
                         in_channels: int = 3, net=None, device="cuda"):
    """A fresh state and its net: the UNet's flax-distributed init from
    ``generator`` (not ``jax.random``'s numbers), zero Adam moments."""
    if net is None:
        net = UNet(num_input_channels=in_channels,
                   num_classes=cfg.num_classes)
    net.init_weights(generator)
    params = dict(net.named_parameters())
    layout = TP.ParamLayout.of(params)
    flat = layout.flatten(params).detach().to(device)
    state = Pix2PixState(
        step=0, flat_params=flat, layout=layout,
        batch_stats={k: v.detach().to(device).clone()
                     for k, v in net.named_buffers()},
        opt=TP.AdamState(0, torch.zeros_like(flat), torch.zeros_like(flat)),
        lr_scale=torch.ones((), dtype=torch.float32, device=device))
    return state, net.to(device)


def pix2pix_state_from_flat(flat: Dict[str, np.ndarray], device="cuda"
                            ) -> Pix2PixState:
    """A ``read_tpu`` pix2pix checkpoint's leaves -> :class:`Pix2PixState`."""
    params = TP._subtree(flat, "params/", device)
    mu = TP._subtree(flat, "opt/0/mu/", device)
    nu = TP._subtree(flat, "opt/0/nu/", device)
    if not params or set(mu) != set(params) or set(nu) != set(params):
        raise ValueError("checkpoint holds no pix2pix state (params and "
                         "Adam's mu/nu under opt/0/)")
    layout = TP.ParamLayout.of(params)
    return Pix2PixState(
        step=int(flat["step"]), flat_params=layout.flatten(params),
        layout=layout,
        batch_stats=TP._subtree(flat, "batch_stats/", device),
        opt=TP.AdamState(int(flat["opt/0/count"]), layout.flatten(mu),
                         layout.flatten(nu)),
        lr_scale=TP._leaf(flat, "lr_scale", device))


def flat_from_pix2pix_state(state: Pix2PixState) -> Dict[str, np.ndarray]:
    """Inverse of :func:`pix2pix_state_from_flat`: the keys and dtypes of
    ``read_tpu``'s checkpoint of the same state."""
    flat = {}
    for prefix, tensors in (("params/", state.params),
                            ("batch_stats/", state.batch_stats),
                            ("opt/0/mu/", state.layout.views(state.opt.mu)),
                            ("opt/0/nu/", state.layout.views(state.opt.nu))):
        for name, t in tensors.items():
            flat[prefix + name.replace(".", "/")] = t.detach().cpu().numpy()
    flat["opt/0/count"] = np.asarray(state.opt.count, np.int32)
    flat["step"] = np.asarray(state.step, np.int32)
    flat["lr_scale"] = state.lr_scale.detach().cpu().numpy().astype(
        np.float32)
    return flat


def loss_and_grad(net: UNet, cfg: TP.PipelineConfig, vgg_params,
                  state: Pix2PixState, xyz: torch.Tensor, batch: dict,
                  pointcloud: Dict, mode: str = "colors"):
    """One forward and backward of :func:`make_pix2pix_step`'s step from
    ``state``: ``(loss, metrics, new batch_stats, flat gradient)``, the
    gradient before the guard."""
    flat = state.flat_params.detach().requires_grad_()
    levels = R.rasterize_pyramid_pooled(xyz, batch["total_m"],
                                        cfg.crop_size, cfg.num_scales)
    # the maps are float32; a float64 state (a test's referee) takes them
    # widened
    pyr = [RM.render_mode(mode, ix, dep, pointcloud).to(flat.dtype)
           for ix, dep in levels]
    bs = {k: v.clone() for k, v in state.batch_stats.items()}
    out = torch.func.functional_call(
        net, {**state.layout.views(flat), **bs}, tuple(pyr),
        {"train": True, "remat": cfg.remat, "operands": cfg.operands})
    loss, metrics = TP._losses(cfg, vgg_params, out, batch)
    (g,) = torch.autograd.grad(loss, [flat])
    return loss, metrics, bs, g


def make_pix2pix_step(net: UNet, cfg: TP.PipelineConfig, vgg_params,
                      pointcloud: Dict, mode: str = "colors"):
    """``step(state, xyz [N, 3], batch) -> (new_state, metrics)``:
    rasterize the crop's exact pyramid (``cfg.crop_size``,
    ``cfg.num_scales`` levels), render ``mode`` at each level from
    ``pointcloud``'s attributes, run the UNet in train mode, the texture
    pipeline's losses, the guard, Adam (:func:`loss_and_grad`, then the
    update). ``batch``: ``'total_m' [B, 4, 4]``, ``'target' [B, h, w,
    3]``. Full float32 (TF32 off), as the texture pipeline's step; with
    ``cfg.dtype='bfloat16'`` the net runs flax's bfloat16 activations."""
    pc = {"rgb": pointcloud["rgb"]}

    def step(state: Pix2PixState, xyz: torch.Tensor, batch: dict):
        with fp32.full_f32():
            return _step(state, xyz, batch)

    def _step(state: Pix2PixState, xyz: torch.Tensor, batch: dict):
        if not isinstance(pc["rgb"], torch.Tensor):
            pc["rgb"] = RM.to_f32(pc["rgb"], xyz.device)
        loss, metrics, bs, g = loss_and_grad(net, cfg, vgg_params, state,
                                             xyz, batch, pc, mode)
        with torch.no_grad():
            up, opt = TP.adam_update(TP._guard_grad(g, cfg.grad_clip),
                                     state.opt)
            new = state.replace(
                step=state.step + 1,
                flat_params=state.flat_params + (up * cfg.lr)
                * state.lr_scale,
                batch_stats=bs, opt=opt)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return new, metrics

    return step
