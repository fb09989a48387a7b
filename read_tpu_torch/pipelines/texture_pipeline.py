"""The texture pipeline: config, pyramid, and the training step.

Counterpart of ``read_tpu/pipelines/texture_pipeline.py``:
``PipelineConfig`` (:47-120), ``parse_format_geometry`` (:123-152),
``config_from_dict`` (:155-215), ``TrainState``, ``_guard_grad`` and the
optimizers (:218-250), ``create_state`` (:253-299, point texture), a
whole ``TrainState`` to and from its checkpoint leaves
(``state_from_flat``/``flat_from_state``), ``_build_pyramid``
(:345-415, the point-texture branch: 1-px points, splats and per-point
or z-scaled sizes),
``_forward`` (:418-449), ``_losses`` (:452-518), ``make_train_step``
(:521-632), ``make_eval_step`` (:635-659) and ``ReduceLROnPlateau``
(:662-684).

A train step is eager PyTorch under autograd: z-buffer (K5 for the
default 'sort', K1 for 'pallas'/'scatter1', K6's splat projection for
either with ``point_radius > 0``; no gradient flows into the
projection) -> exact pyramid pool -> descriptor gather with the
per-image scatter-add backward (1-px points) or the summing one
(splats) -> the UNet's differentiable route
(``F.conv2d``, flax's BatchNorm) -> losses -> gradients -> the gradient
guard -> Adam (net) and RMS (texture) updates that reproduce optax's.
The net's parameters and Adam moments each live in one flat buffer, so
the guard, Adam and the parameter update are a few kernels a step. A
step returns a new :class:`TrainState` and leaves the one it was given
untouched, as the JAX step does without donation. The VGG target
features run under ``no_grad``. With ``remat`` the UNet's EBlocks and
DBlocks run under ``torch.utils.checkpoint`` (``models.unet.UNet``), as
``read_tpu``'s run under ``nn.remat``.

A checkpoint's ``conv_impl`` (``xla``/``im2col``/``pallas``) is checked
and dropped: every name holds the same parameters, and training always
runs the differentiable route. Configurations that need code the port
does not have yet raise ``NotImplementedError``: mesh textures, extra
input modes, supersampling, point dropout and jitter (the train
dataset's ``drop_points``/``perturb_points``), ``label_in_input``,
bfloat16 training and the VGG ensemble; the fields that only those use
(``texture_size``, ``label_in_input``) are left out.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from read_tpu_torch.criterions import losses as L
from read_tpu_torch.criterions import vgg as V
from read_tpu_torch.models import texture as T
from read_tpu_torch.models.unet import UNet
from read_tpu_torch.ops import rasterize as R
from read_tpu_torch.utils import convert as CV
from read_tpu_torch.utils import fp32

__all__ = ["PipelineConfig", "parse_format_geometry", "config_from_dict",
           "build_pyramid", "ParamLayout", "TrainState", "AdamState",
           "RmsState", "adam_update", "rms_update", "create_state",
           "state_from_flat", "flat_from_state", "make_train_step",
           "make_eval_step", "ReduceLROnPlateau"]

Tensors = Dict[str, torch.Tensor]

_DEFAULT_FORMAT = ("uv_1d_p1, uv_1d_p1_ds1, uv_1d_p1_ds2, uv_1d_p1_ds3, "
                   "uv_1d_p1_ds4")
_CONV_IMPLS = ("xla", "im2col", "pallas")
_DTYPES = ("float32", "bfloat16")
_CRITERIA = ("vgg", "vgg_pytorch", "vgg_mix", "vgg_partial", "vgg_ens",
             "huber_only")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static experiment hyperparameters: ``read_tpu``'s fields and
    defaults (less the two named in the module docstring), with
    ``dtype`` named 'float32' or 'bfloat16'."""
    crop_size: Tuple[int, int] = (256, 256)      # (h, w)
    descriptor_size: int = 8
    num_scales: int = 4
    supersampling: int = 1
    lr: float = 1e-4
    texture_lr: float = 1e-1
    huber_ratio: float = 1e4
    seg_ratio: float = 3e2
    vgg_ratio: float = 1.0
    vgg_partialconv: bool = False
    vgg_backend: str = "caffe"    # 'caffe', 'pytorch' or 'mix'
    vgg_ensemble: int = 0
    reg_weight: float = 0.0
    texture_activation: str = "none"
    use_mask: bool = False
    masked_background: bool = False
    num_classes: Optional[int] = None
    point_radius: int = 0
    relative_point_size: bool = False   # 'ps': z-scaled splat sizes
    min_point_size: float = 1.0         # the z-scaled sizes' floor
    grad_clip: float = 1e3
    use_mesh: bool = False
    temporal_average: bool = False
    drop_points: float = 0.0
    perturb_points: float = 0.0
    extra_modes: Tuple[Tuple[str, ...], ...] = ()
    # 'bfloat16' serves with bf16 conv operands and float32 accumulation
    # and activations; training runs float32 only
    dtype: str = "float32"
    raster_method: str = "sort"
    remat: bool = False

    @property
    def net_in_channels(self) -> int:
        """UNet input channels: descriptors + extra modality channels."""
        extra = 0
        if self.extra_modes:
            extra = sum(1 if m in ("depth", "labels", "uv_1d") else 3
                        for m in self.extra_modes[0])
        return self.descriptor_size + extra

    @property
    def operands(self) -> str:
        return "bf16" if self.dtype == "bfloat16" else "f32"


def parse_format_geometry(input_format: str):
    """``(point_radius, relative_point_size, extra_modes)`` from the
    input-format DSL string (same derivation as ``read_tpu``)."""
    from read_tpu_torch.scene.formats import parse_input_format
    specs = parse_input_format(input_format)
    relative_ps = any(sp.splat_mode for sp in specs)
    point_radius = 0
    for sp in specs:
        point_radius = max(point_radius,
                           sp.point_size if sp.splat_mode
                           else (sp.point_size - 1) // 2)
    groups = []
    for sp in specs:
        if sp.mode == "uv_1d":
            groups.append([])
        elif groups:
            groups[-1].append(sp.mode)
    extra_modes = ()
    if any(groups):
        if len(set(map(tuple, groups))) != 1:
            raise ValueError(
                "input_format: every scale must carry the SAME extra "
                f"modalities (one UNet input width); got {groups}")
        extra_modes = tuple(tuple(g) for g in groups)
    return point_radius, relative_ps, extra_modes


def _unported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported to read_tpu_torch "
                              f"(ROADMAP {item})")


def _check_geometry(cfg: PipelineConfig) -> None:
    """Raise for the pyramid configurations the port does not have."""
    if cfg.use_mesh:
        _unported("the mesh-texture path (use_mesh)", "queue 1, item 9")
    if cfg.extra_modes:
        _unported("extra input modes", "queue 1, item 9")
    if cfg.supersampling > 1:
        _unported("supersampling", "queue 1, item 6")


def _check_trainable(cfg: PipelineConfig) -> None:
    """Raise for the training configurations the port does not have."""
    _check_geometry(cfg)
    if cfg.drop_points > 0 or cfg.perturb_points > 0:
        _unported("point dropout and jitter (ops/augment.py)",
                  "queue 1, item 9")
    if cfg.vgg_ensemble:
        _unported("the VGG ensemble (vgg_ens)", "'Not ported'")
    if cfg.dtype != "float32":
        _unported("bfloat16 training", "queue 1, item 8")


def _crop_size(d: dict, crop_size) -> Tuple[int, int]:
    """``(h, w)``: ``crop_size`` if given, else the dict's (``'WxH'`` or
    ``(h, w)``), else 256x256."""
    if crop_size is None:
        crop_size = d.get("crop_size", (256, 256))
        if isinstance(crop_size, str):
            w, h = crop_size.lower().split("x")
            crop_size = (int(h), int(w))
    return tuple(int(x) for x in crop_size)


def config_from_dict(d: dict, crop_size: Optional[Tuple[int, int]] = None,
                     train_dataset_args: Optional[dict] = None
                     ) -> PipelineConfig:
    """A :class:`PipelineConfig` from an args-style dict (the train CLI's
    ``vars(args)`` or a checkpoint's embedded ``config``) at
    ``crop_size`` ``(h, w)`` (default: the dict's ``crop_size``), with
    the train dataset's ``drop_points``/``perturb_points``, as
    ``read_tpu`` builds it; raises for what the port does not have."""
    tda = train_dataset_args or {}
    if tda.get("label_in_input"):
        _unported("label_in_input", "queue 1, item 9")
    criterion = d.get("criterion", "vgg")
    if criterion not in _CRITERIA:
        raise ValueError(f"unknown criterion {criterion!r}; expected one "
                         f"of {_CRITERIA}")
    raster_method = d.get("raster_method", "sort") or "sort"
    R._check_method(raster_method)  # config files bypass argparse choices
    if (d.get("conv_impl") or "xla") not in _CONV_IMPLS:
        raise ValueError(f"unknown conv_impl {d['conv_impl']!r}")
    dtype = d.get("dtype") or "float32"
    if dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}")
    point_radius, relative_ps, extra_modes = parse_format_geometry(
        d.get("input_format", _DEFAULT_FORMAT))
    cfg = PipelineConfig(
        crop_size=_crop_size(d, crop_size),
        point_radius=point_radius,
        relative_point_size=relative_ps,
        extra_modes=extra_modes,
        drop_points=float(tda.get("drop_points", 0.0)),
        perturb_points=float(tda.get("perturb_points", 0.0)),
        descriptor_size=int(d.get("descriptor_size", 8)),
        supersampling=int(d.get("supersampling", 1) or 1),
        lr=float(d.get("lr", 1e-4)),
        texture_lr=float(d.get("texture_lr", 1e-1)),
        vgg_ratio=0.0 if criterion == "huber_only" else 1.0,
        vgg_partialconv=criterion == "vgg_partial",
        vgg_backend={"vgg_pytorch": "pytorch",
                     "vgg_mix": "mix"}.get(criterion, "caffe"),
        vgg_ensemble=(int(d.get("vgg_ens_k", 3)) if criterion == "vgg_ens"
                      else 0),
        huber_ratio=1e4 if criterion != "huber_only" else 1.0,
        reg_weight=float(d.get("reg_weight", 0.0) or 0.0),
        texture_activation=d.get("texture_activation", "none"),
        use_mask=bool(d.get("use_mask", False)
                      or d.get("masked_background", False)),
        masked_background=bool(d.get("masked_background", False)),
        use_mesh=bool(d.get("use_mesh", False)),
        temporal_average=bool(d.get("temporal_average", False)),
        num_classes=d.get("num_classes"),
        dtype=dtype,
        raster_method=raster_method,
        remat=bool(d.get("remat", False)),
    )
    _check_geometry(cfg)
    return cfg


def build_pyramid(cfg: PipelineConfig, texture: torch.Tensor,
                  xyz: torch.Tensor, total_m: torch.Tensor, shape=None,
                  point_sizes=None):
    """Rasterize the pyramid (one full-resolution z-buffer, splatted
    where ``cfg.point_radius > 0``, exact 2x2 pair pools) and gather
    descriptors: ``cfg.num_scales`` maps ``[B, h_i, w_i, C]``.
    ``point_sizes`` is the scene manifest's per-point size buffer. The
    gather's backward is the per-image scatter-add for 1-px points and
    the summing one for splats, as ``read_tpu`` picks them."""
    _check_geometry(cfg)
    h, w = shape or cfg.crop_size
    levels = R.rasterize_pyramid_pooled(
        xyz, total_m, (h, w), num_scales=cfg.num_scales,
        point_radius=cfg.point_radius, method=cfg.raster_method,
        point_sizes=point_sizes, relative_size=cfg.relative_point_size,
        min_point_size=cfg.min_point_size, pool_impl="exact")
    sample = (T.sample_point_texture_unique if cfg.point_radius == 0
              else T.sample_point_texture)
    return [sample(texture, ix, cfg.texture_activation) for ix, _ in levels]


# --------------------------------------------------------------------------
# Training state and optimizers
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamLayout:
    """Where each net parameter lies in one flat float32 buffer: the
    names and shapes in buffer order."""
    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]

    @classmethod
    def of(cls, tensors: Tensors) -> "ParamLayout":
        return cls(tuple(tensors), tuple(tuple(t.shape)
                                         for t in tensors.values()))

    def flatten(self, tensors: Tensors) -> torch.Tensor:
        """One buffer of ``tensors`` (keyed by ``names``), in order."""
        return torch.cat([tensors[k].reshape(-1) for k in self.names])

    def views(self, flat: torch.Tensor) -> Tensors:
        """Views of ``flat``, keyed by name and shaped."""
        parts = flat.split([int(np.prod(s)) for s in self.shapes])
        return {k: p.view(s)
                for k, s, p in zip(self.names, self.shapes, parts)}


@dataclasses.dataclass
class AdamState:
    """``optax.scale_by_adam``'s state: update count, first and second
    moments as flat buffers in the parameters' layout."""
    count: int
    mu: torch.Tensor
    nu: torch.Tensor


@dataclasses.dataclass
class RmsState:
    """``optax.scale_by_rms``'s state: the second moment."""
    nu: torch.Tensor


@dataclasses.dataclass
class TrainState:
    """The JAX ``TrainState``. The UNet's parameters lie in one flat
    buffer ``flat_params`` in ``layout``'s order (the Adam moments
    too); ``params`` gives them keyed by the port's module names
    (``feat0.conv_fm.kernel``). ``batch_stats`` are the BatchNorm
    running statistics keyed the same way (``feat0.norm.mean``).
    ``lr_scale`` is a 0-d float32 tensor."""
    step: int
    flat_params: torch.Tensor
    layout: ParamLayout
    batch_stats: Tensors
    texture: torch.Tensor
    net_opt: AdamState
    tex_opt: RmsState
    lr_scale: torch.Tensor

    @functools.cached_property
    def params(self) -> Tensors:
        """Keyed views of ``flat_params``, made once per state."""
        return self.layout.views(self.flat_params)

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def _guard_grad(g: torch.Tensor, clip: float) -> torch.Tensor:
    """NaN -> 0, +-inf -> +-clip, then clip to [-clip, clip]."""
    return torch.nan_to_num(g, nan=0.0, posinf=clip,
                            neginf=-clip).clamp(-clip, clip)


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32, as optax computes it."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def adam_update(g: torch.Tensor, state: AdamState, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8):
    """``optax.chain(scale_by_adam(b1, b2, eps), scale(-1))`` on a flat
    gradient buffer: ``(updates, new state)``; the update is ``-m_hat /
    (sqrt(v_hat) + eps)``. (``torch.optim.Adam`` folds the bias
    corrections into the step size and ``eps``, which rounds
    differently.) A handful of kernels over the buffer, with no
    per-tensor work on the host."""
    count = state.count + 1
    c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
    mu = (1 - b1) * g + b1 * state.mu
    nu = (1 - b2) * (g * g) + b2 * state.nu
    updates = -((mu / c1) / (torch.sqrt(nu / c2) + eps))
    return updates, AdamState(count, mu, nu)


def rms_update(g: torch.Tensor, state: RmsState, decay: float = 0.99,
               eps: float = 1e-8):
    """``optax.chain(scale_by_rms(decay, eps), scale(-1))``: ``(update,
    new state)``; the update is ``-g * rsqrt(nu + eps)`` with ``nu``
    starting at 0 (``torch.optim.RMSprop`` divides by ``sqrt(nu) +
    eps``)."""
    nu = (1 - decay) * (g * g) + decay * state.nu
    return -(torch.rsqrt(nu + eps) * g), RmsState(nu)


def create_state(generator: torch.Generator, cfg: PipelineConfig,
                 n_points: int, texture_init: str = "rand",
                 net: Optional[UNet] = None, device="cuda"
                 ) -> Tuple[TrainState, UNet]:
    """A fresh state: the net's flax-distributed init and the descriptor
    table ('rand' by default, as ``read_tpu``) drawn from ``generator``
    (not ``jax.random``'s numbers), zero optimizer moments, step 0,
    ``lr_scale`` 1. Returns ``(state, net)``; the step functions run
    ``net`` on the state's variables."""
    _check_trainable(cfg)
    if net is None:
        net = UNet(num_input_channels=cfg.net_in_channels,
                   num_classes=cfg.num_classes)
    net.init_weights(generator)
    texture = T.init_point_texture(n_points, cfg.descriptor_size,
                                   texture_init, generator=generator)
    params = dict(net.named_parameters())
    layout = ParamLayout.of(params)
    flat = layout.flatten(params).detach().to(device)
    stats = {k: v.detach().to(device).clone()
             for k, v in net.named_buffers()}
    texture = texture.to(device)
    state = TrainState(
        step=0, flat_params=flat, layout=layout, batch_stats=stats,
        texture=texture,
        net_opt=AdamState(0, torch.zeros_like(flat), torch.zeros_like(flat)),
        tex_opt=RmsState(torch.zeros_like(texture)),
        lr_scale=torch.ones((), dtype=torch.float32, device=device))
    return state, net.to(device)


_MU, _NU = "net_opt/0/mu/", "net_opt/0/nu/"


def _subtree(flat: Dict[str, np.ndarray], prefix: str, device) -> Tensors:
    """The float32 leaves under ``prefix``, keyed by module name."""
    return {key[len(prefix):].replace("/", "."):
            torch.from_numpy(np.array(arr, np.float32)).to(device)
            for key, arr in flat.items() if key.startswith(prefix)}


def state_from_flat(flat: Dict[str, np.ndarray], device="cuda"
                    ) -> TrainState:
    """A whole ``read_tpu`` ``TrainState``, flattened as its checkpoint
    holds it (``read_tpu/utils/ckpt.py:42-47``: ``step``, ``lr_scale``,
    ``params/``, ``batch_stats/``, ``texture``, the net optimizer's
    ``net_opt/0/count``, ``net_opt/0/mu/<param path>`` and
    ``net_opt/0/nu/<param path>``, the texture optimizer's
    ``tex_opt/0/nu``) -> the port's :class:`TrainState` on
    ``device``."""
    params = _subtree(flat, "params/", device)
    mu, nu = _subtree(flat, _MU, device), _subtree(flat, _NU, device)
    if not params or set(mu) != set(params) or set(nu) != set(params):
        raise ValueError("checkpoint holds no whole train state (params "
                         "and the net optimizer's mu/nu)")

    def f32(key):
        return torch.from_numpy(np.array(flat[key], np.float32)).to(device)

    layout = ParamLayout.of(params)
    return TrainState(
        step=int(flat["step"]), flat_params=layout.flatten(params),
        layout=layout, batch_stats=_subtree(flat, "batch_stats/", device),
        texture=f32("texture"),
        net_opt=AdamState(int(flat["net_opt/0/count"]),
                          layout.flatten(mu), layout.flatten(nu)),
        tex_opt=RmsState(f32("tex_opt/0/nu")),
        lr_scale=f32("lr_scale"))


def flat_from_state(state: TrainState) -> Dict[str, np.ndarray]:
    """Inverse of :func:`state_from_flat`: the flat keys and dtypes a
    ``read_tpu`` checkpoint of its ``TrainState`` holds."""

    def tree(prefix, buf):
        return {prefix + name.replace(".", "/"): t.detach().cpu().numpy()
                for name, t in state.layout.views(buf).items()}

    flat = CV.flat_from_variables({**state.params, **state.batch_stats},
                                  state.texture)
    flat.update(tree(_MU, state.net_opt.mu))
    flat.update(tree(_NU, state.net_opt.nu))
    flat["net_opt/0/count"] = np.asarray(state.net_opt.count, np.int32)
    flat["tex_opt/0/nu"] = state.tex_opt.nu.detach().cpu().numpy()
    flat["step"] = np.asarray(state.step, np.int32)
    flat["lr_scale"] = state.lr_scale.detach().cpu().numpy().astype(
        np.float32)
    return flat


# --------------------------------------------------------------------------
# Forward, losses, steps
# --------------------------------------------------------------------------


def _forward(net: UNet, cfg: PipelineConfig, params: Tensors,
             batch_stats: Tensors, texture: torch.Tensor, xyz, total_m,
             train: bool, shape=None, point_sizes=None):
    """Pyramid + the net's differentiable route on ``params`` and
    ``batch_stats``: ``(out, new batch_stats, pyramid)``. With ``train``
    BatchNorm normalizes by the batch statistics and the returned
    statistics are moved copies; else the running ones are used and
    returned as they are."""
    pyr = build_pyramid(cfg, texture, xyz, total_m, shape=shape,
                        point_sizes=point_sizes)
    if cfg.temporal_average:
        # each item's input averages with the previous item's; the
        # first keeps itself (read_tpu's batched shift-average)
        pyr = [(x + torch.cat([x[:1], x[:-1]], 0)) * 0.5 for x in pyr]
    if train:
        batch_stats = {k: v.clone() for k, v in batch_stats.items()}
    out = torch.func.functional_call(net, {**params, **batch_stats},
                                     tuple(pyr),
                                     {"train": train, "remat": cfg.remat})
    return out, batch_stats, pyr


def _losses(cfg: PipelineConfig, vgg_params, out: Tensors, batch: dict,
            per_item: bool = False):
    """``(loss, metrics)`` as ``read_tpu``'s ``_losses``; ``per_item``
    gives ``[B]`` vectors."""
    im = out["im_out"]
    target = batch["target"]
    mask = batch.get("mask")
    metrics = {}
    im_l = im * mask if cfg.use_mask and mask is not None else im
    hub = L.huber_loss(im_l, target, per_item=per_item)
    loss = cfg.huber_ratio * hub
    metrics["huber_loss"] = hub
    if vgg_params is not None and cfg.vgg_ratio:
        if cfg.vgg_ensemble:
            _unported("the VGG ensemble (vgg_ens)", "'Not ported'")
        if cfg.vgg_backend == "mix":
            pp, pc = (vgg_params if isinstance(vgg_params, tuple)
                      else (vgg_params, vgg_params))
            vgg = V.vgg_loss_mix(pp, pc, im_l, target, per_item=per_item)
        else:
            vgg = V.vgg_loss(vgg_params, im_l, target,
                             backend=cfg.vgg_backend,
                             partialconv=cfg.vgg_partialconv,
                             per_item=per_item)
        loss = loss + cfg.vgg_ratio * vgg
        metrics["vgg_loss"] = vgg
    if cfg.num_classes is not None and "seg_out" in out \
            and batch.get("label") is not None:
        seg = L.cross_entropy_ignore0(out["seg_out"], batch["label"])
        if per_item:
            seg = seg.expand(loss.shape)
        loss = loss + cfg.seg_ratio * seg
        metrics["seg_loss"] = seg
    if cfg.masked_background and mask is not None:
        # the main loss renormalized by the mask mean + background pull
        if per_item:
            mmean = mask.reshape(mask.shape[0], -1).mean(dim=1)
            off = torch.abs(im * (1.0 - mask))
            bkg = 500.0 * off.reshape(off.shape[0], -1).mean(dim=1)
            loss = loss / torch.clamp(mmean, min=1e-6) + bkg
        else:
            loss = loss / torch.clamp(mask.mean(), min=1e-6)
            loss = loss + L.masked_background_loss(im, mask)
    metrics["psnr"] = L.psnr(im, target, per_item=per_item)
    return loss, metrics


def _loss_and_grads(net: UNet, cfg: PipelineConfig, vgg_params,
                    state: TrainState, xyz, batch: dict, freeze_net: bool):
    """One forward and backward from ``state``: ``(metrics, new
    batch_stats, im_out, flat net gradient or None, texture grad)``,
    gradients before the guard, ``metrics['loss']`` the scalar loss. The
    net runs on views of one leaf buffer, so autograd hands back the
    gradient in ``state.layout``'s order."""
    flat = state.flat_params.detach().requires_grad_(not freeze_net)
    params = state.layout.views(flat)
    texture = state.texture.detach().requires_grad_()
    out, new_bs, _ = _forward(net, cfg, params, state.batch_stats, texture,
                              xyz, batch["total_m"], train=not freeze_net,
                              point_sizes=batch.get("point_sizes"))
    loss, metrics = _losses(cfg, vgg_params, out, batch)
    if cfg.reg_weight:
        loss = loss + T.point_texture_reg_loss(texture, cfg.reg_weight)
    metrics["loss"] = loss
    wrt = [texture] if freeze_net else [flat, texture]
    grads = torch.autograd.grad(loss, wrt, allow_unused=True,
                                materialize_grads=True)
    g_net = None if freeze_net else grads[0]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return metrics, new_bs, out["im_out"].detach(), g_net, grads[-1]


def make_train_step(net: UNet, cfg: PipelineConfig, vgg_params,
                    freeze_net: bool = False, return_images: bool = False):
    """``train_step(state, xyz [N, 3], batch) -> (new_state, metrics)``
    (``+ im_out [B, h, w, 3]`` with ``return_images``).

    ``batch``: ``'total_m' [B, 4, 4]`` and ``'target' [B, h, w, 3]``
    (+ ``'mask' [B, h, w, 1]``, ``'label' [B, h, w]``, the scene's
    per-point sizes ``'point_sizes' [N]``). ``vgg_params``
    is a list of 13 ``(w, b)`` (a ``(pytorch, caffe)`` pair for the
    'mix' backend) or None. ``freeze_net`` fits the texture alone with
    the net in eval mode (running BatchNorm statistics, unchanged).
    The guard (NaN -> 0, +-inf and beyond -> +-``grad_clip``) runs
    before both optimizers; both step by ``lr * lr_scale``. The step,
    forward and backward, runs in full float32 (TF32 off,
    :func:`read_tpu_torch.utils.fp32.full_f32`) whatever the caller's
    flags, and restores them."""
    _check_trainable(cfg)

    def train_step(state: TrainState, xyz: torch.Tensor, batch: dict):
        with fp32.full_f32():
            return _train_step(state, xyz, batch)

    def _train_step(state: TrainState, xyz: torch.Tensor, batch: dict):
        metrics, new_bs, im, g_net, g_tex = _loss_and_grads(
            net, cfg, vgg_params, state, xyz, batch, freeze_net)
        with torch.no_grad():
            up_tex, tex_opt = rms_update(_guard_grad(g_tex, cfg.grad_clip),
                                         state.tex_opt)
            lr_tex = cfg.texture_lr * state.lr_scale
            changes = dict(step=state.step + 1,
                           texture=state.texture + lr_tex * up_tex,
                           tex_opt=tex_opt)
            if not freeze_net:
                up_net, net_opt = adam_update(
                    _guard_grad(g_net, cfg.grad_clip), state.net_opt)
                changes.update(
                    flat_params=state.flat_params
                    + (cfg.lr * state.lr_scale) * up_net,
                    batch_stats=new_bs, net_opt=net_opt)
        new_state = state.replace(**changes)
        if return_images:
            return new_state, metrics, im
        return new_state, metrics

    return train_step


def make_eval_step(net: UNet, cfg: PipelineConfig, vgg_params):
    """``eval_step(state, xyz, batch) -> (im_out, metrics)``: the eval-
    mode forward at the target's size and per-item ``[B]`` metrics
    (losses, PSNR, SSIM of the clipped image), in full float32 as the
    training step."""
    _check_trainable(cfg)

    @torch.no_grad()
    def eval_step(state: TrainState, xyz: torch.Tensor, batch: dict):
        with fp32.full_f32():
            shape = tuple(batch["target"].shape[1:3])
            out, _, _ = _forward(net, cfg, state.params, state.batch_stats,
                                 state.texture, xyz, batch["total_m"],
                                 train=False, shape=shape,
                                 point_sizes=batch.get("point_sizes"))
            loss, metrics = _losses(cfg, vgg_params, out, batch,
                                    per_item=True)
            metrics["loss"] = loss
            metrics["ssim"] = L.ssim(torch.clamp(out["im_out"], 0, 1),
                                     batch["target"], per_item=True)
            return out["im_out"], metrics

    return eval_step


class ReduceLROnPlateau:
    """Host-side plateau scheduler (torch semantics: factor 0.5, the
    given patience), driving ``TrainState.lr_scale``."""

    def __init__(self, factor: float = 0.5, patience: int = 3,
                 min_scale: float = 1e-4):
        self.factor = factor
        self.patience = patience
        self.min_scale = min_scale
        self.best = float("inf")
        self.bad_epochs = 0
        self.scale = 1.0

    def step(self, metric: float) -> float:
        if metric < self.best:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.bad_epochs = 0
        return self.scale
