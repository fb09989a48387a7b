"""The texture pipeline: config, pyramid, and the training step.

Counterpart of ``read_tpu/pipelines/texture_pipeline.py``:
``PipelineConfig`` (:47-120), ``parse_format_geometry`` (:123-152),
``config_from_dict`` (:155-215), ``TrainState``, ``_guard_grad`` and the
optimizers (:218-250), ``create_state`` (:253-299, point and mesh
textures), a whole ``TrainState`` to and from its checkpoint leaves
(``state_from_flat``/``flat_from_state``), ``_extra_maps`` (:302-343),
``_build_pyramid`` (:345-415: 1-px points, splats and per-point or
z-scaled sizes, the NDC jitter, mesh textures with or without triangle
faces, supersampling, the extra input modalities), ``_forward``
(:418-449), ``_losses`` (:452-518), ``make_train_step`` (:521-632, with
point dropout and jitter, :553-564), ``make_eval_step`` (:635-659) and
``ReduceLROnPlateau`` (:662-684).

A train step is eager PyTorch under autograd: z-buffer (K5 for the
default 'sort', K1 for 'pallas'/'scatter1', K6's splat projection for
either with ``point_radius > 0``; no gradient flows into the
projection) -> exact pyramid pool -> descriptor gather with the
per-image scatter-add backward (1-px points) or the summing one
(splats), or a mesh texture's bilinear sample at the uv map -> the
UNet's differentiable route
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
runs the differentiable route.

With ``supersampling`` ss > 1 the pyramid rasterizes and gathers at
``ss`` times the size and each level is resized down by ``ss``
(``F.interpolate`` bilinear with ``antialias=True``, which is what
``jax.image.resize(..., 'bilinear')`` does on a downscale). Extra input
modalities (``extra_modes``, from the input format) are render-mode maps
(:mod:`read_tpu_torch.ops.render_modes`) of each level's index and depth
maps, concatenated before the descriptors; the view-dependent modes
(``normals_l/r/d``) take the batch's camera-to-world ``view_matrix``,
and with ``label_in_input`` a rendered ``labels`` map becomes the
batch's ground-truth ``label`` image masked by rendered occupancy.

With ``drop_points`` or ``perturb_points`` (the train dataset's
augmentations) each step draws its dropout and jitter once
(:func:`augment`): from a generator on the points' device seeded by the
step, so a run repeats and the host never waits for the device; a
dropped point moves to ``1e9`` and the jitter reaches the z-buffer
kernels as ``ndc_jitter``. With ``use_mesh`` the texture is a tuple of
``[s, s, C]`` tables (``texture_size / 2^i``), sampled at each pixel's uv:
with the scene's triangle ``faces`` a triangle raster per level
(:mod:`read_tpu_torch.ops.rasterize_mesh`) and the perspective-correct
uv, else the uv of each level's winning point (``uv2d``).

With ``dtype='bfloat16'`` the net's differentiable route runs flax's
bfloat16 activations (``models.unet.UNet``, ``operands='bf16'``: conv
operands and activations bfloat16, BatchNorm float32); the parameters,
the texture, the pyramid, the losses (VGG included), the gradient guard
and both optimizers stay float32, as ``read_tpu`` keeps them with
``param_dtype=float32``.

With ``vgg_ensemble`` K (``--criterion vgg_ens``) ``vgg_params`` is a list
of K weight sets and the VGG term is their mean
(``criterions.vgg.vgg_loss_ens``), in the train and eval steps, the
sharded steps and pix2pix alike (:func:`vgg_term`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from read_tpu_torch.criterions import losses as L
from read_tpu_torch.criterions import vgg as V
from read_tpu_torch.models import texture as T
from read_tpu_torch.models.unet import UNet
from read_tpu_torch.ops import augment as A
from read_tpu_torch.ops import rasterize as R
from read_tpu_torch.ops import rasterize_mesh as RMesh
from read_tpu_torch.ops import render_modes as RM
from read_tpu_torch.utils import convert as CV
from read_tpu_torch.utils import fp32
from read_tpu_torch.utils.profiling import mark, span

__all__ = ["PipelineConfig", "parse_format_geometry", "config_from_dict",
           "build_pyramid", "ParamLayout", "TrainState", "AdamState",
           "RmsState", "adam_update", "rms_update", "create_state",
           "init_texture", "state_from_flat", "flat_from_state", "augment",
           "make_train_step", "make_eval_step", "ReduceLROnPlateau"]

Tensors = Dict[str, torch.Tensor]
Tables = CV.Tables          # a texture: its tables, one for a point texture

_DEFAULT_FORMAT = ("uv_1d_p1, uv_1d_p1_ds1, uv_1d_p1_ds2, uv_1d_p1_ds3, "
                   "uv_1d_p1_ds4")
_CONV_IMPLS = ("xla", "im2col", "pallas")
_DTYPES = ("float32", "bfloat16")
_CRITERIA = ("vgg", "vgg_pytorch", "vgg_mix", "vgg_partial", "vgg_ens",
             "huber_only")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static experiment hyperparameters: ``read_tpu``'s fields and
    defaults (less ``conv_impl``), with ``dtype`` named 'float32' or
    'bfloat16'."""
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
    texture_size: int = 512     # mesh textures: level i is size / 2^i
    temporal_average: bool = False
    drop_points: float = 0.0
    perturb_points: float = 0.0
    extra_modes: Tuple[Tuple[str, ...], ...] = ()
    label_in_input: bool = False
    # 'bfloat16' serves with bf16 conv operands, float32 accumulation and
    # float32 activations, and trains with flax's bf16 activations
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


def _check_geometry(cfg: PipelineConfig) -> None:
    """Raise for pyramid configurations that cannot be built."""
    if cfg.supersampling < 1:
        raise ValueError(f"supersampling {cfg.supersampling} < 1")


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
        label_in_input=bool(tda.get("label_in_input", False)),
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
        texture_size=int(d.get("texture_size", 512) or 512),
        temporal_average=bool(d.get("temporal_average", False)),
        num_classes=d.get("num_classes"),
        dtype=dtype,
        raster_method=raster_method,
        remat=bool(d.get("remat", False)),
    )
    _check_geometry(cfg)
    return cfg


def _extra_maps(cfg: PipelineConfig, modes, ix, dep, pointcloud,
                gt_label=None, view_m=None, tables=None):
    """The extra modality maps of one pyramid level (``ix``/``dep``
    ``[B, h, w]``), in ``modes`` order. ``normals_l/r/d`` colour each
    item's points from its camera-to-world ``view_m [B, 4, 4]``, one
    ``[B, N, 3]`` table a mode kept in ``tables`` for the other levels;
    with ``label_in_input`` a ``labels`` map is ``gt_label [B, H, W]``
    subsampled to the level (every ``H // h``-th pixel) and masked by
    rendered-label occupancy."""
    pc = pointcloud or {}
    tables = {} if tables is None else tables
    maps = []
    for mode in modes:
        if mode in RM.VIEW_DEPENDENT:
            if view_m is None:
                raise ValueError(
                    f"view-dependent extra mode {mode!r} needs per-item "
                    "view matrices: pass batch['view_matrix'] [B, 4, 4]")
            normals = pc.get("normals")
            if normals is None:
                maps.append(torch.zeros(ix.shape + (3,), device=ix.device))
                continue
            if mode not in tables:
                xyz = RM.to_f32(pc["xyz"], ix.device)
                normals = RM.to_f32(normals, ix.device)
                tables[mode] = torch.stack([
                    RM.view_dependent_colors(mode, xyz, normals, vm)
                    for vm in RM.to_f32(view_m, ix.device)])
            maps.append(RM.gather_attribute(tables[mode], ix))
            continue
        rendered = RM.render_mode(mode, ix, dep, pc)
        if mode == "labels" and cfg.label_in_input and gt_label is not None:
            f = gt_label.shape[1] // ix.shape[1]
            if f == 0:
                raise ValueError(
                    f"label_in_input: the label image ({gt_label.shape[1]} "
                    f"rows) is smaller than the raster ({ix.shape[1]} rows);"
                    " supersampling cannot carry it")
            occ = (rendered[..., 0] > 1e-9).to(torch.float32)
            lab = gt_label[:, ::f, ::f].to(torch.float32)
            rendered = (lab * occ)[..., None]
        maps.append(rendered)
    return maps


def _downscale(x: torch.Tensor, ss: int) -> torch.Tensor:
    """``x [B, h, w, C]`` resized to ``[B, h // ss, w // ss, C]``:
    bilinear with antialiasing (the triangle filter stretched by ``ss``), as
    ``jax.image.resize(..., 'bilinear')`` downscales; contiguous NHWC
    again for the UNet's kernels."""
    b, hh, ww, c = x.shape
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(hh // ss, ww // ss),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).contiguous()


def _mesh_pyramid(cfg: PipelineConfig, texture, xyz, total_m, h, w,
                  uv2d, faces):
    """The mesh branch with faces: a triangle raster at each level's
    size (no pooling: the uv is interpolated at the level's own pixels),
    the perspective-correct uv map, the tables' sample, zeros where no
    face covers a pixel. The rasters of every level run first
    (``read.mesh_raster``), then the samples (``read.mesh_sample``);
    each sampled level's gradient, when it arrives, marks
    ``read.mesh_grad``."""
    ss = cfg.supersampling
    maps = []
    with span("read.mesh_raster"):
        for i in range(cfg.num_scales):
            hi, wi = (h * ss) // (2 ** i), (w * ss) // (2 ** i)
            fi, _ = RMesh.rasterize_mesh_batch(xyz, faces, total_m, hi, wi)
            maps.append((fi, RMesh.interpolate_uv(xyz, faces, uv2d, total_m,
                                                  fi)))
    pyr = []
    with span("read.mesh_sample"):
        for fi, uv_map in maps:
            x = T.sample_mesh_texture(texture, uv_map,
                                      cfg.texture_activation)
            x = x * (fi >= 0).unsqueeze(-1).to(x.dtype)
            if x.requires_grad:
                x.register_hook(_mesh_grad_mark)
            pyr.append(_downscale(x, ss) if ss > 1 else x)
    return pyr


def _mesh_grad_mark(grad: torch.Tensor) -> None:
    """A sampled level's gradient hook: the instant ``read.mesh_grad``,
    on the autograd engine's thread, when the net's backward has handed
    that level its gradient and the tables' sample backward has not
    run."""
    mark("read.mesh_grad")


def build_pyramid(cfg: PipelineConfig, texture: Tables, xyz: torch.Tensor,
                  total_m: torch.Tensor, shape=None, point_sizes=None,
                  pointcloud=None, gt_label=None, view_m=None, uv2d=None,
                  faces=None, ndc_jitter=None):
    """Rasterize the pyramid (one z-buffer at ``cfg.supersampling`` times
    ``shape``, splatted where ``cfg.point_radius > 0``, exact 2x2 pair
    pools) and gather descriptors: ``cfg.num_scales`` maps ``[B, h_i,
    w_i, C]`` from ``texture``, the state's tables (the point table
    alone, or the mesh tables). ``point_sizes`` is the scene manifest's
    per-point size
    buffer; ``ndc_jitter [N, 2]`` each point's NDC offset (the
    augmentation). With ``cfg.extra_modes`` each level carries its
    modality maps before the descriptors (:func:`_extra_maps`:
    ``pointcloud`` the point attributes, ``gt_label`` the batch's label
    image, ``view_m`` its camera-to-world matrices); with supersampling
    each level is then resized down (:func:`_downscale`). The gather's
    backward is the per-image scatter-add for 1-px points and the
    summing one for splats, as ``read_tpu`` picks them.

    With ``cfg.use_mesh`` ``uv2d [N, 2]`` gives the points' (vertices')
    uv, at which the mesh tables are sampled: given ``faces [T, 3]``
    each level is a triangle raster (:func:`_mesh_pyramid`, which, as in
    ``read_tpu``, carries no extra modes and no jitter), else each
    level's winning point gives its uv."""
    _check_geometry(cfg)
    h, w = shape or cfg.crop_size
    ss = cfg.supersampling
    if cfg.use_mesh and uv2d is None:
        raise ValueError("the mesh-texture pyramid needs per-vertex uv2d")
    if cfg.use_mesh and faces is not None:
        return _mesh_pyramid(cfg, texture, xyz, total_m, h, w, uv2d, faces)
    with span("read.raster"):
        levels = R.rasterize_pyramid_pooled(
            xyz, total_m, (h * ss, w * ss), num_scales=cfg.num_scales,
            point_radius=cfg.point_radius, method=cfg.raster_method,
            ndc_jitter=ndc_jitter, point_sizes=point_sizes,
            relative_size=cfg.relative_point_size,
            min_point_size=cfg.min_point_size, pool_impl="exact")
    sample = (T.sample_point_texture_unique if cfg.point_radius == 0
              else T.sample_point_texture)
    pyr, tables = [], {}
    with span("read.gather"):
        for lvl, (ix, dep) in enumerate(levels):
            if cfg.use_mesh:
                uv_map = RM.gather_attribute(uv2d, ix)
                x = T.sample_mesh_texture(texture, uv_map,
                                          cfg.texture_activation)
                x = x * (ix >= 0).unsqueeze(-1).to(x.dtype)
            else:
                x = sample(texture[0], ix, cfg.texture_activation)
            if cfg.extra_modes:
                ex = _extra_maps(cfg, cfg.extra_modes[lvl], ix, dep,
                                 pointcloud, gt_label, view_m, tables)
                x = torch.cat(ex + [x], dim=-1)
            if ss > 1:
                x = _downscale(x, ss)
            pyr.append(x)
    return pyr


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
    """``optax.scale_by_rms``'s state: the second moment, one tensor a
    table."""
    nu: Tables


@dataclasses.dataclass
class TrainState:
    """The JAX ``TrainState``. The UNet's parameters lie in one flat
    buffer ``flat_params`` in ``layout``'s order (the Adam moments
    too); ``params`` gives them keyed by the port's module names
    (``feat0.conv_fm.kernel``). ``batch_stats`` are the BatchNorm
    running statistics keyed the same way (``feat0.norm.mean``).
    ``texture`` is a tuple of tables: the ``[N, C]`` point table alone
    or, with ``use_mesh``, the ``[s, s, C]`` mesh tables (``tex_opt.nu``
    alike).
    ``lr_scale`` is a 0-d float32 tensor."""
    step: int
    flat_params: torch.Tensor
    layout: ParamLayout
    batch_stats: Tensors
    texture: Tables
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


def rms_update(g: Tables, state: RmsState, decay: float = 0.99,
               eps: float = 1e-8):
    """``optax.chain(scale_by_rms(decay, eps), scale(-1))`` on each
    table's gradient in ``g``: ``(updates, new state)``; the update is
    ``-g * rsqrt(nu + eps)`` with ``nu`` starting at 0
    (``torch.optim.RMSprop`` divides by ``sqrt(nu) + eps``)."""
    nu = tuple((1 - decay) * (gi * gi) + decay * ni
               for gi, ni in zip(g, state.nu))
    return (tuple(-(torch.rsqrt(ni + eps) * gi) for gi, ni in zip(g, nu)),
            RmsState(nu))


def init_texture(cfg: PipelineConfig, n_points: int,
                 texture_init: str = "rand",
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> Tables:
    """A fresh texture's tables on ``device``: the ``[n_points, C]`` point
    table (``texture_init`` 'rand' or 'zeros'), or with ``cfg.use_mesh``
    the four mesh tables ``[texture_size / 2^i, ..., C]`` ('rand', else
    zeros), as ``read_tpu``'s ``create_state`` makes them."""
    if cfg.use_mesh:
        tables = T.init_mesh_texture(
            cfg.texture_size, cfg.descriptor_size,
            init_method="rand" if texture_init == "rand" else "zeros",
            generator=generator)
    else:
        tables = [T.init_point_texture(n_points, cfg.descriptor_size,
                                       texture_init, generator=generator)]
    return tuple(t.to(device) for t in tables)


def create_state(generator: torch.Generator, cfg: PipelineConfig,
                 n_points: int, texture_init: str = "rand",
                 net: Optional[UNet] = None, device="cuda"
                 ) -> Tuple[TrainState, UNet]:
    """A fresh state: the net's flax-distributed init and the descriptor
    table or mesh tables (:func:`init_texture`; 'rand' by default, as
    ``read_tpu``) drawn from ``generator`` (not ``jax.random``'s
    numbers), zero optimizer moments, step 0,
    ``lr_scale`` 1. Returns ``(state, net)``; the step functions run
    ``net`` on the state's variables."""
    _check_geometry(cfg)
    if net is None:
        net = UNet(num_input_channels=cfg.net_in_channels,
                   num_classes=cfg.num_classes)
    net.init_weights(generator)
    texture = init_texture(cfg, n_points, texture_init, generator, device)
    params = dict(net.named_parameters())
    layout = ParamLayout.of(params)
    flat = layout.flatten(params).detach().to(device)
    stats = {k: v.detach().to(device).clone()
             for k, v in net.named_buffers()}
    state = TrainState(
        step=0, flat_params=flat, layout=layout, batch_stats=stats,
        texture=texture,
        net_opt=AdamState(0, torch.zeros_like(flat), torch.zeros_like(flat)),
        tex_opt=RmsState(tuple(torch.zeros_like(t) for t in texture)),
        lr_scale=torch.ones((), dtype=torch.float32, device=device))
    return state, net.to(device)


_MU, _NU = "net_opt/0/mu/", "net_opt/0/nu/"


def _subtree(flat: Dict[str, np.ndarray], prefix: str, device) -> Tensors:
    """The float32 leaves under ``prefix``, keyed by module name."""
    return {key[len(prefix):].replace("/", "."):
            torch.from_numpy(np.array(arr, np.float32)).to(device)
            for key, arr in flat.items() if key.startswith(prefix)}


def _leaf(flat: Dict[str, np.ndarray], key: str, device) -> torch.Tensor:
    return torch.from_numpy(np.array(flat[key], np.float32)).to(device)


def state_from_flat(flat: Dict[str, np.ndarray], device="cuda"
                    ) -> TrainState:
    """A whole ``read_tpu`` ``TrainState``, flattened as its checkpoint
    holds it (``read_tpu/utils/ckpt.py:42-47``: ``step``, ``lr_scale``,
    ``params/``, ``batch_stats/``, ``texture`` (mesh tables:
    ``texture/<level>``), the net optimizer's ``net_opt/0/count``,
    ``net_opt/0/mu/<param path>`` and ``net_opt/0/nu/<param path>``, the
    texture optimizer's ``tex_opt/0/nu`` (``tex_opt/0/nu/<level>``)) ->
    the port's :class:`TrainState` on ``device``."""
    params = _subtree(flat, "params/", device)
    mu, nu = _subtree(flat, _MU, device), _subtree(flat, _NU, device)
    if not params or set(mu) != set(params) or set(nu) != set(params):
        raise ValueError("checkpoint holds no whole train state (params "
                         "and the net optimizer's mu/nu)")

    layout = ParamLayout.of(params)
    return TrainState(
        step=int(flat["step"]), flat_params=layout.flatten(params),
        layout=layout, batch_stats=_subtree(flat, "batch_stats/", device),
        texture=CV.texture_from_flat(flat, "texture", device),
        net_opt=AdamState(int(flat["net_opt/0/count"]),
                          layout.flatten(mu), layout.flatten(nu)),
        tex_opt=RmsState(CV.texture_from_flat(flat, "tex_opt/0/nu",
                                              device)),
        lr_scale=_leaf(flat, "lr_scale", device))


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
    flat.update(CV.flat_from_texture(state.tex_opt.nu, "tex_opt/0/nu"))
    flat["step"] = np.asarray(state.step, np.int32)
    flat["lr_scale"] = state.lr_scale.detach().cpu().numpy().astype(
        np.float32)
    return flat


# --------------------------------------------------------------------------
# Forward, losses, steps
# --------------------------------------------------------------------------


def _forward(net: UNet, cfg: PipelineConfig, params: Tensors,
             batch_stats: Tensors, texture, xyz, total_m, train: bool,
             shape=None, batch=None):
    """Pyramid + the net's differentiable route on ``params`` and
    ``batch_stats``: ``(out, new batch_stats, pyramid)``. ``batch`` may
    carry the pyramid's other inputs (``point_sizes``, ``pointcloud``,
    ``label``, ``view_matrix``, the mesh path's ``uv2d`` and ``faces``,
    the step's ``ndc_jitter``). With ``train`` BatchNorm normalizes by
    the batch statistics and the returned statistics are moved copies;
    else the running ones are used and returned as they are."""
    batch = batch or {}
    pyr = build_pyramid(cfg, texture, xyz, total_m, shape=shape,
                        point_sizes=batch.get("point_sizes"),
                        pointcloud=batch.get("pointcloud"),
                        gt_label=batch.get("label"),
                        view_m=batch.get("view_matrix"),
                        uv2d=batch.get("uv2d"), faces=batch.get("faces"),
                        ndc_jitter=batch.get("ndc_jitter"))
    if cfg.temporal_average:
        # each item's input averages with the previous item's; the
        # first keeps itself (read_tpu's batched shift-average)
        pyr = [(x + torch.cat([x[:1], x[:-1]], 0)) * 0.5 for x in pyr]
    if train:
        batch_stats = {k: v.clone() for k, v in batch_stats.items()}
    out = torch.func.functional_call(net, {**params, **batch_stats},
                                     tuple(pyr),
                                     {"train": train, "remat": cfg.remat,
                                      "operands": cfg.operands})
    return out, batch_stats, pyr


def vgg_term(cfg: PipelineConfig, vgg_params, im: torch.Tensor,
             target: torch.Tensor, per_item: bool = False) -> torch.Tensor:
    """The VGG loss of ``cfg``'s criterion (``read_tpu``'s ``_losses``
    :474-496, in its order): the 'mix' blend (``vgg_params`` one weight
    set for both branches, or a ``(pytorch, caffe)`` pair), the
    ensemble's mean (``vgg_ensemble``: ``vgg_params`` a list of weight
    sets), or one network."""
    if cfg.vgg_backend == "mix":
        pp, pc = (vgg_params if isinstance(vgg_params, tuple)
                  else (vgg_params, vgg_params))
        return V.vgg_loss_mix(pp, pc, im, target, per_item=per_item)
    if cfg.vgg_ensemble:
        return V.vgg_loss_ens(vgg_params, im, target,
                              backend=cfg.vgg_backend,
                              partialconv=cfg.vgg_partialconv,
                              per_item=per_item)
    return V.vgg_loss(vgg_params, im, target, backend=cfg.vgg_backend,
                      partialconv=cfg.vgg_partialconv, per_item=per_item)


def _losses(cfg: PipelineConfig, vgg_params, out: Tensors, batch: dict,
            per_item: bool = False):
    """``(loss, metrics)`` as ``read_tpu``'s ``_losses``; ``per_item``
    gives ``[B]`` vectors."""
    with span("read.loss"):
        im = out["im_out"]
        target = batch["target"]
        mask = batch.get("mask")
        metrics = {}
        im_l = im * mask if cfg.use_mask and mask is not None else im
        hub = L.huber_loss(im_l, target, per_item=per_item)
        loss = cfg.huber_ratio * hub
        metrics["huber_loss"] = hub
        if vgg_params is not None and cfg.vgg_ratio:
            vgg = vgg_term(cfg, vgg_params, im_l, target, per_item)
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


def _net_grad_mark(grad: torch.Tensor) -> None:
    """The image's gradient hook: the instant ``read.net_grad``, on the
    autograd engine's thread, when every loss-side backward node has run
    and the net's and the gather's have not."""
    mark("read.net_grad")


def _loss_and_grads(net: UNet, cfg: PipelineConfig, vgg_params,
                    state: TrainState, xyz, batch: dict, freeze_net: bool):
    """One forward and backward from ``state``: ``(metrics, new
    batch_stats, im_out, flat net gradient or None, texture grad)``,
    gradients before the guard (the texture's a tuple, one a table),
    ``metrics['loss']`` the scalar loss. The net runs on views of one
    leaf buffer, so autograd hands back the gradient in
    ``state.layout``'s order."""
    flat = state.flat_params.detach().requires_grad_(not freeze_net)
    params = state.layout.views(flat)
    tables = tuple(t.detach().requires_grad_() for t in state.texture)
    with span("read.forward"):
        out, new_bs, _ = _forward(net, cfg, params, state.batch_stats,
                                  tables, xyz, batch["total_m"],
                                  train=not freeze_net, batch=batch)
        loss, metrics = _losses(cfg, vgg_params, out, batch)
        if cfg.reg_weight:
            loss = loss + (
                T.mesh_texture_reg_loss(tables, cfg.reg_weight)
                if cfg.use_mesh
                else T.point_texture_reg_loss(tables[0], cfg.reg_weight))
    if out["im_out"].requires_grad:
        out["im_out"].register_hook(_net_grad_mark)
    metrics["loss"] = loss
    wrt = tables if freeze_net else (flat, *tables)
    with span("read.backward"):
        grads = torch.autograd.grad(loss, wrt, allow_unused=True,
                                    materialize_grads=True)
    g_net = None if freeze_net else grads[0]
    g_tex = tuple(grads[len(wrt) - len(tables):])
    metrics = {k: v.detach() for k, v in metrics.items()}
    return metrics, new_bs, out["im_out"].detach(), g_net, g_tex


# the augmentation's generators: seeded by (AUGMENT_SEED, step), as
# read_tpu folds the step into PRNGKey(0)
AUGMENT_SEED = 0


def _step_draws(step: int, n: int, device):
    """The step's default draws: ``([n, 1] dropout, [n, 2] jitter)``
    uniforms from a generator on ``device`` seeded by ``(AUGMENT_SEED,
    step)``; the same numbers on every run, and no host sync."""
    gen = torch.Generator(device=device)
    gen.manual_seed((AUGMENT_SEED << 32) | int(step))
    u_drop = torch.rand((n, 1), generator=gen, device=device)
    return u_drop, torch.rand((n, 2), generator=gen, device=device)


def augment(cfg: PipelineConfig, step: int, xyz: torch.Tensor, draws=None):
    """The step's point dropout and jitter: ``(xyz, ndc_jitter or
    None)``, ``xyz`` itself and None when ``cfg.drop_points`` and
    ``cfg.perturb_points`` are 0. ``draws(step, n, device) -> (u_drop
    [n, 1], u_jitter [n, 2])`` gives the uniforms (default
    :func:`_step_draws`); the jitter is worth up to ``perturb_points``
    pixels of the crop (``cfg.crop_size``), as in ``read_tpu``."""
    if not (cfg.drop_points > 0 or cfg.perturb_points > 0):
        return xyz, None
    u_drop, u_jit = (draws or _step_draws)(step, xyz.shape[0], xyz.device)
    jitter = None
    if cfg.drop_points > 0:
        xyz = A.drop_points_from(u_drop, xyz, cfg.drop_points)
    if cfg.perturb_points > 0:
        jitter = A.jitter_offsets_from(u_jit, cfg.perturb_points,
                                       *cfg.crop_size)
    return xyz, jitter


def make_train_step(net: UNet, cfg: PipelineConfig, vgg_params,
                    freeze_net: bool = False, return_images: bool = False,
                    draws=None):
    """``train_step(state, xyz [N, 3], batch) -> (new_state, metrics)``
    (``+ im_out [B, h, w, 3]`` with ``return_images``).

    ``batch``: ``'total_m' [B, 4, 4]`` and ``'target' [B, h, w, 3]``
    (+ ``'mask' [B, h, w, 1]``, ``'label' [B, h, w]``, the scene's
    per-point sizes ``'point_sizes' [N]``; with extra modes the point
    attributes they read, ``'pointcloud'`` (``rgb``, ``xyz``, ``xyz_c``,
    ``normals``, ``uv2d``, ``labels``), and for ``normals_l/r/d`` the
    camera-to-world ``'view_matrix' [B, 4, 4]``). ``vgg_params``
    is a list of 13 ``(w, b)`` (a ``(pytorch, caffe)`` pair for the
    'mix' backend) or None. ``freeze_net`` fits the texture alone with
    the net in eval mode (running BatchNorm statistics, unchanged).
    The guard (NaN -> 0, +-inf and beyond -> +-``grad_clip``) runs
    before both optimizers; both step by ``lr * lr_scale``. The step,
    forward and backward, runs in full float32 (TF32 off,
    :func:`read_tpu_torch.utils.fp32.full_f32`) whatever the caller's
    flags, and restores them.

    With ``cfg.drop_points`` or ``cfg.perturb_points`` each step first
    runs :func:`augment` on ``xyz`` with the state's step; ``draws`` (see
    there) replaces its generator, e.g. with given uniforms. A
    ``use_mesh`` batch carries ``'uv2d' [N, 2]`` and, for the triangle
    raster, ``'faces' [T, 3]``."""
    _check_geometry(cfg)

    def train_step(state: TrainState, xyz: torch.Tensor, batch: dict):
        with fp32.full_f32():
            return _train_step(state, xyz, batch)

    def _train_step(state: TrainState, xyz: torch.Tensor, batch: dict):
        xyz, jitter = augment(cfg, state.step, xyz, draws)
        if jitter is not None:
            batch = dict(batch, ndc_jitter=jitter)
        metrics, new_bs, im, g_net, g_tex = _loss_and_grads(
            net, cfg, vgg_params, state, xyz, batch, freeze_net)
        with torch.no_grad(), span("read.optimizer"):
            with span("read.rmsprop"):
                up_tex, tex_opt = rms_update(
                    tuple(_guard_grad(g, cfg.grad_clip) for g in g_tex),
                    state.tex_opt)
                lr_tex = cfg.texture_lr * state.lr_scale
                texture = tuple(t + lr_tex * u
                                for t, u in zip(state.texture, up_tex))
            changes = dict(step=state.step + 1, texture=texture,
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
    _check_geometry(cfg)

    @torch.no_grad()
    def eval_step(state: TrainState, xyz: torch.Tensor, batch: dict):
        with fp32.full_f32():
            shape = tuple(batch["target"].shape[1:3])
            out, _, _ = _forward(net, cfg, state.params, state.batch_stats,
                                 state.texture, xyz, batch["total_m"],
                                 train=False, shape=shape, batch=batch)
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
