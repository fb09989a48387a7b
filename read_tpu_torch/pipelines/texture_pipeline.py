"""The checkpoint config and the pyramid build of the texture pipeline.

Counterpart of ``read_tpu/pipelines/texture_pipeline.py`` for serving:
``PipelineConfig`` (:47-120, the fields the renderer reads),
``parse_format_geometry`` (:123-152), ``config_from_dict`` (:155-215)
and ``_build_pyramid`` (:345-415, the point-texture, radius-0 branch).

``conv_impl`` names ``xla``/``im2col``/``pallas`` are accepted and
ignored: they hold the same parameters and the port has one UNet.
Configurations that need code the port does not have yet (mesh
textures, splats, z-scaled sizes, extra input modes, supersampling)
raise ``NotImplementedError`` when the config is built.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from read_tpu_torch.models import texture as T
from read_tpu_torch.ops import rasterize as R

__all__ = ["PipelineConfig", "parse_format_geometry", "config_from_dict",
           "build_pyramid"]

_DEFAULT_FORMAT = ("uv_1d_p1, uv_1d_p1_ds1, uv_1d_p1_ds2, uv_1d_p1_ds3, "
                   "uv_1d_p1_ds4")
_CONV_IMPLS = ("xla", "im2col", "pallas")
_NUM_SCALES = 4  # the UNet consumes 4 pyramid levels
_DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """The inference settings the port reads from a checkpoint's config."""
    crop_size: Tuple[int, int] = (256, 256)      # (h, w)
    texture_activation: str = "none"
    # 'float32' or 'bfloat16'; the port runs 'bfloat16' as bf16 conv
    # operands with float32 accumulation and float32 activations
    dtype: str = "float32"
    raster_method: str = "sort"

    @property
    def operands(self) -> str:
        return "bf16" if self.dtype == "bfloat16" else "f32"


def parse_format_geometry(input_format: str):
    """``(point_radius, relative_point_size, extra_modes)`` from the
    input-format DSL string (same derivation as ``read_tpu``)."""
    from read_tpu.scene.formats import parse_input_format
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
                              f"(ROADMAP queue 1, {item})")


def config_from_dict(d: dict, crop_size: Tuple[int, int]
                     ) -> PipelineConfig:
    """A :class:`PipelineConfig` from a checkpoint's embedded ``config``
    dict, rendering at ``crop_size`` ``(h, w)``."""
    raster_method = d.get("raster_method", "sort") or "sort"
    if raster_method not in R.RASTER_METHODS:
        raise ValueError(f"unknown raster method {raster_method!r}")
    conv_impl = d.get("conv_impl", "xla") or "xla"
    if conv_impl not in _CONV_IMPLS:
        raise ValueError(f"unknown conv_impl {conv_impl!r}")
    dtype = d.get("dtype") or "float32"
    if dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}")
    point_radius, relative_ps, extra_modes = parse_format_geometry(
        d.get("input_format", _DEFAULT_FORMAT))
    if d.get("use_mesh"):
        _unported("the mesh-texture path (use_mesh)", "item 9")
    if point_radius > 0 or relative_ps:
        _unported("splat point sizes (input_format p>1 / ps)", "item 9")
    if extra_modes:
        _unported("extra input modes", "item 9")
    if int(d.get("supersampling", 1) or 1) > 1:
        _unported("supersampling", "item 6")
    return PipelineConfig(
        crop_size=tuple(int(x) for x in crop_size),
        texture_activation=d.get("texture_activation", "none"),
        dtype=dtype,
        raster_method=raster_method,
    )


def build_pyramid(cfg: PipelineConfig, texture: torch.Tensor,
                  xyz: torch.Tensor, total_m: torch.Tensor, shape=None):
    """Rasterize the 4-level pyramid and gather descriptors:
    a list of ``[B, h_i, w_i, C]`` maps. The levels come from the exact
    (depth, id) pair pool, as in ``read_tpu``'s ``_build_pyramid``."""
    h, w = shape or cfg.crop_size
    levels = R.rasterize_pyramid_pooled(
        xyz, total_m, (h, w), num_scales=_NUM_SCALES,
        method=cfg.raster_method, pool_impl="exact")
    return [T.sample_point_texture(texture, ix, cfg.texture_activation)
            for ix, _ in levels]
