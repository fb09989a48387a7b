"""Non-neural render modes: attribute maps from index and depth buffers.

Counterpart of ``read_tpu/ops/render_modes.py``: ``gather_attribute``,
``render_mode`` (every mode of ``scene/formats.MODES`` plus ``lit`` and
``texture2d``), ``blinn_phong_colors``, ``sample_texture2d_colors``,
``view_dependent_colors`` and ``DEFAULT_LIGHT_POSITION``, on torch
tensors. Once the z-buffer's index map exists, each mode is a gather of
a per-point attribute through it (``-1`` -> the fill value):

- ``colors``, ``xyz`` (bbox-normalized positions ``xyz_c``), ``uv_2d``,
  ``labels``, ``normals_m`` (``n * 0.5 + 0.5``): gathers, bit-equal to
  ``read_tpu`` on the same index map;
- ``uv_1d``: the index map itself; ``depth``: the depth buffer;
- ``normals_l`` (view-space normals), ``normals_r`` (the view direction
  reflected about the normal), ``normals_d`` (the camera->point
  direction): per-point colours from the camera-to-world matrix;
- ``lit``: Blinn-Phong in view space with the reference shader's
  constants (ambient 0.1, diffuse 0.75, specular 1.0, shininess 128,
  gamma 2.2), composited as ``0.35 * light + 0.65 * 0.5``;
- ``texture2d``: a bilinear, clamp-to-edge sample of the scene's texture
  image at per-point ``(u, 1 - v)``.

The view-dependent and lit modes invert the view matrix in float32
(``torch.linalg.inv_ex``, JAX ``jnp.linalg.inv``), so they agree with
``read_tpu`` to the last bits only. Inputs may be numpy arrays or
tensors; attributes go to the index map's device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["DEFAULT_LIGHT_POSITION", "gather_attribute", "render_mode",
           "blinn_phong_colors", "sample_texture2d_colors",
           "view_dependent_colors", "VIEW_DEPENDENT", "point_attributes",
           "to_f32"]

# the reference's default light and material constants
DEFAULT_LIGHT_POSITION = (4.07625, 1.00545, 5.90386)
_AMBIENT = 0.1
_DIFFUSE = 0.75
_SPECULAR = 1.0
_SHININESS = 128.0
_GAMMA = 2.2
VIEW_DEPENDENT = ("normals_l", "normals_r", "normals_d")
# the scene point attributes each extra input modality reads
_ATTRS = {"colors": ("rgb",), "xyz": ("xyz_c",), "uv_2d": ("uv2d",),
          "labels": ("labels",), "normals_m": ("normals",),
          **{m: ("xyz", "normals") for m in VIEW_DEPENDENT}}


def point_attributes(modes) -> list:
    """The point-cloud keys that the extra input ``modes`` read, sorted
    (``depth`` and ``uv_1d`` read none)."""
    return sorted({a for m in modes for a in _ATTRS.get(m, ())})


def to_f32(a, device) -> torch.Tensor:
    """``a`` (numpy or tensor) as a float32 tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(a, np.float32)).to(device)


def _inv(m: torch.Tensor) -> torch.Tensor:
    """``m``'s inverse without ``torch.linalg.inv``'s singularity check,
    which waits for the card on every call (``jnp.linalg.inv`` checks
    nothing either)."""
    return torch.linalg.inv_ex(m)[0]


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-9)


def blinn_phong_colors(xyz: torch.Tensor, normals: torch.Tensor,
                       view_matrix, light_position=DEFAULT_LIGHT_POSITION
                       ) -> torch.Tensor:
    """Per-point Blinn-Phong shading ``[N, 3]`` in view space.
    ``view_matrix`` is camera-to-world (the modelview is its inverse);
    ``light_position`` is a view-space position."""
    vm = _inv(to_f32(view_matrix, xyz.device))
    rot = vm[:3, :3]
    pv = xyz @ rot.T + vm[:3, 3]
    nv = _unit(normals @ rot.T)
    ldir = _unit(to_f32(light_position, xyz.device) - pv)
    lamb = torch.clamp((ldir * nv).sum(-1, keepdim=True), min=0.0)
    half = _unit(ldir + _unit(-pv))
    spec_angle = torch.clamp((half * nv).sum(-1, keepdim=True), min=0.0)
    spec = torch.where(lamb > 0.0, spec_angle ** _SHININESS, 0.0)
    linear = _AMBIENT + lamb * _DIFFUSE + spec * _SPECULAR
    light_rgb = (linear ** (1.0 / _GAMMA)).expand(xyz.shape[0], 3)
    # the live shader: out = mix(vec4(light, 1), vec4(0.5), 0.65)
    return light_rgb * 0.35 + 0.5 * 0.65


def sample_texture2d_colors(texture_image, uv2d: torch.Tensor
                            ) -> torch.Tensor:
    """Bilinear sample of a ``[Ht, Wt, 3]`` texture at per-point uvs in
    [0, 1] with the GL v-flip, clamp-to-edge addressing."""
    tex = to_f32(texture_image, uv2d.device)
    ht, wt = tex.shape[0], tex.shape[1]
    u = torch.clamp(uv2d[..., 0], 0.0, 1.0)
    v = 1.0 - torch.clamp(uv2d[..., 1], 0.0, 1.0)
    x = u * wt - 0.5
    y = v * ht - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]

    def at(yy, xx):
        yy = torch.clamp(yy.to(torch.int32), 0, ht - 1).long()
        xx = torch.clamp(xx.to(torch.int32), 0, wt - 1).long()
        return tex[yy, xx]

    top = at(y0, x0) * (1 - fx) + at(y0, x0 + 1) * fx
    bot = at(y0 + 1, x0) * (1 - fx) + at(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy


def gather_attribute(attr: torch.Tensor, index_map: torch.Tensor,
                     fill: float = 0.0) -> torch.Tensor:
    """``attr [N, C]`` through ``index_map [...]`` -> ``[..., C]``; -1
    gives ``fill``. A per-item table ``attr [B, N, C]`` gathers through
    ``index_map [B, ...]`` item by item."""
    n = attr.shape[-2]
    idx = torch.clamp(index_map, 0, n - 1).long()
    if attr.dim() == 3:
        b = torch.arange(attr.shape[0], device=attr.device).view(
            -1, *([1] * (idx.dim() - 1)))
        out = attr[b, idx]
    else:
        out = attr[idx]
    return torch.where((index_map >= 0)[..., None], out,
                       torch.full_like(out, fill))


def view_dependent_colors(mode: str, xyz: torch.Tensor,
                          normals: torch.Tensor, view_matrix
                          ) -> torch.Tensor:
    """Per-point colours ``[N, 3]`` of ``normals_l/r/d`` for one
    camera-to-world ``view_matrix [4, 4]``."""
    vm = to_f32(view_matrix, xyz.device)
    sub = mode.split("_")[1]
    if sub == "l":  # view-space normals
        rot = _inv(vm)[:3, :3]
        return normals @ rot.T * 0.5 + 0.5
    view_dir = _unit(xyz - vm[:3, 3])
    if sub == "d":  # camera -> point direction
        return view_dir * 0.5 + 0.5
    if sub == "r":  # the view direction reflected about the normal
        dotp = (view_dir * normals).sum(-1, keepdim=True)
        return (view_dir - 2.0 * dotp * normals) * 0.5 + 0.5
    raise ValueError(f"unknown view-dependent mode {mode!r}")


def render_mode(mode: str, index_map: torch.Tensor, depth_map: torch.Tensor,
                pointcloud: Dict, view_matrix=None) -> torch.Tensor:
    """One modality map ``[..., C]`` of a rasterized view.

    ``index_map``/``depth_map`` ``[..., H, W]`` come from the z-buffer;
    ``pointcloud`` is a scene dict (``xyz``, ``rgb``, ``xyz_c``,
    ``normals``, ``uv2d``, ``labels``, ``texture_image``,
    ``light_position``); ``view_matrix [4, 4]`` camera-to-world is needed
    by ``normals_l/r/d`` and ``lit``."""
    dev = index_map.device
    if mode == "uv_1d":
        return index_map[..., None].to(torch.float32)
    if mode == "depth":
        return depth_map[..., None]
    if mode in ("colors", "xyz", "uv_2d"):
        (key,) = _ATTRS[mode]
        return gather_attribute(to_f32(pointcloud[key], dev), index_map)
    normals = pointcloud.get("normals")
    if mode == "labels":
        lab = pointcloud.get("labels")
        if lab is None:
            return torch.zeros(index_map.shape + (1,), device=dev)
        return gather_attribute(to_f32(lab, dev).reshape(-1, 1), index_map)
    if mode == "lit":
        if normals is None:
            return torch.zeros(index_map.shape + (3,), device=dev)
        if view_matrix is None:
            raise ValueError("lit mode needs a view matrix")
        cols = blinn_phong_colors(
            to_f32(pointcloud["xyz"], dev), to_f32(normals, dev), view_matrix,
            pointcloud.get("light_position", DEFAULT_LIGHT_POSITION))
        return gather_attribute(cols, index_map)
    if mode == "texture2d":
        tex = pointcloud.get("texture_image")
        if tex is None:
            raise ValueError("texture2d mode needs a scene texture image "
                             "('texture' key in the manifest)")
        cols = sample_texture2d_colors(tex, to_f32(pointcloud["uv2d"], dev))
        return gather_attribute(cols, index_map)
    if mode.startswith("normals"):
        if normals is None:
            return torch.zeros(index_map.shape + (3,), device=dev)
        normals = to_f32(normals, dev)
        if mode == "normals_m":  # model space as colours
            return gather_attribute(normals * 0.5 + 0.5, index_map)
        if view_matrix is None:
            raise ValueError(f"{mode} needs a view matrix")
        cols = view_dependent_colors(mode, to_f32(pointcloud["xyz"], dev),
                                     normals, view_matrix)
        return gather_attribute(cols, index_map)
    raise ValueError(f"unknown render mode {mode!r}")
