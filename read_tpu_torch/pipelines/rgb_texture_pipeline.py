"""RGBTexturePipeline: classic RGB texture fitting (no network).

Counterpart of ``read_tpu/pipelines/rgb_texture_pipeline.py``:
``rgb_texture_forward`` (:34-39), ``create_rgb_texture_state`` (:42-49)
and ``make_rgb_texture_step`` (:52-99). A four-level 3-channel mesh
texture (``models.texture.sample_mesh_texture``, sigmoid) is sampled at
a rendered uv map and fitted to the target photos with RMSprop
(``optax.rmsprop(lr, decay=0.99, eps=1e-8)``:
:func:`~read_tpu_torch.pipelines.texture_pipeline.rms_update`, then
``-lr``) whose updates the plateau decay ``lr_scale`` scales. The uv map
comes from the point raster (``rasterize_batch``, 'sort': K5 and a
one-level pass on the card) and each winning point's ``uv2d``, or, given
the scene's triangle ``faces``, from the triangle raster and the
perspective-correct interpolation (``ops.rasterize_mesh``). The state
is :class:`RgbTextureState`; its checkpoint leaves are ``read_tpu``'s
(``step``, ``tables/<level>``, ``opt/0/nu/<level>``, ``lr_scale``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from read_tpu_torch.criterions import losses as L
from read_tpu_torch.models import texture as T
from read_tpu_torch.ops import rasterize as R
from read_tpu_torch.ops import rasterize_mesh as RMesh
from read_tpu_torch.ops import render_modes as RM
from read_tpu_torch.pipelines import texture_pipeline as TP
from read_tpu_torch.utils import convert as CV
from read_tpu_torch.utils import fp32

__all__ = ["RgbTextureState", "rgb_texture_forward",
           "create_rgb_texture_state", "rgb_state_from_flat",
           "flat_from_rgb_state", "uv_and_mask", "make_rgb_texture_step"]


@dataclasses.dataclass
class RgbTextureState:
    """``read_tpu``'s rgb_texture state dict: the tables (a tuple of
    ``[s, s, 3]``), RMSprop's second moments (alike) and the plateau
    factor (a 0-d float32 tensor)."""
    step: int
    tables: tuple
    opt: TP.RmsState
    lr_scale: torch.Tensor

    def replace(self, **changes) -> "RgbTextureState":
        return dataclasses.replace(self, **changes)


def rgb_texture_forward(tables, uv_map: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """The RGB mesh texture (sigmoid) at ``uv_map [..., 2]``, times
    ``mask [..., 1]``."""
    return T.sample_mesh_texture(tables, uv_map, activation="sigmoid") * mask


def create_rgb_texture_state(texture_size: int, levels: int = 4,
                             device="cuda") -> RgbTextureState:
    """Tables filled with 0.5 (``read_tpu``'s init, no randomness), zero
    RMS moments, step 0, ``lr_scale`` 1."""
    tables = tuple(t.to(device) for t in T.init_mesh_texture(
        texture_size, n_channels=3, levels=levels, init_method="0.5"))
    return RgbTextureState(
        step=0, tables=tables,
        opt=TP.RmsState(tuple(torch.zeros_like(t) for t in tables)),
        lr_scale=torch.ones((), dtype=torch.float32, device=device))


def rgb_state_from_flat(flat: Dict[str, np.ndarray],
                        device="cuda") -> RgbTextureState:
    """A ``read_tpu`` rgb_texture checkpoint's leaves -> the state."""
    tables = CV.texture_from_flat(flat, "tables", device)
    nu = CV.texture_from_flat(flat, "opt/0/nu", device)
    if tables[0].dim() != 3 or len(nu) != len(tables):
        raise ValueError("checkpoint holds no rgb_texture state (tables/ "
                         "and RMSprop's opt/0/nu/)")
    return RgbTextureState(step=int(flat["step"]), tables=tables,
                           opt=TP.RmsState(nu),
                           lr_scale=TP._leaf(flat, "lr_scale", device))


def flat_from_rgb_state(state: RgbTextureState) -> Dict[str, np.ndarray]:
    """Inverse of :func:`rgb_state_from_flat`."""
    flat = CV.flat_from_texture(state.tables, "tables")
    flat.update(CV.flat_from_texture(state.opt.nu, "opt/0/nu"))
    flat["step"] = np.asarray(state.step, np.int32)
    flat["lr_scale"] = state.lr_scale.detach().cpu().numpy().astype(
        np.float32)
    return flat


def uv_and_mask(xyz: torch.Tensor, total_m: torch.Tensor, uv2d, h: int,
                w: int, faces: Optional[torch.Tensor] = None,
                samples: int = 8):
    """``(uv_map [B, h, w, 2], mask [B, h, w, 1])`` of the views
    ``total_m [B, 4, 4]``: with ``faces`` the triangle raster's
    perspective-correct uv, else the point raster's winning ``uv2d``;
    the mask is 1 where something was drawn."""
    if faces is None:
        idx, _ = R.rasterize_batch(xyz, total_m, h, w)
        uv_map = RM.gather_attribute(uv2d, idx)
    else:
        idx, _ = RMesh.rasterize_mesh_batch(xyz, faces, total_m, h, w,
                                            samples)
        uv_map = RMesh.interpolate_uv(xyz, faces, uv2d, total_m, idx)
    return uv_map, (idx >= 0).unsqueeze(-1).to(torch.float32)


def make_rgb_texture_step(lr: float, pointcloud: Dict, h: int, w: int,
                          reg_weight: float = 0.0, grad_clip: float = 1e3,
                          faces=None, mesh_samples: int = 8):
    """``step(state, xyz, batch) -> (new_state, {'loss', 'psnr'})`` at
    ``h x w``: huber loss of the masked prediction against the masked
    target (+ the mesh tables' L2 with ``reg_weight``), the guard,
    RMSprop at ``lr * lr_scale``. ``pointcloud['uv2d'] [N, 2]`` gives
    the uv; ``faces [T, 3]`` switches to the triangle raster."""
    scene = {"uv2d": pointcloud["uv2d"], "faces": faces}

    def step(state: RgbTextureState, xyz: torch.Tensor, batch: dict):
        with fp32.full_f32():
            return _step(state, xyz, batch)

    def _step(state: RgbTextureState, xyz: torch.Tensor, batch: dict):
        if "on" not in scene:     # the scene's inputs, on the device once
            scene["on"] = xyz.device
            scene["uv2d"] = RM.to_f32(scene["uv2d"], xyz.device)
            f = scene["faces"]
            if f is not None:
                if not isinstance(f, torch.Tensor):
                    f = torch.from_numpy(np.asarray(f, np.int64))
                scene["faces"] = f.to(xyz.device).reshape(-1, 3).to(
                    torch.int32)
        uv_map, mask = uv_and_mask(xyz, batch["total_m"], scene["uv2d"], h,
                                   w, scene["faces"], mesh_samples)
        tables = [t.detach().requires_grad_() for t in state.tables]
        pred = rgb_texture_forward(tables, uv_map, mask)
        loss = L.huber_loss(pred, batch["target"] * mask)
        if reg_weight:
            loss = loss + T.mesh_texture_reg_loss(tables, reg_weight)
        grads = torch.autograd.grad(loss, tables)
        with torch.no_grad():
            up, opt = TP.rms_update(
                tuple(TP._guard_grad(g, grad_clip) for g in grads),
                state.opt)
            new = state.replace(
                step=state.step + 1,
                tables=tuple(t + (u * lr) * state.lr_scale
                             for t, u in zip(state.tables, up)),
                opt=opt)
            metrics = {"loss": loss.detach(),
                       "psnr": L.psnr(pred, batch["target"])}
        return new, metrics

    return step
