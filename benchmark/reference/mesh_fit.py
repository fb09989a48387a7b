"""One fitting step of READ's texture pipeline on neural mesh textures,
plainly, and its first steps from a given start.

A step: each level's raster and uv maps of the batch's views (no
gradient, :func:`benchmark.reference.mesh.pyramid_maps`), the four
tables sampled there (:func:`benchmark.reference.mesh.sample`), the UNet
in training form, the loss ``1e4 * huber(im, target) + vgg(im, target)
+ reg`` with the tables' per-level regulariser, gradients of the net's
trainable parameters and of the tables, the guard, Adam on the net and
RMSprop on each table, as :func:`benchmark.reference.fit.run_steps`
(whose VGG loss, Huber loss, guard and bias correction it uses). With
``stages`` the first step also reports its stages to a
:class:`benchmark.reference.mesh_stages.Stages`, which holds each in
float32 on this run's own inputs.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence

import torch

from benchmark.reference import mesh, mesh_stages, unet
from benchmark.reference.fit import (_STATS, HUBER_RATIO, _bias_correction,
                                     _guard, huber, vgg_loss)
from benchmark.reference.prec import full_f32

__all__ = ["run_steps"]


@contextlib.contextmanager
def _watching(stages: "mesh_stages.Stages"):
    """Inside the block every reference layer reports its input, output
    and output gradient to ``stages``."""
    conv = unet._Net.conv

    def watched(self, name, x, stride=1, relu=True, res=None):
        y = conv(self, name, x, stride, relu, res)
        stages.layer(name, x, res, stride, relu, y)
        if y.requires_grad:
            y.register_hook(lambda g: stages.layer_grad(name, g))
        return y

    unet._Net.conv = watched
    try:
        yield
    finally:
        unet._Net.conv = conv


def run_steps(params: Dict[str, torch.Tensor],
              tables: Sequence[torch.Tensor], verts: torch.Tensor,
              faces: torch.Tensor, uv: torch.Tensor, batches: Sequence[dict],
              vgg, *, lr: float, texture_lr: float, levels: int,
              reg_weight: float, samples: int = 8, grad_clip: float = 1e3,
              prec: str = "f32", stages: bool = False) -> dict:
    """The steps of ``batches`` (each ``total_m [B, 4, 4]``, ``target
    [B, h, w, 3]``) from ``params`` and the mesh ``tables``, over the
    mesh ``verts [V, 3]``, ``faces [T, 3]`` and vertex ``uv [V, 2]``.
    Returns each step's loss, each leaf's guarded first gradient (its
    norm) and its change over all the steps (its norm); the leaves are
    the trainable parameters by name and ``'texture'``, the four tables
    as one; with ``stages``, also the first step's
    :data:`benchmark.reference.mesh_stages.NUMBERS` under ``'stages'``.
    Nothing given is changed."""
    names = [k for k in params if not k.endswith(_STATS)]
    p = {k: v.detach().clone() for k, v in params.items()}
    tex = [t.detach().clone() for t in tables]
    mu = {k: torch.zeros_like(p[k]) for k in names}
    nu = {k: torch.zeros_like(p[k]) for k in names}
    tex_nu = [torch.zeros_like(t) for t in tex]
    losses, first, staged = [], None, None
    with full_f32():
        for step, batch in enumerate(batches, start=1):
            total_m, target = batch["total_m"], batch["target"]
            h, w = target.shape[1:3]
            with torch.no_grad():
                maps = mesh.pyramid_maps(verts, faces, uv, total_m, h, w,
                                         levels, samples)
            leaves = {k: p[k].requires_grad_() for k in names}
            ts = [t.requires_grad_() for t in tex]
            st = mesh_stages.Stages(p, tex, maps, target, vgg,
                                    reg_weight=reg_weight,
                                    grad_clip=grad_clip) \
                if stages and step == 1 else None
            with _watching(st) if st else contextlib.nullcontext():
                pyr = [mesh.sample(ts, uv_i, face) for face, uv_i in maps]
                if st:
                    st.pyramid(pyr)
                    for i, x in enumerate(pyr):
                        x.register_hook(lambda g, i=i: st.pyramid_grad(i, g))
                im = unet.forward({**p, **leaves}, pyr, train=True,
                                  prec=prec)
                if st:
                    st.image(im)
                    im.register_hook(st.image_grad)
                loss = HUBER_RATIO * huber(im, target) \
                    + vgg_loss(vgg, im, target, prec) \
                    + mesh.reg_loss(ts, reg_weight)
                grads = torch.autograd.grad(loss, [leaves[k] for k in names]
                                            + ts)
            losses.append(float(loss.detach()))
            with torch.no_grad():
                g = {k: _guard(gi, grad_clip) for k, gi in zip(names, grads)}
                g_tex = [_guard(gi, grad_clip) for gi in grads[len(names):]]
                if first is None:
                    first = {k: float(torch.linalg.vector_norm(v))
                             for k, v in g.items()}
                    first["texture"] = float(torch.linalg.vector_norm(
                        torch.cat([gi.reshape(-1) for gi in g_tex])))
                if st:
                    staged = st.finish(losses[0], g,
                                       [gi.abs() for gi in g_tex])
                c1 = _bias_correction(0.9, step)
                c2 = _bias_correction(0.999, step)
                for k in names:
                    mu[k] = (1 - 0.9) * g[k] + 0.9 * mu[k]
                    nu[k] = (1 - 0.999) * (g[k] * g[k]) + 0.999 * nu[k]
                    up = -((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + 1e-8))
                    p[k] = p[k].detach() + lr * up
                for i, gi in enumerate(g_tex):
                    tex_nu[i] = (1 - 0.99) * (gi * gi) + 0.99 * tex_nu[i]
                    tex[i] = tex[i].detach() + texture_lr * -(
                        torch.rsqrt(tex_nu[i] + 1e-8) * gi)
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(p[k] - params[k]))
                  for k in names}
        change["texture"] = float(torch.linalg.vector_norm(torch.cat(
            [(t - t0).reshape(-1) for t, t0 in zip(tex, tables)])))
    out = {"losses": losses, "first_grad": first, "change": change}
    if staged is not None:
        out["stages"] = staged
    return out
