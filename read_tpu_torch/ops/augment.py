"""Point-cloud training augmentations: point dropout and screen-space jitter.

Counterpart of ``read_tpu/ops/augment.py``: ``drop_points`` (:26-35),
``pixel_jitter_offsets`` (:38-45) and ``perturb_pixels`` (:48-54). Each
is split into a deterministic core that takes the uniform draws
(``*_from``) and a thin wrapper that draws them from an explicit
``torch.Generator`` on the tensors' device.

The cores give JAX's bits for the same uniforms: ``jax.random.bernoulli(
key, 1 - rate)`` is ``uniform(key) < float32(1 - rate)``, so a point is
kept where its draw is below ``1 - rate``; the jitter is ``(u - 0.5) *
[2 * amount / w, 2 * amount / h]`` in float32. The wrappers' random
stream is PyTorch's, not ``jax.random``'s: the same seed gives other
numbers than ``read_tpu``, as ``models.texture.init_point_texture``'s
do. A dropped point moves to ``1e9``, where the rasterizer's clip test
rejects it; the jitter goes to the rasterizer as ``ndc_jitter [N, 2]``,
which adds it after the clip test and before the floor.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["drop_points", "drop_points_from", "pixel_jitter_offsets",
           "jitter_offsets_from", "perturb_pixels", "perturb_pixels_from"]

# far enough that the w > 0 / NDC-cube test always rejects
_FAR_AWAY = 1e9


def drop_points_from(uniform: torch.Tensor, xyz: torch.Tensor,
                     rate: float) -> torch.Tensor:
    """``xyz [N, 3]`` with each point whose draw ``uniform [N, 1]`` is not
    below ``1 - rate`` moved to ``1e9`` (the GL discard buffer's effect);
    ``xyz`` itself where ``rate <= 0``."""
    if rate <= 0:
        return xyz
    keep = uniform < float(np.float32(1.0 - rate))
    return torch.where(keep, xyz, _FAR_AWAY)


def drop_points(generator: torch.Generator, xyz: torch.Tensor,
                rate: float) -> torch.Tensor:
    """:func:`drop_points_from` with ``[N, 1]`` uniforms drawn from
    ``generator`` (on ``xyz``'s device)."""
    if rate <= 0:
        return xyz
    u = torch.rand((xyz.shape[0], 1), generator=generator,
                   device=xyz.device)
    return drop_points_from(u, xyz, rate)


def jitter_offsets_from(uniform: torch.Tensor, amount: float, h: int,
                        w: int) -> torch.Tensor:
    """Per-point NDC offsets worth up to ``amount`` pixels: ``(uniform
    [N, 2] - 0.5) * [2 * amount / w, 2 * amount / h]`` (FastRand's
    ``p - 0.5``). The scales are float32 values multiplied in as Python
    scalars: no tensor is copied to the device, so a step on the card
    does not wait for it."""
    u = uniform - 0.5
    sx, sy = (float(np.float32(2.0 * amount / n)) for n in (w, h))
    return torch.stack([u[:, 0] * sx, u[:, 1] * sy], dim=1)


def pixel_jitter_offsets(generator: torch.Generator, n: int, amount: float,
                         h: int, w: int, device="cuda") -> torch.Tensor:
    """:func:`jitter_offsets_from` with ``[n, 2]`` uniforms drawn from
    ``generator`` on ``device``. Feed to ``rasterize_batch(...,
    ndc_jitter=...)``."""
    u = torch.rand((n, 2), generator=generator, device=device)
    return jitter_offsets_from(u, amount, h, w)


def perturb_pixels_from(uniform: torch.Tensor, ndc: torch.Tensor,
                        amount: float, h: int, w: int) -> torch.Tensor:
    """Projected ``ndc [N, 3]`` with x and y moved by
    :func:`jitter_offsets_from`; ``ndc`` itself where ``amount <= 0``."""
    if amount <= 0:
        return ndc
    off = jitter_offsets_from(uniform, amount, h, w)
    return torch.cat([ndc[:, :2] + off, ndc[:, 2:]], dim=1)


def perturb_pixels(generator: torch.Generator, ndc: torch.Tensor,
                   amount: float, h: int, w: int) -> torch.Tensor:
    """:func:`perturb_pixels_from` with ``[N, 2]`` uniforms drawn from
    ``generator`` (on ``ndc``'s device)."""
    if amount <= 0:
        return ndc
    u = torch.rand((ndc.shape[0], 2), generator=generator,
                   device=ndc.device)
    return perturb_pixels_from(u, ndc, amount, h, w)
