"""Point descriptor tables: init and the gather through an index map.

Counterpart of ``read_tpu/models/texture.py``: ``init_point_texture``
(:41-55), ``sample_point_texture_unique`` with its scatter-add backward
(``_gather_unique`` :116-161; the forward is ``sample_point_texture``'s,
:84-113) and ``point_texture_reg_loss`` (:164-167). Tables are ``[N, C]``
float32 tensors; empty pixels (index -1) sample zeros. The port has one
gather: it rasterizes 1-px points only, for which ``read_tpu`` also
gathers through ``sample_point_texture_unique``.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["init_point_texture", "sample_point_texture_unique",
           "point_texture_reg_loss"]


def init_point_texture(n_points: int, n_channels: int = 8,
                       init_method: str = "zeros",
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """A ``[n_points, n_channels]`` float32 CPU table: 'zeros' or 'rand'
    (uniform [0, 1) from ``generator``). The numbers differ from
    ``jax.random``'s for the same seed."""
    shape = (n_points, n_channels)
    if init_method == "zeros":
        return torch.zeros(shape, dtype=torch.float32)
    if init_method == "rand":
        if generator is None:
            raise ValueError("'rand' init needs a torch.Generator")
        return torch.rand(shape, generator=generator, dtype=torch.float32)
    raise ValueError(f"unknown init_method: {init_method}")


class _GatherUnique(torch.autograd.Function):
    """The masked gather whose backward scatter-adds the cotangent into
    an ``[N + 1, C]`` buffer one image at a time, empty pixels aimed at
    the dump row ``N``, which is cut off. Each point wins at most one
    pixel per image with 1-px points, so within an image the rows are
    unique: no two atomics of one launch meet on a kept row, and the
    images add up in image order, as in ``read_tpu``. The result is the
    same bits on every run, on the CPU and on CUDA."""

    @staticmethod
    def forward(ctx, table, index_map):
        n = table.shape[0]
        ctx.save_for_backward(index_map)
        ctx.n = n
        idx = index_map.clamp(0, n - 1).long()
        return table[idx] * (index_map >= 0).unsqueeze(-1).to(table.dtype)

    @staticmethod
    def backward(ctx, g):
        (index_map,) = ctx.saved_tensors
        n, c = ctx.n, g.shape[-1]
        rows = index_map.reshape(-1, index_map.shape[-2]
                                 * index_map.shape[-1]).long()
        g = g.reshape(rows.shape[0], -1, c)
        acc = torch.zeros((n + 1, c), dtype=g.dtype, device=g.device)
        for b in range(rows.shape[0]):
            acc.index_add_(0, torch.where(rows[b] >= 0, rows[b], n), g[b])
        return acc[:n], None


def sample_point_texture_unique(table: torch.Tensor,
                                index_map: torch.Tensor,
                                activation: str = "none") -> torch.Tensor:
    """Gather ``table [N, C]`` through ``index_map [..., H, W]`` (int,
    -1 = empty): ``[..., H, W, C]``, zeros at empty pixels, then the
    activation 'none' | 'sigmoid' | 'tanh' (applied after the mask, as
    in ``read_tpu``, so an empty pixel reads sigmoid(0) = 0.5). The
    backward is :class:`_GatherUnique`'s, valid for 1-px points only (the
    only points the port rasterizes: with ``point_radius > 0`` a point
    would cover several pixels of one image)."""
    if activation not in ("none", "sigmoid", "tanh"):
        raise ValueError(f"unknown activation: {activation}")
    sample = _GatherUnique.apply(table, index_map)
    if activation == "sigmoid":
        return torch.sigmoid(sample)
    if activation == "tanh":
        return torch.tanh(sample)
    return sample


def point_texture_reg_loss(table: torch.Tensor,
                           reg_weight: float) -> torch.Tensor:
    """L2 descriptor regularizer ``reg_weight * mean(table^2)``."""
    return reg_weight * torch.mean(torch.square(table))
