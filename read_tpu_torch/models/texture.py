"""Point descriptor tables: init and the gather through an index map.

Counterpart of ``read_tpu/models/texture.py``: ``init_point_texture``
(:41-55), ``sample_point_texture`` (:84-113), ``sample_point_texture_unique``
with its scatter-add backward (``_gather_unique`` :116-161; the forward
is ``sample_point_texture``'s) and ``point_texture_reg_loss``
(:164-167). Tables are ``[N, C]`` float32 tensors; empty pixels (index
-1) sample zeros. As in ``read_tpu``, 1-px points gather through
``sample_point_texture_unique`` and splats (a point winning several
pixels of one image) through ``sample_point_texture``.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["init_point_texture", "sample_point_texture",
           "sample_point_texture_unique", "point_texture_reg_loss"]


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


class _Gather(torch.autograd.Function):
    """The masked gather ``table[index_map]`` (zeros at -1) whose backward
    adds every pixel's cotangent into its point's row of an ``[N + 1, C]``
    buffer, empty pixels aimed at the dump row ``N``, which is cut off.
    ``per_image``: one ``index_add_`` per image, in image order, as
    ``read_tpu``'s unique gather adds them; with 1-px points each point
    wins at most one pixel of an image, so no two atomics of one launch
    meet on a kept row and the result is the same bits on every run, on
    the CPU and on CUDA. Otherwise one ``index_add_`` over all images,
    which sums duplicate rows too (a splatted point wins several pixels
    of one image): on CUDA they meet in float atomics, whose order
    changes from run to run, so that result is not bit-reproducible."""

    @staticmethod
    def forward(ctx, table, index_map, per_image):
        n = table.shape[0]
        ctx.save_for_backward(index_map)
        ctx.n, ctx.per_image = n, per_image
        idx = index_map.clamp(0, n - 1).long()
        return table[idx] * (index_map >= 0).unsqueeze(-1).to(table.dtype)

    @staticmethod
    def backward(ctx, g):
        (index_map,) = ctx.saved_tensors
        n, c = ctx.n, g.shape[-1]
        images = (index_map.shape[-2] * index_map.shape[-1]
                  if ctx.per_image else index_map.numel())
        rows = index_map.reshape(-1, images).long()
        g = g.reshape(rows.shape[0], -1, c)
        acc = torch.zeros((n + 1, c), dtype=g.dtype, device=g.device)
        for b in range(rows.shape[0]):
            acc.index_add_(0, torch.where(rows[b] >= 0, rows[b], n), g[b])
        return acc[:n], None, None


def _activate(sample: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "sigmoid":
        return torch.sigmoid(sample)
    if activation == "tanh":
        return torch.tanh(sample)
    return sample


def _check_activation(activation: str) -> None:
    if activation not in ("none", "sigmoid", "tanh"):
        raise ValueError(f"unknown activation: {activation}")


def sample_point_texture(table: torch.Tensor, index_map: torch.Tensor,
                         activation: str = "none") -> torch.Tensor:
    """Gather ``table [N, C]`` through ``index_map [..., H, W]`` (int,
    -1 = empty): ``[..., H, W, C]``, zeros at empty pixels, then the
    activation 'none' | 'sigmoid' | 'tanh' (after the mask). Its
    backward (:class:`_Gather`, one ``index_add_``) sums every pixel a
    point won, so it holds for splats, where one point covers several
    pixels of an image."""
    _check_activation(activation)
    return _activate(_Gather.apply(table, index_map, False), activation)


def sample_point_texture_unique(table: torch.Tensor,
                                index_map: torch.Tensor,
                                activation: str = "none") -> torch.Tensor:
    """Gather ``table [N, C]`` through ``index_map [..., H, W]`` (int,
    -1 = empty): ``[..., H, W, C]``, zeros at empty pixels, then the
    activation 'none' | 'sigmoid' | 'tanh' (applied after the mask, as
    in ``read_tpu``, so an empty pixel reads sigmoid(0) = 0.5). The
    backward (:class:`_Gather`, one ``index_add_`` per image) is
    bit-reproducible for 1-px points; with ``point_radius > 0`` a point
    covers several pixels of one image: use
    :func:`sample_point_texture`."""
    _check_activation(activation)
    return _activate(_Gather.apply(table, index_map, True), activation)


def point_texture_reg_loss(table: torch.Tensor,
                           reg_weight: float) -> torch.Tensor:
    """L2 descriptor regularizer ``reg_weight * mean(table^2)``."""
    return reg_weight * torch.mean(torch.square(table))
