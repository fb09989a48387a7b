"""Point descriptor tables: init and the gather through an index map.

Counterpart of ``read_tpu/models/texture.py``: ``init_point_texture``
(:41-55) and ``sample_point_texture`` (:84-113). Tables are ``[N, C]``
float32 tensors; empty pixels (index -1) sample zeros.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["init_point_texture", "sample_point_texture"]


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


def sample_point_texture(table: torch.Tensor, index_map: torch.Tensor,
                         activation: str = "none") -> torch.Tensor:
    """Gather ``table [N, C]`` through ``index_map [..., H, W]`` (int,
    -1 = empty): ``[..., H, W, C]``, zeros at empty pixels, then the
    activation 'none' | 'sigmoid' | 'tanh' (applied after the mask, as
    in ``read_tpu``, so an empty pixel reads sigmoid(0) = 0.5)."""
    if activation not in ("none", "sigmoid", "tanh"):
        raise ValueError(f"unknown activation: {activation}")
    n = table.shape[0]
    idx = index_map.clamp(0, n - 1).long()
    sample = table[idx]
    sample = sample * (index_map >= 0).unsqueeze(-1).to(table.dtype)
    if activation == "sigmoid":
        sample = torch.sigmoid(sample)
    elif activation == "tanh":
        sample = torch.tanh(sample)
    return sample
