"""Full float32 for the port's own entry points.

PyTorch runs cuDNN float32 convolutions in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
decimal digits. ``read_tpu`` trains and evaluates in float32, so the
training step, the eval step and the VGG loss run under
:func:`full_f32`, whatever flags their caller set.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["full_f32"]


@contextlib.contextmanager
def full_f32():
    """Turn TF32 off for cuDNN convolutions and cuBLAS matmuls inside the
    block (its backward passes too, where they run inside it) and restore
    the caller's flags after it."""
    cudnn = torch.backends.cudnn.allow_tf32
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul
