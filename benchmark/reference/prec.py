"""The reference's one convolution, in float32 or in TF32.

``prec='f32'`` runs ``F.conv2d`` with TF32 off for cuDNN and cuBLAS, so
a float32 convolution on the card keeps float32's 24-bit significand.
``prec='tf32'`` is the control: every operand of every product, in the
forward and in both backward convolutions, is rounded to TF32's 10-bit
significand (round to nearest, ties to even) and the sums stay float32,
which is what TF32 tensor cores compute. The rounding is written out, so
the control reads the same on the CPU and on the card.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

__all__ = ["PRECISIONS", "round_tf32", "conv2d", "full_f32"]

PRECISIONS = ("f32", "tf32")


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuDNN convolutions and cuBLAS matmuls inside the
    block; the caller's flags restored after it."""
    cudnn = torch.backends.cudnn.allow_tf32
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to 10 significand bits, ties to even."""
    i = t.contiguous().view(torch.int32)
    i = (i + (0xFFF + ((i >> 13) & 1))) & -8192
    return i.view(torch.float32)


class _ConvTF32(torch.autograd.Function):
    """``F.conv2d`` on TF32-rounded operands; its backward rounds the
    incoming gradient and the saved operands alike."""

    @staticmethod
    def forward(ctx, x, w, b, stride, pad):
        xr, wr = round_tf32(x), round_tf32(w)
        ctx.save_for_backward(xr, wr)
        ctx.stride, ctx.pad, ctx.has_b = stride, pad, b is not None
        return F.conv2d(xr, wr, b, stride=stride, padding=pad)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = round_tf32(g)
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv2d_input(xr.shape, wr, gr, ctx.stride,
                                            ctx.pad)
        if ctx.needs_input_grad[1]:
            gw = torch.nn.grad.conv2d_weight(xr, wr.shape, gr, ctx.stride,
                                             ctx.pad)
        if ctx.has_b and ctx.needs_input_grad[2]:
            gb = g.sum(dim=(0, 2, 3))
        return gx, gw, gb, None, None


def conv2d(x: torch.Tensor, w: torch.Tensor, b, stride: int, pad: int,
           prec: str = "f32") -> torch.Tensor:
    """NCHW ``x`` convolved with OIHW ``w`` (+ ``b``), zero padding
    ``pad``, in ``prec``. The caller holds TF32 off (:func:`full_f32`)."""
    if prec == "f32":
        return F.conv2d(x, w, b, stride=stride, padding=pad)
    if prec == "tf32":
        return _ConvTF32.apply(x, w, b, stride, pad)
    raise ValueError(f"unknown precision {prec!r}; expected {PRECISIONS}")
