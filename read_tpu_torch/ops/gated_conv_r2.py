"""K7: the row-band gated convolutions (``csrc/gated_conv_r2.cu``) and
twins.

Counterpart of ``scripts/gated_conv_pallas_r2.py`` ``gated_conv3x3``
(:105-166) and ``gated_conv1x1`` (:179-220), the round-2 design that K2
and K3 superseded; the kernel bench times it beside them at K2's shapes.
Contract, as the script's: one image ``x [H, W, Cin]``, HWIO weights
``w [k, k, Cin, C2]``, stride 1, zero pad ``(k-1)//2``, no residual.
``gated=True``: ``C2 = 2*Cout`` and ``out = act(f) * sigmoid(m) * scale
+ offset``; ``gated=False``: ``C2 = Cout`` and ``out = act(fm) * scale +
offset`` (``scale``/``offset`` have C2 entries). ``act`` is ELU when
``relu``. The input's dtype (float32 or bfloat16) is also the weights'
(cast to it) and the output's; bias, scale and offset are float32 and
every sum is float32.

Each wrapper sends a CPU tensor to its plain twin and a CUDA tensor to
its kernel (anything else raises); ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from read_tpu_torch import _build
from read_tpu_torch.ops.gated_conv import gated_epilogue

__all__ = ["gated_conv3x3_r2", "gated_conv3x3_r2_plain", "gated_conv1x1_r2",
           "gated_conv1x1_r2_plain", "launches"]

launches = {"gated_conv3x3_r2": 0, "gated_conv1x1_r2": 0}
_DTYPES = (torch.float32, torch.bfloat16)


def _plain(x, w, b, scale, offset, relu, gated):
    """Twin of both forms: the conv in float32 on the dtype's values."""
    k = w.shape[0]
    xf, wf = x.float(), w.to(x.dtype).float()
    fm = F.conv2d(xf.permute(2, 0, 1)[None], wf.permute(3, 2, 0, 1),
                  padding=(k - 1) // 2)[0].permute(1, 2, 0)
    return gated_epilogue(fm, b, scale, offset, None, relu,
                          gated).to(x.dtype).contiguous()


def gated_conv3x3_r2_plain(x, w, b, scale, offset, *, relu=True,
                           gated=True):
    """Plain PyTorch twin of :func:`gated_conv3x3_r2` (``F.conv2d``)."""
    return _plain(x, w, b, scale, offset, relu, gated)


def gated_conv1x1_r2_plain(x, w, b, scale, offset, *, relu=True,
                           gated=True):
    """Plain PyTorch twin of :func:`gated_conv1x1_r2` (``F.conv2d``)."""
    return _plain(x, w.reshape(1, 1, *w.shape[-2:]), b, scale, offset,
                  relu, gated)


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _run(name, k, x, w, b, scale, offset, relu, gated):
    if w.dim() == 2:
        w = w.reshape(1, 1, *w.shape)
    if x.dim() != 3 or x.dtype not in _DTYPES or w.dim() != 4 \
            or tuple(w.shape[:2]) != (k, k) or w.shape[2] != x.shape[-1]:
        raise ValueError(f"{name}: want x [H, W, Cin] float32/bfloat16 and "
                         f"w [{k}, {k}, Cin, C2]; got {tuple(x.shape)} "
                         f"{x.dtype}, {tuple(w.shape)}")
    c2 = w.shape[-1]
    cout = c2 // 2 if gated else c2
    if (gated and c2 != 2 * cout) or tuple(b.shape) != (c2,) or \
            tuple(scale.shape) != (cout,) or tuple(offset.shape) != (cout,):
        raise ValueError(f"{name}: bias/scale/offset do not fit C2={c2}")
    for t in (b, scale, offset):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: bias/scale/offset must be float32")
    tensors = (x, w, b, scale, offset)
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: tensors on different devices")
    if x.device.type == "cpu":
        return _plain(x, w, b, scale, offset, relu, gated)
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {x.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    h, wd, cin = x.shape
    w = w.to(x.dtype).contiguous()
    out = torch.empty((h, wd, cout), dtype=x.dtype, device=x.device)
    fn = _build.function("gated_conv_r2", "gated_conv_r2", _ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), scale.data_ptr(),
             offset.data_ptr(), out.data_ptr(), h, wd, cin, cout, k,
             int(relu), int(gated), int(x.dtype == torch.bfloat16),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, name)
    launches[name] += 1
    return out


def gated_conv3x3_r2(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     scale: torch.Tensor, offset: torch.Tensor, *,
                     relu: bool = True, gated: bool = True) -> torch.Tensor:
    """K7 3x3: ``x [H, W, Cin]``, ``w [3, 3, Cin, C2]`` -> ``[H, W,
    Cout]`` in x's dtype."""
    return _run("gated_conv3x3_r2", 3, x, w, b, scale, offset, relu, gated)


def gated_conv1x1_r2(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     scale: torch.Tensor, offset: torch.Tensor, *,
                     relu: bool = True, gated: bool = True) -> torch.Tensor:
    """K7 1x1: ``x [H, W, Cin]``, ``w [1, 1, Cin, C2]`` or ``[Cin, C2]``
    -> ``[H, W, Cout]`` in x's dtype."""
    return _run("gated_conv1x1_r2", 1, x, w, b, scale, offset, relu, gated)
