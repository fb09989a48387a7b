"""The MIMO-UNet refinement network in PyTorch (NHWC), two routes.

Counterpart of ``read_tpu/models/unet.py:130-365`` (topology and
parameter names). The **serving** route (``train=None``, the default)
runs it the way ``read_tpu/models/unet_pallas.py`` runs it for
inference, under ``torch.no_grad()``: BatchNorm folded into each gated
conv's affine
(``_fold_bn`` :43-49), every 3x3 and strided conv on K2, the SCM 1x1
convs on K3, and the 1x1 convs over concatenations of resampled maps
(SCM ``BasicConv_4``, AFF ``BasicConv_0``, ``Convs*``) as
``conv1x1_comb`` (:228-276): ``conv1x1(concat(up(x_j))) == sum_j
up(x_j @ W_j)``, low-resolution matmuls, the resample, and a PyTorch
epilogue.

Submodule names follow the flax paths (``SCM2``, ``Encoder0.ResBlock_0.
BasicConv_1``, ``AFF0``, ``Convs0``, ``feat0``..``feat7``, ``seg_head``)
and each BasicConv holds ``conv_fm.kernel`` (HWIO ``[k, k, Cin,
2*Cout]``), ``conv_fm.bias``, ``norm.scale``/``norm.bias`` and the
buffers ``norm.mean``/``norm.var``, so :mod:`read_tpu_torch.utils.
convert` maps checkpoint keys one to one.

The **differentiable** route (``train=True`` or ``False``) is what
``read_tpu`` trains (its convs run through XLA, never Pallas): each
BasicConv is ``F.conv2d`` (cuDNN on a GPU) with the HWIO kernel permuted
at the call, the gate, and flax's BatchNorm under autograd
(:class:`_Norm`); the 1x1 convs over concatenations resample, concatenate
and convolve, as flax does. ``train=True`` normalizes with the batch
statistics and updates the running ones in place (the JAX step returns
them as its new ``batch_stats``); ``train=False`` uses the running
statistics, with gradients (the frozen-net training step).

Inputs and outputs are NHWC ``[B, h, w, C]``; ``B > 1`` is a real batch.
``operands='bf16'`` (serving only) rounds every conv and matmul operand
to bfloat16 and accumulates in float32 (JAX's ``bf16_mxu``); activations
stay float32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from read_tpu_torch.ops import gated_conv as GC

__all__ = ["BasicConv", "UNet", "unet_from_state"]

_BN_EPS = 1e-5
_BN_MOMENTUM = 0.9  # flax's: running = 0.9 * running + 0.1 * batch
_OPERANDS = ("f32", "bf16")


def _nearest_down(x: torch.Tensor, f: int) -> torch.Tensor:
    """Top-left pick of each f x f block (torch nearest downsample)."""
    return x[:, ::f, ::f, :].contiguous()


def _nearest_up(x: torch.Tensor, f: int) -> torch.Tensor:
    """Repeat each pixel f times along H and W."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, f, w, f, c).reshape(
        b, h * f, w * f, c)


def _bilinear_up4(x: torch.Tensor) -> torch.Tensor:
    """x4 bilinear upsample with half-pixel centres (``jax.image.resize``
    'bilinear' == ``F.interpolate(align_corners=False)`` when upsampling,
    edges included: both clamp to the border sample)."""
    b, h, w, c = x.shape
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(4 * h, 4 * w),
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1).contiguous()


def _lerp_up4(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x4 linear upsample along ``dim`` with half-pixel centres, the
    border clamped: output ``4i + p`` blends ``x[i]`` with ``x[i - 1]``
    (p = 0, 1: weights 3/8, 1/8) or ``x[i + 1]`` (p = 2, 3: 1/8, 3/8)."""
    n = x.shape[dim]
    prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
    phases = [prev * 0.375 + x * 0.625, prev * 0.125 + x * 0.875,
              x * 0.875 + nxt * 0.125, x * 0.625 + nxt * 0.375]
    return torch.stack(phases, dim + 1).flatten(dim, dim + 1)


def _bilinear_up4_lerp(x: torch.Tensor) -> torch.Tensor:
    """:func:`_bilinear_up4` built from slices and element-wise lerps, for
    the differentiable route: its backward is slicing and adds, so it is
    deterministic on CUDA, where ``F.interpolate``'s bilinear backward
    accumulates with atomics in no fixed order."""
    return _lerp_up4(_lerp_up4(x, 1), 2)


def _resample(x: torch.Tensor, mode: str, f: int,
              train: Optional[bool] = None) -> torch.Tensor:
    if mode == "id":
        return x
    if mode == "nearest":
        return _nearest_up(x, f)
    if mode == "bilinear":
        return _bilinear_up4(x) if train is None else _bilinear_up4_lerp(x)
    raise ValueError(mode)


class _Conv(nn.Module):
    """flax ``nn.Conv`` parameters: HWIO ``kernel`` and ``bias``."""

    def __init__(self, k: int, cin: int, cout2: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(k, k, cin, cout2))
        self.bias = nn.Parameter(torch.zeros(cout2))


class _Norm(nn.Module):
    """flax ``nn.BatchNorm`` parameters and running statistics."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        """flax's BatchNorm over the channels of NHWC ``x``: ``(x - mean)
        * (rsqrt(var + eps) * scale) + bias``. ``train`` takes the batch
        mean and the two-pass **biased** variance (``use_fast_variance=
        False``) and moves the running statistics toward them with
        momentum 0.9; ``nn.BatchNorm2d`` would update with the unbiased
        variance."""
        if train:
            dims = tuple(range(x.dim() - 1))
            mean = x.mean(dim=dims)
            var = torch.square(x - mean).mean(dim=dims)
            with torch.no_grad():
                self.mean.copy_(_BN_MOMENTUM * self.mean
                                + (1 - _BN_MOMENTUM) * mean)
                self.var.copy_(_BN_MOMENTUM * self.var
                               + (1 - _BN_MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + _BN_EPS) * self.scale) \
            + self.bias


class BasicConv(nn.Module):
    """Gated conv + BatchNorm (``read_tpu/models/unet.py:130-184``); zero
    padding ``(k-1)//2``. ``train=None`` runs the serving kernels with
    the folded eval BN; ``True``/``False`` the differentiable route
    with batch/running statistics."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, relu: bool = True):
        super().__init__()
        self.k, self.stride, self.relu = kernel_size, stride, relu
        self.conv_fm = _Conv(kernel_size, cin, 2 * cout)
        self.norm = _Norm(cout)
        self._folded = None  # (BN tensor versions, (scale, offset))

    def folded_bn(self):
        """``scale = gamma * rsqrt(var + eps)``, ``offset = beta -
        mean * scale`` (``unet_pallas._fold_bn``), computed once and
        reused until a BN tensor is replaced or written to (its storage
        or version counter changes): folding on every call would add
        four tiny kernel launches per conv to each frame."""
        n = self.norm
        key = tuple((t.data_ptr(), t._version)
                    for t in (n.scale, n.bias, n.mean, n.var))
        if self._folded is None or self._folded[0] != key:
            scale = n.scale * torch.rsqrt(n.var + _BN_EPS)
            self._folded = (key, (scale, n.bias - n.mean * scale))
        return self._folded[1]

    def forward(self, x: torch.Tensor, bf16: bool = False,
                train: Optional[bool] = None,
                res: Optional[torch.Tensor] = None) -> torch.Tensor:
        if train is not None:
            return self._differentiable(x, train, res)
        scale, offset = self.folded_bn()
        w, b = self.conv_fm.kernel, self.conv_fm.bias
        if self.k == 1 and self.stride == 1:
            return GC.gated_conv_1x1(x, w, b, scale, offset, res,
                                     relu=self.relu, bf16=bf16)
        return GC.gated_conv_kxk(x, w, b, scale, offset, res,
                                 stride=self.stride, relu=self.relu,
                                 bf16=bf16)

    def _differentiable(self, x: torch.Tensor, train: bool,
                        res: Optional[torch.Tensor]) -> torch.Tensor:
        fm = F.conv2d(x.permute(0, 3, 1, 2),
                      self.conv_fm.kernel.permute(3, 2, 0, 1),
                      self.conv_fm.bias, stride=self.stride,
                      padding=(self.k - 1) // 2).permute(0, 2, 3, 1)
        c = fm.shape[-1] // 2
        f, m = fm[..., :c], fm[..., c:]
        if self.relu:
            f = F.elu(f)
        out = self.norm(f * torch.sigmoid(m), train)
        return out if res is None else out + res

    def comb(self, parts, bf16: bool = False,
             train: Optional[bool] = None) -> torch.Tensor:
        """This 1x1 conv over the channel concat of resampled ``parts``
        (``(x [B, h_j, w_j, C_j], mode, factor)``, mode in id / nearest /
        bilinear). Serving contracts each part at its own resolution;
        the differentiable route resamples and concatenates first."""
        if train is not None:
            x = torch.cat([_resample(x, mode, f, train)
                           for x, mode, f in parts], dim=-1)
            return self(x, train=train)
        w = self.conv_fm.kernel
        w2 = w.reshape(w.shape[2], w.shape[3])
        acc, coff = None, 0
        for x, mode, f in parts:
            c = x.shape[-1]
            xj, wj = x, w2[coff:coff + c]
            coff += c
            if bf16:
                xj, wj = GC.round_bf16(xj), GC.round_bf16(wj)
            a = _resample(torch.matmul(xj, wj), mode, f)
            acc = a if acc is None else acc + a
        if coff != w2.shape[0]:
            raise ValueError(f"comb: parts carry {coff} channels, weight "
                             f"wants {w2.shape[0]}")
        scale, offset = self.folded_bn()
        return GC.gated_epilogue(acc, self.conv_fm.bias, scale, offset,
                                 None, self.relu)


class ResBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.BasicConv_0 = BasicConv(c, c, 3, 1, relu=True)
        self.BasicConv_1 = BasicConv(c, c, 3, 1, relu=False)

    def forward(self, x, bf16, train=None):
        return self.BasicConv_1(self.BasicConv_0(x, bf16, train), bf16,
                                train, res=x)


class EBlock(nn.Module):
    """``num_res`` ResBlocks (also the DBlock body)."""

    def __init__(self, c: int, num_res: int):
        super().__init__()
        self.num_res = num_res
        for i in range(num_res):
            self.add_module(f"ResBlock_{i}", ResBlock(c))

    def forward(self, x, bf16, train=None):
        for i in range(self.num_res):
            x = getattr(self, f"ResBlock_{i}")(x, bf16, train)
        return x


class SCM(nn.Module):
    def __init__(self, out_plane: int, in_channels: int):
        super().__init__()
        op = out_plane
        self.BasicConv_0 = BasicConv(in_channels, op // 4, 3)
        self.BasicConv_1 = BasicConv(op // 4, op // 2, 1)
        self.BasicConv_2 = BasicConv(op // 2, op // 2, 3)
        self.BasicConv_3 = BasicConv(op // 2, op - in_channels, 1)
        self.BasicConv_4 = BasicConv(op, op, 1, relu=False)

    def forward(self, x, bf16, train=None):
        y = self.BasicConv_0(x, bf16, train)
        y = self.BasicConv_1(y, bf16, train)
        y = self.BasicConv_2(y, bf16, train)
        y = self.BasicConv_3(y, bf16, train)
        return self.BasicConv_4.comb([(x, "id", 1), (y, "id", 1)], bf16,
                                     train)


class FAM(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.BasicConv_0 = BasicConv(c, c, 3, relu=False)

    def forward(self, x1, x2, bf16, train=None):
        return self.BasicConv_0(x1 * x2, bf16, train, res=x1)


class AFF(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.BasicConv_0 = BasicConv(cin, cout, 1, relu=True)
        self.BasicConv_1 = BasicConv(cout, cout, 3, relu=False)

    def forward(self, parts, bf16, train=None):
        return self.BasicConv_1(self.BasicConv_0.comb(parts, bf16, train),
                                bf16, train)


class UNet(nn.Module):
    """MIMO-UNet (``read_tpu/models/unet.py:267-365``).

    ``net(x, x_2, x_4, x_8)`` with NHWC descriptor maps at full, 1/2, 1/4
    and 1/8 resolution; returns ``{'im_out': [B, h, w, out]}`` (+
    ``'seg_out'`` with ``num_classes``). ``h`` and ``w`` must be
    divisible by 8."""

    def __init__(self, num_input_channels: int = 8,
                 num_output_channels: int = 3, base_channel: int = 32,
                 num_res: int = 4, num_classes: Optional[int] = None):
        super().__init__()
        bc, cin = base_channel, num_input_channels
        self.num_classes = num_classes
        self.SCM2 = SCM(bc * 2, cin)
        self.SCM1 = SCM(bc * 4, cin)
        self.SCM0 = SCM(bc * 8, cin)
        self.feat0 = BasicConv(cin, bc, 3, 1)
        self.Encoder0 = EBlock(bc, num_res)
        self.feat1 = BasicConv(bc, bc * 2, 3, 2)
        self.FAM2 = FAM(bc * 2)
        self.Encoder1 = EBlock(bc * 2, num_res)
        self.feat2 = BasicConv(bc * 2, bc * 4, 3, 2)
        self.FAM1 = FAM(bc * 4)
        self.Encoder2 = EBlock(bc * 4, num_res)
        self.feat6 = BasicConv(bc * 4, bc * 8, 3, 2)
        self.FAM0 = FAM(bc * 8)
        self.Encoder3 = EBlock(bc * 8, num_res)
        self.AFF0 = AFF(bc * 15, bc)
        self.AFF1 = AFF(bc * 15, bc * 2)
        self.AFF2 = AFF(bc * 15, bc * 4)
        self.Decoder0 = EBlock(bc * 8, num_res)
        self.feat7 = BasicConv(bc * 8, bc * 4, 4, 2)
        self.Convs0 = BasicConv(bc * 8, bc * 4, 1)
        self.Decoder1 = EBlock(bc * 4, num_res)
        self.feat3 = BasicConv(bc * 4, bc * 2, 4, 2)
        self.Convs1 = BasicConv(bc * 4, bc * 2, 1)
        self.Decoder2 = EBlock(bc * 2, num_res)
        self.feat4 = BasicConv(bc * 2, bc, 4, 2)
        self.Convs2 = BasicConv(bc * 2, bc, 1)
        self.Decoder3 = EBlock(bc, num_res)
        self.feat5 = BasicConv(bc, num_output_channels, 3, relu=False)
        if num_classes is not None:
            self.seg_head = BasicConv(bc, num_classes, 3, relu=False)

    def init_weights(self, generator: torch.Generator) -> "UNet":
        """flax's init in distribution: conv kernels lecun-normal
        (truncated at 2 sigma, fan_in = k*k*Cin), biases 0, BN identity.
        The numbers differ from ``jax.random``'s."""
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, _Conv):
                    k, _, cin, _ = mod.kernel.shape
                    std = math.sqrt(1.0 / (k * k * cin)) / .87962566103423978
                    nn.init.trunc_normal_(mod.kernel, std=std, a=-2 * std,
                                          b=2 * std, generator=generator)
                    mod.bias.zero_()
        return self

    def forward(self, x, x_2, x_4, x_8, train: Optional[bool] = None,
                operands: str = "f32") -> Dict[str, torch.Tensor]:
        """``train=None`` (default): the serving route, no autograd.
        ``train=True``/``False``: the differentiable route with batch /
        running BN statistics (float32 operands only)."""
        if operands not in _OPERANDS:
            raise ValueError(f"operands must be one of {_OPERANDS}")
        if train is None:
            with torch.no_grad():
                return self._forward(x, x_2, x_4, x_8, operands == "bf16",
                                     None)
        if operands != "f32":
            raise NotImplementedError(
                "the differentiable (training) route runs float32 "
                "operands only; bfloat16 training is not ported")
        return self._forward(x, x_2, x_4, x_8, False, bool(train))

    def _forward(self, x, x_2, x_4, x_8, bf16: bool,
                 train: Optional[bool]):
        r = (bf16, train)
        z2 = self.SCM2(x_2, *r)
        z4 = self.SCM1(x_4, *r)
        z8 = self.SCM0(x_8, *r)

        res1 = self.Encoder0(self.feat0(x, *r), *r)
        z = self.FAM2(self.feat1(res1, *r), z2, *r)
        res2 = self.Encoder1(z, *r)
        z = self.FAM1(self.feat2(res2, *r), z4, *r)
        res3 = self.Encoder2(z, *r)
        z = self.FAM0(self.feat6(res3, *r), z8, *r)
        z = self.Encoder3(z, *r)

        # AFF cross-scale fusion; the downsamples are cheap picks, the
        # upsamples (serving) happen after each part's low-resolution
        # matmul
        z12 = _nearest_down(res1, 2)
        z13 = _nearest_down(res1, 4)
        z23 = _nearest_down(res2, 2)
        r1 = self.AFF0([(res1, "id", 1), (res2, "nearest", 2),
                        (res3, "nearest", 4), (z, "nearest", 8)], *r)
        r2 = self.AFF1([(z12, "id", 1), (res2, "id", 1),
                        (res3, "nearest", 2), (z, "nearest", 4)], *r)
        r3 = self.AFF2([(z13, "id", 1), (z23, "id", 1), (res3, "id", 1),
                        (z, "nearest", 2)], *r)

        # decoder: stride-2 k4 conv + x4 bilinear = x2 up, then skip
        z = self.feat7(self.Decoder0(z, *r), *r)
        z = self.Convs0.comb([(z, "bilinear", 4), (r3, "id", 1)], *r)
        z = self.feat3(self.Decoder1(z, *r), *r)
        z = self.Convs1.comb([(z, "bilinear", 4), (r2, "id", 1)], *r)
        z = self.feat4(self.Decoder2(z, *r), *r)
        z = self.Convs2.comb([(z, "bilinear", 4), (r1, "id", 1)], *r)
        feats = self.Decoder3(z, *r)
        out = {"im_out": self.feat5(feats, *r)}
        if self.num_classes is not None:
            out["seg_out"] = self.seg_head(feats, *r)
        return out


def unet_from_state(state: Dict[str, torch.Tensor]) -> UNet:
    """A :class:`UNet` shaped after, and loaded from, a state dict (e.g.
    from :func:`read_tpu_torch.utils.convert.variables_from_flat`):
    widths, depth and heads are read off the parameter shapes."""
    k0 = state["feat0.conv_fm.kernel"]
    res_ids = {key.split(".")[1] for key in state
               if key.startswith("Encoder0.ResBlock_")}
    seg = state.get("seg_head.conv_fm.kernel")
    net = UNet(num_input_channels=k0.shape[2],
               num_output_channels=state["feat5.conv_fm.kernel"].shape[3]
               // 2,
               base_channel=k0.shape[3] // 2, num_res=len(res_ids),
               num_classes=None if seg is None else seg.shape[3] // 2)
    net.load_state_dict(state, strict=True)
    return net.eval()
