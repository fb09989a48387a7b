"""The MIMO-UNet refinement network in PyTorch (NHWC), two routes.

Counterpart of ``read_tpu/models/unet.py:130-365`` (topology and
parameter names). The **serving** route (``train=None``, the default)
runs it the way ``read_tpu/models/unet_pallas.py`` runs it for
inference, under ``torch.no_grad()``: BatchNorm folded into each gated
conv's affine (``_fold_bn`` :43-49), every 3x3 and strided conv on K2
(on its wgmma loop where ``GC.kxk_route`` says so, with its packed
weight cached), the SCM 1x1 convs on K3, the SCM ``BasicConv_4`` over
its concat of two same-resolution maps on K4 (the concat never written;
K3 and K4 on the 1x1 wgmma loop, with their packed weight cached), and
the 1x1 convs
over concatenations of resampled maps (AFF ``BasicConv_0``, ``Convs*``)
as ``conv1x1_comb`` (:228-276): ``conv1x1(concat(up(x_j))) == sum_j
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

With ``remat`` (the differentiable route under autograd) every EBlock
and DBlock (``Encoder*``, ``Decoder*``) runs under
``torch.utils.checkpoint`` (non-reentrant), where ``read_tpu`` wraps
them in ``nn.remat``: their activations are dropped after the forward
and recomputed in the backward. The recomputation reads the block's
parameters and statistics as the forward saw them (they enter the
checkpoint as inputs, so a ``functional_call`` that has since returned
does not matter) and leaves the running statistics alone: they move
once a step, as without ``remat``.

Inside :func:`global_batch_norm` the train-mode BatchNorm takes its
statistics over a batch spread across processes, as ``read_tpu``'s
``'split'`` multi-device step takes them over the global batch
(:mod:`read_tpu_torch.parallel.sharded`): the given differentiable
reduce (an all-reduce sum over the mesh's process group) sums each
layer's per-channel sums and count, then its squared deviations from
the global mean; the running statistics move toward those global
moments, the same on every process. A remat recomputation reduces
again, as its forward did. Outside it nothing changes.

Inputs and outputs are NHWC ``[B, h, w, C]``; ``B > 1`` is a real batch.
``operands='bf16'`` means two things. On the serving route it rounds
every conv and matmul operand to bfloat16 and accumulates in float32
(JAX's ``bf16_mxu``); activations stay float32. On the differentiable
route it runs what flax runs with ``dtype=bfloat16, param_dtype=float32``
(``read_tpu/models/unet.py:142-199``): each conv's input, kernel and bias
in bfloat16, the conv's output rounded to bfloat16 before the bias add,
the gate in bfloat16, BatchNorm in float32 on the gate's output cast up
(its statistics stay float32) and its result cast back; the residual
adds, resamples and concats then run on bfloat16 tensors, and
``im_out``/``seg_out`` come back float32.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from read_tpu_torch.ops import gated_conv as GC
from read_tpu_torch.utils.profiling import span

__all__ = ["BasicConv", "UNet", "unet_from_state", "global_batch_norm"]

_BN_EPS = 1e-5
_BN_MOMENTUM = 0.9  # flax's: running = 0.9 * running + 0.1 * batch
_OPERANDS = ("f32", "bf16")
_recompute = threading.local()   # .active: a checkpoint is recomputing
_bn_reduce = threading.local()   # .fn: global_batch_norm's reduce


@contextlib.contextmanager
def _recomputing(reduce=None):
    """A checkpoint's recomputation: no running-statistics update, and
    the BatchNorm reduce its forward ran with (it may run on the
    autograd engine's thread)."""
    _recompute.active = True
    try:
        with global_batch_norm(reduce):
            yield
    finally:
        _recompute.active = False


@contextlib.contextmanager
def global_batch_norm(reduce):
    """Inside the block, train-mode BatchNorm statistics are global:
    ``reduce(t)`` must return the sum of ``t`` over every process of the
    batch, differentiably (its backward sums the cotangents alike)."""
    saved = getattr(_bn_reduce, "fn", None)
    _bn_reduce.fn = reduce
    try:
        yield
    finally:
        _bn_reduce.fn = saved


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
    accumulates with atomics in no fixed order. A bfloat16 ``x`` resizes
    as ``jax.image.resize`` does it: one contraction an axis, W first,
    each in float32 and rounded to bfloat16."""
    if x.dtype == torch.bfloat16:
        x = _lerp_up4(x.float(), 2).to(torch.bfloat16)
        return _lerp_up4(x.float(), 1).to(torch.bfloat16)
    return _lerp_up4(_lerp_up4(x, 1), 2)


def _widen(x: torch.Tensor) -> torch.Tensor:
    """A bfloat16 ``x`` as float32; other dtypes as they are."""
    return x.float() if x.dtype == torch.bfloat16 else x


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
        variance. A checkpoint's recomputation does not move them again.
        Inside :func:`global_batch_norm` both passes are sums reduced
        over the processes of the batch."""
        if train:
            dims = tuple(range(x.dim() - 1))
            reduce = getattr(_bn_reduce, "fn", None)
            if reduce is None:
                mean = x.mean(dim=dims)
                var = torch.square(x - mean).mean(dim=dims)
            else:
                count = x.new_full((1,), float(x.numel() // x.shape[-1]))
                sums = reduce(torch.cat([x.sum(dim=dims), count]))
                mean = sums[:-1] / sums[-1]
                var = reduce(torch.square(x - mean).sum(dim=dims)) / sums[-1]
            if not getattr(_recompute, "active", False):
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
        self._packed = {}  # pack function -> (kernel version, packed)

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

    def _packed_with(self, pack) -> torch.Tensor:
        """``pack(kernel)``, packed once and reused until the kernel is
        replaced or written to (its storage or version counter changes),
        as :meth:`folded_bn`."""
        w = self.conv_fm.kernel
        key = (w.data_ptr(), w._version)
        hit = self._packed.get(pack)
        if hit is None or hit[0] != key:
            with torch.no_grad():
                hit = self._packed[pack] = (key, pack(w))
        return hit[1]

    def packed_kxk_bf16(self) -> torch.Tensor:
        """``GC.pack_kxk_bf16`` of the conv kernel (K2's wgmma loop, bf16
        operands), cached (:meth:`_packed_with`)."""
        return self._packed_with(GC.pack_kxk_bf16)

    def packed_kxk_tf32(self) -> torch.Tensor:
        """``GC.pack_kxk_tf32`` of the conv kernel (K2's wgmma loop, f32
        operands as three TF32 products), cached (:meth:`_packed_with`)."""
        return self._packed_with(GC.pack_kxk_tf32)

    def packed_1x1(self, bf16: bool) -> torch.Tensor:
        """``GC.pack_1x1_bf16`` (``bf16``) or ``GC.pack_1x1_tf32`` of the
        1x1 conv kernel (the 1x1 wgmma loop of K3 and K4), cached
        (:meth:`_packed_with`)."""
        return self._packed_with(GC.pack_1x1_bf16 if bf16
                                 else GC.pack_1x1_tf32)

    def prepare(self, bf16: bool) -> None:
        """Fill the caches now: the folded BN, and the weight a wgmma
        loop takes for ``bf16`` or f32 operands (the 1x1 loop's for a 1x1
        conv, K2's for a k x k conv). A renderer calls it at load, so no
        request folds or packs."""
        self.folded_bn()
        if self.k == 1 and self.stride == 1:
            self.packed_1x1(bf16)
        elif bf16:
            self.packed_kxk_bf16()
        else:
            self.packed_kxk_tf32()

    def forward(self, x: torch.Tensor, bf16: bool = False,
                train: Optional[bool] = None,
                res: Optional[torch.Tensor] = None) -> torch.Tensor:
        if train is not None:
            return self._differentiable(x, train, res, bf16)
        scale, offset = self.folded_bn()
        w, b = self.conv_fm.kernel, self.conv_fm.bias
        # the wrappers call the cache's getter only on a wgmma route
        if self.k == 1 and self.stride == 1:
            return GC.gated_conv_1x1(x, w, b, scale, offset, res,
                                     relu=self.relu, bf16=bf16,
                                     packed=lambda: self.packed_1x1(bf16))
        return GC.gated_conv_kxk(x, w, b, scale, offset, res,
                                 stride=self.stride, relu=self.relu,
                                 bf16=bf16, packed=self.packed_kxk_bf16
                                 if bf16 else self.packed_kxk_tf32)

    def _differentiable(self, x: torch.Tensor, train: bool,
                        res: Optional[torch.Tensor],
                        bf16: bool = False) -> torch.Tensor:
        w, b = self.conv_fm.kernel, self.conv_fm.bias
        if bf16:
            # flax nn.Conv(dtype=bfloat16): the conv's output is rounded
            # to bfloat16, then the bfloat16 bias is added
            x, w, b = (t.to(torch.bfloat16) for t in (x, w, b))
        fm = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                      None if bf16 else b, stride=self.stride,
                      padding=(self.k - 1) // 2).permute(0, 2, 3, 1)
        if bf16:
            fm = fm + b
        c = fm.shape[-1] // 2
        f, m = fm[..., :c], fm[..., c:]
        if self.relu:
            f = F.elu(f)
        out = f * torch.sigmoid(m)
        out = (self.norm(out.float(), train).to(torch.bfloat16) if bf16
               else self.norm(out, train))
        return out if res is None else out + res

    def comb(self, parts, bf16: bool = False,
             train: Optional[bool] = None) -> torch.Tensor:
        """This 1x1 conv over the channel concat of resampled ``parts``
        (``(x [B, h_j, w_j, C_j], mode, factor)``, mode in id / nearest /
        bilinear). Serving sends a site whose parts are all ``id`` (the
        SCMs' ``BasicConv_4``) to K4 in one launch, and contracts the
        parts of any other site at their own resolution; the
        differentiable route resamples and concatenates first."""
        if train is not None:
            x = torch.cat([_resample(x, mode, f, train)
                           for x, mode, f in parts], dim=-1)
            return self(x, bf16, train=train)
        if len(parts) <= GC.MAX_CAT and all(mode == "id"
                                            for _, mode, _ in parts):
            scale, offset = self.folded_bn()
            return GC.gated_conv_1x1_cat(
                [x for x, _, _ in parts], self.conv_fm.kernel,
                self.conv_fm.bias, scale, offset, relu=self.relu,
                bf16=bf16, packed=lambda: self.packed_1x1(bf16))
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

    def prepare(self, operands: str = "f32") -> "UNet":
        """Fold every BasicConv's BN and pack its wgmma weight for
        ``operands`` now (:meth:`BasicConv.prepare`), so the first frame
        does not."""
        if operands not in _OPERANDS:
            raise ValueError(f"operands must be one of {_OPERANDS}")
        for mod in self.modules():
            if isinstance(mod, BasicConv):
                mod.prepare(operands == "bf16")
        return self

    def forward(self, x, x_2, x_4, x_8, train: Optional[bool] = None,
                operands: str = "f32",
                remat: bool = False) -> Dict[str, torch.Tensor]:
        """``train=None`` (default): the serving route, no autograd.
        ``train=True``/``False``: the differentiable route with batch /
        running BN statistics, float32 or flax's bfloat16 activations
        (``operands``, see the module docstring); ``remat`` checkpoints
        its EBlocks and DBlocks while autograd records."""
        if operands not in _OPERANDS:
            raise ValueError(f"operands must be one of {_OPERANDS}")
        bf16 = operands == "bf16"
        with span("read.unet"):
            if train is None:
                with torch.no_grad():
                    return self._forward(x, x_2, x_4, x_8, bf16, None,
                                         False)
            return self._forward(x, x_2, x_4, x_8, bf16, bool(train),
                                 remat and torch.is_grad_enabled())

    def _block(self, name: str, x: torch.Tensor, bf16: bool,
               train: Optional[bool], remat: bool) -> torch.Tensor:
        """EBlock/DBlock ``name`` on ``x``; with ``remat`` under a
        non-reentrant checkpoint whose inputs are ``x`` and the block's
        current parameters. Its current statistics enter by reference:
        the forward moves them in place, which a checkpoint input may
        not see, and no output depends on them in train mode."""
        block = getattr(self, name)
        if not remat:
            return block(x, bf16, train)
        params = dict(block.named_parameters())
        stats = dict(block.named_buffers())
        names = tuple(params)

        def run(x, *values):
            return torch.func.functional_call(
                block, {**dict(zip(names, values)), **stats},
                (x, bf16, train))

        reduce = getattr(_bn_reduce, "fn", None)
        return torch.utils.checkpoint.checkpoint(
            run, x, *params.values(), use_reentrant=False,
            preserve_rng_state=False,
            context_fn=lambda: (contextlib.nullcontext(),
                                _recomputing(reduce)))

    def _forward(self, x, x_2, x_4, x_8, bf16: bool,
                 train: Optional[bool], remat: bool):
        r = (bf16, train)

        def block(name, z):
            return self._block(name, z, bf16, train, remat)

        z2 = self.SCM2(x_2, *r)
        z4 = self.SCM1(x_4, *r)
        z8 = self.SCM0(x_8, *r)

        res1 = block("Encoder0", self.feat0(x, *r))
        z = self.FAM2(self.feat1(res1, *r), z2, *r)
        res2 = block("Encoder1", z)
        z = self.FAM1(self.feat2(res2, *r), z4, *r)
        res3 = block("Encoder2", z)
        z = self.FAM0(self.feat6(res3, *r), z8, *r)
        z = block("Encoder3", z)

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
        z = self.feat7(block("Decoder0", z), *r)
        z = self.Convs0.comb([(z, "bilinear", 4), (r3, "id", 1)], *r)
        z = self.feat3(block("Decoder1", z), *r)
        z = self.Convs1.comb([(z, "bilinear", 4), (r2, "id", 1)], *r)
        z = self.feat4(block("Decoder2", z), *r)
        z = self.Convs2.comb([(z, "bilinear", 4), (r1, "id", 1)], *r)
        feats = block("Decoder3", z)
        # flax casts the heads to float32 (a float64 run stays float64)
        out = {"im_out": _widen(self.feat5(feats, *r))}
        if self.num_classes is not None:
            out["seg_out"] = _widen(self.seg_head(feats, *r))
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
