"""The MIMO-UNet of READ (``READ/models/unet.py:130-365``), plainly.

Every layer is a gated convolution followed by BatchNorm: ``fm = conv(x,
W) + b`` with ``2 * Cout`` outputs, ``y = act(fm[:Cout]) *
sigmoid(fm[Cout:])`` (``act`` ELU or identity), then ``(y - mean) *
rsqrt(var + 1e-5) * scale + bias``, then an optional residual. In eval
form (``train=False``) BatchNorm uses its running statistics; in
training form the batch mean and the biased batch variance. The 1x1
layers over several maps resample each map to the layer's size (nearest
or x4 bilinear with half-pixel centres), concatenate and convolve, as
the model is written. Zero padding ``(k - 1) // 2``.

Parameters are a dict keyed ``<layer>.conv_fm.kernel`` (HWIO ``[k, k,
Cin, 2*Cout]``), ``<layer>.conv_fm.bias``, ``<layer>.norm.scale``,
``.bias``, ``.mean`` and ``.var``, the model's own names
(:func:`layers` lists them). Inputs and outputs are NHWC.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.prec import conv2d

__all__ = ["layers", "param_shapes", "forward"]

BN_EPS = 1e-5
Params = Dict[str, torch.Tensor]


def layers(cin: int = 8, cout: int = 3, bc: int = 32, num_res: int = 4
           ) -> List[Tuple[str, int, int, int]]:
    """Every gated conv: ``(name, k, Cin, Cout)``."""
    out = []

    def scm(name, op):
        out.extend([(f"{name}.BasicConv_0", 3, cin, op // 4),
                    (f"{name}.BasicConv_1", 1, op // 4, op // 2),
                    (f"{name}.BasicConv_2", 3, op // 2, op // 2),
                    (f"{name}.BasicConv_3", 1, op // 2, op - cin),
                    (f"{name}.BasicConv_4", 1, op, op)])

    def block(name, c):
        for i in range(num_res):
            out.extend([(f"{name}.ResBlock_{i}.BasicConv_0", 3, c, c),
                        (f"{name}.ResBlock_{i}.BasicConv_1", 3, c, c)])

    scm("SCM2", bc * 2)
    scm("SCM1", bc * 4)
    scm("SCM0", bc * 8)
    out.append(("feat0", 3, cin, bc))
    block("Encoder0", bc)
    out.append(("feat1", 3, bc, bc * 2))
    out.append(("FAM2.BasicConv_0", 3, bc * 2, bc * 2))
    block("Encoder1", bc * 2)
    out.append(("feat2", 3, bc * 2, bc * 4))
    out.append(("FAM1.BasicConv_0", 3, bc * 4, bc * 4))
    block("Encoder2", bc * 4)
    out.append(("feat6", 3, bc * 4, bc * 8))
    out.append(("FAM0.BasicConv_0", 3, bc * 8, bc * 8))
    block("Encoder3", bc * 8)
    for i, c in enumerate((bc, bc * 2, bc * 4)):
        out.extend([(f"AFF{i}.BasicConv_0", 1, bc * 15, c),
                    (f"AFF{i}.BasicConv_1", 3, c, c)])
    block("Decoder0", bc * 8)
    out.append(("feat7", 4, bc * 8, bc * 4))
    out.append(("Convs0", 1, bc * 8, bc * 4))
    block("Decoder1", bc * 4)
    out.append(("feat3", 4, bc * 4, bc * 2))
    out.append(("Convs1", 1, bc * 4, bc * 2))
    block("Decoder2", bc * 2)
    out.append(("feat4", 4, bc * 2, bc))
    out.append(("Convs2", 1, bc * 2, bc))
    block("Decoder3", bc)
    out.append(("feat5", 3, bc, cout))
    return out


def param_shapes(cin: int = 8, cout: int = 3, bc: int = 32,
                 num_res: int = 4) -> Dict[str, Tuple[int, ...]]:
    """Every parameter and running statistic, name -> shape."""
    shapes = {}
    for name, k, ci, co in layers(cin, cout, bc, num_res):
        shapes[f"{name}.conv_fm.kernel"] = (k, k, ci, 2 * co)
        shapes[f"{name}.conv_fm.bias"] = (2 * co,)
        for leaf in ("scale", "bias", "mean", "var"):
            shapes[f"{name}.norm.{leaf}"] = (co,)
    return shapes


class _Net:
    """One forward pass over ``params`` (NCHW inside)."""

    def __init__(self, params: Params, train: bool, prec: str):
        self.p, self.train, self.prec = params, train, prec

    def conv(self, name, x, stride=1, relu=True, res=None):
        w = self.p[f"{name}.conv_fm.kernel"]
        k = w.shape[0]
        fm = conv2d(x, w.permute(3, 2, 0, 1), self.p[f"{name}.conv_fm.bias"],
                    stride, (k - 1) // 2, self.prec)
        c = fm.shape[1] // 2
        f, m = fm[:, :c], fm[:, c:]
        if relu:
            f = F.elu(f)
        y = f * torch.sigmoid(m)
        if self.train:
            mean = y.mean(dim=(0, 2, 3))
            var = torch.square(y - mean[None, :, None, None]).mean(
                dim=(0, 2, 3))
        else:
            mean = self.p[f"{name}.norm.mean"]
            var = self.p[f"{name}.norm.var"]
        scale = torch.rsqrt(var + BN_EPS) * self.p[f"{name}.norm.scale"]
        y = (y - mean[None, :, None, None]) * scale[None, :, None, None] \
            + self.p[f"{name}.norm.bias"][None, :, None, None]
        return y if res is None else y + res

    @staticmethod
    def resample(x, mode, f):
        if mode == "id":
            return x
        if mode == "nearest":
            return x.repeat_interleave(f, dim=2).repeat_interleave(f, dim=3)
        h, w = x.shape[2:]
        return F.interpolate(x, size=(h * f, w * f), mode="bilinear",
                             align_corners=False)

    def comb(self, name, parts, relu=True):
        x = torch.cat([self.resample(x, mode, f) for x, mode, f in parts],
                      dim=1)
        return self.conv(name, x, relu=relu)

    def scm(self, name, x):
        y = self.conv(f"{name}.BasicConv_0", x)
        y = self.conv(f"{name}.BasicConv_1", y)
        y = self.conv(f"{name}.BasicConv_2", y)
        y = self.conv(f"{name}.BasicConv_3", y)
        return self.comb(f"{name}.BasicConv_4", [(x, "id", 1), (y, "id", 1)],
                         relu=False)

    def block(self, name, x, num_res):
        for i in range(num_res):
            r = f"{name}.ResBlock_{i}"
            x = self.conv(f"{r}.BasicConv_1", self.conv(f"{r}.BasicConv_0", x),
                          relu=False, res=x)
        return x

    def aff(self, name, parts):
        return self.conv(f"{name}.BasicConv_1", self.comb(
            f"{name}.BasicConv_0", parts), relu=False)

    def fam(self, name, x1, x2):
        return self.conv(f"{name}.BasicConv_0", x1 * x2, relu=False, res=x1)

    def __call__(self, x, x_2, x_4, x_8, num_res):
        z2 = self.scm("SCM2", x_2)
        z4 = self.scm("SCM1", x_4)
        z8 = self.scm("SCM0", x_8)
        res1 = self.block("Encoder0", self.conv("feat0", x), num_res)
        z = self.fam("FAM2", self.conv("feat1", res1, stride=2), z2)
        res2 = self.block("Encoder1", z, num_res)
        z = self.fam("FAM1", self.conv("feat2", res2, stride=2), z4)
        res3 = self.block("Encoder2", z, num_res)
        z = self.fam("FAM0", self.conv("feat6", res3, stride=2), z8)
        z = self.block("Encoder3", z, num_res)
        z12, z13 = res1[:, :, ::2, ::2], res1[:, :, ::4, ::4]
        z23 = res2[:, :, ::2, ::2]
        r1 = self.aff("AFF0", [(res1, "id", 1), (res2, "nearest", 2),
                               (res3, "nearest", 4), (z, "nearest", 8)])
        r2 = self.aff("AFF1", [(z12, "id", 1), (res2, "id", 1),
                               (res3, "nearest", 2), (z, "nearest", 4)])
        r3 = self.aff("AFF2", [(z13, "id", 1), (z23, "id", 1),
                               (res3, "id", 1), (z, "nearest", 2)])
        z = self.conv("feat7", self.block("Decoder0", z, num_res), stride=2)
        z = self.comb("Convs0", [(z, "bilinear", 4), (r3, "id", 1)])
        z = self.conv("feat3", self.block("Decoder1", z, num_res), stride=2)
        z = self.comb("Convs1", [(z, "bilinear", 4), (r2, "id", 1)])
        z = self.conv("feat4", self.block("Decoder2", z, num_res), stride=2)
        z = self.comb("Convs2", [(z, "bilinear", 4), (r1, "id", 1)])
        return self.conv("feat5", self.block("Decoder3", z, num_res),
                         relu=False)


def forward(params: Params, pyramid, train: bool = False,
            prec: str = "f32") -> torch.Tensor:
    """``im_out [B, h, w, Cout]`` of the four NHWC maps ``pyramid``
    (full, 1/2, 1/4 and 1/8 size). The caller holds TF32 off."""
    num_res = len({k.split(".")[1] for k in params
                   if k.startswith("Encoder0.ResBlock_")})
    maps = [x.permute(0, 3, 1, 2) for x in pyramid]
    out = _Net(params, train, prec)(*maps, num_res)
    return out.permute(0, 2, 3, 1)
