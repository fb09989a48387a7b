"""Operations and bytes of the model's convolutions, from the shapes.

Each gated convolution of the MIMO-UNet is one :class:`Site`: its
kernel, stride, output channels ``Cout`` (it computes ``2 * Cout`` sums,
both halves of the gate) and its input maps, each at its own size. Its
operations are ``2 * MAC``. A 1x1 layer over several maps that the model
resamples before it concatenates them has two counts: ``'written'``, the
MACs of the 1x1 convolution at the output size as the model is written,
and ``'least'``, the MACs of each map's own contraction at that map's
size, which is all the function needs, since a 1x1 convolution commutes
with the resampling. The roofline and the MFU metrics take ``'least'``,
the work of the function whatever computes it; ``'written'`` is what a
FLOP counter reads off the plain reference.

A site's bytes: each input map read once at its own size, the weights,
the conv bias and the four BatchNorm vectors, the residual where there
is one, the output written once; 4 bytes an element (float32).

The bound of a site is the larger of its operations over the peak and
its bytes over the memory rate; the configuration gives both (float32:
the TF32 tensor-core peak, since no implementation that meets the
float32 check multiplies faster).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from benchmark.reference import fit as ref_fit
from benchmark.reference import unet as ref_unet

__all__ = ["Site", "unet_sites", "vgg_sites", "site_flops", "site_bytes",
           "total_flops", "bound_s", "fit_step_flops"]

F32 = 4


@dataclasses.dataclass(frozen=True)
class Site:
    name: str
    k: int
    stride: int
    cout: int
    out_hw: Tuple[int, int]
    inputs: Tuple[Tuple[int, int, int], ...]   # (C, h, w) each
    batch: int
    res: bool = False
    gated: bool = True

    @property
    def cin(self) -> int:
        return sum(c for c, _, _ in self.inputs)


def _out(h: int, k: int, stride: int) -> int:
    return (h + 2 * ((k - 1) // 2) - k) // stride + 1


def unet_sites(batch: int, h: int, w: int, cin: int = 8, cout: int = 3,
               bc: int = 32, num_res: int = 4) -> List[Site]:
    """Every gated conv of one forward pass at ``batch x h x w``, in the
    order of :func:`benchmark.reference.unet.layers`."""
    shapes = {name: (k, ci, co) for name, k, ci, co in
              ref_unet.layers(cin, cout, bc, num_res)}
    sites = []

    def size(f):
        return h // f, w // f

    def conv(name, f_in, stride=1, res=False):
        k, ci, co = shapes[name]
        hi, wi = size(f_in)
        sites.append(Site(name, k, stride, co,
                          (_out(hi, k, stride), _out(wi, k, stride)),
                          ((ci, hi, wi),), batch, res))

    def comb(name, f_out, parts):
        k, ci, co = shapes[name]
        ins = tuple((c, *size(f)) for c, f in parts)
        if sum(c for c, _, _ in ins) != ci:
            raise ValueError(f"{name}: parts carry the wrong channels")
        sites.append(Site(name, 1, 1, co, size(f_out), ins, batch))

    def block(name, f):
        for i in range(num_res):
            conv(f"{name}.ResBlock_{i}.BasicConv_0", f)
            conv(f"{name}.ResBlock_{i}.BasicConv_1", f, res=True)

    for name, op, f in (("SCM2", bc * 2, 2), ("SCM1", bc * 4, 4),
                        ("SCM0", bc * 8, 8)):
        for i in range(4):
            conv(f"{name}.BasicConv_{i}", f)
        comb(f"{name}.BasicConv_4", f, ((cin, f), (op - cin, f)))
    conv("feat0", 1)
    block("Encoder0", 1)
    for feat, fam, enc, c, f in (("feat1", "FAM2", "Encoder1", 2, 2),
                                 ("feat2", "FAM1", "Encoder2", 4, 4),
                                 ("feat6", "FAM0", "Encoder3", 8, 8)):
        conv(feat, f // 2, stride=2)
        conv(f"{fam}.BasicConv_0", f, res=True)
        block(enc, f)
    for i, f in enumerate((1, 2, 4)):
        srcs = ((bc, max(f, 1)), (bc * 2, max(f, 2)), (bc * 4, max(f, 4)),
                (bc * 8, 8))
        comb(f"AFF{i}.BasicConv_0", f, srcs)
        conv(f"AFF{i}.BasicConv_1", f)
    for dec, feat, convs, c, f in (("Decoder0", "feat7", "Convs0", 4, 8),
                                   ("Decoder1", "feat3", "Convs1", 2, 4),
                                   ("Decoder2", "feat4", "Convs2", 1, 2)):
        block(dec, f)
        conv(feat, f, stride=2)
        comb(convs, f // 2, ((bc * c, f * 2), (bc * c, f // 2)))
    block("Decoder3", 1)
    conv("feat5", 1)
    return sites


def vgg_sites(batch: int, h: int, w: int) -> List[Site]:
    """The 13 convs of the VGG loss on ``batch`` images of ``h x w``
    (plain 3x3 convs with a bias, no gate)."""
    sites, cin = [], 3
    for i, cout in enumerate(ref_fit.VGG_CHANNELS, start=1):
        sites.append(Site(f"vgg{i}", 3, 1, cout, (h, w), ((cin, h, w),),
                          batch, gated=False))
        cin = cout
        if i in (2, 4, 8, 12):
            h, w = h // 2, w // 2
    return sites


def site_flops(s: Site, form: str = "least") -> float:
    """``2 * MAC`` of ``s`` (``form`` 'least' or 'written')."""
    c2 = 2 * s.cout if s.gated else s.cout
    kk = s.k * s.k
    ho, wo = s.out_hw
    if form == "written" or len(s.inputs) == 1:
        return 2.0 * s.batch * ho * wo * kk * s.cin * c2
    if form != "least":
        raise ValueError(form)
    return 2.0 * s.batch * sum(hi * wi * c for c, hi, wi in s.inputs) * c2


def site_bytes(s: Site) -> float:
    c2 = 2 * s.cout if s.gated else s.cout
    ho, wo = s.out_hw
    inputs = s.batch * sum(c * hi * wi for c, hi, wi in s.inputs)
    weights = s.k * s.k * s.cin * c2 + c2 + (4 * s.cout if s.gated else 0)
    out = s.batch * ho * wo * s.cout * (2 if s.res else 1)
    return float(F32 * (inputs + weights + out))


def total_flops(sites: Sequence[Site], form: str = "least") -> float:
    return sum(site_flops(s, form) for s in sites)


def bound_s(sites: Sequence[Site], peak_flops: float,
            hbm_bytes_s: float) -> float:
    """The least time of ``sites``: each site's larger of its operations
    at ``peak_flops`` and its bytes at ``hbm_bytes_s``, summed."""
    return sum(max(site_flops(s) / peak_flops, site_bytes(s) / hbm_bytes_s)
               for s in sites)


def fit_step_flops(batch: int, h: int, w: int, net: dict) -> float:
    """The model operations of one fitting step: the UNet's forward
    three times (forward, and the backward's input and weight
    gradients), the VGG forward on the output and on the target and the
    output branch's input gradient; no recomputation."""
    unet = total_flops(unet_sites(batch, h, w, **net))
    return 3.0 * unet + 3.0 * total_flops(vgg_sites(batch, h, w))
