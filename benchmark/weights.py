"""Weights and tables from the seed, in a few large calls on the device.

:func:`unet_params` fills every parameter and running statistic that
:func:`benchmark.reference.unet.param_shapes` names: the conv kernels
from one normal draw, each scaled by its fan-in as flax's lecun-normal
init scales it; the rest either as a fresh fit starts them (biases 0,
BatchNorm the identity) or, for a served checkpoint, drawn so that every
BatchNorm and bias does something (``trained=True``). :func:`table`
draws the descriptor table uniform in [0, 1), as the pipeline's 'rand'
init; :func:`vgg_params` the VGG convs He-normal with zero biases.
Each takes its own ``torch.Generator``; :func:`generator` derives one a
purpose from the run's seed.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference import fit as ref_fit
from benchmark.reference import unet as ref_unet

__all__ = ["generator", "unet_params", "table", "vgg_params"]

# one stream a purpose
STREAMS = {"scene": 1, "net": 2, "table": 3, "vgg": 4, "targets": 5}


def generator(seed: int, purpose: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + STREAMS[purpose]) % (1 << 63))
    return gen


def unet_params(net: dict, gen: torch.Generator, device,
                trained: bool = False) -> Dict[str, torch.Tensor]:
    shapes = ref_unet.param_shapes(**net)
    kernels = [k for k in shapes if k.endswith(".conv_fm.kernel")]
    sizes = [math.prod(shapes[k]) for k in kernels]
    draw = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for k, part in zip(kernels, draw.split(sizes)):
        kh, _, cin, _ = shapes[k]
        std = math.sqrt(1.0 / (kh * kh * cin)) / 0.87962566103423978
        out[k] = (part * std).view(shapes[k])
    rest = [k for k in shapes if k not in out]
    sizes = [math.prod(shapes[k]) for k in rest]
    if trained:
        u = torch.rand(sum(sizes), generator=gen, device=device).split(sizes)
        n = torch.randn(sum(sizes), generator=gen, device=device).split(sizes)
    for i, k in enumerate(rest):
        leaf = k.rsplit(".", 1)[-1]
        if not trained:
            fill = 1.0 if leaf in ("scale", "var") else 0.0
            out[k] = torch.full(shapes[k], fill, device=device)
        elif leaf in ("scale", "var"):
            out[k] = 0.8 + 0.4 * u[i]
        else:           # conv bias, BatchNorm bias and mean
            out[k] = (0.02 if k.endswith("conv_fm.bias") else 0.1) * n[i]
    return out


def table(n: int, channels: int, gen: torch.Generator, device
          ) -> torch.Tensor:
    return torch.rand((n, channels), generator=gen, device=device)


def vgg_params(gen: torch.Generator, device):
    shapes, cin = [], 3
    for cout in ref_fit.VGG_CHANNELS:
        shapes.append((3, 3, cin, cout))
        cin = cout
    sizes = [math.prod(s) for s in shapes]
    draw = torch.randn(sum(sizes), generator=gen, device=device)
    return [((part * math.sqrt(2.0 / (9 * s[2]))).view(s),
             torch.zeros(s[3], device=device))
            for s, part in zip(shapes, draw.split(sizes))]
