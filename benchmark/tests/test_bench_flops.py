"""The conv operation counts of ``benchmark.flops`` against PyTorch's own
FLOP counter over the plain reference, at a tiny size on the CPU."""

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, weights
from benchmark.reference import fit as ref_fit
from benchmark.reference import raster as ref_raster
from benchmark.reference import unet as ref_unet

NET = dict(cin=8, cout=3, bc=8, num_res=1)
B, H, W = 2, 32, 64


def _params(trained=True):
    return weights.unet_params(NET, weights.generator(5, "net", "cpu"), "cpu",
                               trained=trained)


def _pyramid(batch=B, h=H, w=W):
    gen = torch.Generator().manual_seed(3)
    return [torch.rand(batch, h // 2 ** i, w // 2 ** i, 8, generator=gen)
            for i in range(4)]


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_unet_forward_written_count_matches_flop_counter():
    params, pyr = _params(), _pyramid()
    with torch.no_grad():
        counted = _counted(lambda: ref_unet.forward(params, pyr))
    sites = flops.unet_sites(B, H, W, **NET)
    assert len(sites) == len(ref_unet.layers(**NET))
    assert counted == flops.total_flops(sites, "written")
    assert flops.total_flops(sites, "least") < counted


@pytest.mark.parametrize("name", ["SCM1.BasicConv_4", "AFF0.BasicConv_0",
                                  "AFF2.BasicConv_0", "Convs0", "Convs2"])
def test_least_form_computes_the_layer_and_its_count(name):
    """A 1x1 layer over resampled maps, computed as each map's own
    contraction at its size then resampled, equals the layer as written;
    the counter reads the site's 'least' count off it."""
    site = {s.name: s for s in flops.unet_sites(B, H, W, **NET)}[name]
    gen = torch.Generator().manual_seed(1)
    xs = [torch.randn(B, c, h, w, generator=gen) for c, h, w in site.inputs]
    wt = torch.randn(2 * site.cout, site.cin, 1, 1, generator=gen)
    ho, wo = site.out_hw

    def up(x):
        f = ho // x.shape[2]
        if f == 1:
            return x
        mode = "bilinear" if name.startswith("Convs") else "nearest"
        return F.interpolate(x, scale_factor=f, mode=mode,
                             align_corners=False if mode == "bilinear"
                             else None)

    written = F.conv2d(torch.cat([up(x) for x in xs], 1), wt)
    parts, c0 = [], 0
    for x in xs:
        parts.append(F.conv2d(x, wt[:, c0:c0 + x.shape[1]]))
        c0 += x.shape[1]
    least = sum(up(p) for p in parts)
    torch.testing.assert_close(least, written, atol=1e-4, rtol=1e-4)
    assert _counted(lambda: [F.conv2d(x, wt[:, :x.shape[1]]) for x in xs]) \
        == flops.site_flops(site, "least")
    assert _counted(lambda: F.conv2d(torch.cat([up(x) for x in xs], 1),
                                     wt)) == flops.site_flops(site, "written")


def test_fit_step_count_matches_flop_counter():
    """One reference fitting step: the UNet forward and its backward (input
    and weight gradients), VGG on output and target and the output's
    input gradient."""
    gen = weights.generator(5, "scene", "cpu")
    xyz = torch.rand(4000, 3, generator=gen) * 8 - 4
    xyz[:, 2] -= 8.0
    m = torch.eye(4).repeat(B, 1, 1)
    m[:, 3, 2], m[:, 3, 3] = -1.0, 0.0           # w = -z: in front
    batch = {"total_m": m, "target": torch.rand(B, H, W, 3, generator=gen)}
    assert (ref_raster.pyramid(xyz, m, H, W, 1)[0][0] >= 0).any()
    table = weights.table(4000, 8, weights.generator(5, "table", "cpu"),
                          "cpu")
    vgg = weights.vgg_params(weights.generator(5, "vgg", "cpu"), "cpu")
    counted = _counted(lambda: ref_fit.run_steps(
        _params(False), table, xyz, [batch], vgg, lr=1e-4, texture_lr=0.1,
        levels=4))
    unet = flops.total_flops(flops.unet_sites(B, H, W, **NET), "written")
    vgg_ops = flops.total_flops(flops.vgg_sites(B, H, W))
    assert counted == 3 * unet + 3 * vgg_ops
    assert flops.fit_step_flops(B, H, W, NET) == pytest.approx(
        3 * flops.total_flops(flops.unet_sites(B, H, W, **NET))
        + 3 * vgg_ops)


def test_bound_is_the_larger_of_operations_and_bytes():
    site = flops.unet_sites(1, 368, 1216)[0]
    ops, nbytes = flops.site_flops(site), flops.site_bytes(site)
    assert flops.bound_s([site], 495e12, 3.35e12) == max(ops / 495e12,
                                                         nbytes / 3.35e12)
    # the full-size frame: 84 k x k sites (K2's calls) among the rest
    sites = flops.unet_sites(1, 368, 1216)
    assert sum(1 for s in sites if s.k > 1) == 84
