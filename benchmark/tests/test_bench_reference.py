"""The frozen reference against the port's own CPU path (its plain
twins) at a tiny size: a wrong copy in the reference shows here. These
tests may import the port; the reference may not."""

import numpy as np
import pytest
import torch

from benchmark import kinds, manifest, scene, weights
from benchmark.kinds.fit import compare
from benchmark.reference import fit as ref_fit
from benchmark.reference import raster as ref_raster
from benchmark.reference import unet as ref_unet
from benchmark.reference.prec import full_f32, round_tf32

NET = dict(cin=8, cout=3, bc=8, num_res=1)


def _port_unet(params):
    from read_tpu_torch.models.unet import UNet
    net = UNet(num_input_channels=8, num_output_channels=3, base_channel=8,
               num_res=1)
    net.load_state_dict(params, strict=True)
    return net.eval()


def _street(n=5000, seed=4):
    return scene.street(n, weights.generator(seed, "scene", "cpu"), "cpu")


def _matrices(h, w, count=2):
    K = scene.intrinsics(w, h, 0.6 * w)
    P = scene.gl_projection(K, (w, h))
    return torch.from_numpy(np.stack([
        scene.total_matrix(P, v) for v in scene.drive(count, 3.0)]).astype(
            np.float32))


def test_raster_pyramid_is_the_ports_bit_for_bit():
    from read_tpu_torch.ops import rasterize as R
    xyz, m = _street(), _matrices(32, 64)
    want = R.rasterize_pyramid_pooled(xyz, m, (32, 64), 4, method="sort",
                                      pool_impl="exact")
    got = ref_raster.pyramid(xyz, m, 32, 64, 4)
    assert (got[0][0] >= 0).float().mean() > 0.2
    for (gi, gd), (wi, wd) in zip(got, want):
        assert torch.equal(gi, wi) and torch.equal(gd, wd)


@pytest.mark.parametrize("train", [False, True])
def test_unet_matches_the_ports(train):
    params = weights.unet_params(NET, weights.generator(2, "net", "cpu"),
                                 "cpu", trained=True)
    gen = torch.Generator().manual_seed(0)
    pyr = [torch.rand(2, 32 // 2 ** i, 64 // 2 ** i, 8, generator=gen)
           for i in range(4)]
    net = _port_unet(params)
    with torch.no_grad(), full_f32():
        want = net(*pyr, train=train)["im_out"] if train else \
            net(*pyr)["im_out"]
        got = ref_unet.forward(params, pyr, train=train)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


def test_vgg_loss_matches_the_ports():
    from read_tpu_torch.criterions import vgg as V
    vgg = weights.vgg_params(weights.generator(2, "vgg", "cpu"), "cpu")
    gen = torch.Generator().manual_seed(1)
    a, b = (torch.rand(2, 32, 32, 3, generator=gen) for _ in range(2))
    with full_f32():
        torch.testing.assert_close(ref_fit.vgg_loss(vgg, a, b),
                                   V.vgg_loss(vgg, a, b), atol=0,
                                   rtol=1e-5)


def test_the_frame_matches_the_renderers(tiny_root):
    """The view cell at a tiny size: ``NeuralRenderer.infer`` on the CPU
    (the twins) against the reference's frame at every kept pose."""
    man = manifest.load(tiny_root)
    cfg = manifest.config(man, "read-kitti6")
    c = kinds.cell_class("view")(cfg, manifest.traffic(man, "view"), 77,
                                 "cpu")
    c.setup()
    c.window(0.3)
    c.release()
    assert len(c.kept) >= 1
    assert c.readings()["frame_gap"] < 1e-5


def test_one_fit_step_matches_the_ports(tiny_root):
    """The port's training step on the CPU against the reference's, from
    one seeded start: the loss, each leaf's first gradient and its
    change."""
    man = manifest.load(tiny_root)
    cfg = manifest.config(man, "read-kitti6")
    c = kinds.cell_class("fit")(cfg, manifest.traffic(man, "fit_crops"), 5,
                                "cpu")
    c.setup()
    xyz, params, table, vgg, batches = c.inputs()
    ref = ref_fit.run_steps(params, table, xyz, batches[:3], vgg,
                            lr=cfg["lr"], texture_lr=cfg["texture_lr"],
                            levels=4)
    gaps = compare(c.prog, ref)
    assert gaps["loss1_gap"] < 1e-6 and gaps["grad_gap"] < 1e-3
    assert gaps["change_gap"] < 0.1 and gaps["texture_change_gap"] < 0.1


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -1.0 - 2 ** -12, 3.0e-20])
    r = round_tf32(x)
    assert r.tolist()[:5] == [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -1.0]
    assert abs(r[5] / x[5] - 1) < 2 ** -10
