"""The program's spans (``utils.profiling.span`` and ``mark``) on the CPU.

A tiny training step (``UNet(base_channel=8, num_res=1)``, 2000 points,
B=2 crops of 32x32, VGG on) and a tiny renderer's frame run under
``torch.profiler.profile``. Each ``read.*`` span appears once a step or
frame (``read.gather_bwd`` once a pyramid level), nested as the layers
are; the ``read.net_grad`` instant falls inside ``read.backward``, after
every loss-side backward node and before the net's first; and what the
step and the frame compute is the same bits with and without a profiler.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from read_tpu_torch.criterions import vgg as V
from read_tpu_torch.models.unet import UNet
from read_tpu_torch.pipelines import texture_pipeline as TP
from read_tpu_torch.render import NeuralRenderer
from read_tpu_torch.scene import camera
from read_tpu_torch.utils import ckpt as CK
from read_tpu_torch.utils import profiling

N, B, HW = 2000, 2, (32, 32)
STEP_SPANS = ("read.raster", "read.gather", "read.unet", "read.forward",
              "read.loss", "read.backward", "read.net_grad",
              "read.optimizer", "read.rmsprop")
FRAME_SPANS = ("read.frame", "read.raster", "read.gather", "read.unet",
               "read.download")
NODE = "autograd::engine::evaluate_function: "


def _scene():
    rng = np.random.default_rng(7)
    xyz = rng.uniform(-2, 2, size=(N, 3)).astype(np.float32)
    xyz[:, 2] -= 6.0
    h, w = HW
    K = np.array([[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]])
    poses = []
    for i in range(B):
        pose = np.eye(4)
        pose[0, 3] = 0.2 * i
        poses.append(pose)
    return xyz, K, poses


@pytest.fixture(scope="module")
def fit():
    xyz, K, poses = _scene()
    cfg = TP.config_from_dict({"crop_size": "32x32"})
    state, net = TP.create_state(torch.Generator().manual_seed(0), cfg, N,
                                 net=UNet(base_channel=8, num_res=1),
                                 device="cpu")
    vgg = V.random_vgg_params(torch.Generator().manual_seed(1), "cpu")
    P = camera.gl_projection(K, (HW[1], HW[0]), 0.1, 50.0)
    batch = {"total_m": torch.from_numpy(np.stack(
                 [camera.total_matrix(P, p) for p in poses]).astype(
                 np.float32)),
             "target": torch.rand((B,) + HW + (3,),
                                  generator=torch.Generator().manual_seed(2))}
    return TP.make_train_step(net, cfg, vgg), state, torch.from_numpy(xyz), \
        batch, cfg


@pytest.fixture(scope="module")
def renderer(tmp_path_factory):
    xyz, K, poses = _scene()
    state, _ = TP.create_state(torch.Generator().manual_seed(3),
                               TP.PipelineConfig(crop_size=HW), N,
                               net=UNet(base_channel=8, num_res=1),
                               device="cpu")
    path = str(tmp_path_factory.mktemp("spans") / "ckpt")
    CK.save_checkpoint(path, TP.flat_from_state(state), config={})
    data = {"pointcloud": {"xyz": xyz}, "intrinsic_matrix": K,
            "view_matrix": np.stack(poses), "point_sizes": None,
            "config": {"viewport_size": (HW[1], HW[0])}}
    return NeuralRenderer(data, path, device="cpu"), poses


def _profiled(fn):
    """``(fn's result, host ranges [(name, tid, start, end)])`` of one
    call under ``torch.profiler``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = [(e.name(), e.start_thread_id(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU]
    return out, ranges


def _named(ranges, name):
    return [r for r in ranges if r[0] == name]


def _one(ranges, name):
    found = _named(ranges, name)
    assert len(found) == 1, (name, len(found))
    return found[0]


def _inside(inner, outer):
    return outer[2] <= inner[2] and inner[3] <= outer[3]


def _state_tensors(state):
    return [state.flat_params, *state.texture, state.net_opt.mu,
            state.net_opt.nu, *state.tex_opt.nu,
            *state.batch_stats.values()]


def test_step_spans_appear_once_and_nest(fit):
    step, state, xyz, batch, cfg = fit
    _, ranges = _profiled(lambda: step(state, xyz, batch))
    spans = {name: _one(ranges, name) for name in STEP_SPANS}
    for name in ("read.raster", "read.gather", "read.unet", "read.loss"):
        assert _inside(spans[name], spans["read.forward"]), name
        assert spans[name][1] == spans["read.forward"][1]
    assert _inside(spans["read.rmsprop"], spans["read.optimizer"])
    assert spans["read.raster"][3] <= spans["read.gather"][2] \
        <= spans["read.gather"][3] <= spans["read.unet"][2] \
        <= spans["read.unet"][3] <= spans["read.loss"][2]
    assert spans["read.forward"][3] <= spans["read.backward"][2]
    assert spans["read.backward"][3] <= spans["read.optimizer"][2]
    bwd = _named(ranges, "read.gather_bwd")
    assert len(bwd) == cfg.num_scales
    assert all(_inside(r, spans["read.backward"]) for r in bwd)
    mark = spans["read.net_grad"]
    assert _inside(mark, spans["read.backward"])


def test_net_grad_mark_splits_the_backward(fit):
    """Every loss-side backward node (VGG's pools, VGG's convs on the
    output) ends before the instant; every UNet conv's and the gather's
    begins after it."""
    step, state, xyz, batch, _ = fit
    _, ranges = _profiled(lambda: step(state, xyz, batch))
    t = _one(ranges, "read.net_grad")[2]
    pools = _named(ranges, NODE + "AvgPool2DBackward0")
    gathers = _named(ranges, NODE + "_GatherBackward")
    convs = _named(ranges, NODE + "ConvolutionBackward0")
    assert pools and gathers and convs
    assert all(r[3] <= t for r in pools)
    assert all(r[2] >= t for r in gathers)
    unet, loss = _one(ranges, "read.unet"), _one(ranges, "read.loss")
    fwd = _named(ranges, "aten::convolution")
    unet_convs = sum(_inside(r, unet) for r in fwd)
    loss_convs = sum(_inside(r, loss) for r in fwd)
    before = [r for r in convs if r[3] <= t]
    after = [r for r in convs if r[2] >= t]
    # VGG runs on the output and, without gradient, on the target
    assert len(before) == loss_convs // 2 > 0
    assert len(after) == unet_convs > 0
    assert len(before) + len(after) == len(convs)


def test_step_is_the_same_bits_under_the_profiler(fit):
    step, state, xyz, batch, _ = fit
    plain, plain_metrics = step(state, xyz, batch)
    again, _ = step(state, xyz, batch)
    (traced, traced_metrics), _ = _profiled(lambda: step(state, xyz, batch))
    for a, b, c in zip(_state_tensors(plain), _state_tensors(again),
                       _state_tensors(traced)):
        assert torch.equal(a, b)
        assert torch.equal(a, c)
    for k, v in plain_metrics.items():
        assert torch.equal(v, traced_metrics[k]), k


def test_frame_spans_appear_once_and_nest(renderer):
    r, poses = renderer
    _, ranges = _profiled(lambda: r.infer(poses[1]))
    spans = {name: _one(ranges, name) for name in FRAME_SPANS}
    for name in FRAME_SPANS[1:]:
        assert _inside(spans[name], spans["read.frame"]), name
    assert spans["read.raster"][3] <= spans["read.gather"][2]
    assert spans["read.unet"][3] <= spans["read.download"][2]


def test_pyramid_and_net_are_the_same_bits_under_the_profiler(renderer):
    r, poses = renderer

    def frame():
        pyr = r.pyramid(poses[0])
        return pyr, r.net(*pyr, operands=r.cfg.operands)["im_out"]

    pyr, img = frame()
    (pyr_t, img_t), ranges = _profiled(frame)
    assert [x[0] for x in sorted(ranges, key=lambda x: x[2])
            if x[0].startswith("read.")] == [
        "read.raster", "read.gather", "read.unet"]
    assert all(torch.equal(a, b) for a, b in zip(pyr, pyr_t))
    assert torch.equal(img, img_t)
    np.testing.assert_array_equal(r.infer(poses[0]),
                                  _profiled(lambda: r.infer(poses[0]))[0])


def test_spans_record_only_under_a_profiler():
    assert profiling.span("read.x") is profiling.span("read.y")

    def run():
        with profiling.span("read.x"):
            profiling.mark("read.m")

    run()
    _, ranges = _profiled(run)
    x, m = _one(ranges, "read.x"), _one(ranges, "read.m")
    assert _inside(m, x)
