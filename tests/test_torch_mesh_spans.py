"""The mesh branch's spans and counters on the CPU.

A tiny ``use_mesh`` training step with faces (the benchmark's street
mesh at 2 m quads, 1,680 faces; 2 crops of 32x32; ``UNet(base_channel=8,
num_res=1)``, VGG on) under ``torch.profiler``: ``read.mesh_raster`` and
``read.mesh_sample`` appear once a step, in that order inside
``read.forward`` and before ``read.unet``; the ``read.mesh_grad``
instant falls inside ``read.backward``, after ``read.net_grad``, after
every UNet conv's backward node and before every backward node of the
tables' sample. ``ops.rasterize_mesh.counts`` counts four rasters a view
and their chunks of faces. The step's loss, tables and net are the same
bits with and without a profiler.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from benchmark import scene, street_mesh
from read_tpu_torch.criterions import vgg as V
from read_tpu_torch.models.unet import UNet
from read_tpu_torch.ops import rasterize_mesh as M
from read_tpu_torch.pipelines import texture_pipeline as TP

B, HW = 2, 32
NODE = "autograd::engine::evaluate_function: "


@pytest.fixture(scope="module", autouse=True)
def native_cpu_convs():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@pytest.fixture(scope="module")
def fit():
    verts, faces, uv = street_mesh.street_mesh(
        2.0, 0.01, torch.Generator().manual_seed(5), "cpu")
    cfg = TP.config_from_dict({"use_mesh": True, "texture_size": 64,
                               "reg_weight": 1.0, "crop_size": "32x32"})
    state, net = TP.create_state(torch.Generator().manual_seed(0), cfg,
                                 len(verts),
                                 net=UNet(base_channel=8, num_res=1),
                                 device="cpu")
    vgg = V.random_vgg_params(torch.Generator().manual_seed(1), "cpu")
    K = scene.intrinsics(HW, HW, 24.0)
    P = scene.gl_projection(K, (HW, HW))
    total_m = np.stack([scene.total_matrix(P, v)
                        for v in scene.drive(B, 6.0)]).astype(np.float32)
    batch = {"total_m": torch.from_numpy(total_m), "uv2d": uv,
             "faces": faces,
             "target": torch.rand((B, HW, HW, 3),
                                  generator=torch.Generator().manual_seed(2))}
    return TP.make_train_step(net, cfg, vgg), state, verts, batch, cfg


def _profiled(fn):
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


def test_mesh_spans_appear_once_and_nest(fit):
    step, state, verts, batch, cfg = fit
    _, ranges = _profiled(lambda: step(state, verts, batch))
    spans = {name: _one(ranges, name) for name in (
        "read.forward", "read.mesh_raster", "read.mesh_sample", "read.unet",
        "read.backward", "read.net_grad")}
    for name in ("read.mesh_raster", "read.mesh_sample", "read.unet"):
        assert _inside(spans[name], spans["read.forward"]), name
        assert spans[name][1] == spans["read.forward"][1]
    assert spans["read.mesh_raster"][3] <= spans["read.mesh_sample"][2] \
        <= spans["read.mesh_sample"][3] <= spans["read.unet"][2]
    # the point branch's spans are not on the mesh branch
    assert not _named(ranges, "read.raster")
    assert not _named(ranges, "read.gather")
    marks = _named(ranges, "read.mesh_grad")
    assert len(marks) == cfg.num_scales
    assert all(_inside(r, spans["read.backward"]) for r in marks)
    assert min(r[2] for r in marks) >= spans["read.net_grad"][2]


def test_mesh_grad_mark_splits_the_net_from_the_tables(fit):
    """Every UNet conv's backward node ends before the first instant;
    every backward node of the tables' sample (the ``index_select``
    gathers) starts after it."""
    step, state, verts, batch, _ = fit
    _, ranges = _profiled(lambda: step(state, verts, batch))
    t = min(r[2] for r in _named(ranges, "read.mesh_grad"))
    convs = _named(ranges, NODE + "ConvolutionBackward0")
    gathers = _named(ranges, NODE + "IndexSelectBackward0")
    assert convs and len(gathers) == 4 * 4 * 4   # levels x tables x corners
    assert all(r[3] <= t for r in convs)
    assert all(r[2] >= t for r in gathers)


def test_counters_count_four_rasters_a_view(fit, monkeypatch):
    step, state, verts, batch, cfg = fit
    monkeypatch.setattr(M, "CANDIDATES_PER_CHUNK", 500 * 64)
    monkeypatch.setattr(M, "counts", {"rasters": 0, "chunks": 0})
    step(state, verts, batch)
    n = len(batch["faces"])
    assert M.counts["rasters"] == B * cfg.num_scales
    assert M.counts["chunks"] == B * cfg.num_scales * -(-n // 500)


def _state_tensors(state):
    return [state.flat_params, *state.texture, state.net_opt.mu,
            state.net_opt.nu, *state.tex_opt.nu,
            *state.batch_stats.values()]


def test_the_step_is_the_same_bits_with_and_without_a_profiler(fit):
    step, state, verts, batch, _ = fit
    plain, metrics = step(state, verts, batch)
    (traced, traced_metrics), _ = _profiled(lambda: step(state, verts, batch))
    assert torch.equal(metrics["loss"], traced_metrics["loss"])
    for a, b in zip(_state_tensors(plain), _state_tensors(traced)):
        assert torch.equal(a, b)
