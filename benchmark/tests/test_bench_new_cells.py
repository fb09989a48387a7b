"""The cell ``street-mesh-fit``: its entries, the mesh reference's
imports, the mesh readers on a hand-made trace, whole runs at a tiny size
on the CPU (the mesh at 1 m quads) with and without planted faults, the
TF32 control, and, marked ``cuda``, a traced run on the card at full
size."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import calibrate, cell_faults, faults, manifest, spans
from benchmark import run as R
from benchmark import street_mesh
from benchmark.kinds import fit_mesh
from benchmark.run import Run
from benchmark.trace import DeviceOp, Op, Trace

from conftest import ROOT, make_tiny_root

MESH = "street-mesh-fit"
NEW_READERS = ("mesh_raster_ms.fit", "mesh_texture_ms.fit",
               "mesh_raster_roofline.fit")
APPENDED = ("step_ms", "peak_gib", "unet_fwd_ms.fit", "loss_fwd_ms.fit",
            "loss_bwd_ms.fit", "conv_ms.fit", "mfu_pct.fit",
            "device_idle_pct.fit", "forward_idle_ms.fit",
            "backward_idle_ms.fit", "device_ops.fit", "optimizer_ms.fit",
            "net_bwd_ms.fit")
MS = 1_000_000


def tiny(dst: str) -> str:
    """:func:`conftest.make_tiny_root` with the mesh at 1 m quads and a
    64-texel texture, and the new mix cut as the old ones are."""
    root = make_tiny_root(dst)
    bench = os.path.join(root, "benchmark")
    for rel, change in (
            ("configs/read-street-mesh.json",
             dict(mesh_edge_m=1.0, texture_size=64)),
            ("traffic/fit_mesh_crops.json",
             dict(crop=[32, 32], views=6, batch_size=2, inner_batch=2,
                  batches=4, traced_steps=1))):
        path = os.path.join(bench, rel)
        with open(path) as f:
            d = json.load(f)
        d.update(change)
        with open(path, "w") as f:
            json.dump(d, f)
    return root


@pytest.fixture(scope="module")
def tiny_new(tmp_path_factory):
    return tiny(str(tmp_path_factory.mktemp("new_cells")))


def _run(root, cell, trace=False):
    return R.run(manifest.load(root), cell, 2 ** 31 + 77, 0.3, trace, "cpu")


def test_the_new_entries(tiny_new):
    man = manifest.load()
    cells = {w["name"]: w for w in man["workloads"]}
    assert cells[MESH]["chips"] == 1
    assert not any(w["chips"] == 4 for w in man["workloads"])
    cfg = manifest.config(man, "read-street-mesh")
    entry = [c for c in man["configs"] if c["name"] == "read-street-mesh"]
    assert entry[0]["reduced"] == []
    assert street_mesh.counts(cfg["mesh_edge_m"]) == (cfg["mesh_faces"],
                                                      cfg["mesh_vertices"])
    assert (cfg["base_channel"], cfg["num_res"], cfg["num_scales"],
            cfg["texture_size"], cfg["texture_levels"]) == (32, 4, 4, 512, 4)
    assert set(manifest.limits(man, MESH)) == set(fit_mesh.NUMBERS)
    mesh_layers = {m["name"] for m in manifest.per_layer(man, MESH)}
    reported = mesh_layers | {m["name"] for m in manifest.end_to_end(
        man, MESH)}
    assert set(APPENDED) | set(NEW_READERS) <= reported
    for name in NEW_READERS:
        m = [x for x in man["per_layer"] if x["name"] == name][0]
        assert m["workloads"] == [MESH] and m["moves"] == "step_ms"


def test_the_new_reference_imports_nothing_of_the_port():
    for name in ("mesh.py", "mesh_fit.py", "mesh_stages.py"):
        path = os.path.join(ROOT, "benchmark", "reference", name)
        tree = ast.parse(open(path).read(), path)
        tops = {a.name.split(".")[0] for n in ast.walk(tree)
                if isinstance(n, ast.Import) for a in n.names}
        tops |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.level == 0}
        assert not tops & {"read_tpu_torch", *R.FORBIDDEN}, (path, tops)
    code = ("import sys, benchmark.reference.mesh_fit;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & {"read_tpu_torch", *R.FORBIDDEN}


def _mesh_trace(program_spans=True):
    """One step: the rasters and the samples in the forward, the backward
    on the autograd engine's thread split by ``read.net_grad`` and then
    ``read.mesh_grad``, and RMSprop."""
    def launch(tid, at, corr):
        return Op("cudaLaunchKernel", tid, at * MS, at * MS + MS // 2,
                  corr=corr)
    ops = [Op("bench.slice", 1, 0, 100 * MS),
           launch(1, 3, 1), launch(1, 11, 2), launch(1, 21, 3),
           launch(2, 45, 4), launch(2, 55, 5), launch(2, 65, 6),
           launch(1, 85, 7)]
    if program_spans:
        ops += [Op("read.forward", 1, 2 * MS, 38 * MS),
                Op("read.mesh_raster", 1, 2 * MS, 10 * MS),
                Op("read.mesh_sample", 1, 10 * MS, 20 * MS),
                Op("read.unet", 1, 20 * MS, 30 * MS),
                Op("read.backward", 1, 40 * MS, 80 * MS),
                Op("read.net_grad", 2, 50 * MS, 50 * MS + 1000),
                Op("read.mesh_grad", 2, 60 * MS, 60 * MS + 1000),
                Op("read.mesh_grad", 2, 61 * MS, 61 * MS + 1000),
                Op("read.optimizer", 1, 82 * MS, 95 * MS),
                Op("read.rmsprop", 1, 83 * MS, 90 * MS)]
    at = {1: (4, 9), 2: (12, 14), 3: (22, 28), 4: (46, 49), 5: (56, 59),
          6: (66, 70), 7: (86, 87)}
    dev = [DeviceOp(f"k{c}", s * MS, e * MS, c) for c, (s, e) in at.items()]
    return Trace(ops, dev)


@pytest.mark.parametrize("items", [1, 2])
def test_the_mesh_readers_on_a_hand_made_step(items):
    from benchmark import mesh_flops
    man = manifest.load()
    cfg = manifest.config(man, "read-street-mesh")
    shape = dict(batch=8, h=256, w=256, mesh=(1000, 2000), levels=4)
    run = Run(cfg, shape, 0.1, _mesh_trace(), items)
    got = {name: manifest.reader(man, name)(run) for name in NEW_READERS}
    least = mesh_flops.step_bound_s(1000, 2000, 8, 256, 256, 4,
                                    cfg["peak_flops"], cfg["hbm_bytes_s"])
    assert got == pytest.approx({
        "mesh_raster_ms.fit": 5.0 / items,
        "mesh_texture_ms.fit": (2.0 + 4.0 + 1.0) / items,
        "mesh_raster_roofline.fit": 100.0 * least * 1e3 / (5.0 / items)})
    # bytes bound the raster: each input and output once
    assert least == pytest.approx(8 * sum(
        mesh_flops.raster_bytes(1000, 2000, 256 >> i, 256 >> i)
        for i in range(4)) / cfg["hbm_bytes_s"])
    none = Run(cfg, shape, 0.1, _mesh_trace(program_spans=False), 1)
    assert {manifest.reader(man, n)(none) for n in NEW_READERS} == {None}
    assert spans.device_ops(none) == 7


def test_street_mesh_fit_runs_correct(tiny_new):
    res = _run(tiny_new, MESH, trace=True)
    assert res["correct"], res["checks"]
    assert res["device"]["count"] == 1


@pytest.mark.parametrize("planted,fault,number", [
    (faults.planted, "unchanged", "layer_grad_gap"),
    (faults.planted, "texture_doubled", "texture_change_gap"),
    (cell_faults.planted, "corner_weight", "texture_grad_gap")])
def test_street_mesh_fit_faults_fail(tiny_new, planted, fault, number):
    with planted(fault):
        res = _run(tiny_new, MESH)
    assert not res["correct"]
    got = res["checks"][number]
    assert got["value"] is None or got["value"] > got["limit"], got


def test_street_mesh_fit_half_the_views_fails_at_once(tiny_new):
    with cell_faults.planted("half_views"), \
            pytest.raises(RuntimeError, match="triangle rasters"):
        _run(tiny_new, MESH)


def test_street_mesh_fit_control_is_not_correct(tiny_new):
    """The reference with TF32 operands in the program's place: each
    stage's own rounding, which no chaos has grown, is over the layers'
    limits."""
    man = manifest.load(tiny_new)
    limits = manifest.limits(man, MESH)
    nums = calibrate.control_readings(man, MESH, 2 ** 31 + 78, "cpu")
    assert set(nums) == set(limits)
    for k in ("layer_gap", "image_grad_gap"):
        assert nums[k] > limits[k], (k, nums)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    yield torch.device("cuda", 0)
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_street_mesh_fit_traced_on_the_card(card):
    res = R.run(manifest.load(), MESH, 2 ** 31 + 404, 2.0, True, card)
    assert res["correct"], res["checks"]
    layers = res["metrics"]
    for name in NEW_READERS + tuple(a for a in APPENDED
                                    if a not in ("step_ms", "peak_gib")):
        assert layers.get(name, {}).get("value") is not None, name
    assert 0 < layers["mesh_raster_roofline.fit"]["value"] <= 100
