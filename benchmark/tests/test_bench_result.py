"""The run's last line, and a run without a card."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import manifest
from benchmark import run as R

from conftest import ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", ["kitti6-view", "kitti6-fit"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(tiny_root, cell, trace):
    """The keys a result line carries, in order, ``breakdown`` when traced and
    ``checks`` last; every check beside its limit."""
    man = manifest.load(tiny_root)
    res = R.run(man, cell, 2 ** 32 + 11, 0.2, trace, "cpu")
    assert list(res) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    json.dumps(res, allow_nan=False)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    limits = manifest.limits(man, cell)
    assert set(res["checks"]) == set(limits)
    for k, v in res["checks"].items():
        assert v == {"value": v["value"], "limit": limits[k]}
    want = ({m["name"] for m in manifest.per_layer(man, cell)} if trace
            else {m["name"] for m in manifest.end_to_end(man, cell)})
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == want
        for k, v in res["metrics"].items():
            assert set(v) == {"value", "unit"}
            # a CPU run reads no device memory
            assert v["value"] > 0 or k == "peak_gib"
    else:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_without_a_card_it_exits_and_prints_no_result():
    """No CUDA device here: the command fails and never runs the cell on
    the CPU."""
    if _has_card():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "kitti6-view",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == R.NO_DEVICE
    assert proc.stdout.strip() == ""
    assert "needs 1 CUDA device" in proc.stderr


def test_without_the_program_it_fails(tmp_path):
    """A directory with only ``BENCHMARK.json`` and ``benchmark/`` cannot
    run a cell."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.calibrate", "--workload",
         "kitti6-view", "--seeds", "1"] if _has_card() else
        [sys.executable, "-c",
         "from benchmark import run as R, manifest; "
         "R.run(manifest.load(), 'kitti6-view', 1, 0.1, False, 'cpu')"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "read_tpu_torch" in proc.stderr


def _has_card() -> bool:
    import torch
    return torch.cuda.is_available()
