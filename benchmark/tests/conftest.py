"""Fixtures of the benchmark's own tests: a copy of the benchmark at a
size a CPU test run holds.

    python -m pytest benchmark/tests -q

runs them from the root of the repo; the ones marked ``cuda`` skip
without a card.
"""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the configurations at a width and a depth the CPU holds, and short mixes
TINY_CONFIG = dict(viewport=[64, 32], focal=40.0, points=3000,
                   base_channel=8, num_res=1)
TINY_TRAFFIC = {
    "view": dict(poses=20, check_every=1, check_max=3, warmup_frames=1,
                 traced_frames=2),
    "fit_crops": dict(crop=[32, 32], views=6, batch_size=2, inner_batch=2,
                      batches=4, traced_steps=1),
    "fit_frames": dict(views=4, batches=3, traced_steps=1),
}


def make_tiny_root(dst: str) -> str:
    """A copy of ``BENCHMARK.json`` and ``benchmark/`` under ``dst`` with
    every configuration and mix cut to :data:`TINY_CONFIG` and
    :data:`TINY_TRAFFIC`; the limits as committed."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(dst, "benchmark"), dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(dst, "BENCHMARK.json")) as f:
        man = json.load(f)
    for c in man["configs"]:
        path = os.path.join(dst, c["file"])
        with open(path) as f:
            cfg = json.load(f)
        cfg.update(TINY_CONFIG)
        with open(path, "w") as f:
            json.dump(cfg, f)
    for mix, change in TINY_TRAFFIC.items():
        path = os.path.join(dst, "benchmark", "traffic", f"{mix}.json")
        with open(path) as f:
            t = json.load(f)
        t.update(change)
        with open(path, "w") as f:
            json.dump(t, f)
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(str(tmp_path))

