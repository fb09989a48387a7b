"""A whole run at a tiny size on the CPU, the look for a card skipped, with
the timed path broken underneath: ``correct`` has to come out false for
each fault the cell can have, and true without one. (One card: no
exchange between chips to leave out.)"""

import pytest

from benchmark import faults, manifest
from benchmark import run as R


def _run(root, cell):
    return R.run(manifest.load(root), cell, 2 ** 31 + 77, 0.3, False, "cpu")


@pytest.mark.parametrize("cell", ["kitti6-view", "kitti6-fit",
                                  "kitti10m-fit"])
def test_sound_run_is_correct(tiny_root, cell):
    res = _run(tiny_root, cell)
    assert res["correct"], res["checks"]


def test_view_frame_altered(tiny_root):
    """An answer altered where it is produced: a patch of each frame."""
    with faults.planted("frame_altered"):
        res = _run(tiny_root, "kitti6-view")
    gap = res["checks"]["frame_gap"]
    assert not res["correct"]
    assert gap["value"] is None or gap["value"] > gap["limit"]


# kitti10m-fit steps at batch 1: it has no half batch to leave out
@pytest.mark.parametrize("cell,fault", [
    ("kitti6-fit", "unchanged"), ("kitti6-fit", "half_batch"),
    ("kitti6-fit", "texture_doubled"), ("kitti10m-fit", "unchanged"),
    ("kitti10m-fit", "texture_doubled")])
def test_fit_fault_fails(tiny_root, cell, fault):
    with faults.planted(fault):
        res = _run(tiny_root, cell)
    assert not res["correct"]
    assert any(v["value"] is None or v["value"] > v["limit"]
               for v in res["checks"].values())
