"""On the card, at each cell's own size: the control (the reference with
TF32 operands in the program's place) comes out not correct on three
seeds, and the program correct on one. Skips without a card; run on the
chip with ``python -m pytest benchmark/tests -m cuda``."""

import pytest
import torch

from benchmark import calibrate, manifest

pytestmark = pytest.mark.cuda

CELLS = [w["name"] for w in manifest.load()["workloads"]]
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    yield torch.device("cuda", 0)
    torch.cuda.empty_cache()


def _fails(nums: dict, limits: dict) -> bool:
    return any(not v <= limits[k] for k, v in nums.items())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(dev, cell):
    man = manifest.load()
    limits = manifest.limits(man, cell)
    for seed in SEEDS:
        nums = calibrate.control_readings(man, cell, seed, dev)
        assert set(nums) == set(limits)
        assert _fails(nums, limits), (seed, nums, limits)


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(dev, cell):
    man = manifest.load()
    limits = manifest.limits(man, cell)
    nums = calibrate.program_readings(man, cell, SEEDS[0], 2.0, dev)
    assert not _fails(nums, limits), (nums, limits)
