"""The kernel bench's arithmetic and control flow, on the CPU.

Its bounds are checked against reckonings done by hand (the larger of
flops over the card's peak and bytes over 3.35 TB/s); its rows run at a
tiny size with the CUDA timer stubbed, so every row's kernel wrapper
(the twin, on a CPU tensor), comparison and cost is exercised; without a
card its entry point refuses to run.
"""

import pytest
import torch

from read_tpu_torch import kernel_bench as KB
from read_tpu_torch.ops import gated_conv_probe as GP


def test_bounds_match_hand_reckonings():
    # each K2/K7 bench shape: 2*H*W*Cin*2Cout*9 = 16.5 GFLOP
    for h, w, c in KB.CONV_SHAPES:
        flops, nbytes = KB.conv_cost((1, h, w, c), 3, 1, 2 * c, c)
        assert flops == pytest.approx(16.5e9, rel=0.01)
        assert KB.bound(flops, nbytes) == (pytest.approx(0.2462, rel=1e-3),
                                           "operations")
        # bf16: 0.0167 ms of tensor-core work; at 368x1216x32 the 115 MB
        # of f32 activations (0.034 ms) bound it instead
        assert KB.bound(flops, 0, bf16=True)[0] == pytest.approx(
            0.0167, rel=0.01)
        assert KB.bound(flops, nbytes, bf16=True)[0] >= KB.bound(
            flops, 0, bf16=True)[0]
    # K4 cat11_aff0: 27.5 GFLOP, 916 MB -> 0.41 ms, bound by operations
    flops, nbytes = KB.conv_cost((1, 368, 1216, 480), 1, 1, 64, 32)
    assert (flops, nbytes) == (pytest.approx(27.5e9, rel=0.01),
                               pytest.approx(916e6, rel=0.01))
    assert KB.bound(flops, nbytes) == (pytest.approx(0.41, rel=0.01),
                                       "operations")
    # K4 cat11_convs2: 3.67 GFLOP, 172 MB -> 0.055 ms
    flops, nbytes = KB.conv_cost((1, 368, 1216, 64), 1, 1, 64, 32)
    assert KB.bound(flops, nbytes)[0] == pytest.approx(0.055, rel=0.01)
    # a strided conv counts its input at full size, its output at half
    flops, nbytes = KB.conv_cost((1, 8, 8, 4), 4, 2, 6, 3, res=True)
    assert flops == 2 * 16 * 16 * 4 * 6
    assert nbytes == 4 * (256 + 16 * 4 * 6) + 4 * 12 + 4 * 16 * 3 * 2


def test_rows_run_and_compare_at_a_tiny_size(monkeypatch):
    monkeypatch.setattr(KB, "N_POINTS", 6000)
    monkeypatch.setattr(KB, "HW", (24, 40))
    monkeypatch.setattr(KB, "CONV_SHAPES", ((10, 12, 32), (6, 8, 64)))
    monkeypatch.setattr(KB, "SCM_SITES", (("SCM2", 6, 8, (8, 56)),))
    monkeypatch.setattr(KB, "CAT_PROBES",
                        (("cat11_aff0", 6, 8, (32, 64, 128, 256), 32),))
    # nopack has no output, so no CPU twin: its rows need the card
    monkeypatch.setattr(GP, "MODES", ("full", "packonly", "nowin"))
    monkeypatch.setattr(KB, "event_ms", lambda fn, iters=10, warmup=2:
                        (fn(), 1.0)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    rows, launches = KB.run(torch.device("cpu"), echo=None)
    by = {}
    for r in rows:
        by[r["kernel"]] = by.get(r["kernel"], 0) + 1
        assert r["bound_ms"] > 0 and r["bound_by"] in ("bytes",
                                                       "operations")
    assert by == {"zbuffer": 3, "zbuffer_exact": 3, "zbuffer_keys": 3,
                  "gated_conv_kxk": 4, "gated_conv3x3_r2": 4,
                  "gated_conv_1x1": 4, "gated_conv1x1_r2": 4,
                  "gated_conv_probe": 12, "gated_conv_1x1_cat": 4}
    assert all(v == 0 for v in launches.values())   # twins on the CPU
    assert all(r["max_abs_err"] == 0.0 for r in rows
               if r["group"] == "zbuffer")


def test_event_ms_divides_back_to_back_calls(monkeypatch):
    """Each timed pair of events encloses ``iters`` calls and one call
    runs before the start event; the result is per call."""
    calls = []

    class Event:   # elapsed time: 1 ms per call between the two records
        def __init__(self, enable_timing):
            assert enable_timing

        def record(self):
            self.at = len(calls)

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return float(end.at - self.at)

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    assert KB.event_ms(lambda: calls.append(1), iters=7, warmup=2,
                       reps=3) == 1.0
    assert len(calls) == 2 + 3 * (1 + 7)


def test_entry_point_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KB.main([])
