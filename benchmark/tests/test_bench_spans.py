"""The readers of the program's spans on a hand-made trace of one step:
the forward's spans on the step thread, the backward launched from the
autograd engine's thread while the step thread waits in
``read.backward``, split at the ``read.net_grad`` instant on that
thread, and the optimizer's spans."""

import pytest

from benchmark import manifest, spans
from benchmark.run import Run
from benchmark.trace import DeviceOp, Op, Trace

MS = 1_000_000   # ns

NEW = ("raster_ms.serve", "gather_ms.serve", "device_ops.serve",
       "unet_fwd_ms.fit", "loss_fwd_ms.fit", "loss_bwd_ms.fit",
       "net_bwd_ms.fit", "optimizer_ms.fit", "point_table_ms.fit",
       "forward_idle_ms.fit", "backward_idle_ms.fit", "device_ops.fit")


def _launch(tid, at, corr):
    return Op("cudaLaunchKernel", tid, at * MS, at * MS + MS // 2,
              corr=corr)


def _host(program_spans=True):
    """Thread 1 runs the step; thread 2 is the autograd engine's. Without
    ``program_spans`` the same launches under the benchmark's spans
    alone, as a program without spans gives them."""
    spans_1 = [
        Op("read.forward", 1, 2 * MS, 40 * MS),
        Op("read.raster", 1, 3 * MS, 8 * MS),
        Op("read.gather", 1, 8 * MS, 12 * MS),
        Op("read.unet", 1, 12 * MS, 25 * MS),
        Op("read.loss", 1, 25 * MS, 38 * MS),
        Op("read.backward", 1, 40 * MS, 80 * MS),
        Op("read.optimizer", 1, 82 * MS, 95 * MS),
        Op("read.rmsprop", 1, 83 * MS, 88 * MS),
        Op("read.net_grad", 2, 50 * MS, 50 * MS + 1000),
        Op("read.gather_bwd", 2, 60 * MS, 70 * MS),
    ]
    ops = [
        Op("bench.slice", 1, 0, 100 * MS),
        Op("bench.step", 1, 1 * MS, 99 * MS),
        _launch(1, 4, 1),       # raster
        _launch(1, 9, 2),       # gather
        _launch(1, 13, 3),      # unet
        _launch(1, 26, 4),      # loss
        _launch(1, 41, 5),      # the backward's seed, on the step thread
        _launch(2, 45, 6),      # the loss's backward
        _launch(2, 52, 7),      # the net's backward
        _launch(2, 61, 8),      # the gather's scatter-add
        _launch(2, 72, 9),      # the net's backward
        _launch(1, 84, 10),     # RMSprop
        _launch(1, 90, 11),     # Adam
        _launch(1, 96, 12),     # outside the program's spans
    ]
    return ops + (spans_1 if program_spans else [])


def _device():
    at = {1: (5, 6), 2: (10, 11), 3: (14, 24), 4: (27, 35), 5: (42, 43),
          6: (46, 49), 7: (53, 60), 8: (62, 64), 9: (73, 79),
          10: (85, 86), 11: (91, 93), 12: (96, 97), 99: (200, 210)}
    return [DeviceOp(f"k{c}", s * MS, e * MS, c) for c, (s, e) in at.items()]


def _run(program_spans=True, items=1):
    return Run({}, {}, 0.1, Trace(_host(program_spans), _device()), items)


def test_device_time_during_a_span_counts_every_thread():
    tr = _run().trace
    assert spans.step_tid(tr) == 1
    # the launching thread's chain sees only the seed of the backward
    assert tr.span_device_s("read.backward") == pytest.approx(0.001)
    assert spans.device_s_during(tr, "read.backward") == pytest.approx(
        0.001 + 0.003 + 0.007 + 0.002 + 0.006)
    assert spans.split_device_s(tr, "read.backward", "read.net_grad") \
        == pytest.approx((0.004, 0.015))
    covered = sum(spans.device_s_during(tr, s) for s in (
        "read.forward", "read.backward", "read.optimizer"))
    assert covered == pytest.approx(0.042)
    assert sum(d.end - d.start for d in tr.in_window()) * 1e-9 \
        == pytest.approx(0.043)


def test_idle_time_during_a_span():
    tr = _run().trace
    assert spans.idle_s_during(tr, "read.forward") == pytest.approx(
        0.003 + 0.004 + 0.003 + 0.003 + 0.005)
    assert spans.idle_s_during(tr, "read.backward") == pytest.approx(
        0.002 + 0.003 + 0.004 + 0.002 + 0.009 + 0.001)


@pytest.mark.parametrize("items", [1, 2])
def test_each_new_reader_on_the_hand_made_step(items):
    man = manifest.load()
    want = {"raster_ms.serve": 1.0, "gather_ms.serve": 1.0,
            "device_ops.serve": 12, "unet_fwd_ms.fit": 10.0,
            "loss_fwd_ms.fit": 8.0, "loss_bwd_ms.fit": 4.0,
            "net_bwd_ms.fit": 15.0, "optimizer_ms.fit": 3.0,
            "point_table_ms.fit": 1.0 + 2.0 + 1.0,
            "forward_idle_ms.fit": 18.0, "backward_idle_ms.fit": 21.0,
            "device_ops.fit": 12}
    run = _run(items=items)
    got = {name: manifest.reader(man, name)(run) for name in NEW}
    assert got == pytest.approx({k: v / items for k, v in want.items()})
    # the backward's split adds up to the span's device time
    assert got["loss_bwd_ms.fit"] + got["net_bwd_ms.fit"] == pytest.approx(
        spans.device_s_during(run.trace, "read.backward") / items * 1e3)


def test_a_program_without_spans_reads_none():
    """An older commit's trace: the readers of spans give None and do
    not raise; the count of device operations needs no span."""
    man = manifest.load()
    run = _run(program_spans=False)
    got = {name: manifest.reader(man, name)(run) for name in NEW}
    assert got.pop("device_ops.serve") == got.pop("device_ops.fit") == 12
    assert set(got.values()) == {None}
    assert spans.device_s_during(run.trace, "read.backward") is None
    none = Run({}, {}, 0.1, None, 1)
    assert {manifest.reader(man, name)(none) for name in NEW} == {None}


def test_a_backward_with_no_instant_is_not_split():
    host = [op for op in _host() if op.name != "read.net_grad"]
    tr = Trace(host, _device())
    assert spans.split_device_s(tr, "read.backward", "read.net_grad") \
        is None
    assert manifest.reader(manifest.load(), "loss_bwd_ms.fit")(
        Run({}, {}, 0.1, tr, 1)) is None
