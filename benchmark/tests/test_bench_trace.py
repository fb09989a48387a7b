"""The trace reduction on a hand-made trace: device time by the launching
span and op, the busy union, the idle gaps by what the host did."""

import pytest

from benchmark.trace import DeviceOp, Op, Trace

MS = 1_000_000   # ns


def _trace():
    host = [
        Op("bench.slice", 1, 0, 100 * MS),
        Op("bench.pyramid", 1, 1 * MS, 10 * MS),
        Op("aten::index", 1, 2 * MS, 3 * MS),
        Op("cudaLaunchKernel", 1, 2 * MS, 3 * MS, corr=7),
        Op("cudaLaunchKernel", 1, 5 * MS, 6 * MS, corr=8),
        Op("bench.net", 1, 10 * MS, 90 * MS),
        Op("aten::convolution", 1, 11 * MS, 20 * MS),
        Op("cudaLaunchKernel", 1, 12 * MS, 13 * MS, corr=9),
        Op("cuLaunchKernelEx", 1, 30 * MS, 31 * MS, corr=10),
        Op("aten::copy_", 1, 90 * MS, 99 * MS),
        # the autograd thread: a backward conv outside every span
        Op("aten::convolution_backward", 2, 40 * MS, 50 * MS),
        Op("cudaLaunchKernel", 2, 41 * MS, 42 * MS, corr=11),
    ]
    device = [
        DeviceOp("gather", 4 * MS, 6 * MS, 7),
        DeviceOp("pool", 6 * MS, 8 * MS, 8),
        DeviceOp("cudnn_fwd", 14 * MS, 40 * MS, 9),
        DeviceOp("k2_wgmma", 40 * MS, 60 * MS, 10),
        DeviceOp("cudnn_bwd", 70 * MS, 80 * MS, 11),
        DeviceOp("outside", 200 * MS, 210 * MS, 99),
    ]
    return Trace(host, device)


def test_device_time_goes_to_the_launching_span_and_op():
    tr = _trace()
    assert tr.window_s == pytest.approx(0.1)
    assert tr.span_device_s("bench.pyramid") == pytest.approx(0.004)
    assert tr.span_device_s("bench.net") == pytest.approx(0.046)
    conv = tr.device_s(lambda c: any("convolution" in n for n in c))
    assert conv == pytest.approx(0.036)
    assert tr.launch_chain(tr.device[2]) == [
        "bench.slice", "bench.net", "aten::convolution", "cudaLaunchKernel"]


def test_busy_union_and_idle_gaps():
    tr = _trace()
    assert tr.busy_intervals() == [(4 * MS, 8 * MS), (14 * MS, 60 * MS),
                                   (70 * MS, 80 * MS)]
    assert tr.busy_s == pytest.approx(0.060)
    gaps = dict((k, v) for k, v in tr.idle_gaps())
    # 0-4 ms and the 8-14 ms gap begin in the pyramid span; 60-70 ms in
    # the net span; 80-100 ms in the net span too (the copy starts at 90)
    assert gaps["bench.pyramid/bench.pyramid"] == pytest.approx(0.006)
    assert gaps["bench.slice/bench.slice"] == pytest.approx(0.004)
    assert gaps["bench.net/bench.net"] == pytest.approx(0.030)
    assert sum(gaps.values()) == pytest.approx(tr.window_s - tr.busy_s)
    top = tr.top_device_ops(2)
    assert [name for name, _ in top] == ["cudnn_fwd", "k2_wgmma"]
