"""Device profiling helpers.

Counterpart of ``read_tpu/utils/profiling.py``, whose ``trace`` wraps
``jax.profiler`` and whose ``device_timeit`` times a jitted callable.
Here :func:`trace` records a ``torch.profiler`` trace of a block (the
CPU's operators, and the CUDA device's kernels where the tensors live
on a card) and writes it as a Chrome trace, which Perfetto or
``chrome://tracing`` opens; :func:`device_timeit` times a callable in
its steady state, with CUDA events on a card and ``perf_counter`` on
the CPU.

:func:`span` and :func:`mark` put the program's own ranges into such a
trace: ``read.<what>`` ranges around the work of a layer, on the host
clock that the device operations share, so a reader of the trace can
give each range the device time its launches took. With no profiler
active each costs a check of one flag and records nothing; neither
waits for the device.
"""

from __future__ import annotations

import contextlib
import os
import time

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

__all__ = ["trace", "device_timeit", "span", "mark"]

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records the block as the range ``name``
    while a ``torch.profiler`` (or ``autograd.profiler``) trace is
    active, on the thread that enters it, and does nothing otherwise:

    >>> with span("read.raster"):
    ...     levels = rasterize_pyramid_pooled(...)

    The range is a ``RecordFunction`` of the function scope, as an ATen
    op's is: it nests with the ops inside it and has no device-side
    copy (a ``record_function`` range of the user scope gets one)."""
    return _RecordFunctionFast(name) \
        if _autograd_profiler._is_profiler_enabled else _OFF


def mark(name: str) -> None:
    """A :func:`span` around nothing: an instant (its start) on the
    calling thread; an autograd hook's marks the moment the engine ran
    it."""
    if _autograd_profiler._is_profiler_enabled:
        with _RecordFunctionFast(name):
            pass


@contextlib.contextmanager
def trace(logdir: str):
    """Record a trace of the block and write ``<logdir>/trace.json`` (a
    Chrome trace) when it ends, with the device's activity where CUDA is
    available:

    >>> with trace("runs/tr") as prof:
    ...     train_step(state, xyz, batch)

    Yields the ``torch.profiler.profile``, whose ``key_averages()``
    tabulate the operators."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_timeit(fn, *args, iters: int = 10, warmup: int = 1,
                  device=None) -> dict:
    """Steady-state time of ``fn(*args)``: ``{'mean_ms', 'per_sec'}``
    over ``iters`` calls after ``warmup``. On a CUDA ``device`` (default:
    the current one when CUDA is available) one pair of CUDA events
    brackets the calls, so the time is the device's; else the host's
    ``perf_counter``."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    for _ in range(warmup):
        fn(*args)
    if device.type == "cuda":
        with torch.cuda.device(device):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3 / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        dt = (time.perf_counter() - t0) / iters
    return {"mean_ms": dt * 1e3, "per_sec": 1.0 / dt}
