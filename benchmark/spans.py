"""The program's own spans in a traced slice, as the per-layer readers
take them.

The port records ``read.<what>`` ranges (``read_tpu_torch.utils.
profiling.span``) around the work of its layers, and the instant
``read.net_grad`` (``mark``) when the output image's gradient is
complete. This module turns them into device time, idle time and counts
with :class:`benchmark.trace.Trace`'s public attributes alone.

The *step thread* is the thread that holds ``bench.slice``. A span on
it may launch work from another thread: the autograd engine runs a
card's backward on a thread of its own while the step thread waits
inside ``torch.autograd.grad``. So :func:`device_s_during` gives a span
the device operations whose launching runtime call started while the
step thread was inside the span, whichever thread made the call, and
:func:`split_device_s` cuts those at the first instant of a mark inside
each of the span's intervals. A span whose work is launched on its own
thread keeps ``Trace.span_device_s``.

A program without the spans (an older commit) gives None from every
function here that reads one, and never raises.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from benchmark.trace import SLICE, Op

__all__ = ["step_tid", "intervals", "instants", "launches",
           "device_s_during", "split_device_s", "idle_s_during",
           "span_ms", "split_ms", "idle_ms", "device_ops"]

Interval = Tuple[int, int]


def step_tid(trace) -> Optional[int]:
    """The thread that holds ``bench.slice``, or None."""
    for op in trace.ops:
        if op.name == SLICE:
            return op.tid
    return None


def intervals(trace, span: str) -> List[Interval]:
    """``[start, end]`` ns of each range ``span`` on the step thread, in
    time order (empty where the step thread or the span is missing)."""
    tid = step_tid(trace)
    return sorted((op.start, op.end) for op in trace.ops
                  if op.name == span and op.tid == tid)


def instants(trace, name: str) -> List[int]:
    """The start, ns, of each range ``name`` on any thread, in order."""
    return sorted(op.start for op in trace.ops if op.name == name)


def launches(trace) -> Dict[int, Op]:
    """Each correlation id's runtime call (the earliest, should two host
    ops carry one)."""
    out: Dict[int, Op] = {}
    for op in trace.ops:
        if op.corr and (op.corr not in out
                        or op.start < out[op.corr].start):
            out[op.corr] = op
    return out


def _inside(spans: List[Interval], t: int) -> Optional[int]:
    """The index of the interval of ``spans`` (sorted, disjoint) that
    holds ``t``, or None."""
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i if i >= 0 and spans[i][0] <= t <= spans[i][1] else None


def device_s_during(trace, span: str) -> Optional[float]:
    """Seconds of the window's device operations launched, from any
    thread, while the step thread was inside ``span``; None where the
    span is not in the trace."""
    spans = intervals(trace, span)
    if not spans:
        return None
    calls = launches(trace)
    ns = 0
    for d in trace.in_window():
        op = calls.get(d.corr)
        if op is not None and _inside(spans, op.start) is not None:
            ns += d.end - d.start
    return ns * 1e-9


def split_device_s(trace, span: str, mark: str
                   ) -> Optional[Tuple[float, float]]:
    """``(before, after)``: :func:`device_s_during`'s seconds of ``span``
    split at the first instant ``mark`` inside each of its intervals
    (before it, and at or after it). None where the span is missing or
    an interval holds no such instant."""
    spans = intervals(trace, span)
    if not spans:
        return None
    cuts = []
    marks = instants(trace, mark)
    for s, e in spans:
        j = bisect.bisect_left(marks, s)
        if j == len(marks) or marks[j] > e:
            return None
        cuts.append(marks[j])
    calls = launches(trace)
    before = after = 0
    for d in trace.in_window():
        op = calls.get(d.corr)
        i = None if op is None else _inside(spans, op.start)
        if i is None:
            continue
        if op.start < cuts[i]:
            before += d.end - d.start
        else:
            after += d.end - d.start
    return before * 1e-9, after * 1e-9


def idle_s_during(trace, span: str) -> Optional[float]:
    """Seconds inside ``span``'s intervals on the step thread (within the
    slice's window) in which no operation ran on the device; None where
    the span is missing or the device ran nothing."""
    spans = intervals(trace, span)
    busy = trace.busy_intervals()
    if not spans or not busy:
        return None
    idle, last = [], trace.t0
    for s, e in busy:
        if s > last:
            idle.append((last, s))
        last = max(last, e)
    if trace.t1 > last:
        idle.append((last, trace.t1))
    ns = 0
    for s, e in spans:
        for a, b in idle:
            ns += max(0, min(e, b) - max(s, a))
    return ns * 1e-9


def span_ms(run, span: str) -> Optional[float]:
    """Device ms an item (frame or step) launched under ``span`` on its
    own thread (``Trace.span_device_s``); None where the trace lacks the
    span or the device ran nothing."""
    if run.trace is None or not run.trace.in_window() or \
            not any(op.name == span for op in run.trace.ops):
        return None
    return run.trace.span_device_s(span) / run.items * 1e3


def split_ms(run, span: str, mark: str) -> Optional[Tuple[float, float]]:
    """:func:`split_device_s` in ms an item; None where it is None or the
    device ran nothing in the span."""
    split = None if run.trace is None else split_device_s(run.trace, span,
                                                          mark)
    if split is None or sum(split) <= 0:
        return None
    return tuple(s / run.items * 1e3 for s in split)


def idle_ms(run, span: str) -> Optional[float]:
    """:func:`idle_s_during` in ms an item."""
    s = None if run.trace is None else idle_s_during(run.trace, span)
    return None if s is None else s / run.items * 1e3


def device_ops(run) -> Optional[float]:
    """Device operations (kernels, copies, sets) an item in the slice;
    None where the device ran nothing."""
    if run.trace is None:
        return None
    n = len(run.trace.in_window())
    return n / run.items if n else None
