"""A profiled slice of a run, reduced to what the per-layer metrics read.

:func:`profile` runs a function under ``torch.profiler`` (CPU and CUDA
activities) inside the span ``bench.slice``, which ends in a
synchronize. :class:`Trace` then holds

- the host's operations and spans on each thread, nested by time;
- each device operation (kernel, copy, set) with the host operation
  that launched it: the CUDA runtime call of the same correlation id,
  and the chain of host operations around that call on its thread;
- the slice's window (the ``bench.slice`` span) and the device's busy
  time in it (the union of the device operations' intervals).

Spans are the benchmark's own ``record_function`` ranges, named
``bench.<what>``; nothing here needs spans inside the program.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["Op", "DeviceOp", "Trace", "profile", "from_kineto"]

SLICE = "bench.slice"


@dataclasses.dataclass
class Op:
    """A host operation or span: ``[start, end]`` ns on thread ``tid``."""
    name: str
    tid: int
    start: int
    end: int
    corr: int = 0           # the runtime call's correlation id, if any
    parent: Optional[int] = None


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: int
    end: int
    corr: int               # its runtime call's correlation id


def _is_runtime(name: str) -> bool:
    """A CUDA runtime or driver call (``cudaLaunchKernel``,
    ``cuLaunchKernelEx``, ``cudaMemcpyAsync``...)."""
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())


class Trace:
    def __init__(self, host: Sequence[Op], device: Sequence[DeviceOp]):
        self.ops = sorted(host, key=lambda o: (o.tid, o.start, -o.end))
        self.device = sorted(device, key=lambda d: d.start)
        self._threads: Dict[int, List[int]] = defaultdict(list)
        stack: List[int] = []
        tid = None
        for i, op in enumerate(self.ops):
            if op.tid != tid:
                tid, stack = op.tid, []
            while stack and self.ops[stack[-1]].end < op.start:
                stack.pop()
            op.parent = stack[-1] if stack else None
            stack.append(i)
            self._threads[op.tid].append(i)
        self._starts = {t: [self.ops[i].start for i in idx]
                        for t, idx in self._threads.items()}
        self._runtime = {op.corr: i for i, op in enumerate(self.ops)
                         if op.corr and _is_runtime(op.name)}
        slices = [o for o in self.ops if o.name == SLICE]
        if slices:
            self.t0, self.t1 = slices[0].start, slices[-1].end
        elif self.device:
            self.t0, self.t1 = self.device[0].start, self.device[-1].end
        else:
            self.t0 = self.t1 = 0

    # -- host side ---------------------------------------------------------
    def chain_at(self, tid: int, t: int) -> List[str]:
        """Names of the host ops that contain time ``t`` on thread ``tid``,
        outermost first."""
        starts = self._starts.get(tid)
        if not starts:
            return []
        i = bisect.bisect_right(starts, t) - 1
        if i < 0:
            return []
        j = self._threads[tid][i]
        names = []
        while j is not None:
            op = self.ops[j]
            if op.start <= t <= op.end:
                names.append(op.name)
            j = op.parent
        return names[::-1]

    def launch_chain(self, d: DeviceOp) -> List[str]:
        """The host ops around the call that launched ``d``."""
        i = self._runtime.get(d.corr)
        if i is None:
            return []
        op = self.ops[i]
        return self.chain_at(op.tid, op.start)

    # -- device side -------------------------------------------------------
    def in_window(self) -> List[DeviceOp]:
        return [d for d in self.device
                if d.end > self.t0 and d.start < self.t1]

    def device_s(self, where: Callable[[List[str]], bool]) -> float:
        """Seconds of device operations in the window whose launching
        chain satisfies ``where``."""
        return sum(d.end - d.start for d in self.in_window()
                   if where(self.launch_chain(d))) * 1e-9

    def span_device_s(self, span: str) -> float:
        return self.device_s(lambda chain: span in chain)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for d in self.in_window():
            s, e = max(d.start, self.t0), min(d.end, self.t1)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def top_device_ops(self, n: int = 10) -> List[list]:
        total: Dict[str, int] = defaultdict(int)
        for d in self.in_window():
            total[d.name[:160]] += d.end - d.start
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns * 1e-9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The device's idle time in the window by what the host was doing
        when each gap began: the innermost span of the slice's thread and
        the innermost host op on any thread (the deepest), the largest
        ``n``."""
        slices = [o for o in self.ops if o.name == SLICE]
        tid = slices[0].tid if slices else None
        edges, last = [], self.t0
        for s, e in self.busy_intervals():
            if s > last:
                edges.append((last, s))
            last = max(last, e)
        if self.t1 > last:
            edges.append((last, self.t1))
        total: Dict[str, int] = defaultdict(int)
        for s, e in edges:
            spans = [c for c in (self.chain_at(tid, s) if tid is not None
                                 else []) if c.startswith("bench.")]
            chains = [self.chain_at(t, s) for t in self._threads]
            deepest = max(chains, key=len, default=[])
            label = "/".join(x for x in (spans[-1] if spans else "",
                                         deepest[-1] if deepest else "")
                             if x) or "(no host op)"
            total[label[:160]] += e - s
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns * 1e-9] for name, ns in top]


def from_kineto(events) -> Trace:
    """A :class:`Trace` of a finished ``torch.profiler.profile``'s
    kineto events (``prof.profiler.kineto_results.events()``)."""
    from torch.autograd import DeviceType
    host, device = [], []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if e.start_thread_id() != e.end_thread_id():
                continue            # async ranges do not nest
            host.append(Op(name, int(e.start_thread_id()), int(e.start_ns()),
                           int(e.end_ns()), int(e.correlation_id())
                           if _is_runtime(name) else 0))
        elif e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or name.startswith("bench."):
                continue            # the spans' device-side copies
            device.append(DeviceOp(name, int(e.start_ns()), int(e.end_ns()),
                                   int(e.correlation_id())))
    return Trace(host, device)


def profile(fn: Callable[[], None], cuda: bool = True) -> Trace:
    """Run ``fn`` once under the profiler, inside the ``bench.slice``
    span, which ends when the device has finished (``cuda=False``: the
    host alone, for the CPU tests)."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as _profile
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with _profile(activities=activities) as prof:
        with record_function(SLICE):
            fn()
            if cuda:
                torch.cuda.synchronize()
    return from_kineto(prof.profiler.kineto_results.events())
