"""Timing and metric-accumulation utilities.

The port's copy of ``read_tpu/utils/perform.py``: ``TicToc``, a
wall-clock millisecond timer with a per-name record table, ``AccumDict``,
a running metric dict printed as ``cur (avg)``, and ``Tee``, which
mirrors a stream into a log file. These time host-side stages only; a
device time needs CUDA events or ``torch.profiler``.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np

__all__ = ["TicToc", "AccumDict", "Tee"]


class TicToc:
    """Wall-clock millisecond timer."""

    _records: Dict[str, List[float]] = defaultdict(list)

    def __init__(self):
        self._t0 = None

    def tic(self):
        self._t0 = time.perf_counter()
        return self

    def toc(self) -> float:
        assert self._t0 is not None, "call tic() first"
        return (time.perf_counter() - self._t0) * 1000.0

    def tocp(self, name: str) -> float:
        ms = self.toc()
        TicToc._records[name].append(ms)
        return ms

    @staticmethod
    def print_summary(reset: bool = True):
        rows = []
        for name, vals in TicToc._records.items():
            v = np.asarray(vals)
            rows.append(f"{name:24s} n={len(v):5d} min={v.min():8.2f} "
                        f"mean={v.mean():8.2f} "
                        f"p95={np.percentile(v, 95):8.2f} "
                        f"max={v.max():8.2f} (ms)")
        print("\n".join(rows))
        if reset:
            TicToc._records.clear()


class AccumDict:
    """Running metric accumulator with ``cur (avg)`` formatting."""

    def __init__(self, num_f: int = 3):
        self._dict = defaultdict(list)
        self.num_f = num_f

    def add(self, k, v):
        self._dict[k].append(float(v))

    def update(self, metrics: dict):
        for k, v in metrics.items():
            self.add(k, v)

    def __getitem__(self, k):
        return self._dict[k]

    def mean(self, k) -> float:
        return float(np.mean(self._dict[k]))

    def means(self) -> dict:
        return {k: float(np.mean(v)) for k, v in self._dict.items()}

    def __str__(self):
        parts = []
        for k, v in self._dict.items():
            parts.append(f"{k}: {v[-1]:.{self.num_f}f} "
                         f"({np.mean(v):.{self.num_f}f})")
        return "  ".join(parts)

    def clear(self):
        self._dict.clear()


class Tee:
    """Mirror a stream to a log file."""

    def __init__(self, path: str, stream=None):
        self.file = open(path, "a")
        self.stream = stream or sys.stdout

    def write(self, data):
        self.file.write(data)
        self.stream.write(data)
        self.file.flush()

    def flush(self):
        self.file.flush()
        self.stream.flush()

    def close(self):
        self.file.close()
