"""Metric-accumulation and logging utilities.

The port's copy of ``read_tpu/utils/perform.py``, less its host-clock
timer ``TicToc``: ``AccumDict``, a running metric dict printed as ``cur
(avg)``, and ``Tee``, which mirrors a stream into a log file. Device
time comes from ``torch.profiler`` (``utils.profiling``: ``trace`` and
the program's ``span`` ranges) or CUDA events (``device_timeit``).
"""

from __future__ import annotations

import sys
from collections import defaultdict

import numpy as np

__all__ = ["AccumDict", "Tee"]


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
