"""Drivers of the traffic kinds: ``benchmark/kinds/<kind>.py`` holds
``Cell``, which a traffic file names by its ``kind``.

A ``Cell(config, traffic, seed, device)`` has ``setup()`` (everything
before the measured window, warm-up included), ``window(seconds)`` (the
measured window: its end-to-end values, requests attempted and failed),
``slice()`` (the few requests or steps a traced run profiles, in the
benchmark's spans), ``release()`` (frees the program's state),
``readings()`` (the numbers that decide ``correct``; ``control=<a
precision>`` puts the reference in that precision in the program's
place), ``shape`` (what the per-layer readers count
from) and, after ``setup()``, ``setup_parts`` (seconds by part).
"""

from __future__ import annotations

import importlib

__all__ = ["cell_class"]


def cell_class(kind: str):
    return importlib.import_module(f"benchmark.kinds.{kind}").Cell
