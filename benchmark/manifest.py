"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix;
the configuration's ``file`` holds its sizes, ``benchmark/traffic/<mix>.
json`` the mix's parameters (its ``kind`` names the module that runs it,
``benchmark/kinds/<kind>.py``), ``benchmark/limits/<cell>.json`` the
limits of the numbers that decide ``correct``, and ``benchmark/metrics/
<metric>.py`` each per-layer metric's reader. Adding a cell, a mix, a
configuration or a metric adds files and entries; nothing here names
one.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List

__all__ = ["ROOT", "load", "workload", "config", "traffic", "limits",
           "end_to_end", "per_layer", "reader", "ManifestError"]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class ManifestError(RuntimeError):
    pass


def _json(path: str) -> dict:
    if not os.path.isfile(path):
        raise ManifestError(f"missing file {path}")
    with open(path) as f:
        return json.load(f)


def load(root: str = ROOT) -> dict:
    man = _json(os.path.join(root, "BENCHMARK.json"))
    man["_root"] = root
    return man


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise ManifestError(f"no workload {name!r} in BENCHMARK.json")


def config(man: dict, name: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return _json(os.path.join(man["_root"], c["file"]))
    raise ManifestError(f"no config {name!r} in BENCHMARK.json")


def traffic(man: dict, name: str) -> dict:
    return _json(os.path.join(man["_root"], "benchmark", "traffic",
                              f"{name}.json"))


def limits(man: dict, cell: str) -> Dict[str, float]:
    return _json(os.path.join(man["_root"], "benchmark", "limits",
                              f"{cell}.json"))["limits"]


def end_to_end(man: dict, cell: str) -> List[dict]:
    """The end-to-end metrics cell ``cell`` reports."""
    return [m for m in man["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer(man: dict, cell: str) -> List[dict]:
    """The per-layer metrics cell ``cell`` reports: those that list it,
    and those that list no cells and move an end-to-end metric it
    reports."""
    moved = {m["name"] for m in end_to_end(man, cell)}
    return [m for m in man["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def reader(man: dict, metric: str) -> Callable:
    """``read(run) -> float or None`` of ``benchmark/metrics/<metric>.py``."""
    path = os.path.join(man["_root"], "benchmark", "metrics",
                        f"{metric}.py")
    if not os.path.isfile(path):
        raise ManifestError(f"no reader {path}")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
