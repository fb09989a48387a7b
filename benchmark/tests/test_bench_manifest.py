"""``BENCHMARK.json`` against its format rules, and every file it names."""

import json
import os
import re

import pytest

from benchmark import kinds, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    return manifest.load()


def test_keys_and_limits(man):
    assert set(man) - {"_root"} == {"command", "paths", "run_seconds",
                                   "configs", "workloads", "end_to_end",
                                   "per_layer"}
    assert isinstance(man["run_seconds"], int)
    assert 1 <= man["run_seconds"] <= 51
    assert 1 <= len(man["paths"]) <= 16 and 1 <= len(man["command"]) <= 32
    for p in man["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert not p.endswith("_torch")
    for word in man["command"]:
        assert LINE.match(word) and not word.startswith("/")
    assert os.path.getsize(os.path.join(man["_root"], "BENCHMARK.json")) \
        <= 64 * 1024


def test_entries_have_just_their_keys(man):
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(tuple(p + "/" for p in man["paths"]))
    cells = {w["name"] for w in man["workloads"]}
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert LINE.match(m["layer"])
    for m in man["end_to_end"] + man["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
    names = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(names) == len(set(names))
    setup = [m for m in man["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]


def test_every_cell_resolves(man):
    e2e = {m["name"] for m in man["end_to_end"]}
    for w in man["workloads"]:
        cfg = manifest.config(man, w["config"])
        traffic = manifest.traffic(man, w["traffic"])
        assert kinds.cell_class(traffic["kind"])
        assert cfg["peak_flops"] > 0 and cfg["hbm_bytes_s"] > 0
        assert manifest.limits(man, w["name"])
        reported = {m["name"] for m in manifest.end_to_end(man, w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        layers = manifest.per_layer(man, w["name"])
        assert layers
        for m in layers:
            assert m["moves"] in reported and m["moves"] in e2e
            assert callable(manifest.reader(man, m["name"]))
    used = {w["config"] for w in man["workloads"]}
    assert used == {c["name"] for c in man["configs"]}


def test_a_cell_of_new_files_alone_is_found_and_runs(tiny_root):
    """A cell, a mix, its limits and a per-layer metric added as new files
    and entries, with no file of the harness edited."""
    root = tiny_root
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        man = json.load(f)
    man["workloads"].append({"name": "kitti6-view-short", "config":
                             "read-kitti6", "traffic": "view_short",
                             "chips": 1, "why": "a dummy cell"})
    man["per_layer"].append({
        "name": "dummy_ms.serve", "unit": "ms", "better": "lower",
        "source": "host_clock", "layer": "device", "moves": "frame_ms",
        "workloads": ["kitti6-view-short"]})
    with open(path, "w") as f:
        json.dump(man, f)
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "traffic", "view.json")) as f:
        mix = json.load(f)
    mix["poses"] = 8
    with open(os.path.join(bench, "traffic", "view_short.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(bench, "limits", "kitti6-view.json")) as f:
        limits = f.read()
    with open(os.path.join(bench, "limits", "kitti6-view-short.json"),
              "w") as f:
        f.write(limits)
    with open(os.path.join(bench, "metrics", "dummy_ms.serve.py"), "w") as f:
        f.write("def read(run):\n    return run.item_s * 1e3\n")

    from benchmark import run as R
    m = manifest.load(root)
    assert [x["name"] for x in manifest.per_layer(m, "kitti6-view-short")] \
        == ["dummy_ms.serve"]
    res = R.run(m, "kitti6-view-short", 2 ** 31 + 5, 0.2, True, "cpu")
    assert res["correct"] is True
    assert res["metrics"]["dummy_ms.serve"]["value"] > 0
