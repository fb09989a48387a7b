"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. The cell, its configuration, its traffic
mix, its limits and its per-layer readers are found by name
(:mod:`benchmark.manifest`). The run makes its inputs from ``--seed``,
sets up (the first run in a checkout also builds the kernels into
``build/kernels``), warms up, measures for ``--seconds``, and with
``--trace 1`` profiles a short slice after the window. After the
window it frees the program's state and holds what the timed path
produced against the plain reference (``benchmark/reference``). The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its
limit, which also end standard error.

It exits with 3, printing no result, where no CUDA device is there or
fewer than the cell asks for, and with 4 where ``jax``, ``jaxlib``,
``flax`` or the JAX package ``read_tpu`` is loaded once the window has
closed.
"""

from __future__ import annotations

import os
import time

_T0 = time.perf_counter()


def _process_age() -> float:
    """Seconds between this process's start and now, from ``/proc``
    (0 where it cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE = _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "read_tpu")
NO_DEVICE, FORBIDDEN_LOADED = 3, 4


def _caches(root: str) -> None:
    """Kernel caches at fixed paths inside the checkout (the port's own
    nvcc builds go to ``build/kernels`` there already)."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "build",
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules(names=None) -> list:
    """Top-level names of loaded modules (or of ``names``) that a run may
    not load, compared whole (``read_tpu_torch`` is not ``read_tpu``)."""
    names = list(sys.modules) if names is None else names
    loaded = {name.split(".", 1)[0] for name in names}
    return sorted(loaded.intersection(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class Run:
    """What a run knows when the per-layer readers read it."""

    def __init__(self, cfg, shape, item_s, trace, items):
        self.cfg = cfg              # the configuration's file
        self.shape = shape          # batch, h, w, net: what flops counts
        self.item_s = item_s        # window seconds a request or step
        self.trace = trace          # benchmark.trace.Trace or None
        self.items = items          # requests or steps in the trace


def run(man: dict, name: str, seed: int, seconds: float, trace: bool,
        device, age: float = 0.0, t_start: float = None) -> dict:
    """One run of cell ``name`` on ``device``: the result's dict (no
    device check here; :func:`main` makes it)."""
    import torch
    from benchmark import kinds, manifest
    from benchmark import trace as T
    t_start = time.perf_counter() if t_start is None else t_start
    cell = manifest.workload(man, name)
    cfg = manifest.config(man, cell["config"])
    traffic = manifest.traffic(man, cell["traffic"])
    limits = manifest.limits(man, name)
    cuda = torch.device(device).type == "cuda"
    c = kinds.cell_class(traffic["kind"])(cfg, traffic, seed, device)
    c.setup()
    setup_peak = 0
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = age + time.perf_counter() - t_start
    print("setup " + " ".join(f"{k} {v:.3f} s" for k, v in
                              c.setup_parts.items())
          + f"; total {setup_s:.3f} s", file=sys.stderr)
    out = c.window(seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    metrics = dict(out["metrics"])
    metrics["setup_s"] = setup_s
    metrics["peak_gib"] = peak / 2 ** 30
    units = {m["name"]: m["unit"] for m in man["end_to_end"]}
    result = {"correct": False, "attempted": out["attempted"],
              "failed": out["failed"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else "cpu"),
                   "count": cell["chips"],
                   "memory_peak_bytes": int(max(setup_peak, peak))
                   if cuda else 0}
    if trace:
        tr = T.profile(c.slice, cuda)
        n = traffic.get("traced_frames", traffic.get("traced_steps"))
        rec = Run(cfg, c.shape, out["item_s"], tr, n)
        per_layer = {}
        for m in manifest.per_layer(man, name):
            value = manifest.reader(man, m["name"])(rec)
            if value is not None:
                per_layer[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = per_layer
        if cuda:
            device_info["busy_s"] = tr.busy_s
            device_info["window_s"] = tr.window_s
        result["device"] = device_info
        result["breakdown"] = {"device_ops": tr.top_device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    else:
        result["metrics"] = {
            m["name"]: {"value": metrics[m["name"]], "unit": units[m["name"]]}
            for m in manifest.end_to_end(man, name)}
        result["device"] = device_info
    c.release()
    if cuda:
        torch.cuda.empty_cache()
    numbers = c.readings()
    result["correct"] = bool(
        out["attempted"] > 0 and out["failed"] == 0
        and set(numbers) == set(limits)
        and all(math.isfinite(v) and v <= limits[k]
                for k, v in numbers.items()))
    # a number that is not finite prints as null: it failed
    result["checks"] = {
        k: {"value": v if math.isfinite(v) else None,
            "limit": limits.get(k)} for k, v in numbers.items()}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import manifest
    _caches(manifest.ROOT)
    man = manifest.load()
    cell = manifest.workload(man, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: cell {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found {found}; no result", file=sys.stderr)
        return NO_DEVICE
    result = run(man, args.workload, args.seed, args.seconds,
                 bool(args.trace), torch.device("cuda", 0), _AGE, _T0)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return FORBIDDEN_LOADED
    for k, v in result["checks"].items():
        ok = v["value"] is not None and v["limit"] is not None \
            and v["value"] <= v["limit"]
        print(f"check {k} {v['value']!r} limit {v['limit']!r} "
              f"{'ok' if ok else 'FAIL'}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
