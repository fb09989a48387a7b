"""Readings that the limits of ``correct`` are set from, many seeds in one
process.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--fault NAME --fault-seeds 7,8,9] \\
        [--seconds 10] [--out FILE.jsonl]

For each of ``--seeds`` the program runs as a benchmark run does (set-up,
a window of ``--seconds``, the program's state freed) and the numbers
that decide ``correct`` are read against the float32 reference. For
each of ``--control-seeds`` the control is read instead: the reference
with every product's operands rounded to TF32, the nearest precision
below the configuration's float32, in the program's place, at the
cell's size. For each of ``--fault-seeds`` the program runs with the
fault ``--fault`` planted (:mod:`benchmark.faults`). One JSON line a
reading goes to standard output and to ``--out``. A benchmark run never
runs this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

__all__ = ["program_readings", "control_readings", "main"]


def _cell(man, name, seed, device):
    from benchmark import kinds, manifest
    cell = manifest.workload(man, name)
    cfg = manifest.config(man, cell["config"])
    traffic = manifest.traffic(man, cell["traffic"])
    return kinds.cell_class(traffic["kind"])(cfg, traffic, seed, device)


def program_readings(man, name: str, seed: int, seconds: float,
                     device) -> dict:
    c = _cell(man, name, seed, device)
    c.setup()
    c.window(seconds)
    c.release()
    return c.readings()


def control_readings(man, name: str, seed: int, device) -> dict:
    return _cell(man, name, seed, device).readings(control="tf32")


def main(argv=None) -> int:
    import torch
    from benchmark import faults, manifest
    from benchmark.run import _caches
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", default=None)
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    _caches(manifest.ROOT)
    man = manifest.load()
    dev = torch.device("cuda", 0)
    jobs = [("program", int(s)) for s in args.seeds.split(",") if s] + \
        [("control", int(s)) for s in args.control_seeds.split(",") if s] + \
        [(args.fault, int(s)) for s in args.fault_seeds.split(",") if s]
    for mode, seed in jobs:
        t0 = time.perf_counter()
        if mode == "control":
            nums = control_readings(man, args.workload, seed, dev)
        elif mode == "program":
            nums = program_readings(man, args.workload, seed, args.seconds,
                                    dev)
        else:
            with faults.planted(mode):
                nums = program_readings(man, args.workload, seed,
                                        args.seconds, dev)
        line = json.dumps({"cell": args.workload, "mode": mode, "seed": seed,
                           "seconds": time.perf_counter() - t0, **nums})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
