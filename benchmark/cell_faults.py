"""Faults planted in the program under the mesh fit, to show what its
``correct`` catches (:mod:`benchmark.faults` holds the others, which
wrap ``make_train_step``):

- ``corner_weight``: the mesh tables' bilinear sample hands the corner
  ``(x0 + 1, y0 + 1)`` 1% more gradient than its weight (the forward is
  the program's, to the bit);
- ``tie_to_larger``: the triangle raster gives a pixel that two faces
  reach at one depth to the larger face id;
- ``half_views``: the step leaves out half of the batch's views and
  takes the mean over the rest (:mod:`benchmark.faults`' ``half_batch``
  for a mesh batch, whose ``uv2d`` and ``faces`` are not per view).

:func:`planted` puts one in the program for the length of a ``with``
block. Readings with a fault, many seeds in one process::

    python3 -m benchmark.cell_faults --workload street-mesh-fit \\
        --fault corner_weight --seeds 7,8 [--seconds 2] [--out FILE.jsonl]

A benchmark run never plants one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

__all__ = ["FAULTS", "planted", "main"]


def _corner_weight(sample):
    def run(tex, uv):
        out = sample(tex, uv)
        ht, wt, c = tex.shape
        x = ((uv[..., 0] + 1.0) * wt - 1.0) * 0.5
        y = ((uv[..., 1] + 1.0) * ht - 1.0) * 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        xi, yi = x0.to(torch.int32) + 1, y0.to(torch.int32) + 1
        inside = (xi >= 0) & (xi < wt) & (yi >= 0) & (yi < ht)
        lin = (yi.clamp(0, ht - 1) * wt + xi.clamp(0, wt - 1)).long()
        val = tex.reshape(-1, c).index_select(0, lin.reshape(-1)).view(
            *lin.shape, c) * inside.unsqueeze(-1).to(tex.dtype)
        extra = 0.01 * val * ((x - x0) * (y - y0)).unsqueeze(-1)
        return out + (extra - extra.detach())
    return run


def _tie_to_larger(raster):
    def run(verts, faces, total_m, h, w, samples=8):
        index, depth = raster(verts, faces.flip(0), total_m, h, w, samples)
        return torch.where(index >= 0, faces.shape[0] - 1 - index,
                           index), depth
    return run



def _half_views(make):
    def made(*a, **k):
        step = make(*a, **k)

        def run(state, xyz, batch):
            b = batch["target"].shape[0]
            return step(state, xyz, {
                k: v[:max(1, b // 2)] if k in ("total_m", "target") else v
                for k, v in batch.items()})
        return run
    return made


# name -> (module, attribute, wrapper of the attribute)
FAULTS = {
    "corner_weight": ("read_tpu_torch.models.texture",
                      "_bilinear_sample_2d", _corner_weight),
    "tie_to_larger": ("read_tpu_torch.ops.rasterize_mesh", "rasterize_mesh",
                      _tie_to_larger),
    "half_views": ("read_tpu_torch.pipelines.texture_pipeline",
                   "make_train_step", _half_views),
}


@contextlib.contextmanager
def planted(name: str):
    """The program with fault ``name`` in place inside the block."""
    import importlib
    module, attr, wrap = FAULTS[name]
    owner = importlib.import_module(module)
    saved = getattr(owner, attr)
    setattr(owner, attr, wrap(saved))
    try:
        yield
    finally:
        setattr(owner, attr, saved)


def main(argv=None) -> int:
    from benchmark import calibrate, manifest
    from benchmark.run import _caches
    p = argparse.ArgumentParser(description="Readings with a fault planted.")
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", required=True, choices=sorted(FAULTS))
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("cell_faults: no CUDA device", file=sys.stderr)
        return 3
    _caches(manifest.ROOT)
    man = manifest.load()
    for seed in (int(s) for s in args.seeds.split(",") if s):
        t0 = time.perf_counter()
        with planted(args.fault):
            nums = calibrate.program_readings(man, args.workload, seed,
                                              args.seconds,
                                              torch.device("cuda", 0))
        line = json.dumps({"cell": args.workload, "mode": args.fault,
                           "seed": seed,
                           "seconds": time.perf_counter() - t0, **nums})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
