"""The port's kernel bench: each hand-written kernel beside its plain
twin, a library yardstick and its bound, on the card.

    python -m read_tpu_torch.kernel_bench [--out FILE.json]

The counterpart of the JAX package's kernel benches, one group each:

- ``zbuffer`` (``scripts/bench_r4_probe.py`` ``probe_pzb2``): K1 (fused
  projection), K5 and K6 (on the frame's packed keys, and on keys with
  every position 4 times: heavy ties), 1M points, 1216x368, B=1 and 2;
- ``convs`` (``scripts/bench_gated_conv.py``): K7 3x3 beside K2 and K7
  1x1 beside K3 at ``(368, 1216, 32->32)``, ``(184, 608, 64->64)``,
  ``(92, 304, 128->128)``, ``(46, 152, 256->256)``, f32 and bf16;
- ``probe`` (``scripts/probe_pack_split.py``): K8's four modes at the
  same four shapes, f32 and bf16 (K8 runs K2's old tile loops, so its
  bf16 ``full`` rows are the old bf16 loop beside the ``convs`` group's
  K2 bf16 rows, which run the wgmma loop);
- ``cat`` (``scripts/probe_pack_new.py`` ``cat11_*``): K4 at the three
  SCM sites of the serving frame and at ``cat11_convs2`` (32+32->32) and
  ``cat11_aff0`` (32+64+128+256->32), 1216x368, f32 and bf16.

Each row gives the kernel's device time (:func:`event_ms`: CUDA events
around back-to-back calls), the twin's, the
library call's where one PyTorch call computes the function or its main
part (``scatter_reduce_`` amin for the z-buffers; ``F.conv2d`` without
the epilogue for K2, K7 3x3 and K8 full; ``torch.matmul`` on a
pre-concatenated input for K3, K4 and K7 1x1; the port never calls
them), the bound (the larger of operations over the card's peak for
their type and bytes over 3.35 TB/s, each input read once and each
output written once; see :func:`bound`) and kernel/bound. Every kernel
is held against its twin as it goes (z-buffers and K8 ``packonly``
bit-equal; f32 within ``F32_TOL``; K2/K3/K4 bf16 operands within
``BF16_TOL`` and ``F32_TOL``: same rounded operands, f32 sums; K7's bf16
output within ``BF16_OUT_TOL``: one f32 sum rounded to bf16 once, so at
most one bf16 ulp apart); a mismatch raises. TF32 is off. Without a
CUDA device it raises.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from read_tpu_torch.frame import frame_inputs
from read_tpu_torch.ops import gated_conv as GC
from read_tpu_torch.ops import gated_conv_probe as GP
from read_tpu_torch.ops import gated_conv_r2 as R2
from read_tpu_torch.ops import rasterize_kernels as RK

__all__ = ["bound", "conv_cost", "library_conv",
           "zbuffer_yardsticks", "run", "main"]

F32_TOL = dict(atol=2e-5, rtol=1e-4)     # tests/test_unet_pallas.py
BF16_TOL = dict(atol=0.35, rtol=0.05)    # same file, bf16 operands
# a bf16 output: one ulp is at most 2**-7 of the value (< rtol), atol for
# values near 0
BF16_OUT_TOL = dict(atol=1e-3, rtol=1e-2)
# NVIDIA H100 SXM data sheet, dense: f32 off the tensor cores, bf16 on
# them, HBM3 bandwidth
PEAK_F32, PEAK_BF16, HBM_BYTES_S = 67e12, 989e12, 3.35e12
# flops of one point's projection in one view (4 row dots of 3 mul + 3
# add, 3 divides, depth and pixel mapping ~9)
PROJECT_FLOPS = 4 * 6 + 3 + 9
N_POINTS, HW = 1_000_000, (368, 1216)
CONV_SHAPES = ((368, 1216, 32), (184, 608, 64), (92, 304, 128),
               (46, 152, 256))
# the SCM BasicConv_4 sites of the full-width frame: (name, h, w, cins)
SCM_SITES = (("SCM2", 184, 608, (8, 56)), ("SCM1", 92, 304, (8, 120)),
             ("SCM0", 46, 152, (8, 248)))
CAT_PROBES = (("cat11_convs2", 368, 1216, (32, 32), 32),
              ("cat11_aff0", 368, 1216, (32, 64, 128, 256), 32))


class BenchFailure(RuntimeError):
    pass


def bound(flops: float, nbytes: float, bf16: bool = False):
    """``(ms, 'operations' | 'bytes')``: the least time the card could
    take, the larger of ``flops`` at the f32 (or bf16 tensor-core) peak
    and ``nbytes`` at the HBM rate, and which of the two it is."""
    t_ops = flops / (PEAK_BF16 if bf16 else PEAK_F32) * 1e3
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def conv_cost(x_shape, k: int, stride: int, c2: int, cout: int,
              in_bytes: int = 4, out_bytes: int = 4,
              res: bool = False, epilogue: bool = True):
    """``(flops, bytes)`` of one k x k conv of ``x [B, H, W, Cin]`` to C2
    sums (``cout`` outputs): ``2 * pixels_out * k*k*Cin * C2`` flops;
    the input, weights, bias/scale/offset, residual read once and the
    output written once."""
    b, h, w, cin = x_shape
    pad = (k - 1) // 2
    npix = b * ((h + 2 * pad - k) // stride + 1) \
        * ((w + 2 * pad - k) // stride + 1)
    flops = 2.0 * npix * k * k * cin * c2
    nbytes = (in_bytes * (b * h * w * cin + k * k * cin * c2)
              + (4 * (c2 + 2 * cout) if epilogue else 0)
              + out_bytes * npix * cout + (4 * npix * cout if res else 0))
    return flops, nbytes


def event_ms(fn: Callable, iters: int = 10, warmup: int = 2,
             reps: int = 3) -> float:
    """Device time of one ``fn()`` in ms: ``iters`` calls back to back
    between one pair of CUDA events, divided by ``iters``; the median of
    ``reps`` such pairs. One more call queued before the start event
    keeps the device busy while the host launches the first timed call,
    so the host's launch path (ctypes, checks, the launch itself) hides
    behind the device's work wherever a call's device time is the longer
    of the two."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        fn()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def max_err(name: str, got, want, tols) -> float:
    """Max |got - want|; raises unless finite, same shape and within
    every tolerance in ``tols`` (``None``: bit-equal); tuples of outputs
    are compared element by element."""
    if isinstance(got, tuple):
        return max(max_err(name, g, w, tols) for g, w in zip(got, want))
    if tuple(got.shape) != tuple(want.shape):
        raise BenchFailure(f"{name}: shape {tuple(got.shape)} != "
                           f"{tuple(want.shape)}")
    if tols is None:
        if not torch.equal(got, want):
            raise BenchFailure(f"{name}: differs from its twin at "
                               f"{int((got != want).sum())} elements")
        return 0.0
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise BenchFailure(f"{name}: non-finite output")
    err = (got - want).abs()
    for tol in tols:
        if not bool((err <= tol["atol"] + tol["rtol"] * want.abs()).all()):
            raise BenchFailure(f"{name}: max |err| {float(err.max()):.3g}"
                               f" exceeds atol {tol['atol']} + rtol "
                               f"{tol['rtol']}")
    return float(err.max())


class Row:
    """One bench row: a kernel call, its twin, an optional library call,
    the comparison and the cost the bound is computed from."""

    def __init__(self, group, kernel, label, fn, twin, library, tols,
                 flops, nbytes, bf16):
        self.group, self.kernel, self.label = group, kernel, label
        self.fn, self.twin, self.library, self.tols = fn, twin, library, tols
        self.flops, self.nbytes, self.bf16 = flops, nbytes, bf16
        self.out = None

    def measure(self) -> Dict:
        name = f"{self.kernel} {self.label}"
        err = None
        if self.twin is not None:
            want = self.twin()
            torch.cuda.synchronize()
            err = max_err(name, self.out, want, self.tols)
            del want
        self.out = None
        t_k = event_ms(self.fn)
        t_p = (event_ms(self.twin, iters=5, warmup=1)
               if self.twin is not None else None)
        t_l = event_ms(self.library) if self.library is not None else None
        b_ms, by = bound(self.flops, self.nbytes, self.bf16)
        return {"group": self.group, "kernel": self.kernel,
                "label": self.label, "ms": t_k, "plain_ms": t_p,
                "library_ms": t_l, "bound_ms": b_ms, "bound_by": by,
                "kernel_over_bound": t_k / b_ms, "max_abs_err": err,
                "flops": self.flops, "bytes": self.nbytes}


def _weights(gen, dev, k, cin, c2, cout):
    w = torch.randn(k, k, cin, c2, generator=gen, device=dev) \
        / (k * k * cin) ** 0.5
    b = torch.randn(c2, generator=gen, device=dev) * 0.1
    scale = torch.rand(cout, generator=gen, device=dev) + 0.5
    offset = torch.randn(cout, generator=gen, device=dev) * 0.1
    return w, b, scale, offset


def library_conv(x, w, stride=1):
    """The library yardstick of a k x k conv: ``F.conv2d`` (cuDNN) on
    NHWC ``x`` and HWIO ``w`` (channels-last views), no epilogue."""
    k = w.shape[0]
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                    stride=stride, padding=(k - 1) // 2)


def zbuffer_yardsticks(xyz, ms, hw):
    """For points ``xyz`` seen through ``ms`` at ``hw``: K6's inputs
    (int32 pixel ids and the frame's packed keys, ``[B, N]``), and for
    each z-buffer ``(library call, flops, bytes)``: ``scatter_reduce_``
    amin of the same keys into a buffer with a dump slot, the projection's
    flops (K1, K5) and the bytes read and written once."""
    b, n, npx = ms.shape[0], xyz.shape[0], hw[0] * hw[1]
    pix, depth, _, _ = RK._projected(xyz, ms, *hw)
    ids = torch.arange(n, dtype=torch.int32, device=xyz.device).expand(b, n)
    key = RK.pack_keys(pix, depth, ids, npx, n)[0].contiguous()
    key64 = RK.pack_exact_keys(pix, depth, ids, npx)
    dump = pix.clamp(max=npx).long()
    buf32 = torch.full((b, npx + 1), RK.INT32_MAX, dtype=torch.int32,
                       device=xyz.device)
    buf64 = torch.full((b, npx + 1), RK.INT64_MAX, dtype=torch.int64,
                       device=xyz.device)
    proj = PROJECT_FLOPS * b * n
    return pix.to(torch.int32).contiguous(), key, {
        "zbuffer": (lambda: buf32.scatter_reduce_(-1, dump, key, "amin"),
                    proj, 12 * n + 64 * b + 4 * b * npx + 4 * b * n),
        "zbuffer_exact": (lambda: buf64.scatter_reduce_(-1, dump, key64,
                                                        "amin"),
                          proj, 12 * n + 64 * b + 8 * b * npx),
        "zbuffer_keys": (lambda: buf32.scatter_reduce_(-1, dump, key,
                                                       "amin"),
                         0.0, 8 * b * n + 4 * b * npx)}


def zbuffer_rows(dev) -> List[Row]:
    """K1, K5 and K6 at the serving frame's shapes."""
    rows = []
    hw = HW[0] * HW[1]
    cases = []
    for b in (1, 2):
        cases.append((f"B={b}", *frame_inputs(b, N_POINTS, HW)))
    xyz, ms = frame_inputs(1, N_POINTS, HW)
    cases.append(("B=1 ties", np.tile(xyz[:N_POINTS // 4], (4, 1)), ms))
    for label, xyz, ms in cases:
        xyz = torch.from_numpy(xyz).to(dev)
        ms = torch.from_numpy(ms).to(dev)
        pix, key, lib = zbuffer_yardsticks(xyz, ms, HW)
        calls = {
            "zbuffer": (lambda xyz=xyz, ms=ms: RK.zbuffer(xyz, ms, *HW),
                        lambda xyz=xyz, ms=ms: RK.zbuffer_plain(xyz, ms,
                                                                *HW)),
            "zbuffer_exact": (
                lambda xyz=xyz, ms=ms: RK.zbuffer_exact(xyz, ms, *HW),
                lambda xyz=xyz, ms=ms: RK.zbuffer_exact_plain(xyz, ms, *HW)),
            "zbuffer_keys": (lambda p=pix, k=key: RK.zbuffer_keys(p, k, hw),
                             lambda p=pix, k=key: RK.zbuffer_keys_plain(
                                 p, k, hw))}
        for name, (fn, twin) in calls.items():
            library, flops, nbytes = lib[name]
            rows.append(Row("zbuffer", name, label, fn, twin, library, None,
                            flops, nbytes, False))
    return rows


def conv_rows(dev) -> List[Row]:
    """K2 and K7 3x3, K3 and K7 1x1, at the four level shapes."""
    rows = []
    gen = torch.Generator(device=dev).manual_seed(0)
    for h, w, c in CONV_SHAPES:
        x = torch.randn(1, h, w, c, generator=gen, device=dev)
        for k in (3, 1):
            wk, b, scale, offset = _weights(gen, dev, k, c, 2 * c, c)
            for bf16 in (False, True):
                dt = torch.bfloat16 if bf16 else torch.float32
                xl, wl = x.to(dt), wk.to(dt)
                tag = f"{h}x{w} {c}->{c} {'bf16' if bf16 else 'f32'}"
                if k == 3:
                    lib = (lambda xl=xl, wl=wl: library_conv(xl, wl))
                    packed = GC.pack_kxk_bf16(wk) if bf16 else None
                    rows.append(Row(
                        "convs", "gated_conv_kxk", tag,
                        lambda x=x, a=(wk, b, scale, offset), bf=bf16,
                        pk=packed: GC.gated_conv_kxk(x, *a, bf16=bf,
                                                     packed=pk),
                        lambda x=x, a=(wk, b, scale, offset), bf=bf16:
                            GC.gated_conv_kxk_plain(x, *a, bf16=bf),
                        lib, (BF16_TOL, F32_TOL) if bf16 else (F32_TOL,),
                        *conv_cost(x.shape, 3, 1, 2 * c, c), bf16))
                    kern, twin = R2.gated_conv3x3_r2, R2.gated_conv3x3_r2_plain
                    kname = "gated_conv3x3_r2"
                else:
                    lib = (lambda xl=xl, wl=wl.reshape(c, 2 * c):
                           torch.matmul(xl, wl))
                    rows.append(Row(
                        "convs", "gated_conv_1x1", tag,
                        lambda x=x, a=(wk, b, scale, offset), bf=bf16:
                            GC.gated_conv_1x1(x, *a, bf16=bf),
                        lambda x=x, a=(wk, b, scale, offset), bf=bf16:
                            GC.gated_conv_1x1_plain(x, *a, bf16=bf),
                        lib, (BF16_TOL, F32_TOL) if bf16 else (F32_TOL,),
                        *conv_cost(x.shape, 1, 1, 2 * c, c), bf16))
                    kern, twin = R2.gated_conv1x1_r2, R2.gated_conv1x1_r2_plain
                    kname = "gated_conv1x1_r2"
                nb = 2 if bf16 else 4
                rows.append(Row(
                    "convs", kname, tag,
                    lambda f=kern, x=xl[0], a=(wl, b, scale, offset):
                        f(x, *a),
                    lambda f=twin, x=xl[0], a=(wl, b, scale, offset):
                        f(x, *a),
                    lib, (BF16_OUT_TOL,) if bf16 else (F32_TOL,),
                    *conv_cost(x.shape, k, 1, 2 * c, c, nb, nb), bf16))
    return rows


def probe_rows(dev) -> List[Row]:
    """K8's four modes at the four level shapes."""
    rows = []
    gen = torch.Generator(device=dev).manual_seed(1)
    for h, w, c in CONV_SHAPES:
        x = torch.randn(1, h, w, c, generator=gen, device=dev)
        wk = torch.randn(3, 3, c, 2 * c, generator=gen, device=dev) \
            / (9 * c) ** 0.5
        for bf16 in (False, True):
            dt = torch.bfloat16 if bf16 else torch.float32
            lib = (lambda xl=x.to(dt), wl=wk.to(dt): library_conv(xl, wl))
            flops, nbytes = conv_cost(x.shape, 3, 1, 2 * c, 2 * c,
                                      epilogue=False)
            x_bytes, out_bytes = 4 * x.numel(), 8 * h * w * c
            for mode in GP.MODES:
                tag = f"{mode} {h}x{w} {c}->{c} {'bf16' if bf16 else 'f32'}"
                cost = {"full": (flops, nbytes),
                        "nowin": (flops, nbytes),
                        "nopack": (flops, out_bytes),
                        "packonly": (0.0, x_bytes + out_bytes)}[mode]
                rows.append(Row(
                    "probe", "gated_conv_probe", tag,
                    lambda x=x, w_=wk, m=mode, bf=bf16:
                        GP.gated_conv_probe(x, w_, mode=m, bf16=bf),
                    None if mode == "nopack" else
                    (lambda x=x, w_=wk, m=mode, bf=bf16:
                        GP.gated_conv_probe_plain(x, w_, mode=m, bf16=bf)),
                    lib if mode == "full" else None,
                    None if mode == "packonly" else (F32_TOL,),
                    *cost, bf16))
    return rows


def cat_rows(dev) -> List[Row]:
    """K4 at the serving frame's SCM sites and the two probe shapes."""
    rows = []
    gen = torch.Generator(device=dev).manual_seed(2)
    sites = [(n, h, w, cins, sum(cins), False) for n, h, w, cins in
             SCM_SITES] + [(n, h, w, cins, cout, True)
                           for n, h, w, cins, cout in CAT_PROBES]
    for name, h, w, cins, cout, relu in sites:
        xs = [torch.randn(1, h, w, c, generator=gen, device=dev)
              for c in cins]
        wk, b, scale, offset = _weights(gen, dev, 1, sum(cins), 2 * cout,
                                        cout)
        xcat = torch.cat(xs, dim=-1)
        w2 = wk.reshape(sum(cins), 2 * cout)
        for bf16 in (False, True):
            dt = torch.bfloat16 if bf16 else torch.float32
            tag = (f"{name} {h}x{w} {'+'.join(map(str, cins))}->{cout} "
                   f"{'bf16' if bf16 else 'f32'}")
            args = (xs, wk, b, scale, offset)
            rows.append(Row(
                "cat", "gated_conv_1x1_cat", tag,
                lambda a=args, r=relu, bf=bf16:
                    GC.gated_conv_1x1_cat(*a, relu=r, bf16=bf),
                lambda a=args, r=relu, bf=bf16:
                    GC.gated_conv_1x1_cat_plain(*a, relu=r, bf16=bf),
                lambda xl=xcat.to(dt), wl=w2.to(dt): torch.matmul(xl, wl),
                (BF16_TOL, F32_TOL) if bf16 else (F32_TOL,),
                *conv_cost(xcat.shape, 1, 1, 2 * cout, cout), bf16))
    return rows


_BUILDERS = {"zbuffer": zbuffer_rows, "convs": conv_rows,
             "probe": probe_rows, "cat": cat_rows}


def run(dev, echo: Optional[Callable] = print):
    """Run every bench group on ``dev``: ``(rows, launches)``. Every row's
    kernel runs once first (``launches``: the counts of that pass, the
    bench's own path), then each is held against its twin and timed."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = (RK.launches, GC.launches, R2.launches, GP.launches)
    results = []
    total = {}
    for build_rows in _BUILDERS.values():
        rows = build_rows(dev)
        for counts in counters:
            for key in counts:
                counts[key] = 0
        for row in rows:
            row.out = row.fn()
        torch.cuda.synchronize()
        for counts in counters:
            for key, val in counts.items():
                total[key] = total.get(key, 0) + val
        for row in rows:
            res = row.measure()
            results.append(res)
            if echo is not None:
                echo(format_row(res))
        del rows
        torch.cuda.empty_cache()
    return results, total


def format_row(r: Dict) -> str:
    def ms(v):
        return "-" if v is None else f"{v:.4f}"
    err = "-" if r["max_abs_err"] is None else f"{r['max_abs_err']:.2e}"
    return (f"[{r['group']}] {r['kernel']} {r['label']}: kernel "
            f"{ms(r['ms'])} ms, twin {ms(r['plain_ms'])}, library "
            f"{ms(r['library_ms'])}, bound {ms(r['bound_ms'])} "
            f"({r['bound_by']}), kernel/bound "
            f"{r['kernel_over_bound']:.1f}, err {err}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=None, help="write the rows as JSON")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_bench: no CUDA device; the bench runs "
                           "only on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)} ({smi}); torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    rows, launches = run(torch.device("cuda:0"))
    print(f"[launches] {launches}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0),
                       "nvidia_smi": smi, "rows": rows,
                       "launches": launches}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
