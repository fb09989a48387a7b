"""The port's kernel bench: each hand-written kernel beside its plain
twin, a library yardstick and its bound, on the card.

    python -m read_tpu_torch.kernel_bench [--out FILE.json]

The counterpart of the JAX package's kernel benches, one group each:

- ``zbuffer`` (``scripts/bench_r4_probe.py`` ``probe_pzb2``): K1 (fused
  projection), K5, the quantized key of 'sort1q' (``zbuffer_quant``) and
  K6 (on the frame's packed keys, and on keys with every position 4
  times: heavy ties), 1M points, 1216x368, B=1 and 2;
  the pyramid (K1 or K5 and the pass); and K6 on its user path, the
  splat projection and the pass (``zbuffer_splat``) at
  :func:`splat_cases`, beside ``scatter_reduce_`` amin over the
  ``[B, N*K]`` arrays the TPU path builds (``expand_ms``: building them)
  and with the atomics the case needs (``atomics``);
- ``convs`` (``scripts/bench_gated_conv.py``): K7 3x3 beside K2 and K7
  1x1 beside K3 at ``(368, 1216, 32->32)``, ``(184, 608, 64->64)``,
  ``(92, 304, 128->128)``, ``(46, 152, 256->256)``, f32 and bf16 (x, w
  and out in the dtype); each K7 row (a wgmma loop, through
  ``ops.gated_conv_r2.r2_route``) follows the same call packing its
  weight on every call (label ``packs per call ...``, timed alone) and
  precedes the band kernel called directly (kernel ``<name>_band``, the
  old design);
- ``probe`` (``scripts/probe_pack_split.py``): K8's four modes on K2's
  wgmma loop at the same four shapes, f32 and bf16, each beside the
  same four on the old tile loop (label ``tile <mode> ...``): the modes
  split the loop's time into staging and products, and ``full`` against
  the ``convs`` group's K2 row is the gated epilogue's share; at 128 and
  256 channels ``full`` and ``packonly`` at one N tile (``C->64``) too,
  for what re-staging the patch per N tile costs;
- ``cat`` (``scripts/probe_pack_new.py`` ``cat11_*``): K4 at the three
  SCM sites of the serving frame and at ``cat11_convs2`` (32+32->32) and
  ``cat11_aff0`` (32+64+128+256->32), 1216x368, f32 and bf16.

K2, K7 3x3 and K8 (but its ``tile ...`` rows) run K2's wgmma loop, and
K3, K4 and K7 1x1 the 1x1 wgmma loop, at every bench shape (f32
operands as three TF32 products; K7's bf16 in the loops' bf16-storage
mode), with their weights packed once per row, as ``BasicConv`` caches
them; their f32 rows take the bound of that arithmetic (``tf32x3``)
and carry the f32 FMA peak's as ``f32_fma_bound_ms``.

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
bit-equal; f32 within ``F32_TOL``; K2/K3/K4/K8 bf16 operands within
``BF16_TOL`` and ``F32_TOL``: same rounded operands, f32 sums; K7's bf16
output within ``BF16_OUT_TOL``: one f32 sum rounded to bf16 once, so at
most one bf16 ulp apart); a mismatch raises. TF32 is off. Without a
CUDA device it raises.
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics
import subprocess
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from read_tpu_torch.frame import frame_inputs, train_inputs
from read_tpu_torch.ops import gated_conv as GC
from read_tpu_torch.ops import gated_conv_probe as GP
from read_tpu_torch.ops import gated_conv_r2 as R2
from read_tpu_torch.ops import rasterize as R
from read_tpu_torch.ops import rasterize_kernels as RK

__all__ = ["bound", "conv_cost", "event_ms", "graph_ms", "device_ops",
           "library_conv", "zbuffer_yardsticks", "splat_cases",
           "manifest_sizes", "splat_inputs", "splat_yardsticks", "run", "main"]

F32_TOL = dict(atol=2e-5, rtol=1e-4)     # tests/test_unet_pallas.py
BF16_TOL = dict(atol=0.35, rtol=0.05)    # same file, bf16 operands
# a bf16 output: one ulp is at most 2**-7 of the value (< rtol), atol for
# values near 0
BF16_OUT_TOL = dict(atol=1e-3, rtol=1e-2)
# NVIDIA H100 SXM data sheet, dense: f32 off the tensor cores, bf16 and
# TF32 on them, HBM3 bandwidth
PEAK_F32, PEAK_BF16, PEAK_TF32, HBM_BYTES_S = 67e12, 989e12, 495e12, 3.35e12
# flops of one point's projection in one view (4 row dots of 3 mul + 3
# add, 3 divides, depth and pixel mapping ~9)
PROJECT_FLOPS = 4 * 6 + 3 + 9
N_POINTS, HW = 1_000_000, (368, 1216)
# the training step's views (frame.train_inputs) and the pyramids' depth
TRAIN_B, TRAIN_HW, PYRAMID_LEVELS = 8, (256, 256), 4
CONV_SHAPES = ((368, 1216, 32), (184, 608, 64), (92, 304, 128),
               (46, 152, 256))
# the SCM BasicConv_4 sites of the full-width frame: (name, h, w, cins)
SCM_SITES = (("SCM2", 184, 608, (8, 56)), ("SCM1", 92, 304, (8, 120)),
             ("SCM0", 46, 152, (8, 248)))
CAT_PROBES = (("cat11_convs2", 368, 1216, (32, 32), 32),
              ("cat11_aff0", 368, 1216, (32, 64, 128, 256), 32))


class BenchFailure(RuntimeError):
    pass


def bound(flops: float, nbytes: float, bf16: bool = False,
          tf32x3: bool = False):
    """``(ms, 'operations' | 'bytes')``: the least time the card could
    take, the larger of ``flops`` at the f32 (or bf16 tensor-core) peak
    and ``nbytes`` at the HBM rate, and which of the two it is.
    ``tf32x3``: f32 operands as three TF32 tensor-core products (the
    wgmma loops' f32 mode), ``3 * flops`` at the TF32 peak."""
    if tf32x3:
        flops, peak = 3 * flops, PEAK_TF32
    else:
        peak = PEAK_BF16 if bf16 else PEAK_F32
    t_ops = flops / peak * 1e3
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


def graph_ms(fn: Callable, iters: int = 20, reps: int = 5) -> float:
    """Device time of one ``fn()`` in ms with no host launch path:
    ``iters`` calls captured in one CUDA graph, the graph replayed
    between two CUDA events, divided by ``iters``; the median of
    ``reps`` replays. Where a call runs shorter on the device than its
    launch takes on the host, :func:`event_ms` reads the host's path and
    this reads the device's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(times)


def device_ops(fn: Callable, traces: int = 3) -> Optional[int]:
    """Device operations (kernels, memsets, copies) that one ``fn()``
    queues: the most that ``traces`` ``torch.profiler`` traces of one
    call each hold (a trace can come back without its device activity);
    None where none holds any."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(1 for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA))
    return max(counts) or None


def max_err(name: str, got, want, tols) -> float:
    """Max |got - want|; raises unless finite, same shape and within
    every tolerance in ``tols`` (``None``: bit-equal); tuples or lists of
    outputs (a pyramid's levels) are compared element by element."""
    if isinstance(got, (tuple, list)):   # outputs, or pyramid levels
        if len(got) != len(want):
            raise BenchFailure(f"{name}: {len(got)} outputs, want "
                               f"{len(want)}")
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
    the comparison and the cost the bound is computed from (``tf32x3``:
    f32 operands as three TF32 products, see :func:`bound`)."""

    def __init__(self, group, kernel, label, fn, twin, library, tols,
                 flops, nbytes, bf16, tf32x3=False, graph=False):
        self.group, self.kernel, self.label = group, kernel, label
        self.fn, self.twin, self.library, self.tols = fn, twin, library, tols
        self.flops, self.nbytes, self.bf16 = flops, nbytes, bf16
        self.tf32x3 = tf32x3
        # also time fn (and the library call) in a CUDA graph, and count
        # the device operations of each
        self.graph = graph
        self.out = None
        self.launches = {}  # counter -> launches of the first pass's call
        # more keys of the row: a value, or a callable measured after the
        # kernel
        self.extra = {}

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
        b_ms, by = bound(self.flops, self.nbytes, self.bf16, self.tf32x3)
        row = {"group": self.group, "kernel": self.kernel,
               "label": self.label, "ms": t_k, "plain_ms": t_p,
               "library_ms": t_l, "bound_ms": b_ms, "bound_by": by,
               "kernel_over_bound": t_k / b_ms, "max_abs_err": err,
               "flops": self.flops, "bytes": self.nbytes,
               "launches": self.launches}
        if self.tf32x3:
            row["f32_fma_bound_ms"] = bound(self.flops, self.nbytes)[0]
        row.update({k: v() if callable(v) else v
                    for k, v in self.extra.items()})
        if self.graph:
            row.update(graph_ms=graph_ms(self.fn),
                       device_ops=device_ops(self.fn))
            if self.library is not None:
                row.update(library_graph_ms=graph_ms(self.library),
                           library_device_ops=device_ops(self.library))
        return row


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


def zbuffer_yardsticks(xyz, ms, hw, jitter=None):
    """For points ``xyz`` seen through ``ms`` at ``hw`` (with the NDC
    ``jitter [N, 2]`` where given): K6's inputs (int32 pixel ids and the
    frame's packed keys, ``[B, N]``), and for each z-buffer ``(library
    call, flops, bytes)``: ``scatter_reduce_`` amin of the same keys into
    a buffer with a dump slot, the projection's flops (K1, K5, the
    quantized key; two adds more a view and point with the jitter) and
    the bytes read and written once (the jitter's 8 a point)."""
    b, n, npx = ms.shape[0], xyz.shape[0], hw[0] * hw[1]
    pix, depth, _, _ = RK._projected(xyz, ms, *hw, jitter)
    ids = torch.arange(n, dtype=torch.int32, device=xyz.device).expand(b, n)
    key = RK.pack_keys(pix, depth, ids, npx, n)[0].contiguous()
    key64 = RK.pack_exact_keys(pix, depth, ids, npx)
    keyq = RK.pack_quant_keys(pix, depth, ids, npx, RK.quant_bits(npx)[1])
    dump = pix.clamp(max=npx).long()
    buf32 = torch.full((b, npx + 1), RK.INT32_MAX, dtype=torch.int32,
                       device=xyz.device)
    buf64 = torch.full((b, npx + 1), RK.INT64_MAX, dtype=torch.int64,
                       device=xyz.device)
    extra = 0 if jitter is None else 8 * n
    proj = (PROJECT_FLOPS + (0 if jitter is None else 2)) * b * n
    return pix.to(torch.int32).contiguous(), key, {
        "zbuffer": (lambda: buf32.scatter_reduce_(-1, dump, key, "amin"),
                    proj, 12 * n + extra + 64 * b + 4 * b * npx + 4 * b * n),
        "zbuffer_exact": (lambda: buf64.scatter_reduce_(-1, dump, key64,
                                                        "amin"),
                          proj, 12 * n + extra + 64 * b + 8 * b * npx),
        "zbuffer_quant": (lambda: buf64.scatter_reduce_(-1, dump, keyq,
                                                        "amin"),
                          proj, 12 * n + extra + 64 * b + 8 * b * npx),
        "zbuffer_keys": (lambda: buf32.scatter_reduce_(-1, dump, key,
                                                       "amin"),
                         0.0, 8 * b * n + 4 * b * npx)}


def zbuffer_rows(dev) -> List[Row]:
    """K1, K5, the quantized key and K6 at the serving frame's shapes and
    the training step's, each also in a CUDA graph; then the pyramid
    rows."""
    rows = []
    cases = []
    for b in (1, 2):
        cases.append((f"B={b}", *frame_inputs(b, N_POINTS, HW), HW))
    xyz, ms = frame_inputs(1, N_POINTS, HW)
    cases.append(("B=1 ties", np.tile(xyz[:N_POINTS // 4], (4, 1)), ms, HW))
    cases.append((f"B={TRAIN_B} {TRAIN_HW[1]}x{TRAIN_HW[0]}",
                  *train_inputs(TRAIN_B, N_POINTS, TRAIN_HW[0])[:2],
                  TRAIN_HW))
    for label, xyz, ms, hw in cases:
        xyz = torch.from_numpy(xyz).to(dev)
        ms = torch.from_numpy(ms).to(dev)
        npx = hw[0] * hw[1]
        pix, key, lib = zbuffer_yardsticks(xyz, ms, hw)
        calls = {
            "zbuffer": (lambda xyz=xyz, ms=ms, hw=hw: RK.zbuffer(xyz, ms,
                                                                 *hw),
                        lambda xyz=xyz, ms=ms, hw=hw: RK.zbuffer_plain(
                            xyz, ms, *hw)),
            "zbuffer_exact": (
                lambda xyz=xyz, ms=ms, hw=hw: RK.zbuffer_exact(xyz, ms, *hw),
                lambda xyz=xyz, ms=ms, hw=hw: RK.zbuffer_exact_plain(
                    xyz, ms, *hw)),
            "zbuffer_quant": (
                lambda xyz=xyz, ms=ms, hw=hw: RK.zbuffer_quant(xyz, ms, *hw),
                lambda xyz=xyz, ms=ms, hw=hw: RK.zbuffer_quant_plain(
                    xyz, ms, *hw)),
            "zbuffer_keys": (lambda p=pix, k=key, n=npx: RK.zbuffer_keys(
                                 p, k, n),
                             lambda p=pix, k=key, n=npx:
                                 RK.zbuffer_keys_plain(p, k, n))}
        for name, (fn, twin) in calls.items():
            library, flops, nbytes = lib[name]
            rows.append(Row("zbuffer", name, label, fn, twin, library, None,
                            flops, nbytes, False, graph=True))
    return rows + pyramid_rows(dev) + splat_rows(dev)


def pyramid_cost(b, n, hw, levels):
    """``(flops, bytes)`` of a pyramid: the projection's flops; xyz and
    the matrices read once, every level's index and depth written
    once."""
    h, w = hw
    out = sum(8 * b * (h >> i) * (w >> i) for i in range(levels))
    return PROJECT_FLOPS * b * n, 12 * n + 64 * b + out


def plain_pool_chain(xyz, ms, hw, levels, method, pool_impl):
    """This tree's projection followed by the plain pools, in the order
    the port ran them before the pyramid pass: K1 and the winner-depth
    gather, or K5 (with a one-level pass), then the plain pools one
    level after another. Its projection is this tree's, so it is not
    the earlier code's time (PERF.md section 5 has that)."""
    b, n = ms.shape[0], xyz.shape[0]
    if method == "sort":
        index, depth = RK.zbuffer_exact(xyz, ms, *hw)
    else:
        buf, depth0 = RK.zbuffer(xyz, ms, *hw)
        index, depth = RK.unpack_packed(buf, RK.key_bits(n)[0], depth0)
    index, depth = index.view(b, *hw), depth.view(b, *hw)
    if pool_impl == "packed":
        return RK.pool_pyramid_plain(index, depth, levels, "packed", n)
    out = [(index, depth)]
    for _ in range(1, levels):
        index, depth = R._pool2x2_zbuffer(index, depth)
        out.append((index, depth))
    return out


def pyramid_rows(dev) -> List[Row]:
    """:func:`RK.zbuffer_pyramid` to ``PYRAMID_LEVELS`` levels for each
    z-buffer (``method``) and pool, at the serving frame's shape (B=1)
    and the training step's, held bit-equal to its twin at every level;
    its library yardstick is :func:`plain_pool_chain`. Both also run in a
    CUDA graph, with their device operations counted."""
    rows = []
    shapes = [("B=1", *frame_inputs(1, N_POINTS, HW), HW),
              (f"B={TRAIN_B}",
               *train_inputs(TRAIN_B, N_POINTS, TRAIN_HW[0])[:2], TRAIN_HW)]
    for tag, xyz, ms, hw in shapes:
        xyz = torch.from_numpy(xyz).to(dev)
        ms = torch.from_numpy(ms).to(dev)
        for method, pool in itertools.product(("pallas", "sort"),
                                              ("packed", "exact")):
            args = (xyz, ms, *hw, PYRAMID_LEVELS, method, pool)
            rows.append(Row(
                "zbuffer", "zbuffer_pyramid",
                f"{method}+{pool} {tag} {hw[1]}x{hw[0]} L={PYRAMID_LEVELS}",
                lambda a=args: RK.zbuffer_pyramid(*a),
                lambda a=args: RK.zbuffer_pyramid_plain(*a),
                lambda a=args: plain_pool_chain(a[0], a[1], a[2:4],
                                                 *a[4:]),
                None,
                *pyramid_cost(ms.shape[0], xyz.shape[0], hw, PYRAMID_LEVELS),
                False, graph=True))
    return rows


def splat_cases():
    """K6's splat shapes, ``N_POINTS`` points, ``PYRAMID_LEVELS`` levels:
    ``(label, method, pool, B, hw, radius, z-scaled manifest sizes)``.
    (a) the ``uv_1d_p3`` serving frame, (b) the ``uv_1d_p3`` training
    step, (c) z-scaled per-point sizes capped at r = 2 on a close-up
    scene (:func:`splat_inputs`)."""
    return (("a", "pallas", "packed", 1, HW, 1, False),
            ("b", "sort", "exact", TRAIN_B, TRAIN_HW, 1, False),
            ("c", "pallas", "packed", 2, HW, 2, True))


def manifest_sizes(n: int) -> np.ndarray:
    """A scene manifest's per-point sizes, float32 ``[n]``: a third 3.0,
    the rest 1.0, every 101st NaN."""
    ps = np.where(np.arange(n) % 3 == 0, 3.0, 1.0).astype(np.float32)
    ps[::101] = np.nan
    return ps


def splat_inputs(case, seed: int = 0):
    """``(xyz [N, 3], total_m [B, 4, 4], kwargs)`` of one of
    :func:`splat_cases`: the serving frame's or the training step's
    points and views; case (c) moves the frame's points to 0.2-2.2 units
    before the camera (scaled by 0.1), so that its z-scaled sizes (a
    third 3.0, the rest 1.0, every 101st NaN) cover every ring of the
    r = 2 square, and gives them as ``point_sizes``."""
    label, method, pool, b, hw, radius, sizes = case
    if hw == TRAIN_HW:
        xyz, ms, _ = train_inputs(b, N_POINTS, hw[0], seed=seed)
    else:
        xyz, ms = frame_inputs(b, N_POINTS, hw, seed=seed)
    kw = dict(point_radius=radius, relative_size=sizes)
    if sizes:
        xyz = xyz * np.float32(0.1)
        xyz[:, 2] += np.float32(1.3)
        kw["point_sizes"] = manifest_sizes(len(xyz))
    return xyz, ms, kw


def splat_yardsticks(xyz, ms, hw, method, levels, kw):
    """For one splat case: ``(library call, expand call, atomics, flops,
    bytes)``. The library call is ``scatter_reduce_`` amin of the keys
    over JAX's ``[B, N*K]`` expansion (built here once; copies off the
    frame aim at one dump slot, as in JAX); the expand call builds those
    arrays (:func:`RK.splat_keys`); atomics counts the copies that land
    in the frame (one atomicMin each); flops are the projection's, bytes
    xyz (and the sizes) read once and every level written once."""
    b, n, npx = ms.shape[0], xyz.shape[0], hw[0] * hw[1]
    sizes = kw.get("point_sizes")

    def expand():
        return RK.splat_keys(xyz, ms, *hw, method, **kw)[:2]

    pix, key = expand()
    atomics = int((pix < npx).sum())
    dump = pix.clamp(max=npx).long()
    del pix
    buf = torch.full((b, npx + 1), torch.iinfo(key.dtype).max,
                     dtype=key.dtype, device=xyz.device)
    flops, nbytes = pyramid_cost(b, n, hw, levels)
    if sizes is not None:
        nbytes += 4 * n
    return (lambda: buf.scatter_reduce_(-1, dump, key, "amin"), expand,
            atomics, flops, nbytes)


def splat_rows(dev) -> List[Row]:
    """K6 on its user path (:func:`RK.zbuffer_splat`) at each of
    :func:`splat_cases`, bit-equal to its twin at every level, also in
    a CUDA graph; its library is ``scatter_reduce_`` over the expanded
    arrays, beside which ``expand_ms`` times building them."""
    rows = []
    for case in splat_cases():
        label, method, pool, b, hw = case[:5]
        xyz, ms, kw = splat_inputs(case)
        xyz = torch.from_numpy(xyz).to(dev)
        ms = torch.from_numpy(ms).to(dev)
        if "point_sizes" in kw:
            kw["point_sizes"] = torch.from_numpy(kw["point_sizes"]).to(dev)
        library, expand, atomics, flops, nbytes = splat_yardsticks(
            xyz, ms, hw, method, PYRAMID_LEVELS, kw)
        args = (xyz, ms, *hw, PYRAMID_LEVELS, method, pool)
        row = Row("zbuffer", "zbuffer_splat",
                  f"({label}) {method}+{pool} r={kw['point_radius']}"
                  + (" z-scaled sizes" if "point_sizes" in kw else "")
                  + f" B={b} {hw[1]}x{hw[0]} L={PYRAMID_LEVELS}",
                  lambda a=args, kw=kw: RK.zbuffer_splat(*a, **kw),
                  lambda a=args, kw=kw: RK.zbuffer_splat_plain(*a, **kw),
                  library, None, flops, nbytes, False, graph=True)
        row.extra = {"atomics": atomics,
                     "expand_ms": lambda f=expand: event_ms(f, iters=5)}
        rows.append(row)
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
                    packed = (GC.pack_kxk_bf16(wk) if bf16
                              else GC.pack_kxk_tf32(wk))
                    rows.append(Row(
                        "convs", "gated_conv_kxk", tag,
                        lambda x=x, a=(wk, b, scale, offset), bf=bf16,
                        pk=packed: GC.gated_conv_kxk(x, *a, bf16=bf,
                                                     packed=pk),
                        lambda x=x, a=(wk, b, scale, offset), bf=bf16:
                            GC.gated_conv_kxk_plain(x, *a, bf16=bf),
                        lib, (BF16_TOL, F32_TOL) if bf16 else (F32_TOL,),
                        *conv_cost(x.shape, 3, 1, 2 * c, c), bf16,
                        tf32x3=not bf16))
                    kern, twin = R2.gated_conv3x3_r2, R2.gated_conv3x3_r2_plain
                else:
                    lib = (lambda xl=xl, wl=wl.reshape(c, 2 * c):
                           torch.matmul(xl, wl))
                    packed = (GC.pack_1x1_bf16(wk) if bf16
                              else GC.pack_1x1_tf32(wk))
                    rows.append(Row(
                        "convs", "gated_conv_1x1", tag,
                        lambda x=x, a=(wk, b, scale, offset), bf=bf16,
                        pk=packed: GC.gated_conv_1x1(x, *a, bf16=bf,
                                                     packed=pk),
                        lambda x=x, a=(wk, b, scale, offset), bf=bf16:
                            GC.gated_conv_1x1_plain(x, *a, bf16=bf),
                        lib, (BF16_TOL, F32_TOL) if bf16 else (F32_TOL,),
                        *conv_cost(x.shape, 1, 1, 2 * c, c), bf16,
                        tf32x3=not bf16))
                    kern, twin = R2.gated_conv1x1_r2, R2.gated_conv1x1_r2_plain
                rows += r2_rows(kern, twin, lib, tag, xl[0], wl, b, scale,
                                offset)
    return rows


def r2_rows(kern, twin, lib, tag, x, w, b, scale, offset) -> List[Row]:
    """K7's rows at one shape and dtype: the wrapper (gated: a wgmma loop
    through ``r2_route``) packing its weight on every call (no twin or
    library, labelled ``packs per call``), the same with the weight
    packed once (``R2.pack_r2``, as ``BasicConv`` caches K2's), and the
    band kernel called directly (``R2._band``, kernel ``<name>_band``)."""
    k, c2 = w.shape[0], w.shape[-1]
    bf16 = x.dtype == torch.bfloat16
    nb = 2 if bf16 else 4
    cost = conv_cost((1, *x.shape), k, 1, c2, c2 // 2, nb, nb)
    tols = (BF16_OUT_TOL,) if bf16 else (F32_TOL,)
    a = (w, b, scale, offset)
    name = kern.__name__
    return [
        Row("convs", name, f"packs per call {tag}",
            lambda: kern(x, *a), None, None, tols, *cost, bf16,
            tf32x3=not bf16),
        Row("convs", name, tag,
            lambda pk=R2.pack_r2(w): kern(x, *a, packed=pk),
            lambda: twin(x, *a), lib, tols, *cost, bf16, tf32x3=not bf16),
        Row("convs", f"{name}_band", tag, lambda: R2._band(k, x, *a),
            lambda: twin(x, *a), lib, tols, *cost, bf16)]


def _probe_cost(x, c2):
    """``{mode: (flops, bytes)}`` of K8 on ``x [1, H, W, Cin]`` with
    ``c2`` raw output columns: ``full``/``nowin`` the conv's; ``nopack``
    its products with the weights read and the output written;
    ``packonly`` x read and the output written."""
    cin, npix = x.shape[-1], x.shape[1] * x.shape[2]
    flops, nbytes = conv_cost(x.shape, 3, 1, c2, c2, epilogue=False)
    out_bytes = 4 * npix * c2
    return {"full": (flops, nbytes), "nowin": (flops, nbytes),
            "nopack": (flops, 4 * 9 * cin * c2 + out_bytes),
            "packonly": (0.0, 4 * x.numel() + out_bytes)}


def probe_rows(dev) -> List[Row]:
    """K8 at the four level shapes, f32 and bf16: its four modes on K2's
    wgmma loop (the weight packed once a shape and dtype, as
    ``BasicConv`` caches K2's; f32 rows with the TF32 x3 bound); at 128
    and 256 channels ``full`` and ``packonly`` with ``Cout = 64`` too
    (``C->64``: one N tile, the same K, so the full-width rows less
    these are what re-staging the patch for each further N tile costs);
    then the four modes on the old tile loop (label ``tile <mode>
    ...``)."""
    rows = []
    gen = torch.Generator(device=dev).manual_seed(1)

    def loop_rows(x, wk, modes, tag, bf16, lib, loop="wgmma"):
        cost = _probe_cost(x, wk.shape[-1])
        wgmma = loop == "wgmma"
        tols = (BF16_TOL, F32_TOL) if bf16 and wgmma else (F32_TOL,)
        packed = None if not wgmma else (
            GC.pack_kxk_bf16(wk) if bf16 else GC.pack_kxk_tf32(wk))
        return [Row(
            "probe", "gated_conv_probe",
            f"{mode} {tag}" if wgmma else f"tile {mode} {tag}",
            lambda m=mode: GP.gated_conv_probe(
                x, wk, mode=m, bf16=bf16, loop=loop, packed=packed),
            None if mode == "nopack" else
            (lambda m=mode: GP.gated_conv_probe_plain(
                x, wk, mode=m, bf16=bf16, loop=loop)),
            lib if mode == "full" else None,
            None if mode == "packonly" else tols,
            *cost[mode], bf16, tf32x3=wgmma and not bf16) for mode in modes]

    for h, w, c in CONV_SHAPES:
        x = torch.randn(1, h, w, c, generator=gen, device=dev)
        wk = torch.randn(3, 3, c, 2 * c, generator=gen, device=dev) \
            / (9 * c) ** 0.5
        for bf16 in (False, True):
            dt = torch.bfloat16 if bf16 else torch.float32
            lib = (lambda xl=x.to(dt), wl=wk.to(dt): library_conv(xl, wl))
            tag = f"{h}x{w} {c}->{c} {'bf16' if bf16 else 'f32'}"
            rows += loop_rows(x, wk, GP.MODES, tag, bf16, lib)
            if c > 64:
                rows += loop_rows(x, wk[..., :128].contiguous(),
                                  ("full", "packonly"),
                                  tag.replace(f"->{c}", "->64"), bf16, None)
            rows += loop_rows(x, wk, GP.MODES, tag, bf16, lib, loop="tile")
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
            packed = GC.pack_1x1_bf16(wk) if bf16 else GC.pack_1x1_tf32(wk)
            rows.append(Row(
                "cat", "gated_conv_1x1_cat", tag,
                lambda a=args, r=relu, bf=bf16, pk=packed:
                    GC.gated_conv_1x1_cat(*a, relu=r, bf16=bf, packed=pk),
                lambda a=args, r=relu, bf=bf16:
                    GC.gated_conv_1x1_cat_plain(*a, relu=r, bf16=bf),
                lambda xl=xcat.to(dt), wl=w2.to(dt): torch.matmul(xl, wl),
                (BF16_TOL, F32_TOL) if bf16 else (F32_TOL,),
                *conv_cost(xcat.shape, 1, 1, 2 * cout, cout), bf16,
                tf32x3=not bf16))
    return rows


_BUILDERS = {"zbuffer": zbuffer_rows, "convs": conv_rows,
             "probe": probe_rows, "cat": cat_rows}


def run(dev, echo: Optional[Callable] = print):
    """Run every bench group on ``dev``: ``(rows, launches)``. Every row's
    kernel runs once first (``launches``: the counts of that pass, the
    bench's own path; each row's ``launches`` the counters its call
    moved), then each is held against its twin and timed."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = (RK.launches, GC.launches, R2.launches, GP.launches)

    def counts():
        return {k: v for c in counters for k, v in c.items()}

    results = []
    total = {key: 0 for key in counts()}
    for build_rows in _BUILDERS.values():
        rows = build_rows(dev)
        for row in rows:
            before = counts()
            row.out = row.fn()
            row.launches = {k: v - before[k] for k, v in counts().items()
                            if v != before[k]}
            for key, val in row.launches.items():
                total[key] += val
        torch.cuda.synchronize()
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
    graph = ""
    if "graph_ms" in r:
        graph = (f"; in a CUDA graph {ms(r['graph_ms'])} ms, "
                 f"{r['device_ops']} device ops")
        if "library_graph_ms" in r:
            graph += (f" (library {ms(r['library_graph_ms'])} ms, "
                      f"{r['library_device_ops']} ops)")
    if "expand_ms" in r:
        graph += (f"; building the library's [B, N*K] arrays "
                  f"{ms(r['expand_ms'])} ms, {r['atomics']} atomics")
    return (f"[{r['group']}] {r['kernel']} {r['label']}: kernel "
            f"{ms(r['ms'])} ms, twin {ms(r['plain_ms'])}, library "
            f"{ms(r['library_ms'])}, bound {ms(r['bound_ms'])} "
            f"({r['bound_by']}), kernel/bound "
            f"{r['kernel_over_bound']:.1f}, err {err}{graph}")


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
