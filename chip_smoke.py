#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``read_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``);
without a device it exits non-zero at once. It

1. builds the port's CUDA kernels from ``read_tpu_torch/csrc``;
2. holds each kernel against its plain PyTorch twin at the shapes of the
   full-width serving path (K1 bit-equal; K2/K3/K4 within the f32
   tolerance of ``tests/test_unet_pallas.py``, with bf16 operands
   too, since kernel and twin round the same operands and sum in f32;
   the 79 K2 calls of a frame on K2's wgmma loop and the 9 K3/K4 calls
   on the 1x1 wgmma loop in both operand modes, f32 as three TF32
   products, K2's at K up to 9 x 256 = 2304; the K3/K4 calls each also
   with a residual) and times both with CUDA events;
3. serves 4 requests (each timed) through
   ``read_tpu_torch.render.NeuralRenderer``
   from a random-weight full-width checkpoint written in ``read_tpu``'s
   format, over a 1M-point scene at 1216x368, and checks every kernel
   ran on that path (launch counters) and the two wgmma loops exactly as
   often as their routes predict (``ops.gated_conv.kxk_route``: 79 K2
   calls a request; ``conv1x1_route``: 9 K3/K4 calls), in every serving
   phase; then serves 2 of those requests with ``dtype='bfloat16'``,
   which must run the loops as often too and match the all-twin
   request;
4. holds K5, the exact z-buffer, bit-equal against its twin at 1M
   points (1216x368 at B=1 and 2, with heavy ties, and 256x256 at B=8)
   and times both, also in a CUDA graph; at the same four shapes holds
   the pyramid (``rasterize_kernels.zbuffer_pyramid``: K1 or K5 and the
   pyramid pass) bit-equal against its twin at all 4 levels, for both
   z-buffers and both pools;
5. trains: one full training step from a fresh full-width state, with
   K5 and with its twin (cuDNN deterministic), must give bit-equal
   pyramids and the same loss and gradients within 1e-6 relative; then
   10 steps at the bench operating point (256x256 crops, B=8, 1M
   points, VGG on, the default config) are timed (2 warm-up, 5 timed)
   and must lower the loss on their fixed batch; 7 more are timed the
   same way with TF32 forced on around the step (the port runs it with
   TF32 off);
6. saves the trained state as a ``read_tpu`` checkpoint with the
   default config (``sort``) and serves 2 requests from it at 1216x368,
   through K5, K2 and K3;
7. runs the train/eval CLI (``read_tpu_torch.train.main``, in this
   process) on two drives it builds on disk (1M points each at 1216x368,
   20 poses, PNG targets rendered with ``point_radius=1`` on ``sort``,
   as ``scripts/make_demo_scene.py`` renders them: the splat projection
   and the gather; JSON manifests): the ``configs/demo_drive.yaml``
   recipe (256x256 crops, batch 2 x inner 4, VGG with random weights,
   ``split_by_step``) for 2 epochs of 8 steps with ``--max-scenes-hbm
   1`` (the texture swap), ``--resume`` for one more epoch, ``--eval
   --eval-all`` from the best checkpoint, and one ``sort`` request from
   it through ``NeuralRenderer``. Every run must return 0 with finite
   losses, the checkpoints must be those ``read_tpu``'s rules leave
   (rotation to 3, ``best_<scene>``), the resumed step must continue the
   saved one, the val loss must fall from epoch 0 to 1, the eval PNGs
   must be written, and K5 and the pyramid pass must launch once per
   train step and val batch (K5's ``cli_launches``). It prints the CLI's
   ms/step beside the bare step's, the share of a step spent waiting for
   data, and val ms/view;
8. splats (K6 on its user path, ``rasterize_kernels.zbuffer_splat``:
   the splat projection and the pyramid pass): bit-equal to its twin at
   every level at the kernel bench's three splat shapes, (a) the
   ``uv_1d_p3`` serving frame (``pallas``, packed pool, r=1, B=1, 1M
   points, 1216x368), (b) the ``uv_1d_p3`` training step (``sort``,
   exact pool, r=1, B=8, 256x256) and (c) z-scaled manifest sizes
   capped at r=2 (B=2), each timed (events and a CUDA graph) beside its
   twin, ``scatter_reduce_`` over the ``[B, N*K]`` arrays the TPU path
   builds (and the time to build them) and its bound, its peak memory
   growth below those arrays' size; 3 requests from a full-width
   ``uv_1d_p3`` checkpoint with manifest ``point_sizes`` (request 0
   against its all-twin frame, 5e-4/1e-3) and train steps at the bench
   point with ``uv_1d_p3`` (3 against their twins: pyramids bit-equal,
   loss rel 1e-6, gradients 2e-4 x max|g|; 7 timed, the loss falling),
   one splat launch per request and per step;
9. times ``read_tpu_torch.frame.make_frame`` at B=1 and B=4 with bf16
   and f32 operands, and compares one B=1 frame (f32 and bf16 operands)
   with the same frame with every kernel swapped for its twin; a frame
   that runs either wgmma loop fewer times than its route predicts
   fails;
10. holds K7's band kernel against its twin on its own route (a
   ``gated=False`` call and a width the wgmma loops do not take, 3x3 and
   1x1, f32 and bf16), then runs the kernel bench
   (``read_tpu_torch.kernel_bench``) in-process: K1, K5 and K6
   (bit-equal, ties included) at 1M points, 1216x368, B=1 and 2, and
   256x256, B=8, each also in a CUDA graph; the pyramid in its four
   combinations at the frame's and the training step's shapes beside
   the same projection followed by the plain pools; K7
   beside K2 and K3, and K8's four modes, at the four level shapes; K4
   at the frame's SCM sites and the two concat probes; f32 and bf16;
   each against its twin, with its library yardstick and bound. Per
   level and dtype it prints K2's gated row beside K8's four modes on
   the same wgmma loop (``full``, ``nopack``, ``packonly``, ``nowin``;
   ``packonly`` bit-equal) and, at 128 and 256 channels, ``full`` and
   ``packonly`` at one N tile (each of those 40 rows must have launched
   the loop), the four modes on the old tile loop (32 rows, each must
   have launched it), cuDNN and the bound; and K7's 16 gated rows (3x3
   on K2's loop, 1x1 on the 1x1 loop; f32 as three TF32 products, bf16
   in the loops' bf16-storage mode), each of which must have launched
   its loop, beside the band kernel called directly and the same call
   packing its weight on every call.

The serving phases also require K4 (``gated_conv_1x1_cat``): 3 launches
per request, the SCMs' ``BasicConv_4``; every phase that builds a
pyramid on the card (serve, serve_bf16, serve_sort, the frames, train)
requires the pyramid pass (``zbuffer_pyramid``) to have launched as
often as its z-buffer. TF32 is off throughout, so the
twins' convolutions and matmuls are full float32 (but for the TF32-on
train timing). Any failed check
raises and the script exits non-zero. The last stdout line is ``{"ok":
true, "device": {...}}``; the line before it lists each kernel's
launches (counted on the run of the path it serves: K1-K4, the pyramid
pass and both wgmma loops on the f32 serving path, K5 on the training
steps, K6's splat projection (``zbuffer_splat``) on the ``uv_1d_p3``
requests (``train_launches``: its training steps), ``zbuffer_keys``
(K6's given-key kernel), K7 and K8 on
the kernel bench's first pass, K8's on K2's wgmma loop with its tile-loop
launches as ``tile_launches``; K2's loop also on the bf16 requests,
``bf16_launches``), error, its time, its twin's, the library call's and
its bound (``shape`` says what they were measured on); K1, K5, K6 and
the pyramid add their device time in a CUDA graph (``graph_ms``), the
pyramid its device operations and the training step's numbers
(``train_*``) beside the serving frame's, with the projection
followed by the plain pools as its library; the splat entry its three
shapes (``cases``: each with the time to build the ``[B, N*K]``
arrays, ``expand_ms``, its atomics and its peak memory growth), and its
ms/request and ms/step; K5 adds the ``sort``
requests' launches (``sort_launches``) and the CLI's
(``cli_launches``); the K2, K3, K4 and wgmma-loop entries add their bf16 per-frame times (``bf16_ms``,
``bf16_plain_ms``, ``bf16_library_ms``, ``bf16_bound_ms``), K7's four
entries (``gated_conv{3x3,1x1}_r2_wgmma``: the loops; ``..._band``: the
band kernel) and K8's (``full`` on K2's wgmma loop; ``tile_*``: on the
old tile loop) their bf16 sums over the four bench shapes. The f32
entries of K2, K3, K4, K7 on the loops, K8 and the loops, whose wgmma
calls run three TF32 tensor-core products, take as ``bound_ms`` the
bound of that arithmetic (``3 * flops`` at the TF32 peak, or the bytes; K2's 5
tile-loop calls at the f32 FMA peak) and give the f32 FMA peak's looser
bound beside it (``f32_fma_bound_ms``).
"""

import contextlib
import dataclasses
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

F32_TOL = dict(atol=2e-5, rtol=1e-4)     # tests/test_unet_pallas.py
BF16_TOL = dict(atol=0.35, rtol=0.05)    # same file, bf16 operands
FRAME_TOL = dict(atol=5e-4, rtol=1e-3)   # whole UNet, f32
N_POINTS = 1_000_000
HW = (368, 1216)
TRAIN_B, TRAIN_HW = 8, 256
TRAIN_STEPS, WARMUP, TIMED = 10, 2, 5
KERNELS = {
    "zbuffer": ("read_tpu_torch/csrc/zbuffer.cu",
                "read_tpu/ops/rasterize_pallas.py:145"),
    "gated_conv_kxk": ("read_tpu_torch/csrc/gated_conv.cu",
                       "read_tpu/ops/gated_conv_pack.py:190"),
    "gated_conv_kxk_wgmma": ("read_tpu_torch/csrc/gated_conv_wgmma.cuh",
                             "read_tpu/ops/gated_conv_pack.py:190"),
    "gated_conv_1x1": ("read_tpu_torch/csrc/gated_conv.cu",
                       "read_tpu/ops/gated_conv_pack.py:421"),
    "zbuffer_exact": ("read_tpu_torch/csrc/zbuffer.cu",
                      "read_tpu/ops/rasterize_pallas.py:40"),
    # the pass after K1/K5: K5's output stage, K1's depth gather and the
    # 2x2 pools (read_tpu/ops/rasterize.py:574, :602)
    "zbuffer_pyramid": ("read_tpu_torch/csrc/zbuffer.cu",
                        "read_tpu/ops/rasterize_pallas.py:40"),
    "gated_conv_1x1_cat": ("read_tpu_torch/csrc/gated_conv.cu",
                           "read_tpu/ops/gated_conv_pack.py:509"),
    "gated_conv_1x1_wgmma": ("read_tpu_torch/csrc/gated_conv_1x1_wgmma.cuh",
                             "read_tpu/ops/gated_conv_pack.py:509"),
    "zbuffer_keys": ("read_tpu_torch/csrc/zbuffer.cu",
                     "read_tpu/ops/rasterize_pallas.py:234"),
    # K6 on its user path: the splat projection (and the pass, launched
    # by the same C entry)
    "zbuffer_splat": ("read_tpu_torch/csrc/zbuffer.cu",
                      "read_tpu/ops/rasterize_pallas.py:234"),
    "gated_conv3x3_r2_wgmma": ("read_tpu_torch/csrc/gated_conv_wgmma.cuh",
                               "scripts/gated_conv_pallas_r2.py:73"),
    "gated_conv1x1_r2_wgmma": ("read_tpu_torch/csrc/gated_conv_1x1_wgmma.cuh",
                               "scripts/gated_conv_pallas_r2.py:169"),
    "gated_conv3x3_r2_band": ("read_tpu_torch/csrc/gated_conv_r2.cu",
                              "scripts/gated_conv_pallas_r2.py:73"),
    "gated_conv1x1_r2_band": ("read_tpu_torch/csrc/gated_conv_r2.cu",
                              "scripts/gated_conv_pallas_r2.py:169"),
    # K8's entry is its `full` mode on K2's wgmma loop (the kernel in the
    # header), launched through the C entry named third
    "gated_conv_probe": ("read_tpu_torch/csrc/gated_conv_wgmma.cuh",
                         "scripts/probe_pack_split.py:33",
                         "read_tpu_torch/csrc/gated_conv_probe.cu"),
}
LIBRARIES = ("zbuffer", "gated_conv", "gated_conv_r2", "gated_conv_probe")


class SmokeFailure(RuntimeError):
    pass


def wall_ms(fn, iters=5, warmup=2):
    """Median wall time of ``fn()`` followed by a device sync, in ms."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


class Twins:
    """Swap the ops modules' kernel entry points for their plain twins
    inside this process (the package itself has no such switch)."""

    def __enter__(self):
        from read_tpu_torch.ops import gated_conv as GC
        from read_tpu_torch.ops import rasterize_kernels as RK
        self.saved = [(RK, "zbuffer", RK.zbuffer),
                      (RK, "zbuffer_exact", RK.zbuffer_exact),
                      (RK, "zbuffer_pyramid", RK.zbuffer_pyramid),
                      (RK, "zbuffer_splat", RK.zbuffer_splat),
                      (GC, "gated_conv_kxk", GC.gated_conv_kxk),
                      (GC, "gated_conv_1x1", GC.gated_conv_1x1),
                      (GC, "gated_conv_1x1_cat", GC.gated_conv_1x1_cat)]
        for mod, name, _ in self.saved:
            setattr(mod, name, getattr(mod, name + "_plain"))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def _counters():
    from read_tpu_torch.ops import gated_conv as GC
    from read_tpu_torch.ops import gated_conv_probe as GP
    from read_tpu_torch.ops import gated_conv_r2 as R2
    from read_tpu_torch.ops import rasterize_kernels as RK
    return (RK.launches, GC.launches, R2.launches, GP.launches)


def launches():
    return {k: v for counts in _counters() for k, v in counts.items()}


def reset_launches():
    for counts in _counters():
        for name in counts:
            counts[name] = 0


def phase_build(report):
    """Every kernel library, one nvcc each, all started together."""
    from read_tpu_torch import _build
    t0 = time.perf_counter()
    _build.build(LIBRARIES)
    for name in LIBRARIES:
        _build.load(name)
    print(f"[build] nvcc {dict(_build.build_seconds)} s, total "
          f"{time.perf_counter() - t0:.2f} s")


def library_and_bound(report_row, library_fn, flops, nbytes, bf16=False):
    """Time ``library_fn`` (one PyTorch call of the same function) and
    set the row's ``library_ms``, ``bound_ms`` and ``bound_by``."""
    from read_tpu_torch.kernel_bench import bound, event_ms
    b_ms, by = bound(flops, nbytes, bf16)
    report_row.update(library_ms=event_ms(library_fn, iters=20),
                      bound_ms=b_ms, bound_by=by)


def phase_zbuffer(report, dev):
    import torch
    from read_tpu_torch import kernel_bench as KB
    from read_tpu_torch.frame import frame_inputs
    from read_tpu_torch.kernel_bench import event_ms, graph_ms
    from read_tpu_torch.ops import rasterize_kernels as RK
    for b in (1, 2):
        xyz, ms = frame_inputs(b, N_POINTS, HW)
        xyz = torch.from_numpy(xyz).to(dev)
        ms = torch.from_numpy(ms).to(dev)
        buf_k, d_k = RK.zbuffer(xyz, ms, *HW)
        buf_p, d_p = RK.zbuffer_plain(xyz, ms, *HW)
        torch.cuda.synchronize()
        if not torch.equal(buf_k, buf_p):
            raise SmokeFailure(f"zbuffer B={b}: key buffer differs from "
                               f"twin at {int((buf_k != buf_p).sum())} "
                               "pixels")
        if not torch.equal(d_k, d_p):
            raise SmokeFailure(f"zbuffer B={b}: point depths differ")
        filled = float((buf_k != RK.INT32_MAX).float().mean())
        t_k = event_ms(lambda: RK.zbuffer(xyz, ms, *HW), iters=20)
        g_k = graph_ms(lambda: RK.zbuffer(xyz, ms, *HW))
        t_p = event_ms(lambda: RK.zbuffer_plain(xyz, ms, *HW), iters=20)
        print(f"[zbuffer] B={b} N={N_POINTS} {HW[1]}x{HW[0]}: bit-equal, "
              f"{filled:.3f} of pixels covered; kernel {t_k:.4f} ms (in a "
              f"CUDA graph {g_k:.4f}), twin {t_p:.4f} ms")
        if b == 1:
            report["zbuffer"].update(ms=t_k, graph_ms=g_k, plain_ms=t_p,
                                     shape=f"B=1 N={N_POINTS} {HW[1]}x"
                                           f"{HW[0]}")
            library_and_bound(report["zbuffer"], *KB.zbuffer_yardsticks(
                xyz, ms, HW)[2]["zbuffer"])
    report["zbuffer"]["max_abs_err"] = 0.0


def phase_zbuffer_exact(report, dev):
    """K5 bit-equal to its twin, and the pyramid (K1 or K5 and the pass)
    in all four combinations of z-buffer and pool bit-equal to its twin
    at every level: 1M points at 1216x368 B=1 and 2, with heavy ties, and
    at the training step's 256x256 B=8."""
    import torch
    from read_tpu_torch import kernel_bench as KB
    from read_tpu_torch.frame import frame_inputs, train_inputs
    from read_tpu_torch.kernel_bench import event_ms, graph_ms
    from read_tpu_torch.ops import rasterize_kernels as RK
    cases = []
    for b in (1, 2):
        cases.append((f"B={b}", *frame_inputs(b, N_POINTS, HW), HW))
    xyz, ms = frame_inputs(1, N_POINTS, HW)
    # every position 4 times: exact depth ties, won by the least id
    cases.append(("B=1 ties", np.tile(xyz[:N_POINTS // 4], (4, 1)), ms,
                  HW))
    xyz, ms, _ = train_inputs(TRAIN_B, N_POINTS, TRAIN_HW)
    cases.append((f"B={TRAIN_B}", xyz, ms, (TRAIN_HW, TRAIN_HW)))
    for label, xyz, ms, hw in cases:
        xyz = torch.from_numpy(xyz).to(dev)
        ms = torch.from_numpy(ms).to(dev)
        i_k, d_k = RK.zbuffer_exact(xyz, ms, *hw)
        i_p, d_p = RK.zbuffer_exact_plain(xyz, ms, *hw)
        torch.cuda.synchronize()
        if not torch.equal(i_k, i_p):
            raise SmokeFailure(f"zbuffer_exact {label}: index differs from "
                               f"twin at {int((i_k != i_p).sum())} pixels")
        if not torch.equal(d_k, d_p):
            raise SmokeFailure(f"zbuffer_exact {label}: depth differs")
        filled = float((i_k >= 0).float().mean())
        t_k = event_ms(lambda: RK.zbuffer_exact(xyz, ms, *hw), iters=20)
        g_k = graph_ms(lambda: RK.zbuffer_exact(xyz, ms, *hw))
        t_p = event_ms(lambda: RK.zbuffer_exact_plain(xyz, ms, *hw),
                       iters=20)
        print(f"[zbuffer_exact] {label} N={xyz.shape[0]} {hw[1]}x{hw[0]}: "
              f"bit-equal, {filled:.3f} of pixels covered; kernel "
              f"{t_k:.4f} ms (in a CUDA graph {g_k:.4f}), twin {t_p:.4f} ms")
        check_pyramids(label, xyz, ms, hw)
    # the training step's shape (the last case)
    report["zbuffer_exact"].update(ms=t_k, graph_ms=g_k, plain_ms=t_p,
                                   max_abs_err=0.0,
                                   shape=f"{label} N={xyz.shape[0]} "
                                         f"{hw[1]}x{hw[0]}")
    library_and_bound(report["zbuffer_exact"], *KB.zbuffer_yardsticks(
        xyz, ms, hw)[2]["zbuffer_exact"])


def check_pyramids(label, xyz, ms, hw):
    """``RK.zbuffer_pyramid`` to 4 levels in every combination of
    z-buffer and pool against its twin, every level bit-equal; each call
    launches one projection and one pass."""
    import torch
    from read_tpu_torch.ops import rasterize_kernels as RK
    for method, pool in itertools.product(("pallas", "sort"),
                                          ("packed", "exact")):
        before = dict(RK.launches)
        got = RK.zbuffer_pyramid(xyz, ms, *hw, 4, method, pool)
        ran = {k: v - before[k] for k, v in RK.launches.items()
               if v != before[k]}
        proj = "zbuffer_exact" if method == "sort" else "zbuffer"
        if ran != {proj: 1, "zbuffer_pyramid": 1}:
            raise SmokeFailure(f"pyramid {method}+{pool} {label}: launches "
                               f"{ran}")
        want = RK.zbuffer_pyramid_plain(xyz, ms, *hw, 4, method, pool)
        torch.cuda.synchronize()
        for lv, ((ig, dg), (iw, dw)) in enumerate(zip(got, want)):
            if not (torch.equal(ig, iw) and torch.equal(dg, dw)):
                raise SmokeFailure(
                    f"pyramid {method}+{pool} {label} level {lv}: differs "
                    f"from the twin at {int((ig != iw).sum())} indices, "
                    f"{int((dg != dw).sum())} depths")
    print(f"[zbuffer_pyramid] {label} {hw[1]}x{hw[0]}: pallas/sort x "
          "packed/exact, 4 levels each, bit-equal to the twin")


def train_setup(dev):
    """The bench training operating point on ``dev``: ``(net, cfg, vgg,
    state, xyz, batch)`` with a fresh full-width state and random VGG
    weights, both from seeded ``torch.Generator``s."""
    import torch
    from read_tpu_torch.criterions import vgg as V
    from read_tpu_torch.frame import train_inputs
    from read_tpu_torch.pipelines import texture_pipeline as TP
    xyz, ms, target = train_inputs(TRAIN_B, N_POINTS, TRAIN_HW)
    cfg = TP.PipelineConfig(crop_size=(TRAIN_HW, TRAIN_HW))
    vgg = V.random_vgg_params(torch.Generator().manual_seed(0), device=dev)
    state, net = TP.create_state(torch.Generator().manual_seed(0), cfg,
                                 N_POINTS, device=dev)
    batch = {"total_m": torch.from_numpy(ms).to(dev),
             "target": torch.from_numpy(target).to(dev)}
    return net, cfg, vgg, state, torch.from_numpy(xyz).to(dev), batch


def phase_train_vs_twin(ctx):
    """One step's pyramid, loss and gradients with K5 and with its twin,
    from the same state, with cuDNN deterministic."""
    import torch
    from read_tpu_torch.ops import rasterize as R
    from read_tpu_torch.pipelines import texture_pipeline as TP
    net, cfg, vgg, state, xyz, batch = ctx["train"]
    runs = []
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for twin in (False, True):
            with Twins() if twin else contextlib.nullcontext():
                levels = R.rasterize_pyramid_pooled(
                    xyz, batch["total_m"], cfg.crop_size, cfg.num_scales,
                    method=cfg.raster_method)
                pyr = TP.build_pyramid(cfg, state.texture, xyz,
                                       batch["total_m"])
                metrics, _, _, g_net, g_tex = TP._loss_and_grads(
                    net, cfg, vgg, state, xyz, batch, False)
            runs.append(([t for lv in levels for t in lv] + pyr,
                         metrics["loss"],
                         {**state.layout.views(g_net), "texture": g_tex}))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = saved
    (maps_k, loss_k, g_k), (maps_p, loss_p, g_p) = runs
    if not all(torch.equal(a, b) for a, b in zip(maps_k, maps_p)):
        raise SmokeFailure("train_vs_twin: pyramids differ")
    rel = float((loss_k - loss_p).abs() / loss_p.abs())
    worst = max(float((g_k[k] - g).abs().max() / g.abs().max().clamp(
        min=1e-30)) for k, g in g_p.items())
    if not rel <= 1e-6 or not worst <= 1e-6:
        raise SmokeFailure(f"train_vs_twin: loss rel {rel:.3g}, worst "
                           f"gradient rel {worst:.3g} (bound 1e-6)")
    print(f"[train_vs_twin] pyramids bit-equal ({len(maps_k)} maps); loss "
          f"{float(loss_k):.6g} rel diff {rel:.3g}; {len(g_k)} gradients, "
          f"worst rel diff {worst:.3g} (bound 1e-6)")


def phase_train(report, ctx):
    """The main path of this slice: 10 train steps at the bench point,
    2 warm-up and 5 timed among them, through the pipeline API."""
    import torch
    from read_tpu_torch.pipelines import texture_pipeline as TP
    net, cfg, vgg, state, xyz, batch = ctx["train"]
    step = TP.make_train_step(net, cfg, vgg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses = []
    for i in range(TRAIN_STEPS):
        if i == WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, metrics = step(state, xyz, batch)
        losses.append(metrics["loss"])
        if i == WARMUP + TIMED - 1:
            torch.cuda.synchronize()
            seconds = (time.perf_counter() - t0) / TIMED
    torch.cuda.synchronize()
    counts = launches()
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SmokeFailure(f"train: losses {losses} not finite or not "
                           "lower at the end")
    pyramid_ran("train", counts, "zbuffer_exact", None)
    report["zbuffer_exact"]["launches"] = counts["zbuffer_exact"]
    ctx["train_ms"] = seconds * 1e3
    print(f"[train] {TRAIN_B}x{TRAIN_HW}^2 crops, {N_POINTS} points, "
          f"full-width UNet, VGG on: {seconds * 1e3:.2f} ms/step, "
          f"{1.0 / seconds:.3f} steps/s (mean of {TIMED} "
          f"after {WARMUP} warm-up); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; loss "
          f"{losses[0]:.6g} -> {losses[-1]:.6g} over {TRAIN_STEPS} steps; "
          f"launches {counts}")
    ctx["trained"] = state
    # the same step with TF32 forced on around it, from the trained state
    with tf32_on():
        on_s, on_losses, _ = timed_steps(step, state, xyz, batch)
    if not all(np.isfinite([float(x) for x in on_losses])):
        raise SmokeFailure("train: TF32-on losses not finite")
    print(f"[train] TF32 on (forced around the step): {on_s * 1e3:.2f} "
          f"ms/step; TF32 off (the port's default): {seconds * 1e3:.2f} "
          f"ms/step (mean of {TIMED} after {WARMUP} warm-up)")


@contextlib.contextmanager
def tf32_on():
    """Inside: the port's ``full_f32`` blocks (training step, eval step,
    VGG loss) turn TF32 on for cuDNN and cuBLAS instead of off, so the
    training step can be timed with TF32 (the package has no switch)."""
    import torch
    from read_tpu_torch.utils import fp32

    @contextlib.contextmanager
    def forced_on():
        saved = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = saved

    real = fp32.full_f32
    fp32.full_f32 = forced_on
    try:
        yield
    finally:
        fp32.full_f32 = real


def timed_steps(step, state, xyz, batch):
    """``WARMUP`` steps, then the mean seconds of ``TIMED`` more, from
    ``state``: ``(seconds, losses, last state)``."""
    import torch
    losses = []
    for i in range(WARMUP + TIMED):
        if i == WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, metrics = step(state, xyz, batch)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / TIMED, losses, state


def phase_serve_sort(report, ctx, dev, workdir):
    """The trained state saved with the default config (``sort``) and
    served through ``NeuralRenderer``: K5, K2 and K3 must all run."""
    import torch
    from read_tpu_torch.pipelines import texture_pipeline as TP
    from read_tpu_torch.render import NeuralRenderer
    from read_tpu_torch.utils import ckpt as CK
    xyz = ctx["train"][4].cpu().numpy()
    ckpt = os.path.join(workdir, "ckpt_trained_sort")
    CK.save_checkpoint(ckpt, TP.flat_from_state(ctx["trained"]), config={})
    h, w = HW
    K = np.array([[720.0, 0, w / 2], [0, 720.0, h / 2], [0, 0, 1]])
    poses = []
    for i in range(2):
        pose = np.eye(4)
        pose[0, 3] = 0.05 * i
        poses.append(pose)
    scene = {"pointcloud": {"xyz": xyz}, "intrinsic_matrix": K,
             "view_matrix": poses, "point_sizes": None,
             "config": {"viewport_size": (w, h)}}
    r = NeuralRenderer(scene, ckpt, device=dev)
    if r.cfg.raster_method != "sort":
        raise SmokeFailure(f"serve_sort: config says {r.cfg.raster_method}")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    imgs = [r.infer(p) for p in poses]
    seconds = time.perf_counter() - t0
    counts = launches()
    for i, img in enumerate(imgs):
        if img.shape != (h, w, 3) or not np.isfinite(img).all():
            raise SmokeFailure(f"serve_sort request {i}: bad frame")
    if not float(np.abs(imgs[0] - imgs[1]).max()) > 0:
        raise SmokeFailure("serve_sort: the 2 requests rendered the same")
    for name in ("zbuffer_exact", "gated_conv_kxk", "gated_conv_1x1",
                 "gated_conv_1x1_cat"):
        if counts[name] == 0:
            raise SmokeFailure(f"serve_sort: {name} never ran")
    if counts["gated_conv_1x1_cat"] != 3 * len(imgs):
        raise SmokeFailure("serve_sort: K4 did not launch 3 times per "
                           "request")
    routed_loops_ran(ctx, "serve_sort", counts, len(imgs))
    pyramid_ran("serve_sort", counts, "zbuffer_exact", len(imgs))
    report["zbuffer_exact"]["sort_launches"] = counts["zbuffer_exact"]
    print(f"[serve_sort] trained checkpoint, default config (sort): "
          f"{len(imgs)} requests at {w}x{h}, "
          f"{seconds * 1e3 / len(imgs):.2f} ms/request (first included); "
          f"launches {counts}")


def record_conv_shapes(dev, operands="bf16"):
    """Run one full-width B=1 frame with recording shims around K2, K3
    and K4: ``{(name, input shapes, w shape, stride, relu, has_res,
    route): calls}``, ``route`` being ``kxk_route`` for K2 and
    ``conv1x1_route`` for K3 and K4 (``'wgmma'``: the loop)."""
    from read_tpu_torch.frame import make_frame
    from read_tpu_torch.ops import gated_conv as GC
    counts = {}

    def record(name, xs, w, res, kw, route):
        key = (name, tuple(tuple(x.shape) for x in xs), tuple(w.shape),
               kw.get("stride", 1), kw["relu"], res is not None, route)
        counts[key] = counts.get(key, 0) + 1

    def kxk(x, w, b, scale, offset, res=None, **kw):
        record("gated_conv_kxk", [x], w, res, kw,
               GC.kxk_route(x, w, (b, scale, offset, res)))
        return saved[0](x, w, b, scale, offset, res, **kw)

    def k3(x, w, b, scale, offset, res=None, **kw):
        record("gated_conv_1x1", [x], w, res, kw,
               GC.conv1x1_route([x], w.shape[-1] // 2,
                                epilogue=(b, scale, offset, res)))
        return saved[1](x, w, b, scale, offset, res, **kw)

    def k4(xs, w, b, scale, offset, res=None, **kw):
        assert kw.get("gated", True)
        record("gated_conv_1x1_cat", xs, w, res, kw,
               GC.conv1x1_route(xs, w.shape[-1] // 2,
                                epilogue=(b, scale, offset, res)))
        return saved[2](xs, w, b, scale, offset, res, **kw)

    frame_fn, args = make_frame(1, operands, device=dev)
    saved = (GC.gated_conv_kxk, GC.gated_conv_1x1, GC.gated_conv_1x1_cat)
    GC.gated_conv_kxk, GC.gated_conv_1x1, GC.gated_conv_1x1_cat = (
        kxk, k3, k4)
    try:
        frame_fn(*args)
    finally:
        GC.gated_conv_kxk, GC.gated_conv_1x1, GC.gated_conv_1x1_cat = saved
    return counts


def _conv_operands(gen, dev, xs, ws):
    """Random inputs ``xs`` (shapes), weight ``ws`` (HWIO shape) and
    epilogue of one gated conv, on ``dev``."""
    import torch
    cin, c2 = ws[-2], ws[-1]
    x = [torch.randn(s, generator=gen, device=dev) for s in xs]
    w = torch.randn(ws, generator=gen, device=dev) * (
        1.0 / (cin * (ws[0] * ws[1] if len(ws) == 4 else 1)) ** 0.5)
    b = torch.randn(c2, generator=gen, device=dev) * 0.1
    scale = torch.rand(c2 // 2, generator=gen, device=dev) + 0.5
    offset = torch.randn(c2 // 2, generator=gen, device=dev) * 0.1
    return x, w, b, scale, offset


def _sum_into(acc, n, ms, plain_ms, library_ms, bound_ms, by, fma_ms=0.0,
              graph_ms=0.0, library_graph_ms=0.0):
    """Add ``n`` calls of one shape to the per-frame sums ``acc``."""
    for key, t in (("ms", ms), ("plain_ms", plain_ms),
                   ("library_ms", library_ms), (by, bound_ms),
                   ("f32_fma_bound_ms", fma_ms), ("graph_ms", graph_ms),
                   ("library_graph_ms", library_graph_ms)):
        acc[key] += n * t


def _per_frame_line(name, ops, a):
    b_ms = a["operations"] + a["bytes"]
    extra = (f", f32 FMA bound {a['f32_fma_bound_ms']:.4f}"
             if a.get("f32_fma_bound_ms") else "")
    if a.get("graph_ms"):
        extra += (f"; in a CUDA graph (no host path): kernel "
                  f"{a['graph_ms']:.4f}, library "
                  f"{a['library_graph_ms']:.4f}")
    print(f"[convs] {name} per B=1 frame ({ops} operands): kernel "
          f"{a['ms']:.4f} ms, twin {a['plain_ms']:.4f}, library "
          f"{a['library_ms']:.4f}, bound {b_ms:.4f} (operations "
          f"{a['operations']:.4f}, bytes {a['bytes']:.4f}){extra}, "
          f"kernel/bound {a['ms'] / b_ms:.1f}, kernel/library "
          f"{a['ms'] / a['library_ms']:.2f}")


def _report_per_frame(report, name, per_frame, err, shape):
    """The kernels line's entry of ``name`` from its per-frame sums: f32
    as its main numbers, bf16 under ``bf16_*`` (where it ran)."""
    a = per_frame["f32"]
    row = report[name]
    if a["ms"] > 0:
        row.update(max_abs_err=err, ms=a["ms"], plain_ms=a["plain_ms"],
                   library_ms=a["library_ms"],
                   bound_ms=a["operations"] + a["bytes"],
                   bound_by=max(("operations", "bytes"), key=a.get),
                   shape=shape)
        for key in ("f32_fma_bound_ms", "graph_ms", "library_graph_ms"):
            if a.get(key):
                row[key] = a[key]
    a = per_frame["bf16"]
    row.update(bf16_ms=a["ms"], bf16_plain_ms=a["plain_ms"],
               bf16_library_ms=a["library_ms"],
               bf16_bound_ms=a["operations"] + a["bytes"])
    for key in ("graph_ms", "library_graph_ms"):
        if a.get(key):
            row["bf16_" + key] = a[key]


def _new_sums():
    return {ops: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                  "operations": 0.0, "bytes": 0.0, "f32_fma_bound_ms": 0.0,
                  "graph_ms": 0.0, "library_graph_ms": 0.0}
            for ops in ("f32", "bf16")}


def phase_convs(report, ctx, dev):
    """Every K2 shape of one full-width frame, f32 and bf16 operands,
    kernel against twin; sums per B=1 frame. The calls that
    ``kxk_route`` sends to the wgmma loop (in both operand modes, f32 as
    three TF32 products, weights packed once as ``BasicConv`` caches
    them) also sum into its own entry; their f32 bound is that of three
    TF32 products, the f32 FMA peak's beside it. The frame's recorded
    K2/K3/K4 calls and the loops' calls per frame
    (``ctx['wgmma_per_frame']``, ``ctx['conv1x1_per_frame']``) go to
    ``ctx`` for the 1x1, frame and serving phases."""
    import torch
    from read_tpu_torch.kernel_bench import (bound, conv_cost, event_ms,
                                             library_conv, max_err)
    from read_tpu_torch.ops import gated_conv as GC
    counts = record_conv_shapes(dev)
    torch.cuda.synchronize()
    ctx["conv_calls"] = counts
    ctx["wgmma_per_frame"] = sum(
        n for key, n in counts.items()
        if key[0] == "gated_conv_kxk" and key[-1] == "wgmma")
    ctx["conv1x1_per_frame"] = sum(
        n for key, n in counts.items()
        if key[0] != "gated_conv_kxk" and key[-1] == "wgmma")
    gen = torch.Generator(device=dev).manual_seed(0)
    # per B=1 frame and operand type: kernel, twin and library ms, and
    # the bound's ms by limiting resource
    per_frame = {n: _new_sums()
                 for n in ("gated_conv_kxk", "gated_conv_kxk_wgmma")}
    errs = {n: 0.0 for n in per_frame}
    print(f"[convs] {len(counts)} distinct gated-conv shapes in one "
          f"full-width frame ({ctx['wgmma_per_frame']} K2 calls on the "
          f"wgmma loop, {ctx['conv1x1_per_frame']} K3/K4 calls on the 1x1 "
          "wgmma loop)")
    name = "gated_conv_kxk"
    kernel, twin = GC.gated_conv_kxk, GC.gated_conv_kxk_plain
    for (_, (xs,), ws, stride, relu, has_res, route), n in sorted(
            (k, v) for k, v in counts.items() if k[0] == name):
        (x,), w, b, scale, offset = _conv_operands(gen, dev, [xs], ws)
        kw = dict(relu=relu, stride=stride)
        out_shape = kernel(x, w, b, scale, offset, None, **kw).shape
        res = (torch.randn(out_shape, generator=gen, device=dev)
               if has_res else None)
        flops, nbytes = conv_cost(xs, ws[0], stride, ws[-1], ws[-1] // 2,
                                  res=has_res)
        wgmma = route == "wgmma"
        line = []
        # bf16: the bf16 bound, then the f32 bound too, because the
        # kernel and its twin round the same operands and sum in f32
        for ops, tols in (("f32", (F32_TOL,)),
                          ("bf16", (BF16_TOL, F32_TOL))):
            bf16 = kw["bf16"] = ops == "bf16"
            if wgmma:   # packed once, as BasicConv caches it
                kw["packed"] = (GC.pack_kxk_bf16(w) if bf16
                                else GC.pack_kxk_tf32(w))
            before = GC.launches["gated_conv_kxk_wgmma"]
            got = kernel(x, w, b, scale, offset, res, **kw)
            ran = GC.launches["gated_conv_kxk_wgmma"] - before
            if ran != wgmma:
                raise SmokeFailure(f"{name} {xs} {ws} {ops}: the wgmma "
                                   f"loop ran {ran} times, route {route}")
            want = twin(x, w, b, scale, offset, res, **kw)
            torch.cuda.synchronize()
            err = max_err(f"{name} {xs} {ws} s{stride} {ops}", got, want,
                          tols)
            errs[name] = max(errs[name], err)
            xl, wl = (x.bfloat16(), w.bfloat16()) if bf16 else (x, w)
            t_k = event_ms(lambda: kernel(x, w, b, scale, offset, res,
                                          **kw))
            t_p = event_ms(lambda: twin(x, w, b, scale, offset, res, **kw))
            t_l = event_ms(lambda: library_conv(xl, wl, stride))
            b_ms, by = bound(flops, nbytes, bf16, tf32x3=wgmma and not bf16)
            fma_ms = 0.0 if bf16 else bound(flops, nbytes)[0]
            for key in [name] + (["gated_conv_kxk_wgmma"] if wgmma else []):
                _sum_into(per_frame[key][ops], n, t_k, t_p, t_l, b_ms, by,
                          fma_ms)
            if wgmma:
                errs["gated_conv_kxk_wgmma"] = max(
                    errs["gated_conv_kxk_wgmma"], err)
                kw.pop("packed")
            line.append(f"{ops}{' wgmma' if wgmma else ''}: err "
                        f"{err:.2e} kernel {t_k:.4f} ms twin "
                        f"{t_p:.4f} library {t_l:.4f} bound {b_ms:.4f} "
                        f"({by})" + ("" if bf16 else
                                     f" f32 FMA bound {fma_ms:.4f}"))
        print(f"[convs] {name} x{list(xs)} w{list(ws)} s{stride} "
              f"relu={relu} res={has_res} (x{n}/frame) | "
              + " | ".join(line))
    for key, by_ops in per_frame.items():
        for ops, a in by_ops.items():
            _per_frame_line(key, ops, a)
    _report_per_frame(report, name, per_frame[name], errs[name],
                      "the K2 shapes of one full-width B=1 frame, f32 (the "
                      "wgmma loop's calls as three TF32 products), summed "
                      "(bf16_*: bf16 operands)")
    _report_per_frame(report, "gated_conv_kxk_wgmma",
                      per_frame["gated_conv_kxk_wgmma"],
                      errs["gated_conv_kxk_wgmma"],
                      f"the {ctx['wgmma_per_frame']} routed K2 calls of "
                      "one full-width B=1 frame, f32 operands as three "
                      "TF32 products (bound: their TF32 peak), summed "
                      "(bf16_*: bf16 operands)")


def phase_conv1x1(report, ctx, dev):
    """Every K3 and K4 shape of one full-width frame (the 9 calls
    ``conv1x1_route`` sends to the 1x1 wgmma loop), f32 and bf16
    operands, weights packed once as ``BasicConv`` caches them: the
    kernel held against its twin (f32 bound; bf16 also the bf16 bound),
    once more with a residual, then kernel, twin, library
    (``torch.matmul`` on the concatenated input) and bound timed, the
    kernel and the library also inside a CUDA graph (device time with no
    host launch path: these calls are short enough for the host's path to
    show in ``event_ms``); sums per B=1 frame for K3, K4 and the loop. The
    f32 bound is that of three TF32 products (what the loop computes),
    the f32 FMA peak's beside it."""
    import torch
    from read_tpu_torch.kernel_bench import (bound, conv_cost, event_ms,
                                             graph_ms, max_err)
    from read_tpu_torch.ops import gated_conv as GC
    gen = torch.Generator(device=dev).manual_seed(1)
    names = ("gated_conv_1x1", "gated_conv_1x1_cat", "gated_conv_1x1_wgmma")
    per_frame = {n: _new_sums() for n in names}
    errs = {n: 0.0 for n in names}
    calls = sorted((k, v) for k, v in ctx["conv_calls"].items()
                   if k[0] in names)
    for (name, xs_shapes, ws, _, relu, has_res, route), n in calls:
        if route != "wgmma":
            raise SmokeFailure(f"{name} {xs_shapes}: not on the 1x1 loop")
        xs, w, b, scale, offset = _conv_operands(gen, dev, xs_shapes, ws)
        cout, k = ws[-1] // 2, ws[-2]
        if name == "gated_conv_1x1":
            kernel = lambda *a, **kw: GC.gated_conv_1x1(xs[0], *a, **kw)
            twin = lambda *a, **kw: GC.gated_conv_1x1_plain(xs[0], *a, **kw)
        else:
            kernel = lambda *a, **kw: GC.gated_conv_1x1_cat(xs, *a, **kw)
            twin = lambda *a, **kw: GC.gated_conv_1x1_cat_plain(xs, *a,
                                                                **kw)
        lead = xs_shapes[0][:-1]
        res = torch.randn(*lead, cout, generator=gen, device=dev)
        xcat, w2 = torch.cat(xs, -1), w.reshape(k, 2 * cout)
        flops, nbytes = conv_cost(xcat.shape, 1, 1, 2 * cout, cout,
                                  res=has_res)
        line = []
        for ops, tols in (("f32", (F32_TOL,)),
                          ("bf16", (BF16_TOL, F32_TOL))):
            bf16 = ops == "bf16"
            kw = dict(relu=relu, bf16=bf16,
                      packed=GC.pack_1x1_bf16(w) if bf16
                      else GC.pack_1x1_tf32(w))
            err = 0.0
            for r in ((res if has_res else None), None if has_res else res):
                before = GC.launches["gated_conv_1x1_wgmma"]
                got = kernel(w, b, scale, offset, r, **kw)
                if GC.launches["gated_conv_1x1_wgmma"] != before + 1:
                    raise SmokeFailure(f"{name} {xs_shapes} {ops}: the 1x1 "
                                       "loop did not run")
                want = twin(w, b, scale, offset, r, **kw)
                torch.cuda.synchronize()
                err = max(err, max_err(
                    f"{name} {xs_shapes} {ops} res={r is not None}", got,
                    want, tols))
            for key in (name, "gated_conv_1x1_wgmma"):
                errs[key] = max(errs[key], err)
            r = res if has_res else None
            xl, wl = (xcat.bfloat16(), w2.bfloat16()) if bf16 else (xcat,
                                                                    w2)
            t_k = event_ms(lambda: kernel(w, b, scale, offset, r, **kw))
            t_p = event_ms(lambda: twin(w, b, scale, offset, r, **kw))
            t_l = event_ms(lambda: torch.matmul(xl, wl))
            # the same calls with no host launch path: device time alone
            g_k = graph_ms(lambda: kernel(w, b, scale, offset, r, **kw))
            g_l = graph_ms(lambda: torch.matmul(xl, wl))
            b_ms, by = bound(flops, nbytes, bf16, tf32x3=not bf16)
            fma_ms = 0.0 if bf16 else bound(flops, nbytes)[0]
            for key in (name, "gated_conv_1x1_wgmma"):
                _sum_into(per_frame[key][ops], n, t_k, t_p, t_l, b_ms, by,
                          fma_ms, g_k, g_l)
            line.append(f"{ops}: err {err:.2e} kernel {t_k:.4f} ms twin "
                        f"{t_p:.4f} library {t_l:.4f} bound {b_ms:.4f} "
                        f"({by})" + ("" if bf16 else
                                     f" f32 FMA bound {fma_ms:.4f}")
                        + f"; in a CUDA graph: kernel {g_k:.4f} library "
                        f"{g_l:.4f}")
        print(f"[conv1x1] {name} x{[list(s) for s in xs_shapes]} "
              f"w{list(ws)} relu={relu} res={has_res} (x{n}/frame) | "
              + " | ".join(line))
    for key in names:
        for ops, a in per_frame[key].items():
            _per_frame_line(key, ops, a)
        count = sum(n for (name, *_), n in calls
                    if key in (name, "gated_conv_1x1_wgmma"))
        _report_per_frame(report, key, per_frame[key], errs[key],
                          f"the {count} calls of one full-width B=1 frame, "
                          "f32 operands as three TF32 products (bound: "
                          "their TF32 peak), summed (bf16_*: bf16 "
                          "operands)")


def phase_serve(report, ctx, dev, workdir):
    """The serving path: the checkpoint-driven renderer answers 4
    requests with the packed-key z-buffer (K1), K2 (on its wgmma loop
    where routed), K3 and K4. The scene,
    poses and checkpoint go to ``ctx['serve']`` for ``serve_bf16``."""
    import torch
    from read_tpu_torch.frame import frame_inputs
    from read_tpu_torch.models import texture as T
    from read_tpu_torch.models.unet import UNet
    from read_tpu_torch.render import NeuralRenderer
    from read_tpu_torch.utils import ckpt as CK
    from read_tpu_torch.utils import convert as CV

    xyz, _ = frame_inputs(1, N_POINTS, HW)
    h, w = HW
    K = np.array([[720.0, 0, w / 2], [0, 720.0, h / 2], [0, 0, 1]])
    poses = []
    for i in range(4):
        pose = np.eye(4)
        pose[0, 3] = 0.05 * i
        pose[1, 3] = -0.02 * i
        poses.append(pose)
    scene = {"pointcloud": {"xyz": xyz}, "intrinsic_matrix": K,
             "view_matrix": poses, "point_sizes": None,
             "config": {"viewport_size": (w, h)}}
    net = UNet().init_weights(torch.Generator().manual_seed(1))
    table = T.init_point_texture(N_POINTS, 8, "rand",
                                 generator=torch.Generator().manual_seed(0))
    ckpt = os.path.join(workdir, "ckpt_full_width")
    CK.save_checkpoint(ckpt, CV.flat_from_variables(net.state_dict(),
                                                    table),
                       config={"raster_method": "pallas",
                               "conv_impl": "pallas", "dtype": "float32"})
    ctx["serve"] = (scene, poses, ckpt)
    r = NeuralRenderer(scene, ckpt, device=dev)
    torch.cuda.synchronize()
    reset_launches()
    imgs, each = [], []
    for p in poses:   # infer ends in a host copy: the frame is done
        t0 = time.perf_counter()
        imgs.append(r.infer(p))
        each.append((time.perf_counter() - t0) * 1e3)
    counts = launches()
    for i, img in enumerate(imgs):
        if img.shape != (h, w, 3) or not np.isfinite(img).all():
            raise SmokeFailure(f"request {i}: bad frame {img.shape}")
    routed_loops_ran(ctx, "serve", counts, len(imgs))
    pyramid_ran("serve", counts, "zbuffer", len(imgs))
    report["zbuffer_pyramid"]["launches"] = counts["zbuffer_pyramid"]
    for name in ("gated_conv_kxk_wgmma", "gated_conv_1x1_wgmma"):
        report[name]["launches"] = counts[name]
    if not any(float(np.abs(a - b).max()) > 0
               for a, b in zip(imgs, imgs[1:])):
        raise SmokeFailure("the 4 requests rendered identical frames")
    print(f"[serve] NeuralRenderer: {len(imgs)} requests at {w}x{h}, "
          f"{N_POINTS} points, {sum(each) / len(each):.2f} ms/request "
          f"(first included); each request "
          f"{', '.join(f'{t:.2f}' for t in each)} ms; launches {counts}")
    for name in ("zbuffer", "gated_conv_kxk", "gated_conv_1x1",
                 "gated_conv_1x1_cat"):
        if counts[name] == 0:
            raise SmokeFailure(f"kernel {name} never ran on the main path")
        report[name]["launches"] = counts[name]
    if counts["gated_conv_1x1_cat"] != 3 * len(imgs):
        raise SmokeFailure(f"serve: K4 launched {counts['gated_conv_1x1_cat']}"
                           f" times for {len(imgs)} requests, not 3 each")


def phase_serve_bf16(report, ctx, dev):
    """The renderer with ``dtype='bfloat16'`` (bf16 conv operands) answers
    2 of ``serve``'s requests from the same checkpoint: every call the
    routes send to the wgmma loops must run them, and the first frame
    must match the same request with every kernel swapped for its
    twin."""
    import torch
    from read_tpu_torch.kernel_bench import max_err
    from read_tpu_torch.render import NeuralRenderer
    scene, poses, ckpt = ctx["serve"]
    r = NeuralRenderer(scene, ckpt, dtype="bfloat16", device=dev)
    if r.cfg.operands != "bf16":
        raise SmokeFailure(f"serve_bf16: operands {r.cfg.operands}")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    imgs = [r.infer(p) for p in poses[:2]]
    seconds = time.perf_counter() - t0
    counts = launches()
    h, w = HW
    for i, img in enumerate(imgs):
        if img.shape != (h, w, 3) or not np.isfinite(img).all():
            raise SmokeFailure(f"serve_bf16 request {i}: bad frame")
    if not float(np.abs(imgs[0] - imgs[1]).max()) > 0:
        raise SmokeFailure("serve_bf16: the 2 requests rendered the same")
    routed_loops_ran(ctx, "serve_bf16", counts, len(imgs))
    pyramid_ran("serve_bf16", counts, "zbuffer", len(imgs))
    report["gated_conv_kxk_wgmma"]["bf16_launches"] = counts[
        "gated_conv_kxk_wgmma"]
    with Twins():
        twin = r.infer(poses[0])
    err = max_err("serve_bf16 request 0 vs twins", torch.from_numpy(imgs[0]),
                  torch.from_numpy(twin), (FRAME_TOL,))
    print(f"[serve_bf16] NeuralRenderer dtype=bfloat16: {len(imgs)} "
          f"requests at {w}x{h}, {seconds * 1e3 / len(imgs):.2f} "
          f"ms/request (first included); vs all-twin max |err| {err:.3g}; "
          f"launches {counts}")


def _routed(ctx):
    """Each wgmma loop's launches per frame, as its route predicts: K2's
    (``kxk_route``, 79) and the 1x1 loop's (``conv1x1_route``, 9), in
    either operand mode."""
    return (("gated_conv_kxk_wgmma", ctx["wgmma_per_frame"]),
            ("gated_conv_1x1_wgmma", ctx["conv1x1_per_frame"]))


def pyramid_ran(what, counts, proj, calls):
    """Fail unless the z-buffer ``proj`` (``zbuffer``: K1, or
    ``zbuffer_exact``: K5) and the pyramid pass each launched ``calls``
    times (``None``: at least once, as often as each other)."""
    ran = (counts[proj], counts["zbuffer_pyramid"])
    if (calls is None and not ran[0] == ran[1] > 0) or \
            (calls is not None and ran != (calls, calls)):
        raise SmokeFailure(f"{what}: {proj} launched {ran[0]} times, the "
                           f"pyramid pass {ran[1]}, want "
                           f"{calls or 'as often, at least once'}")


def routed_loops_ran(ctx, what, counts, requests):
    """Fail unless both wgmma loops ran exactly as often as their routes
    predict for ``requests`` frames."""
    for name, per_frame in _routed(ctx):
        if counts[name] != requests * per_frame:
            raise SmokeFailure(f"{what}: {name} ran {counts[name]} times, "
                               f"the route predicts {requests * per_frame}")


def loops_ran(ctx, what, fn):
    """Run ``fn()`` (one frame call); fail unless both wgmma loops ran at
    least as often as their routes predict for it, and K1 and the
    pyramid pass once each."""
    from read_tpu_torch.ops import gated_conv as GC
    from read_tpu_torch.ops import rasterize_kernels as RK
    before = dict(GC.launches)
    before_rk = dict(RK.launches)
    out = fn()
    for name, want in _routed(ctx):
        ran = GC.launches[name] - before[name]
        if ran < want:
            raise SmokeFailure(f"{what}: {name} ran {ran} times, the "
                               f"route predicts {want}")
    pyramid_ran(what, {k: v - before_rk[k] for k, v in RK.launches.items()},
                "zbuffer", 1)
    return out


def phase_frames(ctx, dev):
    import torch
    from read_tpu_torch.frame import make_frame
    for ops in ("bf16", "f32"):
        for b in (1, 4):
            frame_fn, args = make_frame(b, ops, device=dev)
            out = loops_ran(ctx, f"frame B={b} {ops}",
                            lambda: frame_fn(*args))
            torch.cuda.synchronize()
            if tuple(out.shape) != (b, *HW, 3) or \
                    not bool(torch.isfinite(out).all()):
                raise SmokeFailure(f"frame B={b} {ops}: bad output")
            ms = wall_ms(lambda: frame_fn(*args), iters=5)
            with Twins():
                ms_twin = wall_ms(lambda: frame_fn(*args), iters=3,
                                  warmup=1)
            print(f"[frame] B={b} {ops} operands: {ms / b:.3f} ms/frame "
                  f"({ms:.3f} ms/call); all-twin {ms_twin / b:.3f} "
                  "ms/frame")
            del frame_fn, args, out
            torch.cuda.empty_cache()


def phase_frame_vs_twin(ctx, dev):
    import torch
    from read_tpu_torch.frame import make_frame
    from read_tpu_torch.kernel_bench import max_err
    for ops, tols in (("f32", (FRAME_TOL,)),
                      ("bf16", (BF16_TOL, FRAME_TOL))):
        frame_fn, args = make_frame(1, ops, device=dev)
        got = loops_ran(ctx, f"frame_vs_twin {ops}", lambda: frame_fn(*args))
        with Twins():
            want = frame_fn(*args)
        torch.cuda.synchronize()
        err = max_err(f"frame B=1 {ops} kernels vs twins", got, want, tols)
        bounds = "; ".join(f"atol {t['atol']}, rtol {t['rtol']}"
                           for t in tols)
        print(f"[frame] B=1 {ops}: kernels vs all-twin frame max |err| "
              f"{err:.3g} (within {bounds})")


def phase_r2_band_route(dev):
    """K7's band kernel on its own route: a ``gated=False`` call and a
    gated call the loops do not take (3x3: Cin = 8; 1x1: Cin = 12), f32
    and bf16, at the second bench level (184x608), each held against its
    twin; each must launch the band kernel and not a wgmma loop."""
    import torch
    from read_tpu_torch.kernel_bench import BF16_OUT_TOL, max_err
    from read_tpu_torch.ops import gated_conv_r2 as R2
    gen = torch.Generator(device=dev).manual_seed(3)
    h, w = 184, 608
    for k, (cin, cout, gated), dt in itertools.product(
            (3, 1), ((64, 64, False), (None, 64, True)),
            (torch.float32, torch.bfloat16)):
        cin = cin or (8 if k == 3 else 12)
        c2 = 2 * cout if gated else cout
        x = torch.randn(h, w, cin, generator=gen, device=dev).to(dt)
        wk = (torch.randn(k, k, cin, c2, generator=gen, device=dev)
              / (k * k * cin) ** 0.5).to(dt)
        b = torch.randn(c2, generator=gen, device=dev) * 0.1
        scale = torch.rand(cout, generator=gen, device=dev) + 0.5
        offset = torch.randn(cout, generator=gen, device=dev) * 0.1
        kern, twin = ((R2.gated_conv3x3_r2, R2.gated_conv3x3_r2_plain)
                      if k == 3 else
                      (R2.gated_conv1x1_r2, R2.gated_conv1x1_r2_plain))
        name = kern.__name__
        before = dict(R2.launches)
        got = kern(x, wk, b, scale, offset, gated=gated)
        ran = {key: R2.launches[key] - before[key] for key in before}
        if ran[name + "_band"] != 1 or ran[name + "_wgmma"] != 0:
            raise SmokeFailure(f"r2 band route {name} Cin={cin} gated="
                               f"{gated}: launches {ran}")
        want = twin(x, wk, b, scale, offset, gated=gated)
        torch.cuda.synchronize()
        tols = (BF16_OUT_TOL,) if dt == torch.bfloat16 else (F32_TOL,)
        err = max_err(f"{name} band route", got, want, tols)
        print(f"[kernel_bench] {name} on the band kernel's own route, "
              f"{h}x{w} {cin}->{cout} gated={gated} {dt}: max |err| "
              f"{err:.3g}")


def phase_kernel_bench(report, dev):
    """The kernel bench in-process: K6, K7 and K8 on their path (the
    bench's first pass counts their launches), K4 at the frame's SCM
    sites; every row held against its twin. Each of K7's 16 gated rows
    (3x3 and 1x1, 4 shapes, f32 and bf16) must have run on its wgmma
    loop, and each band row on the band kernel; each of K8's 32 mode rows
    and 8 one-N-tile rows on K2's wgmma loop, and its 32 ``tile <mode>``
    rows on the tile loop."""
    from read_tpu_torch import kernel_bench as KB
    from read_tpu_torch.ops import gated_conv_probe as GP
    rows, counts = KB.run(dev)
    tags = {ops: [f"{h}x{w} {c}->{c} {ops}" for h, w, c in KB.CONV_SHAPES]
            for ops in ("f32", "bf16")}

    def select(kernel, labels):
        sel = [r for r in rows if r["kernel"] == kernel
               and r["label"] in labels]
        if len(sel) != len(labels):
            raise SmokeFailure(f"kernel_bench: {kernel} has "
                               f"{len(sel)} of the rows {labels}")
        return sel

    def bound_of(sel):
        by = {}
        for r in sel:
            by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + r["bound_ms"]
        return sum(by.values()), max(by, key=by.get)

    def fill(name, sel, shape, bf=None):
        b_ms, by = bound_of(sel)
        report[name].update(
            ms=sum(r["ms"] for r in sel),
            plain_ms=sum(r["plain_ms"] for r in sel),
            library_ms=sum(r["library_ms"] for r in sel),
            bound_ms=b_ms, bound_by=by,
            max_abs_err=max(r["max_abs_err"] for r in sel), shape=shape)
        if any("f32_fma_bound_ms" in r for r in sel):
            report[name]["f32_fma_bound_ms"] = sum(
                r["f32_fma_bound_ms"] for r in sel)
        if bf is not None:   # the bf16 rows beside the f32 ones
            report[name].update(
                bf16_ms=sum(r["ms"] for r in bf),
                bf16_plain_ms=sum(r["plain_ms"] for r in bf),
                bf16_library_ms=sum(r["library_ms"] for r in bf),
                bf16_bound_ms=bound_of(bf)[0],
                bf16_max_abs_err=max(r["max_abs_err"] for r in bf))

    for name in ("zbuffer_keys", "gated_conv3x3_r2_wgmma",
                 "gated_conv1x1_r2_wgmma", "gated_conv3x3_r2_band",
                 "gated_conv1x1_r2_band", "gated_conv_probe_wgmma",
                 "gated_conv_probe_tile"):
        if counts[name] == 0:
            raise SmokeFailure(f"kernel_bench: {name} never ran")
        if name in report:
            report[name]["launches"] = counts[name]
    fill("zbuffer_keys", select("zbuffer_keys", ["B=1"]),
         f"B=1 N={N_POINTS} {HW[1]}x{HW[0]}, the frame's packed keys")
    report["zbuffer_keys"]["graph_ms"] = select("zbuffer_keys",
                                                ["B=1"])[0]["graph_ms"]
    # the pyramid rows: each one projection and one pass; the entry is
    # the serving frame's (K1, packed pool), train_*: the training
    # step's (K5, exact pool); library: the projection, then the plain
    # pools
    for r in [r for r in rows if r["kernel"] == "zbuffer_pyramid"]:
        proj = "zbuffer_exact" if r["label"].startswith("sort") else \
            "zbuffer"
        if r["launches"] != {proj: 1, "zbuffer_pyramid": 1}:
            raise SmokeFailure(f"kernel_bench: zbuffer_pyramid {r['label']} "
                               f"launched {r['launches']}")
    frame = f"pallas+packed B=1 {HW[1]}x{HW[0]} L=4"
    train = f"sort+exact B={TRAIN_B} {TRAIN_HW}x{TRAIN_HW} L=4"
    (pf,), (pt,) = (select("zbuffer_pyramid", [frame]),
                    select("zbuffer_pyramid", [train]))
    fill("zbuffer_pyramid", [pf], f"{frame}, N={N_POINTS} (library: K1 "
         "and the plain pools)")
    keys = ("graph_ms", "device_ops", "library_graph_ms",
            "library_device_ops")
    report["zbuffer_pyramid"].update({k: pf[k] for k in keys})
    report["zbuffer_pyramid"].update(
        {f"train_{k}": pt[k] for k in keys + ("ms", "plain_ms",
                                              "library_ms", "bound_ms")})
    report["zbuffer_pyramid"]["train_shape"] = f"{train}, N={N_POINTS}"
    levels = "the 4 bench shapes (368x1216x32 .. 46x152x256), summed"
    for k7 in ("gated_conv3x3_r2", "gated_conv1x1_r2"):
        # every gated K7 row on its wgmma loop, the band rows on the band
        for ops in ("f32", "bf16"):
            loop = select(k7, tags[ops] + [f"packs per call {t}"
                                           for t in tags[ops]])
            band = select(k7 + "_band", tags[ops])
            for r, want in [(r, {k7: 1, k7 + "_wgmma": 1}) for r in loop] \
                    + [(r, {k7 + "_band": 1}) for r in band]:
                if r["launches"] != want:
                    raise SmokeFailure(f"kernel_bench: {r['kernel']} "
                                       f"{r['label']} launched "
                                       f"{r['launches']}, want {want}")
        fill(k7 + "_wgmma", select(k7, tags["f32"]),
             f"{levels}; f32 (three TF32 products), bf16 (bf16 storage) "
             "as bf16_*", bf=select(k7, tags["bf16"]))
        fill(k7 + "_band", select(k7 + "_band", tags["f32"]),
             f"{levels}; f32, bf16 as bf16_*",
             bf=select(k7 + "_band", tags["bf16"]))
    # K8: every mode row (and one-N-tile row) on K2's wgmma loop, every
    # tile row on the tile loop; its entry is `full` on the loop
    # (launches: the loop's)
    k8 = "gated_conv_probe"
    one_tile = {ops: {(h, w, c): f"{h}x{w} {c}->64 {ops}"
                      for h, w, c in KB.CONV_SHAPES if c > 64}
                for ops in ("f32", "bf16")}
    for ops in ("f32", "bf16"):
        for r, loop in [(r, "wgmma") for r in select(
                k8, [f"{m} {t}" for m in GP.MODES for t in tags[ops]]
                + [f"{m} {t}" for m in ("full", "packonly")
                   for t in one_tile[ops].values()])] \
                + [(r, "tile") for r in select(
                    k8, [f"tile {m} {t}" for m in GP.MODES
                         for t in tags[ops]])]:
            want = {k8: 1, f"{k8}_{loop}": 1}
            if r["launches"] != want:
                raise SmokeFailure(f"kernel_bench: {k8} {r['label']} "
                                   f"launched {r['launches']}, want {want}")
    fill(k8, select(k8, [f"full {t}" for t in tags["f32"]]),
         f"mode full on K2's wgmma loop, {levels}; f32 (three TF32 "
         "products), bf16 operands as bf16_*; tile_*: full on the old "
         "tile loop",
         bf=select(k8, [f"full {t}" for t in tags["bf16"]]))
    report[k8].update(
        launches=counts[f"{k8}_wgmma"], tile_launches=counts[f"{k8}_tile"],
        tile_ms=sum(r["ms"] for r in select(
            k8, [f"tile full {t}" for t in tags["f32"]])),
        bf16_tile_ms=sum(r["ms"] for r in select(
            k8, [f"tile full {t}" for t in tags["bf16"]])))
    # per level and dtype: K2's gated row, K8's four modes on the same
    # loop, the old loop's full, cuDNN and the bound; K7's loops beside
    # its band kernel
    by = {(r["kernel"], r["label"]): r for r in rows}
    for (h, w, c), ops in itertools.product(KB.CONV_SHAPES,
                                            ("f32", "bf16")):
        tag = f"{h}x{w} {c}->{c} {ops}"
        k2 = by[("gated_conv_kxk", tag)]
        modes = ", ".join(f"{m} {by[(k8, f'{m} {tag}')]['ms']:.4f}"
                          for m in GP.MODES)
        one = one_tile[ops].get((h, w, c))
        if one is not None:
            modes += (f"; at one N tile (->64) full "
                      f"{by[(k8, f'full {one}')]['ms']:.4f}, packonly "
                      f"{by[(k8, f'packonly {one}')]['ms']:.4f}")
        old = ", ".join(f"{m} {by[(k8, f'tile {m} {tag}')]['ms']:.4f}"
                        for m in GP.MODES)
        print(f"[kernel_bench] K2/K8 {tag}: K2 gated {k2['ms']:.4f} ms; "
              f"K8 on the wgmma loop: {modes}; on the old loop: {old}; "
              f"cuDNN {k2['library_ms']:.4f}; bound {k2['bound_ms']:.4f} "
              f"({k2['bound_by']})")
        for k7, what in (("gated_conv3x3_r2", "K7 3x3"),
                         ("gated_conv1x1_r2", "K7 1x1")):
            loop, band = by[(k7, tag)], by[(k7 + "_band", tag)]
            unpacked = by[(k7, f"packs per call {tag}")]
            print(f"[kernel_bench] {what} {tag}: wgmma loop "
                  f"{loop['ms']:.4f} ms (packing per call "
                  f"{unpacked['ms']:.4f}), band kernel {band['ms']:.4f}, "
                  f"library {loop['library_ms']:.4f}, bound "
                  f"{loop['bound_ms']:.4f} ({loop['bound_by']}), err "
                  f"{loop['max_abs_err']:.3g} / {band['max_abs_err']:.3g}")
    print(f"[kernel_bench] {len(rows)} rows, every kernel within its "
          f"tolerance of its twin; first-pass launches {counts}")


# ---------------------------------------------------------------------------
# Splats: K6's splat projection on its user path
# ---------------------------------------------------------------------------

P3_FORMAT = ("uv_1d_p3, uv_1d_p3_ds1, uv_1d_p3_ds2, uv_1d_p3_ds3, "
             "uv_1d_p3_ds4")
SPLAT_STEPS, SPLAT_VS_TWIN = 7, 3      # steps timed (2 warm-up), twin checks
GRAD_ATOL = 2e-4                       # x max|g|, tests/test_torch_train.py


def splat_memory(dev, xyz, ms, hw, method, pool, kw):
    """``(peak growth, bytes of the [B, N*K] arrays it replaces)``: the
    growth of ``torch.cuda.max_memory_allocated`` over one
    ``zbuffer_splat`` call, and the pixel ids and keys (int32, and int32
    or int64) of JAX's expansion."""
    import torch
    from read_tpu_torch.ops import rasterize_kernels as RK
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = RK.zbuffer_splat(xyz, ms, *hw, 4, method, pool, **kw)
    torch.cuda.synchronize()
    growth = torch.cuda.max_memory_allocated() - base
    del out
    copies = ms.shape[0] * xyz.shape[0] * (2 * kw["point_radius"] + 1) ** 2
    return growth, copies * (4 + (8 if method == "sort" else 4))


def phase_splats(report, dev, workdir):
    """K6 on its user path: the splat projection and the pyramid pass
    (``rasterize_kernels.zbuffer_splat``) bit-equal to its twin at every
    level and timed at the kernel bench's three splat shapes (a) the
    ``uv_1d_p3`` serving frame, (b) the ``uv_1d_p3`` training step, (c)
    z-scaled manifest sizes capped at r = 2; its peak memory growth below
    the ``[B, N*K]`` arrays it replaces; then 3 requests from a
    full-width ``uv_1d_p3`` checkpoint with per-point sizes, and train
    steps at the bench point with ``uv_1d_p3`` (each of the first
    ``SPLAT_VS_TWIN`` against its twin, then ``SPLAT_STEPS`` timed), one
    splat launch per request and per step."""
    import torch
    from read_tpu_torch import kernel_bench as KB
    from read_tpu_torch.ops import rasterize_kernels as RK
    row = report["zbuffer_splat"]
    cases = {}
    for r, case in zip(KB.splat_rows(dev), KB.splat_cases()):
        label, method, pool, b, hw = case[:5]
        before = dict(RK.launches)
        r.out = r.fn()
        ran = {k: v - before[k] for k, v in RK.launches.items()
               if v != before[k]}
        if ran != {"zbuffer_splat": 1, "zbuffer_pyramid": 1}:
            raise SmokeFailure(f"splats ({label}): launches {ran}")
        res = r.measure()       # raises unless bit-equal at every level
        xyz, ms, kw = KB.splat_inputs(case)
        xyz, ms = torch.from_numpy(xyz).to(dev), torch.from_numpy(ms).to(dev)
        if "point_sizes" in kw:
            kw["point_sizes"] = torch.from_numpy(kw["point_sizes"]).to(dev)
        growth, replaced = splat_memory(dev, xyz, ms, hw, method, pool, kw)
        if not growth < replaced:
            raise SmokeFailure(f"splats ({label}): peak memory growth "
                               f"{growth} B, not below the {replaced} B of "
                               "the [B, N*K] arrays")
        res.update(peak_growth_bytes=growth, expanded_bytes=replaced)
        cases[label] = res
        print(f"[splats] {r.label}: bit-equal to the twin at 4 "
              f"levels; kernel {res['ms']:.4f} ms (in a CUDA graph "
              f"{res['graph_ms']:.4f}, {res['device_ops']} device ops), "
              f"twin {res['plain_ms']:.4f}, library (scatter_reduce_ over "
              f"[B, N*K]) {res['library_ms']:.4f} + building those arrays "
              f"{res['expand_ms']:.4f}, bound {res['bound_ms']:.4f} "
              f"({res['bound_by']}), kernel/bound "
              f"{res['kernel_over_bound']:.1f}; {res['atomics']} atomics "
              f"({res['atomics'] / res['graph_ms'] / 1e6:.1f} G/s in the "
              f"graph); peak memory growth {growth / 2 ** 20:.2f} MiB "
              f"against {replaced / 2 ** 20:.1f} MiB of [B, N*K] arrays")
        del r
    a = cases["a"]
    row.update({k: a[k] for k in ("ms", "graph_ms", "plain_ms",
                                  "library_ms", "bound_ms", "bound_by",
                                  "max_abs_err", "expand_ms", "atomics")},
               shape=f"{a['label']}, N={N_POINTS}; library: "
                     "scatter_reduce_ amin over the [B, N*K] arrays, "
                     "expand_ms: building them",
               cases={k: {key: c[key] for key in (
                   "label", "ms", "graph_ms", "plain_ms", "library_ms",
                   "expand_ms", "bound_ms", "bound_by", "atomics",
                   "peak_growth_bytes", "expanded_bytes")}
                   for k, c in cases.items()})
    torch.cuda.empty_cache()
    splat_serve(report, dev, workdir)
    torch.cuda.empty_cache()
    splat_train(report, dev)


def splat_serve(report, dev, workdir):
    """3 requests from a full-width ``uv_1d_p3`` checkpoint (random
    weights) over the 1M-point frame scene with manifest sizes, through
    ``NeuralRenderer``: one splat projection and one pass per request,
    K2/K3/K4 as on the serving path; request 0 matches its all-twin
    frame."""
    import torch
    from read_tpu_torch.frame import frame_inputs
    from read_tpu_torch.kernel_bench import manifest_sizes, max_err
    from read_tpu_torch.models import texture as T
    from read_tpu_torch.models.unet import UNet
    from read_tpu_torch.render import NeuralRenderer
    from read_tpu_torch.utils import ckpt as CK
    from read_tpu_torch.utils import convert as CV
    xyz, _ = frame_inputs(1, N_POINTS, HW)
    h, w = HW
    K = np.array([[720.0, 0, w / 2], [0, 720.0, h / 2], [0, 0, 1]])
    poses = []
    for i in range(3):
        pose = np.eye(4)
        pose[0, 3] = 0.05 * i
        poses.append(pose)
    scene = {"pointcloud": {"xyz": xyz}, "intrinsic_matrix": K,
             "view_matrix": poses, "point_sizes": manifest_sizes(N_POINTS),
             "config": {"viewport_size": (w, h)}}
    net = UNet().init_weights(torch.Generator().manual_seed(1))
    table = T.init_point_texture(N_POINTS, 8, "rand",
                                 generator=torch.Generator().manual_seed(0))
    ckpt = os.path.join(workdir, "ckpt_full_width_p3")
    CK.save_checkpoint(ckpt, CV.flat_from_variables(net.state_dict(),
                                                    table),
                       config={"raster_method": "pallas",
                               "input_format": P3_FORMAT,
                               "dtype": "float32"})
    r = NeuralRenderer(scene, ckpt, device=dev)
    if (r.cfg.point_radius, r.cfg.raster_method) != (1, "pallas"):
        raise SmokeFailure(f"splat serve: radius {r.cfg.point_radius}, "
                           f"{r.cfg.raster_method}")
    torch.cuda.synchronize()
    reset_launches()
    imgs, each = [], []
    for p in poses:
        t0 = time.perf_counter()
        imgs.append(r.infer(p))
        each.append((time.perf_counter() - t0) * 1e3)
    counts = launches()
    for i, img in enumerate(imgs):
        if img.shape != (h, w, 3) or not np.isfinite(img).all():
            raise SmokeFailure(f"splat serve request {i}: bad frame")
    if (counts["zbuffer_splat"], counts["zbuffer_pyramid"], counts["zbuffer"],
            counts["zbuffer_exact"]) != (len(imgs), len(imgs), 0, 0):
        raise SmokeFailure(f"splat serve: z-buffer launches {counts}, want "
                           f"one splat projection and pass per request")
    if counts["gated_conv_1x1_cat"] != 3 * len(imgs) or \
            counts["gated_conv_kxk"] == 0 or counts["gated_conv_1x1"] == 0:
        raise SmokeFailure(f"splat serve: conv launches {counts}")
    report["zbuffer_splat"]["launches"] = counts["zbuffer_splat"]
    with Twins():
        twin = r.infer(poses[0])
    err = max_err("splat serve request 0 vs twins", torch.from_numpy(imgs[0]),
                  torch.from_numpy(twin), (FRAME_TOL,))
    steady = sum(each[1:]) / (len(each) - 1)
    # the same requests at r = 0 (K1, the unique gather), same window
    r.set_point_radius(0)
    r.infer(poses[0])
    p1 = []
    for p in poses[1:]:
        t0 = time.perf_counter()
        r.infer(p)
        p1.append((time.perf_counter() - t0) * 1e3)
    p1 = sum(p1) / len(p1)
    report["zbuffer_splat"].update(serve_ms_per_request=steady,
                                   serve_p1_ms_per_request=p1)
    print(f"[splats] serve: uv_1d_p3 checkpoint, manifest point_sizes, "
          f"{len(imgs)} requests at {w}x{h}, {N_POINTS} points: "
          f"{steady:.2f} ms/request after the first ({each[0]:.2f}); the "
          f"same requests after set_point_radius(0) {p1:.2f}; vs "
          f"all-twin max |err| {err:.3g} (atol {FRAME_TOL['atol']}, rtol "
          f"{FRAME_TOL['rtol']}); launches {counts}")


def splat_train(report, dev):
    """The bench training point with ``uv_1d_p3`` (r = 1, 'sort': the
    splat projection with K5's exact key, the exact pool, the summing
    gather): each of ``SPLAT_VS_TWIN`` steps has bit-equal pyramids and
    its loss (rel 1e-6) and gradients (``GRAD_ATOL * max|g|``; the
    gather's backward adds duplicate rows in float atomics, in no fixed
    order) against the same step with the twins; then ``SPLAT_STEPS``
    steps, 2 warm-up, one splat launch each, the loss falling."""
    import torch
    from read_tpu_torch.criterions import vgg as V
    from read_tpu_torch.frame import train_inputs
    from read_tpu_torch.ops import rasterize as R
    from read_tpu_torch.pipelines import texture_pipeline as TP
    xyz, ms, target = train_inputs(TRAIN_B, N_POINTS, TRAIN_HW)
    cfg = TP.config_from_dict({"input_format": P3_FORMAT},
                              crop_size=(TRAIN_HW, TRAIN_HW))
    if (cfg.point_radius, cfg.raster_method) != (1, "sort"):
        raise SmokeFailure(f"splat train: {cfg}")
    vgg = V.random_vgg_params(torch.Generator().manual_seed(0), device=dev)
    state, net = TP.create_state(torch.Generator().manual_seed(0), cfg,
                                 N_POINTS, device=dev)
    xyz = torch.from_numpy(xyz).to(dev)
    batch = {"total_m": torch.from_numpy(ms).to(dev),
             "target": torch.from_numpy(target).to(dev)}
    step = TP.make_train_step(net, cfg, vgg)
    worst = 0.0
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for i in range(SPLAT_VS_TWIN):
        runs = []
        for twin in (False, True):
            with Twins() if twin else contextlib.nullcontext():
                levels = R.rasterize_pyramid_pooled(
                    xyz, batch["total_m"], cfg.crop_size, cfg.num_scales,
                    point_radius=cfg.point_radius, method=cfg.raster_method)
                metrics, _, _, g_net, g_tex = TP._loss_and_grads(
                    net, cfg, vgg, state, xyz, batch, False)
            runs.append(([t for lv in levels for t in lv], metrics["loss"],
                         {**state.layout.views(g_net), "texture": g_tex}))
        torch.cuda.synchronize()
        (maps_k, loss_k, g_k), (maps_p, loss_p, g_p) = runs
        if not all(torch.equal(a, b) for a, b in zip(maps_k, maps_p)):
            raise SmokeFailure(f"splat train step {i}: pyramids differ")
        rel = float((loss_k - loss_p).abs() / loss_p.abs())
        off = max(float((g_k[k] - g).abs().max() / g.abs().max().clamp(
            min=1e-30)) for k, g in g_p.items())
        if not rel <= 1e-6 or not off <= GRAD_ATOL:
            raise SmokeFailure(f"splat train step {i}: loss rel {rel:.3g}, "
                               f"worst gradient {off:.3g} x max|g| (bounds "
                               f"1e-6, {GRAD_ATOL})")
        worst = max(worst, off)
        state, _ = step(state, xyz, batch)
    torch.backends.cudnn.deterministic = saved
    torch.cuda.synchronize()
    reset_launches()
    losses = []
    for i in range(SPLAT_STEPS):
        if i == WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, metrics = step(state, xyz, batch)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3 / (SPLAT_STEPS - WARMUP)
    counts = launches()
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SmokeFailure(f"splat train: losses {losses}")
    if (counts["zbuffer_splat"], counts["zbuffer_pyramid"],
            counts["zbuffer_exact"]) != (SPLAT_STEPS, SPLAT_STEPS, 0):
        raise SmokeFailure(f"splat train: z-buffer launches {counts}, want "
                           f"one splat projection and pass per step")
    # the same steps at r = 0 (K5, the unique gather), same window
    p1_cfg = dataclasses.replace(cfg, point_radius=0)
    p1_s, _, _ = timed_steps(TP.make_train_step(net, p1_cfg, vgg), state,
                             xyz, batch)
    report["zbuffer_splat"].update(train_launches=counts["zbuffer_splat"],
                                   train_ms_per_step=ms_step,
                                   train_p1_ms_per_step=p1_s * 1e3)
    print(f"[splats] train: uv_1d_p3 at {TRAIN_B}x{TRAIN_HW}^2 crops, "
          f"{N_POINTS} points, VGG on, sort: {SPLAT_VS_TWIN} steps against "
          f"the twins (pyramids bit-equal, worst gradient {worst:.3g} x "
          f"max|g|, bound {GRAD_ATOL}); {ms_step:.2f} ms/step (mean of "
          f"{SPLAT_STEPS - WARMUP} after {WARMUP} warm-up), the same steps "
          f"at r = 0 after them {p1_s * 1e3:.2f}; loss {losses[0]:.6g} -> "
          f"{losses[-1]:.6g}; launches {counts}")


# ---------------------------------------------------------------------------
# The train/eval CLI (read_tpu_torch.train) on two 1M-point drives
# ---------------------------------------------------------------------------

# configs/demo_drive.yaml, carried here as data so no YAML reader is needed
DEMO_DRIVE = {
    "paths_file": "data/demo_scene/paths.yaml",
    "dataset_names": ["demo_drive"],
    "crop_size": "256x256", "batch_size": 2, "epochs": 6, "save_freq": 2,
    "save_dir": "data/logs", "name": "demo_drive", "log_freq": 25,
    "criterion": "vgg", "splitter": "split_by_step",
    "splitter_args": {"val_step": 10},
    "train_dataset_args": {"random_zoom": [0.2, 2.0],
                           "random_shift": [-1.0, 1.0], "num_samples": 2,
                           "inner_batch": 4},
    "val_dataset_args": {},
}
CLI_SCENES = ("drive_a", "drive_b")
CLI_POSES, CLI_EPOCHS, CLI_STEPS = 20, 2, 8


def write_ply(path, xyz, rgb8):
    """A binary little-endian PLY of float32 xyz and uchar rgb."""
    arr = np.empty(len(xyz), np.dtype([
        ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
        ("red", "u1"), ("green", "u1"), ("blue", "u1")]))
    arr["x"], arr["y"], arr["z"] = xyz.T
    arr["red"], arr["green"], arr["blue"] = rgb8.T
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(xyz)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property uchar red\nproperty uchar green\n"
              "property uchar blue\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii") + arr.tobytes())


def drive_world(rng, n_points):
    """``(xyz [N, 3], rgb [N, 3])`` float32: a street along -z in the
    layout of ``scripts/make_demo_scene.py``'s world: road with lane
    marks, sidewalks, facades with window rows, trees."""
    def share(f):
        return int(n_points * f)

    n = share(0.35)
    x, z = rng.uniform(-4.5, 4.5, n), rng.uniform(-75, 5, n)
    road = np.stack([x, np.zeros(n), z], 1)
    c_road = rng.uniform(0.25, 0.35, (n, 1)) * np.ones((1, 3))
    c_road[(np.abs(x) < 0.08) & ((z % 4) < 2)] = (0.85, 0.85, 0.8)
    n = share(0.10)
    walk = np.stack([rng.choice([-1, 1], n) * rng.uniform(4.6, 7.0, n),
                     np.full(n, 0.12), rng.uniform(-75, 5, n)], 1)
    c_walk = rng.uniform(0.45, 0.55, (n, 1)) * np.ones((1, 3))
    n = share(0.40)
    y, z = rng.uniform(0, 9, n), rng.uniform(-75, 5, n)
    bld = np.stack([rng.choice([-1, 1], n) * rng.uniform(7.2, 7.5, n), y,
                    z], 1)
    c_bld = np.stack([rng.uniform(0.45, 0.75, n), rng.uniform(0.35, 0.55, n),
                      rng.uniform(0.3, 0.45, n)], 1)
    block = np.floor(z / 15).astype(int) % 3
    c_bld[block == 1] *= 0.8
    c_bld[block == 2] = c_bld[block == 2][:, ::-1]
    c_bld[((y % 3) > 1.2) & ((y % 3) < 2.4) & ((z % 3) > 1.0)
          & ((z % 3) < 2.2)] = (0.1, 0.12, 0.2)
    n = n_points - len(road) - len(walk) - len(bld)
    centers = np.stack([rng.choice([-1, 1], 24) * rng.uniform(5.5, 6.8, 24),
                        np.full(24, 3.2), rng.uniform(-70, 0, 24)], 1)
    tree = centers[rng.integers(0, 24, n)] + rng.normal(0, 0.9, (n, 3)) \
        * (1, 1.3, 1)
    g = rng.uniform(0.15, 0.45, (n, 1))
    c_tree = np.concatenate([g * 0.4, g + 0.25, g * 0.35], 1)
    xyz = np.concatenate([road, walk, bld, tree]).astype(np.float32)
    rgb = np.concatenate([c_road, c_walk, c_bld, c_tree]).clip(0, 1)
    return xyz, rgb.astype(np.float32)


def make_drive_scene(root, name, seed, dev, n_points, hw, poses):
    """A drive on disk: ``drive_world`` of ``n_points``; ``poses``
    camera poses 2.5 m apart along the road; targets rendered with
    ``point_radius=1`` on ``sort`` (the splat projection with K5's key),
    as ``scripts/make_demo_scene.py`` renders its targets, and the
    descriptor gather, written as PNG by ``image_io``; a JSON manifest.
    Returns the paths-file entry."""
    import torch
    from read_tpu_torch.data import image_io
    from read_tpu_torch.models import texture as T
    from read_tpu_torch.ops import rasterize as R
    from read_tpu_torch.scene import camera
    h, w = hw
    d = os.path.join(root, name)
    os.makedirs(os.path.join(d, "images"), exist_ok=True)
    xyz, colors = drive_world(np.random.default_rng(seed), n_points)
    rgb8 = (colors * 255).astype(np.uint8)
    write_ply(os.path.join(d, "pc.ply"), xyz, rgb8)
    K = np.array([[720.0, 0, w / 2], [0, 720.0, h / 2], [0, 0, 1]])
    np.savetxt(os.path.join(d, "cam.txt"), np.vstack([[w, h, 0], K]))
    P = camera.gl_projection(K, (w, h), znear=0.1, zfar=1000.0)
    views = []
    for i in range(poses):
        view = np.eye(4)
        view[:3, 3] = (0.3 * np.sin(0.4 * i), 1.6, -2.5 * i)
        views.append(view)
    np.savetxt(os.path.join(d, "poses.dat"),
               np.stack(views).reshape(-1, 4))
    xyz_d = torch.from_numpy(xyz).to(dev)
    table = torch.from_numpy(rgb8.astype(np.float32) / 255.0).to(dev)
    ms = torch.from_numpy(np.stack([camera.total_matrix(P, v)
                                    for v in views]).astype(np.float32))
    for i in range(poses):
        index, _ = R.rasterize_batch(xyz_d, ms[i:i + 1].to(dev), h, w,
                                     point_radius=1)
        img = T.sample_point_texture(table, index)[0]
        image_io.write_png(os.path.join(d, "images", f"{i:06}.png"),
                           (img.cpu().numpy() * 255 + 0.5).astype(np.uint8))
    with open(os.path.join(d, "scene.json"), "w") as f:
        json.dump({"viewport_size": [w, h], "pointcloud": "pc.ply",
                   "intrinsic_matrix": "cam.txt",
                   "view_matrix": "poses.dat"}, f)
    return {"scene_path": os.path.join(d, "scene.json"),
            "target_path": os.path.join(d, "images"),
            "target_name": "{label:06d}.png"}


def expected_checkpoints(history, names, save_freq, keep=3):
    """The checkpoint dirs ``read_tpu.train``'s rules leave after the
    epochs of ``history``: ``ckpt_<scene>_<epoch>`` at every
    ``save_freq``-th epoch and at every improvement, the newest ``keep``
    kept, and ``best_<scene>`` after an improvement."""
    best, kept, out = float("inf"), [], set()
    for h in history:
        if h["epoch"] % save_freq == 0 or h["val_loss"] < best:
            kept = (kept + [h["epoch"]])[-keep:]
        if h["val_loss"] < best:
            best = h["val_loss"]
            out |= {f"best_{n}" for n in names}
    return out | {f"ckpt_{n}_{e}" for n in names for e in kept}


OPTIONAL = ("yaml", "cv2", "imageio", "matplotlib", "tensorboardX")


@contextlib.contextmanager
def without_modules(names=OPTIONAL):
    """Inside, importing any of ``names`` fails, as on a machine without
    them; modules already imported are hidden and put back after."""
    def ours(mod):
        return mod.split(".")[0] in names

    class Block:
        def find_spec(self, name, path=None, target=None):
            if ours(name):
                raise ImportError(f"{name} is blocked")
            return None

    hidden = {m: sys.modules.pop(m) for m in list(sys.modules) if ours(m)}
    finder = Block()
    sys.meta_path.insert(0, finder)
    try:
        yield
    finally:
        sys.meta_path.remove(finder)
        for m in [m for m in sys.modules if ours(m)]:
            del sys.modules[m]
        sys.modules.update(hidden)


def host_data_ms(paths_file, recipe, hw):
    """The host data path alone, on this machine's CPU: ms for one
    training batch (``batch_size`` items of ``inner_batch`` crops, PNG
    already decoded) and for one val item at the full frame."""
    import types
    from read_tpu_torch.data.dataset import BatchIterator
    from read_tpu_torch.data.scenes import get_datasets
    args = types.SimpleNamespace(
        paths_file=paths_file, dataset_names=[CLI_SCENES[0]],
        exclude_datasets=None, crop_size=recipe["crop_size"],
        eval_all=False, splitter=recipe["splitter"],
        splitter_args=recipe["splitter_args"],
        train_dataset_args=recipe["train_dataset_args"],
        val_dataset_args=recipe["val_dataset_args"])
    (tr,), (va,), _ = get_datasets(args)
    it = iter(BatchIterator(tr, recipe["batch_size"], seed=1))
    next(it)   # decode the PNGs once, as the cache holds them later
    t0 = time.perf_counter()
    for _ in range(4):
        next(it)
    train_ms = (time.perf_counter() - t0) * 1e3 / 4
    va[0]
    t0 = time.perf_counter()
    for i in range(4):
        va[i % len(va)]
    return train_ms, (time.perf_counter() - t0) * 1e3 / 4


def _cli_run(logs, name, flags, dev):
    """``read_tpu_torch.train.main`` in this process; ``(exp dir,
    history, launches of K5 and the pyramid pass)``."""
    from read_tpu_torch import train
    if dev.type != "cuda":
        flags = flags + ["--headless-platform", "cpu"]
    save = os.path.join(logs, name)
    reset_launches()
    rc = train.main(flags + ["--save-dir", save, "--name", name])
    counts = launches()
    if rc != 0:
        raise SmokeFailure(f"cli {name}: exit code {rc}")
    (exp,) = os.listdir(save)
    exp = os.path.join(save, exp)
    with open(os.path.join(exp, "history.json")) as f:
        history = json.load(f)
    return exp, history, (counts["zbuffer_exact"], counts["zbuffer_pyramid"])


def _steady(history):
    """Mean ms/step after each epoch's first two steps, and the share of
    those steps spent waiting for the next batch."""
    step = [ms for h in history for ms in h["train_timing"]["step_ms"][2:]]
    wait = [ms for h in history for ms in h["train_timing"]["wait_ms"][2:]]
    return float(np.mean(step)), float(sum(wait) / sum(step)), len(step)


def phase_cli(report, ctx, dev, workdir, n_points=N_POINTS, hw=HW,
              poses=CLI_POSES, recipe=None):
    """The train/eval CLI on the card: two drives of ``n_points`` at
    ``hw`` built on disk, then ``read_tpu_torch.train.main`` with the
    demo_drive recipe (``--epochs 2 --max-steps-per-epoch 8
    --max-scenes-hbm 1``), ``--resume`` for one more epoch, ``--eval
    --eval-all`` from the best checkpoint, and one ``sort`` request from
    it through ``NeuralRenderer``. K5 and the pyramid pass must launch
    once per train step and val batch."""
    import torch
    from read_tpu_torch.data import image_io
    from read_tpu_torch.render import NeuralRenderer
    from read_tpu_torch.utils import ckpt as CK
    t_phase = time.perf_counter()
    recipe = dict(recipe or DEMO_DRIVE)
    try:
        from read_tpu_torch.utils import config_io
        on_disk = config_io.load("configs/demo_drive.yaml")
    except Exception:      # no PyYAML here: the carried copy stands
        on_disk = None
    if on_disk is not None and on_disk != DEMO_DRIVE:
        raise SmokeFailure("cli: configs/demo_drive.yaml changed; update "
                           "DEMO_DRIVE")
    root = os.path.join(workdir, "cli")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.perf_counter()
    paths = {"datasets": {name: make_drive_scene(root, name, seed, dev,
                                                 n_points, hw, poses)
                          for seed, name in enumerate(CLI_SCENES)}}
    build_s = time.perf_counter() - t0
    recipe["paths_file"] = os.path.join(root, "paths.json")
    recipe["dataset_names"] = list(CLI_SCENES)
    with open(recipe["paths_file"], "w") as f:
        json.dump(paths, f)
    config = os.path.join(root, "demo_drive.json")
    with open(config, "w") as f:
        json.dump(recipe, f)
    logs = os.path.join(root, "logs")
    check = dev.type == "cuda"
    base = ["--config", config, "--max-steps-per-epoch", str(CLI_STEPS),
            "--max-scenes-hbm", "1"]

    # expected work per run, from the recipe alone
    tda = recipe["train_dataset_args"]
    n_val = len(range(0, poses, recipe["splitter_args"]["val_step"]))
    n_batches = (poses - n_val) * tda["num_samples"] // recipe["batch_size"]
    steps = min(CLI_STEPS, n_batches)
    val_batches = n_val * len(CLI_SCENES)

    def check_run(name, history, ran, want_steps, want_val):
        got_steps = sum(len(h["train_timing"]["step_ms"]) for h in history
                        if "train_timing" in h)
        got_val = sum(h["val_timing"]["batches"] for h in history)
        if (got_steps, got_val) != (want_steps, want_val):
            raise SmokeFailure(f"cli {name}: {got_steps} steps, {got_val} "
                               f"val batches, want {want_steps}, "
                               f"{want_val}")
        losses = [h[k] for h in history for k in ("train_loss", "val_loss")
                  if k in h]
        if not np.isfinite(losses).all():
            raise SmokeFailure(f"cli {name}: losses {losses}")
        if check and ran != (want_steps + want_val,) * 2:
            raise SmokeFailure(f"cli {name}: K5 and the pyramid pass "
                               f"launched {ran}, want "
                               f"{want_steps + want_val} each")
        return ran[0]

    # the CLI and the renderer, with none of the optional packages
    with without_modules():
        # 1. the demo_drive fit
        fit, hist, ran = _cli_run(logs, "fit", base + [
            "--epochs", str(CLI_EPOCHS)], dev)
        cli_launches = check_run("fit", hist, ran, CLI_EPOCHS * steps,
                                 CLI_EPOCHS * val_batches)
        val = [h["val_loss"] for h in hist]
        if not val[1] < val[0]:
            raise SmokeFailure(f"cli fit: val loss {val} did not fall")
        ck = os.path.join(fit, "checkpoints")
        want = expected_checkpoints(hist, CLI_SCENES, recipe["save_freq"])
        if set(os.listdir(ck)) != want:
            raise SmokeFailure(f"cli fit: checkpoints {sorted(os.listdir(ck))}"
                               f", the reference's rules give {sorted(want)}")
        ms_step, wait_share, n_timed = _steady(hist)

        # 2. --resume for one more epoch
        saved = {n: int(CK.load_checkpoint(CK.latest_checkpoint(
            ck, f"ckpt_{n}"))[0]["step"]) for n in CLI_SCENES}
        _, rhist, ran = _cli_run(logs, "resume", base + [
            "--epochs", "1", "--resume", ck], dev)
        cli_launches += check_run("resume", rhist, ran, steps, val_batches)
        tt = rhist[0]["train_timing"]
        if tt["first_step"] != saved[tt["first_scene"]] + 1:
            raise SmokeFailure(f"cli resume: first step {tt['first_step']} of "
                               f"{tt['first_scene']}, saved {saved}")

        # 3. --eval --eval-all from the best checkpoint
        scene = CLI_SCENES[0]
        ev_dir = os.path.join(root, "eval")
        _, ehist, ran = _cli_run(logs, "eval", [
            "--config", config, "--eval", "--eval-all", "--dataset-names",
            scene, "--resume", os.path.join(ck, f"best_{scene}"),
            "--eval-dir", ev_dir], dev)
        cli_launches += check_run("eval", ehist, ran, 0, poses)
        pngs = sorted(os.listdir(ev_dir))
        if pngs != [f"{scene}_{i:06}.png" for i in range(poses)]:
            raise SmokeFailure(f"cli eval: wrote {pngs}")
        if image_io.imread(os.path.join(ev_dir, pngs[-1])).shape != (*hw, 3):
            raise SmokeFailure("cli eval: bad PNG")
        vt = ehist[0]["val_timing"]
        val_ms = 1e3 * vt["seconds"] / vt["views"]

        # 4. one sort request from the CLI's best checkpoint
        r = NeuralRenderer(paths["datasets"][scene]["scene_path"],
                           os.path.join(ck, f"best_{scene}"), device=dev)
        if r.cfg.raster_method != "sort":
            raise SmokeFailure(f"cli serve: config says {r.cfg.raster_method}")
        reset_launches()
        img = r.infer(r.scene_data["view_matrix"][3])
        if check:
            pyramid_ran("cli serve", launches(), "zbuffer_exact", 1)
        if img.shape != (*hw, 3) or not np.isfinite(img).all():
            raise SmokeFailure("cli serve: bad frame")
        del r
        train_host, val_host = host_data_ms(recipe["paths_file"], recipe,
                                            hw)
        if check:
            torch.cuda.synchronize()
    report["zbuffer_exact"]["cli_launches"] = cli_launches
    bare = ctx.get("train_ms")
    print(f"[cli] demo_drive recipe, {len(CLI_SCENES)} scenes x "
          f"{n_points} points at {hw[1]}x{hw[0]}, crops "
          f"{recipe['crop_size']}, batch "
          f"{recipe['batch_size']} x {tda['inner_batch']}, VGG: train "
          f"{ms_step:.2f} ms/step over {n_timed} steps (each epoch's first "
          f"2 left out) beside the bare step's "
          + (f"{bare:.2f}" if bare else "(not run)")
          + f" ms/step; {100 * wait_share:.1f}% of each step waiting on "
          f"PrefetchIterator; val {val_ms:.2f} ms/view at "
          f"{hw[1]}x{hw[0]} ({vt['views']} views, --eval); val loss "
          f"{val[0]:.6g} -> {val[1]:.6g}; K5 launches {cli_launches} "
          f"(train steps + val batches); scenes built in {build_s:.1f} s; "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    print(f"[cli] host data path alone (this machine's CPU, no device): "
          f"{train_host:.2f} ms a training batch ({recipe['batch_size']} "
          f"items x {tda['inner_batch']} crops of {recipe['crop_size']}), "
          f"{val_host:.2f} ms a val item at {hw[1]}x{hw[0]}; the CLI ran "
          f"without {', '.join(OPTIONAL)}")


def check_report(report):
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err")
    for name, row in report.items():
        missing = [k for k in keys if row.get(k) is None]
        if missing or row["launches"] <= 0:
            raise SmokeFailure(f"kernel {name}: launches {row['launches']}, "
                               f"missing {missing}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    from read_tpu_torch import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    workdir = os.path.join(os.path.dirname(_build.BUILD_DIR), "smoke")
    os.makedirs(workdir, exist_ok=True)
    report = {name: {"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": 0,
                     **({"entry": entry[0]} if entry else {})}
              for name, (src, rep, *entry) in KERNELS.items()}
    ctx = {}
    phases = [("build", lambda: phase_build(report)),
              ("zbuffer", lambda: phase_zbuffer(report, dev)),
              ("zbuffer_exact", lambda: phase_zbuffer_exact(report, dev)),
              ("convs", lambda: phase_convs(report, ctx, dev)),
              ("conv1x1", lambda: phase_conv1x1(report, ctx, dev)),
              ("serve", lambda: phase_serve(report, ctx, dev, workdir)),
              ("serve_bf16", lambda: phase_serve_bf16(report, ctx, dev)),
              ("train_setup", lambda: ctx.update(train=train_setup(dev))),
              ("train_vs_twin", lambda: phase_train_vs_twin(ctx)),
              ("train", lambda: phase_train(report, ctx)),
              ("serve_sort",
               lambda: phase_serve_sort(report, ctx, dev, workdir)),
              ("free", lambda: (ctx.pop("train"), ctx.pop("trained"),
                                torch.cuda.empty_cache())),
              ("splats", lambda: phase_splats(report, dev, workdir)),
              ("cli", lambda: phase_cli(report, ctx, dev, workdir)),
              ("frame_vs_twin", lambda: phase_frame_vs_twin(ctx, dev)),
              ("frames", lambda: phase_frames(ctx, dev)),
              ("r2_band_route", lambda: phase_r2_band_route(dev)),
              ("kernel_bench", lambda: phase_kernel_bench(report, dev)),
              ("report", lambda: check_report(report))]
    for name, fn in phases:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        print(f"[phase] {name} ok in {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(smi)
    print(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
