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
   packing its weight on every call;
11. ``apps`` (after ``cli``, on its best ``sort`` checkpoint and drive):
   ``read_tpu_torch.baseline_configs``' config 1 over all 20 poses
   (device rate back to back, the rate with the host download, val
   PSNR/SSIM on ``split_by_step``'s val frames; K5, the pass and both
   wgmma loops as the routes predict for every frame), config 4
   bit-equal to the unsplit frame with the mapped index pyramid equal,
   config 5 (boxes inside ``drive_world`` over 1000 points each; the
   edited frame differs and matches its all-twin frame; the 3-view
   panorama at 3648x368); one ``supersampling=2`` request (its pyramid
   at 2432x736 and net input bit-equal to the twins', the frame within
   5e-4/1e-3 of its all-twin frame), timed beside an ss=1 request; and
   every raw mode on the drive with seeded normals (one K5 and pass
   launch, no conv; gathers bit-equal to the CPU on the card's maps,
   float modes within the CPU tests' bounds), each timed;
12. ``extra_modes``: ``depth`` + ``normals_l`` at every scale at the
   bench point (12 input channels): 3 train steps against their twins
   (pyramids and extra maps bit-equal, loss rel 1e-6, gradients 2e-4 x
   max|g|), 7 timed with the loss falling; 2 requests at 1216x368 from
   the trained state, request 0 within 5e-4/1e-3 of its all-twin frame,
   each K2/K3/K4 wrapper and wgmma loop launched as the width
   predicates give (``predicted_conv_calls``: 79 K2 calls on its loop
   and 3, not 9, on the 1x1 loop a frame), timed beside serve_sort's
   8-channel checkpoint on the same scene;
13. ``augment``: K1, K5 and the splat projection with the NDC jitter
   (``rasterize_kernels``' ``jitter``) bit-equal to their twins at 1M
   points, 1216x368 B=1 and 2 and 256x256 B=8, with 1 px and 16 px of
   jitter (centres past every edge), the pyramid in all four
   combinations too; each timed at the step's shape beside itself
   without the jitter; then the augmented step (``drop_points`` 0.1,
   ``perturb_points`` 1.0: values no recipe sets, chosen to exercise the
   path) at the bench point with ``sort`` (K5), ``pallas`` (K1) and
   ``uv_1d_p3`` (the splat): 3 steps against their twins with the same
   draws, 7 timed beside the same step without the augmentation, one
   jittered projection and one pass a step, the loss falling;
14. ``mesh``: the street of ``drive_world`` as a 0.79M-face mesh
   (``mesh_street``): the triangle raster at 1216x368 timed with its
   peak memory growth; ``use_mesh`` train steps (texture 512, 8
   channels, the full-width UNet) with faces (no kernel of the port
   runs in them), 3 then 7 timed, the loss falling, beside the steps
   without faces (K5 and the uv gather: 3 against their twins,
   pyramids bit-equal, then 7 timed); 2 requests from the trained
   ``use_mesh`` checkpoint with faces (request 0 within 5e-4/1e-3 of
   its all-twin frame, K2/K3/K4 as their routes predict, no z-buffer)
   and 1 without faces (K5);
15. ``alt_pipelines``: pix2pix at the bench point (3 steps against their
   twins, 7 timed), rgb_texture on the street mesh with and without
   faces (timed; without faces K5's uv maps bit-equal to the twins' and
   a step's loss within 1e-6), and both CLIs (``--pipeline pix2pix`` on the cli
   phase's ``drive_a``, ``--pipeline rgb_texture --use-mesh`` on the
   street mesh written to disk with its manifest naming the mesh): 1
   epoch of 8 steps, then ``--resume`` for one more, the checkpoints as
   ``read_tpu.train``'s rules leave them, val PSNR printed.
16. ``sharded`` (after ``viewer``): ``rasterize_kernels.zbuffer_pool``,
   the pass alone on given exact keys, bit-equal to its twin at the
   bench point (and on an empty buffer), timed with its bound; the
   sharded step (``parallel.sharded``) at the bench point on a 1x1 mesh
   on NCCL (one spawned rank: pyramids bit-equal, loss and gradients
   within 1e-6 relative of the unsharded step, both timed in one
   window) and on 1x2 and 2x1 meshes of two gloo ranks sharing the card
   (merged pyramids bit-equal to the unsharded K5 pyramid, first loss
   within 1e-4 of the unsharded step's, one bf16 1x2 loss within 1e-3
   of the unsharded bf16 step's; ms/step, peak memory and the
   collectives' ms per rank; K5, the one-level pass and
   ``zbuffer_pool`` once per rank and step, counted in the ranks); then
   ``--mesh 1x2`` through the CLI for one short epoch of ``drive_a``,
   whose unsharded checkpoint serves one request. Two ranks on one card
   are no scaling result.
17. ``raster_methods`` (after ``serve_sort``): the quantized key of
   'sort1q' (``rasterize_kernels.zbuffer_quant``: a third key mode of the
   projection, the splat and the pass) bit-equal to its twin at 1M
   points, 1216x368 B=1 and 2, with heavy ties, and 256x256 B=8: one
   level, 4-level pyramids with both pools, with a 1 px jitter and as an
   r=1 splat, each call one projection (``zbuffer_quant``,
   ``zbuffer_quant_jitter``, ``zbuffer_splat``) and one pass; timed at
   the frame's shape (events and a CUDA graph) beside its twin,
   ``scatter_reduce_`` and its bound; 'sort2' and 'scatter' launch K5
   (r=1: the splat) and the pass and equal 'sort'; the pixels where
   'sort1q' keeps another winner than 'sort' at 1216x368 (the frame, and
   500k near-duplicate pairs); one 'sort1q' request through
   ``NeuralRenderer`` against its all-twin frame (``zbuffer_quant``'s
   launches); 3 'vgg_ens' train steps (K = 3) at the bench point beside 3
   'vgg' steps from the same state, ms/step and peak memory, the
   ensemble's loss falling.

"The loss falling" (``loss_fell``): the mean of the last 3 timed
losses below the mean of the phase's 3 steps from its fresh state, and
the last below the first.

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
steps, the quantized key (``zbuffer_quant``) on the 'sort1q' request,
K6's splat projection (``zbuffer_splat``) on the ``uv_1d_p3``
requests (``train_launches``: its training steps), ``zbuffer_keys``
(K6's given-key kernel), K7 and K8 on
the kernel bench's first pass, K8's on K2's wgmma loop with its tile-loop
launches as ``tile_launches``; K2's loop also on the bf16 requests,
``bf16_launches``), K1, K5 and the splat projection once more as
their jitter variants (``zbuffer_jitter``, ``zbuffer_exact_jitter``,
``zbuffer_splat_jitter``: launches on the augmented steps, times at
the step's shape beside ``unjittered_ms``), ``zbuffer_pool`` (the pass
on given keys: launches on the 1x1 mesh's timed steps, counted in its
rank; ``library_ms`` null), error, its time, its
twin's, the library call's and
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
    # 'sort1q' (read_tpu/ops/rasterize.py:204-241): the quantized key, a
    # third key mode of K5's projection, the splat and the pass
    "zbuffer_quant": ("read_tpu_torch/csrc/zbuffer.cu",
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
    # K1, K5 and the splat projection run with the NDC jitter of the
    # augmented step (read_tpu/ops/rasterize.py:328-331, fed by
    # read_tpu/ops/augment.py), counted apart
    "zbuffer_jitter": ("read_tpu_torch/csrc/zbuffer.cu",
                       "read_tpu/ops/rasterize_pallas.py:145"),
    "zbuffer_exact_jitter": ("read_tpu_torch/csrc/zbuffer.cu",
                             "read_tpu/ops/rasterize_pallas.py:40"),
    "zbuffer_splat_jitter": ("read_tpu_torch/csrc/zbuffer.cu",
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
    # the pass alone on the merged keys of the multi-device z-merge
    # (read_tpu/parallel/sharded.py:84-97 pools with rasterize.py:574),
    # K5's output stage
    "zbuffer_pool": ("read_tpu_torch/csrc/zbuffer.cu",
                     "read_tpu/ops/rasterize_pallas.py:40"),
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
                      (RK, "zbuffer_quant", RK.zbuffer_quant),
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


def check_pyramids(label, xyz, ms, hw, jitter=None):
    """``RK.zbuffer_pyramid`` to 4 levels in every combination of
    z-buffer and pool against its twin, every level bit-equal; each call
    launches one projection (its jitter variant with ``jitter``) and one
    pass."""
    import torch
    from read_tpu_torch.ops import rasterize_kernels as RK
    for method, pool in itertools.product(("pallas", "sort"),
                                          ("packed", "exact")):
        before = dict(RK.launches)
        got = RK.zbuffer_pyramid(xyz, ms, *hw, 4, method, pool,
                                 jitter=jitter)
        ran = {k: v - before[k] for k, v in RK.launches.items()
               if v != before[k]}
        proj = "zbuffer_exact" if method == "sort" else "zbuffer"
        if jitter is not None:
            proj += "_jitter"
        if ran != {proj: 1, "zbuffer_pyramid": 1}:
            raise SmokeFailure(f"pyramid {method}+{pool} {label}: launches "
                               f"{ran}")
        want = RK.zbuffer_pyramid_plain(xyz, ms, *hw, 4, method, pool,
                                        jitter=jitter)
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
                         {**state.layout.views(g_net), "texture": g_tex[0]}))
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


# the quantized key's checks at 1M points: (label, views, hw, ties)
QUANT_CASES = (("B=1", 1, HW, False), ("B=2", 2, HW, False),
               ("B=1 ties", 1, HW, True),
               (f"B={TRAIN_B}", TRAIN_B, (TRAIN_HW, TRAIN_HW), False))
ENS_STEPS = 3    # timed vgg_ens (and vgg) steps, after one warm-up


def _ran(before):
    return {k: v - before[k] for k, v in launches().items()
            if v != before[k]}


def quant_vs_twin(label, xyz, ms, hw, dev):
    """The quantized key ('sort1q') bit-equal to its twin: one level
    (``zbuffer_quant``), the 4-level pyramid with both pools, the same
    with a 1 px jitter and as an r = 1 splat; each call one projection
    (its counter) and one pass."""
    import torch
    from read_tpu_torch.ops import rasterize_kernels as RK
    jit = jitter_for(xyz.shape[0], 1.0, hw, dev)
    calls = [("one level", "zbuffer_quant",
              lambda: RK.zbuffer_quant(xyz, ms, *hw),
              lambda: RK.zbuffer_quant_plain(xyz, ms, *hw))]
    for pool in ("exact", "packed"):
        args = (xyz, ms, *hw, 4, "sort1q", pool)
        calls += [
            (f"{pool} pool", "zbuffer_quant",
             lambda a=args: RK.zbuffer_pyramid(*a),
             lambda a=args: RK.zbuffer_pyramid_plain(*a)),
            (f"{pool} pool, 1 px jitter", "zbuffer_quant_jitter",
             lambda a=args: RK.zbuffer_pyramid(*a, jitter=jit),
             lambda a=args: RK.zbuffer_pyramid_plain(*a, jitter=jit)),
            (f"{pool} pool, r=1 splat", "zbuffer_splat",
             lambda a=args: RK.zbuffer_splat(*a, 1),
             lambda a=args: RK.zbuffer_splat_plain(*a, 1))]
    for what, proj, fn, twin in calls:
        before = launches()
        got = fn()
        ran = _ran(before)
        if ran != {proj: 1, "zbuffer_pyramid": 1}:
            raise SmokeFailure(f"sort1q {label} {what}: launches {ran}")
        want = twin()
        torch.cuda.synchronize()
        got, want = ((got,), (want,)) if what == "one level" else (got, want)
        for lv, ((ig, dg), (iw, dw)) in enumerate(zip(got, want)):
            if not (torch.equal(ig, iw) and torch.equal(dg, dw)):
                raise SmokeFailure(
                    f"sort1q {label} {what} level {lv}: differs from the "
                    f"twin at {int((ig != iw).sum())} indices, "
                    f"{int((dg != dw).sum())} depths")
    print(f"[raster_methods] sort1q {label} N={xyz.shape[0]} {hw[1]}x"
          f"{hw[0]}: bit-equal to the twin (one level; 4 levels, exact and "
          "packed pools, also with a 1 px jitter and as an r=1 splat)")


def phase_raster_methods(report, ctx, dev):
    """read_tpu's last raster methods and the VGG ensemble on the card:
    the quantized key ('sort1q') bit-equal to its twin at 1M points
    (``QUANT_CASES``) and timed; the launches of each method; where
    'sort1q' picks other winners than 'sort' at 1216x368; one 'sort1q'
    request through ``NeuralRenderer`` against its all-twin frame; and
    ``ENS_STEPS`` 'vgg_ens' train steps (K = 3) at the bench point beside
    as many 'vgg' steps from the same state."""
    import torch
    from read_tpu_torch import kernel_bench as KB
    from read_tpu_torch.criterions import vgg as V
    from read_tpu_torch.frame import frame_inputs, train_inputs
    from read_tpu_torch.kernel_bench import event_ms, graph_ms
    from read_tpu_torch.ops import rasterize as R
    from read_tpu_torch.ops import rasterize_kernels as RK
    from read_tpu_torch.pipelines import texture_pipeline as TP
    from read_tpu_torch.render import NeuralRenderer
    for label, b, hw, ties in QUANT_CASES:
        if hw == HW:
            xyz, ms = frame_inputs(1 if ties else b, N_POINTS, hw)
            if ties:   # every position 4 times: exact depth ties
                xyz = np.tile(xyz[:N_POINTS // 4], (4, 1))
        else:
            xyz, ms, _ = train_inputs(b, N_POINTS, hw[0])
        quant_vs_twin(label, torch.from_numpy(xyz).to(dev),
                      torch.from_numpy(ms).to(dev), hw, dev)
    # the frame's shape: timed, with its library call and bound
    xyz, ms = (torch.from_numpy(a).to(dev)
               for a in frame_inputs(1, N_POINTS, HW))
    row = report["zbuffer_quant"]
    row.update(ms=event_ms(lambda: RK.zbuffer_quant(xyz, ms, *HW), iters=20),
               graph_ms=graph_ms(lambda: RK.zbuffer_quant(xyz, ms, *HW)),
               plain_ms=event_ms(lambda: RK.zbuffer_quant_plain(xyz, ms, *HW),
                                 iters=20),
               max_abs_err=0.0, db=RK.quant_bits(HW[0] * HW[1])[0],
               shape=f"B=1 N={N_POINTS} {HW[1]}x{HW[0]}, one level",
               semantics="read_tpu/ops/rasterize.py:204")
    library_and_bound(row, *KB.zbuffer_yardsticks(xyz, ms, HW)[2][
        "zbuffer_quant"])
    # each method's kernels, 1 px and r = 1
    want = {"sort2": "zbuffer_exact", "scatter": "zbuffer_exact",
            "sort1q": "zbuffer_quant"}
    levels = {}
    for method, proj in want.items():
        for r in (0, 1):
            before = launches()
            levels[method, r] = R.rasterize_pyramid_pooled(
                xyz, ms, HW, 4, r, method)
            ran = _ran(before)
            if ran != {proj if r == 0 else "zbuffer_splat": 1,
                       "zbuffer_pyramid": 1}:
                raise SmokeFailure(f"{method} r={r}: launches {ran}")
    for r in (0, 1):
        sort = R.rasterize_pyramid_pooled(xyz, ms, HW, 4, r, "sort")
        for method in ("sort2", "scatter"):
            if not all(torch.equal(a, b) for lv, lw in zip(
                    levels[method, r], sort) for a, b in zip(lv, lw)):
                raise SmokeFailure(f"{method} r={r}: differs from 'sort'")
    # where 'sort1q' keeps another winner than 'sort': the frame's scene,
    # and pairs of points 1e-5 of the way apart on one ray
    i_q, i_s = levels["sort1q", 0][0][0], R.rasterize_batch(
        xyz, ms, *HW)[0]
    pairs = xyz[:N_POINTS // 2]
    pairs = torch.stack([pairs, pairs * (1.0 - 1e-5)], 1).reshape(-1, 3)
    p_q = R.rasterize_batch(pairs, ms, *HW, method="sort1q")[0]
    p_s = R.rasterize_batch(pairs, ms, *HW)[0]
    frame_diff, pair_diff = int((i_q != i_s).sum()), int((p_q != p_s).sum())
    covered = int((p_s >= 0).sum())
    if pair_diff == 0:
        raise SmokeFailure("sort1q picked the same winners as sort on the "
                           "near-duplicate pairs")
    print(f"[raster_methods] sort2/scatter: K5 and the pass (r=0; r=1 the "
          f"splat), bit-equal to 'sort'; sort1q ({row['db']} depth bits at "
          f"{HW[1]}x{HW[0]}) picks another winner than sort at "
          f"{frame_diff} pixels of the 1M-point frame and at {pair_diff} of "
          f"{covered} covered pixels of {N_POINTS // 2} near-duplicate "
          f"pairs; kernel {row['ms']:.4f} ms (in a CUDA graph "
          f"{row['graph_ms']:.4f}), twin {row['plain_ms']:.4f}, "
          f"scatter_reduce_ {row['library_ms']:.4f}, bound "
          f"{row['bound_ms']:.4f} ({row['bound_by']})")
    # one 'sort1q' request, against its all-twin frame
    scene, poses, ckpt = ctx["serve"]
    r = NeuralRenderer(scene, ckpt, raster_method="sort1q", device=dev)
    r.infer(poses[0])
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    img = r.infer(poses[1])
    ms_req = (time.perf_counter() - t0) * 1e3
    counts = launches()
    pyramid_ran("raster_methods request", counts, "zbuffer_quant", 1)
    row["launches"] = counts["zbuffer_quant"]
    with Twins():
        want_img = NeuralRenderer(scene, ckpt, raster_method="sort1q",
                                  device=dev).infer(poses[1])
    err = float(np.abs(img - want_img).max())
    if img.shape != (HW[0], HW[1], 3) or not np.isfinite(img).all() or \
            not np.allclose(img, want_img, **FRAME_TOL):
        raise SmokeFailure(f"sort1q request: {img.shape}, max |err| {err} "
                           "from the all-twin frame")
    print(f"[raster_methods] sort1q request through NeuralRenderer: "
          f"{ms_req:.2f} ms, max |err| {err:.3g} from the all-twin frame; "
          f"launches {counts}")
    # vgg_ens (K = 3, as the CLI builds it) beside vgg, from one state
    net, cfg, vgg, state, xyz_t, batch = ctx["train"]
    ens = [V.random_vgg_params(torch.Generator().manual_seed(k), device=dev)
           for k in range(3)]
    runs = {}
    for name, c, params in (
            ("vgg_ens", dataclasses.replace(cfg, vgg_ensemble=3), ens),
            ("vgg", cfg, vgg)):
        step = TP.make_train_step(net, c, params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        st, losses = state, []
        for i in range(1 + ENS_STEPS):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            st, metrics = step(st, xyz_t, batch)
            losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        runs[name] = ((time.perf_counter() - t0) / ENS_STEPS * 1e3, losses,
                      torch.cuda.max_memory_allocated() / 2 ** 30)
    ms_e, losses, peak_e = runs["vgg_ens"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SmokeFailure(f"vgg_ens: losses {losses} not finite or not "
                           "lower at the end")
    ctx["vgg_ens_ms"] = ms_e
    print(f"[raster_methods] vgg_ens (K=3) at the bench point "
          f"({TRAIN_B}x{TRAIN_HW}^2, {N_POINTS} points, 'sort'): "
          f"{ms_e:.2f} ms/step, peak {peak_e:.2f} GiB, loss "
          f"{losses[0]:.6g} -> {losses[-1]:.6g}; vgg {runs['vgg'][0]:.2f} "
          f"ms/step, peak {runs['vgg'][2]:.2f} GiB (mean of {ENS_STEPS} "
          "after 1 warm-up, same window)")


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


def loss_fell(what, head, losses):
    """Fail unless the timed window's ``losses`` are finite and fall
    below ``head``, the losses of the phase's first ``SPLAT_VS_TWIN``
    steps from its fresh state: the mean of the window's last 3 below the
    mean of ``head``, and its last below ``head[0]``. The window alone
    is no test: the step's loss moves by up to ~14% from one step to the
    next, so a 7-step window falls in some runs and not in others
    (PERF.md section 5)."""
    losses = [float(x) for x in losses]
    before = float(np.mean([float(x) for x in head]))
    tail = float(np.mean(losses[-3:]))
    if not all(np.isfinite(losses)) or not tail < before \
            or not losses[-1] < float(head[0]):
        raise SmokeFailure(f"{what}: losses {losses} not finite or not "
                           f"below the first steps' (mean of the last 3 "
                           f"{tail:.6g}, of the first {len(head)} steps "
                           f"{before:.6g}; first step {float(head[0]):.6g})")
    return losses


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
            before = dict(GC.launches)
            got = kernel(x, w, b, scale, offset, res, **kw)
            ran = tuple(GC.launches[k] - before[k] for k in (
                "gated_conv_kxk_wgmma", "gated_conv_kxk_wgmma_tma"))
            if ran != (wgmma, wgmma and not bf16):
                raise SmokeFailure(f"{name} {xs} {ws} {ops}: the wgmma "
                                   f"loop and its f32 kernel ran {ran} "
                                   f"times, route {route}")
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
                                                    (table,)),
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
    report["gated_conv_kxk_wgmma"]["tma_launches"] = counts[
        "gated_conv_kxk_wgmma_tma"]
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
    routed_loops_ran(ctx, "serve_bf16", counts, len(imgs), "bf16")
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


def _routed(ctx, ops="f32"):
    """Each wgmma loop's launches per frame with ``ops`` operands, as its
    route predicts: K2's (``kxk_route``, 79), all of them on its f32
    kernel (``gated_conv_kxk_wgmma_tma``: A copied raw by TMA im2col) with
    f32 operands and none with bf16, and the 1x1 loop's
    (``conv1x1_route``, 9)."""
    k2 = ctx["wgmma_per_frame"]
    return (("gated_conv_kxk_wgmma", k2),
            ("gated_conv_kxk_wgmma_tma", k2 if ops == "f32" else 0),
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


def routed_loops_ran(ctx, what, counts, requests, ops="f32"):
    """Fail unless both wgmma loops (and K2's f32 kernel) ran exactly as
    often as their routes predict for ``requests`` frames with ``ops``
    operands."""
    for name, per_frame in _routed(ctx, ops):
        if counts[name] != requests * per_frame:
            raise SmokeFailure(f"{what}: {name} ran {counts[name]} times, "
                               f"the route predicts {requests * per_frame}")


def loops_ran(ctx, what, fn, ops="f32"):
    """Run ``fn()`` (one frame call with ``ops`` operands); fail unless
    both wgmma loops (and K2's f32 kernel) ran at least as often as their
    routes predict for it (K2's f32 kernel not at all with bf16), and K1
    and the pyramid pass once each."""
    from read_tpu_torch.ops import gated_conv as GC
    from read_tpu_torch.ops import rasterize_kernels as RK
    before = dict(GC.launches)
    before_rk = dict(RK.launches)
    out = fn()
    for name, want in _routed(ctx, ops):
        ran = GC.launches[name] - before[name]
        if ran < want or (want == 0 and ran != 0):
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
                            lambda: frame_fn(*args), ops)
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
        got = loops_ran(ctx, f"frame_vs_twin {ops}", lambda: frame_fn(*args),
                        ops)
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
                                                    (table,)),
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
    worst, head = 0.0, []
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
                         {**state.layout.views(g_net), "texture": g_tex[0]}))
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
        head.append(loss_k)
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
    losses = loss_fell("splat train", head, losses)
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
          f"at r = 0 after them {p1_s * 1e3:.2f}; loss {float(head[0]):.6g} "
          f"(fresh state) -> {losses[0]:.6g} -> {losses[-1]:.6g}; launches "
          f"{counts}")


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
    from read_tpu_torch.scene import io as IO
    h, w = hw
    d = os.path.join(root, name)
    os.makedirs(os.path.join(d, "images"), exist_ok=True)
    xyz, colors = drive_world(np.random.default_rng(seed), n_points)
    rgb8 = (colors * 255).astype(np.uint8)
    IO.write_ply(os.path.join(d, "pc.ply"), xyz, rgb8)
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


def expected_checkpoints(history, names, save_freq, keep=3,
                         metric=lambda h: h["val_loss"]):
    """The checkpoint dirs ``read_tpu.train``'s rules leave after the
    epochs of ``history``: ``ckpt_<scene>_<epoch>`` at every
    ``save_freq``-th epoch and at every improvement of ``metric`` (lower
    is better: the val loss, or minus the val PSNR under
    ``--plateau-metric psnr``), the newest ``keep`` kept, and
    ``best_<scene>`` after an improvement."""
    best, kept, out = float("inf"), [], set()
    for h in history:
        if h["epoch"] % save_freq == 0 or metric(h) < best:
            kept = (kept + [h["epoch"]])[-keep:]
        if metric(h) < best:
            best = metric(h)
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
    ctx["cli_recipe"] = recipe
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
        ctx["drive"] = (paths["datasets"][scene]["scene_path"],
                        os.path.join(ck, f"best_{scene}"),
                        paths["datasets"][scene]["target_path"])
        r = NeuralRenderer(*ctx["drive"][:2], device=dev)
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


# ---------------------------------------------------------------------------
# The scene applications (configs 1/4/5), supersampling and the raw modes
# on the CLI's drive; extra input modalities at the bench point
# ---------------------------------------------------------------------------

# edit boxes inside drive_world (its street runs along -z): a stretch of
# the left facade near the first pose, deleted, and a stretch of the right
# facade further on, copied 6 m towards the road
APPS_DELETE = ((-7.6, 0.0, -20.0), (-7.0, 9.0, -10.0))
APPS_COPY = ((7.0, 0.0, -40.0), (7.6, 4.0, -30.0))
APPS_SHIFT = (-6.0, 0.0, 0.0)
RAW_MODES = ("colors", "xyz", "depth", "uv_1d", "labels", "pca",
             "normals_m", "normals_l", "normals_r", "normals_d", "lit")
# the float modes' bounds of tests/test_torch_render_modes.py; the rest
# gather, bit-equal
RAW_TOL = {"normals_l": 2e-7, "normals_r": 2e-7, "normals_d": 2e-7,
           "lit": 5e-6}
EXTRA_FORMAT = ", ".join(f"uv_1d_p1{s}, depth{s}, normals_l{s}"
                         for s in [""] + [f"_ds{i}" for i in range(1, 5)])
CONV_CALLS = ("gated_conv_kxk", "gated_conv_kxk_wgmma", "gated_conv_1x1",
              "gated_conv_1x1_cat", "gated_conv_1x1_wgmma")


def predicted_conv_calls(cin):
    """The K2/K3/K4 calls of one frame of a full-width UNet with ``cin``
    input channels, and those the route predicates send to the two wgmma
    loops, on widths alone (``kxk_route``: ``Cin % 32 == 0`` and ``Cout %
    8 == 0``; ``conv1x1_route``: gated, every ``C_j % 8 == 0`` and ``Cout
    % 8 == 0``; every tensor aligned, as the serving path's are): the net
    runs once on the CPU at 16x16 with counting shims around the three
    wrappers. Keys as ``ops.gated_conv.launches``."""
    import torch
    from read_tpu_torch.models.unet import UNet
    from read_tpu_torch.ops import gated_conv as GC
    calls = dict.fromkeys(CONV_CALLS, 0)
    saved = (GC.gated_conv_kxk, GC.gated_conv_1x1, GC.gated_conv_1x1_cat)

    def loop(cins, cout, gated=True):
        return int(gated and cout % 8 == 0 and all(c % 8 == 0 for c in cins))

    def kxk(x, w, *a, **k):
        calls["gated_conv_kxk"] += 1
        calls["gated_conv_kxk_wgmma"] += int(
            w.shape[-2] % 32 == 0 and (w.shape[-1] // 2) % 8 == 0)
        return saved[0](x, w, *a, **k)

    def k3(x, w, *a, **k):
        calls["gated_conv_1x1"] += 1
        calls["gated_conv_1x1_wgmma"] += loop([x.shape[-1]],
                                              w.shape[-1] // 2)
        return saved[1](x, w, *a, **k)

    def k4(xs, w, *a, **k):
        gated = k.get("gated", True)
        calls["gated_conv_1x1_cat"] += 1
        calls["gated_conv_1x1_wgmma"] += loop(
            [x.shape[-1] for x in xs], w.shape[-1] // (2 if gated else 1),
            gated)
        return saved[2](xs, w, *a, **k)

    net = UNet(num_input_channels=cin).init_weights(
        torch.Generator().manual_seed(0))
    GC.gated_conv_kxk, GC.gated_conv_1x1, GC.gated_conv_1x1_cat = (
        kxk, k3, k4)
    try:
        net(*[torch.zeros(1, 16 >> i, 16 >> i, cin) for i in range(4)])
    finally:
        GC.gated_conv_kxk, GC.gated_conv_1x1, GC.gated_conv_1x1_cat = saved
    return calls


def conv_calls_ran(what, counts, predicted, requests):
    """Fail unless each K2/K3/K4 wrapper and each wgmma loop launched
    ``requests`` times its ``predicted`` calls a frame."""
    want = {k: requests * v for k, v in predicted.items()}
    got = {k: counts[k] for k in CONV_CALLS}
    if got != want:
        raise SmokeFailure(f"{what}: conv launches {got}, the routes "
                           f"predict {want}")


def phase_apps(report, ctx, dev, workdir):
    """Configs 1, 4 and 5 (``read_tpu_torch.baseline_configs``) on the
    CLI's best ``sort`` checkpoint and its drive (1M points, 1216x368,
    PNG targets): config 1 over all 20 poses (K5, the pass and both wgmma
    loops as often as the routes predict for every frame), config 4
    bit-equal to the unsplit frame with the mapped index pyramid equal,
    config 5's edit (each box over 1000 points; the frame changes and
    matches its all-twin frame) and its 3-view panorama; then one
    ``supersampling=2`` request and every raw mode."""
    import torch
    from read_tpu_torch import baseline_configs as BC
    from read_tpu_torch.kernel_bench import max_err
    from read_tpu_torch.render import NeuralRenderer
    t_phase = time.perf_counter()
    scene, ckpt, targets = ctx["drive"]
    out = os.path.join(workdir, "apps")
    os.makedirs(out, exist_ok=True)
    r = NeuralRenderer(scene, ckpt, device=dev)
    if r.cfg.raster_method != "sort":
        raise SmokeFailure(f"apps: config says {r.cfg.raster_method}")
    views = [np.asarray(v) for v in r.scene_data["view_matrix"]]
    torch.cuda.synchronize()
    reset_launches()
    c1 = BC.config1_trajectory(r, targets,
                               DEMO_DRIVE["splitter_args"]["val_step"], out)
    frames = 2 * len(views) + 1    # warm-up, device rate, host rate
    counts = launches()
    pyramid_ran("apps config 1", counts, "zbuffer_exact", frames)
    routed_loops_ran(ctx, "apps config 1", counts, frames)
    if c1["frames"] != CLI_POSES or c1["n_val"] != 2 or not np.isfinite(
            [c1["val_psnr_mean"], c1["val_ssim_mean"]]).all():
        raise SmokeFailure(f"apps config 1: {c1}")
    c4 = BC.config4_stitch(r, views[0], out=out)
    if not (c4["bit_equal"] and c4["index_pyramid_equal"]):
        raise SmokeFailure(f"apps config 4 on sort: not exact ({c4}; "
                           f"{c4['tied_pixels']} differing pixels at exact "
                           "depth ties)")
    unedited = r.infer(views[0])
    c5 = BC.config5_edit_panorama(r, views[0], views[len(views) // 2],
                                  APPS_DELETE, APPS_COPY, APPS_SHIFT,
                                  out=out)
    edited, pano = c5.pop("images")
    if min(c5["deleted_points"], c5["copied_points"]) <= 1000:
        raise SmokeFailure(f"apps config 5: boxes select {c5}")
    if not float(np.abs(edited - unedited).max()) > 0:
        raise SmokeFailure("apps config 5: the edit changed no pixel")
    with Twins():
        twin = r.infer(views[0])
    err5 = max_err("apps config 5 edited frame vs twins",
                   torch.from_numpy(edited), torch.from_numpy(twin),
                   (FRAME_TOL,))
    if pano.shape != (HW[0], 3 * HW[1], 3) or not np.isfinite(pano).all():
        raise SmokeFailure(f"apps config 5: panorama {pano.shape}")
    del r
    torch.cuda.empty_cache()
    ctx["apps"] = {"config1": c1, "config4": c4, "config5": c5}
    print(f"[apps] config 1 (trajectory, {c1['frames']} poses at "
          f"{HW[1]}x{HW[0]}, {N_POINTS} points, sort): device "
          f"{c1['device_ms']:.3f} ms/frame ({c1['fps_device']:.2f} fps, "
          f"back to back, one sync), with the host download "
          f"{c1['host_ms']:.3f} ms/frame "
          f"({c1['fps_with_host_download']:.2f} fps); val PSNR "
          f"{c1['val_psnr_mean']:.4f} SSIM {c1['val_ssim_mean']:.4f} over "
          f"{c1['n_val']} val frames (split_by_step)")
    print(f"[apps] config 4 (split at the median z, re-stitched): "
          f"bit-equal to the unsplit frame, index pyramid equal at 4 "
          f"levels; {c4['device_ms']:.3f} ms/frame "
          f"({c4['fps_device']:.2f} fps)")
    print(f"[apps] config 5: {c5['deleted_points']} points deleted, "
          f"{c5['copied_points']} copied ({c5['points']} now): "
          f"{c5['edited_device_ms']:.3f} ms/frame "
          f"({c5['edited_fps_device']:.2f} fps); vs all-twin max |err| "
          f"{err5:.3g}; panorama {c5['panorama_views']} views, "
          f"{c5['panorama_px'][1]}x{c5['panorama_px'][0]} in "
          f"{c5['panorama_ms']:.2f} ms (with the host downloads)")
    apps_supersampled(ctx, dev, scene, ckpt, views)
    apps_raw_modes(dev, scene, ckpt, views)
    print(f"[apps] phase {time.perf_counter() - t_phase:.1f} s")


def apps_supersampled(ctx, dev, scene, ckpt, views):
    """One ``supersampling=2`` request: its index pyramid (2432x736, 4
    levels) and net input bit-equal to the twins', the frame within
    ``FRAME_TOL`` of its all-twin frame, K5, the pass and both wgmma
    loops as the routes predict; timed beside an ss=1 request."""
    import torch
    from read_tpu_torch.kernel_bench import max_err
    from read_tpu_torch.render import NeuralRenderer
    r1 = NeuralRenderer(scene, ckpt, device=dev)
    r2 = NeuralRenderer(scene, ckpt, supersampling=2, device=dev)
    pose = views[5]
    idx, pyr = r2.index_pyramid(pose), r2.pyramid(pose)
    with Twins():
        idx_t, pyr_t = r2.index_pyramid(pose), r2.pyramid(pose)
    if tuple(idx[0].shape) != (1, 2 * HW[0], 2 * HW[1]) or \
            tuple(pyr[0].shape) != (1, *HW, 8):
        raise SmokeFailure(f"apps ss=2: index {tuple(idx[0].shape)}, net "
                           f"input {tuple(pyr[0].shape)}")
    max_err("apps ss=2 index pyramid vs twin", idx, idx_t, None)
    max_err("apps ss=2 net input vs twin", pyr, pyr_t, None)
    torch.cuda.synchronize()
    reset_launches()
    img = r2.infer(pose)
    counts = launches()
    pyramid_ran("apps ss=2", counts, "zbuffer_exact", 1)
    routed_loops_ran(ctx, "apps ss=2", counts, 1)
    with Twins():
        twin = r2.infer(pose)
    err = max_err("apps ss=2 frame vs twins", torch.from_numpy(img),
                  torch.from_numpy(twin), (FRAME_TOL,))
    ms2 = wall_ms(lambda: r2.infer_device(pose))
    ms1 = wall_ms(lambda: r1.infer_device(pose))
    ctx["apps"].update(ss2_ms=ms2, ss1_ms=ms1)
    print(f"[apps] supersampling 2: pyramid at {2 * HW[1]}x{2 * HW[0]} "
          f"bit-equal to its twin at 4 levels (index and net input); "
          f"frame vs all-twin max |err| {err:.3g}; {ms2:.3f} ms/request "
          f"beside {ms1:.3f} at ss=1 (median of 5, each synced); "
          f"launches {counts}")


def apps_raw_modes(dev, scene, ckpt, views):
    """Every raw mode of ``NeuralRenderer.render_mode`` on the drive with
    seeded per-point unit normals added: one K5 and one pass launch per
    frame and no conv, and against the same call with ``device='cpu'``
    on the card's index and depth maps (gathers bit-equal, float modes
    within ``RAW_TOL``); each timed."""
    import torch
    from read_tpu_torch.kernel_bench import max_err
    from read_tpu_torch.render import NeuralRenderer
    from read_tpu_torch.scene.io import load_scene_data
    data = load_scene_data(scene)
    n = len(data["pointcloud"]["xyz"])
    normals = np.random.default_rng(7).normal(size=(n, 3)).astype(
        np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    data["pointcloud"] = dict(data["pointcloud"], normals=normals)
    rr = NeuralRenderer(data, ckpt, device=dev)
    rc = NeuralRenderer(data, ckpt, device="cpu")
    pose = views[3]
    idx, dep = rr.raster(pose)
    rc.raster = lambda view, K=None: (idx.cpu(), dep.cpu())
    times = {}
    for mode in RAW_MODES:
        torch.cuda.synchronize()
        reset_launches()
        got = rr.render_mode(mode, pose)
        counts = launches()
        if (counts["zbuffer_exact"], counts["zbuffer_pyramid"]) != (1, 1) \
                or any(counts[k] for k in CONV_CALLS):
            raise SmokeFailure(f"apps raw {mode}: launches {counts}")
        tol = ((dict(atol=RAW_TOL[mode], rtol=0),) if mode in RAW_TOL
               else None)
        max_err(f"apps raw {mode} card vs cpu", torch.from_numpy(got),
                torch.from_numpy(rc.render_mode(mode, pose)), tol)
        times[mode] = wall_ms(lambda: rr.render_mode(mode, pose), iters=3,
                              warmup=1)
    print(f"[apps] raw modes at {HW[1]}x{HW[0]}, {n} points (K5 + the "
          "pass, gather, host download; gathers bit-equal to the CPU on "
          "the card's maps, float modes within "
          f"{RAW_TOL}): " + ", ".join(f"{m} {t:.3f}" for m, t in
                                      times.items()) + " ms")


def phase_extra_modes(report, ctx, dev, workdir):
    """Extra input modalities at the bench point (256x256 crops, B=8, 1M
    points, VGG, 'sort') with ``depth`` + ``normals_l`` at every scale
    (a 12-channel net input; seeded per-point unit normals, the batch's
    camera-to-world matrices): 3 train steps against their twins
    (pyramids with their extra maps bit-equal, loss rel 1e-6, gradients
    ``GRAD_ATOL * max|g|``), ``WARMUP + TIMED`` timed steps with the loss
    falling; the state saved as a ``read_tpu`` checkpoint and 2 requests
    at 1216x368 served from it, request 0 within ``FRAME_TOL`` of its
    all-twin frame, each K2/K3/K4 wrapper and wgmma loop launched as the
    route predicates give at these widths."""
    import torch
    from read_tpu_torch.criterions import vgg as V
    from read_tpu_torch.frame import train_inputs
    from read_tpu_torch.kernel_bench import max_err
    from read_tpu_torch.pipelines import texture_pipeline as TP
    from read_tpu_torch.render import NeuralRenderer
    from read_tpu_torch.utils import ckpt as CK
    t_phase = time.perf_counter()
    xyz, ms, target = train_inputs(TRAIN_B, N_POINTS, TRAIN_HW)
    views = []
    for i in range(TRAIN_B):     # train_inputs' poses
        view = np.eye(4)
        view[0, 3] = 0.05 * i
        views.append(view)
    normals = np.random.default_rng(7).normal(size=xyz.shape).astype(
        np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    cfg = TP.config_from_dict({"input_format": EXTRA_FORMAT},
                              crop_size=(TRAIN_HW, TRAIN_HW))
    if (cfg.net_in_channels, cfg.raster_method) != (12, "sort"):
        raise SmokeFailure(f"extra_modes: {cfg}")
    vgg = V.random_vgg_params(torch.Generator().manual_seed(0), device=dev)
    state, net = TP.create_state(torch.Generator().manual_seed(0), cfg,
                                 N_POINTS, device=dev)
    xyz_d = torch.from_numpy(xyz).to(dev)
    batch = {"total_m": torch.from_numpy(ms).to(dev),
             "target": torch.from_numpy(target).to(dev),
             "view_matrix": torch.from_numpy(
                 np.stack(views).astype(np.float32)).to(dev),
             "pointcloud": {"xyz": xyz_d,
                            "normals": torch.from_numpy(normals).to(dev)}}
    step = TP.make_train_step(net, cfg, vgg)
    worst, head = 0.0, []
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for i in range(SPLAT_VS_TWIN):
        runs = []
        for twin in (False, True):
            with Twins() if twin else contextlib.nullcontext():
                pyr = TP.build_pyramid(
                    cfg, state.texture, xyz_d, batch["total_m"],
                    pointcloud=batch["pointcloud"],
                    view_m=batch["view_matrix"])
                metrics, _, _, g_net, g_tex = TP._loss_and_grads(
                    net, cfg, vgg, state, xyz_d, batch, False)
            runs.append((pyr, metrics["loss"],
                         {**state.layout.views(g_net), "texture": g_tex[0]}))
        torch.cuda.synchronize()
        (pyr_k, loss_k, g_k), (pyr_p, loss_p, g_p) = runs
        max_err(f"extra_modes step {i} pyramid (extra maps and "
                "descriptors) vs twin", pyr_k, pyr_p, None)
        rel = float((loss_k - loss_p).abs() / loss_p.abs())
        off = max(float((g_k[k] - g).abs().max() / g.abs().max().clamp(
            min=1e-30)) for k, g in g_p.items())
        if not rel <= 1e-6 or not off <= GRAD_ATOL:
            raise SmokeFailure(f"extra_modes step {i}: loss rel {rel:.3g}, "
                               f"worst gradient {off:.3g} x max|g| (bounds "
                               f"1e-6, {GRAD_ATOL})")
        worst = max(worst, off)
        head.append(loss_k)
        state, _ = step(state, xyz_d, batch)
    torch.backends.cudnn.deterministic = saved
    torch.cuda.synchronize()
    reset_launches()
    seconds, losses, state = timed_steps(step, state, xyz_d, batch)
    counts = launches()
    losses = loss_fell("extra_modes train", head, losses)
    pyramid_ran("extra_modes train", counts, "zbuffer_exact",
                WARMUP + TIMED)
    del batch, step
    # serve 2 requests from the trained state
    ckpt = os.path.join(workdir, "ckpt_extra_modes")
    CK.save_checkpoint(ckpt, TP.flat_from_state(state),
                       config={"input_format": EXTRA_FORMAT})
    del state, net
    torch.cuda.empty_cache()
    h, w = HW
    K = np.array([[720.0, 0, w / 2], [0, 720.0, h / 2], [0, 0, 1]])
    poses = []
    for i in range(2):
        pose = np.eye(4)
        pose[0, 3] = 0.05 * i
        poses.append(pose)
    scene = {"pointcloud": {"xyz": xyz, "normals": normals},
             "intrinsic_matrix": K, "view_matrix": poses,
             "point_sizes": None, "config": {"viewport_size": (w, h)}}
    r = NeuralRenderer(scene, ckpt, device=dev)
    predicted = predicted_conv_calls(cfg.net_in_channels)
    at8 = predicted_conv_calls(8)   # the predicates alone, at 8 channels
    if (at8["gated_conv_kxk_wgmma"], at8["gated_conv_1x1_wgmma"]) != (
            ctx["wgmma_per_frame"], ctx["conv1x1_per_frame"]):
        raise SmokeFailure(f"extra_modes: the width predicates give {at8} "
                           "at 8 channels, the recorded frame "
                           f"{ctx['wgmma_per_frame']} and "
                           f"{ctx['conv1x1_per_frame']} loop calls")
    torch.cuda.synchronize()
    reset_launches()
    each = []
    imgs = []
    for p in poses:
        t0 = time.perf_counter()
        imgs.append(r.infer(p))
        each.append((time.perf_counter() - t0) * 1e3)
    counts = launches()
    for i, img in enumerate(imgs):
        if img.shape != (h, w, 3) or not np.isfinite(img).all():
            raise SmokeFailure(f"extra_modes request {i}: bad frame")
    pyramid_ran("extra_modes serve", counts, "zbuffer_exact", len(imgs))
    conv_calls_ran("extra_modes serve", counts, predicted, len(imgs))
    with Twins():
        twin = r.infer(poses[0])
    err = max_err("extra_modes request 0 vs twins", torch.from_numpy(imgs[0]),
                  torch.from_numpy(twin), (FRAME_TOL,))
    steady = wall_ms(lambda: r.infer_device(poses[1]))
    # the same scene and request from serve_sort's 8-channel checkpoint
    r8 = NeuralRenderer(scene, os.path.join(workdir, "ckpt_trained_sort"),
                        device=dev)
    steady8 = wall_ms(lambda: r8.infer_device(poses[1]))
    bare = ctx.get("train_ms")
    print(f"[extra_modes] depth + normals_l at every scale (net input 12 "
          f"channels), {TRAIN_B}x{TRAIN_HW}^2 crops, {N_POINTS} points, "
          f"VGG on, sort: {SPLAT_VS_TWIN} steps against the twins "
          f"(pyramids and extra maps bit-equal, worst gradient "
          f"{worst:.3g} x max|g|, bound {GRAD_ATOL}); {seconds * 1e3:.2f} "
          f"ms/step (mean of {TIMED} after {WARMUP} warm-up) beside the "
          f"bare step's " + (f"{bare:.2f}" if bare else "(not run)")
          + f" in this run; loss {float(head[0]):.6g} (fresh state) -> "
          f"{losses[0]:.6g} -> {losses[-1]:.6g}")
    print(f"[extra_modes] serve: {len(imgs)} requests at {w}x{h} from the "
          f"trained checkpoint, {', '.join(f'{t:.2f}' for t in each)} "
          f"ms, then {steady:.3f} ms/request (median of 5, each synced) "
          f"beside {steady8:.3f} for serve_sort's 8-channel checkpoint on "
          f"the same scene; "
          f"vs all-twin max |err| {err:.3g}; conv launches "
          f"{ {k: counts[k] for k in CONV_CALLS} } = {len(imgs)} x the "
          f"routes' {predicted} at Cin {cfg.net_in_channels}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# Slice 5: point dropout and jitter (K1, K5 and the splat projection with
# the NDC jitter), mesh textures with the triangle raster, and the
# pix2pix and rgb_texture pipelines with their CLI
# ---------------------------------------------------------------------------

# the train dataset's augmentation at the bench point: no recipe in the
# repo sets them (configs/train_example.yaml has 0.0); these values turn
# both on at a size that moves points across pixels
AUG = {"drop_points": 0.1, "perturb_points": 1.0}
# jitter of the kernel checks: the step's 1 px, and 16 px for centres
# pushed one or more pixels past every edge of the frame
JITTER_PX = (1.0, 16.0)
JITTERED = {"zbuffer": "zbuffer_jitter",
            "zbuffer_exact": "zbuffer_exact_jitter",
            "zbuffer_splat": "zbuffer_splat_jitter"}


def jitter_for(n, px, hw, dev, seed=0):
    """``[n, 2]`` NDC offsets of up to ``px`` pixels, drawn on ``dev``
    (``ops.augment.pixel_jitter_offsets``)."""
    import torch
    from read_tpu_torch.ops import augment as A
    gen = torch.Generator(device=dev).manual_seed(seed)
    return A.pixel_jitter_offsets(gen, n, px, *hw, device=dev)


def jitter_kernels(report, dev):
    """K1, K5 and the splat projection with the NDC jitter against their
    twins, bit for bit: the projections alone (K1's key buffer and point
    depths, K5 with its one-level pass) and the pyramid in all four
    combinations of z-buffer and pool at every level, and the splat (r =
    1, sort+exact and pallas+packed) at every level; 1M points at
    1216x368 B=1 and 2 and at 256x256 B=8, each with 1 px and 16 px of
    jitter. Each jittered launch counts as the jitter variant. At 256x256
    B=8 with 1 px (the augmented step's inputs) each is timed beside the
    same kernel without the jitter, its twin and its library call
    (``scatter_reduce_`` amin of the jittered keys)."""
    import torch
    from read_tpu_torch import kernel_bench as KB
    from read_tpu_torch.frame import frame_inputs, train_inputs
    from read_tpu_torch.kernel_bench import event_ms, graph_ms
    from read_tpu_torch.ops import rasterize_kernels as RK
    cases = [(f"B={b}", *frame_inputs(b, N_POINTS, HW), HW) for b in (1, 2)]
    xyz, ms, _ = train_inputs(TRAIN_B, N_POINTS, TRAIN_HW)
    cases.append((f"B={TRAIN_B}", xyz, ms, (TRAIN_HW, TRAIN_HW)))
    for label, xyz, ms, hw in cases:
        xyz = torch.from_numpy(xyz).to(dev)
        ms = torch.from_numpy(ms).to(dev)
        for px in JITTER_PX:
            jit = jitter_for(xyz.shape[0], px, hw, dev)
            what = f"{label} {hw[1]}x{hw[0]} {px:g} px"
            before = dict(RK.launches)
            pairs = [
                ("zbuffer", RK.zbuffer(xyz, ms, *hw, jitter=jit),
                 RK.zbuffer_plain(xyz, ms, *hw, jitter=jit)),
                ("zbuffer_exact", RK.zbuffer_exact(xyz, ms, *hw, jitter=jit),
                 RK.zbuffer_exact_plain(xyz, ms, *hw, jitter=jit))]
            for method, pool in (("sort", "exact"), ("pallas", "packed")):
                args = (xyz, ms, *hw, 4, method, pool, 1)
                pairs.append(("zbuffer_splat",
                              RK.zbuffer_splat(*args, jitter=jit),
                              RK.zbuffer_splat_plain(*args, jitter=jit)))
            torch.cuda.synchronize()
            ran = {k: v - before[k] for k, v in RK.launches.items()
                   if v != before[k]}
            if ran != {"zbuffer_jitter": 1, "zbuffer_exact_jitter": 1,
                       "zbuffer_splat_jitter": 2, "zbuffer_pyramid": 3}:
                raise SmokeFailure(f"jitter {what}: launches {ran}")
            for name, got, want in pairs:
                got = [t for x in got for t in (x if isinstance(x, tuple)
                                                 else (x,))]
                want = [t for x in want for t in (x if isinstance(x, tuple)
                                                   else (x,))]
                bad = [i for i, (a, b) in enumerate(zip(got, want))
                       if not torch.equal(a, b)]
                if bad:
                    raise SmokeFailure(f"{name} with jitter {what}: outputs "
                                       f"{bad} differ from the twin")
            check_pyramids(f"{label} jitter {px:g} px", xyz, ms, hw, jit)
            print(f"[augment] K1, K5, splat (sort+exact, pallas+packed) "
                  f"with jitter, {what}, N={xyz.shape[0]}: bit-equal to "
                  "their twins")
    # the augmented step's shape: times with and without the jitter
    jit = jitter_for(xyz.shape[0], JITTER_PX[0], hw, dev)
    lib = KB.zbuffer_yardsticks(xyz, ms, hw, jit)[2]
    splat_kw = dict(point_radius=1, jitter=jit)
    s_lib, _, atomics, s_flops, s_bytes = KB.splat_yardsticks(
        xyz, ms, hw, "sort", 4, splat_kw)
    s_flops += 2 * ms.shape[0] * xyz.shape[0]
    s_bytes += 8 * xyz.shape[0]
    splat_args = (xyz, ms, *hw, 4, "sort", "exact", 1)
    rows = {
        "zbuffer": (lambda j: RK.zbuffer(xyz, ms, *hw, jitter=j),
                    lambda j: RK.zbuffer_plain(xyz, ms, *hw, jitter=j),
                    lib["zbuffer"]),
        "zbuffer_exact": (lambda j: RK.zbuffer_exact(xyz, ms, *hw, jitter=j),
                          lambda j: RK.zbuffer_exact_plain(xyz, ms, *hw,
                                                           jitter=j),
                          lib["zbuffer_exact"]),
        "zbuffer_splat": (lambda j: RK.zbuffer_splat(*splat_args, jitter=j),
                          lambda j: RK.zbuffer_splat_plain(*splat_args,
                                                           jitter=j),
                          (s_lib, s_flops, s_bytes))}
    for name, (fn, twin, (library, flops, nbytes)) in rows.items():
        t_j = event_ms(lambda: fn(jit), iters=20)
        g_j = graph_ms(lambda: fn(jit))
        t_0 = event_ms(lambda: fn(None), iters=20)
        g_0 = graph_ms(lambda: fn(None))
        t_p = event_ms(lambda: twin(jit), iters=5)
        row = report[JITTERED[name]]
        row.update(ms=t_j, graph_ms=g_j, plain_ms=t_p, max_abs_err=0.0,
                   unjittered_ms=t_0, unjittered_graph_ms=g_0,
                   shape=f"B={TRAIN_B} N={xyz.shape[0]} {hw[1]}x{hw[0]}, "
                         f"{JITTER_PX[0]:g} px"
                         + (" r=1 sort+exact L=4" if name == "zbuffer_splat"
                            else ""))
        library_and_bound(row, library, flops, nbytes)
        print(f"[augment] {JITTERED[name]} at {row['shape']}: kernel "
              f"{t_j:.4f} ms (graph {g_j:.4f}) beside {t_0:.4f} (graph "
              f"{g_0:.4f}) without the jitter; twin {t_p:.4f}; library "
              f"{row['library_ms']:.4f}; bound {row['bound_ms']:.4f} "
              f"({row['bound_by']})"
              + (f"; {atomics} atomics" if name == "zbuffer_splat" else ""))


def augment_steps(report, dev, ctx):
    """The augmented training step at the bench point (``AUG``: dropout
    0.1, 1 px jitter; VGG, the full-width UNet) in three variants: the
    default ``sort`` (K5 with the jitter), ``pallas`` (K1 with the
    jitter) and ``uv_1d_p3`` (the splat projection, K5's exact key, with
    the jitter). Each: ``SPLAT_VS_TWIN`` steps against their twins with
    the same draws (the step's generator is seeded by the step), pyramids
    bit-equal, loss rel 1e-6, gradients ``GRAD_ATOL * max|g|``; then
    ``SPLAT_STEPS`` steps (2 warm-up) with one jittered projection and
    one pass each and the loss falling, beside the same steps without the
    augmentation in the same window."""
    import torch
    from read_tpu_torch.criterions import vgg as V
    from read_tpu_torch.frame import train_inputs
    from read_tpu_torch.ops import rasterize as R
    from read_tpu_torch.pipelines import texture_pipeline as TP
    xyz, ms, target = train_inputs(TRAIN_B, N_POINTS, TRAIN_HW)
    xyz = torch.from_numpy(xyz).to(dev)
    batch = {"total_m": torch.from_numpy(ms).to(dev),
             "target": torch.from_numpy(target).to(dev)}
    vgg = V.random_vgg_params(torch.Generator().manual_seed(0), device=dev)
    variants = (("sort", {}, "zbuffer_exact"),
                ("pallas", {"raster_method": "pallas"}, "zbuffer"),
                ("uv_1d_p3", {"input_format": P3_FORMAT}, "zbuffer_splat"))
    for label, conf, proj in variants:
        cfg = TP.config_from_dict(conf, crop_size=(TRAIN_HW, TRAIN_HW),
                                  train_dataset_args=AUG)
        state, net = TP.create_state(torch.Generator().manual_seed(0), cfg,
                                     N_POINTS, device=dev)
        step = TP.make_train_step(net, cfg, vgg)
        worst, head = 0.0, []
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        for i in range(SPLAT_VS_TWIN):
            runs = []
            for twin in (False, True):
                with Twins() if twin else contextlib.nullcontext():
                    xyz_a, jit = TP.augment(cfg, state.step, xyz)
                    levels = R.rasterize_pyramid_pooled(
                        xyz_a, batch["total_m"], cfg.crop_size,
                        cfg.num_scales, point_radius=cfg.point_radius,
                        method=cfg.raster_method, ndc_jitter=jit)
                    metrics, _, _, g_net, g_tex = TP._loss_and_grads(
                        net, cfg, vgg, state, xyz_a,
                        dict(batch, ndc_jitter=jit), False)
                runs.append(([t for lv in levels for t in lv],
                             metrics["loss"],
                             {**state.layout.views(g_net),
                              "texture": g_tex[0]}))
            torch.cuda.synchronize()
            (maps_k, loss_k, g_k), (maps_p, loss_p, g_p) = runs
            if not all(torch.equal(a, b) for a, b in zip(maps_k, maps_p)):
                raise SmokeFailure(f"augment {label} step {i}: pyramids "
                                   "differ from the twins'")
            rel = float((loss_k - loss_p).abs() / loss_p.abs())
            off = max(float((g_k[k] - g).abs().max() / g.abs().max().clamp(
                min=1e-30)) for k, g in g_p.items())
            if not rel <= 1e-6 or not off <= GRAD_ATOL:
                raise SmokeFailure(f"augment {label} step {i}: loss rel "
                                   f"{rel:.3g}, worst gradient {off:.3g} x "
                                   f"max|g| (bounds 1e-6, {GRAD_ATOL})")
            worst = max(worst, off)
            head.append(loss_k)
            state, _ = step(state, xyz, batch)
        torch.backends.cudnn.deterministic = saved
        torch.cuda.synchronize()
        reset_launches()
        seconds, losses, state = timed_steps(step, state, xyz, batch)
        counts = launches()
        losses = loss_fell(f"augment {label}", head, losses)
        n = WARMUP + TIMED
        jittered = JITTERED[proj]
        others = [k for k in ("zbuffer", "zbuffer_exact", "zbuffer_splat",
                              *JITTERED.values()) if k != jittered]
        if (counts[jittered], counts["zbuffer_pyramid"]) != (n, n) or \
                any(counts[k] for k in others):
            raise SmokeFailure(f"augment {label}: z-buffer launches "
                               f"{counts}, want one {jittered} and one "
                               f"pass a step")
        report[jittered]["launches"] = counts[jittered]
        bare_s, _, _ = timed_steps(TP.make_train_step(
            net, dataclasses.replace(cfg, drop_points=0.0,
                                     perturb_points=0.0), vgg),
            state, xyz, batch)
        report[jittered].update(train_ms_per_step=seconds * 1e3,
                                train_bare_ms_per_step=bare_s * 1e3)
        ctx.setdefault("augment_ms", {})[label] = (seconds * 1e3,
                                                   bare_s * 1e3)
        print(f"[augment] train {label}: drop_points {AUG['drop_points']}, "
              f"perturb_points {AUG['perturb_points']} at {TRAIN_B}x"
              f"{TRAIN_HW}^2 crops, {N_POINTS} points, VGG on: "
              f"{SPLAT_VS_TWIN} steps against the twins with the same draws "
              f"(pyramids bit-equal, worst gradient {worst:.3g} x max|g|, "
              f"bound {GRAD_ATOL}); {seconds * 1e3:.2f} ms/step (mean of "
              f"{TIMED} after {WARMUP} warm-up) beside {bare_s * 1e3:.2f} "
              f"for the same step without the augmentation after it; loss "
              f"{float(head[0]):.6g} (fresh state) -> {losses[0]:.6g} -> "
              f"{losses[-1]:.6g}; {jittered} "
              f"{counts[jittered]}, pass {counts['zbuffer_pyramid']}")
        del state, net, step
        torch.cuda.empty_cache()


def phase_augment(report, ctx, dev):
    t0 = time.perf_counter()
    jitter_kernels(report, dev)
    augment_steps(report, dev, ctx)
    print(f"[augment] phase {time.perf_counter() - t0:.1f} s")


# The mesh scene: drive_world's road and two facades as triangulated
# grids, MESH_QUADS quads each (0.79M faces in all), with a uv atlas (one
# third of it a grid) and a procedural RGB atlas for the targets
MESH_QUADS = (256, 512)
MESH_TEXTURE = 512             # the CLI's --texture-size default


def _grid(corner, du, dv, quads, third):
    """One grid: ``quads = (nu, nv)`` quads from ``corner`` along ``du``
    and ``dv``; ``(verts, faces, uv)`` with uv in the atlas's
    ``third``-th horizontal band."""
    nu, nv = quads
    u, v = np.meshgrid(np.linspace(0, 1, nu + 1), np.linspace(0, 1, nv + 1))
    verts = (np.asarray(corner)[None, None] + u[..., None] * du
             + v[..., None] * dv).reshape(-1, 3)
    i = np.arange((nu + 1) * (nv + 1)).reshape(nv + 1, nu + 1)
    a, b, c, d = i[:-1, :-1], i[:-1, 1:], i[1:, :-1], i[1:, 1:]
    faces = np.concatenate([np.stack([a, b, d], -1).reshape(-1, 3),
                            np.stack([a, d, c], -1).reshape(-1, 3)])
    uv = np.stack([v.reshape(-1), (third + u.reshape(-1)) / 3.0], 1)
    return verts, faces, uv


def mesh_street():
    """``(verts [V, 3], faces [T, 3] int32, uv [V, 2], atlas [S, S, 3])``
    float32: the road (y = 0, |x| <= 4.5) and the facades (x = +-7.2, y
    in [0, 9]) of ``drive_world``'s street from z = 5 to -75, each a grid
    of ``MESH_QUADS`` quads, and a procedural ``MESH_TEXTURE``^2 atlas
    (asphalt with lane marks; facades with window rows)."""
    grids = [
        _grid((-4.5, 0.0, 5.0), np.array([9.0, 0, 0]),
              np.array([0, 0, -80.0]), MESH_QUADS, 0),
        _grid((-7.2, 0.0, 5.0), np.array([0, 9.0, 0]),
              np.array([0, 0, -80.0]), MESH_QUADS, 1),
        _grid((7.2, 0.0, 5.0), np.array([0, 9.0, 0]),
              np.array([0, 0, -80.0]), MESH_QUADS, 2)]
    verts, faces, uv, off = [], [], [], 0
    for v, f, t in grids:
        verts.append(v)
        faces.append(f + off)
        uv.append(t)
        off += len(v)
    s = MESH_TEXTURE
    y, x = np.meshgrid(np.arange(s) / s, np.arange(s) / s, indexing="ij")
    atlas = np.empty((s, s, 3))
    band = (y * 3).astype(int)
    fy = y * 3 - band                   # across the grid, along x or y
    road = 0.3 + 0.05 * np.sin(40 * x) * np.cos(31 * fy)
    lane = (np.abs(fy - 0.5) < 0.01) & ((x * 20) % 1 < 0.5)
    window = ((fy * 3) % 1 > 0.4) & ((fy * 3) % 1 < 0.8) & \
        ((x * 26) % 1 > 0.3) & ((x * 26) % 1 < 0.7)
    facade = np.stack([0.6 - 0.1 * ((x * 5).astype(int) % 2),
                       0.45 + 0 * x, 0.35 + 0 * x], -1)
    atlas[:] = facade
    atlas[band == 0] = road[band == 0, None]
    atlas[(band == 0) & lane] = (0.85, 0.85, 0.8)
    atlas[(band > 0) & window] = (0.1, 0.12, 0.2)
    return (np.concatenate(verts).astype(np.float32),
            np.concatenate(faces).astype(np.int32),
            np.concatenate(uv).astype(np.float32),
            atlas.astype(np.float32))


def street_poses(n, shift=0.0):
    """``n`` camera-to-world poses along the street, 2.5 m apart (the
    drives' trajectory)."""
    views = []
    for i in range(n):
        view = np.eye(4)
        view[:3, 3] = (0.3 * np.sin(0.4 * i) + shift, 1.6, -2.5 * i)
        views.append(view)
    return views


def street_matrices(views, hw):
    from read_tpu_torch.scene import camera
    h, w = hw
    K = np.array([[720.0, 0, w / 2], [0, 720.0, h / 2], [0, 0, 1]])
    P = camera.gl_projection(K, (w, h), znear=0.1, zfar=1000.0)
    return K, np.stack([camera.total_matrix(P, v)
                        for v in views]).astype(np.float32)


def render_atlas(verts, faces, uv, atlas, ms, hw):
    """Targets: the atlas sampled at each view's triangle-raster uv
    (``[B, h, w, 3]`` on the tensors' device; black where no face)."""
    from read_tpu_torch.models import texture as T
    from read_tpu_torch.ops import rasterize_mesh as RMesh
    fi, _ = RMesh.rasterize_mesh_batch(verts, faces, ms, *hw)
    uv_map = RMesh.interpolate_uv(verts, faces, uv, ms, fi)
    img = T.sample_mesh_texture([atlas], uv_map)
    return img * (fi >= 0).unsqueeze(-1).to(img.dtype)


def phase_mesh(report, ctx, dev, workdir):
    """Mesh textures on the street mesh (``mesh_street``: 0.79M faces,
    ``MESH_TEXTURE``^2 tables, 8 channels, the full-width UNet, VGG):
    the triangle raster at 1216x368 B=1, timed with its peak memory
    growth; ``use_mesh`` train steps with faces at the bench crop
    (256x256, B=8; no kernel of the port runs in them; one triangle
    raster a view and level, ``ops.rasterize_mesh.counts``), ``SPLAT_VS_TWIN``
    then ``WARMUP + TIMED`` timed with the loss falling, beside the
    steps without faces (K5 and the uv gather: ``SPLAT_VS_TWIN`` against
    the twins, pyramids bit-equal, then timed); the state saved as a
    ``read_tpu`` checkpoint and 2 ``NeuralRenderer`` requests at
    1216x368 with faces (request 0 within ``FRAME_TOL`` of its all-twin
    frame, K2/K3/K4 and both wgmma loops as their routes predict, no
    z-buffer) and 1 without faces (one K5 and one pass)."""
    import torch
    from read_tpu_torch.criterions import vgg as V
    from read_tpu_torch.kernel_bench import max_err
    from read_tpu_torch.ops import rasterize as R
    from read_tpu_torch.ops import rasterize_mesh as RMesh
    from read_tpu_torch.pipelines import texture_pipeline as TP
    from read_tpu_torch.render import NeuralRenderer
    from read_tpu_torch.utils import ckpt as CK
    t_phase = time.perf_counter()
    verts, faces, uv, atlas = mesh_street()
    ctx["mesh_street"] = (verts, faces, uv, atlas)
    v_d, f_d, uv_d = (torch.from_numpy(a).to(dev) for a in (verts, faces,
                                                             uv))
    atlas_d = torch.from_numpy(atlas).to(dev)
    # the triangle raster alone at the frame's size
    _, m1 = street_matrices(street_poses(1), HW)
    m1 = torch.from_numpy(m1).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fi, _ = RMesh.rasterize_mesh_batch(v_d, f_d, m1, *HW)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    covered = float((fi >= 0).float().mean())
    raster_ms = wall_ms(lambda: RMesh.rasterize_mesh_batch(v_d, f_d, m1,
                                                           *HW))
    ctx["mesh_raster"] = (raster_ms, peak)
    print(f"[mesh] street mesh: {len(verts)} vertices, {len(faces)} faces; "
          f"triangle raster at {HW[1]}x{HW[0]} B=1: {raster_ms:.2f} ms "
          f"(median of 5, synced), peak memory growth {peak / 2 ** 20:.1f} "
          f"MiB, {covered:.3f} of pixels covered")
    # training
    views = street_poses(TRAIN_B)
    _, ms = street_matrices(views, (TRAIN_HW, TRAIN_HW))
    ms = torch.from_numpy(ms).to(dev)
    target = render_atlas(v_d, f_d, uv_d, atlas_d, ms, (TRAIN_HW, TRAIN_HW))
    vgg = V.random_vgg_params(torch.Generator().manual_seed(0), device=dev)
    cfg = TP.config_from_dict({"use_mesh": True,
                               "texture_size": MESH_TEXTURE},
                              crop_size=(TRAIN_HW, TRAIN_HW))
    state, net = TP.create_state(torch.Generator().manual_seed(0), cfg,
                                 len(verts), device=dev)
    batch = {"total_m": ms, "target": target, "uv2d": uv_d, "faces": f_d}
    step = TP.make_train_step(net, cfg, vgg)
    # with faces no kernel of the port runs in the step (the triangle
    # raster and the texture sample are plain PyTorch), so no twin holds
    # it: SPLAT_VS_TWIN steps from the fresh state, then the timed window
    head = []
    for i in range(SPLAT_VS_TWIN):
        state, metrics = step(state, v_d, batch)
        head.append(metrics["loss"])
    torch.cuda.synchronize()
    reset_launches()
    rasters = RMesh.counts["rasters"]
    seconds, losses, state = timed_steps(step, state, v_d, batch)
    counts = launches()
    rasters = RMesh.counts["rasters"] - rasters
    if rasters != (WARMUP + TIMED) * TRAIN_B * cfg.num_scales:
        raise SmokeFailure(f"mesh train with faces: {rasters} triangle "
                           f"rasters in {WARMUP + TIMED} steps of "
                           f"{TRAIN_B} views at {cfg.num_scales} levels")
    losses = loss_fell("mesh train", head, losses)
    if any(counts[k] for k in ("zbuffer", "zbuffer_exact", "zbuffer_splat",
                               "zbuffer_pyramid")):
        raise SmokeFailure(f"mesh train with faces: z-buffer launches "
                           f"{counts}")
    # without faces: K5 and the pass over the mesh's vertices, then the
    # uv gather; SPLAT_VS_TWIN steps from the trained state against the
    # twins (pyramids bit-equal, gradients within GRAD_ATOL), then timed
    nf_batch = {k: v for k, v in batch.items() if k != "faces"}
    nf_state, worst = state, 0.0
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for i in range(SPLAT_VS_TWIN):
        runs = []
        for twin in (False, True):
            with Twins() if twin else contextlib.nullcontext():
                levels = R.rasterize_pyramid_pooled(
                    v_d, ms, cfg.crop_size, cfg.num_scales,
                    point_radius=cfg.point_radius, method=cfg.raster_method)
                metrics, _, _, g_net, g_tex = TP._loss_and_grads(
                    net, cfg, vgg, nf_state, v_d, nf_batch, False)
            runs.append(([t for lv in levels for t in lv], metrics["loss"],
                         {**nf_state.layout.views(g_net),
                          **{f"texture/{j}": g for j, g in
                             enumerate(g_tex)}}))
        torch.cuda.synchronize()
        (maps_k, loss_k, g_k), (maps_p, loss_p, g_p) = runs
        if not all(torch.equal(a, b) for a, b in zip(maps_k, maps_p)):
            raise SmokeFailure(f"mesh step {i} without faces: pyramids "
                               "differ from the twins'")
        rel = float((loss_k - loss_p).abs() / loss_p.abs())
        off = max(float((g_k[k] - g).abs().max() / g.abs().max().clamp(
            min=1e-30)) for k, g in g_p.items())
        if not rel <= 1e-6 or not off <= GRAD_ATOL:
            raise SmokeFailure(f"mesh step {i} without faces: loss rel "
                               f"{rel:.3g}, worst gradient {off:.3g} x "
                               f"max|g| (bounds 1e-6, {GRAD_ATOL})")
        worst = max(worst, off)
        nf_state, _ = step(nf_state, v_d, nf_batch)
    torch.backends.cudnn.deterministic = saved
    torch.cuda.synchronize()
    reset_launches()
    nf_s, nf_losses, _ = timed_steps(step, nf_state, v_d, nf_batch)
    pyramid_ran("mesh train without faces", launches(), "zbuffer_exact",
                WARMUP + TIMED)
    del nf_state
    ctx["mesh_ms"] = (seconds * 1e3, nf_s * 1e3)
    print(f"[mesh] train use_mesh, texture {MESH_TEXTURE}^2 x 4 levels, "
          f"{TRAIN_B}x{TRAIN_HW}^2 crops, VGG on: with faces "
          f"{seconds * 1e3:.2f} ms/step (mean of {TIMED} after {WARMUP} "
          f"warm-up, after {SPLAT_VS_TWIN} steps), loss {float(head[0]):.6g} "
          f"(fresh state) -> {losses[0]:.6g} -> {losses[-1]:.6g}; without "
          f"faces (K5 + uv gather) {SPLAT_VS_TWIN} steps against the twins "
          f"(pyramids bit-equal, worst gradient {worst:.3g} x max|g|, bound "
          f"{GRAD_ATOL}), {nf_s * 1e3:.2f} ms/step")
    ckpt = os.path.join(workdir, "ckpt_mesh")
    CK.save_checkpoint(ckpt, TP.flat_from_state(state),
                       config={"use_mesh": True,
                               "texture_size": MESH_TEXTURE})
    del state, net, step, batch, nf_batch
    torch.cuda.empty_cache()
    # serving
    h, w = HW
    views = street_poses(2)
    K, _ = street_matrices(views, HW)
    scene = {"pointcloud": {"xyz": verts, "uv2d": uv, "faces": faces},
             "intrinsic_matrix": K, "view_matrix": views,
             "point_sizes": None, "config": {"viewport_size": (w, h)}}
    r = NeuralRenderer(scene, ckpt, device=dev)
    predicted = predicted_conv_calls(8)
    torch.cuda.synchronize()
    reset_launches()
    imgs, each = [], []
    for p in views:
        t0 = time.perf_counter()
        imgs.append(r.infer(p))
        each.append((time.perf_counter() - t0) * 1e3)
    counts = launches()
    for i, img in enumerate(imgs):
        if img.shape != (h, w, 3) or not np.isfinite(img).all():
            raise SmokeFailure(f"mesh request {i}: bad frame")
    conv_calls_ran("mesh serve", counts, predicted, len(imgs))
    if any(counts[k] for k in ("zbuffer", "zbuffer_exact", "zbuffer_splat",
                               "zbuffer_pyramid")):
        raise SmokeFailure(f"mesh serve with faces: z-buffer launches "
                           f"{counts}")
    with Twins():
        twin = r.infer(views[0])
    err = max_err("mesh request 0 vs twins", torch.from_numpy(imgs[0]),
                  torch.from_numpy(twin), (FRAME_TOL,))
    steady = wall_ms(lambda: r.infer_device(views[1]))
    scene_nf = dict(scene, pointcloud={"xyz": verts, "uv2d": uv})
    r_nf = NeuralRenderer(scene_nf, ckpt, device=dev)
    reset_launches()
    img = r_nf.infer(views[1])
    counts = launches()
    pyramid_ran("mesh serve without faces", counts, "zbuffer_exact", 1)
    conv_calls_ran("mesh serve without faces", counts, predicted, 1)
    if img.shape != (h, w, 3) or not np.isfinite(img).all():
        raise SmokeFailure("mesh request without faces: bad frame")
    steady_nf = wall_ms(lambda: r_nf.infer_device(views[1]))
    ctx["mesh_serve"] = (steady, steady_nf)
    print(f"[mesh] serve: {len(imgs)} requests at {w}x{h} with faces, "
          f"{', '.join(f'{t:.2f}' for t in each)} ms, then {steady:.3f} "
          f"ms/request (median of 5, synced); vs all-twin max |err| "
          f"{err:.3g}; conv launches as the routes predict "
          f"({predicted}); without faces (K5 + uv gather) {steady_nf:.3f} "
          f"ms/request; phase {time.perf_counter() - t_phase:.1f} s")


def write_mesh_scene(root, name, dev, verts, faces, uv, atlas, hw, poses):
    """The street mesh on disk: its vertices as the point cloud (binary
    PLY, atlas colours), the mesh (binary PLY with ``s``, ``t`` and the
    faces) named by the manifest's ``mesh``, ``poses`` poses along the
    street and PNG targets of the atlas at each view's triangle raster;
    a JSON manifest. Returns the paths-file entry."""
    import torch
    from read_tpu_torch.data import image_io
    from read_tpu_torch.scene import io as IO
    d = os.path.join(root, name)
    os.makedirs(os.path.join(d, "images"), exist_ok=True)
    rgb8 = (np.clip(atlas[(uv[:, 1] * (atlas.shape[0] - 1)).astype(int),
                          (uv[:, 0] * (atlas.shape[1] - 1)).astype(int)],
                    0, 1) * 255).astype(np.uint8)
    IO.write_ply(os.path.join(d, "pc.ply"), verts, rgb8)
    vert = np.empty(len(verts), np.dtype([
        ("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("s", "<f4"),
        ("t", "<f4")]))
    vert["x"], vert["y"], vert["z"] = verts.T
    vert["s"], vert["t"] = uv.T
    face = np.empty(len(faces), np.dtype([("n", "u1"), ("i", "<i4", 3)]))
    face["n"], face["i"] = 3, faces
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(verts)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property float s\nproperty float t\n"
              f"element face {len(faces)}\n"
              "property list uchar int vertex_indices\nend_header\n")
    with open(os.path.join(d, "mesh.ply"), "wb") as f:
        f.write(header.encode("ascii") + vert.tobytes() + face.tobytes())
    views = street_poses(poses)
    K, ms = street_matrices(views, hw)
    np.savetxt(os.path.join(d, "cam.txt"), np.vstack([[hw[1], hw[0], 0], K]))
    np.savetxt(os.path.join(d, "poses.dat"), np.stack(views).reshape(-1, 4))
    v_d, f_d, uv_d = (torch.from_numpy(a).to(dev) for a in (verts, faces,
                                                             uv))
    atlas_d = torch.from_numpy(atlas).to(dev)
    for i in range(poses):
        img = render_atlas(v_d, f_d, uv_d, atlas_d,
                           torch.from_numpy(ms[i:i + 1]).to(dev), hw)[0]
        image_io.write_png(os.path.join(d, "images", f"{i:06}.png"),
                           (img.cpu().numpy() * 255 + 0.5).astype(np.uint8))
    with open(os.path.join(d, "scene.json"), "w") as f:
        json.dump({"viewport_size": [hw[1], hw[0]], "pointcloud": "pc.ply",
                   "mesh": "mesh.ply", "intrinsic_matrix": "cam.txt",
                   "view_matrix": "poses.dat"}, f)
    return {"scene_path": os.path.join(d, "scene.json"),
            "target_path": os.path.join(d, "images"),
            "target_name": "{label:06d}.png"}


def expected_alt_checkpoints(history, pipeline, names, save_freq, keep=3):
    """``read_tpu.train``'s alt-pipeline rules (:328-523): at every
    ``save_freq``-th epoch or a better val PSNR
    ``ckpt_<pipeline>_<scene>_<epoch>``, the newest ``keep`` kept, and
    ``best_<pipeline>_<scene>`` on a better one."""
    best, kept, out = float("inf"), [], set()
    for h in history:
        val = -h["val_psnr"]
        if val < best or h["epoch"] % save_freq == 0:
            kept = (kept + [h["epoch"]])[-keep:]
        if val < best:
            best = val
            out |= {f"best_{pipeline}_{n}" for n in names}
    return out | {f"ckpt_{pipeline}_{n}_{e}" for n in names for e in kept}


def alt_cli(dev, root, config, pipeline, scene, flags):
    """One ``--pipeline`` CLI fit of 1 epoch of ``CLI_STEPS`` steps on
    ``scene``, then ``--resume`` for one more; checks the checkpoints
    against ``read_tpu.train``'s rules and the resumed step. Returns
    ``(ms/step after the first 2, val PSNR of both runs, launches)``."""
    from read_tpu_torch import train
    from read_tpu_torch.utils import ckpt as CK
    logs = os.path.join(root, "logs_" + pipeline)
    shutil.rmtree(logs, ignore_errors=True)
    extra = ["--headless-platform", "cpu"] if dev.type != "cuda" else []
    base = ["--config", config, "--pipeline", pipeline, "--dataset-names",
            scene, "--max-steps-per-epoch", str(CLI_STEPS)] + flags + extra
    out = []
    reset_launches()
    for name, more in (("fit", ["--epochs", "1"]),
                       ("resume", ["--epochs", "1", "--resume", None])):
        if more[-1] is None:
            more[-1] = os.path.join(out[0][0], "checkpoints")
        save = os.path.join(logs, name)
        rc = train.main(base + more + ["--save-dir", save, "--name", name])
        if rc != 0:
            raise SmokeFailure(f"cli {pipeline} {name}: exit code {rc}")
        (exp,) = os.listdir(save)
        exp = os.path.join(save, exp)
        with open(os.path.join(exp, "history.json")) as f:
            hist = json.load(f)
        ck = os.path.join(exp, "checkpoints")
        want = expected_alt_checkpoints(hist, pipeline, [scene],
                                        DEMO_DRIVE["save_freq"])
        if set(os.listdir(ck)) != want:
            raise SmokeFailure(f"cli {pipeline} {name}: checkpoints "
                               f"{sorted(os.listdir(ck))}, the reference's "
                               f"rules give {sorted(want)}")
        step = int(CK.load_checkpoint(CK.latest_checkpoint(
            ck, f"ckpt_{pipeline}_{scene}"))[0]["step"])
        if step != CLI_STEPS * (len(out) + 1):
            raise SmokeFailure(f"cli {pipeline} {name}: step {step}")
        if not all(np.isfinite(h["train_loss"]) and h["val_psnr"] > 0
                   for h in hist):
            raise SmokeFailure(f"cli {pipeline} {name}: history {hist}")
        out.append((exp, hist))
    counts = launches()
    step_ms = [ms for _, hist in out for h in hist
               for ms in h["step_ms"][2:] or h["step_ms"]]
    return (float(np.mean(step_ms)),
            [h["val_psnr"] for _, hist in out for h in hist], counts)


def phase_alt_pipelines(report, ctx, dev, workdir):
    """pix2pix at the bench point (the full-width UNet on raw ``colors``,
    3 input channels, 1M points with seeded colours, VGG):
    ``SPLAT_VS_TWIN`` steps against their twins (pyramids bit-equal, loss
    rel 1e-6, gradients ``GRAD_ATOL * max|g|``), ``WARMUP + TIMED``
    timed with the loss falling, one K5 and one pass a step; rgb_texture
    on the street mesh at the bench crop, with faces (the triangle raster)
    and without (K5 and the uv gather), 3 steps each, timed, the loss
    falling; then the CLI: ``--pipeline pix2pix`` on the cli phase's
    ``drive_a`` and ``--pipeline rgb_texture --use-mesh`` on the street
    mesh on disk (its manifest names the mesh), each 1 epoch of
    ``CLI_STEPS`` steps and ``--resume`` for one more, the checkpoints as
    ``read_tpu.train``'s rules leave them."""
    import torch
    from read_tpu_torch.criterions import vgg as V
    from read_tpu_torch.frame import train_inputs
    from read_tpu_torch.ops import rasterize as R
    from read_tpu_torch.pipelines import pix2pix_pipeline as P2P
    from read_tpu_torch.pipelines import rgb_texture_pipeline as RGB
    from read_tpu_torch.pipelines import texture_pipeline as TP
    t_phase = time.perf_counter()
    xyz, ms, target = train_inputs(TRAIN_B, N_POINTS, TRAIN_HW)
    rgb = np.random.default_rng(3).uniform(size=xyz.shape).astype(np.float32)
    xyz = torch.from_numpy(xyz).to(dev)
    pc = {"rgb": torch.from_numpy(rgb).to(dev)}
    batch = {"total_m": torch.from_numpy(ms).to(dev),
             "target": torch.from_numpy(target).to(dev)}
    vgg = V.random_vgg_params(torch.Generator().manual_seed(0), device=dev)
    cfg = P2P.Pix2PixConfig(crop_size=(TRAIN_HW, TRAIN_HW))
    state, net = P2P.create_pix2pix_state(torch.Generator().manual_seed(0),
                                          cfg, in_channels=3, device=dev)
    step = P2P.make_pix2pix_step(net, cfg, vgg, pc)
    worst, head = 0.0, []
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for i in range(SPLAT_VS_TWIN):
        runs = []
        for twin in (False, True):
            with Twins() if twin else contextlib.nullcontext():
                levels = R.rasterize_pyramid_pooled(
                    xyz, batch["total_m"], cfg.crop_size, cfg.num_scales)
                loss, _, _, g = P2P.loss_and_grad(net, cfg, vgg, state, xyz,
                                                  batch, pc)
            runs.append(([t for lv in levels for t in lv], loss.detach(),
                         state.layout.views(g)))
        torch.cuda.synchronize()
        (maps_k, loss_k, g_k), (maps_p, loss_p, g_p) = runs
        if not all(torch.equal(a, b) for a, b in zip(maps_k, maps_p)):
            raise SmokeFailure(f"pix2pix step {i}: pyramids differ")
        rel = float((loss_k - loss_p).abs() / loss_p.abs())
        off = max(float((g_k[k] - g).abs().max() / g.abs().max().clamp(
            min=1e-30)) for k, g in g_p.items())
        if not rel <= 1e-6 or not off <= GRAD_ATOL:
            raise SmokeFailure(f"pix2pix step {i}: loss rel {rel:.3g}, "
                               f"worst gradient {off:.3g} x max|g|")
        worst = max(worst, off)
        head.append(loss_k)
        state, _ = step(state, xyz, batch)
    torch.backends.cudnn.deterministic = saved
    torch.cuda.synchronize()
    reset_launches()
    p2p_s, losses, state = timed_steps(step, state, xyz, batch)
    counts = launches()
    losses = loss_fell("pix2pix train", head, losses)
    pyramid_ran("pix2pix train", counts, "zbuffer_exact", WARMUP + TIMED)
    print(f"[alt_pipelines] pix2pix at {TRAIN_B}x{TRAIN_HW}^2 crops, "
          f"{N_POINTS} points, full-width UNet on colors, VGG on: "
          f"{SPLAT_VS_TWIN} steps against the twins (pyramids bit-equal, "
          f"worst gradient {worst:.3g} x max|g|, bound {GRAD_ATOL}); "
          f"{p2p_s * 1e3:.2f} ms/step (mean of {TIMED} after {WARMUP} "
          f"warm-up), loss {float(head[0]):.6g} (fresh state) -> "
          f"{losses[0]:.6g} -> {losses[-1]:.6g}")
    del state, net, step
    torch.cuda.empty_cache()
    # rgb_texture on the street mesh
    verts, faces, uv, atlas = ctx["mesh_street"]
    v_d, f_d, uv_d = (torch.from_numpy(a).to(dev) for a in (verts, faces,
                                                             uv))
    _, ms = street_matrices(street_poses(TRAIN_B), (TRAIN_HW, TRAIN_HW))
    ms = torch.from_numpy(ms).to(dev)
    rgb_batch = {"total_m": ms, "target": render_atlas(
        v_d, f_d, uv_d, torch.from_numpy(atlas).to(dev), ms,
        (TRAIN_HW, TRAIN_HW))}
    rgb_ms = {}
    for with_faces in (True, False):
        st = RGB.create_rgb_texture_state(MESH_TEXTURE, device=dev)
        rstep = RGB.make_rgb_texture_step(
            0.1, {"uv2d": uv_d}, TRAIN_HW, TRAIN_HW,
            faces=f_d if with_faces else None)
        if not with_faces:
            # K5 at the street mesh's vertices: the uv maps and one
            # step's loss against the twins'
            got = RGB.uv_and_mask(v_d, ms, uv_d, TRAIN_HW, TRAIN_HW)
            m_k = rstep(st, v_d, rgb_batch)[1]["loss"]
            with Twins():
                want = RGB.uv_and_mask(v_d, ms, uv_d, TRAIN_HW, TRAIN_HW)
                m_p = rstep(st, v_d, rgb_batch)[1]["loss"]
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise SmokeFailure("rgb_texture without faces: uv maps "
                                   "differ from the twins'")
            rel = float((m_k - m_p).abs() / m_p.abs())
            if not rel <= 1e-6:
                raise SmokeFailure(f"rgb_texture without faces: loss rel "
                                   f"{rel:.3g} against the twins (bound "
                                   f"1e-6)")
        st, m0 = rstep(st, v_d, rgb_batch)   # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        losses = [float(m0["loss"])]
        for _ in range(3):
            st, m = rstep(st, v_d, rgb_batch)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        rgb_ms[with_faces] = (time.perf_counter() - t0) * 1e3 / 3
        counts = launches()
        losses = [float(x) for x in losses]
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise SmokeFailure(f"rgb_texture faces={with_faces}: losses "
                               f"{losses}")
        if with_faces and counts["zbuffer_exact"]:
            raise SmokeFailure(f"rgb_texture with faces: launches {counts}")
        if not with_faces:
            pyramid_ran("rgb_texture without faces", counts,
                        "zbuffer_exact", 3)
        print(f"[alt_pipelines] rgb_texture on the street mesh, texture "
              f"{MESH_TEXTURE}^2, {TRAIN_B}x{TRAIN_HW}^2 views, "
              + ("with faces (triangle raster)" if with_faces else
                 "without faces (K5 + uv gather; uv maps bit-equal and "
                 "the loss within 1e-6 of the twins')")
              + f": {rgb_ms[with_faces]:.2f} ms/step (mean of 3 after 1), "
              f"loss {losses[0]:.6g} -> {losses[-1]:.6g}")
    ctx["alt_ms"] = (p2p_s * 1e3, rgb_ms[True], rgb_ms[False])
    # the CLIs
    if "drive" not in ctx:
        raise SmokeFailure("alt_pipelines: the cli phase's drive is missing")
    root = os.path.join(workdir, "cli")
    with open(os.path.join(root, "paths.json")) as f:
        paths = json.load(f)
    paths["datasets"]["street"] = write_mesh_scene(
        root, "street", dev, verts, faces, uv, atlas, HW, CLI_POSES)
    recipe = dict(ctx["cli_recipe"],
                  paths_file=os.path.join(root, "paths_alt.json"))
    with open(recipe["paths_file"], "w") as f:
        json.dump(paths, f)
    config = os.path.join(root, "alt.json")
    with open(config, "w") as f:
        json.dump(recipe, f)
    with without_modules():
        p_ms, p_psnr, p_counts = alt_cli(dev, root, config, "pix2pix",
                                         CLI_SCENES[0], [])
        r_ms, r_psnr, r_counts = alt_cli(dev, root, config, "rgb_texture",
                                         "street", ["--use-mesh"])
    if dev.type == "cuda" and not p_counts["zbuffer_exact"]:
        raise SmokeFailure(f"cli pix2pix: launches {p_counts}")
    ctx["alt_cli_ms"] = (p_ms, r_ms)
    print(f"[alt_pipelines] cli pix2pix on {CLI_SCENES[0]} (demo_drive "
          f"recipe, 1 epoch of {CLI_STEPS} steps + --resume 1): "
          f"{p_ms:.2f} ms/step; val PSNR "
          f"{', '.join(f'{p:.3f}' for p in p_psnr)}"
          f"; cli rgb_texture --use-mesh on the street mesh: {r_ms:.2f} "
          f"ms/step; val PSNR {', '.join(f'{p:.3f}' for p in r_psnr)}; "
          f"checkpoints as read_tpu.train's rules leave them; phase "
          f"{time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# bfloat16 training, config 3 (the 10M-point scene and its probe recipe)
# and the viewer
# ---------------------------------------------------------------------------

# the first bf16 loss at the bench point lies 8.33e-5 (relative) from the
# f32 one on the H100; 1e-3 is twelve times that
BF16_LOSS_RTOL = 1e-3


@contextlib.contextmanager
def bf16_batchnorm():
    """A wrong bf16 route, to show what the first-loss bound sees: train-
    mode BatchNorm in bf16 on the gate's bf16 output, its batch
    statistics and its affine map (flax runs both in f32). The running
    statistics are left alone."""
    import torch
    from read_tpu_torch.models import unet as U
    forward = U._Norm.forward

    def in_bf16(self, x, train):
        x = x.to(torch.bfloat16)
        mean = x.mean(dim=(0, 1, 2))
        var = torch.square(x - mean).mean(dim=(0, 1, 2))
        return (x - mean) * (torch.rsqrt(var + U._BN_EPS)
                             * self.scale.to(x.dtype)) + self.bias.to(x.dtype)

    U._Norm.forward = in_bf16
    try:
        yield
    finally:
        U._Norm.forward = forward


def phase_bf16_train(report, ctx, dev):
    """bfloat16 training at the bench point (256x256, B=8, 1M points,
    VGG, ``sort``, the full-width UNet): the first loss of each dtype
    from one fresh state (the bf16 one within ``BF16_LOSS_RTOL`` of the
    f32 one, and not equal to it), beside the first loss of a wrong bf16
    route (:func:`bf16_batchnorm`); 3 bf16 steps, then ``WARMUP`` +
    ``TIMED`` more with K5 and the pass once a step and the loss falling
    (``loss_fell``), and the f32 step from the state they leave, in the
    same window. Peak memory of each window."""
    import torch
    from read_tpu_torch.pipelines import texture_pipeline as TP
    t_phase = time.perf_counter()
    net, cfg, vgg, state, xyz, batch = train_setup(dev)
    cfg_b = dataclasses.replace(cfg, dtype="bfloat16")
    step_f, step_b = (TP.make_train_step(net, c, vgg) for c in (cfg, cfg_b))
    first = {}
    for name, step in (("f32", step_f), ("bf16", step_b)):
        _, m = step(state, xyz, batch)
        first[name] = float(m["loss"])
    with bf16_batchnorm():
        wrong = float(step_b(state, xyz, batch)[1]["loss"])
    rel = abs(first["bf16"] - first["f32"]) / abs(first["f32"])
    rel_wrong = abs(wrong - first["f32"]) / abs(first["f32"])
    if not 0 < rel <= BF16_LOSS_RTOL:
        raise SmokeFailure(f"bf16_train: first loss {first['bf16']:.6g} vs "
                           f"f32 {first['f32']:.6g} from the same state "
                           f"(rel {rel:.3g}; want 0 < rel <= "
                           f"{BF16_LOSS_RTOL})")
    head = []
    for _ in range(3):
        state, m = step_b(state, xyz, batch)
        head.append(m["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    bf16_s, losses, state = timed_steps(step_b, state, xyz, batch)
    counts = launches()
    peak_b = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = loss_fell("bf16_train", head, losses)
    pyramid_ran("bf16_train", counts, "zbuffer_exact", WARMUP + TIMED)
    report["zbuffer_exact"]["bf16_train_launches"] = counts["zbuffer_exact"]
    torch.cuda.reset_peak_memory_stats()
    f32_s, f32_losses, _ = timed_steps(step_f, state, xyz, batch)
    peak_f = torch.cuda.max_memory_allocated() / 2 ** 30
    if not np.isfinite([float(x) for x in f32_losses]).all():
        raise SmokeFailure("bf16_train: f32 losses not finite")
    ctx["bf16_train_ms"] = (bf16_s * 1e3, f32_s * 1e3)
    print(f"[bf16_train] {TRAIN_B}x{TRAIN_HW}^2 crops, {N_POINTS} points, "
          f"full-width UNet, VGG on: bf16 {bf16_s * 1e3:.2f} ms/step, peak "
          f"memory {peak_b:.2f} GiB; f32 in the same window "
          f"{f32_s * 1e3:.2f} ms/step, peak {peak_f:.2f} GiB (each the "
          f"mean of {TIMED} after {WARMUP} warm-up); first loss from one "
          f"fresh state bf16 {first['bf16']:.6g}, f32 {first['f32']:.6g} "
          f"(rel {rel:.3g}, bound {BF16_LOSS_RTOL}; BatchNorm in bf16: "
          f"{wrong:.6g}, rel {rel_wrong:.3g}); bf16 loss "
          f"{float(head[0]):.6g} -> {losses[0]:.6g} -> {losses[-1]:.6g}; "
          f"K5 {counts['zbuffer_exact']}, pass {counts['zbuffer_pyramid']}; "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    del net, state, step_f, step_b
    torch.cuda.empty_cache()


# config 3 (configs/scene10m_probe.yaml): the 10M-point drive of
# read_tpu_torch.make_demo_scene, its probe recipe through the CLI in both
# dtypes, with and without --remat
CONFIG3 = "configs/scene10m_probe.yaml"
CONFIG3_POINTS, CONFIG3_VIEWS = 10_000_000, 24
CONFIG3_RUNS = (("bfloat16", False), ("bfloat16", True), ("float32", False),
                ("float32", True))
CONFIG3_HW = HW             # the recipe's crop, the native frame
# steps an epoch, of the recipe's 21: four runs of whole epochs took 159 s
# on the H100; the whole fit is run on its own (PERF.md)
CONFIG3_STEPS = 8


def phase_config3(report, ctx, dev, workdir):
    """Config 3 on the card: ``python -m read_tpu_torch.make_demo_scene
    --points 10000000 --views 24`` in this process (K6's splat projection
    with K5's key, once a view), then ``read_tpu_torch.train.main`` with
    ``configs/scene10m_probe.yaml`` as it is (read without PyYAML) and
    ``--paths-file`` on the new scene, in bf16 and f32, each with and
    without ``--remat``, ``CONFIG3_STEPS`` steps an epoch: ms/step, peak
    memory, val PSNR/SSIM, the checkpoints the reference's rules leave,
    the epochs' train loss falling, K5 and the pass once a train step
    and val batch."""
    import torch
    from read_tpu_torch import make_demo_scene
    from read_tpu_torch.utils import config_io
    t_phase = time.perf_counter()
    root = os.path.join(workdir, "scene10m")
    shutil.rmtree(root, ignore_errors=True)
    reset_launches()
    t0 = time.perf_counter()
    with without_modules():
        rc = make_demo_scene.main([
            "--out", root, "--points", str(CONFIG3_POINTS), "--views",
            str(CONFIG3_VIEWS), "--width", str(CONFIG3_HW[1]), "--height",
            str(CONFIG3_HW[0]), "--device", dev.type])
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = launches()
    check = dev.type == "cuda"
    if rc != 0 or check and (counts["zbuffer_splat"],
                             counts["zbuffer_pyramid"]) != \
            (CONFIG3_VIEWS, CONFIG3_VIEWS):
        raise SmokeFailure(f"config3 scene: rc {rc}, launches {counts}, want "
                           f"{CONFIG3_VIEWS} splat projections and passes")
    report["zbuffer_splat"]["scene10m_launches"] = counts["zbuffer_splat"]
    pngs = sorted(os.listdir(os.path.join(root, "images")))
    if pngs != [f"{i:06}.png" for i in range(CONFIG3_VIEWS)]:
        raise SmokeFailure(f"config3 scene: images {pngs}")
    with without_modules():
        recipe = config_io.load(CONFIG3)
    val_step = recipe["splitter_args"]["val_step"]
    n_val = len(range(0, CONFIG3_VIEWS, val_step))
    per_epoch = min(CONFIG3_VIEWS - n_val, CONFIG3_STEPS)
    epochs = recipe["epochs"]
    # the CLI's train composite (every log_freq-th step) rasterizes too
    dumps = epochs * (per_epoch // recipe.get("log_freq", 50))
    logs = os.path.join(root, "logs")
    rows = []
    for dtype, remat in CONFIG3_RUNS:
        name = f"{dtype}{'_remat' if remat else ''}"
        flags = ["--config", CONFIG3, "--paths-file",
                 os.path.join(root, "paths.yaml"), "--dtype", dtype,
                 "--max-steps-per-epoch", str(CONFIG3_STEPS)]
        if remat:
            flags.append("--remat")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with without_modules():
            exp, hist, ran = _cli_run(logs, name, flags, dev)
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steps = sum(len(h["train_timing"]["step_ms"]) for h in hist)
        val_batches = sum(h["val_timing"]["batches"] for h in hist)
        if (len(hist), steps, val_batches) != (epochs, epochs * per_epoch,
                                               epochs * n_val):
            raise SmokeFailure(f"config3 {name}: {len(hist)} epochs, {steps} "
                               f"steps, {val_batches} val batches")
        want = steps + val_batches + dumps
        if check and ran != (want, want):
            raise SmokeFailure(f"config3 {name}: K5 and the pass launched "
                               f"{ran}, want {want} each (train steps, val "
                               "batches, train composites)")
        # the epoch's mean train loss: the val loss of a 3-epoch probe at
        # lr 1e-3 and batch 1 can rise for an epoch (BatchNorm's running
        # statistics trail the batch ones)
        train = [h["train_loss"] for h in hist]
        val = [h["val_loss"] for h in hist]
        if not np.isfinite(train + val).all() or not train[-1] < train[0]:
            raise SmokeFailure(f"config3 {name}: train loss {train} did not "
                               f"fall (val {val})")
        with open(os.path.join(exp, "args.yaml")) as f:
            args_dtype = json.load(f)["dtype"]
        ck = os.path.join(exp, "checkpoints")
        kept = expected_checkpoints(hist, ["demo_drive"],
                                    recipe["save_freq"],
                                    metric=lambda h: -h["val"]["psnr"])
        if set(os.listdir(ck)) != kept or args_dtype != dtype:
            raise SmokeFailure(f"config3 {name}: checkpoints "
                               f"{sorted(os.listdir(ck))}, the reference's "
                               f"rules give {sorted(kept)}; dtype "
                               f"{args_dtype}")
        ms_step, wait, n_timed = _steady(hist)
        last = hist[-1]["val"]
        rows.append((name, ms_step, peak, last["psnr"], last["ssim"]))
        report["zbuffer_exact"].setdefault("config3_launches", 0)
        report["zbuffer_exact"]["config3_launches"] += ran[0]
        print(f"[config3] {name}: {ms_step:.2f} ms/step over {n_timed} "
              f"steps (each epoch's first 2 left out; {100 * wait:.1f}% "
              f"waiting on data), peak memory {peak:.2f} GiB, val PSNR "
              + " -> ".join(f"{h['val']['psnr']:.3f}" for h in hist)
              + f", SSIM {hist[0]['val']['ssim']:.4f} -> "
              f"{last['ssim']:.4f}, train loss {train[0]:.6g} -> "
              f"{train[-1]:.6g}, val loss {val[0]:.6g} -> {val[-1]:.6g};"
              " epochs " + ", ".join(f"{h['seconds']:.2f}" for h in hist)
              + " s"
              + f"; K5 {ran[0]}; run {run_s:.1f} s")
    ctx["config3"] = rows
    print(f"[config3] scene: {CONFIG3_POINTS} points, {CONFIG3_VIEWS} views "
          f"at {CONFIG3_HW[1]}x{CONFIG3_HW[0]} by "
          f"read_tpu_torch.make_demo_scene in {gen_s:.2f} s "
          f"({counts['zbuffer_splat']} splat projections); recipe "
          f"{CONFIG3} ({epochs} epochs x {per_epoch} steps, crop "
          f"{recipe['crop_size']}, batch {recipe['batch_size']}, "
          f"{recipe['criterion']}); phase {time.perf_counter() - t_phase:.1f}"
          " s")
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


VIEWER_FRAMES = 20


def phase_viewer(report, ctx, dev):
    """The viewer on the CLI phase's best ``sort`` checkpoint of its 1M-
    point drive at 1216x368: ``viewer.main([..., '--offscreen', '20'])``
    as a user runs it (no cv2: K5 and the pass once a frame, K2's and the
    1x1 loop as their routes predict for its neural frames), then a
    ``ViewerApp``: ``VIEWER_FRAMES`` neural frames (fps, ms/frame) beside
    ``infer`` of a ``NeuralRenderer`` built apart from the app on the
    same checkpoint, in the same window, the app's frame bit-equal to
    that renderer's for the same pose, ``+`` through K6's splat
    projection and ``-`` back to 1-px points (the frame as before), ``t``,
    and every raw mode the scene has attributes for, once each."""
    import io
    import torch
    from read_tpu_torch import viewer
    from read_tpu_torch.render import NeuralRenderer
    from read_tpu_torch.utils import profiling
    t_phase = time.perf_counter()
    scene, ckpt, targets = ctx["drive"]
    # 1. the CLI, offscreen
    out = io.StringIO()
    reset_launches()
    with without_modules(), contextlib.redirect_stdout(out):
        rc = viewer.main(["--scene", scene, "--ckpt", ckpt, "--offscreen",
                          str(VIEWER_FRAMES), "--nearest-train", "--gt",
                          os.path.join(targets, "*.png"), "--device",
                          dev.type])
    torch.cuda.synchronize()
    counts = launches()
    lines = out.getvalue().strip().splitlines()
    # read_tpu's smoke: the trajectory's frames and the keys w, d, 1, n
    # render neural frames; m, c, v, p and the replay raw ones
    neural = VIEWER_FRAMES + 4
    frames = neural + 4 + 3
    if rc != 0 or not lines[-1].startswith(f"offscreen ok: {frames} "
                                           "frames") \
            or "loaded" not in lines[-2]:
        raise SmokeFailure(f"viewer --offscreen: rc {rc}, output {lines}")
    check = dev.type == "cuda"
    if check:
        pyramid_ran("viewer --offscreen", counts, "zbuffer_exact", frames)
        routed_loops_ran(ctx, "viewer --offscreen", counts, neural)
    report["zbuffer_exact"]["viewer_launches"] = counts["zbuffer_exact"]

    # 2. the app beside the renderer
    app = viewer.ViewerApp(scene, ckpt, device=dev)
    r = app.r
    views = r.scene_data["view_matrix"]
    poses = [np.asarray(views[i % len(views)], np.float64)
             for i in range(VIEWER_FRAMES)]
    apart = NeuralRenderer(scene, ckpt, device=dev)
    for pose in poses[:2]:                     # warm-up
        app.tb.m = pose.copy()
        app.render()
        apart.infer(pose)
    app.frame_times.clear()
    for pose in poses:
        app.tb.m = pose.copy()
        app.render()
    fps = app.fps
    infer_ms = profiling.device_timeit(apart.infer, poses[3],
                                       iters=VIEWER_FRAMES)["mean_ms"]
    app.tb.m = poses[3].copy()
    frame = app.render()
    if not np.array_equal(frame, apart.infer(poses[3])):
        raise SmokeFailure("viewer: the app's neural frame differs from "
                           "NeuralRenderer.infer's for the same pose")
    del apart
    reset_launches()
    app.handle_key("+")
    splat = app.render()
    plus = launches()
    app.handle_key("-")
    back = app.render()
    if check and (plus["zbuffer_splat"], plus["zbuffer_exact"]) != (1, 0) or \
            r.cfg.point_radius != 0 or not np.array_equal(back, frame) or \
            np.array_equal(splat, frame):
        raise SmokeFailure(f"viewer: '+' launches {plus}, radius back to "
                           f"{r.cfg.point_radius}, '-' frame as before "
                           f"{np.array_equal(back, frame)}")
    report["zbuffer_splat"]["viewer_launches"] = plus["zbuffer_splat"]
    app.handle_key("t")
    ta = [app.render() for _ in range(2)]
    app.handle_key("t")
    if not (r.temporal_average is False and all(np.isfinite(a).all()
                                                for a in ta)):
        raise SmokeFailure("viewer: 't' did not toggle temporal averaging")
    mode_ms = {}
    # texture2d needs a scene texture image; the drive has none
    for key in "cvblph" + "mmmm":
        app.handle_key(key)
        t0 = time.perf_counter()
        img = app.render()
        mode_ms[app.mode] = (time.perf_counter() - t0) * 1e3
        if img.shape != frame.shape or not np.isfinite(img).all():
            raise SmokeFailure(f"viewer: mode {app.mode} gave a bad frame")
    app.handle_key("n")
    print(f"[viewer] --offscreen {VIEWER_FRAMES}: {lines[-1]} (no cv2; K5 "
          f"{counts['zbuffer_exact']}, K2 wgmma "
          f"{counts['gated_conv_kxk_wgmma']} for {neural} neural frames); "
          f"app: {fps:.3f} fps, {1e3 / fps:.3f} ms/frame over "
          f"{VIEWER_FRAMES} neural frames beside NeuralRenderer.infer "
          f"{infer_ms:.3f} ms/frame in the same window (one pose, CUDA "
          f"events, profiling.device_timeit); frame bit-equal "
          f"to that renderer's; '+' splat launches {plus['zbuffer_splat']}, '-' back "
          f"to radius 0 bit-equal; raw modes ms "
          + ", ".join(f"{k} {v:.1f}" for k, v in mode_ms.items())
          + f"; phase {time.perf_counter() - t_phase:.1f} s")
    del app, r
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Multi-device training: the pass-only entry, the sharded step on a 1x1
# NCCL mesh and on 1x2 / 2x1 gloo meshes sharing the card, the --mesh CLI
# ---------------------------------------------------------------------------

SHARDED_SHAPES = ((1, 2), (2, 1))
SHARDED_TIMEOUT_S = 300      # each collective and the group's set-up
SHARDED_JOIN_S = 300         # each spawn
SHARDED_LOSS_RTOL = 1e-4     # tests/test_sharded.py:130


def sharded_pool_kernel(report, dev):
    """``zbuffer_pool`` (the pass on given keys) bit-equal to its twin at
    the bench point (a merged-key buffer of K5's level 0, B=8, 256x256,
    1M points, 4 levels) and with every pixel empty; timed beside its
    twin, with its bound (the keys read once, the levels written once).
    No single PyTorch call pools a 64-bit key pyramid: ``library_ms`` is
    null."""
    import torch
    from read_tpu_torch.frame import train_inputs
    from read_tpu_torch.kernel_bench import bound, event_ms
    from read_tpu_torch.ops import rasterize_kernels as RK
    xyz, ms, _ = train_inputs(TRAIN_B, N_POINTS, TRAIN_HW)
    xyz = torch.from_numpy(xyz).to(dev)
    ms = torch.from_numpy(ms).to(dev)
    hw = (TRAIN_HW, TRAIN_HW)
    ix, dep = RK.zbuffer_exact(xyz, ms, *hw)
    key = RK.exact_keys(ix, dep).view(TRAIN_B, *hw)
    empty = torch.full_like(key, RK.INT64_MAX)
    for label, keys in (("bench", key), ("empty", empty)):
        before = RK.launches["zbuffer_pool"]
        got = RK.zbuffer_pool(keys, 4)
        if RK.launches["zbuffer_pool"] != before + 1:
            raise SmokeFailure("zbuffer_pool: no launch counted")
        want = RK.zbuffer_pool_plain(keys, 4)
        torch.cuda.synchronize()
        for lv, ((ig, dg), (iw, dw)) in enumerate(zip(got, want)):
            if not (torch.equal(ig, iw) and torch.equal(dg, dw)):
                raise SmokeFailure(f"zbuffer_pool {label} level {lv}: "
                                   "differs from the twin")
    t_k = event_ms(lambda: RK.zbuffer_pool(key, 4), iters=20)
    t_p = event_ms(lambda: RK.zbuffer_pool_plain(key, 4), iters=20)
    pixels = sum(TRAIN_B * (TRAIN_HW >> i) ** 2 for i in range(4))
    b_ms, by = bound(3.0 * (pixels - TRAIN_B * TRAIN_HW ** 2),
                     8 * TRAIN_B * TRAIN_HW ** 2 + 8 * pixels)
    report["zbuffer_pool"].update(
        ms=t_k, plain_ms=t_p, library_ms=None, bound_ms=b_ms, bound_by=by,
        max_abs_err=0.0, shape=f"B={TRAIN_B} {TRAIN_HW}x{TRAIN_HW}, 4 "
                               "levels, K5's keys")
    print(f"[sharded] zbuffer_pool (the pass on given keys) B={TRAIN_B} "
          f"{TRAIN_HW}x{TRAIN_HW}, 4 levels: bit-equal to its twin (and "
          f"on an empty buffer); kernel {t_k:.4f} ms, twin {t_p:.4f} ms, "
          f"bound {b_ms:.4f} ms ({by})")


def _timed_collectives(mesh, acc):
    """Wrap this rank's collectives (on the mesh instance) to add their
    host seconds, the card synchronized before and after, to ``acc`` by
    kind: the merge (MIN), the gather's sums (points group), the
    cotangents' all-gather, gradients (over a million elements) and the
    rest (BatchNorm, metrics)."""
    import torch
    import torch.distributed as dist
    reduce, gather = mesh.all_reduce, mesh.all_gather

    def timed(kind, fn, t, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(t, *a, **k)
        torch.cuda.synchronize()
        acc[kind] = acc.get(kind, 0.0) + time.perf_counter() - t0
        acc[kind + "_mib"] = acc.get(kind + "_mib", 0.0) \
            + t.numel() * t.element_size() / 2 ** 20
        return out

    def all_reduce(t, op=dist.ReduceOp.SUM, group=None):
        kind = ("merge" if op == dist.ReduceOp.MIN else
                "maps" if group is mesh.points_group else
                "gradients" if t.numel() > 1_000_000 else "small")
        return timed(kind, reduce, t, op, group)

    mesh.all_reduce = all_reduce
    mesh.all_gather = lambda t, group: timed("cotangents", gather, t, group)


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _sharded_mesh_run(mesh, ctx, out, bf16_check):
    """One mesh shape on this rank (see :func:`sharded_rank`)."""
    import torch
    from read_tpu_torch.ops import rasterize as R
    from read_tpu_torch.ops import rasterize_kernels as RK
    from read_tpu_torch.parallel import sharded as S
    from read_tpu_torch.pipelines import texture_pipeline as TP
    net, cfg, vgg, state, xyz, batch = ctx
    st = S.prepare_scene_state(mesh, state)
    xl = S.shard_points(mesh, xyz)
    # the merged pyramid against the unsharded K5 pyramid of the block
    blk = S.shard_batch(mesh, batch)
    got = S.sharded_rasterize_pyramid(
        mesh, xl, mesh.points_index * xl.shape[0], blk["total_m"],
        cfg.crop_size, cfg.num_scales)
    want = R.rasterize_pyramid_pooled(xyz, blk["total_m"], cfg.crop_size,
                                      cfg.num_scales)
    out["pyramid_equal"] = all(torch.equal(a, c) and torch.equal(b, e)
                               for (a, b), (c, e) in zip(got, want))
    del got, want
    # the main path: every kernel of the step, once a step
    step = S.make_sharded_train_step(net, cfg, vgg, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses = []
    for i in range(WARMUP + TIMED):
        if i == WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        new, metrics = step(st, xl, batch)
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    out["ms"] = (time.perf_counter() - t0) / TIMED * 1e3
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["launches"] = {k: v for k, v in launches().items() if v}
    out["first_loss"] = losses[0]
    out["losses"] = losses
    # one step more with its collectives timed
    acc = {}
    _timed_collectives(mesh, acc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(st, xl, batch)
    torch.cuda.synchronize()
    acc["step"] = time.perf_counter() - t0
    out["collectives"] = {k: v * 1e3 if not k.endswith("_mib") else v
                          for k, v in acc.items()}
    if bf16_check:
        bcfg = dataclasses.replace(cfg, dtype="bfloat16")
        m, *_ = S.sharded_loss_and_grads(net, bcfg, vgg, mesh, st, xl, batch)
        out["bf16_first_loss"] = float(m["loss"])
    del new, st
    torch.cuda.empty_cache()


def sharded_rank(rank, world, device, out_dir, shapes, bf16_check):
    """One rank of the sharded phase (the ranks import this script): the
    bench point's fresh state from the same seeds on every rank; for each
    mesh shape the merged pyramid against the unsharded K5 pyramid,
    ``WARMUP + TIMED`` steps of ``parallel.sharded.make_sharded_train_step``
    (ms/step, peak memory, the launch counts over those steps), one step
    more with its collectives timed, and on a 1x2 mesh one bf16 loss.
    Rank 0 then runs the unsharded step on the whole batch for the
    losses (and on a 1x1 mesh compares the raw gradients, cuDNN
    deterministic, and times the unsharded step in the same window).
    Each rank writes ``rank<r>.json``."""
    import torch
    from read_tpu_torch.parallel import sharded as S
    from read_tpu_torch.pipelines import texture_pipeline as TP
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = train_setup(device)
    net, cfg, vgg, state, xyz, batch = ctx
    res = {"rank": rank, "world": world, "device":
           torch.cuda.get_device_name(device), "meshes": {}}
    for shape in shapes:
        mesh = S.make_mesh(*shape, device)
        res["backend"] = mesh.backend
        out = res["meshes"][f"{shape[0]}x{shape[1]}"] = {}
        _sharded_mesh_run(mesh, ctx, out, bf16_check and shape == (1, 2))
    if rank == 0:
        ref = res["unsharded"] = {}
        m, *_ = TP._loss_and_grads(net, cfg, vgg, state, xyz, batch, False)
        ref["loss"] = float(m["loss"])
        if bf16_check:
            bcfg = dataclasses.replace(cfg, dtype="bfloat16")
            m, *_ = TP._loss_and_grads(net, bcfg, vgg, state, xyz, batch,
                                       False)
            ref["bf16_loss"] = float(m["loss"])
        if tuple(shapes) == ((1, 1),):
            mesh = S.make_mesh(1, 1, device)
            saved = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
            try:
                ms_, _, _, gs_net, gs_tex = TP._loss_and_grads(
                    net, cfg, vgg, state, xyz, batch, False)
                m, _, g_net, g_tex = S.sharded_loss_and_grads(
                    net, cfg, vgg, mesh, S.prepare_scene_state(mesh, state),
                    S.shard_points(mesh, xyz), batch)
                ref["loss_rel"] = float((m["loss"] - ms_["loss"]).abs()
                                        / ms_["loss"].abs())
                views = state.layout.views(g_net)
                want = state.layout.views(gs_net)
                ref["grad_rel"] = max(
                    [_rel(views[k], want[k]) for k in views]
                    + [_rel(g_tex[0], gs_tex[0])])
            finally:
                torch.backends.cudnn.deterministic = saved
            del gs_net, gs_tex, g_net, g_tex
            torch.cuda.empty_cache()
            step = TP.make_train_step(net, cfg, vgg)
            torch.cuda.reset_peak_memory_stats()
            seconds, _, _ = timed_steps(step, state, xyz, batch)
            ref["ms"] = seconds * 1e3
            ref["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _spawn_sharded(dev, out_dir, world, shapes, bf16_check):
    """The ranks of one spawn; their results, rank by rank."""
    import torch
    from read_tpu_torch.parallel import launch
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launch.spawn(sharded_rank, world, dev.type,
                 args=(out_dir, shapes, bf16_check),
                 timeout_s=SHARDED_TIMEOUT_S, join_s=SHARDED_JOIN_S)
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results, time.perf_counter() - t0


def _check_mesh_runs(label, results, ref):
    """Fail unless every rank's merged pyramid was bit-equal, each of
    its steps launched K5, the one-level pass and ``zbuffer_pool`` once,
    and its first loss lies within ``SHARDED_LOSS_RTOL`` of the
    unsharded step's; lines for the ms/step and memory per rank."""
    lines = []
    for name in results[0]["meshes"]:
        for res in results:
            out = res["meshes"][name]
            steps = WARMUP + TIMED
            want = {"zbuffer_exact": steps, "zbuffer_pyramid": steps,
                    "zbuffer_pool": steps}
            if not out["pyramid_equal"]:
                raise SmokeFailure(f"sharded {label} {name} rank "
                                   f"{res['rank']}: merged pyramid differs "
                                   "from the unsharded K5 pyramid")
            if out["launches"] != want:
                raise SmokeFailure(f"sharded {label} {name} rank "
                                   f"{res['rank']}: launches "
                                   f"{out['launches']}, want {want}")
            rel = abs(out["first_loss"] - ref["loss"]) / abs(ref["loss"])
            if not rel <= SHARDED_LOSS_RTOL \
                    or not np.isfinite(out["losses"]).all():
                raise SmokeFailure(f"sharded {label} {name}: first loss "
                                   f"{out['first_loss']} vs unsharded "
                                   f"{ref['loss']} (rel {rel:.3g})")
            if "bf16_first_loss" in out:
                brel = abs(out["bf16_first_loss"] - ref["bf16_loss"]) \
                    / abs(ref["bf16_loss"])
                if not brel <= BF16_LOSS_RTOL:
                    raise SmokeFailure(f"sharded {label} {name}: bf16 first "
                                       f"loss rel {brel:.3g}")
                out["bf16_rel"] = brel
            c = out["collectives"]
            lines.append(
                f"{name} rank {res['rank']} ({res['backend']}): "
                f"{out['ms']:.2f} ms/step, peak {out['peak_gib']:.2f} GiB, "
                f"first loss rel {rel:.3g}"
                + (f", bf16 rel {out['bf16_rel']:.3g}" if "bf16_rel" in out
                   else "")
                + "; one step " + f"{c['step']:.2f} ms, collectives "
                + ", ".join(f"{k} {c[k]:.2f} ms ({c[k + '_mib']:.1f} MiB)"
                            for k in ("merge", "maps", "cotangents",
                                      "gradients", "small") if k in c))
    return lines


def phase_sharded(report, ctx, dev, workdir):
    """Multi-device training (``read_tpu_torch.parallel``) on one card:
    the pass-only entry (:func:`sharded_pool_kernel`); a 1x1 mesh on NCCL
    against the unsharded step (pyramids bit-equal, loss and gradients
    within 1e-6 relative, both timed in one window); 1x2 and 2x1 meshes as
    two gloo ranks sharing the card (merged pyramids bit-equal to the
    unsharded K5 pyramid, first loss within 1e-4 of the unsharded step's,
    one bf16 1x2 loss within 1e-3 of the unsharded bf16 step's; ms/step,
    peak memory and collectives per rank). Two ranks on one card are no
    scaling result. Then ``--mesh 1x2`` through the CLI for one short
    epoch of the cli phase's ``drive_a``, whose unsharded checkpoint
    serves one request."""
    import torch
    from read_tpu_torch.render import NeuralRenderer
    t_phase = time.perf_counter()
    sharded_pool_kernel(report, dev)
    root = os.path.join(workdir, "sharded")
    one, s1 = _spawn_sharded(dev, os.path.join(root, "1x1"), 1,
                             ((1, 1),), False)
    ref1 = one[0]["unsharded"]
    if one[0]["backend"] != "nccl":
        raise SmokeFailure(f"sharded 1x1: backend {one[0]['backend']}")
    if not (ref1["loss_rel"] <= 1e-6 and ref1["grad_rel"] <= 1e-6):
        raise SmokeFailure(f"sharded 1x1: loss rel {ref1['loss_rel']:.3g}, "
                           f"gradient rel {ref1['grad_rel']:.3g} (bound 1e-6)")
    lines = _check_mesh_runs("1x1", one, ref1)
    report["zbuffer_pool"]["launches"] = \
        one[0]["meshes"]["1x1"]["launches"]["zbuffer_pool"]
    two, s2 = _spawn_sharded(dev, os.path.join(root, "gloo"), 2,
                             SHARDED_SHAPES, True)
    if {r["backend"] for r in two} != {"gloo"}:
        raise SmokeFailure("sharded: two ranks on one card must use gloo")
    lines += _check_mesh_runs("gloo", two, two[0]["unsharded"])
    for line in lines:
        print(f"[sharded] {line}")
    print(f"[sharded] 1x1 (NCCL) beside the unsharded step, one window: "
          f"{one[0]['meshes']['1x1']['ms']:.2f} vs {ref1['ms']:.2f} ms/step, "
          f"peak {one[0]['meshes']['1x1']['peak_gib']:.2f} vs "
          f"{ref1['peak_gib']:.2f} GiB; loss rel {ref1['loss_rel']:.3g}, "
          f"gradients rel {ref1['grad_rel']:.3g} (bound 1e-6); spawns "
          f"{s1:.1f} s (1 rank) and {s2:.1f} s (2 ranks); two ranks "
          "sharing one card are no scaling result")
    # the CLI
    if "drive" not in ctx:
        raise SmokeFailure("sharded: the cli phase's drive is missing")
    from read_tpu_torch import train
    cli = os.path.join(workdir, "cli")
    config = os.path.join(cli, "demo_drive.json")
    scene = CLI_SCENES[0]
    save = os.path.join(root, "cli")
    shutil.rmtree(save, ignore_errors=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rc = train.main(["--config", config, "--mesh", "1x2", "--dataset-names",
                     scene, "--epochs", "1", "--max-steps-per-epoch", "4",
                     "--save-dir", save, "--name", "mesh"])
    cli_s = time.perf_counter() - t0
    if rc != 0:
        raise SmokeFailure(f"sharded cli: exit code {rc}")
    (exp,) = os.listdir(save)
    exp = os.path.join(save, exp)
    with open(os.path.join(exp, "history.json")) as f:
        hist = json.load(f)
    ck = os.path.join(exp, "checkpoints")
    want = expected_checkpoints(hist, [scene], DEMO_DRIVE["save_freq"])
    if set(os.listdir(ck)) != want:
        raise SmokeFailure(f"sharded cli: checkpoints {sorted(os.listdir(ck))}"
                           f", the reference's rules give {sorted(want)}")
    if not np.isfinite([hist[0]["train_loss"], hist[0]["val_loss"]]).all():
        raise SmokeFailure(f"sharded cli: history {hist}")
    r = NeuralRenderer(ctx["drive"][0], os.path.join(ck, f"best_{scene}"),
                       device=dev)
    reset_launches()
    img = r.infer(r.scene_data["view_matrix"][3])
    pyramid_ran("sharded cli serve", launches(), "zbuffer_exact", 1)
    if img.shape != (*HW, 3) or not np.isfinite(img).all():
        raise SmokeFailure("sharded cli serve: bad frame")
    del r
    ms_step, _, n_timed = _steady(hist)
    print(f"[sharded] cli --mesh 1x2 (gloo, one card) on {scene}: 1 epoch "
          f"of 4 steps, {ms_step:.2f} ms/step over {n_timed} steps after "
          f"the first 2, val loss {hist[0]['val_loss']:.6g}; unsharded "
          f"checkpoints as read_tpu.train's rules leave them; one request "
          f"from best_{scene} on one device; run {cli_s:.1f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s")


def check_report(report):
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err")
    for name, row in report.items():
        # library_ms may be null where no PyTorch call computes the same
        # function, and the row says so
        missing = [k for k in keys if row.get(k) is None
                   and not (k == "library_ms" and k in row)]
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
              ("raster_methods",
               lambda: phase_raster_methods(report, ctx, dev)),
              ("free", lambda: (ctx.pop("train"), ctx.pop("trained"),
                                torch.cuda.empty_cache())),
              ("splats", lambda: phase_splats(report, dev, workdir)),
              ("cli", lambda: phase_cli(report, ctx, dev, workdir)),
              ("apps", lambda: phase_apps(report, ctx, dev, workdir)),
              ("extra_modes",
               lambda: phase_extra_modes(report, ctx, dev, workdir)),
              ("augment", lambda: phase_augment(report, ctx, dev)),
              ("mesh", lambda: phase_mesh(report, ctx, dev, workdir)),
              ("alt_pipelines",
               lambda: phase_alt_pipelines(report, ctx, dev, workdir)),
              ("bf16_train", lambda: phase_bf16_train(report, ctx, dev)),
              ("config3", lambda: phase_config3(report, ctx, dev, workdir)),
              ("viewer", lambda: phase_viewer(report, ctx, dev)),
              ("sharded",
               lambda: phase_sharded(report, ctx, dev, workdir)),
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
