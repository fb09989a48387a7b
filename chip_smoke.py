#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``read_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``);
without a device it exits non-zero at once. It

1. builds the port's CUDA kernels from ``read_tpu_torch/csrc``;
2. holds each kernel against its plain PyTorch twin at the shapes of the
   full-width serving path (K1 bit-equal; K2/K3 within the f32
   tolerance of ``tests/test_unet_pallas.py``, with bf16 operands
   too, since kernel and twin round the same operands and sum in f32)
   and times both with CUDA events;
3. serves 4 requests through ``read_tpu_torch.render.NeuralRenderer``
   from a random-weight full-width checkpoint written in ``read_tpu``'s
   format, over a 1M-point scene at 1216x368, and checks every kernel
   ran on that path (launch counters); then serves 2 of those requests
   with ``dtype='bfloat16'``, which must run K2's bf16 wgmma loop as
   often as ``ops.gated_conv.kxk_route`` predicts (79 calls a frame) and
   match the all-twin request;
4. holds K5, the exact z-buffer, bit-equal against its twin at 1M
   points (1216x368 at B=1 and 2, with heavy ties, and 256x256 at B=8)
   and times both;
5. trains: one full training step from a fresh full-width state, with
   K5 and with its twin (cuDNN deterministic), must give bit-equal
   pyramids and the same loss and gradients within 1e-6 relative; then
   10 steps at the bench operating point (256x256 crops, B=8, 1M
   points, VGG on, the default config) are timed (2 warm-up, 5 timed)
   and must lower the loss on their fixed batch;
6. saves the trained state as a ``read_tpu`` checkpoint with the
   default config (``sort``) and serves 2 requests from it at 1216x368,
   through K5, K2 and K3;
7. times ``read_tpu_torch.frame.make_frame`` at B=1 and B=4 with bf16
   and f32 operands, and compares one B=1 frame (f32 and bf16 operands)
   with the same frame with every kernel swapped for its twin; a bf16
   frame that runs the wgmma loop fewer times than the route predicts
   fails;
8. runs the kernel bench (``read_tpu_torch.kernel_bench``) in-process:
   K1, K5 and K6 (bit-equal, ties included) at 1M points, 1216x368, B=1
   and 2; K7 beside K2 and K3, and K8's four modes, at the four level
   shapes; K4 at the frame's SCM sites and the two concat probes; f32
   and bf16; each against its twin, with its library yardstick and
   bound; K2's bf16 rows (the wgmma loop) are printed beside K8 ``full``
   bf16 (the old loop) of the same run.

The serving phases also require K4 (``gated_conv_1x1_cat``): 3 launches
per request, the SCMs' ``BasicConv_4``. TF32 is off throughout, so the
twins' convolutions and matmuls are full float32. Any failed check
raises and the script exits non-zero. The last stdout line is ``{"ok":
true, "device": {...}}``; the line before it lists each kernel's
launches (counted on the run of the path it serves: K1-K4 on the
serving path, K2's wgmma loop on the bf16 serving requests, K5 on the
training steps, K6-K8 on the kernel bench's first pass), error, its
time, its twin's, the library call's and its bound (``shape`` says what
they were measured on); K2's entry adds its bf16 per-frame times
(``bf16_ms``, ``bf16_plain_ms``, ``bf16_library_ms``, ``bf16_bound_ms``).
"""

import contextlib
import json
import os
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
    "gated_conv_1x1_cat": ("read_tpu_torch/csrc/gated_conv.cu",
                           "read_tpu/ops/gated_conv_pack.py:509"),
    "zbuffer_keys": ("read_tpu_torch/csrc/zbuffer.cu",
                     "read_tpu/ops/rasterize_pallas.py:234"),
    "gated_conv3x3_r2": ("read_tpu_torch/csrc/gated_conv_r2.cu",
                         "scripts/gated_conv_pallas_r2.py:73"),
    "gated_conv1x1_r2": ("read_tpu_torch/csrc/gated_conv_r2.cu",
                         "scripts/gated_conv_pallas_r2.py:169"),
    "gated_conv_probe": ("read_tpu_torch/csrc/gated_conv_probe.cu",
                         "scripts/probe_pack_split.py:33"),
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
    from read_tpu_torch.kernel_bench import event_ms
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
        t_p = event_ms(lambda: RK.zbuffer_plain(xyz, ms, *HW), iters=20)
        print(f"[zbuffer] B={b} N={N_POINTS} {HW[1]}x{HW[0]}: bit-equal, "
              f"{filled:.3f} of pixels covered; kernel {t_k:.4f} ms, "
              f"twin {t_p:.4f} ms")
        if b == 1:
            report["zbuffer"].update(ms=t_k, plain_ms=t_p,
                                     shape=f"B=1 N={N_POINTS} {HW[1]}x"
                                           f"{HW[0]}")
            library_and_bound(report["zbuffer"], *KB.zbuffer_yardsticks(
                xyz, ms, HW)[2]["zbuffer"])
    report["zbuffer"]["max_abs_err"] = 0.0


def phase_zbuffer_exact(report, dev):
    import torch
    from read_tpu_torch import kernel_bench as KB
    from read_tpu_torch.frame import frame_inputs, train_inputs
    from read_tpu_torch.kernel_bench import event_ms
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
        t_p = event_ms(lambda: RK.zbuffer_exact_plain(xyz, ms, *hw),
                       iters=20)
        print(f"[zbuffer_exact] {label} N={xyz.shape[0]} {hw[1]}x{hw[0]}: "
              f"bit-equal, {filled:.3f} of pixels covered; kernel "
              f"{t_k:.4f} ms, twin {t_p:.4f} ms")
    # the training step's shape (the last case)
    report["zbuffer_exact"].update(ms=t_k, plain_ms=t_p, max_abs_err=0.0,
                                   shape=f"{label} N={xyz.shape[0]} "
                                         f"{hw[1]}x{hw[0]}")
    library_and_bound(report["zbuffer_exact"], *KB.zbuffer_yardsticks(
        xyz, ms, hw)[2]["zbuffer_exact"])


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
    if counts["zbuffer_exact"] == 0:
        raise SmokeFailure("train: K5 never ran on the training path")
    report["zbuffer_exact"]["launches"] = counts["zbuffer_exact"]
    print(f"[train] {TRAIN_B}x{TRAIN_HW}^2 crops, {N_POINTS} points, "
          f"full-width UNet, VGG on: {seconds * 1e3:.2f} ms/step, "
          f"{1.0 / seconds:.3f} steps/s (mean of {TIMED} "
          f"after {WARMUP} warm-up); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; loss "
          f"{losses[0]:.6g} -> {losses[-1]:.6g} over {TRAIN_STEPS} steps; "
          f"launches {counts}")
    ctx["trained"] = state


def phase_serve_sort(ctx, dev, workdir):
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
    print(f"[serve_sort] trained checkpoint, default config (sort): "
          f"{len(imgs)} requests at {w}x{h}, "
          f"{seconds * 1e3 / len(imgs):.2f} ms/request (first included); "
          f"launches {counts}")


def record_conv_shapes(dev, operands="bf16"):
    """Run one full-width B=1 frame with recording shims around K2/K3:
    ``{(name, x shape, w shape, stride, relu, has_res, route): calls}``,
    ``route`` being K2's ``kxk_route`` (``'1x1'`` for K3)."""
    from read_tpu_torch.frame import make_frame
    from read_tpu_torch.ops import gated_conv as GC
    counts = {}

    def shim(name, real):
        def fn(x, w, b, scale, offset, res=None, **kw):
            route = (GC.kxk_route(x, w, kw["bf16"])
                     if name == "gated_conv_kxk" else "1x1")
            key = (name, tuple(x.shape), tuple(w.shape),
                   kw.get("stride", 1), kw["relu"], res is not None, route)
            counts[key] = counts.get(key, 0) + 1
            return real(x, w, b, scale, offset, res, **kw)
        return fn

    frame_fn, args = make_frame(1, operands, device=dev)
    saved = (GC.gated_conv_kxk, GC.gated_conv_1x1)
    GC.gated_conv_kxk = shim("gated_conv_kxk", saved[0])
    GC.gated_conv_1x1 = shim("gated_conv_1x1", saved[1])
    try:
        frame_fn(*args)
    finally:
        GC.gated_conv_kxk, GC.gated_conv_1x1 = saved
    return counts


def phase_convs(report, ctx, dev):
    """Every gated-conv shape of one full-width frame, f32 and bf16
    operands, kernel against twin; sums per B=1 frame. The bf16 K2 calls
    that ``kxk_route`` sends to the wgmma loop also sum into its own
    entry, and their count per frame goes to ``ctx['wgmma_per_frame']``
    for the frame and serving phases."""
    import torch
    from read_tpu_torch.kernel_bench import (bound, conv_cost, event_ms,
                                             library_conv, max_err)
    from read_tpu_torch.ops import gated_conv as GC
    counts = record_conv_shapes(dev)
    torch.cuda.synchronize()
    ctx["wgmma_per_frame"] = sum(n for key, n in counts.items()
                                 if key[-1] == "wgmma")
    gen = torch.Generator(device=dev).manual_seed(0)
    # per B=1 frame and operand type: kernel, twin and library ms, and
    # the bound's ms by limiting resource
    per_frame = {n: {ops: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                           "operations": 0.0, "bytes": 0.0}
                     for ops in ("f32", "bf16")}
                 for n in ("gated_conv_kxk", "gated_conv_1x1",
                           "gated_conv_kxk_wgmma")}
    errs = {n: 0.0 for n in per_frame}
    print(f"[convs] {len(counts)} distinct gated-conv shapes in one "
          "full-width frame")
    for (name, xs, ws, stride, relu, has_res, route), n in sorted(
            counts.items()):
        kernel = getattr(GC, name)
        twin = getattr(GC, name + "_plain")
        cin, c2 = ws[-2], ws[-1]
        x = torch.randn(xs, generator=gen, device=dev)
        w = torch.randn(ws, generator=gen, device=dev) * (
            1.0 / (cin * (ws[0] * ws[1] if len(ws) == 4 else 1)) ** 0.5)
        b = torch.randn(c2, generator=gen, device=dev) * 0.1
        scale = torch.rand(c2 // 2, generator=gen, device=dev) + 0.5
        offset = torch.randn(c2 // 2, generator=gen, device=dev) * 0.1
        kw = dict(relu=relu)
        if name == "gated_conv_kxk":
            kw["stride"] = stride
        out_shape = kernel(x, w, b, scale, offset, None, **kw).shape
        res = (torch.randn(out_shape, generator=gen, device=dev)
               if has_res else None)
        k = ws[0] if len(ws) == 4 else 1
        flops, nbytes = conv_cost(xs, k, stride, c2, c2 // 2, res=has_res)
        line = []
        # bf16: the bf16 bound, then the f32 bound too, because the
        # kernel and its twin round the same operands and sum in f32
        for ops, tols in (("f32", (F32_TOL,)),
                          ("bf16", (BF16_TOL, F32_TOL))):
            kw["bf16"] = ops == "bf16"
            wgmma = kw["bf16"] and route == "wgmma"
            if wgmma:   # packed once, as BasicConv caches it
                kw["packed"] = GC.pack_kxk_bf16(w)
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
            xl, wl = (x.bfloat16(), w.bfloat16()) if kw["bf16"] else (x, w)
            if name == "gated_conv_kxk":
                library = (lambda: library_conv(xl, wl, stride))
            else:
                library = (lambda: torch.matmul(xl, wl.reshape(cin, c2)))
            t_k = event_ms(lambda: kernel(x, w, b, scale, offset, res,
                                          **kw))
            t_p = event_ms(lambda: twin(x, w, b, scale, offset, res, **kw))
            t_l = event_ms(library)
            b_ms, by = bound(flops, nbytes, kw["bf16"])
            for acc in [per_frame[name][ops]] + (
                    [per_frame["gated_conv_kxk_wgmma"][ops]] if wgmma
                    else []):
                for key, t in (("ms", t_k), ("plain_ms", t_p),
                               ("library_ms", t_l), (by, b_ms)):
                    acc[key] += n * t
            if wgmma:
                errs["gated_conv_kxk_wgmma"] = max(
                    errs["gated_conv_kxk_wgmma"], err)
                kw.pop("packed")
            line.append(f"{ops}{' wgmma' if wgmma else ''}: err "
                        f"{err:.2e} kernel {t_k:.4f} ms twin "
                        f"{t_p:.4f} library {t_l:.4f} bound {b_ms:.4f} "
                        f"({by})")
        print(f"[convs] {name} x{list(xs)} w{list(ws)} s{stride} "
              f"relu={relu} res={has_res} (x{n}/frame) | "
              + " | ".join(line))
    for name, by_ops in per_frame.items():
        for ops, a in by_ops.items():
            b_ms = a["operations"] + a["bytes"]
            if b_ms == 0:   # the wgmma loop takes no f32 call
                continue
            print(f"[convs] {name} per B=1 frame ({ops} operands): kernel "
                  f"{a['ms']:.3f} ms, twin {a['plain_ms']:.3f}, library "
                  f"{a['library_ms']:.3f}, bound {b_ms:.3f} (operations "
                  f"{a['operations']:.3f}, bytes {a['bytes']:.3f}), "
                  f"kernel/bound {a['ms'] / b_ms:.1f}")
        ops = "bf16" if name == "gated_conv_kxk_wgmma" else "f32"
        a = by_ops[ops]
        report[name].update(
            max_abs_err=errs[name], ms=a["ms"], plain_ms=a["plain_ms"],
            library_ms=a["library_ms"],
            bound_ms=a["operations"] + a["bytes"],
            bound_by=max(("operations", "bytes"), key=a.get),
            shape=f"the shapes of one full-width B=1 frame, {ops}, summed"
                  + (f" ({ctx['wgmma_per_frame']} calls)"
                     if ops == "bf16" else ""))
    a = per_frame["gated_conv_kxk"]["bf16"]
    report["gated_conv_kxk"].update(
        bf16_ms=a["ms"], bf16_plain_ms=a["plain_ms"],
        bf16_library_ms=a["library_ms"],
        bf16_bound_ms=a["operations"] + a["bytes"])


def phase_serve(report, ctx, dev, workdir):
    """The serving path: the checkpoint-driven renderer answers 4
    requests with the packed-key z-buffer (K1), K2 and K3. The scene,
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
    t0 = time.perf_counter()
    imgs = [r.infer(p) for p in poses]
    seconds = time.perf_counter() - t0
    counts = launches()
    for i, img in enumerate(imgs):
        if img.shape != (h, w, 3) or not np.isfinite(img).all():
            raise SmokeFailure(f"request {i}: bad frame {img.shape}")
    if counts["gated_conv_kxk_wgmma"] != 0:
        raise SmokeFailure("serve: float32 requests ran the bf16 loop")
    if not any(float(np.abs(a - b).max()) > 0
               for a, b in zip(imgs, imgs[1:])):
        raise SmokeFailure("the 4 requests rendered identical frames")
    print(f"[serve] NeuralRenderer: {len(imgs)} requests at {w}x{h}, "
          f"{N_POINTS} points, {seconds * 1e3 / len(imgs):.2f} ms/request"
          f" (first included); launches {counts}")
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
    2 of ``serve``'s requests from the same checkpoint: every K2 call the
    route sends to the wgmma loop must run it, and the first frame must
    match the same request with every kernel swapped for its twin."""
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
    want = 2 * ctx["wgmma_per_frame"]
    if counts["gated_conv_kxk_wgmma"] != want:
        raise SmokeFailure(f"serve_bf16: the wgmma loop ran "
                           f"{counts['gated_conv_kxk_wgmma']} times, the "
                           f"route predicts {want}")
    report["gated_conv_kxk_wgmma"]["launches"] = counts[
        "gated_conv_kxk_wgmma"]
    with Twins():
        twin = r.infer(poses[0])
    err = max_err("serve_bf16 request 0 vs twins", torch.from_numpy(imgs[0]),
                  torch.from_numpy(twin), (FRAME_TOL,))
    print(f"[serve_bf16] NeuralRenderer dtype=bfloat16: {len(imgs)} "
          f"requests at {w}x{h}, {seconds * 1e3 / len(imgs):.2f} "
          f"ms/request (first included); vs all-twin max |err| {err:.3g}; "
          f"launches {counts}")


def wgmma_ran(ctx, what, fn):
    """Run ``fn()``; fail unless the wgmma loop ran at least as often as
    the route predicts for one bf16 frame call."""
    from read_tpu_torch.ops import gated_conv as GC
    before = GC.launches["gated_conv_kxk_wgmma"]
    out = fn()
    ran = GC.launches["gated_conv_kxk_wgmma"] - before
    if ran < ctx["wgmma_per_frame"]:
        raise SmokeFailure(f"{what}: the wgmma loop ran {ran} times, the "
                           f"route predicts {ctx['wgmma_per_frame']}")
    return out


def phase_frames(ctx, dev):
    import torch
    from read_tpu_torch.frame import make_frame
    for ops in ("bf16", "f32"):
        for b in (1, 4):
            frame_fn, args = make_frame(b, ops, device=dev)
            out = (wgmma_ran(ctx, f"frame B={b}", lambda: frame_fn(*args))
                   if ops == "bf16" else frame_fn(*args))
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
        got = (wgmma_ran(ctx, "frame_vs_twin", lambda: frame_fn(*args))
               if ops == "bf16" else frame_fn(*args))
        with Twins():
            want = frame_fn(*args)
        torch.cuda.synchronize()
        err = max_err(f"frame B=1 {ops} kernels vs twins", got, want, tols)
        bounds = "; ".join(f"atol {t['atol']}, rtol {t['rtol']}"
                           for t in tols)
        print(f"[frame] B=1 {ops}: kernels vs all-twin frame max |err| "
              f"{err:.3g} (within {bounds})")


def phase_kernel_bench(report, dev):
    """The kernel bench in-process: K6, K7 and K8 on their path (the
    bench's first pass counts their launches), K4 at the frame's SCM
    sites; every row held against its twin."""
    from read_tpu_torch import kernel_bench as KB
    rows, counts = KB.run(dev)

    def fill(name, pick, shape):
        sel = [r for r in rows if r["kernel"] == name and pick(r["label"])]
        if not sel:
            raise SmokeFailure(f"kernel_bench: no {name} row for {shape}")
        by = {}
        for r in sel:
            by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + r["bound_ms"]
        report[name].update(
            ms=sum(r["ms"] for r in sel),
            plain_ms=sum(r["plain_ms"] for r in sel),
            library_ms=sum(r["library_ms"] for r in sel),
            bound_ms=sum(by.values()), bound_by=max(by, key=by.get),
            max_abs_err=max(r["max_abs_err"] for r in sel), shape=shape)

    for name in ("zbuffer_keys", "gated_conv3x3_r2", "gated_conv1x1_r2",
                 "gated_conv_probe"):
        if counts[name] == 0:
            raise SmokeFailure(f"kernel_bench: {name} never ran")
        report[name]["launches"] = counts[name]
    fill("gated_conv_1x1_cat",
         lambda l: l.startswith("SCM") and l.endswith("f32"),
         "the 3 SCM sites of one full-width B=1 frame, f32, summed")
    fill("zbuffer_keys", lambda l: l == "B=1",
         f"B=1 N={N_POINTS} {HW[1]}x{HW[0]}, the frame's packed keys")
    for name in ("gated_conv3x3_r2", "gated_conv1x1_r2"):
        fill(name, lambda l: l.endswith("f32"),
             "the 4 bench shapes (368x1216x32 .. 46x152x256), f32, summed")
    fill("gated_conv_probe", lambda l: l.startswith("full") and
         l.endswith("f32"), "mode full at the 4 bench shapes, f32, summed")
    # K2's bf16 rows run the wgmma loop, K8 full bf16 the old tile loop
    for h, w, c in KB.CONV_SHAPES:
        tag = f"{h}x{w} {c}->{c} bf16"
        new = [r for r in rows if r["kernel"] == "gated_conv_kxk"
               and r["label"] == tag]
        old = [r for r in rows if r["kernel"] == "gated_conv_probe"
               and r["label"] == f"full {tag}"]
        if not (new and old):
            raise SmokeFailure(f"kernel_bench: no K2/K8 bf16 rows at {tag}")
        print(f"[kernel_bench] K2 bf16 {tag}: wgmma loop {new[0]['ms']:.4f}"
              f" ms, old loop (K8 full) {old[0]['ms']:.4f}, cuDNN "
              f"{new[0]['library_ms']:.4f}, bound {new[0]['bound_ms']:.4f}")
    print(f"[kernel_bench] {len(rows)} rows, every kernel within its "
          f"tolerance of its twin; first-pass launches {counts}")


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
                     "replaces": rep, "launches": 0}
              for name, (src, rep) in KERNELS.items()}
    ctx = {}
    phases = [("build", lambda: phase_build(report)),
              ("zbuffer", lambda: phase_zbuffer(report, dev)),
              ("zbuffer_exact", lambda: phase_zbuffer_exact(report, dev)),
              ("convs", lambda: phase_convs(report, ctx, dev)),
              ("serve", lambda: phase_serve(report, ctx, dev, workdir)),
              ("serve_bf16", lambda: phase_serve_bf16(report, ctx, dev)),
              ("train_setup", lambda: ctx.update(train=train_setup(dev))),
              ("train_vs_twin", lambda: phase_train_vs_twin(ctx)),
              ("train", lambda: phase_train(report, ctx)),
              ("serve_sort", lambda: phase_serve_sort(ctx, dev, workdir)),
              ("free", lambda: (ctx.pop("train"), ctx.pop("trained"),
                                torch.cuda.empty_cache())),
              ("frame_vs_twin", lambda: phase_frame_vs_twin(ctx, dev)),
              ("frames", lambda: phase_frames(ctx, dev)),
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
