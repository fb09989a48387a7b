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
   ran on that path (launch counters);
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
   with the same frame with every kernel swapped for its twin.

TF32 is off throughout, so the twins' convolutions and matmuls are full
float32. Any failed check raises and the script exits non-zero. The
last stdout line is ``{"ok": true, "device": {...}}``; the line before
it lists each kernel's launches (counted on the run of the path it
serves: K1-K3 on the serving path, K5 on the training steps), error and
times.
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
    "gated_conv_1x1": ("read_tpu_torch/csrc/gated_conv.cu",
                       "read_tpu/ops/gated_conv_pack.py:421"),
    "zbuffer_exact": ("read_tpu_torch/csrc/zbuffer.cu",
                      "read_tpu/ops/rasterize_pallas.py:40"),
}


class SmokeFailure(RuntimeError):
    pass


def check_close(name, got, want, atol, rtol):
    import torch
    if got.shape != want.shape:
        raise SmokeFailure(f"{name}: shape {tuple(got.shape)} != "
                           f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise SmokeFailure(f"{name}: non-finite output")
    err = (got - want).abs()
    bound = atol + rtol * want.abs()
    if not bool((err <= bound).all()):
        raise SmokeFailure(f"{name}: max |err| {float(err.max()):.3g} "
                           f"exceeds atol {atol} + rtol {rtol}")
    return float(err.max())


def event_ms(fn, iters=10, warmup=2):
    """Median device time of ``fn()`` in ms (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
                      (GC, "gated_conv_1x1", GC.gated_conv_1x1)]
        for mod, name, _ in self.saved:
            setattr(mod, name, getattr(mod, name + "_plain"))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def launches():
    from read_tpu_torch.ops import gated_conv as GC
    from read_tpu_torch.ops import rasterize_kernels as RK
    return {**RK.launches, **GC.launches}


def reset_launches():
    from read_tpu_torch.ops import gated_conv as GC
    from read_tpu_torch.ops import rasterize_kernels as RK
    for counts in (RK.launches, GC.launches):
        for name in counts:
            counts[name] = 0


def phase_build(report):
    from read_tpu_torch import _build
    t0 = time.perf_counter()
    for name in ("zbuffer", "gated_conv"):
        _build.load(name)
    print(f"[build] nvcc {dict(_build.build_seconds)} s, total "
          f"{time.perf_counter() - t0:.2f} s")


def phase_zbuffer(report, dev):
    import torch
    from read_tpu_torch.frame import frame_inputs
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
            report["zbuffer"].update(ms=t_k, plain_ms=t_p)
    report["zbuffer"]["max_abs_err"] = 0.0


def phase_zbuffer_exact(report, dev):
    import torch
    from read_tpu_torch.frame import frame_inputs, train_inputs
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
    report["zbuffer_exact"].update(ms=t_k, plain_ms=t_p, max_abs_err=0.0)


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
    for name in ("zbuffer_exact", "gated_conv_kxk", "gated_conv_1x1"):
        if counts[name] == 0:
            raise SmokeFailure(f"serve_sort: {name} never ran")
    print(f"[serve_sort] trained checkpoint, default config (sort): "
          f"{len(imgs)} requests at {w}x{h}, "
          f"{seconds * 1e3 / len(imgs):.2f} ms/request (first included); "
          f"launches {counts}")


def record_conv_shapes(dev):
    """Run one full-width B=1 frame with recording shims around K2/K3:
    ``{(name, x shape, w shape, stride, relu, has_res): calls}``."""
    from read_tpu_torch.frame import make_frame
    from read_tpu_torch.ops import gated_conv as GC
    counts = {}

    def shim(name, real):
        def fn(x, w, b, scale, offset, res=None, **kw):
            key = (name, tuple(x.shape), tuple(w.shape),
                   kw.get("stride", 1), kw["relu"], res is not None)
            counts[key] = counts.get(key, 0) + 1
            return real(x, w, b, scale, offset, res, **kw)
        return fn

    frame_fn, args = make_frame(1, "f32", device=dev)
    saved = (GC.gated_conv_kxk, GC.gated_conv_1x1)
    GC.gated_conv_kxk = shim("gated_conv_kxk", saved[0])
    GC.gated_conv_1x1 = shim("gated_conv_1x1", saved[1])
    try:
        frame_fn(*args)
    finally:
        GC.gated_conv_kxk, GC.gated_conv_1x1 = saved
    return counts


def phase_convs(report, dev):
    import torch
    from read_tpu_torch.ops import gated_conv as GC
    counts = record_conv_shapes(dev)
    torch.cuda.synchronize()
    gen = torch.Generator(device=dev).manual_seed(0)
    per_frame = {n: {"f32": [0.0, 0.0], "bf16": [0.0, 0.0]}
                 for n in ("gated_conv_kxk", "gated_conv_1x1")}
    errs = {n: 0.0 for n in per_frame}
    print(f"[convs] {len(counts)} distinct gated-conv shapes in one "
          "full-width frame")
    for (name, xs, ws, stride, relu, has_res), n in sorted(counts.items()):
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
        line = []
        # bf16: the bf16 bound, then the f32 bound too, because the
        # kernel and its twin round the same operands and sum in f32
        for ops, tols in (("f32", (F32_TOL,)),
                          ("bf16", (BF16_TOL, F32_TOL))):
            kw["bf16"] = ops == "bf16"
            got = kernel(x, w, b, scale, offset, res, **kw)
            want = twin(x, w, b, scale, offset, res, **kw)
            torch.cuda.synchronize()
            for tol in tols:
                err = check_close(f"{name} {xs} {ws} s{stride} {ops}", got,
                                  want, **tol)
            errs[name] = max(errs[name], err)
            t_k = event_ms(lambda: kernel(x, w, b, scale, offset, res,
                                          **kw))
            t_p = event_ms(lambda: twin(x, w, b, scale, offset, res, **kw))
            per_frame[name][ops][0] += n * t_k
            per_frame[name][ops][1] += n * t_p
            line.append(f"{ops}: err {err:.2e} kernel {t_k:.4f} ms twin "
                        f"{t_p:.4f} ms")
        print(f"[convs] {name} x{list(xs)} w{list(ws)} s{stride} "
              f"relu={relu} res={has_res} (x{n}/frame) | "
              + " | ".join(line))
    for name, by_ops in per_frame.items():
        for ops, (t_k, t_p) in by_ops.items():
            print(f"[convs] {name} per B=1 frame ({ops} operands): kernel "
                  f"{t_k:.3f} ms, twin {t_p:.3f} ms")
        report[name].update(max_abs_err=errs[name], ms=by_ops["f32"][0],
                            plain_ms=by_ops["f32"][1])


def phase_serve(report, dev, workdir):
    """The serving path: the checkpoint-driven renderer answers 4
    requests with the packed-key z-buffer (K1), K2 and K3."""
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
    if not any(float(np.abs(a - b).max()) > 0
               for a, b in zip(imgs, imgs[1:])):
        raise SmokeFailure("the 4 requests rendered identical frames")
    print(f"[serve] NeuralRenderer: {len(imgs)} requests at {w}x{h}, "
          f"{N_POINTS} points, {seconds * 1e3 / len(imgs):.2f} ms/request"
          f" (first included); launches {counts}")
    for name in ("zbuffer", "gated_conv_kxk", "gated_conv_1x1"):
        if counts[name] == 0:
            raise SmokeFailure(f"kernel {name} never ran on the main path")
        report[name]["launches"] = counts[name]


def phase_frames(dev):
    import torch
    from read_tpu_torch.frame import make_frame
    for ops in ("bf16", "f32"):
        for b in (1, 4):
            frame_fn, args = make_frame(b, ops, device=dev)
            out = frame_fn(*args)
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


def phase_frame_vs_twin(dev):
    import torch
    from read_tpu_torch.frame import make_frame
    for ops, tols in (("f32", (FRAME_TOL,)),
                      ("bf16", (BF16_TOL, FRAME_TOL))):
        frame_fn, args = make_frame(1, ops, device=dev)
        got = frame_fn(*args)
        with Twins():
            want = frame_fn(*args)
        torch.cuda.synchronize()
        for tol in tols:
            err = check_close(f"frame B=1 {ops} kernels vs twins", got,
                              want, **tol)
        bounds = "; ".join(f"atol {t['atol']}, rtol {t['rtol']}"
                           for t in tols)
        print(f"[frame] B=1 {ops}: kernels vs all-twin frame max |err| "
              f"{err:.3g} (within {bounds})")


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
              ("convs", lambda: phase_convs(report, dev)),
              ("serve", lambda: phase_serve(report, dev, workdir)),
              ("train_setup", lambda: ctx.update(train=train_setup(dev))),
              ("train_vs_twin", lambda: phase_train_vs_twin(ctx)),
              ("train", lambda: phase_train(report, ctx)),
              ("serve_sort", lambda: phase_serve_sort(ctx, dev, workdir)),
              ("free", lambda: (ctx.clear(), torch.cuda.empty_cache())),
              ("frame_vs_twin", lambda: phase_frame_vs_twin(dev)),
              ("frames", lambda: phase_frames(dev))]
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
