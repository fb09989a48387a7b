"""read_tpu_torch's CUDA kernels against their plain PyTorch twins.

These need a CUDA device (and ``nvcc`` to build the kernels); without one
every test skips. On a GPU machine, which need not have JAX installed::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

TF32 is switched off for the twins (full float32 convolutions and
matmuls). K1, K5, the pyramid pass (every level), K6 (its given-key
kernel, and on its user path the splat projection, every level, plain,
per-point and z-scaled sizes and the edge cases of
tests/test_torch_splat.py) and K8
``packonly`` must be bit-equal; K2/K3/K4,
K7 and K8 within ``atol 2e-5, rtol 1e-4`` (f32 operands; K8's modes on
both of K2's loops, the wgmma loop's f32 as three TF32 products, up to K
= 9 * 256) and K2-K4
within ``atol 0.35, rtol 0.05`` (bf16 operands; also within the f32
bound: the same rounded operands, f32 sums), the bounds of
``tests/test_unet_pallas.py``; K7's bf16 output within ``atol 1e-3,
rtol 1e-2`` (one f32 sum rounded to bf16 once: at most one bf16 ulp
apart, which its wgmma route is also held to). K7's gated calls run the
wgmma loops (3x3 on K2's, 1x1 on the 1x1 loop; f32 as three TF32
products, bf16 in the loops' bf16-storage mode), the rest its band
kernel. K2 on its wgmma loop and K3 and K4 on the 1x1 wgmma loop are
held to the f32 bound in both operand modes (f32 operands as three TF32
products; bf16 also within the bf16 bound). One training step on the GPU
(K5, cuDNN) is held against the same step on the CPU (the twins) from
the same state: losses rtol 1e-3, running statistics atol 1e-5. The
device-guard test needs two cards and skips on one.
"""

import numpy as np
import pytest
import torch

from read_tpu_torch.criterions import vgg as V
from read_tpu_torch.frame import frame_inputs, make_frame
from read_tpu_torch.models.unet import BasicConv, UNet
from read_tpu_torch.ops import gated_conv as GC
from read_tpu_torch.ops import gated_conv_probe as GP
from read_tpu_torch.ops import gated_conv_r2 as R2
from read_tpu_torch.ops import rasterize as R
from read_tpu_torch.ops import rasterize_kernels as RK
from read_tpu_torch.pipelines import texture_pipeline as TP

pytestmark = pytest.mark.cuda

F32 = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=0.35, rtol=0.05)
BF16_OUT = dict(atol=1e-3, rtol=1e-2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cudnn, matmul = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul


@pytest.mark.parametrize("batch,n,hw", [(1, 5000, (24, 40)),
                                        (3, 200_000, (96, 160))])
def test_zbuffer_kernel_bit_equal(dev, batch, n, hw):
    xyz, ms = frame_inputs(batch, n, hw, focal=hw[1] * 0.6)
    xyz, ms = torch.from_numpy(xyz).to(dev), torch.from_numpy(ms).to(dev)
    before = RK.launches["zbuffer"]
    buf, d0 = RK.zbuffer(xyz, ms, *hw)
    assert RK.launches["zbuffer"] == before + 1
    buf_p, d0_p = RK.zbuffer_plain(xyz, ms, *hw)
    torch.cuda.synchronize()
    assert torch.equal(buf, buf_p)
    assert torch.equal(d0, d0_p)
    assert (buf != RK.INT32_MAX).float().mean() > 0.2


@pytest.mark.parametrize("batch,n,hw,dup", [(1, 5000, (24, 40), 1),
                                            (3, 200_000, (96, 160), 1),
                                            (2, 200_000, (64, 64), 8)])
def test_zbuffer_exact_kernel_bit_equal(dev, batch, n, hw, dup):
    """K5 vs its twin; ``dup=8`` repeats every position 8 times (exact
    depth ties, won by the least id)."""
    xyz, ms = frame_inputs(batch, n // dup, hw, focal=hw[1] * 0.6)
    xyz = np.tile(xyz, (dup, 1))
    xyz, ms = torch.from_numpy(xyz).to(dev), torch.from_numpy(ms).to(dev)
    before = RK.launches["zbuffer_exact"]
    index, depth = RK.zbuffer_exact(xyz, ms, *hw)
    assert RK.launches["zbuffer_exact"] == before + 1
    index_p, depth_p = RK.zbuffer_exact_plain(xyz, ms, *hw)
    torch.cuda.synchronize()
    assert torch.equal(index, index_p)
    assert torch.equal(depth, depth_p)
    assert (index >= 0).float().mean() > 0.2
    if dup > 1:
        assert int(index.max()) < n // dup


_PYRAMID_CASES = [(1, 5000, (48, 80), 1),      # ragged tiles both ways
                  (2, 200_000, (96, 160), 1),
                  (8, 100_000, (64, 64), 8)]   # exact ties


@pytest.mark.parametrize("num_scales", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("batch,n,hw,dup", _PYRAMID_CASES)
@pytest.mark.parametrize("pool_impl", ["exact", "packed"])
@pytest.mark.parametrize("method", ["sort", "pallas"])
def test_zbuffer_pyramid_kernel_bit_equal(dev, method, pool_impl, batch, n,
                                          hw, dup, num_scales):
    """K1 or K5 and the pyramid pass vs the twin, every level bit-equal;
    one call launches one projection and one pass."""
    xyz, ms = frame_inputs(batch, n // dup, hw, focal=hw[1] * 0.6)
    xyz = np.tile(xyz, (dup, 1))
    xyz, ms = torch.from_numpy(xyz).to(dev), torch.from_numpy(ms).to(dev)
    proj = "zbuffer_exact" if method == "sort" else "zbuffer"
    before = dict(RK.launches)
    got = RK.zbuffer_pyramid(xyz, ms, *hw, num_scales, method, pool_impl)
    assert RK.launches["zbuffer_pyramid"] == before["zbuffer_pyramid"] + 1
    assert RK.launches[proj] == before[proj] + 1
    want = RK.zbuffer_pyramid_plain(xyz, ms, *hw, num_scales, method,
                                    pool_impl)
    torch.cuda.synchronize()
    assert len(got) == num_scales
    for (ig, dg), (iw, dw) in zip(got, want):
        assert torch.equal(ig, iw) and torch.equal(dg, dw)
    assert (got[0][0] >= 0).float().mean() > 0.2
    if dup > 1:
        assert int(got[0][0].max()) < n // dup


@pytest.mark.parametrize("hw,num_scales", [((25, 41), 1), ((24, 42), 1),
                                           ((128, 256), 8)])
@pytest.mark.parametrize("pool_impl", ["exact", "packed"])
@pytest.mark.parametrize("method", ["sort", "pallas"])
def test_zbuffer_pyramid_odd_widths_and_deep_tiles(dev, method, pool_impl,
                                                   hw, num_scales):
    """Rows that are not 16-byte aligned (the scalar loads), and 8
    levels (128 x 128 tiles, more than 48 KB of shared memory)."""
    xyz, ms = frame_inputs(2, 20000, hw, focal=hw[1] * 0.6)
    xyz, ms = torch.from_numpy(xyz).to(dev), torch.from_numpy(ms).to(dev)
    got = RK.zbuffer_pyramid(xyz, ms, *hw, num_scales, method, pool_impl)
    want = RK.zbuffer_pyramid_plain(xyz, ms, *hw, num_scales, method,
                                    pool_impl)
    torch.cuda.synchronize()
    for (ig, dg), (iw, dw) in zip(got, want):
        assert torch.equal(ig, iw) and torch.equal(dg, dw)


@pytest.mark.parametrize("method,pool_impl", [("pallas", "packed"),
                                              ("sort", "exact")])
def test_pyramid_on_cuda_runs_no_plain_pool(dev, monkeypatch, method,
                                            pool_impl):
    """``rasterize_pyramid_pooled`` on a CUDA tensor: the projection and
    the pass (three device operations: fill, projection, pass), no
    twin, no plain pool."""
    from read_tpu_torch.kernel_bench import device_ops

    def refuse(*a, **k):
        raise AssertionError("a plain pool or twin ran on the card")

    for mod, name in ((R, "_pool2x2_zbuffer"), (RK, "pool_pyramid_plain"),
                      (RK, "zbuffer_pyramid_plain"), (RK, "unpack_packed"),
                      (RK, "zbuffer_plain"), (RK, "zbuffer_exact_plain")):
        monkeypatch.setattr(mod, name, refuse)
    xyz, ms = frame_inputs(2, 20000, (48, 64), focal=40.0)
    xyz, ms = torch.from_numpy(xyz).to(dev), torch.from_numpy(ms).to(dev)
    before = dict(RK.launches)
    R.rasterize_pyramid_pooled(xyz, ms, (48, 64), 4, method=method,
                               pool_impl=pool_impl)
    ran = {k: v - before[k] for k, v in RK.launches.items() if v != before[k]}
    proj = "zbuffer_exact" if method == "sort" else "zbuffer"
    assert ran == {proj: 1, "zbuffer_pyramid": 1}
    assert device_ops(lambda: R.rasterize_pyramid_pooled(
        xyz, ms, (48, 64), 4, method=method, pool_impl=pool_impl)) == 3


def test_pyramid_replays_in_a_cuda_graph(dev):
    """A captured ``rasterize_pyramid_pooled`` replays bit-equal to the
    twin, for new points copied into its inputs."""
    xyz, ms = frame_inputs(2, 20000, (48, 64), focal=40.0)
    xyz, ms = torch.from_numpy(xyz).to(dev), torch.from_numpy(ms).to(dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        R.rasterize_pyramid_pooled(xyz, ms, (48, 64), 4, method="pallas",
                                   pool_impl="packed")
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        levels = R.rasterize_pyramid_pooled(xyz, ms, (48, 64), 4,
                                            method="pallas",
                                            pool_impl="packed")
    xyz.copy_(xyz.flip(0) * 0.9)
    graph.replay()
    want = RK.zbuffer_pyramid_plain(xyz, ms, 48, 64, 4, "pallas", "packed")
    torch.cuda.synchronize()
    for (ig, dg), (iw, dw) in zip(levels, want):
        assert torch.equal(ig, iw) and torch.equal(dg, dw)


def test_train_step_on_cuda_matches_cpu(dev):
    """One full step at 32x32, B=2, base 8, VGG on, from the same state:
    GPU (K5, cuDNN) vs CPU (twins)."""
    rng = np.random.default_rng(0)
    xyz, ms = frame_inputs(2, 4000, (32, 32), focal=30.0)
    target = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    cfg = TP.PipelineConfig(crop_size=(32, 32))
    vgg = V.random_vgg_params(torch.Generator().manual_seed(0), device="cpu")
    state, net = TP.create_state(torch.Generator().manual_seed(1), cfg, 4000,
                                 net=UNet(base_channel=8, num_res=1),
                                 device="cpu")
    out = []
    for device in ("cpu", dev):
        st = TP.state_from_flat(TP.flat_from_state(state), device)
        step = TP.make_train_step(net.to(device), cfg,
                                  [(w.to(device), b.to(device))
                                   for w, b in vgg])
        batch = {"total_m": torch.from_numpy(ms).to(device),
                 "target": torch.from_numpy(target).to(device)}
        new, metrics = step(st, torch.from_numpy(xyz).to(device), batch)
        out.append((new, {k: float(v) for k, v in metrics.items()}))
    (cpu, m_cpu), (gpu, m_gpu) = out
    for key in ("loss", "huber_loss", "vgg_loss", "psnr"):
        assert m_gpu[key] == pytest.approx(m_cpu[key], rel=1e-3), key
    for key, t in cpu.batch_stats.items():
        torch.testing.assert_close(gpu.batch_stats[key].cpu(), t, rtol=0,
                                   atol=1e-5)


def test_rasterize_on_cuda_matches_cpu(dev):
    xyz, ms = frame_inputs(2, 20000, (48, 64), focal=40.0)
    cpu = R.rasterize_pyramid_pooled(torch.from_numpy(xyz),
                                     torch.from_numpy(ms), (48, 64), 4,
                                     method="pallas", pool_impl="packed")
    gpu = R.rasterize_pyramid_pooled(torch.from_numpy(xyz).to(dev),
                                     torch.from_numpy(ms).to(dev), (48, 64),
                                     4, method="pallas", pool_impl="packed")
    for (ic, dc), (ig, dg) in zip(cpu, gpu):
        assert torch.equal(ic, ig.cpu()) and torch.equal(dc, dg.cpu())


def _splat_scene(batch, n=20_000, hw=(64, 96), seed=3):
    """Points 0.5 to 6.5 units before a perspective camera (z-scaled sizes
    reach every ring), ``batch`` poses, sizes in [0.5, 6), every 17th
    NaN (tests/test_torch_splat.py's scene, larger)."""
    from read_tpu_torch.scene import camera
    rng = np.random.default_rng(seed)
    h, w = hw
    xyz = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    xyz[:, 2] = rng.uniform(-6.5, -0.5, n)
    K = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]])
    P = camera.gl_projection(K, (w, h), 0.1, 50.0)
    ms = []
    for i in range(batch):
        view = np.eye(4)
        view[0, 3] = 0.3 * i
        ms.append(camera.total_matrix(P, view))
    sizes = rng.uniform(0.5, 6.0, n).astype(np.float32)
    sizes[::17] = np.nan
    return xyz, np.stack(ms).astype(np.float32), sizes


def _splat_edge_scene(n=3000, seed=4):
    """Orthographic views of points at ndc x, y = +-1 exactly (centres
    one past the frame), a third on other points' positions (ties), and
    NaN, +-inf, negative, fractional and over-cap sizes."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.05, 1.05, size=(n, 3)).astype(np.float32)
    xyz[:, 2] = rng.uniform(-1.0, 1.0, n)
    xyz[0:150, 0] = 1.0
    xyz[150:300, 1] = -1.0
    xyz[300:450, 0] = -1.0
    xyz[450:600, 1] = 1.0
    xyz[2000:] = xyz[rng.integers(0, 2000, n - 2000)]
    ms = np.stack([np.eye(4, dtype=np.float32)] * 2)
    ms[1, 2, 3] = 0.1
    sizes = np.array([np.nan, np.inf, -np.inf, -2.0, 0.0, 0.5, 1.0, 2.5,
                      2.9998, 2.9999, 3.0, 3.0001, 4.9, 5.0, 9.0],
                     np.float32)[np.arange(n) % 15]
    return xyz, ms, sizes


def _splat_vs_twins(dev, xyz, ms, hw, levels, method, pool_impl, kw):
    """The splat kernel against its twin on the card and on the CPU,
    every level bit-equal; one call launches one splat projection and
    one pass. Returns level 0's index."""
    dkw = dict(kw)
    if kw.get("point_sizes") is not None:
        dkw["point_sizes"] = torch.from_numpy(kw["point_sizes"]).to(dev)
    xd, md = torch.from_numpy(xyz).to(dev), torch.from_numpy(ms).to(dev)
    before = dict(RK.launches)
    got = RK.zbuffer_splat(xd, md, *hw, levels, method, pool_impl, **dkw)
    ran = {k: v - before[k] for k, v in RK.launches.items() if v != before[k]}
    assert ran == {"zbuffer_splat": 1, "zbuffer_pyramid": 1}
    want = RK.zbuffer_splat_plain(xd, md, *hw, levels, method, pool_impl,
                                  **dkw)
    cpu = RK.zbuffer_splat_plain(torch.from_numpy(xyz), torch.from_numpy(ms),
                                 *hw, levels, method, pool_impl, **kw)
    torch.cuda.synchronize()
    for (ig, dg), (iw, dw), (ic, dc) in zip(got, want, cpu):
        assert torch.equal(ig, iw) and torch.equal(dg, dw)
        assert torch.equal(ig.cpu(), ic) and torch.equal(dg.cpu(), dc)
    return got[0][0]


@pytest.mark.parametrize("kind", ["plain", "sizes", "relative"])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("pool_impl", ["exact", "packed"])
@pytest.mark.parametrize("method", ["sort", "pallas"])
def test_zbuffer_splat_kernel_bit_equal(dev, method, pool_impl, radius,
                                        batch, kind):
    """K6 on its user path (the splat projection and the pass) against
    its twin at 4 levels: plain radius, per-point sizes, z-scaled sizes."""
    xyz, ms, sizes = _splat_scene(batch)
    kw = {"point_radius": radius}
    if kind != "plain":
        kw["point_sizes"] = sizes
    if kind == "relative":
        kw.update(relative_size=True, min_point_size=1.5)
    index = _splat_vs_twins(dev, xyz, ms, (64, 96), 4, method, pool_impl, kw)
    assert 0.05 < float((index >= 0).float().mean()) < 1.0


@pytest.mark.parametrize("relative", [False, True])
@pytest.mark.parametrize("min_point_size", [1.0, 3.0])
@pytest.mark.parametrize("method", ["sort", "pallas"])
def test_zbuffer_splat_edge_cases_bit_equal(dev, method, min_point_size,
                                            relative):
    """Off-frame centres, ties and NaN/inf/negative/fractional/over-cap
    sizes, r = 2 (and r = 16, the largest), against the twin."""
    xyz, ms, sizes = _splat_edge_scene()
    pool = "exact" if method == "sort" else "packed"
    for kw in (dict(point_radius=2, point_sizes=sizes,
                    relative_size=relative, min_point_size=min_point_size),
               dict(point_radius=RK.MAX_SPLAT_RADIUS, point_sizes=sizes,
                    relative_size=relative, min_point_size=min_point_size)):
        _splat_vs_twins(dev, xyz, ms, (48, 64), 2, method, pool, kw)


def test_splat_on_cuda_never_expands(dev, monkeypatch):
    """A splat on CUDA tensors runs the kernel and allocates no
    ``[B, N*K]`` array: the expansion and the plain z-buffers are never
    called, at most three device operations run (the fill, the splat,
    the pass; a profiler trace may come back short of one), and the peak
    memory growth stays below the expanded pixel ids and keys."""
    from read_tpu_torch.kernel_bench import device_ops
    xyz, ms, sizes = _splat_scene(2, n=200_000)
    xyz, ms = torch.from_numpy(xyz).to(dev), torch.from_numpy(ms).to(dev)
    sizes = torch.from_numpy(sizes).to(dev)
    for name in ("splat_expand", "zbuffer_splat_plain", "scatter_min",
                 "pool_pyramid_plain"):
        monkeypatch.setattr(RK, name, lambda *a, **k: pytest.fail(
            "the plain expansion ran on CUDA tensors"))

    def run():
        return R.rasterize_pyramid_pooled(
            xyz, ms, (64, 96), 4, point_radius=2, method="pallas",
            point_sizes=sizes, relative_size=True, pool_impl="packed")

    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    run()
    torch.cuda.synchronize()
    growth = torch.cuda.max_memory_allocated() - base
    assert growth < 2 * 200_000 * 25 * 8
    assert device_ops(run) <= 3


def test_sample_point_texture_backward_on_cuda(dev):
    """The splat gather's backward on CUDA (float atomics over duplicate
    rows, in no fixed order) against the CPU within 1e-6 * max|g|."""
    from read_tpu_torch.models import texture as T
    xyz, ms, _ = _splat_scene(2)
    index = RK.zbuffer_splat(torch.from_numpy(xyz).to(dev),
                             torch.from_numpy(ms).to(dev), 64, 96, 1,
                             "sort", "exact", 2)[0][0]
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(xyz.shape[0], 8, generator=gen)
    g = torch.randn(*index.shape, 8, generator=gen)
    grads = []
    for d in ("cpu", dev):
        t = table.to(d).detach().requires_grad_()
        T.sample_point_texture(t, index.to(d)).backward(g.to(d))
        grads.append(t.grad.cpu())
    scale = float(grads[0].abs().max())
    torch.testing.assert_close(grads[1], grads[0], rtol=0, atol=1e-6 * scale)


def _conv_case(dev, shape, cin, cout, k, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(*shape, cin, generator=gen, device=dev)
    w = torch.randn(k, k, cin, 2 * cout, generator=gen, device=dev) / (
        k * k * cin) ** 0.5
    b = torch.randn(2 * cout, generator=gen, device=dev) * 0.1
    scale = torch.rand(cout, generator=gen, device=dev) + 0.5
    offset = torch.randn(cout, generator=gen, device=dev) * 0.1
    return x, w, b, scale, offset


@pytest.mark.parametrize("cin,cout,k,stride", [
    (8, 16, 3, 1), (32, 3, 3, 1), (32, 32, 3, 1), (64, 64, 3, 2),
    (128, 128, 3, 1), (256, 128, 4, 2), (40, 24, 4, 2),
    (12, 8, 3, 1), (64, 100, 3, 1)])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("with_res", [False, True])
def test_gated_conv_kxk_kernel_matches_twin(dev, cin, cout, k, stride,
                                            bf16, with_res):
    x, w, b, scale, offset = _conv_case(dev, (2, 22, 34), cin, cout, k,
                                        cin + cout + k)
    ho, wo = (22 - 1) // stride + 1, (34 - 1) // stride + 1
    if k == 4:
        ho, wo = 22 // 2, 34 // 2
    res = (torch.randn(2, ho, wo, cout, device=dev) if with_res else None)
    for relu in (True, False):
        got = GC.gated_conv_kxk(x, w, b, scale, offset, res, stride=stride,
                                relu=relu, bf16=bf16)
        want = GC.gated_conv_kxk_plain(x, w, b, scale, offset, res,
                                       stride=stride, relu=relu, bf16=bf16)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **(BF16 if bf16 else F32))
        if bf16:  # same arithmetic up to summation order
            torch.testing.assert_close(got, want, **F32)


@pytest.mark.parametrize("cin,cout,k,stride", [
    (32, 32, 3, 1), (64, 64, 3, 1), (128, 128, 3, 1), (256, 256, 3, 1),
    (32, 64, 3, 2), (64, 128, 4, 2), (256, 128, 4, 2), (96, 64, 3, 1)])
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_gated_conv_kxk_wgmma_matches_twin(dev, cin, cout, k, stride,
                                           with_res, bf16):
    """K2's wgmma loop on a ragged 23x70 image, B=2, relu on and off,
    within the f32 bound of the twin in both operand modes: bf16 (the
    same bf16 operands and f32 sums as the twin) and f32 (three TF32
    products, K up to 9 x 256 = 2304); the route counter shows the loop
    ran."""
    x, w, b, scale, offset = _conv_case(dev, (2, 23, 70), cin, cout, k,
                                        cin + 3 * cout + k)
    pad = (k - 1) // 2
    ho, wo = ((n + 2 * pad - k) // stride + 1 for n in (23, 70))
    res = (torch.randn(2, ho, wo, cout, device=dev) if with_res else None)
    assert GC.kxk_route(x, w, (b, scale, offset, res)) == "wgmma"
    packed = GC.pack_kxk_bf16(w) if bf16 else GC.pack_kxk_tf32(w)
    for relu in (True, False):
        before = dict(GC.launches)
        got = GC.gated_conv_kxk(x, w, b, scale, offset, res, stride=stride,
                                relu=relu, bf16=bf16, packed=packed)
        assert GC.launches["gated_conv_kxk_wgmma"] == \
            before["gated_conv_kxk_wgmma"] + 1
        assert GC.launches["gated_conv_kxk"] == before["gated_conv_kxk"] + 1
        want = GC.gated_conv_kxk_plain(x, w, b, scale, offset, res,
                                       stride=stride, relu=relu, bf16=bf16)
        torch.cuda.synchronize()
        assert got.shape == (2, ho, wo, cout)
        torch.testing.assert_close(got, want, **F32)


@pytest.mark.parametrize("bf16", [False, True])
def test_gated_conv_kxk_wgmma_refused_launch_raises(dev, bf16):
    """A packed weight the kernel refuses (256-column N tiles; a tile
    count that does not cover Cout) surfaces as the wrapper's error; a
    pack of the other operand mode raises in the wrapper."""
    x, w, b, scale, offset = _conv_case(dev, (1, 8, 8), 32, 128, 3, 1)
    out = torch.empty(1, 8, 8, 128, device=dev)
    good = GC.pack_kxk_bf16(w) if bf16 else GC.pack_kxk_tf32(w)
    other = GC.pack_kxk_tf32(w) if bf16 else GC.pack_kxk_bf16(w)
    lead = (2, 5) if bf16 else (2, 9, 2)
    assert tuple(good.shape) == lead + (128, 64 if bf16 else 32)
    wide = good.reshape(1, *lead[1:], 256, good.shape[-1])
    for packed in (wide, good[:1].contiguous()):
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            GC._launch_wgmma(x, packed, b, scale, offset, None, out, 3, 1,
                             True, bf16)
    for packed in (good[:1].contiguous(), other):
        with pytest.raises(ValueError, match="packed weight"):
            GC.gated_conv_kxk(x, w, b, scale, offset, bf16=bf16,
                              packed=packed)


def test_basic_conv_passes_its_cached_kxk_packs(dev):
    """``BasicConv.forward`` hands K2's loop the module's cached pack
    (through the cache's getter) for each operand type."""
    seen = []
    real = GC._launch_wgmma

    def spy(x, packed, *args):
        seen.append(packed)
        return real(x, packed, *args)

    conv = BasicConv(32, 64, 3).to(dev)
    with torch.no_grad():
        conv.conv_fm.kernel.normal_()
    x = torch.randn(1, 6, 11, 32, device=dev)
    GC._launch_wgmma = spy
    try:
        conv(x, False)
        conv(x, True)
    finally:
        GC._launch_wgmma = real
    assert seen[0] is conv.packed_kxk_tf32()
    assert seen[1] is conv.packed_kxk_bf16()


@pytest.mark.parametrize("cins,cout", [
    ((16,), 32), ((32,), 56), ((64,), 120), ((128,), 248), ((8, 56), 64),
    ((8, 248), 256), ((32, 64, 128, 256), 24), ((8, 8, 16), 40)])
@pytest.mark.parametrize("bf16", [False, True])
def test_gated_conv_1x1_wgmma_matches_twin(dev, cins, cout, bf16):
    """The 1x1 wgmma loop (K3 for one input, K4 for more) on 2x13x29
    pixels (a ragged last 64-pixel tile), relu on and off, with and
    without a residual: within the f32 bound of the twin in both modes
    (f32 operands as three TF32 products), bf16 also within the bf16
    bound; the route counters show the loop ran."""
    gen = torch.Generator(device=dev).manual_seed(sum(cins) + cout)
    xs = [torch.randn(2, 13, 29, c, generator=gen, device=dev)
          for c in cins]
    k = sum(cins)
    w = torch.randn(1, 1, k, 2 * cout, generator=gen, device=dev) / k ** 0.5
    b = torch.randn(2 * cout, generator=gen, device=dev) * 0.1
    scale = torch.rand(cout, generator=gen, device=dev) + 0.5
    offset = torch.randn(cout, generator=gen, device=dev) * 0.1
    assert GC.conv1x1_route(xs, cout) == "wgmma"
    packed = GC.pack_1x1_bf16(w) if bf16 else GC.pack_1x1_tf32(w)
    name = "gated_conv_1x1" if len(cins) == 1 else "gated_conv_1x1_cat"
    for relu, res in ((True, None),
                      (False, torch.randn(2, 13, 29, cout, device=dev))):
        before = dict(GC.launches)
        if len(cins) == 1:
            got = GC.gated_conv_1x1(xs[0], w, b, scale, offset, res,
                                    relu=relu, bf16=bf16, packed=packed)
            want = GC.gated_conv_1x1_plain(xs[0], w, b, scale, offset, res,
                                           relu=relu, bf16=bf16)
        else:
            got = GC.gated_conv_1x1_cat(xs, w, b, scale, offset, res,
                                        relu=relu, bf16=bf16, packed=packed)
            want = GC.gated_conv_1x1_cat_plain(xs, w, b, scale, offset, res,
                                               relu=relu, bf16=bf16)
        assert GC.launches[name] == before[name] + 1
        assert GC.launches["gated_conv_1x1_wgmma"] == \
            before["gated_conv_1x1_wgmma"] + 1
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **F32)
        if bf16:
            torch.testing.assert_close(got, want, **BF16)


def test_gated_conv_1x1_wgmma_refused_launch_raises(dev):
    """A packed weight that does not fit raises in the wrapper; inputs
    the C entry refuses (C % 8 != 0) surface as the wrapper's error."""
    x, w, b, scale, offset = _conv_case(dev, (1, 8, 8), 32, 64, 1, 3)
    out = torch.empty(1, 8, 8, 64, device=dev)
    with pytest.raises(ValueError, match="packed weight"):
        GC.gated_conv_1x1(x, w, b, scale, offset,
                          packed=GC.pack_1x1_bf16(w))
    x12 = torch.randn(1, 8, 8, 12, device=dev)
    w12 = torch.randn(12, 128, device=dev)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        GC._launch_1x1_wgmma("gated_conv_1x1", [x12], w12, None, b, scale,
                             offset, None, out, True, False)


@pytest.mark.parametrize("bf16", [False, True])
def test_misaligned_epilogue_views_keep_the_tile_loop(dev, bf16):
    """A residual view (or a bias view) at a 4-byte offset sends K2, K3
    and K4 to the tile loop, which matches the twin; the 1x1 and K2 wgmma
    C entries refuse such pointers with an error the wrapper raises, and
    the context stays usable (no misaligned-address fault)."""
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(1, 7, 19, 64, generator=gen, device=dev)
    w = torch.randn(1, 1, 64, 64, generator=gen, device=dev) / 8.0
    w3 = torch.randn(3, 3, 64, 64, generator=gen, device=dev) / 24.0
    vec = torch.randn(65, generator=gen, device=dev)
    b, scale, offset = vec[:64], vec[:32].abs() + 0.5, vec[32:64]
    flat = torch.randn(7 * 19 * 32 + 1, generator=gen, device=dev)
    res = flat[1:].view(1, 7, 19, 32)
    assert res.is_contiguous() and res.data_ptr() % 8 == 4
    xs = [x[..., :8].contiguous(), x[..., 8:].contiguous()]
    for bias, r in ((b, res), (vec[1:65], None)):
        before = dict(GC.launches)
        got = GC.gated_conv_1x1(x, w, bias, scale, offset, r, bf16=bf16)
        got4 = GC.gated_conv_1x1_cat(xs, w, bias, scale, offset, r,
                                     bf16=bf16)
        got2 = GC.gated_conv_kxk(x, w3, bias, scale, offset, r, bf16=bf16)
        assert GC.launches["gated_conv_kxk"] == before["gated_conv_kxk"] + 1
        for loop in ("gated_conv_1x1_wgmma", "gated_conv_kxk_wgmma"):
            assert GC.launches[loop] == before[loop]
        want = GC.gated_conv_1x1_plain(x, w, bias, scale, offset, r,
                                       bf16=bf16)
        want2 = GC.gated_conv_kxk_plain(x, w3, bias, scale, offset, r,
                                        bf16=bf16)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **F32)
        torch.testing.assert_close(got4, want, **F32)
        torch.testing.assert_close(got2, want2, **F32)
    out = torch.empty(1, 7, 19, 32, device=dev)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        GC._launch_1x1_wgmma("gated_conv_1x1", [x], w, None, b, scale,
                             offset, res, out, True, bf16)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        GC._launch_wgmma(x, GC.pack_kxk_bf16(w3) if bf16 else
                         GC.pack_kxk_tf32(w3), b, scale, offset, res, out,
                         3, 1, True, bf16)
    before = dict(GC.launches)
    got = GC.gated_conv_1x1(x, w, b, scale, offset, res.clone(), bf16=bf16)
    got2 = GC.gated_conv_kxk(x, w3, b, scale, offset, res.clone(),
                             bf16=bf16)
    for loop in ("gated_conv_1x1_wgmma", "gated_conv_kxk_wgmma"):
        assert GC.launches[loop] == before[loop] + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(got, GC.gated_conv_1x1_plain(
        x, w, b, scale, offset, res, bf16=bf16), **F32)
    torch.testing.assert_close(got2, GC.gated_conv_kxk_plain(
        x, w3, b, scale, offset, res, bf16=bf16), **F32)


def test_basic_conv_passes_its_cached_1x1_packs(dev):
    """``BasicConv.forward`` (K3) and ``comb`` (K4) hand the loop the
    module's cached pack (through the cache's getter), for each operand
    type."""
    seen = []
    real = GC._launch_1x1_wgmma

    def spy(name, xs, w2, packed, *args):
        seen.append(packed() if callable(packed) else packed)
        return real(name, xs, w2, packed, *args)

    conv = BasicConv(64, 64, 1).to(dev)
    with torch.no_grad():
        conv.conv_fm.kernel.normal_()
    x = torch.randn(1, 5, 7, 64, device=dev)
    GC._launch_1x1_wgmma = spy
    try:
        for bf16 in (False, True):
            conv(x, bf16)
            conv.comb([(x[..., :8].contiguous(), "id", 1),
                       (x[..., 8:].contiguous(), "id", 1)], bf16)
            assert seen[-2] is seen[-1] is conv.packed_1x1(bf16)
    finally:
        GC._launch_1x1_wgmma = real


@pytest.mark.parametrize("cin,cout", [(16, 32), (32, 56), (128, 248)])
@pytest.mark.parametrize("bf16", [False, True])
def test_gated_conv_1x1_kernel_matches_twin(dev, cin, cout, bf16):
    x, w, b, scale, offset = _conv_case(dev, (2, 13, 29), cin, cout, 1, 7)
    res = torch.randn(2, 13, 29, cout, device=dev)
    before = GC.launches["gated_conv_1x1"]
    got = GC.gated_conv_1x1(x, w, b, scale, offset, res, bf16=bf16)
    assert GC.launches["gated_conv_1x1"] == before + 1
    want = GC.gated_conv_1x1_plain(x, w, b, scale, offset, res, bf16=bf16)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **F32)


@pytest.mark.parametrize("cin,cout", [(12, 32), (32, 20)])
@pytest.mark.parametrize("bf16", [False, True])
def test_gated_conv_1x1_tile_loop_matches_twin(dev, cin, cout, bf16):
    """Widths the 1x1 wgmma loop does not take (C % 8 != 0, Cout % 8 !=
    0) keep the tile loop."""
    x, w, b, scale, offset = _conv_case(dev, (2, 13, 29), cin, cout, 1, 7)
    res = torch.randn(2, 13, 29, cout, device=dev)
    before = dict(GC.launches)
    got = GC.gated_conv_1x1(x, w, b, scale, offset, res, bf16=bf16)
    assert GC.launches["gated_conv_1x1"] == before["gated_conv_1x1"] + 1
    assert GC.launches["gated_conv_1x1_wgmma"] == \
        before["gated_conv_1x1_wgmma"]
    want = GC.gated_conv_1x1_plain(x, w, b, scale, offset, res, bf16=bf16)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **F32)


def test_wrappers_refuse_non_contiguous_cuda_input(dev):
    x, w, b, scale, offset = _conv_case(dev, (1, 8, 8), 32, 16, 3, 0)
    with pytest.raises(ValueError):
        GC.gated_conv_kxk(x.transpose(1, 2), w, b, scale, offset)
    with pytest.raises(ValueError):
        RK.zbuffer(torch.zeros(3, 10, device=dev).t(),
                   torch.zeros(1, 4, 4, device=dev), 8, 8)


@pytest.mark.parametrize("operands", ["f32", "bf16"])
def test_small_frame_kernels_match_twins(dev, operands):
    frame_fn, args = make_frame(batch=2, operands=operands, device=dev,
                                n_points=20000, hw=(48, 64), focal=40.0,
                                base_channel=8, num_res=1)
    before = GC.launches["gated_conv_1x1_cat"]
    got = frame_fn(*args)
    assert GC.launches["gated_conv_1x1_cat"] == before + 3  # the SCMs
    saved = (RK.zbuffer_pyramid, GC.gated_conv_kxk, GC.gated_conv_1x1,
             GC.gated_conv_1x1_cat)
    RK.zbuffer_pyramid = RK.zbuffer_pyramid_plain
    GC.gated_conv_kxk = GC.gated_conv_kxk_plain
    GC.gated_conv_1x1 = GC.gated_conv_1x1_plain
    GC.gated_conv_1x1_cat = GC.gated_conv_1x1_cat_plain
    try:
        want = frame_fn(*args)
    finally:
        (RK.zbuffer_pyramid, GC.gated_conv_kxk, GC.gated_conv_1x1,
         GC.gated_conv_1x1_cat) = saved
    torch.cuda.synchronize()
    assert np.isfinite(got.cpu().numpy()).all()
    torch.testing.assert_close(got, want, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("cins,gated", [((8, 56), True), ((16, 8, 4), True),
                                        ((32, 64, 128, 256), True),
                                        ((16, 8, 4), False), ((5, 3), True)])
@pytest.mark.parametrize("bf16", [False, True])
def test_gated_conv_1x1_cat_kernel_matches_twin(dev, cins, gated, bf16):
    gen = torch.Generator(device=dev).manual_seed(sum(cins))
    xs = [torch.randn(2, 13, 29, c, generator=gen, device=dev)
          for c in cins]
    cout = 24
    c2 = 2 * cout if gated else cout
    w = torch.randn(1, 1, sum(cins), c2, generator=gen, device=dev) \
        / sum(cins) ** 0.5
    b = torch.randn(c2, generator=gen, device=dev) * 0.1
    scale = torch.rand(cout, generator=gen, device=dev) + 0.5
    offset = torch.randn(cout, generator=gen, device=dev) * 0.1
    res = torch.randn(2, 13, 29, cout, generator=gen, device=dev)
    for relu in (True, False):
        before = GC.launches["gated_conv_1x1_cat"]
        got = GC.gated_conv_1x1_cat(xs, w, b, scale, offset, res, relu=relu,
                                    gated=gated, bf16=bf16)
        assert GC.launches["gated_conv_1x1_cat"] == before + 1
        want = GC.gated_conv_1x1_cat_plain(xs, w, b, scale, offset, res,
                                           relu=relu, gated=gated, bf16=bf16)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **F32)


@pytest.mark.parametrize("batched", [False, True])
def test_zbuffer_keys_kernel_bit_equal(dev, batched):
    """K6 on packed keys with heavy ties (every position 4 times) and
    dropped points (pix >= n_pixels)."""
    hw = (96, 160)
    xyz, ms = frame_inputs(2 if batched else 1, 50_000, hw, focal=96.0)
    xyz = torch.from_numpy(np.tile(xyz, (4, 1))).to(dev)
    ms = torch.from_numpy(ms).to(dev)
    n, npx = xyz.shape[0], hw[0] * hw[1]
    pix, depth, _, _ = RK._projected(xyz, ms, *hw)
    ids = torch.arange(n, dtype=torch.int32, device=dev).expand_as(pix)
    key = RK.pack_keys(pix, depth, ids, npx, n)[0].contiguous()
    pix = pix.to(torch.int32).contiguous()
    assert int((pix >= npx).sum()) > 0
    if not batched:
        pix, key = pix[0].contiguous(), key[0].contiguous()
    before = RK.launches["zbuffer_keys"]
    got = RK.zbuffer_keys(pix, key, npx)
    assert RK.launches["zbuffer_keys"] == before + 1
    want = RK.zbuffer_keys_plain(pix, key, npx)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert (got != RK.INT32_MAX).float().mean() > 0.2


@pytest.mark.parametrize("k", [3, 1])
@pytest.mark.parametrize("cin,cout,h,w", [(32, 32, 20, 70), (8, 12, 9, 33),
                                          (64, 40, 16, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gated_conv_r2_kernel_matches_twin(dev, k, cin, cout, h, w, dtype):
    """K7, gated and not, relu on and off, H and W not tile multiples."""
    kern, twin = ((R2.gated_conv3x3_r2, R2.gated_conv3x3_r2_plain) if k == 3
                  else (R2.gated_conv1x1_r2, R2.gated_conv1x1_r2_plain))
    for gated in (True, False):
        c2 = 2 * cout if gated else cout
        x = torch.randn(h, w, cin, device=dev).to(dtype)
        wk = torch.randn(k, k, cin, c2, device=dev).to(dtype) / (
            k * k * cin) ** 0.5
        b = torch.randn(c2, device=dev) * 0.1
        scale = torch.rand(cout, device=dev) + 0.5
        offset = torch.randn(cout, device=dev) * 0.1
        for relu in (True, False):
            got = kern(x, wk, b, scale, offset, relu=relu, gated=gated)
            want = twin(x, wk, b, scale, offset, relu=relu, gated=gated)
            torch.cuda.synchronize()
            assert got.dtype == dtype
            torch.testing.assert_close(
                got.float(), want.float(),
                **(BF16_OUT if dtype == torch.bfloat16 else F32))


def _r2_case(dev, h, w, cin, cout, k, gated, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    c2 = 2 * cout if gated else cout
    x = torch.randn(h, w, cin, generator=gen, device=dev).to(dtype)
    wk = (torch.randn(k, k, cin, c2, generator=gen, device=dev)
          / (k * k * cin) ** 0.5).to(dtype)
    b = torch.randn(c2, generator=gen, device=dev) * 0.1
    scale = torch.rand(cout, generator=gen, device=dev) + 0.5
    offset = torch.randn(cout, generator=gen, device=dev) * 0.1
    return x, wk, b, scale, offset


def _r2_fns(k):
    return ((R2.gated_conv3x3_r2, R2.gated_conv3x3_r2_plain) if k == 3
            else (R2.gated_conv1x1_r2, R2.gated_conv1x1_r2_plain))


def _assert_r2_close(got, want):
    """f32: the f32 bound; bf16: each value at most one bf16 ulp (2**(e -
    7) for a value in [2**e, 2**(e+1))) from the twin's, 1e-5 beside it
    for values near 0, and within ``BF16_OUT``."""
    g, w = got.float(), want.float()
    if got.dtype == torch.float32:
        torch.testing.assert_close(g, w, **F32)
        return
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -100)))
                     - 7)
    assert bool(((g - w).abs() <= ulp + 1e-5).all())
    torch.testing.assert_close(g, w, **BF16_OUT)


@pytest.mark.parametrize("h,w,c", [(37, 121, 32), (23, 61, 64),
                                   (12, 30, 128), (6, 15, 256)])
@pytest.mark.parametrize("k", [3, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gated_conv_r2_wgmma_matches_twin(dev, h, w, c, k, dtype):
    """K7 on its wgmma loop (3x3 on K2's, 1x1 on the 1x1 loop) at the
    bench's four levels cut about 10x in H and W (odd sizes, K up to 9 x
    256 = 2304), relu on and off, with a packed weight, a getter and
    none: f32 (three TF32 products) within the f32 bound, bf16 in and out
    within one bf16 ulp of the twin; the route counters show the loop
    ran, no band kernel, and nothing counted under K2/K3's names."""
    kern, twin = _r2_fns(k)
    name = kern.__name__
    x, wk, b, scale, offset = _r2_case(dev, h, w, c, c, k, True, dtype,
                                       h + c + k)
    assert R2.r2_route(x, wk, True, (b, scale, offset)) == "wgmma"
    pk = R2.pack_r2(wk)
    for relu, packed in ((True, pk), (False, lambda: pk), (True, None)):
        before, gc_before = dict(R2.launches), dict(GC.launches)
        got = kern(x, wk, b, scale, offset, relu=relu, packed=packed)
        assert R2.launches[name] == before[name] + 1
        assert R2.launches[name + "_wgmma"] == before[name + "_wgmma"] + 1
        assert R2.launches[name + "_band"] == before[name + "_band"]
        assert GC.launches == gc_before
        want = twin(x, wk, b, scale, offset, relu=relu)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (h, w, c)
        _assert_r2_close(got, want)


@pytest.mark.parametrize("k", [3, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gated_conv_r2_band_route_matches_twin(dev, k, dtype):
    """``gated=False``, widths the loops do not take (3x3 Cin = 8, 1x1
    Cin = 12, Cout = 12) and misaligned x or bias views run the band
    kernel, which matches the twin."""
    kern, twin = _r2_fns(k)
    name = kern.__name__
    cases = [(32, 32, False, None), (8 if k == 3 else 12, 32, True, None),
             (32, 12, True, None), (32, 32, True, "x"),
             (32, 32, True, "bias")]
    for i, (cin, cout, gated, view) in enumerate(cases):
        x, wk, b, scale, offset = _r2_case(dev, 19, 45, cin, cout, k, gated,
                                           dtype, 50 + i)
        if view == "x":      # 2 or 4 bytes past a 16-byte boundary
            flat = torch.zeros(x.numel() + 1, dtype=dtype, device=dev)
            x = flat[1:].view(x.shape).copy_(x)
        elif view == "bias":   # 4 bytes past an 8-byte boundary
            b = torch.zeros(b.numel() + 1, device=dev)[1:].copy_(b)
        assert R2.r2_route(x, wk, gated, (b, scale, offset)) == "band"
        before = dict(R2.launches)
        got = kern(x, wk, b, scale, offset, gated=gated,
                   packed=lambda: pytest.fail("packed on the band route"))
        assert R2.launches[name + "_band"] == before[name + "_band"] + 1
        assert R2.launches[name + "_wgmma"] == before[name + "_wgmma"]
        want = twin(x, wk, b, scale, offset, gated=gated)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        torch.testing.assert_close(
            got.float(), want.float(),
            **(BF16_OUT if dtype == torch.bfloat16 else F32))


def test_gated_conv_r2_wgmma_refused_launch_raises(dev):
    """On K7's wgmma route a pack of the other dtype's mode raises in the
    wrapper (the band kernel does not run instead); launches the C
    entries refuse (a residual in bf16 storage, an unknown mode) surface
    as the wrapper's error."""
    x, wk, b, scale, offset = _r2_case(dev, 8, 8, 32, 32, 3, True,
                                       torch.bfloat16, 7)
    w1 = wk[1:2, 1:2].contiguous()
    before = dict(R2.launches)
    for kern, w, other in ((R2.gated_conv3x3_r2, wk, GC.pack_kxk_tf32),
                           (R2.gated_conv1x1_r2, w1, GC.pack_1x1_tf32)):
        with pytest.raises(ValueError, match="packed weight"):
            kern(x, w, b, scale, offset, packed=other(w.float()))
    assert R2.launches == before
    out = torch.empty(1, 8, 8, 32, dtype=torch.bfloat16, device=dev)
    res = torch.zeros(1, 8, 8, 32, device=dev)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        GC._launch_wgmma(x[None], R2.pack_r2(wk), b, scale, offset, res,
                         out, 3, 1, True, GC.OPS_BF16_STORAGE)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        GC._call_1x1_wgmma("gated_conv1x1_r2", [x], R2.pack_r2(w1), b,
                           scale, offset, None, out[0], True, 3)


@pytest.mark.parametrize("cin,cout,h,w", [(32, 32, 20, 70), (8, 12, 9, 33),
                                          (64, 16, 11, 13)])
@pytest.mark.parametrize("bf16", [False, True])
def test_gated_conv_probe_kernel_matches_twin(dev, cin, cout, h, w, bf16):
    """K8: full and nowin within the f32 bound, packonly bit-equal,
    nopack runs (no defined output)."""
    gen = torch.Generator(device=dev).manual_seed(cin + cout)
    x = torch.randn(2, h, w, cin, generator=gen, device=dev)
    wk = torch.randn(3, 3, cin, 2 * cout, generator=gen, device=dev) / (
        9 * cin) ** 0.5
    for mode in ("full", "nowin", "packonly"):
        got = GP.gated_conv_probe(x, wk, mode=mode, bf16=bf16)
        want = GP.gated_conv_probe_plain(x, wk, mode=mode, bf16=bf16)
        torch.cuda.synchronize()
        if mode == "packonly":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, **F32)
    before = GP.launches["gated_conv_probe"]
    out = GP.gated_conv_probe(x, wk, mode="nopack", bf16=bf16)
    torch.cuda.synchronize()
    assert out.shape == (2, h, w, 2 * cout)
    assert GP.launches["gated_conv_probe"] == before + 1


def _probe_case(dev, b, h, w, cin, cout):
    gen = torch.Generator(device=dev).manual_seed(b + h + cin + cout)
    x = torch.randn(b, h, w, cin, generator=gen, device=dev)
    wk = torch.randn(3, 3, cin, 2 * cout, generator=gen, device=dev) / (
        9 * cin) ** 0.5
    return x, wk


@pytest.mark.parametrize("loop,cin,cout,b,h,w", [
    ("wgmma", 32, 32, 2, 20, 70),    # one 64-column N tile
    ("wgmma", 64, 256, 1, 9, 13),    # four N tiles, 117 pixels
    ("wgmma", 32, 152, 1, 7, 9),     # 2*Cout > 9*Cin: packonly's zeros
    ("tile", 32, 32, 2, 20, 70),
    ("tile", 8, 12, 2, 9, 33)])
@pytest.mark.parametrize("bf16", [False, True])
def test_gated_conv_probe_modes_on_both_loops(dev, loop, cin, cout, b, h,
                                              w, bf16):
    """K8's four modes on each loop against the twin of that loop: full
    and nowin within the f32 bound (bf16 operands: the twin rounds the
    same operands), packonly bit-equal (on the wgmma loop: the staged
    TF32 parts' sum in f32, bf16 widened; the output is allocated
    uninitialised, so NaN left in the allocator's block shows any column
    no kernel wrote), nopack runs. Each call counts one launch on its
    loop."""
    x, wk = _probe_case(dev, b, h, w, cin, cout)
    packed = GC.pack_kxk_bf16(wk) if bf16 else GC.pack_kxk_tf32(wk)
    for mode in GP.MODES:
        torch.full((b, h, w, 2 * cout), float("nan"), device=dev)
        before = dict(GP.launches)
        got = GP.gated_conv_probe(x, wk, mode=mode, bf16=bf16, loop=loop,
                                  packed=packed if loop == "wgmma" else None)
        torch.cuda.synchronize()
        assert GP.launches["gated_conv_probe"] == before[
            "gated_conv_probe"] + 1
        assert GP.launches[f"gated_conv_probe_{loop}"] == before[
            f"gated_conv_probe_{loop}"] + 1
        assert got.shape == (b, h, w, 2 * cout)
        if mode == "nopack":
            continue
        want = GP.gated_conv_probe_plain(x, wk, mode=mode, bf16=bf16,
                                         loop=loop)
        torch.cuda.synchronize()
        if mode == "packonly":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, **F32)


def test_gated_conv_probe_full_tf32x3_at_k_2304(dev):
    """``full`` on the wgmma loop with f32 operands (three TF32 products,
    a fresh wgmma sum per 32-channel slice) holds the f32 bound at K =
    9 * 256, H and W cut small; the loop is K2's own, packed weight made
    by the wrapper."""
    x, wk = _probe_case(dev, 1, 12, 17, 256, 64)
    assert GP.probe_route(x, wk) == "wgmma"
    got = GP.gated_conv_probe(x, wk, mode="full")
    want = GP.gated_conv_probe_plain(x, wk, mode="full")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **F32)


def test_gated_conv_probe_wgmma_refuses_misaligned_pointers(dev):
    """The C entry's wgmma route, as ``gated_conv_kxk_wgmma``: x, the
    packed weight and out 16-byte aligned, else cudaErrorInvalidValue
    (raised by the wrapper's launch helper), with no launch."""
    from read_tpu_torch import _build
    x, wk = _probe_case(dev, 1, 4, 8, 32, 8)
    packed = GC.pack_kxk_tf32(wk)
    fn = _build.function("gated_conv_probe", "gated_conv_probe",
                         GP._ARGTYPES)
    xs = torch.empty(x.numel() + 1, device=dev)[1:]
    xs.copy_(x.reshape(-1))
    out = torch.empty(4 * 8 * 16 + 1, device=dev)
    good = (x.data_ptr(), packed.data_ptr(), out.data_ptr())
    for bad in ((xs.data_ptr(),) + good[1:],
                good[:2] + (out[1:].data_ptr(),)):
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            _build.call(fn, x.device, "gated_conv_probe (wgmma)", *bad, 1,
                        4, 8, 32, 8, 0, 0, 1)
    _build.call(fn, x.device, "gated_conv_probe (wgmma)", *good, 1, 4, 8,
                32, 8, 0, 0, 1)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out[:4 * 8 * 16].reshape(1, 4, 8, 16),
        GP.gated_conv_probe_plain(x, wk, mode="full"), **F32)


def test_wrappers_launch_on_their_tensors_device(dev):
    """Tensors on ``cuda:1`` while ``cuda:0`` is current: each wrapper
    launches on ``cuda:1`` (device guard; the C entries ask that device
    for its limits) and matches its twin. Needs two devices."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    d1 = torch.device("cuda:1")
    torch.cuda.set_device(0)
    xyz, ms = frame_inputs(1, 5000, (24, 40), focal=24.0)
    xyz, ms = torch.from_numpy(xyz).to(d1), torch.from_numpy(ms).to(d1)
    assert torch.equal(RK.zbuffer(xyz, ms, 24, 40)[0],
                       RK.zbuffer_plain(xyz, ms, 24, 40)[0])
    for k, cin, bf16 in ((3, 32, True), (3, 8, False), (1, 64, False),
                         (1, 64, True)):
        x, w, b, scale, offset = _conv_case(d1, (1, 9, 70), cin, 64, k, 5)
        if k == 3:
            got = GC.gated_conv_kxk(x, w, b, scale, offset, bf16=bf16)
            want = GC.gated_conv_kxk_plain(x, w, b, scale, offset,
                                           bf16=bf16)
        else:
            got = GC.gated_conv_1x1(x, w, b, scale, offset, bf16=bf16)
            want = GC.gated_conv_1x1_plain(x, w, b, scale, offset,
                                           bf16=bf16)
        torch.cuda.synchronize(d1)
        assert got.device == d1 and torch.cuda.current_device() == 0
        torch.testing.assert_close(got, want, **F32)
