"""read_tpu_torch's CUDA kernels against their plain PyTorch twins.

These need a CUDA device (and ``nvcc`` to build the kernels); without one
every test skips. On a GPU machine, which need not have JAX installed::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

TF32 is switched off for the twins (full float32 convolutions and
matmuls). K1 and K5 must be bit-equal; K2/K3 within ``atol 2e-5, rtol
1e-4`` (f32 operands) and ``atol 0.35, rtol 0.05`` (bf16 operands), the
bounds of ``tests/test_unet_pallas.py``. One training step on the GPU
(K5, cuDNN) is held against the same step on the CPU (the twins) from
the same state: losses rtol 1e-3, running statistics atol 1e-5.
"""

import numpy as np
import pytest
import torch

from read_tpu_torch.criterions import vgg as V
from read_tpu_torch.frame import frame_inputs, make_frame
from read_tpu_torch.models.unet import UNet
from read_tpu_torch.ops import gated_conv as GC
from read_tpu_torch.ops import rasterize as R
from read_tpu_torch.ops import rasterize_kernels as RK
from read_tpu_torch.pipelines import texture_pipeline as TP

pytestmark = pytest.mark.cuda

F32 = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=0.35, rtol=0.05)


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


def test_train_step_on_cuda_matches_cpu(dev):
    """One full step at 32x32, B=2, base 8, VGG on, from the same state:
    GPU (K5, cuDNN) vs CPU (twins)."""
    rng = np.random.default_rng(0)
    xyz, ms = frame_inputs(2, 4000, (32, 32), focal=30.0)
    target = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    cfg = TP.PipelineConfig(crop_size=(32, 32))
    vgg = V.random_vgg_params(torch.Generator().manual_seed(0))
    state, net = TP.create_state(torch.Generator().manual_seed(1), cfg, 4000,
                                 net=UNet(base_channel=8, num_res=1))
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
    got = frame_fn(*args)
    saved = RK.zbuffer, GC.gated_conv_kxk, GC.gated_conv_1x1
    RK.zbuffer = RK.zbuffer_plain
    GC.gated_conv_kxk = GC.gated_conv_kxk_plain
    GC.gated_conv_1x1 = GC.gated_conv_1x1_plain
    try:
        want = frame_fn(*args)
    finally:
        RK.zbuffer, GC.gated_conv_kxk, GC.gated_conv_1x1 = saved
    torch.cuda.synchronize()
    assert np.isfinite(got.cpu().numpy()).all()
    torch.testing.assert_close(got, want, atol=5e-4, rtol=1e-3)
