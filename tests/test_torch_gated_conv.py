"""The gated-conv twins (K2, K3) against read_tpu's Pallas kernels and
flax's BasicConv, on the CPU.

The JAX kernels run in interpret mode; they take channel-major
``[C, H*W]`` activations, the port NHWC ``[B, H, W, C]``. Tolerances are
``tests/test_unet_pallas.py``'s: f32 ``atol 2e-5, rtol 1e-4``; bf16
operands ``atol 0.35, rtol 0.05``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from read_tpu.models.unet import BasicConv as FlaxBasicConv
from read_tpu.ops import gated_conv_pack as GP
from read_tpu_torch.models.unet import BasicConv
from read_tpu_torch.ops import gated_conv as GC

F32 = dict(atol=2e-5, rtol=1e-4)
BF16 = dict(atol=0.35, rtol=0.05)


def _operands(rng, cin, cout, k=3):
    wk = (rng.normal(size=(k, k, cin, 2 * cout)) * 0.2).astype(np.float32)
    b = rng.normal(size=2 * cout).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    offset = rng.normal(size=cout).astype(np.float32)
    return wk, b, scale, offset


def _chw(x):
    """[1, H, W, C] numpy -> [C, H*W] jax."""
    _, h, w, c = x.shape
    return jnp.asarray(x[0].transpose(2, 0, 1).reshape(c, h * w))


def _nhwc(y, h, w):
    """[C, H*W] jax -> [1, H, W, C] numpy."""
    return np.asarray(y).reshape(-1, h, w).transpose(1, 2, 0)[None]


@pytest.mark.parametrize("cin,cout,h,w", [(8, 4, 8, 16), (32, 32, 6, 9)])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("with_res", [False, True])
def test_kxk_twin_matches_pallas_3x3(cin, cout, h, w, relu, with_res):
    rng = np.random.default_rng(cin + cout + relu + 7 * with_res)
    x = rng.normal(size=(1, h, w, cin)).astype(np.float32)
    wk, b, scale, offset = _operands(rng, cin, cout)
    res = (rng.normal(size=(1, h, w, cout)).astype(np.float32)
           if with_res else None)
    want = GP.gated_conv3x3_chw(
        _chw(x), jnp.asarray(wk), jnp.asarray(b), jnp.asarray(scale),
        jnp.asarray(offset), None if res is None else _chw(res),
        w_img=w, relu=relu, rows=2, interpret=True, impl="dot3")
    got = GC.gated_conv_kxk(*map(torch.from_numpy,
                                 (x, wk, b, scale, offset)),
                            None if res is None else torch.from_numpy(res),
                            relu=relu)
    np.testing.assert_allclose(got.numpy(), _nhwc(want, h, w), **F32)


def test_kxk_twin_bf16_operands_match_pallas_mxu_bf16():
    rng = np.random.default_rng(11)
    cin, cout, h, w = 32, 32, 6, 9
    x = rng.normal(size=(1, h, w, cin)).astype(np.float32)
    wk, b, scale, offset = _operands(rng, cin, cout)
    args = (_chw(x), jnp.asarray(wk), jnp.asarray(b), jnp.asarray(scale),
            jnp.asarray(offset))
    want = GP.gated_conv3x3_chw(*args, w_img=w, relu=True, rows=2,
                                interpret=True, impl="dot3",
                                mxu_bf16=True)
    targs = tuple(map(torch.from_numpy, (x, wk, b, scale, offset)))
    got = GC.gated_conv_kxk(*targs, relu=True, bf16=True)
    np.testing.assert_allclose(got.numpy(), _nhwc(want, h, w), **BF16)
    # same arithmetic (bf16 products exact in f32, f32 sums): far inside
    # the bf16 bound in practice
    np.testing.assert_allclose(got.numpy(), _nhwc(want, h, w), **F32)
    f32 = GC.gated_conv_kxk(*targs, relu=True)
    assert float((got - f32).abs().max()) > 0  # the rounding happened


def _flax_basic_conv(rng, cin, cout, k, stride, relu, x):
    mod = FlaxBasicConv(cout, k, stride, relu=relu, conv_impl="xla")
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    params = jax.tree_util.tree_map(np.array, v["params"])
    params["norm"]["scale"] = rng.uniform(0.5, 1.5, cout).astype(
        np.float32)
    params["norm"]["bias"] = rng.normal(size=cout).astype(np.float32)
    params["conv_fm"]["bias"] = rng.normal(size=2 * cout).astype(
        np.float32) * 0.1
    stats = {"norm": {
        "mean": rng.normal(size=cout).astype(np.float32) * 0.1,
        "var": rng.uniform(0.5, 2.0, cout).astype(np.float32)}}
    ref = mod.apply({"params": params, "batch_stats": stats},
                    jnp.asarray(x), train=False)
    port = BasicConv(cin, cout, k, stride, relu=relu)
    with torch.no_grad():
        port.conv_fm.kernel.copy_(torch.from_numpy(
            params["conv_fm"]["kernel"]))
        port.conv_fm.bias.copy_(torch.from_numpy(params["conv_fm"]["bias"]))
        port.norm.scale.copy_(torch.from_numpy(params["norm"]["scale"]))
        port.norm.bias.copy_(torch.from_numpy(params["norm"]["bias"]))
        port.norm.mean.copy_(torch.from_numpy(stats["norm"]["mean"]))
        port.norm.var.copy_(torch.from_numpy(stats["norm"]["var"]))
    return np.asarray(ref), port


@pytest.mark.parametrize("k,cin,cout,h,w", [(3, 8, 16, 12, 20),
                                            (4, 16, 8, 12, 20),
                                            (4, 8, 8, 6, 10)])
def test_strided_transition_matches_flax(k, cin, cout, h, w):
    """k3s2 / k4s2 (pad 1: even H -> H/2), B=2, BN folded, vs flax
    BasicConv(conv_impl='xla') in eval mode."""
    rng = np.random.default_rng(k * 100 + cin)
    x = rng.normal(size=(2, h, w, cin)).astype(np.float32)
    ref, port = _flax_basic_conv(rng, cin, cout, k, 2, True, x)
    assert ref.shape == (2, h // 2, w // 2, cout)
    with torch.no_grad():
        got = port(torch.from_numpy(x), bf16=False)
    np.testing.assert_allclose(got.numpy(), ref, **F32)


@pytest.mark.parametrize("relu", [True, False])
def test_1x1_twin_matches_pallas(relu):
    rng = np.random.default_rng(3 + relu)
    cin, cout, n = 16, 8, 100
    x = rng.normal(size=(cin, n)).astype(np.float32)
    wk, b, scale, offset = _operands(rng, cin, cout, k=1)
    want = GP.gated_conv1x1_chw(jnp.asarray(x), jnp.asarray(wk),
                                jnp.asarray(b), jnp.asarray(scale),
                                jnp.asarray(offset), relu=relu, lanes=64,
                                interpret=True)
    got = GC.gated_conv_1x1(torch.from_numpy(x.T.copy()),
                            *map(torch.from_numpy, (wk, b, scale, offset)),
                            relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).T, **F32)


def test_1x1_twin_bf16_and_residual_match_pallas():
    rng = np.random.default_rng(5)
    cin, cout, n = 32, 16, 300
    x = rng.normal(size=(cin, n)).astype(np.float32)
    r = rng.normal(size=(cout, n)).astype(np.float32)
    wk, b, scale, offset = _operands(rng, cin, cout, k=1)
    # XLA:CPU has no bf16 x bf16 -> f32 dot for this kernel, so the JAX
    # side gets the operands already rounded to bf16 (held as f32): the
    # same products, exact in f32, and the same f32 sums as mxu_bf16
    rx, rw = (np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                         .astype(jnp.float32)) for a in (x, wk))
    want = GP.gated_conv1x1_chw(jnp.asarray(rx), jnp.asarray(rw),
                                jnp.asarray(b), jnp.asarray(scale),
                                jnp.asarray(offset), jnp.asarray(r),
                                relu=True, lanes=128, interpret=True)
    got = GC.gated_conv_1x1(torch.from_numpy(x.T.copy()),
                            *map(torch.from_numpy, (wk, b, scale, offset)),
                            torch.from_numpy(r.T.copy()), relu=True,
                            bf16=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).T, **BF16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).T, **F32)


def test_1x1_matches_flax_basic_conv():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 6, 10, 16)).astype(np.float32)
    ref, port = _flax_basic_conv(rng, 16, 24, 1, 1, True, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x), bf16=False)
    np.testing.assert_allclose(got.numpy(), ref, **F32)


def test_wrappers_dispatch_by_device():
    """A CPU tensor runs the twin (no kernel launch); a device with no
    kernel raises; bad shapes raise."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1, 4, 6, 8)).astype(np.float32))
    wk, b, scale, offset = map(torch.from_numpy, _operands(rng, 8, 4))
    before = dict(GC.launches)
    GC.gated_conv_kxk(x, wk, b, scale, offset)
    GC.gated_conv_1x1(x, wk[1:2, 1:2], b, scale, offset)
    assert GC.launches == before
    meta = [t.to("meta") for t in (x, wk, b, scale, offset)]
    with pytest.raises(RuntimeError):
        GC.gated_conv_kxk(*meta)
    with pytest.raises(ValueError):
        GC.gated_conv_kxk(x, wk[:, :, :4], b, scale, offset)
    with pytest.raises(TypeError):
        GC.gated_conv_kxk(x.double(), wk, b, scale, offset)
