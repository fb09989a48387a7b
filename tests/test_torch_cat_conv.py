"""K4's twin, the concat-free gated 1x1 conv, against read_tpu's Pallas
kernel ``gated_conv1x1_cat_chw`` (interpret mode), and the serving UNet
that runs it at the SCM sites against flax, on the CPU.

The JAX kernel takes channel-major ``[C_j, N]`` inputs, the port NHWC
``[..., C_j]``. For bf16 operands the JAX side gets the operands already
rounded to bf16 (held as f32: XLA:CPU has no bf16 x bf16 -> f32 dot
here), which gives the same exact products and f32 sums as
``mxu_bf16``. Tolerances: ``tests/test_unet_pallas.py``'s f32 bound
``atol 2e-5, rtol 1e-4`` for the conv, ``atol 5e-4, rtol 1e-3`` for the
whole UNet.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from read_tpu.models.unet import UNet as FlaxUNet
from read_tpu.ops import gated_conv_pack as GP
from read_tpu_torch.models import unet as U
from read_tpu_torch.ops import gated_conv as GC

F32 = dict(atol=2e-5, rtol=1e-4)
CINS = (16, 8, 4)


def _round(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                      .astype(jnp.float32))


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("relu", [True, False])
def test_cat_twin_matches_pallas(gated, bf16, relu):
    rng = np.random.default_rng(5 + 2 * gated + bf16)
    cout, n = 8, 300
    c2 = 2 * cout if gated else cout
    xs = [rng.normal(size=(c, n)).astype(np.float32) for c in CINS]
    r = rng.normal(size=(cout, n)).astype(np.float32)
    wk = rng.normal(size=(1, 1, sum(CINS), c2)).astype(np.float32) * 0.3
    b = rng.normal(size=c2).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    offset = rng.normal(size=cout).astype(np.float32)
    jx, jw = ([_round(x) for x in xs], _round(wk)) if bf16 else (xs, wk)
    want = GP.gated_conv1x1_cat_chw(
        tuple(jnp.asarray(x) for x in jx), jnp.asarray(jw), jnp.asarray(b),
        jnp.asarray(scale), jnp.asarray(offset), jnp.asarray(r), relu=relu,
        gated=gated, lanes=128, interpret=True)
    before = dict(GC.launches)
    got = GC.gated_conv_1x1_cat(
        [torch.from_numpy(x.T.copy()) for x in xs],
        *map(torch.from_numpy, (wk, b, scale, offset)),
        torch.from_numpy(r.T.copy()), relu=relu, gated=gated, bf16=bf16)
    assert GC.launches == before  # a CPU tensor runs the twin
    np.testing.assert_allclose(got.numpy(), np.asarray(want).T, **F32)
    if bf16:  # the rounding happened
        f32 = GC.gated_conv_1x1_cat_plain(
            [torch.from_numpy(x.T.copy()) for x in xs],
            *map(torch.from_numpy, (wk, b, scale, offset)),
            torch.from_numpy(r.T.copy()), relu=relu, gated=gated)
        assert float((got - f32).abs().max()) > 0


def test_cat_twin_equals_1x1_on_the_concat():
    """The twin over 2-4 inputs of a [B, H, W, C_j] batch is K3's twin
    on the materialized concat, up to summation order."""
    rng = np.random.default_rng(3)
    for cins in ((8, 56), (32, 64, 128, 256)):
        xs = [torch.from_numpy(rng.normal(size=(2, 3, 5, c)).astype(
            np.float32)) for c in cins]
        w = torch.from_numpy(rng.normal(size=(sum(cins), 16)).astype(
            np.float32)) / sum(cins) ** 0.5
        b, scale, offset = (torch.from_numpy(rng.normal(size=s).astype(
            np.float32)) for s in (16, 8, 8))
        got = GC.gated_conv_1x1_cat(xs, w, b, scale, offset)
        want = GC.gated_conv_1x1(torch.cat(xs, -1), w, b, scale, offset)
        assert got.shape == (2, 3, 5, 8)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)


def test_cat_wrapper_refuses_bad_input():
    x = [torch.zeros(1, 4, 4, 8)] * 5
    w, b, s, o = torch.zeros(40, 8), torch.zeros(8), torch.ones(4), \
        torch.zeros(4)
    with pytest.raises(ValueError):      # more than 4 inputs
        GC.gated_conv_1x1_cat(x, w, b, s, o)
    with pytest.raises(ValueError):      # channels do not fit the weight
        GC.gated_conv_1x1_cat(x[:2], w, b, s, o)
    with pytest.raises(ValueError):      # leading shapes differ
        GC.gated_conv_1x1_cat([x[0], torch.zeros(1, 4, 5, 8)], w[:16], b,
                              s, o)
    with pytest.raises(RuntimeError):    # no kernel for the device
        GC.gated_conv_1x1_cat([t.to("meta") for t in x[:2]],
                              *(t.to("meta") for t in (w[:16], b, s, o)))


def test_serving_unet_runs_k4_at_the_scm_sites_and_matches_flax():
    """The small UNet's serving route sends the three SCM ``BasicConv_4``
    sites (and only those) to K4 (its twin on the CPU) and stays within
    the UNet bound of flax's eval forward."""
    rng = np.random.default_rng(0)
    h, w = 16, 32
    pyr = [rng.normal(size=(1, h // f, w // f, 8)).astype(np.float32)
           for f in (1, 2, 4, 8)]
    net = FlaxUNet(base_channel=8, num_res=1)
    variables = jax.jit(lambda *p: net.init(jax.random.PRNGKey(0), *p,
                                            train=False))(*pyr)
    want = jax.jit(lambda v, *p: net.apply(v, *p, train=False))(
        variables, *pyr)["im_out"]
    port = U.UNet(base_channel=8, num_res=1)
    flat = {f"{'batch_stats' if k[0] == 'batch_stats' else 'params'}/"
            + "/".join(str(getattr(p, "key", p)) for p in k[1:]): np.array(v)
            for k, v in jax.tree_util.tree_flatten_with_path(
                dict(variables))[0]}
    state = {k.split("/", 1)[1].replace("/", "."): torch.from_numpy(v)
             for k, v in flat.items()}
    port.load_state_dict(state, strict=True)
    calls = []
    real = GC.gated_conv_1x1_cat

    def spy(xs, *a, **k):
        calls.append(tuple(x.shape[-1] for x in xs))
        return real(xs, *a, **k)

    GC.gated_conv_1x1_cat = spy
    try:
        got = port(*map(torch.from_numpy, pyr))["im_out"]
    finally:
        GC.gated_conv_1x1_cat = real
    assert sorted(calls) == [(8, 8), (8, 24), (8, 56)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4,
                               rtol=1e-3)
