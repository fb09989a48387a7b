"""K7's twins, the row-band gated 3x3 and 1x1 convolutions, against the
round-2 Pallas kernels of ``scripts/gated_conv_pallas_r2.py`` (interpret
mode) on the CPU: relu on and off, gated on and off, an image height
that is not a multiple of ``tile_h``, float32 at ``atol 2e-5, rtol
1e-4`` (the bound of ``tests/test_unet_pallas.py``) and bfloat16 in and
out at ``atol 1e-3, rtol 1e-2``: both sides sum the same bf16 operands
in f32 and round the output to bf16 once, so they differ by at most one
bf16 ulp (2**-7 of the value, under ``rtol``; ``atol`` for values near
0).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from read_tpu_torch.ops import gated_conv_r2 as R2

F32 = dict(atol=2e-5, rtol=1e-4)
BF16_OUT = dict(atol=1e-3, rtol=1e-2)
_SPEC = importlib.util.spec_from_file_location(
    "gated_conv_pallas_r2", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "scripts", "gated_conv_pallas_r2.py"))
G = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(G)


def _case(rng, h, w, cin, cout, k, gated):
    c2 = 2 * cout if gated else cout
    x = rng.normal(size=(h, w, cin)).astype(np.float32)
    wk = (rng.normal(size=(k, k, cin, c2)) / np.sqrt(k * k * cin)).astype(
        np.float32)
    b = (rng.normal(size=c2) * 0.1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    offset = (rng.normal(size=cout) * 0.1).astype(np.float32)
    return x, wk, b, scale, offset


@pytest.mark.parametrize("k,h,tile_h", [(3, 10, 4), (3, 8, 8), (1, 10, 4)])
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("relu", [True, False])
def test_r2_twin_matches_pallas_f32(k, h, tile_h, gated, relu):
    rng = np.random.default_rng(k * 10 + h + 2 * gated + relu)
    x, wk, b, scale, offset = _case(rng, h, 12, 16, 8, k, gated)
    fn = G.gated_conv3x3 if k == 3 else G.gated_conv1x1
    want = fn(*map(jnp.asarray, (x, wk, b, scale, offset)), relu=relu,
              gated=gated, tile_h=tile_h, interpret=True)
    port = R2.gated_conv3x3_r2 if k == 3 else R2.gated_conv1x1_r2
    before = dict(R2.launches)
    got = port(*map(torch.from_numpy, (x, wk, b, scale, offset)),
               relu=relu, gated=gated)
    assert R2.launches == before        # a CPU tensor runs the twin
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("k", [3, 1])
@pytest.mark.parametrize("gated", [True, False])
def test_r2_twin_matches_pallas_bf16(k, gated):
    """bf16 in and out (the weights cast to the input's dtype, f32
    sums): the script's kernel on bf16 input vs the port's twin."""
    rng = np.random.default_rng(40 + k + gated)
    x, wk, b, scale, offset = _case(rng, 10, 12, 16, 8, k, gated)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    fn = G.gated_conv3x3 if k == 3 else G.gated_conv1x1
    want = fn(xb, *map(jnp.asarray, (wk, b, scale, offset)), relu=True,
              gated=gated, tile_h=4, interpret=True)
    port = R2.gated_conv3x3_r2 if k == 3 else R2.gated_conv1x1_r2
    got = port(torch.from_numpy(x).to(torch.bfloat16),
               *map(torch.from_numpy, (wk, b, scale, offset)), relu=True,
               gated=gated)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **BF16_OUT)


def test_r2_wrapper_refuses_bad_input():
    x = torch.zeros(4, 5, 8)
    w, b, s, o = torch.zeros(3, 3, 8, 6), torch.zeros(6), torch.ones(3), \
        torch.zeros(3)
    with pytest.raises(ValueError):      # a batch dim: one image only
        R2.gated_conv3x3_r2(x[None], w, b, s, o)
    with pytest.raises(ValueError):      # 3x3 weights to the 1x1 entry
        R2.gated_conv1x1_r2(x, w, b, s, o)
    with pytest.raises(ValueError):      # gated needs an even C2
        R2.gated_conv3x3_r2(x, w[..., :5], b[:5], s, o)
    with pytest.raises(TypeError):
        R2.gated_conv3x3_r2(x, w, b.double(), s, o)
    with pytest.raises(RuntimeError):
        R2.gated_conv3x3_r2(*(t.to("meta") for t in (x, w, b, s, o)))
