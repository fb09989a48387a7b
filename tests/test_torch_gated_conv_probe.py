"""K8's twin, the phase probe of K2, against the definitions of its modes
on the CPU (the JAX ``variant_kernel`` of ``scripts/probe_pack_split.py``
is local to its ``main`` and cannot be imported):

- ``full``: ``jax.lax.conv_general_dilated`` with no bias (3x3, stride
  1, zero pad 1), ``atol 2e-5, rtol 1e-4``;
- ``packonly``: the im2col tap matrix built here with numpy, tap-major
  ``(ky, kx, ci)``, its first ``2*Cout`` columns, bit-equal;
- ``nowin``: ``sum_t mask_t * x @ W_t`` with the in-image masks of the
  shifted taps, built here with numpy, ``atol 2e-5, rtol 1e-4``;
- ``nopack`` has no defined output: the twin and the CPU wrapper raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from read_tpu_torch.ops import gated_conv_probe as GP

F32 = dict(atol=2e-5, rtol=1e-4)


def _case(seed, b=2, h=7, w=9, cin=8, cout=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    wk = (rng.normal(size=(3, 3, cin, 2 * cout)) / np.sqrt(9 * cin)).astype(
        np.float32)
    return x, wk


def _taps(x):
    """numpy: the 9 zero-padded taps [B, H, W, C] and their masks."""
    _, h, w, _ = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    inside = np.pad(np.ones((h, w), np.float32), 1)
    return ([xp[:, ky:ky + h, kx:kx + w] for ky in range(3)
             for kx in range(3)],
            [inside[ky:ky + h, kx:kx + w] for ky in range(3)
             for kx in range(3)])


@pytest.mark.parametrize("bf16", [False, True])
def test_probe_full_matches_xla_conv(bf16):
    x, wk = _case(1)
    jx, jw = jnp.asarray(x), jnp.asarray(wk)
    if bf16:  # rounded operands, f32 sums (XLA:CPU has no bf16 dot here)
        jx, jw = (a.astype(jnp.bfloat16).astype(jnp.float32)
                  for a in (jx, jw))
    want = jax.lax.conv_general_dilated(
        jx, jw, (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    before = dict(GP.launches)
    got = GP.gated_conv_probe(torch.from_numpy(x), torch.from_numpy(wk),
                              mode="full", bf16=bf16)
    assert GP.launches == before          # a CPU tensor runs the twin
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("cin,cout", [(8, 6), (2, 12)])
def test_probe_packonly_is_the_tap_matrix(cin, cout):
    """Columns j < 2*Cout of the im2col matrix; with 9*Cin < 2*Cout the
    columns past the taps are zero."""
    x, wk = _case(2, cin=cin, cout=cout)
    taps, _ = _taps(x)
    cols = np.concatenate(taps, axis=-1)
    want = np.zeros(x.shape[:3] + (2 * cout,), np.float32)
    m = min(2 * cout, 9 * cin)
    want[..., :m] = cols[..., :m]
    got = GP.gated_conv_probe(torch.from_numpy(x), torch.from_numpy(wk),
                              mode="packonly")
    np.testing.assert_array_equal(got.numpy(), want)


def test_probe_nowin_is_the_masked_centre_tap_sum():
    x, wk = _case(3)
    _, masks = _taps(x)
    w9 = wk.reshape(9, x.shape[-1], -1)
    want = sum(masks[t][None, :, :, None] * (x @ w9[t]) for t in range(9))
    got = GP.gated_conv_probe(torch.from_numpy(x), torch.from_numpy(wk),
                              mode="nowin")
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_probe_contract():
    x, wk = map(torch.from_numpy, _case(4))
    with pytest.raises(ValueError):       # nopack: no defined output
        GP.gated_conv_probe_plain(x, wk, mode="nopack")
    with pytest.raises(ValueError):
        GP.gated_conv_probe(x, wk, mode="nopack")
    with pytest.raises(ValueError):
        GP.gated_conv_probe(x, wk, mode="pack")
    with pytest.raises(ValueError):       # not a 3x3 weight
        GP.gated_conv_probe(x, wk[:1, :1], mode="full")
    with pytest.raises(RuntimeError):
        GP.gated_conv_probe(x.to("meta"), wk.to("meta"), mode="full")
