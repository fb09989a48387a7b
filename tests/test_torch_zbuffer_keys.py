"""K6's twin, the z-buffer of given packed int32 keys, against read_tpu's
Pallas kernels ``zbuffer_pallas3`` (single view, (8, 128)-tiled
framebuffer) and ``zbuffer_pallas2`` (``[B, N]``) in interpret mode,
bit for bit, on the CPU.

Keys are made as JAX makes them (``rasterize_pallas.pack_keys``: the
depth truncated, not rounded) from a projected cloud, and handed to
both sides as numpy arrays: heavy ties (every position several times)
and dropped points (``pix >= n_pixels``) included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from read_tpu.ops import rasterize as JR
from read_tpu.ops import rasterize_pallas as RP
from read_tpu_torch.frame import frame_inputs
from read_tpu_torch.ops import rasterize_kernels as RK


def _keys(batch, n, hw, dup):
    """``(pix [B, N], key [B, N])`` int32 numpy from JAX's projection and
    ``pack_keys``; off-frame points carry ``pix = h*w``."""
    h, w = hw
    xyz, ms = frame_inputs(batch, n // dup, hw, focal=w * 0.6)
    xyz = jnp.asarray(np.tile(xyz, (dup, 1)))
    pix, key = [], []
    for m in ms:
        ndc, valid = JR.project_points(xyz, jnp.asarray(m))
        u = jnp.floor(w * (ndc[:, 0] + 1) * .5).astype(jnp.int32)
        v = jnp.floor(h * (1 - ndc[:, 1]) * .5).astype(jnp.int32)
        inside = valid & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        p = jnp.where(inside, v * w + u, h * w)
        d = jnp.where(inside, (ndc[:, 2] + 1) * .5, 2.0)
        k, _ = RP.pack_keys(p, d, jnp.arange(xyz.shape[0], dtype=jnp.int32),
                            h * w, xyz.shape[0])
        pix.append(np.asarray(p, np.int32))
        key.append(np.asarray(k, np.int32))
    return np.stack(pix), np.stack(key)


@pytest.mark.parametrize("n,hw,dup", [(3000, (24, 40), 1),
                                      (2400, (16, 24), 6)])
def test_keys_twin_matches_pallas3(n, hw, dup):
    pix, key = _keys(1, n, hw, dup)
    npx = hw[0] * hw[1]
    assert (pix >= npx).any()                  # dropped points present
    want = RP.zbuffer_pallas3(jnp.asarray(pix[0]), jnp.asarray(key[0]),
                              npx, chunk=1024, unroll=4, interpret=True)
    got = RK.zbuffer_keys(torch.from_numpy(pix[0]), torch.from_numpy(key[0]),
                          npx)
    assert got.shape == (npx,) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got != RK.INT32_MAX).any()


@pytest.mark.parametrize("dup", [1, 4])
def test_keys_twin_matches_pallas2_batched(dup):
    hw = (24, 40)
    pix, key = _keys(2, 3000, hw, dup)
    npx = hw[0] * hw[1]
    want = RP.zbuffer_pallas2(jnp.asarray(pix), jnp.asarray(key), npx,
                              chunk=1024, interpret=True)
    got = RK.zbuffer_keys(torch.from_numpy(pix), torch.from_numpy(key), npx)
    assert got.shape == (2, npx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the two views differ (different poses)
    assert not np.array_equal(got[0].numpy(), got[1].numpy())


def test_keys_wrapper_contract():
    """A CPU tensor runs the twin (no launch); bad input raises."""
    pix = torch.tensor([0, 3, 3, 9, 1], dtype=torch.int32)
    key = torch.tensor([7, 5, 2, 1, 4], dtype=torch.int32)
    before = dict(RK.launches)
    got = RK.zbuffer_keys(pix, key, 4)
    assert RK.launches == before
    assert got.tolist() == [7, 4, RK.INT32_MAX, 2]   # 9 >= 4 is dropped
    with pytest.raises(TypeError):
        RK.zbuffer_keys(pix.long(), key, 4)
    with pytest.raises(ValueError):
        RK.zbuffer_keys(pix, key[:4], 4)
    with pytest.raises(RuntimeError):
        RK.zbuffer_keys(pix.to("meta"), key.to("meta"), 4)
