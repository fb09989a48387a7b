"""K5, the exact z-buffer, on the CPU: its twin against read_tpu's.

On the CPU ``RK.zbuffer_exact`` runs its plain twin (``pack_exact_keys``
-> ``scatter_min`` on int64 keys -> ``unpack_exact``). JAX's side runs the
Pallas kernel ``rasterize_pallas``/``zbuffer_pallas`` in interpret mode
and the default ``rasterize_batch(method='sort')``. Index and depth maps
must be bit-equal: per pixel the least depth, ties to the least id.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from read_tpu.ops import rasterize as JR
from read_tpu.ops import rasterize_pallas as JRP
from read_tpu.scene import camera
from read_tpu_torch.frame import frame_inputs
from read_tpu_torch.ops import rasterize as R
from read_tpu_torch.ops import rasterize_kernels as RK


def _scene(n=1500, h=24, w=40, views=3, dup=None, seed=3):
    """Points in front of a camera, B views. ``dup`` draws every point
    from ``dup`` distinct positions: many points share a pixel and an
    exact depth."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-2, 2, size=(n if dup is None else dup, 3))
    xyz[:, 2] -= 6.0
    if dup is not None:
        xyz = xyz[rng.integers(0, dup, n)]
    K = np.array([[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]])
    P = camera.gl_projection(K, (w, h), 0.1, 50.0)
    ms = []
    for i in range(views):
        v = np.eye(4)
        v[0, 3] = 0.3 * i
        ms.append(camera.total_matrix(P, v))
    return xyz.astype(np.float32), np.stack(ms).astype(np.float32)


def _twin(pix, depth, ids, n_pixels):
    """K5's twin on given (pix, depth, ids): pack -> scatter-min ->
    unpack (pix >= n_pixels is dropped)."""
    key = RK.pack_exact_keys(pix, depth, ids, n_pixels)
    return RK.unpack_exact(RK.scatter_min(pix, key, n_pixels))


@pytest.mark.parametrize("dup", [None, 40])
def test_zbuffer_exact_matches_pallas_kernel(dup):
    """Per view, vs ``rasterize_pallas`` (the Pallas K5 with JAX's
    projection) in interpret mode; ``dup=40`` is the heavy-tie case."""
    h, w = 24, 40
    xyz, ms = _scene(n=1200, views=2, dup=dup)
    index, depth = RK.zbuffer_exact(torch.from_numpy(xyz),
                                    torch.from_numpy(ms), h, w)
    for b, m in enumerate(ms):
        ij, dj = JRP.rasterize_pallas(jnp.asarray(xyz), jnp.asarray(m), h, w,
                                      chunk=256, interpret=True)
        np.testing.assert_array_equal(index[b].numpy(),
                                      np.asarray(ij).reshape(-1))
        np.testing.assert_array_equal(depth[b].numpy(),
                                      np.asarray(dj).reshape(-1))
    if dup is None:
        assert (index >= 0).float().mean() > 0.2
    else:   # ~30 points per position: each winner beat its exact twins
        winners = index[index >= 0]
        assert 0 < len(winners) <= 2 * dup
        assert len(torch.unique(winners)) == len(torch.unique(
            torch.from_numpy(xyz)[winners.long()], dim=0))


@pytest.mark.parametrize("views", [1, 3])
@pytest.mark.parametrize("dup", [None, 60])
def test_rasterize_batch_sort_matches_jax(views, dup):
    xyz, ms = _scene(views=views, dup=dup)
    ij, dj = JR.rasterize_batch(jnp.asarray(xyz), jnp.asarray(ms), 24, 40,
                                method="sort")
    it, dt = R.rasterize_batch(torch.from_numpy(xyz), torch.from_numpy(ms),
                               24, 40, method="sort")
    assert tuple(it.shape) == (views, 24, 40) and it.dtype == torch.int32
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    if dup is not None:   # the ties really happened: fewer winners
        assert len(np.unique(it.numpy()[it.numpy() >= 0])) <= dup


def test_pyramid_sort_matches_jax():
    """All 4 levels of the exact pyramid at 48x64, B=2."""
    xyz, ms = frame_inputs(batch=2, n_points=20000, hw=(48, 64), focal=40.0)
    lj = JR.rasterize_pyramid_pooled(jnp.asarray(xyz), jnp.asarray(ms),
                                     (48, 64), 4, method="sort")
    lt = R.rasterize_pyramid_pooled(torch.from_numpy(xyz),
                                    torch.from_numpy(ms), (48, 64), 4,
                                    method="sort")
    assert len(lt) == 4
    for (ij, dj), (it, dt) in zip(lj, lt):
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def test_far_plane_pow2():
    """A power-of-two id count at depth 1.0 must not read empty: the
    key ``bits(1.0) << 32 | id`` never meets the empty sentinel
    (test_rasterize_pallas2.py:31-41)."""
    n, h, w = 1024, 8, 8
    it, dt = _twin(torch.zeros(n, dtype=torch.int32), torch.ones(n),
                   torch.arange(n, dtype=torch.int32), h * w)
    ij, dj = JRP.zbuffer_pallas(jnp.zeros((n,), jnp.int32),
                                jnp.full((n,), 1.0), h * w, chunk=256,
                                interpret=True)
    assert int(it[0]) == int(ij[0]) == 0
    assert float(dt[0]) == float(dj[0]) == 1.0
    assert bool((it[1:] == -1).all()) and float(dt[1:].abs().max()) == 0.0


def test_exact_keys_beyond_2_to_23_ids():
    """Ids up to 2^31 - 1 on synthetic pixels and depths (no projection,
    no 8M-point cloud): the packed-key limit of K1 does not apply, and
    the result equals JAX's sort z-buffer on the same ids."""
    rng = np.random.default_rng(11)
    n, n_pixels = 4000, 97
    pix = rng.integers(0, n_pixels + 1, n).astype(np.int32)  # +1: dropped
    depth = rng.choice(np.linspace(0, 1, 7, dtype=np.float32), n)
    ids = rng.choice(np.arange(2 ** 23 - 50, 2 ** 31 - 1, 131_071,
                               dtype=np.int64), n, replace=False
                     ).astype(np.int32)
    it, dt = _twin(torch.from_numpy(pix), torch.from_numpy(depth),
                   torch.from_numpy(ids), n_pixels)
    ij, dj = JR._zbuffer_sort(jnp.asarray(pix), jnp.asarray(depth),
                              jnp.asarray(ids), n_pixels)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert int(it.max()) >= 2 ** 23
    with pytest.raises(ValueError):
        RK.key_bits(2 ** 23 + 1)


def test_zbuffer_exact_refuses_bad_input():
    xyz, ms = _scene(n=10, views=1)
    with pytest.raises(RuntimeError):
        RK.zbuffer_exact(torch.from_numpy(xyz).to("meta"),
                         torch.from_numpy(ms).to("meta"), 8, 8)
    with pytest.raises(TypeError):
        RK.zbuffer_exact(torch.from_numpy(xyz).double(),
                         torch.from_numpy(ms), 8, 8)
