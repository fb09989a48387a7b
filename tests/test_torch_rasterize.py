"""read_tpu_torch's raster path against read_tpu's, on the CPU.

On the CPU the port runs K1's plain twin (``RK.scatter_min``: a
``scatter_reduce_`` amin on the packed keys); the JAX side runs
``_zbuffer_scatter1`` and the Pallas
kernel in interpret mode. Index maps, depths and pyramids must be
bit-equal: the port keeps JAX's f32 operation order throughout.
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


def _random_case(rng, n, h, w):
    pix = rng.integers(0, h * w + 1, n).astype(np.int32)
    depth = rng.uniform(0, 1, n).astype(np.float32)
    ids = np.arange(n, dtype=np.int32)
    return pix, depth, ids


def _twin_scatter1(pix, depth, ids, n_pixels, depth_by_id, n_ids):
    """JAX ``_zbuffer_scatter1``'s contract from the pieces K1's twin
    runs: pack_keys -> scatter_min -> unpack."""
    key, idb = RK.pack_keys(pix, depth, ids, n_pixels, n_ids)
    return RK.unpack_packed(RK.scatter_min(pix, key, n_pixels), idb,
                            depth_by_id)


@pytest.mark.parametrize("n,h,w", [(5000, 24, 40), (1024, 8, 16)])
def test_zbuffer_scatter1_matches_jax(rng, n, h, w):
    """Same (pix, depth, ids) -> bit-equal index and depth vs both the
    XLA scatter1 and the Pallas kernel (interpret mode)."""
    pix, depth, ids = _random_case(rng, n, h, w)
    it, dt = _twin_scatter1(torch.from_numpy(pix), torch.from_numpy(depth),
                            torch.from_numpy(ids), h * w,
                            torch.from_numpy(depth), n)
    i1, d1 = JR._zbuffer_scatter1(jnp.asarray(pix), jnp.asarray(depth),
                                  jnp.asarray(ids), h * w,
                                  jnp.asarray(depth), n)
    i2, d2 = JRP.zbuffer_scatter1_pallas(
        jnp.asarray(pix), jnp.asarray(depth), jnp.asarray(ids), h * w,
        jnp.asarray(depth), n, interpret=True)
    for ij, dj in ((i1, d1), (i2, d2)):
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def test_pack_keys_match_jax(rng):
    n, h, w = 5000, 24, 40
    pix, depth, ids = _random_case(rng, n, h, w)
    kt, idb_t = RK.pack_keys(torch.from_numpy(pix), torch.from_numpy(depth),
                             torch.from_numpy(ids), h * w, n)
    kj, idb_j = JRP.pack_keys(jnp.asarray(pix), jnp.asarray(depth),
                              jnp.asarray(ids), h * w, n)
    assert idb_t == idb_j == 13
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))


def test_key_bits_at_1m_points():
    assert RK.key_bits(1_000_000) == (20, 2 ** 11 - 1)
    with pytest.raises(ValueError):
        RK.key_bits(2 ** 23 + 1)


def test_far_plane_pow2():
    """Power-of-two id count + far-plane depths must not read empty: the
    key is clipped to qmax-1 so it never equals the INT32_MAX sentinel
    (test_rasterize_pallas2.py:31-41)."""
    n, h, w = 1024, 8, 8
    pix = torch.zeros(n, dtype=torch.int32)
    depth = torch.ones(n)
    ids = torch.arange(n, dtype=torch.int32)
    it, dt = _twin_scatter1(pix, depth, ids, h * w, depth, n)
    i2, d2 = JRP.zbuffer_scatter1_pallas(
        jnp.zeros((n,), jnp.int32), jnp.full((n,), 1.0), jnp.arange(n),
        h * w, jnp.full((n,), 1.0), n, interpret=True)
    assert int(it[0]) >= 0 and float(dt[0]) == 1.0
    assert int(it[0]) == int(i2[0])


def _scene(n=3000, h=24, w=40, f=30.0, views=2):
    rng = np.random.default_rng(3)
    xyz = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    xyz[:, 2] -= 6.0
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    P = camera.gl_projection(K, (w, h), 0.1, 50.0)
    ms = []
    for i in range(views):
        v = np.eye(4)
        v[0, 3] = 0.3 * i
        ms.append(camera.total_matrix(P, v))
    return xyz, np.stack(ms).astype(np.float32)


def test_projection_matches_jax():
    """The element-wise projection agrees with JAX's; a pixel id that
    moves would need an FMA contraction on one side. Bound: none
    moved (checked exactly)."""
    xyz, ms = _scene()
    for m in ms:
        nd_j, va_j = JR.project_points(jnp.asarray(xyz), jnp.asarray(m))
        nd_t, va_t = R.project_points(torch.from_numpy(xyz),
                                      torch.from_numpy(m))
        np.testing.assert_array_equal(va_t.numpy(), np.asarray(va_j))
        np.testing.assert_array_equal(nd_t.numpy(), np.asarray(nd_j))


@pytest.mark.parametrize("method", ["pallas", "scatter1"])
def test_rasterize_batch_matches_jax(method):
    """B=2 views through K1's twin vs JAX rasterize_batch: bit-equal
    index and depth maps (0 moved pixels)."""
    xyz, ms = _scene()
    ij, dj = JR.rasterize_batch(jnp.asarray(xyz), jnp.asarray(ms), 24, 40,
                                method=method)
    it, dt = R.rasterize_batch(torch.from_numpy(xyz), torch.from_numpy(ms),
                               24, 40, method=method)
    moved = int((it.numpy() != np.asarray(ij)).sum())
    assert moved == 0, f"{moved} pixels moved"
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert (it >= 0).float().mean() > 0.3  # the test covers real pixels


def test_zbuffer_twin_buffer_matches_jax_keys():
    """K1's twin returns the per-pixel min of exactly JAX's packed keys
    (shared projection -> shared (pix, key))."""
    xyz, ms = _scene(views=1)
    h, w = 24, 40
    n = xyz.shape[0]
    ndc, valid = JR.project_points(jnp.asarray(xyz), jnp.asarray(ms[0]))
    pix, depth = JR._pixel_ids(ndc, valid, h, w)
    key, _ = JRP.pack_keys(pix, depth, jnp.arange(n, dtype=jnp.int32),
                           h * w, n)
    want = JRP.zbuffer_pallas2(pix, key, h * w, interpret=True)
    buf, depth0 = RK.zbuffer(torch.from_numpy(xyz), torch.from_numpy(ms),
                             h, w)
    np.testing.assert_array_equal(buf[0].numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        depth0[0].numpy(),
        np.asarray(jnp.where(valid, (ndc[:, 2] + 1.0) * 0.5, 0.0)))


@pytest.mark.parametrize("pool_impl", ["exact", "packed"])
def test_pyramid_pools_match_jax(pool_impl):
    """4-level pyramids at 48x64, B=2: bit-equal at every level."""
    xyz, ms = frame_inputs(batch=2, n_points=20000, hw=(48, 64), focal=40.0)
    lj = JR.rasterize_pyramid_pooled(jnp.asarray(xyz), jnp.asarray(ms),
                                     (48, 64), 4, method="pallas",
                                     pool_impl=pool_impl)
    lt = R.rasterize_pyramid_pooled(torch.from_numpy(xyz),
                                    torch.from_numpy(ms), (48, 64), 4,
                                    method="pallas", pool_impl=pool_impl)
    assert len(lt) == 4
    for (ij, dj), (it, dt) in zip(lj, lt):
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def test_unknown_method_and_device_raise():
    xyz, ms = _scene()
    with pytest.raises(ValueError):
        R.rasterize_batch(torch.from_numpy(xyz), torch.from_numpy(ms),
                          24, 40, method="bogus")
    with pytest.raises(RuntimeError):
        RK.zbuffer(torch.from_numpy(xyz).to("meta"),
                   torch.from_numpy(ms).to("meta"), 24, 40)
