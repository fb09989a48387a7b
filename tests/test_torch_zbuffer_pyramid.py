"""The pyramid pass's twin on the CPU: ``zbuffer_pyramid`` against JAX.

On the CPU ``RK.zbuffer_pyramid`` runs its plain twin: K1's or K5's
twin, then each coarser level as the 2x2 minimum of one key (the 64-bit
``(depth bits) << 32 | id`` for the exact pool, the packed int32 key for
the packed pool). JAX's side is ``read_tpu.ops.rasterize.
rasterize_pyramid_pooled``. Every level's index and depth must be
bit-equal. The points include some at depth exactly 1.0 (the far bin
``qmax - 1``) and 0.0, some off the frame inside the clip cube and some
outside it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from read_tpu.ops import rasterize as JR
from read_tpu_torch.ops import rasterize as R
from read_tpu_torch.ops import rasterize_kernels as RK


def _scene(n, views, dup, seed=5):
    """``n`` points seen by ``views`` orthographic views (clip w = 1, so
    depth = (z + 1) / 2 exactly). ``dup``: every point is one of ``n //
    3`` positions (exact depth ties, won by the least id)."""
    rng = np.random.default_rng(seed)
    m = n // 3 if dup else n
    xyz = rng.uniform(-1.1, 1.1, size=(m, 3)).astype(np.float32)
    xyz[:, 2] = rng.uniform(-1.0, 1.0, m)
    xyz[: m // 10, 2] = 1.0                 # depth 1.0: the far bin
    xyz[m // 10: m // 5, 2] = -1.0          # depth 0.0
    xyz[m // 5: m // 5 + 20, 0] = 1.0       # u == w: in the cube, off frame
    if dup:
        xyz = xyz[rng.integers(0, m, n)]
    ms = []
    for i in range(views):
        t = np.eye(4, dtype=np.float32)
        t[0, 3] = 0.07 * i
        t[1, 3] = -0.05 * i
        ms.append(t)
    return xyz, np.stack(ms)


@pytest.mark.parametrize("num_scales", [1, 4])
@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("views,hw", [(1, (64, 64)), (3, (32, 48))])
@pytest.mark.parametrize("pool_impl", ["exact", "packed"])
@pytest.mark.parametrize("method", ["sort", "pallas"])
def test_pyramid_twin_matches_jax(method, pool_impl, views, hw, dup,
                                  num_scales):
    xyz, ms = _scene(3000, views, dup)
    lj = JR.rasterize_pyramid_pooled(jnp.asarray(xyz), jnp.asarray(ms), hw,
                                     num_scales, method=method,
                                     pool_impl=pool_impl)
    lt = RK.zbuffer_pyramid(torch.from_numpy(xyz), torch.from_numpy(ms),
                            *hw, num_scales, method, pool_impl)
    assert len(lt) == num_scales
    for i, ((ij, dj), (it, dt)) in enumerate(zip(lj, lt)):
        assert it.shape == (views, hw[0] >> i, hw[1] >> i)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    index, depth = lt[0]
    assert 0.1 < float((index >= 0).float().mean()) < 1.0  # some empty
    assert float(depth.max()) == 1.0 and float(depth[index >= 0].min()) == 0
    if dup:   # each winner is the least id at its position
        _, first = np.unique(xyz, axis=0, return_index=True)
        assert np.isin(index[index >= 0].numpy(), first).all()


def test_pyramid_entry_points_run_the_pyramid():
    """``rasterize_pyramid_pooled`` and ``rasterize_batch`` give what
    ``zbuffer_pyramid`` gives ('scatter1' is K1's method)."""
    xyz, ms = (torch.from_numpy(a) for a in _scene(3000, 2, False))
    got = R.rasterize_pyramid_pooled(xyz, ms, (32, 48), 3, method="scatter1",
                                     pool_impl="packed")
    want = RK.zbuffer_pyramid(xyz, ms, 32, 48, 3, "pallas", "packed")
    for (ig, dg), (iw, dw) in zip(got, want):
        assert torch.equal(ig, iw) and torch.equal(dg, dw)
    index, depth = R.rasterize_batch(xyz, ms, 32, 48)
    (iw, dw), = RK.zbuffer_pyramid(xyz, ms, 32, 48, 1)
    assert torch.equal(index, iw) and torch.equal(depth, dw)


@pytest.mark.parametrize("levels", [2, 4])
def test_min_of_key_is_the_pair_pool(levels):
    """The exact pool as the minimum of ``(depth bits) << 32 | id`` gives
    the (depth, id) pair pool's levels, JAX's and the port's
    ``_pool2x2_zbuffer``, on level-0 buffers with depth ties, depths 0
    and 1, and empty pixels."""
    rng = np.random.default_rng(levels)
    b, h, w = 2, 16, 24
    index = rng.permutation(b * h * w * 2)[: b * h * w].reshape(b, h, w)
    index = index.astype(np.int32)
    depth = rng.choice(np.array([0.0, 0.25, 0.5, 1.0, 0.3, 0.7],
                                np.float32), size=(b, h, w))
    empty = rng.uniform(size=(b, h, w)) < 0.3
    empty[0, :4, :4] = True                  # a coarse pixel all empty
    index[empty] = -1
    depth[empty] = 0.0
    it, dt = torch.from_numpy(index), torch.from_numpy(depth)
    got = RK.pool_pyramid_plain(it, dt, levels, "exact", b * h * w * 2)
    ij, dj = jnp.asarray(index), jnp.asarray(depth)
    for lv in range(1, levels):
        it, dt = R._pool2x2_zbuffer(it, dt)
        ij, dj = JR._pool2x2_zbuffer(ij, dj)
        assert torch.equal(got[lv][0], it) and torch.equal(got[lv][1], dt)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert int((got[1][0] < 0).sum()) > 0     # an empty coarse pixel


def test_pyramid_refusals():
    xyz, ms = (torch.from_numpy(a) for a in _scene(600, 1, False))
    with pytest.raises(ValueError, match="divisible"):
        RK.zbuffer_pyramid(xyz, ms, 36, 48, 4)      # 36 % 8 != 0
    with pytest.raises(ValueError, match="num_scales"):
        RK.zbuffer_pyramid(xyz, ms, 32, 48, 0)
    with pytest.raises(ValueError, match="num_scales"):
        RK.zbuffer_pyramid(xyz, ms, 512, 512, RK.MAX_LEVELS + 1)
    # more than 2^23 ids: no packed key (a view, no memory)
    many = torch.zeros(1, 3).expand(2 ** 23 + 1, 3)
    for method, pool in (("sort", "packed"), ("pallas", "exact")):
        with pytest.raises(ValueError, match="2\\^23"):
            RK.zbuffer_pyramid(many, ms, 32, 48, 2, method, pool)
    with pytest.raises(ValueError, match="method"):
        RK.zbuffer_pyramid(xyz, ms, 32, 48, 2, "scatter1")
    with pytest.raises(ValueError, match="pool_impl"):
        RK.zbuffer_pyramid(xyz, ms, 32, 48, 2, "sort", "pair")
    with pytest.raises(TypeError):
        RK.zbuffer_pyramid(xyz.double(), ms, 32, 48, 2)
    with pytest.raises(ValueError, match="different devices"):
        RK.zbuffer_pyramid(xyz, ms.to("meta"), 32, 48, 2)
    with pytest.raises(RuntimeError, match="no kernel"):
        RK.zbuffer_pyramid(xyz.to("meta"), ms.to("meta"), 32, 48, 2)
    # the entry point refuses the same size
    with pytest.raises(ValueError, match="divisible"):
        R.rasterize_pyramid_pooled(xyz, ms, (36, 48), 4)


@pytest.mark.parametrize("pool_impl", ["exact", "packed"])
@pytest.mark.parametrize("method", ["sort", "pallas"])
def test_bench_library_chain_is_the_pyramid(method, pool_impl):
    """The kernel bench's library yardstick for the pyramid rows (the
    projection, then the plain pools level by level) computes the same
    levels as the pyramid's twin, bit for bit, ties included."""
    from read_tpu_torch import kernel_bench as KB
    xyz, ms = (torch.from_numpy(a) for a in _scene(3000, 2, True))
    want = RK.zbuffer_pyramid(xyz, ms, 32, 48, 4, method, pool_impl)
    got = KB.plain_pool_chain(xyz, ms, (32, 48), 4, method, pool_impl)
    assert len(got) == len(want) == 4
    for (ig, dg), (iw, dw) in zip(got, want):
        assert torch.equal(ig, iw) and torch.equal(dg, dw)
