"""K6 on its user path, splats, against read_tpu on the CPU.

On the CPU ``RK.zbuffer_splat`` runs its twin, ``zbuffer_splat_plain``,
which builds JAX's ``(2r+1)^2`` offset expansion as JAX does and
z-buffers it with K5's exact key ('sort') or K1's packed key ('pallas').
JAX's side is ``read_tpu.ops.rasterize`` (on the CPU its 'pallas' runs
the XLA scatter1) and, at one shape, ``_rasterize_batch_pallas_splat``
with ``zbuffer_pallas2`` in interpret mode. Every level's index and depth
must be bit-equal: plain radius, per-point sizes and z-scaled sizes, r =
1 and 2, 1 and 3 views, and the edge cases: centres one past the frame
(ndc x = 1 or y = -1: only their left or upper neighbours land), exact
depth ties, NaN, infinite, negative, fractional and over-cap sizes with
``min_point_size`` 1 and 3, and sizes with r = 0 (which change nothing
and run K1's or K5's twin). A plain emulation of the CUDA kernel's
coverage rule (the square of half-width ``splat_reach``) is held to the
expansion's per-copy test.

The slice as a whole, with the UNet cut to ``base_channel=8,
num_res=1``: the plain gather's forward and backward on a splatted index
map (``rtol 1e-6``: sums of a few float32 terms, in another order than
XLA's); the first-step gradients from a JAX-written ``TrainState`` with
``uv_1d_p3`` and with a ``ps`` format and per-point sizes, no further
from a float64 run than JAX's float32 gradients (x1.25) and within
``2e-4 * max|g|`` of JAX's, the rule of ``tests/test_torch_train.py``
(where JAX's own gradient is further than ``1e-4 * max|g|`` from the
float64 run, within 2.25 times that distance, which the first bound
implies); a
``NeuralRenderer`` frame from a JAX ``uv_1d_p3`` checkpoint with a
``point_sizes`` manifest within ``atol 5e-4, rtol 1e-3``;
``set_point_radius`` against a renderer built at that radius; and a CLI
run with ``--input-format uv_1d_p3...`` whose every step and val batch
splats.
"""

import dataclasses
import functools
import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from read_tpu.criterions import vgg as JV
from read_tpu.models import texture as JT
from read_tpu.models.unet import UNet as FlaxUNet
from read_tpu.ops import rasterize as JR
from read_tpu.ops import rasterize_pallas as JRP
from read_tpu.pipelines import texture_pipeline as JTP
from read_tpu.render import NeuralRenderer as JaxRenderer
from read_tpu.scene import camera
from read_tpu.scene import io as JIO
from read_tpu.utils import ckpt as JCK
from read_tpu_torch import render as TR
from read_tpu_torch import train as TRAIN
from read_tpu_torch.models import texture as T
from read_tpu_torch.models.unet import UNet
from read_tpu_torch.ops import rasterize as R
from read_tpu_torch.ops import rasterize_kernels as RK
from read_tpu_torch.pipelines import texture_pipeline as TP
from read_tpu_torch.utils import ckpt as CK
from read_tpu_torch.utils import convert as CV

P3 = "uv_1d_p3, uv_1d_p3_ds1, uv_1d_p3_ds2, uv_1d_p3_ds3, uv_1d_p3_ds4"
PS2 = "uv_1d_ps2, uv_1d_ps2_ds1, uv_1d_ps2_ds2, uv_1d_ps2_ds3, uv_1d_ps2_ds4"
SMALL = dict(base_channel=8, num_res=1)
FRAME_TOL = dict(atol=5e-4, rtol=1e-3)
GRAD_ATOL = 2e-4           # x max|g|, tests/test_torch_train.py
# sizes that probe every branch of the radius arithmetic: NaN (centre
# only: jnp.maximum/minimum propagate it), +-inf, negative, zero,
# fractional either side of an odd size, exactly odd, over the cap
EDGE_SIZES = np.array([np.nan, np.inf, -np.inf, -2.0, 0.0, 0.5, 1.0, 2.5,
                       2.9998, 2.9999, 3.0, 3.0001, 4.9, 5.0, 9.0],
                      np.float32)


def _persp_scene(n, views, hw, seed=3):
    """``n`` points 0.5 to 6.5 units before a perspective camera (clip z
    spans ~0.3 to ~6, so z-scaled sizes cover every ring), ``views``
    poses, per-point sizes in [0.5, 6) with every 17th NaN."""
    rng = np.random.default_rng(seed)
    h, w = hw
    xyz = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    xyz[:, 2] = rng.uniform(-6.5, -0.5, n)
    K = np.array([[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]])
    P = camera.gl_projection(K, (w, h), 0.1, 50.0)
    ms = []
    for i in range(views):
        view = np.eye(4)
        view[0, 3] = 0.3 * i
        view[1, 3] = -0.2 * i
        ms.append(camera.total_matrix(P, view))
    sizes = rng.uniform(0.5, 6.0, n).astype(np.float32)
    sizes[::17] = np.nan
    return xyz, np.stack(ms).astype(np.float32), sizes


def _edge_scene(n=300, views=2, seed=4):
    """Orthographic views (clip w = 1: ndc = clip) of points, some of
    them exactly at ndc x = +-1 and y = +-1 (x = 1 puts the centre one
    past the last column, y = -1 one past the last row), a third of them
    on another point's position (exact depth ties), with
    :data:`EDGE_SIZES` cycled."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.05, 1.05, size=(n, 3)).astype(np.float32)
    xyz[:, 2] = rng.uniform(-1.0, 1.0, n)
    xyz[0:15, 0] = 1.0
    xyz[15:30, 1] = -1.0
    xyz[30:45, 0] = -1.0
    xyz[45:60, 1] = 1.0
    xyz[60:75, :2] = (1.0, -1.0)
    xyz[200:] = xyz[rng.integers(0, 200, n - 200)]
    ms = []
    for i in range(views):
        t = np.eye(4, dtype=np.float32)
        t[2, 3] = 0.1 * i     # clip z (and depth) moves per view
        ms.append(t)
    sizes = EDGE_SIZES[np.arange(n) % len(EDGE_SIZES)]
    return xyz, np.stack(ms), sizes


def _assert_levels_equal(got, want):
    assert len(got) == len(want)
    for (it, dt), (ij, dj) in zip(got, want):
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def _both(xyz, ms, hw, levels, method, kw):
    """JAX's and the port's pyramids of the same call (the pool JAX's
    training uses for 'sort', the serving path's for 'pallas')."""
    pool = "exact" if method == "sort" else "packed"
    jkw = dict(kw)
    if jkw.get("point_sizes") is not None:
        jkw["point_sizes"] = jnp.asarray(jkw["point_sizes"])
    want = JR.rasterize_pyramid_pooled(jnp.asarray(xyz), jnp.asarray(ms),
                                       hw, levels, method=method,
                                       pool_impl=pool, **jkw)
    got = R.rasterize_pyramid_pooled(torch.from_numpy(xyz),
                                     torch.from_numpy(ms), hw, levels,
                                     method=method, pool_impl=pool, **kw)
    return got, want


@pytest.mark.parametrize("kind", ["plain", "sizes", "relative"])
@pytest.mark.parametrize("views", [1, 3])
@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("method", ["sort", "pallas"])
def test_splat_twin_matches_jax(method, radius, views, kind):
    """``rasterize_pyramid_pooled`` (3 levels) and ``rasterize_batch``
    with splats, bit-equal to JAX's at every level."""
    hw = (32, 48)
    xyz, ms, sizes = _persp_scene(400, views, hw)
    kw = {"point_radius": radius}
    if kind != "plain":
        kw["point_sizes"] = sizes
    if kind == "relative":
        kw.update(relative_size=True, min_point_size=1.5)
    got, want = _both(xyz, ms, hw, 3, method, kw)
    _assert_levels_equal(got, want)
    index = got[0][0]
    assert 0.05 < float((index >= 0).float().mean()) < 0.98  # some empty
    level0 = R.rasterize_batch(torch.from_numpy(xyz), torch.from_numpy(ms),
                               *hw, method=method, **kw)
    _assert_levels_equal([level0], want[:1])


@pytest.mark.parametrize("relative", [False, True])
@pytest.mark.parametrize("min_point_size", [1.0, 3.0])
@pytest.mark.parametrize("method", ["sort", "pallas"])
def test_splat_edge_cases_match_jax(method, min_point_size, relative):
    """Off-frame centres, exact ties and every kind of odd size, r = 2,
    bit-equal to JAX at 2 levels; a point whose centre is one past the
    frame wins pixels of the frame's last column or row."""
    hw = (16, 24)
    xyz, ms, sizes = _edge_scene()
    kw = dict(point_radius=2, point_sizes=sizes, relative_size=relative,
              min_point_size=min_point_size)
    got, want = _both(xyz, ms, hw, 2, method, kw)
    _assert_levels_equal(got, want)
    index = got[0][0]
    edge = set(index[:, :, -1].reshape(-1).tolist()) \
        | set(index[:, -1, :].reshape(-1).tolist())
    assert edge & set(range(0, 30)) | edge & set(range(60, 75))
    # the plain radius (every size 2r+1) and z-scaled sizes alone too
    for kw in (dict(point_radius=1),
               dict(point_radius=2, relative_size=True,
                    min_point_size=min_point_size)):
        _assert_levels_equal(*_both(xyz, ms, hw, 2, method, kw))


@pytest.mark.parametrize("method", ["sort", "pallas"])
def test_sizes_with_radius_zero_run_k1_k5(method, monkeypatch):
    """With r = 0 JAX's offsets are (0, 0) alone: per-point and z-scaled
    sizes change nothing, and the port runs K1's or K5's twin, never the
    splat."""
    xyz, ms, sizes = _persp_scene(400, 2, (32, 48))
    plain = R.rasterize_pyramid_pooled(
        torch.from_numpy(xyz), torch.from_numpy(ms), (32, 48), 2,
        method=method, pool_impl="exact" if method == "sort" else "packed")

    def refuse(*a, **k):
        raise AssertionError("zbuffer_splat ran with point_radius 0")

    monkeypatch.setattr(RK, "zbuffer_splat", refuse)
    kw = dict(point_radius=0, point_sizes=sizes, relative_size=True,
              min_point_size=3.0)
    got, want = _both(xyz, ms, (32, 48), 2, method, kw)
    _assert_levels_equal(got, want)
    for (ig, dg), (ip, dp) in zip(got, plain):
        assert torch.equal(ig, ip) and torch.equal(dg, dp)


def test_twin_matches_pallas_splat_interpret(monkeypatch):
    """At one shape the twin against ``_rasterize_batch_pallas_splat``
    itself: the ``[B, N*K]`` expansion packed and z-buffered by
    ``zbuffer_pallas2`` (interpret mode), the path K6's kernel serves on
    the TPU."""
    xyz, ms, sizes = _persp_scene(600, 2, (24, 40), seed=7)
    monkeypatch.setattr(JRP, "zbuffer_pallas2",
                        functools.partial(JRP.zbuffer_pallas2,
                                          interpret=True))
    ij, dj = JR._rasterize_batch_pallas_splat(
        jnp.asarray(xyz), jnp.asarray(ms), 24, 40, 2, None,
        jnp.asarray(sizes), True, 1.0)
    (it, dt), = RK.zbuffer_splat(torch.from_numpy(xyz), torch.from_numpy(ms),
                                 24, 40, 1, "pallas", "packed", 2,
                                 point_sizes=sizes, relative_size=True)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def _kernel_reach(rad_inputs, radius):
    """``splat_reach`` of ``csrc/zbuffer.cu`` in numpy float32: NaN-
    propagating max/min written as the kernel writes them, the largest k
    <= r with ``rad >= thr[k]``."""
    base, cz, relative, min_size = rad_inputs
    f = np.float32

    def nan_max(a, b):
        return np.where((a > b) | (a != a), a, b)

    def nan_min(a, b):
        return np.where((a < b) | (a != a), a, b)

    size = base
    if relative:
        size = nan_max(f(min_size), base / nan_max(cz, f(1e-6)))
    size = nan_min(size, f(2 * radius + 1))
    rad = (size - f(1)) * f(0.5)
    k = np.zeros(rad.shape, np.int64)
    for j in range(1, RK.MAX_SPLAT_RADIUS + 1):
        k = np.where((j <= radius) & (rad >= f(j - 1e-4)), j, k)
    return k


@pytest.mark.parametrize("relative", [False, True])
def test_kernel_square_rule_equals_jax_offsets(relative):
    """The kernel covers the square of half-width ``splat_reach`` around
    the centre instead of testing each offset: for every (view, point,
    offset) of the edge scene the expansion's test (JAX's) agrees."""
    xyz, ms, sizes = _edge_scene()
    radius, (h, w) = 2, (16, 24)
    pix, _, valid = RK.splat_expand(torch.from_numpy(xyz),
                                    torch.from_numpy(ms), h, w, radius,
                                    sizes, relative, 3.0)
    _, _, cz = R.project_points(torch.from_numpy(xyz), torch.from_numpy(ms),
                                return_clip_z=True)
    k = _kernel_reach((np.broadcast_to(sizes, cz.shape), cz.numpy(),
                       relative, 3.0), radius)
    ndc = R.project_points(torch.from_numpy(xyz), torch.from_numpy(ms))[0]
    u = torch.floor(w * (ndc[..., 0] + 1.0) * 0.5).to(torch.int32).numpy()
    v = torch.floor(h * (1.0 - ndc[..., 1]) * 0.5).to(torch.int32).numpy()
    n, copies = xyz.shape[0], []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            inside = valid.numpy() & (u + dx >= 0) & (u + dx < w) \
                & (v + dy >= 0) & (v + dy < h)
            copies.append(inside & (max(abs(dy), abs(dx)) <= k))
    np.testing.assert_array_equal(pix.numpy() < h * w,
                                  np.concatenate(copies, axis=-1))
    assert pix.shape[-1] == 25 * n and set(np.unique(k)) >= {0, 1, 2}


def test_splat_refusals():
    xyz, ms, sizes = (torch.from_numpy(a) for a in _persp_scene(50, 1,
                                                                (8, 8)))
    with pytest.raises(ValueError, match="point_radius"):
        RK.zbuffer_splat(xyz, ms, 8, 8, 1, "sort", "exact",
                         RK.MAX_SPLAT_RADIUS + 1)
    with pytest.raises(ValueError, match="point_radius"):
        R.rasterize_batch(xyz, ms, 8, 8, point_radius=-1)
    with pytest.raises(ValueError, match="sizes"):
        R.rasterize_batch(xyz, ms, 8, 8, point_radius=1,
                          point_sizes=sizes[:10])
    with pytest.raises(NotImplementedError, match="item 9"):
        R.rasterize_batch(xyz, ms, 8, 8, point_radius=1,
                          ndc_jitter=torch.zeros(50, 2))
    with pytest.raises(RuntimeError, match="no kernel"):
        RK.zbuffer_splat(xyz.to("meta"), ms.to("meta"), 8, 8, 1, "sort",
                         "exact", 1)


@pytest.mark.parametrize("activation", ["none", "sigmoid"])
def test_sample_point_texture_matches_jax(activation):
    """The plain gather through a splatted index map (points winning
    several pixels of one image): the forward, and the backward, which
    sums every pixel a point won, against JAX's vjp."""
    xyz, ms, _ = _persp_scene(400, 2, (32, 48))
    index = R.rasterize_batch(torch.from_numpy(xyz), torch.from_numpy(ms),
                              32, 48, point_radius=2)[0]
    ids, counts = np.unique(index[0].numpy(), return_counts=True)
    assert counts[ids >= 0].max() > 1          # duplicates in one image
    rng = np.random.default_rng(0)
    table = rng.normal(size=(400, 8)).astype(np.float32)
    g = rng.normal(size=(*index.shape, 8)).astype(np.float32)
    want, vjp = jax.vjp(lambda t: JT.sample_point_texture(
        t, jnp.asarray(index.numpy()), activation), jnp.asarray(table))
    (want_g,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(table).requires_grad_()
    got = T.sample_point_texture(t, index, activation)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-7)
    scale = float(np.abs(want_g).max())
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g), rtol=1e-6,
                               atol=1e-6 * scale)


# ---------------------------------------------------------------------------
# The training step, the renderer and the CLI
# ---------------------------------------------------------------------------

N, B, HW = 1500, 2, (32, 32)


@pytest.fixture(scope="module", autouse=True)
def native_cpu_convs():
    """oneDNN's CPU convolution backward loses precision on caffe-scaled
    VGG inputs (tests/test_torch_train.py): off in this module."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _train_batch():
    rng = np.random.default_rng(5)
    xyz = rng.uniform(-2, 2, size=(N, 3)).astype(np.float32)
    xyz[:, 2] = rng.uniform(-5.0, -1.0, N)
    h, w = HW
    K = np.array([[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]])
    P = camera.gl_projection(K, (w, h), 0.1, 50.0)
    ms = []
    for i in range(B):
        view = np.eye(4)
        view[0, 3] = 0.2 * i
        ms.append(camera.total_matrix(P, view))
    sizes = rng.uniform(1.0, 5.0, N).astype(np.float32)
    sizes[::23] = np.nan
    return xyz, {"total_m": np.stack(ms).astype(np.float32),
                 "target": rng.uniform(size=(B, h, w, 3)).astype(
                     np.float32)}, sizes


@pytest.mark.parametrize("fmt,with_sizes", [(P3, False), (PS2, True)])
def test_first_splat_step_matches_jax(fmt, with_sizes, tmp_path):
    """The first step's loss (rtol 1e-4) and gradients from one JAX-
    written ``TrainState``: ``uv_1d_p3`` (r = 1, 'sort') and ``uv_1d_ps2``
    (z-scaled, capped at r = 2) with manifest sizes in the batch."""
    cfg_j = JTP.config_from_dict({"input_format": fmt}, crop_size=HW)
    cfg = TP.config_from_dict({"input_format": fmt}, crop_size=HW)
    assert (cfg.point_radius, cfg.relative_point_size) == (
        cfg_j.point_radius, cfg_j.relative_point_size) == (
        (1, False) if fmt == P3 else (2, True))
    state, net = JTP.create_state(jax.random.PRNGKey(0), cfg_j, n_points=N,
                                  net=FlaxUNet(**SMALL))
    path = str(tmp_path / "ckpt")
    JCK.save_checkpoint(path, state, config={"input_format": fmt})
    vgg = JV.random_vgg_params(0)
    xyz, batch, sizes = _train_batch()
    ps = sizes if with_sizes else None
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params, texture):
        out, _, _ = JTP._forward(
            net, cfg_j, params, state.batch_stats, texture,
            jnp.asarray(xyz), jb["total_m"], train=True,
            point_sizes=None if ps is None else jnp.asarray(ps))
        return JTP._losses(cfg_j, vgg, out, jb)[0]

    loss_j, grads = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(
        state.params, state.texture)
    want = JCK._flatten({"params": grads[0], "texture": grads[1]})

    tstate = TP.state_from_flat(CK.load_checkpoint(path)[0], "cpu")
    tvgg = CV.vgg_params_from_numpy(
        [(np.asarray(w), np.asarray(b)) for w, b in vgg], "cpu")
    tnet = UNet(**SMALL)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if ps is not None:
        tb["point_sizes"] = torch.from_numpy(ps)
    txyz = torch.from_numpy(xyz)
    metrics, _, _, g_flat, g_tex = TP._loss_and_grads(
        tnet, cfg, tvgg, tstate, txyz, tb, False)
    np.testing.assert_allclose(float(metrics["loss"]), float(loss_j),
                               rtol=1e-4)
    got = {"params/" + k.replace(".", "/"): g.numpy()
           for k, g in tstate.layout.views(g_flat).items()}
    got["texture"] = g_tex.numpy()
    assert set(got) == set(want)
    s64 = dataclasses.replace(
        tstate, flat_params=tstate.flat_params.double(),
        batch_stats={k: v.double() for k, v in tstate.batch_stats.items()},
        texture=tstate.texture.double())
    b64 = dict(tb, target=tb["target"].double())
    _, _, _, g64, t64 = TP._loss_and_grads(
        tnet, cfg, [(w.double(), b.double()) for w, b in tvgg], s64, txyz,
        b64, False)
    truth = {"params/" + k.replace(".", "/"): g.numpy()
             for k, g in tstate.layout.views(g64).items()}
    truth["texture"] = t64.numpy()

    def off(g, key):
        return float(np.abs(np.asarray(g) - truth[key]).max()
                     / np.abs(truth[key]).max())

    for key, g in got.items():
        # 2e-4 * max|g|, or more where JAX's own float32 gradient is
        # further than 1e-4 * max|g| from the float64 run: the port may be
        # 1.25x as far from it, so 2.25x JAX's distance bounds the two
        # results' distance (ps2 with sizes: JAX 1.5e-3 off, the port
        # 5e-4)
        atol = max(GRAD_ATOL, 2.25 * off(want[key], key))
        np.testing.assert_allclose(g, want[key], rtol=0, atol=atol * float(
            np.abs(want[key]).max()), err_msg=key)
    port, jax_err = (max(off(grads[k], k) for k in truth)
                     for grads in (got, want))
    assert port <= 1.25 * jax_err, (port, jax_err)
    # the whole step runs, on the same loss
    _, m = TP.make_train_step(tnet, cfg, tvgg)(tstate, txyz, tb)
    np.testing.assert_allclose(float(m["loss"]), float(metrics["loss"]),
                               rtol=1e-6)


@pytest.fixture(scope="module")
def p3_scene(tmp_path_factory):
    """A tiny scene on disk with a ``point_sizes`` manifest, and one JAX
    ``uv_1d_p3`` checkpoint of it ('pallas', the serving method)."""
    root = tmp_path_factory.mktemp("splat_scene")
    rng = np.random.default_rng(2)
    n, w, h = 3000, 48, 32
    xyz = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    xyz[:, 2] = rng.uniform(-6.0, -2.0, n)
    JIO.write_ply(str(root / "pc.ply"), xyz,
                  rng.uniform(0, 1, size=(n, 3)).astype(np.float32))
    K = np.array([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]])
    np.savetxt(root / "cam.txt", np.vstack([[w, h, 0], K]))
    poses = []
    for i in range(2):
        pose = np.eye(4)
        pose[0, 3] = 0.2 * i
        poses.append(pose)
    np.savetxt(root / "poses.dat", np.stack(poses).reshape(-1, 4))
    sizes = np.where(np.arange(n) % 3 == 0, 3.0, 1.0).astype(np.float32)
    sizes[::101] = np.nan
    np.save(root / "sizes.npy", sizes)
    with open(root / "scene.yaml", "w") as f:
        f.write(f"viewport_size: [{w}, {h}]\npointcloud: pc.ply\n"
                "intrinsic_matrix: cam.txt\nview_matrix: poses.dat\n"
                "point_sizes: sizes.npy\n")
    config = {"raster_method": "pallas", "conv_impl": "xla",
              "input_format": P3}
    cfg = JTP.config_from_dict(config, crop_size=(32, 32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTP, "UNet", functools.partial(FlaxUNet, **SMALL))
        state, _ = JTP.create_state(jax.random.PRNGKey(0), cfg, n_points=n)
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 2.0, a.shape).astype(np.float32),
        state.batch_stats)
    state = state.replace(batch_stats=stats)
    ckpt = str(root / "ckpt_p3")
    JCK.save_checkpoint(ckpt, state, config=config)
    return str(root / "scene.yaml"), ckpt, poses, root


def test_p3_renderer_matches_read_tpu(p3_scene):
    """A ``uv_1d_p3`` checkpoint over a scene with manifest sizes: the
    port's frames against ``read_tpu``'s renderer."""
    scene, ckpt, poses, _ = p3_scene
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTP, "UNet", functools.partial(FlaxUNet, **SMALL))
        jr = JaxRenderer(scene, ckpt)
    tr = TR.NeuralRenderer(scene, ckpt, device="cpu")
    assert tr.cfg.point_radius == jr.cfg.point_radius == 1
    assert tr.point_sizes is not None and jr.point_sizes is not None
    for pose in poses:
        np.testing.assert_allclose(tr.infer(pose), jr.infer(pose),
                                   **FRAME_TOL)


def test_set_point_radius_equals_a_renderer_built_at_it(p3_scene):
    """``set_point_radius`` gives the frames of a renderer whose
    checkpoint says that radius; it clamps at 0 and keeps the config when
    the radius is the current one."""
    scene, ckpt, poses, root = p3_scene
    flat, meta = CK.load_checkpoint(ckpt)
    p1 = str(root / "ckpt_p1")
    CK.save_checkpoint(p1, flat, config=dict(
        meta["config"], input_format=P3.replace("p3", "p1")))
    r3 = TR.NeuralRenderer(scene, ckpt, device="cpu")
    r1 = TR.NeuralRenderer(scene, p1, device="cpu")
    assert r1.cfg.point_radius == 0
    want3, want1 = r3.infer(poses[1]), r1.infer(poses[1])
    assert float(np.abs(want3 - want1).max()) > 0
    cfg = r1.cfg
    r1.set_point_radius(0)
    assert r1.cfg is cfg
    r1.set_point_radius(1)
    np.testing.assert_array_equal(r1.infer(poses[1]), want3)
    r3.set_point_radius(-2)
    assert r3.cfg.point_radius == 0
    np.testing.assert_array_equal(r3.infer(poses[1]), want1)


def test_cli_trains_a_p3_format(p3_scene, tmp_path, monkeypatch):
    """``python -m read_tpu_torch.train --input-format uv_1d_p3...`` on
    the scene with manifest sizes: every train step and val batch
    splats, with the manifest's sizes; the checkpoint renders at r =
    1."""
    scene, _, _, root = p3_scene
    paths = root / "paths.json"
    with open(paths, "w") as f:
        json.dump({"datasets": {"toy": {
            "scene_path": scene, "target_path": str(root / "targets"),
            "target_name": "{label:06d}.png"}}}, f)
    os.makedirs(root / "targets", exist_ok=True)
    from read_tpu_torch.data import image_io
    for i in range(2):
        image_io.imwrite(str(root / "targets" / f"{i:06}.png"),
                         np.full((32, 48, 3), 40 * i, np.uint8))
    calls = []
    real = RK.zbuffer_splat

    def counted(*a, **k):
        bound = inspect.signature(real).bind(*a, **k)
        calls.append(bound.arguments.get("point_sizes") is not None)
        return real(*a, **k)

    monkeypatch.setattr(RK, "zbuffer_splat", counted)
    monkeypatch.setattr(TP, "UNet", functools.partial(UNet, **SMALL))
    config = tmp_path / "config.json"
    with open(config, "w") as f:
        json.dump({"paths_file": str(paths), "input_format": P3,
                   "crop_size": "32x32", "batch_size": 1,
                   "criterion": "huber_only", "splitter": "split_by_step",
                   "splitter_args": {"val_step": 2}, "log_freq": 100,
                   "headless_platform": "cpu",
                   "train_dataset_args": {"inner_batch": 1,
                                          "num_samples": 1,
                                          "random_zoom": [1.0, 1.5],
                                          "random_shift": [-1.0, 1.0]}},
                  f)
    save = tmp_path / "logs"
    rc = TRAIN.main(["--config", str(config), "--epochs", "1",
                     "--save-dir", str(save)])
    assert rc == 0
    (exp,) = os.listdir(save)
    with open(save / exp / "history.json") as f:
        (hist,) = json.load(f)
    assert np.isfinite([hist["train_loss"], hist["val_loss"]]).all()
    steps = len(hist["train_timing"]["step_ms"])
    assert steps >= 1 and len(calls) == steps + hist["val_timing"][
        "batches"] and all(calls)
    best = save / exp / "checkpoints" / "best_toy"
    r = TR.NeuralRenderer(scene, str(best), device="cpu")
    assert r.cfg.point_radius == 1
