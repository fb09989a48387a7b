"""Point dropout and screen-space jitter: the port against read_tpu, on the CPU.

- The cores of ``ops.augment`` (``drop_points_from``,
  ``jitter_offsets_from``, ``perturb_pixels_from``) given the uniforms
  ``jax.random.uniform`` draws from JAX's key are bit-equal to
  ``read_tpu.ops.augment``'s functions of that key.
- The wrappers' draws from a ``torch.Generator``: rate, range and
  reproducibility (the stream itself is PyTorch's, not JAX's).
- ``rasterize_pyramid_pooled`` with ``ndc_jitter`` (the kernels' twins
  on the CPU) is bit-equal at every level to JAX's, for ``sort`` and
  ``pallas`` x the ``exact`` and ``packed`` pools, at r = 0, r = 1 and
  with per-point sizes, with points jittered across every edge of the
  frame (centres at negative u and v, and one or more past the last
  column and row) and points outside the clip cube jittered back over
  the frame, which stay out.
- The augmented training step (``drop_points 0.1``, ``perturb_points
  1.0``) from a JAX-written ``TrainState`` with JAX's own draws for that
  step injected: pyramids bit-equal, loss within 1e-6 relative, every
  gradient within ``2e-4 x max|g|`` (``tests/test_torch_train.py`` says
  why a float32 step holds no tighter); the default draws come from a
  generator seeded by the step, the same on every run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from read_tpu.criterions import vgg as JV
from read_tpu.models.unet import UNet as FlaxUNet
from read_tpu.ops import augment as JA
from read_tpu.ops import rasterize as JR
from read_tpu.pipelines import texture_pipeline as JTP
from read_tpu.scene import camera
from read_tpu.utils import ckpt as JCK
from read_tpu_torch.models.unet import UNet
from read_tpu_torch.ops import augment as A
from read_tpu_torch.ops import rasterize as R
from read_tpu_torch.ops import rasterize_kernels as RK
from read_tpu_torch.pipelines import texture_pipeline as TP
from read_tpu_torch.utils import ckpt as CK
from read_tpu_torch.utils import convert as CV

GRAD_ATOL = 2e-4            # x max|g|, tests/test_torch_train.py


@pytest.fixture(scope="module", autouse=True)
def native_cpu_convs():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _keys(step):
    """JAX's per-step keys: ``split(fold_in(PRNGKey(0), step))``."""
    key = jax.random.fold_in(jax.random.PRNGKey(0), step)
    return jax.random.split(key)


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
def test_drop_points_core_matches_jax(rate):
    n = 5000
    xyz = np.random.default_rng(1).normal(size=(n, 3)).astype(np.float32)
    kd, _ = _keys(3)
    want = np.asarray(JA.drop_points(kd, jnp.asarray(xyz), rate))
    u = np.asarray(jax.random.uniform(kd, (n, 1)))
    got = A.drop_points_from(torch.from_numpy(u), torch.from_numpy(xyz),
                             rate)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("amount,hw", [(1.0, (32, 48)), (3.5, (368, 1216))])
def test_jitter_core_matches_jax(amount, hw):
    n = 4000
    _, kp = _keys(5)
    u = torch.from_numpy(np.asarray(jax.random.uniform(kp, (n, 2))))
    want = np.asarray(JA.pixel_jitter_offsets(kp, n, amount, *hw))
    np.testing.assert_array_equal(
        A.jitter_offsets_from(u, amount, *hw).numpy(), want)
    ndc = np.random.default_rng(2).uniform(-1, 1, (n, 3)).astype(np.float32)
    want = np.asarray(JA.perturb_pixels(kp, jnp.asarray(ndc), amount, *hw))
    got = A.perturb_pixels_from(u, torch.from_numpy(ndc), amount, *hw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_draws_rate_range_and_reproducibility():
    n, rate, amount, (h, w) = 200_000, 0.1, 2.0, (64, 128)
    xyz = torch.zeros((n, 3))
    dropped = A.drop_points(torch.Generator().manual_seed(1), xyz, rate)
    frac = float((dropped[:, 0] == 1e9).float().mean())
    assert abs(frac - rate) < 0.005, frac
    assert torch.equal((dropped == 1e9).all(1), (dropped == 1e9).any(1))
    assert A.drop_points(torch.Generator(), xyz, 0.0) is xyz
    off = A.pixel_jitter_offsets(torch.Generator().manual_seed(2), n,
                                 amount, h, w, device="cpu")
    px = off * torch.tensor([w / 2.0, h / 2.0])   # offsets in pixels
    assert float(px.abs().max()) <= amount / 2
    assert float(px.abs().max()) > 0.99 * amount / 2
    assert abs(float(px.mean())) < 0.01
    again = A.pixel_jitter_offsets(torch.Generator().manual_seed(2), n,
                                   amount, h, w, device="cpu")
    assert torch.equal(off, again)
    ndc = torch.rand((n, 3), generator=torch.Generator().manual_seed(3))
    moved = A.perturb_pixels(torch.Generator().manual_seed(4), ndc, amount,
                             h, w)
    assert torch.equal(moved[:, 2], ndc[:, 2])
    assert A.perturb_pixels(torch.Generator(), ndc, 0.0, h, w) is ndc


def _edge_scene(n, views, seed=7):
    """Orthographic views (clip w = 1) of ``n`` points, a third of them
    within a few pixels of the frame's four edges, a tenth just outside
    the clip cube in x or y, a tenth at exact depth ties; and jitter of up
    to 6 pixels (``jitter_offsets_from``), so centres land at negative u
    and v and one or more past the last column and row."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    k = n // 3
    side = rng.integers(0, 4, k)
    edge = rng.uniform(0.9, 1.0, k).astype(np.float32)
    xyz[:k, 0] = np.where(side == 0, -edge, np.where(side == 1, edge,
                                                     xyz[:k, 0]))
    xyz[:k, 1] = np.where(side == 2, -edge, np.where(side == 3, edge,
                                                     xyz[:k, 1]))
    out = slice(k, k + n // 10)          # outside the cube: never drawn
    xyz[out, rng.integers(0, 2)] = rng.choice([-1.0, 1.0]) * rng.uniform(
        1.0001, 1.02, n // 10)
    ties = slice(k + n // 10, k + n // 5)
    xyz[ties] = xyz[rng.integers(0, k, ties.stop - ties.start)]
    xyz[:, 2] = np.round(xyz[:, 2], 2)   # more exact depth ties
    ms = []
    for i in range(views):
        t = np.eye(4, dtype=np.float32)
        t[0, 3] = 0.01 * i
        ms.append(t)
    return xyz, np.stack(ms), rng


@pytest.mark.parametrize("case", ["r0", "r1", "sizes"])
@pytest.mark.parametrize("pool_impl", ["exact", "packed"])
@pytest.mark.parametrize("method", ["sort", "pallas"])
def test_jittered_pyramid_matches_jax(method, pool_impl, case):
    hw, views = (32, 48), 2
    xyz, ms, rng = _edge_scene(3000, views)
    jit = A.jitter_offsets_from(
        torch.from_numpy(rng.uniform(size=(3000, 2)).astype(np.float32)),
        12.0, *hw).numpy()
    kw = {}
    if case != "r0":
        kw["point_radius"] = 1
    if case == "sizes":
        kw["point_sizes"] = rng.uniform(0.5, 3.5, 3000).astype(np.float32)
    lj = JR.rasterize_pyramid_pooled(
        jnp.asarray(xyz), jnp.asarray(ms), hw, 4, method=method,
        ndc_jitter=jnp.asarray(jit), pool_impl=pool_impl,
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    lt = R.rasterize_pyramid_pooled(
        torch.from_numpy(xyz), torch.from_numpy(ms), hw, 4, method=method,
        ndc_jitter=torch.from_numpy(jit), pool_impl=pool_impl,
        **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    for i, ((ij, dj), (it, dt)) in enumerate(zip(lj, lt)):
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij),
                                      err_msg=f"level {i}")
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj),
                                      err_msg=f"level {i}")
    # the jitter moved something, and points outside the cube stay out
    # (view 0 is the identity; view 1's shift brings some of them in)
    plain = R.rasterize_pyramid_pooled(
        torch.from_numpy(xyz), torch.from_numpy(ms), hw, 4, method=method,
        pool_impl=pool_impl,
        **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    assert not torch.equal(plain[0][0], lt[0][0])
    outside = set(range(1000, 1300))
    assert not outside & set(lt[0][0][0].unique().tolist())


def test_jitter_leaves_depth_and_validity():
    """The packed z-buffer's level-0 depth (what K1's pass re-projects
    for its winners) is each winner's unjittered depth, and a jitter
    that moves every point off the frame empties it."""
    xyz, ms, rng = _edge_scene(2000, 1)
    jit = torch.from_numpy(rng.uniform(-0.05, 0.05, (2000, 2)).astype(
        np.float32))
    (index, depth), = R.rasterize_pyramid_pooled(
        torch.from_numpy(xyz), torch.from_numpy(ms), (40, 40), 1,
        method="pallas", ndc_jitter=jit)
    ndc, valid = R.project_points(torch.from_numpy(xyz),
                                  torch.from_numpy(ms))
    want = ((ndc[0, :, 2] + 1.0) * 0.5)[index.clamp(min=0)]
    hit = index >= 0
    assert bool(hit.any())
    assert torch.equal(depth[hit], want[hit])
    away = torch.full((2000, 2), 2.5)
    (index, depth), = R.rasterize_pyramid_pooled(
        torch.from_numpy(xyz), torch.from_numpy(ms), (40, 40), 1,
        method="sort", ndc_jitter=away)
    assert bool((index == -1).all()) and bool((depth == 0).all())


def test_jitter_refusals():
    xyz = torch.zeros((10, 3))
    ms = torch.eye(4)[None]
    with pytest.raises(ValueError, match="jitter"):
        RK.zbuffer_pyramid(xyz, ms, 8, 8, 1, jitter=torch.zeros(9, 2))
    with pytest.raises(TypeError, match="jitter"):
        RK.zbuffer_splat(xyz, ms, 8, 8, 1, "sort", "exact", 1,
                         jitter=torch.zeros(10, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="devices"):
        RK.zbuffer(xyz, ms, 8, 8, jitter=torch.zeros(10, 2, device="meta"))


# --------------------------------------------------------------------------
# The augmented training step against JAX's
# --------------------------------------------------------------------------

N, B, HW, STEP = 2000, 2, (32, 32), 4


def _scene():
    rng = np.random.default_rng(5)
    xyz = rng.uniform(-2, 2, size=(N, 3)).astype(np.float32)
    xyz[:, 2] -= 6.0
    h, w = HW
    K = np.array([[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]])
    P = camera.gl_projection(K, (w, h), 0.1, 50.0)
    ms = []
    for i in range(B):
        view = np.eye(4)
        view[0, 3] = 0.2 * i
        ms.append(camera.total_matrix(P, view))
    return xyz, {"total_m": np.stack(ms).astype(np.float32),
                 "target": rng.uniform(size=(B, h, w, 3)).astype(np.float32)}


AUG = dict(drop_points=0.1, perturb_points=1.0)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """A JAX state at step ``STEP``, JAX's augmented gradients, loss and
    pyramid of that step, and its draws."""
    cfg = JTP.PipelineConfig(crop_size=HW, **AUG)
    state, net = JTP.create_state(jax.random.PRNGKey(0), cfg, n_points=N,
                                  net=FlaxUNet(base_channel=8, num_res=1))
    state = state.replace(step=jnp.asarray(STEP, jnp.int32))
    path = str(tmp_path_factory.mktemp("aug") / "ckpt")
    JCK.save_checkpoint(path, state, config={})
    vgg = JV.random_vgg_params(0)
    xyz, batch = _scene()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    kd, kp = _keys(STEP)
    jxyz = JA.drop_points(kd, jnp.asarray(xyz), cfg.drop_points)
    jit = JA.pixel_jitter_offsets(kp, N, cfg.perturb_points, *HW)

    def loss_fn(params, texture):
        out, _, pyr = JTP._forward(net, cfg, params, state.batch_stats,
                                   texture, jxyz, jb["total_m"], train=True,
                                   ndc_jitter=jit)
        return JTP._losses(cfg, vgg, out, jb)[0], pyr

    (loss, pyr), grads = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(state.params, state.texture)
    _, m = JTP.make_train_step(net, cfg, vgg)(state, jnp.asarray(xyz), jb)
    levels = JR.rasterize_pyramid_pooled(jxyz, jb["total_m"], HW, 4,
                                         ndc_jitter=jit)
    return dict(path=path, xyz=xyz, batch=batch,
                vgg=[(np.asarray(w), np.asarray(b)) for w, b in vgg],
                grads=JCK._flatten({"params": grads[0],
                                    "texture": grads[1]}),
                loss=float(loss), step_loss=float(m["loss"]),
                levels=[np.asarray(ix) for ix, _ in levels],
                draws=(np.asarray(jax.random.uniform(kd, (N, 1))),
                       np.asarray(jax.random.uniform(kp, (N, 2)))))


def _jax_draws(ref):
    def draws(step, n, device):
        assert (step, n) == (STEP, N)
        return tuple(torch.from_numpy(u).to(device) for u in ref["draws"])
    return draws


def test_augmented_step_matches_jax(ref):
    cfg = TP.PipelineConfig(crop_size=HW, **AUG)
    net = UNet(base_channel=8, num_res=1)
    vgg = CV.vgg_params_from_numpy(ref["vgg"], "cpu")
    state = TP.state_from_flat(CK.load_checkpoint(ref["path"])[0], "cpu")
    assert state.step == STEP
    xyz = torch.from_numpy(ref["xyz"])
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    seen = []
    real = TP.R.rasterize_pyramid_pooled

    def spy(*a, **k):
        out = real(*a, **k)
        seen.append([ix for ix, _ in out])
        return out

    TP.R.rasterize_pyramid_pooled = spy
    try:
        xyz_a, jitter = TP.augment(cfg, state.step, xyz, _jax_draws(ref))
        metrics, _, _, g_flat, g_tex = TP._loss_and_grads(
            net, cfg, vgg, state, xyz_a, dict(batch, ndc_jitter=jitter),
            False)
    finally:
        TP.R.rasterize_pyramid_pooled = real
    for got, want in zip(seen[0], ref["levels"]):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(float(metrics["loss"]), ref["loss"],
                               rtol=1e-6)
    got = {"params/" + k.replace(".", "/"): g
           for k, g in state.layout.views(g_flat).items()}
    got["texture"] = g_tex[0]
    for key, g in got.items():
        want = ref["grads"][key]
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=GRAD_ATOL * float(np.abs(want).max()),
                                   err_msg=key)
    # the whole step with the injected draws gives JAX's step loss
    step = TP.make_train_step(net, cfg, vgg, draws=_jax_draws(ref))
    new, m = step(state, xyz, batch)
    np.testing.assert_allclose(float(m["loss"]), ref["step_loss"], rtol=1e-6)
    assert new.step == STEP + 1


def test_default_draws_repeat_and_change_by_step(ref):
    """The default draws: a generator seeded by the step, so a step
    repeats bit for bit and the next step draws anew."""
    cfg = TP.PipelineConfig(crop_size=HW, **AUG)
    xyz = torch.from_numpy(ref["xyz"])
    a = TP.augment(cfg, 7, xyz)
    b = TP.augment(cfg, 7, xyz)
    c = TP.augment(cfg, 8, xyz)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], c[1])
    frac = float((a[0][:, 0] == 1e9).float().mean())
    assert 0.05 < frac < 0.15
    bare = TP.augment(TP.PipelineConfig(crop_size=HW), 7, xyz)
    assert bare[0] is xyz and bare[1] is None
