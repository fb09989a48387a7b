"""read_tpu's last raster methods and its VGG ensemble in the port,
against read_tpu on the CPU.

(a) ``rasterize_batch`` and ``rasterize_pyramid_pooled`` (both pools, 3
    levels) for 'sort2', 'scatter' (K5's twin) and 'sort1q' (the
    quantized key's twin): r 0 and 1, 1 and 3 views, per-point and
    z-scaled sizes, the NDC jitter. Indices and depths bit-equal at every
    level, but for one fault of the reference that a test pins: JAX's
    'sort1q' splat reads its winner's depth from the ``[N*K]`` expansion's
    first offset copy (``rasterize.py:240`` on the array built at
    :389-393), 2.0 wherever that copy missed the frame or the point's
    size. There JAX's depth is 2.0 and the port's the winner's own depth
    (JAX's ``project_points``). The coarse levels are held to JAX's own
    pools (``_pool2x2_zbuffer``, ``_pool2x2_packed``) run on JAX's level
    0, corrected there: ``rasterize_pyramid_pooled`` is ``rasterize_batch``
    and those pools.
(b) 'sort1q' is a semantics of its own: pairs of points a few float32
    ulps apart in depth, the nearer with the higher id, fall in one
    depth bin (20 bits at 48x32), where 'sort1q' keeps the farther one
    and 'sort' the nearer; both bit-equal to JAX's, and they differ.
(c) Fewer than 8 depth bits raise as JAX's 'sort1q' does; the bits at
    the frame sizes of the bench.
(d) ``vgg_loss_ens`` against JAX's with JAX's K ``random_vgg_params``
    carried across (value, per item, gradient: ``tests/test_torch_losses.
    py``'s tolerances), JAX run op by op as the port runs: with the
    'pytorch' normalization XLA's jitted gradient of seed 1's network
    lies 1.1e-3 x max|g| from JAX's own eager one (a ReLU or an L1 term
    at its kink), the port 2.8e-7 x max|g| from the eager one.
(e) One 'vgg_ens' train step from one state (the port's, carried into
    JAX's ``TrainState``) on ``tests/test_torch_train.py``'s scene, with
    its bounds: first-step loss rtol 1e-3, gradients atol 2e-4 x max|g|
    and no further from the port's float64 step than JAX's float32 ones
    (x1.25); the eval step's metrics rtol 1e-4. The float32 step is
    ill-conditioned (that file's docstring): from other states (the seed
    2 state here, or 600 points at 48x32) the two float32 gradients part
    by 4.2-4.3e-4 x max|g| while the port stays the nearer to the float64
    one (1.9e-4 and 2.6e-4 against JAX's 3.5e-4 and 3.1e-4).
(f) ``--criterion vgg_ens`` with ``raster_method: sort1q`` through both
    train CLIs (``--eval --eval-all`` from one JAX-written checkpoint;
    per-view metrics rtol 1e-4; the port's K networks are JAX's seeds
    0..K-1 put in place of its ``torch.Generator`` draws, which the CLI
    seeds 0..K-1; K = 3 in both CLIs: ``vgg_ens_k`` in a config file is a
    key neither parser has, so it never reaches ``config_from_dict``), and
    ``--raster sort1q`` through both render CLIs (the PNGs within one
    level).

The UNet is ``base_channel=8, num_res=1`` and the ensemble of (d) and
(e) K = 2, to keep the JAX compiles few.
"""

import dataclasses
import functools
import json
import os
import sys

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from read_tpu import render as JRENDER
from read_tpu import train as JTRAIN
from read_tpu.criterions import vgg as JV
from read_tpu.models.unet import UNet as FlaxUNet
from read_tpu.ops import rasterize as JR
from read_tpu.pipelines import texture_pipeline as JTP
from read_tpu.scene import camera
from read_tpu.scene import io as JIO
from read_tpu.utils import ckpt as JCK
from read_tpu.utils import perform as JPERF
from read_tpu_torch import render as TR
from read_tpu_torch import train as TRAIN
from read_tpu_torch.criterions import vgg as V
from read_tpu_torch.models.unet import UNet
from read_tpu_torch.ops import rasterize as R
from read_tpu_torch.ops import rasterize_kernels as RK
from read_tpu_torch.pipelines import texture_pipeline as TP
from read_tpu_torch.utils import convert as CV

N, H, W, LEVELS = 600, 32, 48, 3
K_ENS = 2
K_CLI = 3       # both CLIs' K: a config file's vgg_ens_k never reaches them
SMALL = dict(base_channel=8, num_res=1)
GRAD_ATOL = 2e-4            # x max|g|, tests/test_torch_train.py
VALUE = dict(rtol=1e-4)     # tests/test_torch_losses.py
EVAL_KEYS = ("loss", "huber_loss", "vgg_loss", "psnr", "ssim")


@pytest.fixture(scope="module", autouse=True)
def native_cpu_convs():
    """PyTorch's own CPU convolution (oneDNN's backward is looser;
    ``tests/test_torch_train.py``)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _matrices(hw, views, focal=40.0):
    h, w = hw
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]])
    P = camera.gl_projection(K, (w, h), 0.1, 50.0)
    ms = []
    for i in range(views):
        view = np.eye(4)
        view[0, 3] = 0.3 * i
        ms.append(camera.total_matrix(P, view))
    return np.stack(ms).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(3)
    xyz = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    xyz[:, 2] -= 6.0
    return dict(
        xyz=xyz, ms=_matrices((H, W), 3),
        sizes=rng.uniform(0.5, 5.5, N).astype(np.float32),
        # z-scaled: sizes / clip z (4-8 here) from under 1 to over 3
        big=rng.uniform(1.0, 30.0, N).astype(np.float32),
        jitter=(rng.uniform(-1.0, 1.0, (N, 2)) * 3.0 / W).astype(
            np.float32))


# (label, point_radius, views, keyword arguments by scene key)
CASES = [("r0", 0, 1, {}),
         ("r0 B3 jitter", 0, 3, dict(ndc_jitter="jitter")),
         ("r1 z-scaled", 1, 1, dict(point_sizes="big", relative_size=True)),
         ("r1 B3 sizes jitter", 1, 3, dict(point_sizes="sizes",
                                          ndc_jitter="jitter"))]


def _kwargs(scene, kw, to):
    return {k: to(scene[v]) if isinstance(v, str) else v
            for k, v in kw.items()}


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("method", ["sort2", "scatter", "sort1q"])
def test_methods_match_read_tpu(scene, method, case):
    """(a) Index and depth bit-equal at every level, both pools; the
    'sort1q' splat's depth where JAX reads 2.0 is the winner's own."""
    _, r, b, kw = case
    xyz, ms = scene["xyz"], scene["ms"][:b]
    jkw = _kwargs(scene, kw, jnp.asarray)
    tkw = _kwargs(scene, kw, torch.from_numpy)
    ji, jd = (np.asarray(a) for a in JR.rasterize_batch(
        jnp.asarray(xyz), jnp.asarray(ms), H, W, r, method, **jkw))
    ti, td = R.rasterize_batch(torch.from_numpy(xyz), torch.from_numpy(ms),
                               H, W, r, method, **tkw)
    np.testing.assert_array_equal(ti.numpy(), ji)
    assert (ji >= 0).mean() > 0.2
    fault = jd == 2.0
    faulty = method == "sort1q" and r > 0
    if faulty:
        # the reference's fault, pinned: covered pixels at depth 2.0
        assert fault.any() and (ji[fault] >= 0).all()
        ndc, _ = jax.vmap(JR.project_points, in_axes=(None, 0))(
            jnp.asarray(xyz), jnp.asarray(ms))
        depth0 = (np.asarray(ndc)[..., 2] + np.float32(1.0)) \
            * np.float32(0.5)
        own = np.take_along_axis(depth0, np.maximum(ji, 0).reshape(b, -1),
                                 axis=1).reshape(ji.shape)
        jd = np.where(fault, own, jd)
    else:
        assert not fault.any()
    np.testing.assert_array_equal(_bits(td), _bits(jd))
    # JAX's rasterize_pyramid_pooled is rasterize_batch and these pools
    exact = [(ji, jd)]
    for _ in range(1, LEVELS):
        exact.append(JR._pool2x2_zbuffer(*exact[-1]))
    want = {"exact": exact, "packed": JR._pool2x2_packed(
        jnp.asarray(ji), jnp.asarray(jd), N, LEVELS)}
    for pool in ("exact", "packed"):
        got = R.rasterize_pyramid_pooled(
            torch.from_numpy(xyz), torch.from_numpy(ms), (H, W), LEVELS, r,
            method, pool_impl=pool, **tkw)
        assert len(got) == len(want[pool]) == LEVELS
        for lv, ((gi, gd), (wi, wd)) in enumerate(zip(got, want[pool])):
            np.testing.assert_array_equal(gi.numpy(), np.asarray(wi),
                                          err_msg=f"{pool} level {lv}")
            np.testing.assert_array_equal(_bits(gd), _bits(wd),
                                          err_msg=f"{pool} level {lv}")


def test_sort1q_keeps_the_least_id_within_a_depth_bin(scene):
    """(b) Near-duplicate pairs, the nearer one second: 'sort1q' and
    'sort' each bit-equal to JAX's, and 'sort1q' keeps the farther
    point wherever both share a bin."""
    rng = np.random.default_rng(11)
    base = rng.uniform(-2, 2, (N // 2, 3)).astype(np.float32)
    base[:, 2] -= 6.0
    # the second of a pair lies on the same ray, 1e-5 of the way nearer:
    # a few float32 ulps of depth, less than a bin of 2^-20 (N points in
    # one view: (a)'s shapes, so JAX's op-by-op programs are reused)
    near = (base * np.float32(1.0 - 1e-5)).astype(np.float32)
    xyz = np.stack([base, near], axis=1).reshape(-1, 3)
    ms = scene["ms"][:1]
    got = {}
    for method in ("sort", "sort1q"):
        ji, jd = (np.asarray(a) for a in JR.rasterize_batch(
            jnp.asarray(xyz), jnp.asarray(ms), H, W, 0, method))
        ti, td = R.rasterize_batch(torch.from_numpy(xyz),
                                   torch.from_numpy(ms), H, W, 0, method)
        np.testing.assert_array_equal(ti.numpy(), ji)
        np.testing.assert_array_equal(_bits(td), _bits(jd))
        got[method] = ti.numpy(), td.numpy()
    (i_s, d_s), (i_q, d_q) = got["sort"], got["sort1q"]
    differ = i_s != i_q
    assert differ.sum() > 0.3 * (i_s >= 0).sum()
    # there 'sort' kept the nearer (odd) point, 'sort1q' its farther twin
    assert (i_s[differ] % 2 == 1).all()
    np.testing.assert_array_equal(i_q[differ], i_s[differ] - 1)
    qq = RK.quant_bits(H * W)[1]
    assert ((d_q[differ] > d_s[differ])
            & (d_q[differ] - d_s[differ] < 1.0 / qq)).all()


@pytest.mark.parametrize("entry", ["batch r0", "batch r1", "zbuffer_quant"])
def test_sort1q_refuses_under_8_depth_bits(entry):
    """(c) 2048x4096 leaves 7 depth bits: the port raises JAX's
    ValueError before it allocates a frame; the bits at the bench's frame
    sizes and at the 8-bit edge."""
    assert RK.quant_bits(368 * 1216) == (12, 4095)
    assert RK.quant_bits(256 * 256)[0] == 14
    assert RK.quant_bits(2 ** 23 - 3)[0] == 8
    xyz, ms = np.zeros((4, 3), np.float32), _matrices((4, 4), 1)
    msg = "sort1q: only 7 depth bits for 8388608 pixels; use method='sort'"
    if entry == "zbuffer_quant":
        with pytest.raises(ValueError, match=msg):
            RK.zbuffer_quant(torch.from_numpy(xyz), torch.from_numpy(ms),
                             2048, 4096)
        return
    r = int(entry[-1])
    with pytest.raises(ValueError, match=msg):
        JR.rasterize_batch(jnp.asarray(xyz), jnp.asarray(ms), 2048, 4096,
                           r, "sort1q")
    with pytest.raises(ValueError, match=msg):
        R.rasterize_batch(torch.from_numpy(xyz), torch.from_numpy(ms), 2048,
                          4096, r, "sort1q")


@pytest.fixture(scope="module")
def jax_vgg():
    """JAX's ``random_vgg_params(seed)`` for seeds 0..2, as numpy."""
    return [[(np.asarray(w), np.asarray(b)) for w, b in
             JV.random_vgg_params(seed)] for seed in range(K_CLI)]


@pytest.mark.parametrize("kw", [dict(), dict(partialconv=True),
                                dict(backend="pytorch")],
                         ids=["caffe", "partialconv", "pytorch"])
def test_vgg_loss_ens_matches_jax(jax_vgg, kw):
    """(d) Value, per item and d loss / d pred of the K-network mean."""
    rng = np.random.default_rng(2)
    pred = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    target = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    target[:, :4] = 0.0                   # a masked band for partialconv
    jp = [[(jnp.asarray(w), jnp.asarray(b)) for w, b in p]
          for p in jax_vgg[:K_ENS]]
    tp = [CV.vgg_params_from_numpy(p, "cpu") for p in jax_vgg[:K_ENS]]

    def jax_loss(p, per_item=False):
        return JV.vgg_loss_ens(jp, p, jnp.asarray(target), per_item=per_item,
                               **kw)

    want, want_g = jax.value_and_grad(jax_loss)(jnp.asarray(pred))
    want_items = jax_loss(jnp.asarray(pred), True)
    p = torch.from_numpy(pred).requires_grad_()
    got = V.vgg_loss_ens(tp, p, torch.from_numpy(target), **kw)
    (got_g,) = torch.autograd.grad(got, [p])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **VALUE)
    with torch.no_grad():
        items = V.vgg_loss_ens(tp, torch.from_numpy(pred),
                               torch.from_numpy(target), per_item=True, **kw)
    np.testing.assert_allclose(items.numpy(), np.asarray(want_items),
                               **VALUE)
    # the mean of K: not any one network's loss
    one = V.vgg_loss(tp[0], torch.from_numpy(pred), torch.from_numpy(target),
                     **kw)
    assert abs(float(one) - float(got.detach())) > 1e-3 * float(
        got.detach())
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=0,
                               atol=1e-5 * float(np.abs(want_g).max()))


@functools.lru_cache(maxsize=None)
def _template(n_points, hw):
    """A JAX ``TrainState`` of shapes only (the small UNet)."""
    cfg = JTP.PipelineConfig(crop_size=hw)
    return jax.eval_shape(lambda: JTP.create_state(
        jax.random.PRNGKey(0), cfg, n_points=n_points,
        net=FlaxUNet(**SMALL))[0])


def _step_scene():
    """``tests/test_torch_train.py``'s scene: 2000 points, 32x32 crops,
    B=2, uniform targets (its first batch)."""
    rng = np.random.default_rng(5)
    xyz = rng.uniform(-2, 2, size=(2000, 3)).astype(np.float32)
    xyz[:, 2] -= 6.0
    K = np.array([[30.0, 0, 16.0], [0, 30.0, 16.0], [0, 0, 1]])
    P = camera.gl_projection(K, (32, 32), 0.1, 50.0)
    ms = []
    for i in range(2):
        view = np.eye(4)
        view[0, 3] = 0.2 * i
        ms.append(camera.total_matrix(P, view))
    return xyz, {"total_m": np.stack(ms).astype(np.float32),
                 "target": rng.uniform(size=(2, 32, 32, 3)).astype(
                     np.float32)}


def test_vgg_ens_train_and_eval_steps_match_jax(jax_vgg):
    """(e) The port's first 'vgg_ens' step and eval step against JAX's
    from the same state (the port's fresh one, carried into JAX's
    ``TrainState``) and batch; the gradients also no further from the
    port's float64 step than JAX's float32 ones are (x1.25), as
    ``tests/test_torch_train.py`` holds them."""
    xyz, batch = _step_scene()
    n, hw = len(xyz), (32, 32)
    cfg = TP.PipelineConfig(crop_size=hw, vgg_ensemble=K_ENS)
    jcfg = JTP.PipelineConfig(crop_size=hw, vgg_ensemble=K_ENS)
    state, net = TP.create_state(torch.Generator().manual_seed(0), cfg, n,
                                 net=UNet(**SMALL), device="cpu")
    jstate = JCK._unflatten(_template(n, hw), TP.flat_from_state(state))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jvgg = [[(jnp.asarray(w), jnp.asarray(b)) for w, b in p]
            for p in jax_vgg[:K_ENS]]
    tvgg = [CV.vgg_params_from_numpy(p, "cpu") for p in jax_vgg[:K_ENS]]
    jnet = FlaxUNet(**SMALL)

    def loss_fn(params, texture):
        out, _, _ = JTP._forward(jnet, jcfg, params, jstate.batch_stats,
                                 texture, jnp.asarray(xyz), jb["total_m"],
                                 train=True)
        return JTP._losses(jcfg, jvgg, out, jb)[0]

    want, (gp, gt) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(
        jstate.params, jstate.texture)
    metrics, _, _, g_net, g_tex = TP._loss_and_grads(
        net, cfg, tvgg, state, torch.from_numpy(xyz), tb, False)
    np.testing.assert_allclose(float(metrics["loss"]), float(want),
                               rtol=1e-3)
    want_g = {k: np.asarray(v) for k, v in
              JCK._flatten({"params": gp, "texture": gt}).items()}

    def named(flat, tex):
        out = {"params/" + k.replace(".", "/"): v.numpy()
               for k, v in state.layout.views(flat).items()}
        out["texture"] = tex[0].numpy()
        return out

    got_g = named(g_net, g_tex)
    assert len(got_g) == len(want_g)
    for key, g in got_g.items():
        np.testing.assert_allclose(
            g, want_g[key], rtol=0, err_msg=key,
            atol=GRAD_ATOL * float(np.abs(want_g[key]).max()))
    s64 = dataclasses.replace(
        state, flat_params=state.flat_params.double(),
        batch_stats={k: v.double() for k, v in state.batch_stats.items()},
        texture=(state.texture[0].double(),))
    _, _, _, g64, t64 = TP._loss_and_grads(
        net, cfg, [[(w.double(), b.double()) for w, b in p] for p in tvgg],
        s64, torch.from_numpy(xyz), dict(tb, target=tb["target"].double()),
        False)
    truth = named(g64, t64)

    def worst(grads):
        return max(float(np.abs(grads[k] - t).max() / np.abs(t).max())
                   for k, t in truth.items())

    assert worst(got_g) <= 1.25 * worst(want_g)
    _, m1 = TP.make_train_step(net, cfg, tvgg)(state, torch.from_numpy(xyz),
                                                tb)
    assert float(m1["loss"]) == float(metrics["loss"])
    _, jev = JTP.make_eval_step(jnet, jcfg, jvgg)(jstate, jnp.asarray(xyz),
                                                 jb)
    _, ev = TP.make_eval_step(net, cfg, tvgg)(state, torch.from_numpy(xyz),
                                              tb)
    for key in EVAL_KEYS:
        np.testing.assert_allclose(np.asarray(ev[key]), np.asarray(jev[key]),
                                   rtol=1e-4, err_msg=key)


def _write_scene(root, n, hw, views):
    """A scene on disk: PLY, intrinsics, poses, PNG targets rendered with
    read_tpu's reference rasterizer, a JSON manifest and paths file."""
    rng = np.random.default_rng(9)
    xyz = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    xyz[:, 2] -= 6.0
    colors = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
    os.makedirs(root / "images", exist_ok=True)
    JIO.write_ply(str(root / "pc.ply"), xyz, colors)
    h, w = hw
    K = np.array([[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]])
    np.savetxt(root / "cam.txt", np.vstack([[w, h, 0], K]))
    P = camera.gl_projection(K, (w, h), znear=0.1, zfar=50.0)
    poses = []
    for i in range(views):
        pose = np.eye(4)
        pose[0, 3] = 0.2 * i
        poses.append(pose)
        idx, _ = JR.rasterize_reference(xyz, camera.total_matrix(P, pose),
                                        h, w)
        img = np.zeros((h, w, 3), np.float32)
        img[idx >= 0] = colors[idx[idx >= 0]]
        imageio.imwrite(str(root / "images" / f"{i:06}.png"),
                        (img * 255).astype(np.uint8))
    np.savetxt(root / "poses.dat", np.stack(poses).reshape(-1, 4))
    with open(root / "scene.json", "w") as f:
        json.dump({"viewport_size": [w, h], "pointcloud": "pc.ply",
                   "intrinsic_matrix": "cam.txt",
                   "view_matrix": "poses.dat"}, f)
    with open(root / "paths.json", "w") as f:
        json.dump({"datasets": {"toy": {
            "scene_path": str(root / "scene.json"),
            "target_path": str(root / "images"),
            "target_name": "{label:06d}.png"}}}, f)


class _JitInit:
    """A flax module whose ``init`` runs jitted (flax's eager init of the
    UNet, which ``read_tpu``'s CLI runs twice, takes ~13 s each on the
    CPU); everything else is the module's."""

    def __init__(self, net):
        self._net = net

    def init(self, key, *pyr, train):
        return jax.jit(functools.partial(self._net.init, train=train))(
            key, *pyr)

    def __getattr__(self, name):
        return getattr(self._net, name)


def _cli(main, argv):
    """An in-process CLI run (read_tpu's train CLI leaves its log copy as
    ``sys.stdout``: undone)."""
    streams = sys.stdout, sys.stderr
    try:
        assert main(argv) == 0
    finally:
        sys.stdout, sys.stderr = streams


@pytest.mark.parametrize("cli", ["train", "render"])
def test_clis_run_vgg_ens_and_sort1q_as_read_tpu(tmp_path, monkeypatch,
                                                 jax_vgg, cli):
    """(f) Both train CLIs evaluate one JAX-written checkpoint with
    ``--criterion vgg_ens`` (K = 3) on 'sort1q'; both render CLIs render
    it with ``--raster sort1q``."""
    n, hw, views = 1500, (32, 32), 4
    _write_scene(tmp_path, n, hw, views)
    monkeypatch.setattr(TP, "UNet", functools.partial(UNet, **SMALL))
    monkeypatch.setattr(JTP, "UNet",
                        lambda **kw: _JitInit(FlaxUNet(**SMALL, **kw)))
    state, _ = TP.create_state(torch.Generator().manual_seed(2),
                               TP.PipelineConfig(crop_size=hw), n,
                               device="cpu")
    ckpt = str(tmp_path / "ckpt")
    JCK.save_checkpoint(ckpt, JCK._unflatten(_template(n, hw),
                                             TP.flat_from_state(state)),
                        config={})
    quant = []
    twin = RK.zbuffer_quant_plain
    monkeypatch.setattr(RK, "zbuffer_quant_plain",
                        lambda *a, **k: quant.append(1) or twin(*a, **k))
    if cli == "render":
        flags = ["--scene", str(tmp_path / "scene.json"), "--ckpt", ckpt,
                 "--raster", "sort1q", "--max-frames", "2"]
        _cli(TR.main, flags + ["--out", str(tmp_path / "port"), "--device",
                               "cpu"])
        assert quant
        _cli(JRENDER.main, flags + ["--out", str(tmp_path / "jax")])
        for i in range(2):
            got = imageio.imread(tmp_path / "port" / f"{i:06}.png")
            want = imageio.imread(tmp_path / "jax" / f"{i:06}.png")
            assert got.shape == want.shape == (*hw, 3)
            assert np.abs(got.astype(int) - want).max() <= 1
        return
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"paths_file": str(tmp_path / "paths.json"),
                   "crop_size": f"{hw[1]}x{hw[0]}", "batch_size": 1,
                   "criterion": "vgg_ens", "raster_method": "sort1q", "splitter": "split_by_step",
                   "splitter_args": {"val_step": 2},
                   "headless_platform": "cpu"}, f)
    # the port's K networks: JAX's seeds 0..K-1 in place of its own draws
    seeds = []
    nets = [CV.vgg_params_from_numpy(p, "cpu") for p in jax_vgg]
    monkeypatch.setattr(V, "random_vgg_params", lambda gen, device:
                        seeds.append(gen.initial_seed()) or nets[seeds[-1]])
    # JAX's own draws, made once in this module
    jnets = [[(jnp.asarray(w), jnp.asarray(b)) for w, b in p]
             for p in jax_vgg]
    monkeypatch.setattr(JV, "random_vgg_params", lambda seed: jnets[seed])
    recorded = []

    class Recording(JPERF.AccumDict):
        def update(self, metrics):
            recorded.append(dict(metrics))
            super().update(metrics)

    flags = ["--config", str(tmp_path / "config.json"), "--eval",
             "--eval-all", "--resume", ckpt]
    _cli(TRAIN.main, flags + ["--save-dir", str(tmp_path / "port")])
    monkeypatch.setattr(JPERF, "AccumDict", Recording)
    _cli(JTRAIN.main, flags + ["--save-dir", str(tmp_path / "jax")])
    exp = {}
    for side in ("port", "jax"):
        (name,) = os.listdir(tmp_path / side)
        exp[side] = tmp_path / side / name
        with open(exp[side] / "log.txt") as f:
            assert (f"criterion vgg_ens: averaging {K_CLI} seeded-random "
                    "VGG feature sets") in f.read(), side
    assert seeds == list(range(K_CLI)) and quant
    with open(exp["port"] / "history.json") as f:
        got = json.load(f)[0]["views"]
    assert len(got) == len(recorded) == views
    for g, w in zip(got, recorded):
        for key in EVAL_KEYS:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4,
                                       err_msg=key)
