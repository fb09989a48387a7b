"""The port's training step against read_tpu's, on the CPU.

One JAX ``create_state(PRNGKey(0), ...)`` with ``UNet(base_channel=8,
num_res=1)`` over 2000 points is saved with ``read_tpu.utils.ckpt`` and
carried across with the port's numpy-only reader; JAX's own
``random_vgg_params(0)`` is carried across too. Crops are 32x32, B=2, VGG
(caffe) is on and the z-buffer is the default 'sort' (K5's twin here).
The JAX reference runs once per module.

Tolerances and why:
- first-step gradients: ``atol 2e-4 * max|g|`` per tensor, not 1e-5.
  The float32 step is ill-conditioned (train-mode BatchNorm over few
  pixels, the 1e4-weighted huber term, caffe-scaled VGG): against a
  float64 run of the same step, JAX's float32 gradients are off by up
  to ~8e-4 * max|g| and the port's by as much, while the two float32
  results differ by ~1.1e-4 * max|g|. The test also holds the port to
  that float64 run: its worst deviation may exceed JAX's by 25% at most;
- losses and PSNR over 3 steps ``rtol 1e-3``; running statistics after
  step 1 ``atol 1e-5``; eval-step metrics ``rtol 1e-4``;
- optimizers ``rtol 1e-6``; the unique-gather backward exact for
  integer-valued cotangents, else ``1e-6`` (``rtol 1e-5`` through a
  sigmoid/tanh activation, whose last ulp differs between XLA and
  PyTorch).

PyTorch's oneDNN CPU convolution is switched off in this module: its
backward loses up to 4e-4 * max|g| on the caffe-scaled VGG inputs
(checked against float64), where PyTorch's own CPU convolution holds
2e-7. Parameters are never compared elementwise after Adam steps: the
first updates are sign-like for tiny gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from read_tpu.criterions import vgg as JV
from read_tpu.models import texture as JT
from read_tpu.models.unet import UNet as FlaxUNet
from read_tpu.pipelines import texture_pipeline as JTP
from read_tpu.scene import camera
from read_tpu.utils import ckpt as JCK
from read_tpu_torch.models import texture as T
from read_tpu_torch.models.unet import UNet
from read_tpu_torch.pipelines import texture_pipeline as TP
from read_tpu_torch.utils import ckpt as CK
from read_tpu_torch.utils import convert as CV

N, B, HW = 2000, 2, (32, 32)
GRAD_ATOL = 2e-4            # x max|g|, see the module docstring
METRIC_KEYS = ("loss", "huber_loss", "vgg_loss", "psnr")


@pytest.fixture(scope="module", autouse=True)
def native_cpu_convs():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _scene():
    """``xyz [N, 3]`` and 3 batches of B poses with uniform targets."""
    rng = np.random.default_rng(5)
    xyz = rng.uniform(-2, 2, size=(N, 3)).astype(np.float32)
    xyz[:, 2] -= 6.0
    h, w = HW
    K = np.array([[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]])
    P = camera.gl_projection(K, (w, h), 0.1, 50.0)
    batches = []
    for step in range(3):
        ms = []
        for i in range(B):
            view = np.eye(4)
            view[0, 3] = 0.2 * i + 0.1 * step
            ms.append(camera.total_matrix(P, view))
        batches.append({
            "total_m": np.stack(ms).astype(np.float32),
            "target": rng.uniform(size=(B, h, w, 3)).astype(np.float32)})
    return xyz, batches


def _np(metrics):
    return {k: np.asarray(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    cfg = JTP.PipelineConfig(crop_size=HW)
    state, net = JTP.create_state(jax.random.PRNGKey(0), cfg, n_points=N,
                                  net=FlaxUNet(base_channel=8, num_res=1))
    path = str(tmp_path_factory.mktemp("train") / "ckpt")
    JCK.save_checkpoint(path, state, config={})
    vgg = JV.random_vgg_params(0)
    xyz, batches = _scene()
    jxyz = jnp.asarray(xyz)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]

    def loss_fn(params, texture, batch):
        out, _, _ = JTP._forward(net, cfg, params, state.batch_stats,
                                 texture, jxyz, batch["total_m"], train=True)
        return JTP._losses(cfg, vgg, out, batch)[0]

    grads = jax.jit(jax.grad(loss_fn, argnums=(0, 1)))(
        state.params, state.texture, jb[0])
    step = JTP.make_train_step(net, cfg, vgg)
    s, full = state, []
    for i in range(3):
        s, m = step(s, jxyz, jb[i])
        full.append(_np(m))
        if i == 0:
            stats1 = JCK._flatten({"batch_stats": s.batch_stats})
    _, frozen = JTP.make_train_step(net, cfg, vgg, freeze_net=True)(
        state, jxyz, jb[0])
    im, ev = JTP.make_eval_step(net, cfg, vgg)(s, jxyz, jb[1])
    return dict(path=path, xyz=xyz, batches=batches,
                vgg=[(np.asarray(w), np.asarray(b)) for w, b in vgg],
                grads=JCK._flatten({"params": grads[0],
                                    "texture": grads[1]}),
                full=full, stats1=stats1, frozen=_np(frozen),
                state3=JCK._flatten(s), eval=(np.asarray(im), _np(ev)))


def _port(ref, flat=None, device="cpu"):
    """(net, cfg, vgg, state, xyz, batches) on the port's side."""
    flat = flat if flat is not None else CK.load_checkpoint(ref["path"])[0]
    batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
               for b in ref["batches"]]
    return (UNet(base_channel=8, num_res=1).to(device),
            TP.PipelineConfig(crop_size=HW),
            CV.vgg_params_from_numpy(ref["vgg"], device),
            TP.state_from_flat(flat, device),
            torch.from_numpy(ref["xyz"]).to(device), batches)


def _assert_metrics(got, want, rtol, keys=METRIC_KEYS):
    for key in keys:
        np.testing.assert_allclose(np.asarray(got[key]), want[key],
                                   rtol=rtol, err_msg=key)


def test_train_state_round_trip(ref):
    """A whole JAX TrainState's flat leaves come back bit for bit, with
    the same keys and dtypes."""
    flat, _ = CK.load_checkpoint(ref["path"])
    back = TP.flat_from_state(TP.state_from_flat(flat, device="cpu"))
    assert set(back) == set(flat)
    for key, arr in flat.items():
        assert back[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(back[key], arr, err_msg=key)


def test_create_state_matches_jax_layout(ref):
    """The port's fresh state has JAX's leaves and shapes; BatchNorm
    starts at mean 0, var 1, the optimizers at 0."""
    flat, _ = CK.load_checkpoint(ref["path"])
    state, net = TP.create_state(torch.Generator().manual_seed(0),
                                 TP.PipelineConfig(crop_size=HW), N,
                                 net=UNet(base_channel=8, num_res=1),
                                 device="cpu")
    mine = TP.flat_from_state(state)
    assert {k: v.shape for k, v in mine.items()} == \
        {k: v.shape for k, v in flat.items()}
    assert state.step == 0 and state.net_opt.count == 0
    for key, arr in flat.items():
        if key.startswith(("batch_stats/", "net_opt/", "tex_opt/")) \
                or key in ("step", "lr_scale"):
            np.testing.assert_array_equal(mine[key], arr, err_msg=key)
    assert 0 <= float(state.texture.min()) and float(state.texture.max()) < 1


def test_first_step_gradients_match_jax(ref):
    """(a) Every parameter's and the texture's gradient of the first
    step within 2e-4 * max|g| of jax.grad, and no further from a float64
    run of the port's step than JAX's float32 gradients are (x1.25)."""
    net, cfg, vgg, state, xyz, batches = _port(ref)
    _, _, _, g_flat, g_tex = TP._loss_and_grads(net, cfg, vgg, state, xyz,
                                                batches[0], False)
    g_net = state.layout.views(g_flat)
    want = ref["grads"]
    assert len(g_net) == sum(k.startswith("params/") for k in want)
    got = {"params/" + k.replace(".", "/"): g for k, g in g_net.items()}
    got["texture"] = g_tex
    for key, g in got.items():
        scale = float(np.abs(want[key]).max())
        np.testing.assert_allclose(g.numpy(), want[key], rtol=0,
                                   atol=GRAD_ATOL * scale, err_msg=key)
    s64 = dataclasses.replace(
        state, flat_params=state.flat_params.double(),
        batch_stats={k: v.double() for k, v in state.batch_stats.items()},
        texture=state.texture.double())
    b64 = dict(batches[0], target=batches[0]["target"].double())
    _, _, _, g64, t64 = TP._loss_and_grads(
        net, cfg, [(w.double(), b.double()) for w, b in vgg], s64, xyz,
        b64, False)
    truth = {"params/" + k.replace(".", "/"): g.numpy()
             for k, g in state.layout.views(g64).items()}
    truth["texture"] = t64.numpy()

    def worst(grads):
        return max(float(np.abs(np.asarray(grads[k]) - t).max()
                         / np.abs(t).max()) for k, t in truth.items())

    port, jax_err = worst({k: g.numpy() for k, g in got.items()}), \
        worst(want)
    assert port <= 1.25 * jax_err, (port, jax_err)


def test_three_steps_match_jax(ref):
    """(b) Losses and PSNR of 3 full steps; running stats after step 1."""
    net, cfg, vgg, state, xyz, batches = _port(ref)
    step = TP.make_train_step(net, cfg, vgg, return_images=True)
    for i in range(3):
        state, metrics, im = step(state, xyz, batches[i])
        _assert_metrics(metrics, ref["full"][i], 1e-3)
        assert tuple(im.shape) == (B, *HW, 3)
        if i == 0:
            for name, t in state.batch_stats.items():
                key = "batch_stats/" + name.replace(".", "/")
                np.testing.assert_allclose(t.numpy(), ref["stats1"][key],
                                           rtol=0, atol=1e-5, err_msg=key)
    assert state.step == 3 and state.net_opt.count == 3


def test_freeze_net_step_matches_jax(ref):
    """(c) One texture-only step: same loss bounds, the net untouched,
    the input state untouched."""
    net, cfg, vgg, state, xyz, batches = _port(ref)
    before = TP.flat_from_state(state)
    new, metrics = TP.make_train_step(net, cfg, vgg, freeze_net=True)(
        state, xyz, batches[0])
    _assert_metrics(metrics, ref["frozen"], 1e-3)
    after, again = TP.flat_from_state(new), TP.flat_from_state(state)
    for key, arr in before.items():
        same = np.array_equal(after[key], arr)
        changed = key in ("texture", "tex_opt/0/nu", "step")
        assert same != changed, key
        np.testing.assert_array_equal(again[key], arr, err_msg=key)


def test_eval_step_matches_jax(ref):
    """(d) Per-item loss, PSNR and SSIM from JAX's state after 3 steps
    (trained BatchNorm statistics), carried across."""
    net, cfg, vgg, state, xyz, batches = _port(ref, flat=ref["state3"])
    im, metrics = TP.make_eval_step(net, cfg, vgg)(state, xyz, batches[1])
    want_im, want = ref["eval"]
    assert tuple(im.shape) == want_im.shape
    _assert_metrics(metrics, want, 1e-4, METRIC_KEYS + ("ssim",))
    assert tuple(metrics["ssim"].shape) == (B,)


@pytest.mark.parametrize("change", [
    dict(drop_points=0.1), dict(perturb_points=1.0), dict(remat=True),
    dict(vgg_ensemble=3), dict(dtype="bfloat16"), dict(use_mesh=True),
    dict(point_radius=1), dict(supersampling=2),
    dict(extra_modes=(("depth",),) * 4)])
def test_unported_training_configs_raise(change):
    cfg = TP.PipelineConfig(crop_size=HW, **change)
    net = UNet(base_channel=8, num_res=1)
    with pytest.raises(NotImplementedError):
        TP.make_train_step(net, cfg, None)
    with pytest.raises(NotImplementedError):
        TP.create_state(torch.Generator().manual_seed(0), cfg, 10, net=net,
                        device="cpu")


@pytest.mark.parametrize("activation", ["none", "sigmoid", "tanh"])
@pytest.mark.parametrize("integer", [True, False])
def test_unique_gather_matches_jax(activation, integer):
    """``sample_point_texture_unique`` forward and backward: [B=3, 6, 7]
    index maps with empties and one point per pixel per image (points
    repeat across images)."""
    rng = np.random.default_rng(7)
    n, c = 60, 5
    table = rng.normal(size=(n, c)).astype(np.float32)
    idx = np.stack([np.where(rng.uniform(size=42) < 0.3, -1,
                             rng.permutation(n)[:42]).reshape(6, 7)
                    for _ in range(3)]).astype(np.int32)
    cot = rng.normal(size=(3, 6, 7, c)).astype(np.float32)
    if integer:
        cot = np.round(cot * 4)

    def jax_fn(t):
        return JT.sample_point_texture_unique(t, jnp.asarray(idx),
                                              activation)

    want_out = jax_fn(jnp.asarray(table))
    want = jax.grad(lambda t: jnp.sum(jax_fn(t) * cot))(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_()
    out = T.sample_point_texture_unique(t, torch.from_numpy(idx), activation)
    (got,) = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), [t])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=1e-6, atol=1e-7)
    if activation != "none":
        # XLA's and PyTorch's sigmoid/tanh differ in the last ulp, and
        # the cotangent (up to ~12) scales that difference
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    elif integer:
        np.testing.assert_array_equal(out.detach().numpy(),
                                      np.asarray(want_out))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def test_optimizers_match_optax():
    """3 updates of Adam (net, on a flat buffer of two tensors) and RMS
    (texture) from the same gradients and zero states, and the states
    they leave."""
    rng = np.random.default_rng(8)
    shapes = {"a": (4, 5), "b": (7,)}
    layout = TP.ParamLayout.of({k: torch.zeros(s) for k, s in
                                shapes.items()})
    adam = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
    rms = optax.scale_by_rms(decay=0.99, eps=1e-8)
    jp = {k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()}
    ja, jr = adam.init(jp), rms.init(jp["a"])
    ta = TP.AdamState(0, torch.zeros(27), torch.zeros(27))
    tr = TP.RmsState(torch.zeros(shapes["a"]))
    for _ in range(3):
        g = {k: (rng.normal(size=s) * 10.0 ** rng.uniform(-6, 1, size=s)
                 ).astype(np.float32) for k, s in shapes.items()}
        ua, ja = adam.update({k: jnp.asarray(v) for k, v in g.items()}, ja)
        ur, jr = rms.update(jnp.asarray(g["a"]), jr)
        va, ta = TP.adam_update(layout.flatten(
            {k: torch.from_numpy(v) for k, v in g.items()}), ta)
        vr, tr = TP.rms_update(torch.from_numpy(g["a"]), tr)
        va, mu, nu = (layout.views(t) for t in (va, ta.mu, ta.nu))
        for k in shapes:   # the port's updates carry scale(-1)
            np.testing.assert_allclose(-va[k].numpy(), np.asarray(ua[k]),
                                       rtol=1e-6)
            np.testing.assert_allclose(mu[k].numpy(),
                                       np.asarray(ja.mu[k]), rtol=1e-6)
            np.testing.assert_allclose(nu[k].numpy(),
                                       np.asarray(ja.nu[k]), rtol=1e-6)
        np.testing.assert_allclose(-vr.numpy(), np.asarray(ur), rtol=1e-6)
        np.testing.assert_allclose(tr.nu.numpy(), np.asarray(jr.nu),
                                   rtol=1e-6)
    assert ta.count == int(ja.count) == 3


def test_guard_grad_matches_jax():
    g = np.array([np.nan, np.inf, -np.inf, 2e3, -5e3, 999.5, -0.25, 0.0],
                 np.float32)
    got = TP._guard_grad(torch.from_numpy(g), 1e3).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(JTP._guard_grad(jnp.asarray(g), 1e3)))
    np.testing.assert_array_equal(
        got, [0.0, 1e3, -1e3, 1e3, -1e3, 999.5, -0.25, 0.0])


def test_reduce_lr_on_plateau_matches_jax():
    seq = [5.0, 4.0, 4.5, 4.2, 4.1, 4.0, 3.0, 3.5, 3.6, 3.7, 3.8, 3.9]
    mine, theirs = TP.ReduceLROnPlateau(patience=2), \
        JTP.ReduceLROnPlateau(patience=2)
    assert [mine.step(m) for m in seq] == [theirs.step(m) for m in seq]
    assert mine.scale == 0.25
