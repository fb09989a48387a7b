"""bfloat16 training in the port against read_tpu's, on the CPU.

One JAX ``create_state(PRNGKey(0), ...)`` with ``UNet(base_channel=8,
num_res=1)`` over 2000 points is saved with ``read_tpu.utils.ckpt`` and
carried across; crops are 32x64, B=2, VGG (caffe, JAX's
``random_vgg_params(0)``) is on and the z-buffer is 'sort'. JAX's side is
the flax ``UNet(dtype=bfloat16)`` (``param_dtype`` float32), the port's
``UNet(operands='bf16')`` on the differentiable route.

bfloat16 keeps 8 significant bits, and each package rounds at its own
places (XLA's CPU backend keeps some element-wise chains in float32, its
sigmoid differs from PyTorch's in the last bit, oneDNN's and XLA's
convolutions sum in other orders), so the two bfloat16 results are two
independent draws of rounding noise around the float32 function. The
bounds say so:

- **forward** (``train=True`` and ``False``, random pyramids): the port's
  output within a relative L2 distance of ``0.12`` (train) / ``0.012``
  (eval) of JAX's bfloat16 output; the port's L2 distance from JAX's
  float32 output at most ``1.075x`` JAX's own bfloat16 output's (the
  port reads 0.975x in train mode and 0.898x in eval mode; with
  BatchNorm run wholly in bfloat16 it reads 1.077x, with the bias added
  to the conv's float32 sum before the rounding 1.128x, both in train
  mode; at init the eval-mode BatchNorm is exact in bfloat16); and
  further from it than the float32 route's bound (``5e-4 * max``), the
  proof that it ran in bfloat16. Train-mode BatchNorm over a 4x8 bottleneck magnifies the
  noise: JAX's own bfloat16 output lies ~8% (L2) from its float32 one
  there, ~0.6% in eval mode;
- **first step**: the loss within ``rtol 2e-2``, and each gradient tensor
  against JAX's bfloat16 gradient, with read_tpu's float64 gradient (the
  Flax UNet run in float64 under ``jax.enable_x64``, as in
  ``tests/test_torch_pipelines_extra.py``) as the referee. With ``d`` =
  ``max|g - g64| / max|g64|``: ``max|g_port - g_jax|`` at most ``3.5 *
  max(d_jax, 2e-4) * max|g64|``, and ``d_port`` summed over the tensors
  at most ``1.25x`` ``d_jax`` summed. Two bfloat16 runs are two draws of
  rounding noise that this size magnifies (train-mode BatchNorm over a
  4x8x2 bottleneck turns 8-bit rounding into gradients ~24% off, the
  median ``d_jax``); they round at different places (XLA's bfloat16
  sigmoid differs from PyTorch's in a third of the elements), so
  ``d_port / d_jax`` spreads from 0.14 to 3.3 over the 205 tensors and
  ``max|g_port - g_jax| / (d_jax * max|g64|)`` reaches 2.9. BatchNorm run
  wholly in bfloat16 takes it to 4.2; a fault of one rounding (the bias
  added before the rounding, the gate in float32, a resample not
  rounded) stays inside the noise, at 64x128 too (there ``d_jax`` is
  ~65%): these bounds catch a function that differs, not where one
  rounding falls;
- **the state after the step**: losses and PSNR ``rtol 2e-2``, the new
  running statistics within ``atol 2e-2`` (JAX's own bfloat16 statistics
  lie up to ~1e-2 from its float32 ones), the parameters, texture and
  both optimizers float32;
- **eval step** from JAX's state after its step: per-item losses, PSNR
  and SSIM ``rtol 2e-2``;
- **remat** in bfloat16: the port's gradients and statistics bit-equal
  to its plain bfloat16 step (the recomputation rounds as the forward);
- **pix2pix** in bfloat16: one step's losses ``rtol 2e-2`` and running
  statistics ``atol 2e-2`` against JAX's.

PyTorch's oneDNN CPU convolution is off, as in ``tests/
test_torch_train.py``. Each JAX function is compiled once.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from read_tpu.criterions import vgg as JV
from read_tpu.models import unet as JU
from read_tpu.models.unet import UNet as FlaxUNet
from read_tpu.pipelines import pix2pix_pipeline as JP2P
from read_tpu.pipelines import texture_pipeline as JTP
from read_tpu.scene import camera
from read_tpu.utils import ckpt as JCK
from read_tpu_torch.models.unet import UNet
from read_tpu_torch.pipelines import pix2pix_pipeline as P2P
from read_tpu_torch.pipelines import texture_pipeline as TP
from read_tpu_torch.utils import ckpt as CK
from read_tpu_torch.utils import convert as CV

N, B, HW = 2000, 2, (32, 64)
SMALL = dict(base_channel=8, num_res=1)
F32_TOL = 5e-4          # x max|out|: tests/test_torch_unet.py's bound
FWD_L2 = {True: 0.12, False: 0.012}
FWD_F32_RATIO = 1.075   # port's L2 distance from f32 over JAX's bf16's
METRIC_RTOL = 2e-2
STATS_ATOL = 2e-2
GRAD_ATOL = 2e-4        # x max|g|
GRAD_FACTOR = 3.5       # x max(d_jax, GRAD_ATOL) * max|g64|
METRIC_KEYS = ("loss", "huber_loss", "vgg_loss", "psnr")


@pytest.fixture(scope="module", autouse=True)
def native_cpu_convs():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _scene(rng):
    """``xyz [N, 3]``, per-point colours and 2 batches of B poses with
    uniform targets."""
    xyz = rng.uniform(-2, 2, size=(N, 3)).astype(np.float32)
    xyz[:, 2] -= 6.0
    h, w = HW
    K = np.array([[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]])
    P = camera.gl_projection(K, (w, h), 0.1, 50.0)
    batches = []
    for step in range(2):
        ms = []
        for i in range(B):
            view = np.eye(4)
            view[0, 3] = 0.2 * i + 0.1 * step
            ms.append(camera.total_matrix(P, view))
        batches.append({
            "total_m": np.stack(ms).astype(np.float32),
            "target": rng.uniform(size=(B, h, w, 3)).astype(np.float32)})
    return xyz, rng.uniform(size=(N, 3)).astype(np.float32), batches


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``. Patched into
    ``read_tpu.models.unet`` (its BatchNorm and output casts name
    float32), it runs the Flax UNet in float64 under ``jax.enable_x64``:
    read_tpu's own float64 gradient, the referee."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _np(metrics):
    return {k: np.asarray(v) for k, v in metrics.items()}


class _JitInit:
    """A flax module whose ``init`` runs jitted (flax's eager init of the
    UNet takes ~30 s on the CPU); everything else is the module's."""

    def __init__(self, net):
        self._net = net

    def init(self, key, *pyr, train):
        return jax.jit(functools.partial(self._net.init, train=train))(
            key, *pyr)

    def __getattr__(self, name):
        return getattr(self._net, name)


def _captured_grads(step, state, *args):
    """``step(state, *args)`` with the gradients its guard receives
    captured: ``(result, {flat key: gradient})``. JAX's step guards
    ``(params grads, texture grad)`` leaf by leaf, in tree order while it
    traces (the callbacks themselves may run in any order)."""
    seen = {}
    guard = JTP._guard_grad

    def spy(g, clip):
        i = len(seen)
        seen[i] = None
        jax.debug.callback(lambda a: seen.__setitem__(i, np.asarray(a)), g)
        return guard(g, clip)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTP, "_guard_grad", spy)
        out = jax.block_until_ready(step(state, *args))
    jax.effects_barrier()
    paths = jax.tree_util.tree_flatten_with_path(
        (state.params, state.texture))[0]
    keys = ["params/" + "/".join(str(k.key) for k in path[1:])
            if path[0].idx == 0 else "texture" for path, _ in paths]
    assert len(seen) == len(keys)
    return out, {key: seen[i] for i, key in enumerate(keys)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    rng = np.random.default_rng(3)
    cfg = JTP.PipelineConfig(crop_size=HW, dtype=jnp.bfloat16)
    state, _ = JTP.create_state(jax.random.PRNGKey(0), cfg, n_points=N,
                                net=_JitInit(FlaxUNet(**SMALL)))
    net = FlaxUNet(**SMALL, dtype=jnp.bfloat16)
    path = str(tmp_path_factory.mktemp("bf16") / "ckpt")
    JCK.save_checkpoint(path, state, config={"dtype": "bfloat16"})
    vgg = JV.random_vgg_params(0)
    xyz, rgb, batches = _scene(rng)
    jxyz = jnp.asarray(xyz)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]

    # the net alone, both modes, float32 and bfloat16
    pyr = [rng.normal(size=(B, HW[0] // f, HW[1] // f, 8)).astype(np.float32)
           for f in (1, 2, 4, 8)]
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    cases = [(bf16, train) for bf16 in (False, True)
             for train in (True, False)]

    @jax.jit
    def forwards(v, *p):
        return [FlaxUNet(**SMALL, dtype=jnp.bfloat16 if bf16
                         else jnp.float32).apply(
            v, *p, train=train, mutable=["batch_stats"])[0]["im_out"]
            for bf16, train in cases]

    fwd = dict(zip(cases, map(np.asarray, forwards(variables, *pyr))))
    (s1, m1), grads = _captured_grads(
        JTP.make_train_step(net, cfg, vgg), state, jxyz, jb[0])
    cfg64 = JTP.PipelineConfig(crop_size=HW)

    def loss_fn(params, texture, net, batch_stats, vgg, target):
        out, _, _ = JTP._forward(net, cfg64, params, batch_stats, texture,
                                 jxyz, jb[0]["total_m"], train=True)
        return JTP._losses(cfg64, vgg, out, dict(jb[0], target=target))[0]

    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(JU, "jnp", _Float64Numpy())
        g64 = jax.jit(jax.grad(loss_fn, argnums=(0, 1)), static_argnums=2)(
            _f64(state.params), _f64(state.texture),
            FlaxUNet(**SMALL, dtype=jnp.float64), _f64(state.batch_stats),
            _f64(vgg), batches[0]["target"].astype(np.float64))
    grads64 = {k: np.asarray(v) for k, v in JCK._flatten(
        {"params": g64[0], "texture": g64[1]}).items()}
    im, ev = JTP.make_eval_step(net, cfg, vgg)(s1, jxyz, jb[1])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JP2P, "UNet",
                   lambda **kw: _JitInit(FlaxUNet(**SMALL, **kw)))
        p_state, p_net, opt = JP2P.create_pix2pix_state(
            jax.random.PRNGKey(1), cfg)
    p_path = str(tmp_path_factory.mktemp("bf16_p2p") / "ckpt")
    JCK.save_checkpoint(p_path, p_state, config={"dtype": "bfloat16"})
    p_new, p_m = JP2P.make_pix2pix_step(p_net, cfg, opt, vgg,
                                        {"rgb": rgb})(p_state, jxyz, jb[0])
    return dict(
        path=path, xyz=xyz, rgb=rgb, batches=batches, pyr=pyr, fwd=fwd,
        vgg=[(np.asarray(w), np.asarray(b)) for w, b in vgg],
        grads=grads, grads64=grads64, step1=_np(m1), state1=JCK._flatten(s1),
        eval=(np.asarray(im), _np(ev)),
        p_path=p_path, p_step=_np(p_m),
        p_stats=JCK._flatten({"batch_stats": p_new["batch_stats"]}))


def _port(ref, flat=None, **cfg):
    """(net, cfg, vgg, state, xyz, batches) on the port's side, bf16."""
    flat = flat if flat is not None else CK.load_checkpoint(ref["path"])[0]
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in ref["batches"]]
    return (UNet(**SMALL),
            TP.PipelineConfig(crop_size=HW, dtype="bfloat16", **cfg),
            CV.vgg_params_from_numpy(ref["vgg"], "cpu"),
            TP.state_from_flat(flat, "cpu"),
            torch.from_numpy(ref["xyz"]), batches)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _assert_metrics(got, want, keys=METRIC_KEYS):
    for key in keys:
        np.testing.assert_allclose(np.asarray(got[key]), want[key],
                                   rtol=METRIC_RTOL, err_msg=key)


@pytest.mark.parametrize("train", [True, False])
def test_bf16_forward_matches_flax(ref, train):
    """The net alone from JAX's state: within the mode's L2 bound of
    flax's bfloat16 output, no further from its float32 output than
    1.075x flax's bfloat16 is, and visibly bfloat16 (beyond the float32
    bound).
    The output comes back float32; the parameters stay float32."""
    flat, _ = CK.load_checkpoint(ref["path"])
    net = UNet(**SMALL)
    state = TP.state_from_flat(flat, "cpu")
    out = torch.func.functional_call(
        net, {**state.params, **state.batch_stats},
        tuple(map(torch.from_numpy, ref["pyr"])),
        {"train": train, "operands": "bf16"})["im_out"]
    assert out.dtype == torch.float32
    got = out.detach().numpy()
    f32, bf16 = ref["fwd"][False, train], ref["fwd"][True, train]
    assert _rel_l2(got, bf16) <= FWD_L2[train], _rel_l2(got, bf16)
    assert _rel_l2(got, f32) <= FWD_F32_RATIO * _rel_l2(bf16, f32), \
        (_rel_l2(got, f32), _rel_l2(bf16, f32))
    assert float(np.abs(got - f32).max()) > F32_TOL * np.abs(f32).max()
    assert all(p.dtype == torch.float32 for p in net.parameters())


def test_first_bf16_step_gradients_match_jax(ref):
    """The first step's loss, and every gradient tensor against JAX's
    bfloat16 gradient with read_tpu's float64 gradient as the referee:
    ``max|g_port - g_jax|`` at most ``3.5 * max(d_jax, 2e-4) * max|g64|``,
    and the port's distances from float64 summed at most 1.25x JAX's."""
    net, cfg, vgg, state, xyz, batches = _port(ref)
    metrics, _, _, g_flat, g_tex = TP._loss_and_grads(
        net, cfg, vgg, state, xyz, batches[0], False)
    np.testing.assert_allclose(float(metrics["loss"]),
                               ref["step1"]["loss"], rtol=METRIC_RTOL)
    got = {"params/" + k.replace(".", "/"): g.numpy()
           for k, g in state.layout.views(g_flat).items()}
    got["texture"] = g_tex[0].numpy()
    want, truth = ref["grads"], ref["grads64"]
    assert set(got) == set(want) == set(truth)
    assert all(g.dtype == np.float32 for g in got.values())

    def off(g, key):
        return float(np.abs(np.asarray(g, np.float64) - truth[key]).max()
                     / np.abs(truth[key]).max())

    port = {key: off(got[key], key) for key in truth}
    jax_off = {key: off(want[key], key) for key in truth}
    for key in truth:
        atol = GRAD_FACTOR * max(jax_off[key], GRAD_ATOL) * float(
            np.abs(truth[key]).max())
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol,
                                   err_msg=key)
    assert sum(port.values()) <= 1.25 * sum(jax_off.values()), \
        (sum(port.values()), sum(jax_off.values()))
    # bfloat16 shows: float32 gradients lie ~2e-3 * max|g| from float64
    assert float(np.median(list(port.values()))) > 1e-2


def test_bf16_step_state_matches_jax(ref):
    """One whole bfloat16 step: its metrics, the new running statistics,
    float32 parameters/texture/moments that moved, the step counts, and
    the input state untouched."""
    net, cfg, vgg, state, xyz, batches = _port(ref)
    before = TP.flat_from_state(state)
    new, metrics = TP.make_train_step(net, cfg, vgg)(state, xyz,
                                                     batches[0])
    _assert_metrics(metrics, ref["step1"])
    after = TP.flat_from_state(new)
    for key, arr in ref["state1"].items():
        assert after[key].dtype == np.asarray(arr).dtype, key
        if key.startswith("batch_stats/"):
            np.testing.assert_allclose(after[key], arr, rtol=0,
                                       atol=STATS_ATOL, err_msg=key)
    assert new.step == 1 and new.net_opt.count == 1
    for key, arr in TP.flat_from_state(state).items():
        np.testing.assert_array_equal(arr, before[key], err_msg=key)
    assert not np.array_equal(after["texture"], before["texture"])
    assert new.flat_params.dtype == torch.float32


def test_bf16_eval_step_matches_jax(ref):
    """Per-item losses, PSNR and SSIM from JAX's state after its bfloat16
    step, carried across; the image float32."""
    net, cfg, vgg, state, xyz, batches = _port(ref, flat=ref["state1"])
    im, metrics = TP.make_eval_step(net, cfg, vgg)(state, xyz, batches[1])
    want_im, want = ref["eval"]
    assert im.dtype == torch.float32 and tuple(im.shape) == want_im.shape
    _assert_metrics(metrics, want, METRIC_KEYS + ("ssim",))
    assert tuple(metrics["ssim"].shape) == (B,)


@pytest.mark.parametrize("freeze_net", [False, True])
def test_bf16_remat_equals_plain(ref, freeze_net):
    """``remat`` in bfloat16 recomputes the blocks as the forward ran
    them: gradients and new statistics bit-equal to the plain bfloat16
    step's."""
    outs = []
    for remat in (False, True):
        net, cfg, vgg, state, xyz, batches = _port(ref, remat=remat)
        _, bs, _, g_net, g_tex = TP._loss_and_grads(
            net, cfg, vgg, state, xyz, batches[0], freeze_net)
        outs.append((bs, g_net, g_tex))
    (bs0, n0, t0), (bs1, n1, t1) = outs
    for k in bs0:
        torch.testing.assert_close(bs1[k], bs0[k], rtol=0, atol=0)
    if not freeze_net:
        torch.testing.assert_close(n1, n0, rtol=0, atol=0)
    torch.testing.assert_close(t1[0], t0[0], rtol=0, atol=0)


def test_pix2pix_bf16_step_matches_jax(ref):
    """One pix2pix step in bfloat16 from JAX's state: losses and the new
    running statistics against JAX's bfloat16 step."""
    state = P2P.pix2pix_state_from_flat(CK.load_checkpoint(ref["p_path"])[0],
                                        "cpu")
    cfg = TP.PipelineConfig(crop_size=HW, dtype="bfloat16")
    step = P2P.make_pix2pix_step(
        UNet(num_input_channels=3, **SMALL), cfg,
        CV.vgg_params_from_numpy(ref["vgg"], "cpu"),
        {"rgb": ref["rgb"]})
    batch = {k: torch.from_numpy(v) for k, v in ref["batches"][0].items()}
    new, metrics = step(state, torch.from_numpy(ref["xyz"]), batch)
    _assert_metrics(metrics, ref["p_step"])
    for name, t in new.batch_stats.items():
        key = "batch_stats/" + name.replace(".", "/")
        np.testing.assert_allclose(t.numpy(), ref["p_stats"][key], rtol=0,
                                   atol=STATS_ATOL, err_msg=key)
    assert new.flat_params.dtype == torch.float32 and new.step == 1


def test_bf16_config_trains_from_a_fresh_state():
    """``dtype='bfloat16'`` no longer refuses: a fresh state is float32
    and a step from it runs, its loss finite."""
    cfg = TP.PipelineConfig(crop_size=(16, 16), dtype="bfloat16")
    state, net = TP.create_state(torch.Generator().manual_seed(0), cfg, 50,
                                 net=UNet(**SMALL), device="cpu")
    assert state.flat_params.dtype == torch.float32
    rng = np.random.default_rng(0)
    xyz = torch.from_numpy(rng.uniform(-1, 1, (50, 3)).astype(np.float32)
                           - np.float32([0, 0, 4]))
    P = camera.gl_projection(np.array([[16.0, 0, 8], [0, 16.0, 8],
                                       [0, 0, 1]]), (16, 16), 0.1, 50.0)
    batch = {"total_m": torch.from_numpy(camera.total_matrix(
                 P, np.eye(4))[None].astype(np.float32)),
             "target": torch.rand(1, 16, 16, 3)}
    new, m = TP.make_train_step(net, cfg, None)(state, xyz, batch)
    assert np.isfinite(float(m["loss"])) and new.step == 1
