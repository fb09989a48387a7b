"""``remat`` in the port's training step, on the CPU.

With ``PipelineConfig(remat=True)`` the UNet's EBlocks and DBlocks run
under ``torch.utils.checkpoint`` (``read_tpu`` wraps them in
``nn.remat``). Held two ways, at ``UNet(base_channel=8, num_res=1)``,
32x32 crops, B=2, VGG (caffe) on:

- against the port's plain step from the same state: the new BatchNorm
  running statistics bit-equal (the recomputation must not move them a
  second time) and the gradients within 1e-6 x max|g| per tensor, in
  train mode and with ``freeze_net``;
- against JAX's ``remat=True`` step from one JAX-written state, with
  JAX's ``random_vgg_params(0)`` carried across: losses and PSNR of 3
  steps within ``rtol 1e-3`` and the running statistics after step 1
  within ``atol 1e-5``, ``tests/test_torch_train.py``'s three-step
  tolerances.

PyTorch's oneDNN CPU convolution is off here, as in
``tests/test_torch_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from read_tpu.criterions import vgg as JV
from read_tpu.models.unet import UNet as FlaxUNet
from read_tpu.pipelines import texture_pipeline as JTP
from read_tpu.scene import camera
from read_tpu.utils import ckpt as JCK
from read_tpu_torch.models.unet import UNet
from read_tpu_torch.pipelines import texture_pipeline as TP
from read_tpu_torch.utils import ckpt as CK
from read_tpu_torch.utils import convert as CV

N, B, HW = 2000, 2, (32, 32)
METRIC_KEYS = ("loss", "huber_loss", "vgg_loss", "psnr")


@pytest.fixture(scope="module", autouse=True)
def native_cpu_convs():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _scene():
    """``xyz [N, 3]`` and 3 batches of B poses with uniform targets."""
    rng = np.random.default_rng(11)
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


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """JAX's remat step: 3 steps from a fresh state, which is saved. The
    state is initialised through the plain net (the same parameter
    tree; flax's init of the remat net takes ~50 s on the CPU)."""
    cfg = JTP.PipelineConfig(crop_size=HW, remat=True)
    state, _ = JTP.create_state(jax.random.PRNGKey(1), cfg, n_points=N,
                                net=FlaxUNet(base_channel=8, num_res=1))
    net = FlaxUNet(base_channel=8, num_res=1, remat=True)
    path = str(tmp_path_factory.mktemp("remat") / "ckpt")
    JCK.save_checkpoint(path, state, config={})
    vgg = JV.random_vgg_params(0)
    xyz, batches = _scene()
    step = JTP.make_train_step(net, cfg, vgg)
    s, metrics = state, []
    for i in range(3):
        s, m = step(s, jnp.asarray(xyz),
                    {k: jnp.asarray(v) for k, v in batches[i].items()})
        metrics.append({k: np.asarray(v) for k, v in m.items()})
        if i == 0:
            stats1 = JCK._flatten({"batch_stats": s.batch_stats})
    return dict(path=path, xyz=xyz, batches=batches, metrics=metrics,
                stats1=stats1,
                vgg=[(np.asarray(w), np.asarray(b)) for w, b in vgg])


def _port(ref, remat):
    flat = CK.load_checkpoint(ref["path"])[0]
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in ref["batches"]]
    return (UNet(base_channel=8, num_res=1),
            TP.PipelineConfig(crop_size=HW, remat=remat),
            CV.vgg_params_from_numpy(ref["vgg"], "cpu"),
            TP.state_from_flat(flat, "cpu"), torch.from_numpy(ref["xyz"]),
            batches)


@pytest.mark.parametrize("freeze_net", [False, True])
def test_remat_step_equals_plain_step(ref, freeze_net):
    runs = []
    for remat in (False, True):
        net, cfg, vgg, state, xyz, batches = _port(ref, remat)
        metrics, stats, _, g_net, g_tex = TP._loss_and_grads(
            net, cfg, vgg, state, xyz, batches[0], freeze_net)
        grads = {"texture": g_tex[0]}
        if g_net is not None:
            grads.update(state.layout.views(g_net))
        runs.append((metrics, stats, grads))
    (m0, s0, g0), (m1, s1, g1) = runs
    for key in METRIC_KEYS:
        assert torch.equal(m0[key], m1[key]), key
    for key, t in s0.items():
        assert torch.equal(t, s1[key]), key
    before = _port(ref, False)[3].batch_stats
    moved = [k for k, t in s0.items() if not torch.equal(t, before[k])]
    assert bool(moved) != freeze_net
    assert set(g0) == set(g1)
    assert len(g0) == 1 if freeze_net else len(g0) > 50
    for key, g in g0.items():
        scale = float(g.abs().max()) or 1.0
        err = float((g1[key] - g).abs().max()) / scale
        assert err <= 1e-6, (key, err)


def test_remat_steps_match_jax_remat(ref):
    net, cfg, vgg, state, xyz, batches = _port(ref, remat=True)
    step = TP.make_train_step(net, cfg, vgg)
    for i in range(3):
        state, metrics = step(state, xyz, batches[i])
        for key in METRIC_KEYS:
            np.testing.assert_allclose(np.asarray(metrics[key]),
                                       ref["metrics"][i][key], rtol=1e-3,
                                       err_msg=key)
        if i == 0:
            for name, t in state.batch_stats.items():
                key = "batch_stats/" + name.replace(".", "/")
                np.testing.assert_allclose(t.numpy(), ref["stats1"][key],
                                           rtol=0, atol=1e-5, err_msg=key)
    assert state.step == 3
