"""Supersampling, extra input modalities and ``label_in_input`` in the
port's pipeline against ``read_tpu``'s, on the CPU.

- ``build_pyramid`` against JAX's ``_build_pyramid`` on one texture and
  one batch of 2000 seeded points (32x32, B=2): at ``supersampling`` 2
  ('sort' and 'pallas'), with ``depth`` + ``normals_l`` at every scale
  (per-item view matrices), with ``labels`` under ``label_in_input``,
  and the refusal of ``label_in_input`` with supersampling (JAX's
  ``gt_label[:, ::0]`` raises too);
- the first training step from one JAX-written ``TrainState`` (UNet base
  8, one res block, the net's input widened by the extra channels) in
  each of those configurations, with the huber loss alone (the VGG loss
  has its own step tests and would triple this file's time): loss ``rtol
  1e-4`` and every gradient
  within ``2e-4 * max|g|`` (or 2.25x JAX's own distance from a float64
  run of the port's step, whichever is larger; the port no further from
  that run than 1.25x JAX), as ``tests/test_torch_splat.py`` holds the
  splat step (at ss 2 on 'sort'; the 'pallas' pyramid at ss 2 is held
  above); then the eval step's per-item metrics ``rtol 1e-4``. One JAX
  state serves every configuration of one input width.

Pyramid tolerances: index-derived maps (descriptors, depth, labels) at
``supersampling`` 1 are bit-equal; ``normals_l`` inverts the view
matrix in float32 (``atol 2e-7``); a supersampled level is an
antialiased bilinear resize (``F.interpolate(..., antialias=True)``
against ``jax.image.resize``), ``atol 1e-6``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from read_tpu.models.unet import UNet as FlaxUNet
from read_tpu.pipelines import texture_pipeline as JTP
from read_tpu.scene import camera
from read_tpu.utils import ckpt as JCK
from read_tpu_torch.models.unet import UNet
from read_tpu_torch.pipelines import texture_pipeline as TP
from read_tpu_torch.utils import ckpt as CK

N, B, HW = 2000, 2, (32, 32)
SMALL = dict(base_channel=8, num_res=1)
GRAD_ATOL = 2e-4            # x max|g|, tests/test_torch_train.py


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's CPU ops are small: one intra-op thread runs them
    fastest when the suite's workers share the cores (8 threads a
    worker ran them ~7x slower under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _format(extra):
    return ", ".join(", ".join([f"uv_1d_p1_ds{i}" if i else "uv_1d_p1"]
                               + [f"{m}_ds{i}" if i else m for m in extra])
                     for i in range(5))


DEPTH_NORMALS = _format(("depth", "normals_l"))
LABELS = _format(("labels",))
HUBER = {"criterion": "huber_only"}
CONFIGS = {
    "ss2_sort": ({"supersampling": 2, **HUBER}, {}),
    "ss2_pallas": ({"supersampling": 2, "raster_method": "pallas",
                    **HUBER}, {}),
    "depth_normals_l": ({"input_format": DEPTH_NORMALS, **HUBER}, {}),
    "label_in_input": ({"input_format": LABELS, **HUBER},
                       {"label_in_input": True}),
}


@pytest.fixture(scope="module", autouse=True)
def native_cpu_convs():
    """oneDNN's CPU convolution backward loses precision on caffe-scaled
    VGG inputs (tests/test_torch_train.py): off in this module."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@pytest.fixture(scope="module")
def data():
    """Points, their attributes, a texture and one batch (poses, their
    camera-to-world matrices, targets, label images)."""
    rng = np.random.default_rng(9)
    xyz = rng.uniform(-2, 2, size=(N, 3)).astype(np.float32)
    xyz[:, 2] -= 6.0
    normals = rng.normal(size=(N, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    h, w = HW
    K = np.array([[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]])
    P = camera.gl_projection(K, (w, h), 0.1, 50.0)
    views, ms = [], []
    for i in range(B):
        a = 0.1 * (i + 1)
        view = np.eye(4)
        view[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                        [-np.sin(a), 0, np.cos(a)]]
        view[:3, 3] = (0.2 * i, 0.1, 0.3)
        views.append(view)
        ms.append(camera.total_matrix(P, view))
    pc = {"xyz": xyz, "normals": normals,
          "labels": rng.integers(1, 6, N).astype(np.float32)}
    batch = {"total_m": np.stack(ms).astype(np.float32),
             "view_matrix": np.stack(views).astype(np.float32),
             "target": rng.uniform(size=(B, h, w, 3)).astype(np.float32),
             "label": rng.integers(0, 7, (B, h, w)).astype(np.int32)}
    texture = rng.uniform(size=(N, 8)).astype(np.float32)
    return xyz, pc, batch, texture


def _configs(name):
    config, tda = CONFIGS[name]
    return (JTP.config_from_dict(config, crop_size=HW,
                                 train_dataset_args=tda),
            TP.config_from_dict(config, crop_size=HW,
                                train_dataset_args=tda))


def _jax_batch(batch, pc):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["pointcloud"] = {k: jnp.asarray(v) for k, v in pc.items()}
    return jb


def _torch_batch(batch, pc):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["pointcloud"] = {k: torch.from_numpy(v) for k, v in pc.items()}
    return tb


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_pyramid_matches_read_tpu(data, name):
    xyz, pc, batch, texture = data
    cfg_j, cfg = _configs(name)
    assert cfg.net_in_channels == cfg_j.net_in_channels
    assert cfg.label_in_input == cfg_j.label_in_input
    jb, tb = _jax_batch(batch, pc), _torch_batch(batch, pc)
    want = JTP._build_pyramid(
        cfg_j, jnp.asarray(texture), jnp.asarray(xyz), jb["total_m"],
        pointcloud=jb["pointcloud"], gt_label=jb["label"],
        view_m=jb["view_matrix"])
    got = TP.build_pyramid(cfg, (torch.from_numpy(texture),),
                           torch.from_numpy(xyz), tb["total_m"],
                           pointcloud=tb["pointcloud"], gt_label=tb["label"],
                           view_m=tb["view_matrix"])
    assert len(got) == len(want) == cfg.num_scales
    for lvl, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape == (
            B, HW[0] >> lvl, HW[1] >> lvl, cfg.net_in_channels)
        assert g.is_contiguous()
        g = g.numpy()
        if cfg.supersampling > 1:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        elif name == "depth_normals_l":
            # [depth | normals_l (3) | descriptors (8)]
            np.testing.assert_array_equal(g[..., :1], w[..., :1])
            np.testing.assert_allclose(g[..., 1:4], w[..., 1:4], rtol=0,
                                       atol=2e-7)
            np.testing.assert_array_equal(g[..., 4:], w[..., 4:])
        else:
            np.testing.assert_array_equal(g, w)
    if name == "label_in_input":   # the labels are the label image's
        lab = got[0][..., 0].numpy()
        covered = lab != 0
        np.testing.assert_array_equal(lab[covered],
                                      batch["label"][covered])


def test_label_in_input_refuses_supersampling(data):
    xyz, pc, batch, texture = data
    config, tda = CONFIGS["label_in_input"]
    cfg = TP.config_from_dict(dict(config, supersampling=2), crop_size=HW,
                              train_dataset_args=tda)
    cfg_j = JTP.config_from_dict(dict(config, supersampling=2),
                                 crop_size=HW, train_dataset_args=tda)
    jb, tb = _jax_batch(batch, pc), _torch_batch(batch, pc)
    with pytest.raises(ValueError):
        JTP._build_pyramid(cfg_j, jnp.asarray(texture), jnp.asarray(xyz),
                           jb["total_m"], pointcloud=jb["pointcloud"],
                           gt_label=jb["label"])
    with pytest.raises(ValueError, match="supersampling"):
        TP.build_pyramid(cfg, (torch.from_numpy(texture),),
                         torch.from_numpy(xyz), tb["total_m"],
                         pointcloud=tb["pointcloud"], gt_label=tb["label"])


def test_view_dependent_modes_need_view_matrices(data):
    xyz, pc, batch, texture = data
    _, cfg = _configs("depth_normals_l")
    tb = _torch_batch(batch, pc)
    with pytest.raises(ValueError, match="view_matrix"):
        TP.build_pyramid(cfg, (torch.from_numpy(texture),),
                         torch.from_numpy(xyz), tb["total_m"],
                         pointcloud=tb["pointcloud"])


@pytest.fixture(scope="module")
def jax_states(tmp_path_factory):
    """``get(cfg) -> (flax net, JAX TrainState, its checkpoint path)``:
    one ``create_state(PRNGKey(0))`` per net input width, jitted, made
    once and shared by the configurations of that width."""
    made = {}

    def get(cfg_j):
        c = cfg_j.net_in_channels
        if c not in made:
            net = FlaxUNet(num_input_channels=c, **SMALL)
            state = jax.jit(lambda k: JTP.create_state(
                k, cfg_j, n_points=N, net=net)[0])(jax.random.PRNGKey(0))
            path = str(tmp_path_factory.mktemp(f"in{c}") / "ckpt")
            JCK.save_checkpoint(path, state, config={})
            made[c] = (net, state, path)
        return made[c]

    return get


@pytest.mark.parametrize("name", ["ss2_sort", "depth_normals_l",
                                  "label_in_input"])
def test_first_step_and_eval_match_jax(data, jax_states, name):
    xyz, pc, batch, _ = data
    cfg_j, cfg = _configs(name)
    net, state, path = jax_states(cfg_j)
    vgg = None
    jb, jxyz = _jax_batch(batch, pc), jnp.asarray(xyz)

    def loss_fn(params, texture):
        out, _, _ = JTP._forward(
            net, cfg_j, params, state.batch_stats, texture, jxyz,
            jb["total_m"], train=True, pointcloud=jb["pointcloud"],
            gt_label=jb["label"], view_m=jb["view_matrix"])
        return JTP._losses(cfg_j, vgg, out, jb)[0]

    loss_j, grads = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(
        state.params, state.texture)
    want = JCK._flatten({"params": grads[0], "texture": grads[1]})

    tstate = TP.state_from_flat(CK.load_checkpoint(path)[0], "cpu")
    tvgg = None
    tnet = UNet(num_input_channels=cfg.net_in_channels, **SMALL)
    tb, txyz = _torch_batch(batch, pc), torch.from_numpy(xyz)
    metrics, _, _, g_flat, g_tex = TP._loss_and_grads(
        tnet, cfg, tvgg, tstate, txyz, tb, False)
    np.testing.assert_allclose(float(metrics["loss"]), float(loss_j),
                               rtol=1e-4)
    got = {"params/" + k.replace(".", "/"): g.numpy()
           for k, g in tstate.layout.views(g_flat).items()}
    got["texture"] = g_tex[0].numpy()
    assert set(got) == set(want)
    s64 = dataclasses.replace(
        tstate, flat_params=tstate.flat_params.double(),
        batch_stats={k: v.double() for k, v in tstate.batch_stats.items()},
        texture=(tstate.texture[0].double(),))
    b64 = dict(tb, target=tb["target"].double())
    _, _, _, g64, t64 = TP._loss_and_grads(
        tnet, cfg, None, s64, txyz, b64, False)
    truth = {"params/" + k.replace(".", "/"): g.numpy()
             for k, g in tstate.layout.views(g64).items()}
    truth["texture"] = t64[0].numpy()

    def off(g, key):
        return float(np.abs(np.asarray(g) - truth[key]).max()
                     / np.abs(truth[key]).max())

    for key, g in got.items():
        atol = max(GRAD_ATOL, 2.25 * off(want[key], key))
        np.testing.assert_allclose(g, want[key], rtol=0, atol=atol * float(
            np.abs(want[key]).max()), err_msg=key)
    port, jax_err = (max(off(grads[k], k) for k in truth)
                     for grads in (got, want))
    assert port <= 1.25 * jax_err, (port, jax_err)
    # the whole step runs on the same loss, then the eval step
    new, m = TP.make_train_step(tnet, cfg, tvgg)(tstate, txyz, tb)
    np.testing.assert_allclose(float(m["loss"]), float(metrics["loss"]),
                               rtol=1e-6)
    assert new.step == 1
    im_j, ev_j = JTP.make_eval_step(net, cfg_j, vgg)(state, jxyz, jb)
    im, ev = TP.make_eval_step(tnet, cfg, tvgg)(tstate, txyz, tb)
    assert tuple(im.shape) == np.asarray(im_j).shape
    for key in ("loss", "huber_loss", "psnr", "ssim"):
        np.testing.assert_allclose(ev[key].numpy(), np.asarray(ev_j[key]),
                                   rtol=1e-4, err_msg=key)
