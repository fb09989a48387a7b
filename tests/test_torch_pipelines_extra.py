"""The pix2pix and rgb_texture pipelines and their CLI: the port against
read_tpu, on the CPU.

- ``multiscale_inputs``: the raw-mode maps grouped by ``input_modality``
  as JAX groups them (bit-equal gathers).
- 3 pix2pix steps from a JAX-written state (``UNet(base_channel=8,
  num_res=1)``, 32x32 crops, B=2, VGG on): the first step's gradients
  against read_tpu's own float32 and float64 gradients (the Flax UNet
  run in float64 under ``jax.enable_x64``; see the test); each step's
  loss, from JAX's state before it, within 1e-6 relative, the BatchNorm
  statistics after it within 1e-5, the step, Adam's count, and the
  parameters after it within 1e-5 where its gradient is not tiny
  (Adam's first updates are sign-like for tiny gradients; see
  ``tests/test_torch_train.py``).
- 3 rgb_texture steps, with faces (the triangle raster) and without (the
  point raster's uv), from JAX's state (with faces run op by op, see the
  fixture): losses and PSNR within 1e-6 relative, the tables and RMS
  moments after them within 1e-5.
- ``adam_update``/``rms_update`` against ``optax.adam``/``optax.rmsprop``
  as the two steps build them (then ``* lr_scale``), bit for bit or 1e-7.
- Checkpoints: a JAX-written state of each pipeline carried into the
  port and back bit for bit, and a port-written one loaded by
  ``read_tpu.utils.ckpt.load_checkpoint`` with JAX's template.
- The CLI ``--pipeline pix2pix`` and ``--pipeline rgb_texture
  [--use-mesh]`` on two 32x32 scenes (one a textured mesh whose manifest
  names its ``mesh``), ``--headless-platform cpu``: checkpoint names and
  rotation as ``read_tpu.train``'s rules leave them, ``--resume``
  continuing the step, val PSNR printed, the triangle raster used for the
  mesh scene.
"""

import dataclasses
import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from read_tpu.criterions import vgg as JV
from read_tpu.models import unet as JU
from read_tpu.models.unet import UNet as FlaxUNet
from read_tpu.ops import rasterize as JR
from read_tpu.ops import render_modes as JRM
from read_tpu.pipelines import pix2pix_pipeline as JP2P
from read_tpu.pipelines import rgb_texture_pipeline as JRGB
from read_tpu.pipelines import texture_pipeline as JTP
from read_tpu.scene import camera
from read_tpu.scene import io as JIO
from read_tpu.utils import ckpt as JCK
from read_tpu_torch import train as TRAIN
from read_tpu_torch.models.unet import UNet
from read_tpu_torch.ops import rasterize as R
from read_tpu_torch.ops import rasterize_mesh as RMesh
from read_tpu_torch.pipelines import pix2pix_pipeline as P2P
from read_tpu_torch.pipelines import rgb_texture_pipeline as RGB
from read_tpu_torch.pipelines import texture_pipeline as TP
from read_tpu_torch.utils import ckpt as CK
from read_tpu_torch.utils import convert as CV

N, B, HW = 2000, 2, (32, 32)
GRAD_ATOL = 2e-4            # x max|g|, tests/test_torch_train.py
SMALL = dict(base_channel=8, num_res=1)


@pytest.fixture(scope="module", autouse=True)
def native_cpu_convs():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``. Patched into
    ``read_tpu.models.unet`` (its BatchNorm and output casts name
    float32), it runs the Flax UNet in float64 under ``jax.enable_x64``:
    read_tpu's own float64 gradient, the referee of the port's."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _grid_mesh(nx=24, ny=24, z=-6.0):
    """A bumpy ``nx x ny``-vertex grid facing the camera, two triangles a
    quad, uv over [0, 1]: ``(verts, faces, uv, rgb)``."""
    rng = np.random.default_rng(8)
    u, v = np.meshgrid(np.linspace(0, 1, nx), np.linspace(0, 1, ny))
    verts = np.stack([-3 + 6 * u, -3 + 6 * v,
                      z + 0.3 * np.sin(6 * u) + 0.05 * rng.normal(
                          size=u.shape)], -1).reshape(-1, 3)
    i = np.arange(nx * ny).reshape(ny, nx)
    a, b, c, d = i[:-1, :-1], i[:-1, 1:], i[1:, :-1], i[1:, 1:]
    faces = np.concatenate([np.stack([a, b, d], -1).reshape(-1, 3),
                            np.stack([a, d, c], -1).reshape(-1, 3)])
    uv = np.stack([u, v], -1).reshape(-1, 2)
    rgb = rng.uniform(size=(nx * ny, 3))
    return (verts.astype(np.float32), faces.astype(np.int32),
            uv.astype(np.float32), rgb.astype(np.float32))


def _poses(n, P, shift=0.0):
    ms = []
    for i in range(n):
        view = np.eye(4)
        view[0, 3], view[1, 3] = 0.15 * i + shift, -0.1 * i
        ms.append(camera.total_matrix(P, view))
    return np.stack(ms).astype(np.float32)


def _cam(hw=HW, f=30.0):
    h, w = hw
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    return K, camera.gl_projection(K, (w, h), 0.1, 50.0)


def _batches(rng, P, steps=3):
    return [{"total_m": _poses(B, P, 0.1 * s),
             "target": rng.uniform(size=(B, *HW, 3)).astype(np.float32)}
            for s in range(steps)]


def test_multiscale_inputs_matches_jax():
    rng = np.random.default_rng(1)
    xyz = rng.uniform(-2, 2, size=(N, 3)).astype(np.float32)
    xyz[:, 2] -= 6.0
    pc = {"rgb": rng.uniform(size=(N, 3)).astype(np.float32),
          "xyz_c": rng.uniform(size=(N, 3)).astype(np.float32)}
    _, P = _cam()
    ms = _poses(B, P)
    jl = JR.rasterize_pyramid_pooled(jnp.asarray(xyz), jnp.asarray(ms), HW,
                                     4)
    tl = R.rasterize_pyramid_pooled(torch.from_numpy(xyz),
                                    torch.from_numpy(ms), HW, 4)
    for k in (1, 2, 3):
        # k maps a scale: each level repeated k times, modes cycling
        modes = [("colors", "xyz", "depth")[i % 3] for i in range(4 * k)]
        want = JP2P.multiscale_inputs(modes, [jl[i // k] for i in
                                              range(4 * k)], pc,
                                      input_modality=k)
        got = P2P.multiscale_inputs(modes, [tl[i // k] for i in
                                            range(4 * k)], pc,
                                    input_modality=k)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------------------------
# pix2pix
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def p2p_ref(tmp_path_factory):
    rng = np.random.default_rng(5)
    xyz = rng.uniform(-2, 2, size=(N, 3)).astype(np.float32)
    xyz[:, 2] -= 6.0
    rgb = rng.uniform(size=(N, 3)).astype(np.float32)
    _, P = _cam()
    batches = _batches(rng, P)
    cfg = JTP.PipelineConfig(crop_size=HW)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JP2P, "UNet", functools.partial(FlaxUNet, **SMALL))
        state, net, opt = JP2P.create_pix2pix_state(jax.random.PRNGKey(0),
                                                    cfg)
    path = str(tmp_path_factory.mktemp("p2p") / "ckpt")
    JCK.save_checkpoint(path, state, config={})
    vgg = JV.random_vgg_params(0)
    pc = {"rgb": rgb}
    jxyz = jnp.asarray(xyz)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]

    def loss_fn(params, net, batch_stats, vgg, target):
        levels = JR.rasterize_pyramid_pooled(jxyz, jb[0]["total_m"], HW, 4)
        pyr = [JRM.render_mode("colors", ix, dep, {"rgb": jnp.asarray(rgb)})
               for ix, dep in levels]
        out, _ = net.apply({"params": params, "batch_stats": batch_stats},
                           *pyr, train=True, mutable=["batch_stats"])
        return JTP._losses(cfg, vgg, out, dict(jb[0], target=target))[0]

    grads = jax.jit(jax.grad(loss_fn), static_argnums=1)(
        state["params"], net, state["batch_stats"], vgg, jb[0]["target"])
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(JU, "jnp", _Float64Numpy())
        grads64 = jax.jit(jax.grad(loss_fn), static_argnums=1)(
            _f64(state["params"]), net.clone(dtype=jnp.float64),
            _f64(state["batch_stats"]), _f64(vgg),
            batches[0]["target"].astype(np.float64))
    # XLA's fused program may round a projection otherwise than JAX op by
    # op, which the port follows bit for bit: on a pose with a perturbed
    # matrix one edge pixel moved. The jitted step below is the
    # reference only where its pyramids are the op-by-op ones.
    for b in jb:
        eager = JR.rasterize_pyramid_pooled(jxyz, b["total_m"], HW, 4)
        fused = jax.jit(lambda m: JR.rasterize_pyramid_pooled(
            jxyz, m, HW, 4))(b["total_m"])
        for (ie, _), (i_f, _) in zip(eager, fused):
            np.testing.assert_array_equal(np.asarray(ie), np.asarray(i_f))
    step = JP2P.make_pix2pix_step(net, cfg, opt, vgg, pc)
    s, losses, states = state, [], [JCK._flatten(state)]
    for b in jb:
        s, m = step(s, jxyz, b)
        losses.append(float(m["loss"]))
        states.append(JCK._flatten(s))
    return dict(path=path, xyz=xyz, rgb=rgb, batches=batches,
                vgg=[(np.asarray(w), np.asarray(b)) for w, b in vgg],
                grads=JCK._flatten({"params": grads}),
                grads64=JCK._flatten({"params": grads64}), losses=losses,
                states=states, state=state)


def _p2p_port(ref):
    cfg = TP.PipelineConfig(crop_size=HW)
    net = UNet(num_input_channels=3, **SMALL)
    state = P2P.pix2pix_state_from_flat(CK.load_checkpoint(ref["path"])[0],
                                        "cpu")
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in ref["batches"]]
    return (net, cfg, CV.vgg_params_from_numpy(ref["vgg"], "cpu"), state,
            torch.from_numpy(ref["xyz"]), batches)


def _p2p_grads(net, cfg, vgg, state, xyz, batch, rgb):
    """The port's first-step gradient (``loss_and_grad``, as the step
    takes it) at the state's dtype."""
    g = P2P.loss_and_grad(net, cfg, vgg, state, xyz, batch, {"rgb": rgb})[3]
    return {"params/" + k.replace(".", "/"): t.numpy()
            for k, t in state.layout.views(g).items()}


def test_pix2pix_steps_match_jax(p2p_ref):
    """The first step's gradients against read_tpu's, tensor by tensor:
    the port's float64 gradient within 1e-9 x max|g| of JAX's float64
    gradient, the port's float32 gradient within 2e-4 x max|g| of it, and
    of JAX's float32 gradient by the rule of ``tests/test_torch_splat.py``
    (2e-4 x max|g|, or 2.25x JAX's own float32 distance from its float64
    run where that is larger). Then each step from JAX's own state
    before it: the loss, the BatchNorm statistics, the step counts, and
    the parameters where that step's gradient is far from zero (Adam's
    first updates are sign-like for tiny gradients; chained Adam states
    part ways, see below)."""
    net, cfg, vgg, state, xyz, batches = _p2p_port(p2p_ref)
    rgb = torch.from_numpy(p2p_ref["rgb"])
    got = _p2p_grads(net, cfg, vgg, state, xyz, batches[0], rgb)
    s64 = dataclasses.replace(
        state, flat_params=state.flat_params.double(),
        batch_stats={k: v.double() for k, v in state.batch_stats.items()})
    port64 = _p2p_grads(
        net, cfg, [(w.double(), b.double()) for w, b in vgg], s64, xyz,
        dict(batches[0], target=batches[0]["target"].double()),
        rgb.double())
    assert set(got) == set(p2p_ref["grads"]) == set(p2p_ref["grads64"])
    for key, g in got.items():
        truth, want = p2p_ref["grads64"][key], p2p_ref["grads"][key]
        scale = float(np.abs(truth).max())
        np.testing.assert_allclose(port64[key], truth, rtol=0,
                                   atol=1e-9 * scale, err_msg=key)
        np.testing.assert_allclose(g, truth, rtol=0,
                                   atol=GRAD_ATOL * scale, err_msg=key)
        jax_off = float(np.abs(want - truth).max()) / scale
        np.testing.assert_allclose(
            g, want, rtol=0, atol=max(GRAD_ATOL, 2.25 * jax_off)
            * float(np.abs(want).max()), err_msg=key)
    # each step from JAX's own state before it: an Adam update moves a
    # parameter whose gradient is tiny by about +-lr on its float32 sign,
    # so chained states part ways (the losses by 2e-3 after 3 steps)
    step = P2P.make_pix2pix_step(net, cfg, vgg, {"rgb": p2p_ref["rgb"]})
    for i, b in enumerate(batches):
        before = P2P.pix2pix_state_from_flat(p2p_ref["states"][i], "cpu")
        new, m = step(before, xyz, b)
        np.testing.assert_allclose(float(m["loss"]), p2p_ref["losses"][i],
                                   rtol=1e-6, err_msg=f"step {i}")
        after = P2P.flat_from_pix2pix_state(new)
        prev, want = p2p_ref["states"][i], p2p_ref["states"][i + 1]
        assert set(after) == set(want)
        assert int(after["step"]) == int(after["opt/0/count"]) == i + 1
        for key, arr in want.items():
            if key.startswith("batch_stats/"):
                np.testing.assert_allclose(after[key], arr, rtol=0,
                                           atol=1e-5, err_msg=key)
            if not key.startswith("params/"):
                continue
            # the step's gradient, from JAX's first moments (b1 = 0.9)
            mu = "opt/0/mu/" + key[len("params/"):]
            g = (want[mu] - 0.9 * prev[mu]) / 0.1
            big = np.abs(g) > 1e-2 * np.abs(g).max()
            np.testing.assert_allclose(after[key][big], arr[big], rtol=0,
                                       atol=1e-5, err_msg=f"{key} step {i}")


def test_pix2pix_checkpoints_both_ways(p2p_ref, tmp_path):
    flat, _ = CK.load_checkpoint(p2p_ref["path"])
    back = P2P.flat_from_pix2pix_state(P2P.pix2pix_state_from_flat(flat,
                                                                  "cpu"))
    assert set(back) == set(flat)
    for key, arr in flat.items():
        assert back[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(back[key], arr, err_msg=key)
    state, _ = P2P.create_pix2pix_state(torch.Generator().manual_seed(1),
                                        TP.PipelineConfig(crop_size=HW),
                                        net=UNet(num_input_channels=3,
                                                 **SMALL), device="cpu")
    CK.save_checkpoint(str(tmp_path / "port"),
                       P2P.flat_from_pix2pix_state(state), config={})
    restored, _ = JCK.load_checkpoint(str(tmp_path / "port"),
                                      template=p2p_ref["state"])
    assert int(restored["step"]) == 0
    assert set(JCK._flatten(restored)) == set(flat)


# --------------------------------------------------------------------------
# rgb_texture
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rgb_ref(tmp_path_factory):
    verts, faces, uv, _ = _grid_mesh()
    rng = np.random.default_rng(6)
    _, P = _cam()
    batches = _batches(rng, P)
    state, opt = JRGB.create_rgb_texture_state(jax.random.PRNGKey(0), 16,
                                               lr=0.1)
    path = str(tmp_path_factory.mktemp("rgb") / "ckpt")
    JCK.save_checkpoint(path, state, config={})
    out = dict(path=path, scene=(verts, faces, uv), batches=batches,
               state=state)
    for with_faces in (True, False):
        step = JRGB.make_rgb_texture_step(
            opt, {"uv2d": uv}, *HW, reg_weight=0.05,
            faces=faces if with_faces else None)
        s, ms = state, []
        # op by op: XLA's fused program of the triangle raster rounds the
        # edge functions otherwise and moves 8 edge pixels of this mesh
        # (jitted against eager JAX); the port does JAX's arithmetic op by
        # op, as eager JAX does
        with jax.disable_jit(with_faces):
            for b in batches:
                s, m = step(s, jnp.asarray(verts),
                            {k: jnp.asarray(v) for k, v in b.items()})
                ms.append({k: float(v) for k, v in m.items()})
        out[with_faces] = dict(metrics=ms, after=JCK._flatten(s))
    return out


@pytest.mark.parametrize("with_faces", [True, False])
def test_rgb_texture_steps_match_jax(rgb_ref, with_faces):
    verts, faces, uv = rgb_ref["scene"]
    state = RGB.rgb_state_from_flat(CK.load_checkpoint(rgb_ref["path"])[0],
                                    "cpu")
    step = RGB.make_rgb_texture_step(0.1, {"uv2d": uv}, *HW,
                                     reg_weight=0.05,
                                     faces=faces if with_faces else None)
    want = rgb_ref[with_faces]
    for i, b in enumerate(rgb_ref["batches"]):
        state, m = step(state, torch.from_numpy(verts),
                        {k: torch.from_numpy(v) for k, v in b.items()})
        for key in ("loss", "psnr"):
            np.testing.assert_allclose(float(m[key]), want["metrics"][i][key],
                                       rtol=1e-6, err_msg=f"{key} {i}")
    after = RGB.flat_from_rgb_state(state)
    assert set(after) == set(want["after"])
    for key, arr in want["after"].items():
        np.testing.assert_allclose(after[key], arr, rtol=0, atol=1e-5,
                                   err_msg=key)
    # the mask: the triangle raster covers the grid's interior, the
    # point raster only its vertices' pixels
    uv_map, mask = RGB.uv_and_mask(
        torch.from_numpy(verts), torch.from_numpy(rgb_ref["batches"][0][
            "total_m"]), torch.from_numpy(uv), *HW,
        torch.from_numpy(faces) if with_faces else None)
    assert (float(mask.mean()) > 0.8) == with_faces


def test_rgb_checkpoints_both_ways(rgb_ref, tmp_path):
    flat, _ = CK.load_checkpoint(rgb_ref["path"])
    assert "tables/3" in flat and "opt/0/nu/3" in flat
    back = RGB.flat_from_rgb_state(RGB.rgb_state_from_flat(flat, "cpu"))
    assert set(back) == set(flat)
    for key, arr in flat.items():
        assert back[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(back[key], arr, err_msg=key)
    mine = RGB.create_rgb_texture_state(16, device="cpu")
    CK.save_checkpoint(str(tmp_path / "port"), RGB.flat_from_rgb_state(mine),
                       config={})
    restored, _ = JCK.load_checkpoint(str(tmp_path / "port"),
                                      template=rgb_ref["state"])
    for a, b in zip(restored["tables"], rgb_ref["state"]["tables"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_optimizers_match_optax():
    rng = np.random.default_rng(9)
    p = rng.normal(size=(300,)).astype(np.float32)
    grads = [rng.normal(size=(300,)).astype(np.float32) * s
             for s in (1.0, 1e-3, 30.0)]
    lr, scale = 1e-4, np.float32(0.5)
    for name, opt in (("adam", optax.adam(lr)),
                      ("rms", optax.rmsprop(lr, decay=0.99, eps=1e-8))):
        st = opt.init(jnp.asarray(p))
        tp, jp = torch.from_numpy(p), jnp.asarray(p)
        tst = (TP.AdamState(0, torch.zeros(300), torch.zeros(300))
               if name == "adam" else TP.RmsState((torch.zeros(300),)))
        for g in grads:
            u, st = opt.update(jnp.asarray(g), st, jp)
            jp = optax.apply_updates(jp, u * scale)
            if name == "adam":
                tu, tst = TP.adam_update(torch.from_numpy(g), tst)
            else:
                (tu,), tst = TP.rms_update((torch.from_numpy(g),), tst)
            tp = tp + (tu * lr) * torch.tensor(scale)
            np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                                       atol=1e-7, err_msg=name)


# --------------------------------------------------------------------------
# The CLI
# --------------------------------------------------------------------------

SCENES = ("toyP", "toyM")


def _write_ply_mesh(path, verts, faces, uv, rgb):
    """An ascii PLY with per-vertex colour and texture coordinates
    (``s``, ``t``) and the faces."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(verts)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\n"
                "property uchar blue\nproperty float s\nproperty float t\n"
                f"element face {len(faces)}\n"
                "property list uchar int vertex_indices\nend_header\n")
        c = (rgb * 255).astype(np.uint8)
        for p, col, q in zip(verts, c, uv):
            f.write(f"{p[0]:.7g} {p[1]:.7g} {p[2]:.7g} {col[0]} {col[1]} "
                    f"{col[2]} {q[0]:.7g} {q[1]:.7g}\n")
        for a, b, d in faces:
            f.write(f"3 {a} {b} {d}\n")


def _write_scene(root, name, mesh):
    import imageio.v2 as imageio
    d = root / name
    os.makedirs(d / "images", exist_ok=True)
    rng = np.random.default_rng(len(name) + mesh)
    if mesh:
        xyz, faces, uv, rgb = _grid_mesh()
        _write_ply_mesh(d / "mesh.ply", xyz, faces, uv, rgb)
    else:
        xyz = rng.uniform(-2, 2, size=(N, 3)).astype(np.float32)
        xyz[:, 2] -= 6.0
        rgb = rng.uniform(size=(N, 3)).astype(np.float32)
    JIO.write_ply(str(d / "pc.ply"), xyz, rgb)
    K, P = _cam()
    views = []
    for i in range(6):
        view = np.eye(4)
        view[0, 3] = 0.2 * i
        views.append(view)
        idx, _ = JR.rasterize_reference(xyz, camera.total_matrix(P, view),
                                        *HW)
        img = np.zeros((*HW, 3), np.float32)
        img[idx >= 0] = rgb[idx[idx >= 0]]
        imageio.imwrite(str(d / "images" / f"{i:06}.png"),
                        (img * 255).astype(np.uint8))
    np.savetxt(d / "cam.txt", np.vstack([[HW[1], HW[0], 0], K]))
    np.savetxt(d / "poses.dat", np.stack(views).reshape(-1, 4))
    manifest = {"viewport_size": [HW[1], HW[0]], "pointcloud": "pc.ply",
                "intrinsic_matrix": "cam.txt", "view_matrix": "poses.dat"}
    if mesh:
        manifest["mesh"] = "mesh.ply"
    with open(d / "scene.json", "w") as f:
        json.dump(manifest, f)
    return {"scene_path": str(d / "scene.json"),
            "target_path": str(d / "images"),
            "target_name": "{label:06d}.png"}


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("alt_cli")
    paths = {"datasets": {name: _write_scene(root, name, i == 1)
                          for i, name in enumerate(SCENES)}}
    with open(root / "paths.json", "w") as f:
        json.dump(paths, f)
    config = {"paths_file": str(root / "paths.json"),
              "crop_size": f"{HW[1]}x{HW[0]}", "batch_size": 1,
              "criterion": "huber_only", "splitter": "split_by_step",
              "splitter_args": {"val_step": 3}, "log_freq": 1,
              "save_freq": 1, "headless_platform": "cpu",
              "texture_size": 16,
              "train_dataset_args": {"inner_batch": 1, "num_samples": 1}}
    with open(root / "config.json", "w") as f:
        json.dump(config, f)
    return root


def _run(root, name, extra):
    save = root / f"logs_{name}"
    streams = sys.stdout, sys.stderr
    try:
        rc = TRAIN.main(["--config", str(root / "config.json"),
                         "--save-dir", str(save), "--name", name] + extra)
    finally:
        sys.stdout, sys.stderr = streams
    assert rc == 0
    (exp,) = os.listdir(save)
    return save / exp


def _expected(pipeline, scenes, epochs, val_psnr):
    """The checkpoint directory ``read_tpu.train``'s rules leave: each
    epoch saved (save_freq 1) and rotated to 3 with
    ``read_tpu.utils.ckpt.rotate_checkpoints``, ``best_`` on a better val
    PSNR."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        best = float("inf")
        for e in range(epochs):
            for s in scenes:
                os.makedirs(os.path.join(d, f"ckpt_{pipeline}_{s}_{e}"))
                JCK.rotate_checkpoints(d, f"ckpt_{pipeline}_{s}", keep=3)
                if -val_psnr[e] < best:
                    os.makedirs(os.path.join(d, f"best_{pipeline}_{s}"),
                                exist_ok=True)
            best = min(best, -val_psnr[e])
        return sorted(os.listdir(d))


@pytest.fixture(scope="module", autouse=True)
def small_unet():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(P2P, "UNet", functools.partial(UNet, **SMALL))
        yield


@pytest.mark.parametrize("pipeline,flags", [
    ("pix2pix", []), ("rgb_texture", []), ("rgb_texture", ["--use-mesh"])])
def test_alt_pipeline_cli(cli_root, pipeline, flags, monkeypatch):
    calls = []
    real = RMesh.rasterize_mesh_batch

    def spy(*a, **k):
        calls.append(a[3:5])
        return real(*a, **k)

    monkeypatch.setattr(RMesh, "rasterize_mesh_batch", spy)
    name = pipeline + "".join(flags).replace("-", "_")
    exp = _run(cli_root, name, ["--pipeline", pipeline, "--epochs", "4",
                                "--max-steps-per-epoch", "2"] + flags)
    with open(exp / "history.json") as f:
        hist = json.load(f)
    assert [h["epoch"] for h in hist] == [0, 1, 2, 3]
    psnr = [h["val_psnr"] for h in hist]
    assert all(np.isfinite(h["train_loss"]) for h in hist)
    assert all(np.isfinite(psnr)) and all(p > 0 for p in psnr)
    # read_tpu counts the steps over the epoch: 2 on toyP, then 1 on toyM
    assert [len(h["step_ms"]) for h in hist] == [3] * 4
    assert sorted(os.listdir(exp / "checkpoints")) == _expected(
        pipeline, SCENES, 4, psnr)
    # the triangle raster ran for the mesh scene only, with --use-mesh
    assert bool(calls) == ("--use-mesh" in flags and pipeline != "pix2pix")
    with open(exp / "log.txt") as f:
        log = f.read()
    assert "val psnr" in log and "done; best val psnr" in log
    # --resume one more epoch from the checkpoints
    again = _run(cli_root, name + "_resume",
                 ["--pipeline", pipeline, "--epochs", "1",
                  "--max-steps-per-epoch", "2",
                  "--resume", str(exp / "checkpoints")] + flags)
    with open(again / "log.txt") as f:
        log = f.read()
    for s in SCENES if pipeline == "rgb_texture" else SCENES[:1]:
        last = CK.latest_checkpoint(str(exp / "checkpoints"),
                                    f"ckpt_{pipeline}_{s}")
        assert f"resumed {s} from {last}" in log
    flat, _ = CK.load_checkpoint(str(again / "checkpoints" /
                                     f"ckpt_{pipeline}_{SCENES[0]}_0"))
    # pix2pix: one state, 4 x 3 steps before; rgb_texture: 4 x 2 on toyP
    assert int(flat["step"]) == (15 if pipeline == "pix2pix" else 10)


def test_texture_cli_with_mesh_textures_and_augmentation(cli_root, tmp_path,
                                                         monkeypatch):
    """``--pipeline texture --use-mesh`` with the train dataset's
    ``drop_points``/``perturb_points``: the mesh scene trains through the
    triangle raster, its checkpoint holds the four tables (``texture/0..3``
    at ``--texture-size``), and the renderer serves it."""
    from read_tpu_torch import render as TR
    monkeypatch.setattr(TP, "UNet", functools.partial(UNet, **SMALL))
    calls = []
    real = RMesh.rasterize_mesh_batch

    def spy(*a, **k):
        calls.append(a[3:5])
        return real(*a, **k)

    monkeypatch.setattr(RMesh, "rasterize_mesh_batch", spy)
    with open(cli_root / "config.json") as f:
        config = json.load(f)
    config["train_dataset_args"] = dict(config["train_dataset_args"],
                                        drop_points=0.1, perturb_points=1.0)
    path = tmp_path / "config.json"
    with open(path, "w") as f:
        json.dump(config, f)
    save = tmp_path / "logs"
    streams = sys.stdout, sys.stderr
    try:
        assert TRAIN.main(["--config", str(path), "--save-dir", str(save),
                           "--use-mesh", "--epochs", "1",
                           "--max-steps-per-epoch", "2",
                           "--dataset-names", "toyM"]) == 0
    finally:
        sys.stdout, sys.stderr = streams
    (exp,) = os.listdir(save)
    ck = save / exp / "checkpoints" / "best_toyM"
    flat, meta = CK.load_checkpoint(str(ck))
    assert [flat[f"texture/{i}"].shape for i in range(4)] == [
        (16 >> i, 16 >> i, 8) for i in range(4)]
    assert meta["config"]["use_mesh"] and int(flat["step"]) == 2
    # a triangle raster at every level of every train step and val view
    assert (32, 32) in calls and (4, 4) in calls
    r = TR.NeuralRenderer(str(cli_root / "toyM" / "scene.json"), str(ck),
                          device="cpu")
    assert r.faces is not None and r.cfg.texture_size == 16
    img = r.infer(r.scene_data["view_matrix"][0])
    assert img.shape == (32, 32, 3) and np.isfinite(img).all()
