"""The port's serving slice as a whole against read_tpu, on the CPU.

- ``read_tpu_torch.render.NeuralRenderer`` vs ``read_tpu.render.
  NeuralRenderer`` on one JAX-written checkpoint (``TP.create_state``
  with ``raster_method='pallas'``, ``conv_impl='xla'``) of a tiny scene
  on disk, plain and with ``temporal_average``, and on the same weights
  under the default config (the exact ``sort`` z-buffer, K5's twin);
- the renderer at ``supersampling=2`` ('pallas' and 'sort'), from a
  checkpoint trained with ``depth`` + ``normals_l``, and in every raw
  mode (``render_mode``, also from a ``uv_1d_p3`` checkpoint; gather
  modes bit-equal, the view-dependent and lit ones within
  ``tests/test_torch_render_modes.py``'s bounds), and the render CLI
  writing raw-mode PNGs;
- ``read_tpu_torch.frame.make_frame`` at a small size vs the JAX
  composition it ports (packed pyramid -> gather -> flax UNet);
- importing every module of the port (the kernel bench included) loads
  no JAX and nothing of ``read_tpu``, and no source of the port or
  ``chip_smoke.py`` names ``read_tpu`` in an import.

The UNet is cut to ``base_channel=8, num_res=1`` (the JAX pipeline's
``UNet`` is swapped for that width in this process only) to keep the
test fast; the port reads the width off the checkpoint. Tolerance:
``atol 5e-4, rtol 1e-3``.
"""

import copy
import functools
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from read_tpu.models import texture as JT
from read_tpu.models.unet import UNet as FlaxUNet
from read_tpu.ops import rasterize as JR
from read_tpu.pipelines import texture_pipeline as JTP
from read_tpu.render import NeuralRenderer as JaxRenderer
from read_tpu.scene import io as IO
from read_tpu.utils import ckpt as JCK
from read_tpu_torch import render as TR
from read_tpu_torch.data import image_io
from read_tpu_torch.frame import make_frame
from read_tpu_torch.utils import ckpt as CK
from read_tpu_torch.utils import convert as CV

TOL = dict(atol=5e-4, rtol=1e-3)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_UNET = functools.partial(FlaxUNet, base_channel=8, num_res=1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's CPU ops are small: one intra-op thread runs them
    fastest when the suite's workers share the cores (8 threads a
    worker ran them ~7x slower under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene_and_ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_scene")
    rng = np.random.default_rng(1)
    n, w, h = 4000, 48, 32
    xyz = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    xyz[:, 2] -= 6.0
    IO.write_ply(str(root / "pc.ply"), xyz,
                 rng.uniform(0, 1, size=(n, 3)).astype(np.float32))
    K = np.array([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]])
    np.savetxt(root / "cam.txt", np.vstack([[w, h, 0], K]))
    poses = []
    for i in range(2):
        pose = np.eye(4)
        pose[0, 3] = 0.2 * i
        poses.append(pose)
    np.savetxt(root / "poses.dat", np.stack(poses).reshape(-1, 4))
    with open(root / "scene.yaml", "w") as f:
        f.write(f"viewport_size: [{w}, {h}]\npointcloud: pc.ply\n"
                "intrinsic_matrix: cam.txt\nview_matrix: poses.dat\n")

    config = {"raster_method": "pallas", "conv_impl": "xla"}
    cfg = JTP.config_from_dict(config, crop_size=(32, 32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTP, "UNet", SMALL_UNET)
        state, _ = JTP.create_state(jax.random.PRNGKey(0), cfg, n_points=n)
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 2.0, a.shape).astype(np.float32),
        state.batch_stats)
    state = state.replace(batch_stats=stats)
    ckpt = str(root / "ckpt")
    JCK.save_checkpoint(ckpt, state, config=config)
    return str(root / "scene.yaml"), ckpt, poses


@pytest.fixture(scope="module")
def jax_renderers(scene_and_ckpt):
    scene, ckpt, _ = scene_and_ckpt
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTP, "UNet", SMALL_UNET)
        return (JaxRenderer(scene, ckpt),
                JaxRenderer(scene, ckpt, temporal_average=True))


def test_renderer_matches_read_tpu(scene_and_ckpt, jax_renderers):
    scene, ckpt, poses = scene_and_ckpt
    jr, _ = jax_renderers
    tr = TR.NeuralRenderer(scene, ckpt, device="cpu")
    assert (tr.vw, tr.vh) == (jr.vw, jr.vh) == (48, 32)
    assert tr.cfg.raster_method == "pallas"
    for pose in poses:
        want = jr.infer(pose)
        got = tr.infer(pose)
        assert got.shape == want.shape == (32, 48, 3)
        np.testing.assert_allclose(got, want, **TOL)
        dev = tr.infer_device(pose)
        assert tuple(dev.shape) == (1, 32, 48, 3)


def test_renderer_temporal_average_matches_read_tpu(scene_and_ckpt,
                                                    jax_renderers):
    scene, ckpt, poses = scene_and_ckpt
    _, jr = jax_renderers
    tr = TR.NeuralRenderer(scene, ckpt, temporal_average=True,
                           device="cpu")
    outs = []
    for pose in poses:   # the second frame averages with the first
        want = jr.infer(pose)
        got = tr.infer(pose)
        np.testing.assert_allclose(got, want, **TOL)
        outs.append(got)
    assert float(np.abs(outs[0] - outs[1]).max()) > 0


def test_renderer_takes_a_scene_dict(scene_and_ckpt):
    scene, ckpt, poses = scene_and_ckpt
    data = IO.load_scene_data(scene)
    a = TR.NeuralRenderer(scene, ckpt, device="cpu").infer(poses[1])
    b = TR.NeuralRenderer(data, ckpt, device="cpu").infer(poses[1])
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", ["pallas", "sort"])
def test_supersampled_renderer_matches_read_tpu(scene_and_ckpt,
                                                jax_renderers, method):
    """``supersampling=2``: the pyramid rasterized at 96x64 and resized
    down, then the UNet at 48x32, against read_tpu's renderer rebuilt at
    ss 2 with the same z-buffer."""
    scene, ckpt, poses = scene_and_ckpt
    jr = copy.copy(jax_renderers[0])
    jr.cfg = jr.cfg.replace(supersampling=2, raster_method=method)
    jr._build_fns()
    tr = TR.NeuralRenderer(scene, ckpt, supersampling=2,
                           raster_method=method, device="cpu")
    assert tr.cfg.supersampling == jr.cfg.supersampling == 2
    for pose in poses:
        pyr = tr.pyramid(pose)
        assert [tuple(x.shape) for x in pyr] == [
            (1, 32 >> i, 48 >> i, 8) for i in range(4)]
        want = jr.infer(pose)
        np.testing.assert_allclose(tr.infer(pose), want, **TOL)
    plain = TR.NeuralRenderer(scene, ckpt, raster_method=method,
                              device="cpu").infer(poses[0])
    assert float(np.abs(plain - want).max()) > 0


EXTRA_FMT = ", ".join(
    f"uv_1d_p1{s}, depth{s}, normals_l{s}"
    for s in [""] + [f"_ds{i}" for i in range(1, 5)])
RAW_MODES = ("colors", "xyz", "depth", "uv_1d", "uv_2d", "labels", "pca",
             "normals_m", "normals_l", "normals_r", "normals_d", "lit")
# as tests/test_torch_render_modes.py; and 'depth', normalized over the
# covered range (~7e-3 of NDC depth here): read_tpu's jitted raster
# rounds a depth 1 ulp (6e-8) off the eager one now and then, 8.4e-6
# after the normalization
RAW_TOL = {"normals_l": 2e-7, "normals_r": 2e-7, "normals_d": 2e-7,
           "lit": 5e-6, "depth": 2e-5}


@pytest.fixture(scope="module")
def extra_scene(tmp_path_factory):
    """A tiny scene with per-point normals and colours, poses that turn,
    a JAX checkpoint trained with ``depth`` + ``normals_l`` at every
    scale ('sort'; a 12-channel net input), and read_tpu's renderer of
    it."""
    root = tmp_path_factory.mktemp("extra_scene")
    rng = np.random.default_rng(3)
    n, w, h = 3000, 48, 32
    xyz = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    xyz[:, 2] -= 6.0
    normals = rng.normal(size=(n, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    IO.write_ply(str(root / "pc.ply"), xyz,
                 rng.uniform(0, 1, size=(n, 3)).astype(np.float32), normals)
    K = np.array([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]])
    np.savetxt(root / "cam.txt", np.vstack([[w, h, 0], K]))
    poses = []
    for i in range(2):
        a = 0.15 * (i + 1)
        pose = np.eye(4)
        pose[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                        [-np.sin(a), 0, np.cos(a)]]
        pose[:3, 3] = (0.2 * i, 0.1, 0.0)
        poses.append(pose)
    np.savetxt(root / "poses.dat", np.stack(poses).reshape(-1, 4))
    with open(root / "scene.yaml", "w") as f:
        f.write(f"viewport_size: [{w}, {h}]\npointcloud: pc.ply\n"
                "intrinsic_matrix: cam.txt\nview_matrix: poses.dat\n")
    config = {"conv_impl": "xla", "input_format": EXTRA_FMT}
    cfg = JTP.config_from_dict(config, crop_size=(32, 32))
    assert cfg.net_in_channels == 12
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTP, "UNet", SMALL_UNET)
        state, _ = JTP.create_state(jax.random.PRNGKey(0), cfg, n_points=n)
        stats = jax.tree_util.tree_map(
            lambda a: rng.uniform(0.5, 2.0, a.shape).astype(np.float32),
            state.batch_stats)
        ckpt = str(root / "ckpt")
        JCK.save_checkpoint(ckpt, state.replace(batch_stats=stats),
                            config=config)
        jr = JaxRenderer(str(root / "scene.yaml"), ckpt)
    return str(root / "scene.yaml"), ckpt, poses, jr


def test_extra_modes_renderer_matches_read_tpu(extra_scene):
    """A checkpoint trained with ``depth`` + ``normals_l``: the port
    renders its 12-channel input (the scene's normals and world xyz, the
    request's view matrix) as read_tpu does."""
    scene, ckpt, poses, jr = extra_scene
    tr = TR.NeuralRenderer(scene, ckpt, device="cpu")
    assert tr.cfg.extra_modes == jr.cfg.extra_modes
    assert tr.cfg.net_in_channels == 12
    assert sorted(tr.pc_attrs) == sorted(jr.pc_attrs) == ["normals", "xyz"]
    for pose in poses:
        np.testing.assert_allclose(tr.infer(pose), jr.infer(pose), **TOL)


@pytest.mark.parametrize("mode", RAW_MODES)
def test_raw_modes_match_read_tpu(extra_scene, tmp_path, mode):
    """Every raw mode of ``render_mode`` against read_tpu's on the same
    checkpoint ('sort'); the same frames from a ``uv_1d_p3`` copy of it,
    since the raw modes rasterize 1-px points whatever the format."""
    scene, ckpt, poses, jr = extra_scene
    tr = TR.NeuralRenderer(scene, ckpt, device="cpu")
    flat, meta = CK.load_checkpoint(ckpt)
    p3 = str(tmp_path / "ckpt_p3")
    CK.save_checkpoint(p3, flat, config=dict(
        meta["config"], input_format=EXTRA_FMT.replace("uv_1d_p1",
                                                       "uv_1d_p3")))
    t3 = TR.NeuralRenderer(scene, p3, device="cpu")
    assert t3.cfg.point_radius == 1
    for pose in poses:
        want = jr.render_mode(mode, pose)
        got = tr.render_mode(mode, pose)
        assert got.shape == want.shape == (32, 48,
                                           2 if mode == "uv_2d" else 3)
        assert got.dtype == np.float32
        if mode in RAW_TOL:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=RAW_TOL[mode])
        else:
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(t3.render_mode(mode, pose), got)


def test_renderer_sort_checkpoint_matches_read_tpu(scene_and_ckpt,
                                                    tmp_path):
    """The same weights under a default config (no raster_method: the
    exact 'sort' z-buffer) render as read_tpu renders them."""
    scene, ckpt, poses = scene_and_ckpt
    sort_ckpt = str(tmp_path / "ckpt_sort")
    shutil.copytree(ckpt, sort_ckpt)
    meta_path = os.path.join(sort_ckpt, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["config"] = {"conv_impl": "xla"}
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTP, "UNet", SMALL_UNET)
        jr = JaxRenderer(scene, sort_ckpt)
    tr = TR.NeuralRenderer(scene, sort_ckpt, device="cpu")
    assert tr.cfg.raster_method == jr.cfg.raster_method == "sort"
    for pose in poses:
        np.testing.assert_allclose(tr.infer(pose), jr.infer(pose), **TOL)


def test_render_cli_writes_frames(scene_and_ckpt, tmp_path, capsys):
    scene, ckpt, _ = scene_and_ckpt
    out = tmp_path / "frames"
    rc = TR.main(["--scene", scene, "--ckpt", ckpt, "--out", str(out),
                  "--fps-report", "--device", "cpu"])
    assert rc == 0
    assert sorted(os.listdir(out)) == ["000000.png", "000001.png"]
    assert '"frames": 2' in capsys.readouterr().out


def test_render_cli_writes_raw_mode_pngs(extra_scene, tmp_path):
    """``--mode normals_l``: one PNG per pose of the manifest, the
    renderer's raw frame as 8-bit."""
    scene, ckpt, _, _ = extra_scene
    out = tmp_path / "raw"
    assert TR.main(["--scene", scene, "--ckpt", ckpt, "--out", str(out),
                    "--mode", "normals_l", "--device", "cpu"]) == 0
    assert sorted(os.listdir(out)) == ["000000.png", "000001.png"]
    tr = TR.NeuralRenderer(scene, ckpt, device="cpu")
    for i, pose in enumerate(tr.scene_data["view_matrix"]):
        want = (tr.render_mode("normals_l", pose) * 255).astype(np.uint8)
        np.testing.assert_array_equal(   # imread gives cv2's BGR
            image_io.imread(str(out / f"{i:06}.png"))[..., ::-1], want)


def test_render_cli_needs_cuda_unless_told_cpu(scene_and_ckpt, tmp_path,
                                               capsys, monkeypatch):
    """Without CUDA the CLI refuses to render (and to report an fps)
    unless ``--device cpu`` asks for the plain twins."""
    scene, ckpt, _ = scene_and_ckpt
    out = tmp_path / "frames"
    monkeypatch.setattr(TR.torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        TR.main(["--scene", scene, "--ckpt", ckpt, "--out", str(out),
                 "--fps-report"])
    assert exc.value.code == 2
    assert "--device cpu" in capsys.readouterr().err
    assert not out.exists()


def test_make_frame_matches_jax_composition():
    """The benchmark frame at 48x64, 20k points, B=2, f32 operands vs
    rasterize_pyramid_pooled(method='pallas', pool_impl='packed') ->
    gather -> flax UNet on the same weights and table."""
    h, w = 48, 64
    frame_fn, args = make_frame(batch=2, operands="f32", device="cpu",
                                n_points=20000, hw=(h, w), focal=40.0,
                                base_channel=8, num_res=1)
    got = frame_fn(*args).numpy()
    net, table, xyz, total_m = args
    flat = CV.flat_from_variables(net.state_dict(), (table,))
    variables = {"params": {}, "batch_stats": {}}
    for key, arr in flat.items():
        if key == "texture":
            continue
        node = variables
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(arr)
    levels = JR.rasterize_pyramid_pooled(
        jnp.asarray(xyz.numpy()), jnp.asarray(total_m.numpy()), (h, w), 4,
        method="pallas", pool_impl="packed")
    pyr = [JT.sample_point_texture(jnp.asarray(flat["texture"]), ix)
           for ix, _ in levels]
    want = jax.jit(lambda v, *p: SMALL_UNET().apply(v, *p, train=False))(
        variables, *pyr)["im_out"]
    assert got.shape == (2, h, w, 3)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


_IMPORT_ALL = """
import importlib, pkgutil, sys
import read_tpu_torch
names = [m.name for m in pkgutil.walk_packages(read_tpu_torch.__path__,
                                               "read_tpu_torch.")]
assert "read_tpu_torch.kernel_bench" in names, names
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "flax", "optax", "triton",
                                    "read_tpu"))
assert not bad, bad
print(len(names))
"""


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, imported in a clean
    process: no jax, flax, optax or triton, and no read_tpu or
    read_tpu.* module, is loaded."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 45


def test_port_sources_import_nothing_of_read_tpu():
    """No import statement anywhere in the port's sources or in
    chip_smoke.py, at module level or inside a function, names jax, flax,
    optax or read_tpu(.*)."""
    import ast
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "read_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            bad += [(path, m) for m in mods if m.split(".")[0] in (
                "jax", "flax", "optax", "read_tpu")]
    assert len(files) > 20 and not bad, bad
