"""The port's scene generator (``read_tpu_torch.make_demo_scene``) and
PLY writer against read_tpu's, on the CPU.

- ``build_world`` bit-equal to ``scripts/make_demo_scene.build_world``
  (the script is loaded by path; it imports only numpy at its top) for
  two seeds at 10k points.
- ``scene.io.write_ply`` byte for byte as ``read_tpu.scene.io.write_ply``
  (binary little-endian, float and uint8 colours), read back by both
  packages' ``read_ply``.
- The generator end to end at 20k points, 64x32, 3 views, on the plain
  twins: every target's index map bit-equal to *eager* JAX's
  ``rasterize_batch(..., point_radius=1)`` on 'sort' (the script jits
  it; eager is the op-by-op program the port follows), every PNG equal
  to JAX's gather written as the script writes it, the point cloud,
  camera and poses files equal to the script's, and ``paths.yaml`` with
  ``configs/scene10m_probe.yaml`` as it is loading through the port's
  CLI and ``data.scenes`` with PyYAML blocked (the YAML subset of
  ``utils.config_io``).
"""

import importlib.util
import os

import imageio.v2 as imageio
import jax.numpy as jnp
import numpy as np
import pytest

from read_tpu.ops import rasterize as JR
from read_tpu.ops import render_modes as JRM
from read_tpu.scene import camera as JCAM
from read_tpu.scene import io as JIO
from read_tpu_torch import make_demo_scene as MDS
from read_tpu_torch import train as TRAIN
from read_tpu_torch.data import scenes as S
from read_tpu_torch.scene import camera
from read_tpu_torch.scene import io as IO
from read_tpu_torch.utils import config_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SMALL, W, H, VIEWS = 20_000, 64, 32, 3


def _script():
    spec = importlib.util.spec_from_file_location(
        "make_demo_scene_script",
        os.path.join(REPO, "scripts", "make_demo_scene.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [0, 7])
def test_build_world_matches_the_script(seed):
    want = _script().build_world(np.random.default_rng(seed), 10_000)
    got = MDS.build_world(np.random.default_rng(seed), 10_000)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (10_000, 3)


@pytest.mark.parametrize("uint8", [False, True])
def test_write_ply_matches_read_tpu(tmp_path, uint8):
    rng = np.random.default_rng(2)
    xyz = rng.normal(size=(50, 3)).astype(np.float32)
    rgb = (rng.integers(0, 256, (50, 3)).astype(np.uint8) if uint8
           else rng.uniform(-0.1, 1.1, (50, 3)).astype(np.float32))
    mine, theirs = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    IO.write_ply(mine, xyz, rgb)
    JIO.write_ply(theirs, xyz, rgb, binary=True)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    r8 = rgb if uint8 else (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    for read in (IO.read_ply, JIO.read_ply):
        v = read(mine)["vertex"]
        np.testing.assert_array_equal(np.stack([v["x"], v["y"], v["z"]], 1),
                                      xyz)
        np.testing.assert_array_equal(
            np.stack([v["red"], v["green"], v["blue"]], 1), r8)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    out = tmp_path_factory.mktemp("demo") / "scene"
    assert MDS.main(["--out", str(out), "--points", str(N_SMALL),
                     "--views", str(VIEWS), "--width", str(W), "--height",
                     str(H), "--seed", "3", "--device", "cpu"]) == 0
    return out


def test_generator_targets_match_eager_jax(scene):
    xyz, rgb = _script().build_world(np.random.default_rng(3), N_SMALL)
    K = np.array([[720.0, 0, W / 2], [0, 720.0, H / 2], [0, 0, 1]])
    P = JCAM.gl_projection(K, (W, H), znear=0.1, zfar=1000.0)
    views = [JCAM.look_at([0.35 * np.sin(i * 0.12), 1.6, 2.0 + i * 1.5],
                          [0.35 * np.sin((i + 8) * 0.12), 1.5,
                           14.0 + i * 1.5], up=[0, 1, 0])
             for i in range(VIEWS)]
    for got, want in zip(MDS.drive_views(VIEWS), views):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.loadtxt(scene / "poses.dat"),
                                  np.stack(views).reshape(-1, 4))
    np.testing.assert_array_equal(np.loadtxt(scene / "cam.txt"),
                                  np.vstack([[W, H, 0], K]))
    ms = [JCAM.total_matrix(P, v) for v in views]
    ports = list(MDS.render_targets(
        xyz, rgb, [camera.total_matrix(camera.gl_projection(
            K, (W, H), znear=0.1, zfar=1000.0), v) for v in views],
        H, W, "cpu"))
    covered = 0
    for i, (m, (index, target)) in enumerate(zip(ms, ports)):
        idx, _ = JR.rasterize_batch(
            jnp.asarray(xyz), jnp.asarray(m.astype(np.float32)[None]), H,
            W, point_radius=1)
        np.testing.assert_array_equal(index, np.asarray(idx[0]))
        img = np.asarray(JRM.gather_attribute(jnp.asarray(rgb), idx[0]))
        want = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        np.testing.assert_array_equal(target, want)
        np.testing.assert_array_equal(
            imageio.imread(scene / "images" / f"{i:06}.png"), want)
        covered += int((index >= 0).sum())
    assert covered > VIEWS * H * W // 2
    cloud = JIO.read_ply(str(scene / "pc.ply"))["vertex"]
    np.testing.assert_array_equal(
        np.stack([cloud["x"], cloud["y"], cloud["z"]], 1), xyz)
    np.testing.assert_array_equal(
        np.stack([cloud["red"], cloud["green"], cloud["blue"]], 1),
        (np.clip(rgb, 0, 1) * 255).astype(np.uint8))


def test_generator_scene_loads_for_the_probe_recipe(scene, monkeypatch):
    """``--config configs/scene10m_probe.yaml --paths-file
    <scene>/paths.yaml`` with PyYAML blocked: the recipe's flags as YAML
    gives them, and ``demo_drive``'s views split 1 in 10 for val."""
    monkeypatch.setattr(config_io, "_yaml", lambda: None)
    args = TRAIN.load_args([
        "--config", os.path.join(REPO, "configs", "scene10m_probe.yaml"),
        "--paths-file", str(scene / "paths.yaml")])
    assert args.crop_size == "1216x368" and args.lr == 1e-3
    assert args.dataset_names == ["demo_drive"] and args.epochs == 3
    assert args.train_dataset_args["random_zoom"] is None
    ds_train, ds_val, _ = S.get_datasets(args)
    (tr,), (va,) = ds_train, ds_val
    assert len(tr.target_list) + len(va.target_list) == VIEWS
    assert all(os.path.exists(p) for p in tr.target_list)
    want = JIO.load_scene_data(str(scene / "scene.yaml"))
    np.testing.assert_array_equal(tr.scene_data["pointcloud"]["xyz"],
                                  want["pointcloud"]["xyz"])
    assert list(tr.scene_data["config"]["viewport_size"]) == [W, H]
