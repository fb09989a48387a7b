"""The port's scene applications against ``read_tpu``, on the CPU.

- ``read_tpu_torch.scene.tools`` (stitch, selections, transform, delete,
  duplicate, panorama cameras), ``scene.trajectory`` (quaternions,
  slerp, sample, frames, save/load) and ``scene.trackball`` against
  ``read_tpu.scene``'s on the same seeded inputs: bit-equal, since both
  are the same numpy code;
- ``render.pca_color`` and ``render.nearest_train`` against
  ``read_tpu.render``'s: bit-equal;
- ``read_tpu_torch.baseline_configs`` on a tiny scene with a random-weight
  checkpoint (UNet base 8, one res block): config 4 on the exact 'sort'
  z-buffer is bit-equal to the unsplit frame and its mapped index pyramid
  equal at every level; ``main`` runs configs 1, 4 and 5 end to end and
  writes its PNGs and ``results.json``.
"""

import json
import os

import numpy as np
import pytest
import torch

from read_tpu import render as JRENDER
from read_tpu.scene import io as JIO
from read_tpu.scene import tools as JST
from read_tpu.scene import trackball as JTB
from read_tpu.scene import trajectory as JTJ
from read_tpu_torch import baseline_configs as BC
from read_tpu_torch import render as TR
from read_tpu_torch.data import image_io
from read_tpu_torch.models import texture as T
from read_tpu_torch.models.unet import UNet
from read_tpu_torch.scene import io as IO
from read_tpu_torch.scene import tools as ST
from read_tpu_torch.scene import trackball as TB
from read_tpu_torch.scene import trajectory as TJ
from read_tpu_torch.utils import ckpt as CK
from read_tpu_torch.utils import convert as CV

W, H, N = 48, 32, 4000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's CPU ops are small: one intra-op thread runs them
    fastest when the suite's workers share the cores (8 threads a
    worker ran them ~7x slower under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _poses(rng, n):
    out = []
    for _ in range(n):
        a = rng.uniform(-0.4, 0.4)
        m = np.eye(4)
        m[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]]
        m[:3, 3] = rng.uniform(-1, 1, 3)
        out.append(m)
    return out


def _tuple_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_stitch_and_edits_match_read_tpu():
    rng = np.random.default_rng(0)
    scenes = []
    for i in range(3):
        n = 100 + 50 * i
        tf = None if i == 0 else _poses(rng, 1)[0]
        scenes.append((rng.normal(size=(n, 3)).astype(np.float32),
                       rng.normal(size=(n, 8)).astype(np.float32), tf))
    _tuple_equal(ST.stitch_scenes(scenes), JST.stitch_scenes(scenes))
    xyz, tex, _ = ST.stitch_scenes(scenes)
    lo, hi = (-0.5, -1.0, -0.2), (0.8, 0.5, 1.0)
    box = ST.select_bbox(xyz, lo, hi)
    np.testing.assert_array_equal(box, JST.select_bbox(xyz, lo, hi))
    assert 0 < box.sum() < len(xyz)
    ball = ST.select_sphere(xyz, (0.1, 0.2, 0.0), 0.9)
    np.testing.assert_array_equal(
        ball, JST.select_sphere(xyz, (0.1, 0.2, 0.0), 0.9))
    tf = _poses(rng, 1)[0]
    np.testing.assert_array_equal(ST.transform_points(xyz, box, tf),
                                  JST.transform_points(xyz, box, tf))
    _tuple_equal(ST.delete_points(xyz, tex, box),
                 JST.delete_points(xyz, tex, box))
    _tuple_equal(ST.duplicate_points(xyz, tex, ball, tf),
                 JST.duplicate_points(xyz, tex, ball, tf))
    with pytest.raises(AssertionError):
        ST.stitch_scenes([(xyz, tex[:-1], None)])


@pytest.mark.parametrize("n_views,step", [(3, 30.0), (4, 40.0), (1, 10.0)])
def test_panorama_cameras_match_read_tpu(n_views, step):
    view = _poses(np.random.default_rng(1), 1)[0]
    got = ST.panorama_cameras(view, n_views, step)
    want = JST.panorama_cameras(view, n_views, step)
    assert len(got) == n_views
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_trajectory_matches_read_tpu(tmp_path):
    keys = _poses(np.random.default_rng(2), 4)
    keys[2][:3, :3] = np.diag([-1.0, 1.0, -1.0])   # trace < 0 branch
    mine, theirs = TJ.Trajectory(keys), JTJ.Trajectory(keys)
    for t in (0.0, 0.1, 0.37, 0.5, 0.99, 1.0, 1.5):
        np.testing.assert_array_equal(mine.sample(t), theirs.sample(t))
    for a, b in zip(mine.frames(9), theirs.frames(9)):
        np.testing.assert_array_equal(a, b)
    for k in keys:
        np.testing.assert_array_equal(TJ.mat_to_quat(k[:3, :3]),
                                      JTJ.mat_to_quat(k[:3, :3]))
    q0, q1 = TJ.mat_to_quat(keys[0][:3, :3]), TJ.mat_to_quat(keys[1][:3, :3])
    np.testing.assert_array_equal(TJ.slerp(q0, q1, 0.3),
                                  JTJ.slerp(q0, q1, 0.3))
    np.testing.assert_array_equal(TJ.quat_to_mat(q1), JTJ.quat_to_mat(q1))
    path = str(tmp_path / "traj.txt")
    mine.save(path)
    back = JTJ.Trajectory.load(path)
    again = TJ.Trajectory.load(path)
    for a, b, k in zip(back.keyframes, again.keyframes, keys):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, k, rtol=0, atol=1e-15)
    assert len(TJ.Trajectory().frames(3)) == 3
    t = TJ.Trajectory()
    assert t.add(keys[0]) == 0 and len(t) == 1
    t.remove_last()
    t.clear()
    np.testing.assert_array_equal(t.sample(0.5), np.eye(4))


def test_trackball_matches_read_tpu():
    view = _poses(np.random.default_rng(3), 1)[0]
    view[1, 3] = 1.5
    mine, theirs = TB.Trackball(view), JTB.Trackball(view)
    for name, args in (("rotate", (12.0, -7.0)), ("rotate_local", (3, 4)),
                       ("roll", (0.2,)), ("pan", (5.0, -2.0)),
                       ("zoom", (3.0,)), ("fly", (1.0, 0.5, -0.2)),
                       ("turn", (0.1, -0.05)),
                       ("set_yaw_pitch_roll", (0.3, 0.1, -0.2, (1, 2, 3)))):
        getattr(mine, name)(*args)
        getattr(theirs, name)(*args)
        np.testing.assert_array_equal(mine.view_matrix(),
                                      theirs.view_matrix(), err_msg=name)
    for prop in ("position", "forward", "right", "up"):
        np.testing.assert_array_equal(getattr(mine, prop),
                                      getattr(theirs, prop))
    np.testing.assert_array_equal(TB._rotation((0, 1, 1), 0.7),
                                  JTB._rotation((0, 1, 1), 0.7))


def test_pca_color_and_nearest_train_match_read_tpu():
    rng = np.random.default_rng(4)
    desc = rng.normal(size=(5000, 8)).astype(np.float32)
    for kw in ({}, {"sample": 700, "seed": 3}):
        got = TR.pca_color(desc, **kw)
        np.testing.assert_array_equal(got, JRENDER.pca_color(desc, **kw))
        assert got.shape == (5000, 3) and got.dtype == np.float32
    poses = _poses(rng, 12)
    for q in _poses(rng, 5) + [poses[7]]:
        assert TR.nearest_train(poses, q) == JRENDER.nearest_train(poses, q)
    assert TR.nearest_train(poses, poses[7]) == 7


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    """A tiny street along -z on disk (PLY, poses, PNG targets) and one
    random-weight 'sort' checkpoint of it (UNet base 8, one res block)."""
    root = tmp_path_factory.mktemp("apps")
    rng = np.random.default_rng(6)
    xyz = np.stack([rng.uniform(-4, 4, N), rng.uniform(-1, 3, N),
                    rng.uniform(-30, -2, N)], 1).astype(np.float32)
    JIO.write_ply(str(root / "pc.ply"), xyz,
                  rng.uniform(0, 1, size=(N, 3)).astype(np.float32))
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]])
    np.savetxt(root / "cam.txt", np.vstack([[W, H, 0], K]))
    poses = []
    for i in range(4):
        pose = np.eye(4)
        pose[:3, 3] = (0.1 * i, 0.5, -1.0 * i)
        poses.append(pose)
    np.savetxt(root / "poses.dat", np.stack(poses).reshape(-1, 4))
    os.makedirs(root / "images")
    for i in range(4):
        image_io.imwrite(str(root / "images" / f"{i:06}.png"),
                         rng.integers(0, 255, (H, W, 3), np.uint8))
    with open(root / "scene.json", "w") as f:
        json.dump({"viewport_size": [W, H], "pointcloud": "pc.ply",
                   "intrinsic_matrix": "cam.txt",
                   "view_matrix": "poses.dat"}, f)
    net = UNet(base_channel=8, num_res=1).init_weights(
        torch.Generator().manual_seed(1))
    table = T.init_point_texture(N, 8, "rand",
                                 generator=torch.Generator().manual_seed(0))
    ckpt = str(root / "ckpt")
    CK.save_checkpoint(ckpt, CV.flat_from_variables(net.state_dict(),
                                                    (table,)), config={})
    return str(root / "scene.json"), ckpt, poses, root


def test_config4_on_sort_is_bit_equal(drive):
    scene, ckpt, poses, _ = drive
    r = TR.NeuralRenderer(scene, ckpt, device="cpu")
    assert r.cfg.raster_method == "sort"
    before = r.infer(poses[1])
    res = BC.config4_stitch(r, poses[1], reps=1)
    assert res["bit_equal"] and res["index_pyramid_equal"], res
    assert res["tied_pixels"] == 0 and res["max_abs_diff"] == 0.0
    # the renderer now holds the stitched scene: a permutation of the
    # points, so the same frame
    assert not torch.equal(r.xyz, torch.from_numpy(
        IO.load_scene_data(scene)["pointcloud"]["xyz"].astype(np.float32)))
    np.testing.assert_array_equal(r.infer(poses[1]), before)


def test_baseline_configs_main_runs_every_config(drive, tmp_path, capsys):
    scene, ckpt, poses, root = drive
    out = tmp_path / "cfgs"
    assert BC.main(["--scene", scene, "--ckpt", ckpt, "--out", str(out),
                    "--device", "cpu", "--val-step", "2"]) == 0
    with open(out / "results.json") as f:
        res = json.load(f)
    c1, c4, c5 = (res["config1_trajectory"], res["config4_stitching"],
                  res["config5_edit_panorama"])
    assert c1["frames"] == 4 and c1["n_val"] == 2
    assert np.isfinite([c1["val_psnr_mean"], c1["val_ssim_mean"],
                        c1["fps_device"]]).all()
    assert c4["bit_equal"] and c4["index_pyramid_equal"]
    assert c5["panorama_px"] == [H, 3 * W] and c5["panorama_views"] == 3
    for name in ("cfg1_000000.png", "cfg1_000002.png", "cfg4_stitched.png",
                 "cfg5_edited.png", "cfg5_panorama.png"):
        assert os.path.exists(out / name), name
    assert image_io.imread(str(out / "cfg5_panorama.png")).shape == (
        H, 3 * W, 3)


def test_config5_edits_and_panorama(drive):
    """A box inside the street deleted, another copied 3 m to the side:
    the point count and the frame change; the panorama's tiles are the
    renderer's frames at the ring's poses."""
    scene, ckpt, poses, _ = drive
    r = TR.NeuralRenderer(scene, ckpt, device="cpu")
    before = r.infer(poses[0])
    xyz = r.xyz.numpy()
    dele, copy = ((-2, -1, -12), (2, 3, -6)), ((-4, -1, -20), (-1, 3, -14))
    n_del = ST.select_bbox(xyz, *dele).sum()
    res = BC.config5_edit_panorama(r, poses[0], poses[2], dele, copy,
                                   (3.0, 0.0, 0.0), reps=1)
    assert res["deleted_points"] == n_del > 50
    assert res["copied_points"] > 50
    assert res["points"] == N - n_del + res["copied_points"] == len(r.xyz)
    edited, pano = res["images"]
    assert float(np.abs(edited - before).max()) > 0
    np.testing.assert_array_equal(edited, r.infer(poses[0]))
    ring = ST.panorama_cameras(poses[2], 3, 40.0)
    np.testing.assert_array_equal(pano[:, W:2 * W], r.infer(ring[1]))


def test_render_panorama_tiles_the_camera_ring(drive):
    """``render_panorama`` with the port's renderer: the ring's frames
    side by side, the yaw step defaulting to the horizontal field of
    view (read_tpu's rule)."""
    scene, ckpt, poses, _ = drive
    r = TR.NeuralRenderer(scene, ckpt, device="cpu")
    pano = ST.render_panorama(r, poses[1], n_views=3)
    fov = float(np.rad2deg(2 * np.arctan(r.vw / (2 * r.K[0, 0]))))
    ring = JST.panorama_cameras(poses[1], 3, fov)
    assert pano.shape == (H, 3 * W, 3)
    for i, pose in enumerate(ring):
        np.testing.assert_array_equal(pano[:, i * W:(i + 1) * W],
                                      r.infer(pose))
