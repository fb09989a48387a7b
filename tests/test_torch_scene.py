"""The port's scene host code against ``read_tpu.scene`` on the same
inputs: camera math (bit-equal), the input-format DSL on
``configs/train_example.yaml``'s format, and ``load_scene_data`` on tiny
written scenes (binary and ascii PLY, Metashape XML, txt poses, view
matrices, ini intrinsics). The port's copies must give the same arrays
and fields, so nothing of the port needs the JAX package's host code.
"""

import os

import numpy as np
import pytest
import yaml

from read_tpu.scene import camera as JC
from read_tpu.scene import formats as JF
from read_tpu.scene import io as JIO
from read_tpu_torch.scene import camera as C
from read_tpu_torch.scene import formats as F
from read_tpu_torch.scene import io as IO

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_camera_matches_read_tpu():
    rng = np.random.default_rng(0)
    K = np.array([[720.5, 0, 600.3], [0, 715.0, 180.2], [0, 0, 1]])
    for size, near, far in (((1216, 368), 0.1, 1000.0), ((64, 48), 0.5,
                                                         50.0)):
        np.testing.assert_array_equal(C.gl_projection(K, size, near, far),
                                      JC.gl_projection(K, size, near, far))
    P = JC.gl_projection(K, (1216, 368))
    np.testing.assert_array_equal(C.rewrite_near_far(P, 0.2, 300.0),
                                  JC.rewrite_near_far(P, 0.2, 300.0))
    np.testing.assert_array_equal(C.rescale_K(K, 0.5, 0.25),
                                  JC.rescale_K(K, 0.5, 0.25))
    np.testing.assert_array_equal(C.rescale_K(K, 2.0, 3.0, keep_fov=False),
                                  JC.rescale_K(K, 2.0, 3.0, keep_fov=False))
    for _ in range(3):
        view = JC.look_at(rng.normal(size=3), rng.normal(size=3) + 5.0)
        np.testing.assert_array_equal(C.total_matrix(P, view),
                                      JC.total_matrix(P, view))


def test_input_format_matches_read_tpu():
    with open(os.path.join(REPO, "configs", "train_example.yaml")) as f:
        fmt = yaml.safe_load(f)["input_format"]
    got, want = F.parse_input_format(fmt), JF.parse_input_format(fmt)
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert (a.mode, a.draw_points, a.point_size, a.splat_mode,
                a.flat_color, a.downscale, a.channels) == \
            (b.mode, b.draw_points, b.point_size, b.splat_mode,
             b.flat_color, b.downscale, b.channels)
    for tok in ("colors", "normals_d_p4_ds1", "xyz_ps8", "labels_ds3",
                "depth"):
        a, b = F.parse_input_string(tok), JF.parse_input_string(tok)
        assert (a.mode, a.point_size, a.splat_mode, a.downscale) == \
            (b.mode, b.point_size, b.splat_mode, b.downscale)
    with pytest.raises(ValueError):
        F.parse_input_string("bogus_p1")


def _assert_same_scene(got, want):
    assert set(got) == set(want)
    for key in ("pointcloud", "mesh"):
        if want[key] is None:
            assert got[key] is None
            continue
        assert set(got[key]) == set(want[key])
        for field, arr in want[key].items():
            if arr is None:
                assert got[key][field] is None, field
            else:
                np.testing.assert_array_equal(got[key][field], arr,
                                              err_msg=field)
    for key in ("proj_matrix", "intrinsic_matrix", "model3d_origin",
                "point_sizes"):
        if want[key] is None:
            assert got[key] is None, key
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert len(got["view_matrix"]) == len(want["view_matrix"])
    for a, b in zip(got["view_matrix"], want["view_matrix"]):
        np.testing.assert_array_equal(a, b)
    assert list(got["camera_labels"]) == list(want["camera_labels"])
    assert got["config"] == want["config"]
    assert (got["net_ckpt"], got["tex_ckpt"]) == (want["net_ckpt"],
                                                  want["tex_ckpt"])


def test_load_scene_data_matches_read_tpu(tmp_path):
    """Binary PLY with colors and normals, Metashape XML intrinsics and
    extrinsics, a projection matrix, point sizes, a data ratio."""
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(60, 3)).astype(np.float32)
    JIO.write_ply(str(tmp_path / "pc.ply"), xyz,
                  rng.uniform(size=(60, 3)).astype(np.float32),
                  rng.normal(size=(60, 3)).astype(np.float32))
    (tmp_path / "camera.xml").write_text(
        "<document><chunk><sensors><sensor><calibration>"
        '<resolution width="640" height="480"/><f>500.5</f>'
        "</calibration></sensor></sensors><cameras>"
        '<camera label="a"><transform>1 0 0 5 0 1 0 6 0 0 1 7 0 0 0 1'
        "</transform></camera>"
        '<camera label="b"><transform>1 0 0 8 0 1 0 9 0 0 1 10 0 0 0 1'
        "</transform></camera>"
        '<camera label="c"/>'
        "</cameras></chunk></document>")
    np.savetxt(tmp_path / "proj.txt", JC.gl_projection(
        np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]]), (640, 480)))
    np.save(tmp_path / "sizes.npy", rng.uniform(size=60).astype(np.float32))
    (tmp_path / "scene.yaml").write_text(
        "viewport_size: [640, 480]\npointcloud: pc.ply\n"
        "intrinsic_matrix: camera.xml\nview_matrix: camera.xml\n"
        "proj_matrix: proj.txt\npoint_sizes: sizes.npy\n"
        "data_ratio: 0.5\nnet_path: exp\nckpt: net.npz\n"
        "texture_ckpt: tex.npz\n")
    path = str(tmp_path / "scene.yaml")
    _assert_same_scene(IO.load_scene_data(path), JIO.load_scene_data(path))


def test_load_scene_data_other_formats_match_read_tpu(tmp_path):
    """ASCII PLY (no colors: the white*255 fallback), view matrices with
    a non-finite one dropped, ini intrinsics; then txt poses with their
    image list and txt intrinsics, and a mesh with faces."""
    rng = np.random.default_rng(2)
    JIO.write_ply(str(tmp_path / "pc.ply"),
                  rng.normal(size=(12, 3)).astype(np.float32), binary=False)
    vm = np.tile(np.eye(4), (3, 1, 1))
    vm[1, 0, 0] = np.nan
    np.savetxt(tmp_path / "views.fake", vm.reshape(-1, 4))
    (tmp_path / "cam.ini").write_text(
        "[SceneCameraParams]\nK = 500 510 320 240\nw = 640\nh = 480\n")
    (tmp_path / "a.yaml").write_text(
        "viewport_size: [640, 480]\npointcloud: pc.ply\n"
        "intrinsic_matrix: cam.ini\nview_matrix: views.fake\n")
    path = str(tmp_path / "a.yaml")
    got = IO.load_scene_data(path)
    _assert_same_scene(got, JIO.load_scene_data(path))
    assert got["camera_labels"] == ["0", "2"]

    np.savetxt(tmp_path / "poses.txt",
               np.tile(np.eye(4), (2, 1, 1)).reshape(-1, 4))
    (tmp_path / "images.txt").write_text("f0.png\nf1.png\n")
    np.savetxt(tmp_path / "K.txt", np.array([[640, 480, 0], [500, 0, 320],
                                             [0, 500, 240], [0, 0, 1]]))
    (tmp_path / "tri.ply").write_bytes(
        b"ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\n"
        b"property float y\nproperty float z\nelement face 1\n"
        b"property list uchar int vertex_indices\nend_header\n"
        b"0 0 0\n1 0 0\n0 1 0\n3 0 1 2\n")
    (tmp_path / "b.yaml").write_text(
        "viewport_size: [640, 480]\nmesh: tri.ply\n"
        "intrinsic_matrix: K.txt\nview_matrix: poses.txt\n")
    path = str(tmp_path / "b.yaml")
    got = IO.load_scene_data(path)
    _assert_same_scene(got, JIO.load_scene_data(path))
    np.testing.assert_array_equal(got["mesh"]["faces"], [0, 1, 2])
