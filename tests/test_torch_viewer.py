"""The port's viewer (``read_tpu_torch.viewer``) against read_tpu's, and
``utils.profiling``, on the CPU.

Both ``ViewerApp``s open one toy checkpoint at 48x32 (a fresh state the
port writes with ``UNet(base_channel=8, num_res=1)``, which
``read_tpu``'s renderer loads with its UNet cut to that width and
initialised jitted; ``tests/test_render_roundtrip.py``'s viewer smoke
opens a trained one). One key sequence (flying, turning, rolling, every
mode key, the normals cycle, ``+``/``-``, ``t``, ``g``, keyframes,
replay, ``y``) leaves the two apps with the same mode, point radius,
temporal average, trajectory and trackball matrix (``atol 1e-12``)
after every key; ``u`` is the 2D-texture mode in both (``read_tpu``
binds it twice and its second binding, saving the trajectory, never
runs). The port's neural
frame is ``NeuralRenderer.infer``'s for the same pose, bit for bit;
``--offscreen`` runs and exits 0 with ``cv2`` unimportable, and the
windowed mode exits naming cv2. ``profiling.trace`` writes a Chrome
trace of a CPU block; ``device_timeit`` times on the host clock.
"""

import functools
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from read_tpu import viewer as JVW
from read_tpu.models.unet import UNet as FlaxUNet
from read_tpu.pipelines import texture_pipeline as JTP
from read_tpu.scene import io as JIO
from read_tpu_torch import viewer as VW
from read_tpu_torch.models.unet import UNet
from read_tpu_torch.render import NeuralRenderer
from read_tpu_torch.pipelines import texture_pipeline as TP
from read_tpu_torch.utils import ckpt as CK
from read_tpu_torch.utils import profiling

W, H = 48, 32
KEYS = list("wasdqe1234zx") + list("ncmmmmmvblphut") + [
    "+", "+", "=", "-", "t", "g", "k", "w", "k", "j", "k", "2", "k", "r",
    "y", "r", "u", "\x1b"]


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = tmp_path_factory.mktemp("viewer")
    rng = np.random.default_rng(4)
    n = 3000
    xyz = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    xyz[:, 2] -= 6.0
    JIO.write_ply(str(root / "pc.ply"), xyz,
                  rng.uniform(0, 1, size=(n, 3)).astype(np.float32))
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]])
    np.savetxt(root / "cam.txt", np.vstack([[W, H, 0], K]))
    poses = []
    for i in range(3):
        pose = np.eye(4)
        pose[0, 3] = 0.2 * i
        poses.append(pose)
    np.savetxt(root / "poses.dat", np.stack(poses).reshape(-1, 4))
    with open(root / "scene.yaml", "w") as f:
        f.write(f"viewport_size: [{W}, {H}]\npointcloud: pc.ply\n"
                "intrinsic_matrix: cam.txt\nview_matrix: poses.dat\n")
    state, _ = TP.create_state(torch.Generator().manual_seed(0),
                               TP.PipelineConfig(crop_size=(H, W)), n,
                               net=UNet(base_channel=8, num_res=1),
                               device="cpu")
    ckpt = CK.save_checkpoint(str(root / "ckpt"), TP.flat_from_state(state),
                              config={})
    return str(root / "scene.yaml"), ckpt


class _SmallJitInit:
    """``read_tpu``'s UNet cut to the checkpoint's width, its ``init``
    jitted (flax's eager init takes ~25 s on the CPU)."""

    def __init__(self, **kw):
        self._net = FlaxUNet(base_channel=8, num_res=1, **kw)

    def init(self, key, *pyr, train):
        return jax.jit(functools.partial(self._net.init, train=train))(
            key, *pyr)

    def __getattr__(self, name):
        return getattr(self._net, name)


def _same(port, ref):
    assert port.mode == ref.mode
    assert port.r.cfg.point_radius == ref.r.cfg.point_radius
    assert port.r.temporal_average == ref.r.temporal_average
    assert port.replaying == ref.replaying
    assert len(port.trajectory) == len(ref.trajectory)
    np.testing.assert_allclose(port.tb.m, ref.tb.m, rtol=0, atol=1e-12)


def test_keys_match_read_tpu(toy, tmp_path, monkeypatch, capsys):
    scene, ckpt = toy
    monkeypatch.chdir(tmp_path)        # 'y' looks for trajectory.txt here
    port = VW.ViewerApp(scene, ckpt, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTP, "UNet", _SmallJitInit)
        ref = JVW.ViewerApp(scene, ckpt)
    _same(port, ref)
    modes = []
    for key in KEYS:
        assert port.handle_key(key) == ref.handle_key(key), key
        _same(port, ref)
        modes.append(port.mode)
    assert set(modes) >= {"neural", "colors", "depth", "xyz", "labels",
                          "pca", "lit", "texture2d", "normals_m",
                          "normals_l", "normals_r", "normals_d"}
    assert port.mode == "texture2d" and not os.path.exists("trajectory.txt")
    assert port.r.cfg.point_radius == 2
    assert port.r.temporal_average == (KEYS.count("t") % 2 == 1)


def test_neural_frame_is_infer(toy, tmp_path, monkeypatch):
    """The app's neural frame is the renderer's ``infer`` at the
    trackball's pose; each raw mode renders; ``+`` splats the frame,
    ``-`` returns to 1-px points; a screenshot is the frame's PNG."""
    scene, ckpt = toy
    monkeypatch.chdir(tmp_path)
    app = VW.ViewerApp(scene, ckpt, device="cpu")
    r = NeuralRenderer(scene, ckpt, device="cpu")
    app.handle_key("w")
    frame = app.render()
    np.testing.assert_array_equal(frame, r.infer(app.tb.view_matrix()))
    assert frame.shape == (H, W, 3) and len(app.frame_times) == 1
    for key in "cvblphm":
        app.handle_key(key)
        img = app.render()
        assert img.shape == (H, W, 3) and np.isfinite(img).all(), key
    app.handle_key("n")
    app.handle_key("+")
    splat = app.render()
    assert app.r.cfg.point_radius == 1 and not np.array_equal(splat, frame)
    app.handle_key("-")
    np.testing.assert_array_equal(app.render(), frame)
    path = app.screenshot("shot.png")
    from read_tpu_torch.data import image_io
    shot = image_io.imread(path)[..., ::-1]
    np.testing.assert_array_equal(
        shot, (np.clip(frame, 0, 1) * 255).astype(np.uint8))
    assert app.fps > 0


def test_offscreen_runs_without_cv2(toy, monkeypatch, capsys):
    scene, ckpt = toy
    monkeypatch.setitem(sys.modules, "cv2", None)   # import cv2 raises
    images = os.path.join(os.path.dirname(scene), "*.png")
    rc = VW.main(["--scene", scene, "--ckpt", ckpt, "--offscreen", "3",
                  "--device", "cpu", "--nearest-train", "--gt", images])
    assert rc == 0
    out = capsys.readouterr().out
    assert "offscreen ok: 14 frames" in out and "traj 2 kf" in out
    assert "nearest-train:" in out
    with pytest.raises(SystemExit, match="cv2"):
        VW.main(["--scene", scene, "--ckpt", ckpt, "--device", "cpu"])


def test_profiling_trace_and_timeit(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        (x @ x).sum()
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert len(prof.key_averages()) > 0
    t = profiling.device_timeit(lambda: x @ x, iters=3, device="cpu")
    assert t["mean_ms"] > 0 and t["per_sec"] > 0
