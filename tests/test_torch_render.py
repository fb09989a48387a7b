"""The port's serving slice as a whole against read_tpu, on the CPU.

- ``read_tpu_torch.render.NeuralRenderer`` vs ``read_tpu.render.
  NeuralRenderer`` on one JAX-written checkpoint (``TP.create_state``
  with ``raster_method='pallas'``, ``conv_impl='xla'``) of a tiny scene
  on disk, plain and with ``temporal_average``, and on the same weights
  under the default config (the exact ``sort`` z-buffer, K5's twin);
- ``read_tpu_torch.frame.make_frame`` at a small size vs the JAX
  composition it ports (packed pyramid -> gather -> flax UNet);
- importing the renderer and frame loads no JAX.

The UNet is cut to ``base_channel=8, num_res=1`` (the JAX pipeline's
``UNet`` is swapped for that width in this process only) to keep the
test fast; the port reads the width off the checkpoint. Tolerance:
``atol 5e-4, rtol 1e-3``.
"""

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

from read_tpu.models import texture as JT
from read_tpu.models.unet import UNet as FlaxUNet
from read_tpu.ops import rasterize as JR
from read_tpu.pipelines import texture_pipeline as JTP
from read_tpu.render import NeuralRenderer as JaxRenderer
from read_tpu.scene import io as IO
from read_tpu.utils import ckpt as JCK
from read_tpu_torch import render as TR
from read_tpu_torch.frame import make_frame
from read_tpu_torch.utils import convert as CV

TOL = dict(atol=5e-4, rtol=1e-3)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_UNET = functools.partial(FlaxUNet, base_channel=8, num_res=1)


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


def test_renderer_refuses_sort_and_unported_config(scene_and_ckpt):
    """'sort' renders now (below); a raster method that is still not
    ported, and supersampling, raise."""
    scene, ckpt, _ = scene_and_ckpt
    with pytest.raises(NotImplementedError, match="sort2"):
        TR.NeuralRenderer(scene, ckpt, raster_method="sort2", device="cpu")
    with pytest.raises(NotImplementedError):
        TR.NeuralRenderer(scene, ckpt, supersampling=2, device="cpu")


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
    flat = CV.flat_from_variables(net.state_dict(), table)
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


def test_port_imports_no_jax():
    code = ("import sys, read_tpu_torch.render, read_tpu_torch.frame; "
            "bad = [m for m in ('jax', 'flax', 'optax', 'triton', "
            "'read_tpu.utils.ckpt') if m in sys.modules]; "
            "assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
