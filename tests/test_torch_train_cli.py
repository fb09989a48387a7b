"""The port's train/eval CLI (``read_tpu_torch.train``) end to end on the
CPU (``--headless-platform cpu``), against ``read_tpu.train``.

Two tiny scenes on disk (1500 points, 32x32 frames, 6 poses, PNG
targets rendered with ``read_tpu``'s reference rasterizer; manifests,
paths and experiment config written as JSON, which YAML readers read
too), 32x32 crops. Both CLIs build their UNet through their pipeline
module's ``UNet``, which this module swaps for ``base_channel=8,
num_res=1`` (as ``tests/test_torch_render.py`` does for JAX) to keep
the runs and their checkpoints small.

- a fit of one scene: ``args.yaml``, ``log.txt``, ``splits.json`` (the
  lists ``read_tpu.data.scenes.get_datasets`` gives), ``history.json``,
  ``ckpt_<scene>_<epoch>``, ``best_<scene>``, a train composite;
  ``--resume`` continues the step; the checkpoints load in
  ``read_tpu.utils.ckpt.load_checkpoint`` with a JAX ``TrainState``
  template; ``latest_checkpoint``/``rotate_checkpoints`` against
  ``read_tpu``'s on one listing;
- ``--eval --eval-all`` from one JAX-written checkpoint (with JAX's
  ``random_vgg_params(0)`` as ``--vgg-weights``) in both CLIs: the same
  ``args.yaml`` (but the directories) and ``splits.json``, and per-view
  loss, PSNR and SSIM within ``rtol 1e-4``
  (``tests/test_torch_train.py::test_eval_step_matches_jax``'s
  tolerance); the predictions dumped as PNG;
- ``SceneStateStore`` with a budget of 1 against no budget over the same
  operations, and ``--eval`` over two scenes with ``--max-scenes-hbm 1``
  against no budget: the same states and metrics;
- a subprocess run with ``cv2``, ``yaml``, ``imageio``, ``matplotlib``
  and ``tensorboardX`` blocked from import;
- ``--supersampling 2`` and an ``--input-format`` with extra modalities
  (``colors``, ``normals_l``) train a step, validate and write a
  checkpoint the renderer loads;
- without a CUDA device the CLI refuses to run unless told ``cpu``
  (``--criterion vgg_ens`` runs: ``tests/test_torch_raster_methods.py``);
- ``--mesh`` keeps ``read_tpu.train``'s rules (``--max-scenes-hbm`` and
  ``--freeze-net`` exit; ``--pipeline rgb_texture`` runs as without it;
  ``drop_points`` warns), and a ``--mesh 1x2`` fit of both scenes on two
  gloo ranks saves the unsharded run's checkpoints, which
  ``NeuralRenderer`` loads on one device, with the unsharded run's
  losses. The spawned ranks build their UNet with this process's
  ``TP.UNet`` (the CLI hands it to them), so the swap reaches them.
"""

import functools
import json
import os
import subprocess
import sys

import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch
import yaml

from read_tpu import train as JTRAIN
from read_tpu.criterions import vgg as JV
from read_tpu.data import scenes as JS
from read_tpu.models.unet import UNet as FlaxUNet
from read_tpu.ops import rasterize as JR
from read_tpu.pipelines import texture_pipeline as JTP
from read_tpu.scene import camera
from read_tpu.scene import io as JIO
from read_tpu.utils import ckpt as JCK
from read_tpu.utils import perform as JPERF
from read_tpu_torch import render as TR
from read_tpu_torch import train as TRAIN
from read_tpu_torch.models.unet import UNet
from read_tpu_torch.pipelines import texture_pipeline as TP
from read_tpu_torch.utils import ckpt as CK

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, HW, VIEWS = 1500, 32, 6
SCENES = ("toyA", "toyB")
SMALL = dict(base_channel=8, num_res=1)
EVAL_KEYS = ("loss", "huber_loss", "vgg_loss", "psnr", "ssim")


def _write_scene(root, name, seed):
    d = root / name
    os.makedirs(d / "images", exist_ok=True)
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-2, 2, size=(N, 3)).astype(np.float32)
    xyz[:, 2] -= 6.0
    colors = rng.uniform(0, 1, size=(N, 3)).astype(np.float32)
    JIO.write_ply(str(d / "pc.ply"), xyz, colors)
    K = np.array([[30.0, 0, HW / 2], [0, 30.0, HW / 2], [0, 0, 1]])
    np.savetxt(d / "cam.txt", np.vstack([[HW, HW, 0], K]))
    P = camera.gl_projection(K, (HW, HW), znear=0.1, zfar=50.0)
    views = []
    for i in range(VIEWS):
        view = np.eye(4)
        view[0, 3] = 0.2 * i
        views.append(view)
        idx, _ = JR.rasterize_reference(xyz, camera.total_matrix(P, view),
                                        HW, HW)
        img = np.zeros((HW, HW, 3), np.float32)
        img[idx >= 0] = colors[idx[idx >= 0]]
        imageio.imwrite(str(d / "images" / f"{i:06}.png"),
                        (img * 255).astype(np.uint8))
    np.savetxt(d / "poses.dat", np.stack(views).reshape(-1, 4))
    with open(d / "scene.json", "w") as f:
        json.dump({"viewport_size": [HW, HW], "pointcloud": "pc.ply",
                   "intrinsic_matrix": "cam.txt",
                   "view_matrix": "poses.dat"}, f)
    return {"scene_path": str(d / "scene.json"),
            "target_path": str(d / "images"),
            "target_name": "{label:06d}.png"}


@pytest.fixture(scope="module", autouse=True)
def small_unet():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TP, "UNet", functools.partial(UNet, **SMALL))
        mp.setattr(JTP, "UNet", functools.partial(FlaxUNet, **SMALL))
        yield


@pytest.fixture(scope="module")
def setup(tmp_path_factory, small_unet):
    """The scenes, config and VGG weights, and a 2-epoch fit of toyA."""
    root = tmp_path_factory.mktemp("cli")
    paths = {"datasets": {name: _write_scene(root, name, seed)
                          for seed, name in enumerate(SCENES)}}
    with open(root / "paths.json", "w") as f:
        json.dump(paths, f)
    config = {"paths_file": str(root / "paths.json"),
              "crop_size": f"{HW}x{HW}", "batch_size": 1,
              "criterion": "huber_only", "splitter": "split_by_step",
              "splitter_args": {"val_step": 3}, "log_freq": 2,
              "save_freq": 1, "headless_platform": "cpu",
              "train_dataset_args": {"inner_batch": 1, "num_samples": 1,
                                     "random_zoom": [1.0, 1.5],
                                     "random_shift": [-1.0, 1.0]}}
    with open(root / "config.json", "w") as f:
        json.dump(config, f)
    vgg = JV.random_vgg_params(0)
    np.savez(root / "vgg.npz", **{f"conv{i}_{k}": np.asarray(a)
                                  for i, (w, b) in enumerate(vgg)
                                  for k, a in (("w", w), ("b", b))})
    fit = _run(root, "fit", ["--epochs", "2", "--max-steps-per-epoch",
                             "1", "--log-freq", "1", "--dataset-names",
                             "toyA"])
    return dict(root=root, config=config, fit=fit)


def _run(root, name, extra, main=TRAIN.main):
    """One in-process CLI run; the experiment directory it made.
    ``read_tpu.train`` leaves its log copy as ``sys.stdout``: undone."""
    save = root / f"logs_{name}"
    streams = sys.stdout, sys.stderr
    try:
        rc = main(["--config", str(root / "config.json"), "--save-dir",
                   str(save), "--name", name] + extra)
    finally:
        sys.stdout, sys.stderr = streams
    assert rc == 0
    (exp,) = os.listdir(save)
    return save / exp


@functools.lru_cache(maxsize=None)
def _template(n_points):
    """A JAX ``TrainState`` of shapes only (the swapped UNet)."""
    cfg = JTP.PipelineConfig(crop_size=(HW, HW))
    return jax.eval_shape(lambda: JTP.create_state(
        jax.random.PRNGKey(0), cfg, n_points=n_points)[0])


def test_fit_experiment_layout(setup):
    exp = setup["fit"]
    for name in ("args.yaml", "log.txt", "splits.json", "history.json",
                 "train_imgs/comp_0.png"):
        assert (exp / name).exists(), name
    with open(exp / "args.yaml") as f:
        args = json.load(f)
    assert args["epochs"] == 2 and args["splitter_args"] == {"val_step": 3}
    with open(exp / "splits.json") as f:
        splits = json.load(f)
    jargs = JTRAIN.load_args(["--config",
                              str(setup["root"] / "config.json")])
    jargs.dataset_names = ["toyA"]
    jtr, jva, _ = JS.get_datasets(jargs)
    assert splits == {tr.name: {"train": tr.target_list,
                                "val": va.target_list}
                      for tr, va in zip(jtr, jva)}
    assert len(splits["toyA"]["val"]) == 2
    with open(exp / "history.json") as f:
        hist = json.load(f)
    assert [h["epoch"] for h in hist] == [0, 1]
    for h in hist:
        assert np.isfinite(h["train_loss"]) and np.isfinite(h["val_loss"])
        tt = h["train_timing"]
        assert len(tt["step_ms"]) == len(tt["wait_ms"]) == 1
        assert h["val_timing"]["views"] == 2
    # --save-freq 1: every epoch saved, best after each improvement
    assert sorted(os.listdir(exp / "checkpoints")) == [
        "best_toyA", "ckpt_toyA_0", "ckpt_toyA_1"]
    with open(exp / "log.txt") as f:
        assert "done; best val loss" in f.read()


def test_rotation_matches_read_tpu(tmp_path):
    """``latest_checkpoint`` and ``rotate_checkpoints`` on one listing
    (epochs out of order, a ``.tmp``, ``best_``, another scene whose name
    shares the prefix) leave what ``read_tpu``'s do."""
    names = ["ckpt_toyA_0", "ckpt_toyA_10", "ckpt_toyA_2", "ckpt_toyA_9",
             "ckpt_toyA_3.tmp", "best_toyA", "ckpt_toyAB_1", "ckpt_toyB_4"]
    trees = []
    for side, ck in (("port", CK), ("jax", JCK)):
        d = tmp_path / side
        for n in names:
            os.makedirs(d / n)
        assert os.path.basename(ck.latest_checkpoint(str(d), "ckpt_toyA")
                                ) == "ckpt_toyA_10"
        ck.rotate_checkpoints(str(d), "ckpt_toyA", keep=3)
        ck.rotate_checkpoints(str(d), "ckpt_toyB", keep=3)
        trees.append(sorted(os.listdir(d)))
    assert trees[0] == trees[1]
    assert "ckpt_toyA_0" not in trees[0] and "ckpt_toyA_9" in trees[0]


def test_checkpoints_load_in_read_tpu(setup):
    ck = setup["fit"] / "checkpoints"
    latest = CK.latest_checkpoint(str(ck), "ckpt_toyA")
    assert latest.endswith("ckpt_toyA_1")
    flat, meta = CK.load_checkpoint(latest)
    assert meta["extra"]["epoch"] == 1 and int(flat["step"]) == 2
    state, jmeta = JCK.load_checkpoint(latest, template=_template(N))
    assert jmeta["config"]["criterion"] == "huber_only"
    jflat = JCK._flatten(state)
    assert set(jflat) == set(flat)
    for key, arr in flat.items():
        np.testing.assert_array_equal(jflat[key], arr, err_msg=key)


def test_resume_continues_the_step(setup):
    ck = setup["fit"] / "checkpoints"
    exp = _run(setup["root"], "resume", ["--epochs", "1",
                                         "--max-steps-per-epoch", "1",
                                         "--resume", str(ck),
                                         "--dataset-names", "toyA"])
    with open(exp / "history.json") as f:
        (h,) = json.load(f)
    assert h["train_timing"]["first_step"] == 3
    assert h["train_timing"]["first_scene"] == "toyA"
    with open(exp / "log.txt") as f:
        assert f"resumed toyA from {ck / 'ckpt_toyA_1'} (step 2)" in f.read()
    flat, _ = CK.load_checkpoint(str(exp / "checkpoints" / "ckpt_toyA_0"))
    assert int(flat["step"]) == 3 and int(flat["net_opt/0/count"]) == 3


def test_eval_matches_read_tpu(setup, monkeypatch):
    """``--eval --eval-all`` from one JAX-written checkpoint: per-view
    metrics within rtol 1e-4, the same args.yaml and splits.json."""
    root = setup["root"]
    fresh, _ = TP.create_state(torch.Generator().manual_seed(3),
                               TP.PipelineConfig(crop_size=(HW, HW)), N,
                               device="cpu")
    assert fresh.flat_params.numel() < 10 ** 6   # the swapped UNet
    jstate = JCK._unflatten(_template(N), TP.flat_from_state(fresh))
    ckpt = str(root / "jax_ckpt")
    JCK.save_checkpoint(ckpt, jstate, config={})
    flags = ["--eval", "--eval-all", "--resume", ckpt, "--criterion",
             "vgg", "--vgg-weights", str(root / "vgg.npz"),
             "--dataset-names", "toyA"]
    recorded = []

    class Recording(JPERF.AccumDict):
        def update(self, metrics):
            recorded.append(dict(metrics))
            super().update(metrics)

    exp = _run(root, "eval", flags + ["--eval-dir", str(root / "ev")])
    monkeypatch.setattr(JPERF, "AccumDict", Recording)
    jexp = _run(root, "jeval", flags + ["--eval-dir", str(root / "jev")],
                main=JTRAIN.main)
    with open(exp / "history.json") as f:
        views = json.load(f)[0]["views"]
    assert len(views) == len(recorded) == VIEWS
    for got, want in zip(views, recorded):
        for key in EVAL_KEYS:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       err_msg=key)
    for name in ("splits.json", "args.yaml"):
        with open(exp / name) as f:
            got = yaml.safe_load(f)
        with open(jexp / name) as f:
            want = yaml.safe_load(f)
        if name == "args.yaml":
            for d in (got, want):
                for key in ("save_dir", "name", "eval_dir"):
                    d.pop(key)
        assert got == want, name
    assert sorted(os.listdir(root / "ev")) == \
        sorted(os.listdir(root / "jev")) == \
        [f"toyA_{i:06}.png" for i in range(VIEWS)]


def test_scene_store_budget_keeps_the_same_states():
    """A budget of 1 over two scenes, driven through the CLI's sequence
    of operations (activate, step, rebind the net, set lr_scale), ends
    with the same states as no budget."""
    cfg = TP.PipelineConfig(crop_size=(16, 16))
    stores = [TRAIN.SceneStateStore(None), TRAIN.SceneStateStore(1)]
    net = UNet(base_channel=8, num_res=1)
    for store in stores:
        gen = torch.Generator().manual_seed(0)
        for sid in (0, 1):
            st, net = TP.create_state(gen, cfg, 50, net=net, device="cpu")
            store[sid] = st
    rng = np.random.default_rng(0)
    for i in range(12):
        sid = int(rng.integers(2))
        upd = torch.from_numpy(rng.normal(size=(50, 8)).astype(np.float32))
        for store in stores:
            st = store.activate(sid)
            store[sid] = st.replace(texture=(st.texture[0] + upd,),
                                    tex_opt=TP.RmsState((st.tex_opt.nu[0]
                                                         + upd * upd,)),
                                    step=st.step + 1)
            other = 1 - sid
            store[other] = store[other].replace(
                lr_scale=torch.tensor(0.5 ** i))
    assert stores[1].resident_ids == (sid,)
    assert stores[1].is_offloaded(1 - sid)
    for sid in (0, 1):
        a, b = (TP.flat_from_state(s.activate(sid)) for s in stores)
        for key, arr in a.items():
            np.testing.assert_array_equal(b[key], arr, err_msg=key)


def test_eval_with_scene_budget(setup):
    """Both scenes from one checkpoint (the same point count), with a
    budget of one resident texture and without."""
    ck = str(setup["fit"] / "checkpoints" / "ckpt_toyA_1")
    results = []
    for budget in ([], ["--max-scenes-hbm", "1"]):
        exp = _run(setup["root"], f"budget{len(budget)}",
                   ["--eval", "--resume", ck] + budget)
        with open(exp / "history.json") as f:
            results.append(json.load(f)[0]["views"])
    assert len(results[0]) == 4 and results[0] == results[1]


_BLOCKED = """
import sys
BLOCKED = {"cv2", "yaml", "imageio", "matplotlib", "tensorboardX"}

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, Block())
import functools
from read_tpu_torch import train
from read_tpu_torch.models.unet import UNet
from read_tpu_torch.pipelines import texture_pipeline as TP
TP.UNet = functools.partial(UNet, base_channel=8, num_res=1)
rc = train.main(sys.argv[1:])
assert not BLOCKED & {m.split(".")[0] for m in sys.modules}
sys.exit(rc)
"""


def test_cli_runs_without_optional_packages(setup, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED, "--config",
         str(setup["root"] / "config.json"), "--save-dir",
         str(tmp_path), "--epochs", "1", "--max-steps-per-epoch", "2",
         "--dataset-names", "toyB"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (exp,) = os.listdir(tmp_path)
    for name in ("args.yaml", "splits.json", "train_imgs/comp_0.png",
                 "checkpoints/best_toyB", "val_imgs/toyB_000000.png"):
        assert os.path.exists(os.path.join(tmp_path, exp, name)), name


@pytest.mark.parametrize("case", ["max_scenes_hbm", "freeze_net",
                                  "rgb_texture", "drop_points"])
def test_mesh_keeps_read_tpu_rules(setup, tmp_path, case):
    """``--mesh`` as ``read_tpu.train`` has it: with ``--max-scenes-hbm``
    or ``--freeze-net`` it exits; ``--pipeline rgb_texture`` runs as
    without it (after the mesh line); a config with ``drop_points`` trains
    sharded and warns that the sharded step does not apply it."""
    config = dict(setup["config"])
    if case == "drop_points":
        config["train_dataset_args"] = dict(
            config["train_dataset_args"], drop_points=0.1)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(config, f)
    short = ["--epochs", "1", "--max-steps-per-epoch", "1",
             "--dataset-names", "toyA"]
    if case in ("max_scenes_hbm", "freeze_net"):
        flag = {"max_scenes_hbm": ["--max-scenes-hbm", "1"],
                "freeze_net": ["--freeze-net"]}[case]
        with pytest.raises(SystemExit, match=f"{flag[0]} is not supported "
                                             "with --mesh"):
            TRAIN.main(["--config", str(tmp_path / "config.json"),
                        "--save-dir", str(tmp_path / "logs"), "--mesh",
                        "1x2"] + flag)
        return
    flags = (["--pipeline", "rgb_texture", "--mesh", "1x2"]
             if case == "rgb_texture" else ["--mesh", "1x1"])
    exp = _run(tmp_path, case, flags + short)
    with open(exp / "log.txt") as f:
        log = f.read()
    assert "mesh: data=1 x points=" in log
    if case == "rgb_texture":
        assert "backend" not in log   # no ranks were started
        assert (exp / "checkpoints" / "best_rgb_texture_toyA").exists()
    else:
        assert "does not apply drop_points under --mesh" in log
        assert "backend gloo" in log   # rank 0's line
        assert (exp / "checkpoints" / "best_toyA").exists()


def test_mesh_fit_matches_unsharded(setup):
    """``--mesh 1x2`` (two gloo ranks; with batch 1 the second takes no
    rows in stage 2) for one epoch of both scenes: the checkpoints an
    unsharded run leaves, unsharded, loading in ``NeuralRenderer`` on one
    device; the train and val losses of the unsharded run within 1e-4."""
    flags = ["--epochs", "1", "--max-steps-per-epoch", "2"]
    runs = {name: _run(setup["root"], name, flags + extra)
            for name, extra in (("mesh1x2", ["--mesh", "1x2"]),
                                ("unsharded", []))}
    hist = {}
    for name, exp in runs.items():
        with open(exp / "history.json") as f:
            (hist[name],) = json.load(f)
    for key in ("train_loss", "val_loss"):
        assert abs(hist["mesh1x2"][key] - hist["unsharded"][key]) <= 1e-4
    assert len(hist["mesh1x2"]["train_timing"]["step_ms"]) == 2
    listing = {name: sorted(os.listdir(exp / "checkpoints"))
               for name, exp in runs.items()}
    assert listing["mesh1x2"] == listing["unsharded"] == [
        "best_toyA", "best_toyB", "ckpt_toyA_0", "ckpt_toyB_0"]
    best = str(runs["mesh1x2"] / "checkpoints" / "best_toyA")
    flat, _ = CK.load_checkpoint(best)
    assert flat["texture"].shape == (N, 8)   # the padding stripped
    r = TR.NeuralRenderer(setup["config"]["paths_file"].replace(
        "paths.json", "toyA/scene.json"), best, device="cpu")
    img = r.infer(r.scene_data["view_matrix"][0])
    assert img.shape == (HW, HW, 3) and np.isfinite(img).all()


def _one_step(setup, name, flags):
    """One train step and one val pass of toyA with ``flags``; ``(exp
    dir, its history, the target shapes the pyramids were rasterized
    at)``."""
    shapes = []
    real = TP.R.rasterize_pyramid_pooled

    def spy(xyz, total_m, target_shape, *a, **k):
        shapes.append(tuple(target_shape))
        return real(xyz, total_m, target_shape, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TP.R, "rasterize_pyramid_pooled", spy)
        exp = _run(setup["root"], name, flags + [
            "--epochs", "1", "--max-steps-per-epoch", "1",
            "--dataset-names", "toyA"])
    with open(exp / "history.json") as f:
        (hist,) = json.load(f)
    assert np.isfinite([hist["train_loss"], hist["val_loss"]]).all()
    assert len(hist["train_timing"]["step_ms"]) == 1
    return exp, hist, shapes


def test_cli_trains_and_resumes_in_bfloat16(setup):
    """``--dtype bfloat16``: 2 steps whose checkpoints record the dtype,
    then a resume from them that continues the step in bfloat16 (the
    net's route is bfloat16 in the steps and the val pass)."""
    routes = []
    real = UNet.forward

    def spy(self, *a, operands="f32", **k):
        routes.append(operands)
        return real(self, *a, operands=operands, **k)

    flags = ["--dtype", "bfloat16", "--epochs", "1",
             "--max-steps-per-epoch", "2", "--dataset-names", "toyA"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(UNet, "forward", spy)
        exp = _run(setup["root"], "bf16", flags)
        ck = exp / "checkpoints"
        flat, meta = CK.load_checkpoint(str(ck / "ckpt_toyA_0"))
        assert meta["config"]["dtype"] == "bfloat16"
        assert int(flat["step"]) == 2
        assert flat["params/feat0/conv_fm/kernel"].dtype == np.float32
        again = _run(setup["root"], "bf16_resume",
                     flags + ["--resume", str(ck)])
    assert routes and set(routes) == {"bf16"}
    with open(again / "history.json") as f:
        (h,) = json.load(f)
    assert h["train_timing"]["first_step"] == 3
    assert np.isfinite([h["train_loss"], h["val_loss"]]).all()
    flat, meta = CK.load_checkpoint(str(again / "checkpoints"
                                        / "ckpt_toyA_0"))
    assert int(flat["step"]) == 4 and meta["config"]["dtype"] == "bfloat16"


def test_cli_trains_with_supersampling(setup):
    """``--supersampling 2``: the train step and the val pass rasterize
    at twice the crop and frame; the checkpoint renders at ss 2."""
    exp, hist, shapes = _one_step(setup, "ss2", ["--supersampling", "2"])
    assert shapes == [(2 * HW, 2 * HW)] * (1 + hist["val_timing"]["batches"])
    r = TR.NeuralRenderer(setup["config"]["paths_file"].replace(
        "paths.json", "toyA/scene.json"),
        str(exp / "checkpoints" / "best_toyA"), device="cpu")
    assert r.cfg.supersampling == 2


def test_cli_trains_an_extra_mode_format(setup):
    """``--input-format`` with ``colors`` and ``normals_l`` at every
    scale: the net takes 8 + 3 + 3 channels, the steps get the scene's
    colours, world xyz and per-item view matrices (``normals_l`` raises
    without them; the toy scenes have no normals, so its map is 0), and
    the checkpoint renders with the same attributes."""
    fmt = ", ".join(f"uv_1d_p1{s}, colors{s}, normals_l{s}"
                    for s in [""] + [f"_ds{i}" for i in range(1, 5)])
    exp, _, _ = _one_step(setup, "extra", ["--input-format", fmt])
    best = str(exp / "checkpoints" / "best_toyA")
    flat, meta = CK.load_checkpoint(best)
    assert meta["config"]["input_format"] == fmt
    assert flat["params/feat0/conv_fm/kernel"].shape[2] == 14
    r = TR.NeuralRenderer(setup["config"]["paths_file"].replace(
        "paths.json", "toyA/scene.json"), best, device="cpu")
    assert r.cfg.net_in_channels == 14
    assert sorted(r.pc_attrs) == ["rgb", "xyz"]
    img = r.infer(r.scene_data["view_matrix"][0])
    assert img.shape == (HW, HW, 3) and np.isfinite(img).all()


def test_no_cuda_refuses_without_cpu_flag(setup, tmp_path, monkeypatch):
    """No ``--headless-platform`` (or ``cuda``) and no CUDA device: exit
    before any experiment directory exists."""
    config = {k: v for k, v in setup["config"].items()
              if k != "headless_platform"}
    path = tmp_path / "config.json"
    with open(path, "w") as f:
        json.dump(config, f)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--headless-platform", "cuda"]):
        with pytest.raises(SystemExit, match="--headless-platform cpu"):
            TRAIN.main(["--config", str(path), "--save-dir",
                        str(tmp_path / "logs")] + extra)
    assert not os.path.exists(tmp_path / "logs")
