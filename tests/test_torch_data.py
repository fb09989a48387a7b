"""The port's host data path against read_tpu's, on the CPU.

- splitters: all four give ``read_tpu.data.splitter``'s lists;
- ``ViewDataset``/``BatchIterator``/``get_datasets`` against
  ``read_tpu.data``'s on one tiny scene on disk (uint8 RGB targets,
  8-bit masks and labels as PNG) with the same seed: train items'
  ``total_m``, ``intrinsic_matrix`` and ``view_matrix`` bit-equal, labels
  (nearest warps) equal, targets and masks (bilinear warps) within
  ``WARP_ATOL``; val items likewise; ``crop_by_mask``; batch order;
- ``warp_perspective`` against ``cv2.warpPerspective``;
- ``image_io``: the PNG decoder bit-equal to ``cv2.imread(...,
  IMREAD_UNCHANGED)`` on files ``cv2.imwrite`` wrote with each row
  filter (8 and 16 bits, 1, 3 and 4 channels) and on the encoder's own
  files (every filter, 1-4 channels, gray+alpha included); the
  encoder's files read back equal;
- ``config_io``: every ``configs/*.yaml`` as ``yaml.safe_load`` reads
  it, and with PyYAML blocked both as JSON and as it is (the block-style
  YAML subset); a file outside that subset raises naming itself;
  ``scene.io.load_scene_data`` on a JSON manifest with PyYAML blocked.

``WARP_ATOL = 1e-5``: the numpy warp follows the vector path of OpenCV
5's warp (float32 source coordinates, each row's offsets multiplied and
added, the column term fused; bilinear as three fused lerps) and is
bit-equal to this environment's OpenCV 5.0 wherever that path runs:
every column when the output width is a multiple of 16, as the
dataset's crops and frames here are (max |err| 0). OpenCV's scalar tail
(the last ``w mod 16`` columns otherwise) rounds the column term
separately, which moves a source coordinate by one float32 ulp: up to
7.6e-6 on [0, 1] images under 128 px. OpenCV 4.10 and older warp through
a 1/32-pixel table and differ by up to ~0.025 on noise. For a general
perspective homography (no dataset draws one) the coordinates differ by
up to one ulp everywhere: ``PERSPECTIVE_ATOL = 2e-5``, and under 1% of
nearest picks move.
"""

import glob
import json
import os
from types import SimpleNamespace

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import yaml

from read_tpu.data import dataset as JD
from read_tpu.data import scenes as JS
from read_tpu.data import splitter as JSP
from read_tpu.scene import io as JIO
from read_tpu_torch.data import dataset as D
from read_tpu_torch.data import image_io
from read_tpu_torch.data import scenes as S
from read_tpu_torch.data import splitter as SP
from read_tpu_torch.scene import io as IO
from read_tpu_torch.utils import config_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARP_ATOL = 1e-5
PERSPECTIVE_ATOL = 2e-5
VIEWPORT = (96, 64)   # (w, h)
N_VIEWS = 7


def _write_scene(root, json_manifest=False):
    """A tiny posed scene: targets are random-colour RGB PNGs, masks a
    blob per view, labels 0-8 blocks."""
    rng = np.random.default_rng(0)
    w, h = VIEWPORT
    xyz = rng.uniform(-2, 2, size=(300, 3)).astype(np.float32)
    xyz[:, 2] -= 6.0
    JIO.write_ply(str(root / "pc.ply"), xyz, rng.uniform(size=(300, 3)))
    K = np.array([[70.0, 0, w / 2], [0, 70.0, h / 2], [0, 0, 1]])
    np.savetxt(root / "cam.txt", np.vstack([[w, h, 0], K]))
    views = []
    for d in ("images", "masks", "labels"):
        os.makedirs(root / d, exist_ok=True)
    yy, xx = np.mgrid[:h, :w]
    for i in range(N_VIEWS):
        view = np.eye(4)
        view[0, 3] = 0.15 * i
        views.append(view)
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        imageio.imwrite(str(root / "images" / f"{i:06}.png"), img)
        blob = ((xx - 20 - 6 * i) ** 2 + (yy - 30) ** 2 < 200)
        imageio.imwrite(str(root / "masks" / f"{i}.png"),
                        (blob * 255).astype(np.uint8))
        lab = ((xx // 12 + yy // 16 + i) % 9).astype(np.uint8)
        imageio.imwrite(str(root / "labels" / f"{i}.png"), lab)
    np.savetxt(root / "poses.dat", np.stack(views).reshape(-1, 4))
    manifest = {"viewport_size": [w, h], "pointcloud": "pc.ply",
                "intrinsic_matrix": "cam.txt", "view_matrix": "poses.dat"}
    paths = {"datasets": {"toy": {
        "scene_path": str(root / "scene.yaml"),
        "target_path": str(root / "images"),
        "target_name": "{label:06d}.png",
        "mask_path": str(root / "masks"),
        "label_path": str(root / "labels")}}}
    with open(root / "scene.yaml", "w") as f:
        yaml.safe_dump(manifest, f)
    with open(root / "scene.json", "w") as f:
        json.dump(manifest, f)
    with open(root / "paths.yaml", "w") as f:
        yaml.safe_dump(paths, f)
    return root


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return _write_scene(tmp_path_factory.mktemp("scene"))


def _args(scene, **tda):
    return SimpleNamespace(
        paths_file=str(scene / "paths.yaml"), dataset_names=None,
        exclude_datasets=None, crop_size="32x24", eval_all=False,
        splitter="split_by_step", splitter_args={"val_step": 3},
        train_dataset_args=dict(
            random_zoom=[0.5, 2.0], random_shift=[-1.0, 1.0],
            num_samples=2, inner_batch=3, **tda),
        val_dataset_args={})


# ---------------------------------------------------------------------------
# splitters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw", [
    ("split_by_ratio", dict(train_ratio=0.7, seed=3)),
    ("split_by_step", dict(val_step=4, train_drop=1)),
    ("split_by_step100", dict(val_step=10)),
    ("eval_all", {})])
def test_splitters_match_read_tpu(name, kw):
    lists = [list(range(137)), [f"t{i}" for i in range(137)],
             [None] * 137]
    assert SP.get_splitter(name)(lists, **kw) == \
        JSP.get_splitter(name)(lists, **kw)
    with pytest.raises(KeyError):
        SP.get_splitter("by_eval")


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------


def _assert_item(got, want):
    for key in ("total_m", "intrinsic_matrix", "view_matrix", "label",
                "id"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got[key].dtype == want[key].dtype, key
    for key in ("target", "mask"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=WARP_ATOL, err_msg=key)
    assert got["target_filename"] == want["target_filename"]


@pytest.mark.parametrize("crop_by_mask", [False, True])
def test_view_dataset_matches_read_tpu(scene, crop_by_mask):
    """Train and val items from ``get_datasets`` on both sides."""
    args = _args(scene, crop_by_mask=crop_by_mask)
    tr, va, tex = S.get_datasets(args)
    jtr, jva, jtex = JS.get_datasets(args)
    assert tex == jtex
    assert tr[0].target_list == jtr[0].target_list
    assert va[0].target_list == jva[0].target_list
    assert len(tr[0]) == len(jtr[0]) == 2 * 4
    for i in range(len(tr[0])):
        _assert_item(tr[0][i], jtr[0][i])
    assert tr[0][0]["target"].shape == (3, 24, 32, 3)
    for i in range(len(va[0])):
        _assert_item(va[0][i], jva[0][i])
    assert va[0][0]["target"].shape == (64, 96, 3)


def test_batch_iterator_order_matches_read_tpu(scene):
    args = _args(scene)
    (tr,), _, _ = S.get_datasets(args)
    (jtr,), _, _ = JS.get_datasets(args)
    got = list(D.PrefetchIterator(D.BatchIterator(tr, 3, seed=5)))
    want = list(JD.BatchIterator(jtr, 3, seed=5))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["target_filename"] == w["target_filename"]
        for key in ("total_m", "label", "id", "view_matrix"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        np.testing.assert_allclose(g["target"], w["target"], rtol=0,
                                   atol=WARP_ATOL)


def test_prefetch_stops_its_worker_when_the_consumer_stops():
    """Breaking out of the loop joins the worker (it would otherwise
    block on a full queue for the life of the process); an error in
    the source reaches the consumer."""
    import itertools
    import threading
    before = threading.active_count()
    for _ in range(20):
        for i in D.PrefetchIterator(itertools.count(), depth=2):
            if i == 3:
                break
    assert threading.active_count() == before

    def failing():
        yield 1
        raise ValueError("source failed")

    with pytest.raises(ValueError, match="source failed"):
        list(D.PrefetchIterator(failing()))
    assert threading.active_count() == before


@pytest.mark.parametrize("nearest", [False, True])
@pytest.mark.parametrize("perspective", [False, True])
def test_warp_matches_cv2(nearest, perspective):
    """Zoom+shift homographies (what the dataset draws) within
    ``WARP_ATOL`` bilinear and exactly nearest; a general perspective
    homography within ``PERSPECTIVE_ATOL`` (OpenCV's source coordinates
    then differ from the numpy warp's by up to one float32 ulp)."""
    rng = np.random.default_rng(2)
    worst = 0.0
    for t in range(8):
        shape = [(37, 53, 3), (64, 96), (40, 40, 4)][t % 3]
        img = rng.uniform(size=shape).astype(np.float32)
        if nearest:
            img = (img * 9).astype(np.uint8)
        z = rng.uniform(0.2, 2.0)
        H = np.array([[z, 0, -rng.uniform(0, 30)],
                      [0, z, -rng.uniform(0, 20)], [0, 0, 1.0]])
        if perspective:
            H = H @ np.array([[1.1, 0.05, -3], [0.02, 0.9, 4],
                              [1e-3, 2e-3, 1.0]])
        size = (int(rng.integers(8, 80)), int(rng.integers(8, 80)))
        got = D.warp_perspective(img, H, size, nearest=nearest)
        want = cv2.warpPerspective(img, H, size, flags=cv2.INTER_NEAREST
                                   if nearest else cv2.INTER_LINEAR)
        assert got.shape == want.shape and got.dtype == want.dtype
        err = np.abs(got.astype(np.float64) - want)
        if nearest and perspective:   # a tie can round either way
            err = np.mean(err > 0)
        worst = max(worst, float(err.max()))
    bound = (PERSPECTIVE_ATOL if perspective else WARP_ATOL) \
        if not nearest else (0.01 if perspective else 0)
    assert worst <= bound, worst


# ---------------------------------------------------------------------------
# image_io
# ---------------------------------------------------------------------------

_CV2_FILTERS = [cv2.IMWRITE_PNG_FILTER_NONE, cv2.IMWRITE_PNG_FILTER_SUB,
                cv2.IMWRITE_PNG_FILTER_UP, cv2.IMWRITE_PNG_FILTER_AVG,
                cv2.IMWRITE_PNG_FILTER_PAETH, cv2.IMWRITE_PNG_ALL_FILTERS]


def _image(rng, dtype, channels, shape=(19, 27)):
    hi = 256 if dtype == np.uint8 else 65536
    full = shape + ((channels,) if channels > 1 else ())
    noise = rng.integers(0, hi, full)
    smooth = np.cumsum(np.cumsum(rng.integers(0, 3, full), 0), 1) % hi
    return np.where(rng.uniform(size=full) < 0.3, noise, smooth
                    ).astype(dtype)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decoder_matches_cv2(tmp_path, dtype, channels):
    rng = np.random.default_rng(channels)
    path = str(tmp_path / "x.png")
    for flt in _CV2_FILTERS:
        img = _image(rng, dtype, channels)
        assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER, flt])
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        got = image_io.read_png(path)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=str(flt))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_png_encoder_round_trips(tmp_path, dtype):
    """Every filter and channel count, gray+alpha included: cv2 and the
    port's decoder read the encoder's files back equal (in cv2's BGR(A)
    order; gray+alpha as BGRA)."""
    rng = np.random.default_rng(7)
    path = str(tmp_path / "y.png")
    for channels in (1, 2, 3, 4):
        for flt in range(5):
            img = _image(rng, dtype, channels)
            image_io.write_png(path, img, filter_type=flt)
            if channels == 1:
                want = img
            elif channels == 2:
                want = img[..., [0, 0, 0, 1]]
            else:
                want = img[..., [2, 1, 0, 3][:channels]]
            for got in (cv2.imread(path, cv2.IMREAD_UNCHANGED),
                        image_io.read_png(path)):
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{channels} {flt}")


def test_imread_without_cv2(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    img = _image(rng, np.uint8, 3)
    png, jpg = str(tmp_path / "a.png"), str(tmp_path / "a.jpg")
    cv2.imwrite(png, img)
    cv2.imwrite(jpg, img)
    with_cv2 = image_io.imread(png)
    monkeypatch.setattr(image_io, "_cv2", lambda: None)
    np.testing.assert_array_equal(image_io.imread(png), with_cv2)
    with pytest.raises(ValueError, match="'jpg'"):
        image_io.imread(jpg)
    with pytest.raises(ValueError, match="'jpg'"):
        image_io.imwrite(jpg, img)
    with pytest.raises(FileNotFoundError):
        image_io.imread(str(tmp_path / "missing.png"))
    np.testing.assert_array_equal(image_io.imread_color(png), img)


# ---------------------------------------------------------------------------
# config_io and the scene manifest
# ---------------------------------------------------------------------------


def test_colorize_matches_read_tpu():
    """The carried viridis table against ``read_tpu``'s matplotlib call
    (NaN included), and the KITTI palette."""
    from read_tpu.utils import colorize as JC
    from read_tpu_torch.utils import colorize as C
    rng = np.random.default_rng(4)
    x = rng.normal(size=(40, 50))
    x[0, :3] = (np.nan, x.min(), x.max())
    np.testing.assert_array_equal(C.colorize(x), JC.colorize(x))
    np.testing.assert_array_equal(C.colorize(x, vmin=-1, vmax=0.5),
                                  JC.colorize(x, vmin=-1, vmax=0.5))
    labels = rng.integers(-2, 12, (7, 9))
    np.testing.assert_array_equal(C.label_to_color(labels),
                                  JC.label_to_color(labels))


def test_config_io_reads_every_config(tmp_path, monkeypatch):
    files = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
    assert len(files) >= 9
    wants = []
    for path in files:
        with open(path) as f:
            want = yaml.safe_load(f)
        assert config_io.load(path) == want, path
        wants.append(want)
    monkeypatch.setattr(config_io, "_yaml", lambda: None)
    for path, want in zip(files, wants):
        js = str(tmp_path / (os.path.basename(path) + ".json"))
        config_io.dump(want, js)
        assert config_io.load(js) == want, path
        with open(js) as f:
            assert yaml.safe_load(f) == want, path
        assert config_io.load(path) == want, path
    for i, text in enumerate(["a: &x 1\nb: *x\n", "a:\n- b: 1\n",
                              "a: |\n  text\n", "---\na: 1\n"]):
        bad = tmp_path / f"bad{i}.yaml"
        bad.write_text(text)
        with pytest.raises(config_io.ConfigFormatError, match=bad.name):
            config_io.load(str(bad))


def test_scene_manifest_as_json_without_yaml(scene, monkeypatch):
    want = JIO.load_scene_data(str(scene / "scene.yaml"))
    monkeypatch.setattr(config_io, "_yaml", lambda: None)
    got = IO.load_scene_data(str(scene / "scene.json"))
    assert got["camera_labels"] == want["camera_labels"]
    assert tuple(got["config"]["viewport_size"]) == VIEWPORT
    for key in ("intrinsic_matrix", "model3d_origin"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_array_equal(np.stack(got["view_matrix"]),
                                  np.stack(want["view_matrix"]))
    for key in ("xyz", "rgb"):
        np.testing.assert_array_equal(got["pointcloud"][key],
                                      want["pointcloud"][key], err_msg=key)
    # the YAML manifest reads through the block-style subset alike
    again = IO.load_scene_data(str(scene / "scene.yaml"))
    assert again["config"] == want["config"]
    np.testing.assert_array_equal(np.stack(again["view_matrix"]),
                                  np.stack(want["view_matrix"]))
    np.testing.assert_array_equal(again["pointcloud"]["xyz"],
                                  want["pointcloud"]["xyz"])

