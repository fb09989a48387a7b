"""The triangle raster's CUDA kernel (``csrc/mesh_raster.cu``) against its
plain twin on the same CUDA inputs, and the route by device.

``ops.rasterize_mesh.rasterize_mesh`` on a CUDA tensor runs the kernel;
its face-id and depth maps must be bit-equal to
``rasterize_mesh_plain``'s (the chain of PyTorch ops, run on the card
too) on random meshes, ties at one depth (the least id wins), vertices
behind the eye, faces straddling ``w = 0``, flat faces, faces larger
than the subgrid, candidates off the frame and beyond ``|z| = 1``,
``samples`` 8, 32 and 64, and the benchmark's street mesh
(``benchmark.street_mesh``) at the ``street-mesh-fit`` cell's 256x256
crop views, every level, and at 1216x368. ``counts['rasters']`` and
``counts['kernel']`` rise by one a view; ``cell_faults``' planted
``tie_to_larger`` still changes a tie mesh's index map; a face naming
a vertex the mesh lacks covers nothing (the twin's indexing raises).
These skip without a card; run them there with::

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_cuda.py -q

The one CPU test: on CPU tensors ``rasterize_mesh`` runs the twin and
the kernel's counter stays at 0.
"""

import json
import os

import numpy as np
import pytest
import torch

from read_tpu_torch.ops import rasterize_mesh as M
from read_tpu_torch.scene import camera

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    yield torch.device("cuda")
    torch.cuda.empty_cache()


def _cam(w, h, view=None, znear=0.1, zfar=100.0):
    K = np.array([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]])
    P = camera.gl_projection(K, (w, h), znear=znear, zfar=zfar)
    return camera.total_matrix(P, np.eye(4) if view is None else view
                               ).astype(np.float32)


def _random_mesh(rng, n_tri, spread=1.5, size=0.25, near=3.0, far=8.0):
    centers = rng.uniform(-spread, spread, size=(n_tri, 3))
    centers[:, 2] = -rng.uniform(near, far, size=n_tri)
    offs = rng.uniform(-size, size, size=(n_tri, 3, 3))
    verts = (centers[:, None, :] + offs).reshape(-1, 3).astype(np.float32)
    faces = np.arange(n_tri * 3, dtype=np.int32).reshape(n_tri, 3)
    return verts, faces


def _mesh(name):
    """``(verts, faces, h, w, total_m)`` of one test case, numpy."""
    rng = np.random.default_rng(5)
    h, w = 72, 104
    m = _cam(w, h)
    if name == "random":
        verts, faces = _random_mesh(rng, 3000)
    elif name == "winding":
        verts, faces = _random_mesh(rng, 2000)
        faces[::2] = faces[::2, ::-1]
    elif name == "tie":           # every face twice, the copies far apart
        verts, faces = _random_mesh(rng, 400)
        faces = np.concatenate([faces, faces[::-1]])
    elif name == "behind":        # some vertices behind the eye (z > 0)
        verts, faces = _random_mesh(rng, 2000, size=0.4)
        verts[::7, 2] = rng.uniform(0.5, 2.0, len(verts[::7]))
    elif name == "straddle":      # each face across the eye plane z = 0
        verts, faces = _random_mesh(rng, 1500, size=0.3, near=-0.3,
                                    far=0.3)
        verts[::3, 2] = -rng.uniform(1e-8, 1e-4, len(verts[::3]))
    elif name == "flat":          # collinear and repeated corners
        verts, faces = _random_mesh(rng, 1500)
        v = verts.reshape(-1, 3, 3)
        v[::3, 2] = 0.5 * (v[::3, 0] + v[::3, 1])
        v[1::3, 1] = v[1::3, 0]
        verts = v.reshape(-1, 3)
    elif name == "large":         # bboxes far beyond the subgrid
        verts, faces = _random_mesh(rng, 300, size=1.5)
    elif name == "offscreen":     # straddling every edge of the frame
        verts, faces = _random_mesh(rng, 3000, spread=4.0)
    elif name == "clip_z":        # across the near and the far plane
        verts, faces = _random_mesh(rng, 2000, spread=1.0, size=0.6,
                                    near=0.05, far=0.3)
        verts[1::2, 2] = -rng.uniform(0.5, 12.0, len(verts[1::2]))
        m = _cam(w, h, znear=0.2, zfar=6.0)
    elif name == "negative_ids":  # ids counted from the end, int64
        verts, faces = _random_mesh(rng, 1000)
        faces = (faces - len(verts)).astype(np.int64)
    else:
        raise KeyError(name)
    return verts, faces, h, w, m


CASES = ["random", "winding", "tie", "behind", "straddle", "flat", "large",
         "offscreen", "clip_z", "negative_ids"]


def _both(verts, faces, m, h, w, samples=8):
    """The kernel's and the twin's maps on the card, and how many views
    the counters saw."""
    before = dict(M.counts)
    got = M.rasterize_mesh(verts, faces, m, h, w, samples)
    ran = {k: M.counts[k] - before[k] for k in ("rasters", "kernel",
                                                "chunks")}
    want = M.rasterize_mesh_plain(verts, faces, m, h, w, samples)
    torch.cuda.synchronize()
    return got, want, ran


def _assert_same(got, want):
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("samples", [8, 32, 64])
def test_kernel_is_bit_equal_to_the_twin(dev, name, samples):
    verts, faces, h, w, m = _mesh(name)
    got, want, ran = _both(torch.from_numpy(verts).to(dev),
                           torch.from_numpy(faces).to(dev),
                           torch.from_numpy(m).to(dev), h, w, samples)
    _assert_same(got, want)
    assert ran == {"rasters": 1, "kernel": 1, "chunks": 0}
    covered = int((got[0] >= 0).sum())
    assert covered > (0 if name in ("straddle", "clip_z") else 200), covered


@pytest.mark.cuda
def test_ties_go_to_the_least_id_and_the_planted_fault_flips_them(dev):
    from benchmark import cell_faults
    verts, faces, h, w, m = _mesh("tie")
    v, f, mm = (torch.from_numpy(a).to(dev) for a in (verts, faces, m))
    index, _ = M.rasterize_mesh(v, f, mm, h, w)
    n = len(faces) // 2
    assert bool((index[index >= 0] < n).all())
    with cell_faults.planted("tie_to_larger"):
        flipped, _ = M.rasterize_mesh_batch(v, f, mm[None], h, w)
    changed = flipped[0] != index
    assert int(changed.sum()) > 200
    assert bool((flipped[0][changed] >= n).all())


@pytest.mark.cuda
def test_faces_with_ids_out_of_range_cover_nothing(dev):
    """A face naming a vertex the mesh lacks is skipped on the card (the
    twin's indexing raises): the maps are the twin's without it."""
    verts, faces, h, w, m = _mesh("random")
    bad = faces.copy()
    bad[::5, 1] = len(verts) + 7
    bad[1::5, 2] = -len(verts) - 3
    v, mm = torch.from_numpy(verts).to(dev), torch.from_numpy(m).to(dev)
    got = M.rasterize_mesh(v, torch.from_numpy(bad).to(dev), mm, h, w)
    keep = np.ones(len(faces), bool)
    keep[::5] = keep[1::5] = False
    # the skipped faces as [0, 0, 0], a point, which the twin rejects as
    # flat: every other face keeps its id
    want_faces = np.where(keep[:, None], faces, 0)
    want = M.rasterize_mesh_plain(v, torch.from_numpy(want_faces).to(dev),
                                  mm, h, w)
    _assert_same(got, want)
    assert int((got[0] >= 0).sum()) > 200


def _street(dev):
    from benchmark import street_mesh, weights
    from benchmark.kinds import fit_mesh
    cfg = json.load(open(os.path.join(ROOT, "benchmark", "configs",
                                      "read-street-mesh.json")))
    traffic = json.load(open(os.path.join(ROOT, "benchmark", "traffic",
                                          "fit_mesh_crops.json")))
    seed = 2 ** 31 + 24
    cell = fit_mesh.Cell(cfg, traffic, seed, dev)
    verts, faces, _ = street_mesh.street_mesh(
        cfg["mesh_edge_m"], cfg["mesh_jitter_m"],
        weights.generator(seed, "scene", dev), dev)
    return cfg, cell, verts, faces


@pytest.mark.cuda
def test_street_mesh_crops_every_level_and_the_frame(dev):
    """The cell's first batch: 8 crop views of 256x256 at each of the 4
    levels, one raster a view; then a full 1216x368 view."""
    cfg, cell, verts, faces = _street(dev)
    ms = torch.from_numpy(cell.matrices[0]).to(dev)
    cw, ch = cell.crop
    covered = []
    for i in range(cfg["num_scales"]):
        before = dict(M.counts)
        got = M.rasterize_mesh_batch(verts, faces, ms, ch >> i, cw >> i,
                                     cfg["samples"])
        assert M.counts["rasters"] - before["rasters"] == len(ms)
        assert M.counts["kernel"] - before["kernel"] == len(ms)
        for b in range(len(ms)):
            want = M.rasterize_mesh_plain(verts, faces, ms[b], ch >> i,
                                          cw >> i, cfg["samples"])
            _assert_same((got[0][b], got[1][b]), want)
        covered.append(float((got[0] >= 0).float().mean()))
    assert min(covered) > 0.3, covered
    w, h = cfg["viewport"]
    K = np.array([[cfg["focal"], 0, w / 2], [0, cfg["focal"], h / 2],
                  [0, 0, 1]])
    view = np.eye(4)
    view[:3, 3] = (0.0, 1.6, 10.0)
    view[:3, :3] = camera.look_at((0.0, 1.6, 10.0), (0.0, 1.2, 60.0),
                                  up=(0.0, 1.0, 0.0))[:3, :3]
    P = camera.gl_projection(K, (w, h), znear=0.1, zfar=1000.0)
    m = torch.from_numpy(camera.total_matrix(P, view).astype(
        np.float32)).to(dev)
    got, want, ran = _both(verts, faces, m, h, w, cfg["samples"])
    _assert_same(got, want)
    assert ran["kernel"] == 1 and float((got[0] >= 0).float().mean()) > 0.3


def test_cpu_tensors_run_the_twin(monkeypatch):
    """On CPU tensors the twin runs (its chunks counted) and the kernel's
    counter stays at 0: the maps are the twin's own."""
    monkeypatch.setattr(M, "counts", {"rasters": 0, "kernel": 0,
                                      "chunks": 0})
    verts, faces = _random_mesh(np.random.default_rng(1), 60)
    m = _cam(40, 32)
    v, f, mm = (torch.from_numpy(a) for a in (verts, faces, m))
    got = M.rasterize_mesh_batch(v, f, torch.stack([mm, mm]), 32, 40)
    assert M.counts == {"rasters": 2, "kernel": 0, "chunks": 2}
    want = M.rasterize_mesh_plain(v, f, mm, 32, 40)
    assert torch.equal(got[0][1], want[0]) and torch.equal(got[1][1],
                                                           want[1])
    assert int((want[0] >= 0).sum()) > 50
