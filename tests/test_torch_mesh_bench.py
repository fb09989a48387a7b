"""The port's mesh-texture path against the benchmark's plain reference
(``benchmark/reference/mesh.py``, ``mesh_fit.py``) on the CPU, at a small
size: the benchmark's street mesh at 1 m quads (7,440 faces), the
``street-mesh-fit`` cell's crops cut to 32x32 and a UNet of base 8 with
one res block, seeded random weights.

- Face ids: the port's raster, the reference's and the port's float64
  oracle ``rasterize_mesh_reference`` are bit-equal at 16x16, where no
  pixel's face is wider than the 8x8 sample grid; at 32x32, where some
  are, the port and the reference stay bit-equal and the oracle, which
  covers each face whole, differs only at pixels outside a face's
  subgrid (the departure from READ that ``benchmark/reference/mesh.py``
  names).
- The uv maps within 1e-6 and the sampled pyramid within 2e-6 (below).
- The cell's first steps: every number of its ``correct`` (the first
  step held stage by stage, ``benchmark/reference/mesh_stages.py``, and
  the changes after three steps) within the cell's own limits
  (``benchmark/limits/street-mesh-fit.json``), the first loss and
  gradients within 1e-6 and 1e-3; the reference with TF32 operands in
  the program's place over the layers' limits.
"""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.kinds import fit_mesh
from benchmark.kinds.fit import compare
from benchmark.reference import mesh as RefMesh
from benchmark.reference import mesh_fit
from read_tpu_torch.ops import rasterize_mesh as M
from read_tpu_torch.pipelines import texture_pipeline as TP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = 8
# the same arithmetic, written apart: bit-equal on the CPU; the bound
# leaves room for a sum of three weights taken in another order (a few
# float32 ulps of a uv in [0, 1])
UV_ATOL = 1e-6
# F.grid_sample forms each corner's weight from the far corner's
# distance, the port from the near one's, and four levels of texels in
# [0, 1) are summed: a few ulps of a sum near 2
PYRAMID_ATOL = 2e-6


def _json(*path):
    with open(os.path.join(ROOT, *path)) as f:
        return json.load(f)


@pytest.fixture(scope="module", autouse=True)
def native_cpu_convs():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@pytest.fixture(scope="module")
def cell():
    cfg = _json("benchmark", "configs", "read-street-mesh.json")
    cfg.update(viewport=[64, 32], focal=40.0, base_channel=8, num_res=1,
               mesh_edge_m=1.0, texture_size=64)
    traffic = _json("benchmark", "traffic", "fit_mesh_crops.json")
    traffic.update(crop=[32, 32], views=6, batch_size=2, inner_batch=1,
                   batches=3, traced_steps=1)
    c = fit_mesh.Cell(cfg, traffic, 2 ** 31 + 77, "cpu")
    (verts, faces, uv), *_ = c.inputs()
    assert len(faces) == 7440
    return c, verts, faces, uv


def _views(c):
    return [torch.from_numpy(m) for m in c.matrices[0]]


def _extent(verts, faces, m, h, w):
    """Each face's screen bounding box, in pixels, and whether all its
    vertices are in front of the eye."""
    ndc, wc = RefMesh.project(verts, m)
    sx, sy = RefMesh._screen(ndc, h, w)
    f = faces.long()
    return (sx[f].amin(1), sx[f].amax(1), sy[f].amin(1), sy[f].amax(1),
            (wc[f] > 1e-9).all(1))


def test_face_ids_are_bit_equal_at_the_coarser_level(cell):
    """At 16x16 (the crops' second level) every face a pixel shows
    covers it within its subgrid: the three rasters agree to the bit."""
    c, verts, faces, _ = cell
    for m in _views(c):
        h = w = 16
        x0, x1, y0, y1, front = _extent(verts, faces, m, h, w)
        seen = front & (x1 >= 0) & (x0 < w) & (y1 >= 0) & (y0 < h)
        assert int(seen.sum()) > 50
        port, _ = M.rasterize_mesh(verts, faces, m, h, w, SAMPLES)
        ref = RefMesh.raster(verts, faces, m, h, w, SAMPLES)
        oracle, _ = M.rasterize_mesh_reference(
            verts.numpy(), faces.numpy(), m.numpy(), h, w)
        assert (port >= 0).float().mean() > 0.5
        assert torch.equal(port, ref)
        np.testing.assert_array_equal(port.numpy(), oracle)


def test_the_subgrid_departure(cell):
    """At 32x32 some faces are wider than the grid: the port and the
    reference still agree to the bit; the oracle covers more, and every
    pixel where it differs lies outside its face's subgrid."""
    c, verts, faces, _ = cell
    differ = 0
    for m in _views(c):
        h = w = 32
        port, _ = M.rasterize_mesh(verts, faces, m, h, w, SAMPLES)
        ref = RefMesh.raster(verts, faces, m, h, w, SAMPLES)
        assert torch.equal(port, ref)
        oracle, _ = M.rasterize_mesh_reference(
            verts.numpy(), faces.numpy(), m.numpy(), h, w)
        oracle = torch.from_numpy(oracle)
        assert not bool(((port >= 0) & (oracle < 0)).any())
        x0, _, y0, _, _ = _extent(verts, faces, m, h, w)
        py, px = torch.nonzero(port != oracle, as_tuple=True)
        face = oracle[py, px].long()
        outside = (px - x0[face].floor() >= SAMPLES) \
            | (py - y0[face].floor() >= SAMPLES)
        assert bool(outside.all())
        differ += len(py)
    assert differ > 0


def test_uv_maps_and_pyramid_match_the_reference(cell):
    c, verts, faces, uv = cell
    _, _, tables, _, _ = c.inputs()
    total_m = torch.stack(_views(c))
    cfg = TP.config_from_dict({"use_mesh": True, "texture_size": 64,
                               "crop_size": "32x32"})
    port = TP._mesh_pyramid(cfg, tuple(tables), verts, total_m, 32, 32, uv,
                            faces)
    maps = RefMesh.pyramid_maps(verts, faces, uv, total_m, 32, 32, 4)
    for lvl, (x, (face, uv_map)) in enumerate(zip(port, maps)):
        fi = M.rasterize_mesh_batch(verts, faces, total_m, 32 >> lvl,
                                    32 >> lvl)[0]
        assert torch.equal(fi, face)
        got_uv = M.interpolate_uv(verts, faces, uv, total_m, fi)
        torch.testing.assert_close(got_uv, uv_map, atol=UV_ATOL, rtol=0)
        want = RefMesh.sample(tables, uv_map, face)
        torch.testing.assert_close(x, want, atol=PYRAMID_ATOL, rtol=0)
        assert float(x.abs().sum()) > 0


def test_first_steps_match_the_reference(cell):
    """The port's ``use_mesh`` step with faces (the regulariser on), the
    cell's first three steps, against the reference's: the changes under
    the limits the card's runs are held to (the stages of the first step
    and the changes), and the first loss and each
    leaf's first gradient, which the card's runs leave out (the step is
    chaotic in float32 at the full width, PERF.md), within 1e-6 and 1e-3:
    at this size it is not, and one float32 rounding stays below them."""
    c = cell[0]
    limits = _json("benchmark", "limits", "street-mesh-fit.json")["limits"]
    c.setup()
    c.release()
    nums = c.readings()
    assert set(nums) == set(limits) == set(fit_mesh.NUMBERS)
    assert all(nums[k] <= limits[k] for k in limits), (nums, limits)
    (verts, faces, uv), params, tables, vgg, batches = c.inputs()
    ref = mesh_fit.run_steps(
        params, tables, verts, faces, uv, batches[:3], vgg,
        lr=c.cfg["lr"], texture_lr=c.cfg["texture_lr"], levels=4,
        reg_weight=c.cfg["reg_weight"], samples=SAMPLES)
    gaps = compare(c.prog, ref)
    assert gaps["loss1_gap"] < 1e-6 and gaps["grad_gap"] < 1e-3, gaps


def test_the_tf32_control_fails_the_stage_limits(cell):
    """The control (the reference with every conv's operands rounded to
    TF32, in the program's place) is not correct: each layer's own
    rounding, held on the layer's own input, is over the layers' limits,
    while the whole-step numbers could not tell it from float32 at the
    card's size (PERF.md)."""
    c = cell[0]
    limits = _json("benchmark", "limits", "street-mesh-fit.json")["limits"]
    nums = c.readings(control="tf32")
    assert set(nums) == set(limits)
    for k in ("layer_gap", "image_grad_gap"):
        assert nums[k] > limits[k], (k, nums)
