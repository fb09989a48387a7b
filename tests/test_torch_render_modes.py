"""``read_tpu_torch.ops.render_modes`` against ``read_tpu.ops.render_modes``
on the CPU, on the same index and depth maps.

The maps come from JAX's own ``rasterize_batch`` ('sort') of 3000 seeded
points at 48x32, two views; the point attributes (colours, bbox colours,
unit normals, uvs, labels, a 20x16 texture image) from one numpy seed.

Tolerances and why:
- the gather modes (``colors``, ``xyz``, ``uv_1d``, ``uv_2d``,
  ``labels``, ``normals_m``, ``depth``) copy values: bit-equal;
- ``normals_l`` inverts the view matrix in float32 (``torch.linalg.inv``
  against ``jnp.linalg.inv``), ``normals_r/d`` normalize with other
  reductions, ``texture2d`` interpolates: ``atol 2e-7`` (a few ulp of
  values in [0, 1]; measured 6e-8 at most);
- ``lit`` raises a cosine to the power 128, which multiplies a last-bit
  difference about 128-fold: ``atol 5e-6`` (measured 5.4e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from read_tpu.ops import rasterize as JR
from read_tpu.ops import render_modes as JRM
from read_tpu.scene import camera
from read_tpu.scene.formats import MODES
from read_tpu_torch.ops import render_modes as RM

N, H, W = 3000, 32, 48
GATHER = ("colors", "xyz", "uv_1d", "uv_2d", "labels", "normals_m",
          "depth")
TOL = {"normals_l": 2e-7, "normals_r": 2e-7, "normals_d": 2e-7,
       "texture2d": 2e-7, "lit": 5e-6}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's CPU ops are small: one intra-op thread runs them
    fastest when the suite's workers share the cores (8 threads a
    worker ran them ~7x slower under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _view():
    """A camera-to-world matrix with a rotation and a translation."""
    a = 0.3
    view = np.eye(4)
    view[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                    [-np.sin(a), 0, np.cos(a)]]
    view[:3, 3] = (0.4, 0.2, 0.5)
    return view


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(11)
    xyz = rng.uniform(-2, 2, size=(N, 3)).astype(np.float32)
    xyz[:, 2] -= 6.0
    normals = rng.normal(size=(N, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    pc = {"xyz": xyz,
          "rgb": rng.uniform(size=(N, 3)).astype(np.float32),
          "xyz_c": rng.uniform(size=(N, 3)).astype(np.float32),
          "normals": normals,
          "uv2d": rng.uniform(-0.1, 1.1, size=(N, 2)).astype(np.float32),
          "labels": rng.integers(0, 9, N).astype(np.float32),
          "texture_image": rng.uniform(size=(16, 20, 3)).astype(np.float32)}
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]])
    P = camera.gl_projection(K, (W, H), 0.1, 50.0)
    views = [np.eye(4), _view()]
    ms = np.stack([camera.total_matrix(P, v) for v in views]).astype(
        np.float32)
    idx, dep = JR.rasterize_batch(jnp.asarray(xyz), jnp.asarray(ms), H, W)
    assert (np.asarray(idx) >= 0).mean() > 0.3
    return pc, np.asarray(idx), np.asarray(dep), views


def _torch_pc(pc):
    return {k: torch.from_numpy(v) for k, v in pc.items()}


@pytest.mark.parametrize("mode", sorted(set(MODES) | {"lit", "texture2d"}))
def test_render_mode_matches_read_tpu(scene, mode):
    pc, idx, dep, views = scene
    for view in views:
        want = np.asarray(JRM.render_mode(
            mode, jnp.asarray(idx), jnp.asarray(dep),
            {k: jnp.asarray(v) for k, v in pc.items()}, view_matrix=view))
        got = RM.render_mode(mode, torch.from_numpy(idx),
                             torch.from_numpy(dep), _torch_pc(pc),
                             view_matrix=view).numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        if mode in GATHER:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL[mode])
        # numpy attributes in, the same maps out
        again = RM.render_mode(mode, torch.from_numpy(idx),
                               torch.from_numpy(dep), pc, view_matrix=view)
        np.testing.assert_array_equal(again.numpy(), got)


@pytest.mark.parametrize("mode", ["normals_l", "normals_r", "normals_d"])
def test_per_item_tables_match_vmapped_gather(scene, mode):
    """The training input's path: one colour table per batch item from
    its own view matrix, gathered through that item's index map (JAX
    vmaps both)."""
    pc, idx, _, views = scene
    vms = np.stack(views).astype(np.float32)
    xyz, nrm = jnp.asarray(pc["xyz"]), jnp.asarray(pc["normals"])
    cols = jax.vmap(lambda vm: JRM.view_dependent_colors(
        mode, xyz, nrm, vm))(jnp.asarray(vms))
    want = np.asarray(jax.vmap(JRM.gather_attribute)(cols, jnp.asarray(idx)))
    tcols = torch.stack([RM.view_dependent_colors(
        mode, torch.from_numpy(pc["xyz"]), torch.from_numpy(pc["normals"]),
        vm) for vm in torch.from_numpy(vms)])
    got = RM.gather_attribute(tcols, torch.from_numpy(idx)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[mode])


def test_blinn_phong_and_texture_sampling_match(scene):
    pc, _, _, views = scene
    light = (1.0, 2.0, 3.0)
    want = np.asarray(JRM.blinn_phong_colors(
        jnp.asarray(pc["xyz"]), jnp.asarray(pc["normals"]), views[1],
        light))
    got = RM.blinn_phong_colors(torch.from_numpy(pc["xyz"]),
                                torch.from_numpy(pc["normals"]), views[1],
                                light).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL["lit"])
    assert RM.DEFAULT_LIGHT_POSITION == JRM.DEFAULT_LIGHT_POSITION
    want = np.asarray(JRM.sample_texture2d_colors(
        jnp.asarray(pc["texture_image"]), jnp.asarray(pc["uv2d"])))
    got = RM.sample_texture2d_colors(pc["texture_image"],
                                     torch.from_numpy(pc["uv2d"])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL["texture2d"])


def test_gather_fill_and_missing_attributes(scene):
    pc, idx, dep, views = scene
    tidx, tdep = torch.from_numpy(idx), torch.from_numpy(dep)
    attr = torch.from_numpy(pc["rgb"])
    want = np.asarray(JRM.gather_attribute(jnp.asarray(pc["rgb"]),
                                           jnp.asarray(idx), fill=0.5))
    np.testing.assert_array_equal(
        RM.gather_attribute(attr, tidx, fill=0.5).numpy(), want)
    bare = {"xyz": pc["xyz"]}
    for mode, c in (("labels", 1), ("normals_m", 3), ("normals_l", 3),
                    ("lit", 3)):
        out = RM.render_mode(mode, tidx, tdep, bare, view_matrix=views[0])
        assert tuple(out.shape) == idx.shape + (c,)
        assert not out.any()
    with pytest.raises(ValueError, match="view matrix"):
        RM.render_mode("normals_r", tidx, tdep, pc)
    with pytest.raises(ValueError, match="view matrix"):
        RM.render_mode("lit", tidx, tdep, pc)
    with pytest.raises(ValueError, match="texture"):
        RM.render_mode("texture2d", tidx, tdep, bare)
    with pytest.raises(ValueError, match="unknown"):
        RM.render_mode("normals_x", tidx, tdep, pc, view_matrix=views[0])
    with pytest.raises(ValueError, match="unknown"):
        RM.render_mode("sepia", tidx, tdep, pc)
