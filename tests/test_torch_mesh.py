"""Mesh textures and the triangle raster: the port against read_tpu, on the CPU.

- ``ops.rasterize_mesh.rasterize_mesh`` (K5's exact key and
  ``scatter_min`` in place of JAX's lexicographic sort) against
  ``read_tpu.ops.rasterize_mesh.rasterize_mesh``: index maps bit-equal,
  depths exact, on ``tests/test_mesh_raster.py``'s fixtures (random small
  triangles, occlusion) and on faces of both windings, faces partly off
  the screen, faces with a vertex behind the eye, and faces larger than
  the sample grid (covered on its subgrid); in several face chunks as in
  one; and against the float64 oracle ``rasterize_mesh_reference``
  (agreement > 99.5%, as the JAX test holds JAX's: float32 against
  float64 flips pixels whose centres graze an edge).
- ``interpolate_uv`` within 1e-6 of JAX's.
- ``sample_mesh_texture`` (forward and backward) against JAX's and
  against ``F.grid_sample`` summed over the levels, within 1e-6;
  ``mesh_texture_reg_loss`` and ``init_mesh_texture``.
- The ``use_mesh`` pyramid (with faces: a triangle raster per level;
  without: the point pyramid's uv gather) against JAX's jitted
  ``_build_pyramid`` within 1e-5 (XLA's fused program rounds the
  bilinear sums and the sigmoid up to 2.1e-6 away from the same
  arithmetic run op by op, which holds 1e-6), and the ``use_mesh`` train
  step from a JAX-written state: loss 1e-6 relative, gradients against
  read_tpu's own float32 and float64 gradients (see the test), the state
  after one step, the whole state round trip both ways.
- A ``use_mesh`` checkpoint written by JAX, rendered by the port's
  ``NeuralRenderer`` with and without faces against JAX's renderer
  (5e-4/1e-3, as ``tests/test_torch_render.py`` holds its frames), and
  ``pca`` refused on it.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from read_tpu.criterions import vgg as JV
from read_tpu.models import texture as JT
from read_tpu.models import unet as JU
from read_tpu.models.unet import UNet as FlaxUNet
from read_tpu.ops import rasterize_mesh as JM
from read_tpu.pipelines import texture_pipeline as JTP
from read_tpu.render import NeuralRenderer as JaxRenderer
from read_tpu.scene import camera
from read_tpu.utils import ckpt as JCK
from read_tpu_torch import render as TR
from read_tpu_torch.models import texture as T
from read_tpu_torch.models.unet import UNet
from read_tpu_torch.ops import rasterize_mesh as M
from read_tpu_torch.pipelines import texture_pipeline as TP
from read_tpu_torch.utils import ckpt as CK
from read_tpu_torch.utils import convert as CV

GRAD_ATOL = 2e-4            # x max|g|, tests/test_torch_train.py
FRAME_TOL = dict(atol=5e-4, rtol=1e-3)


@pytest.fixture(scope="module", autouse=True)
def native_cpu_convs():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _cam(w=48, h=48, view=None):
    K = np.array([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]])
    P = camera.gl_projection(K, (w, h), znear=0.1, zfar=100.0)
    return camera.total_matrix(P, np.eye(4) if view is None else view
                               ).astype(np.float32)


def _random_mesh(rng, n_tri=40, spread=1.5, size=0.25):
    centers = rng.uniform(-spread, spread, size=(n_tri, 3)).astype(
        np.float32)
    centers[:, 2] = -rng.uniform(3.0, 8.0, size=n_tri)
    offs = rng.uniform(-size, size, size=(n_tri, 3, 3)).astype(np.float32)
    verts = (centers[:, None, :] + offs).reshape(-1, 3)
    faces = np.arange(n_tri * 3, dtype=np.int32).reshape(n_tri, 3)
    return verts, faces


def _fixture(name):
    """``(verts, faces, uv)`` of one test mesh."""
    rng = np.random.default_rng(11)
    if name == "random":
        verts, faces = _random_mesh(rng)
    elif name == "occlusion":
        verts = np.array([
            [-1.0, -1.0, -6.0], [1.0, -1.0, -6.0], [0.0, 1.2, -6.0],
            [-0.3, -0.3, -3.0], [0.3, -0.3, -3.0], [0.0, 0.4, -3.0],
        ], np.float32)
        faces = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    elif name == "winding":
        verts, faces = _random_mesh(rng, 60)
        faces[::2] = faces[::2, ::-1]
    elif name == "offscreen":   # straddling every edge of the frame
        verts, faces = _random_mesh(rng, 80, spread=2.2)
    elif name == "behind":      # some vertices behind the eye (z > 0)
        verts, faces = _random_mesh(rng, 60, size=0.4)
        verts[::7, 2] = rng.uniform(0.5, 2.0, len(verts[::7]))
    elif name == "large":       # bboxes beyond the 8x8 sample grid
        verts, faces = _random_mesh(rng, 30, size=1.2)
    else:
        raise KeyError(name)
    uv = rng.uniform(size=(len(verts), 2)).astype(np.float32)
    return verts, faces, uv


MESHES = ["random", "occlusion", "winding", "offscreen", "behind", "large"]


@pytest.mark.parametrize("name", MESHES)
def test_rasterize_mesh_matches_jax(name, monkeypatch):
    verts, faces, _ = _fixture(name)
    h, w = 40, 56
    m = _cam(w, h)
    want_i, want_d = JM.rasterize_mesh(jnp.asarray(verts),
                                       jnp.asarray(faces), jnp.asarray(m),
                                       h, w)
    got_i, got_d = M.rasterize_mesh(torch.from_numpy(verts),
                                    torch.from_numpy(faces),
                                    torch.from_numpy(m), h, w)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    assert int((got_i >= 0).sum()) > 20
    # chunks of 7 faces: the same maps
    monkeypatch.setattr(M, "CANDIDATES_PER_CHUNK", 7 * 64)
    chunked = M.rasterize_mesh(torch.from_numpy(verts),
                               torch.from_numpy(faces), torch.from_numpy(m),
                               h, w)
    assert torch.equal(chunked[0], got_i) and torch.equal(chunked[1], got_d)


@pytest.mark.parametrize("name", ["random", "winding", "offscreen", "behind"])
def test_rasterize_mesh_matches_oracle(name):
    verts, faces, _ = _fixture(name)
    h = w = 48
    m = _cam(w, h)
    idx, dep = M.rasterize_mesh(torch.from_numpy(verts),
                                torch.from_numpy(faces), torch.from_numpy(m),
                                h, w)
    idx_ref, dep_ref = M.rasterize_mesh_reference(verts, faces, m, h, w)
    want_ref = JM.rasterize_mesh_reference(verts, faces, m, h, w)
    np.testing.assert_array_equal(idx_ref, want_ref[0])
    idx, dep = idx.numpy(), dep.numpy()
    agree = (idx == idx_ref).mean()
    assert agree > 0.995, agree
    both = (idx == idx_ref) & (idx >= 0)
    np.testing.assert_allclose(dep[both], dep_ref[both], atol=1e-5)


def test_rasterize_mesh_batch_and_uv_match_jax():
    verts, faces, uv = _fixture("offscreen")
    h, w = 40, 56
    views = []
    for i in range(3):
        v = np.eye(4)
        v[0, 3], v[1, 3] = 0.3 * i, -0.2 * i
        views.append(_cam(w, h, v))
    ms = np.stack(views)
    ji, jd = JM.rasterize_mesh_batch(jnp.asarray(verts), jnp.asarray(faces),
                                     jnp.asarray(ms), h, w)
    ti, td = M.rasterize_mesh_batch(torch.from_numpy(verts),
                                    torch.from_numpy(faces),
                                    torch.from_numpy(ms), h, w)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    want = jax.vmap(lambda fi, m: JM.interpolate_uv(
        jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(uv), m, fi))(
            ji, jnp.asarray(ms))
    got = M.interpolate_uv(torch.from_numpy(verts), torch.from_numpy(faces),
                           torch.from_numpy(uv), torch.from_numpy(ms), ti)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    one = M.interpolate_uv(torch.from_numpy(verts), torch.from_numpy(faces),
                           torch.from_numpy(uv), torch.from_numpy(ms[1]),
                           ti[1])
    assert torch.equal(one, got[1])
    assert bool((got[ti < 0] == 0).all())


@pytest.mark.parametrize("activation", ["none", "sigmoid"])
def test_sample_mesh_texture_matches_jax_and_grid_sample(activation):
    rng = np.random.default_rng(3)
    tables = [rng.normal(size=(s, s, 5)).astype(np.float32)
              for s in (16, 8, 4, 2)]
    uv = rng.uniform(-0.2, 1.2, size=(2, 9, 11, 2)).astype(np.float32)
    cot = rng.normal(size=(2, 9, 11, 5)).astype(np.float32)

    def jax_loss(ts):
        return jnp.sum(JT.sample_mesh_texture(ts, jnp.asarray(uv),
                                              activation) * cot)

    want = np.asarray(JT.sample_mesh_texture(
        [jnp.asarray(t) for t in tables], jnp.asarray(uv), activation))
    want_g = jax.grad(jax_loss)([jnp.asarray(t) for t in tables])
    tt = [torch.from_numpy(t).requires_grad_() for t in tables]
    got = T.sample_mesh_texture(tt, torch.from_numpy(uv), activation)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    (got * torch.from_numpy(cot)).sum().backward()
    for t, g in zip(tt, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=0,
                                   atol=1e-5)
    # the library's bilinear sample, summed over the levels, as a referee
    grid = torch.from_numpy(uv) * 2 - 1
    ref = sum(F.grid_sample(torch.from_numpy(t).permute(2, 0, 1)[None]
                            .expand(2, -1, -1, -1), grid, mode="bilinear",
                            padding_mode="zeros", align_corners=False)
              for t in tables).permute(0, 2, 3, 1)
    if activation == "sigmoid":
        ref = torch.sigmoid(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref.numpy(), rtol=0,
                               atol=1e-5)


def test_mesh_texture_init_and_reg_loss_match_jax():
    rng = np.random.default_rng(4)
    tables = [rng.normal(size=(s, s, 3)).astype(np.float32)
              for s in (8, 4, 2, 1, 1)]
    want = float(JT.mesh_texture_reg_loss([jnp.asarray(t) for t in tables],
                                          0.3))
    got = T.mesh_texture_reg_loss([torch.from_numpy(t) for t in tables], 0.3)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    for method in ("zeros", "0.5", "rand"):
        mine = T.init_mesh_texture(32, 4, 3, method,
                                   generator=torch.Generator().manual_seed(0))
        ref = JT.init_mesh_texture(jax.random.PRNGKey(0), 32, 4, 3, method)
        assert [tuple(t.shape) for t in mine] == [r.shape for r in ref]
        if method != "rand":
            for a, b in zip(mine, ref):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            assert all(0 <= float(t.min()) and float(t.max()) < 1
                       for t in mine)
    with pytest.raises(ValueError, match="Generator"):
        T.init_mesh_texture(8, 2, 1, "rand")


# --------------------------------------------------------------------------
# The use_mesh pipeline: pyramid, train step, checkpoints, renderer
# --------------------------------------------------------------------------

HW, B = (32, 48), 2


def _grid_mesh(rng, nx=14, ny=10, z=-5.0, x0=-2.4, y0=-1.6, size=4.8,
               tilt=0.3):
    """A tilted ``nx x ny``-vertex grid of quads, two triangles each, with
    uv running over [0, 1]: ``(verts, faces, uv)``."""
    u, v = np.meshgrid(np.linspace(0, 1, nx), np.linspace(0, 1, ny))
    verts = np.stack([x0 + size * u, y0 + size * 0.66 * v,
                      z + tilt * (u - 0.5) + 0.05 * rng.normal(size=u.shape)],
                     -1).reshape(-1, 3).astype(np.float32)
    i = np.arange(nx * ny).reshape(ny, nx)
    a, b, c, d = i[:-1, :-1], i[:-1, 1:], i[1:, :-1], i[1:, 1:]
    faces = np.concatenate([np.stack([a, b, d], -1).reshape(-1, 3),
                            np.stack([a, d, c], -1).reshape(-1, 3)])
    uv = np.stack([u, v], -1).reshape(-1, 2).astype(np.float32)
    return verts, faces.astype(np.int32), uv


def _mesh_scene():
    """Two overlapping grids (a near one occluding part of a far one)
    and B poses at ``HW``: ``(verts, faces, uv, total_m, targets)``."""
    rng = np.random.default_rng(21)
    far = _grid_mesh(rng)
    near = _grid_mesh(rng, 8, 6, z=-3.5, x0=-0.6, y0=-0.5, size=1.6)
    verts = np.concatenate([far[0], near[0]])
    faces = np.concatenate([far[1], near[1] + len(far[0])])
    uv = np.concatenate([far[2], near[2]])
    h, w = HW
    K = np.array([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]])
    P = camera.gl_projection(K, (w, h), 0.1, 50.0)
    ms = []
    for i in range(B):
        view = np.eye(4)
        view[0, 3], view[1, 3] = 0.3 * i, -0.1 * i
        ms.append(camera.total_matrix(P, view))
    target = rng.uniform(size=(B, h, w, 3)).astype(np.float32)
    return verts, faces, uv, np.stack(ms).astype(np.float32), target


@pytest.mark.parametrize("with_faces", [True, False])
def test_mesh_pyramid_matches_jax(with_faces):
    verts, faces, uv, ms, _ = _mesh_scene()
    rng = np.random.default_rng(2)
    tables = [rng.normal(size=(s, s, 8)).astype(np.float32)
              for s in (16, 8, 4, 2)]
    kw = dict(crop_size=HW, use_mesh=True, texture_size=16,
              texture_activation="sigmoid")
    jcfg = JTP.PipelineConfig(**kw)
    want = jax.jit(lambda t, x, m, u, f: JTP._build_pyramid(
        jcfg, t, x, m, uv2d=u, faces=f))(
        tuple(jnp.asarray(t) for t in tables), jnp.asarray(verts),
        jnp.asarray(ms), jnp.asarray(uv),
        jnp.asarray(faces) if with_faces else None)
    got = TP.build_pyramid(
        TP.PipelineConfig(**kw), tuple(torch.from_numpy(t) for t in tables),
        torch.from_numpy(verts), torch.from_numpy(ms),
        uv2d=torch.from_numpy(uv),
        faces=torch.from_numpy(faces) if with_faces else None)
    assert len(got) == 4
    for i, (g, wnt) in enumerate(zip(got, want)):
        assert tuple(g.shape) == (B, HW[0] >> i, HW[1] >> i, 8)
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=0,
                                   atol=1e-5, err_msg=f"level {i}")
    # empty pixels read sigmoid(0) * 0 = 0 and covered ones do not
    assert float(got[0].abs().max()) > 0
    assert float((got[0] == 0).float().mean()) > 0


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``. Patched into
    ``read_tpu.models.unet`` (its BatchNorm and output casts name
    float32), it runs the Flax UNet in float64 under ``jax.enable_x64``:
    read_tpu's own float64 gradient, the referee of the port's."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _eager_mesh_maps(verts, faces, uv, ms, levels=4):
    """JAX's face and uv maps at each level's ``(h, w)``, run op by op.
    XLA's fused program of the triangle raster and the barycentrics
    rounds otherwise and moves edge pixels (the port follows JAX op by
    op: ``test_rasterize_mesh_batch_and_uv_match_jax``)."""
    out = {}
    with jax.disable_jit():
        for i in range(levels):
            hw = (HW[0] >> i, HW[1] >> i)
            fi, dep = JM.rasterize_mesh_batch(verts, faces, ms, *hw)
            uvm = jax.vmap(lambda f, m: JM.interpolate_uv(
                verts, faces, uv, m, f))(fi, ms)
            out[hw] = (fi, dep), uvm
    return out


@pytest.fixture(scope="module")
def mesh_ref(tmp_path_factory):
    """A JAX use_mesh state (16^2 tables, reg_weight on), saved; JAX's
    first-step loss and its gradients in float32 and in float64, with
    and without faces, and the state after its step with faces. There
    JAX's
    jitted step reads the face and uv maps of eager JAX
    (:func:`_eager_mesh_maps`)."""
    verts, faces, uv, ms, target = _mesh_scene()
    cfg = JTP.PipelineConfig(crop_size=HW, use_mesh=True, texture_size=16,
                             reg_weight=0.1)
    state, net = JTP.create_state(jax.random.PRNGKey(0), cfg,
                                  n_points=len(verts),
                                  net=FlaxUNet(base_channel=8, num_res=1))
    path = str(tmp_path_factory.mktemp("mesh") / "ckpt")
    JCK.save_checkpoint(path, state, config={})
    vgg = JV.random_vgg_params(0)
    out = dict(path=path, scene=(verts, faces, uv, ms, target),
               vgg=[(np.asarray(w), np.asarray(b)) for w, b in vgg],
               state=state)
    jv, jf, ju, jm = (jnp.asarray(a) for a in (verts, faces, uv, ms))
    maps = _eager_mesh_maps(jv, jf, ju, jm)
    sample = JT.sample_mesh_texture

    def grads(net, params, texture, batch_stats, vgg, target, faces):
        batch = {"total_m": jm, "target": jnp.asarray(target), "uv2d": ju}
        if faces is not None:
            batch["faces"] = faces

        def loss_fn(params, texture):
            o, _, _ = JTP._forward(net, cfg, params, batch_stats, texture,
                                   jv, jm, train=True, uv2d=ju,
                                   faces=faces)
            loss = JTP._losses(cfg, vgg, o, batch)[0]
            return loss + JT.mesh_texture_reg_loss(list(texture),
                                                   cfg.reg_weight)

        loss, g = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(
            params, texture)
        return float(loss), JCK._flatten({"params": g[0], "texture": g[1]})

    for with_faces in (True, False):
        fc = jf if with_faces else None
        with pytest.MonkeyPatch.context() as mp:
            if with_faces:
                mp.setattr(JM, "rasterize_mesh_batch",
                           lambda v, f, m, h, w: maps[(h, w)][0])
                mp.setattr(JT, "sample_mesh_texture",
                           lambda t, u, *a: sample(t, maps[u.shape[1:3]][1],
                                                   *a))
            loss, g32 = grads(net, state.params, state.texture,
                              state.batch_stats, vgg, target, fc)
            out[with_faces] = dict(loss=loss, grads=g32)
            if with_faces:
                new, _ = JTP.make_train_step(net, cfg, vgg)(
                    state, jv, {"total_m": jm, "uv2d": ju, "faces": fc,
                                "target": jnp.asarray(target)})
                out[with_faces]["after"] = JCK._flatten(new)
            mp.setattr(JU, "jnp", _Float64Numpy())
            with jax.enable_x64(True):
                _, g64 = grads(
                    net.clone(dtype=jnp.float64), _f64(state.params),
                    _f64(state.texture), _f64(state.batch_stats),
                    _f64(out["vgg"]), target.astype(np.float64), fc)
        out[with_faces]["grads64"] = g64
    return out


def _mesh_port(mesh_ref, with_faces):
    verts, faces, uv, ms, target = mesh_ref["scene"]
    cfg = TP.PipelineConfig(crop_size=HW, use_mesh=True, texture_size=16,
                            reg_weight=0.1)
    batch = {"total_m": torch.from_numpy(ms),
             "target": torch.from_numpy(target),
             "uv2d": torch.from_numpy(uv)}
    if with_faces:
        batch["faces"] = torch.from_numpy(faces)
    return (UNet(base_channel=8, num_res=1), cfg,
            CV.vgg_params_from_numpy(mesh_ref["vgg"], "cpu"),
            TP.state_from_flat(CK.load_checkpoint(mesh_ref["path"])[0],
                               "cpu"),
            torch.from_numpy(verts), batch)


def _grads(state, g_flat, g_tex):
    out = {"params/" + k.replace(".", "/"): g.numpy()
           for k, g in state.layout.views(g_flat).items()}
    out.update({f"texture/{i}": g.numpy() for i, g in enumerate(g_tex)})
    return out


@pytest.mark.parametrize("with_faces", [True, False])
def test_mesh_train_step_matches_jax(mesh_ref, with_faces, tmp_path):
    """First-step loss (1e-6 relative) and gradients against read_tpu's,
    tensor by tensor: the port's float64 gradient within 1e-9 x max|g| of
    JAX's float64 gradient (the same function and derivative); the
    port's float32 gradient within 2e-4 x max|g| of JAX's float64
    gradient, and of JAX's float32 gradient by the rule of
    ``tests/test_torch_splat.py`` (2e-4 x max|g|, or 2.25x JAX's own
    float32 distance from its float64 run where that is larger: JAX's
    float32 gradients of this step lie up to
    ~1.3e-3 x max|g| from its float64 run, in the BatchNorm scales after
    the mesh pyramid's empty pixels). With faces, the state after one
    step: the tables and the net's parameters where the gradient is far
    from zero (the first RMS and Adam updates are sign-like)."""
    net, cfg, vgg, state, xyz, batch = _mesh_port(mesh_ref, with_faces)
    assert isinstance(state.texture, tuple) and len(state.texture) == 4
    assert tuple(state.texture[0].shape) == (16, 16, 8)
    ref = mesh_ref[with_faces]
    metrics, _, _, g_flat, g_tex = TP._loss_and_grads(net, cfg, vgg, state,
                                                      xyz, batch, False)
    np.testing.assert_allclose(float(metrics["loss"]), ref["loss"],
                               rtol=1e-6)
    got = _grads(state, g_flat, g_tex)
    assert set(got) == set(ref["grads"]) == set(ref["grads64"])
    s64 = dataclasses.replace(
        state, flat_params=state.flat_params.double(),
        batch_stats={k: v.double() for k, v in state.batch_stats.items()},
        texture=tuple(t.double() for t in state.texture))
    _, _, _, g64, t64 = TP._loss_and_grads(
        net, cfg, [(w.double(), b.double()) for w, b in vgg], s64, xyz,
        dict(batch, target=batch["target"].double()), False)
    port64 = _grads(state, g64, t64)
    for key, g in got.items():
        truth, want = ref["grads64"][key], ref["grads"][key]
        scale = float(np.abs(truth).max())
        np.testing.assert_allclose(port64[key], truth, rtol=0,
                                   atol=1e-9 * scale, err_msg=key)
        np.testing.assert_allclose(g, truth, rtol=0,
                                   atol=GRAD_ATOL * scale, err_msg=key)
        jax_off = float(np.abs(want - truth).max()) / scale
        np.testing.assert_allclose(
            g, want, rtol=0, atol=max(GRAD_ATOL, 2.25 * jax_off)
            * float(np.abs(want).max()), err_msg=key)
    if not with_faces:
        return
    new, _ = TP.make_train_step(net, cfg, vgg)(state, xyz, batch)
    after = TP.flat_from_state(new)
    assert set(after) == set(ref["after"])
    assert int(after["step"]) == 1
    for key, g in ref["grads64"].items():
        big = np.abs(g) > 1e-2 * np.abs(g).max()
        np.testing.assert_allclose(after[key][big], ref["after"][key][big],
                                   rtol=0, atol=1e-4 if key.startswith(
                                       "texture") else 1e-6, err_msg=key)
    # a port-written state loads in read_tpu with its own template
    CK.save_checkpoint(str(tmp_path / "port"), after, config={})
    back, _ = JCK.load_checkpoint(str(tmp_path / "port"),
                                  template=mesh_ref["state"])
    assert isinstance(back.texture, tuple) and int(back.step) == 1
    for i, t in enumerate(back.texture):
        np.testing.assert_array_equal(np.asarray(t), after[f"texture/{i}"])


def test_mesh_state_round_trip_and_create(mesh_ref):
    flat, _ = CK.load_checkpoint(mesh_ref["path"])
    assert "texture/3" in flat and "tex_opt/0/nu/3" in flat
    back = TP.flat_from_state(TP.state_from_flat(flat, "cpu"))
    assert set(back) == set(flat)
    for key, arr in flat.items():
        np.testing.assert_array_equal(back[key], arr, err_msg=key)
    cfg = TP.PipelineConfig(crop_size=HW, use_mesh=True, texture_size=16)
    state, _ = TP.create_state(torch.Generator().manual_seed(0), cfg, 10,
                               net=UNet(base_channel=8, num_res=1),
                               device="cpu")
    mine = TP.flat_from_state(state)
    assert {k: v.shape for k, v in mine.items()} == \
        {k: v.shape for k, v in flat.items()}


@pytest.fixture(scope="module")
def mesh_render(tmp_path_factory):
    """A JAX use_mesh checkpoint (base 8 UNet, 16^2 tables, random
    BatchNorm statistics) and the scene as read_tpu's renderer loads
    it (uv2d and faces in its point cloud)."""
    verts, faces, uv, _, _ = _mesh_scene()
    root = tmp_path_factory.mktemp("mesh_render")
    w, h = HW[1], HW[0]
    K = np.array([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]])
    poses = []
    for i in range(2):
        pose = np.eye(4)
        pose[0, 3] = 0.25 * i
        poses.append(pose)
    scene = {"pointcloud": {"xyz": verts.astype(np.float64), "uv2d": uv,
                            "faces": faces.reshape(-1).astype(np.uint32),
                            "rgb": np.ones_like(verts)},
             "intrinsic_matrix": K, "config": {"viewport_size": (w, h)},
             "view_matrix": poses, "point_sizes": None, "texture": None}
    config = {"use_mesh": True, "texture_size": 16, "conv_impl": "xla"}
    cfg = JTP.config_from_dict(config, crop_size=HW)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTP, "UNet", functools.partial(FlaxUNet, base_channel=8,
                                                  num_res=1))
        state, _ = JTP.create_state(jax.random.PRNGKey(0), cfg,
                                    n_points=len(verts))
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 2.0, a.shape).astype(np.float32),
        state.batch_stats)
    ckpt = str(root / "ckpt")
    JCK.save_checkpoint(ckpt, state.replace(batch_stats=stats),
                        config=config)
    return scene, ckpt, poses


@pytest.mark.parametrize("with_faces", [True, False])
def test_mesh_renderer_matches_jax(mesh_render, with_faces):
    import read_tpu.scene.io as JIO
    scene, ckpt, poses = mesh_render
    if not with_faces:
        scene = dict(scene, pointcloud=dict(scene["pointcloud"],
                                            faces=None))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTP, "UNet", functools.partial(FlaxUNet, base_channel=8,
                                                  num_res=1))
        mp.setattr(JIO, "load_scene_data", lambda path: scene)
        jr = JaxRenderer("scene.yaml", ckpt)
    tr = TR.NeuralRenderer(scene, ckpt, device="cpu")
    assert tr.cfg.use_mesh and (tr.faces is not None) == with_faces
    for pose in poses:
        np.testing.assert_allclose(tr.infer(pose), jr.infer(pose),
                                   **FRAME_TOL)
    with pytest.raises(ValueError, match="point texture"):
        tr.render_mode("pca", poses[0])


def test_interpolate_uv_is_zero_at_empty_pixels_with_face0_on_the_eye_plane():
    """Empty pixels read face 0's vertices. With one of them on the eye
    plane (clip w = 0, NDC inf/NaN) read_tpu's uv map is NaN there (it
    multiplies by the mask); the port's is 0, and the same elsewhere."""
    verts, faces, uv = _fixture("random")
    verts = np.concatenate([[[0.3, 0.2, 0.0]], verts]).astype(np.float32)
    faces = np.concatenate([[[0, 1, 2]], faces + 1]).astype(np.int32)
    uv = np.concatenate([[[0.5, 0.5]], uv]).astype(np.float32)
    h, w = 40, 56
    m = _cam(w, h)
    fi, _ = M.rasterize_mesh(torch.from_numpy(verts),
                             torch.from_numpy(faces), torch.from_numpy(m),
                             h, w)
    got = M.interpolate_uv(torch.from_numpy(verts), torch.from_numpy(faces),
                           torch.from_numpy(uv), torch.from_numpy(m), fi)
    want = np.asarray(JM.interpolate_uv(jnp.asarray(verts),
                                        jnp.asarray(faces), jnp.asarray(uv),
                                        jnp.asarray(m),
                                        jnp.asarray(fi.numpy())))
    empty = fi.numpy() < 0
    assert empty.any() and np.isnan(want[empty]).all()
    assert bool(torch.isfinite(got).all()) and not got[fi < 0].any()
    np.testing.assert_allclose(got.numpy()[~empty], want[~empty], rtol=0,
                               atol=1e-6)
