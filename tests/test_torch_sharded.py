"""Multi-device training (``read_tpu_torch.parallel``) on the CPU.

One spawn of 4 gloo ranks for the module (``launch.spawn``, in a
thread while the test process computes the references) builds a (1, 4)
and a (2, 2) mesh from one world and runs every case; rank 0 writes the
results to an npz file, which each test reads. The ranks import this
module and so neither ``jax`` nor ``read_tpu``: JAX is imported only in
the fixtures, and each rank asserts that it loaded neither.

Sizes: ``UNet(base_channel=8, num_res=1)``, 1021 points (4 does not
divide it: the texture pads), 32x32 crops, B = 4 (B = 2 where a points
rank gets no rows of the split step's stage 2).

- (a) the merged index and depth pyramids bit-equal to read_tpu's
  ``sharded_rasterize_pyramid`` under ``shard_map`` on the virtual mesh
  (``tests/test_sharded.py:33-54``), 'sort' and 'pallas', r = 0 and 1,
  and 'sort1q' at r = 0 (each shard's winner by its quantized key, the
  merge by the exact one), on a scene with duplicate points in different shards (the least
  global id must win) and a view where points lie at depth exactly 0;
  'sort' also bit-equal to the port's unsharded ``zbuffer_pyramid``;
- (b) the owned-row gather against read_tpu's ``sharded_gather``,
  'none' and 'sigmoid', atol 1e-6 (``test_sharded.py:76``), and its
  backward against the unsharded gather's;
- (c) the 'split' step on (1, 4) and (2, 2) (VGG on; a masked loss with
  ``masked_background``; ``remat``) against the port's unsharded step on the
  whole batch, which ``tests/test_torch_train.py`` holds to read_tpu:
  loss within 1e-4 (relative where it exceeds 1), raw net and texture
  gradients and the new BatchNorm statistics within 2e-4 x max|g|, the
  port's gradient bound (ROADMAP queue 3);
- (d) a (2, 2) 'split' and a (2, 2) 'replicated' step from one
  JAX-written ``TrainState`` against read_tpu's
  ``make_sharded_train_step`` with unit-lr SGD (``TP._make_optimizers``
  patched here, as ``test_sharded.py:187-199`` does): loss within 1e-4,
  net gradients and statistics within 2e-4 x max|g|. read_tpu's texture
  gradients there are P times the unsharded step's (its ``psum``
  transpose sums the points ranks' identical cotangents; ROADMAP queue
  3): the port's, which equal the unsharded step's, are held to read_tpu's
  divided by P;
- (e) extra modes (``colors`` + ``depth``; ``normals_d``/``normals_l``
  with per-item view matrices) on (1, 4), B = 2, against the port's
  unsharded step: loss within 1e-4 (``test_sharded.py:161``, :275);
- (f) ``use_mesh`` on (1, 4): loss within 1e-4, the tables after one
  whole step within 5e-3 (:306-315);
- (g) ``prepare_scene_state`` -> ``unshard_state`` round trip with
  padding, bit for bit (and ``shard_scene`` as ``shard_points`` and the
  prepared table's rows).

Every join and the process group carry their own timeouts (no
pytest-timeout here): a hung rank fails the fixture.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from read_tpu_torch.criterions import vgg as V
from read_tpu_torch.models import texture as T
from read_tpu_torch.models.unet import UNet
from read_tpu_torch.ops import rasterize_kernels as RK
from read_tpu_torch.parallel import launch
from read_tpu_torch.parallel import sharded as S
from read_tpu_torch.pipelines import texture_pipeline as TP
from read_tpu_torch.scene import camera
from read_tpu_torch.utils import ckpt as CK

N, HW, B = 1021, (32, 32), 4
SMALL = dict(base_channel=8, num_res=1)
# 'sort1q' at r = 0 only: with splats JAX's merge takes the minimum of
# its faulty 'sort1q' depths (tests/test_torch_raster_methods.py)
MERGES = (("sort", 0), ("sort", 1), ("pallas", 0), ("pallas", 1),
          ("sort1q", 0))
GRAD_ATOL = 2e-4          # x max|g|, tests/test_torch_train.py
RANK_TIMEOUT_S = 60       # every collective and the group's set-up
JOIN_S = 240              # the whole spawn


# --------------------------------------------------------------------------
# Inputs: the same numbers in the test process and in every rank
# --------------------------------------------------------------------------


def _inputs():
    rng = np.random.default_rng(7)
    h, w = HW
    xyz = rng.uniform(-2, 2, size=(N, 3)).astype(np.float32)
    xyz[:, 2] -= 6.0
    K = np.array([[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]])
    P = camera.gl_projection(K, (w, h), znear=0.1, zfar=50.0)
    ms, views = [], []
    for i in range(B):
        view = np.eye(4)
        view[0, 3] = 0.15 * i
        ms.append(camera.total_matrix(P, view))
        views.append(view)
    # the merge scene: the same points, some at z = -4 exactly, copies of
    # rows of shard 0 and 1 in shards 2 and 3 (1021 points pad to 4 x 256)
    mxyz = xyz.copy()
    mxyz[10:30, 2] = -4.0
    mxyz[600:640] = mxyz[10:50]
    mxyz[900:940] = mxyz[300:340]
    # view 1: orthographic, ndc_z = -0.25 z - 2, so z = -4 is depth 0
    ortho = np.array([[0.5, 0, 0, 0], [0, 0.5, 0, 0], [0, 0, -0.25, -2.0],
                      [0, 0, 0, 1]], np.float32)
    normals = rng.normal(size=(N, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    return dict(
        xyz=xyz, total_m=np.stack(ms).astype(np.float32),
        view_matrix=np.stack(views).astype(np.float32),
        target=rng.uniform(size=(B, h, w, 3)).astype(np.float32),
        mask=(rng.uniform(size=(B, h, w, 1)) > 0.3).astype(np.float32),
        merge_xyz=mxyz,
        merge_m=np.stack([ms[0], ortho]).astype(np.float32),
        rgb=rng.uniform(size=(N, 3)).astype(np.float32),
        normals=normals,
        uv2d=rng.uniform(size=(N, 2)).astype(np.float32),
        table=rng.normal(size=(1024, 8)).astype(np.float32),
        gather_ix=rng.integers(-1, 1024, size=(2, 16, 16)).astype(np.int32),
        gather_cot=rng.normal(size=(2, 16, 16, 8)).astype(np.float32))


def _cfg(name):
    """The step configurations by case name."""
    h1 = dict(crop_size=HW, huber_ratio=1.0)
    return {
        "vgg": TP.PipelineConfig(**h1),
        "masked": TP.PipelineConfig(**h1, vgg_ratio=0.0, use_mask=True,
                                    masked_background=True),
        "jax": TP.PipelineConfig(**h1, vgg_ratio=0.0),
        "remat": TP.PipelineConfig(**h1, vgg_ratio=0.0, remat=True),
        "colors": TP.PipelineConfig(**h1, vgg_ratio=0.0,
                                    extra_modes=(("colors", "depth"),) * 4),
        "normals": TP.PipelineConfig(
            **h1, vgg_ratio=0.0,
            extra_modes=(("normals_d", "normals_l"),) * 4),
        "use_mesh": TP.PipelineConfig(**h1, vgg_ratio=0.0, use_mesh=True,
                                      texture_size=64, reg_weight=1e-2),
    }[name]


def _state(cfg):
    """``(state, net)`` from the same seed in every process."""
    net = UNet(num_input_channels=cfg.net_in_channels, **SMALL)
    return TP.create_state(torch.Generator().manual_seed(0), cfg, N,
                           net=net, device="cpu")


def _batch(d, cfg, b=B, whole=True):
    """A torch batch of ``b`` rows for ``cfg``; ``whole``: with the point
    attributes the unsharded step reads."""
    t = {k: torch.from_numpy(d[k][:b]) for k in ("total_m", "target")}
    if cfg.use_mask:
        t["mask"] = torch.from_numpy(d["mask"][:b])
    if cfg.extra_modes:
        t["view_matrix"] = torch.from_numpy(d["view_matrix"][:b])
        if whole:
            t["pointcloud"] = {k: torch.from_numpy(d[k])
                               for k in _attrs(cfg)}
    if cfg.use_mesh and whole:
        t["uv2d"] = torch.from_numpy(d["uv2d"])
    return t


def _attrs(cfg):
    """The point attributes a case's sharded step reads."""
    if cfg.use_mesh:
        return ("uv2d",)
    if cfg.extra_modes and "colors" in cfg.extra_modes[0]:
        return ("rgb",)
    if cfg.extra_modes:
        return ("xyz", "normals")
    return ()


# --------------------------------------------------------------------------
# The ranks
# --------------------------------------------------------------------------


def _gathered(mesh, t, n=None):
    """This points shard's rows of ``t`` assembled on rank 0 (numpy, the
    first ``n`` rows), else None."""
    full = mesh.gather_rows(t) if mesh.data_index == 0 else None
    return None if full is None else full[:n].numpy().copy()


def _rank_merges(meshes, d, out):
    mesh = meshes[(1, 4)]
    xl = S.shard_points(mesh, torch.from_numpy(d["merge_xyz"]))
    off = mesh.points_index * xl.shape[0]
    for method, r in MERGES:
        levels = S.sharded_rasterize_pyramid(
            mesh, xl, off, torch.from_numpy(d["merge_m"]), HW, 4, r, method)
        for lv, (ix, dep) in enumerate(levels):
            out[f"merge/{method}/{r}/{lv}/index"] = ix.numpy().copy()
            out[f"merge/{method}/{r}/{lv}/depth"] = dep.numpy().copy()


def _rank_gather(meshes, d, out):
    mesh = meshes[(1, 4)]
    table = S._local_rows(mesh, torch.from_numpy(d["table"]))
    off = mesh.points_index * table.shape[0]
    ix = torch.from_numpy(d["gather_ix"])
    for act in ("none", "sigmoid"):
        leaf = table.clone().requires_grad_()
        x = S.sharded_gather(mesh, leaf, off, ix, act)
        (g,) = torch.autograd.grad(
            (x * torch.from_numpy(d["gather_cot"])).sum(), leaf)
        out[f"gather/{act}"] = x.detach().numpy().copy()
        out[f"gather/{act}/grad"] = _gathered(mesh, g)


def _rank_split(meshes, d, out):
    vgg = V.random_vgg_params(torch.Generator().manual_seed(0), "cpu")
    for case, shape in (("vgg", (1, 4)), ("vgg", (2, 2)),
                        ("masked", (2, 2)), ("remat", (2, 2))):
        mesh, cfg = meshes[shape], _cfg(case)
        state, net = _state(cfg)
        m, bs, g_net, g_tex = S.sharded_loss_and_grads(
            net, cfg, vgg if cfg.vgg_ratio else None, mesh,
            S.prepare_scene_state(mesh, state),
            S.shard_points(mesh, torch.from_numpy(d["xyz"])),
            _batch(d, cfg, whole=False))
        key = f"split/{case}/{shape[0]}x{shape[1]}"
        out[key + "/loss"] = float(m["loss"])
        out[key + "/psnr"] = float(m["psnr"])
        out[key + "/g_net"] = g_net.numpy().copy()
        out[key + "/g_tex"] = _gathered(mesh, g_tex[0], N)
        for k, v in bs.items():
            out[key + "/bs/" + k] = v.numpy().copy()


def _rank_vs_jax(meshes, d, jax_ckpt, out):
    # the test process writes the JAX state while the ranks run the other
    # cases, then the marker
    deadline = time.monotonic() + JOIN_S
    while not os.path.exists(jax_ckpt + ".ready"):
        if time.monotonic() > deadline:
            raise TimeoutError("no JAX state was written")
        time.sleep(0.2)
    mesh, cfg = meshes[(2, 2)], _cfg("jax")
    state = S.prepare_scene_state(
        mesh, TP.state_from_flat(CK.load_checkpoint(jax_ckpt)[0], "cpu"))
    net = UNet(**SMALL)
    for mode in ("split", "replicated"):
        m, bs, g_net, g_tex = S.sharded_loss_and_grads(
            net, cfg, None, mesh, state,
            S.shard_points(mesh, torch.from_numpy(d["xyz"])),
            _batch(d, cfg, whole=False), unet=mode)
        out[f"jax/{mode}/loss"] = float(m["loss"])
        out[f"jax/{mode}/g_net"] = g_net.numpy().copy()
        out[f"jax/{mode}/g_tex"] = _gathered(mesh, g_tex[0], N)
        for k, v in bs.items():
            out[f"jax/{mode}/bs/" + k] = v.numpy().copy()


def _rank_extra_and_mesh(meshes, d, out):
    mesh = meshes[(1, 4)]
    xl = S.shard_points(mesh, torch.from_numpy(d["xyz"]))
    for case in ("colors", "normals", "use_mesh"):
        cfg = _cfg(case)
        state, net = _state(cfg)
        pc = S.shard_pointcloud_attrs(mesh, {k: d[k] for k in _attrs(cfg)})
        step = S.make_sharded_train_step(net, cfg, None, mesh)
        new, m = step(S.prepare_scene_state(mesh, state), xl,
                      _batch(d, cfg, b=2, whole=False), pc)
        out[f"extra/{case}/loss"] = float(m["loss"])
        if case == "use_mesh":
            for i, t in enumerate(new.texture):
                out[f"extra/{case}/table/{i}"] = t.numpy().copy()


def _rank_round_trip(meshes, d, out):
    state, _ = _state(_cfg("jax"))
    nu = torch.from_numpy(d["table"][:N]).abs()
    state = state.replace(tex_opt=TP.RmsState((nu,)))
    xyz = torch.from_numpy(d["xyz"])
    for shape, mesh in meshes.items():
        mine = S.prepare_scene_state(mesh, state)
        xl, tl = S.shard_scene(mesh, xyz, state.texture[0])
        assert torch.equal(xl, S.shard_points(mesh, xyz))
        assert torch.equal(tl, mine.texture[0])
        back = S.unshard_state(mesh, mine, N)
        if mesh.rank == 0:
            key = f"round/{shape[0]}x{shape[1]}"
            out[key + "/texture"] = back.texture[0].numpy().copy()
            out[key + "/nu"] = back.tex_opt.nu[0].numpy().copy()
            out[key + "/params"] = back.flat_params.numpy().copy()
        else:
            assert back is None


def _rank(rank, world, device, jax_ckpt, out_path):
    """Every case on this rank; rank 0 saves the results."""
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                    ("jax", "jaxlib", "flax", "optax", "read_tpu"))
    assert not loaded, f"rank {rank} loaded {loaded}"
    torch.backends.mkldnn.enabled = False   # as the reference's process
    d = _inputs()
    meshes = {(1, 4): S.make_mesh(1, 4, device),
              (2, 2): S.make_mesh(2, 2, device)}
    out = {"clean": np.asarray(True)}
    _rank_merges(meshes, d, out)
    _rank_gather(meshes, d, out)
    _rank_round_trip(meshes, d, out)
    _rank_split(meshes, d, out)
    _rank_extra_and_mesh(meshes, d, out)
    _rank_vs_jax(meshes, d, jax_ckpt, out)
    if rank == 0:
        np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


# --------------------------------------------------------------------------
# The reference side
# --------------------------------------------------------------------------


class _JitInit:
    """A flax module whose ``init`` runs jitted (flax's eager init of the
    UNet takes ~45 s on the CPU); everything else is the module's."""

    def __init__(self, net):
        self._net = net

    def init(self, key, *pyr, train):
        import jax
        return jax.jit(lambda k, *p: self._net.init(k, *p, train=train))(
            key, *pyr)

    def __getattr__(self, name):
        return getattr(self._net, name)


def _jax_state(path):
    import jax
    from read_tpu.models.unet import UNet as FlaxUNet
    from read_tpu.pipelines import texture_pipeline as JTP
    from read_tpu.utils import ckpt as JCK
    # unit learning rates: with unit-lr SGD a step moves each leaf by its
    # gradient
    cfg = JTP.PipelineConfig(crop_size=HW, vgg_ratio=0.0, huber_ratio=1.0,
                             lr=1.0, texture_lr=1.0)
    state, _ = JTP.create_state(jax.random.PRNGKey(0), cfg, n_points=N,
                                net=_JitInit(FlaxUNet(**SMALL)))
    JCK.save_checkpoint(path, state, config={})
    open(path + ".ready", "w").close()
    return cfg, state, FlaxUNet(**SMALL)


def _jax_merges(d):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from read_tpu.parallel import sharded as JS
    mesh = JS.make_mesh(1, 4)
    xyz_s = JS.shard_points(mesh, d["merge_xyz"])
    out = {}
    for method, r in MERGES:
        def body(xyz_local, total_m, method=method, r=r):
            off = (jax.lax.axis_index("points") *
                   xyz_local.shape[0]).astype(jnp.int32)
            return JS.sharded_rasterize_pyramid(
                xyz_local, off, total_m, HW, 4, r, "points", method)

        f = shard_map(body, mesh=mesh, in_specs=(P("points", None), P()),
                      out_specs=P(), check_vma=False)
        levels = jax.jit(f)(xyz_s, jnp.asarray(d["merge_m"]))
        out[(method, r)] = [(np.asarray(i), np.asarray(dp))
                            for i, dp in levels]
    return out


def _jax_gather(d):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P
    from read_tpu.parallel import sharded as JS
    mesh = JS.make_mesh(1, 4)
    table_s = jax.device_put(jnp.asarray(d["table"]),
                             NamedSharding(mesh, P("points", None)))
    out = {}
    for act in ("none", "sigmoid"):
        def body(table_local, idx, act=act):
            off = (jax.lax.axis_index("points") *
                   table_local.shape[0]).astype(jnp.int32)
            return JS.sharded_gather(table_local, off, idx, act)

        f = shard_map(body, mesh=mesh, in_specs=(P("points", None), P()),
                      out_specs=P(), check_vma=False)
        out[act] = np.asarray(jax.jit(f)(table_s,
                                         jnp.asarray(d["gather_ix"])))
    return out


def _jax_sharded_steps(d, cfg, state, net):
    """read_tpu's (2, 2) 'split' and 'replicated' steps with unit-lr SGD:
    ``{mode: (loss, params grads, texture grads, batch_stats)}`` flat."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from read_tpu.parallel import sharded as JS
    from read_tpu.pipelines import texture_pipeline as JTP
    from read_tpu.utils import ckpt as JCK
    mesh = JS.make_mesh(2, 2)
    st = JS.prepare_scene_state(mesh, state)
    xyz_s = JS.shard_points(mesh, d["xyz"])
    dsh = NamedSharding(mesh, P("data"))
    batch = {k: jax.device_put(jnp.asarray(d[k]), dsh)
             for k in ("total_m", "target")}
    orig = JTP._make_optimizers
    JTP._make_optimizers = lambda cfg: (optax.sgd(1.0), optax.sgd(1.0))
    try:
        out = {}
        for mode in ("split", "replicated"):
            step = JS.make_sharded_train_step(net, cfg, None, mesh,
                                              unet=mode)
            s2, m = step(st, xyz_s, batch)
            before = JCK._flatten({"params": st.params})
            after = JCK._flatten({"params": s2.params})
            tex = np.asarray(st.texture)[:N] - np.asarray(s2.texture)[:N]
            out[mode] = (float(m["loss"]),
                         {k: before[k] - after[k] for k in before}, tex,
                         JCK._flatten({"batch_stats": s2.batch_stats}))
    finally:
        JTP._make_optimizers = orig
    return out


def _port_unsharded(d):
    """The port's unsharded steps on the whole batch, by case."""
    vgg = V.random_vgg_params(torch.Generator().manual_seed(0), "cpu")
    xyz = torch.from_numpy(d["xyz"])
    out = {}
    for case in ("vgg", "masked", "remat"):
        cfg = _cfg(case)
        state, net = _state(cfg)
        m, bs, _, g_net, g_tex = TP._loss_and_grads(
            net, cfg, vgg if cfg.vgg_ratio else None, state, xyz,
            _batch(d, cfg), False)
        out[case] = (float(m["loss"]), float(m["psnr"]), g_net.numpy(),
                     g_tex[0].numpy(), {k: v.numpy() for k, v in bs.items()})
    for case in ("colors", "normals", "use_mesh"):
        cfg = _cfg(case)
        state, net = _state(cfg)
        new, m = TP.make_train_step(net, cfg, None)(state, xyz,
                                                    _batch(d, cfg, b=2))
        out[case] = (float(m["loss"]), [t.numpy() for t in new.texture])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn the ranks (in a thread), compute the references meanwhile
    (the JAX state first, which the ranks read last), join, and return
    both."""
    tmp = tmp_path_factory.mktemp("sharded")
    d = _inputs()
    jax_ckpt = str(tmp / "jax_state")
    out_path = str(tmp / "ranks.npz")
    failure = []

    def go():
        try:
            launch.spawn(_rank, 4, "cpu", args=(jax_ckpt, out_path),
                         timeout_s=RANK_TIMEOUT_S, join_s=JOIN_S)
        except BaseException as e:   # re-raised in the test process
            failure.append(e)

    thread = threading.Thread(target=go)
    thread.start()
    try:
        jcfg, jstate, jnet = _jax_state(jax_ckpt)
        with torch.backends.mkldnn.flags(enabled=False):
            ref = {"merges": _jax_merges(d), "gather": _jax_gather(d),
                   "jax": _jax_sharded_steps(d, jcfg, jstate, jnet),
                   "port": _port_unsharded(d)}
    finally:
        thread.join(JOIN_S + 30)
    if failure:
        raise failure[0]
    if thread.is_alive():
        raise RuntimeError("the ranks outlived their join")
    with np.load(out_path) as z:
        ranks = {k: z[k] for k in z.files}
    ref["layout"] = TP.state_from_flat(CK.load_checkpoint(jax_ckpt)[0],
                                       "cpu").layout
    return d, ranks, ref


# --------------------------------------------------------------------------
# The cases
# --------------------------------------------------------------------------


def _loss_close(got, want, tol=1e-4):
    assert abs(got - want) <= tol * max(1.0, abs(want)), (got, want)


def _grads_close(got, want, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_ATOL * scale,
                               err_msg=what)


def test_ranks_import_no_jax(runs):
    _, ranks, _ = runs
    assert bool(ranks["clean"])


@pytest.mark.parametrize("method,r", MERGES)
def test_merged_pyramid_bit_equal_to_jax(runs, method, r):
    """(a) Every level's index and depth bit for bit, cross-shard ties to
    the least global id, depth-0 points, padded shards."""
    d, ranks, ref = runs
    want = ref["merges"][(method, r)]
    assert len(want) == 4
    for lv, (ix, dep) in enumerate(want):
        got_ix = ranks[f"merge/{method}/{r}/{lv}/index"]
        got_dep = ranks[f"merge/{method}/{r}/{lv}/depth"]
        np.testing.assert_array_equal(got_ix, ix, err_msg=f"level {lv}")
        np.testing.assert_array_equal(got_dep.view(np.int32),
                                      dep.view(np.int32),
                                      err_msg=f"level {lv}")
    ix0, dep0 = want[0]
    # the scene holds what the key order must get right
    assert ((dep0 == 0.0) & (ix0 >= 0)).any()
    assert (ix0 >= 600).any() or (ix0 >= 256).any()


@pytest.mark.parametrize("r", (0, 1))
def test_sort_merge_bit_equal_to_unsharded(runs, r):
    """(a) The merged 'sort' pyramid is the unsharded one: the key order
    is the exact z-buffer's."""
    d, ranks, _ = runs
    xyz = torch.from_numpy(d["merge_xyz"])
    ms = torch.from_numpy(d["merge_m"])
    if r == 0:
        want = RK.zbuffer_pyramid(xyz, ms, *HW, 4, "sort", "exact")
    else:
        want = RK.zbuffer_splat(xyz, ms, *HW, 4, "sort", "exact", r)
    for lv, (ix, dep) in enumerate(want):
        np.testing.assert_array_equal(ranks[f"merge/sort/{r}/{lv}/index"],
                                      ix.numpy())
        np.testing.assert_array_equal(ranks[f"merge/sort/{r}/{lv}/depth"],
                                      dep.numpy())


def test_zbuffer_pool_twin_and_refusals():
    """The pass-only entry's twin unpacks and pools the given keys as
    ``zbuffer_pyramid`` does; its refusals are the pyramid's."""
    d = _inputs()
    xyz = torch.from_numpy(d["merge_xyz"])
    ms = torch.from_numpy(d["merge_m"])
    key = RK.exact_keys(*RK.zbuffer_exact(xyz, ms, *HW)).view(2, *HW)
    got = RK.zbuffer_pool(key, 4)
    want = RK.zbuffer_pyramid(xyz, ms, *HW, 4, "sort", "exact")
    for (a, b), (c, e) in zip(got, want):
        assert torch.equal(a, c) and torch.equal(b, e)
    with pytest.raises(TypeError):
        RK.zbuffer_pool(key.to(torch.int32), 4)
    with pytest.raises(ValueError, match="not divisible"):
        RK.zbuffer_pool(key[:, :, :30], 4)
    with pytest.raises(ValueError, match="num_scales"):
        RK.zbuffer_pool(key, RK.MAX_LEVELS + 1)
    with pytest.raises(RuntimeError, match="no kernel"):
        RK.zbuffer_pool(key.to("meta"), 4)


@pytest.mark.parametrize("act", ("none", "sigmoid"))
def test_gather_matches_jax(runs, act):
    """(b) The owned-row gather, the activation after the sum."""
    _, ranks, ref = runs
    np.testing.assert_allclose(ranks[f"gather/{act}"], ref["gather"][act],
                               atol=1e-6)


@pytest.mark.parametrize("act", ("none", "sigmoid"))
def test_gather_backward_matches_unsharded(runs, act):
    """(b) Its backward adds each cotangent into the owning shard's row
    once: the unsharded gather's table gradient."""
    d, ranks, _ = runs
    table = torch.from_numpy(d["table"]).requires_grad_()
    x = T.sample_point_texture_unique(table, torch.from_numpy(d["gather_ix"]),
                                      act)
    (g,) = torch.autograd.grad((x * torch.from_numpy(d["gather_cot"])).sum(),
                               table)
    np.testing.assert_allclose(ranks[f"gather/{act}/grad"], g.numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("case,shape", [("vgg", "1x4"), ("vgg", "2x2"),
                                        ("masked", "2x2"), ("remat", "2x2")])
def test_split_matches_unsharded(runs, case, shape):
    """(c) Loss, PSNR, raw gradients and BatchNorm statistics of the
    'split' step are the unsharded step's on the whole batch; with
    ``remat`` the recomputed blocks reduce their BatchNorm sums again."""
    _, ranks, ref = runs
    loss, psnr, g_net, g_tex, bs = ref["port"][case]
    key = f"split/{case}/{shape}"
    _loss_close(float(ranks[key + "/loss"]), loss)
    _loss_close(float(ranks[key + "/psnr"]), psnr)
    _grads_close(ranks[key + "/g_net"], g_net, "net")
    _grads_close(ranks[key + "/g_tex"], g_tex, "texture")
    for k, v in bs.items():
        np.testing.assert_allclose(ranks[key + "/bs/" + k], v, rtol=0,
                                   atol=GRAD_ATOL * float(np.abs(v).max()),
                                   err_msg=k)


@pytest.mark.parametrize("mode", ("split", "replicated"))
def test_sharded_step_matches_jax(runs, mode):
    """(d) The (2, 2) step from one JAX-written state against read_tpu's:
    'replicated' normalizes per data block, which sets it apart."""
    _, ranks, ref = runs
    loss, g_params, g_tex, bs = ref["jax"][mode]
    _loss_close(float(ranks[f"jax/{mode}/loss"]), loss)
    views = ref["layout"].views(torch.from_numpy(ranks[f"jax/{mode}/g_net"]))
    for name, g in views.items():
        want = g_params["params/" + name.replace(".", "/")]
        _grads_close(g.numpy(), want, name)
    # read_tpu's texture gradient is n_points-axis (P = 2) times the
    # unsharded one (ROADMAP queue 3)
    _grads_close(ranks[f"jax/{mode}/g_tex"], g_tex / 2.0, "texture")
    for k, v in bs.items():
        got = ranks[f"jax/{mode}/bs/" + k[len("batch_stats/"):]
                    .replace("/", ".")]
        np.testing.assert_allclose(got, v, rtol=0,
                                   atol=GRAD_ATOL * float(np.abs(v).max()),
                                   err_msg=k)


@pytest.mark.parametrize("case", ("colors", "normals"))
def test_extra_modes_match_unsharded(runs, case):
    """(e) Points-sharded attribute tables (per-item view colours too),
    B = 2 over 4 points ranks: two of them take no rows in stage 2."""
    _, ranks, ref = runs
    _loss_close(float(ranks[f"extra/{case}/loss"]), ref["port"][case][0])


def test_use_mesh_matches_unsharded(runs):
    """(f) Replicated mesh tables sampled at the gathered uv maps: the
    loss, and the tables after one step (RMSprop's rsqrt amplifies
    reduction-order noise on near-zero moments, ``test_sharded.py``)."""
    _, ranks, ref = runs
    loss, tables = ref["port"]["use_mesh"]
    _loss_close(float(ranks["extra/use_mesh/loss"]), loss)
    for i, t in enumerate(tables):
        np.testing.assert_allclose(ranks[f"extra/use_mesh/table/{i}"], t,
                                   atol=5e-3)


@pytest.mark.parametrize("shape", ("1x4", "2x2"))
def test_unshard_round_trip(runs, shape):
    """(g) Pad, shard, gather and strip give the state back bit for
    bit."""
    d, ranks, _ = runs
    state, _ = _state(_cfg("jax"))
    np.testing.assert_array_equal(ranks[f"round/{shape}/texture"],
                                  state.texture[0].numpy())
    np.testing.assert_array_equal(ranks[f"round/{shape}/nu"],
                                  np.abs(d["table"][:N]))
    np.testing.assert_array_equal(ranks[f"round/{shape}/params"],
                                  state.flat_params.numpy())


def test_batch_rows_follow_read_tpu_placement():
    """A batch whose rows the data axis does not divide is refused, as
    read_tpu's ``P('data')`` placement refuses it; the split step's
    stage 2 takes ``ceil(B/D / P)`` rows a points rank, so with 2 rows
    over 4 points ranks two ranks take none (read_tpu's GSPMD pads)."""
    mesh = S.Mesh(2, 4, rank=5, device=torch.device("cpu"), backend="gloo",
                  points_group=None, data_group=None)
    batch = {"total_m": torch.zeros(4, 4, 4), "target": torch.arange(4)}
    assert mesh.data_index == 1 and mesh.points_index == 1
    assert S.shard_batch(mesh, batch)["target"].tolist() == [2, 3]
    with pytest.raises(ValueError, match="divide evenly"):
        S.shard_batch(mesh, {"total_m": torch.zeros(3, 4, 4)})
    assert mesh.rows(2) == [(0, 1), (1, 2), (2, 2), (2, 2)]
    assert mesh.rows(6) == [(0, 2), (2, 4), (4, 6), (6, 6)]
