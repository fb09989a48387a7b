"""Multi-device training over a ``('data', 'points')`` mesh of ranks.

Counterpart of ``read_tpu/parallel/sharded.py``: ``make_mesh`` (:49-58),
the z-merge ``_local_raster_merge`` and ``sharded_rasterize_pyramid``
(:61-97), ``sharded_gather`` (:100-118), ``sharded_extra_maps``
(:121-196), the shard, pad and unshard helpers (:199-348) and
``make_sharded_train_step`` in its ``'replicated'`` (:350-468) and
``'split'`` (:471-636) modes.

``read_tpu`` runs one jitted SPMD program from one controller; here each
rank is a process (:mod:`read_tpu_torch.parallel.launch`) and
``torch.distributed`` collectives stand in for ``pmin``/``psum``/
``pmean``. Rank ``r`` sits at ``(r // P, r % P)`` of a ``D x P`` mesh:
batch rows shard over ``data``, the point cloud, its descriptor table
and the table's RMSprop moment over ``points``; net parameters, Adam
moments and mesh-texture tables are replicated. Every rank is handed
the whole batch and keeps its data block's rows (``B`` divisible by
``D``, as ``read_tpu``'s placement asks).

- **The z-merge.** Each points rank z-buffers its own points at level 0
  by the route the unsharded step takes for the config (K5 for 'sort',
  K1 for 'pallas'/'scatter1', the splat projection for ``point_radius >
  0``; :func:`read_tpu_torch.ops.rasterize.rasterize_batch`, which picks
  the winner with the shard's own ids, as ``read_tpu`` does), writes
  K5's 64-bit key ``float_bits(depth) << 32 | (index + id_offset)`` with
  **global** ids (``INT64_MAX`` where empty), and one
  ``all_reduce(MIN)`` over the points group merges the shards. Depths
  are non-negative and ids below 2^31, so the least key is the least
  depth, ties to the least global id: what ``read_tpu``'s two ``pmin``s
  give. The pyramid pass pools the merged key
  (:func:`read_tpu_torch.ops.rasterize_kernels.zbuffer_pool`: levels 1
  and up are the exact 2x2 pools of the merged buffer). Pad points sit
  at ``1e9`` and never land.
- **The owned-row gather.** Each points rank gathers the rows it owns
  (zeros elsewhere) and an ``all_reduce(SUM)`` over the points group
  assembles the map; the activation comes after the sum. Its backward is
  the scatter-add of the cotangent into the owned rows: every points
  rank holds the same cotangent of the assembled map, so the sum's
  backward is the identity. (``read_tpu``'s transpose of its ``psum``
  instead sums the points ranks' identical cotangents, and its
  ``_unreplicate_fix`` rescales the split step's: its texture gradients
  come out ``P`` times the unsharded step's. The port's equal the
  unsharded step's; ROADMAP queue 3.)
- **'split'** (the default): stage 1 (raster, merge, gather) runs for
  the data block's ``B/D`` rows on each of its points ranks; each rank
  then takes its share of the block's rows (``ceil(B/D / P)`` a rank,
  the last ones may get fewer or none) for the UNet and the loss. The
  backward of that slice all-gathers the points ranks' cotangents, so
  each scatters the whole block into its own rows. BatchNorm takes
  global-batch statistics (:func:`read_tpu_torch.models.unet.
  global_batch_norm`); every mean of the loss and the metrics is over
  the global batch (each rank's loss is its rows' share of the global
  means, and the masked loss divides by the global mask mean; PSNR is a
  log of the global MSE). The reg loss counts each texture row once
  (the data-block-0 ranks add their shard's part). Net and mesh-table
  gradients are summed over all ranks in one all-reduce (one flat
  buffer), point-table gradients over the data group.
- **'replicated'**: the whole loss runs on every points rank of a data
  block, with the block's own BatchNorm statistics; the guarded net and
  texture gradients, the statistics and the metrics take their mean
  over the data group. ``use_mesh`` is refused, as in ``read_tpu``.

As in ``read_tpu``'s sharded step, no point dropout or jitter, no
supersampling, no per-point or z-scaled splat sizes and no temporal
average enter (the raster runs at ``crop_size`` with the radius alone;
``read_tpu_torch.train`` warns). Both modes run the cfg's ``operands``
and ``remat`` and full float32 (TF32 off), as the unsharded step.

Collectives on CUDA tensors under gloo (ranks sharing a card) go
through host memory, here and explicitly (:meth:`Mesh.all_reduce`); no
device or backend is switched silently and a failed collective raises.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from read_tpu_torch.criterions import losses as L
from read_tpu_torch.models import texture as T
from read_tpu_torch.models import unet as U
from read_tpu_torch.ops import rasterize as R
from read_tpu_torch.ops import rasterize_kernels as RK
from read_tpu_torch.ops import render_modes as RM
from read_tpu_torch.pipelines import texture_pipeline as TP
from read_tpu_torch.utils import fp32

__all__ = ["Mesh", "make_mesh", "shard_batch", "sharded_rasterize_pyramid",
           "sharded_gather", "sharded_extra_maps", "shard_scene",
           "shard_state", "shard_points", "shard_pointcloud_attrs",
           "prepare_scene_state", "unshard_state", "sharded_loss_and_grads",
           "make_sharded_train_step"]

_UNET_MODES = ("split", "replicated")
_ATTR_KEYS = {"colors": "rgb", "xyz": "xyz_c", "uv_2d": "uv2d",
              "labels": "labels", "normals_m": "normals"}


@dataclasses.dataclass
class Mesh:
    """One rank's view of the ``n_data x n_points`` mesh: its
    coordinates ``(data_index, points_index)``, its device, and the
    process groups of its row (``points_group``: the ranks sharing its
    data block) and column (``data_group``: the ranks sharing its points
    shard). ``host_staged``: collectives go through host memory (gloo
    with CUDA tensors)."""
    n_data: int
    n_points: int
    rank: int
    device: torch.device
    backend: str
    points_group: object
    data_group: object

    @property
    def world(self) -> int:
        return self.n_data * self.n_points

    @property
    def data_index(self) -> int:
        return self.rank // self.n_points

    @property
    def points_index(self) -> int:
        return self.rank % self.n_points

    @property
    def host_staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def _size(self, group) -> int:
        if group is None:
            return self.world
        return self.n_points if group is self.points_group else self.n_data

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM,
                   group=None) -> torch.Tensor:
        """A new tensor: ``t`` reduced by ``op`` over ``group`` (None:
        every rank). gloo ranks sharing a card hand gloo a host copy and
        copy the result back: the tensor crosses the host, here."""
        if self._size(group) == 1:
            return t.detach().clone()
        if self.host_staged:
            host = t.detach().to("cpu")
            dist.all_reduce(host, op=op, group=group)
            return host.to(self.device)
        out = t.detach().clone()
        dist.all_reduce(out, op=op, group=group)
        return out

    def all_gather(self, t: torch.Tensor, group) -> list:
        """Every rank of ``group``'s ``t`` (equal shapes), in rank
        order; through host memory as :meth:`all_reduce`."""
        if self._size(group) == 1:
            return [t.detach().clone()]
        src = t.detach().to("cpu") if self.host_staged \
            else t.detach().contiguous()
        parts = [torch.empty_like(src) for _ in range(self._size(group))]
        dist.all_gather(parts, src, group=group)
        return [p.to(self.device) for p in parts]

    def gather_rows(self, t: torch.Tensor):
        """The points ranks' ``t``, concatenated in rank order, on the
        data block's first points rank (None on the others); through
        host memory as :meth:`all_reduce`."""
        if self.n_points == 1:
            return t
        dst = self.data_index * self.n_points
        src = t.detach().to("cpu") if self.host_staged else t.detach()
        parts = [torch.empty_like(src) for _ in range(self.n_points)] \
            if self.rank == dst else None
        dist.gather(src, parts, dst=dst, group=self.points_group)
        return None if parts is None else torch.cat(parts).to(self.device)

    def rows(self, n: int):
        """``[(start, stop)]`` of each points rank's share of ``n`` data
        block rows: ``ceil(n / P)`` a rank in order, the last ones fewer
        or none (the split step's stage 2)."""
        chunk = -(-n // self.n_points)
        return [(min(p * chunk, n), min((p + 1) * chunk, n))
                for p in range(self.n_points)]


def make_mesh(n_data: int, n_points: int, device) -> Mesh:
    """This rank's :class:`Mesh` over an initialized ``torch.distributed``
    world of ``n_data * n_points`` ranks (``read_tpu``'s ``make_mesh``
    reshapes its devices so: rank ``r`` is ``(r // n_points, r %
    n_points)``) on this rank's ``device``. Every rank must call it, in
    the same order, since it makes the groups."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialized")
    world = dist.get_world_size()
    if n_data < 1 or n_points < 1 or n_data * n_points != world:
        raise ValueError(f"make_mesh: a {n_data}x{n_points} mesh needs "
                         f"{n_data * n_points} ranks; the world has {world}")
    rank = dist.get_rank()
    d_index, p_index = divmod(rank, n_points)
    points_group = data_group = None
    for d in range(n_data):
        g = dist.new_group([d * n_points + p for p in range(n_points)])
        if d == d_index:
            points_group = g
    for p in range(n_points):
        g = dist.new_group([d * n_points + p for d in range(n_data)])
        if p == p_index:
            data_group = g
    return Mesh(n_data, n_points, rank, torch.device(device),
                dist.get_backend(), points_group, data_group)


def shard_batch(mesh: Mesh, batch: Dict) -> Dict:
    """This rank's data block of a batch every rank holds whole: the
    rows ``[d * B/D, (d + 1) * B/D)`` of each entry. ``B`` must be
    divisible by ``D``, as ``read_tpu``'s ``P('data')`` placement refuses
    it otherwise."""
    b = batch["total_m"].shape[0]
    if b % mesh.n_data:
        raise ValueError(f"batch of {b} rows over a data axis of "
                         f"{mesh.n_data}: the batch must divide evenly")
    n = b // mesh.n_data
    r0 = mesh.data_index * n
    return {k: v[r0:r0 + n] for k, v in batch.items()}


# --------------------------------------------------------------------------
# The z-merge and the owned-row gather
# --------------------------------------------------------------------------


def sharded_rasterize_pyramid(mesh: Mesh, xyz_local: torch.Tensor,
                              id_offset: int, total_m: torch.Tensor,
                              target_shape, num_scales: int = 4,
                              point_radius: int = 0, method: str = "sort"):
    """The merged index pyramid of the points shards: a list of
    ``(index [B, h_i, w_i], depth)`` with global ids (``read_tpu``'s
    ``sharded_rasterize_pyramid``). This shard's level-0 z-buffer becomes
    K5's exact key with global ids (``INT64_MAX`` where empty), one MIN
    all-reduce over the points group merges the shards, and the pass
    pools the merged buffer. ``id_offset``: the global id of this
    shard's first point."""
    h0, w0 = target_shape
    xyz_local = xyz_local.to(torch.float32).contiguous()
    total_m = total_m.to(device=xyz_local.device, dtype=torch.float32
                         ).contiguous()
    idx, dep = R.rasterize_batch(xyz_local, total_m, h0, w0, point_radius,
                                 method)
    key = mesh.all_reduce(RK.exact_keys(idx, dep, id_offset),
                          dist.ReduceOp.MIN, mesh.points_group)
    return RK.zbuffer_pool(key, num_scales)


class _PointsSum(torch.autograd.Function):
    """The sum over the points group; its backward is the identity, since
    every points rank holds the same cotangent of the sum."""

    @staticmethod
    def forward(ctx, mesh: Mesh, x: torch.Tensor):
        return mesh.all_reduce(x, dist.ReduceOp.SUM, mesh.points_group)

    @staticmethod
    def backward(ctx, g):
        return None, g


def _owned_ids(index_map: torch.Tensor, id_offset: int, n_local: int):
    """Global ids -> this shard's rows, -1 where another shard owns the
    point or the pixel is empty."""
    local = index_map - id_offset
    return torch.where((local >= 0) & (local < n_local), local, -1)


def sharded_gather(mesh: Mesh, table_local: torch.Tensor, id_offset: int,
                   index_map: torch.Tensor, activation: str = "none",
                   per_image: bool = True) -> torch.Tensor:
    """Gather descriptors from a row-sharded ``table_local [N/P, C]``
    through the global ``index_map``: each points rank serves the rows it
    owns (zeros elsewhere), a sum over the points group assembles the
    map, then the activation. The backward adds the cotangent into the
    owned rows only (``per_image``: the 1-px points' per-image add, else
    the splats' summing one, as the unsharded gathers)."""
    T._check_activation(activation)
    local = _owned_ids(index_map, id_offset, table_local.shape[0])
    x = T._Gather.apply(table_local, local, per_image)
    if mesh.n_points > 1:
        x = _PointsSum.apply(mesh, x)
    return T._activate(x, activation)


def sharded_extra_maps(mesh: Mesh, cfg: TP.PipelineConfig, modes, ix, dep,
                       pc_local: Dict, id_offset: int, gt_label=None,
                       view_m=None, tables=None):
    """The extra modality maps of one level from points-sharded attribute
    tables (``read_tpu``'s ``sharded_extra_maps``): per-point attributes
    through :func:`sharded_gather`; ``normals_l/r/d`` colour each item's
    points from the shard's own ``xyz``/``normals`` rows and the item's
    ``view_m`` (one ``[B, N/P, 3]`` table a mode, kept in ``tables`` for
    the other levels) and gather through the same owned-row sum;
    ``uv_1d`` and ``depth`` come from the merged maps. A missing
    ``labels`` table zero-fills; another missing attribute raises."""
    tables = {} if tables is None else tables
    maps = []
    for mode in modes:
        if mode in RM.VIEW_DEPENDENT:
            if view_m is None:
                raise ValueError(
                    f"view-dependent extra mode {mode!r} needs per-item "
                    "view matrices: pass batch['view_matrix'] [B, 4, 4]")
            normals, xyz_l = pc_local.get("normals"), pc_local.get("xyz")
            if normals is None:
                maps.append(torch.zeros(ix.shape + (3,), device=ix.device))
                continue
            if xyz_l is None:
                raise KeyError(
                    f"extra mode {mode!r} needs the sharded 'xyz' table")
            if mode not in tables:
                tables[mode] = torch.stack([
                    RM.view_dependent_colors(mode, xyz_l, normals, vm)
                    for vm in RM.to_f32(view_m, ix.device)])
            x = RM.gather_attribute(
                tables[mode], _owned_ids(ix, id_offset, xyz_l.shape[0]))
            maps.append(_PointsSum.apply(mesh, x)
                        if mesh.n_points > 1 else x)
            continue
        if mode == "uv_1d":
            maps.append(ix[..., None].to(torch.float32))
            continue
        if mode == "depth":
            maps.append(dep[..., None])
            continue
        key = _ATTR_KEYS[mode]
        attr = pc_local.get(key)
        if attr is None:
            if mode != "labels":
                raise KeyError(
                    f"extra mode {mode!r} needs point attribute {key!r}, "
                    "absent from the sharded pointcloud")
            maps.append(torch.zeros(ix.shape + (1,), device=ix.device))
            continue
        if mode == "normals_m":
            attr = attr * 0.5 + 0.5
        rendered = sharded_gather(mesh, attr, id_offset, ix)
        if mode == "labels" and cfg.label_in_input and gt_label is not None:
            occ = (rendered[..., 0] > 1e-9).to(torch.float32)
            f = gt_label.shape[1] // ix.shape[1]
            lab = gt_label[:, ::f, ::f].to(torch.float32)
            rendered = (lab * occ)[..., None]
        maps.append(rendered)
    return maps


# --------------------------------------------------------------------------
# Shard, pad, unshard
# --------------------------------------------------------------------------


def _pad_rows(x: torch.Tensor, pad: int, value: float = 0.0):
    if not pad:
        return x
    return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), value,
                                    dtype=x.dtype, device=x.device)])


def _local_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This points rank's rows of ``x`` (a multiple of P rows)."""
    if x.shape[0] % mesh.n_points:
        raise ValueError(f"{x.shape[0]} rows do not shard over "
                         f"{mesh.n_points} points ranks: pad them first")
    n = x.shape[0] // mesh.n_points
    return x[mesh.points_index * n:(mesh.points_index + 1) * n].contiguous()


def shard_points(mesh: Mesh, xyz) -> torch.Tensor:
    """This rank's points ``[N/P, 3]`` on its device, ``N`` padded to a
    multiple of P with points at ``1e9`` that never land."""
    xyz = RM.to_f32(xyz, mesh.device).reshape(-1, 3)
    return _local_rows(mesh, _pad_rows(xyz, (-xyz.shape[0]) % mesh.n_points,
                                       1e9))


def shard_scene(mesh: Mesh, xyz, texture: torch.Tensor):
    """``(xyz_local, texture_local)``: the points as
    :func:`shard_points` and the ``[N, C]`` table padded with zero rows
    alike."""
    tex = texture.to(mesh.device)
    return shard_points(mesh, xyz), _local_rows(
        mesh, _pad_rows(tex, (-tex.shape[0]) % mesh.n_points))


def shard_pointcloud_attrs(mesh: Mesh, pc: Dict) -> Dict:
    """This rank's rows of each point attribute (``rgb``, ``xyz_c``,
    ``uv2d``, ``labels``, ``normals``, ``xyz``), float32 ``[N/P, C]``
    (1-D attributes as one column), padded with zeros as the points
    (pad points are never gathered)."""
    out = {}
    for key, attr in pc.items():
        if attr is None:
            continue
        a = RM.to_f32(attr, mesh.device)
        if a.dim() == 1:
            a = a[:, None]
        out[key] = _local_rows(mesh, _pad_rows(a, (-a.shape[0])
                                               % mesh.n_points))
    return out


def _point_table(state: TP.TrainState) -> bool:
    """The state's texture is the ``[N, C]`` point table (not the
    ``[s, s, C]`` mesh tables, which replicate)."""
    return state.texture[0].dim() == 2


def shard_state(mesh: Mesh, state: TP.TrainState) -> TP.TrainState:
    """This rank's part of a state whose point table has a multiple of P
    rows, on the rank's device: its rows of the table and of the RMSprop
    moment; the net, its statistics and Adam moments, and mesh-texture
    tables whole."""
    dev = mesh.device
    state = state.replace(
        flat_params=state.flat_params.to(dev),
        batch_stats={k: v.to(dev) for k, v in state.batch_stats.items()},
        texture=tuple(t.to(dev) for t in state.texture),
        net_opt=TP.AdamState(state.net_opt.count, state.net_opt.mu.to(dev),
                             state.net_opt.nu.to(dev)),
        tex_opt=TP.RmsState(tuple(t.to(dev) for t in state.tex_opt.nu)),
        lr_scale=state.lr_scale.to(dev))
    if not _point_table(state):
        return state
    return state.replace(
        texture=(_local_rows(mesh, state.texture[0]),),
        tex_opt=TP.RmsState((_local_rows(mesh, state.tex_opt.nu[0]),)))


def prepare_scene_state(mesh: Mesh, state: TP.TrainState) -> TP.TrainState:
    """An unsharded state (every rank holds the same one, e.g. from the
    same seed or checkpoint) -> this rank's sharded state for the step:
    the point table and its RMSprop moment padded with zero rows to a
    multiple of P, then :func:`shard_state`."""
    if _point_table(state):
        pad = (-state.texture[0].shape[0]) % mesh.n_points
        state = state.replace(
            texture=(_pad_rows(state.texture[0], pad),),
            tex_opt=TP.RmsState((_pad_rows(state.tex_opt.nu[0], pad),)))
    return shard_state(mesh, state)


def unshard_state(mesh: Mesh, state: TP.TrainState,
                  n_points: int) -> Optional[TP.TrainState]:
    """The inverse of :func:`prepare_scene_state`: the whole state on
    rank 0, its point table and RMSprop moment gathered from the points
    ranks and stripped of the padding; None on every other rank. The
    ranks of data block 0 must all call it (the others may)."""
    if mesh.data_index != 0:
        return None
    if not _point_table(state):
        return state if mesh.rank == 0 else None
    tex = mesh.gather_rows(state.texture[0])
    nu = mesh.gather_rows(state.tex_opt.nu[0])
    if mesh.rank != 0:
        return None
    return state.replace(texture=(tex[:n_points].contiguous(),),
                         tex_opt=TP.RmsState((nu[:n_points].contiguous(),)))


# --------------------------------------------------------------------------
# The step
# --------------------------------------------------------------------------


class _TakeRows(torch.autograd.Function):
    """Forward: this points rank's share of each map's data-block rows.
    Backward: every points rank's cotangents, all-gathered over the
    points group (one all-gather for all maps, each share padded to the
    largest), so each rank scatters the whole block into its own
    rows."""

    @staticmethod
    def forward(ctx, mesh: Mesh, bounds, *maps):
        ctx.mesh, ctx.bounds = mesh, bounds
        ctx.shapes = [tuple(m.shape) for m in maps]
        r0, r1 = bounds[mesh.points_index]
        return tuple(m[r0:r1].clone() for m in maps)

    @staticmethod
    def backward(ctx, *grads):
        mesh, bounds = ctx.mesh, ctx.bounds
        want = [i for i, need in enumerate(ctx.needs_input_grad[2:]) if need]
        out = [None] * len(grads)
        if not want:
            return (None, None, *out)
        chunk = max(r1 - r0 for r0, r1 in bounds)
        mine = []
        for i in want:
            g = grads[i]
            pad = chunk - g.shape[0]
            if pad:
                g = torch.cat([g, g.new_zeros((pad,) + tuple(g.shape[1:]))])
            mine.append(g.reshape(-1))
        parts = mesh.all_gather(torch.cat(mine), mesh.points_group)
        sizes = [chunk * int(np.prod(ctx.shapes[i][1:])) for i in want]
        split = [p.split(sizes) for p in parts]
        for j, i in enumerate(want):
            rest = ctx.shapes[i][1:]
            out[i] = torch.cat([split[p][j].view(chunk, *rest)[:r1 - r0]
                                for p, (r0, r1) in enumerate(bounds)])
        return (None, None, *out)


class _Sum(torch.autograd.Function):
    """The sum over ``group`` (None: every rank), differentiable: its
    backward sums the cotangents over the group alike (the global
    BatchNorm's reduce)."""

    @staticmethod
    def forward(ctx, mesh: Mesh, group, x: torch.Tensor):
        ctx.mesh, ctx.group = mesh, group
        return mesh.all_reduce(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return None, None, ctx.mesh.all_reduce(g, dist.ReduceOp.SUM,
                                               ctx.group)


def _stage1(mesh: Mesh, cfg: TP.PipelineConfig, tables, xyz_local,
            id_offset: int, blk: Dict, pc_local: Dict):
    """Raster, merge and gather for the data block: per level the
    descriptor map (or, with ``use_mesh``, ``(extras, uv, mask)``), the
    extra maps first."""
    h, w = cfg.crop_size
    levels = sharded_rasterize_pyramid(
        mesh, xyz_local, id_offset, blk["total_m"], (h, w), cfg.num_scales,
        cfg.point_radius, cfg.raster_method)
    per_image = cfg.point_radius == 0
    pyr, cache = [], {}
    for lvl, (ix, dep) in enumerate(levels):
        ex = []
        if cfg.extra_modes:
            ex = sharded_extra_maps(mesh, cfg, cfg.extra_modes[lvl], ix, dep,
                                    pc_local, id_offset, blk.get("label"),
                                    blk.get("view_matrix"), cache)
        if cfg.use_mesh:
            uv = sharded_gather(mesh, pc_local["uv2d"], id_offset, ix,
                                per_image=per_image)
            exm = torch.cat(ex, -1) if ex else \
                torch.zeros(ix.shape + (0,), device=ix.device)
            pyr.append((exm, uv, (ix >= 0).to(torch.float32)))
        else:
            x = sharded_gather(mesh, tables[0], id_offset, ix,
                               cfg.texture_activation, per_image)
            pyr.append(torch.cat(ex + [x], -1) if ex else x)
    return pyr


def _mesh_stage2(cfg: TP.PipelineConfig, tables, stage1):
    """The replicated mesh tables sampled at the gathered uv maps, zeros
    where no point landed, after the extra maps."""
    pyr = []
    for ex, uv, mask in stage1:
        x = T.sample_mesh_texture(tables, uv, cfg.texture_activation)
        x = x * mask[..., None]
        pyr.append(torch.cat([ex, x], -1) if ex.shape[-1] else x)
    return pyr


def _split_losses(mesh: Mesh, cfg: TP.PipelineConfig, vgg_params,
                  out: Dict, rows: Dict, b_global: int):
    """This rank's share of ``TP._losses``' loss over the global batch
    (summed over the ranks it is the loss) and its no-grad metric parts
    ``{name: share}`` (``se``: the squared error sum PSNR is taken
    from)."""
    im = out["im_out"]
    target, mask = rows["target"], rows.get("mask")
    h, w = im.shape[1:3]
    masked = cfg.use_mask and mask is not None
    im_l = im * mask if masked else im
    seg_on = (cfg.num_classes is not None and "seg_out" in out
              and rows.get("label") is not None)
    bkg_on = cfg.masked_background and mask is not None
    counts = []
    if bkg_on:
        counts.append(mask.sum())
    if seg_on:
        counts.append((rows["label"] > 0).sum().to(torch.float32))
    if counts:
        counts = mesh.all_reduce(torch.stack(counts).to(torch.float64))
        counts = [float(c) for c in counts]
    hub = L.huber_loss(im_l, target, per_item=True).sum() / b_global
    loss = cfg.huber_ratio * hub
    parts = {"huber_loss": hub}
    if vgg_params is not None and cfg.vgg_ratio:
        vgg = TP.vgg_term(cfg, vgg_params, im_l, target,
                          per_item=True).sum() / b_global
        loss = loss + cfg.vgg_ratio * vgg
        parts["vgg_loss"] = vgg
    if seg_on:
        n_local = max(float((rows["label"] > 0).sum()), 1.0)
        seg = L.cross_entropy_ignore0(out["seg_out"], rows["label"]) \
            * (n_local / max(counts[-1], 1.0))
        loss = loss + cfg.seg_ratio * seg
        parts["seg_loss"] = seg
    if bkg_on:
        mmean = counts[0] / (b_global * h * w)
        bkg = 500.0 * torch.abs(im * (1.0 - mask)).sum() \
            / (b_global * h * w * im.shape[-1])
        loss = loss / max(mmean, 1e-6) + bkg
    parts["se"] = torch.square(torch.clamp(im, 0.0, 1.0) - target).sum()
    return loss, parts


def _psnr(se_sum: torch.Tensor, n: int) -> torch.Tensor:
    return -10.0 * torch.log10(torch.clamp(se_sum / n, min=1e-12))


def _flat(ts) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in ts])


def _unflat(flat: torch.Tensor, like):
    out, off = [], 0
    for t in like:
        out.append(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    return out


def _grads(net, cfg: TP.PipelineConfig, vgg_params, mesh: Mesh, unet: str,
           state: TP.TrainState, xyz_local: torch.Tensor, batch: Dict,
           pc_local: Optional[Dict], clip: Optional[float]):
    """One sharded forward and backward: ``(metrics, new batch_stats,
    net gradient, texture gradients)``, reduced over the mesh. ``clip``:
    under 'replicated' each rank guards its gradients before their mean
    over the data group, as ``read_tpu`` does (None: no guard)."""
    pc_local = pc_local or {}
    blk = shard_batch(mesh, batch)
    b_global = batch["total_m"].shape[0]
    id_offset = mesh.points_index * xyz_local.shape[0]
    flat = state.flat_params.detach().requires_grad_()
    params = state.layout.views(flat)
    tables = tuple(t.detach().requires_grad_() for t in state.texture)
    bs = {k: v.clone() for k, v in state.batch_stats.items()}
    stage1 = _stage1(mesh, cfg, tables, xyz_local, id_offset, blk, pc_local)
    call = {"train": True, "remat": cfg.remat, "operands": cfg.operands}
    if unet == "split":
        bounds = mesh.rows(blk["total_m"].shape[0])
        r0, r1 = bounds[mesh.points_index]
        if cfg.use_mesh:
            taken = _TakeRows.apply(mesh, bounds, *[
                t for lv in stage1 for t in lv])
            pyr = _mesh_stage2(cfg, tables, [taken[i:i + 3] for i in
                                             range(0, len(taken), 3)])
        else:
            pyr = list(_TakeRows.apply(mesh, bounds, *stage1))
        rows = {k: v[r0:r1] for k, v in blk.items()}
        with U.global_batch_norm(functools.partial(_Sum.apply, mesh, None)):
            out = torch.func.functional_call(net, {**params, **bs},
                                             tuple(pyr), call)
        loss, parts = _split_losses(mesh, cfg, vgg_params, out, rows,
                                    b_global)
        if cfg.reg_weight:
            if cfg.use_mesh:
                reg = (T.mesh_texture_reg_loss(tables, cfg.reg_weight)
                       if mesh.rank == 0 else None)
            else:   # the padded table's mean, each row once
                n_all = tables[0].shape[0] * mesh.n_points
                reg = (cfg.reg_weight * torch.square(tables[0]).sum()
                       / (n_all * tables[0].shape[1])
                       if mesh.data_index == 0 else None)
            if reg is not None:
                loss = loss + reg
    else:
        out = torch.func.functional_call(net, {**params, **bs},
                                         tuple(stage1), call)
        loss, metrics = TP._losses(cfg, vgg_params, out, blk)
        if cfg.reg_weight:   # the shard's own mean, as read_tpu's
            loss = loss + T.point_texture_reg_loss(tables[0],
                                                   cfg.reg_weight)
        metrics["loss"] = loss
        parts = metrics
    g_net, *g_tex = torch.autograd.grad(loss, (flat, *tables),
                                        allow_unused=True,
                                        materialize_grads=True)
    names = sorted(parts)
    values = torch.stack([parts[k].detach().reshape(()) for k in names])
    if unet == "split":
        # net (+ mesh tables) and the metric shares over every rank
        values = torch.cat([values, loss.detach().reshape(1)])
        head = [g_net] + (g_tex if cfg.use_mesh else [])
        summed = mesh.all_reduce(_flat(head + [values]))
        *head, values = _unflat(summed, head + [values])
        g_net = head[0]
        if cfg.use_mesh:
            g_tex = head[1:]
        elif mesh.n_data > 1:
            g_tex = [mesh.all_reduce(g_tex[0], group=mesh.data_group)]
        *values, total = values.unbind()
        metrics = dict(zip(names, values))
        se = metrics.pop("se")
        metrics["psnr"] = _psnr(se, b_global * int(np.prod(
            batch["target"].shape[1:])))
        metrics["loss"] = total
        new_bs = bs
    else:
        if clip is not None:
            g_net = TP._guard_grad(g_net, clip)
            g_tex = [TP._guard_grad(g, clip) for g in g_tex]
        stats = list(bs.values())
        both = [g_net] + g_tex + stats + [values]
        mean = mesh.all_reduce(_flat(both), group=mesh.data_group) \
            / mesh.n_data
        g_net, *rest = _unflat(mean, both)
        g_tex = rest[:len(g_tex)]
        new_bs = dict(zip(bs, rest[len(g_tex):len(g_tex) + len(stats)]))
        metrics = dict(zip(names, rest[-1].unbind()))
    return metrics, new_bs, g_net, tuple(g_tex)


def sharded_loss_and_grads(net, cfg: TP.PipelineConfig, vgg_params,
                           mesh: Mesh, state: TP.TrainState,
                           xyz_local: torch.Tensor, batch: Dict,
                           pc_local: Optional[Dict] = None,
                           unet: str = "split"):
    """One sharded forward and backward from this rank's ``state``
    without the update, as ``TP._loss_and_grads``: ``(metrics, new
    batch_stats, net gradient [flat], texture gradients)``, the raw
    gradients before the guard, reduced over the mesh ('split': summed,
    so they are the unsharded step's; 'replicated': the data group's
    mean). The texture gradient is this rank's rows of the point table,
    or the mesh tables whole. In full float32 (TF32 off)."""
    _check_mode(cfg, unet)
    with fp32.full_f32():
        return _grads(net, cfg, vgg_params, mesh, unet, state, xyz_local,
                      batch, pc_local, None)


def _check_mode(cfg: TP.PipelineConfig, unet: str) -> None:
    TP._check_geometry(cfg)
    if unet not in _UNET_MODES:
        raise ValueError(f"unet {unet!r}: one of {_UNET_MODES}")
    if unet == "replicated" and cfg.use_mesh:
        raise ValueError("use_mesh is only supported with unet='split' (the "
                         "2D tables are replicated and sampled in stage 2)")


def make_sharded_train_step(net, cfg: TP.PipelineConfig, vgg_params,
                            mesh: Mesh, unet: str = "split"):
    """``train_step(state, xyz_local, batch, pc_local=None) -> (new_state,
    metrics)`` over the mesh (``read_tpu``'s ``make_sharded_train_step``):
    ``state`` is this rank's (:func:`prepare_scene_state`), ``xyz_local``
    its points (:func:`shard_points`), ``batch`` the whole batch (every
    rank the same; ``total_m``, ``target``, with ``mask``, ``label``,
    ``view_matrix`` as the unsharded step's, no point attributes),
    ``pc_local`` its rows of the
    point attributes the extra modes or ``use_mesh`` read
    (:func:`shard_pointcloud_attrs`). The guard, Adam on the net and RMS
    on the texture follow as in ``TP.make_train_step``; ``metrics`` are
    the global batch's, alike on every rank ('replicated': the data
    group's mean). ``unet``: 'split' or 'replicated' (see the module's
    note)."""
    _check_mode(cfg, unet)

    def train_step(state: TP.TrainState, xyz_local: torch.Tensor,
                   batch: Dict, pc_local: Optional[Dict] = None):
        with fp32.full_f32():
            clip = cfg.grad_clip if unet == "replicated" else None
            metrics, new_bs, g_net, g_tex = _grads(
                net, cfg, vgg_params, mesh, unet, state, xyz_local, batch,
                pc_local, clip)
            with torch.no_grad():
                if clip is None:
                    g_net = TP._guard_grad(g_net, cfg.grad_clip)
                    g_tex = tuple(TP._guard_grad(g, cfg.grad_clip)
                                  for g in g_tex)
                up_tex, tex_opt = TP.rms_update(g_tex, state.tex_opt)
                lr_tex = cfg.texture_lr * state.lr_scale
                texture = tuple(t + lr_tex * u
                                for t, u in zip(state.texture, up_tex))
                up_net, net_opt = TP.adam_update(g_net, state.net_opt)
                new_state = state.replace(
                    step=state.step + 1, texture=texture, tex_opt=tex_opt,
                    flat_params=state.flat_params
                    + (cfg.lr * state.lr_scale) * up_net,
                    batch_stats=new_bs, net_opt=net_opt)
        return new_state, metrics

    return train_step
