"""Training orchestrator CLI on PyTorch (CUDA kernels on a GPU).

Usage::

    python -m read_tpu_torch.train --config configs/demo_drive.yaml \\
        [--crop-size 256x256] [--epochs 100] ...

Counterpart of ``read_tpu/train.py``: the same flags and defaults
(``build_argparser``), an experiment config
that sets defaults which the command line overrides (``load_args``), an
experiment directory with ``args.yaml``, a ``log.txt`` copy of the
console and ``splits.json`` (``setup_experiment``), and ``main``:

- one state per scene, all sharing one net (``--net-ckpt`` loads it);
  splatted input formats (``uv_1d_p3...``, ``uv_1d_ps...``) and a
  scene manifest's per-point ``point_sizes`` go to every step's
  z-buffer; ``--supersampling`` rasterizes at that many times the crop;
  extra input modalities in ``--input-format`` (``depth``,
  ``normals_l``, ...) and ``label_in_input`` get their point attributes
  (on the device once a scene), label images and view matrices;
  ``--resume`` restores whole states (net, textures, both optimizers,
  step) from ``read_tpu``-format checkpoints; ``--freeze-net`` fits the
  textures alone; the train dataset's ``drop_points``/``perturb_points``
  augment every step (drawn on the device, seeded by the step);
  ``--use-mesh`` trains mesh textures of ``--texture-size`` (the scene's
  ``uv2d``, and its triangle ``faces`` where it has them,
  ``scene.io.mesh_inputs``);
- the epoch interleaves the scenes' batches; with ``--max-scenes-hbm``
  the scenes train in chunks of that many, and the other scenes'
  textures and texture-optimizer moments wait in pinned host memory
  (:class:`SceneStateStore`, least recently used out first); the net
  stays on the device;
- validation at the full /16-aligned frame, batched
  (``--batch-size-val``), its metrics copied to the host once an epoch;
- ``ReduceLROnPlateau`` on the val loss or PSNR drives ``lr_scale``;
- ``checkpoints/ckpt_<scene>_<epoch>`` (the newest 3 kept) and
  ``best_<scene>``, in ``read_tpu``'s format, so ``read_tpu`` and
  ``read_tpu_torch.render`` both load them;
- ``--eval`` (with ``--eval-all``, ``--eval-dir``) validates only and
  dumps the predictions as PNG;
- ``--pipeline pix2pix`` (the UNet on raw ``colors`` pyramids, Adam) and
  ``--pipeline rgb_texture`` (an RGB mesh texture, RMSprop, no net; with
  ``--use-mesh`` and scene faces through the triangle raster):
  :func:`run_alt_pipeline`, ``read_tpu``'s loop (:328-523) with its val
  PSNR, plateau decay, ``ckpt_<pipeline>_<scene>_<epoch>`` (the newest 3
  kept), ``best_<pipeline>_<scene>`` and ``--resume``;
- every ``--log-freq`` steps a train composite (output | target |
  depth) under ``train_imgs/``, and tensorboard scalars when
  ``tensorboardX`` is installed;
- ``--mesh DATAxPOINTS`` trains on ``D x P`` ranks, one process each
  (:mod:`read_tpu_torch.parallel.launch`: NCCL when every rank has a
  card of its own, else gloo, which ranks sharing a card use), with
  ``read_tpu``'s sharded step (:mod:`read_tpu_torch.parallel.sharded`,
  'split'). Every rank reads the same batches in the same order and
  keeps its own rows, so no data crosses ranks; rank 0 alone writes the
  log, ``history.json``, images and checkpoints, validates on the
  unsharded state and saves it unsharded, so a one-device run, the
  renderer and ``read_tpu`` load it. ``read_tpu.train``'s rules hold:
  the mesh line is printed; ``--max-scenes-hbm`` and ``--freeze-net``
  with ``--mesh`` exit; the other pipelines run as without ``--mesh``;
  a manifest's ``point_sizes`` are dropped, and under ``--use-mesh`` a
  scene's triangle faces are ignored (printed); the sharded step
  applies no ``drop_points``/``perturb_points``, no supersampling, no
  z-scaled sizes and no temporal average (one warning says which).

Beyond ``read_tpu``'s outputs the experiment directory holds
``history.json``: per epoch the losses, each train step's wall time and
the part of it spent waiting for the next batch, the val time and the
epoch's wall time (``seconds``: its steps and its val epoch, without the
checkpoints written after it).

The CLI runs on the CUDA device; ``--headless-platform cpu`` runs it on
the CPU with the kernels' plain twins (the tests do). Without a CUDA
device and without that flag it exits with an error. It needs none of
PyYAML, ``cv2``, ``imageio``, ``matplotlib`` or ``tensorboardX``:
configs are then read as JSON or block-style YAML
(:mod:`read_tpu_torch.utils.config_io`), images as PNG
(:mod:`read_tpu_torch.data.image_io`). ``--dtype bfloat16`` trains the
net with flax's bfloat16 activations (``models.unet``); the checkpoints
record the dtype in their config. ``--criterion vgg_ens`` averages the
VGG loss over K = 3 random networks drawn from ``torch.Generator``s seeded
0..K-1, or over the one network of ``--vgg-weights``. (K is
``config_from_dict``'s ``vgg_ens_k``, which a config file does not reach:
as in ``read_tpu``, a key the parser lacks goes to ``extra_config``.)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["parse_size", "build_argparser", "load_args",
           "setup_experiment", "config_dict", "SceneStateStore",
           "run_alt_pipeline", "main"]

# the sharded run's collective timeout: rank 0 validates while the other
# ranks wait in one
MESH_TIMEOUT_S = 3600


def parse_size(s) -> tuple:
    if isinstance(s, (list, tuple)):
        return tuple(int(x) for x in s)
    if isinstance(s, (int, float)):
        return (int(s), int(s))
    w, h = s.lower().split("x")
    return (int(h), int(w))  # (h, w); the command line says WxH


def build_argparser() -> argparse.ArgumentParser:
    """``read_tpu.train``'s flags, defaults and choices."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", type=str, default=None,
                   help="experiment YAML (or JSON); flags override it")
    p.add_argument("--pipeline", type=str, default="texture",
                   choices=["texture", "pix2pix", "rgb_texture"])
    p.add_argument("--paths-file", dest="paths_file", type=str)
    p.add_argument("--dataset-names", dest="dataset_names", nargs="*",
                   default=None)
    p.add_argument("--exclude-datasets", dest="exclude_datasets",
                   nargs="*", default=None)
    p.add_argument("--crop-size", dest="crop_size", type=str,
                   default="256x256")
    p.add_argument("--batch-size", dest="batch_size", type=int, default=2)
    p.add_argument("--batch-size-val", dest="batch_size_val", type=int,
                   default=1)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--texture-lr", dest="texture_lr", type=float,
                   default=1e-1)
    p.add_argument("--descriptor-size", dest="descriptor_size", type=int,
                   default=8)
    p.add_argument("--supersampling", type=int, default=1)
    p.add_argument("--input-format", dest="input_format", type=str,
                   default="uv_1d_p1, uv_1d_p1_ds1, uv_1d_p1_ds2, "
                           "uv_1d_p1_ds3, uv_1d_p1_ds4")
    p.add_argument("--splitter", type=str, default="split_by_step")
    p.add_argument("--criterion", type=str, default="vgg",
                   choices=["vgg", "vgg_pytorch", "vgg_mix",
                            "vgg_partial", "vgg_ens", "huber_only"],
                   help="vgg = caffe-normalized VGG loss; vgg_pytorch "
                        "torchvision normalization; vgg_mix the 0.5/0.5 "
                        "blend; vgg_partial the masked perceptual loss; "
                        "vgg_ens the mean over 3 seeded-random VGG weight "
                        "sets; huber_only no VGG")
    p.add_argument("--vgg-weights", dest="vgg_weights", type=str,
                   default=None)
    p.add_argument("--use-mask", dest="use_mask", action="store_true")
    p.add_argument("--num-classes", dest="num_classes", type=int,
                   default=None)
    p.add_argument("--texture-activation", dest="texture_activation",
                   type=str, default="none")
    p.add_argument("--texture-init", dest="texture_init", type=str,
                   default="rand", choices=["rand", "zeros"])
    p.add_argument("--reg-weight", dest="reg_weight", type=float,
                   default=0.0)
    p.add_argument("--save-dir", dest="save_dir", type=str,
                   default="data/logs")
    p.add_argument("--name", type=str, default=None)
    p.add_argument("--save-freq", dest="save_freq", type=int, default=1)
    p.add_argument("--log-freq", dest="log_freq", type=int, default=50)
    p.add_argument("--log-num-images", dest="log_num_images", type=int,
                   default=4)
    p.add_argument("--net-ckpt", dest="net_ckpt", type=str, default=None)
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint dir to resume from (full state)")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--eval-all", dest="eval_all", action="store_true")
    p.add_argument("--eval-dir", dest="eval_dir", type=str, default=None)
    p.add_argument("--freeze-net", dest="freeze_net", action="store_true",
                   help="texture-only fitting: freeze the (loaded) net "
                        "and train only the scene descriptors")
    p.add_argument("--plateau-patience", dest="plateau_patience",
                   type=int, default=5)
    p.add_argument("--plateau-factor", dest="plateau_factor", type=float,
                   default=0.5)
    p.add_argument("--plateau-metric", dest="plateau_metric", type=str,
                   default="loss", choices=["loss", "psnr"],
                   help="metric driving ReduceLROnPlateau")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="the net's activations and conv operands in "
                        "training and evaluation")
    p.add_argument("--remat", action="store_true", default=None,
                   help="recompute the UNet's EBlocks and DBlocks in the "
                        "backward pass instead of keeping their "
                        "activations")
    p.add_argument("--conv-impl", dest="conv_impl", type=str,
                   default="xla", choices=["xla", "im2col"],
                   help="accepted for read_tpu compatibility and recorded "
                        "in checkpoints; training always runs F.conv2d")
    p.add_argument("--raster-method", dest="raster_method", type=str,
                   default="sort",
                   choices=["sort", "scatter1", "scatter", "sort1q",
                            "pallas"],
                   help="z-buffer: 'sort'/'scatter' exact (K5), 'sort1q' "
                        "quantized depth bins, 'pallas'/'scatter1' packed "
                        "key (K1); recorded in checkpoints")
    p.add_argument("--max-steps-per-epoch", dest="max_steps_per_epoch",
                   type=int, default=None)
    p.add_argument("--max-scenes-hbm", dest="max_scenes_hbm", type=int,
                   default=None,
                   help="cap on device-resident scene texture tables: the "
                        "scenes train in chunks of this many while the "
                        "rest wait in pinned host memory. Default: all "
                        "scenes resident.")
    p.add_argument("--headless-platform", dest="headless_platform",
                   type=str, default=None,
                   help="'cpu' runs on the CPU with the kernels' plain "
                        "twins; default: the CUDA device")
    p.add_argument("--mesh", type=str, default=None,
                   help="multi-device mesh 'DATAxPOINTS' (e.g. 2x4): "
                        "D x P ranks, batch rows over DATA, the point "
                        "cloud and its descriptors over POINTS")
    p.add_argument("--masked-background", dest="masked_background",
                   action="store_true",
                   help="renormalize loss by mask mean + pull background "
                        "to black")
    p.add_argument("--use-mesh", dest="use_mesh", action="store_true",
                   help="mesh textures sampled at the scene's uv2d (with "
                        "its triangle faces where it has them)")
    p.add_argument("--texture-size", dest="texture_size", type=int,
                   default=512)
    p.add_argument("--temporal-average", dest="temporal_average",
                   action="store_true",
                   help="average each item's input pyramid with the "
                        "previous item's")
    return p


def load_args(argv=None):
    """Two-stage parse: the config file sets defaults, the command line
    overrides them."""
    from read_tpu_torch.utils import config_io

    parser = build_argparser()
    args, _ = parser.parse_known_args(argv)
    if args.config:
        config = config_io.load(args.config) or {}
        known = {a.dest for a in parser._actions}
        defaults = {k: v for k, v in config.items() if k in known}
        unknown = {k: v for k, v in config.items() if k not in known}
        parser.set_defaults(**defaults)
        args = parser.parse_args(argv)
        args.extra_config = unknown
    else:
        args = parser.parse_args(argv)
        args.extra_config = {}
    # dataset args blocks straight from the config file
    args.train_dataset_args = args.extra_config.pop(
        "train_dataset_args", {})
    args.val_dataset_args = args.extra_config.pop("val_dataset_args", {})
    args.splitter_args = args.extra_config.pop("splitter_args",
                                               {"val_step": 10})
    return args


def setup_experiment(args) -> str:
    """``<save_dir>/<name>_<time>/`` with ``checkpoints/``, ``args.yaml``
    (JSON, which YAML readers read too) and ``log.txt``, a copy of
    stdout and stderr from here on."""
    from read_tpu_torch.utils import config_io
    from read_tpu_torch.utils.perform import Tee

    name = args.name or (os.path.splitext(os.path.basename(
        args.config))[0] if args.config else "experiment")
    exp_dir = os.path.join(args.save_dir,
                           f"{name}_{time.strftime('%m%d_%H%M%S')}")
    os.makedirs(os.path.join(exp_dir, "checkpoints"), exist_ok=True)
    config_io.dump({k: v for k, v in vars(args).items()
                    if not k.startswith("_")},
                   os.path.join(exp_dir, "args.yaml"))
    sys.stdout = Tee(os.path.join(exp_dir, "log.txt"), sys.__stdout__)
    sys.stderr = Tee(os.path.join(exp_dir, "log.txt"), sys.__stderr__)
    return exp_dir


def config_dict(args) -> dict:
    return {k: v for k, v in vars(args).items()
            if isinstance(v, (str, int, float, bool, list, tuple,
                              type(None)))}


def _to_host(tables: tuple) -> tuple:
    """Host copies of a texture's ``tables`` (or their RMS moments):
    pinned where they lie on a CUDA device."""
    return tuple(torch.empty(t.shape, dtype=t.dtype,
                             pin_memory=True).copy_(t) if t.is_cuda
                 else t.clone() for t in tables)


class SceneStateStore:
    """Per-scene :class:`~read_tpu_torch.pipelines.texture_pipeline.
    TrainState` dict with a texture host offload.

    At most ``budget`` scenes keep their texture and its RMS moment on
    ``device``; the others hold host copies (pinned on a GPU) and come
    back on :meth:`activate`, which evicts the least recently used scene
    beyond the budget. The net portion (parameters, statistics, Adam
    moments) always stays on the device. ``budget=None`` keeps every
    scene resident."""

    def __init__(self, budget: Optional[int] = None, device="cpu"):
        self._states: Dict[int, object] = {}
        self.budget = budget
        self.device = torch.device(device)
        self._lru: List[int] = []  # most-recent last, device-resident ids
        self._host: Dict[int, torch.Tensor] = {}  # id -> its host texture

    def __getitem__(self, sid):
        return self._states[sid]

    def __setitem__(self, sid, state):
        self._states[sid] = state
        # only device-resident textures count against the budget (a
        # net-portion rebind of an offloaded state does not)
        if self.budget is not None and sid not in self._lru \
                and not self.is_offloaded(sid):
            self._lru.append(sid)
            self._evict()

    def __iter__(self):
        return iter(self._states)

    def is_offloaded(self, sid) -> bool:
        """The state holds the host copy this store made of its
        texture (a state set since then holds its own)."""
        return self._host.get(sid) is not None and \
            self._states[sid].texture is self._host[sid]

    @property
    def resident_ids(self):
        return tuple(self._lru)

    def _offload(self, sid):
        from read_tpu_torch.pipelines.texture_pipeline import RmsState
        if self.is_offloaded(sid):
            return
        st = self._states[sid].replace(
            texture=_to_host(self._states[sid].texture),
            tex_opt=RmsState(_to_host(self._states[sid].tex_opt.nu)))
        self._states[sid] = st
        self._host[sid] = st.texture

    def _evict(self):
        while self.budget is not None and len(self._lru) > self.budget:
            self._offload(self._lru.pop(0))

    def activate(self, sid):
        """The state with its texture tables on the device, evicting the
        least recently used scene beyond the budget."""
        from read_tpu_torch.pipelines.texture_pipeline import RmsState
        st = self._states[sid]
        if self.budget is None:
            return st
        if sid in self._lru:
            self._lru.remove(sid)
        self._lru.append(sid)
        if self.is_offloaded(sid):
            st = st.replace(texture=_to_device(st.texture, self.device),
                            tex_opt=RmsState(_to_device(st.tex_opt.nu,
                                                        self.device)))
            self._states[sid] = st
            del self._host[sid]
        self._evict()
        return st


def _to_device(tables: tuple, device) -> tuple:
    return tuple(t.to(device, non_blocking=True) for t in tables)


def _shapes(layout) -> dict:
    return dict(zip(layout.names, layout.shapes))


def _texture_shapes(tables: tuple) -> list:
    return [tuple(t.shape) for t in tables]


def _mesh_shape(args):
    """``(D, P)`` of ``--mesh DxP``, or None."""
    if not args.mesh:
        return None
    try:
        n_data, n_points = (int(x) for x in args.mesh.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh {args.mesh!r}: want DATAxPOINTS, e.g. 2x4")
    if n_data < 1 or n_points < 1:
        raise SystemExit(f"--mesh {args.mesh!r}: both axes must be >= 1")
    return n_data, n_points


def _device(args) -> torch.device:
    """CUDA unless ``--headless-platform cpu``; never a silent CPU run."""
    plat = (args.headless_platform or "cuda").lower()
    if plat == "cpu":
        return torch.device("cpu")
    if plat not in ("cuda", "gpu"):
        raise SystemExit(f"--headless-platform {plat!r}: use 'cpu' or "
                         "'cuda'")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --headless-platform cpu to "
                         "run on the CPU with the kernels' plain twins")
    return torch.device("cuda")


def run_alt_pipeline(args, cfg, ds_train, ds_val, writer, exp_dir: str,
                     vgg_params, device: torch.device) -> int:
    """The loops of the pipelines without point textures
    (``read_tpu/train.py:328-523``): ``pix2pix``, the UNet alone on raw
    rendered ``colors`` (one state for all scenes); ``rgb_texture``, an
    RGB mesh texture per scene, no net (with ``--use-mesh`` and the
    scene's faces through the triangle raster). Each epoch runs the
    scenes one after another (at most ``--max-steps-per-epoch`` steps,
    counted over the epoch as ``read_tpu`` counts them), then the val
    views at full frame for their PSNR, whose negative drives the
    plateau decay; ``ckpt_<pipeline>_<scene>_<epoch>`` is saved every
    ``--save-freq`` epochs and on a better val PSNR (the newest 3 kept),
    ``best_<pipeline>_<scene>`` on a better one; ``--resume`` loads a
    scene's checkpoint dir or the newest under the given root. The
    experiment's ``history.json`` holds each epoch's train loss, val
    PSNR, lr scale and step wall times."""
    from read_tpu_torch.criterions import losses as L
    from read_tpu_torch.data.dataset import BatchIterator, PrefetchIterator
    from read_tpu_torch.ops import rasterize as R
    from read_tpu_torch.ops import render_modes as RM
    from read_tpu_torch.pipelines import pix2pix_pipeline as P2P
    from read_tpu_torch.pipelines import rgb_texture_pipeline as RGB
    from read_tpu_torch.pipelines import texture_pipeline as TP
    from read_tpu_torch.scene.io import mesh_inputs
    from read_tpu_torch.utils import ckpt as CK
    from read_tpu_torch.utils import fp32
    from read_tpu_torch.utils.perform import AccumDict

    def to_dev(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    ckpt_root = os.path.join(exp_dir, "checkpoints")
    scene_pc = {ds.id: ds.scene_data["pointcloud"] for ds in ds_train}
    xyz_dev = {sid: to_dev(np.asarray(pc["xyz"], np.float32))
               for sid, pc in scene_pc.items()}
    pix2pix = args.pipeline == "pix2pix"
    if pix2pix:
        state, net = P2P.create_pix2pix_state(
            torch.Generator().manual_seed(args.seed), cfg, in_channels=3,
            device=device)
        rgb = {sid: to_dev(np.asarray(pc["rgb"], np.float32))
               for sid, pc in scene_pc.items()}
        steps = {sid: P2P.make_pix2pix_step(net, cfg, vgg_params,
                                            {"rgb": rgb[sid]},
                                            mode="colors")
                 for sid in scene_pc}

        @torch.no_grad()
        def eval_image(sid, total_m, shape):
            with fp32.full_f32():
                levels = R.rasterize_pyramid_pooled(xyz_dev[sid], total_m,
                                                    shape, cfg.num_scales)
                pyr = [RM.gather_attribute(rgb[sid], ix) for ix, _ in levels]
                out = torch.func.functional_call(
                    net, {**state.params, **state.batch_stats}, tuple(pyr),
                    {"train": False, "operands": cfg.operands})
                return out["im_out"]

        def to_flat(sid):
            return P2P.flat_from_pix2pix_state(state)
    else:
        h, w = cfg.crop_size
        states, steps, mesh = {}, {}, {}
        for ds in ds_train:
            states[ds.id] = RGB.create_rgb_texture_state(args.texture_size,
                                                         device=device)
            uv2d, faces = mesh_inputs(ds.scene_data)
            mesh[ds.id] = (to_dev(uv2d), to_dev(faces) if args.use_mesh
                           and faces is not None else None)
            steps[ds.id] = RGB.make_rgb_texture_step(
                args.texture_lr, {"uv2d": mesh[ds.id][0]}, h, w,
                reg_weight=args.reg_weight, faces=mesh[ds.id][1])

        @torch.no_grad()
        def eval_image(sid, total_m, shape):
            with fp32.full_f32():
                uv_map, mask = RGB.uv_and_mask(xyz_dev[sid], total_m,
                                               mesh[sid][0], *shape,
                                               mesh[sid][1])
                return RGB.rgb_texture_forward(states[sid].tables, uv_map,
                                               mask)

        def to_flat(sid):
            return RGB.flat_from_rgb_state(states[sid])

    if args.resume:
        for ds in ds_train:
            cand = args.resume
            if not os.path.exists(os.path.join(cand, "state.npz")):
                cand = CK.latest_checkpoint(
                    args.resume, f"ckpt_{args.pipeline}_{ds.name}") or \
                    os.path.join(args.resume,
                                 f"best_{args.pipeline}_{ds.name}")
            flat, _ = CK.load_checkpoint(cand)
            if pix2pix:
                restored = P2P.pix2pix_state_from_flat(flat, device)
                if _shapes(restored.layout) != _shapes(state.layout):
                    raise SystemExit(f"--resume {cand}: the checkpoint's "
                                     "net does not match the configured "
                                     "one")
                state = restored
            else:
                restored = RGB.rgb_state_from_flat(flat, device)
                if _texture_shapes(restored.tables) != \
                        _texture_shapes(states[ds.id].tables):
                    raise SystemExit(f"--resume {cand}: the checkpoint's "
                                     "tables do not match --texture-size")
                states[ds.id] = restored
            print(f"resumed {ds.name} from {cand} (step {restored.step})")
            if pix2pix:
                break   # one shared state

    sched = TP.ReduceLROnPlateau(factor=args.plateau_factor,
                                 patience=args.plateau_patience)
    best_val = float("inf")
    history = []
    for epoch in range(args.epochs):
        acc = AccumDict()
        step_count = 0
        step_ms = []
        for ds in ds_train:
            it = PrefetchIterator(BatchIterator(
                ds, args.batch_size, shuffle=True,
                seed=args.seed + epoch), depth=2)
            t_ask = time.perf_counter()
            for batch in it:
                dev_batch = {"total_m": to_dev(batch["total_m"]),
                             "target": to_dev(batch["target"])}
                if pix2pix:
                    state, metrics = steps[ds.id](state, xyz_dev[ds.id],
                                                  dev_batch)
                else:
                    states[ds.id], metrics = steps[ds.id](
                        states[ds.id], xyz_dev[ds.id], dev_batch)
                acc.update({k: float(v) for k, v in metrics.items()})
                t_done = time.perf_counter()
                step_ms.append((t_done - t_ask) * 1e3)
                t_ask = t_done
                step_count += 1
                if step_count % args.log_freq == 0:
                    print(f"epoch {epoch} it {step_count}: {acc}")
                if args.max_steps_per_epoch and \
                        step_count >= args.max_steps_per_epoch:
                    break
        # val: full-frame PSNR
        vacc = AccumDict()
        t0 = time.perf_counter()
        for ds in ds_val:
            for i in range(len(ds.view_list)):
                item = ds[i]
                shape = tuple(item["target"].shape[:2])
                img = eval_image(ds.id, to_dev(item["total_m"][None]), shape)
                vacc.update({"psnr": float(L.psnr(
                    img[0], to_dev(item["target"])))})
        val_s = time.perf_counter() - t0
        val_psnr = vacc.mean("psnr") if vacc["psnr"] else 0.0
        val_loss = -val_psnr
        scale = sched.step(val_loss)
        lr = torch.tensor(scale, dtype=torch.float32, device=device)
        if pix2pix:
            state = state.replace(lr_scale=lr)
        else:
            for sid in states:
                states[sid] = states[sid].replace(lr_scale=lr)
        train_loss = acc.mean("loss") if acc["loss"] else float("inf")
        print(f"epoch {epoch}: train {train_loss:.5f} val psnr "
              f"{val_psnr:.2f} lr_scale {scale:.4f}")
        steady = step_ms[2:] or step_ms
        n_val = len(vacc["psnr"])
        if steady:
            print(f"epoch {epoch} timing: {len(step_ms)} steps, "
                  f"{np.mean(steady):.2f} ms/step after the first 2; val "
                  f"{n_val} views, {1e3 * val_s / max(n_val, 1):.2f} "
                  "ms/view")
        history.append({"epoch": epoch, "train_loss": train_loss,
                        "val_psnr": val_psnr, "lr_scale": scale,
                        "step_ms": step_ms, "val_seconds": val_s})
        with open(os.path.join(exp_dir, "history.json"), "w") as f:
            json.dump(history, f, indent=1)
        if writer:
            writer.add_scalar("train/loss", train_loss, epoch)
            writer.add_scalar("val/psnr", val_psnr, epoch)
            writer.add_scalar("lr_scale", scale, epoch)
        if val_loss < best_val or epoch % args.save_freq == 0:
            for ds in ds_train:
                flat = to_flat(ds.id)
                extra = {"epoch": epoch, "val_psnr": val_psnr}
                CK.save_checkpoint(
                    os.path.join(ckpt_root, f"ckpt_{args.pipeline}_"
                                 f"{ds.name}_{epoch}"),
                    flat, config=config_dict(args), extra=extra)
                CK.rotate_checkpoints(
                    ckpt_root, f"ckpt_{args.pipeline}_{ds.name}", keep=3)
                if val_loss < best_val:
                    CK.save_checkpoint(
                        os.path.join(ckpt_root,
                                     f"best_{args.pipeline}_{ds.name}"),
                        flat, config=config_dict(args), extra=extra)
            best_val = min(best_val, val_loss)
    print(f"done; best val psnr {-best_val:.2f}")
    return 0


def main(argv=None) -> int:
    args = load_args(argv)
    device = _device(args)
    shape = _mesh_shape(args)
    streams = sys.stdout, sys.stderr
    exp_dir = setup_experiment(args)
    try:
        if shape is not None:
            return _launch_mesh(args, exp_dir, device, shape)
        return _run(args, exp_dir, device)
    finally:
        tees = sys.stdout, sys.stderr
        sys.stdout, sys.stderr = streams
        for tee in tees:
            tee.close()


def _launch_mesh(args, exp_dir: str, device: torch.device, shape) -> int:
    """``--mesh``: ``read_tpu.train``'s rules, then the ranks. The other
    pipelines run here as without ``--mesh``."""
    from read_tpu_torch.parallel import launch
    from read_tpu_torch.pipelines import texture_pipeline as TP

    n_data, n_points = shape
    print(f"mesh: data={n_data} x points={n_points} over "
          f"{n_data * n_points} ranks")
    try:
        cfg = TP.config_from_dict(vars(args),
                                  crop_size=parse_size(args.crop_size),
                                  train_dataset_args=args.train_dataset_args)
    except ValueError as e:
        raise SystemExit(str(e))
    if cfg.use_mesh:
        print("mesh + use_mesh: replicated 2D tables, sharded uv2d "
              "(point-splat uv variant; triangle faces ignored)")
    if args.pipeline != "texture":
        return _run(args, exp_dir, device)
    if args.max_scenes_hbm is not None:
        raise SystemExit("--max-scenes-hbm is not supported with --mesh "
                         "(sharded tables are already the large-scene "
                         "path); drop one of the flags")
    if args.freeze_net:
        raise SystemExit("--freeze-net is not supported with --mesh "
                         "(texture-only fitting is a single-chip "
                         "workflow; drop one of the flags)")
    ignored = [name for name, on in (
        ("drop_points", cfg.drop_points > 0),
        ("perturb_points", cfg.perturb_points > 0),
        ("supersampling", cfg.supersampling > 1),
        ("z-scaled point sizes ('ps' input formats)",
         cfg.relative_point_size),
        ("temporal_average", cfg.temporal_average)) if on]
    if ignored:
        print("WARNING: the sharded step (as read_tpu's) does not apply "
              + ", ".join(ignored) + " under --mesh")
    launch.spawn(_mesh_rank, n_data * n_points, device.type,
                 args=(args, exp_dir, shape, TP.UNet),
                 timeout_s=MESH_TIMEOUT_S)
    return 0


def _mesh_rank(rank: int, world: int, device: torch.device, args,
               exp_dir: str, shape, unet) -> None:
    """One rank of a ``--mesh`` run: ``_run`` on this rank's part of the
    mesh. Rank 0 writes to the console and ``log.txt``; the others are
    silent but for errors. ``unet`` is the launching process's
    ``texture_pipeline.UNet`` (the class, or a caller's narrowed factory,
    pickled by reference with its arguments): every rank builds the net
    that process would build."""
    from read_tpu_torch.parallel import sharded as SH
    from read_tpu_torch.pipelines import texture_pipeline as TP
    from read_tpu_torch.utils.perform import Tee

    TP.UNet = unet
    streams = sys.stdout, sys.stderr
    if rank == 0:
        sys.stdout = Tee(os.path.join(exp_dir, "log.txt"), sys.__stdout__)
        sys.stderr = Tee(os.path.join(exp_dir, "log.txt"), sys.__stderr__)
    else:
        sys.stdout = open(os.devnull, "w")
    try:
        mesh = SH.make_mesh(*shape, device)
        print(f"mesh rank {rank} of {world} on {device}: backend "
              f"{mesh.backend}")
        rc = _run(args, exp_dir, device, mesh)
    finally:
        mine = sys.stdout, sys.stderr
        sys.stdout, sys.stderr = streams
        for stream in set(mine) - set(streams):
            stream.close()
    if rc:
        raise RuntimeError(f"rank {rank}: exit code {rc}")


def _run(args, exp_dir: str, device: torch.device, mesh=None) -> int:
    """The texture pipeline's loop (and the others'); with ``mesh`` (a
    ``parallel.sharded.Mesh``) this rank's part of a sharded run. Rank 0
    (or the one process) writes tensorboard scalars when
    ``tensorboardX`` is installed, closing the writer at the end."""
    writer = None
    if mesh is None or mesh.rank == 0:
        try:
            from tensorboardX import SummaryWriter
            writer = SummaryWriter(exp_dir, flush_secs=10)
        except Exception:
            pass
    try:
        return _train(args, exp_dir, device, writer, mesh)
    finally:
        if writer is not None:
            writer.close()


def _train(args, exp_dir: str, device: torch.device, writer, mesh) -> int:
    from read_tpu_torch.criterions import vgg as V
    from read_tpu_torch.data.dataset import BatchIterator, PrefetchIterator
    from read_tpu_torch.data.scenes import get_datasets
    from read_tpu_torch.ops import render_modes as RM
    from read_tpu_torch.pipelines import texture_pipeline as TP
    from read_tpu_torch.scene.io import mesh_inputs
    from read_tpu_torch.utils import ckpt as CK
    from read_tpu_torch.utils import convert as CV
    from read_tpu_torch.utils.perform import AccumDict

    lead = mesh is None or mesh.rank == 0   # writes logs, images, files
    if mesh is not None:
        from read_tpu_torch.parallel import sharded as SH
    print(f"experiment dir: {exp_dir}")
    print(f"devices: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                  if device.type == "cuda" else ""))

    h, w = parse_size(args.crop_size)
    try:
        cfg = TP.config_from_dict(
            vars(args), crop_size=(h, w),
            train_dataset_args=args.train_dataset_args)
    except ValueError as e:
        raise SystemExit(str(e))

    ds_train, ds_val, texture_ckpts = get_datasets(args)
    for tr, va in zip(ds_train, ds_val):
        print(f"scene {tr.name}: {tr.n_points} points, "
              f"{len(tr.view_list)} train views, "
              f"{len(va.view_list)} val views")
    # split lists saved for reproducibility
    if lead:
        with open(os.path.join(exp_dir, "splits.json"), "w") as f:
            json.dump({tr.name: {"train": tr.target_list,
                                 "val": va.target_list}
                       for tr, va in zip(ds_train, ds_val)}, f, indent=1)

    vgg_params = None
    if cfg.vgg_ratio:
        if cfg.vgg_ensemble and not args.vgg_weights:
            vgg_params = [V.random_vgg_params(
                torch.Generator().manual_seed(seed), device)
                for seed in range(cfg.vgg_ensemble)]
            print(f"criterion vgg_ens: averaging {cfg.vgg_ensemble} "
                  "seeded-random VGG feature sets")
        else:
            if args.vgg_weights and os.path.exists(args.vgg_weights):
                vgg_params = V.load_vgg_params(args.vgg_weights, device)
            else:
                vgg_params = V.random_vgg_params(
                    torch.Generator().manual_seed(0), device)
                print("WARNING: no --vgg-weights; using seeded random VGG "
                      "features")
            if cfg.vgg_ensemble:
                # weights given: vgg_ens is a 1-ensemble
                vgg_params = [vgg_params]

    if args.pipeline != "texture":
        return run_alt_pipeline(args, cfg, ds_train, ds_val, writer, exp_dir,
                                vgg_params, device)

    # per-scene states sharing one net; with --max-scenes-hbm only that
    # many scenes' texture tables stay on the device
    gen = torch.Generator().manual_seed(args.seed)
    states = SceneStateStore(budget=args.max_scenes_hbm, device=device)
    shared = net = None
    for tr, tex_ckpt in zip(ds_train, texture_ckpts):
        if shared is None:
            shared, net = TP.create_state(
                gen, cfg, n_points=tr.n_points,
                texture_init=args.texture_init, device=device)
            st = shared
        else:   # one net: scene 0's, with this scene's own texture
            tex = TP.init_texture(cfg, tr.n_points, args.texture_init, gen,
                                  device)
            st = shared.replace(texture=tex, tex_opt=TP.RmsState(
                tuple(torch.zeros_like(t) for t in tex)))
        if tex_ckpt:
            flat, _ = CK.load_checkpoint(tex_ckpt)
            st = st.replace(texture=CV.texture_from_flat(flat, "texture",
                                                         device))
        states[tr.id] = st
    if args.net_ckpt:
        flat, _ = CK.load_checkpoint(args.net_ckpt)
        params = TP._subtree(flat, "params/", device)
        if set(params) != set(shared.layout.names):
            raise SystemExit(f"--net-ckpt {args.net_ckpt}: its parameters "
                             "do not match the configured net")
        flat_params = shared.layout.flatten(params)
        bs = TP._subtree(flat, "batch_stats/", device)
        for sid in states:
            states[sid] = states[sid].replace(flat_params=flat_params,
                                              batch_stats=bs)
        print(f"loaded net ckpt {args.net_ckpt}")

    if args.resume:
        # whole states: params, textures, both optimizers, step. One dir
        # per scene: --resume names one scene's dir or checkpoints/.
        for ds in ds_train:
            cand = args.resume
            if not os.path.exists(os.path.join(cand, "state.npz")):
                cand = CK.latest_checkpoint(args.resume,
                                            f"ckpt_{ds.name}") or \
                    os.path.join(args.resume, f"best_{ds.name}")
            flat, _ = CK.load_checkpoint(cand)
            restored = TP.state_from_flat(flat, device)
            want = states[ds.id]
            if _shapes(restored.layout) != _shapes(want.layout) or \
                    _texture_shapes(restored.texture) != \
                    _texture_shapes(want.texture):
                raise SystemExit(f"--resume {cand}: the checkpoint's net "
                                 "or texture does not match the "
                                 "configured one")
            states[ds.id] = restored
            print(f"resumed {ds.name} from {cand} (step {restored.step})")

    if args.freeze_net and not (args.net_ckpt or args.resume):
        print("WARNING: --freeze-net without --net-ckpt/--resume freezes "
              "RANDOM net weights")
    if mesh is None:
        train_step = TP.make_train_step(net, cfg, vgg_params,
                                        freeze_net=args.freeze_net,
                                        return_images=True)
    else:
        # this rank's part: the point table and its RMS moment padded to
        # P rows and sharded over the points ranks
        for ds in ds_train:
            states[ds.id] = SH.prepare_scene_state(mesh, states[ds.id])
        sharded_step = SH.make_sharded_train_step(net, cfg, vgg_params, mesh)
    eval_step = TP.make_eval_step(net, cfg, vgg_params)
    sched = TP.ReduceLROnPlateau(factor=args.plateau_factor,
                                 patience=args.plateau_patience)

    scene_by_id = {ds.id: ds for ds in ds_train}

    def scene_xyz(ds, whole: bool = False) -> torch.Tensor:
        """The scene's points on the device; under ``--mesh`` this
        rank's shard, unless ``whole`` (validation)."""
        xyz = torch.from_numpy(np.asarray(
            ds.scene_data["pointcloud"]["xyz"], np.float32)).to(device)
        return xyz if mesh is None or whole else SH.shard_points(mesh, xyz)

    def to_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    psize_cache: Dict[int, Optional[torch.Tensor]] = {}
    pc_cache: Dict[int, Dict[str, torch.Tensor]] = {}
    mesh_cache: Dict[int, Dict[str, torch.Tensor]] = {}
    extra = {m for g in cfg.extra_modes for m in g}
    view_dependent = bool(extra & set(RM.VIEW_DEPENDENT))

    def point_attrs(sid: int) -> Dict[str, torch.Tensor]:
        """The point attributes the extra modes read, on the device once
        a scene (``read_tpu``'s ``pc_cache``)."""
        if sid not in pc_cache:
            pc = scene_by_id[sid].scene_data["pointcloud"]
            pc_cache[sid] = {a: to_dev(np.asarray(pc[a], np.float32))
                             for a in RM.point_attributes(extra)
                             if pc.get(a) is not None}
        return pc_cache[sid]

    sharded_pc: Dict[int, Dict[str, torch.Tensor]] = {}

    def sharded_attrs(sid: int) -> Dict[str, torch.Tensor]:
        """Under ``--mesh``: this rank's rows of the point attributes the
        extra modes read, and of ``uv2d`` with ``--use-mesh``."""
        if sid not in sharded_pc:
            attrs = dict(point_attrs(sid)) if extra else {}
            if cfg.use_mesh:
                uv2d, faces = mesh_inputs(scene_by_id[sid].scene_data)
                attrs["uv2d"] = to_dev(uv2d)
                if faces is not None:
                    print(f"scene {sid}: triangle faces ignored under "
                          "--mesh (sharded path uses the point-splat uv "
                          "variant)")
            sharded_pc[sid] = SH.shard_pointcloud_attrs(mesh, attrs)
        return sharded_pc[sid]

    def add_scene_inputs(dev_batch: dict, sid: int, batch: dict,
                         train: bool) -> None:
        """The pyramid's inputs beyond the poses: the scene manifest's
        per-point sizes (``point_sizes``, on the device once a scene),
        and with extra modes the point attributes (``pointcloud``), the
        label image under ``label_in_input`` (training batches) and the
        camera-to-world ``view_matrix`` for ``normals_l/r/d``; with
        ``--use-mesh`` the scene's ``uv2d`` and triangle ``faces``.
        Under ``--mesh`` no sizes and no faces; a training batch's point
        attributes come apart (:func:`sharded_attrs`)."""
        if mesh is not None:
            if not train:   # the unsharded eval step, read_tpu's inputs
                if cfg.use_mesh:
                    dev_batch["uv2d"] = to_dev(
                        mesh_inputs(scene_by_id[sid].scene_data)[0])
                if extra:
                    dev_batch["pointcloud"] = point_attrs(sid)
            elif cfg.label_in_input and extra:
                dev_batch["label"] = to_dev(batch["label"])
            if view_dependent:
                dev_batch["view_matrix"] = to_dev(batch["view_matrix"])
            return
        if cfg.use_mesh:
            if sid not in mesh_cache:
                uv2d, faces = mesh_inputs(scene_by_id[sid].scene_data)
                mesh_cache[sid] = {"uv2d": to_dev(uv2d)}
                if faces is not None:
                    mesh_cache[sid]["faces"] = to_dev(faces)
            dev_batch.update(mesh_cache[sid])
        if sid not in psize_cache:
            ps = scene_by_id[sid].scene_data.get("point_sizes")
            psize_cache[sid] = None if ps is None else to_dev(
                np.asarray(ps, np.float32).reshape(-1))
        if psize_cache[sid] is not None:
            dev_batch["point_sizes"] = psize_cache[sid]
        if not extra:
            return
        dev_batch["pointcloud"] = point_attrs(sid)
        if train and cfg.label_in_input:
            dev_batch["label"] = to_dev(batch["label"])
        if view_dependent:
            dev_batch["view_matrix"] = to_dev(batch["view_matrix"])

    def dump_train_composite(k: int, im, batch, dev_batch, xyz):
        """out | target | depth (viridis) grids stacked, ``comp_{k %
        log_num_images}.png`` under ``train_imgs/``."""
        from read_tpu_torch.data import image_io
        from read_tpu_torch.ops import rasterize as R
        from read_tpu_torch.utils.colorize import colorize, label_to_color
        _, depth = R.rasterize_batch(xyz, dev_batch["total_m"],
                                     im.shape[1], im.shape[2],
                                     method=cfg.raster_method)

        def grid(rows):  # up to 4 side by side
            return np.concatenate([np.asarray(r) for r in rows[:4]], axis=1)

        comp = [grid(np.clip(im.cpu().numpy(), 0, 1)),
                grid(batch["target"]),
                grid(colorize(depth.cpu().numpy()))]
        if args.num_classes and batch.get("label") is not None:
            comp.append(grid(
                label_to_color(batch["label"]).astype(np.float32) / 255.))
        comp = np.concatenate(comp, axis=0)
        d = os.path.join(exp_dir, "train_imgs")
        os.makedirs(d, exist_ok=True)
        image_io.imwrite(
            os.path.join(d, f"comp_{k % args.log_num_images}.png"),
            (np.clip(comp, 0, 1) * 255).astype(np.uint8))

    def carry_net(dst_sid: int, src_sid: int):
        """Rebind dst's net portion to src's: one net for all scenes."""
        if dst_sid == src_sid:
            return
        s = states[src_sid]
        states[dst_sid] = states[dst_sid].replace(
            flat_params=s.flat_params, layout=s.layout,
            batch_stats=s.batch_stats, net_opt=s.net_opt,
            lr_scale=s.lr_scale)

    def run_train_epoch(epoch: int):
        """Interleaved multi-scene epoch: the scenes' batch streams are
        shuffled together so the shared net and its BatchNorm statistics
        never see one long single-scene run. With ``--max-scenes-hbm``
        the scenes run in chunks of that size (interleaved within a
        chunk), so textures swap once per chunk. Returns ``(mean loss,
        timing)``: each step's wall time, from asking for its batch to
        its metrics on the host, and the wait for the batch within it."""
        acc = AccumDict()
        ep_rng = np.random.default_rng(args.seed + 13 * epoch)

        def batches():
            its = {ds.id: iter(BatchIterator(
                ds, args.batch_size, shuffle=True,
                seed=args.seed + epoch)) for ds in ds_train}
            scene_ids = [ds.id for ds in ds_train]
            ep_rng.shuffle(scene_ids)
            chunk = args.max_scenes_hbm or len(scene_ids)
            n_slots = {ds.id: len(BatchIterator(ds, args.batch_size))
                       for ds in ds_train}
            for c0 in range(0, len(scene_ids), chunk):
                group = scene_ids[c0:c0 + chunk]
                slots = [sid for sid in group
                         for _ in range(n_slots[sid])]
                ep_rng.shuffle(slots)
                for sid in slots:
                    try:
                        yield sid, next(its[sid])
                    except StopIteration:
                        continue

        xyz_cache = {}
        step_count = 0
        last_sid = None
        timing = {"step_ms": [], "wait_ms": [], "first_step": None,
                  "first_scene": None}
        t_ask = time.perf_counter()
        for sid, batch in PrefetchIterator(batches(), depth=2):
            t_got = time.perf_counter()
            if sid not in xyz_cache:
                xyz_cache[sid] = scene_xyz(scene_by_id[sid])
                if args.max_scenes_hbm is not None:
                    # point clouds follow the texture working set
                    keep = set(states.resident_ids) | {sid}
                    for k in [k for k in xyz_cache if k not in keep]:
                        del xyz_cache[k]
            if last_sid is not None:
                carry_net(sid, last_sid)
            dev_batch = {"total_m": to_dev(batch["total_m"]),
                         "target": to_dev(batch["target"])}
            if cfg.use_mask:
                dev_batch["mask"] = to_dev(batch["mask"])
            if args.num_classes:
                dev_batch["label"] = to_dev(batch["label"])
            add_scene_inputs(dev_batch, sid, batch, train=True)
            if mesh is None:
                st, metrics, im = train_step(states.activate(sid),
                                             xyz_cache[sid], dev_batch)
            else:   # no images come back from the sharded step
                (st, metrics), im = sharded_step(
                    states[sid], xyz_cache[sid], dev_batch,
                    sharded_attrs(sid)), None
            states[sid] = st
            last_sid = sid
            acc.update({k: float(v) for k, v in metrics.items()})
            step_count += 1
            gstep = st.step
            if timing["first_step"] is None:
                timing.update(first_step=gstep,
                              first_scene=scene_by_id[sid].name)
            if step_count % args.log_freq == 0:
                print(f"epoch {epoch} it {step_count}: {acc}")
                if writer:
                    for k, v in acc.means().items():
                        writer.add_scalar(f"train/{k}", v, gstep)
                if args.log_num_images and im is not None:
                    try:
                        dump_train_composite(
                            step_count // args.log_freq - 1, im, batch,
                            dev_batch, xyz_cache[sid])
                    except Exception as e:  # never kill training on a dump
                        print(f"train composite dump failed: {e}")
            t_done = time.perf_counter()
            timing["step_ms"].append((t_done - t_ask) * 1e3)
            timing["wait_ms"].append((t_got - t_ask) * 1e3)
            t_ask = t_done
            if args.max_steps_per_epoch and \
                    step_count >= args.max_steps_per_epoch:
                break
        # propagate the final net to every scene state
        if last_sid is not None:
            for ds in ds_train:
                carry_net(ds.id, last_sid)
        loss = acc.mean("loss") if acc["loss"] else float("inf")
        return loss, timing

    def run_val_epoch(epoch: int, dump_dir: Optional[str] = None):
        """Validation epoch: views batched (``--batch-size-val``) at the
        full /16-aligned frame, the tail batch padded to the same shape,
        the host preparing the next batch while the device runs this
        one; the metrics stay on the device until one copy at the end.
        Returns ``(mean loss, AccumDict, per-view metrics, timing)``."""
        t0 = time.perf_counter()
        acc = AccumDict()
        n_dumped, n_batches = 0, 0
        pending = []  # (scene, file names, device metric dicts)
        for ds in ds_val:
            if not len(ds.view_list):
                continue
            st = eval_state(ds.id)
            if not lead:
                continue
            xyz = scene_xyz(ds, whole=True)
            bs = max(1, args.batch_size_val)

            def val_batches(ds=ds, bs=bs):
                n = len(ds.view_list)
                for i0 in range(0, n, bs):
                    items = [ds[i] for i in range(i0, min(i0 + bs, n))]
                    npad = bs - len(items)
                    b = {k: np.stack([it[k] for it in items] +
                                     [items[-1][k]] * npad)
                         for k in ("total_m", "target", "mask",
                                   "view_matrix")}
                    b["filenames"] = [it["target_filename"]
                                      for it in items]
                    yield b

            for batch in PrefetchIterator(val_batches(), depth=2):
                names = batch.pop("filenames")
                dev_batch = {"total_m": to_dev(batch["total_m"]),
                             "target": to_dev(batch["target"])}
                if cfg.use_mask:
                    dev_batch["mask"] = to_dev(batch["mask"])
                add_scene_inputs(dev_batch, ds.id, batch, train=False)
                img, metrics = eval_step(st, xyz, dev_batch)
                n_batches += 1
                # per-item [B] metrics; the padded tail is dropped below
                pending.append((ds.name, names, metrics))
                if writer and n_dumped == 0:
                    grid = np.concatenate(
                        [np.clip(img[0].cpu().numpy(), 0, 1),
                         batch["target"][0]], axis=1)
                    writer.add_image(f"val/{ds.name}",
                                     grid.transpose(2, 0, 1), epoch)
                if dump_dir and n_dumped < args.log_num_images * 8:
                    from read_tpu_torch.data import image_io
                    os.makedirs(dump_dir, exist_ok=True)
                    for j in range(min(len(names),
                                       args.log_num_images * 8
                                       - n_dumped)):
                        base = os.path.splitext(
                            os.path.basename(names[j]))[0]
                        out = np.clip(img[j].cpu().numpy(), 0, 1)
                        image_io.imwrite(
                            os.path.join(dump_dir,
                                         f"{ds.name}_{base}.png"),
                            (out * 255).astype(np.uint8))
                        n_dumped += 1
        views = []
        if pending:
            # one device -> host copy for the whole epoch's metrics
            keys = list(pending[0][2])
            host = torch.cat([m[k].reshape(-1).float() for _, _, m in pending
                              for k in keys]).cpu().numpy()
            pos = 0
            for name, names, m in pending:
                b = m[keys[0]].numel()
                vals = host[pos:pos + b * len(keys)].reshape(len(keys), b)
                pos += b * len(keys)
                for j, fname in enumerate(names):
                    row = {k: float(vals[i, j]) for i, k in enumerate(keys)}
                    acc.update(row)
                    views.append({"scene": name, "target": fname, **row})
        timing = {"views": len(views), "batches": n_batches,
                  "seconds": time.perf_counter() - t0}
        loss = acc.mean("loss") if acc["loss"] else float("inf")
        if mesh is not None:
            # rank 0's loss and PSNR to every rank, for the schedule
            psnr = acc.mean("psnr") if acc["psnr"] else float("nan")
            got = mesh.all_reduce(torch.tensor(
                [loss, psnr] if lead else [0.0, 0.0], dtype=torch.float64,
                device=device))
            loss, psnr = (float(v) for v in got)
            if not lead:
                acc = AccumDict()
                acc.update({"loss": loss, "psnr": psnr}
                           if np.isfinite(psnr) else {"loss": loss})
        return loss, acc, views, timing

    def eval_state(sid: int):
        """The state the unsharded eval step and the checkpoints take:
        under ``--mesh`` gathered and stripped of the texture padding on
        rank 0 (None on the others; the ranks of data block 0 must all
        ask), else the scene's with its tables on the device."""
        if mesh is None:
            return states.activate(sid)
        return SH.unshard_state(mesh, states[sid], scene_by_id[sid].n_points)

    ckpt_root = os.path.join(exp_dir, "checkpoints")
    history = []

    def write_history():
        if lead:
            with open(os.path.join(exp_dir, "history.json"), "w") as f:
                json.dump(history, f, indent=1)

    if args.eval:
        dump = args.eval_dir or os.path.join(exp_dir, "eval")
        val_loss, acc, views, vt = run_val_epoch(0, dump_dir=dump)
        print(f"VAL LOSS {val_loss:.5f}  {acc}")
        history.append({"eval": True, "val_loss": val_loss,
                        "val": acc.means(), "views": views,
                        "val_timing": vt})
        write_history()
        return 0

    best_val = float("inf")
    for epoch in range(args.epochs):
        t0 = time.time()
        train_loss, tt = run_train_epoch(epoch)
        val_loss, vacc, views, vt = run_val_epoch(
            epoch, dump_dir=os.path.join(exp_dir, "val_imgs")
            if epoch % args.save_freq == 0 else None)
        sched_metric = val_loss if args.plateau_metric == "loss" \
            else -vacc.mean("psnr")
        scale = sched.step(sched_metric)
        lr = torch.tensor(scale, dtype=torch.float32, device=device)
        for sid in states:
            states[sid] = states[sid].replace(lr_scale=lr)
        print(f"epoch {epoch}: train {train_loss:.5f} val {val_loss:.5f} "
              f"lr_scale {scale:.4f} ({time.time()-t0:.0f}s)  {vacc}")
        steady = tt["step_ms"][2:] or tt["step_ms"]
        wait = tt["wait_ms"][len(tt["wait_ms"]) - len(steady):]
        if steady:
            print(f"epoch {epoch} timing: {len(tt['step_ms'])} steps, "
                  f"{np.mean(steady):.2f} ms/step after the first 2, "
                  f"{100 * sum(wait) / sum(steady):.1f}% of it waiting "
                  f"for data; val {vt['views']} views, "
                  f"{1e3 * vt['seconds'] / max(vt['views'], 1):.2f} "
                  "ms/view")
        history.append({"epoch": epoch, "train_loss": train_loss,
                        "val_loss": val_loss, "val": vacc.means(),
                        "lr_scale": scale, "train_timing": tt,
                        "val_timing": vt, "seconds": time.time() - t0})
        write_history()
        if writer:
            writer.add_scalar("val/loss", val_loss, epoch)
            for k, v in vacc.means().items():
                writer.add_scalar(f"val/{k}", v, epoch)
            writer.add_scalar("lr_scale", scale, epoch)

        # checkpoints are saved unsharded (read_tpu's rule), by rank 0
        if epoch % args.save_freq == 0 or sched_metric < best_val:
            for ds in ds_train:
                st = eval_state(ds.id)
                if not lead:
                    continue
                CK.save_checkpoint(
                    os.path.join(ckpt_root, f"ckpt_{ds.name}_{epoch}"),
                    TP.flat_from_state(st), config=config_dict(args),
                    extra={"epoch": epoch, "val_loss": val_loss})
                CK.rotate_checkpoints(ckpt_root, f"ckpt_{ds.name}", keep=3)
            if sched_metric < best_val:
                best_val = sched_metric
                for ds in ds_train:
                    st = eval_state(ds.id)
                    if lead:
                        CK.save_checkpoint(
                            os.path.join(ckpt_root, f"best_{ds.name}"),
                            TP.flat_from_state(st),
                            config=config_dict(args),
                            extra={"epoch": epoch, "val_loss": val_loss,
                                   "val_psnr": vacc.mean("psnr")})
    print(f"done; best val loss {best_val:.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
