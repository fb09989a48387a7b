"""Training orchestrator CLI on PyTorch (CUDA kernels on a GPU).

Usage::

    python -m read_tpu_torch.train --config configs/demo_drive.yaml \\
        [--crop-size 256x256] [--epochs 100] ...

Counterpart of ``read_tpu/train.py`` for ``--pipeline texture``: the
same flags and defaults (``build_argparser``), an experiment config
that sets defaults which the command line overrides (``load_args``), an
experiment directory with ``args.yaml``, a ``log.txt`` copy of the
console and ``splits.json`` (``setup_experiment``), and ``main``:

- one state per scene, all sharing one net (``--net-ckpt`` loads it);
  splatted input formats (``uv_1d_p3...``, ``uv_1d_ps...``) and a
  scene manifest's per-point ``point_sizes`` go to every step's
  z-buffer;
  ``--resume`` restores whole states (net, textures, both optimizers,
  step) from ``read_tpu``-format checkpoints; ``--freeze-net`` fits the
  textures alone;
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
- every ``--log-freq`` steps a train composite (output | target |
  depth) under ``train_imgs/``, and tensorboard scalars when
  ``tensorboardX`` is installed.

Beyond ``read_tpu``'s outputs the experiment directory holds
``history.json``: per epoch the losses, each train step's wall time and
the part of it spent waiting for the next batch, and the val time.

The CLI runs on the CUDA device; ``--headless-platform cpu`` runs it on
the CPU with the kernels' plain twins (the tests do). Without a CUDA
device and without that flag it exits with an error. It needs none of
PyYAML, ``cv2``, ``imageio``, ``matplotlib`` or ``tensorboardX``:
configs may be JSON (:mod:`read_tpu_torch.utils.config_io`), images PNG
(:mod:`read_tpu_torch.data.image_io`). What the port does not have yet
(``--pipeline pix2pix|rgb_texture``, ``--mesh``, ``--use-mesh``,
``--dtype bfloat16``, extra modes, supersampling, point dropout) exits
with the ``ROADMAP.md`` item that will bring it.
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
           "setup_experiment", "config_dict", "SceneStateStore", "main"]


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
                   choices=["texture", "pix2pix", "rgb_texture"],
                   help="only 'texture' is ported")
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
                        "huber_only no VGG (vgg_ens is not ported)")
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
                   help="bfloat16 training is not ported")
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
                   help="z-buffer: 'sort' exact (K5), 'pallas'/'scatter1' "
                        "packed key (K1); recorded in checkpoints")
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
                   help="multi-device mesh 'DATAxPOINTS' (not ported)")
    p.add_argument("--masked-background", dest="masked_background",
                   action="store_true",
                   help="renormalize loss by mask mean + pull background "
                        "to black")
    p.add_argument("--use-mesh", dest="use_mesh", action="store_true",
                   help="mesh textures (not ported)")
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


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``: pinned when ``t`` is on a CUDA device."""
    if t.is_cuda:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t)
    return t.clone()


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
            st = st.replace(
                texture=st.texture.to(self.device, non_blocking=True),
                tex_opt=RmsState(st.tex_opt.nu.to(self.device,
                                                  non_blocking=True)))
            self._states[sid] = st
            del self._host[sid]
        self._evict()
        return st


def _shapes(layout) -> dict:
    return dict(zip(layout.names, layout.shapes))


def _refuse_unported(args) -> None:
    """Exit, naming the ``ROADMAP.md`` item, for what is not ported."""
    if args.pipeline != "texture":
        raise SystemExit(f"--pipeline {args.pipeline} is not ported to "
                         "read_tpu_torch (ROADMAP queue 1, item 10)")
    if args.mesh:
        raise SystemExit("--mesh (multi-device training) is not ported to "
                         "read_tpu_torch (ROADMAP queue 1, item 12)")
    if args.use_mesh:
        raise SystemExit("--use-mesh (mesh textures) is not ported to "
                         "read_tpu_torch (ROADMAP queue 1, item 9)")
    if args.dtype != "float32":
        raise SystemExit("--dtype bfloat16 (bfloat16 training) is not "
                         "ported to read_tpu_torch (ROADMAP queue 1, "
                         "item 8)")


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


def main(argv=None) -> int:
    args = load_args(argv)
    _refuse_unported(args)
    device = _device(args)
    streams = sys.stdout, sys.stderr
    exp_dir = setup_experiment(args)
    try:
        return _run(args, exp_dir, device)
    finally:
        tees = sys.stdout, sys.stderr
        sys.stdout, sys.stderr = streams
        for tee in tees:
            tee.close()


def _run(args, exp_dir: str, device: torch.device) -> int:
    from read_tpu_torch.criterions import vgg as V
    from read_tpu_torch.data.dataset import BatchIterator, PrefetchIterator
    from read_tpu_torch.data.scenes import get_datasets
    from read_tpu_torch.models import texture as T
    from read_tpu_torch.pipelines import texture_pipeline as TP
    from read_tpu_torch.utils import ckpt as CK
    from read_tpu_torch.utils.perform import AccumDict

    print(f"experiment dir: {exp_dir}")
    print(f"devices: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                  if device.type == "cuda" else ""))

    try:
        from tensorboardX import SummaryWriter
        writer = SummaryWriter(exp_dir, flush_secs=10)
    except Exception:
        writer = None

    h, w = parse_size(args.crop_size)
    try:
        cfg = TP.config_from_dict(
            vars(args), crop_size=(h, w),
            train_dataset_args=args.train_dataset_args)
        TP._check_trainable(cfg)
    except (ValueError, NotImplementedError) as e:
        raise SystemExit(str(e))

    ds_train, ds_val, texture_ckpts = get_datasets(args)
    for tr, va in zip(ds_train, ds_val):
        print(f"scene {tr.name}: {tr.n_points} points, "
              f"{len(tr.view_list)} train views, "
              f"{len(va.view_list)} val views")
    # split lists saved for reproducibility
    with open(os.path.join(exp_dir, "splits.json"), "w") as f:
        json.dump({tr.name: {"train": tr.target_list,
                             "val": va.target_list}
                   for tr, va in zip(ds_train, ds_val)}, f, indent=1)

    vgg_params = None
    if cfg.vgg_ratio:
        if args.vgg_weights and os.path.exists(args.vgg_weights):
            vgg_params = V.load_vgg_params(args.vgg_weights, device)
        else:
            vgg_params = V.random_vgg_params(torch.Generator().manual_seed(0),
                                             device)
            print("WARNING: no --vgg-weights; using seeded random VGG "
                  "features")

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
            tex = T.init_point_texture(tr.n_points, cfg.descriptor_size,
                                       args.texture_init,
                                       generator=gen).to(device)
            st = shared.replace(texture=tex,
                                tex_opt=TP.RmsState(torch.zeros_like(tex)))
        if tex_ckpt:
            flat, _ = CK.load_checkpoint(tex_ckpt)
            st = st.replace(texture=torch.from_numpy(
                np.array(flat["texture"], np.float32)).to(device))
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
                    restored.texture.shape != want.texture.shape:
                raise SystemExit(f"--resume {cand}: the checkpoint's net "
                                 "or texture does not match the "
                                 "configured one")
            states[ds.id] = restored
            print(f"resumed {ds.name} from {cand} (step {restored.step})")

    if args.freeze_net and not (args.net_ckpt or args.resume):
        print("WARNING: --freeze-net without --net-ckpt/--resume freezes "
              "RANDOM net weights")
    train_step = TP.make_train_step(net, cfg, vgg_params,
                                    freeze_net=args.freeze_net,
                                    return_images=True)
    eval_step = TP.make_eval_step(net, cfg, vgg_params)
    sched = TP.ReduceLROnPlateau(factor=args.plateau_factor,
                                 patience=args.plateau_patience)

    scene_by_id = {ds.id: ds for ds in ds_train}

    def scene_xyz(ds) -> torch.Tensor:
        return torch.from_numpy(np.asarray(
            ds.scene_data["pointcloud"]["xyz"], np.float32)).to(device)

    def to_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    psize_cache: Dict[int, Optional[torch.Tensor]] = {}

    def add_point_sizes(dev_batch: dict, sid: int) -> None:
        """The scene manifest's per-point sizes (``point_sizes`` key),
        on the device once a scene, into the batch where there are
        any."""
        if sid not in psize_cache:
            ps = scene_by_id[sid].scene_data.get("point_sizes")
            psize_cache[sid] = None if ps is None else to_dev(
                np.asarray(ps, np.float32).reshape(-1))
        if psize_cache[sid] is not None:
            dev_batch["point_sizes"] = psize_cache[sid]

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
            add_point_sizes(dev_batch, sid)
            st, metrics, im = train_step(states.activate(sid),
                                         xyz_cache[sid], dev_batch)
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
                if args.log_num_images:
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
            xyz = scene_xyz(ds)
            st = states.activate(ds.id)
            bs = max(1, args.batch_size_val)

            def val_batches(ds=ds, bs=bs):
                n = len(ds.view_list)
                for i0 in range(0, n, bs):
                    items = [ds[i] for i in range(i0, min(i0 + bs, n))]
                    npad = bs - len(items)
                    b = {k: np.stack([it[k] for it in items] +
                                     [items[-1][k]] * npad)
                         for k in ("total_m", "target", "mask")}
                    b["filenames"] = [it["target_filename"]
                                      for it in items]
                    yield b

            for batch in PrefetchIterator(val_batches(), depth=2):
                names = batch.pop("filenames")
                dev_batch = {"total_m": to_dev(batch["total_m"]),
                             "target": to_dev(batch["target"])}
                if cfg.use_mask:
                    dev_batch["mask"] = to_dev(batch["mask"])
                add_point_sizes(dev_batch, ds.id)
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
        return loss, acc, views, timing

    ckpt_root = os.path.join(exp_dir, "checkpoints")
    history = []

    def write_history():
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
                        "val_timing": vt})
        write_history()
        if writer:
            writer.add_scalar("val/loss", val_loss, epoch)
            for k, v in vacc.means().items():
                writer.add_scalar(f"val/{k}", v, epoch)
            writer.add_scalar("lr_scale", scale, epoch)

        if epoch % args.save_freq == 0 or sched_metric < best_val:
            for ds in ds_train:
                CK.save_checkpoint(
                    os.path.join(ckpt_root, f"ckpt_{ds.name}_{epoch}"),
                    TP.flat_from_state(states.activate(ds.id)),
                    config=config_dict(args),
                    extra={"epoch": epoch, "val_loss": val_loss})
                CK.rotate_checkpoints(ckpt_root, f"ckpt_{ds.name}", keep=3)
            if sched_metric < best_val:
                best_val = sched_metric
                for ds in ds_train:
                    CK.save_checkpoint(
                        os.path.join(ckpt_root, f"best_{ds.name}"),
                        TP.flat_from_state(states.activate(ds.id)),
                        config=config_dict(args),
                        extra={"epoch": epoch, "val_loss": val_loss,
                               "val_psnr": vacc.mean("psnr")})
    print(f"done; best val loss {best_val:.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
