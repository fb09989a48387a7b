"""Scene registry -> train/val ViewDatasets.

The port's copy of ``read_tpu/data/scenes.py``: a paths file maps
dataset names to a scene manifest and image directories; per-scene file
lists are built from the camera labels, split by the configured splitter
and wrapped in :class:`~read_tpu_torch.data.dataset.ViewDataset`. Name
patterns are format strings (``target_name: "{label}.png"``); the
``<key>_func`` f-string lambda form is parsed, never evaluated. The
paths file and manifests are read through
:mod:`read_tpu_torch.utils.config_io` (YAML with PyYAML, else JSON).
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

from read_tpu_torch.data.dataset import ViewDataset
from read_tpu_torch.data.splitter import eval_all, get_splitter
from read_tpu_torch.scene.io import load_scene_data
from read_tpu_torch.utils import config_io

__all__ = ["get_datasets", "get_dataset_config", "name_template"]


def get_dataset_config(paths_data: dict, name: str) -> dict:
    """Resolve one dataset's entry, applying the per-hostname data_root
    prefix if configured (a ``data_roots`` map of hostname -> path
    prefix, joined onto relative paths)."""
    datasets = paths_data["datasets"]
    if name not in datasets:
        raise KeyError(f"dataset {name!r} not in paths file; have "
                       f"{sorted(datasets)}")
    config = dict(datasets[name])
    roots = paths_data.get("data_roots")
    if roots:
        import socket
        root = roots.get(socket.gethostname(), roots.get("default"))
        if root:
            for key in ("scene_path", "target_path", "mask_path",
                        "label_path"):
                if key in config and not os.path.isabs(config[key]):
                    config[key] = os.path.join(root, config[key])
    return config


_LAMBDA_FSTRING = re.compile(
    r"lambda\s+(\w+)\s*:\s*f(['\"])(.*)\2\s*$")


def name_template(config: dict, key: str, default: str) -> str:
    """Resolve a file-name template. Prefers ``<key>`` (a format string
    with ``{label}``); falls back to parsing the reference's
    ``<key>_func`` f-string lambdas without eval."""
    if key in config:
        return config[key]
    func_key = key + "_func"
    if func_key in config:
        m = _LAMBDA_FSTRING.match(config[func_key].strip())
        if m:
            var, _, body = m.groups()
            # {i} / {i:06} etc -> {label...}
            return re.sub(r"\{%s(![rsa])?(:[^}]*)?\}" % var,
                          lambda mm: "{label%s%s}" % (mm.group(1) or "",
                                                      mm.group(2) or ""),
                          body)
        raise ValueError(
            f"{func_key} is not a simple f-string lambda; use "
            f"{key}: '{{label}}.png' instead (no code in configs)")
    return default


def _format_label(template: str, label) -> str:
    # numeric specs like {label:06} need an int label
    if re.search(r"\{label:0?\d+d?\}", template):
        try:
            label = int(label)
        except (TypeError, ValueError):
            pass
    try:
        return template.format(label=label)
    except ValueError:
        return template.format(label=str(label))


def _get_splits(paths_data: dict, name: str, args) -> Tuple[ViewDataset,
                                                            ViewDataset]:
    config = get_dataset_config(paths_data, name)
    scene_data = load_scene_data(config["scene_path"])

    view_list = scene_data["view_matrix"]
    camera_labels = scene_data["camera_labels"]

    tgt_tpl = name_template(config, "target_name", "{label:06}.png")
    target_list = [os.path.join(config["target_path"],
                                _format_label(tgt_tpl, lbl))
                   for lbl in camera_labels]

    if "mask_path" in config:
        tpl = name_template(config, "mask_name", "{label}.png")
        mask_list = [os.path.join(config["mask_path"],
                                  _format_label(tpl, lbl))
                     for lbl in camera_labels]
    else:
        mask_list = [None] * len(target_list)

    if "label_path" in config:
        tpl = name_template(config, "label_name", "{label}.png")
        label_list = [os.path.join(config["label_path"],
                                   _format_label(tpl, lbl))
                      for lbl in camera_labels]
    else:
        label_list = [None] * len(target_list)

    lists = [list(view_list), target_list, mask_list, label_list]
    crop = args.crop_size
    if isinstance(crop, str):  # "WxH" CLI form
        cw, ch = crop.lower().split("x")
        crop = (int(cw), int(ch))
    elif isinstance(crop, (int, float)):
        crop = (int(crop), int(crop))
    else:
        crop = tuple(int(x) for x in crop)
    if getattr(args, "eval_all", False):
        train_lists, val_lists = eval_all(lists)
    else:
        splitter = get_splitter(args.splitter)
        train_lists, val_lists = splitter(lists, **args.splitter_args)

    common = dict(scene_data=scene_data, image_size=crop)  # (w, h)
    ds_train = ViewDataset(
        "train", view_list=train_lists[0], target_list=train_lists[1],
        mask_list=train_lists[2], label_list=train_lists[3],
        **common, **args.train_dataset_args)
    ds_val = ViewDataset(
        "val", view_list=val_lists[0], target_list=val_lists[1],
        mask_list=val_lists[2], label_list=val_lists[3],
        **common, **args.val_dataset_args)
    return ds_train, ds_val


def get_datasets(args) -> Tuple[List[ViewDataset], List[ViewDataset],
                                List[Optional[str]]]:
    """Build per-scene train/val datasets + per-scene texture ckpt
    paths."""
    assert args.paths_file, "set paths_file"
    paths_data = config_io.load(args.paths_file)

    names = list(args.dataset_names or paths_data["datasets"])
    if getattr(args, "exclude_datasets", None):
        names = [n for n in names if n not in set(args.exclude_datasets)]

    ds_train_list, ds_val_list, texture_ckpts = [], [], []
    for i, name in enumerate(names):
        ds_train, ds_val = _get_splits(paths_data, name, args)
        ds_train.name = ds_val.name = name
        ds_train.id = ds_val.id = i
        ds_train_list.append(ds_train)
        ds_val_list.append(ds_val)
        texture_ckpts.append(
            ds_train.scene_data["config"].get("texture_ckpt"))
    return ds_train_list, ds_val_list, texture_ckpts
