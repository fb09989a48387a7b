"""Checkpoint directories in ``read_tpu``'s format, with numpy only.

Counterpart of ``read_tpu/utils/ckpt.py:42-96``. A checkpoint is a
directory holding ``state.npz`` (one array per leaf, keyed by the
``/``-joined pytree path, e.g. ``params/feat0/conv_fm/kernel``) and
``meta.json`` (``config``, ``extra`` and the sorted ``keys``). The JAX
package flattens its train state with ``jax.tree_util``; here the flat
dict is the interface, so nothing needs JAX to read or write one.
``latest_checkpoint`` and ``rotate_checkpoints`` (:97-131) find and
prune the ``<prefix>_<epoch>`` directories the train CLI writes.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint",
           "rotate_checkpoints"]


def save_checkpoint(path: str, flat: Dict[str, np.ndarray],
                    config: Optional[dict] = None,
                    extra: Optional[dict] = None) -> str:
    """Write a flat ``{key: array}`` dict, config and ``extra`` (e.g.
    the epoch and its val loss) to directory ``path``.

    Same layout and atomic ``.tmp`` rename as the JAX writer, so
    ``read_tpu.utils.ckpt.load_checkpoint`` reads the result."""
    flat = {k: np.asarray(v) for k, v in flat.items()}
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "state.npz"), **flat)
    meta = {"config": config or {}, "extra": extra or {},
            "keys": sorted(flat)}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1, default=str)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return path


def load_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], dict]:
    """Read a checkpoint dir: ``(flat {key: np.ndarray}, meta)``."""
    with np.load(os.path.join(path, "state.npz")) as z:
        flat = {k: z[k] for k in z.files}
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return flat, meta


def _step_of(name: str) -> int:
    try:
        return int(name.rsplit("_", 1)[-1])
    except ValueError:
        return -1


def latest_checkpoint(directory: str, prefix: str = "ckpt"
                      ) -> Optional[str]:
    """The ``prefix*`` directory with the highest ``_<n>`` suffix, or
    None."""
    if not os.path.isdir(directory):
        return None
    cands = [d for d in os.listdir(directory)
             if d.startswith(prefix) and not d.endswith(".tmp")]
    if not cands:
        return None
    return os.path.join(directory, max(cands, key=_step_of))


def rotate_checkpoints(directory: str, prefix: str = "ckpt",
                       keep: int = 3) -> None:
    """Keep the ``keep`` newest ``prefix_*`` dirs; ``best_*`` is never
    rotated."""
    if not os.path.isdir(directory):
        return
    cands = [d for d in os.listdir(directory)
             if d.startswith(prefix + "_") and not d.endswith(".tmp")]
    for d in sorted(cands, key=_step_of)[:-keep]:
        shutil.rmtree(os.path.join(directory, d))
