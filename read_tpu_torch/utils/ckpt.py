"""Checkpoint directories in ``read_tpu``'s format, with numpy only.

Counterpart of ``read_tpu/utils/ckpt.py:42-96``. A checkpoint is a
directory holding ``state.npz`` (one array per leaf, keyed by the
``/``-joined pytree path, e.g. ``params/feat0/conv_fm/kernel``) and
``meta.json`` (``config``, ``extra`` and the sorted ``keys``). The JAX
package flattens its train state with ``jax.tree_util``; here the flat
dict is the interface, so nothing needs JAX to read or write one.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint"]


def save_checkpoint(path: str, flat: Dict[str, np.ndarray],
                    config: Optional[dict] = None) -> str:
    """Write a flat ``{key: array}`` dict + config to directory ``path``.

    Same layout and atomic ``.tmp`` rename as the JAX writer, so
    ``read_tpu.utils.ckpt.load_checkpoint`` reads the result."""
    flat = {k: np.asarray(v) for k, v in flat.items()}
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "state.npz"), **flat)
    meta = {"config": config or {}, "extra": {}, "keys": sorted(flat)}
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
