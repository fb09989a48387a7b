"""The weight bridge between ``read_tpu`` checkpoints and the port.

A ``read_tpu`` train state flattens to ``/``-joined keys
(``read_tpu/utils/ckpt.py:42-47``): the UNet's flax parameters under
``params/``, its BatchNorm running stats under ``batch_stats/``, and the
point descriptor table as ``texture`` (a mesh texture's tables as
``texture/0``, ``texture/1``, ...). The port holds either as a tuple of
tables (one for the point table). The port's UNet
(:mod:`read_tpu_torch.models.unet`) names its submodules after the flax
paths, so the mapping is one to one: ``params/AFF0/BasicConv_1/conv_fm/
kernel`` <-> ``AFF0.BasicConv_1.conv_fm.kernel`` and ``batch_stats/
AFF0/BasicConv_1/norm/mean`` <-> ``AFF0.BasicConv_1.norm.mean``.

A whole ``TrainState`` with its optimizer state is carried across by
``read_tpu_torch.pipelines.texture_pipeline.state_from_flat`` and
``flat_from_state``, on top of these functions.

Layouts are kept as flax has them: conv kernels stay HWIO
``[k, k, Cin, 2*Cout]`` with the fused ``[f | m]`` halves, which is the
layout the port's kernels read, so nothing is transposed.
"""

from __future__ import annotations

import itertools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

__all__ = ["variables_from_flat", "flat_from_variables",
           "texture_from_flat", "flat_from_texture", "vgg_params_from_numpy"]

_STATS = ("mean", "var")
Tables = Tuple[torch.Tensor, ...]


def variables_from_flat(flat: Dict[str, np.ndarray]
                        ) -> Tuple[Dict[str, torch.Tensor], Tables]:
    """``read_tpu`` flat checkpoint -> ``(unet_state, texture)``.

    ``unet_state`` is a state dict for :class:`~read_tpu_torch.models.
    unet.UNet` (CPU float32 tensors); ``texture`` the texture's tables
    (:func:`texture_from_flat`). Other leaves (optimizer state, step, lr
    scale) are ignored."""
    state = {}
    for key, arr in flat.items():
        prefix, _, rest = key.partition("/")
        if prefix not in ("params", "batch_stats") or not rest:
            continue
        name = rest.replace("/", ".")
        if (prefix == "batch_stats") != (name.rsplit(".", 1)[-1]
                                         in _STATS):
            raise ValueError(f"unexpected checkpoint leaf {key!r}")
        state[name] = torch.from_numpy(np.array(arr, np.float32))
    if not state:
        raise ValueError("checkpoint holds no params/ or batch_stats/ "
                         "leaves")
    try:
        return state, texture_from_flat(flat, "texture", "cpu")
    except KeyError:
        raise ValueError("checkpoint holds no 'texture' leaf") from None


def flat_from_variables(unet_state: Dict[str, torch.Tensor],
                        texture: Tables) -> Dict[str, np.ndarray]:
    """Inverse of :func:`variables_from_flat`: the flat keys that
    ``read_tpu`` writes, as numpy arrays."""
    flat = {}
    for name, t in unet_state.items():
        leaf = name.rsplit(".", 1)[-1]
        prefix = "batch_stats" if leaf in _STATS else "params"
        flat[f"{prefix}/{name.replace('.', '/')}"] = (
            t.detach().cpu().numpy())
    flat.update(flat_from_texture(texture))
    return flat


def texture_from_flat(flat: Dict[str, np.ndarray], key: str = "texture",
                      device="cuda") -> Tables:
    """The float32 tables under ``key`` on ``device``, as a tuple: the
    point table ``<key>`` alone, or the mesh tables ``<key>/0``,
    ``<key>/1``, ... Raises ``KeyError`` where there is neither."""
    keys = [key] if key in flat else list(itertools.takewhile(
        flat.__contains__, (f"{key}/{i}" for i in itertools.count())))
    if not keys:
        raise KeyError(f"checkpoint holds no {key!r} leaf")
    return tuple(torch.from_numpy(np.array(flat[k], np.float32)).to(device)
                 for k in keys)


def flat_from_texture(texture: Tables, key: str = "texture"
                      ) -> Dict[str, np.ndarray]:
    """Inverse of :func:`texture_from_flat`: a point table (``[N, C]``)
    under ``key``, mesh tables (``[s, s, C]``) under ``<key>/<i>``."""
    if len(texture) == 1 and texture[0].dim() == 2:
        return {key: texture[0].detach().cpu().numpy()}
    return {f"{key}/{i}": t.detach().cpu().numpy()
            for i, t in enumerate(texture)}


def vgg_params_from_numpy(pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
                          device="cuda"):
    """VGG parameters given as numpy ``(w HWIO, b)`` pairs (e.g. JAX's
    ``random_vgg_params``) -> the port's list of float32 tensors."""
    return [(torch.from_numpy(np.array(w, np.float32)).to(device),
             torch.from_numpy(np.array(b, np.float32)).to(device))
            for w, b in pairs]
