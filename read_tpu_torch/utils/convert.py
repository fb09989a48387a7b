"""The weight bridge between ``read_tpu`` checkpoints and the port.

A ``read_tpu`` train state flattens to ``/``-joined keys
(``read_tpu/utils/ckpt.py:42-47``): the UNet's flax parameters under
``params/``, its BatchNorm running stats under ``batch_stats/``, and the
point descriptor table as ``texture``. The port's UNet
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

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

__all__ = ["variables_from_flat", "flat_from_variables",
           "vgg_params_from_numpy"]

_STATS = ("mean", "var")


def variables_from_flat(flat: Dict[str, np.ndarray]
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """``read_tpu`` flat checkpoint -> ``(unet_state, texture)``.

    ``unet_state`` is a state dict for :class:`~read_tpu_torch.models.
    unet.UNet` (CPU float32 tensors); ``texture`` the ``[N, C]`` table.
    Other leaves (optimizer state, step, lr scale) are ignored."""
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
    if "texture" not in flat:
        raise ValueError("checkpoint holds no 'texture' leaf (a mesh-"
                         "texture checkpoint is not supported by the port)")
    texture = torch.from_numpy(np.array(flat["texture"], np.float32))
    return state, texture


def flat_from_variables(unet_state: Dict[str, torch.Tensor],
                        texture: torch.Tensor) -> Dict[str, np.ndarray]:
    """Inverse of :func:`variables_from_flat`: the flat keys that
    ``read_tpu`` writes, as numpy arrays."""
    flat = {}
    for name, t in unet_state.items():
        leaf = name.rsplit(".", 1)[-1]
        prefix = "batch_stats" if leaf in _STATS else "params"
        flat[f"{prefix}/{name.replace('.', '/')}"] = (
            t.detach().cpu().numpy())
    flat["texture"] = texture.detach().cpu().numpy()
    return flat


def vgg_params_from_numpy(pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
                          device="cuda"):
    """VGG parameters given as numpy ``(w HWIO, b)`` pairs (e.g. JAX's
    ``random_vgg_params``) -> the port's list of float32 tensors."""
    return [(torch.from_numpy(np.array(w, np.float32)).to(device),
             torch.from_numpy(np.array(b, np.float32)).to(device))
            for w, b in pairs]
