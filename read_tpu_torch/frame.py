"""The operating points that ``bench.py`` times, on PyTorch.

:func:`train_inputs` is the training step's (``bench.py:28-70``): 1M
points ``uniform(-10, 10)`` shifted by z - 25, fx = fy = 720 at 256x256,
B = 8 poses with x offset 0.05 * i, uniform random targets.

:func:`make_frame` is the serving frame, the counterpart of
``__graft_entry__.entry_orchestrated`` (:76-192): the
same operating point (1M points ``uniform(-10, 10)`` shifted by z - 25,
fx = fy = 720 at 1216x368, near 0.1, far 1000, one pose per frame with
x offset 0.05 * i), the 'pallas' raster (K1), the packed pool to 4
levels, the descriptor gather and the full-width UNet (K2, K3). The
whole batch renders in one call; there is no encoder/decoder split.

The weights and the descriptor table are random, from ``torch``
generators seeded by ``seed`` (they differ from ``jax.random``'s); the
points come from ``numpy.random.default_rng(seed)`` as in JAX.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from read_tpu.scene import camera
from read_tpu_torch.models import texture as T
from read_tpu_torch.models.unet import UNet
from read_tpu_torch.ops import rasterize as R

__all__ = ["make_frame", "frame_inputs", "train_inputs"]


def frame_inputs(batch: int = 1, n_points: int = 1_000_000,
                 hw: Tuple[int, int] = (368, 1216), focal: float = 720.0,
                 seed: int = 0):
    """``(xyz [N, 3], total_m [B, 4, 4])`` float32 numpy arrays of the
    benchmark scene and trajectory."""
    h, w = hw
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-10, 10, size=(n_points, 3)).astype(np.float32)
    xyz[:, 2] -= 25.0
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]])
    P = camera.gl_projection(K, (w, h), znear=0.1, zfar=1000.0)
    ms = []
    for i in range(batch):
        view = np.eye(4)
        view[0, 3] = 0.05 * i  # a short trajectory, one pose per frame
        ms.append(camera.total_matrix(P, view))
    return xyz, np.stack(ms).astype(np.float32)


def train_inputs(batch: int = 8, n_points: int = 1_000_000, hw: int = 256,
                 focal: float = 720.0, seed: int = 0):
    """``(xyz [N, 3], total_m [B, 4, 4], target [B, hw, hw, 3])`` float32
    numpy arrays of the training benchmark, drawn in ``bench.py``'s
    order from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-10, 10, size=(n_points, 3)).astype(np.float32)
    xyz[:, 2] -= 25.0
    K = np.array([[focal, 0, hw / 2], [0, focal, hw / 2], [0, 0, 1]])
    P = camera.gl_projection(K, (hw, hw), znear=0.1, zfar=1000.0)
    ms = []
    for i in range(batch):
        view = np.eye(4)
        view[0, 3] = 0.05 * i
        ms.append(camera.total_matrix(P, view))
    target = rng.uniform(size=(batch, hw, hw, 3)).astype(np.float32)
    return xyz, np.stack(ms).astype(np.float32), target


def make_frame(batch: int = 1, operands: str = "bf16", *, device,
               n_points: int = 1_000_000,
               hw: Tuple[int, int] = (368, 1216), focal: float = 720.0,
               base_channel: int = 32, num_res: int = 4, seed: int = 0
               ) -> Tuple[Callable, tuple]:
    """``(frame_fn, args)``: ``frame_fn(*args)`` renders ``batch`` frames
    and returns ``im_out [B, h, w, 3]`` on ``device``.

    ``args = (net, table, xyz, total_m)``. ``operands`` 'bf16' (default,
    as JAX's ``bf16_mxu``) or 'f32'. ``device`` has no default: a CPU
    device runs the plain twins, not the kernels."""
    device = torch.device(device)
    h, w = hw
    xyz, total_m = frame_inputs(batch, n_points, hw, focal, seed)
    gen = torch.Generator().manual_seed(seed)
    table = T.init_point_texture(n_points, 8, "rand", generator=gen)
    net = UNet(base_channel=base_channel, num_res=num_res).init_weights(
        torch.Generator().manual_seed(seed + 1)).eval()

    def frame_fn(net, table, xyz, total_m):
        levels = R.rasterize_pyramid_pooled(xyz, total_m, (h, w), 4,
                                            method="pallas",
                                            pool_impl="packed")
        pyr = [T.sample_point_texture_unique(table, ix) for ix, _ in levels]
        return net(*pyr, operands=operands)["im_out"]

    args = (net.to(device), table.to(device),
            torch.from_numpy(xyz).to(device),
            torch.from_numpy(total_m).to(device))
    return frame_fn, args
