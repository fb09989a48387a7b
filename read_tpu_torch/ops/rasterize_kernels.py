"""K1: the packed-key z-buffer (``csrc/zbuffer.cu``) and its twin.

Counterpart of ``read_tpu/ops/rasterize_pallas.py``: ``pack_keys``
(:295-308) and ``zbuffer_pallas2`` / ``_kernel2`` (:145-231) as called by
``rasterize_batch(method='pallas')`` (``rasterize.py:516-545``). The CUDA
kernel also fuses the projection and pixel mapping that feed it (see the
source's header note).

:func:`zbuffer` is the wrapper: a CPU tensor goes to
:func:`zbuffer_plain`, a CUDA tensor to the kernel, anything else
raises. ``launches['zbuffer']`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from read_tpu_torch import _build

__all__ = ["INT32_MAX", "key_bits", "pack_keys", "scatter_min",
           "zbuffer", "zbuffer_plain", "launches"]

INT32_MAX = 2 ** 31 - 1

# kernel launches (a CPU call runs the twin and counts nothing)
launches = {"zbuffer": 0}


def key_bits(n_ids: int):
    """``(idb, qmax)``: id bits and the largest depth bin of the packed
    key, ``idb = max(1, (n_ids - 1).bit_length())``, ``qmax =
    2^(31 - idb) - 1`` (20 id bits and 11 depth bits at 1M points)."""
    idb = max(1, (n_ids - 1).bit_length())
    db = 31 - idb
    if db < 8:
        raise ValueError(
            f"packed z-buffer: only {db} depth bits for {n_ids} ids; more "
            "than 2^23 points need the 64-bit exact-key mode (ROADMAP "
            "queue 2, K1)")
    return idb, (1 << db) - 1


def pack_keys(pix: torch.Tensor, depth: torch.Tensor, ids: torch.Tensor,
              n_pixels: int, n_ids: int):
    """``key = trunc(clip(depth * qmax, 0, qmax - 1)) << idb | id``;
    points with ``pix >= n_pixels`` get ``INT32_MAX``. Returns
    ``(key, idb)`` (``rasterize_pallas.pack_keys`` parity: the depth is
    truncated, not rounded, and the bin qmax is never used so a covered
    far-plane pixel cannot equal the empty sentinel)."""
    idb, qmax = key_bits(n_ids)
    q = torch.clamp(depth * qmax, 0, qmax - 1).to(torch.int32)
    key = torch.where(pix < n_pixels, (q << idb) | ids.to(torch.int32),
                      INT32_MAX)
    return key, idb


def scatter_min(pix: torch.Tensor, key: torch.Tensor, n_pixels: int):
    """Per-pixel minimum of ``key`` over the last dim of ``pix [..., N]``
    (``INT32_MAX`` = empty): ``[..., n_pixels]`` int32. Pixel ids
    ``>= n_pixels`` land in a dump slot that is cut off
    (``rasterize._zbuffer_scatter1`` parity)."""
    buf = torch.full((*pix.shape[:-1], n_pixels + 1), INT32_MAX,
                     dtype=torch.int32, device=pix.device)
    buf.scatter_reduce_(-1, pix.clamp(max=n_pixels).long(), key, "amin",
                        include_self=True)
    return buf[..., :n_pixels].contiguous()


def zbuffer_plain(xyz: torch.Tensor, total_m: torch.Tensor, h: int,
                  w: int):
    """Plain PyTorch twin of :func:`zbuffer` (same contract)."""
    # rasterize.py imports this module, so import its helpers lazily
    from read_tpu_torch.ops.rasterize import _pixel_ids, project_points
    b, n = total_m.shape[0], xyz.shape[0]
    ndc, valid = project_points(xyz, total_m)            # [B, N, 3]
    pix, depth = _pixel_ids(ndc, valid, h, w)
    ids = torch.arange(n, dtype=torch.int32, device=xyz.device)
    key, _ = pack_keys(pix, depth, ids.expand(b, n), h * w, n)
    depth0 = torch.where(valid, (ndc[..., 2] + 1.0) * 0.5, 0.0)
    return scatter_min(pix, key, h * w), depth0


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def zbuffer(xyz: torch.Tensor, total_m: torch.Tensor, h: int, w: int):
    """Project ``xyz [N, 3]`` by ``total_m [B, 4, 4]`` (float32,
    contiguous) and z-buffer every view at ``h x w``.

    Returns ``(buf [B, h*w] int32, depth0 [B, N] float32)``: the
    per-pixel minimum packed key (``INT32_MAX`` = empty; id bits from
    :func:`key_bits` with ``n_ids = N``) and each point's NDC depth
    (0 for points outside the clip cube), from which callers re-gather
    the winner's exact depth."""
    if xyz.dtype != torch.float32 or total_m.dtype != torch.float32:
        raise TypeError("zbuffer: xyz and total_m must be float32")
    if xyz.dim() != 2 or xyz.shape[1] != 3 or total_m.dim() != 3 \
            or tuple(total_m.shape[1:]) != (4, 4):
        raise ValueError(f"zbuffer: want xyz [N,3], total_m [B,4,4]; got "
                         f"{tuple(xyz.shape)}, {tuple(total_m.shape)}")
    if xyz.device != total_m.device:
        raise ValueError("zbuffer: xyz and total_m on different devices")
    if xyz.device.type == "cpu":
        return zbuffer_plain(xyz, total_m, h, w)
    if xyz.device.type != "cuda":
        raise RuntimeError(f"zbuffer: no kernel for device {xyz.device}")
    if not (xyz.is_contiguous() and total_m.is_contiguous()):
        raise ValueError("zbuffer: inputs must be contiguous")
    n, b = xyz.shape[0], total_m.shape[0]
    idb, qmax = key_bits(n)
    buf = torch.full((b, h * w), INT32_MAX, dtype=torch.int32,
                     device=xyz.device)
    depth0 = torch.empty((b, n), dtype=torch.float32, device=xyz.device)
    fn = _build.function("zbuffer", "zbuffer_project", _ARGTYPES)
    err = fn(xyz.data_ptr(), total_m.data_ptr(), n, b, h, w, idb, qmax,
             buf.data_ptr(), depth0.data_ptr(),
             torch.cuda.current_stream(xyz.device).cuda_stream)
    _build.check(err, "zbuffer")
    launches["zbuffer"] += 1
    return buf, depth0

