"""Baseline workload configs 1, 4 and 5 against a fitted checkpoint.

Counterpart of ``scripts/run_baseline_configs.py``, one function per
config over a :class:`read_tpu_torch.render.NeuralRenderer`:

1. :func:`config1_trajectory`: render every pose of the scene; the device
   rate (back-to-back ``infer_device``, one sync at the end), the rate
   with each frame's host download (``infer``), and PSNR/SSIM
   (``criterions.losses``) against the ground truth on the val frames of
   ``split_by_step``.
4. :func:`config4_stitch`: split the points and descriptors at the median
   z, re-stitch them with ``scene.tools.stitch_scenes`` and render; the
   stitched index pyramid, mapped back through the permutation, against
   the unsplit one at every level, the stitched frame against the unsplit
   frame (bit-equal on the exact ``sort`` z-buffer, which breaks depth
   ties by id; a PSNR elsewhere), and the rate.
5. :func:`config5_edit_panorama`: delete the points in one box, copy the
   points of another shifted, render (the rate), and a camera-ring
   panorama (``scene.tools.panorama_cameras``) about the middle pose.

Usage::

    python -m read_tpu_torch.baseline_configs --scene scene.yaml \\
        --ckpt CKPT_DIR --out OUT_DIR [--device cpu]

writes ``cfg1_*.png``, ``cfg4_stitched.png``, ``cfg5_edited.png``,
``cfg5_panorama.png`` and ``results.json`` under ``OUT_DIR``. ``main``
passes the JAX script's own edit boxes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from read_tpu_torch.criterions import losses as L
from read_tpu_torch.data import image_io
from read_tpu_torch.data.dataset import load_image
from read_tpu_torch.data.splitter import split_by_step
from read_tpu_torch.ops import rasterize as R
from read_tpu_torch.scene import tools as ST

__all__ = ["config1_trajectory", "config4_stitch", "config5_edit_panorama",
           "device_ms", "main"]

# scripts/run_baseline_configs.py's edit: delete a car-sized box near the
# road, copy another 6 m to the left
DELETE_BOX = ((-4.5, -0.5, 20.0), (-2.0, 2.5, 28.0))
COPY_BOX = ((2.0, -0.5, 30.0), (4.5, 2.5, 38.0))
COPY_SHIFT = (-6.0, 0.0, 0.0)


def _sync(r) -> None:
    if r.device.type == "cuda":
        torch.cuda.synchronize(r.device)


def _png(out: Optional[str], name: str, img: np.ndarray) -> None:
    if out:
        image_io.imwrite(os.path.join(out, name),
                         (np.clip(img, 0, 1) * 255).astype(np.uint8))


def device_ms(r, poses: Sequence[np.ndarray]) -> float:
    """Mean ms a frame of ``infer_device`` over ``poses`` dispatched back
    to back with one sync at the end (after one warm-up frame)."""
    r.infer_device(poses[0])
    _sync(r)
    t0 = time.perf_counter()
    for pose in poses:
        r.infer_device(pose)
    _sync(r)
    return (time.perf_counter() - t0) * 1e3 / len(poses)


def config1_trajectory(r, target_dir: str, val_step: int = 10,
                       out: Optional[str] = None) -> dict:
    """Config 1 over every pose of ``r.scene_data``: the device rate, the
    rate with the host download (each frame's ``infer`` time, the first
    left out), and mean PSNR/SSIM against ``target_dir/{i:06}.png`` on
    ``split_by_step``'s val frames (``val_step``)."""
    views = [np.asarray(v) for v in r.scene_data["view_matrix"]]
    dev_ms = device_ms(r, views)
    (val_ids,) = split_by_step([list(range(len(views)))], val_step)[1]
    psnrs, ssims, host_ms = [], [], []
    for i, pose in enumerate(views):
        t0 = time.perf_counter()
        img = r.infer(pose)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        if i not in val_ids:
            continue
        path = os.path.join(target_dir, f"{i:06}.png")
        if os.path.exists(path):
            tgt = torch.from_numpy(
                load_image(path).astype(np.float32) / 255.0)[None]
            pred = torch.from_numpy(img)[None]
            psnrs.append(float(L.psnr(pred, tgt)))
            ssims.append(float(L.ssim(pred, tgt)))
        _png(out, f"cfg1_{i:06}.png", img)
    steady = host_ms[1:] or host_ms
    return {"frames": len(views), "device_ms": dev_ms,
            "fps_device": 1e3 / dev_ms,
            "host_ms": float(np.mean(steady)),
            "fps_with_host_download": 1e3 / float(np.mean(steady)),
            "val_psnr_mean": float(np.mean(psnrs)) if psnrs else None,
            "val_ssim_mean": float(np.mean(ssims)) if ssims else None,
            "n_val": len(psnrs)}


def config4_stitch(r, pose, reps: int = 8, out: Optional[str] = None
                   ) -> dict:
    """Config 4 at ``pose``: split ``r``'s points at the median z, stitch
    the halves back (``r.xyz`` and ``r.texture`` are left stitched), and
    compare the stitched frame and index pyramid (mapped back through the
    permutation) with the unsplit ones; ``tied_pixels``: pixels whose
    winners differ at an exact depth tie."""
    if r.point_sizes is not None:
        raise ValueError("config 4 stitches points without per-point "
                         "sizes, as scene.tools does")
    xyz_dev = r.xyz
    xyz = xyz_dev.cpu().numpy()
    tex = r.texture[0].cpu().numpy()
    ref_img = r.infer(pose)
    ref_idx = r.index_pyramid(pose)
    half_a = xyz[:, 2] <= np.median(xyz[:, 2])
    sx, stex, _ = ST.stitch_scenes([(xyz[half_a], tex[half_a], np.eye(4)),
                                    (xyz[~half_a], tex[~half_a], np.eye(4))])
    perm = torch.from_numpy(np.concatenate(
        [np.flatnonzero(half_a), np.flatnonzero(~half_a)])).to(r.device)
    r.xyz = torch.from_numpy(sx).to(r.device)
    r.texture = (torch.from_numpy(stex).to(r.device),)
    img = r.infer(pose)
    index_equal, ties = True, 0
    for want, got in zip(ref_idx, r.index_pyramid(pose)):
        mapped = torch.where(got >= 0, perm[got.clamp(min=0).long()],
                             got).to(want.dtype)
        diff = mapped != want
        if bool(diff.any()):
            index_equal = False
            ties += _tied(xyz_dev, r.total_matrix(pose), want, mapped, diff)
    rate_ms = device_ms(r, [pose] * reps)
    _png(out, "cfg4_stitched.png", img)
    psnr = float(L.psnr(torch.from_numpy(img)[None],
                        torch.from_numpy(ref_img)[None]))
    return {"bit_equal": bool(np.array_equal(img, ref_img)),
            "index_pyramid_equal": index_equal, "tied_pixels": ties,
            "max_abs_diff": float(np.abs(img - ref_img).max()),
            "psnr_vs_unsplit": psnr, "device_ms": rate_ms,
            "fps_device": 1e3 / rate_ms,
            "raster_method": r.cfg.raster_method}


def _tied(xyz, total_m, want, mapped, diff) -> int:
    """Of the pixels where ``want`` and ``mapped`` (original ids) differ,
    those whose two winners lie at the same NDC depth of this view."""
    a, b = want[diff].long(), mapped[diff].long()
    both = (a >= 0) & (b >= 0)
    z = R.project_points(xyz, xyz.new_tensor(total_m))[0][:, 2]
    return int((z[a[both]] == z[b[both]]).sum())


def config5_edit_panorama(r, pose, pano_pose, delete_box=DELETE_BOX,
                          copy_box=COPY_BOX, shift=COPY_SHIFT,
                          reps: int = 8, n_views: int = 3,
                          yaw_step_deg: float = 40.0,
                          out: Optional[str] = None) -> dict:
    """Config 5 on ``r``'s current points: delete those in ``delete_box``
    (``(lo, hi)``), copy those in ``copy_box`` moved by ``shift`` (``r``
    keeps the edited scene), time the frame at ``pose``, and render an
    ``n_views`` camera ring ``yaw_step_deg`` apart about ``pano_pose``
    side by side. Returns the numbers and ``(edited frame, panorama)``
    under ``images``."""
    xyz = r.xyz.cpu().numpy()
    tex = r.texture[0].cpu().numpy()
    sel = ST.select_bbox(xyz, *delete_box)
    ex, etex = ST.delete_points(xyz, tex, sel)
    sel2 = ST.select_bbox(ex, *copy_box)
    tf = np.eye(4)
    tf[:3, 3] = shift
    ex, etex = ST.duplicate_points(ex, etex, sel2, tf)
    r.xyz = torch.from_numpy(ex).to(r.device)
    r.texture = (torch.from_numpy(etex).to(r.device),)
    edited = r.infer(pose)
    rate_ms = device_ms(r, [pose] * reps)
    _png(out, "cfg5_edited.png", edited)
    _sync(r)
    t0 = time.perf_counter()
    tiles = [r.infer(m) for m in ST.panorama_cameras(pano_pose, n_views,
                                                     yaw_step_deg)]
    pano_ms = (time.perf_counter() - t0) * 1e3
    pano = np.concatenate(tiles, axis=1)
    _png(out, "cfg5_panorama.png", pano)
    return {"deleted_points": int(sel.sum()),
            "copied_points": int(sel2.sum()), "points": int(len(ex)),
            "edited_device_ms": rate_ms, "edited_fps_device": 1e3 / rate_ms,
            "panorama_views": n_views, "panorama_px": list(pano.shape[:2]),
            "panorama_ms": pano_ms, "images": (edited, pano)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Baseline configs 1/4/5 against a fitted checkpoint")
    ap.add_argument("--scene", required=True)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", default="baseline_cfgs")
    ap.add_argument("--targets", default=None,
                    help="ground-truth frames {i:06}.png; default: "
                         "images/ beside the scene manifest")
    ap.add_argument("--conv-impl", dest="conv_impl", default=None,
                    help="accepted for read_tpu compatibility; ignored")
    ap.add_argument("--dtype", default=None,
                    choices=["float32", "bfloat16"])
    ap.add_argument("--val-step", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain twins")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        ap.error("no CUDA device; pass --device cpu to run the plain "
                 "PyTorch twins")
    from read_tpu_torch.render import NeuralRenderer
    os.makedirs(args.out, exist_ok=True)
    r = NeuralRenderer(args.scene, args.ckpt, dtype=args.dtype,
                       conv_impl=args.conv_impl, device=args.device)
    views = [np.asarray(v) for v in r.scene_data["view_matrix"]]
    targets = args.targets or os.path.join(
        os.path.dirname(os.path.abspath(args.scene)), "images")
    results = {"config1_trajectory": config1_trajectory(
        r, targets, args.val_step, args.out)}
    print("config1:", results["config1_trajectory"], flush=True)
    results["config4_stitching"] = config4_stitch(r, views[0], out=args.out)
    print("config4:", results["config4_stitching"], flush=True)
    c5 = config5_edit_panorama(r, views[0], views[len(views) // 2],
                               out=args.out)
    c5.pop("images")
    results["config5_edit_panorama"] = c5
    print("config5:", c5, flush=True)
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
