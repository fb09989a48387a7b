"""Generate a synthetic driving scene at the kitti6 operating point
(1216x368) for end-to-end fitting and benchmarking, on the GPU.

The port's counterpart of ``scripts/make_demo_scene.py`` (same flags,
same files, same world for a seed). It builds a structured world (road
plane with lane markings, sidewalks, building facades with windows, tree
crowns, parked boxes) as a coloured point cloud (:func:`build_world`, a
numpy-only copy of the script's, bit-equal for a seed), renders
ground-truth views along a driving trajectory with the port's own
rasterizer, and writes a complete scene layout: ``pc.ply``, ``cam.txt``,
``poses.dat``, ``images/%06d.png``, ``scene.yaml`` and ``paths.yaml``.

Each target is ``rasterize_batch(..., point_radius=1)`` on 'sort' (K6's
splat projection with K5's 64-bit key, which has no 2^23-id limit, so
10M points are fine) and the colour gather, then ``clip * 255``
truncated to uint8 as the script writes it; PNGs through
:mod:`read_tpu_torch.data.image_io`. It needs neither ``jax`` nor
``imageio``.

Usage::

    python -m read_tpu_torch.make_demo_scene --out data/scene10m \\
        --points 10000000 --views 24 [--width 1216 --height 368] \\
        [--seed 0] [--device cuda]

The scene's files are what ``configs/scene10m_probe.yaml`` and
``configs/scene10m_full.yaml`` read (``paths_file:
data/scene10m/paths.yaml``, dataset ``demo_drive``).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

__all__ = ["build_world", "drive_views", "render_targets", "main"]


def build_world(rng, n_total):
    """Structured driving world along +z in [0, 120] m, road at y=0:
    ``(xyz [n_total, 3] float32, rgb [n_total, 3] float32 in [0, 1])``,
    the same numbers as ``scripts/make_demo_scene.py``'s for the same
    ``np.random.Generator`` state."""
    parts = []
    cols = []

    def add(xyz, rgb):
        parts.append(xyz.astype(np.float32))
        cols.append(rgb.astype(np.float32))

    n_road = int(n_total * 0.30)
    z = rng.uniform(0, 120, n_road)
    x = rng.uniform(-4.5, 4.5, n_road)
    road = np.stack([x, np.zeros(n_road), z], 1)
    gray = rng.uniform(0.25, 0.35, (n_road, 1)) * np.ones((1, 3))
    # lane markings: |x| < 0.08 dashed
    dash = (np.abs(x) < 0.08) & ((z % 4) < 2)
    gray[dash] = [0.85, 0.85, 0.8]
    edge = np.abs(np.abs(x) - 4.3) < 0.1
    gray[edge] = [0.8, 0.8, 0.75]
    add(road, gray)

    n_walk = int(n_total * 0.10)
    z = rng.uniform(0, 120, n_walk)
    side = rng.choice([-1, 1], n_walk)
    x = side * rng.uniform(4.6, 7.0, n_walk)
    walk = np.stack([x, np.full(n_walk, 0.12), z], 1)
    add(walk, rng.uniform(0.45, 0.55, (n_walk, 1)) * np.ones((1, 3)))

    n_bld = int(n_total * 0.35)
    z = rng.uniform(0, 120, n_bld)
    side = rng.choice([-1, 1], n_bld)
    x = side * rng.uniform(7.2, 7.5, n_bld)
    y = rng.uniform(0, 9, n_bld)
    bld = np.stack([x, y, z], 1)
    base = np.stack([rng.uniform(0.45, 0.75, n_bld),
                     rng.uniform(0.35, 0.55, n_bld),
                     rng.uniform(0.3, 0.45, n_bld)], 1)
    # block-wise facade colour + a grid of dark windows
    block = (np.floor(z / 15)).astype(int) % 3
    base[block == 1] *= 0.8
    base[block == 2] = base[block == 2][:, ::-1]
    win = ((y % 3) > 1.2) & ((y % 3) < 2.4) & ((z % 3) > 1.0) \
        & ((z % 3) < 2.2)
    base[win] = [0.1, 0.12, 0.2]
    add(bld, base)

    n_tree = int(n_total * 0.15)
    nt = max(n_tree // 400, 8)
    centers_z = rng.uniform(5, 115, nt)
    centers_x = rng.choice([-1, 1], nt) * rng.uniform(5.5, 6.8, nt)
    per = n_tree // nt
    for cz, cx in zip(centers_z, centers_x):
        p = rng.normal(0, 0.9, (per, 3)) * [1, 1.3, 1]
        p += [cx, 3.2, cz]
        g = rng.uniform(0.15, 0.45, (per, 1))
        add(p, np.concatenate(
            [g * 0.4, g + 0.25, g * 0.35], 1).clip(0, 1))

    n_car = n_total - sum(p.shape[0] for p in parts)
    ncars = max(n_car // 3000, 2)
    per = n_car // max(ncars, 1)
    car_colors = np.array([[0.7, 0.1, 0.1], [0.15, 0.2, 0.6],
                           [0.8, 0.8, 0.82], [0.1, 0.1, 0.12],
                           [0.7, 0.5, 0.1]])
    for i in range(ncars):
        cz = rng.uniform(5, 115)
        cx = rng.choice([-1, 1]) * rng.uniform(3.0, 4.0)
        p = rng.uniform(-1, 1, (per, 3)) * [0.9, 0.7, 2.2]
        p[:, 1] = np.abs(p[:, 1]) + 0.15
        p += [cx, 0, cz]
        c = np.tile(car_colors[i % len(car_colors)], (per, 1))
        c *= rng.uniform(0.85, 1.15, (per, 1))
        add(p, c.clip(0, 1))

    return np.concatenate(parts), np.concatenate(cols).clip(0, 1)


def drive_views(n):
    """The driving trajectory: ``n`` view matrices along +z at 1.6 m eye
    height, 1.5 m apart, with a slight weave."""
    from read_tpu_torch.scene import camera
    views = []
    for i in range(n):
        zpos = 2.0 + i * 1.5
        views.append(camera.look_at(
            [0.35 * np.sin(i * 0.12), 1.6, zpos],
            [0.35 * np.sin((i + 8) * 0.12), 1.5, zpos + 12.0],
            up=[0, 1, 0]))
    return views


def render_targets(xyz, rgb, matrices, h, w, device):
    """One ``(index [h, w] int32, target [h, w, 3] uint8)`` pair a ``[4,
    4]`` world-to-clip matrix, on the host: the 'sort' splat raster at
    ``point_radius=1`` and the colour gather, ``clip(0, 1) * 255``
    truncated (a generator)."""
    import torch
    from read_tpu_torch.ops import rasterize as R
    from read_tpu_torch.ops import render_modes as RM
    xyz_d = torch.from_numpy(np.ascontiguousarray(xyz, np.float32)).to(
        device)
    rgb_d = torch.from_numpy(np.ascontiguousarray(rgb, np.float32)).to(
        device)
    for m in matrices:
        m_d = torch.from_numpy(np.asarray(m, np.float32)[None]).to(device)
        idx, _ = R.rasterize_batch(xyz_d, m_d, h, w, point_radius=1)
        img = RM.gather_attribute(rgb_d, idx[0]).cpu().numpy()
        yield idx[0].cpu().numpy(), (np.clip(img, 0, 1) * 255).astype(
            np.uint8)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--points", type=int, default=2_000_000)
    ap.add_argument("--views", type=int, default=60)
    ap.add_argument("--width", type=int, default=1216)
    ap.add_argument("--height", type=int, default=368)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default: the kernels) or 'cpu' (their "
                         "plain twins)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    import torch
    from read_tpu_torch.data import image_io
    from read_tpu_torch.scene import camera
    from read_tpu_torch.scene import io as IO

    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("make_demo_scene: no CUDA device; pass --device "
                         "cpu to render with the plain twins")
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    xyz, rgb = build_world(rng, args.points)
    print(f"world: {xyz.shape[0]} points")

    os.makedirs(os.path.join(args.out, "images"), exist_ok=True)
    IO.write_ply(os.path.join(args.out, "pc.ply"), xyz, rgb)

    w, h = args.width, args.height
    fx = 720.0
    K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1]])
    np.savetxt(os.path.join(args.out, "cam.txt"),
               np.vstack([[w, h, 0], K]))
    P = camera.gl_projection(K, (w, h), znear=0.1, zfar=1000.0)
    views = drive_views(args.views)
    np.savetxt(os.path.join(args.out, "poses.dat"),
               np.stack(views).reshape(-1, 4))

    matrices = [camera.total_matrix(P, v) for v in views]
    for i, (_, img) in enumerate(render_targets(xyz, rgb, matrices, h, w,
                                                device)):
        image_io.write_png(os.path.join(args.out, "images", f"{i:06}.png"),
                           img)
        if i % 20 == 0:
            print(f"rendered target {i}/{args.views}")

    with open(os.path.join(args.out, "scene.yaml"), "w") as f:
        f.write(f"viewport_size: [{w}, {h}]\n"
                "pointcloud: pc.ply\n"
                "intrinsic_matrix: cam.txt\n"
                "view_matrix: poses.dat\n")
    out = os.path.abspath(args.out)
    with open(os.path.join(args.out, "paths.yaml"), "w") as f:
        f.write("datasets:\n"
                "  demo_drive:\n"
                f"    scene_path: {out}/scene.yaml\n"
                f"    target_path: {out}/images\n"
                "    target_name: '{label:06d}.png'\n")
    print(f"scene ready at {args.out} in "
          f"{time.perf_counter() - t0:.3f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
