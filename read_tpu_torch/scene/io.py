"""Scene data IO: PLY point clouds and meshes, Metashape XML, txt/ini
poses, YAML scene manifests.

The port's copy of the parts of ``read_tpu/scene/io.py`` that
``load_scene_data`` (:336-428) calls: ``read_ply`` (:54-158, without
the native ascii fast path: ascii clouds go through ``np.loadtxt``),
``write_ply`` (:161-194),
``import_model3d``, the intrinsics and extrinsics readers,
``get_valid_matrices`` and ``fix_relative_path``. The manifest keys,
relative-path resolution and returned dict are the same. Where PyYAML
is missing the manifest must be JSON, and where cv2 is missing a
texture image must be PNG.
"""

from __future__ import annotations

import configparser
import os
import xml.etree.ElementTree as ET
import numpy as np

from read_tpu_torch.scene import camera

__all__ = ["read_ply", "write_ply", "import_model3d", "load_scene_data",
           "intrinsics_from_xml", "intrinsics_from_ini",
           "intrinsics_from_txt", "extrinsics_from_xml",
           "extrinsics_from_txt", "extrinsics_from_view_matrix",
           "get_valid_matrices", "fix_relative_path", "mesh_inputs"]

_PLY_DTYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def _read_header(f, path):
    if f.readline().strip() != b"ply":
        raise ValueError(f"{path}: not a PLY file")
    fmt, elements, comments, cur = None, [], [], None
    while True:
        line = f.readline()
        if not line:
            raise ValueError(f"{path}: unterminated header")
        tok = line.decode("ascii", "replace").strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "comment":
            comments.append(" ".join(tok[1:]))
        elif tok[0] == "element":
            cur = (tok[1], int(tok[2]), [])
            elements.append(cur)
        elif tok[0] == "property":
            if tok[1] == "list":
                cur[2].append(("list", _PLY_DTYPES[tok[2]],
                               _PLY_DTYPES[tok[3]], tok[4]))
            else:
                cur[2].append((tok[-1], _PLY_DTYPES[tok[1]]))
        elif tok[0] == "end_header":
            return fmt, elements, comments


def _read_ascii(text, elements, out):
    row = 0
    for name, count, props in elements:
        if any(p[0] == "list" for p in props):
            faces = []
            for i in range(count):
                vals = text[row + i].split()
                faces.append([int(v) for v in vals[1:1 + int(vals[0])]])
            out[name] = {"_list": faces}
            if name == "face":
                out["face"] = np.asarray(faces, np.int64)
        else:
            arr = np.loadtxt(text[row:row + count], ndmin=2)
            out[name] = {p[0]: arr[:, j].astype(p[1])
                         for j, p in enumerate(props)}
        row += count
    return out


def _read_binary(buf, endian, elements, out):
    off = 0
    for name, count, props in elements:
        if any(p[0] == "list" for p in props):
            _, idx_dt, val_dt, _ = props[0]
            idx_size = np.dtype(idx_dt).itemsize
            val_size = np.dtype(val_dt).itemsize
            if count == 0:
                out[name] = {}
                continue
            first_n = int(np.frombuffer(buf, endian + idx_dt, 1, off)[0])
            stride = idx_size + first_n * val_size
            block = np.frombuffer(buf, np.uint8, count * stride, off)
            rows = block.reshape(count, stride)
            ns = rows[:, :idx_size].copy().view(endian + idx_dt)[:, 0]
            if (ns == first_n).all():       # uniform polygons
                vals = rows[:, idx_size:].copy().view(endian + val_dt)
                out[name] = {"_list": vals}
                if name == "face":
                    out["face"] = vals.astype(np.int64)
                off += count * stride
            else:                           # ragged lists
                faces, o = [], off
                for _ in range(count):
                    n = int(np.frombuffer(buf, endian + idx_dt, 1, o)[0])
                    o += idx_size
                    faces.append(np.frombuffer(buf, endian + val_dt, n, o))
                    o += n * val_size
                out[name] = {"_list": faces}
                off = o
        else:
            dt = np.dtype([(p[0], endian + p[1]) for p in props])
            arr = np.frombuffer(buf, dt, count, off)
            out[name] = {p[0]: arr[p[0]] for p in props}
            off += dt.itemsize * count
    return out


def read_ply(path: str) -> dict:
    """Parse a PLY file (ascii, binary little or big endian). Returns
    ``{'vertex': {prop: np.ndarray}, 'face': faces [M, k] int or None,
    'comments': [...]}``."""
    with open(path, "rb") as f:
        fmt, elements, comments = _read_header(f, path)
        out = {"comments": comments, "face": None}
        if fmt == "ascii":
            return _read_ascii(f.read().decode("ascii").split("\n"),
                               elements, out)
        endian = "<" if fmt == "binary_little_endian" else ">"
        return _read_binary(f.read(), endian, elements, out)


def write_ply(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Write a point cloud as a binary little-endian PLY: float32 xyz and
    uchar rgb (``rgb`` float in [0, 1] is clipped and scaled by 255,
    truncated; uint8 is written as it is), byte for byte as
    ``read_tpu``'s ``write_ply`` writes it."""
    n = xyz.shape[0]
    props = [("x", "f4"), ("y", "f4"), ("z", "f4"),
             ("red", "u1"), ("green", "u1"), ("blue", "u1")]
    arr = np.empty(n, np.dtype([(p, "<" + d) for p, d in props]))
    arr["x"], arr["y"], arr["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    r8 = (rgb if rgb.dtype == np.uint8
          else (np.clip(rgb, 0, 1) * 255).astype(np.uint8))
    arr["red"], arr["green"], arr["blue"] = r8[:, 0], r8[:, 1], r8[:, 2]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property {'float' if d == 'f4' else 'uchar'} {p}"
               for p, d in props]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(arr.tobytes())


def _xyz_colors(xyz: np.ndarray) -> np.ndarray:
    """Bbox-normalized position colors."""
    mmin, mmax = xyz.min(axis=0), xyz.max(axis=0)
    color = (xyz - mmin) / np.maximum(mmax - mmin, 1e-12)
    return np.clip(color, 0.0, 1.0).astype(np.float32)


def import_model3d(model_path: str, is_mesh: bool = False) -> dict:
    """A PLY point cloud or mesh as the scene dict's model: keys xyz,
    rgb (white*255 when the file has none, as the reference), normals,
    uv2d, uv1d, faces, xyz_c."""
    ply = read_ply(model_path)
    v = ply["vertex"]
    xyz = np.stack([np.asarray(v["x"], np.float64),
                    np.asarray(v["y"], np.float64),
                    np.asarray(v["z"], np.float64)], axis=1)
    n_pts = xyz.shape[0]
    model = {"rgb": None, "normals": None, "uv2d": None, "faces": None}
    if {"red", "green", "blue"} <= set(v):
        model["rgb"] = np.stack([v["red"], v["green"], v["blue"]],
                                axis=1).astype(np.float32) / 255.0
    if {"nx", "ny", "nz"} <= set(v):
        model["normals"] = np.stack([v["nx"], v["ny"], v["nz"]],
                                    axis=1).astype(np.float32)
    if is_mesh:
        if {"s", "t"} <= set(v):
            model["uv2d"] = np.stack([v["s"], v["t"]], axis=1).astype(
                np.float32)
        elif {"u", "v"} <= set(v):
            model["uv2d"] = np.stack([v["u"], v["v"]], axis=1).astype(
                np.float32)
        if ply["face"] is not None:
            model["faces"] = np.asarray(ply["face"]).reshape(-1).astype(
                np.uint32)
    else:
        model["uv2d"] = np.zeros((n_pts, 2), np.float32)
    model["xyz"] = xyz
    model["xyz_c"] = _xyz_colors(xyz)
    model["uv1d"] = np.arange(n_pts)
    if model["rgb"] is None:
        model["rgb"] = np.ones((n_pts, 3), np.float32) * 255
    return model


def intrinsics_from_xml(xml_file: str):
    """Metashape calibration: f with the principal point at the image
    centre. Returns ``(K, (width, height))``."""
    calibration = ET.parse(xml_file).getroot().find(
        "chunk/sensors/sensor/calibration")
    resolution = calibration.find("resolution")
    width = float(resolution.get("width"))
    height = float(resolution.get("height"))
    f = float(calibration.find("f").text)
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]],
                 np.float32)
    return K, (width, height)


def intrinsics_from_ini(ini_path: str):
    conf = configparser.ConfigParser()
    conf.read(ini_path)
    k = np.array(conf.get("SceneCameraParams", "K").split(), np.float64)
    K = np.array([[k[0], 0, k[2]], [0, k[1], k[3]], [0, 0, 1]], np.float32)
    size = [int(conf.get("SceneCameraParams", "w")),
            int(conf.get("SceneCameraParams", "h"))]
    return K, size


def intrinsics_from_txt(cam_txt: str):
    tmp = np.loadtxt(cam_txt)
    return tmp[1:].astype(np.float32), [int(tmp[0, 0]), int(tmp[0, 1])]


def extrinsics_from_xml(xml_file: str, verbose: bool = False):
    """Metashape camera transforms with columns 1:3 negated (cv -> gl).
    Returns ``(list of 4x4 camera-to-world, labels)``."""
    root = ET.parse(xml_file).getroot()
    transforms = {}
    for e in root.findall("chunk/cameras")[0].findall("camera"):
        t = e.find("transform")
        if t is None or t.text is None:
            if verbose:
                print("failed to align camera", e.get("label"))
            continue
        transforms[e.get("label")] = t.text
    view_matrices = []
    for text in transforms.values():
        m = np.array([float(x) for x in text.split()]).reshape(4, 4)
        m[:, 1:3] *= -1
        view_matrices.append(m)
    return view_matrices, list(transforms)


def extrinsics_from_txt(pose_path: str):
    """Flat txt of 4x4 poses plus the sibling ``images`` name list; the
    same cv -> gl column flip."""
    mats = np.loadtxt(pose_path).reshape(-1, 4, 4)
    mats[:, :, 1:3] *= -1
    parts = pose_path.split("/")
    parts[-1] = parts[-1].replace("poses", "images")
    img_names = np.loadtxt("/".join(parts), dtype="str")
    return list(mats), list(np.atleast_1d(img_names))


def extrinsics_from_view_matrix(path: str):
    vm, ids = get_valid_matrices(np.loadtxt(path).reshape(-1, 4, 4))
    return vm, [str(i) for i in ids]


def get_valid_matrices(mlist):
    """Drop non-finite matrices; returns ``(matrices, their indices)``."""
    ilist, vmlist = [], []
    for i, m in enumerate(mlist):
        if np.isfinite(m).all():
            ilist.append(i)
            vmlist.append(m)
    return vmlist, ilist


def fix_relative_path(path: str, config_path: str) -> str:
    if not os.path.exists(path) and not os.path.isabs(path):
        abspath = os.path.join(os.path.dirname(config_path), path)
        if os.path.exists(abspath):
            return abspath
    return path


def _intrinsics(apath: str, config: dict):
    if apath.endswith("xml"):
        K, (w, h) = intrinsics_from_xml(apath)
        assert tuple(config["viewport_size"]) == (w, h), \
            f"calibration size ({w}, {h}) != viewport_size"
        return K
    if apath.endswith("ini"):
        return intrinsics_from_ini(apath)[0]
    if apath.endswith("txt"):
        return intrinsics_from_txt(apath)[0]
    return np.loadtxt(apath)[:3, :3]


def _extrinsics(apath: str):
    if apath.endswith("xml"):
        return extrinsics_from_xml(apath)
    if apath.endswith("txt"):
        return extrinsics_from_txt(apath)
    return extrinsics_from_view_matrix(apath)


def load_scene_data(path: str) -> dict:
    """Load a scene manifest (YAML with PyYAML, else JSON; through
    :mod:`read_tpu_torch.utils.config_io`) into the scene-data dict:
    pointcloud, point_sizes, mesh, texture, proj_matrix,
    intrinsic_matrix, view_matrix, camera_labels, model3d_origin,
    config, net_ckpt, tex_ckpt. A ``texture`` image is read with
    :func:`read_tpu_torch.data.image_io.imread_color` (PNG without
    cv2)."""
    from read_tpu_torch.data import image_io
    from read_tpu_torch.utils import config_io

    config = config_io.load(path)

    def rel(key):
        return fix_relative_path(config[key], path)

    pointcloud = (import_model3d(rel("pointcloud"))
                  if config.get("pointcloud") else None)
    mesh = (import_model3d(rel("mesh"), is_mesh=True)
            if config.get("mesh") else None)
    texture = None
    if config.get("texture"):
        texture = image_io.imread_color(rel("texture"))[..., ::-1].copy()

    intrinsic_matrix = (_intrinsics(rel("intrinsic_matrix"), config)
                        if "intrinsic_matrix" in config else None)
    proj_matrix = (camera.rewrite_near_far(np.loadtxt(rel("proj_matrix")))
                   if "proj_matrix" in config else None)
    view_matrix, camera_labels = (_extrinsics(rel("view_matrix"))
                                  if "view_matrix" in config
                                  else (None, None))
    model3d_origin = (np.loadtxt(rel("model3d_origin"))
                      if "model3d_origin" in config else np.eye(4))
    point_sizes = (np.load(rel("point_sizes"))
                   if "point_sizes" in config else None)
    config["viewport_size"] = (tuple(config["viewport_size"])
                               if "viewport_size" in config else None)

    net_ckpt, tex_ckpt = "", ""
    if "net_path" in config:
        ckpts = os.path.join(config["net_path"], "checkpoints")
        net_ckpt = fix_relative_path(os.path.join(ckpts, config["ckpt"]),
                                     path)
        tex_ckpt = fix_relative_path(
            os.path.join(ckpts, config["texture_ckpt"]), path)

    if "data_ratio" in config and view_matrix is not None:
        n = int(len(view_matrix) * config["data_ratio"])
        view_matrix = view_matrix[:n]
        camera_labels = camera_labels[:n]

    return {
        "pointcloud": pointcloud,
        "point_sizes": point_sizes,
        "mesh": mesh,
        "texture": texture,
        "proj_matrix": proj_matrix,
        "intrinsic_matrix": intrinsic_matrix,
        "view_matrix": view_matrix,
        "camera_labels": camera_labels,
        "model3d_origin": model3d_origin,
        "config": config,
        "net_ckpt": net_ckpt,
        "tex_ckpt": tex_ckpt,
    }


def mesh_inputs(scene_data: dict):
    """``(uv2d [N, 2] float32, faces [T, 3] int32 or None)`` for mesh
    textures. ``read_tpu`` reads both from the point cloud, where a PLY
    point cloud gives zero uv and no faces, so from a manifest it never
    reaches its triangle raster; here a manifest's ``mesh`` with the
    point cloud's vertex count (its vertices are the points) lends its
    texture coordinates and faces when the point cloud has no faces."""
    pc = scene_data["pointcloud"]
    src = pc
    mesh = scene_data.get("mesh")
    if pc.get("faces") is None and mesh is not None \
            and mesh.get("faces") is not None and mesh.get("uv2d") is not None \
            and len(mesh["xyz"]) == len(pc["xyz"]):
        src = mesh
    uv2d = np.asarray(src["uv2d"], np.float32)
    faces = src.get("faces")
    if faces is not None:
        faces = np.asarray(faces, np.int64).reshape(-1, 3).astype(np.int32)
    return uv2d, faces
