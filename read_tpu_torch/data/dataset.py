"""Host-side view dataset: image loading, crop-homography sampling.

The port's copy of ``read_tpu/data/dataset.py``: ``ViewDataset``,
``BatchIterator``, ``PrefetchIterator`` and ``load_image``, with the
same crop homographies and the same draws from ``np.random.default_rng
(seed)``, so one seed gives the same crops. The host loads and warps
images; rasterization runs on the device inside the train step.

- znear 0.1, zfar 1000.
- train: an inner batch of crops per view, each the farthest-centre pick
  among ``inner_sample`` random zoom+shift homographies, with ``K_crop =
  H @ K_src`` and its own GL projection; ``num_samples`` multiplies the
  epoch length; ``crop_by_mask`` centres crops on mask pixels.
- val: the full frame at the /16-aligned size, ``K`` rescaled to it.
- masks and labels are loaded and warped beside the targets; missing ->
  ones / zeros.

``read_tpu`` warps with ``cv2.warpPerspective``; here
:func:`warp_perspective` is one numpy warp, used with or without
``cv2``: the inverse map, bilinear or nearest, border constant 0. It
follows the vector path of OpenCV 5's warp: the 3x3 inverse by cofactors
in float64, source coordinates in float32 (each row's offsets multiplied
and added, the column term fused), nearest rounding half to even, and
bilinear as three fused lerps of float32 samples; OpenCV's scalar tail
(the last columns of a row whose width is not a multiple of its vector
step) rounds the column term separately. Each item returns ``total_m =
proj @ view`` composed on the host, one matrix per crop.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np

from read_tpu_torch.data import image_io
from read_tpu_torch.scene import camera

__all__ = ["ViewDataset", "load_image", "BatchIterator",
           "PrefetchIterator", "warp_perspective"]

ZNEAR = 0.1
ZFAR = 1000.0


@lru_cache(maxsize=1000)
def _load_image_cached(path: str) -> np.ndarray:
    img = image_io.imread(path)
    if img.ndim == 3:
        img = img[..., [2, 1, 0]]  # BGR -> RGB
    return img


def load_image(path: str) -> np.ndarray:
    """BGR->RGB image load with an LRU cache."""
    return _load_image_cached(path)


def _any2float(img: np.ndarray) -> np.ndarray:
    """uint8/uint16 -> [0,1] float."""
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    if img.dtype == np.uint16:
        return img.astype(np.float32) / 65535.0
    return img.astype(np.float32)


def _rnd_crop_center_from_mask(mask: np.ndarray,
                               rng: np.random.Generator,
                               factor: int = 8):
    """Pick a random foreground pixel as crop center, sampling the mask
    at a ``factor``-downsampled grid. Returns ``(x, y)`` source-pixel
    coords, or None for an empty mask."""
    down = mask[::factor, ::factor]
    ys, xs = np.nonzero(down > 0)
    if len(ys) == 0:
        return None
    i = rng.integers(len(ys))
    return float(xs[i] * factor), float(ys[i] * factor)


def _inverse3(S: np.ndarray) -> np.ndarray:
    """OpenCV's 3x3 inverse (``cv::invert``, LU method): the cofactors
    times ``1 / det`` in float64, in its order of operations."""
    det = (S[0, 0] * (S[1, 1] * S[2, 2] - S[1, 2] * S[2, 1])
           - S[0, 1] * (S[1, 0] * S[2, 2] - S[1, 2] * S[2, 0])
           + S[0, 2] * (S[1, 0] * S[2, 1] - S[1, 1] * S[2, 0]))
    if det == 0:
        raise np.linalg.LinAlgError("singular homography")
    d = 1.0 / det
    t = np.empty((3, 3), np.float64)
    t[0, 0] = (S[1, 1] * S[2, 2] - S[1, 2] * S[2, 1]) * d
    t[0, 1] = (S[0, 2] * S[2, 1] - S[0, 1] * S[2, 2]) * d
    t[0, 2] = (S[0, 1] * S[1, 2] - S[0, 2] * S[1, 1]) * d
    t[1, 0] = (S[1, 2] * S[2, 0] - S[1, 0] * S[2, 2]) * d
    t[1, 1] = (S[0, 0] * S[2, 2] - S[0, 2] * S[2, 0]) * d
    t[1, 2] = (S[0, 2] * S[1, 0] - S[0, 0] * S[1, 2]) * d
    t[2, 0] = (S[1, 0] * S[2, 1] - S[1, 1] * S[2, 0]) * d
    t[2, 1] = (S[0, 1] * S[2, 0] - S[0, 0] * S[2, 1]) * d
    t[2, 2] = (S[0, 0] * S[1, 1] - S[0, 1] * S[1, 0]) * d
    return t


def _fma32(a, b, c) -> np.ndarray:
    """``a * b + c`` of float32 operands with one rounding to float32
    (the float64 product is exact)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def warp_perspective(image: np.ndarray, H: np.ndarray,
                     size: Tuple[int, int],
                     nearest: bool = False) -> np.ndarray:
    """``cv2.warpPerspective(image, H, size, INTER_LINEAR or
    INTER_NEAREST)`` with border constant 0: output pixel ``(x, y)``
    samples ``image`` at ``H^-1 (x, y, 1)``. ``size`` is ``(w, h)``;
    ``image`` is ``[h0, w0]`` or ``[h0, w0, C]``, float32 for bilinear,
    any dtype for nearest."""
    w, h = int(size[0]), int(size[1])
    if not nearest and image.dtype != np.float32:
        raise ValueError(f"bilinear warp of {image.dtype}; want float32")
    M = _inverse3(np.asarray(H, np.float64)).astype(np.float32)
    xs = np.arange(w, dtype=np.float32)[None]
    ys = np.arange(h, dtype=np.float32)[:, None]
    src = []
    for i in range(3):   # row offsets in float32, the column term fused
        row = M[i, 1] * ys + M[i, 2]
        src.append(_fma32(M[i, 0], xs, row))
    with np.errstate(divide="ignore", invalid="ignore"):
        fx, fy = src[0] / src[2], src[1] / src[2]
    h0, w0 = image.shape[:2]
    # out-of-range and non-finite coordinates sample the zero border
    fx = np.clip(np.nan_to_num(fx, nan=-4.0), -4.0, w0 + 4.0)
    fy = np.clip(np.nan_to_num(fy, nan=-4.0), -4.0, h0 + 4.0)
    pad = np.zeros((h0 + 2, w0 + 2) + image.shape[2:], image.dtype)
    pad[1:-1, 1:-1] = image

    def tap(iy, ix):
        return pad[np.clip(iy, -1, h0) + 1, np.clip(ix, -1, w0) + 1]

    if nearest:
        return tap(np.rint(fy).astype(np.int64),
                   np.rint(fx).astype(np.int64))
    x0 = np.floor(fx).astype(np.int64)
    y0 = np.floor(fy).astype(np.int64)
    a = fx - x0.astype(np.float32)
    b = fy - y0.astype(np.float32)
    if image.ndim == 3:
        a, b = a[..., None], b[..., None]
    p00, p01 = tap(y0, x0), tap(y0, x0 + 1)
    p10, p11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    top = _fma32(a, p01 - p00, p00)
    bottom = _fma32(a, p11 - p10, p10)
    return _fma32(b, bottom - top, top)


class ViewDataset:
    """Map-style dataset over one scene's posed views."""

    def __init__(self, phase: str, scene_data: dict,
                 image_size,
                 view_list: Sequence[np.ndarray],
                 target_list: Sequence[str],
                 mask_list: Optional[Sequence[Optional[str]]] = None,
                 label_list: Optional[Sequence[Optional[str]]] = None,
                 num_samples: int = 1,
                 inner_batch: int = 4,
                 inner_sample: int = 8,
                 random_zoom: Optional[Sequence[float]] = None,
                 random_shift: Optional[Sequence[float]] = None,
                 drop_points: float = 0.0,
                 perturb_points: float = 0.0,
                 crop_by_mask: bool = False,
                 supersampling: int = 1,
                 seed: int = 0):
        assert phase in ("train", "val")
        self.phase = phase
        if isinstance(image_size, (int, float)):
            image_size = (int(image_size), int(image_size))
        self.scene_data = scene_data
        self.K_src = np.asarray(scene_data["intrinsic_matrix"], np.float64)
        old_size = scene_data["config"]["viewport_size"]
        self.src_sh = np.array(old_size)  # (w, h)
        # val renders at full size rounded down to /16
        self.tgt_sh = (self.src_sh // 16) * 16
        if phase == "train":
            self.tgt_sh = np.array(image_size)
        assert len(view_list) == len(target_list)
        self.view_list = [np.asarray(v, np.float64) for v in view_list]
        self.target_list = list(target_list)
        self.mask_list = list(mask_list) if mask_list else [None] * len(
            target_list)
        self.label_list = list(label_list) if label_list else [None] * len(
            target_list)
        self.num_samples_mult = num_samples if phase == "train" else 1
        self.inner_batch = inner_batch
        self.inner_sample = inner_sample
        self.random_zoom = random_zoom
        self.random_shift = random_shift
        self.drop_points = drop_points
        self.perturb_points = perturb_points
        self.crop_by_mask = crop_by_mask
        self.ss = supersampling
        self.id: int = 0       # scene id, assigned by get_datasets
        self.name: str = ""
        self.rng = np.random.default_rng(seed)

    # -- length / epoch control ------------------------------------------
    def __len__(self):
        return len(self.view_list) * self.num_samples_mult

    @property
    def n_points(self) -> int:
        return self.scene_data["pointcloud"]["xyz"].shape[0]

    # -- crop homographies -----------------------------------------------
    def random_image_crop(self,
                          mask: Optional[np.ndarray] = None
                          ) -> np.ndarray:
        """Zoom+shift homography.

        With ``crop_by_mask`` and a non-empty ``mask``, the shift is
        chosen so a random mask-foreground pixel lands at the crop
        center (clamped to keep the crop inside the image) instead of a
        uniform draw."""
        H = np.eye(3)
        min_zoom_xy = self.tgt_sh / self.src_sh
        z = max(min_zoom_xy[0], min_zoom_xy[1])
        if self.random_zoom:
            z = self.rng.uniform(max(self.random_zoom[0], z),
                                 self.random_zoom[1])
        cnt = None
        if self.crop_by_mask and mask is not None:
            cnt = _rnd_crop_center_from_mask(mask, self.rng)
        if cnt is not None:
            # shift so z*cnt + t == tgt_sh/2; clamp into the valid range
            max_shift = np.maximum(self.src_sh * z - self.tgt_sh, 0)
            t = self.tgt_sh * 0.5 - z * np.asarray(cnt)
            H[0, 2] = float(np.clip(t[0], -max_shift[0], 0))
            H[1, 2] = float(np.clip(t[1], -max_shift[1], 0))
        elif self.random_shift:
            max_shift = self.src_sh * z - self.tgt_sh
            H[0, 2] = -self.rng.uniform(0, max(max_shift[0], 0))
            H[1, 2] = -self.rng.uniform(0, max(max_shift[1], 0))
        H[0, 0] = H[1, 1] = z
        return H

    def get_transform_crop(self, inner_batch: Optional[int] = None,
                           inner_sample: Optional[int] = None,
                           mask: Optional[np.ndarray] = None) -> list:
        """Farthest-center crop selection: per crop, draw
        ``inner_sample`` candidates and keep the one farthest from already
        chosen crop centers. ``mask`` activates mask-centered candidates
        when the dataset was built with ``crop_by_mask``."""
        inner_batch = inner_batch or self.inner_batch
        inner_sample = inner_sample or self.inner_sample
        c = self.tgt_sh * 0.5
        centers, Hs = [], []
        for _ in range(inner_batch):
            best, best_c, best_dis = None, None, -1.0
            for j in range(inner_sample):
                H = self.random_image_crop(mask)
                Hi = np.linalg.inv(H)
                c_trans = np.array([Hi[0, 0] * c[0] + Hi[0, 2],
                                    Hi[1, 1] * c[1] + Hi[1, 2]])
                if centers:
                    dis = min(np.linalg.norm(c_trans - c2)
                              for c2 in centers)
                else:
                    dis = 0.0
                if j == 0 or dis > best_dis:
                    best, best_c, best_dis = H, c_trans, dis
            centers.append(best_c)
            Hs.append(best)
        return Hs

    # -- warping -----------------------------------------------------------
    def _warp(self, image: np.ndarray, H: np.ndarray,
              nearest: bool = False) -> np.ndarray:
        return warp_perspective(image, H, tuple(int(x) for x in self.tgt_sh),
                                nearest=nearest)

    # -- item --------------------------------------------------------------
    def __getitem__(self, idx: int) -> dict:
        """Returns (train) stacked inner-batch arrays:
        ``total_m [IB,4,4] f32``, ``target [IB,h,w,3]``, ``mask
        [IB,h,w,1]``, ``label [IB,h,w] int32``, ``view_matrix``, ``K``,
        ``id``; (val) the same without the IB axis.
        """
        idx = idx % len(self.view_list)
        view = self.view_list[idx]
        target = _any2float(load_image(self.target_list[idx]))
        if target.ndim == 2:
            target = target[..., None].repeat(3, -1)
        target = target[..., :3]

        mask = None
        if self.mask_list[idx]:
            mask = (_any2float(load_image(self.mask_list[idx])))
            if mask.ndim == 3:
                mask = mask[..., 0]
        label = None
        if self.label_list[idx]:
            label = load_image(self.label_list[idx])
            if label.ndim == 3:
                label = label[..., 0]

        w, h = int(self.tgt_sh[0]), int(self.tgt_sh[1])
        if self.phase == "train":
            Hs = self.get_transform_crop(mask=mask)
            Ks = [H @ self.K_src for H in Hs]
            targets = np.stack([self._warp(target, H) for H in Hs])
            if mask is None:
                masks = np.ones((len(Hs), h, w), np.float32)
            else:
                masks = np.stack([self._warp(mask, H) for H in Hs])
            if label is None:
                labels = np.zeros((len(Hs), h, w), np.int32)
            else:
                labels = np.stack(
                    [self._warp(label, H, nearest=True) for H in Hs]
                ).astype(np.int32)
            projs = [camera.gl_projection(K, (w, h), ZNEAR, ZFAR)
                     for K in Ks]
            total_m = np.stack(
                [camera.total_matrix(P, view) for P in projs]
            ).astype(np.float32)
            return {
                "total_m": total_m,
                "view_matrix": np.stack([view] * len(Hs)).astype(
                    np.float32),
                "intrinsic_matrix": np.stack(Ks).astype(np.float32),
                "target": targets.astype(np.float32),
                "mask": masks[..., None].astype(np.float32),
                "label": labels,
                "id": np.full((len(Hs),), self.id, np.int32),
                "target_filename": [self.target_list[idx]] * len(Hs),
            }

        # val: full-frame at /16-aligned size
        K = camera.rescale_K(self.K_src, self.tgt_sh[0] / self.src_sh[0],
                             self.tgt_sh[1] / self.src_sh[1],
                             keep_fov=True)
        Hm = K @ np.linalg.inv(self.K_src)
        target = self._warp(target, Hm)
        if mask is None:
            mask = np.ones((h, w), np.float32)
        else:
            mask = self._warp(mask, Hm)
        if label is None:
            label = np.zeros((h, w), np.int32)
        else:
            label = self._warp(label, Hm, nearest=True).astype(np.int32)
        P = camera.gl_projection(K, (w, h), ZNEAR, ZFAR)
        return {
            "total_m": camera.total_matrix(P, view).astype(np.float32),
            "view_matrix": view.astype(np.float32),
            "intrinsic_matrix": K.astype(np.float32),
            "target": target.astype(np.float32),
            "mask": mask[..., None].astype(np.float32),
            "label": label,
            "id": np.int32(self.id),
            "target_filename": self.target_list[idx],
        }


class BatchIterator:
    """Minimal shuffling batch loader: collates ``batch_size`` dataset
    items (train items already carry an inner-batch axis, flattened
    here)."""

    def __init__(self, dataset: ViewDataset, batch_size: int = 2,
                 shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.ds) // self.batch_size
        if not self.drop_last and len(self.ds) % self.batch_size:
            n += 1
        return n

    def __iter__(self):
        order = np.arange(len(self.ds))
        if self.shuffle:
            self.rng.shuffle(order)
        for i in range(len(self)):
            items = [self.ds[j] for j in
                     order[i * self.batch_size:(i + 1) * self.batch_size]]
            batch = {}
            for k in ("total_m", "target", "mask", "label", "id",
                      "view_matrix"):
                vals = [np.asarray(it[k]) for it in items]
                v = np.stack(vals)
                if self.ds.phase == "train":
                    # flatten (B, IB, ...) -> (B*IB, ...)
                    v = v.reshape((-1,) + v.shape[2:])
                batch[k] = v
            batch["target_filename"] = [
                f for it in items
                for f in (it["target_filename"]
                          if isinstance(it["target_filename"], list)
                          else [it["target_filename"]])]
            yield batch


class PrefetchIterator:
    """Background-thread prefetch over a batch iterator.

    One worker thread loads and warps the next ``depth`` batches while
    the device runs the current step; numpy releases the GIL in its
    array loops, and ``zlib`` does while it inflates a PNG. A consumer
    that stops early (``break``, as ``--max-steps-per-epoch`` does)
    stops the worker too: closing the generator waits for the item in
    progress and joins the thread, so no worker outlives its loop.
    """

    def __init__(self, iterator, depth: int = 2):
        self.iterator = iterator
        self.depth = depth

    def __len__(self):
        return len(self.iterator)

    def __iter__(self):
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        _END = object()
        err = []

        def worker():
            try:
                for item in self.iterator:
                    if stop.is_set():
                        return
                    q.put(item)
            except BaseException as e:  # surface in the consumer
                err.append(e)
            finally:
                q.put(_END)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                yield item
        finally:
            stop.set()
            while t.is_alive():   # unblock a worker waiting to put
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            t.join()
        if err:
            raise err[0]
