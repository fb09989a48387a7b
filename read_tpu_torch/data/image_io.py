"""Image files for the host data path, with ``cv2`` when it is there.

``read_tpu`` reads targets, masks and labels with ``cv2.imread(path,
IMREAD_UNCHANGED)`` (``read_tpu/data/dataset.py:52-64``) and writes its
image dumps with ``imageio``. The port reads through :func:`imread`:
``cv2`` where it imports, else its own PNG decoder over ``zlib``,
``struct`` and numpy (8 and 16 bits; gray, gray+alpha, RGB and RGBA;
all five row filters; not interlaced, no palette). The decoder returns
what ``cv2`` returns: the channels in BGR(A) order, gray+alpha as BGRA
with the gray repeated, 16-bit samples as ``uint16``. PNG is lossless,
so both readers give the same array. Other formats need ``cv2``.

:func:`imwrite` takes RGB(A) order, as ``imageio`` does, and writes PNG
with the port's own encoder; other formats go through ``cv2`` and raise
an error naming the format where it is missing.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

__all__ = ["imread", "imread_color", "imwrite", "read_png", "write_png",
           "PNG_SIGNATURE"]

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel (no palette type 3)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _format_of(path: str) -> str:
    return os.path.splitext(path)[1].lower().lstrip(".") or "(none)"


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def _chunks(data: bytes, path: str):
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: no IEND chunk")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(ftype: np.ndarray, filt: np.ndarray,
                   bpp: int) -> np.ndarray:
    """Rows that use only None, Sub and Up: one numpy pass per row."""
    h, stride = filt.shape
    out = np.empty_like(filt)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        t, f = ftype[r], filt[r]
        if t == 0:
            cur = f
        elif t == 1:      # running sum along each byte lane, mod 256
            cur = np.cumsum(f.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        else:
            cur = f + prev
        out[r] = cur
        prev = out[r]
    return out


def _unfilter_wavefront(ftype: np.ndarray, filt: np.ndarray,
                        bpp: int) -> np.ndarray:
    """Any mix of the five filters. Pixel ``(r, x)`` depends on its left,
    upper and upper-left neighbours only, so every pixel of one
    anti-diagonal ``r + x = t`` is reconstructed in one numpy step."""
    h, stride = filt.shape
    w = stride // bpp
    f3 = filt.reshape(h, w, bpp).astype(np.int32)
    rec = np.zeros((h + 1, w + 1, bpp), np.int32)  # zero top row, left col
    for t in range(h + w - 1):
        rr = np.arange(max(0, t - w + 1), min(h - 1, t) + 1)
        xx = t - rr
        a, b, c = rec[rr + 1, xx], rec[rr, xx + 1], rec[rr, xx]
        typ = ftype[rr][:, None]
        pred = np.select([typ == 1, typ == 2, typ == 3, typ == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        rec[rr + 1, xx + 1] = (f3[rr, xx] + pred) & 255
    return rec[1:, 1:].astype(np.uint8).reshape(h, stride)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG as ``cv2.imread(path, IMREAD_UNCHANGED)`` does:
    ``[H, W]`` gray, else ``[H, W, 3|4]`` BGR(A); uint8 or uint16."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"tRNS":
            raise ValueError(f"{path}: PNG transparency chunks (tRNS) are "
                             "not supported without cv2")
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"{path}: PNG colour type {ctype}, bit depth "
                         f"{depth}, interlace {interlace} is not supported "
                         "without cv2 (8/16-bit gray, gray+alpha, RGB or "
                         "RGBA, not interlaced)")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError(f"{path}: image data too short")
    rows = raw[:h * (stride + 1)].reshape(h, stride + 1)
    ftype, filt = rows[:, 0], rows[:, 1:]
    if ftype.size and int(ftype.max()) > 4:
        raise ValueError(f"{path}: unknown PNG row filter "
                         f"{int(ftype.max())}")
    if ftype.size and int(ftype.max()) <= 2:
        flat = _unfilter_rows(ftype, filt, bpp)
    else:
        flat = _unfilter_wavefront(ftype, filt, bpp)
    if depth == 16:
        img = flat.view(">u2").astype(np.uint16)
    else:
        img = flat
    img = img.reshape(h, w, ch)
    if ch == 1:
        return np.ascontiguousarray(img[..., 0])
    if ch == 2:   # gray + alpha -> BGRA
        return np.ascontiguousarray(img[..., [0, 0, 0, 1]])
    order = [2, 1, 0] if ch == 3 else [2, 1, 0, 3]
    return np.ascontiguousarray(img[..., order])


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _filter_rows(raw: np.ndarray, bpp: int, ftype: int) -> np.ndarray:
    """Apply one PNG row filter to every row of ``raw [H, stride]``."""
    r = raw.astype(np.int32)
    a = np.zeros_like(r)
    a[:, bpp:] = r[:, :-bpp]
    b = np.zeros_like(r)
    b[1:] = r[:-1]
    c = np.zeros_like(r)
    c[1:, bpp:] = r[:-1, :-bpp]
    pred = (0, a, b, (a + b) >> 1, None)[ftype] if ftype < 4 \
        else _paeth(a, b, c)
    return ((r - pred) & 255).astype(np.uint8)


def write_png(path: str, img: np.ndarray, filter_type: int = 2) -> str:
    """Write ``img`` (``[H, W]`` gray, ``[H, W, 2]`` gray+alpha, ``[H, W,
    3|4]`` RGB(A), in that order, as ``imageio`` takes it; uint8 or
    uint16) as a PNG with every row under ``filter_type`` (0 None, 1 Sub,
    2 Up, 3 Average, 4 Paeth)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png: dtype {img.dtype}, want uint8 or "
                         "uint16")
    if filter_type not in range(5):
        raise ValueError(f"write_png: filter type {filter_type}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}.get(ch)
    if ctype is None:
        raise ValueError(f"write_png: {ch} channels")
    depth = 16 if img.dtype == np.uint16 else 8
    samples = img.astype(">u2") if depth == 16 else img
    raw = np.ascontiguousarray(samples).view(np.uint8).reshape(h, -1)
    filt = _filter_rows(raw, ch * depth // 8, filter_type)
    rows = np.concatenate([np.full((h, 1), filter_type, np.uint8), filt], 1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    data = (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)
    return path


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def imread(path: str) -> np.ndarray:
    """``cv2.imread(path, IMREAD_UNCHANGED)``: cv2 where installed, else
    :func:`read_png` (PNG only). Raises ``FileNotFoundError`` for a
    missing or unreadable file."""
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(path)
        return img
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        png = f.read(8) == PNG_SIGNATURE
    if not png:
        raise ValueError(f"{path}: reading {_format_of(path)!r} images "
                         "needs cv2; without it only PNG is read")
    return read_png(path)


def imread_color(path: str) -> np.ndarray:
    """``cv2.imread(path)`` (``IMREAD_COLOR``): ``[H, W, 3]`` uint8 BGR;
    gray is repeated, alpha dropped, 16-bit samples keep their high
    byte."""
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(path)
        return img
    img = imread(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def imwrite(path: str, img: np.ndarray) -> str:
    """Write an RGB(A) or gray image: PNG with :func:`write_png`, any
    other format through cv2 (channels flipped to its BGR order)."""
    if _format_of(path) == "png":
        return write_png(path, img)
    cv2 = _cv2()
    if cv2 is None:
        raise ValueError(f"{path}: writing {_format_of(path)!r} images "
                         "needs cv2; without it only PNG is written")
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] in (3, 4):
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    if not cv2.imwrite(path, np.ascontiguousarray(img)):
        raise ValueError(f"{path}: cv2 could not write it")
    return path
