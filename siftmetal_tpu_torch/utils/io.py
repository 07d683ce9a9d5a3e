"""Image I/O and the IPOL text interchange format, with numpy only.

Images are binary PGM/PPM (P5/P6) and PNG, read without an image library
(the card's machine has none): PNG through ``zlib`` and numpy, 8- and
16-bit, gray, gray+alpha, RGB, RGBA and palette, plain or Adam7
interlaced. The keypoint and descriptor text formats are those of
``siftmetal_tpu/utils/io.py`` and of the IPOL files in ``tests/fixtures``.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np


def _tokens(data: bytes, count: int, pos: int):
    """``count`` whitespace-separated header tokens from ``pos`` (skipping
    '#' comments); returns (tokens, position after the last one)."""
    out = []
    while len(out) < count:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while data[pos:pos + 1] not in (b"\n", b""):
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        out.append(data[start:pos])
    return out, pos


def read_pnm(path: str) -> np.ndarray:
    """Binary PGM (P5) or PPM (P6) -> uint8 [H, W] or [H, W, 3] (16-bit
    files -> uint16)."""
    with open(path, "rb") as f:
        data = f.read()
    (magic, w, h, maxval), pos = _tokens(data, 4, 0)
    if magic not in (b"P5", b"P6"):
        raise ValueError(f"{path}: not a binary PGM/PPM (magic {magic!r})")
    w, h, maxval = int(w), int(h), int(maxval)
    pos += 1  # the single whitespace byte before the raster
    ch = 3 if magic == b"P6" else 1
    dt = np.dtype(np.uint8) if maxval < 256 else np.dtype(">u2")
    n = h * w * ch
    arr = np.frombuffer(data, dtype=dt, count=n, offset=pos)
    arr = arr.reshape((h, w, ch) if ch == 3 else (h, w))
    return arr.astype(np.uint8 if maxval < 256 else np.uint16)


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Channels of each PNG colour type: gray, RGB, palette, gray+alpha, RGBA.
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7 passes: (first row, first column, row step, column step).
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _png_chunks(data: bytes, path: str):
    pos = len(_PNG_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: corrupt PNG chunk {kind!r}")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: PNG without IEND")


def _unfilter(raw: np.ndarray, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the PNG scanline filters of an [h, 1 + row_bytes] byte block
    (filter type first in each row) -> [h, row_bytes] uint8.

    A byte depends on the one ``bpp`` bytes to its left, the one above and
    the one above-left, so every pixel (row r, column p) with the same
    r + p can be computed together: the rows are skewed one pixel right
    each, and the wavefront moves one column of the skewed array a step."""
    ft = raw[:, 0].astype(np.int16)
    if ft.max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {int(ft.max())}")
    w = row_bytes // bpp
    x = raw[:, 1:].reshape(h, w, bpp).astype(np.int16)
    # Skewed layout: pixel (r, p) at [r + 1, 1 + p + r]; row 0 and column 0
    # are the zeros a row's missing neighbours read.
    s = np.zeros((h + 1, w + h + 1, bpp), np.int16)
    f = np.zeros_like(s)
    for r in range(h):
        f[r + 1, 1 + r:1 + r + w] = x[r]
    kind = np.zeros((h + 1, 1), np.int16)
    kind[1:, 0] = ft
    for k in range(1, w + h):
        lo, hi = max(0, k - w), min(h - 1, k - 1)           # rows on this wavefront
        rows = slice(lo + 1, hi + 2)
        up = slice(lo, hi + 1)
        a, b, c = s[rows, k - 1], s[up, k - 1], s[up, k - 2]
        t = kind[rows]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([t == 1, t == 2, t == 3, t == 4], [a, b, (a + b) >> 1, paeth], 0)
        s[rows, k] = (f[rows, k] + pred) & 255
    out = np.empty((h, w, bpp), np.uint8)
    for r in range(h):
        out[r] = s[r + 1, 1 + r:1 + r + w]
    return out.reshape(h, row_bytes)


def read_png(path: str) -> np.ndarray:
    """PNG -> uint8 (8-bit) or uint16 (16-bit) [H, W] (gray), [H, W, 2]
    (gray+alpha), [H, W, 3] (RGB) or [H, W, 4] (RGBA). Palette images are
    expanded through their palette to RGB, or RGBA when they carry
    transparency. Bit depths below 8 are not read."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG")
    idat, palette, trns, head = [], None, None, None
    for kind, body in _png_chunks(data, path):
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
    if head is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = head
    if ctype not in _PNG_CHANNELS or depth not in (8, 16) or (ctype == 3 and depth != 8):
        raise ValueError(f"{path}: PNG colour type {ctype} at {depth} bits is not read")
    ch = _PNG_CHANNELS[ctype]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = np.empty((h, w * bpp), np.uint8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    pos = 0
    for r0, c0, dr, dc in passes:
        ph, pw = (h - r0 + dr - 1) // dr, (w - c0 + dc - 1) // dc
        if ph <= 0 or pw <= 0:
            continue
        n = ph * (1 + pw * bpp)
        block = raw[pos:pos + n]
        if block.size != n:
            raise ValueError(f"{path}: truncated PNG data")
        sub = _unfilter(block.reshape(ph, 1 + pw * bpp), ph, pw * bpp, bpp)
        img.reshape(h, w, bpp)[r0::dr, c0::dc] = sub.reshape(ph, pw, bpp)
        pos += n
    if depth == 16:
        arr = img.reshape(h, w * ch, 2).view(">u2")[..., 0].astype(np.uint16)
    else:
        arr = img
    arr = arr.reshape(h, w, ch)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        idx = arr[..., 0]
        if trns is None:
            return palette[idx]
        alpha = np.full(len(palette), 255, np.uint8)
        alpha[: len(trns)] = trns[: len(palette)]
        return np.concatenate([palette[idx], alpha[idx][..., None]], -1)
    return arr[..., 0] if ch == 1 else arr


def load_image(path: str) -> np.ndarray:
    """PNG or PGM/PPM -> float32 [H, W] or [H, W, C] in [0, 1], gamma
    space (8-bit samples / 255, 16-bit / 65535)."""
    with open(path, "rb") as f:
        png = f.read(len(_PNG_SIGNATURE)) == _PNG_SIGNATURE
    arr = read_png(path) if png else read_pnm(path)
    scale = 255.0 if arr.dtype == np.uint8 else 65535.0
    return arr.astype(np.float32) / scale


def save_image(path: str, image) -> None:
    """[H, W] -> binary PGM, [H, W, 3] -> binary PPM. Floats are taken as
    [0, 1] and quantized as the JAX package's ``save_image`` does
    (clip, x255, truncate); uint8 and uint16 are written as they are."""
    img = np.asarray(image.detach().cpu() if hasattr(image, "detach") else image)
    if img.dtype not in (np.uint8, np.uint16):
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.ndim == 2:
        magic = b"P5"
    elif img.ndim == 3 and img.shape[2] == 3:
        magic = b"P6"
    else:
        raise ValueError(f"PNM holds [H, W] or [H, W, 3] images, got {img.shape}")
    maxval = 255 if img.dtype == np.uint8 else 65535
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(magic + f"\n{w} {h}\n{maxval}\n".encode())
        f.write(img.astype(">u2" if maxval > 255 else np.uint8).tobytes())


def _selected(x, valid) -> np.ndarray:
    return (
        np.asarray(valid).astype(bool)
        if valid is not None
        else np.ones(len(np.asarray(x)), dtype=bool)
    )


def write_keypoints(
    path: str,
    x: np.ndarray,
    y: np.ndarray,
    sigma: np.ndarray,
    theta: Optional[np.ndarray] = None,
    valid: Optional[np.ndarray] = None,
) -> int:
    """IPOL keypoint list: 'x y sigma theta' per line (x = row). Returns
    the number of lines written."""
    sel = _selected(x, valid)
    th = np.asarray(theta) if theta is not None else np.zeros(len(sel))
    n = 0
    with open(path, "w") as f:
        for i in np.nonzero(sel)[0]:
            f.write(
                f"{float(x[i]):.6f} {float(y[i]):.6f} "
                f"{float(sigma[i]):.6f} {float(th[i]):.6f}\n"
            )
            n += 1
    return n


def read_keypoints(path: str) -> np.ndarray:
    """-> [N, 4] (x=row, y=col, sigma, theta)."""
    rows = []
    with open(path) as f:
        for line in f:
            p = line.split()
            if p:
                rows.append([float(v) for v in p[:4]])
    return np.asarray(rows, dtype=np.float32)


def write_descriptors(
    path: str,
    x: np.ndarray,
    y: np.ndarray,
    sigma: np.ndarray,
    theta: np.ndarray,
    features: np.ndarray,
    valid: Optional[np.ndarray] = None,
) -> int:
    """IPOL descriptor file: 'x y sigma theta f0..f127' per line. Returns
    the number of lines written."""
    sel = _selected(x, valid)
    feats = np.asarray(features)
    n = 0
    with open(path, "w") as f:
        for i in np.nonzero(sel)[0]:
            head = (
                f"{float(x[i]):.6f} {float(y[i]):.6f} "
                f"{float(sigma[i]):.6f} {float(theta[i]):.6f}"
            )
            body = " ".join(str(int(v)) for v in feats[i])
            f.write(head + " " + body + "\n")
            n += 1
    return n


def read_descriptors(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """-> (keys [N, 4], features [N, 128] uint8). Ignores any trailing
    columns (the IPOL demo appends the 36-bin orientation histogram)."""
    keys, feats = [], []
    with open(path) as f:
        for line in f:
            p = line.split()
            if not p:
                continue
            keys.append([float(v) for v in p[:4]])
            feats.append([int(float(v)) for v in p[4:132]])
    return (
        np.asarray(keys, dtype=np.float32),
        np.asarray(feats, dtype=np.uint8),
    )
