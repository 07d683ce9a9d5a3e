"""Image I/O and the IPOL text interchange format, with numpy only.

Images are binary PGM/PPM (P5/P6): the IPOL fixtures are PNGs, and the
port reads the same pixels from a binary PPM copy
(``tests/fixtures/butterfly.ppm``) so it needs no image library. The
keypoint and descriptor text formats are those of
``siftmetal_tpu/utils/io.py`` and of the IPOL files in ``tests/fixtures``.
"""

from __future__ import annotations

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


def load_image(path: str) -> np.ndarray:
    """PGM/PPM -> float32 [H, W] or [H, W, 3] in [0, 1], gamma space."""
    arr = read_pnm(path)
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
