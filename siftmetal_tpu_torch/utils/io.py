"""Image loading for the port: binary PPM/PGM (P6/P5) read with numpy.

The IPOL fixtures are PNGs; the port reads the same pixels from a binary
PPM copy (``tests/fixtures/butterfly.ppm``) so it needs no image library.
"""

from __future__ import annotations

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
