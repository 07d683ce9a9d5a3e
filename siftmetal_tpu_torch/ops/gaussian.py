"""Gaussian taps, the fp32 shift-add blur, and banded pass tables.

Port of ``siftmetal_tpu/ops/gaussian.py``. Every 1-D Gaussian pass of the
pyramid is a linear map ``out[i] = sum_j T[i, j] x[j]`` whose matrix ``T``
is banded: the half-sample-symmetric boundary folds the reflected taps
into the edge columns (:func:`band_matrix`), and the seed stage composes
the 2x bilinear upsample into the same matrix
(:func:`upsample_blur_matrix`). :func:`band_table` turns any such
``[n_out, n_in]`` matrix into the compact form the CUDA band kernel reads:
a start column per output and ``K`` contiguous taps from there.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch


def gaussian_taps(sigma: float) -> np.ndarray:
    """Normalized taps, radius ceil(4*sigma)."""
    radius = int(math.ceil(4.0 * sigma))
    k = np.arange(-radius, radius + 1, dtype=np.float64)
    w = np.exp(-0.5 * (k * k) / (sigma * sigma))
    w /= w.sum()
    return w.astype(np.float32)


def _conv1d_sym(image: torch.Tensor, taps: np.ndarray, dim: int) -> torch.Tensor:
    """1-D convolution along ``dim`` (-1 or -2) with half-sample symmetric
    padding, as a shift-and-add over the taps (exact fp32)."""
    radius = len(taps) // 2
    n = image.shape[dim]
    idx = torch.arange(-radius, n + radius, device=image.device)
    idx = torch.remainder(idx, 2 * n)
    idx = torch.where(idx < n, idx, 2 * n - 1 - idx)
    x = image.index_select(dim, idx)
    acc = None
    for k in range(2 * radius + 1):
        term = float(taps[k]) * x.narrow(dim, k, n)
        acc = term if acc is None else acc + term
    return acc


def blur(image: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of [..., H, W] with symmetric boundary
    (the exact fp32 reference of every blur in the port)."""
    if sigma <= 0.0:
        return image
    taps = gaussian_taps(sigma)
    return _conv1d_sym(_conv1d_sym(image, taps, -1), taps, -2)


@functools.lru_cache(maxsize=None)
def band_matrix(sigma: float, n: int) -> np.ndarray:
    """Dense float64 [n, n] matrix of one 1-D Gaussian pass with the
    half-sample-symmetric boundary folded into the edge columns: tap k of
    output i reads ``reflect(i + k)``, the period-2n triangle map (which
    also covers radius > n on tiny top octaves)."""
    taps = gaussian_taps(sigma).astype(np.float64)
    r = len(taps) // 2
    i = np.arange(n)[:, None]
    k = np.arange(-r, r + 1)[None, :]
    idx = np.mod(i + k, 2 * n)
    idx = np.where(idx < n, idx, 2 * n - 1 - idx)
    t = np.zeros((n, n), np.float64)
    np.add.at(
        t,
        (np.repeat(np.arange(n), 2 * r + 1), idx.ravel()),
        np.tile(taps, n),
    )
    return t


@functools.lru_cache(maxsize=None)
def upsample_blur_matrix(sigma: float, n: int) -> np.ndarray:
    """Float64 [2n, n] matrix: the Gaussian pass at 2n (its entries rounded
    to fp32 first, as the JAX package composes it) times IPOL's 2x bilinear
    upsample (even outputs copy, odd outputs are neighbour midpoints with
    the last sample repeated)."""
    u = np.zeros((2 * n, n), np.float64)
    for i in range(n):
        u[2 * i, i] = 1.0
        u[2 * i + 1, i] += 0.5
        u[2 * i + 1, min(i + 1, n - 1)] += 0.5
    t = band_matrix(sigma, 2 * n).astype(np.float32).astype(np.float64)
    return t @ u


def band_table(mat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[n_out, n_in] banded matrix -> (start int32 [n_out], taps float32
    [n_out, K]) with ``out[i] = sum_k taps[i, k] * x[start[i] + k]``.

    K is the widest row support; each start is pulled left where needed
    so that ``start + K <= n_in`` (a band that spans the whole input, as
    on tiny octaves, starts at 0). Built in float64, rounded once."""
    mat = np.asarray(mat, np.float64)
    n_out, n_in = mat.shape
    nz = mat != 0.0
    has = nz.any(axis=1)
    first = np.where(has, nz.argmax(axis=1), 0)
    last = np.where(has, n_in - 1 - nz[:, ::-1].argmax(axis=1), 0)
    k = int(max(1, (last - first + 1).max()))
    start = np.minimum(first, n_in - k)
    cols = start[:, None] + np.arange(k)[None, :]
    taps = np.take_along_axis(mat, cols, axis=1)
    return start.astype(np.int32), taps.astype(np.float32)

