"""Gaussian taps, the fp32 shift-add blur, and the pass matrices of the
routing gates.

Port of ``siftmetal_tpu/ops/gaussian.py``. Every 1-D Gaussian pass of the
port is :func:`conv1d_sym`: the unfolded taps, tap 0 first, applied to the
input read through the half-sample reflection, so every output of a pass
runs the same fp32 sum and a constant input stays constant.
:func:`band_matrix` (the same pass as a dense matrix, reflected taps
folded into the edge columns) and :func:`upsample_blur_matrix` (the seed's
2x upsample composed in) are what the JAX package's TPU route computes;
the port keeps them only for the routing gates
(``ops/kernels/pyramid.py``), which must accept what the JAX package
accepts.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def gaussian_taps(sigma: float) -> np.ndarray:
    """Normalized taps, radius ceil(4*sigma)."""
    radius = int(math.ceil(4.0 * sigma))
    k = np.arange(-radius, radius + 1, dtype=np.float64)
    w = np.exp(-0.5 * (k * k) / (sigma * sigma))
    w /= w.sum()
    return w.astype(np.float32)


def conv1d_sym(image: torch.Tensor, taps: np.ndarray, dim: int) -> torch.Tensor:
    """1-D convolution along ``dim`` (-1 or -2) with half-sample symmetric
    padding (the period-2n triangle map, which also covers a radius above
    the length), as a shift-and-add over the taps: output i is
    ``sum_k taps[k] * x[reflect(i - r + k)]`` in fp32, tap 0 first, every
    product and sum rounded on its own."""
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
    return conv1d_sym(conv1d_sym(image, taps, -1), taps, -2)


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
