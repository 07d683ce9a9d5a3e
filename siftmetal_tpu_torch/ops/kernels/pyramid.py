"""One-shot octave and fused seed: banded separable passes (``csrc/pyramid.cu``).

Replaces ``siftmetal_tpu/ops/pallas/pyramid.py`` ``_oneshot_kernel``
(through ``seed_octave_pallas`` :555 and ``octave_oneshot_pallas`` :280).
What it computes is the same:

  * one-shot octave: slice s of an octave is the first slice blurred by
    rho_s = sqrt(sigma_s^2 - sigma_0^2)/delta (the Gaussian semigroup),
    with the DoG of consecutive slices fused in;
  * fused seed: octave 0's slices straight from the raw grayscale, the
    2x bilinear upsample composed into each slice's pass matrices, and
    slice 0 (the seed image) emitted like any other slice.

The TPU ran each pass as bf16x3 MXU matmuls over 8/128-aligned windows;
here each pass is a banded table (start column + taps, ops/gaussian.py)
applied in direct fp32. The routing gates (``supports``,
``seed_supports``) keep the JAX package's geometry so both packages take
the same route for the same input.

Bound on an H100: bytes (the outputs alone are 11 full planes per frame
at octave 0). See csrc/pyramid.cu for the kernel's design.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ...config import SiftConfig
from .. import cuda as _cuda
from ..gaussian import band_matrix, band_table, upsample_blur_matrix
from . import LAUNCHES, require, use_kernel

HALO = 24        # TPU kernel's vertical halo (rows each side)
BAND = 128       # TPU kernel's output rows per band
ROWS_IN = BAND + 2 * HALO   # 176: smallest octave the one-shot route takes


class BandTables(NamedTuple):
    """Per-slice band tables of one pass direction (host numpy)."""

    start: np.ndarray  # [S, n_out] int32
    taps: np.ndarray   # [S, K, n_out] float32, zero past ks[s]
    ks: np.ndarray     # [S] int32 taps per slice
    n_in: int


def pack_tables(mats: Sequence[np.ndarray]) -> BandTables:
    """Stack per-slice ``[n_out, n_in]`` matrices into one table set
    (taps transposed to [S, K, n_out] for coalesced kernel reads)."""
    tabs = [band_table(m) for m in mats]
    n_out, n_in = mats[0].shape
    k = max(t[1].shape[1] for t in tabs)
    taps = np.zeros((len(tabs), k, n_out), np.float32)
    for s, (_, tp) in enumerate(tabs):
        taps[s, : tp.shape[1]] = tp.T
    return BandTables(
        start=np.stack([t[0] for t in tabs]),
        taps=taps,
        ks=np.asarray([t[1].shape[1] for t in tabs], np.int32),
        n_in=n_in,
    )


_device_tables: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}


def _on_device(key, tab: BandTables, device) -> Tuple[torch.Tensor, ...]:
    k = (key, str(device))
    hit = _device_tables.get(k)
    if hit is None:
        hit = (
            torch.from_numpy(tab.start).to(device),
            torch.from_numpy(tab.taps).to(device),
            torch.from_numpy(tab.ks).to(device),
        )
        _device_tables[k] = hit
    return hit


# --- plain versions of the two passes --------------------------------------


def band_x_plain(x: torch.Tensor, tab: BandTables) -> torch.Tensor:
    """[B, H, W_in] -> [B, S, H, W_out]: the kernel's X pass in PyTorch."""
    start = torch.from_numpy(tab.start).to(x.device).long()
    taps = torch.from_numpy(tab.taps).to(x.device)
    outs = []
    for s in range(start.shape[0]):
        acc = torch.zeros(
            x.shape[:-1] + (start.shape[1],), dtype=torch.float32, device=x.device
        )
        for k in range(int(tab.ks[s])):
            acc = acc + taps[s, k] * x.index_select(-1, start[s] + k)
        outs.append(acc)
    return torch.stack(outs, dim=1)


def band_y_plain(
    xs: torch.Tensor,
    tab: BandTables,
    first: Optional[torch.Tensor],
    with_dog: bool,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """[B, S, H_in, W] -> (gauss, dog): the kernel's Y pass in PyTorch."""
    start = torch.from_numpy(tab.start).to(xs.device).long()
    taps = torch.from_numpy(tab.taps).to(xs.device)
    ys = [] if first is None else [first]
    for s in range(start.shape[0]):
        plane = xs[:, s]
        acc = torch.zeros(
            (xs.shape[0], start.shape[1], xs.shape[-1]),
            dtype=torch.float32,
            device=xs.device,
        )
        for k in range(int(tab.ks[s])):
            acc = acc + taps[s, k][:, None] * plane.index_select(-2, start[s] + k)
        ys.append(acc)
    gauss = torch.stack(ys, dim=1)
    dog = gauss[:, 1:] - gauss[:, :-1] if with_dog else None
    return gauss, dog


def separable_bands(
    x: torch.Tensor,
    key,
    tab_x: BandTables,
    tab_y: BandTables,
    first: Optional[torch.Tensor],
    with_dog: bool,
    counter: str,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """X pass then Y pass of every slice over a [B, H_in, W_in] input.

    Returns (gauss [B, S (+1 with ``first``), H_out, W_out], dog or None).
    On a CUDA tensor both passes are kernel launches (counted once under
    ``counter``); on the CPU the plain versions run."""
    if not use_kernel(x, counter):
        return band_y_plain(band_x_plain(x, tab_x), tab_y, first, with_dog)
    require(x, counter)
    if first is not None:
        require(first, counter)
    if x.ndim != 3:
        raise ValueError(f"{counter}: expected [B, H, W], got {tuple(x.shape)}")
    b, h_in, w_in = x.shape
    s = tab_x.start.shape[0]
    w_out = tab_x.start.shape[1]
    h_out = tab_y.start.shape[1]
    if tab_x.n_in != w_in or tab_y.n_in != h_in:
        raise ValueError(f"{counter}: tables do not fit input {tuple(x.shape)}")
    if first is not None and tuple(first.shape) != (b, h_out, w_out):
        raise ValueError(f"{counter}: first slice {tuple(first.shape)} does not fit")
    sx, tx, kx = _on_device((key, "x"), tab_x, x.device)
    sy, ty, ky = _on_device((key, "y"), tab_y, x.device)
    lib = _cuda.library("pyramid")
    stream = _cuda.stream_of(x)
    xs = torch.empty((b, s, h_in, w_out), dtype=torch.float32, device=x.device)
    _cuda.check(
        lib.band_x(x.data_ptr(), b, h_in, w_in, sx.data_ptr(), tx.data_ptr(),
                   kx.data_ptr(), s, tx.shape[1], w_out, xs.data_ptr(), stream),
        "band_x",
    )
    g = s + (1 if first is not None else 0)
    gauss = torch.empty((b, g, h_out, w_out), dtype=torch.float32, device=x.device)
    dog = (
        torch.empty((b, g - 1, h_out, w_out), dtype=torch.float32, device=x.device)
        if with_dog
        else None
    )
    _cuda.check(
        lib.band_y(xs.data_ptr(), b, s, h_in, w_out, sy.data_ptr(),
                   ty.data_ptr(), ky.data_ptr(), ty.shape[1], h_out,
                   0 if first is None else first.data_ptr(), gauss.data_ptr(),
                   0 if dog is None else dog.data_ptr(), stream),
        "band_y",
    )
    LAUNCHES[counter] += 1
    return gauss, dog


# --- one-shot octave --------------------------------------------------------


def oneshot_rhos(config: SiftConfig) -> Tuple[float, ...]:
    """rho_s = sqrt(sigma_s^2 - sigma_0^2)/delta for s = 1..S-1 (octave
    pixels; the same for every octave)."""
    sig = config.octave_sigmas(0)
    d = config.octave_delta(0)
    return tuple(
        math.sqrt(sig[s] ** 2 - sig[0] ** 2) / d for s in range(1, len(sig))
    )


def supports(config: SiftConfig, h: int) -> bool:
    """The one-shot route's gate: octaves of at least ROWS_IN rows whose
    one-shot radii fit the TPU kernel's halo (same gate as the JAX
    package, so both route alike)."""
    radii = [int(math.ceil(4.0 * r)) for r in oneshot_rhos(config)]
    return h >= ROWS_IN and max(radii) <= HALO


@functools.lru_cache(maxsize=None)
def oneshot_tables(config: SiftConfig, h: int, w: int) -> Tuple[BandTables, BandTables]:
    rhos = oneshot_rhos(config)
    return (
        pack_tables([band_matrix(float(r), w) for r in rhos]),
        pack_tables([band_matrix(float(r), h) for r in rhos]),
    )


def octave_oneshot_plain(first: torch.Tensor, config: SiftConfig):
    tx, ty = oneshot_tables(config, first.shape[-2], first.shape[-1])
    return band_y_plain(band_x_plain(first, tx), ty, first, True)


def octave_oneshot(
    first: torch.Tensor, config: SiftConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """First slice [B, H, W] fp32 -> (gaussians [B, S, H, W], dogs
    [B, S-1, H, W]), every slice one-shot from ``first``."""
    b, h, w = first.shape
    tx, ty = oneshot_tables(config, h, w)
    return separable_bands(
        first, ("oneshot", config, h, w), tx, ty, first, True, "octave_oneshot"
    )


# --- fused seed + octave 0 --------------------------------------------------


def _seed_sigmas(config: SiftConfig) -> Tuple[float, ...]:
    """Blur of each octave-0 slice relative to the input image, in output
    pixels: sqrt((sigma_s/d)^2 - (sigma_in/d)^2). Entry 0 is exactly
    config.seed_blur_sigma()."""
    d = config.delta_min
    s_in = config.sigma_input / d
    return tuple(
        math.sqrt((sig / d) ** 2 - s_in ** 2) for sig in config.octave_sigmas(0)
    )


def _seed_c_matrix(sigma: float, n: int, delta_min: float) -> np.ndarray:
    """Full 1-D pass matrix [n_out, n] of one fused-seed slice."""
    if delta_min == 0.5:
        return upsample_blur_matrix(sigma, n)
    return band_matrix(sigma, n)


@functools.lru_cache(maxsize=None)
def seed_tables(config: SiftConfig, h: int, w: int) -> Tuple[BandTables, BandTables]:
    sigs = _seed_sigmas(config)
    return (
        pack_tables([_seed_c_matrix(float(s), w, config.delta_min) for s in sigs]),
        pack_tables([_seed_c_matrix(float(s), h, config.delta_min) for s in sigs]),
    )


def _pick_ntt(n_t: int, stride_unit: int) -> int:
    """The TPU kernel's column-group width (output tiles per group)."""
    cands = [k for k in range(1, 6) if (stride_unit * k) % 128 == 0]
    return min(cands, key=lambda k: ((-(-n_t // k)) * k - n_t, -k))


def _seed_geometry(delta_min: float, wo: int):
    """(row_stride, rows_in, win_offs) of the TPU fused-seed kernel."""
    row_stride, rows_in = (64, 96) if delta_min == 0.5 else (128, 160)
    n_tt = _pick_ntt(-(-wo // 128), row_stride)
    win_offs = tuple(row_stride * tt // 128 * 128 for tt in range(n_tt))
    return row_stride, rows_in, win_offs


def _fits(c: np.ndarray, r0: int, c0: int, rows: int, cols: int) -> bool:
    """Every tap of rows [r0, r0+rows) of the fp32 matrix ``c`` lies in
    cols [c0, c0+cols): the JAX package's ``_slice_support`` test, with its
    fp32 sums, so both packages accept the same inputs."""
    out = np.zeros((rows, cols), np.float32)
    rr = slice(max(r0, 0), min(r0 + rows, c.shape[0]))
    cc = slice(max(c0, 0), min(c0 + cols, c.shape[1]))
    if rr.start < rr.stop and cc.start < cc.stop:
        out[rr.start - r0 : rr.stop - r0, cc.start - c0 : cc.stop - c0] = c[rr, cc]
    full = np.abs(c[rr, :]).sum()
    kept = np.abs(out).sum()
    return bool(abs(full - kept) <= 1e-9 * max(full, 1.0))


@functools.lru_cache(maxsize=None)
def _seed_windows_fit(config: SiftConfig, h: int, w: int) -> bool:
    """The TPU kernel's static windows hold every composed tap (the
    geometry check of the JAX package's ``_seed_matrices``)."""
    up = 2 if config.delta_min == 0.5 else 1
    ho, wo = up * h, up * w
    row_stride, rows_in, win_offs = _seed_geometry(config.delta_min, wo)
    n_tt = len(win_offs)
    col_stride = n_tt * row_stride
    halo = (rows_in - row_stride) // 2
    n_t = -(-wo // 128)
    n_wt = -(-n_t // n_tt)
    n_bands = -(-ho // BAND)
    hp = row_stride * n_bands
    for sig in _seed_sigmas(config):
        cx = _seed_c_matrix(float(sig), w, config.delta_min).astype(np.float32)
        cy = _seed_c_matrix(float(sig), h, config.delta_min).astype(np.float32)
        for g in range(n_wt):
            for tt in range(n_tt):
                if not _fits(cx, 128 * (n_tt * g + tt),
                             col_stride * g + win_offs[tt] - 64, BAND, 256):
                    return False
        for bd in range(n_bands):
            start = min(max(row_stride * bd - halo, 0), hp - rows_in)
            if start % 8 or not _fits(cy, BAND * bd, start, BAND, rows_in):
                return False
    return True


def seed_supports(config: SiftConfig, h: int, w: int) -> bool:
    """True when octave 0 takes the fused seed route (the JAX package's
    gate, kept so both packages route alike)."""
    if config.delta_min not in (0.5, 1.0) or w < 128:
        return False
    up = 2 if config.delta_min == 0.5 else 1
    _, rows_in, _ = _seed_geometry(config.delta_min, up * w)
    if h < rows_in:
        return False
    return _seed_windows_fit(config, h, w)


def seed_octave_plain(gray: torch.Tensor, config: SiftConfig):
    tx, ty = seed_tables(config, gray.shape[-2], gray.shape[-1])
    return band_y_plain(band_x_plain(gray, tx), ty, None, True)


def seed_octave(
    gray: torch.Tensor, config: SiftConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grayscale [B, h, w] fp32 -> octave 0 (gaussians [B, S, H, W], dogs
    [B, S-1, H, W]) at H, W = h, w times 1/delta_min, with the seed
    upsample and blur folded into every slice's pass tables."""
    b, h, w = gray.shape
    tx, ty = seed_tables(config, h, w)
    return separable_bands(
        gray, ("seed", config, h, w), tx, ty, None, True, "seed_octave"
    )
