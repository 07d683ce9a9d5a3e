"""One-shot octave and fused seed: separable Gaussian passes (``csrc/pyramid.cu``).

Replaces ``siftmetal_tpu/ops/pallas/pyramid.py`` ``_oneshot_kernel``
(through ``seed_octave_pallas`` :555 and ``octave_oneshot_pallas`` :280).
What it computes is the same:

  * one-shot octave: slice s of an octave is the first slice blurred by
    rho_s = sqrt(sigma_s^2 - sigma_0^2)/delta (the Gaussian semigroup),
    with the DoG of consecutive slices fused in;
  * fused seed: octave 0's slices straight from the raw grayscale: the 2x
    bilinear upsample (delta_min 0.5), then each slice's blur of it, and
    slice 0 (the seed image) emitted like any other slice.

Both 1-D passes of a slice are ``ops/gaussian.py`` ``conv1d_sym``: the
slice's unfolded taps, tap 0 first, over the input read through the
half-sample reflection. Every output of a slice runs the same fp32 sum,
so a constant input gives a constant slice. The TPU ran each pass as a
banded matrix with the reflected taps folded into the edge columns (and
the upsample composed in) as bf16x3 MXU matmuls, which leaves rounding
noise on a flat image; the port keeps those matrices only for the routing
gates (``supports``, ``seed_supports``), which keep the JAX package's
geometry so both packages take the same route for the same input.

bf16 forms (the fast preset's ``pyramid_dtype="bfloat16"``; the TPU kernel
on a bf16 input, ``_split_val`` :150 with ``x_lo is None``): the input is
read as bf16, exactly; both passes accumulate in fp32 with fp32 taps and
nothing is rounded between them; every slice and DoG comes out fp32. In
the octave form slice 0 and ``dog[0]`` use the bf16 input upcast.

Bound on an H100: bytes (the outputs alone are 11 full planes per frame
at octave 0). See csrc/pyramid.cu for the kernel's design.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...config import SiftConfig
from .. import cuda as _cuda
from ..gaussian import band_matrix, conv1d_sym, gaussian_taps, upsample_blur_matrix
from ..image import upsample_bilinear_2x
from . import LAUNCHES, require, use_kernel

HALO = 24        # TPU kernel's vertical halo (rows each side)
BAND = 128       # TPU kernel's output rows per band
ROWS_IN = BAND + 2 * HALO   # 176: smallest octave the one-shot route takes


class SliceTaps(NamedTuple):
    """The taps of every slice of a launch (host numpy): both passes of
    slice s apply ``taps[s, :2 radius[s] + 1]``, tap 0 first."""

    taps: np.ndarray    # [S, K] float32, zero past 2 radius[s] + 1
    radius: np.ndarray  # [S] int32


@functools.lru_cache(maxsize=None)
def slice_taps(sigmas: Tuple[float, ...]) -> SliceTaps:
    """``gaussian_taps`` of each sigma, one row a slice."""
    rows = [gaussian_taps(float(s)) for s in sigmas]
    taps = np.zeros((len(rows), max(len(r) for r in rows)), np.float32)
    for s, r in enumerate(rows):
        taps[s, : len(r)] = r
    return SliceTaps(taps=taps, radius=np.asarray([len(r) // 2 for r in rows], np.int32))


def _taps_of(tab: SliceTaps, s: int) -> np.ndarray:
    return tab.taps[s, : 2 * int(tab.radius[s]) + 1]


_device_tables: Dict[Tuple, Tuple[Tuple[torch.Tensor, ...], np.ndarray]] = {}


def launch_table(sigmas: Tuple[float, ...], device) -> int:
    """The address of the host table the C launchers read for ``sigmas``
    on ``device`` (csrc/pyramid.cu ``Table``): the taps and radius
    pointers, the slice count, the taps a slice (K) and the largest
    radius. Built once per (sigmas, device); the device tensors and the
    table stay cached."""
    hit = _device_tables.get((sigmas, device))
    if hit is None:
        tab = slice_taps(sigmas)
        t = (torch.from_numpy(tab.taps).to(device), torch.from_numpy(tab.radius).to(device))
        table = np.asarray([t[0].data_ptr(), t[1].data_ptr(), *tab.taps.shape,
                            int(tab.radius.max())], np.int64)
        hit = _device_tables[(sigmas, device)] = (t, table)
    return hit[1].ctypes.data


# --- plain versions of the two passes --------------------------------------


def band_x_plain(
    x: torch.Tensor, tab: SliceTaps, out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """[B, H, W] -> [B, S, H, W]: the kernel's X pass in PyTorch.

    The input (fp32 or bf16) is upcast exactly; each output is the fp32
    sum of its slice's taps over the reflected input, tap 0 first, every
    product and every sum rounded to fp32 on its own, then cast once to
    ``out_dtype`` (round-to-nearest-even for bf16)."""
    x = x.float()
    outs = [conv1d_sym(x, _taps_of(tab, s), -1) for s in range(len(tab.radius))]
    return torch.stack(outs, dim=1).to(out_dtype)


def band_y_plain(
    xs: torch.Tensor,
    tab: SliceTaps,
    first: Optional[torch.Tensor],
    with_dog: bool,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """[B, S, H, W] -> (gauss, dog): the kernel's Y pass in PyTorch
    (fp32 or bf16 ``xs`` and ``first``, upcast exactly; fp32 out)."""
    xs = xs.float()
    ys = [] if first is None else [first.float()]
    ys += [conv1d_sym(xs[:, s], _taps_of(tab, s), -2) for s in range(len(tab.radius))]
    gauss = torch.stack(ys, dim=1)
    dog = gauss[:, 1:] - gauss[:, :-1] if with_dog else None
    return gauss, dog


def bands_plain(
    x: torch.Tensor,
    sigmas: Tuple[float, ...],
    first: Optional[torch.Tensor],
    with_dog: bool,
    mid_dtype: torch.dtype = torch.float32,
    upsample: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`separable_bands` in PyTorch: the input upcast (and with
    ``upsample`` its 2x bilinear upsample, ``ops/image.py``), then the X
    and the Y pass of every slice."""
    if upsample:
        x = upsample_bilinear_2x(x.float())
    tab = slice_taps(tuple(float(s) for s in sigmas))
    return band_y_plain(band_x_plain(x, tab, mid_dtype), tab, first, with_dog)


def separable_bands(
    x: torch.Tensor,
    sigmas: Tuple[float, ...],
    first: Optional[torch.Tensor],
    with_dog: bool,
    counter: str,
    mid_dtype: torch.dtype = torch.float32,
    upsample: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """X pass then Y pass of every slice (one a sigma) over a [B, H, W]
    input, or over its 2x bilinear upsample with ``upsample``, in one
    launch of the tiled kernel on a CUDA tensor.

    ``x`` (and ``first``) are fp32 or bf16; ``mid_dtype`` is the type of
    the X pass's result that the Y pass reads (bf16 only for a bf16 ``x``
    without ``first``: the cascade blur of the bf16 chain). Returns fp32
    (gauss [B, S (+1 with ``first``), H_out, W_out], dog or None). On a
    CUDA tensor the passes are one launch of ``band_tiles`` (counted under
    ``counter``, or ``counter_bf16`` for a bf16 ``x``), the X pass of each
    tile kept in shared memory; on the CPU the plain versions run."""
    bf16 = torch.bfloat16
    if x.dtype not in (torch.float32, bf16):
        raise TypeError(f"{counter}: expected float32 or bfloat16, got {x.dtype}")
    if mid_dtype not in (torch.float32, bf16) or (
        mid_dtype == bf16 and (x.dtype != bf16 or first is not None or upsample)
    ):
        raise ValueError(f"{counter}: no {x.dtype} -> {mid_dtype} form of the band passes")
    if not use_kernel(x, counter):
        return bands_plain(x, sigmas, first, with_dog, mid_dtype, upsample)
    require(x, counter, x.dtype)
    if first is not None:
        require(first, counter, x.dtype)
    if x.ndim != 3:
        raise ValueError(f"{counter}: expected [B, H, W], got {tuple(x.shape)}")
    b, h_in, w_in = x.shape
    up = 2 if upsample else 1
    h_out, w_out = up * h_in, up * w_in
    if first is not None and tuple(first.shape) != (b, h_out, w_out):
        raise ValueError(f"{counter}: first slice {tuple(first.shape)} does not fit")
    sigmas = tuple(float(s) for s in sigmas)
    table = launch_table(sigmas, x.device)
    g = len(sigmas) + (1 if first is not None else 0)
    gauss = torch.empty((b, g, h_out, w_out), dtype=torch.float32, device=x.device)
    dog = (
        torch.empty((b, g - 1, h_out, w_out), dtype=torch.float32, device=x.device)
        if with_dog
        else None
    )
    with _cuda.launch_on(x) as stream:
        _cuda.check(
            _cuda.library("pyramid").band_tiles(
                table, x.data_ptr(), int(x.dtype == bf16), b, h_in, w_in, len(sigmas),
                int(upsample), 0 if first is None else first.data_ptr(),
                int(first is not None and first.dtype == bf16), gauss.data_ptr(),
                0 if dog is None else dog.data_ptr(), int(mid_dtype == bf16), stream,
            ),
            counter,
        )
    LAUNCHES[counter + "_bf16" if x.dtype == bf16 else counter] += 1
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


def octave_oneshot_plain(first: torch.Tensor, config: SiftConfig):
    return bands_plain(first, oneshot_rhos(config), first, True)


def octave_oneshot(
    first: torch.Tensor, config: SiftConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """First slice [B, H, W] fp32 or bf16 -> fp32 (gaussians [B, S, H, W],
    dogs [B, S-1, H, W]), every slice one-shot from ``first``."""
    return separable_bands(first, oneshot_rhos(config), first, True, "octave_oneshot")


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
    """The JAX package's composed 1-D pass matrix [n_out, n] of one
    fused-seed slice (what its TPU kernel applies; the port reads it only
    in the routing gate)."""
    if delta_min == 0.5:
        return upsample_blur_matrix(sigma, n)
    return band_matrix(sigma, n)


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
    return bands_plain(gray, _seed_sigmas(config), None, True,
                       upsample=config.delta_min == 0.5)


def seed_octave(
    gray: torch.Tensor, config: SiftConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grayscale [B, h, w] fp32 or bf16 -> fp32 octave 0 (gaussians
    [B, S, H, W], dogs [B, S-1, H, W]) at H, W = h, w times 1/delta_min:
    slice s is ``blur(upsample_bilinear_2x(gray), sigma_s)`` (no upsample
    at delta_min 1), every slice in one launch."""
    return separable_bands(gray, _seed_sigmas(config), None, True, "seed_octave",
                           upsample=config.delta_min == 0.5)
