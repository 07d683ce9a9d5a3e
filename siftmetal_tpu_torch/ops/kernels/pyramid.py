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


# Tile geometry of csrc/pyramid.cu (kTileRows, kTileCols, kBlock); the
# launchers refuse any other.
TILE_ROWS = 64
TILE_COLS = 64
TAP_BLOCK = 4


class TiledPass(NamedTuple):
    """One pass direction's tables in the tiled kernel's form: the outputs
    (padded to whole tiles) in blocks of TAP_BLOCK neighbours, each block
    with one first input and its outputs' taps laid out on the block's
    inputs (zero outside each output's own taps), plus each tile's input
    window (host numpy)."""

    base: np.ndarray  # [S, nb] int32: first input of each block
    span: np.ndarray  # [S, nb] int32: inputs the block's taps reach
    taps: np.ndarray  # [S, nb, kp, TAP_BLOCK] float32, kp = max span
    win: np.ndarray   # [S, n_tiles, 2] int32: input [lo, hi) of each tile


def tile_pass(tab: BandTables, tile: int) -> TiledPass:
    """Lay ``tab`` out for tiles of ``tile`` outputs. Output i of block g
    (i = g * TAP_BLOCK + p) reads input base[s, g] + m with tap
    taps[s, g, m, p]; its own taps sit at m = start[s, i] - base[s, g] + k,
    k < ks[s], in table order, so summing a block's taps over m in order
    sums each output's taps in table order. Outputs past n_out repeat the
    last output's start with zero taps."""
    n_s, n_out = tab.start.shape
    n_tiles = -(-n_out // tile)
    n_pad = n_tiles * tile
    nb = n_pad // TAP_BLOCK
    idx = np.minimum(np.arange(n_pad), n_out - 1)
    real = (np.arange(n_pad) < n_out).astype(np.float32)
    start = tab.start[:, idx].astype(np.int64).reshape(n_s, nb, TAP_BLOCK)
    base = start.min(-1)
    d = start - base[..., None]
    span = (d + tab.ks[:, None, None]).max(-1)
    kp = int(span.max())
    taps = np.zeros((n_s, nb, kp, TAP_BLOCK), np.float32)
    g = np.arange(nb)[:, None]
    p = np.arange(TAP_BLOCK)[None, :]
    for s in range(n_s):
        for k in range(int(tab.ks[s])):
            taps[s, g, d[s] + k, p] = (tab.taps[s, k, idx] * real).reshape(nb, TAP_BLOCK)
    per = tile // TAP_BLOCK
    lo = base.reshape(n_s, n_tiles, per).min(-1)
    hi = (base + span).reshape(n_s, n_tiles, per).max(-1)
    c_int = lambda a: np.ascontiguousarray(a, np.int32)   # the kernel's flat layout
    return TiledPass(base=c_int(base), span=c_int(span), taps=taps,
                     win=c_int(np.stack([lo, hi], -1)))


_tiled: Dict[Tuple, Tuple[TiledPass, TiledPass, Tuple[int, int, int]]] = {}
_device_tables: Dict[Tuple, Tuple[Tuple[torch.Tensor, ...], np.ndarray, int]] = {}


def tiled_tables(key, tab_x: BandTables, tab_y: BandTables):
    """(x pass, y pass, (rows_in, cols_in, rows_x)) of one table pair,
    cached under ``key``: the tiled tables and the shared-memory extents a
    block needs (its input window over all slices; the rows one slice's X
    pass fills)."""
    hit = _tiled.get(key)
    if hit is None:
        tx, ty = tile_pass(tab_x, TILE_COLS), tile_pass(tab_y, TILE_ROWS)
        size = lambda w: w[..., 1] - w[..., 0]
        union = lambda w: w[..., 1].max(0) - w[..., 0].min(0)
        extents = (int(union(ty.win).max()), int(union(tx.win).max()),
                   int(size(ty.win).max()))
        hit = _tiled[key] = (tx, ty, extents)
    return hit


def launch_tables(key, device, tables) -> int:
    """The address of the host table the C launchers read for ``key`` on
    ``device`` (csrc/pyramid.cu ``Table``): base, span, taps and win
    pointers, nb, kp, n_tiles of the X pass, the same of the Y pass,
    rows_in, cols_in, rows_x and the tile geometry. Built once per (key,
    device) from ``tables()`` (the two BandTables); the device tensors and
    the table stay cached."""
    hit = _device_tables.get((key, device))
    if hit is None:
        tx, ty, extents = tiled_tables(key, *tables())
        tensors, words = [], []
        for tp in (tx, ty):
            t = [torch.from_numpy(a).to(device) for a in tp]
            tensors += t
            words += [a.data_ptr() for a in t] + [tp.taps.shape[1], tp.taps.shape[2],
                                                   tp.win.shape[1]]
        words += [*extents, TILE_ROWS, TILE_COLS, TAP_BLOCK]
        table = np.asarray(words, np.int64)
        hit = _device_tables[(key, device)] = (tuple(tensors), table, table.ctypes.data)
    return hit[2]


# --- plain versions of the two passes --------------------------------------


def band_x_plain(
    x: torch.Tensor, tab: BandTables, out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """[B, H, W_in] -> [B, S, H, W_out]: the kernel's X pass in PyTorch.

    The input (fp32 or bf16) is upcast exactly; each output is the fp32
    sum of its taps in table order, tap 0 first, every product and every
    sum rounded to fp32 on its own, then cast once to ``out_dtype``
    (round-to-nearest-even for bf16)."""
    x = x.float()
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
    return torch.stack(outs, dim=1).to(out_dtype)


def band_y_plain(
    xs: torch.Tensor,
    tab: BandTables,
    first: Optional[torch.Tensor],
    with_dog: bool,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """[B, S, H_in, W] -> (gauss, dog): the kernel's Y pass in PyTorch
    (fp32 or bf16 ``xs`` and ``first``, upcast exactly; fp32 out)."""
    xs = xs.float()
    first = None if first is None else first.float()
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
    mid_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """X pass then Y pass of every slice over a [B, H_in, W_in] input, in
    one launch of the tiled kernel on a CUDA tensor.

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
        mid_dtype == bf16 and (x.dtype != bf16 or first is not None)
    ):
        raise ValueError(f"{counter}: no {x.dtype} -> {mid_dtype} form of the band passes")
    if not use_kernel(x, counter):
        return band_y_plain(band_x_plain(x, tab_x, mid_dtype), tab_y, first, with_dog)
    require(x, counter, x.dtype)
    if first is not None:
        require(first, counter, x.dtype)
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
    tables = launch_tables(key, x.device, lambda: (tab_x, tab_y))
    g = s + (1 if first is not None else 0)
    gauss = torch.empty((b, g, h_out, w_out), dtype=torch.float32, device=x.device)
    dog = (
        torch.empty((b, g - 1, h_out, w_out), dtype=torch.float32, device=x.device)
        if with_dog
        else None
    )
    with _cuda.launch_on(x) as stream:
        _cuda.check(
            _cuda.library("pyramid").band_tiles(
                tables, x.data_ptr(), int(x.dtype == bf16), b, h_in, w_in, s, h_out,
                w_out, 0 if first is None else first.data_ptr(),
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
    """First slice [B, H, W] fp32 or bf16 -> fp32 (gaussians [B, S, H, W],
    dogs [B, S-1, H, W]), every slice one-shot from ``first``."""
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
    """Grayscale [B, h, w] fp32 or bf16 -> fp32 octave 0 (gaussians
    [B, S, H, W], dogs [B, S-1, H, W]) at H, W = h, w times 1/delta_min,
    with the seed upsample and blur folded into every slice's pass tables."""
    b, h, w = gray.shape
    tx, ty = seed_tables(config, h, w)
    return separable_bands(
        gray, ("seed", config, h, w), tx, ty, None, True, "seed_octave"
    )
