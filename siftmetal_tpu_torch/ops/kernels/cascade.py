"""Fused incremental cascade + DoG of one octave (``csrc/cascade.cu``).

Replaces ``siftmetal_tpu/ops/pallas/cascade.py`` ``_cascade_kernel``
(through ``octave_cascade_pallas`` :88): the whole octave in IPOL order
from its first slice, every Gaussian and DoG slice written once. The
incremental sigmas do not depend on the octave (delta_o cancels in
rho = sqrt(sigma_s^2 - sigma_{s-1}^2) / delta_o), so one tap schedule
serves every octave. The batch is a grid dimension of the kernel (the TPU
path mapped the kernel over frames on the host).

The kernel streams each frame down column strips (:func:`cascade_plan`:
strip width, row bands, ring pitches and depths, the launch table), the
input extended once by the total radius and every stage computed over
the extended plane, so its outputs equal the tiled first design's bit for
bit.

The plain version is the sequential cascade of shift-add blurs
(``ops/gaussian.py`` ``blur``, a symmetric extension before every pass)
and a subtraction; the kernel extends the input once by the total radius
instead, which is the same function to fp32 rounding.

Bound on an H100: bytes. See csrc/cascade.cu.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...config import SiftConfig
from .. import cuda as _cuda
from ..gaussian import blur, gaussian_taps
from . import LAUNCHES, require, use_kernel

# Shared memory a block may use on sm_90 (dynamic, opt-in).
_SMEM_BYTES = 232448
_TILES = (64, 32, 16)
# Rows a superstep of csrc/cascade.cu brings in (kG there), the columns
# of an X task (kXC), and the most stages and taps its launch parameter
# holds.
ROWS = 8
X_COLS = 8
MAX_STAGES = 12
MAX_TAPS = 512
# Output columns a block owns: the fastest of the sweep
# scripts/bench_cascade_orient.py prints. The rows a block walks follow
# from the card: as many row bands as fill its resident blocks (SMs x
# blocks an SM) in one wave, so no block waits for a second wave; the
# sweep's fixed heights beside it.
STRIP = 96
STRIP_CHOICES = (32, 64, 96, 128)
BAND_CHOICES = (120, 240, 480)
SMS = 132            # an H100's SMs: plans made without a card
_SM_BYTES = 233472   # shared memory of an SM (228 KB)
_STATIC_BYTES = 2048  # the kernel's static shared memory and the per-block reserve


@functools.lru_cache(maxsize=None)
def cascade_taps(config: SiftConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(taps float32 [n_stage, k_max] zero-padded, radii int32 [n_stage])
    of the octave-independent incremental blurs."""
    rows = [gaussian_taps(r) for r in config.incremental_sigmas(0)]
    k_max = max(len(t) for t in rows)
    taps = np.zeros((len(rows), k_max), np.float32)
    for s, t in enumerate(rows):
        taps[s, : len(t)] = t
    return taps, np.asarray([len(t) // 2 for t in rows], np.int32)


def cascade_tile(config: SiftConfig) -> int:
    """Largest output tile whose two haloed buffers fit in shared memory:
    the tiled first design's admission rule, which the streamed kernel
    keeps (every configuration it admits has a strip that fits)."""
    taps, radii = cascade_taps(config)
    total = int(radii.sum())
    for t in _TILES:
        side = t + 2 * total
        # Two haloed buffers of odd pitch, the kernel's 4 pad rows, the taps.
        if ((2 * side + 4) * (side | 1) + taps.size) * 4 <= _SMEM_BYTES:
            return t
    raise ValueError(
        f"octave_cascade: total cascade radius {total} does not fit the "
        "kernel's shared-memory tiles"
    )


def _up4(n: int) -> int:
    return -(-n // 4) * 4


class StagePlan(NamedTuple):
    """Stage s of a streamed launch (csrc/cascade.cu ``Stage``). P_s (slice
    s) is kept ``R - m`` columns past each side of the strip, X_s (its X
    pass) and P_{s+1} ``R - m - r``. A ring row holds its columns from
    physical column ``ax`` (X_s, P_{s+1}) or ``ap`` (P_s) on, so that the
    strip's first output column is 16-byte aligned in the X ring; offsets
    and pitches in floats."""

    r: int
    toff: int   # first tap of the stage in the launch's flat taps
    m: int      # radii of the stages before
    wx: int     # columns of X_s and P_{s+1}
    gx: int     # 4-column groups of an X ring row: ceil((ax + wx) / 4)
    px: int     # X ring: pitch (X tasks of X_COLS columns), depth (2 r + ROWS rows), offset
    dx: int
    ox: int
    pp: int     # P_s ring: pitch, depth (2 ROWS rows for s = 0, else ROWS), offset
    dp: int
    op: int
    ax: int     # physical column of X_s's (and P_{s+1}'s) column 0: 4 + (-e) mod 4
    ap: int     # physical column of P_s's column 0 (4 for the input)


class CascadePlan(NamedTuple):
    """A streamed cascade launch over [B, H, W]: one block per (column
    strip, row band, frame), the stages' rings in ``smem`` bytes of
    shared memory, then the column table at float offset ``oc``."""

    b: int
    h: int
    w: int
    radius: int   # R, the sum of the stage radii
    strip: int
    band: int
    strips: int
    bands: int
    smem: int
    oc: int
    stages: Tuple[StagePlan, ...]
    taps: np.ndarray  # float32, the stages' taps one after the other

    def table(self) -> np.ndarray:
        """The int32 launch table csrc/cascade.cu ``octave_cascade`` reads
        (11 head values, then 13 a stage)."""
        head = [self.b, self.h, self.w, len(self.stages), self.radius, self.strip,
                self.band, self.strips, self.bands, self.smem, self.oc]
        return np.asarray(head + [v for st in self.stages for v in st], np.int32)

    def block_rows(self, band: int) -> Tuple[int, int]:
        """Output rows [r0, r1) of row band ``band``; the block reads rows
        [r0 - R, r1 + R) of the extended plane."""
        r0 = band * self.band
        return r0, min(r0 + self.band, self.h)

    def block_cols(self, strip: int) -> Tuple[int, int]:
        """Output columns [c0, c1) of column strip ``strip``; the block
        reads columns [c0 - R, c0 + strip + R) of the extended plane."""
        c0 = strip * self.strip
        return c0, min(c0 + self.strip, self.w)


def _stages(radii, strip: int):
    """Stage plans of ``radii`` at ``strip`` and the floats they take (the
    rings after 4 floats of padding: a window may start up to 4 columns
    before its row)."""
    total = int(sum(radii))
    out, toff, m, off = [], 0, 0, 4
    rings = []
    ap, write = 4, 4 + strip + 2 * total    # the input's columns in P_0's ring
    for r in radii:
        r = int(r)
        wx = strip + 2 * (total - m - r)     # columns of X_s and P_{s+1}
        ax = 4 + (-(total - m - r)) % 4
        gx = -(-(ax + wx) // 4)
        px = X_COLS * -(-4 * gx // X_COLS)   # X tasks of X_COLS columns cover the row
        pp = _up4(max(write, px + 2 * r + 16))
        rings.append((r, toff, m, wx, gx, px, 2 * r + ROWS, pp, ROWS * (2 if m == 0 else 1),
                      ax, ap))
        toff += 2 * r + 1
        m += r
        ap, write = ax, 4 * gx
    for r, toff, m, wx, gx, px, dx, pp, dp, ax, ap in rings:
        op = off
        off += pp * dp
        ox = off
        off += px * dx
        out.append(StagePlan(r, toff, m, wx, gx, px, dx, ox, pp, dp, op, ax, ap))
    return tuple(out), off


def blocks_per_sm(smem: int) -> int:
    """Resident blocks an SM of a plan with ``smem`` bytes of dynamic
    shared memory (the kernel's launch bounds allow 2)."""
    return max(1, min(2, _SM_BYTES // (smem + _STATIC_BYTES)))


@functools.lru_cache(maxsize=64)
def cascade_plan(config: SiftConfig, b: int, h: int, w: int,
                 strip: int = STRIP, band: Optional[int] = None,
                 sms: int = SMS) -> CascadePlan:
    """The streamed launch of ``config``'s cascade over [b, h, w] at
    ``strip`` output columns a block (a strip too wide for shared memory
    halves until it fits) and ``band`` rows, by default the height that
    makes the blocks one wave on ``sms`` SMs."""
    taps, radii = cascade_taps(config)
    cascade_tile(config)                     # the admission rule
    if len(radii) > MAX_STAGES or int((2 * radii + 1).sum()) > MAX_TAPS:
        raise ValueError(f"octave_cascade: {len(radii)} stages of radii {list(radii)} "
                         "exceed the kernel's launch parameter")
    if (radii < 1).any():
        raise ValueError(f"octave_cascade: a stage radius below 1 in {list(radii)}")
    if strip < 4 or strip % 4 or (band is not None and band < 1):
        raise ValueError(f"octave_cascade: strip {strip} (a multiple of 4) and band {band}")
    total = int(radii.sum())
    while True:
        stages, floats = _stages(radii, strip)
        oc = floats
        smem = 4 * (floats + strip + 2 * total)
        if smem <= _SMEM_BYTES or strip <= 4:
            break
        strip = max(4, strip // 2 // 4 * 4)
    if smem > _SMEM_BYTES:
        raise ValueError(f"octave_cascade: radii {list(radii)} fit no strip")
    flat = np.concatenate([taps[s, : 2 * int(r) + 1] for s, r in enumerate(radii)])
    strips = -(-w // strip)
    if band is None:
        bands = max(1, min(h, sms * blocks_per_sm(smem) // (strips * b)))
        band = -(-h // bands)
    return CascadePlan(b, h, w, total, strip, band, strips, -(-h // band),
                       smem, oc, stages, flat.astype(np.float32))


def octave_cascade_plain(
    first: torch.Tensor, config: SiftConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    slices = [first]
    for rho in config.incremental_sigmas(0):
        slices.append(blur(slices[-1], rho))
    stack = torch.stack(slices, dim=1)
    return stack, stack[:, 1:] - stack[:, :-1]


@functools.lru_cache(maxsize=64)
def _launch(config: SiftConfig, b, h, w, strip, band, sms):
    """A plan and its launch table, made once per shape."""
    plan = cascade_plan(config, b, h, w, strip, band, sms)
    return plan, plan.table()


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def octave_cascade(
    first: torch.Tensor, config: SiftConfig, strip: int = STRIP,
    band: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """First slice [B, H, W] fp32 -> (gaussians [B, n+3, H, W], dogs
    [B, n+2, H, W]) of one octave; ``strip`` / ``band``: the block's
    columns and rows (:func:`cascade_plan`; the band by default fills the
    card's SMs in one wave)."""
    if config.pyramid_dtype != "float32":
        raise ValueError("octave_cascade: the fused cascade is the fp32 pyramid's")
    if not use_kernel(first, "octave_cascade"):
        return octave_cascade_plain(first, config)
    require(first, "octave_cascade")
    if first.ndim != 3:
        raise ValueError(f"octave_cascade: expected [B, H, W], got {tuple(first.shape)}")
    b, h, w = first.shape
    sms = _sm_count(first.device) if first.device.type == "cuda" else SMS
    plan, table = _launch(config, b, h, w, strip, band, sms)
    n_stage = len(plan.stages)
    gauss = torch.empty((b, n_stage + 1, h, w), dtype=torch.float32, device=first.device)
    dog = torch.empty((b, n_stage, h, w), dtype=torch.float32, device=first.device)
    with _cuda.launch_on(first) as stream:
        _cuda.check(
            _cuda.library("cascade").octave_cascade(
                first.data_ptr(), table.ctypes.data_as(ctypes.c_void_p),
                plan.taps.ctypes.data_as(ctypes.c_void_p), plan.taps.size,
                gauss.data_ptr(), dog.data_ptr(), stream),
            "octave_cascade",
        )
    LAUNCHES["octave_cascade"] += 1
    return gauss, dog
