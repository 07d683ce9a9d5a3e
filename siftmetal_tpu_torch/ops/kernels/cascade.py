"""Fused incremental cascade + DoG of one octave (``csrc/cascade.cu``).

Replaces ``siftmetal_tpu/ops/pallas/cascade.py`` ``_cascade_kernel``
(through ``octave_cascade_pallas`` :88): the whole octave in IPOL order
from its first slice, every Gaussian and DoG slice written once. The
incremental sigmas do not depend on the octave (delta_o cancels in
rho = sqrt(sigma_s^2 - sigma_{s-1}^2) / delta_o), so one tap schedule
serves every octave. The batch is a grid dimension of the kernel (the TPU
path mapped the kernel over frames on the host).

The plain version is the sequential cascade of shift-add blurs
(``ops/gaussian.py`` ``blur``, a symmetric extension before every pass)
and a subtraction; the kernel extends the input once by the total radius
instead, which is the same function to fp32 rounding.

Bound on an H100: bytes. See csrc/cascade.cu.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ...config import SiftConfig
from .. import cuda as _cuda
from ..gaussian import blur, gaussian_taps
from . import LAUNCHES, require, use_kernel

# Shared memory a block may use on sm_90 (dynamic, opt-in).
_SMEM_BYTES = 232448
_TILES = (64, 32, 16)


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
    """Largest output tile whose two haloed buffers fit in shared memory."""
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


def octave_cascade_plain(
    first: torch.Tensor, config: SiftConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    slices = [first]
    for rho in config.incremental_sigmas(0):
        slices.append(blur(slices[-1], rho))
    stack = torch.stack(slices, dim=1)
    return stack, stack[:, 1:] - stack[:, :-1]


_device_taps = {}


def octave_cascade(
    first: torch.Tensor, config: SiftConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """First slice [B, H, W] fp32 -> (gaussians [B, n+3, H, W], dogs
    [B, n+2, H, W]) of one octave."""
    if config.pyramid_dtype != "float32":
        raise ValueError("octave_cascade: the fused cascade is the fp32 pyramid's")
    if not use_kernel(first, "octave_cascade"):
        return octave_cascade_plain(first, config)
    require(first, "octave_cascade")
    if first.ndim != 3:
        raise ValueError(f"octave_cascade: expected [B, H, W], got {tuple(first.shape)}")
    b, h, w = first.shape
    taps, radii = cascade_taps(config)
    tile = cascade_tile(config)
    key = (config, str(first.device))
    dev_tabs = _device_taps.get(key)
    if dev_tabs is None:
        dev_tabs = (torch.from_numpy(taps).to(first.device),
                    torch.from_numpy(radii).to(first.device))
        _device_taps[key] = dev_tabs
    n_stage = len(radii)
    gauss = torch.empty((b, n_stage + 1, h, w), dtype=torch.float32, device=first.device)
    dog = torch.empty((b, n_stage, h, w), dtype=torch.float32, device=first.device)
    with _cuda.launch_on(first) as stream:
        _cuda.check(
            _cuda.library("cascade").octave_cascade(
                first.data_ptr(), b, h, w, dev_tabs[0].data_ptr(),
                dev_tabs[1].data_ptr(), n_stage, taps.shape[1], int(radii.sum()),
                tile, gauss.data_ptr(), dog.data_ptr(), stream),
            "octave_cascade",
        )
    LAUNCHES["octave_cascade"] += 1
    return gauss, dog
