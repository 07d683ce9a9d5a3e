"""Kernel wrappers of the port and their launch counters.

Each wrapper runs its kernel's plain PyTorch version for a tensor on the
CPU, launches its CUDA kernel for a tensor on a CUDA device (no fallback),
and raises for any other device. ``LAUNCHES[name]`` counts the CUDA
launches of wrapper ``name`` (the band wrappers count their bf16-input
form, and ``blur_cascade`` its bf16 chain, under ``name_bf16``); it moves nowhere else, so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

from typing import Dict

import torch

LAUNCHES: Dict[str, int] = {
    "seed_octave": 0,
    "octave_oneshot": 0,
    "blur_stack": 0,
    "detect_candidates": 0,
    "orientation_hist": 0,
    "descriptor_hist": 0,
    "seed_octave_bf16": 0,
    "octave_oneshot_bf16": 0,
    "blur_stack_bf16": 0,
    "octave_cascade": 0,
    "detect_candidates_lean": 0,
    "orient_desc": 0,
    "orientation_hist_banded": 0,
    "descriptor_hist_banded": 0,
    "blur_cascade": 0,
    "blur_cascade_bf16": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def use_kernel(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); raises for any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


def require(t: torch.Tensor, name: str, dtype=torch.float32) -> torch.Tensor:
    """Check what a CUDA kernel takes: dtype and contiguity."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t
