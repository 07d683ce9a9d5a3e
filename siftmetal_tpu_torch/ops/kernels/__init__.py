"""Kernel wrappers of the port and their launch counters.

Each wrapper runs its kernel's plain PyTorch version for a tensor on the
CPU, launches its CUDA kernel for a tensor on a CUDA device (no fallback),
and raises for any other device. ``LAUNCHES[name]`` counts the calls in
which wrapper ``name`` launches its CUDA kernel (the band wrappers count
their bf16-input form, and ``blur_cascade`` its bf16 chain, under
``name_bf16``); it moves nowhere else, so a run can show that its main
path went through the kernels. Under a CUDA graph capture the wrapper
records its launch into the graph and counts it; a replay of the graph
(``sift/extract.py``) runs no wrapper and counts nothing: a profile of
the replay counts its device kernels by name (``KERNEL_GROUPS``,
``device_launches``), to hold against an eager call's ``LAUNCHES``
(``group_launches``).
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Tuple

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
    "refine_tail": 0,
    "keypoint_compact": 0,
    "lane_peaks": 0,
    "quantize_rows": 0,
}


# The device function each group of wrappers launches, as a pattern of the
# (demangled) kernel name a profiler records; the wrappers of one group
# launch one function, so a profile counts the group's launches together.
KERNEL_GROUPS: Dict[str, Tuple[str, ...]] = {
    r"\bband_tiles_kernel<float\b": ("seed_octave", "octave_oneshot", "blur_stack"),
    r"\bband_tiles_kernel<(?!float\b)": (
        "seed_octave_bf16", "octave_oneshot_bf16", "blur_stack_bf16",
    ),
    r"\bblur_cascade_kernel<[^<>]*, false>": ("blur_cascade",),
    r"\bblur_cascade_kernel<[^<>]*, true>": ("blur_cascade_bf16",),
    r"\bstream_kernel<": ("octave_cascade",),
    r"\bdetect_kernel<true\b": ("detect_candidates",),
    r"\bdetect_kernel<false\b": ("detect_candidates_lean",),
    r"\borientation_kernel\b": ("orientation_hist",),
    r"\bdescriptor_kernel<": ("descriptor_hist",),
    r"\borient_desc_kernel<": ("orient_desc",),
    r"\bresident_orientation_kernel\b": ("orientation_hist_banded",),
    r"\bresident_descriptor_kernel<": ("descriptor_hist_banded",),
    r"\brefine_tail_kernel<": ("refine_tail",),
    r"\bkeypoint_compact_kernel\b": ("keypoint_compact",),
    r"\blane_peaks_kernel<": ("lane_peaks",),
    r"\bquantize_rows_kernel<": ("quantize_rows",),
}


def device_launches(kernel_names: Iterable[str]) -> Dict[Tuple[str, ...], int]:
    """Launches of each wrapper group (``KERNEL_GROUPS``' values) among the
    device kernels a profiler recorded, given by name."""
    counts = {group: 0 for group in KERNEL_GROUPS.values()}
    for name in kernel_names:
        for pattern, group in KERNEL_GROUPS.items():
            if re.search(pattern, name):
                counts[group] += 1
    return counts


def group_launches(launches: Dict[str, int]) -> Dict[Tuple[str, ...], int]:
    """Wrapper launch counts (as ``LAUNCHES``) summed over each group."""
    return {group: sum(launches[w] for w in group) for group in KERNEL_GROUPS.values()}


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
