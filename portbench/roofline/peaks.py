"""Published peaks of the H100 parts (NVIDIA data sheets, dense, no
sparsity): device-memory bytes/s and fp32 (non-tensor-core) FLOP/s,
picked by the card's name."""

from __future__ import annotations

from typing import Tuple

PEAKS = {
    "PCIe": (2.0e12, 51.2e12),
    "NVL": (3.9e12, 60.0e12),
    "SXM": (3.35e12, 67.0e12),
}


def peaks(device_name: str) -> Tuple[float, float]:
    for key in ("PCIe", "NVL"):
        if key in device_name:
            return PEAKS[key]
    return PEAKS["SXM"]


def least_seconds(nbytes: float, nops: float, device_name: str) -> float:
    """The larger of bytes over peak bandwidth and operations over peak
    fp32 rate: the least time the card could take."""
    bw, fl = peaks(device_name)
    return max(nbytes / bw, nops / fl)
