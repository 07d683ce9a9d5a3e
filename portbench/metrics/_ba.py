"""Helpers of the readers of the bundle adjustment's spans in the program
slice (``harness/program.py``)."""

from __future__ import annotations

import statistics
from typing import Optional

from portbench.harness import program


def median_device_ms(trace, name: str) -> Optional[float]:
    """Median device ms of the slice's spans named ``name``; None where
    there is no slice, no such span, or one without device time."""
    sl = program.of(trace)
    if sl is None:
        return None
    ms = [s.device_ms for s in sl.spans if s.name == name]
    if not ms or any(m is None for m in ms):
        return None
    return statistics.median(ms)
