"""Helpers of the readers of the program slice (``harness/program.py``):
its spans grouped by call, or by the span they lie under."""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

from portbench.harness import program

STAGES = ("sift.pyramid", "sift.detect", "sift.describe", "sift.compact")


def device_ms_by_call(sl, name: str) -> Optional[Dict[int, float]]:
    """{call: device ms of the spans named ``name`` in it}; None where
    there is none, or one of them has no device time."""
    out: Dict[int, float] = {}
    for s in sl.spans:
        if s.name == name:
            if s.device_ms is None:
                return None
            out[s.call] = out.get(s.call, 0.0) + s.device_ms
    return out or None


def stage_ms(trace, name: str) -> Optional[float]:
    """Median over the slice's facade calls of the stage's device ms, a
    frame."""
    sl = program.of(trace)
    if sl is None:
        return None
    per_call = device_ms_by_call(sl, name)
    if per_call is None:
        return None
    return statistics.median(per_call.values()) * sl.calls / sl.items


def under(sl, name: str, child: str) -> List[tuple]:
    """(span named ``name``, the spans named ``child`` anywhere under it)
    for each span named ``name``."""
    by_id = {s.id: s for s in sl.spans}
    kids: Dict[int, list] = {s.id: [] for s in sl.spans if s.name == name}
    for s in sl.spans:
        if s.name != child:
            continue
        p = s.parent
        while p is not None and p not in kids:
            p = by_id[p].parent
        if p is not None:
            kids[p].append(s)
    return [(by_id[i], ks) for i, ks in kids.items()]

