"""Profiling and tracing shims.

Port of ``siftmetal_tpu/utils/profiling.py``: ``measure`` wraps a pipeline
phase in a wall clock and a ``torch.profiler.record_function`` span (it
shows up in any profile taken around it); ``capture`` records a
``torch.profiler`` trace of its body (CPU, and CUDA when a card is
present) and writes it to ``trace_dir`` as a Chrome/Perfetto JSON trace.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

logger = logging.getLogger("siftmetal_tpu_torch.perf")

_totals: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def measure(name: str, log: bool = False) -> Iterator[None]:
    """Wall-clock + profiler-annotated interval around a pipeline phase.
    The wall clock does not wait for the card: synchronise inside the
    body to time device work."""
    import torch

    start = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    dt = time.perf_counter() - start
    _totals[name] += dt
    _counts[name] += 1
    if log:
        logger.info("%s: %.3f ms", name, dt * 1e3)


def timings() -> Dict[str, Dict[str, float]]:
    """Accumulated {name: {total_s, count, mean_ms}} since reset."""
    return {
        k: {
            "total_s": _totals[k],
            "count": _counts[k],
            "mean_ms": 1e3 * _totals[k] / max(_counts[k], 1),
        }
        for k in _totals
    }


def reset_timings() -> None:
    _totals.clear()
    _counts.clear()


@contextlib.contextmanager
def capture(trace_dir: str, enabled: bool = True) -> Iterator[None]:
    """Device-level trace capture into ``trace_dir/trace.json`` (view with
    Perfetto or chrome://tracing). A disabled capture runs the body with
    no profiler at all."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
