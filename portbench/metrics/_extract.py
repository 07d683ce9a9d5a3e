"""Helpers of the extraction cells' readers: the per-call share of a
kernel group's roofline from a traced slice."""

from __future__ import annotations

from typing import Optional

from portbench.reference.sift import Params
from portbench.roofline import peaks


def roofline_pct(trace, patterns, work_per_call) -> Optional[float]:
    """100 x least time / device time a call, for the kernels matching
    ``patterns``; None when the slice ran none of them."""
    seconds = trace.kernel_seconds(patterns) / trace.calls
    if seconds <= 0.0:
        return None
    nbytes, nops = work_per_call
    return 100.0 * peaks.least_seconds(nbytes, nops, trace.context["device_name"]) / seconds


def params(trace) -> Params:
    return Params.from_dict(trace.context["config"]["sift"])


def slice_frames(trace):
    """The outputs of every frame the slice extracted, with repeats."""
    outs = trace.context["frame_outputs"]
    return [outs[f] for f in trace.context["slice_frames"]]
