"""Median device ms of ``match_bruteforce`` over the traced slice's pairs,
between CUDA events the benchmark records around the call."""

import statistics


def read(trace):
    spans = trace.spans.get("match.ms")
    return statistics.median(spans) if spans else None
