"""Median device ms from the matcher's end to the decision's host read
(the gather of matched positions, ``find_homography``) over the traced
slice's pairs, between CUDA events the benchmark records."""

import statistics


def read(trace):
    spans = trace.spans.get("geometry.ms")
    return statistics.median(spans) if spans else None
