"""Median device ms of the bundle adjustment's prologue (grouping, the
pair list and its sort, the first costs): the ``ba.prologue`` spans of
the program slice."""

from portbench.metrics._ba import median_device_ms


def read(trace):
    return median_device_ms(trace, "ba.prologue")
