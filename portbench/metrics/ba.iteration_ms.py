"""Median device ms of one LM iteration of the bundle adjustment: the
``ba.iteration`` spans of the program slice, one a replay of the
iteration's graph."""

from portbench.metrics._ba import median_device_ms


def read(trace):
    return median_device_ms(trace, "ba.iteration")
