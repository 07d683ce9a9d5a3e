"""Device ms a frame of the facade's copies around its replay: the
median over the program slice's calls of ``sift.extract``'s CUDA-event
time (upload, replay, output clones) less its four stages', over the
batch."""

import statistics

from portbench.harness import program
from portbench.metrics._program import STAGES, device_ms_by_call


def read(trace):
    sl = program.of(trace)
    if sl is None:
        return None
    calls = device_ms_by_call(sl, "sift.extract")
    stages = [device_ms_by_call(sl, name) for name in STAGES]
    if calls is None or None in stages:
        return None
    io = [ms - sum(s.get(c, 0.0) for s in stages) for c, ms in calls.items()]
    return statistics.median(io) * sl.calls / sl.items
