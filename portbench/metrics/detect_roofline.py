"""Share of the detection kernel's roofline in one call (%), with the soft
extrema the slice's frames counted."""

from portbench.metrics._extract import params, roofline_pct, slice_frames
from portbench.roofline import detect


def read(trace):
    c = trace.context
    n_soft = sum(float(f["counters"]["n_soft"]) for f in slice_frames(trace)) / trace.calls
    work = detect.work(params(trace), c["config"]["height"], c["config"]["width"], c["batch"],
                       c["n_octaves"], n_soft)
    return roofline_pct(trace, detect.PATTERNS, work)
