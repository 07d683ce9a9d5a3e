"""Share of the pyramid kernels' roofline in one call (%): the least time
of the fused seed, one-shot and cascade launches (bytes or operations,
whichever bounds) over their device time a call in the traced slice."""

from portbench.metrics._extract import params, roofline_pct
from portbench.roofline import pyramid


def read(trace):
    c = trace.context
    work = pyramid.work(params(trace), c["config"]["height"], c["config"]["width"], c["batch"],
                        c["n_octaves"])
    return roofline_pct(trace, pyramid.PATTERNS, work)
