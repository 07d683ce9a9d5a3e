"""Share of the staged orientation and descriptor kernels' roofline in
one call (%): operations of the samples inside each keypoint's and each
descriptor's window, from the slice's own outputs."""

from portbench.metrics._extract import params, roofline_pct
from portbench.roofline import describe


def read(trace):
    c = trace.context
    p, h, w = params(trace), c["config"]["height"], c["config"]["width"]
    per_frame = {f: describe.work(p, h, w, out, c["device"])
                 for f, out in c["frame_outputs"].items()}
    frames = c["slice_frames"]
    nbytes = sum(per_frame[f][0] for f in frames) / trace.calls
    nops = sum(per_frame[f][1] for f in frames) / trace.calls
    return roofline_pct(trace, describe.PATTERNS, (nbytes, nops))
