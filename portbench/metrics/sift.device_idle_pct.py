"""Share of the program slice's device time outside every facade call
(%), profiler off: 100 x (1 - the union of the ``sift.extract`` device
spans over the first one's start to the last one's end). The harness's
copies of the outputs to pinned memory run outside the facade's span and
count as idle."""

from portbench.harness import program
from portbench.harness.trace import _union


def read(trace):
    sl = program.of(trace)
    if sl is None:
        return None
    spans = [s for s in sl.spans if s.name == "sift.extract"]
    if not spans or any(s.device_ms is None for s in spans):
        return None
    first = min(s.device_start_ms for s in spans)
    last = max(s.device_end_ms for s in spans)
    if last <= first:
        return None
    busy = sum(b - a for a, b in _union([(s.device_start_ms, s.device_end_ms) for s in spans]))
    return 100.0 * (1.0 - busy / (last - first))
