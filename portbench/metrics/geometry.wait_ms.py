"""Host ms a pair blocked in the library SVDs of RANSAC (each checks its
convergence flag on the host, so waits for the device): the median over
the program slice's ``geometry`` spans of the summed ``twoview.svd``
spans under each."""

import statistics

from portbench.harness import program
from portbench.metrics._program import under


def read(trace):
    sl = program.of(trace)
    if sl is None:
        return None
    per_pair = [sum(s.host_ms for s in svds) for _, svds in under(sl, "geometry", "twoview.svd")]
    return statistics.median(per_pair) if per_pair else None
