"""Host ms a pair spent issuing RANSAC's work: the median over the
program slice's ``geometry`` spans of each span's host ms less the
``twoview.svd`` spans under it (the SVDs' waits, ``geometry.wait_ms``)."""

import statistics

from portbench.harness import program
from portbench.metrics._program import under


def read(trace):
    sl = program.of(trace)
    if sl is None:
        return None
    per_pair = [g.host_ms - sum(s.host_ms for s in svds)
                for g, svds in under(sl, "geometry", "twoview.svd")]
    return statistics.median(per_pair) if per_pair else None
