"""Share of its roofline in one LM iteration of the bundle adjustment
(%): the least time of an iteration (``roofline/ba.py``, from the
problem's cameras, points, observations and same-landmark pairs) over
``ba.iteration_ms``. The pairs a solve are the program slice's counters,
``ba.pairs`` over ``ba.solves``."""

from portbench.harness import program
from portbench.metrics._ba import median_device_ms
from portbench.roofline import ba, peaks


def read(trace):
    ms = median_device_ms(trace, "ba.iteration")
    sl = program.of(trace)
    if ms is None or not sl.counters.get("ba.solves") or "ba.pairs" not in sl.counters:
        return None
    c = trace.context["config"]
    pairs = sl.counters["ba.pairs"] / sl.counters["ba.solves"]
    nbytes, nops = ba.work(c["cameras"], c["points"], c["observations"], pairs,
                           ba.CAMERA_WIDTH[c["camera_model"]])
    return 100.0 * peaks.least_seconds(nbytes, nops, trace.context["device_name"]) / (ms * 1e-3)
