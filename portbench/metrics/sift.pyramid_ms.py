"""Device ms a frame of the ``sift.pyramid`` stage of the facade's traced
replay: the pyramid (seed, one-shot, cascade and blur launches,
decimations). The median over the program slice's calls of the span's
CUDA-event time, over the batch."""

from portbench.metrics._program import stage_ms


def read(trace):
    return stage_ms(trace, "sift.pyramid")
