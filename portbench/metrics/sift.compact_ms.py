"""Device ms a frame of the ``sift.compact`` stage of the facade's traced
replay: the global keypoint and descriptor compactions. The median over
the program slice's calls of the span's CUDA-event time, over the batch."""

from portbench.metrics._program import stage_ms


def read(trace):
    return stage_ms(trace, "sift.compact")
