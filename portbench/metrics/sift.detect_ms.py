"""Device ms a frame of the ``sift.detect`` stage of the facade's traced
replay: detection (the detection kernel and the refinement tail). The
median over the program slice's calls of the span's CUDA-event time,
over the batch."""

from portbench.metrics._program import stage_ms


def read(trace):
    return stage_ms(trace, "sift.detect")
