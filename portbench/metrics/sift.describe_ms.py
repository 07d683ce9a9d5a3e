"""Device ms a frame of the ``sift.describe`` stage of the facade's traced
replay: orientation and descriptors (each octave's keypoint compaction
and patch fields, the patch kernels, the peaks and the lane
compactions). The median over the program slice's calls of the span's
CUDA-event time, over the batch."""

from portbench.metrics._program import stage_ms


def read(trace):
    return stage_ms(trace, "sift.describe")
