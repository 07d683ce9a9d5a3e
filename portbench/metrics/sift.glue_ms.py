"""Device ms a frame of every kernel in the traced slice outside the
port's hand-written kernel groups: the refinement tail, the compactions
and the describe glue (small PyTorch kernels)."""

from portbench.roofline.groups import KERNEL_PATTERNS


def read(trace):
    total = sum(k.dur_us for k in trace.kernels) * 1e-6
    glue = total - trace.kernel_seconds(KERNEL_PATTERNS)
    return 1e3 * glue / trace.items
