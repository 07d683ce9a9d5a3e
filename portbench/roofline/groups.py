"""The hand-written kernel groups of the port, as patterns of the
demangled device-function names a profiler records (copied from the
port's ``ops/kernels`` ``KERNEL_GROUPS``, so a rename there does not move
this yardstick). A kernel outside all of them is glue: small PyTorch
kernels of the refinement tail, the compactions and the describe stage."""

KERNEL_PATTERNS = (
    r"\bband_tiles_kernel<",
    r"\bblur_cascade_kernel<",
    r"\bstream_kernel<",
    r"\bdetect_kernel<",
    r"\borientation_kernel\b",
    r"\bdescriptor_kernel<",
    r"\borient_desc_kernel<",
    r"\bresident_orientation_kernel\b",
    r"\bresident_descriptor_kernel<",
)
