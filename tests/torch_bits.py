"""Helpers shared by the port's tests: bit-for-bit comparison of two
extraction results (one route of ``extract_gray_batch`` against another)
and a dispatch mode that records reads of a device value on the host
(what a CUDA graph cannot hold)."""

import pathlib
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

import siftmetal_tpu_torch

PORT = str(pathlib.Path(siftmetal_tpu_torch.__file__).resolve().parent)

# The ops that read a device value back to the host (bool(), int(),
# .item(), nonzero's data-dependent size).
HOST_READS = (
    torch.ops.aten._local_scalar_dense,
    torch.ops.aten.is_nonzero,
    torch.ops.aten.item,
    torch.ops.aten.nonzero,
)


class HostReads(TorchDispatchMode):
    """Records every host read and the port's frames it was made from;
    reads made inside a kernel's plain version (a function ``*_plain``)
    are only counted."""

    def __init__(self):
        super().__init__()
        self.outside = []
        self.inside = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in HOST_READS:
            frames, f = [], sys._getframe(1)
            while f is not None:
                if f.f_code.co_filename.startswith(PORT):
                    frames.append((f.f_code.co_name, f"{f.f_code.co_filename}:{f.f_lineno}"))
                f = f.f_back
            if any(name.endswith("_plain") for name, _ in frames):
                self.inside += 1
            else:
                self.outside.append((str(func), frames[:2]))
        return func(*args, **(kwargs or {}))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bytes (NaN payloads included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    flat = lambda t: t.contiguous().reshape(-1).view(torch.uint8)
    return torch.equal(flat(a), flat(b))


def assert_same_bits(got, want):
    """Two (Keypoints, Descriptors, counters) results equal bit for bit in
    every field."""
    (kg, dg, cg), (kw, dw, cw) = got, want
    assert set(cg) == set(cw)
    for name, a, b in [*zip(kg._fields, kg, kw), *zip(dg._fields, dg, dw)]:
        assert same_bits(a, b), name
    for key in cw:
        assert same_bits(cg[key], cw[key]), key
