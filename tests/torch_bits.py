"""Bit-for-bit comparison of two extraction results, shared by the port's
tests that hold one route of ``extract_gray_batch`` against another."""

import torch


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
