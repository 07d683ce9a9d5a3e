"""Single-sigma Gaussian blur of a stack through the band kernel.

Replaces ``siftmetal_tpu/ops/pallas/blur.py`` ``_blur_kernel`` (through
``blur_pallas`` :61 and ``blur_stack_pallas`` :110): a separable
Gaussian with the half-sample-symmetric boundary, fp32 taps and fp32
accumulation. In the JAX package only
tests call it and the TPU runs the small-octave cascade in XLA; in the
port it carries that cascade (octaves under 176 rows) and the unfused
seed, through the same ``csrc/pyramid.cu`` passes as the one-shot octave
with one slice and no DoG.

A bf16 stack (the fast preset's blur chain; the bf16 branch of
``siftmetal_tpu/ops/gaussian.py`` ``blur`` :166 with
``out_dtype=float32``) is read as bf16; the X pass rounds its fp32 sum
once to bf16, the Y pass reads that and returns its fp32 sum un-rounded.

Bound on an H100: bytes for the large inputs; the small octaves it serves
in the cascade (<= 120x160) are launch-bound.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from ..gaussian import band_matrix
from . import use_kernel
from .pyramid import BandTables, pack_tables, separable_bands


@functools.lru_cache(maxsize=None)
def blur_tables(sigma: float, h: int, w: int) -> Tuple[BandTables, BandTables]:
    return (
        pack_tables([band_matrix(float(sigma), w)]),
        pack_tables([band_matrix(float(sigma), h)]),
    )


def blur_stack(stack: torch.Tensor, sigma: float) -> torch.Tensor:
    """Blur every [H, W] slice of a [..., H, W] fp32 or bf16 stack by
    ``sigma``; the result is fp32."""
    lead = stack.shape[:-2]
    h, w = stack.shape[-2:]
    flat = stack.reshape((-1, h, w))
    if use_kernel(flat, "blur_stack"):
        flat = flat.contiguous()
    tx, ty = blur_tables(float(sigma), h, w)
    gauss, _ = separable_bands(
        flat, ("blur", float(sigma), h, w), tx, ty, None, False, "blur_stack",
        mid_dtype=stack.dtype,
    )
    return gauss[:, 0].reshape(lead + (h, w))
