"""Seed image and the incremental Gaussian cascade (fp32 or bf16 chain).

Port of ``siftmetal_tpu/sift/pyramid.py`` ``seed_image`` :41 and
``cascade_slices`` :78. Every blur goes through the band kernel wrapper
(``ops/kernels/blur.py``): its plain version on the CPU, its CUDA kernel
on the card. ``cascade_slices`` is the per-stage route, one ``blur_stack``
a stage; ``sift/batched.py`` runs the same cascade in one launch an
octave (``blur_cascade``), equal to it bit for bit.

With ``pyramid_dtype="bfloat16"`` the chain each blur READS is bf16 and
every EMITTED slice is the blur's fp32 accumulator: Gaussians stored in
bf16 would collide neighbouring DoG samples into plateaus, which the
strict extremum test rejects.
"""

from __future__ import annotations

from typing import List

import torch

from ..config import SiftConfig
from ..ops.image import upsample_bilinear_2x
from ..ops.kernels.blur import blur_stack


def is_bf16(config: SiftConfig) -> bool:
    """True for the bf16 blur chain; raises on an unknown pyramid_dtype."""
    if config.pyramid_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unsupported pyramid_dtype {config.pyramid_dtype!r}")
    return config.pyramid_dtype == "bfloat16"


def seed_image(gray: torch.Tensor, config: SiftConfig) -> torch.Tensor:
    """Grayscale [..., H, W] (fp32, or bf16 in the fast mode) -> blurred
    fp32 seed v(0, 0): 2x bilinear upsample when delta_min = 0.5 (none at
    1.0), then a blur by sqrt(sigma_min^2 - sigma_input^2) / delta_min.
    The result is the blur's fp32 accumulator (what the JAX package's
    callers ask for with ``out_dtype=float32``)."""
    if config.delta_min == 1.0:
        scaled = gray
    elif config.delta_min == 0.5:
        scaled = upsample_bilinear_2x(gray)
    else:
        raise ValueError(f"unsupported delta_min {config.delta_min}")
    return blur_stack(scaled, config.seed_blur_sigma())


def cascade_slices(
    first: torch.Tensor, o: int, config: SiftConfig
) -> List[torch.Tensor]:
    """Progressively blurred fp32 slices of octave ``o``: slice s is slice
    s-1 blurred by the incremental sigma rho[s-1 -> s]. In the bf16 mode
    each blur reads the previous slice rounded to bf16."""
    bf16 = is_bf16(config)
    slices = [first.float()]
    chain = first.to(torch.bfloat16) if bf16 else first
    for rho in config.incremental_sigmas(o):
        out = blur_stack(chain, rho)
        chain = out.to(torch.bfloat16) if bf16 else out
        slices.append(out)
    return slices
