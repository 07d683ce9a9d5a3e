"""Seed image and the incremental Gaussian cascade (fp32).

Port of ``siftmetal_tpu/sift/pyramid.py`` ``seed_image`` :41 and
``cascade_slices`` :78. Every blur goes through the band kernel wrapper
(``ops/kernels/blur.py``): its plain version on the CPU, its CUDA kernel
on the card.
"""

from __future__ import annotations

from typing import List

import torch

from ..config import SiftConfig
from ..ops.image import upsample_bilinear_2x
from ..ops.kernels.blur import blur_stack


def _check_fp32(config: SiftConfig) -> None:
    if config.pyramid_dtype != "float32":
        raise NotImplementedError(
            f"pyramid_dtype={config.pyramid_dtype!r}: the port runs the "
            "fp32 pyramid only"
        )


def seed_image(gray: torch.Tensor, config: SiftConfig) -> torch.Tensor:
    """Grayscale [..., H, W] -> blurred seed v(0, 0): 2x bilinear upsample
    when delta_min = 0.5 (none at 1.0), then a blur by
    sqrt(sigma_min^2 - sigma_input^2) / delta_min."""
    _check_fp32(config)
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
    """Progressively blurred slices of octave ``o``: slice s is slice s-1
    blurred by the incremental sigma rho[s-1 -> s]."""
    _check_fp32(config)
    slices = [first]
    chain = first
    for rho in config.incremental_sigmas(o):
        chain = blur_stack(chain, rho)
        slices.append(chain)
    return slices
