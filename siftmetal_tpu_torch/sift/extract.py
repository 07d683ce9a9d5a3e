"""Public SIFT extraction facade: image in, padded keypoint and descriptor
tensors out.

Port of ``siftmetal_tpu/sift/extract.py``. Shapes are static per
(height, width, config), so a ``SIFT`` object is built once per
resolution and reused. It runs on the CUDA card unless the caller asks
for the CPU; without a card it raises rather than carry on elsewhere.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, SiftConfig
from ..device import resolve_device
from ..ops.image import rgb_to_gray
from .detect import Keypoints


class Descriptors(NamedTuple):
    """Global padded descriptor set; ``features`` is uint8 (IPOL
    quantization). Fields are [N] ([N, 128]) per frame, with a leading [B]
    from the batch API."""

    valid: torch.Tensor     # bool
    octave: torch.Tensor    # int32
    x: torch.Tensor         # f32 — row, input-image units
    y: torch.Tensor         # f32 — col, input-image units
    sigma: torch.Tensor     # f32
    theta: torch.Tensor     # f32 — reference orientation, (-pi, pi]
    features: torch.Tensor  # uint8 [..., 128]

    @property
    def count(self) -> torch.Tensor:
        return self.valid.sum(-1, dtype=torch.int32)


def extract_gray(
    gray: torch.Tensor, config: SiftConfig, n_octaves: int
) -> Tuple[Keypoints, Descriptors, Dict[str, torch.Tensor]]:
    """Full SIFT on one [H, W] grayscale image: the batched pipeline at
    B=1, with the frame axis taken off every output."""
    from .batched import extract_gray_batch

    kps, descs, counters = extract_gray_batch(gray[None], config, n_octaves)
    first = lambda a: a[0]
    return (
        Keypoints(*map(first, kps)),
        Descriptors(*map(first, descs)),
        {k: first(v) for k, v in counters.items()},
    )


def extract(
    image: torch.Tensor, config: SiftConfig, n_octaves: int
) -> Tuple[Keypoints, Descriptors, Dict[str, torch.Tensor]]:
    """Like :func:`extract_gray` but takes [H, W, 3|4] gamma-space RGB."""
    return extract_gray(rgb_to_gray(image), config, n_octaves)


class SIFT:
    """Per-resolution SIFT extractor.

    Example:
        sift = SIFT(480, 640)                         # on the CUDA card
        kps, descs, counters = sift.extract(frame)    # one [H, W] frame
        kb, db, cb = sift.extract_batch(frames)       # [B, H, W] batch
    """

    def __init__(
        self,
        height: int,
        width: int,
        config: SiftConfig = DEFAULT_CONFIG,
        n_octaves: Optional[int] = None,
        device=None,
    ):
        self.config = config
        self.height = height
        self.width = width
        self.device = resolve_device(device)
        self.n_octaves = (
            n_octaves if n_octaves is not None else config.num_octaves(height, width)
        )

    def _to_gray(self, images, ndim_gray: int) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images) else images)
        t = t.to(device=self.device, dtype=torch.float32)
        if t.ndim == ndim_gray + 1:
            t = rgb_to_gray(t)
        if tuple(t.shape[-2:]) != (self.height, self.width):
            raise ValueError(
                f"expected frames of {self.height}x{self.width}, got {tuple(t.shape)}"
            )
        return t.contiguous()

    def extract(self, image):
        """[H, W] gray or [H, W, C] RGB -> (Keypoints, Descriptors, counters)."""
        return extract_gray(self._to_gray(image, 2), self.config, self.n_octaves)

    def extract_batch(self, images):
        """[B, H, W] gray or [B, H, W, C] RGB -> batched results."""
        from .batched import extract_gray_batch

        return extract_gray_batch(self._to_gray(images, 3), self.config, self.n_octaves)
