"""Public SIFT extraction facade: image in, padded keypoint and descriptor
tensors out.

Port of ``siftmetal_tpu/sift/extract.py``. Shapes are static per
(height, width, config), so a ``SIFT`` object is built once per
resolution and reused. It runs on the CUDA card unless the caller asks
for the CPU; without a card it raises rather than carry on elsewhere.

What ``jax.jit`` does for the JAX facade (one compiled program per shape,
dispatched once a call), a CUDA graph does here: on a CUDA device ``SIFT``
captures :func:`~.batched.extract_gray_batch` once per batch size through
``graphs.GraphCache`` (after one eager warm-up call on a side stream,
which builds the kernels and fills every table cache) and replays it on
every later call, returning fresh copies of the graph's outputs. The
pipeline reads nothing back to the host, so one replay runs it whole. A
replay runs no kernel wrapper, so ``ops.kernels.LAUNCHES`` does not count
it (a profile of the replay counts its kernels:
``ops.kernels.device_launches``). A capture that fails raises. On the CPU
the facade runs the pipeline eagerly; so does a direct call of
``extract_gray_batch`` on any device.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, SiftConfig
from ..device import resolve_device
from ..graphs import GraphCache
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

    return _first_frame(extract_gray_batch(gray[None], config, n_octaves))


def _first_frame(result):
    """Batched (Keypoints, Descriptors, counters) -> frame 0's."""
    kps, descs, counters = result
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

    On a CUDA device each batch size is captured into a CUDA graph on its
    first call (``extract`` is batch size 1) and replayed after; the
    graphs of one instance share one memory pool.
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
        self._cache = GraphCache(_extract_program, "extract_gray_batch")

    def _to_gray(self, images, ndim_gray: int) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images) else images)
        t = t.to(device=self.device, dtype=torch.float32)
        if t.ndim == ndim_gray + 1:
            t = rgb_to_gray(t)
        if t.ndim != ndim_gray or tuple(t.shape[-2:]) != (self.height, self.width):
            raise ValueError(
                f"expected frames of {self.height}x{self.width}, got {tuple(t.shape)}"
            )
        return t.contiguous()

    def extract(self, image):
        """[H, W] gray or [H, W, C] RGB -> (Keypoints, Descriptors, counters)."""
        return _first_frame(self._run(self._to_gray(image, 2)[None]))

    def extract_batch(self, images):
        """[B, H, W] gray or [B, H, W, C] RGB -> batched results."""
        return self._run(self._to_gray(images, 3))

    @property
    def _graphs(self) -> Dict[int, object]:
        """The captured programs by batch size."""
        return {key.tensors[0][0][0]: prog for key, prog in self._cache.graphs.items()}

    def _run(self, grays: torch.Tensor):
        """``extract_gray_batch`` of a [B, H, W] batch on this instance's
        device: eager on the CPU, a replay of the batch size's graph on a
        CUDA device."""
        return self._cache(grays, config=self.config, n_octaves=self.n_octaves)


def _extract_program(steps, frames, config, n_octaves):
    from .batched import extract_gray_batch

    return steps.stage(extract_gray_batch, frames, config, n_octaves)
