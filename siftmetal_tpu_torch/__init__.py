"""siftmetal_tpu_torch: the PyTorch/CUDA port of siftmetal_tpu.

Batched SIFT extraction (pyramid, detection, orientation, descriptors) on
an NVIDIA H100, with hand-written CUDA kernels for the stages the JAX
package ran as Pallas TPU kernels. The JAX package ``siftmetal_tpu`` is
the reference it is held against; this package imports none of it.

    from siftmetal_tpu_torch import SIFT
    kps, descs, counters = SIFT(480, 640).extract(frame)      # on CUDA
    kps, descs, counters = SIFT(480, 640, device="cpu").extract(frame)
"""

from .config import (
    DEFAULT_CONFIG,
    FAST_BF16_CONFIG,
    FAST_CONFIG,
    SiftConfig,
    config_from_dict,
)
from .sift.detect import Keypoints
from .sift.extract import SIFT, Descriptors, extract, extract_gray
from .sift.batched import extract_gray_batch

__all__ = [
    "DEFAULT_CONFIG",
    "FAST_BF16_CONFIG",
    "FAST_CONFIG",
    "SiftConfig",
    "config_from_dict",
    "Keypoints",
    "Descriptors",
    "SIFT",
    "extract",
    "extract_gray",
    "extract_gray_batch",
]
