"""Keypoint agreement between two extractions of one image.

The port's copy of the identity-homography case of
``siftmetal_tpu/utils/repeatability.py`` ``repeatability``: the fraction
of A's keypoints (inside a margin) that have a keypoint of B within a
blur-scaled tolerance. Used to hold the bf16 pyramid against the fp32 one.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def keypoint_array(kps) -> Tuple[np.ndarray, np.ndarray]:
    """Valid (x, y) points [N, 2] and sigmas [N] of a single-frame
    ``Keypoints`` tuple, as numpy."""
    v = kps.valid.cpu().numpy()
    pts = np.stack([kps.x.cpu().numpy()[v], kps.y.cpu().numpy()[v]], axis=1)
    return pts, kps.sigma.cpu().numpy()[v]


def keypoint_agreement(
    pts_a: np.ndarray,
    sig_a: np.ndarray,
    pts_b: np.ndarray,
    shape: Tuple[int, int],
    margin: float = 10.0,
    base_tol: float = 1.5,
    sigma_tol: float = 0.3,
) -> float:
    """Fraction of A-keypoints inside the margin with a B-keypoint within
    max(base_tol, sigma_tol * sigma). NaN when no A-keypoint is inside or
    B is empty."""
    h_img, w_img = shape
    inside = (
        (pts_a[:, 0] > margin) & (pts_a[:, 0] < h_img - margin)
        & (pts_a[:, 1] > margin) & (pts_a[:, 1] < w_img - margin)
    )
    if not np.any(inside) or len(pts_b) == 0:
        return float("nan")
    d = np.sqrt(((pts_a[inside][:, None, :] - pts_b[None, :, :]) ** 2).sum(-1)).min(1)
    tol = np.maximum(base_tol, sigma_tol * sig_a[inside])
    return float((d < tol).mean())
