"""Keypoint repeatability harness under known homographies.

Port of ``siftmetal_tpu/utils/repeatability.py``: the detector-stability
measure (warp an image with a known H, count the keypoints of the source
that are re-detected within a blur-scaled tolerance) over a deterministic
warp battery of rotations, scales and a perspective tilt. With the
identity homography it measures what a reduced-precision or fast pyramid
mode loses against a baseline on the SAME image
(:func:`keypoint_agreement`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.warp import apply_homography, similarity_homography, warp_perspective


def keypoint_array(kps) -> Tuple[np.ndarray, np.ndarray]:
    """Valid (x, y) points [N, 2] and sigmas [N] of a single-frame
    ``Keypoints`` tuple, as numpy."""
    v = kps.valid.cpu().numpy()
    pts = np.stack([kps.x.cpu().numpy()[v], kps.y.cpu().numpy()[v]], axis=1)
    return pts, kps.sigma.cpu().numpy()[v]


def repeatability(
    pts_a: np.ndarray,
    sig_a: np.ndarray,
    pts_b: np.ndarray,
    hmat: np.ndarray,
    shape: Tuple[int, int],
    margin: float = 10.0,
    base_tol: float = 1.5,
    sigma_tol: float = 0.3,
) -> float:
    """Fraction of A-keypoints (projected by ``hmat`` into B's frame,
    landing inside the margin) with a B-keypoint within
    max(base_tol, sigma_tol * sigma). NaN when no projected point lands
    inside or B is empty."""
    h_img, w_img = shape
    proj = apply_homography(
        torch.from_numpy(np.asarray(hmat, dtype=np.float32)),
        torch.from_numpy(np.asarray(pts_a, dtype=np.float32)),
    ).numpy()
    inside = (
        (proj[:, 0] > margin) & (proj[:, 0] < h_img - margin)
        & (proj[:, 1] > margin) & (proj[:, 1] < w_img - margin)
    )
    if not np.any(inside) or len(pts_b) == 0:
        return float("nan")
    d = np.sqrt(((proj[inside][:, None, :] - pts_b[None, :, :]) ** 2).sum(-1)).min(1)
    tol = np.maximum(base_tol, sigma_tol * sig_a[inside])
    return float((d < tol).mean())


def keypoint_agreement(
    pts_a: np.ndarray,
    sig_a: np.ndarray,
    pts_b: np.ndarray,
    shape: Tuple[int, int],
    margin: float = 10.0,
    base_tol: float = 1.5,
    sigma_tol: float = 0.3,
) -> float:
    """:func:`repeatability` under the identity: agreement of two
    extractions of one image."""
    return repeatability(
        pts_a, sig_a, pts_b, np.eye(3, dtype=np.float32), shape, margin, base_tol, sigma_tol
    )


def standard_warp_battery(shape: Tuple[int, int]) -> List[Tuple[str, np.ndarray]]:
    """Deterministic named homographies: rotations, scales, a tilt."""
    h_img, w_img = shape
    c = (h_img / 2.0, w_img / 2.0)
    warps = [
        ("rot15", similarity_homography(np.deg2rad(15.0), 1.0, center=c)),
        ("rot30", similarity_homography(np.deg2rad(30.0), 1.0, center=c)),
        ("scale0.8", similarity_homography(0.0, 0.8, center=c)),
        ("scale1.25", similarity_homography(0.0, 1.25, center=c)),
    ]
    # Mild perspective tilt around the center.
    tilt = np.eye(3, dtype=np.float64)
    tilt[2, 0] = 2e-4
    shift = np.eye(3)
    shift[0, 2], shift[1, 2] = -c[0], -c[1]
    unshift = np.eye(3)
    unshift[0, 2], unshift[1, 2] = c[0], c[1]
    warps.append(("tilt", (unshift @ tilt @ shift).astype(np.float32)))
    return warps


def run_battery(
    sift,
    gray: np.ndarray,
    warps: Optional[Sequence[Tuple[str, np.ndarray]]] = None,
) -> Dict[str, float]:
    """Repeatability of ``sift`` (a ``SIFT`` object) on one [H, W] image
    under each warp; the warps are made on ``sift``'s device. Returns
    {warp_name: repeatability}."""
    shape = gray.shape
    if warps is None:
        warps = standard_warp_battery(shape)
    image = torch.as_tensor(np.asarray(gray), dtype=torch.float32, device=sift.device)
    k0, _, _ = sift.extract(image)
    pts0, sig0 = keypoint_array(k0)
    out: Dict[str, float] = {}
    for name, hmat in warps:
        k1, _, _ = sift.extract(warp_perspective(image, hmat, shape))
        pts1, _ = keypoint_array(k1)
        out[name] = repeatability(pts0, sig0, pts1, hmat, shape)
    return out
