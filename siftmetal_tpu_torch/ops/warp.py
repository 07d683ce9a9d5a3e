"""Perspective warping and quad transforms.

Port of ``siftmetal_tpu/ops/warp.py``: a bilinear homography warp (the
workhorse of the repeatability battery: warp an image with a known H,
check that keypoints reproject) and the small homography helpers.

Convention: points are (row, col); a homography H maps source
(row, col, 1) homogeneous coordinates to destination. Results lie on the
device of the tensor inputs; homographies given as numpy arrays are moved
there.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of [..., 3, 3] matrices: exact fp32
    arithmetic, no LU and no reduced-precision product (an error of 1e-2
    relative on a homography shifts warp sampling by whole pixels)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h_, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    det = a * (e * i - f * h_) - b * (d * i - f * g) + c * (d * h_ - e * g)
    adj = torch.stack(
        [
            torch.stack([e * i - f * h_, c * h_ - b * i, b * f - c * e], -1),
            torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
            torch.stack([d * h_ - e * g, b * g - a * h_, a * e - b * d], -1),
        ],
        -2,
    )
    return adj / det[..., None, None]


def apply_homography(h: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """[..., N, 2] (row, col) -> transformed [..., N, 2]."""
    p = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    q = p @ h.mT
    w = q[..., 2:]
    return q[..., :2] / torch.where(w.abs() > 1e-12, w, torch.full_like(w, 1e-12))


def warp_perspective(
    image: torch.Tensor, h, out_shape: Tuple[int, int]
) -> torch.Tensor:
    """Inverse-warp ``image`` [..., H, W] by homography ``h`` (src->dst)
    with bilinear sampling; out-of-bounds samples are 0. Leading
    dimensions of ``image`` are warped by the same ``h``."""
    oh, ow = out_shape
    dev = image.device
    h = torch.as_tensor(h, dtype=torch.float32, device=dev)
    rr, cc = torch.meshgrid(
        torch.arange(oh, dtype=torch.float32, device=dev),
        torch.arange(ow, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    dst = torch.stack([rr.reshape(-1), cc.reshape(-1)], dim=-1)
    src = apply_homography(inv3x3(h), dst)
    r, c = src[:, 0], src[:, 1]

    hh, ww = image.shape[-2], image.shape[-1]
    r0f, c0f = torch.floor(r), torch.floor(c)
    fr, fc = r - r0f, c - c0f
    # Far outside the image every sample is masked; the clamp only keeps
    # the integer conversion defined.
    r0 = r0f.clamp(-2.0, hh + 1.0).long()
    c0 = c0f.clamp(-2.0, ww + 1.0).long()

    def sample(ri, ci):
        inside = (ri >= 0) & (ri < hh) & (ci >= 0) & (ci < ww)
        v = image[..., ri.clamp(0, hh - 1), ci.clamp(0, ww - 1)]
        return torch.where(inside, v, torch.zeros_like(v))

    v = (
        sample(r0, c0) * (1 - fr) * (1 - fc)
        + sample(r0, c0 + 1) * (1 - fr) * fc
        + sample(r0 + 1, c0) * fr * (1 - fc)
        + sample(r0 + 1, c0 + 1) * fr * fc
    )
    return v.reshape(image.shape[:-2] + (oh, ow))


def similarity_homography(
    angle: float, scale: float, center: Tuple[float, float],
    translation: Tuple[float, float] = (0.0, 0.0),
) -> np.ndarray:
    """Rotation(+scale) about ``center`` (row, col) as a 3x3 homography."""
    ca, sa = np.cos(angle) * scale, np.sin(angle) * scale
    cr, cc = center
    tr, tc = translation
    return np.array(
        [
            [ca, -sa, cr - ca * cr + sa * cc + tr],
            [sa, ca, cc - sa * cr - ca * cc + tc],
            [0.0, 0.0, 1.0],
        ],
        dtype=np.float32,
    )


def quad_corners(h: int, w: int) -> np.ndarray:
    """Image corner quad [(0,0), (0,w), (h,w), (h,0)] (rows, cols)."""
    return np.array([[0, 0], [0, w], [h, w], [h, 0]], dtype=np.float32)
