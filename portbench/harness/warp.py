"""The pair traffic's views: named homographies and a plain bilinear warp.

The five views of the port's ``standard_warp_battery`` (rotations about
the centre, scalings, a mild perspective tilt), built from the traffic
file's parameters, and an inverse-mapped bilinear warp with zeros outside
the source. Points are (row, col), as the extractor's ``x``, ``y``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch


def view_homography(view: Dict, shape: Tuple[int, int]) -> np.ndarray:
    """[3, 3] float64 map from source (row, col) to view (row, col), about
    the frame's centre: ``rotate_deg`` and ``scale``, or a ``tilt`` (the
    bottom row's first entry)."""
    h, w = shape
    cy, cx = h / 2.0, w / 2.0
    shift = np.array([[1.0, 0, -cy], [0, 1.0, -cx], [0, 0, 1.0]])
    unshift = np.array([[1.0, 0, cy], [0, 1.0, cx], [0, 0, 1.0]])
    if "tilt" in view:
        core = np.eye(3)
        core[2, 0] = float(view["tilt"])
    else:
        a, s = math.radians(float(view.get("rotate_deg", 0.0))), float(view.get("scale", 1.0))
        core = np.array([[s * math.cos(a), -s * math.sin(a), 0.0],
                         [s * math.sin(a), s * math.cos(a), 0.0], [0, 0, 1.0]])
    return unshift @ core @ shift


def views(params: List[Dict], shape) -> List[Tuple[str, np.ndarray]]:
    return [(v["name"], view_homography(v, shape)) for v in params]


def warp(frames: torch.Tensor, hom: np.ndarray) -> torch.Tensor:
    """[B, H, W] frames seen through ``hom``: output pixel p samples the
    source at hom^-1 p, bilinearly, zero outside."""
    b, h, w = frames.shape
    dev = frames.device
    inv = torch.tensor(np.linalg.inv(hom), dtype=torch.float64, device=dev)
    rr, cc = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float64),
                            torch.arange(w, device=dev, dtype=torch.float64), indexing="ij")
    pts = torch.stack([rr, cc, torch.ones_like(rr)], -1) @ inv.T
    sr, sc = pts[..., 0] / pts[..., 2], pts[..., 1] / pts[..., 2]
    r0, c0 = torch.floor(sr), torch.floor(sc)
    fr, fc = (sr - r0).float(), (sc - c0).float()
    out = torch.zeros_like(frames)
    for dr, dc, wgt in ((0, 0, (1 - fr) * (1 - fc)), (0, 1, (1 - fr) * fc),
                        (1, 0, fr * (1 - fc)), (1, 1, fr * fc)):
        r, c = (r0 + dr).long(), (c0 + dc).long()
        inside = (r >= 0) & (r < h) & (c >= 0) & (c < w)
        val = frames[:, r.clamp(0, h - 1), c.clamp(0, w - 1)]
        out += torch.where(inside, wgt, torch.zeros_like(wgt)) * val
    return out
