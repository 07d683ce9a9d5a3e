"""Two-view geometry: homography / fundamental / essential estimation,
triangulation, pose recovery.

Port of ``siftmetal_tpu/geometry/twoview.py``. Every solver takes leading
hypothesis dimensions ([..., K, 2] samples -> [..., 3, 3] models), so
RANSAC solves all its minimal samples with one batched call and scores
them with one [H, N] error matrix. The small factorisations are
``torch.linalg`` calls in fp32 (TF32 is off on the card, device.py).

Conventions: points are [N, 2] (row, col) = (y_img, x_img) in pixels,
matching the detector's output; where a camera matrix is involved the
points are (u, v) = (col, row).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..utils.profiling import span


def take_row(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``t[i]`` for a 0-dim index tensor, gathered on the device (plain
    indexing would read ``i`` on the host)."""
    return t.index_select(0, i.reshape(1))[0]


def _normalize_points(pts: torch.Tensor, w: torch.Tensor):
    """Hartley normalization of [..., K, 2] points with validity weights
    w [..., K]; returns (normalized points, T [..., 3, 3])."""
    cnt = w.sum(-1).clamp(min=1.0)
    mean = (pts * w[..., None]).sum(-2) / cnt[..., None]
    centred = pts - mean[..., None, :]
    d = torch.sqrt((centred ** 2).sum(-1))
    scale = math.sqrt(2.0) / ((d * w).sum(-1) / cnt).clamp(min=1e-12)
    z, o = torch.zeros_like(scale), torch.ones_like(scale)
    t = torch.stack(
        [
            torch.stack([scale, z, -scale * mean[..., 0]], -1),
            torch.stack([z, scale, -scale * mean[..., 1]], -1),
            torch.stack([z, z, o], -1),
        ],
        -2,
    )
    return centred * scale[..., None, None], t


def _homog(pts: torch.Tensor) -> torch.Tensor:
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def _null_vector(a: torch.Tensor) -> torch.Tensor:
    """Right singular vector of the smallest singular value of [..., M, N]
    design matrices; its sign is arbitrary. Vh is complete without the
    full U once M >= N (the refit's 2K x 9 system would otherwise carry a
    2K x 2K factor). The library checks its convergence flag on the host,
    so the call waits for the device: the tracer's host span
    ``twoview.svd``."""
    full = a.shape[-2] < a.shape[-1]
    with span("twoview.svd"):
        return torch.linalg.svd(a, full_matrices=full).Vh[..., -1, :]


def homography_from_points(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """DLT homography from >= 4 correspondences ([..., K, 2] each):
    dst ~ H src. SVD of the Hartley-normalized 2K x 9 design matrix (raw
    pixel coordinates in fp32 cost ~0.1 px); H[2, 2] = 1 when possible."""
    w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    s_n, ts = _normalize_points(src, w)
    d_n, td = _normalize_points(dst, w)
    x, y = s_n[..., 0], s_n[..., 1]
    u, v = d_n[..., 0], d_n[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], dim=-1)
    r2 = torch.stack([z, z, z, x, y, o, -v * x, -v * y, -v], dim=-1)
    a = torch.cat([r1, r2], dim=-2)
    h = _null_vector(a).reshape(a.shape[:-2] + (3, 3))
    h = torch.linalg.inv_ex(td).inverse @ h @ ts
    h22 = h[..., 2:, 2:]
    return h / torch.where(h22.abs() > 1e-12, h22, torch.ones_like(h22))


def homography_transfer_error(
    h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor
) -> torch.Tensor:
    """Forward transfer error |dst - H src| of [N, 2] correspondences
    under [..., 3, 3] models: [..., N]."""
    p = _homog(src) @ h.mT
    w = p[..., 2:]
    proj = p[..., :2] / torch.where(w.abs() > 1e-12, w, torch.full_like(w, 1e-12))
    return torch.sqrt(((proj - dst) ** 2).sum(-1))


def fundamental_from_points(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Normalized 8-point fundamental matrix from >= 8 correspondences
    ([..., K, 2] each): dst^T F src = 0, with the rank-2 projection;
    unit Frobenius norm (its sign is arbitrary)."""
    w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    s_n, ts = _normalize_points(src, w)
    d_n, td = _normalize_points(dst, w)
    x1, y1 = s_n[..., 0], s_n[..., 1]
    x2, y2 = d_n[..., 0], d_n[..., 1]
    a = torch.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, torch.ones_like(x1)],
        dim=-1,
    )
    f = _null_vector(a).reshape(a.shape[:-2] + (3, 3))
    u, s, vh = torch.linalg.svd(f)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., :1])], dim=-1)
    f = (u * s[..., None, :]) @ vh
    f = td.mT @ f @ ts
    norm = torch.linalg.matrix_norm(f).clamp(min=1e-12)
    return f / norm[..., None, None]


def sampson_error(
    f: torch.Tensor, src: torch.Tensor, dst: torch.Tensor
) -> torch.Tensor:
    """First-order geometric (Sampson) error of dst^T F src = 0 for [N, 2]
    correspondences under [..., 3, 3] models: [..., N]."""
    p1 = _homog(src)
    p2 = _homog(dst)
    fp1 = p1 @ f.mT
    ftp2 = p2 @ f
    num = (p2 * fp1).sum(-1) ** 2
    den = fp1[..., 0] ** 2 + fp1[..., 1] ** 2 + ftp2[..., 0] ** 2 + ftp2[..., 1] ** 2
    return num / den.clamp(min=1e-12)


def essential_from_fundamental(
    f: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor
) -> torch.Tensor:
    """E = K2^T F K1, projected onto the essential manifold (equal
    singular values)."""
    e = k2.mT @ f @ k1
    u, s, vh = torch.linalg.svd(e)
    sm = (s[..., 0] + s[..., 1]) / 2.0
    s = torch.stack([sm, sm, torch.zeros_like(sm)], dim=-1)
    return (u * s[..., None, :]) @ vh


def triangulate(
    p1: torch.Tensor, p2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
) -> torch.Tensor:
    """Linear (DLT) two-view triangulation.

    p1/p2: [..., 3, 4] projection matrices; x1/x2: [N, 2] pixel points
    (u, v). Returns [..., N, 3] world points (one 4x4 SVD per point)."""
    p1, p2 = p1[..., None, :, :], p2[..., None, :, :]
    rows = [
        x1[:, 0:1] * p1[..., 2, :] - p1[..., 0, :],
        x1[:, 1:2] * p1[..., 2, :] - p1[..., 1, :],
        x2[:, 0:1] * p2[..., 2, :] - p2[..., 0, :],
        x2[:, 1:2] * p2[..., 2, :] - p2[..., 1, :],
    ]
    x = _null_vector(torch.stack(torch.broadcast_tensors(*rows), dim=-2))
    w = x[..., 3:]
    return x[..., :3] / torch.where(w.abs() > 1e-12, w, torch.full_like(w, 1e-12))


def decompose_essential(e: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The four (R, t) candidates of an essential matrix:
    returns (rs [4, 3, 3], ts [4, 3])."""
    u, _, vh = torch.linalg.svd(e)
    # Enforce proper rotations.
    u = u * torch.sign(torch.linalg.det(u))
    vh = vh * torch.sign(torch.linalg.det(vh))
    w = torch.tensor(
        [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
        dtype=e.dtype, device=e.device,
    )
    r1 = u @ w @ vh
    r2 = u @ w.mT @ vh
    t = u[:, 2]
    return torch.stack([r1, r1, r2, r2]), torch.stack([t, -t, t, -t])


def recover_pose(
    e: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor, weights: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cheirality-tested pose from an essential matrix.

    x1/x2 are [N, 2] points in NORMALIZED camera coordinates (K^-1
    applied), ``weights`` masks valid correspondences. Returns
    (R, t, n_in_front): the candidate with most triangulated points in
    front of both cameras."""
    rs, ts = decompose_essential(e)
    p1 = torch.cat(
        [torch.eye(3, dtype=e.dtype, device=e.device),
         torch.zeros((3, 1), dtype=e.dtype, device=e.device)], dim=1
    )
    p2 = torch.cat([rs, ts[:, :, None]], dim=2)           # [4, 3, 4]
    pts = triangulate(p1, p2, x1, x2)                     # [4, N, 3]
    z1 = pts[..., 2]
    z2 = (pts @ rs.mT + ts[:, None, :])[..., 2]
    scores = (((z1 > 0) & (z2 > 0)) * weights).sum(-1)
    best = torch.argmax(scores)
    return take_row(rs, best), take_row(ts, best), take_row(scores, best)
