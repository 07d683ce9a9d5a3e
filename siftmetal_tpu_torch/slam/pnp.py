"""Perspective-n-Point: camera pose from 2D-3D correspondences.

Port of ``siftmetal_tpu/slam/pnp.py``. Solver: DLT estimation of the
[3, 4] projection matrix from >= 6 points, decomposed against known
intrinsics with an orthonormal (SVD-polar) rotation projection, optionally
refined by a few damped Gauss-Newton steps on reprojection error; the
RANSAC wrapper draws its samples as ``geometry.ransac`` does and, like it,
reads no tensor's value on the host (the SVDs' own convergence checks
aside).
"""

from __future__ import annotations

import torch

from ..geometry.ransac import RansacResult, _sample_indices
from ..geometry.twoview import take_row
from .camera import project, so3_log


def pnp_dlt(points3d: torch.Tensor, uv: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[..., S, 3] world points + [..., S, 2] pixels + intrinsics ->
    camera params [..., 6].

    DLT on normalized rays, then polar projection of the leading 3x3 onto
    SO(3). Needs S >= 6; degenerate samples produce garbage poses that
    RANSAC scoring discards."""
    kinv = torch.linalg.inv_ex(k).inverse
    rays = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1) @ kinv.mT
    x, y = rays[..., 0:1], rays[..., 1:2]
    xw = points3d
    z = torch.zeros_like(xw)
    o = torch.ones_like(x)
    zo = torch.zeros_like(o)
    r1 = torch.cat([xw, o, z, zo, -x * xw, -x], dim=-1)
    r2 = torch.cat([z, zo, xw, o, -y * xw, -y], dim=-1)
    a = torch.cat([r1, r2], dim=-2)                       # [..., 2S, 12]
    p = torch.linalg.svd(a, full_matrices=True).Vh[..., -1, :]
    p = p.reshape(p.shape[:-1] + (3, 4))

    m = p[..., :3]
    # Scale and sign: det(R) > 0 and points in front.
    sign = torch.sign(torch.linalg.det(m))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)[..., None]
    u, s, vh = torch.linalg.svd(m * sign[..., None])
    r = u @ vh
    scale = s.mean(-1, keepdim=True)
    t = sign * p[..., 3] / scale.clamp(min=1e-12)
    w = so3_log(r)

    # Cheirality: most sample points should have positive depth; flip the
    # translation if not (a heuristic fallback).
    depth = (points3d @ r.mT + t[..., None, :])[..., 2]
    front = depth.mean(-1, keepdim=True) > 0
    return torch.cat([w, torch.where(front, t, -t)], dim=-1)


def pnp_refine(
    cam: torch.Tensor,
    points3d: torch.Tensor,
    uv: torch.Tensor,
    k: torch.Tensor,
    weights: torch.Tensor,
    n_iterations: int = 5,
    damping: float = 1e-3,
) -> torch.Tensor:
    """Damped GN refinement of one camera pose [6] on weighted
    reprojection of [S, 3] points; a step is kept only if it lowers the
    cost."""

    def res(c):
        return ((project(c, k, points3d) - uv) * weights[:, None]).reshape(-1)

    eye = torch.eye(6, dtype=cam.dtype, device=cam.device)
    for _ in range(n_iterations):
        r = res(cam)
        j = torch.func.jacfwd(res)(cam)                   # [2S, 6]
        h = j.mT @ j + damping * eye
        d = torch.linalg.solve_ex(h, -(j.mT @ r)).result
        cam_new = cam + d
        better = (res(cam_new) ** 2).sum() < (r ** 2).sum()
        cam = torch.where(better, cam_new, cam)
    return cam


def _count_inliers(cams, points3d, uv, valid, k, threshold):
    """(inlier masks [..., N], counts [...]) of [..., 6] cameras."""
    err = torch.linalg.vector_norm(project(cams[..., None, :], k, points3d) - uv, dim=-1)
    inl = (err < threshold) & valid
    return inl, inl.sum(-1, dtype=torch.int32)


def pnp_ransac_from_indices(
    idx: torch.Tensor,
    points3d: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    k: torch.Tensor,
    sample_size: int = 6,
    inlier_threshold: float = 3.0,
    refine: bool = True,
) -> RansacResult:
    """PnP RANSAC over the given [H, S] minimal samples."""
    points3d = torch.where(valid[:, None], points3d, torch.zeros_like(points3d))
    uv = torch.where(valid[:, None], uv, torch.zeros_like(uv))
    models = pnp_dlt(points3d[idx], uv[idx], k)
    inls, counts = _count_inliers(models, points3d, uv, valid, k, inlier_threshold)
    best = torch.argmax(counts)
    cam, inliers, n_in = (take_row(t, best) for t in (models, inls, counts))

    if refine:
        cam_r = pnp_refine(cam, points3d, uv, k, inliers.to(cam.dtype))
        inl_r, n_r = _count_inliers(cam_r, points3d, uv, valid, k, inlier_threshold)
        better = n_r >= n_in
        cam = torch.where(better, cam_r, cam)
        inliers = torch.where(better, inl_r, inliers)
        n_in = torch.where(better, n_r, n_in)

    ok = valid.sum(dtype=torch.int32) >= sample_size
    return RansacResult(model=cam, inliers=inliers & ok, n_inliers=n_in * ok, ok=ok)


def pnp_ransac(
    generator: torch.Generator,
    points3d: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    k: torch.Tensor,
    n_hypotheses: int = 256,
    sample_size: int = 6,
    inlier_threshold: float = 3.0,
    refine: bool = True,
) -> RansacResult:
    """Parallel-hypothesis PnP RANSAC over padded [N, 3] / [N, 2]
    correspondences; ``generator`` lives on their device."""
    idx = _sample_indices(generator, n_hypotheses, sample_size, valid)
    return pnp_ransac_from_indices(
        idx, points3d, uv, valid, k, sample_size, inlier_threshold, refine
    )
