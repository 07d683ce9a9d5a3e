"""Plain reference of bundle adjustment on BAL's camera model, in float64
(or in the observations' dtype).

A BAL problem (Agarwal, Snavely, Seitz, Szeliski, "Bundle Adjustment in
the Large", ECCV 2010): cameras of 9 numbers [Rodrigues rotation (3),
translation (3), f, k1, k2], points [L, 3], observations (camera, point,
pixel) with the origin at the image centre. Projection: P = R X + t,
p = -P / P_z, pixel = f (1 + k1 |p|^2 + k2 |p|^4) p.

The solve is Levenberg-Marquardt on the Schur complement, plain: every
residual, Jacobian, sum and solve in one dtype (``torch.func`` over one
observation, vmapped); the point blocks Hll, the couplings W and the camera blocks
summed by ``index_add_`` over the observations; the cross term
sum_l W_l Hll_l^-1 W_l^T by ``index_add_`` over every ordered pair of one
point's observations; the reduced camera system dense over the free
cameras and solved by ``torch.linalg.solve``; the points
back-substituted. Call it with TF32 off.

Where it departs from BAL's own solvers (Ceres' Levenberg-Marquardt with
the Schur complement), it follows the port's rule:

* a fixed number of iterations and no convergence test;
* the damping lam I is added to the Hessian's diagonal blocks (not
  Marquardt's scaling by diag(J^T J)); lam starts at ``damping``, is
  halved after an accepted step and multiplied by 10 after a rejected
  one, clamped to [1e-8, 1e6]; a step is accepted when it lowers the cost
  (no gain ratio, no trust radius);
* the first ``fixed_cameras`` cameras are held fixed (a gauge; BAL fixes
  none);
* plain least squares, no robust loss.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

F64 = torch.float64


def _skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def rotation(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle [..., 3] -> rotation matrix [..., 3, 3]."""
    theta = torch.linalg.vector_norm(w, dim=-1)[..., None, None]
    k = _skew(w / theta[..., 0].clamp(min=1e-12))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    r = eye + torch.sin(theta) * k + (1.0 - torch.cos(theta)) * (k @ k)
    return torch.where(theta > 1e-12, r, eye + _skew(w))


def project(cam: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Pixels [..., 2] of points [..., 3] through cameras [..., 9]."""
    p = (rotation(cam[..., :3]) @ x[..., None])[..., 0] + cam[..., 3:6]
    p = -p[..., :2] / p[..., 2:]
    r2 = (p * p).sum(-1, keepdim=True)
    return cam[..., 6:7] * (1.0 + cam[..., 7:8] * r2 + cam[..., 8:9] * r2 * r2) * p


class Observations(NamedTuple):
    cam: torch.Tensor  # [O] int64
    pt: torch.Tensor   # [O] int64
    uv: torch.Tensor   # [O, 2], in the dtype everything is computed in


def observations(cam_idx, pt_idx, uv, dtype=F64) -> Observations:
    return Observations(cam_idx.long(), pt_idx.long(), uv.to(dtype))


def predicted(cameras, points, obs: Observations) -> torch.Tensor:
    """Each observation's predicted pixel [O, 2]."""
    dt = obs.uv.dtype
    return project(cameras.to(dt)[obs.cam], points.to(dt)[obs.pt])


def cost(cameras, points, obs: Observations) -> torch.Tensor:
    """0.5 * the sum of squared reprojection errors."""
    r = predicted(cameras, points, obs) - obs.uv
    return 0.5 * (r * r).sum()


def point_pairs(obs: Observations, n_points: int):
    """(a, b): every ordered pair of observations of one point, itself
    included, as indices into the observations."""
    order = torch.argsort(obs.pt, stable=True)                   # the observations by point
    degree = torch.bincount(obs.pt, minlength=n_points)
    first = torch.cumsum(degree, 0) - degree                     # each point's first in ``order``
    d = degree[obs.pt[order]]
    a = torch.repeat_interleave(order, d)                        # each observation d times
    k = torch.arange(a.shape[0], device=a.device) - torch.repeat_interleave(torch.cumsum(d, 0) - d, d)
    b = order[first[obs.pt[a]] + k]                              # the k-th observation of its point
    return a, b


def _jacobians(cameras, points, obs: Observations):
    def residual(c, x, u):
        r = project(c, x) - u
        return r, r

    def one(c, x, u):
        (jc, jp), r = torch.func.jacfwd(residual, argnums=(0, 1), has_aux=True)(c, x, u)
        return r, jc, jp

    return torch.func.vmap(one)(cameras[obs.cam], points[obs.pt], obs.uv)


def _step(cameras, points, obs: Observations, pairs, lam, fixed_cameras):
    """One Gauss-Newton step of the damped system: (d cameras, d points)."""
    c_n, l_n = cameras.shape[0], points.shape[0]
    dev, dt = cameras.device, cameras.dtype
    r, jc, jp = _jacobians(cameras, points, obs)               # [O,2], [O,2,9], [O,2,3]
    jc = jc * (obs.cam >= fixed_cameras)[:, None, None]
    hcc = torch.zeros(c_n, 9, 9, dtype=dt, device=dev).index_add_(0, obs.cam, jc.mT @ jc)
    bc = -torch.zeros(c_n, 9, dtype=dt, device=dev).index_add_(0, obs.cam, (jc.mT @ r[..., None])[..., 0])
    hll = torch.zeros(l_n, 3, 3, dtype=dt, device=dev).index_add_(0, obs.pt, jp.mT @ jp)
    hll = hll + lam * torch.eye(3, dtype=dt, device=dev)
    bl = -torch.zeros(l_n, 3, dtype=dt, device=dev).index_add_(0, obs.pt, (jp.mT @ r[..., None])[..., 0])
    w = jc.mT @ jp                                             # [O, 9, 3]
    hll_inv = torch.linalg.inv(hll)
    wh = w @ hll_inv[obs.pt]                                   # W Hll^-1, by observation
    a, b = pairs
    cross = torch.zeros(c_n * c_n, 9, 9, dtype=dt, device=dev)
    cross.index_add_(0, obs.cam[a] * c_n + obs.cam[b], wh[a] @ w[b].mT)
    s = -cross.reshape(c_n, c_n, 9, 9).permute(0, 2, 1, 3).reshape(9 * c_n, 9 * c_n)
    s = s + torch.block_diag(*(hcc + lam * torch.eye(9, dtype=dt, device=dev)))
    rhs = bc - torch.zeros(c_n, 9, dtype=dt, device=dev).index_add_(
        0, obs.cam, (wh @ bl[obs.pt][..., None])[..., 0])
    free = torch.arange(9 * c_n, device=dev) >= 9 * fixed_cameras
    d_cam = torch.zeros(9 * c_n, dtype=dt, device=dev)
    d_cam[free] = torch.linalg.solve(s[free][:, free], rhs.reshape(-1)[free])
    d_cam = d_cam.reshape(c_n, 9)
    wt_dc = torch.zeros(l_n, 3, dtype=dt, device=dev).index_add_(
        0, obs.pt, (w.mT @ d_cam[obs.cam][..., None])[..., 0])
    d_pt = (hll_inv @ (bl - wt_dc)[..., None])[..., 0]
    return d_cam, d_pt


class Solution(NamedTuple):
    cameras: torch.Tensor  # [C, 9]
    points: torch.Tensor   # [L, 3]
    initial_cost: float
    final_cost: float
    first_step_cost: float  # the cost the first step reached, accepted or not


def solve(cameras, points, obs: Observations, n_iterations: int, damping: float,
          fixed_cameras: int = 1) -> Solution:
    """``n_iterations`` damped Gauss-Newton steps by the port's rule, in
    the observations' dtype."""
    dt = obs.uv.dtype
    cams, pts = cameras.to(dt), points.to(dt)
    pairs = point_pairs(obs, pts.shape[0])
    lam = damping
    c0 = float(cost(cams, pts, obs))
    c_init, c_first = c0, float("nan")
    for i in range(n_iterations):
        d_cam, d_pt = _step(cams, pts, obs, pairs, lam, fixed_cameras)
        new_cams, new_pts = cams + d_cam, pts + d_pt
        c1 = float(cost(new_cams, new_pts, obs))
        c_first = c1 if i == 0 else c_first
        if c1 < c0:
            cams, pts, c0, lam = new_cams, new_pts, c1, lam * 0.5
        else:
            lam = lam * 10.0
        lam = min(max(lam, 1e-8), 1e6)
    return Solution(cams, pts, c_init, c0, c_first)
