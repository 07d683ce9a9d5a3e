"""Camera parameterization and projection for the SfM/SLAM back-end.

Port of ``siftmetal_tpu/slam/camera.py``. Cameras are 6-vectors
[axis-angle rotation (3), translation (3)] mapping WORLD -> CAMERA:
x_cam = R(w) @ x_world + t. Pixels are (u, v) = (col, row). BAL's
cameras (:func:`project_bal`) append a focal length and two radial
terms to those six. Every function takes leading batch dimensions
([..., 6] cameras, [..., 3] points) that broadcast against each other.
"""

from __future__ import annotations

import torch


def _skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([z, -v[..., 2], v[..., 1]], -1),
            torch.stack([v[..., 2], z, -v[..., 0]], -1),
            torch.stack([-v[..., 1], v[..., 0], z], -1),
        ],
        -2,
    )


def rodrigues(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrix [..., 3, 3] (Taylor-safe
    near 0)."""
    # Kept [..., 1, 1]: a 0-dim intermediate under torch.func's forward
    # mode (pnp_refine's Jacobian) promotes its tangent to float64.
    theta2 = (w * w).sum(-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + 1e-24)
    kx = _skew(w / theta[..., 0])
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    r = eye + torch.sin(theta) * kx + (1.0 - torch.cos(theta)) * (kx @ kx)
    # Near-zero fallback: first-order I + [w]x.
    return torch.where(theta2 > 1e-12, r, eye + _skew(w))


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3], stable for all
    angles incl. pi: a branchless Shepperd quaternion extraction (the
    naive theta / (2 sin theta) formula blows up at theta = pi, which real
    pose graphs do hit)."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(x.clamp(min=1e-24))

    # Four Shepperd cases: trace-dominant or one of the diagonal elements.
    s0 = safe_sqrt(1.0 + tr) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], -1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], -1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], -1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], -1)

    c0 = (tr > 0.0)[..., None]
    c1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    c2 = (m11 >= m22)[..., None]
    q = torch.where(c0, q0, torch.where(c1, q1, torch.where(c2, q2, q3)))
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    q0s = q[..., :1]
    q = q * torch.sign(torch.where(q0s.abs() > 1e-12, q0s, torch.ones_like(q0s)))

    vn = torch.linalg.vector_norm(q[..., 1:], dim=-1, keepdim=True)
    theta = 2.0 * torch.atan2(vn, q[..., :1])
    axis = q[..., 1:] / vn.clamp(min=1e-24)
    return torch.where(vn > 1e-12, axis * theta, 2.0 * q[..., 1:])


def transform(cam: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """World points [..., 3] -> camera frame for camera params [..., 6]."""
    return (rodrigues(cam[..., :3]) @ x[..., None])[..., 0] + cam[..., 3:]


def project(cam: torch.Tensor, k: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """World points [..., 3] -> pixels (u, v) [..., 2] through intrinsics
    k [3, 3]."""
    p = transform(cam, x)
    z = p[..., 2:]
    z = torch.where(z.abs() > 1e-9, z, torch.full_like(z, 1e-9))
    return ((p / z) @ k.mT)[..., :2]


def project_bal(cam: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """World points [..., 3] -> pixels [..., 2] through BAL's camera
    [..., 9] (Agarwal et al., "Bundle Adjustment in the Large", ECCV
    2010): axis-angle rotation, translation, focal length f and radial
    terms k1, k2. P = R X + t, p = -P / P_z (the camera looks down -z),
    pixel = f (1 + k1 |p|^2 + k2 |p|^4) p, the origin at the image
    centre."""
    p = transform(cam[..., :6], x)
    z = p[..., 2:]
    z = torch.where(z.abs() > 1e-9, z, torch.full_like(z, 1e-9))
    p = -p[..., :2] / z
    r2 = (p * p).sum(-1, keepdim=True)
    f, k1, k2 = cam[..., 6:7], cam[..., 7:8], cam[..., 8:9]
    return f * (1.0 + r2 * (k1 + k2 * r2)) * p


def compose(cam_a: torch.Tensor, cam_b: torch.Tensor) -> torch.Tensor:
    """Pose composition (a then b as world->cam maps): c = b o a."""
    ra, rb = rodrigues(cam_a[..., :3]), rodrigues(cam_b[..., :3])
    t = (rb @ cam_a[..., 3:, None])[..., 0] + cam_b[..., 3:]
    return torch.cat([so3_log(rb @ ra), t], dim=-1)


def inverse(cam: torch.Tensor) -> torch.Tensor:
    rt = rodrigues(cam[..., :3]).mT
    return torch.cat([so3_log(rt), -(rt @ cam[..., 3:, None])[..., 0]], dim=-1)


def relative(cam_i: torch.Tensor, cam_j: torch.Tensor) -> torch.Tensor:
    """T_ij such that x_j = T_ij(x_i): T_j o T_i^-1."""
    return compose(inverse(cam_i), cam_j)
