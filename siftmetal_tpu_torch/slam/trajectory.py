"""Trajectory evaluation: Umeyama similarity alignment and ATE.

The port's own copy of ``siftmetal_tpu/slam/trajectory.py`` (the
trajectory-accuracy metric on TUM-style trajectories). Pure numpy:
evaluation runs on the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def camera_centers(cameras: np.ndarray) -> np.ndarray:
    """[N, 6] world->cam params -> [N, 3] camera centers -R^T t."""
    import torch

    from .camera import rodrigues

    cams = np.asarray(cameras)
    r = rodrigues(torch.from_numpy(cams[:, :3].astype(np.float32))).numpy()
    return -np.einsum("nji,nj->ni", r, cams[:, 3:])


def umeyama(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = True
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Least-squares similarity (s, R, t) with dst ~ s R src + t."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    u, d, vt = np.linalg.svd(cov)
    s_mat = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_mat[2, 2] = -1
    r = u @ s_mat @ vt
    var_s = (xs ** 2).sum() / len(src)
    scale = float(np.trace(np.diag(d) @ s_mat) / var_s) if with_scale else 1.0
    t = mu_d - scale * r @ mu_s
    return scale, r, t


def ate_rmse(
    estimated: np.ndarray, ground_truth: np.ndarray, align_scale: bool = True
) -> float:
    """Absolute trajectory error (RMSE) after similarity alignment, the
    standard TUM-RGBD evaluation protocol."""
    s, r, t = umeyama(estimated, ground_truth, align_scale)
    aligned = (s * (r @ estimated.T)).T + t
    return float(np.sqrt(((aligned - ground_truth) ** 2).sum(-1).mean()))


def load_tum_trajectory(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """TUM format: 'timestamp tx ty tz qx qy qz qw' per line.
    Returns (timestamps [N], positions [N, 3])."""
    ts, pos = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            ts.append(float(p[0]))
            pos.append([float(p[1]), float(p[2]), float(p[3])])
    return np.asarray(ts), np.asarray(pos)


def associate(
    ts_a: np.ndarray, ts_b: np.ndarray, max_dt: float = 0.02
) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest-timestamp association between two trajectories."""
    j = np.searchsorted(ts_b, ts_a)
    j = np.clip(j, 1, len(ts_b) - 1)
    left = ts_b[j - 1]
    right = ts_b[j]
    pick = np.where(np.abs(ts_a - left) < np.abs(ts_a - right), j - 1, j)
    ok = np.abs(ts_b[pick] - ts_a) <= max_dt
    return np.nonzero(ok)[0], pick[ok]
