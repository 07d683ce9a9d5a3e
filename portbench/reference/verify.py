"""Plain reference of pair verification: exact 2-NN matching with the
ratio test, then RANSAC on a homography with the caller's generator.

Matching: squared distances of uint8 descriptors exact in float64 (every
partial sum is an integer below 2^53), the nearest and second nearest
target with ties to the lowest index, then the thresholds in float32 on
the features/255 scale. RANSAC: ``n_hypotheses`` minimal samples of 4
drawn as uniform positions among the valid correspondences, each solved
by the normalized DLT (SVD of the 2K x 9 design matrix), scored by the
forward transfer error, the best refit on its inliers (spare slots repeat
the first inlier) and kept when the refit has at least as many inliers.
Plain torch; imports nothing of the measured program.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Verdict(NamedTuple):
    target_idx: torch.Tensor   # [Q] int64, -1 where rejected
    model: torch.Tensor        # [3, 3]
    n_inliers: torch.Tensor    # scalar int


def match(qf, tf, qv, tv, absolute_threshold: float, ratio_threshold: float) -> torch.Tensor:
    """Accepted target of each query row, -1 where none."""
    a, b = qf.to(torch.float64), tf.to(torch.float64)
    d2 = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * (a @ b.T)
    d2 = torch.where(tv[None, :], d2, torch.full_like(d2, math.inf))
    cols = torch.arange(d2.shape[1], device=d2.device)
    best = d2.amin(1)
    i1 = torch.where(d2 == best[:, None], cols, d2.shape[1]).amin(1)
    masked = torch.where(cols[None, :] == i1[:, None], math.inf, d2)
    second = masked.amin(1)
    scale = torch.tensor(1.0 / (255.0 * 255.0), dtype=torch.float32, device=d2.device)
    d1 = torch.sqrt(best.to(torch.float32) * scale)
    dd = torch.sqrt(second.to(torch.float32) * scale)
    ok = qv & (d1 < absolute_threshold)
    if ratio_threshold < 1.0:
        ok = ok & (d1 < ratio_threshold * dd) & torch.isfinite(dd)
    return torch.where(ok, i1, -1)


def _normalize(pts: torch.Tensor):
    mean = pts.mean(-2)
    centred = pts - mean[..., None, :]
    scale = math.sqrt(2.0) / torch.sqrt((centred ** 2).sum(-1)).mean(-1).clamp(min=1e-12)
    t = torch.zeros(pts.shape[:-2] + (3, 3), dtype=pts.dtype, device=pts.device)
    t[..., 0, 0] = scale
    t[..., 1, 1] = scale
    t[..., 0, 2] = -scale * mean[..., 0]
    t[..., 1, 2] = -scale * mean[..., 1]
    t[..., 2, 2] = 1.0
    return centred * scale[..., None, None], t


def dlt(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """[..., K, 2] -> [..., 3, 3] with dst ~ H src, H[2, 2] = 1 where it can."""
    s, ts = _normalize(src)
    d, td = _normalize(dst)
    x, y, u, v = s[..., 0], s[..., 1], d[..., 0], d[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    a = torch.cat([torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], -1),
                   torch.stack([z, z, z, x, y, o, -v * x, -v * y, -v], -1)], -2)
    vh = torch.linalg.svd(a, full_matrices=a.shape[-2] < a.shape[-1]).Vh
    h = vh[..., -1, :].reshape(a.shape[:-2] + (3, 3))
    h = torch.linalg.inv(td) @ h @ ts
    h22 = h[..., 2:, 2:]
    return h / torch.where(h22.abs() > 1e-12, h22, torch.ones_like(h22))


def transfer_error(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    p = torch.cat([src, torch.ones_like(src[:, :1])], -1) @ h.mT
    w = p[..., 2:]
    proj = p[..., :2] / torch.where(w.abs() > 1e-12, w, torch.full_like(w, 1e-12))
    return torch.sqrt(((proj - dst) ** 2).sum(-1))


def homography(gen: torch.Generator, src, dst, valid, n_hypotheses: int, threshold: float):
    """(model, inlier count) of RANSAC over padded [N, 2] correspondences."""
    live = torch.nonzero(valid).flatten()
    count = max(int(live.numel()), 1)
    u = torch.rand((n_hypotheses, 4), generator=gen, device=valid.device)
    pos = torch.minimum((u * count).long(), torch.tensor(count - 1, device=valid.device))
    if live.numel() == 0:
        live = torch.zeros(1, dtype=torch.long, device=valid.device)
    idx = live[pos]
    zero = torch.zeros_like(src)
    src = torch.where(valid[:, None], src, zero)
    dst = torch.where(valid[:, None], dst, zero)
    models = dlt(src[idx], dst[idx])
    inl = (transfer_error(models, src, dst) < threshold) & valid
    counts = inl.sum(-1)
    best = int(torch.argmax(counts))
    model, inliers, n_in = models[best], inl[best], int(counts[best])
    m = src.shape[0]
    order = torch.nonzero(inliers).flatten()
    first = order[0] if order.numel() else torch.zeros((), dtype=torch.long, device=src.device)
    order = torch.cat([order, first.expand(m - order.numel())])
    refit = dlt(src[order], dst[order])
    refit_n = int(((transfer_error(refit, src, dst) < threshold) & valid).sum())
    if refit_n >= n_in:
        model, n_in = refit, refit_n
    ok = int(valid.sum()) >= 4
    return model, (n_in if ok else 0)


def verify(qf, tf, qv, tv, qxy, txy, gen, thresholds, n_hypotheses: int, inlier_threshold: float):
    tgt = match(qf, tf, qv, tv, *thresholds)
    ok = tgt >= 0
    dst = txy[tgt.clamp(min=0)]
    model, n = homography(gen, qxy, dst, ok, n_hypotheses, inlier_threshold)
    return Verdict(tgt, model, n)


def corner_gap(h1: torch.Tensor, h2: torch.Tensor, height: int, width: int) -> float:
    """Largest distance (px) between the images of the frame's corners
    under two homographies, in float64."""
    c = torch.tensor([[0.0, 0.0, 1.0], [0.0, width - 1.0, 1.0], [height - 1.0, 0.0, 1.0],
                      [height - 1.0, width - 1.0, 1.0]], dtype=torch.float64)
    p1 = c @ h1.double().cpu().T
    p2 = c @ h2.double().cpu().T
    return float(((p1[:, :2] / p1[:, 2:]) - (p2[:, :2] / p2[:, 2:])).norm(dim=1).max())
