"""Batched RANSAC: every hypothesis evaluated in parallel, no early exit.

Port of ``siftmetal_tpu/geometry/ransac.py``. A FIXED number of minimal
samples is drawn up front, all models are solved with one batched solver
call, scored against all correspondences with one [H, N] error matrix, and
the best is picked by (masked) inlier count. A least-squares refit on the
winner's inliers replaces the usual local optimization step.

Nothing here reads a tensor's value on the host (no ``.item()``, no
``if tensor``): every choice is a ``torch.where`` or an index gather, so a
batch of pairs can be queued on the card one after the other. The one
exception is inside the solvers: ``torch.linalg.svd`` checks its
convergence flag on the host, one synchronisation per call (PyTorch has
no unchecked form of it).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..sift.detect import compact_indices
from .twoview import take_row


class RansacResult(NamedTuple):
    model: torch.Tensor        # best (refit) model parameters
    inliers: torch.Tensor      # [N] bool
    n_inliers: torch.Tensor    # scalar int32
    ok: torch.Tensor           # bool: enough valid points to attempt


def _sample_indices(
    generator: torch.Generator, n_hypotheses: int, sample_size: int,
    valid: torch.Tensor,
) -> torch.Tensor:
    """[H, S] indices drawn from the valid entries of a padded point set.

    Draws positions uniformly in [0, count) and maps them through the
    compacted valid-index list; duplicate indices within a sample yield a
    degenerate model, which scores ~0 inliers and never wins.
    ``generator`` must live on ``valid``'s device."""
    n = valid.shape[0]
    order, count, _ = compact_indices(valid, n)
    count = count.clamp(min=1)
    u = torch.rand((n_hypotheses, sample_size), generator=generator, device=valid.device)
    pos = torch.minimum((u * count).long(), count.long() - 1)
    return order[pos]


def _count_inliers(models, points_a, points_b, valid, error_fn, threshold):
    """(inlier masks [..., N], counts [...]) of [..., ...] models."""
    inl = (error_fn(models, points_a, points_b) < threshold) & valid
    return inl, inl.sum(-1, dtype=torch.int32)


def ransac_from_indices(
    idx: torch.Tensor,
    points_a: torch.Tensor,
    points_b: torch.Tensor,
    valid: torch.Tensor,
    solver: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    error_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    sample_size: int,
    inlier_threshold: float = 3.0,
    refit: bool = True,
) -> RansacResult:
    """RANSAC over the given [H, S] minimal samples (what :func:`ransac`
    does after drawing them).

    ``solver([..., K, 2], [..., K, 2]) -> [..., model]`` with leading
    hypothesis dimensions; ``error_fn(models, [N, 2], [N, 2]) -> [..., N]``
    residuals compared against ``inlier_threshold``. A degenerate sample's
    NaN residuals compare false and count no inlier."""
    # Padded slots may hold anything; they never count, and zeros keep the
    # factorisations finite when a sample or the refit gathers one.
    zero = torch.zeros_like(points_a)
    points_a = torch.where(valid[:, None], points_a, zero)
    points_b = torch.where(valid[:, None], points_b, zero)
    models = solver(points_a[idx], points_b[idx])
    inls, counts = _count_inliers(
        models, points_a, points_b, valid, error_fn, inlier_threshold
    )
    best = torch.argmax(counts)
    model, inliers, n_in = (take_row(t, best) for t in (models, inls, counts))

    if refit:
        # Least-squares refit on the winning inlier set: the solver on the
        # gathered inliers, the remaining slots padded by REPEATING THE
        # FIRST INLIER (the compaction's fill index 0 is an arbitrary point
        # that may be a gross outlier). Repeating a genuine inlier only
        # reweights it; every refit equation stays an inlier constraint.
        m = points_a.shape[0]
        order, _, _ = compact_indices(inliers, m)
        order = torch.where(torch.arange(m, device=order.device) < n_in, order, order[0])
        refit_model = solver(points_a[order], points_b[order])
        refit_inl, refit_n = _count_inliers(
            refit_model, points_a, points_b, valid, error_fn, inlier_threshold
        )
        better = refit_n >= n_in
        model = torch.where(better, refit_model, model)
        inliers = torch.where(better, refit_inl, inliers)
        n_in = torch.where(better, refit_n, n_in)

    ok = valid.sum(dtype=torch.int32) >= sample_size
    return RansacResult(model=model, inliers=inliers & ok, n_inliers=n_in * ok, ok=ok)


def ransac(
    generator: torch.Generator,
    points_a: torch.Tensor,
    points_b: torch.Tensor,
    valid: torch.Tensor,
    solver: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    error_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    sample_size: int,
    n_hypotheses: int = 512,
    inlier_threshold: float = 3.0,
    refit: bool = True,
) -> RansacResult:
    """Generic parallel RANSAC over padded [N, 2] correspondences with a
    ``valid`` [N] mask; ``generator`` (on the points' device) draws the
    minimal samples."""
    idx = _sample_indices(generator, n_hypotheses, sample_size, valid)
    return ransac_from_indices(
        idx, points_a, points_b, valid, solver, error_fn, sample_size,
        inlier_threshold, refit,
    )


def find_homography(
    generator, src, dst, valid, n_hypotheses=512, inlier_threshold=3.0
) -> RansacResult:
    from .twoview import homography_from_points, homography_transfer_error

    return ransac(
        generator, src, dst, valid,
        solver=homography_from_points,
        error_fn=homography_transfer_error,
        sample_size=4,
        n_hypotheses=n_hypotheses,
        inlier_threshold=inlier_threshold,
    )


def find_fundamental(
    generator, src, dst, valid, n_hypotheses=512, inlier_threshold=2.0
) -> RansacResult:
    from .twoview import fundamental_from_points, sampson_error

    return ransac(
        generator, src, dst, valid,
        solver=fundamental_from_points,
        error_fn=sampson_error,
        sample_size=8,
        n_hypotheses=n_hypotheses,
        # Sampson error is squared-distance-like; threshold in px^2.
        inlier_threshold=inlier_threshold,
    )
