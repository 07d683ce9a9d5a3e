"""Pose-graph optimization over SE(3) keyframe poses.

Port of ``siftmetal_tpu/slam/pose_graph.py``: given relative-pose
constraints (odometry + loop closures), refine absolute keyframe poses by
damped Gauss-Newton on the residual log(T_ij_measured^-1 o T_i^-1 o T_j).
Padded edge lists with weights (0 masks a padding edge); the [6N, 6N]
normal system is dense, assembled with segment sums (``ba._add_rows``,
the edges sorted once a solve) and solved with ``torch.linalg.solve_ex``.
The iteration loop reads nothing on the host. The solve is a ``graphs``
program (``pg_solve``: prologue, one iteration written in place, run
``n_iterations`` times, epilogue); ``optimize_pose_graph`` runs it
eagerly, ``slam.sfm._jit_optimize_pose_graph`` as CUDA graphs.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..graphs import EAGER
from .ba import _add_rows, _check_precision, _segments
from .camera import compose, inverse, relative


class PoseGraph(NamedTuple):
    poses: torch.Tensor     # [N, 6] world->cam (axis-angle, translation)
    edge_i: torch.Tensor    # [E] int32
    edge_j: torch.Tensor    # [E] int32
    rel_ij: torch.Tensor    # [E, 6] measured T_ij (x_j = T_ij(x_i))
    weight: torch.Tensor    # [E] f32 (0 masks a padding edge)
    fixed: int = 1          # first N poses held fixed (gauge); int or 0-dim tensor


def edge_residual(pose_i, pose_j, rel_ij) -> torch.Tensor:
    """[..., 6] log-residual of one constraint (or a batch of them)."""
    pred = relative(pose_i, pose_j)
    return compose(pred, inverse(rel_ij))


def _raw_residuals(g: PoseGraph) -> torch.Tensor:
    return edge_residual(
        g.poses[g.edge_i.long()], g.poses[g.edge_j.long()], g.rel_ij
    )


def graph_residuals(g: PoseGraph) -> torch.Tensor:
    return _raw_residuals(g) * g.weight[:, None]


def graph_cost(g: PoseGraph) -> torch.Tensor:
    r = graph_residuals(g)
    return 0.5 * (r * r).sum()


def _edge_segments(g: PoseGraph):
    """The segment sums' indices of :func:`_step`, fixed for a whole solve:
    by first pose, by second pose, by pose pair."""
    n = g.poses.shape[0]
    ei, ej = g.edge_i.long(), g.edge_j.long()
    return _segments(ei, n), _segments(ej, n), _segments(ei * n + ej, n * n)


def _step(g: PoseGraph, lam: torch.Tensor, segs=None) -> torch.Tensor:
    """One damped Gauss-Newton step; ``segs`` is :func:`_edge_segments` of
    ``g`` (computed here when not given)."""
    n = g.poses.shape[0]
    dev = g.poses.device
    ei, ej = g.edge_i.long(), g.edge_j.long()
    seg_i, seg_j, seg_ij = _edge_segments(g) if segs is None else segs

    def one(pi, pj, m, w):
        def f(a, b):
            # One-row batches: a 0-dim intermediate under forward mode
            # promotes its tangent to float64 (see camera.rodrigues).
            r = edge_residual(a[None], b[None], m[None])[0]
            return r, r

        (ji, jj), r = torch.func.jacfwd(f, argnums=(0, 1), has_aux=True)(pi, pj)
        return ji * w, jj * w, r * w

    ji, jj, r = torch.func.vmap(one)(g.poses[ei], g.poses[ej], g.rel_ij, g.weight)

    # Dense [6N, 6N] normal equations assembled with segment sums.
    def outer(a, b):
        return torch.einsum("eia,eib->eab", a, b)

    h_diag = _add_rows(seg_i, outer(ji, ji)) + _add_rows(seg_j, outer(jj, jj))
    h = torch.zeros((n, 6, n, 6), dtype=g.poses.dtype, device=dev)
    idx = torch.arange(n, device=dev)
    h[idx, :, idx, :] += h_diag
    h_cross = _add_rows(seg_ij, outer(ji, jj)).reshape(n, n, 6, 6)
    x = h_cross.permute(0, 2, 1, 3)            # [i, a, j, b]
    h = h + x + x.permute(2, 3, 0, 1)

    b = -(
        _add_rows(seg_i, torch.einsum("eia,ei->ea", ji, r))
        + _add_rows(seg_j, torch.einsum("eia,ei->ea", jj, r))
    )

    eye = torch.eye(n * 6, dtype=h.dtype, device=dev)
    hm = h.reshape(n * 6, n * 6) + lam * eye
    fixed_mask = (torch.arange(n * 6, device=dev) < g.fixed * 6).to(h.dtype)
    free = 1 - fixed_mask
    hm = hm * free[:, None] * free[None, :] + torch.diag(fixed_mask)
    bv = b.reshape(-1) * free
    return torch.linalg.solve_ex(hm, bv).result.reshape(n, 6)


def robust_edge_weights(g: PoseGraph, huber_delta) -> torch.Tensor:
    """IRLS Huber weights per edge: w = min(1, delta / ||r||).

    Applied ON TOP of the static edge weights so a bad measurement (e.g.
    a loop closure verified by an ill-conditioned PnP) is downweighted
    instead of dragging the whole chain toward its wrong constraint.
    ``huber_delta`` may be a scalar or a per-edge [E] tensor (``inf``
    trusts an edge fully)."""
    r = _raw_residuals(g)
    norm = torch.sqrt((r * r).sum(-1) + 1e-24)
    return torch.clamp(huber_delta / norm, max=1.0)


class GraphSetup(NamedTuple):
    """What :func:`pg_prologue` prepares: the edges' segment-sum indices
    and the state an iteration writes in place (poses, damping)."""

    segs: tuple
    poses: torch.Tensor
    lam: torch.Tensor


def pg_prologue(g: PoseGraph, damping) -> GraphSetup:
    poses = g.poses.clone()
    lam = torch.full((), damping, dtype=poses.dtype, device=poses.device)
    return GraphSetup(_edge_segments(g), poses, lam)


def pg_iteration(g: PoseGraph, huber_delta, setup: GraphSetup) -> None:
    """One robust damped Gauss-Newton step with its accept/reject, written
    into ``setup`` in place (the JAX package's ``lax.fori_loop`` body)."""
    poses, lam = setup.poses, setup.lam
    gg = g._replace(poses=poses)
    w = g.weight * robust_edge_weights(gg, huber_delta)
    gw = gg._replace(weight=w)
    new_poses = poses + _step(gw, lam, setup.segs)
    c0 = graph_cost(gw)
    c1 = graph_cost(gw._replace(poses=new_poses))
    accept = c1 < c0
    poses.copy_(torch.where(accept, new_poses, poses))
    lam.copy_(torch.where(accept, lam * 0.5, lam * 10.0).clamp(1e-8, 1e6))


def pg_epilogue(g: PoseGraph, setup: GraphSetup):
    """(poses, final cost)."""
    return setup.poses, graph_cost(g._replace(poses=setup.poses))


def pg_solve(steps, g: PoseGraph, huber_delta, n_iterations, damping):
    """The pose-graph solve as a ``graphs`` program: prologue,
    ``n_iterations`` iterations, epilogue. Returns (poses, final cost)."""
    _check_precision(g.poses)
    setup = steps.stage(pg_prologue, g, damping)
    steps.loop(n_iterations, pg_iteration, g, huber_delta, setup)
    return steps.stage(pg_epilogue, g, setup)


def optimize_pose_graph(
    g: PoseGraph,
    n_iterations: int = 20,
    damping: float = 1e-4,
    huber_delta=0.1,
) -> Tuple[PoseGraph, torch.Tensor]:
    """Robust-LM pose-graph optimization on the graph's device, eagerly
    (``slam.sfm._jit_optimize_pose_graph`` replays it as CUDA graphs);
    returns (graph, final_cost). ``huber_delta`` is the residual norm
    (rad/units mixed 6-vector) beyond which an edge is treated as an
    outlier and IRLS-downweighted — scalar or per-edge [E] tensor; pass
    ``inf`` (per edge or globally) for pure least squares. ``g.fixed`` is
    an int or a 0-dim tensor."""
    poses, final = pg_solve(EAGER, g, huber_delta, n_iterations, damping)
    return g._replace(poses=poses), final
