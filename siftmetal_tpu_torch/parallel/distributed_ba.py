"""Multi-device bundle adjustment: landmarks sharded over the ranks.

Port of ``siftmetal_tpu/parallel/distributed_ba.py`` on
``torch.distributed``. Landmark blocks (Hll, b_l, the slot-level coupling
blocks and the back-substitution) are independent in the landmark index,
so each rank owns a contiguous landmark shard with its observations
GROUPED BY LANDMARK ([L/D, M] slots, the layout of ``slam/ba.py``'s
``group_by_landmark``), solved as ``slam/ba.py`` solves one device's
(``slot_obs``, ``pair_pieces``): the reduced camera system S = Hcc -
sum_l W_l Hll_l^-1 W_l^T and its right-hand side are formed locally over
the shard's list of same-landmark observation pairs (as long as the
largest shard's count, which ``shard_ba_problem`` takes on the host) and
summed over the ranks; every rank then solves the small replicated
[6C, 6C] system and back-substitutes its own landmarks. Per iteration
the only communication is one all-reduce each of Hcc, the cross term,
the right-hand side (all float64, as ``slam/ba.py`` assembles them) and
the cost: O(C^2) numbers, independent of L.

The accept/reject decision comes from the all-reduced cost, which every
rank holds bit for bit, and stays a ``torch.where`` on the device: nothing
in the LM loop reads a value on the host. On the card ``run`` replays the
solve from CUDA graphs, one program a sharded shape (``graphs``; the
counterpart of the JAX ``jax.jit`` over ``shard_map``): a prologue, one LM
iteration with its four all-reduces, captured once and replayed
``n_iterations`` times, and an epilogue with the landmarks' all-gather.
The gauge is an input on the device. On the CPU (gloo) it runs eagerly.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..graphs import GraphCache
from ..slam.ba import (
    BAProblem,
    GroupedObs,
    LMSetup,
    LMState,
    _check_precision,
    grouped_cost,
    pair_pieces,
    pair_step,
    schur_segments,
    slot_obs,
)
from .extraction import _check_inputs, _routes, all_gather_rows
from .multihost import rank_device


class ShardedBA(NamedTuple):
    """Host-prepared landmark-sharded BA problem (leading axis = device).

    Observations are grouped by LOCAL landmark into [D, L/D, M] slots."""

    cameras: torch.Tensor    # [C, 6] replicated
    landmarks: torch.Tensor  # [D, L/D, 3]
    k: torch.Tensor          # [3, 3]
    cam: torch.Tensor        # [D, L/D, M] int32 — GLOBAL camera index
    uv: torch.Tensor         # [D, L/D, M, 2]
    valid: torch.Tensor      # [D, L/D, M] bool
    fixed_cameras: torch.Tensor  # [1] int32
    max_pairs: int               # same-landmark pairs of the shard that has the most


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def shard_ba_problem(
    problem: BAProblem,
    n_devices: int,
    max_obs_per_landmark: int | None = None,
) -> ShardedBA:
    """Partition landmarks contiguously and group each shard's
    observations by local landmark (on the host, with numpy). A landmark's
    slots take its valid observations in observation order; past M
    (default: the largest degree, rounded up to a multiple of 2) they are
    dropped and the count is logged as a warning. ``max_pairs`` is the
    most same-landmark pairs of valid slots a shard holds: the length of
    every rank's pair list. The tensors keep the problem's device,
    ``fixed_cameras`` (an int or a 0-dim tensor in ``problem``) too."""
    l_n = problem.landmarks.shape[0]
    if l_n % n_devices:
        raise ValueError(f"{l_n} landmarks do not split over {n_devices} devices")
    per = l_n // n_devices

    lm_idx = _np(problem.lm_idx).astype(np.int64)
    cam_idx = _np(problem.cam_idx)
    uv = _np(problem.uv)
    valid = _np(problem.valid).astype(bool)

    sel = np.nonzero(valid)[0]
    degree = np.bincount(lm_idx[sel], minlength=l_n)
    if max_obs_per_landmark is None:
        m = max(2, int(degree.max()) if len(sel) else 2)
        m = (m + 1) // 2 * 2
    else:
        m = max_obs_per_landmark

    # Slot of an observation = its rank among its landmark's valid
    # observations in observation order (a stable sort keeps that order).
    order = sel[np.argsort(lm_idx[sel], kind="stable")]
    lms = lm_idx[order]
    start = np.searchsorted(lms, lms, side="left")
    slot = np.arange(len(order)) - start
    keep = slot < m
    n_dropped = int((~keep).sum())
    o, l, s = order[keep], lms[keep], slot[keep]

    cam_g = np.zeros((l_n, m), np.int32)
    uv_g = np.zeros((l_n, m, 2), np.float32)
    val_g = np.zeros((l_n, m), bool)
    cam_g[l, s] = cam_idx[o]
    uv_g[l, s] = uv[o]
    val_g[l, s] = True
    v = val_g.sum(1).astype(np.int64)
    shard_pairs = (v * (v + 1) // 2).reshape(n_devices, per).sum(1)
    if n_dropped:
        logging.getLogger(__name__).warning(
            "shard_ba_problem: dropped %d observations past %d slots", n_dropped, m,
        )

    dev = problem.cameras.device
    t = lambda a: torch.from_numpy(a).to(dev)
    return ShardedBA(
        cameras=problem.cameras,
        landmarks=problem.landmarks.reshape(n_devices, per, 3),
        k=problem.k,
        cam=t(cam_g.reshape(n_devices, per, m)),
        uv=t(uv_g.reshape(n_devices, per, m, 2)),
        valid=t(val_g.reshape(n_devices, per, m)),
        fixed_cameras=t(np.array([int(problem.fixed_cameras)], np.int32)),
        max_pairs=int(shard_pairs.max()),
    )


def make_distributed_ba(
    mesh,
    n_iterations: int = 10,
    damping: float = 1e-4,
    huber_delta: float = 0.0,
    axis: str = "batch",
):
    """Landmark-sharded BA over the mesh's ranks: ``run(sharded)`` ->
    (cameras [C, 6], landmarks [D, L/D, 3], (initial_cost, final_cost)),
    the same on every rank. Each rank computes on its device and takes
    its own shard of ``sharded`` (the whole ``ShardedBA``, as every rank
    holds it). ``run.eager`` is the same solve without graphs."""
    hd = huber_delta if huber_delta > 0 else 1e12
    group = mesh.get_group(axis)
    world = mesh.size()
    dev = rank_device(mesh)

    def psum(t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()           # NCCL reduces contiguous tensors only
        dist.all_reduce(t, group=group)
        return t

    def prologue(cams, lms, k, cam, uv, valid, max_pairs):
        _check_precision(cams)
        g = GroupedObs(cam=None, uv=None, valid=None,
                       dropped=torch.zeros((), dtype=torch.int32, device=cam.device),
                       flat=slot_obs(cam, uv, valid))
        cams, lms = cams.clone(), lms.clone()
        lam = torch.full((), damping, dtype=cams.dtype, device=cams.device)
        c_init = psum(grouped_cost(cams, lms, k, g, huber_delta))
        state = LMState(cams, lms, c_init.clone(), lam)
        return LMSetup(g, schur_segments(g, cams.shape[0], max_pairs), state, c_init)

    def iteration(k, fixed, setup):
        s, g = setup.state, setup.g
        c_n = s.cameras.shape[0]
        hcc, cross, rhs, hll_inv, G, b_l = pair_pieces(
            s.cameras, s.landmarks, k, g, c_n, s.lam, hd, fixed, setup.segs
        )
        # ONE all-reduce each for the reduced system (O(C^2), not O(L)).
        d_cam, d_lm = pair_step(
            psum(hcc), psum(cross), psum(rhs), hll_inv, G, b_l, g, c_n, s.lam, fixed,
        )
        new_c = s.cameras + d_cam.to(s.cameras.dtype)
        new_l = s.landmarks + d_lm.to(s.landmarks.dtype)
        c1 = psum(grouped_cost(new_c, new_l, k, g, huber_delta))
        accept = c1 < s.c0
        s.cameras.copy_(torch.where(accept, new_c, s.cameras))
        s.landmarks.copy_(torch.where(accept, new_l, s.landmarks))
        s.c0.copy_(torch.where(accept, c1, s.c0))
        s.lam.copy_(torch.where(accept, s.lam * 0.5, s.lam * 10.0).clamp(1e-8, 1e6))

    def epilogue(setup):
        # The carried cost is the total cost of the state kept.
        s = setup.state
        return s.cameras, all_gather_rows(group, [s.landmarks])[0], (setup.c_init, s.c0)

    def solve(steps, cams, lms, k, cam, uv, valid, fixed, max_pairs):
        setup = steps.stage(prologue, cams, lms, k, cam, uv, valid, max_pairs)
        steps.loop(n_iterations, iteration, k, fixed, setup)
        return steps.stage(epilogue, setup)

    graphs = GraphCache(solve, "the distributed bundle adjustment")

    def call(route, sharded: ShardedBA):
        if sharded.landmarks.shape[0] != world:
            raise ValueError(
                f"a problem sharded {sharded.landmarks.shape[0]} ways on a mesh of {world}"
            )
        _check_inputs(dev, "the problem", *sharded[:-1])
        r = mesh.get_local_rank(axis)
        cams, lms_all, costs = route(
            sharded.cameras.to(dev), sharded.landmarks[r].to(dev), sharded.k.to(dev),
            sharded.cam[r].to(dev), sharded.uv[r].to(dev), sharded.valid[r].to(dev),
            sharded.fixed_cameras.to(dev).reshape(()), max_pairs=sharded.max_pairs,
        )
        return cams, lms_all.reshape(sharded.landmarks.shape), costs

    return _routes(call, graphs)
