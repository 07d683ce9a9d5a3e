"""Multi-device bundle adjustment: landmarks sharded over the ranks.

Port of ``siftmetal_tpu/parallel/distributed_ba.py`` on
``torch.distributed``. Landmark blocks (Hll, b_l, the slot-level coupling
blocks and the back-substitution) are independent in the landmark index,
so each rank owns a contiguous landmark shard with its observations
GROUPED BY LANDMARK ([L/D, M] slots, the layout of ``slam/ba.py``). The
reduced camera system S = Hcc - sum_l W_l Hll_l^-1 W_l^T and its right-hand
side are formed locally from observed camera pairs and summed over the
ranks; every rank then solves the small replicated [6C, 6C] system and
back-substitutes its own landmarks. Per iteration the only communication
is one all-reduce each of Hcc, the cross term, the right-hand side (all
float64, as ``slam/ba.py`` assembles them) and the cost: O(C^2) numbers,
independent of L.

The accept/reject decision comes from the all-reduced cost, which every
rank holds bit for bit, and stays a ``torch.where`` on the device: nothing
in the LM loop reads a value on the host.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..slam.ba import (
    BAProblem,
    GroupedObs,
    _check_precision,
    finish_step,
    grouped_cost,
    schur_pieces,
    schur_segments,
)
from .extraction import _check_inputs, all_gather_rows
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
    fixed_cameras: torch.Tensor  # [1] int32, on the host (read once a solve)


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
    dropped and the count is logged as a warning. The tensors keep the
    problem's device; ``fixed_cameras`` stays on the host."""
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
        fixed_cameras=torch.tensor([int(problem.fixed_cameras)], dtype=torch.int32),
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
    holds it)."""
    hd = huber_delta if huber_delta > 0 else 1e12
    group = mesh.get_group(axis)
    world = mesh.size()
    dev = rank_device(mesh)

    def psum(t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()           # NCCL reduces contiguous tensors only
        dist.all_reduce(t, group=group)
        return t

    def run(sharded: ShardedBA):
        if sharded.landmarks.shape[0] != world:
            raise ValueError(
                f"a problem sharded {sharded.landmarks.shape[0]} ways on a mesh of {world}"
            )
        _check_inputs(dev, "the problem", *sharded)
        r = mesh.get_local_rank(axis)
        cams = sharded.cameras.to(dev)
        _check_precision(cams)
        lms = sharded.landmarks[r].to(dev)
        k = sharded.k.to(dev)
        g = GroupedObs(
            cam=sharded.cam[r].to(dev), uv=sharded.uv[r].to(dev),
            valid=sharded.valid[r].to(dev),
            dropped=torch.zeros((), dtype=torch.int32, device=dev),
        )
        fixed = int(sharded.fixed_cameras[0])
        c_n = cams.shape[0]
        segs = schur_segments(g, c_n)

        def total_cost(c, l):
            return psum(grouped_cost(c, l, k, g, huber_delta))

        lam = torch.full((), damping, dtype=cams.dtype, device=dev)
        c_init = total_cost(cams, lms)
        c0 = c_init
        for _ in range(n_iterations):
            hcc, cross, rhs, hll_inv, G, b_l = schur_pieces(
                cams, lms, k, g, c_n, lam, hd, fixed, segs
            )
            # ONE all-reduce each for the reduced system (O(C^2), not O(L)).
            d_cam, d_lm = finish_step(
                psum(hcc), psum(cross), psum(rhs), hll_inv, G, b_l, g.cam, c_n, lam, fixed,
            )
            new_c = cams + d_cam.to(cams.dtype)
            new_l = lms + d_lm.to(lms.dtype)
            c1 = total_cost(new_c, new_l)
            accept = c1 < c0
            cams = torch.where(accept, new_c, cams)
            lms = torch.where(accept, new_l, lms)
            c0 = torch.where(accept, c1, c0)
            lam = torch.where(accept, lam * 0.5, lam * 10.0).clamp(1e-8, 1e6)
        # The carried cost is the total cost of the state kept.
        lms_all = all_gather_rows(group, [lms])[0]
        return cams, lms_all.reshape(sharded.landmarks.shape), (c_init, c0)

    return run
