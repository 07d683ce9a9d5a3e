"""Bundle adjustment: damped Gauss-Newton with a Schur complement.

Port of ``siftmetal_tpu/slam/ba.py``: the same problem layout, grouping,
reduced system and trust control, on the tensors' device.

  * Observations are a padded SoA (cam_idx, lm_idx, uv, valid) with
    static shapes and masked semantics.
  * A camera is 6 numbers with the problem's shared intrinsics ``k``, or
    BAL's 9 (:func:`~.camera.project_bal`: focal length and radial
    distortion of its own; ``k`` is not read). Every block width follows
    the camera's width P.
  * Jacobians come from ``torch.func.jacfwd`` of the per-observation
    residual, vmapped over observations.
  * The normal equations are reduced by segment sums (``_add_rows``: the
    same bits on every run, on the card too; each index sorted once a
    solve). ``sort_by_landmark`` sorts the observations by landmark and
    keeps at most M of each (past M they are dropped AND counted). The
    solve works on the kept observations flat, in that order: the block
    diagonal Hcc [C, P, P] is a segment sum over them, Hll [L, 3, 3] a
    sum over each landmark's run (:func:`_landmark_sums`), and the Schur
    cross term sum_l W_l Hll_l^-1 W_l^T is summed over a list of
    same-landmark observation pairs (:func:`schur_segments`), sorted once
    by camera pair, in chunks that bound the transient. The list has a
    static capacity and every slot of it is worked each iteration (a
    slot past the pairs adds 0): the work and memory follow the
    capacity, sum_l min(d_l, M) (min(d_l, M) + 1) / 2 where the caller
    sets ``max_pairs`` to the problem's count (:func:`landmark_pairs`),
    observations x (M + 1) / 2 by default.
  * The camera system after eliminating landmarks is a dense [PC, PC]
    solve (``torch.linalg.solve_ex``: no host check of its status).
  * The landmark-sharded solve (``parallel/distributed_ba.py``) runs the
    same pieces on its shard's [L, M] slots (:func:`slot_obs`). The grid
    form of the JAX package (``group_by_landmark``'s slots,
    :func:`schur_pieces`, :func:`finish_step`) stays as the reference of
    the tests that hold the port to it.

Nothing in the iteration loop reads a tensor's value on the host: the
accept/reject decision and the damping update are ``torch.where``s, so
the whole solve queues on the card. The solve is a ``graphs`` program
(``lm_solve``): a prologue (``ba.prologue``), one iteration that writes
its state in place (the JAX package's ``lax.fori_loop`` body;
``ba.iteration``), run ``n_iterations`` times, and an epilogue
(``ba.epilogue``); the names are the tracer's spans. ``bundle_adjust``
runs it eagerly, and on the card ``slam.sfm.replayed_bundle_adjust``
captures each piece once a shape and replays the iteration n times. The
state, residuals, Jacobians and costs are fp32, the costs that decide a
step summed in float64 (``grouped_cost``); the normal equations are
assembled and solved in float64 (see ``ACC``); TF32 must be off
(``device.resolve_device`` turns it off).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..graphs import EAGER
from ..utils import profiling
from .camera import project, project_bal


class BAProblem(NamedTuple):
    cameras: torch.Tensor    # [C, P] axis-angle + translation (world->cam); P = 9 adds f, k1, k2
    landmarks: torch.Tensor  # [L, 3]
    k: torch.Tensor          # [3, 3] shared intrinsics (not read when P = 9)
    cam_idx: torch.Tensor    # [O] int32
    lm_idx: torch.Tensor     # [O] int32
    uv: torch.Tensor         # [O, 2] observed pixels (u=col, v=row)
    valid: torch.Tensor      # [O] bool
    fixed_cameras: int = 1   # first N cameras held fixed (gauge); int or 0-dim tensor


class BAStats(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    n_observations: torch.Tensor
    # Observations dropped because a landmark exceeded max_obs_per_landmark
    # slots (counted, never silent).
    obs_dropped: torch.Tensor
    # Same-landmark observation pairs past the solve's ``max_pairs``, left
    # out of the Schur cross term (counted, never silent).
    pairs_dropped: torch.Tensor = torch.zeros((), dtype=torch.int32)
    # The cost the first step reached, accepted or not (summed in float64;
    # NaN without a step): it tells a step's arithmetic apart before the
    # iterations converge.
    first_step_cost: torch.Tensor = torch.full((), float("nan"), dtype=torch.float64)


class FlatObs(NamedTuple):
    """Observations by landmark, each landmark's kept ones first in its
    run: what the solve works on. The single-device solve's holds every
    observation, stably sorted by landmark (``sort_by_landmark``); a
    landmark shard's holds its [L, M] slots (:func:`slot_obs`)."""

    cam: torch.Tensor       # [O] int64 camera index
    lm: torch.Tensor        # [O] int64 landmark index (n_landmarks for an invalid observation)
    uv: torch.Tensor        # [O, 2]
    keep: torch.Tensor      # [O] bool — valid and within its landmark's first M
    kept_end: torch.Tensor  # [O] int64 — end of its landmark's kept run
    ends: torch.Tensor      # [L + 1] int64 — landmark l's run is [ends[l], ends[l + 1])
    m: int                  # max_obs_per_landmark


class GroupedObs(NamedTuple):
    """Observations grouped by landmark: flat (what the solve works on)
    and in [L, M] padded slots (None from ``sort_by_landmark``, and in a
    landmark shard)."""

    cam: Optional[torch.Tensor]    # [L, M] int32 — camera index (0 for padding)
    uv: Optional[torch.Tensor]     # [L, M, 2]
    valid: Optional[torch.Tensor]  # [L, M] bool
    dropped: torch.Tensor          # scalar int32
    flat: FlatObs


def _check_precision(t: torch.Tensor) -> None:
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "bundle adjustment and the pose graph need full-float32 products: "
            "torch.backends.cuda.matmul.allow_tf32 must be False"
        )


def _residual(cam, lm, k, uv):
    """Reprojection residual; the camera's width picks its model."""
    if cam.shape[-1] == 9:
        return project_bal(cam, lm) - uv
    return project(cam, k, lm) - uv


def residuals(problem: BAProblem) -> torch.Tensor:
    """[O, 2] masked reprojection residuals."""
    cam = problem.cameras[problem.cam_idx.long()]
    lm = problem.landmarks[problem.lm_idx.long()]
    return _residual(cam, lm, problem.k, problem.uv) * problem.valid[:, None]


def _rho(norm: torch.Tensor, huber_delta: float) -> torch.Tensor:
    if huber_delta <= 0:
        return 0.5 * norm * norm
    d = huber_delta
    return torch.where(norm <= d, 0.5 * norm * norm, d * (norm - 0.5 * d))


def cost(problem: BAProblem, huber_delta: float = 0.0) -> torch.Tensor:
    """Total objective; Huber rho when ``huber_delta`` > 0."""
    r = residuals(problem)
    if huber_delta <= 0:
        return 0.5 * (r * r).sum()
    norm = torch.sqrt((r * r).sum(-1) + 1e-12) * problem.valid
    return _rho(norm, huber_delta).sum()


def _huber_weight(r: torch.Tensor, delta: float) -> torch.Tensor:
    """Per-observation IRLS weight for the Huber loss, [..., 2] -> [...]."""
    norm = torch.sqrt((r * r).sum(-1) + 1e-12)
    return torch.where(norm <= delta, 1.0, delta / norm)


def sort_by_landmark(
    cam_idx: torch.Tensor,
    lm_idx: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    n_landmarks: int,
    max_obs_per_landmark: int,
) -> GroupedObs:
    """Sort flat observations by landmark (``GroupedObs.flat``; the slots
    are None): what the solve works on.

    Stable-sorts by landmark, derives each observation's slot as its rank
    within the landmark's run and keeps the slots under M. Overflowing
    observations (landmark degree > M) are dropped AND counted."""
    dev = lm_idx.device
    o = lm_idx.shape[0]
    m = max_obs_per_landmark
    key = torch.where(valid, lm_idx.long(), n_landmarks)  # invalid -> overflow bucket
    order = torch.argsort(key, stable=True)
    skey = key[order]
    first = torch.searchsorted(skey, skey, side="left")
    slot = torch.arange(o, device=dev) - first
    listed = skey < n_landmarks
    keep = listed & (slot < m)
    dropped = (listed & (slot >= m)).sum(dtype=torch.int32)
    kept_end = torch.minimum(torch.searchsorted(skey, skey, side="right"), first + m)
    ends = torch.searchsorted(skey, torch.arange(n_landmarks + 1, device=dev))
    flat = FlatObs(cam_idx[order].long(), skey, uv[order], keep, kept_end, ends, m)
    return GroupedObs(None, None, None, dropped, flat)


def group_by_landmark(
    cam_idx: torch.Tensor,
    lm_idx: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    n_landmarks: int,
    max_obs_per_landmark: int,
) -> GroupedObs:
    """Regroup flat observations by landmark, flat and into [L, M] slots
    (the JAX package's grouping; the grid form's input): ``sort_by_landmark``,
    then the kept observations scattered into the padded grid (one spare
    row takes everything not kept and is sliced off)."""
    g = sort_by_landmark(cam_idx, lm_idx, uv, valid, n_landmarks, max_obs_per_landmark)
    f, m = g.flat, max_obs_per_landmark
    dev = lm_idx.device
    spare = n_landmarks * m
    slot = torch.arange(f.lm.shape[0], device=dev) - f.ends[f.lm]
    tgt = torch.where(f.keep, f.lm * m + slot, spare)

    cam_g = torch.zeros(spare + 1, dtype=torch.int32, device=dev)
    cam_g[tgt] = f.cam.to(torch.int32)
    uv_g = torch.zeros((spare + 1, 2), dtype=uv.dtype, device=dev)
    uv_g[tgt] = f.uv
    val_g = torch.zeros(spare + 1, dtype=torch.bool, device=dev)
    val_g[tgt] = f.keep
    return g._replace(
        cam=cam_g[:spare].reshape(n_landmarks, m),
        uv=uv_g[:spare].reshape(n_landmarks, m, 2),
        valid=val_g[:spare].reshape(n_landmarks, m),
    )


def slot_obs(cam: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor) -> FlatObs:
    """The flat form of [L, M] slots whose valid entries lead each row
    (the landmark-sharded solve's): a row a slot, landmark-major, the
    valid ones kept."""
    l_n, m = cam.shape
    ends = torch.arange(0, l_n * m + 1, m, device=cam.device)
    lm = torch.arange(l_n, device=cam.device).repeat_interleave(m)
    kept_end = (ends[:-1] + valid.sum(1)).repeat_interleave(m)
    return FlatObs(cam.reshape(-1).long(), lm, uv.reshape(-1, 2), valid.reshape(-1), kept_end,
                   ends, m)


def landmark_pairs(lm_idx, valid, n_landmarks: int, max_obs_per_landmark: int) -> int:
    """The same-landmark observation pairs a solve sums (each unordered
    pair of kept observations once, an observation with itself too):
    sum_l d (d + 1) / 2 with d = min(degree, M). Host arrays (numpy or CPU
    tensors): for a caller that holds the observations on the host, to
    size ``max_pairs`` and to count ``ba.pairs``."""
    lm = np.asarray(lm_idx)[np.asarray(valid, dtype=bool)]
    d = np.minimum(np.bincount(lm, minlength=n_landmarks), max_obs_per_landmark).astype(np.int64)
    return int((d * (d + 1) // 2).sum())


def _pair_chunk(m: int) -> int:
    """Landmarks per Schur-pair chunk: bounds the [chunk, M, M, 6, 6]
    transient to ~32 MB."""
    return max(128, (1 << 23) // max(1, m * m * 144))


def grouped_cost(cameras, landmarks, k, g: GroupedObs, huber_delta):
    """The (robust) cost of the kept observations, summed in float64: it
    decides the solve's steps, and at BAL scale (~2e5 terms, a cost ~1e5)
    a float32 sum rounds by ~1e-2, the gain of a late step."""
    f = g.flat
    lm = f.lm.clamp(max=landmarks.shape[0] - 1)
    r = _residual(cameras[f.cam], landmarks[lm], k, f.uv)                    # [O, 2]
    norm = torch.where(f.keep, torch.sqrt((r * r).sum(-1) + 1e-12), 0.0)
    return _rho(norm, huber_delta).sum(dtype=torch.float64)


def _jacobians(cam, lm, k, uv):
    """(r [O, 2], d r / d cam [O, 2, 6], d r / d lm [O, 2, 3]) of each
    observation: forward mode over one observation, vmapped."""

    def one(c, l, u):
        def f(cc, ll):
            r = _residual(cc, ll, k, u)
            return r, r

        (jc, jl), r = torch.func.jacfwd(f, argnums=(0, 1), has_aux=True)(c, l)
        return r, jc, jl

    return torch.func.vmap(one)(cam, lm, uv)


class Segments(NamedTuple):
    """A segment-sum index sorted once: ``order`` stably sorts the rows by
    index (None: the rows come sorted), ``ends`` [n + 1] bounds each of
    the ``n`` segments in that order."""

    order: torch.Tensor
    ends: torch.Tensor


def _segments(index: torch.Tensor, n: int) -> Segments:
    """Sort ``index`` (values in [0, n]; a row of value n is in no
    segment) for :func:`_add_rows`; a solve whose index is fixed sorts it
    once and reuses it every iteration."""
    order = torch.argsort(index, stable=True)
    ends = torch.searchsorted(index[order], torch.arange(n + 1, device=index.device))
    return Segments(order, ends)


def _add_rows(seg: Segments, src: torch.Tensor, out=None) -> torch.Tensor:
    """Sum the rows of ``src`` into the segments of ``seg`` (segment sum),
    added to ``out`` when given. The rows in sorted order are summed by
    one float64 prefix sum, and each segment is the difference of the sum
    at its two ends: no atomics (``index_add_`` on the card adds in no
    fixed order), so every run gives the same bits."""
    n = seg.ends.shape[0] - 1
    # Scanned along the last axis of the transpose: a scan along the first
    # axis of [O, 36] runs ~100x slower on the card.
    rows = src if seg.order is None else src[seg.order]
    rows = rows.to(torch.float64).reshape(src.shape[0], -1).T.contiguous()
    csum = torch.cumsum(torch.cat([torch.zeros_like(rows[:, :1]), rows], 1), 1)
    sums = (csum[:, seg.ends[1:]] - csum[:, seg.ends[:-1]]).T.reshape((n,) + src.shape[1:])
    sums = sums.to(src.dtype)
    return sums if out is None else out.add_(sums)


# The normal equations are assembled and solved in float64 (residuals and
# Jacobians stay fp32). The reduced camera system is a difference of
# nearly equal blocks: at 256 cameras / 65,536 landmarks in a chain, fp32
# steps at damping 1e-4..1e-2 raise the cost from 2.3e5 to 1e4..1e15 in
# this port and in the JAX package alike (CPU), float64 ones lower it to
# ~1.8.
ACC = torch.float64


def grid_segments(g: GroupedObs, n_cameras: int):
    """The segment-sum indices of :func:`schur_pieces`, fixed for a whole
    solve: (the slots' cameras, one for each landmark chunk's camera
    pairs)."""
    c_n = n_cameras
    cam_l = g.cam.long()
    chunk = _pair_chunk(cam_l.shape[1])
    pairs = []
    for s in range(0, cam_l.shape[0], chunk):
        c_c = cam_l[s:s + chunk]
        fid = (c_c[:, :, None] * c_n + c_c[:, None, :]).reshape(-1)
        pairs.append(_segments(fid, c_n * c_n))
    return _segments(cam_l.reshape(-1), c_n), pairs


def schur_pieces(
    cameras, landmarks, k, g: GroupedObs, n_cameras, lam, hd, fixed_cameras,
    segs=None,
):
    """Reduced-system pieces from the [L, M] slots of grouped
    observations, in float64 (the landmark-sharded solve's form).

    ``segs`` is :func:`grid_segments` of ``g`` (computed here when not
    given). Returns (hcc [C,6,6], cross [C*C,6,6], rhs [C,6], hll_inv
    [L,3,3], coupling G [L,M,6,3], b_l [L,3]) — everything needed to
    finish a Gauss-Newton step."""
    c_n = n_cameras
    l_n, m = g.cam.shape
    dev = cameras.device
    cam_seg, pair_segs = grid_segments(g, c_n) if segs is None else segs
    cam_f = g.cam.reshape(-1).long()
    lm_f = torch.arange(l_n, device=dev).repeat_interleave(m)
    uv_f = g.uv.reshape(-1, 2)

    r, jc, jl = (t.to(ACC) for t in _jacobians(cameras[cam_f], landmarks[lm_f], k, uv_f))
    lam = torch.as_tensor(lam, dtype=ACC, device=dev)
    w = _huber_weight(r, hd) * g.valid.reshape(-1)
    # Fixed cameras (gauge): zero their Jacobian so their update is 0.
    free = (cam_f >= fixed_cameras).to(jc.dtype)
    jc = jc * free[:, None, None]
    jc_w = jc * w[:, None, None]
    jl_w = jl * w[:, None, None]

    hcc = _add_rows(cam_seg, torch.einsum("oia,oib->oab", jc_w, jc))
    b_c = -_add_rows(cam_seg, torch.einsum("oia,oi->oa", jc_w, r))

    jcg = jc_w.reshape(l_n, m, 2, 6)
    jlg = jl.reshape(l_n, m, 2, 3)
    jl_wg = jl_w.reshape(l_n, m, 2, 3)
    rg_raw = r.reshape(l_n, m, 2)

    eye3 = torch.eye(3, dtype=ACC, device=dev)
    hll = torch.einsum("lmia,lmib->lab", jl_wg, jlg) + lam * eye3
    b_l = -torch.einsum("lmia,lmi->la", jl_wg, rg_raw)
    # Coupling blocks per OBSERVATION slot (the weight rides on jc_w).
    G = torch.einsum("lmia,lmib->lmab", jcg, jlg)          # [L, M, 6, 3]
    hll_inv = torch.linalg.inv_ex(hll).inverse
    y = torch.einsum("lab,lb->la", hll_inv, b_l)           # [L, 3]
    rhs = b_c - _add_rows(
        cam_seg, torch.einsum("lmab,lb->lma", G, y).reshape(-1, 6)
    )

    # Schur cross term from observed camera PAIRS only, chunked over
    # landmarks: blocks[l, m, n] = G_lm Hll_l^-1 G_ln^T added at
    # (cam_lm, cam_ln).
    P = torch.einsum("lmab,lbd->lmad", G, hll_inv)          # [L, M, 6, 3]
    cross = torch.zeros((c_n * c_n, 6, 6), dtype=ACC, device=dev)
    chunk = _pair_chunk(m)
    for s, seg in zip(range(0, l_n, chunk), pair_segs):
        blocks = torch.einsum("lmad,lnbd->lmnab", P[s:s + chunk], G[s:s + chunk])
        _add_rows(seg, blocks.reshape(-1, 6, 6), cross)
    return hcc, cross, rhs, hll_inv, G, b_l


def _solve_cameras(hcc, cross, rhs, n_cameras, lam, fixed_cameras):
    """The camera step: the reduced system [PC, PC] solved in the pieces'
    dtype, the rows and columns of the cameras under the gauge replaced by
    the identity and their right-hand side by 0."""
    c_n, p_n = n_cameras, hcc.shape[-1]
    dev = hcc.device
    lam = torch.as_tensor(lam, dtype=hcc.dtype, device=dev)
    idx = torch.arange(c_n, device=dev)
    eye = torch.eye(p_n, dtype=hcc.dtype, device=dev)
    s = -cross.reshape(c_n, c_n, p_n, p_n).permute(0, 2, 1, 3)
    s = s.contiguous()
    s[idx, :, idx, :] += hcc + lam * eye
    s_mat = s.reshape(c_n * p_n, c_n * p_n)
    fixed_mask = (torch.arange(c_n * p_n, device=dev) < fixed_cameras * p_n).to(hcc.dtype)
    free = 1 - fixed_mask
    s_mat = s_mat * free[:, None] * free[None, :] + torch.diag(fixed_mask)
    rhs_vec = rhs.reshape(-1) * free
    return torch.linalg.solve_ex(s_mat, rhs_vec).result.reshape(c_n, p_n)


def finish_step(
    hcc, cross, rhs, hll_inv, G, b_l, cam_g, n_cameras, lam, fixed_cameras
):
    """Solve the reduced camera system and back-substitute landmarks, in
    the pieces' dtype, from :func:`schur_pieces`' slots."""
    d_cam = _solve_cameras(hcc, cross, rhs, n_cameras, lam, fixed_cameras)
    # Back-substitute landmarks: dl = Hll^-1 (b_l - W^T dc), with
    # W^T dc = sum_m G_lm^T dc[cam_lm].
    dc_g = d_cam[cam_g.long()]                             # [L, M, P]
    wt_dc = torch.einsum("lmab,lma->lb", G, dc_g)          # [L, 3]
    d_lm = torch.einsum("lab,lb->la", hll_inv, b_l - wt_dc)
    return d_cam, d_lm


class SchurIndex(NamedTuple):
    """The segment-sum indices of :func:`pair_pieces`, fixed for a whole
    solve (:func:`schur_segments`)."""

    cams: Segments         # the flat observations by camera (the ones not kept in none)
    a: torch.Tensor        # [N] flat position of each pair's first observation
    b: torch.Tensor        # [N] and of its second (the same landmark, b >= a)
    weight: torch.Tensor   # [N] 1, 0.5 for an observation with itself, 0 past the pairs
    pairs: Segments        # the pairs by camera pair cam_a * C + cam_b (they come sorted)
    dropped: torch.Tensor  # int32: pairs past the N slots, left out


def schur_segments(g: GroupedObs, n_cameras: int, max_pairs: Optional[int] = None) -> SchurIndex:
    """The list of same-landmark pairs of the kept observations of ``g``
    (flat), sorted by camera pair, and the segment-sum indices of
    :func:`pair_pieces`.

    Each kept observation pairs with itself and with the kept ones after
    it in its landmark's run, so each unordered pair of a landmark's kept
    observations is listed once: sum_l d_l (d_l + 1) / 2 pairs
    (:func:`landmark_pairs`), found on the device from the runs' prefix
    sum. The list has ``max_pairs`` slots (default: observations x
    (M + 1) // 2, which no problem fills), each worked in every iteration
    whether it holds a pair or not: a caller that knows the count passes
    it. Pairs past the slots are left out and counted in ``dropped``."""
    f = g.flat
    c_n = n_cameras
    o = f.cam.shape[0]
    dev = f.cam.device
    n = o * (f.m + 1) // 2 if max_pairs is None else max_pairs
    pos = torch.arange(o, device=dev)
    count = torch.where(f.keep, f.kept_end - pos, 0)       # partners of each observation
    last = torch.cumsum(count, 0)
    p = torch.arange(n, device=dev)
    a = torch.searchsorted(last, p, right=True).clamp(max=o - 1)
    b = (a + p - (last[a] - count[a])).clamp(max=o - 1)
    listed = p < last[-1]
    pair_id = torch.where(listed, f.cam[a] * c_n + f.cam[b], c_n * c_n)
    order = torch.argsort(pair_id, stable=True)
    a, b, listed, pair_id = a[order], b[order], listed[order], pair_id[order]
    weight = torch.where(listed, torch.where(a == b, 0.5, 1.0), 0.0).to(ACC)
    return SchurIndex(
        cams=_segments(torch.where(f.keep, f.cam, c_n), c_n),
        a=a, b=b, weight=weight,
        pairs=Segments(None, torch.searchsorted(pair_id, torch.arange(c_n * c_n + 1, device=dev))),
        dropped=(last[-1] - n).clamp(min=0).to(torch.int32),
    )


def _landmark_sums(f: FlatObs, src: torch.Tensor) -> torch.Tensor:
    """Sum the rows of ``src`` [O, ...] (flat order) over each landmark's
    kept observations: [L, ...]. A scan inside each landmark's run (log2 M
    passes of shifted adds, reset at the run's start), read at its last
    kept row. No running sum crosses landmarks: Hll is inverted, and a
    point seen along nearly one ray (condition ~1e7) magnifies the
    rounding of a sum over the whole list (~1e-11 of it) to ~1e-5 of its
    inverse."""
    o = src.shape[0]
    pos = torch.arange(o, device=src.device)
    slot = (pos - f.ends[f.lm]).reshape((o,) + (1,) * (src.dim() - 1))
    s = 1
    while s < f.m:
        shifted = torch.cat([torch.zeros_like(src[:s]), src[:-s]])
        src = src + torch.where(slot >= s, shifted, 0.0)
        s *= 2
    start, end = f.ends[:-1], f.ends[1:]
    last = f.kept_end[start.clamp(max=o - 1)] - 1
    has = ((end > start) & (last >= start)).reshape((-1,) + (1,) * (src.dim() - 1))
    return torch.where(has, src[last.clamp(min=0)], 0.0)


def _pair_rows(p: int) -> int:
    """Pairs a chunk of the cross term: bounds its [chunk, P, P] transient
    to ~64 MB."""
    return max(1024, (1 << 23) // (p * p))


def pair_pieces(cameras, landmarks, k, g: GroupedObs, n_cameras, lam, hd, fixed_cameras,
                segs: SchurIndex):
    """Reduced-system pieces from the kept observations flat, in ``ACC``:
    (hcc [C, P, P], cross [C*C, P, P], rhs [C, P], hll_inv [L, 3, 3],
    coupling G [O, P, 3], b_l [L, 3])."""
    f = g.flat
    c_n, p_n = n_cameras, cameras.shape[-1]
    dev = cameras.device
    lm = f.lm.clamp(max=landmarks.shape[0] - 1)
    r, jc, jl = (t.to(ACC) for t in _jacobians(cameras[f.cam], landmarks[lm], k, f.uv))
    # An observation not kept adds nothing (a where: its Jacobian need not
    # be finite); the fixed cameras (gauge) get a zero Jacobian, so their
    # update is 0.
    keep = f.keep[:, None, None]
    jc = torch.where(keep & (f.cam >= fixed_cameras)[:, None, None], jc, 0.0)
    jl = torch.where(keep, jl, 0.0)
    r = torch.where(f.keep[:, None], r, 0.0)
    w = _huber_weight(r, hd)[:, None, None]
    jc_w, jl_w = jc * w, jl * w
    lam = torch.as_tensor(lam, dtype=ACC, device=dev)

    hcc = _add_rows(segs.cams, torch.einsum("oia,oib->oab", jc_w, jc))
    b_c = -_add_rows(segs.cams, torch.einsum("oia,oi->oa", jc_w, r))
    eye3 = torch.eye(3, dtype=ACC, device=dev)
    hll = _landmark_sums(f, torch.einsum("oia,oib->oab", jl_w, jl)) + lam * eye3
    b_l = -_landmark_sums(f, torch.einsum("oia,oi->oa", jl_w, r))
    # Coupling block of each observation (the weight rides on jc_w).
    G = torch.einsum("oia,oib->oab", jc_w, jl)                 # [O, P, 3]
    hll_inv = torch.linalg.inv_ex(hll).inverse
    y = torch.einsum("lab,lb->la", hll_inv, b_l)               # [L, 3]
    rhs = b_c - _add_rows(segs.cams, torch.einsum("oab,ob->oa", G, y[lm]))

    # Schur cross term over the pair list, a chunk of pairs at a time:
    # pair (a, b) adds G_a Hll^-1 G_b^T at (cam_a, cam_b) (an observation
    # with itself half of it); the list's sum and its transpose are the
    # term.
    ph = torch.einsum("oab,obd->oad", G, hll_inv[lm])          # [O, P, 3]
    half = torch.zeros((c_n * c_n, p_n, p_n), dtype=ACC, device=dev)
    ends, n = segs.pairs.ends, segs.a.shape[0]
    step = _pair_rows(p_n)
    for s in range(0, n, step):
        e = min(s + step, n)
        blocks = torch.einsum("nad,nbd->nab", ph[segs.a[s:e]], G[segs.b[s:e]])
        _add_rows(Segments(None, ends.clamp(s, e) - s), blocks * segs.weight[s:e, None, None], half)
    half = half.reshape(c_n, c_n, p_n, p_n)
    cross = (half + half.permute(1, 0, 3, 2)).reshape(c_n * c_n, p_n, p_n)
    return hcc, cross, rhs, hll_inv, G, b_l


def pair_step(hcc, cross, rhs, hll_inv, G, b_l, g: GroupedObs, n_cameras, lam, fixed_cameras):
    """Solve the reduced camera system and back-substitute landmarks from
    :func:`pair_pieces`: dl = Hll^-1 (b_l - sum over the landmark's kept
    observations of G^T dc[cam])."""
    d_cam = _solve_cameras(hcc, cross, rhs, n_cameras, lam, fixed_cameras)
    wt_dc = _landmark_sums(g.flat, torch.einsum("oab,oa->ob", G, d_cam[g.flat.cam]))
    d_lm = torch.einsum("lab,lb->la", hll_inv, b_l - wt_dc)
    return d_cam, d_lm


def _gauss_newton_step(cameras, landmarks, k, g, n_cameras, lam, hd, fixed, segs):
    pieces = pair_pieces(cameras, landmarks, k, g, n_cameras, lam, hd, fixed, segs)
    d_cam, d_lm = pair_step(*pieces, g, n_cameras, lam, fixed)
    return d_cam.to(cameras.dtype), d_lm.to(landmarks.dtype)


class LMState(NamedTuple):
    """The state an LM iteration carries and writes in place."""

    cameras: torch.Tensor
    landmarks: torch.Tensor
    c0: torch.Tensor        # (robust) cost of the state kept
    lam: torch.Tensor       # damping
    c_first: Optional[torch.Tensor] = None  # cost the first step reached; -1 before it


class LMSetup(NamedTuple):
    """What :func:`lm_prologue` prepares for the iterations."""

    g: GroupedObs
    segs: tuple
    state: LMState
    c_init: torch.Tensor


def lm_prologue(problem: BAProblem, damping, huber_delta, max_obs_per_landmark,
                max_pairs=None) -> LMSetup:
    """Group the observations, list their pairs, sort the segment-sum
    indices and take the first costs; the state is a copy of the
    problem's."""
    g = sort_by_landmark(
        problem.cam_idx, problem.lm_idx, problem.uv, problem.valid,
        problem.landmarks.shape[0], max_obs_per_landmark,
    )
    cameras, landmarks = problem.cameras.clone(), problem.landmarks.clone()
    lam = torch.full((), damping, dtype=cameras.dtype, device=cameras.device)
    c_init = cost(problem)
    # Accept/reject on the SAME (robust) objective the step minimizes; the
    # cost of the state carried into the next iteration is the one just
    # computed for it.
    c0 = grouped_cost(cameras, landmarks, problem.k, g, huber_delta)
    segs = schur_segments(g, cameras.shape[0], max_pairs)
    c_first = torch.full((), -1.0, dtype=c0.dtype, device=c0.device)
    return LMSetup(g, segs, LMState(cameras, landmarks, c0, lam, c_first), c_init)


def lm_iteration(problem: BAProblem, setup: LMSetup, huber_delta) -> None:
    """One damped Gauss-Newton step with its accept/reject, written into
    ``setup.state`` in place (the ``lax.fori_loop`` body of the JAX
    package): a rejected step leaves the state unchanged and inflates the
    damping 10x; an accepted one relaxes it 2x."""
    hd = huber_delta if huber_delta > 0 else 1e12
    s, g, k = setup.state, setup.g, problem.k
    d_cam, d_lm = _gauss_newton_step(
        s.cameras, s.landmarks, k, g, s.cameras.shape[0], s.lam, hd,
        problem.fixed_cameras, setup.segs,
    )
    new_cams = s.cameras + d_cam
    new_lms = s.landmarks + d_lm
    c1 = grouped_cost(new_cams, new_lms, k, g, huber_delta)
    accept = c1 < s.c0
    s.cameras.copy_(torch.where(accept, new_cams, s.cameras))
    s.landmarks.copy_(torch.where(accept, new_lms, s.landmarks))
    s.c0.copy_(torch.where(accept, c1, s.c0))
    s.lam.copy_(torch.where(accept, s.lam * 0.5, s.lam * 10.0).clamp(1e-8, 1e6))
    s.c_first.copy_(torch.where(s.c_first < 0, c1, s.c_first))


def lm_epilogue(problem: BAProblem, setup: LMSetup):
    """(cameras, landmarks, BAStats) of the state kept."""
    s = setup.state
    stats = BAStats(
        initial_cost=setup.c_init,
        final_cost=cost(problem._replace(cameras=s.cameras, landmarks=s.landmarks)),
        n_observations=problem.valid.sum(dtype=torch.int32),
        obs_dropped=setup.g.dropped,
        pairs_dropped=setup.segs.dropped,
        first_step_cost=torch.where(s.c_first < 0, torch.nan, s.c_first),
    )
    return s.cameras, s.landmarks, stats


def lm_solve(steps, problem: BAProblem, n_iterations, damping, huber_delta, max_obs_per_landmark,
             max_pairs=None):
    """The LM solve as a ``graphs`` program: prologue, ``n_iterations``
    iterations, epilogue, each named for the tracer. Returns (cameras,
    landmarks, BAStats)."""
    _check_precision(problem.cameras)
    setup = steps.stage(lm_prologue, problem, damping, huber_delta, max_obs_per_landmark,
                        max_pairs, name="ba.prologue")
    steps.loop(n_iterations, lm_iteration, problem, setup, huber_delta, name="ba.iteration")
    return steps.stage(lm_epilogue, problem, setup, name="ba.epilogue")


def bundle_adjust(
    problem: BAProblem,
    n_iterations: int = 10,
    damping: float = 1e-4,
    huber_delta: float = 0.0,
    max_obs_per_landmark: int = 16,
    max_pairs: Optional[int] = None,
) -> Tuple[BAProblem, BAStats]:
    """Fixed-iteration damped Gauss-Newton BA on the problem's device,
    eagerly (``slam.sfm.replayed_bundle_adjust`` replays it as CUDA
    graphs).

    ``huber_delta`` <= 0 selects plain least squares; > 0 enables Huber
    IRLS weights with that pixel threshold. Levenberg-Marquardt trust
    control without host reads (:func:`lm_iteration`).
    ``max_obs_per_landmark`` bounds the observations kept a landmark;
    past it they are dropped and counted in ``stats.obs_dropped``.
    ``max_pairs`` is the Schur term's pair list's length, worked whole
    every iteration (default: one no problem fills; pass
    :func:`landmark_pairs` where the observations are on the host); pairs
    past it are counted in ``stats.pairs_dropped``.
    ``problem.fixed_cameras`` is an int or a 0-dim tensor. Counts
    ``ba.solves`` for the tracer."""
    profiling.count("ba.solves")
    cameras, landmarks, stats = lm_solve(
        EAGER, problem, n_iterations, damping, huber_delta, max_obs_per_landmark, max_pairs
    )
    return problem._replace(cameras=cameras, landmarks=landmarks), stats
