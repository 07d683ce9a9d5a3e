"""Bundle adjustment: damped Gauss-Newton with a Schur complement.

Port of ``siftmetal_tpu/slam/ba.py``: the same problem layout, grouping,
reduced system and trust control, on the tensors' device.

  * Observations are a padded SoA (cam_idx, lm_idx, uv, valid) with
    static shapes and masked semantics.
  * Jacobians come from ``torch.func.jacfwd`` of the per-observation
    residual, vmapped over observations.
  * The normal equations are reduced by segment sums (``_add_rows``: the
    same bits on every run, on the card too; each index sorted once a
    solve) into block diagonals
    (Hcc [C, 6, 6], Hll [L, 3, 3]). Observations are
    grouped by landmark into [L, M] slots, and the Schur cross term
    sum_l W_l Hll_l^-1 W_l^T is accumulated from observed camera pairs
    only, chunked over landmarks to bound the [chunk, M, M, 6, 6]
    transient: O(L * M^2) per chunk plus O(C^2) output, never O(L * C).
  * The camera system after eliminating landmarks is a dense [6C, 6C]
    solve (``torch.linalg.solve_ex``: no host check of its status).

Nothing in the iteration loop reads a tensor's value on the host: the
accept/reject decision and the damping update are ``torch.where``s, so
the whole solve queues on the card. The state, residuals, Jacobians and
costs are fp32; the normal equations are assembled and solved in float64
(see ``ACC``); TF32 must be off (``device.resolve_device`` turns it off).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .camera import project


class BAProblem(NamedTuple):
    cameras: torch.Tensor    # [C, 6] axis-angle + translation (world->cam)
    landmarks: torch.Tensor  # [L, 3]
    k: torch.Tensor          # [3, 3] shared intrinsics
    cam_idx: torch.Tensor    # [O] int32
    lm_idx: torch.Tensor     # [O] int32
    uv: torch.Tensor         # [O, 2] observed pixels (u=col, v=row)
    valid: torch.Tensor      # [O] bool
    fixed_cameras: int = 1   # first N cameras held fixed (gauge freedom)


class BAStats(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    n_observations: torch.Tensor
    # Observations dropped because a landmark exceeded max_obs_per_landmark
    # slots (counted, never silent).
    obs_dropped: torch.Tensor


class GroupedObs(NamedTuple):
    """Observations grouped by landmark into [L, M] padded slots."""

    cam: torch.Tensor      # [L, M] int32 — camera index (0 for padding)
    uv: torch.Tensor       # [L, M, 2]
    valid: torch.Tensor    # [L, M] bool
    dropped: torch.Tensor  # scalar int32


def _check_precision(t: torch.Tensor) -> None:
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "bundle adjustment and the pose graph need full-float32 products: "
            "torch.backends.cuda.matmul.allow_tf32 must be False"
        )


def _residual(cam, lm, k, uv):
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


def group_by_landmark(
    cam_idx: torch.Tensor,
    lm_idx: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    n_landmarks: int,
    max_obs_per_landmark: int,
) -> GroupedObs:
    """Regroup flat observations into [L, M] slots.

    Stable-sorts by landmark, derives each observation's slot as its rank
    within the landmark's run, and scatters into the padded grid (one
    spare row takes everything not kept and is sliced off). Overflowing
    observations (landmark degree > M) are dropped AND counted."""
    dev = lm_idx.device
    o = lm_idx.shape[0]
    m = max_obs_per_landmark
    spare = n_landmarks * m
    key = torch.where(valid, lm_idx.long(), n_landmarks)  # invalid -> overflow bucket
    order = torch.argsort(key, stable=True)
    skey = key[order]
    first = torch.searchsorted(skey, skey, side="left")
    slot = torch.arange(o, device=dev) - first
    listed = skey < n_landmarks
    keep = listed & (slot < m)
    tgt = torch.where(keep, skey * m + slot, spare)

    cam_g = torch.zeros(spare + 1, dtype=torch.int32, device=dev)
    cam_g[tgt] = cam_idx[order].to(torch.int32)
    uv_g = torch.zeros((spare + 1, 2), dtype=uv.dtype, device=dev)
    uv_g[tgt] = uv[order]
    val_g = torch.zeros(spare + 1, dtype=torch.bool, device=dev)
    val_g[tgt] = keep
    dropped = (listed & (slot >= m)).sum(dtype=torch.int32)
    return GroupedObs(
        cam=cam_g[:spare].reshape(n_landmarks, m),
        uv=uv_g[:spare].reshape(n_landmarks, m, 2),
        valid=val_g[:spare].reshape(n_landmarks, m),
        dropped=dropped,
    )


def _pair_chunk(m: int) -> int:
    """Landmarks per Schur-pair chunk: bounds the [chunk, M, M, 6, 6]
    transient to ~32 MB."""
    return max(128, (1 << 23) // max(1, m * m * 144))


def grouped_cost(cameras, landmarks, k, g: GroupedObs, huber_delta):
    r = _residual(cameras[g.cam.long()], landmarks[:, None, :], k, g.uv)   # [L, M, 2]
    norm = torch.sqrt((r * r).sum(-1) + 1e-12) * g.valid
    return _rho(norm, huber_delta).sum()


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
    index, ``ends`` [n + 1] bounds each of the ``n`` segments in that
    order."""

    order: torch.Tensor
    ends: torch.Tensor


def _segments(index: torch.Tensor, n: int) -> Segments:
    """Sort ``index`` (values in [0, n)) for :func:`_add_rows`; a solve
    whose index is fixed sorts it once and reuses it every iteration."""
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
    rows = src[seg.order].to(torch.float64).reshape(src.shape[0], -1).T.contiguous()
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


def schur_segments(g: GroupedObs, n_cameras: int):
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
    """Reduced-system pieces from grouped observations, in float64.

    ``segs`` is :func:`schur_segments` of ``g`` (computed here when not
    given). Returns (hcc [C,6,6], cross [C*C,6,6], rhs [C,6], hll_inv
    [L,3,3], coupling G [L,M,6,3], b_l [L,3]) — everything needed to
    finish a Gauss-Newton step."""
    c_n = n_cameras
    l_n, m = g.cam.shape
    dev = cameras.device
    cam_seg, pair_segs = schur_segments(g, c_n) if segs is None else segs
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


def finish_step(
    hcc, cross, rhs, hll_inv, G, b_l, cam_g, n_cameras, lam, fixed_cameras
):
    """Solve the reduced camera system and back-substitute landmarks, in
    the pieces' dtype."""
    c_n = n_cameras
    dev = hcc.device
    lam = torch.as_tensor(lam, dtype=hcc.dtype, device=dev)
    idx = torch.arange(c_n, device=dev)
    eye6 = torch.eye(6, dtype=hcc.dtype, device=dev)
    s = -cross.reshape(c_n, c_n, 6, 6).permute(0, 2, 1, 3)
    s = s.contiguous()
    s[idx, :, idx, :] += hcc + lam * eye6
    s_mat = s.reshape(c_n * 6, c_n * 6)
    fixed_mask = (torch.arange(c_n * 6, device=dev) < fixed_cameras * 6).to(hcc.dtype)
    free = 1 - fixed_mask
    s_mat = s_mat * free[:, None] * free[None, :] + torch.diag(fixed_mask)
    rhs_vec = rhs.reshape(-1) * free
    d_cam = torch.linalg.solve_ex(s_mat, rhs_vec).result.reshape(c_n, 6)

    # Back-substitute landmarks: dl = Hll^-1 (b_l - W^T dc), with
    # W^T dc = sum_m G_lm^T dc[cam_lm].
    dc_g = d_cam[cam_g.long()]                             # [L, M, 6]
    wt_dc = torch.einsum("lmab,lma->lb", G, dc_g)          # [L, 3]
    d_lm = torch.einsum("lab,lb->la", hll_inv, b_l - wt_dc)
    return d_cam, d_lm


def _gauss_newton_step(cameras, landmarks, k, g, n_cameras, lam, hd, fixed, segs):
    hcc, cross, rhs, hll_inv, G, b_l = schur_pieces(
        cameras, landmarks, k, g, n_cameras, lam, hd, fixed, segs
    )
    d_cam, d_lm = finish_step(
        hcc, cross, rhs, hll_inv, G, b_l, g.cam, n_cameras, lam, fixed
    )
    return d_cam.to(cameras.dtype), d_lm.to(landmarks.dtype)


def bundle_adjust(
    problem: BAProblem,
    n_iterations: int = 10,
    damping: float = 1e-4,
    huber_delta: float = 0.0,
    max_obs_per_landmark: int = 16,
) -> Tuple[BAProblem, BAStats]:
    """Fixed-iteration damped Gauss-Newton BA on the problem's device.

    ``huber_delta`` <= 0 selects plain least squares; > 0 enables Huber
    IRLS weights with that pixel threshold. Levenberg-Marquardt trust
    control without host reads: a rejected step leaves the state
    unchanged and inflates the damping 10x; an accepted step relaxes it
    2x. ``max_obs_per_landmark`` bounds the grouped layout; observations
    past it are dropped and counted in ``stats.obs_dropped``."""
    _check_precision(problem.cameras)
    hd = huber_delta if huber_delta > 0 else 1e12
    l_n = problem.landmarks.shape[0]
    c_n = problem.cameras.shape[0]
    g = group_by_landmark(
        problem.cam_idx, problem.lm_idx, problem.uv, problem.valid,
        l_n, max_obs_per_landmark,
    )
    k = problem.k
    cameras, landmarks = problem.cameras, problem.landmarks
    lam = torch.full((), damping, dtype=cameras.dtype, device=cameras.device)
    c_init = cost(problem)
    # Accept/reject on the SAME (robust) objective the step minimizes; the
    # cost of the state carried into the next iteration is the one just
    # computed for it.
    c0 = grouped_cost(cameras, landmarks, k, g, huber_delta)
    segs = schur_segments(g, c_n)
    for _ in range(n_iterations):
        d_cam, d_lm = _gauss_newton_step(
            cameras, landmarks, k, g, c_n, lam, hd, problem.fixed_cameras, segs
        )
        new_cams = cameras + d_cam
        new_lms = landmarks + d_lm
        c1 = grouped_cost(new_cams, new_lms, k, g, huber_delta)
        accept = c1 < c0
        cameras = torch.where(accept, new_cams, cameras)
        landmarks = torch.where(accept, new_lms, landmarks)
        c0 = torch.where(accept, c1, c0)
        lam = torch.where(accept, lam * 0.5, lam * 10.0).clamp(1e-8, 1e6)

    out = problem._replace(cameras=cameras, landmarks=landmarks)
    stats = BAStats(
        initial_cost=c_init,
        final_cost=cost(out),
        n_observations=problem.valid.sum(dtype=torch.int32),
        obs_dropped=g.dropped,
    )
    return out, stats
