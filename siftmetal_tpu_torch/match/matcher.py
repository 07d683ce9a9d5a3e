"""Descriptor matching: exact batched 2-NN (any map size), geometry score.

Port of ``siftmetal_tpu/match/matcher.py``: the same functions, field
names, shapes, defaults and sentinels, on padded tensors with validity
masks.

  * ``match_bruteforce``: exact 2-NN of uint8 descriptor sets. Target sets
    past ``target_block`` stream through block products with a running
    top-2 merge, so memory stays flat at any map size.
  * ``match_guided``: the SfM pipeline's spatially gated re-matcher.
  * ``geometry_score``: the consecutive-quadruple length-ratio/angle
    consistency heuristic with z-score outlier rejection.

No kernel of the JAX package lies in this module; its products are plain
matrix products there and ``torch.matmul`` here. The uint8 route is
integer-exact on the CPU and on the card alike: descriptors are centred to
[-128, 127] and multiplied as float32, where every partial sum of the 128
products stays below 2^21 < 2^24 and is therefore exact in any summation
order, provided TF32 is off (``device.resolve_device`` turns it off; the
product checks it).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..sift.detect import compact_indices


class Matches(NamedTuple):
    """Per-query best match over a padded target set."""

    target_idx: torch.Tensor       # [Q] int32 — best target, -1 if rejected
    distance: torch.Tensor         # [Q] f32 — best L2 distance (raw scale)
    second_distance: torch.Tensor  # [Q] f32
    valid: torch.Tensor            # [Q] bool — passed both thresholds
    # [Q] int32 — raw argmin / arg-second-min of the distance row,
    # regardless of acceptance (-1 where undefined, e.g. the guided
    # matcher). Lets a caller resolve ratio-test rejections caused by
    # near-duplicate targets.
    best_idx: Optional[torch.Tensor] = None
    second_idx: Optional[torch.Tensor] = None

    @property
    def count(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int32)


def raw_features(features: torch.Tensor) -> torch.Tensor:
    """uint8 [.., 128] -> f32 in [0, 1]."""
    return features.to(torch.float32) / 255.0


def _exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 ``a @ b.T`` in full float32 (never TF32)."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the matcher needs full-float32 matrix products: "
            "torch.backends.cuda.matmul.allow_tf32 must be False"
        )
    return a @ b.T


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[Q, D], [T, D] f32 -> squared L2 [Q, T] via one matrix product."""
    a2 = (a * a).sum(-1, keepdim=True)
    b2 = (b * b).sum(-1, keepdim=True).T
    return torch.clamp(a2 + b2 - 2.0 * _exact_matmul(a, b), min=0.0)


def pairwise_sq_dists_u8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """uint8 [Q, D], [T, D] -> INTEGER-EXACT squared L2 [Q, T] int32.

    Centring keeps the product's operands in [-128, 127]:

        a.b = (a-128).(b-128) + 128*sum(a) + 128*sum(b) - 128^2 * D

    and every term is an integer. |partial sums| <= D * 128^2 = 2^21 for
    D = 128, so the float32 product is exact; max d^2 = D * 255^2 < 2^24
    is exact in float32 downstream too."""
    if a.dtype != torch.uint8 or b.dtype != torch.uint8:
        raise TypeError(f"expected uint8 descriptors, got {a.dtype} and {b.dtype}")
    d = a.shape[-1]
    if d * 128 * 128 > 2 ** 24:
        raise ValueError(f"descriptor length {d} too long for the exact float32 product")
    ai, bi = a.to(torch.int32), b.to(torch.int32)
    ab = _exact_matmul((ai - 128).float(), (bi - 128).float()).to(torch.int32)
    isum = lambda v: v.sum(-1, keepdim=True, dtype=torch.int32)
    sa, sb = isum(ai), isum(bi).T                    # [Q, 1], [1, T]
    dot = ab + 128 * (sa + sb) - (128 * 128) * d
    a2, b2 = isum(ai * ai), isum(bi * bi).T
    return a2 + b2 - 2 * dot


def _argmin_lowest(d2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min, index of the LOWEST column holding it) per row: the tie rule
    of ``jnp.argmin``, written out because ``torch.min(dim)`` does not
    promise which of several equal minima it reports."""
    t = d2.shape[1]
    best = d2.amin(1)
    cols = torch.arange(t, dtype=torch.int32, device=d2.device)
    idx = torch.where(d2 == best[:, None], cols, t).amin(1)
    return best, idx.to(torch.int32)


def _top2(
    d2: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row (best, second-best, argbest, argsecond) of a [Q, T]
    distance matrix: two min/argmin passes, ties to the lowest index."""
    d1, idx1 = _argmin_lowest(d2)
    cols = torch.arange(d2.shape[1], dtype=torch.int32, device=d2.device)
    masked = torch.where(cols == idx1[:, None], float("inf"), d2)
    d2nd, idx2 = _argmin_lowest(masked)
    return d1, d2nd, idx1, idx2


def _accept(
    d1: torch.Tensor,
    d2: torch.Tensor,
    idx: torch.Tensor,
    idx2: torch.Tensor,
    query_valid: torch.Tensor,
    absolute_threshold: float,
    ratio_threshold: float,
) -> Matches:
    ok = query_valid & (d1 < absolute_threshold)
    if ratio_threshold < 1.0:
        # ratio_threshold >= 1.0 DISABLES the Lowe ratio test (see
        # match_bruteforce); it does not loosen it.
        ok = ok & (d1 < ratio_threshold * d2) & torch.isfinite(d2)
    return Matches(
        target_idx=torch.where(ok, idx, -1).to(torch.int32),
        distance=d1,
        second_distance=d2,
        valid=ok,
        best_idx=idx.to(torch.int32),
        second_idx=idx2.to(torch.int32),
    )


def _sq_dists(qf: torch.Tensor, tf: torch.Tensor) -> torch.Tensor:
    """Squared L2 [Q, T] on the features/255 scale; the integer-exact
    route for uint8 inputs, the float product otherwise."""
    if qf.dtype == torch.uint8 and tf.dtype == torch.uint8:
        return pairwise_sq_dists_u8(qf, tf).to(torch.float32) * (1.0 / (255.0 * 255.0))
    return pairwise_sq_dists(raw_features(qf), raw_features(tf))


def match_bruteforce(
    query_features: torch.Tensor,
    target_features: torch.Tensor,
    query_valid: torch.Tensor,
    target_valid: torch.Tensor,
    absolute_threshold: float = 1.176,
    ratio_threshold: float = 0.6,
    target_block: int = 65536,
) -> Matches:
    """Exact 2-NN matching of descriptor sets [Q, D] against [T, D]
    (thresholds on the features/255 scale).

    Target sets larger than ``target_block`` stream through block products
    with a running top-2 merge: exact at any map size without the [Q, T]
    distance matrix (it peaks at [Q, target_block]).

    ``ratio_threshold >= 1.0`` is a SENTINEL that disables the Lowe ratio
    test entirely (including the finite-second-distance guard); it does
    NOT loosen the test. Use it when querying maps with near-duplicate
    targets; a caller wanting a loose ratio test passes a value < 1.0."""
    b1, b2, idx, idx2 = _top2_blocked(
        query_features, target_features, target_valid, target_block
    )
    return _accept(
        torch.sqrt(b1), torch.sqrt(b2), idx, idx2, query_valid,
        absolute_threshold, ratio_threshold,
    )


def _top2_blocked(
    query_features: torch.Tensor,
    target_features: torch.Tensor,
    target_valid: torch.Tensor,
    target_block: int = 65536,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact per-query (best, second-best) SQUARED distances over the
    valid targets and their indices, ties to the lowest index: one
    product up to ``target_block`` targets, block products with a running
    top-2 merge beyond it."""
    t_n = target_features.shape[0]
    inf = float("inf")
    if t_n <= target_block:
        d2 = _sq_dists(query_features, target_features)
        d2 = torch.where(target_valid[None, :], d2, inf)
        return _top2(d2)

    q_n = query_features.shape[0]
    dev = query_features.device
    b1 = torch.full((q_n,), inf, device=dev)
    b2 = torch.full((q_n,), inf, device=dev)
    i1 = torch.full((q_n,), -1, dtype=torch.int32, device=dev)
    i2 = torch.full((q_n,), -1, dtype=torch.int32, device=dev)
    for off in range(0, t_n, target_block):
        d2 = _sq_dists(query_features, target_features[off:off + target_block])
        d2 = torch.where(target_valid[None, off:off + target_block], d2, inf)
        c1, c2, ci, ci2 = _top2(d2)
        ci, ci2 = ci + off, ci2 + off
        # Streaming top-2 merge: best = min of bests; second-best = min of
        # (the defeated best, both seconds), its index tracked through the
        # same three-way comparison.
        lose = torch.maximum(b1, c1)
        li = torch.where(c1 < b1, i1, ci)
        rest = torch.minimum(b2, c2)
        ni2 = torch.where(lose <= rest, li, torch.where(b2 <= c2, i2, ci2))
        i1 = torch.where(c1 < b1, ci, i1)
        b1 = torch.minimum(b1, c1)
        b2, i2 = torch.minimum(lose, rest), ni2
    return b1, b2, i1, i2


def match_guided(
    query_features: torch.Tensor,
    target_features: torch.Tensor,
    query_valid: torch.Tensor,
    target_valid: torch.Tensor,
    query_uv: torch.Tensor,
    target_uv: torch.Tensor,
    gate_radius: float,
    absolute_threshold: float = 1.4,
) -> Matches:
    """Spatially gated matching: a query may only match targets whose
    predicted image position ``target_uv`` lies within ``gate_radius``
    pixels of ``query_uv``. The gate replaces the ratio test, so only the
    absolute threshold applies."""
    d2 = _sq_dists(query_features, target_features)
    gate = ((query_uv[:, None, :] - target_uv[None, :, :]) ** 2).sum(-1) <= (
        gate_radius * gate_radius
    )
    d2 = torch.where(gate & target_valid[None, :], d2, float("inf"))
    d1, idx = _argmin_lowest(d2)
    dist = torch.sqrt(d1)
    ok = query_valid & torch.isfinite(d1) & (dist < absolute_threshold)
    return Matches(
        target_idx=torch.where(ok, idx, -1).to(torch.int32),
        distance=dist,
        second_distance=torch.full_like(dist, float("inf")),
        valid=ok,
        best_idx=idx,
        second_idx=torch.full_like(idx, -1),
    )


def geometry_score(
    matches: Matches,
    query_xy: torch.Tensor,
    target_xy: torch.Tensor,
    max_samples: int = 80,
    min_samples: int = 7,
    min_length: float = 2.0,
) -> torch.Tensor:
    """Scalar geometric-consistency score of a match set in [0, 1].

    Over consecutive match quadruples (m_i .. m_i+3), compare the length
    ratio and relative angle of the vectors (m1-m0) and (m3-m2) in query
    vs target frames; score = (orientation_similarity *
    scale_similarity)^2; return the mean of the scores with |z| <= 2."""
    # First max_samples accepted matches, in query order (padded with 0).
    order, n, _ = compact_indices(matches.valid, max_samples)
    dev = order.device
    slot_valid = torch.arange(max_samples, device=dev) < n

    src = query_xy[order]                                   # [S, 2]
    tgt = target_xy[matches.target_idx.long()[order]]       # [S, 2]

    def window(a):
        # (m1-m0, m3-m2) for windows starting at i = 0..S-4
        return a[1:-2] - a[:-3], a[3:] - a[2:-1]

    sb, st_ = window(src)
    tb, tt = window(tgt)
    w_valid = slot_valid[3:] & (torch.arange(max_samples - 3, device=dev) < n - 3)

    norms = lambda v: torch.sqrt((v * v).sum(-1))
    lsb, lst, ltb, ltt = norms(sb), norms(st_), norms(tb), norms(tt)
    long_enough = (
        (lsb >= min_length) & (lst >= min_length)
        & (ltb >= min_length) & (ltt >= min_length)
    )
    ok = w_valid & long_enough

    unit = lambda v, l: v / torch.clamp(l, min=1e-12)[:, None]
    pseudo_dot = lambda a, b: torch.clamp((a * b).sum(-1) * 0.5 + 0.5, 0.0, 1.0)

    sdot = pseudo_dot(unit(st_, lst), unit(sb, lsb))
    tdot = pseudo_dot(unit(tt, ltt), unit(tb, ltb))
    ori_sim = 1.0 - (sdot - tdot).abs()

    s_ratio = lst / torch.clamp(lsb, min=1e-12)
    t_ratio = ltt / torch.clamp(ltb, min=1e-12)
    scale_sim = torch.clamp(
        torch.minimum(s_ratio, t_ratio)
        / torch.clamp(torch.maximum(s_ratio, t_ratio), min=1e-12),
        0.0, 1.0,
    )
    score = (ori_sim * scale_sim) ** 2

    zero = torch.zeros_like(score)
    count = ok.sum().to(torch.float32)
    mean = torch.where(ok, score, zero).sum() / torch.clamp(count, min=1.0)
    var = torch.where(ok, (score - mean) ** 2, zero).sum() / torch.clamp(count - 1.0, min=1.0)
    std = torch.sqrt(var)
    z_ok = ok & ((score - mean).abs() <= 2.0 * torch.clamp(std, min=1e-12))
    fair_count = z_ok.sum().to(torch.float32)
    fair_mean = torch.where(z_ok, score, zero).sum() / torch.clamp(fair_count, min=1.0)
    return torch.where(count >= min_samples, fair_mean, torch.zeros_like(fair_mean))
