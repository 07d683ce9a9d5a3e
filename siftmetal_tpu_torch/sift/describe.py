"""Gradient fields, orientation assignment, and descriptor quantization.

Port of ``siftmetal_tpu/sift/describe.py``. The plain lane-chunked
histograms here (:func:`orientation_hist_plain`, :func:`descriptor_plain`)
are the patch kernels' plain versions: the same per-lane patch math as the
JAX package's ``_orientation_hist_one`` / ``_descriptor_one``, run over
chunks of the valid lanes.

Gradient convention: th = atan2(d/dcol, d/drow), IPOL's atan2(gy, gx)
with x = row. Samples outside the image have zero gradient, so they add
nothing (IPOL skips them).

:func:`orientation_lanes` (smoothing, peaks and each octave's lane
compaction) and :func:`quantize_octaves` run their PyTorch route on CPU
tensors and one launch of ``csrc/describe.cu`` each on CUDA tensors,
equal to it bit for bit.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..config import SiftConfig
from ..ops.kernels import use_kernel
from ..ops.kernels.describe import lane_peaks_octaves, quantize_rows
from .detect import compact_indices

_TWO_PI = 2.0 * math.pi


def gradients(gauss: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradient of each [..., H, W] slice with
    replicated edges. Returns (d/drow, d/dcol)."""
    lead = gauss.shape[:-2]
    g = gauss.reshape((-1, 1) + gauss.shape[-2:])
    gp = F.pad(g, (1, 1, 1, 1), mode="replicate").reshape(lead + (gauss.shape[-2] + 2, gauss.shape[-1] + 2))
    gi = 0.5 * (gp[..., 2:, 1:-1] - gp[..., :-2, 1:-1])
    gj = 0.5 * (gp[..., 1:-1, 2:] - gp[..., 1:-1, :-2])
    return gi, gj


def _smooth_circular(hist: torch.Tensor, iterations: int) -> torch.Tensor:
    """IPOL's circular box smoothing, ``iterations`` times."""
    for _ in range(iterations):
        hist = (torch.roll(hist, 1, dims=-1) + hist + torch.roll(hist, -1, dims=-1)) / 3.0
    return hist


def _peak_map(hist: torch.Tensor, config: SiftConfig):
    """(is_peak, theta) per bin of smoothed histograms [..., n_bins]: local
    maxima >= peak_threshold * max, parabolic refinement, IPOL's half-bin
    shift, theta wrapped to [-pi, pi)."""
    n = config.n_orientation_bins
    prev = torch.roll(hist, 1, dims=-1)
    nxt = torch.roll(hist, -1, dims=-1)
    is_peak = (
        (hist > prev)
        & (hist > nxt)
        & (hist >= config.orientation_peak_threshold * hist.amax(-1, keepdim=True))
        & (hist > 0.0)
    )
    offset = (prev - nxt) / (2.0 * (prev + nxt - 2.0 * hist))
    bins = torch.arange(n, dtype=torch.float32, device=hist.device)
    theta = (bins + 0.5 + offset) * (_TWO_PI / n)
    return is_peak, torch.remainder(theta + math.pi, _TWO_PI) - math.pi


def orientation_peaks(
    hist: torch.Tensor, config: SiftConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Principal orientations from smoothed histograms [..., n_bins].
    Returns (theta [..., MAX_ORI], zero where invalid; valid); peaks are
    ordered by height, ties by lower bin (a stable sort, as ``lax.top_k``
    orders them). Zero, not the parabola's 0/0 of a flat histogram: the
    compactions copy these slots into the padding of the outputs."""
    is_peak, theta = _peak_map(hist, config)
    score = torch.where(is_peak, hist, torch.full_like(hist, float("-inf")))
    k = config.max_orientations_per_keypoint
    top, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    valid = torch.isfinite(top[..., :k])
    theta = torch.gather(theta, -1, idx[..., :k])
    return torch.where(valid, theta, torch.zeros_like(theta)), valid


def _pick_bin_order(is_peak: torch.Tensor, values: torch.Tensor, k: int) -> torch.Tensor:
    """``values`` at the first ``k`` peaks in bin order, [..., k]; zero
    where a lane has fewer peaks."""
    rank = torch.cumsum(is_peak.to(torch.int32), -1)
    zero = torch.zeros_like(values)
    return torch.stack(
        [torch.where(is_peak & (rank == p + 1), values, zero).sum(-1) for p in range(k)],
        -1,
    )


def orientation_peaks_bin_order(
    hist: torch.Tensor, config: SiftConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused kernel's peak rule: the first MAX_ORI peaks in BIN order
    (IPOL's emission order). Differs from :func:`orientation_peaks` only
    in order, and in the set only for more than MAX_ORI peaks. Returns
    (theta [..., MAX_ORI], zero where invalid; valid)."""
    is_peak, theta = _peak_map(hist, config)
    k = config.max_orientations_per_keypoint
    valid = _pick_bin_order(is_peak, torch.ones_like(theta), k) > 0.0
    return _pick_bin_order(is_peak, theta, k), valid


def peak_conditioning(hist: torch.Tensor, config: SiftConfig) -> torch.Tensor:
    """max / |prev + next - 2 h| at each kept peak (bin order, [..., MAX_ORI];
    zero where none): how far the parabolic offset amplifies a relative
    error of the histogram. Comparisons of two implementations scale their
    theta tolerance by it."""
    is_peak, _ = _peak_map(hist, config)
    curv = (torch.roll(hist, 1, dims=-1) + torch.roll(hist, -1, dims=-1) - 2.0 * hist).abs()
    cond = hist.amax(-1, keepdim=True) / curv.clamp(min=1e-30)
    return _pick_bin_order(is_peak, cond, config.max_orientations_per_keypoint)


def quantize_descriptors(raw: torch.Tensor, config: SiftConfig) -> torch.Tensor:
    """L2-normalize, clip at 0.2, renormalize, quantize min(512 v, 255)."""
    norm = torch.linalg.vector_norm(raw, dim=-1, keepdim=True)
    clipped = torch.minimum(raw, 0.2 * norm)
    norm2 = torch.linalg.vector_norm(clipped, dim=-1, keepdim=True)
    q = torch.floor(512.0 * clipped / torch.clamp(norm2, min=1e-12))
    return torch.clamp(q, max=255.0).to(torch.uint8)


def quantize_octaves(raws: Sequence[torch.Tensor], config: SiftConfig) -> List[torch.Tensor]:
    """:func:`quantize_descriptors` of every raw descriptor array of
    ``raws`` (one an octave): one call each on CPU tensors; one launch of
    ``csrc/describe.cu`` ``quantize_rows_kernel`` over all of them on CUDA
    tensors (no fallback), equal to it bit for bit; raises for any other
    device."""
    if not use_kernel(raws[0], "quantize_rows"):
        return [quantize_descriptors(raw, config) for raw in raws]
    return quantize_rows(raws)


class DescribeLanes(NamedTuple):
    """One octave's (keypoint, orientation) lanes [B, n_lanes], in
    ascending (keypoint, peak) order: the staged descriptor kernel's lane
    arrays and the descriptor rows' fields. Lanes past a frame's count
    hold pair 0's values (keypoint 0, its first theta) and are not valid."""

    valid: torch.Tensor      # bool
    frame: torch.Tensor      # int32 — the lane's frame
    octave: torch.Tensor     # int32
    scale: torch.Tensor      # int32 — the keypoint's fields, as compacted
    x_oct: torch.Tensor      # f32
    y_oct: torch.Tensor      # f32
    sigma_oct: torch.Tensor  # f32
    theta: torch.Tensor      # f32 — the peak's orientation
    x: torch.Tensor          # f32
    y: torch.Tensor          # f32
    sigma: torch.Tensor      # f32


def lane_count(budget: int) -> int:
    """Lane slots of an octave of ``budget`` keypoint slots: 1.5 a slot,
    in multiples of 128."""
    return (budget * 3 // 2 + 127) // 128 * 128


def orientation_lanes(
    hist: torch.Tensor, kpcs: Sequence, config: SiftConfig, dropped: torch.Tensor
) -> Tuple[List[DescribeLanes], torch.Tensor]:
    """Raw orientation histograms [B, sum of budgets, n_bins] of every
    octave's compacted keypoints ``kpcs`` -> each octave's lanes and
    ``dropped`` [B] plus the lanes that did not fit:
    :func:`orientation_lanes_plain` on CPU tensors; one launch of
    ``csrc/describe.cu`` ``lane_peaks_kernel`` on CUDA tensors
    (``lane_peaks_octaves``, no fallback), equal to it bit for bit; raises
    for any other device. The lanes are views of the launch's buffers."""
    if not use_kernel(hist, "lane_peaks"):
        return orientation_lanes_plain(hist, kpcs, config, dropped)
    b = hist.shape[0]
    lanes = [lane_count(k.valid.shape[1]) for k in kpcs]
    valid, ints, reals, dropped = lane_peaks_octaves(
        hist, kpcs, lanes, dropped,
        smoothing_iterations=config.orientation_smoothing_iterations,
        peak_threshold=config.orientation_peak_threshold,
        max_ori=config.max_orientations_per_keypoint)
    sizes = [b * n for n in lanes]
    out = []
    for v, i, r, n in zip(valid.split(sizes), ints.split(sizes, dim=1),
                          reals.split(sizes, dim=1), lanes):
        scale, frame, octave = i.view(-1, b, n).unbind(0)
        x_oct, y_oct, sigma_oct, theta, x, y, sigma = r.view(-1, b, n).unbind(0)
        out.append(DescribeLanes(v.view(b, n), frame, octave, scale, x_oct, y_oct, sigma_oct,
                                 theta, x, y, sigma))
    return out, dropped


def orientation_lanes_plain(
    hist: torch.Tensor, kpcs: Sequence, config: SiftConfig, dropped: torch.Tensor
) -> Tuple[List[DescribeLanes], torch.Tensor]:
    """The PyTorch route of :func:`orientation_lanes`: the smoothing and the
    peaks of every octave's rows at once, then per octave the (keypoint,
    peak) lane compaction into :func:`lane_count` slots and the gathers of
    the keypoints' fields."""
    b = hist.shape[0]
    dev = hist.device
    hist = _smooth_circular(hist, config.orientation_smoothing_iterations)
    theta_all, ov_all = orientation_peaks(hist, config)
    m = theta_all.shape[-1]
    off = 0
    out = []
    for o, kpc in enumerate(kpcs):
        budget = kpc.valid.shape[1]
        theta = theta_all[:, off:off + budget]
        ori_valid = ov_all[:, off:off + budget] & kpc.valid[:, :, None]
        off += budget
        n_lanes = lane_count(budget)
        order, count, lane_dropped = compact_indices(ori_valid.reshape(b, budget * m), n_lanes)
        dropped = dropped + lane_dropped
        rep = lambda a: torch.gather(a.repeat_interleave(m, dim=1), 1, order)
        frame = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(n_lanes)
        out.append(DescribeLanes(
            valid=torch.arange(n_lanes, device=dev)[None, :] < count[:, None],
            frame=frame.reshape(b, n_lanes),
            octave=torch.full((b, n_lanes), o, dtype=torch.int32, device=dev),
            scale=rep(kpc.scale),
            x_oct=rep(kpc.x_oct),
            y_oct=rep(kpc.y_oct),
            sigma_oct=rep(kpc.sigma_oct),
            theta=torch.gather(theta.reshape(b, budget * m), 1, order),
            x=rep(kpc.x),
            y=rep(kpc.y),
            sigma=rep(kpc.sigma),
        ))
    return out, dropped


# --- plain patch histograms (the patch kernels' plain versions) -------------


def _lane_patches(gi_p, gj_p, idx, frame, scale, x, y, radius):
    """Static [C, 2r+1, 2r+1] gradient windows of lanes ``idx`` centred on
    the rounded keypoint, read from fields zero-padded by ``radius``
    (zeros outside the image), plus the window's row/col offsets
    (dm [C, P, 1], dn [C, 1, P])."""
    b, s, hp, wp = gi_p.shape
    h, w = hp - 2 * radius, wp - 2 * radius
    p = 2 * radius + 1
    fr = frame[idx].clamp(0, b - 1)
    sc = scale[idx].clamp(1, s) - 1
    xs, ys = x[idx], y[idx]
    ci = torch.round(xs).long().clamp(0, h - 1)
    cj = torch.round(ys).long().clamp(0, w - 1)
    ar = torch.arange(p, device=gi_p.device)
    rows = (ci[:, None] + ar)[:, :, None]          # padded coordinates
    cols = (cj[:, None] + ar)[:, None, :]
    f3, s3 = fr[:, None, None], sc[:, None, None]
    pi = gi_p[f3, s3, rows, cols]
    pj = gj_p[f3, s3, rows, cols]
    arf = ar.to(torch.float32)
    dm = ((ci.to(torch.float32) - radius)[:, None] + arf - xs[:, None])[:, :, None]
    dn = ((cj.to(torch.float32) - radius)[:, None] + arf - ys[:, None])[:, None, :]
    return pi, pj, dm, dn


def _pad(a: torch.Tensor, r: int) -> torch.Tensor:
    return F.pad(a, (r, r, r, r))


def _valid_chunks(valid: torch.Tensor, chunk: int):
    live = torch.nonzero(valid).flatten()
    for c0 in range(0, live.numel(), chunk):
        yield live[c0:c0 + chunk]


def orientation_hist_plain(
    gi, gj, frame, scale, x, y, sigma, valid, config: SiftConfig
) -> torch.Tensor:
    """Raw [L, n_bins] orientation histograms (IPOL Alg. 11); invalid
    lanes are zeros. ``gi``/``gj`` are [B, n_scales, H, W]."""
    r = config.ori_patch_radius
    nb = config.n_orientation_bins
    lam = config.orientation_lambda
    out = torch.zeros((scale.shape[0], nb), dtype=torch.float32, device=gi.device)
    gi_p, gj_p = _pad(gi, r), _pad(gj, r)
    for idx in _valid_chunks(valid, config.describe_lane_chunk):
        pi, pj, dm, dn = _lane_patches(gi_p, gj_p, idx, frame, scale, x, y, r)
        sig = sigma[idx][:, None, None]
        r_max = 3.0 * lam * sig
        inside = (dm.abs() <= r_max) & (dn.abs() <= r_max)
        mag = torch.sqrt(pi * pi + pj * pj)
        wgt = torch.exp(-(dm * dm + dn * dn) / (2.0 * (lam * sig) ** 2)) * mag * inside
        theta = torch.remainder(torch.atan2(pj, pi), _TWO_PI)
        bins = torch.remainder(torch.round(theta * (nb / _TWO_PI)).long(), nb)
        c = idx.shape[0]
        hist = torch.zeros((c, nb), dtype=torch.float32, device=gi.device)
        hist.scatter_add_(1, bins.reshape(c, -1), wgt.reshape(c, -1))
        out[idx] = hist
    return out


def descriptor_plain(
    gi, gj, frame, scale, x, y, sigma, theta, valid, config: SiftConfig
) -> torch.Tensor:
    """Raw [L, n_hist^2 * n_ori] descriptor histograms (IPOL Alg. 12) with
    trilinear soft assignment; invalid lanes are zeros."""
    r = config.desc_patch_radius
    nh = config.n_histograms_per_axis
    no = config.n_descriptor_bins
    lam = config.descriptor_lambda
    dev = gi.device
    out = torch.zeros((scale.shape[0], nh * nh * no), dtype=torch.float32, device=dev)
    half = lam * (nh + 1) / nh
    cell = 2.0 * lam / nh
    centers = (torch.arange(1, nh + 1, dtype=torch.float32, device=dev) - (nh + 1) / 2.0) * cell
    ocenters = torch.arange(no, dtype=torch.float32, device=dev) * (_TWO_PI / no)
    gi_p, gj_p = _pad(gi, r), _pad(gj, r)
    for idx in _valid_chunks(valid, config.describe_lane_chunk):
        pi, pj, dm, dn = _lane_patches(gi_p, gj_p, idx, frame, scale, x, y, r)
        sig = sigma[idx][:, None, None]
        th = theta[idx][:, None, None]
        ct, st = torch.cos(th), torch.sin(th)
        xr = (ct * dm + st * dn) / sig
        yr = (-st * dm + ct * dn) / sig
        inside = (xr.abs() < half) & (yr.abs() < half)
        mag = torch.sqrt(pi * pi + pj * pj)
        contrib = torch.exp(-(xr * xr + yr * yr) / (2.0 * lam * lam)) * mag * inside
        wr = torch.clamp(1.0 - (xr[..., None] - centers).abs() / cell, min=0.0)
        wc = torch.clamp(1.0 - (yr[..., None] - centers).abs() / cell, min=0.0)
        phi = torch.remainder(torch.atan2(pj, pi) - th, _TWO_PI)
        d = (phi[..., None] - ocenters).abs()
        d = torch.minimum(d, _TWO_PI - d)
        wo = torch.clamp(1.0 - d * (no / _TWO_PI), min=0.0)
        c = idx.shape[0]
        ab = (contrib[..., None, None] * wr[..., :, None] * wc[..., None, :]).reshape(c, -1, nh * nh)
        hist = torch.einsum("cpa,cpk->cak", ab, wo.reshape(c, -1, no))
        out[idx] = hist.reshape(c, -1)
    return out
