"""Batched SIFT extraction over [B, H, W]: pyramid, detection, orientation,
descriptors and the global compactions.

Port of ``siftmetal_tpu/sift/batched.py`` (:43 ``build_pyramid_batch``,
:112 ``extract_gray_batch``) in the structure of its TPU path. The routing
follows the configuration and the input, not the device. With
``use_oneshot_pyramid``: the fused seed kernel for octave 0 when
``seed_supports``, the one-shot kernel for octaves of at least 176 rows.
With ``use_pallas_pyramid`` (fp32 only): the fused cascade kernel for the
remaining octaves of at least 256 rows. Otherwise the incremental
cascade, one launch an octave (``blur_cascade``).
``pyramid_dtype="bfloat16"`` feeds every one of them a bf16 chain.
``detect_slot_fields`` and ``use_fused_describe`` pick the
detection and describe variants; ``use_band_patches`` sends the two staged
patch stages through their resident-tile kernels (inside the wrappers; the
fused form has none, as in the JAX package). On a CUDA device every kernel wrapper
launches its kernel; on the CPU the same wrappers run their plain
versions. Per-frame counters come back with a leading [B] axis.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..config import SiftConfig
from ..ops.image import decimate_2x
from ..ops.kernels import pyramid as _oneshot
from ..ops.kernels.blur import blur_cascade
from ..ops.kernels.cascade import octave_cascade
from ..ops.kernels.patches import (
    descriptor_lanes,
    orient_desc_lanes,
    orientation_hist_octaves,
    prepare_patch_fields,
)
from . import describe as _describe
from . import detect as _detect
from .pyramid import is_bf16, seed_image

# Profiler ranges of the stages (read by chip_smoke.py's breakdown; free
# when no profiler runs).
_stage = torch.profiler.record_function


def build_pyramid_batch(
    gray: torch.Tensor, config: SiftConfig, n_octaves: int
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """[B, H, W] -> per-octave ([B, S, h, w] gaussians, [B, S-1, h, w] DoGs)."""
    h, w = gray.shape[-2], gray.shape[-1]
    shapes = config.octave_shapes(h, w, n_octaves)
    gaussians: List[torch.Tensor] = []
    dogs: List[torch.Tensor] = []
    # bf16 mode: the chain every blur reads is bf16, every emitted slice
    # the fp32 accumulator (sift/pyramid.py).
    bf16 = is_bf16(config)
    if bf16:
        gray = gray.to(torch.bfloat16)
    use_oneshot = config.use_oneshot_pyramid
    use_cascade = config.use_pallas_pyramid and not bf16
    seed_fused = use_oneshot and _oneshot.seed_supports(config, h, w)
    first = None if seed_fused else seed_image(gray, config)
    for o in range(n_octaves):
        if o > 0:
            prev = gaussians[o - 1][:, config.n_scales_per_octave]
            if bf16:
                prev = prev.to(torch.bfloat16)
            first = decimate_2x(prev, shapes[o]).contiguous()
        if o == 0 and seed_fused:
            stack, dog = _oneshot.seed_octave(gray, config)
        elif use_oneshot and _oneshot.supports(config, shapes[o][0]):
            stack, dog = _oneshot.octave_oneshot(
                first.to(torch.bfloat16) if bf16 else first, config
            )
        elif use_cascade and shapes[o][0] >= 256:
            stack, dog = octave_cascade(first, config)
        else:
            # sift/pyramid.py cascade_slices, stacked, in one launch.
            stack, dog = blur_cascade(first, config.incremental_sigmas(o), bf16)
        gaussians.append(stack)
        dogs.append(dog)
    return gaussians, dogs


def extract_gray_batch(
    grays: torch.Tensor, config: SiftConfig, n_octaves: int
):
    """Full SIFT on a [B, H, W] fp32 grayscale batch. Returns
    (Keypoints, Descriptors, counters), every field with a leading [B]."""
    with _stage("sift_pyramid"):
        gaussians, dogs = build_pyramid_batch(grays, config, n_octaves)
    with _stage("sift_detect"):
        per_octave, counters = _detect.detect_all_octaves_batch(dogs, config)
    counters = dict(counters)
    with _stage("sift_describe"):
        desc_rows, lane_overflow = _describe_octaves(
            gaussians, dogs, per_octave, config
        )
    with _stage("sift_compact"):
        return _compact_all(per_octave, desc_rows, lane_overflow, counters, config)


def _describe_octaves(gaussians, dogs, per_octave, config: SiftConfig):
    """Orientation and descriptor stages of every octave: every octave's
    keypoint compaction and gradient fields, the raw orientation
    histograms of all octaves in one launch, one smoothing and peak pass
    over them, then per-octave lane compaction and descriptors."""
    b = gaussians[0].shape[0]
    dev = gaussians[0].device
    n_octaves = len(gaussians)

    lane_overflow = torch.zeros((b,), dtype=torch.int32, device=dev)
    # Phase A: every octave's keypoint compaction and fields, then the raw
    # orientation histograms of all of them (or, fused, the whole describe
    # stage of each octave in one kernel: no lane compaction, rows carry
    # the peaks' validity).
    kpcs, fields_all, budgets = [], [], []
    for o in range(n_octaves):
        h, w = dogs[o].shape[-2:]
        budget = _detect.keypoint_budget(config, (h, w), o)
        kpc, kp_dropped = _detect.compact_octave_keypoints(
            per_octave[o], o, config, budget
        )
        lane_overflow = lane_overflow + kp_dropped
        kpcs.append(kpc)
        fields_all.append(prepare_patch_fields(gaussians[o], config))
        budgets.append(budget)
    if config.use_fused_describe:
        desc_rows = []
        for o, (kpc, fields, budget) in enumerate(zip(kpcs, fields_all, budgets)):
            frame_kp = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(budget)
            desc_rows.append(_fused_rows(o, kpc, fields, frame_kp, config))
        return desc_rows, lane_overflow
    hist_all = orientation_hist_octaves(fields_all, kpcs, config)
    # Smoothing + peak detection once over every octave's lanes.
    hist_all = _describe._smooth_circular(
        hist_all, config.orientation_smoothing_iterations
    )
    theta_all, ov_all = _describe.orientation_peaks(hist_all, config)

    # Phase B: per-octave (keypoint, orientation) lane compaction +
    # descriptors.
    off = 0
    desc_rows = []
    for o, (budget, kpc, fields) in enumerate(zip(budgets, kpcs, fields_all)):
        theta = theta_all[:, off:off + budget]
        ori_valid = ov_all[:, off:off + budget] & kpc.valid[:, :, None]
        off += budget
        m = theta.shape[-1]
        lane_valid = ori_valid.reshape(b, budget * m)
        n_lanes = (budget * 3 // 2 + 127) // 128 * 128
        order, count, dropped = _detect.compact_indices(lane_valid, n_lanes)
        slot_valid = torch.arange(n_lanes, device=dev)[None, :] < count[:, None]
        lane_overflow = lane_overflow + dropped

        rep = lambda a: torch.gather(a.repeat_interleave(m, dim=1), 1, order)
        theta_l = torch.gather(theta.reshape(b, budget * m), 1, order)
        frame_ln = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(n_lanes)
        flatl = lambda a: a.reshape(b * n_lanes)
        raw = descriptor_lanes(
            fields, flatl(rep(kpc.scale)), flatl(rep(kpc.x_oct)),
            flatl(rep(kpc.y_oct)), flatl(rep(kpc.sigma_oct)), flatl(theta_l),
            config, valid=flatl(slot_valid), frame=frame_ln,
        )
        feats = _describe.quantize_descriptors(raw, config).reshape(b, n_lanes, -1)
        desc_rows.append(
            dict(
                valid=slot_valid,
                octave=torch.full((b, n_lanes), o, dtype=torch.int32, device=dev),
                x=rep(kpc.x),
                y=rep(kpc.y),
                sigma=rep(kpc.sigma),
                theta=theta_l,
                features=feats,
            )
        )
    return desc_rows, lane_overflow


def _fused_rows(o: int, kpc, fields, frame_kp, config: SiftConfig):
    """Octave ``o``'s descriptor rows from the fused orientation+descriptor
    kernel: ``max_ori`` rows per keypoint slot, no lane compaction; a row
    is valid where its keypoint had that peak."""
    b, budget = kpc.valid.shape
    m = config.max_orientations_per_keypoint
    flat = lambda a: a.reshape(b * budget)
    raw, theta, ov = orient_desc_lanes(
        fields, flat(kpc.scale), flat(kpc.x_oct), flat(kpc.y_oct),
        flat(kpc.sigma_oct), config, valid=flat(kpc.valid), frame=frame_kp,
    )
    n_lanes = budget * m
    rep = lambda a: a.repeat_interleave(m, dim=1)
    return dict(
        valid=(ov.reshape(b, budget, m) & kpc.valid[:, :, None]).reshape(b, n_lanes),
        octave=torch.full((b, n_lanes), o, dtype=torch.int32, device=theta.device),
        x=rep(kpc.x),
        y=rep(kpc.y),
        sigma=rep(kpc.sigma),
        theta=theta.reshape(b, n_lanes),
        features=_describe.quantize_descriptors(raw, config).reshape(b, n_lanes, -1),
    )


def _compact_all(per_octave, desc_rows, lane_overflow, counters, config: SiftConfig):
    """The global keypoint and descriptor compactions."""
    from .extract import Descriptors

    dev = lane_overflow.device
    keypoints, kp_dropped_global = _detect.gather_keypoints(per_octave, config)

    n = config.max_descriptors
    valid = torch.cat([r["valid"] for r in desc_rows], dim=1)
    order, count, desc_dropped = _detect.compact_indices(valid, n)

    def take(field):
        cat = torch.cat([r[field] for r in desc_rows], dim=1)
        if cat.ndim == 2:
            return torch.gather(cat, 1, order)
        return torch.gather(cat, 1, order[:, :, None].expand(-1, -1, cat.shape[-1]))

    descriptors = Descriptors(
        valid=torch.arange(n, device=dev)[None, :] < count[:, None],
        octave=take("octave"),
        x=take("x"),
        y=take("y"),
        sigma=take("sigma"),
        theta=take("theta"),
        features=take("features"),
    )
    counters["n_descriptors"] = count
    counters["descriptor_overflow"] = desc_dropped + lane_overflow
    counters["keypoint_overflow"] = kp_dropped_global
    return keypoints, descriptors, counters
