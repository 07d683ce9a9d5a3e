"""Batched SIFT extraction over [B, H, W]: pyramid, detection, orientation,
descriptors and the global compactions.

Port of ``siftmetal_tpu/sift/batched.py`` (:43 ``build_pyramid_batch``,
:112 ``extract_gray_batch``) in the structure of its TPU path. The routing
of each octave follows the input, not the device: the fused seed kernel
for octave 0 when ``seed_supports``, the one-shot kernel for octaves of
at least 176 rows, the incremental cascade otherwise. On a CUDA device
every kernel wrapper launches its kernel; on the CPU the same wrappers run
their plain versions. Per-frame counters come back with a leading [B]
axis.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..config import SiftConfig
from ..ops.image import decimate_2x
from ..ops.kernels import pyramid as _oneshot
from ..ops.kernels.patches import (
    descriptor_lanes,
    orientation_hist_lanes,
    prepare_patch_fields,
)
from . import describe as _describe
from . import detect as _detect
from .pyramid import cascade_slices, seed_image

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
    seed_fused = _oneshot.seed_supports(config, h, w)
    first = None if seed_fused else seed_image(gray, config)
    for o in range(n_octaves):
        if o > 0:
            prev = gaussians[o - 1][:, config.n_scales_per_octave]
            first = decimate_2x(prev, shapes[o]).contiguous()
        if o == 0 and seed_fused:
            stack, dog = _oneshot.seed_octave(gray, config)
        elif _oneshot.supports(config, shapes[o][0]):
            stack, dog = _oneshot.octave_oneshot(first, config)
        else:
            stack = torch.stack(cascade_slices(first, o, config), dim=1)
            dog = stack[:, 1:] - stack[:, :-1]
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
    """Orientation and descriptor stages of every octave: per-octave
    keypoint compaction and raw orientation histograms, one smoothing and
    peak pass over all octaves, then per-octave lane compaction and
    descriptors."""
    b = gaussians[0].shape[0]
    dev = gaussians[0].device
    n_octaves = len(gaussians)

    lane_overflow = torch.zeros((b,), dtype=torch.int32, device=dev)
    # Phase A: per-octave keypoint compaction + raw orientation histograms.
    stage = []   # (octave, budget, kpc, fields, hist)
    for o in range(n_octaves):
        h, w = dogs[o].shape[-2:]
        budget = _detect.keypoint_budget(config, (h, w), o)
        kpc, kp_dropped = _detect.compact_octave_keypoints(
            per_octave[o], o, config, budget
        )
        lane_overflow = lane_overflow + kp_dropped
        fields = prepare_patch_fields(gaussians[o], config)
        frame_kp = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(budget)
        flat = lambda a: a.reshape(b * budget)
        hist = orientation_hist_lanes(
            fields, flat(kpc.scale), flat(kpc.x_oct), flat(kpc.y_oct),
            flat(kpc.sigma_oct), config, valid=flat(kpc.valid), frame=frame_kp,
        ).reshape(b, budget, -1)
        stage.append((o, budget, kpc, fields, hist))

    # Smoothing + peak detection once over every octave's lanes.
    hist_all = torch.cat([s[4] for s in stage], dim=1)
    hist_all = _describe._smooth_circular(
        hist_all, config.orientation_smoothing_iterations
    )
    theta_all, ov_all = _describe.orientation_peaks(hist_all, config)

    # Phase B: per-octave (keypoint, orientation) lane compaction +
    # descriptors.
    desc_rows = []
    off = 0
    for o, budget, kpc, fields, _hist in stage:
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
