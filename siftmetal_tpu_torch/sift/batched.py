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
versions. The describe stage's bookkeeping between the patch kernels (the
keypoint compaction, the peaks and lane compaction, the quantisation) is
one such wrapper each (``csrc/describe.cu``). Per-frame counters come back
with a leading [B] axis.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..config import SiftConfig
from ..graphs import EAGER
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
    grays: torch.Tensor, config: SiftConfig, n_octaves: int, steps=EAGER
):
    """Full SIFT on a [B, H, W] fp32 grayscale batch. Returns
    (Keypoints, Descriptors, counters), every field with a leading [B].

    Its four stages are the named stages of a ``graphs`` program run by
    ``steps`` (``sift.pyramid``, ``sift.detect``, ``sift.describe``,
    ``sift.compact``): host spans of the tracer when eager, one graph a
    stage in the facade's traced replay."""
    gaussians, dogs = steps.stage(
        build_pyramid_batch, grays, config, n_octaves, name="sift.pyramid")
    per_octave, counters = steps.stage(
        _detect.detect_all_octaves_batch, dogs, config, name="sift.detect")
    desc_rows, lane_overflow = steps.stage(
        _describe_octaves, gaussians, dogs, per_octave, config, name="sift.describe")
    return steps.stage(_compact_all, per_octave, desc_rows, lane_overflow, dict(counters),
                       config, name="sift.compact")


def _describe_octaves(gaussians, dogs, per_octave, config: SiftConfig):
    """Orientation and descriptor stages of every octave: the keypoint
    compaction of all octaves and each octave's gradient fields, the raw
    orientation histograms of all of them in one launch, the smoothing,
    peaks and lane compaction of all of them, the descriptors an octave,
    then the quantisation of all of them. On a card the compactions, peaks
    and quantisation are one launch each (``csrc/describe.cu``)."""
    b = gaussians[0].shape[0]
    budgets = [_detect.keypoint_budget(config, tuple(d.shape[-2:]), o)
               for o, d in enumerate(dogs)]
    kpcs, lane_overflow = _detect.compact_keypoints(per_octave, config, budgets)
    fields_all = [prepare_patch_fields(g, config) for g in gaussians]
    if config.use_fused_describe:
        # The whole describe stage of each octave in one kernel: no lane
        # compaction, rows carry the peaks' validity.
        fused = [_fused_rows(o, kpc, fields, config)
                 for o, (kpc, fields) in enumerate(zip(kpcs, fields_all))]
        feats = _describe.quantize_octaves([raw for raw, _ in fused], config)
        return [dict(rows, features=f.reshape(b, rows["x"].shape[1], -1))
                for (_, rows), f in zip(fused, feats)], lane_overflow
    hist_all = orientation_hist_octaves(fields_all, kpcs, config)
    lanes, lane_overflow = _describe.orientation_lanes(hist_all, kpcs, config, lane_overflow)
    flat = lambda a: a.reshape(-1)
    raws = [
        descriptor_lanes(
            fields, flat(ln.scale), flat(ln.x_oct), flat(ln.y_oct), flat(ln.sigma_oct),
            flat(ln.theta), config, valid=flat(ln.valid), frame=flat(ln.frame),
        )
        for fields, ln in zip(fields_all, lanes)
    ]
    feats = _describe.quantize_octaves(raws, config)
    desc_rows = [
        dict(valid=ln.valid, octave=ln.octave, x=ln.x, y=ln.y, sigma=ln.sigma, theta=ln.theta,
             features=f.reshape(b, ln.valid.shape[1], -1))
        for ln, f in zip(lanes, feats)
    ]
    return desc_rows, lane_overflow


def _fused_rows(o: int, kpc, fields, config: SiftConfig):
    """Octave ``o``'s raw descriptors and descriptor rows (all but the
    features) from the fused orientation+descriptor kernel: ``max_ori``
    rows per keypoint slot, no lane compaction; a row is valid where its
    keypoint had that peak."""
    b, budget = kpc.valid.shape
    m = config.max_orientations_per_keypoint
    flat = lambda a: a.reshape(b * budget)
    frame_kp = torch.arange(b, dtype=torch.int32, device=kpc.valid.device).repeat_interleave(budget)
    raw, theta, ov = orient_desc_lanes(
        fields, flat(kpc.scale), flat(kpc.x_oct), flat(kpc.y_oct),
        flat(kpc.sigma_oct), config, valid=flat(kpc.valid), frame=frame_kp,
    )
    n_lanes = budget * m
    rep = lambda a: a.repeat_interleave(m, dim=1)
    return raw, dict(
        valid=(ov.reshape(b, budget, m) & kpc.valid[:, :, None]).reshape(b, n_lanes),
        octave=torch.full((b, n_lanes), o, dtype=torch.int32, device=theta.device),
        x=rep(kpc.x),
        y=rep(kpc.y),
        sigma=rep(kpc.sigma),
        theta=theta.reshape(b, n_lanes),
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
