"""Degenerate inputs through the port, on the CPU: the counterpart of
tests/test_edge_cases.py. A flat image gives no extremum and every
Gaussian slice of it one value a frame, on every pyramid route; noise
under tight budgets drops and reports; the global descriptor and keypoint
compactions count their overflow on the butterfly, as the JAX package
does; the octave schedule refuses more octaves than the image holds.
And the two equalities that keep a flat image flat: the plain
``blur_stack`` is ``ops/gaussian.py`` ``blur``, and every fused-seed slice
is the blur of the upsampled frame, bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

from siftmetal_tpu_torch import FAST_BF16_CONFIG, SIFT, SiftConfig
from siftmetal_tpu_torch.ops.gaussian import blur
from siftmetal_tpu_torch.ops.image import upsample_bilinear_2x
from siftmetal_tpu_torch.ops.kernels import pyramid as PP
from siftmetal_tpu_torch.ops.kernels.blur import blur_stack
from siftmetal_tpu_torch.sift.batched import build_pyramid_batch

# Keep PyTorch's CPU pool small: the suite runs several test processes
# side by side, and oversubscribed pools slow every one of them down.
torch.set_num_threads(2)

# tests/test_edge_cases.py's budgets.
EDGE = dict(max_extrema_per_octave=512, max_keypoints=256, max_descriptors=256)

# Every pyramid route: parity (fused seed, one-shot octave, fp32 cascade),
# the fast preset (fused seed, bf16 cascade), the unfused seed with the
# cascade (fp32 and bf16 chain) and the fused cascade kernel.
ROUTES = {
    "parity": SiftConfig(**EDGE),
    "fast_bf16": dataclasses.replace(FAST_BF16_CONFIG, **EDGE),
    "unfused": SiftConfig(use_oneshot_pyramid=False, **EDGE),
    "unfused_bf16": dataclasses.replace(FAST_BF16_CONFIG, use_oneshot_pyramid=False, **EDGE),
    "pallas_pyramid": SiftConfig(use_oneshot_pyramid=False, use_pallas_pyramid=True, **EDGE),
}
# 0.1 is not a bf16 value: the bf16 chain rounds it.
CONSTANTS = (0.5, 1.0, 0.1)


def _flat_frames(value, h, w):
    """Two flat frames: ``value`` and 0.25."""
    return torch.from_numpy(np.stack([np.full((h, w), value, np.float32),
                                      np.full((h, w), 0.25, np.float32)]))


def test_flat_image_has_no_keypoints():
    kps, descs, counters = SIFT(64, 96, SiftConfig(**EDGE), device="cpu").extract(
        np.full((64, 96), 0.5, np.float32))
    assert int(kps.valid.sum()) == 0
    assert int(descs.valid.sum()) == 0
    assert int(counters["n_extrema"]) == 0
    assert int(counters["overflow"]) == 0


@pytest.mark.parametrize("value", CONSTANTS)
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_flat_slices_hold_one_value(route, value):
    """200x300 flat frames: every Gaussian slice and DoG of every octave
    holds one value a frame (the taps' fp32 sum is not exactly 1, so a
    slice's value may drift from the input's), and extraction finds no
    extremum. The parity route takes the fused seed and the one-shot
    octave here."""
    cfg = ROUTES[route]
    h, w = 200, 300
    if route in ("parity", "fast_bf16"):
        assert PP.seed_supports(cfg, h, w)
    if route == "parity":
        assert PP.supports(cfg, h)
    if route == "pallas_pyramid":
        assert 2 * h >= 256    # octave 0 takes the fused cascade
    frames = _flat_frames(value, h, w)
    n_oct = cfg.num_octaves(h, w)
    gaussians, dogs = build_pyramid_batch(frames, cfg, n_oct)
    assert len(gaussians) == n_oct
    for o, stacks in enumerate(zip(gaussians, dogs)):
        for kind, stack in zip(("gauss", "dog"), stacks):
            for b in range(2):
                for s in range(stack.shape[1]):
                    plane = stack[b, s]
                    assert bool((plane == plane[0, 0]).all()), (kind, o, b, s)
    for b in range(2):
        kps, descs, counters = SIFT(h, w, cfg, device="cpu").extract(frames[b].numpy())
        assert int(counters["n_extrema"]) == 0
        assert int(kps.valid.sum()) == 0 and int(descs.valid.sum()) == 0


def test_noise_image_runs_and_reports_overflow_honestly():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (64, 96)).astype(np.float32)
    cfg = SiftConfig(max_extrema_per_octave=256, max_keypoints=128, max_descriptors=256)
    kps, descs, counters = SIFT(64, 96, cfg, device="cpu").extract(img)
    # Pure noise produces many extrema; tight budgets must DROP and REPORT,
    # never crash or silently corrupt.
    assert int(counters["n_extrema"]) > 0
    n_valid = int(descs.valid.sum())
    assert 0 <= n_valid <= cfg.max_descriptors
    assert n_valid == int(counters["n_descriptors"])
    assert int(kps.valid.sum()) <= cfg.max_keypoints
    for key in ("overflow", "descriptor_overflow", "keypoint_overflow"):
        assert int(counters[key]) >= 0


def _both(butterfly, **budgets):
    """The butterfly's counters from the port and from the JAX package."""
    from siftmetal_tpu.config import SiftConfig as JConfig
    from siftmetal_tpu.sift.extract import SIFT as JSIFT

    h, w = butterfly.shape[:2]
    kps, descs, ctr = SIFT(h, w, SiftConfig(**budgets), device="cpu").extract(butterfly)
    _, _, jctr = JSIFT(h, w, JConfig(**budgets)).extract(butterfly)
    return kps, descs, {k: int(v) for k, v in ctr.items()}, {k: int(v) for k, v in jctr.items()}


def test_global_descriptor_overflow_is_counted(butterfly):
    """The global descriptor compaction saturates a 128-slot budget and
    counts what it drops: the JAX test's bar, and within 1 of the JAX
    package (its pyramid rounds elsewhere)."""
    _, descs, ctr, jctr = _both(butterfly, max_keypoints=2048, max_descriptors=128)
    n_valid = int(descs.valid.sum())
    assert n_valid == 128
    assert ctr["descriptor_overflow"] >= 1600 - 128
    assert abs(ctr["descriptor_overflow"] - jctr["descriptor_overflow"]) <= 1
    assert ctr["n_descriptors"] == n_valid


def test_global_keypoint_overflow_is_counted(butterfly):
    """The same for the global keypoint merge (~1300 keypoints, 64 slots)."""
    kps, _, ctr, jctr = _both(butterfly, max_keypoints=64, max_descriptors=256)
    assert int(kps.valid.sum()) == 64
    assert ctr["keypoint_overflow"] >= 1300 - 64
    assert abs(ctr["keypoint_overflow"] - jctr["keypoint_overflow"]) <= 1


def test_octave_shapes_guard_degenerate():
    """More octaves than the image holds is a clear error; the IPOL count
    always passes."""
    cfg = SiftConfig()
    n_ok = cfg.num_octaves(128, 128)
    shapes = cfg.octave_shapes(128, 128, n_ok)
    assert min(shapes[-1]) >= 4
    with pytest.raises(ValueError, match="max supported"):
        cfg.octave_shapes(128, 128, n_ok + 3)


@pytest.mark.parametrize("shape,sigma", [((2, 50, 70), 1.2489996), ((2, 7, 10), 4.6),
                                         ((1, 60, 80), 3.0901)])
def test_blur_stack_plain_is_blur(shape, sigma):
    """The plain band passes are ops/gaussian.py blur: the same taps in the
    same order, X then Y, bit for bit (a radius above the size included)."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))
    assert torch.equal(blur_stack(x, sigma), blur(x, sigma))


@pytest.mark.parametrize("delta_min", [0.5, 1.0])
def test_seed_slices_are_blurs_of_the_upsample(delta_min):
    """Fused-seed slice s is blur(upsample_bilinear_2x(gray), sigma_s) (no
    upsample at delta_min 1) bit for bit, so its slice 0 is the unfused
    route's seed image."""
    from siftmetal_tpu_torch.sift.pyramid import seed_image

    cfg = SiftConfig(delta_min=delta_min)
    rng = np.random.default_rng(10)
    gray = torch.from_numpy(rng.uniform(0, 1, (2, 45, 70)).astype(np.float32))
    g, d = PP.seed_octave_plain(gray, cfg)
    src = upsample_bilinear_2x(gray) if delta_min == 0.5 else gray
    for s, sigma in enumerate(PP._seed_sigmas(cfg)):
        assert torch.equal(g[:, s], blur(src, sigma)), s
    assert torch.equal(g[:, 0], seed_image(gray, cfg))
    assert torch.equal(d, g[:, 1:] - g[:, :-1])
