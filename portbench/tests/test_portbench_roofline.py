"""The roofline counts against hand counts at small shapes."""

import math

import pytest
import torch

from portbench.reference.sift import Params
from portbench.roofline import describe, detect, peaks, pyramid


def taps(sigma):
    return 2 * math.ceil(4.0 * sigma) + 1


def test_pyramid_by_hand_two_octaves():
    # 2x seed of a 1x96x128 frame: octave 0 is 192x256 (seed route),
    # octave 1 96x128 (under 176 rows: the cascade).
    p = Params()
    nbytes, nops = pyramid.work(p, 96, 128, 1, 2)
    s = 6
    plane0, plane1 = 192 * 256, 96 * 128
    seed = [math.sqrt((sig / 0.5) ** 2 - 1.0) for sig in p.octave_sigmas(0)]
    rhos = p.incremental_sigmas(1)
    want_bytes = 4 * (96 * 128 + s * plane0 + (s - 1) * plane0) + 4 * (plane1 + s * plane1 + (s - 1) * plane1)
    want_ops = (4 * plane0 * sum(taps(x) for x in seed) + 5 * plane0
                + 4 * plane1 * sum(taps(x) for x in rhos) + 5 * plane1)
    assert nbytes == want_bytes
    assert nops == pytest.approx(want_ops, rel=0, abs=0)


def test_pyramid_takes_the_oneshot_route_from_176_rows():
    p = Params()
    # 480x640: octaves 1 (480 rows) and 2 (240 rows) one-shot, 3 on (120) cascade.
    one = sum(taps(r) for r in (math.sqrt(a * a - p.octave_sigmas(0)[0] ** 2) / 0.5
                                for a in p.octave_sigmas(0)[1:]))
    inc3 = sum(taps(r) for r in p.incremental_sigmas(3))
    _, ops3 = pyramid.work(p, 480, 640, 1, 3)
    _, ops4 = pyramid.work(p, 480, 640, 1, 4)
    assert ops4 - ops3 == 4 * 120 * 160 * inc3 + 5 * 120 * 160
    _, ops2 = pyramid.work(p, 480, 640, 1, 2)
    assert ops3 - ops2 == 4 * 240 * 320 * one + 5 * 240 * 320


def test_detect_by_hand():
    p = Params()
    nbytes, nops = detect.work(p, 96, 128, 2, 1, n_soft=10)
    # one octave of 192x256 with 5 DoG planes, 3 interior planes
    assert nbytes == 4 * 2 * 5 * 192 * 256 + 22 * 2 * 3 * 190 * 6
    assert nops == 56 * 2 * 3 * 190 * 254 + 100 * 10


def test_describe_counts_window_samples_by_hand():
    p = Params()
    # One keypoint of octave 0 at (50, 60) with sigma 1 (2 octave px):
    # the orientation box is |d| <= 3 * 1.5 * 2 = 9 octave px, 19 x 19.
    kp = {"valid": torch.tensor([True, False]), "octave": torch.tensor([0, 0]),
          "x": torch.tensor([25.0, 0.0]), "y": torch.tensor([30.0, 0.0]),
          "sigma": torch.tensor([1.0, 0.0])}
    assert describe.orientation_samples(p, 96, 128, kp, "cpu") == 19 * 19
    # Clipped at the top-left corner: rows 0..9, cols 0..9.
    kp["x"][0], kp["y"][0] = 0.0, 0.0
    assert describe.orientation_samples(p, 96, 128, kp, "cpu") == 10 * 10
    # A descriptor at theta 0: the box |d| < lambda (n+1)/n sigma = 7.5 * 2
    # = 15 octave px about the centre on the integer grid, 29 x 29.
    desc = {"valid": torch.tensor([True]), "octave": torch.tensor([0]),
            "x": torch.tensor([50.0]), "y": torch.tensor([60.0]),
            "sigma": torch.tensor([1.0]), "theta": torch.tensor([0.0])}
    assert describe.descriptor_samples(p, 96, 128, desc, "cpu") == 29 * 29


def test_least_seconds_picks_the_bound_and_the_part():
    assert peaks.peaks("NVIDIA H100 80GB HBM3") == peaks.PEAKS["SXM"]
    assert peaks.peaks("NVIDIA H100 PCIe") == peaks.PEAKS["PCIe"]
    assert peaks.least_seconds(3.35e12, 0.0, "H100 SXM") == pytest.approx(1.0)
    assert peaks.least_seconds(0.0, 67e12, "H100 SXM") == pytest.approx(1.0)
