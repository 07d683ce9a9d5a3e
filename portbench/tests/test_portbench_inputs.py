"""The inputs repeat bit for bit for a seed and differ between seeds."""

import numpy as np
import torch

from portbench.harness.frames import procedural_frames
from portbench.harness.warp import view_homography, views, warp
from portbench.tests.conftest import small_cell


def test_frames_repeat_for_a_seed():
    a = procedural_frames(3, 48, 64, 2 ** 31 + 17, "cpu")
    b = procedural_frames(3, 48, 64, 2 ** 31 + 17, "cpu")
    c = procedural_frames(3, 48, 64, 2 ** 31 + 18, "cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert a.dtype == torch.float32 and float(a.min()) == 0.0 and float(a.max()) == 1.0
    assert torch.equal(torch.floor(a * 255.0), a * 255.0)


def test_seed_beyond_32_bits():
    assert procedural_frames(1, 16, 16, 2 ** 40 + 3, "cpu").shape == (1, 16, 16)


def test_warp_identity_and_rotation():
    f = procedural_frames(2, 40, 60, 5, "cpu")
    assert torch.allclose(warp(f, np.eye(3)), f)
    h = view_homography({"rotate_deg": 90.0}, (40, 60))
    p = h @ np.array([20.0, 30.0, 1.0])          # the centre stays
    assert np.allclose(p[:2] / p[2], [20.0, 30.0])
    names = [n for n, _ in views(small_cell("ipol_vga.pairs").traffic["views"], (40, 60))]
    assert names == ["rot15", "rot30", "scale0.8", "scale1.25", "tilt"]


def test_pair_inputs_repeat_for_a_seed():
    from portbench.harness.pairs import PairInputs

    cell = small_cell("ipol_vga.pairs", references=2)
    a = PairInputs(cell, 11, "cpu", 128)
    b = PairInputs(cell, 11, "cpu", 128)
    assert torch.equal(a.features, b.features) and torch.equal(a.xy, b.xy)
    assert a.pairs == b.pairs and len(a.pairs) == 2 * 2 * 5
    assert sum(p[2] for p in a.pairs) == 10
