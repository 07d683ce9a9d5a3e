"""The port's repeatability battery and its match-pair example on the CPU,
against the JAX package on the butterfly."""

import importlib.util
import pathlib

import numpy as np
import torch

from siftmetal_tpu.utils import repeatability as JR
from siftmetal_tpu_torch import SIFT
from siftmetal_tpu_torch.utils import repeatability as PR
from siftmetal_tpu_torch.utils.io import load_image

from conftest import FIXTURES

torch.set_num_threads(2)


def _gray():
    img = load_image(str(FIXTURES / "butterfly.ppm"))
    return (img[..., :3] @ np.array([0.2126, 0.7152, 0.0722], np.float32)).astype(np.float32)


def test_standard_warp_battery_and_repeatability_match_jax():
    """The battery's homographies are the JAX package's, bit for bit; the
    score function gives the same fraction on the same point sets."""
    for shape in ((480, 640), (340, 512)):
        mine, ref = PR.standard_warp_battery(shape), JR.standard_warp_battery(shape)
        assert [n for n, _ in mine] == [n for n, _ in ref] == ["rot15", "rot30", "scale0.8",
                                                               "scale1.25", "tilt"]
        for (_, a), (_, b) in zip(mine, ref):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    shape = (200, 300)
    pts_a = rng.uniform(0, 200, (400, 2)).astype(np.float32) * [1.0, 1.5]
    pts_a = pts_a.astype(np.float32)
    sig_a = rng.uniform(0.8, 12.0, 400).astype(np.float32)
    for name, h in PR.standard_warp_battery(shape):
        proj = np.c_[pts_a, np.ones(400)] @ h.T.astype(np.float64)
        pts_b = (proj[:, :2] / proj[:, 2:] + rng.normal(0, 1.2, (400, 2))).astype(np.float32)[::2]
        got = PR.repeatability(pts_a, sig_a, pts_b, h, shape)
        assert got == JR.repeatability(pts_a, sig_a, pts_b, h, shape), name
        assert 0.1 < got < 0.9
    eye = np.eye(3, dtype=np.float32)
    assert PR.keypoint_agreement(pts_a, sig_a, pts_a[::3], shape) == \
        JR.repeatability(pts_a, sig_a, pts_a[::3], eye, shape)
    assert np.isnan(PR.repeatability(pts_a, sig_a, pts_a[:0], eye, shape))
    assert np.isnan(PR.repeatability(pts_a + 1000, sig_a, pts_a, eye, shape))


def test_run_battery_butterfly_rot15_matches_jax():
    """``run_battery`` on the butterfly under rot15: at least 0.75, the
    JAX package's bar, and within 0.02 of the JAX package's own score (the
    two detect from slightly different pyramids; see
    tests/test_torch_extract.py)."""
    from siftmetal_tpu.sift.extract import SIFT as JSIFT

    gray = _gray()
    warps = [w for w in PR.standard_warp_battery(gray.shape) if w[0] == "rot15"]
    got = PR.run_battery(SIFT(*gray.shape, device="cpu"), gray, warps)
    assert set(got) == {"rot15"} and got["rot15"] >= 0.75, got
    ref = JR.run_battery(JSIFT(*gray.shape), gray, warps)
    assert abs(got["rot15"] - ref["rot15"]) <= 0.02, (got, ref)


def test_match_pair_example_on_cpu(capsys):
    """``examples/match_pair_torch.py`` (butterfly against itself rotated
    20 degrees and scaled 0.95) passes its own bars on the CPU."""
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / "match_pair_torch.py"
    spec = importlib.util.spec_from_file_location("match_pair_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    n_m, n_in, gscore = mod.main(device="cpu")
    assert n_m > 300 and n_in > 0.8 * n_m and gscore > 0.8
    out = capsys.readouterr().out
    for line in ("image B = A rotated 20deg, scaled 0.95", "descriptors: A", "putative matches:",
                 "geometry-consistency score:", "RANSAC homography inliers:"):
        assert line in out
