"""The port's warp helpers (``siftmetal_tpu_torch.ops.warp``) against
``siftmetal_tpu.ops.warp`` on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from siftmetal_tpu.ops import warp as JW
from siftmetal_tpu_torch.ops import warp as PW
from siftmetal_tpu_torch.utils.io import load_image
from siftmetal_tpu_torch.utils.repeatability import standard_warp_battery

from conftest import FIXTURES

torch.set_num_threads(2)


def _crop():
    img = load_image(str(FIXTURES / "butterfly.ppm"))
    return np.ascontiguousarray(img[100:164, 200:296, 1])


def _tilt(shape):
    return dict(standard_warp_battery(shape))["tilt"]


WARPS = {
    "identity": lambda s: np.eye(3, dtype=np.float32),
    "translation": lambda s: np.array([[1, 0, 3.25], [0, 1, -7.5], [0, 0, 1]], np.float32),
    "similarity": lambda s: PW.similarity_homography(np.deg2rad(20.0), 0.95, (s[0] / 2, s[1] / 2)),
    "tilt": _tilt,
}


@pytest.mark.parametrize("name", sorted(WARPS))
def test_warp_perspective_matches_jax(name):
    """Bilinear warp of a 64 x 96 crop, zeros outside: 1e-5 (the same fp32
    arithmetic; products may fuse differently)."""
    img = _crop()
    h = WARPS[name](img.shape)
    got = PW.warp_perspective(torch.from_numpy(img), torch.from_numpy(h), img.shape)
    ref = np.asarray(JW.warp_perspective(jnp.asarray(img), jnp.asarray(h), img.shape))
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() < 1e-5
    if name == "identity":
        assert np.abs(got.numpy() - img).max() < 1e-6
    else:
        assert (got.numpy() == 0).any() or name == "tilt"     # uncovered pixels are zero
    # A numpy homography and another output shape; leading dimensions of
    # the image share the warp.
    small = PW.warp_perspective(torch.from_numpy(img), h, (40, 50))
    ref_s = np.asarray(JW.warp_perspective(jnp.asarray(img), jnp.asarray(h), (40, 50)))
    assert np.abs(small.numpy() - ref_s).max() < 1e-5
    both = PW.warp_perspective(torch.from_numpy(np.stack([img, img[::-1].copy()])), h, img.shape)
    assert both.shape == (2,) + img.shape and torch.equal(both[0], got)


def test_inv3x3_and_apply_homography_match_jax():
    rng = np.random.default_rng(0)
    for h in (WARPS["similarity"]((480, 640)), _tilt((480, 640)),
              rng.uniform(-1, 1, (3, 3)).astype(np.float32) + 2 * np.eye(3, dtype=np.float32)):
        got = PW.inv3x3(torch.from_numpy(h)).numpy()
        ref = np.asarray(JW.inv3x3(jnp.asarray(h)))
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got @ h, np.eye(3), atol=2e-4)
        pts = rng.uniform(0, 400, (50, 2)).astype(np.float32)
        np.testing.assert_allclose(
            PW.apply_homography(torch.from_numpy(h), torch.from_numpy(pts)).numpy(),
            np.asarray(JW.apply_homography(jnp.asarray(h), jnp.asarray(pts))),
            rtol=1e-5, atol=1e-4,
        )
    stack = torch.from_numpy(np.stack([WARPS["similarity"]((64, 96)), _tilt((64, 96))]))
    inv = PW.inv3x3(stack)
    assert inv.shape == (2, 3, 3) and torch.equal(inv[1], PW.inv3x3(stack[1]))
    # A vanishing third coordinate is clamped, not divided by zero.
    h0 = torch.tensor([[1.0, 0, 0], [0, 1, 0], [0, 0, 0]])
    out = PW.apply_homography(h0, torch.tensor([[1.0, 2.0]]))
    ref = np.asarray(JW.apply_homography(jnp.asarray(h0.numpy()), jnp.asarray([[1.0, 2.0]])))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)


def test_similarity_homography_and_quad_corners_match_jax():
    for args in ((0.3, 1.0, (10.0, 20.0)), (np.deg2rad(20.0), 0.95, (240.0, 320.0), (3.0, -4.0))):
        np.testing.assert_array_equal(PW.similarity_homography(*args), JW.similarity_homography(*args))
    np.testing.assert_array_equal(PW.quad_corners(480, 640), JW.quad_corners(480, 640))
    # The centre is the fixed point of a rotation about it.
    h = PW.similarity_homography(0.7, 1.3, (30.0, 40.0))
    c = PW.apply_homography(torch.from_numpy(h), torch.tensor([[30.0, 40.0]]))
    np.testing.assert_allclose(c.numpy(), [[30.0, 40.0]], atol=1e-4)
