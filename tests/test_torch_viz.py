"""The port's drawing (``siftmetal_tpu_torch/utils/viz.py``) against the
JAX package's ``utils/viz.py``: the same matplotlib calls, so each
drawing equals the JAX one pixel for pixel on the same inputs, whether
they come as tensors or as arrays."""

import numpy as np
import pytest
import torch

from siftmetal_tpu.utils import viz as JV
from siftmetal_tpu_torch.utils import viz as PV


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(11)
    h, w, n = 60, 90, 25
    return dict(
        image=rng.uniform(0, 1, (h, w)).astype(np.float32),
        rgb=rng.integers(0, 256, (h, w, 3)).astype(np.uint8),
        x=rng.uniform(0, h, n).astype(np.float32),
        y=rng.uniform(0, w, n).astype(np.float32),
        sigma=rng.uniform(0.5, 6, n).astype(np.float32),
        theta=rng.uniform(-np.pi, np.pi, n).astype(np.float32),
        valid=rng.random(n) < 0.7,
    )


def _t(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("with_theta", [False, True])
def test_draw_keypoints_equals_jax(scene, tmp_path, as_tensor, with_theta):
    args = {k: scene[k] for k in ("image", "x", "y", "sigma", "theta", "valid")}
    if not with_theta:
        args["theta"] = None
    want = JV.draw_keypoints(**args)
    if as_tensor:
        args = {k: (torch.from_numpy(v) if v is not None else None) for k, v in args.items()}
    got = PV.draw_keypoints(**args, path=str(tmp_path / "kp.png"))
    assert got.dtype == np.uint8 and got.shape == (60, 90, 3)
    np.testing.assert_array_equal(got, want)
    assert (tmp_path / "kp.png").stat().st_size > 0


@pytest.mark.parametrize("as_tensor", [False, True])
def test_draw_descriptors_equals_jax(scene, as_tensor):
    args = {k: scene[k] for k in ("rgb", "x", "y", "sigma", "theta", "valid")}
    want = JV.draw_descriptors(*args.values(), n_histograms=4)
    if as_tensor:
        args = _t(args)
    got = PV.draw_descriptors(*args.values(), n_histograms=4)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, PV.draw_descriptors(*args.values(), n_histograms=2))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_draw_matches_equals_jax(scene, as_tensor):
    xy = np.stack([scene["x"], scene["y"]], 1)
    rng = np.random.default_rng(12)
    image_b = rng.uniform(0, 1, (50, 70)).astype(np.float32)
    pairs = [(i, (i * 7) % len(xy)) for i in range(0, len(xy), 2)]
    want = JV.draw_matches(scene["image"], xy, image_b, xy * 0.7, pairs)
    args = [scene["image"], xy, image_b, xy * 0.7]
    if as_tensor:
        args = [torch.from_numpy(a) for a in args]
    got = PV.draw_matches(*args, pairs)
    assert got.shape == (60, 160, 3)
    np.testing.assert_array_equal(got, want)


def test_figure_for_an_image_equals_jax(scene):
    fig_p, fig_j = PV.plt_figure_for(scene["rgb"]), JV.plt_figure_for(scene["rgb"])
    try:
        np.testing.assert_array_equal(PV._figure_to_rgb(fig_p), JV._figure_to_rgb(fig_j))
        assert tuple(fig_p.get_size_inches()) == (0.9, 0.6)
    finally:
        import matplotlib.pyplot as plt

        plt.close(fig_p)
        plt.close(fig_j)
