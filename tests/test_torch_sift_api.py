"""The JAX ``sift`` package's public names in the port
(``siftmetal_tpu_torch/sift/__init__.py``): ``build_pyramid``,
``pyramid_from_rgb``, ``build_gaussian_octave``, ``detect_keypoints`` and
``gather_keypoints`` on one frame, against the JAX functions on the same
numpy inputs."""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import siftmetal_tpu.sift as JS
from siftmetal_tpu.config import SiftConfig as JConfig
from siftmetal_tpu.sift.pyramid import build_gaussian_octave as jbuild_gaussian_octave
from siftmetal_tpu.sift.pyramid import pyramid_from_rgb as jpyramid_from_rgb
from siftmetal_tpu_torch import sift as PS
from siftmetal_tpu_torch.config import SiftConfig
from siftmetal_tpu_torch.sift.batched import build_pyramid_batch
from siftmetal_tpu_torch.sift.detect import detect_all_octaves_batch
from siftmetal_tpu_torch.sift.pyramid import build_gaussian_octave, pyramid_from_rgb
from siftmetal_tpu_torch.utils.io import load_image

torch.set_num_threads(2)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"


@pytest.fixture(scope="module")
def crop():
    """A 64x96 RGB butterfly crop: both packages take the seed blur and
    the cascade there (no fused seed below 128 columns, no one-shot octave
    below 176 rows)."""
    return load_image(str(FIXTURES / "butterfly.ppm"))[150:214, 300:396]


def test_public_names_match_the_jax_sift_package():
    assert set(JS.__all__) <= set(PS.__all__)
    for name in JS.__all__:
        assert callable(getattr(PS, name)), name


@pytest.mark.parametrize("rgb", [False, True], ids=["gray", "rgb"])
def test_build_pyramid_matches_jax(crop, rgb):
    """One frame's (gaussians, dogs), [S, H_o, W_o] per octave, equal to
    the JAX build_pyramid / pyramid_from_rgb to 1e-5 (2e-5 for DoGs),
    tests/test_torch_bands.py's bound for the same route; and bit for bit
    the batched pyramid's frame."""
    cfg, jcfg = SiftConfig(), JConfig()
    n_oct = cfg.num_octaves(64, 96)
    gray = crop @ np.array([0.212639005871510, 0.715168678767756, 0.072192315360734],
                           np.float32)
    if rgb:
        pg, pd = pyramid_from_rgb(torch.from_numpy(crop), cfg, n_oct)
        jg, jd = jpyramid_from_rgb(jnp.asarray(crop), jcfg, n_oct)
    else:
        pg, pd = PS.build_pyramid(torch.from_numpy(gray), cfg, n_oct)
        jg, jd = JS.build_pyramid(jnp.asarray(gray), jcfg, n_oct)
    assert len(pg) == len(jg) == n_oct
    for o in range(n_oct):
        assert tuple(pg[o].shape) == jg[o].shape and tuple(pd[o].shape) == jd[o].shape
        assert np.abs(pg[o].numpy() - np.asarray(jg[o])).max() <= 1e-5, o
        assert np.abs(pd[o].numpy() - np.asarray(jd[o])).max() <= 2e-5, o
    if not rgb:
        bg, bd = build_pyramid_batch(torch.from_numpy(gray)[None], cfg, n_oct)
        assert all(torch.equal(a, b[0]) for a, b in zip(pg + pd, bg + bd))
        # build_gaussian_octave: octave 1 from its first slice, as the JAX one.
        stack = build_gaussian_octave(pg[1][0], 1, cfg)
        jstack = jbuild_gaussian_octave(jnp.asarray(pg[1][0].numpy()), 1, jcfg)
        assert tuple(stack.shape) == jstack.shape
        assert np.abs(stack.numpy() - np.asarray(jstack)).max() <= 1e-5
        assert torch.equal(stack, pg[1])


def test_detect_and_gather_keypoints_match_jax(crop):
    """detect_keypoints + gather_keypoints on the JAX package's DoGs of the
    crop: the port's one detection structure (kernel slots + cross-octave
    tail) against the JAX per-octave route: the counters both report equal,
    the gathered keypoints (octave, x, y, sigma) to 1e-4. The one-frame
    call equals frame 0 of the batched detection bit for bit."""
    cfg, jcfg = SiftConfig(), JConfig()
    n_oct = cfg.num_octaves(64, 96)
    gray = crop @ np.array([0.212639005871510, 0.715168678767756, 0.072192315360734],
                           np.float32)
    _, jdogs = JS.build_pyramid(jnp.asarray(gray), jcfg, n_oct)
    dogs = [torch.from_numpy(np.array(d)) for d in jdogs]

    per_octave, ctr = PS.detect_keypoints(dogs, cfg)
    kp, dropped = PS.gather_keypoints(per_octave, cfg)
    jper, jctr = JS.detect_keypoints(jdogs, jcfg)
    jkp, jdropped = JS.gather_keypoints(jper, jcfg)

    shared = set(ctr) & set(jctr)
    assert {"n_extrema", "n_interp", "n_border"} <= shared
    for key in shared:
        assert int(ctr[key]) == int(jctr[key]), key
    assert int(dropped) == int(jdropped) == 0

    def rows(k):
        sel = np.asarray(k.valid)
        r = np.stack([np.asarray(getattr(k, n))[sel] for n in ("octave", "x", "y", "sigma")], 1)
        return r[np.lexsort(r.T[::-1])]

    a, b = rows(kp), rows(jkp)
    assert a.shape == b.shape and a.shape[0] > 10
    np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)

    bper, bctr = detect_all_octaves_batch([d[None] for d in dogs], cfg)
    for one, batched in zip(per_octave, bper):
        for f, g in zip(one, batched):
            assert torch.equal(f, g[0])
    assert all(torch.equal(ctr[k], bctr[k][0]) for k in bctr)


def test_gather_keypoints_overflow_is_counted(crop):
    """A keypoint budget below the survivors: gather_keypoints keeps the
    first max_keypoints in octave order and counts the rest, as the JAX
    function does."""
    cfg = dataclasses.replace(SiftConfig(), max_keypoints=16)
    jcfg = dataclasses.replace(JConfig(), max_keypoints=16)
    gray = crop[..., 1].copy()
    n_oct = cfg.num_octaves(64, 96)
    _, jdogs = JS.build_pyramid(jnp.asarray(gray), jcfg, n_oct)
    per_octave, _ = PS.detect_keypoints([torch.from_numpy(np.array(d)) for d in jdogs], cfg)
    kp, dropped = PS.gather_keypoints(per_octave, cfg)
    total = sum(int(k.valid.sum()) for k in per_octave)
    assert total > 16 and int(kp.valid.sum()) == 16 and int(dropped) == total - 16
    assert kp.x.shape == (16,)
    jkp, jdropped = JS.gather_keypoints(JS.detect_keypoints(jdogs, jcfg)[0], jcfg)
    assert int(jdropped) == int(dropped) and int(np.asarray(jkp.valid).sum()) == 16
