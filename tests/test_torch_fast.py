"""The fast preset of the port (bf16 blur chain, ``FAST_BF16_CONFIG``) held
against the JAX package on the CPU: the bf16 cascade and pyramid against
the XLA shift-add path, the bf16 one-shot octave and fused seed against
the Pallas kernel in interpret mode, and the slice as a whole (extract two
frames, match them) in both packages.

Where a blur rounds to bf16 the two packages round fp32 sums that may
differ in their last bit (the port folds the boundary reflection into its
tap tables), so now and then a sample lands on the other side of a bf16
rounding boundary: one bf16 ulp, 2^-8 relative, of the X-pass value. The
comparisons allow that on a small stated share of samples and hold the
rest to the fp32 tolerance."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from siftmetal_tpu.config import FAST_BF16_CONFIG as JFAST16
from siftmetal_tpu.ops.pallas import pyramid as JP
from siftmetal_tpu_torch import FAST_BF16_CONFIG, FAST_CONFIG, SIFT
from siftmetal_tpu_torch.match import match_bruteforce
from siftmetal_tpu_torch.ops.kernels import pyramid as PP
from siftmetal_tpu_torch.sift.batched import build_pyramid_batch
from siftmetal_tpu_torch.utils.io import load_image
from siftmetal_tpu_torch.utils.repeatability import keypoint_agreement, keypoint_array

from test_torch_match import assert_matches_equal, to_port_descriptors, to_port_matches

# Keep PyTorch's CPU pool small: the suite runs several test processes
# side by side, and oversubscribed pools slow every one of them down.
torch.set_num_threads(2)

BF16_ULP = 2.0 ** -8        # relative spacing of bf16
FLIP_SHARE = 0.02           # samples allowed to sit on a flipped rounding


def _assert_bf16_close(got, ref, what):
    """fp32 agreement (1e-5) on all but FLIP_SHARE of the samples, and no
    sample further off than one bf16 ulp of the largest value."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref)
    assert err.max() <= BF16_ULP * max(np.abs(ref).max(), 1.0), (what, err.max())
    assert (err > 1e-5).mean() <= FLIP_SHARE, (what, (err > 1e-5).mean())


def _bf16_round(a):
    """numpy fp32 -> the nearest bf16 values, as fp32."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("o,shape", [(1, (60, 80)), (4, (7, 10))])
def test_bf16_cascade_matches_jax(o, shape):
    """bf16 chain read, fp32 accumulators emitted: the slices of both
    packages, and the rounding points of the chain."""
    from siftmetal_tpu.sift.pyramid import cascade_slices as j_cascade
    from siftmetal_tpu_torch.sift.pyramid import cascade_slices

    rng = np.random.default_rng(3)
    first = _bf16_round(rng.uniform(0, 1, (2,) + shape).astype(np.float32))
    ref = [np.asarray(a) for a in j_cascade(jnp.asarray(first).astype(jnp.bfloat16), o, JFAST16)]
    got = cascade_slices(torch.from_numpy(first).to(torch.bfloat16), o, FAST_BF16_CONFIG)
    assert all(a.dtype == torch.float32 for a in got)
    assert all(a.dtype == np.float32 for a in ref)
    np.testing.assert_array_equal(got[0].numpy(), first)
    for s, (a, b) in enumerate(zip(got, ref)):
        _assert_bf16_close(a.numpy(), b, f"slice {s}")
    # Emitted slices are NOT bf16 values: the accumulator is un-rounded.
    assert np.abs(got[1].numpy() - _bf16_round(got[1].numpy())).max() > 0


def test_bf16_blur_rounding_points():
    """X pass: fp32 sum rounded once to bf16; Y pass: reads that bf16,
    returns fp32 un-rounded; taps stay fp32 (the reference's CPU path)."""
    from siftmetal_tpu.ops import gaussian as JG
    from siftmetal_tpu_torch.ops.kernels.blur import blur_stack

    rng = np.random.default_rng(8)
    img = _bf16_round(rng.uniform(0, 1, (1, 40, 56)).astype(np.float32))
    sigma = 1.2262
    ref = np.asarray(JG.blur(jnp.asarray(img).astype(jnp.bfloat16), sigma, out_dtype=jnp.float32))
    x16 = torch.from_numpy(img).to(torch.bfloat16)
    got = blur_stack(x16, sigma)
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    _assert_bf16_close(got.numpy(), ref, "blur")
    tab = PP.slice_taps((sigma,))
    mid = PP.band_x_plain(x16, tab, torch.bfloat16)
    assert mid.dtype == torch.bfloat16
    jmid = np.asarray(JG._conv1d_sym(jnp.asarray(img).astype(jnp.bfloat16),
                                     JG.gaussian_taps(sigma), axis=-1).astype(jnp.float32))
    flips = mid[:, 0].float().numpy() != jmid
    assert flips.mean() <= FLIP_SHARE
    assert np.abs(mid[:, 0].float().numpy() - jmid).max() <= BF16_ULP
    np.testing.assert_array_equal(
        got.numpy(), PP.band_y_plain(mid, tab, None, False)[0][:, 0].numpy()
    )


def test_bf16_pyramid_matches_jax():
    """``build_pyramid_batch`` under FAST_BF16_CONFIG at 2x96x128: below
    the fused-seed and one-shot gates, so both packages run seed blur +
    cascade in every octave, each octave seeded from the bf16-rounded
    slice of the one before."""
    from siftmetal_tpu.sift.batched import build_pyramid_batch as j_build

    rng = np.random.default_rng(12)
    base = rng.uniform(0, 1, (2, 12, 16)).astype(np.float32)
    gray = np.kron(base, np.ones((8, 8), np.float32)) + rng.normal(0, 0.02, (2, 96, 128)).astype(np.float32)
    gray = gray.clip(0, 1).astype(np.float32)
    n_oct = FAST_BF16_CONFIG.num_octaves(96, 128)
    assert not PP.seed_supports(FAST_BF16_CONFIG, 96, 128)
    jg, jd = j_build(jnp.asarray(gray), JFAST16, n_oct)
    pg, pd = build_pyramid_batch(torch.from_numpy(gray), FAST_BF16_CONFIG, n_oct)
    assert len(pg) == len(jg) == n_oct
    for o in range(n_oct):
        assert pg[o].dtype == torch.float32 and tuple(pg[o].shape) == jg[o].shape
        _assert_bf16_close(pg[o].numpy(), np.asarray(jg[o]), f"gauss {o}")
        # A DoG sample differs by at most the two slices' differences.
        err = np.abs(pd[o].numpy() - np.asarray(jd[o]))
        assert err.max() <= 2 * BF16_ULP and (err > 2e-5).mean() <= 2 * FLIP_SHARE, (o, err.max())


def test_bf16_oneshot_matches_pallas():
    """bf16-input one-shot octave vs the Pallas kernel in interpret mode
    on the same bf16 input (bf16x3 matrices on the JAX side, hence 2e-4
    as tests/test_pallas.py holds the fp32 form). No rounding between the
    passes; slice 0 and dog[0] use the input upcast."""
    rng = np.random.default_rng(7)
    first = _bf16_round(rng.uniform(0, 1, (1, 180, 140)).astype(np.float32))
    assert PP.supports(FAST_BF16_CONFIG, 180)
    jg, jd = JP.octave_oneshot_pallas(
        jnp.asarray(first).astype(jnp.bfloat16), JFAST16, interpret=True
    )
    pg, pd = PP.octave_oneshot(torch.from_numpy(first).to(torch.bfloat16), FAST_BF16_CONFIG)
    assert pg.dtype == torch.float32 and pg.shape == jg.shape and pd.shape == jd.shape
    np.testing.assert_array_equal(pg[:, 0].numpy(), first)
    assert np.abs(pg.numpy() - np.asarray(jg)).max() < 2e-4
    assert np.abs(pd.numpy() - np.asarray(jd)).max() < 2e-4
    # The same values as fp32 input give the same result: the input is
    # read exactly and nothing else is rounded.
    g32, d32 = PP.octave_oneshot(torch.from_numpy(first), FAST_BF16_CONFIG)
    np.testing.assert_array_equal(pg.numpy(), g32.numpy())
    np.testing.assert_array_equal(pd.numpy(), d32.numpy())


def test_bf16_seed_matches_pallas():
    """bf16-input fused seed (delta_min = 1) vs the Pallas kernel."""
    rng = np.random.default_rng(11)
    gray = _bf16_round(rng.uniform(0, 1, (1, 170, 250)).astype(np.float32))
    assert PP.seed_supports(FAST_BF16_CONFIG, 170, 250)
    jg, jd = JP.seed_octave_pallas(jnp.asarray(gray).astype(jnp.bfloat16), JFAST16, interpret=True)
    pg, pd = PP.seed_octave(torch.from_numpy(gray).to(torch.bfloat16), FAST_BF16_CONFIG)
    assert pg.shape == jg.shape and pd.shape == jd.shape
    assert np.abs(pg.numpy() - np.asarray(jg)).max() < 2e-4
    assert np.abs(pd.numpy() - np.asarray(jd)).max() < 2e-4


def test_band_passes_refuse_other_forms():
    x = torch.zeros((1, 8, 8))
    rhos = PP.oneshot_rhos(FAST_BF16_CONFIG)
    with pytest.raises(ValueError, match="form"):
        PP.separable_bands(x, rhos, None, False, "blur_stack", mid_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="form"):
        PP.separable_bands(x.to(torch.bfloat16), rhos, None, False, "blur_stack",
                           mid_dtype=torch.bfloat16, upsample=True)
    with pytest.raises(TypeError):
        PP.separable_bands(x.double(), rhos, None, False, "blur_stack")
    with pytest.raises(ValueError, match="pyramid_dtype"):
        import dataclasses

        build_pyramid_batch(x, dataclasses.replace(FAST_CONFIG, pyramid_dtype="float16"), 1)


@pytest.fixture(scope="module")
def frames():
    """Two overlapping 96x128 gray crops of the butterfly, 4 px apart."""
    import pathlib

    from siftmetal_tpu_torch.ops.image import rgb_to_gray

    img = load_image(str(pathlib.Path(__file__).resolve().parent / "fixtures" / "butterfly.ppm"))
    gray = rgb_to_gray(torch.from_numpy(img)).numpy()
    return gray[120:216, 200:328].copy(), gray[122:218, 204:332].copy()


def test_fast_bf16_slice_matches_jax(frames):
    """Extract two frames under FAST_BF16_CONFIG in both packages and
    match them: >= 90% keypoint agreement between the packages (both
    ways); against the port's own fp32 FAST run the agreement the JAX
    package has between its own two precisions (on crops this small the
    bf16 chain moves about a fifth of the fast preset's keypoints in both
    packages alike; the 90% bar of the full butterfly is held on the card);
    the port's matcher on the JAX package's descriptors reproduces its
    matches exactly; and the two packages' match sets name the same point
    pairs."""
    from siftmetal_tpu.config import FAST_CONFIG as JFAST
    from siftmetal_tpu.match import match_bruteforce as j_match
    from siftmetal_tpu.sift.extract import SIFT as JSIFT
    from siftmetal_tpu.utils.repeatability import keypoint_array as j_keypoint_array

    shape = frames[0].shape
    port = SIFT(*shape, config=FAST_BF16_CONFIG, device="cpu")
    port32 = SIFT(*shape, config=FAST_CONFIG, device="cpu")
    jsift = JSIFT(*shape, JFAST16)
    jsift32 = JSIFT(*shape, JFAST)
    pres, jres = [], []
    for f in frames:
        kp, ds, _ = port.extract(f)
        jkp, jds, _ = jsift.extract(jnp.asarray(f))
        k32, _, _ = port32.extract(f)
        pts, sig = keypoint_array(kp)
        jpts, jsig = j_keypoint_array(jkp)
        p32, s32 = keypoint_array(k32)
        assert len(pts) > 40
        assert keypoint_agreement(jpts, jsig, pts, shape, margin=0.0) >= 0.90
        assert keypoint_agreement(pts, sig, jpts, shape, margin=0.0) >= 0.90
        j32, js32 = j_keypoint_array(jsift32.extract(jnp.asarray(f))[0])
        own = keypoint_agreement(p32, s32, pts, shape, margin=0.0)
        theirs = keypoint_agreement(j32, js32, jpts, shape, margin=0.0)
        assert own >= 0.75 and abs(own - theirs) <= 0.02, (own, theirs)
        assert 0.9 <= len(pts) / len(jpts) <= 1.1
        pres.append(ds)
        jres.append(jds)

    jm = j_match(jres[0].features, jres[1].features, jres[0].valid, jres[1].valid)
    conv = [to_port_descriptors(d) for d in jres]
    same = match_bruteforce(conv[0].features, conv[1].features, conv[0].valid, conv[1].valid)
    assert_matches_equal(same, to_port_matches(jm))

    pm = match_bruteforce(pres[0].features, pres[1].features, pres[0].valid, pres[1].valid)

    def pairs(m, d0, d1):
        v = m.valid.numpy()
        t = m.target_idx.numpy()[v]
        return np.concatenate([
            np.stack([d0.x.numpy()[v], d0.y.numpy()[v]], 1),
            np.stack([d1.x.numpy()[t], d1.y.numpy()[t]], 1),
        ], 1)

    a, b = pairs(pm, *pres), pairs(same, *conv)
    assert len(a) > 15 and len(b) > 15
    # The frames are 2 rows and 4 columns apart.
    for rows in (a, b):
        assert np.median(np.abs(rows[:, 0] - rows[:, 2] - 2.0)) < 0.5
        assert np.median(np.abs(rows[:, 1] - rows[:, 3] - 4.0)) < 0.5
    d = np.abs(a[:, None, :] - b[None, :, :]).max(-1)
    assert (d.min(1) < 0.5).mean() >= 0.9 and (d.min(0) < 0.5).mean() >= 0.9
