"""The port's orientation and descriptor stages (plain patch histograms,
smoothing, peaks, quantization) held against the JAX package's XLA path
and its Pallas patch kernels in interpret mode."""

import numpy as np
import torch

import jax.numpy as jnp

from siftmetal_tpu.config import SiftConfig as JConfig
from siftmetal_tpu.sift import describe as JDS
from siftmetal_tpu_torch.config import SiftConfig
from siftmetal_tpu_torch.ops.kernels.patches import (
    descriptor_lanes,
    orientation_hist_lanes,
    prepare_patch_fields,
)
from siftmetal_tpu_torch.sift import describe as PDS

# Keep PyTorch's CPU pool small: the suite runs several test processes
# side by side, and oversubscribed pools slow every one of them down.
torch.set_num_threads(2)

CFG = SiftConfig()
JCFG = JConfig()


def _lanes(seed, b=1, h=96, w=160, n=16):
    """Random Gaussian stacks [b, S, h, w] and n keypoint lanes, some near
    the border so their patches leave the image."""
    rng = np.random.default_rng(seed)
    s = CFG.n_gaussians_per_octave
    gauss = rng.uniform(0, 1, (b, s, h, w)).astype(np.float32)
    lanes = dict(
        scale=rng.integers(1, CFG.n_scales_per_octave + 1, n).astype(np.int32),
        x=np.concatenate([rng.uniform(20, h - 20, n - 4), [1.2, h - 2.3, 30.0, 40.0]]).astype(np.float32),
        y=np.concatenate([rng.uniform(20, w - 20, n - 4), [50.0, 60.0, 0.7, w - 1.6]]).astype(np.float32),
        sigma=rng.uniform(1.7, 3.6, n).astype(np.float32),
        theta=rng.uniform(-3, 3, n).astype(np.float32),
        frame=rng.integers(0, b, n).astype(np.int32),
    )
    return gauss, lanes


def _t(a):
    return torch.tensor(np.array(a))


def _jax_orientation(gauss_f, lanes, sel):
    """JAX ``orientation_hists_xla`` of one frame's lanes ``sel``."""
    return np.asarray(JDS.orientation_hists_xla(
        jnp.asarray(gauss_f),
        *(jnp.asarray(lanes[k][sel]) for k in ("scale", "x", "y", "sigma")), JCFG,
    ))


def test_orientation_plain_matches_xla_and_pallas():
    from siftmetal_tpu.ops.pallas.patches import (
        orientation_hist_lanes_pallas,
        prepare_patch_fields as j_fields,
    )

    gauss, ln = _lanes(0)
    fields = prepare_patch_fields(_t(gauss), CFG)
    got = orientation_hist_lanes(
        fields, _t(ln["scale"]), _t(ln["x"]), _t(ln["y"]), _t(ln["sigma"]), CFG
    ).numpy()
    ref = _jax_orientation(gauss[0], ln, slice(None))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())

    pal = np.asarray(orientation_hist_lanes_pallas(
        j_fields(jnp.asarray(gauss[0]), JCFG),
        *(jnp.asarray(ln[k]) for k in ("scale", "x", "y", "sigma")), JCFG,
        interpret=True,
    ))
    denom = np.abs(pal).max(axis=1, keepdims=True) + 1e-9
    assert (np.abs(pal - got) / denom).max() < 5e-3


def test_descriptor_plain_matches_xla():
    gauss, ln = _lanes(1)
    fields = prepare_patch_fields(_t(gauss), CFG)
    raw = descriptor_lanes(
        fields, _t(ln["scale"]), _t(ln["x"]), _t(ln["y"]), _t(ln["sigma"]),
        _t(ln["theta"]), CFG,
    )
    got = PDS.quantize_descriptors(raw, CFG).numpy().astype(np.int32)
    ref = np.asarray(JDS.descriptor_lanes(
        jnp.asarray(gauss[0]),
        *(jnp.asarray(ln[k]) for k in ("scale", "x", "y", "sigma", "theta")), JCFG,
    )).astype(np.int32)
    assert np.abs(got - ref).max() <= 1
    assert (got != ref).mean() < 0.01


def test_patch_lanes_batched_frames_and_validity():
    """Lanes of two frames in one call, invalid lanes (with garbage
    coordinates) zeroed; each valid lane equals the JAX single-frame
    result of its own frame."""
    gauss, ln = _lanes(2, b=2)
    rng = np.random.default_rng(5)
    valid = rng.random(16) > 0.3
    x = np.where(valid, ln["x"], 1e6).astype(np.float32)
    fields = prepare_patch_fields(_t(gauss), CFG)
    args = (_t(ln["scale"]), _t(x), _t(ln["y"]), _t(ln["sigma"]))
    hist = orientation_hist_lanes(fields, *args, CFG, valid=_t(valid), frame=_t(ln["frame"])).numpy()
    raw = descriptor_lanes(fields, *args, _t(ln["theta"]), CFG, valid=_t(valid),
                           frame=_t(ln["frame"]))
    feats = PDS.quantize_descriptors(raw, CFG).numpy().astype(np.int32)
    assert (hist[~valid] == 0).all() and (raw.numpy()[~valid] == 0).all()
    for f in range(2):
        sel = valid & (ln["frame"] == f)
        ref = _jax_orientation(gauss[f], ln, sel)
        np.testing.assert_allclose(hist[sel], ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
        dref = np.asarray(JDS.descriptor_lanes(
            jnp.asarray(gauss[f]),
            *(jnp.asarray(ln[k][sel]) for k in ("scale", "x", "y", "sigma", "theta")), JCFG,
        )).astype(np.int32)
        assert np.abs(feats[sel] - dref).max() <= 1


def test_smoothing_peaks_quantization_match_jax():
    rng = np.random.default_rng(4)
    hist = rng.uniform(0, 1, (64, 36)).astype(np.float32)
    hist[:8] = 0.0
    hist[:8, [3, 20]] = 1.0          # exact ties: lower bin first
    hist[8:12, :] = 0.5              # flat: no peak at all
    sm_p = PDS._smooth_circular(_t(hist), 6)
    sm_j = JDS._smooth_circular(jnp.asarray(hist), 6)
    np.testing.assert_allclose(sm_p.numpy(), np.asarray(sm_j), rtol=1e-6)
    for h in (hist, np.asarray(sm_j)):
        th_p, ok_p = PDS.orientation_peaks(_t(h), CFG)
        th_j, ok_j = JDS.orientation_peaks(jnp.asarray(h), JCFG)
        np.testing.assert_array_equal(ok_p.numpy(), np.asarray(ok_j))
        np.testing.assert_allclose(
            np.where(ok_p.numpy(), th_p.numpy(), 0), np.where(ok_j, th_j, 0), atol=1e-6
        )
    raw = rng.uniform(0, 1, (32, 128)).astype(np.float32) ** 4
    raw[0] = 0.0
    q_p = PDS.quantize_descriptors(_t(raw), CFG).numpy().astype(np.int32)
    q_j = np.asarray(JDS.quantize_descriptors(jnp.asarray(raw), JCFG)).astype(np.int32)
    assert q_p.dtype == np.int32 and np.abs(q_p - q_j).max() <= 1
    g = rng.uniform(0, 1, (2, 3, 20, 30)).astype(np.float32)
    for a, b in zip(PDS.gradients(_t(g)), JDS.gradients(jnp.asarray(g))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))



def test_peakless_orientations_are_zero_and_padding_finite():
    """A flat (all-zero or constant) histogram has no peak: its theta slots
    are 0, not the parabola's 0/0, so the compactions that copy them into
    the outputs' padding keep every field finite. A frame with large flat
    areas (blobs on a grey plane, half of it blank) extracts with finite
    values in every slot, valid or not."""
    hist = np.zeros((3, 36), np.float32)
    hist[1] = 0.5
    hist[2, 7] = 1.0
    th, ok = PDS.orientation_peaks(torch.from_numpy(hist), CFG)
    assert ok.numpy().tolist() == [[False] * 4, [False] * 4, [True, False, False, False]]
    assert bool(torch.isfinite(th).all()) and float(th[:2].abs().max()) == 0.0
    from siftmetal_tpu_torch import SIFT

    rng = np.random.default_rng(8)
    img = np.full((96, 128), 0.5, np.float32)
    yy, xx = np.mgrid[0:96, 0:128]
    for cy, cx, r, a in zip(rng.uniform(8, 88, 12), rng.uniform(8, 60, 12),
                            rng.uniform(2, 5, 12), rng.choice([-0.3, 0.3], 12)):
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
    kps, descs, _ = SIFT(96, 128, device="cpu").extract(np.clip(img, 0, 1))
    assert int(descs.valid.sum()) > 0
    for t in (kps.x, kps.y, kps.sigma, descs.x, descs.y, descs.sigma, descs.theta):
        assert bool(torch.isfinite(t).all())
