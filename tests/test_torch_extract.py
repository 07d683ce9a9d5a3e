"""The port's whole extraction on the CPU: against the JAX package's
``SIFT.extract`` on a butterfly crop, batched against single-frame, and
the full butterfly against the IPOL fixtures."""

import pathlib

import numpy as np
import pytest
import torch

from siftmetal_tpu_torch import SIFT, SiftConfig
from siftmetal_tpu_torch.utils.io import load_image

# Keep PyTorch's CPU pool small: the suite runs several test processes
# side by side, and oversubscribed pools slow every one of them down.
torch.set_num_threads(2)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"

# IPOL stage counts for butterfly.png (tests/test_detect.py).
IPOL_COUNTS = {
    "n_extrema": 3068,
    "n_soft": 2130,
    "n_interp": 1934,
    "n_hard": 1769,
    "n_edge": 1304,
    "n_border": 1304,
}


@pytest.fixture(scope="module")
def butterfly():
    return load_image(str(FIXTURES / "butterfly.ppm"))


def _np(named):
    return {k: np.asarray(v) for k, v in named._asdict().items()}


def test_crop_matches_jax_extract(butterfly):
    """At 64x96 both packages take the cascade (no fused seed below 128
    columns, no one-shot octave below 176 rows): the same keypoints, and
    descriptors within one quantization step."""
    import jax.numpy as jnp

    from siftmetal_tpu.config import SiftConfig as JConfig
    from siftmetal_tpu.sift.extract import SIFT as JSIFT

    small = butterfly[:64, :96]
    kp, ds, ctr = SIFT(64, 96, SiftConfig(), device="cpu").extract(small)
    jkp, jds, jctr = JSIFT(64, 96, JConfig()).extract(jnp.asarray(small))
    for key, v in jctr.items():
        assert int(ctr[key]) == int(v), key

    def kp_rows(k):
        sel = k["valid"]
        return np.stack([k["octave"][sel], k["x"][sel], k["y"][sel], k["sigma"][sel]], 1)

    a, b = kp_rows(_np(kp)), kp_rows(_np(jkp))
    assert a.shape == b.shape and a.shape[0] > 10
    a, b = a[np.lexsort(a.T[::-1])], b[np.lexsort(b.T[::-1])]
    np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)

    def desc_rows(d):
        sel = d["valid"]
        key = np.stack([d["octave"][sel], d["x"][sel], d["y"][sel], d["theta"][sel]], 1)
        order = np.lexsort(np.round(key, 3).T[::-1])
        return key[order], d["features"][sel][order].astype(np.int32)

    (ka, fa), (kb, fb) = desc_rows(_np(ds)), desc_rows(_np(jds))
    assert ka.shape == kb.shape
    np.testing.assert_allclose(ka, kb, atol=1e-4, rtol=0)
    assert fa.dtype == fb.dtype
    diff = np.abs(fa - fb)
    assert (diff <= 1).mean() >= 0.99, (diff <= 1).mean()


def test_batched_extract_matches_single(butterfly):
    small = butterfly[:64, :96]
    sift = SIFT(64, 96, SiftConfig(), device="cpu")
    k1, d1, c1 = sift.extract(small)
    kb, db, cb = sift.extract_batch(np.stack([small, small[::-1].copy()]))
    for name, a in k1._asdict().items():
        np.testing.assert_array_equal(getattr(kb, name)[0].numpy(), a.numpy(), err_msg=name)
    for name, a in d1._asdict().items():
        np.testing.assert_array_equal(getattr(db, name)[0].numpy(), a.numpy(), err_msg=name)
    for key, v in c1.items():
        assert int(cb[key][0]) == int(v), key
    assert d1.features.dtype.is_floating_point is False and d1.features.shape[-1] == 128


def test_butterfly_meets_ipol_bounds(butterfly):
    """The full butterfly through the port on the CPU (fused seed and
    one-shot octaves, as on the card) meets the IPOL parity bounds of
    tests/test_detect.py and tests/test_describe.py."""
    from conftest import load_keypoint_list

    kp, ds, ctr = SIFT(340, 512, SiftConfig(), device="cpu").extract(butterfly)
    ctr = {k: int(v) for k, v in ctr.items()}
    assert ctr["overflow"] == 0 and ctr["descriptor_overflow"] == 0
    assert ctr["keypoint_overflow"] == 0
    for stage, expected in IPOL_COUNTS.items():
        assert abs(ctr[stage] - expected) <= max(10, 0.01 * expected), (stage, ctr[stage])

    k = _np(kp)
    sel = k["valid"]
    pts = np.stack([k["x"][sel], k["y"][sel]], 1)
    ref = load_keypoint_list("extra_OnEdgeResp_butterfly.txt")
    d2 = ((pts[None] - ref[:, None, :2]) ** 2).sum(-1)
    nearest = d2.argmin(1)
    matched = np.sqrt(d2[np.arange(len(ref)), nearest]) < 0.1
    assert matched.mean() >= 0.995, matched.mean()
    sig_err = np.abs(k["sigma"][sel][nearest[matched]] - ref[matched, 2]) / ref[matched, 2]
    assert np.quantile(sig_err, 0.99) < 1e-3

    d = _np(ds)
    sel = d["valid"]
    fx = np.loadtxt(str(FIXTURES / "butterfly-descriptors.txt"))
    assert abs(int(sel.sum()) - len(fx)) <= 0.05 * len(fx)
    pts = np.stack([d["x"][sel], d["y"][sel]], 1)
    theta, feats = d["theta"][sel], d["features"][sel]
    d2 = ((pts[None] - fx[:, None, :2]) ** 2).sum(-1)
    dth = np.abs(np.mod(theta[None] - fx[:, 3, None] + np.pi, 2 * np.pi) - np.pi)
    dth = np.where(d2 < 0.05 ** 2, dth, np.inf)
    nearest = dth.argmin(1)
    matched = dth[np.arange(len(fx)), nearest] < 0.05
    assert matched.mean() >= 0.93, matched.mean()
    q = feats[nearest[matched]].astype(np.float64)
    q_ref = fx[matched, 4:132]
    rel = np.linalg.norm(q - q_ref, axis=1) / np.linalg.norm(q_ref, axis=1)
    assert np.quantile(rel, 0.5) < 0.01
    assert (rel < 0.1).mean() >= 0.98
