"""The port's two-view geometry and RANSAC against the JAX package on the
scenes of tests/test_geometry.py. Everything random is shared: both sides
get the same numpy-made [H, S] sample indices (the JAX side through a thin
copy of its ``ransac`` body that takes them)."""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from siftmetal_tpu.geometry import twoview as JT
from siftmetal_tpu.geometry.ransac import RansacResult as JRansacResult
from siftmetal_tpu_torch import interop
import siftmetal_tpu_torch.geometry.ransac  # noqa: F401 (the module; the package exports the function)
from siftmetal_tpu_torch.geometry import twoview as PT

PR = sys.modules["siftmetal_tpu_torch.geometry.ransac"]

torch.set_num_threads(2)

def T(a):
    return torch.tensor(np.asarray(a))


def _rot(rx, ry, rz):
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (mz @ my @ mx).astype(np.float32)


def stereo_scene():
    """The scene of tests/test_geometry.py (seed 7)."""
    rng = np.random.default_rng(7)
    n = 200
    pts3 = rng.uniform([-2, -2, 4], [2, 2, 8], (n, 3)).astype(np.float32)
    k = np.array([[500, 0, 320], [0, 500, 240], [0, 0, 1]], dtype=np.float32)
    r = _rot(0.05, -0.1, 0.02)
    t = np.array([0.5, 0.05, 0.02], dtype=np.float32)

    def project(p, rr, tt):
        c = p @ rr.T + tt
        uv = c @ k.T
        return (uv[:, :2] / uv[:, 2:]).astype(np.float32)

    return pts3, k, r, t, project(pts3, np.eye(3, dtype=np.float32), np.zeros(3)), project(pts3, r, t)


def homography_scene(seed, n, h_true):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 400, (n, 2)).astype(np.float32)
    p = np.c_[src, np.ones(n)] @ np.asarray(h_true, np.float32).T
    return rng, src, (p[:, :2] / p[:, 2:]).astype(np.float32)


def _spread_samples(rng, n_points, n_samples, size):
    """Samples without repeated indices (well-conditioned for comparing
    single hypotheses)."""
    return np.stack([rng.choice(n_points, size, replace=False) for _ in range(n_samples)])


def _up_to_sign(a, ref):
    s = np.sign((a * ref).sum((-1, -2), keepdims=True))
    return a * s


def jax_ransac_from_indices(idx, a, b, valid, solver, error_fn, sample_size,
                            inlier_threshold=3.0, refit=True):
    """``siftmetal_tpu.geometry.ransac.ransac`` after its sampling line,
    on given indices."""
    idx, a, b, valid = map(jnp.asarray, (idx, a, b, valid))
    with jax.default_matmul_precision("highest"):
        models = jax.vmap(lambda i: solver(a[i], b[i]))(idx)

    def count_inliers(model):
        inl = (error_fn(model, a, b) < inlier_threshold) & valid
        return inl, jnp.sum(inl.astype(jnp.int32))

    inls, counts = jax.vmap(count_inliers)(models)
    best = jnp.argmax(counts)
    model, inliers, n_in = models[best], inls[best], counts[best]
    if refit:
        m = a.shape[0]
        order = jnp.nonzero(inliers, size=m, fill_value=0)[0]
        order = jnp.where(jnp.arange(m) < n_in, order, order[0])
        with jax.default_matmul_precision("highest"):
            refit_model = solver(a[order], b[order])
        refit_inl, refit_n = count_inliers(refit_model)
        better = refit_n >= n_in
        model = jnp.where(better, refit_model, model)
        inliers = jnp.where(better, refit_inl, inliers)
        n_in = jnp.where(better, refit_n, n_in)
    ok = jnp.sum(valid.astype(jnp.int32)) >= sample_size
    return JRansacResult(model=model, inliers=inliers & ok, n_inliers=n_in * ok, ok=ok), int(best)


# --- solvers and error functions ----------------------------------------------


def test_normalize_points_and_homography_match_jax():
    """H after the h[2,2] normalisation: 1e-4 (relative, +1e-4 absolute:
    two SVD implementations of the same 2K x 9 system in fp32); a batch of
    4-point hypotheses equals the JAX vmap of single solves."""
    h_true = [[1.1, 0.02, 5.0], [-0.03, 0.95, -3.0], [1e-4, -2e-4, 1.0]]
    rng, src, dst = homography_scene(0, 32, h_true)
    w = (np.arange(32) % 3 != 0).astype(np.float32)
    pn, tn = PT._normalize_points(T(src), T(w))
    jn, jt = JT._normalize_points(jnp.asarray(src), jnp.asarray(w))
    np.testing.assert_allclose(pn.numpy(), np.asarray(jn), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jt), rtol=1e-5, atol=1e-6)

    got = PT.homography_from_points(T(src), T(dst)).numpy()
    ref = np.asarray(JT.homography_from_points(jnp.asarray(src), jnp.asarray(dst)))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(h_true, np.float32), rtol=1e-3, atol=1e-3)
    assert PT.homography_transfer_error(T(got), T(src), T(dst)).max().item() < 0.1

    idx = _spread_samples(rng, 32, 16, 4)
    batch = PT.homography_from_points(T(src)[idx], T(dst)[idx])
    assert batch.shape == (16, 3, 3)
    jbatch = np.asarray(jax.vmap(lambda i: JT.homography_from_points(
        jnp.asarray(src)[i], jnp.asarray(dst)[i]))(jnp.asarray(idx)))
    errs = PT.homography_transfer_error(batch, T(src), T(dst)).numpy()          # [16, 32]
    jerrs = np.asarray(jax.vmap(lambda h: JT.homography_transfer_error(
        h, jnp.asarray(src), jnp.asarray(dst)))(jnp.asarray(jbatch)))
    assert errs.shape == (16, 32)
    # Minimal samples of exact data: every hypothesis is the true H; the
    # error matrices agree to 1e-3 relative (+ 0.02 px: a minimal solve in
    # fp32 is only that good).
    np.testing.assert_allclose(errs, jerrs, rtol=1e-3, atol=0.02)
    assert errs.max() < 0.1


def test_fundamental_sampson_essential_match_jax():
    """F up to sign (unit Frobenius norm, 1e-4); Sampson errors 1e-3
    relative (+1e-4 px^2); E = K^T F K projected, up to the same sign."""
    _, k, _, _, x1, x2 = stereo_scene()
    f = PT.fundamental_from_points(T(x1), T(x2)).numpy()
    fj = np.asarray(JT.fundamental_from_points(jnp.asarray(x1), jnp.asarray(x2)))
    np.testing.assert_allclose(np.linalg.norm(f), 1.0, rtol=1e-5)
    np.testing.assert_allclose(_up_to_sign(f, fj), fj, atol=1e-4)
    assert abs(np.linalg.det(f.astype(np.float64))) < 1e-8          # rank 2
    err = PT.sampson_error(T(f), T(x1), T(x2)).numpy()
    jerr = np.asarray(JT.sampson_error(jnp.asarray(f), jnp.asarray(x1), jnp.asarray(x2)))
    np.testing.assert_allclose(err, jerr, rtol=1e-3, atol=1e-4)
    assert np.median(err) < 0.5
    e = PT.essential_from_fundamental(T(f), T(k), T(k)).numpy()
    ej = np.asarray(JT.essential_from_fundamental(jnp.asarray(f), jnp.asarray(k), jnp.asarray(k)))
    np.testing.assert_allclose(e, ej, rtol=1e-3, atol=1e-3 * np.abs(ej).max())
    s = np.linalg.svd(e.astype(np.float64), compute_uv=False)
    assert abs(s[0] - s[1]) < 1e-4 * s[0] and s[2] < 1e-4 * s[0]
    # A batch of 8-point hypotheses: each equals its single solve.
    rng = np.random.default_rng(2)
    idx = _spread_samples(rng, 200, 6, 8)
    batch = PT.fundamental_from_points(T(x1)[idx], T(x2)[idx])
    for b, i in zip(batch, idx):
        one = PT.fundamental_from_points(T(x1)[i], T(x2)[i])
        np.testing.assert_allclose(_up_to_sign(b.numpy(), one.numpy()), one.numpy(), atol=1e-5)
        fj = np.asarray(JT.fundamental_from_points(jnp.asarray(x1[i]), jnp.asarray(x2[i])))
        # Through the error the model gives (its entries are ill-determined
        # for a minimal sample): the median over all points, 1e-3 px^2.
        a = np.median(PT.sampson_error(b, T(x1), T(x2)).numpy())
        c = np.median(np.asarray(JT.sampson_error(jnp.asarray(fj), jnp.asarray(x1), jnp.asarray(x2))))
        assert abs(a - c) < 1e-3 + 0.05 * c


def test_triangulate_decompose_recover_pose_match_jax():
    pts3, k, r_true, t_true, x1, x2 = stereo_scene()
    p1 = (k @ np.c_[np.eye(3), np.zeros(3)]).astype(np.float32)
    p2 = (k @ np.c_[r_true, t_true]).astype(np.float32)
    rec = PT.triangulate(T(p1), T(p2), T(x1), T(x2)).numpy()
    ref = np.asarray(JT.triangulate(*(jnp.asarray(a) for a in (p1, p2, x1, x2))))
    # Both within 0.01 of the true points (the JAX package's bar); of each
    # other within 5e-3: the 4 x 4 null vector of pixel-scaled rows in fp32.
    assert np.abs(rec - pts3).max() < 0.01 and np.abs(rec - ref).max() < 5e-3

    f = np.asarray(JT.fundamental_from_points(jnp.asarray(x1), jnp.asarray(x2)))
    e = np.asarray(JT.essential_from_fundamental(jnp.asarray(f), jnp.asarray(k), jnp.asarray(k)))
    rs, ts = PT.decompose_essential(T(e))
    jrs, jts = (np.asarray(a) for a in JT.decompose_essential(jnp.asarray(e)))
    assert rs.shape == (4, 3, 3) and ts.shape == (4, 3)
    for i in range(4):
        r = rs[i].numpy()
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-4)
        assert np.linalg.det(r) > 0.99
        # The SVD's signs may permute the four candidates: each of the
        # port's is one of the JAX package's (1e-4).
        d = [max(np.abs(r - jrs[j]).max(), np.abs(ts[i].numpy() - jts[j]).max()) for j in range(4)]
        assert min(d) < 1e-4, (i, d)

    kinv = np.linalg.inv(k)
    n1 = (np.c_[x1, np.ones(len(x1))] @ kinv.T)[:, :2].astype(np.float32)
    n2 = (np.c_[x2, np.ones(len(x2))] @ kinv.T)[:, :2].astype(np.float32)
    wts = np.ones(len(x1), np.float32)
    wts[:7] = 0.0
    r, t, n_front = PT.recover_pose(T(e), T(n1), T(n2), T(wts))
    jr, jt, jn = JT.recover_pose(*(jnp.asarray(a) for a in (e, n1, n2, wts)))
    # The same candidate: R and t to 1e-4, the same count in front.
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-4)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-4)
    assert float(n_front) == float(jn) == len(x1) - 7
    assert np.abs(r.numpy() - r_true).max() < 0.02
    t_dir, tt = t.numpy() / np.linalg.norm(t.numpy()), t_true / np.linalg.norm(t_true)
    assert min(np.linalg.norm(t_dir - tt), np.linalg.norm(t_dir + tt)) < 0.05


# --- RANSAC on shared indices -----------------------------------------------------


def _shared_indices(seed, valid, n_hyp, size):
    rng = np.random.default_rng(seed)
    return rng.choice(np.nonzero(valid)[0], (n_hyp, size)).astype(np.int64)


@pytest.mark.parametrize("refit", [True, False])
def test_ransac_homography_shared_indices(refit):
    """Same indices -> the same winning hypothesis, the same inlier mask,
    the model within 1e-3 (relative, +1e-3)."""
    h_true = [[0.9, 0.1, 10.0], [-0.05, 1.05, 20.0], [0, 0, 1.0]]
    rng, src, dst = homography_scene(1, 256, h_true)
    dst[:100] = rng.uniform(0, 400, (100, 2))          # 39% outliers
    valid = np.ones(256, bool)
    valid[-16:] = False
    dst[-16:] = np.nan                                 # garbage in padding slots
    idx = _shared_indices(10, valid, 128, 4)
    # The JAX side never reads a padded slot except through `& valid`.
    jres, jbest = jax_ransac_from_indices(
        idx, src, np.nan_to_num(dst), valid, JT.homography_from_points,
        JT.homography_transfer_error, 4, 3.0, refit)
    res = PR.ransac_from_indices(
        T(idx), T(src), T(dst), T(valid), PT.homography_from_points,
        PT.homography_transfer_error, 4, 3.0, refit)
    assert bool(res.ok) and res.inliers.dtype == torch.bool and res.n_inliers.dtype == torch.int32
    np.testing.assert_array_equal(res.inliers.numpy(), np.asarray(jres.inliers))
    assert int(res.n_inliers) == int(jres.n_inliers) == int(res.inliers.sum())
    np.testing.assert_allclose(res.model.numpy(), np.asarray(jres.model), rtol=1e-3, atol=1e-3)
    # The winner is the same hypothesis.
    models = PT.homography_from_points(T(src)[idx], T(np.nan_to_num(dst))[idx])
    counts = ((PT.homography_transfer_error(models, T(src), T(np.nan_to_num(dst))) < 3.0)
              & T(valid)).sum(-1)
    assert int(torch.argmax(counts)) == jbest
    inl = res.inliers.numpy()
    assert inl[100:240].mean() > 0.98 and inl[:100].mean() < 0.05 and not inl[240:].any()
    # The interop helpers carry the result across unchanged.
    back = interop.ransac_result_from_arrays(tuple(np.asarray(f) for f in jres))
    for a, b in zip(back, res):
        assert a.dtype == b.dtype and a.shape == b.shape
    again = JRansacResult(*interop.ransac_result_to_arrays(res))
    np.testing.assert_array_equal(again.inliers, np.asarray(jres.inliers))


def test_ransac_fundamental_shared_indices():
    _, k, _, _, x1, x2 = stereo_scene()
    rng = np.random.default_rng(3)
    x2n = x2.copy()
    x2n[:60] = rng.uniform(0, 640, (60, 2))
    valid = np.ones(200, bool)
    idx = _shared_indices(11, valid, 256, 8)
    jres, _ = jax_ransac_from_indices(idx, x1, x2n, valid, JT.fundamental_from_points,
                                      JT.sampson_error, 8, 2.0)
    res = PR.ransac_from_indices(T(idx), T(x1), T(x2n), T(valid), PT.fundamental_from_points,
                                 PT.sampson_error, 8, 2.0)
    inl, jinl = res.inliers.numpy(), np.asarray(jres.inliers)
    # Sampson errors of the two refits differ in the last digits; a point
    # within 1e-3 px^2 of the threshold may fall on either side.
    assert (inl != jinl).sum() <= 2
    assert inl[60:].mean() > 0.95 and inl[:60].mean() < 0.1
    f, fj = res.model.numpy(), np.asarray(jres.model)
    np.testing.assert_allclose(_up_to_sign(f, fj), fj, atol=1e-3)


def test_degenerate_samples_never_win():
    """Samples of one repeated index give a degenerate (possibly NaN)
    model: zero or few inliers, and a real model beats them."""
    h_true = [[1.0, 0.0, 4.0], [0.0, 1.0, -6.0], [0, 0, 1.0]]
    _, src, dst = homography_scene(4, 64, h_true)
    valid = np.ones(64, bool)
    idx = np.repeat(np.arange(16)[:, None], 4, 1)          # all degenerate
    idx[11] = [3, 17, 40, 58]                              # one real sample
    res = PR.ransac_from_indices(T(idx), T(src), T(dst), T(valid), PT.homography_from_points,
                                 PT.homography_transfer_error, 4, 3.0, refit=False)
    assert int(res.n_inliers) == 64
    np.testing.assert_allclose(res.model.numpy(), np.asarray(h_true, np.float32), atol=1e-2)


# --- properties on the port alone, with a seeded generator ---------------------


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_find_homography_rejects_outliers():
    h_true = [[0.9, 0.1, 10.0], [-0.05, 1.05, 20.0], [0, 0, 1.0]]
    rng, src, dst = homography_scene(1, 256, h_true)
    dst[:100] = rng.uniform(0, 400, (100, 2))
    valid = np.ones(256, bool)
    valid[-16:] = False
    res = PR.find_homography(_gen(0), T(src), T(dst), T(valid))
    inl = res.inliers.numpy()
    assert bool(res.ok)
    assert inl[100:240].mean() > 0.98 and inl[:100].mean() < 0.05
    again = PR.find_homography(_gen(0), T(src), T(dst), T(valid))
    assert torch.equal(again.inliers, res.inliers) and torch.equal(again.model, res.model)


def test_refit_ignores_gross_outlier_at_index_0():
    """The refit pads its inlier list by repeating the FIRST INLIER; a
    gross outlier at array index 0 must not poison it."""
    h_true = [[1.05, 0.05, 8.0], [-0.02, 0.98, -5.0], [0, 0, 1.0]]
    rng, src, dst = homography_scene(5, 64, h_true)
    dst[1:24] += rng.normal(0, 0.5, (23, 2)).astype(np.float32)
    dst[0] = [9000.0, -9000.0]
    dst[24:40] = rng.uniform(0, 400, (16, 2))
    valid = np.ones(64, bool)
    valid[40:] = False
    run = lambda refit: PR.ransac(
        _gen(3), T(src), T(dst), T(valid), PT.homography_from_points,
        PT.homography_transfer_error, sample_size=4, n_hypotheses=64,
        inlier_threshold=3.0, refit=refit)
    res_no, res = run(False), run(True)
    true_inl = np.zeros(64, bool)
    true_inl[1:24] = True
    mean_err = lambda m: PT.homography_transfer_error(m, T(src), T(dst)).numpy()[true_inl].mean()
    assert not bool(res.inliers[0])
    assert int(res.n_inliers) >= int(res_no.n_inliers)
    assert mean_err(res.model) <= mean_err(res_no.model) + 1e-3
    assert mean_err(res.model) < 1.5


@pytest.mark.parametrize("n_valid", [0, 3, 4])
def test_ok_is_false_under_sample_size_valid_points(n_valid):
    _, src, dst = homography_scene(6, 32, np.eye(3))
    valid = np.zeros(32, bool)
    valid[5:5 + n_valid] = True
    res = PR.find_homography(_gen(1), T(src), T(dst), T(valid), n_hypotheses=16)
    assert bool(res.ok) == (n_valid >= 4)
    if n_valid < 4:
        assert int(res.n_inliers) == 0 and not res.inliers.any()
    idx = PR._sample_indices(_gen(2), 64, 4, T(valid))
    assert idx.shape == (64, 4)
    if n_valid:
        assert set(idx.flatten().tolist()) <= set(range(5, 5 + n_valid))


def test_find_fundamental_rejects_outliers():
    _, k, _, _, x1, x2 = stereo_scene()
    rng = np.random.default_rng(3)
    x2n = x2.copy()
    x2n[:60] = rng.uniform(0, 640, (60, 2))
    res = PR.find_fundamental(_gen(1), T(x1), T(x2n), torch.ones(200, dtype=torch.bool))
    inl = res.inliers.numpy()
    assert inl[60:].mean() > 0.95 and inl[:60].mean() < 0.1
