"""The port's camera math, PnP and trajectory tools against the JAX
package on the same numpy inputs; PnP RANSAC on shared sample indices."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from siftmetal_tpu.slam import camera as JC
from siftmetal_tpu.slam import pnp as JP
from siftmetal_tpu.slam import trajectory as JTR
from siftmetal_tpu_torch.slam import camera as PC
from siftmetal_tpu_torch.slam import pnp as PP
from siftmetal_tpu_torch.slam import trajectory as PTR

torch.set_num_threads(2)


def T(a):
    return torch.tensor(np.asarray(a))


K = np.array([[450, 0, 320], [0, 450, 240], [0, 0, 1]], dtype=np.float32)


# --- camera ----------------------------------------------------------------------


def test_rodrigues_and_so3_log_match_jax_over_batches():
    """1e-5 against the JAX functions; round trips to 1e-4 (the JAX
    package's own bar), including theta = pi and theta -> 0."""
    rng = np.random.default_rng(0)
    w = rng.uniform(-1.5, 1.5, (10, 3)).astype(np.float32)
    axis = np.array([0.6, -0.8, 0.0], np.float32)
    special = np.stack([axis * np.pi, axis * (np.pi - 1e-3), [np.pi, 0, 0], [0, 0, np.pi],
                        axis * 1e-4, axis * 1e-7, [0, 0, 0], [0, 2.5, 0]]).astype(np.float32)
    w = np.concatenate([w, special])
    r = PC.rodrigues(T(w))
    assert r.shape == (len(w), 3, 3)
    back = PC.so3_log(r)
    for i in range(len(w)):
        rj = np.asarray(JC.rodrigues(jnp.asarray(w[i])))
        np.testing.assert_allclose(r[i].numpy(), rj, atol=1e-5)
        np.testing.assert_allclose(r[i].numpy() @ r[i].numpy().T, np.eye(3), atol=1e-5)
        np.testing.assert_allclose(back[i].numpy(), np.asarray(JC.so3_log(jnp.asarray(rj))), atol=1e-5)
        # At pi the axis sign is arbitrary: compare the rotations.
        np.testing.assert_allclose(PC.rodrigues(back[i]).numpy(), rj, atol=1e-4)
        np.testing.assert_allclose(PC.rodrigues(T(w[i])).numpy(), r[i].numpy(), atol=1e-6)   # batch == single
    np.testing.assert_allclose(back[:10].numpy(), w[:10], atol=1e-4)
    # Each of the four Shepperd cases (trace, m00, m11, m22 dominant).
    for wv in ([0.2, 0.1, -0.3], [3.0, 0.2, 0.1], [0.2, 3.0, 0.1], [0.1, 0.2, 3.0]):
        rj = JC.rodrigues(jnp.asarray(wv, dtype=jnp.float32))
        np.testing.assert_allclose(PC.so3_log(T(np.asarray(rj))).numpy(),
                                   np.asarray(JC.so3_log(rj)), atol=1e-5)


def test_transform_project_compose_inverse_relative_match_jax():
    rng = np.random.default_rng(1)
    cams = rng.uniform(-0.5, 0.5, (6, 6)).astype(np.float32)
    cams[:, 5] += 6.0
    x = rng.uniform(-1, 1, (6, 3)).astype(np.float32)
    a, b = cams[:3], cams[3:]
    jv = lambda fn, *args: np.asarray(jax.vmap(fn)(*(jnp.asarray(v) for v in args)))
    np.testing.assert_allclose(PC.transform(T(cams), T(x)).numpy(), jv(JC.transform, cams, x), atol=1e-5)
    uv = PC.project(T(cams), T(K), T(x)).numpy()
    np.testing.assert_allclose(
        uv, jv(lambda c, p: JC.project(c, jnp.asarray(K), p), cams, x), rtol=1e-5, atol=1e-3)
    # One camera against many points, and many cameras against many points.
    many = PC.project(T(cams[0]), T(K), T(x))
    assert many.shape == (6, 2) and np.allclose(many[0].numpy(), uv[0], atol=1e-4)
    assert PC.project(T(cams)[:, None], T(K), T(x)).shape == (6, 6, 2)
    np.testing.assert_allclose(PC.compose(T(a), T(b)).numpy(), jv(JC.compose, a, b), atol=1e-5)
    np.testing.assert_allclose(PC.inverse(T(a)).numpy(), jv(JC.inverse, a), atol=1e-5)
    np.testing.assert_allclose(PC.relative(T(a), T(b)).numpy(), jv(JC.relative, a, b), atol=1e-5)
    np.testing.assert_allclose(PC.compose(T(a), PC.inverse(T(a))).numpy(), np.zeros((3, 6)), atol=1e-5)
    rel = PC.relative(T(a), T(b))
    np.testing.assert_allclose(
        PC.transform(rel, PC.transform(T(a), T(x[:3]))).numpy(),
        PC.transform(T(b), T(x[:3])).numpy(), atol=1e-5)
    # A loop through yaw = pi composes without blowing up.
    half = T(np.array([0, 0, np.pi / 2, 0.1, 0, 0], np.float32))
    full = PC.compose(half, half)
    jfull = np.asarray(JC.compose(jnp.asarray(half.numpy()), jnp.asarray(half.numpy())))
    np.testing.assert_allclose(PC.rodrigues(full[:3]).numpy(),
                               np.asarray(JC.rodrigues(jnp.asarray(jfull[:3]))), atol=1e-5)
    np.testing.assert_allclose(full[3:].numpy(), jfull[3:], atol=1e-5)


# --- PnP ---------------------------------------------------------------------------


def pnp_scene():
    """The scene of tests/test_slam.py::test_pnp_ransac_recovers_pose."""
    rng = np.random.default_rng(11)
    n = 128
    pts = rng.uniform([-2, -2, 5], [2, 2, 10], (n, 3)).astype(np.float32)
    cam_true = np.array([0.1, -0.05, 0.2, 0.3, -0.1, 0.4], dtype=np.float32)
    uv = np.asarray(jax.vmap(lambda p: JC.project(jnp.asarray(cam_true), jnp.asarray(K), p))(
        jnp.asarray(pts)))
    uv_bad = uv.copy()
    uv_bad[:30] += rng.uniform(40, 120, (30, 2)).astype(np.float32)
    return pts, cam_true, uv, uv_bad


def test_pnp_dlt_matches_jax_on_shared_samples():
    """Six-point samples without repeats, on exact data: every hypothesis
    is the true camera; port and JAX agree to 2e-3 (a 12 x 12 null vector
    in fp32 from two SVD implementations), a batch equals its single
    solves."""
    pts, cam_true, uv, _ = pnp_scene()
    rng = np.random.default_rng(0)
    idx = np.stack([rng.choice(128, 6, replace=False) for _ in range(12)])
    got = PP.pnp_dlt(T(pts)[idx], T(uv)[idx], T(K))
    assert got.shape == (12, 6)
    ref = np.asarray(jax.vmap(lambda i: JP.pnp_dlt(jnp.asarray(pts)[i], jnp.asarray(uv)[i],
                                                   jnp.asarray(K)))(jnp.asarray(idx)))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-3)
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(cam_true, (12, 6)), atol=5e-3)
    one = PP.pnp_dlt(T(pts)[idx[3]], T(uv)[idx[3]], T(K))
    np.testing.assert_allclose(one.numpy(), got[3].numpy(), atol=1e-5)
    more = PP.pnp_dlt(T(pts)[:40], T(uv)[:40], T(K))           # over-determined
    np.testing.assert_allclose(more.numpy(), cam_true, atol=2e-3)


@pytest.mark.parametrize("n_iterations", [1, 2, 5])
def test_pnp_refine_matches_jax_step_for_step(n_iterations):
    """Forward-mode Jacobian, damped normal equations, accept-if-better:
    after 1, 2 and 5 steps the two packages hold the same camera (1e-4)."""
    pts, cam_true, uv, _ = pnp_scene()
    start = cam_true + np.array([0.02, -0.01, 0.015, 0.05, -0.04, 0.06], np.float32)
    wts = (np.arange(128) % 4 != 0).astype(np.float32)
    got = PP.pnp_refine(T(start), T(pts), T(uv), T(K), T(wts), n_iterations=n_iterations)
    ref = np.asarray(JP.pnp_refine(*(jnp.asarray(a) for a in (start, pts, uv, K, wts)),
                                   n_iterations=n_iterations))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    err = lambda c: np.abs(np.asarray(c) - cam_true).max()
    assert err(got.numpy()) < err(start)
    if n_iterations == 5:
        assert err(got.numpy()) < 1e-3


def jax_pnp_ransac_from_indices(idx, pts, uv, valid, k, sample_size=6, thr=3.0):
    """``siftmetal_tpu.slam.pnp.pnp_ransac`` after its sampling line."""
    idx, pts, uv, valid, k = map(jnp.asarray, (idx, pts, uv, valid, k))
    with jax.default_matmul_precision("highest"):
        models = jax.vmap(lambda i: JP.pnp_dlt(pts[i], uv[i], k))(idx)

    def count_inliers(cam):
        err = jax.vmap(lambda p, o: jnp.linalg.norm(JC.project(cam, k, p) - o))(pts, uv)
        inl = (err < thr) & valid
        return inl, jnp.sum(inl.astype(jnp.int32))

    inls, counts = jax.vmap(count_inliers)(models)
    best = jnp.argmax(counts)
    cam, inliers, n_in = models[best], inls[best], counts[best]
    with jax.default_matmul_precision("highest"):
        cam_r = JP.pnp_refine(cam, pts, uv, k, inliers.astype(jnp.float32))
    inl_r, n_r = count_inliers(cam_r)
    better = n_r >= n_in
    return (jnp.where(better, cam_r, cam), jnp.where(better, inl_r, inliers),
            jnp.where(better, n_r, n_in), int(best))


def test_pnp_ransac_shared_indices_and_recovery():
    """Shared indices: the same inlier mask and the camera within 1e-3;
    and the recovery bars of tests/test_slam.py (inliers > 97% of the
    clean points, < 5% of the outliers, camera within 5e-3), also with a
    seeded generator."""
    pts, cam_true, _, uv_bad = pnp_scene()
    valid = np.ones(128, bool)
    valid[-8:] = False
    rng = np.random.default_rng(5)
    idx = rng.choice(np.nonzero(valid)[0], (128, 6)).astype(np.int64)
    jcam, jinl, jn, _ = jax_pnp_ransac_from_indices(idx, pts, uv_bad, valid, K)
    res = PP.pnp_ransac_from_indices(T(idx), T(pts), T(uv_bad), T(valid), T(K))
    np.testing.assert_array_equal(res.inliers.numpy(), np.asarray(jinl))
    assert int(res.n_inliers) == int(jn) and bool(res.ok)
    np.testing.assert_allclose(res.model.numpy(), np.asarray(jcam), atol=1e-3)
    for r in (res, PP.pnp_ransac(torch.Generator().manual_seed(2), T(pts), T(uv_bad),
                                 T(valid), T(K))):
        inl = r.inliers.numpy()
        assert inl[30:120].mean() > 0.97 and inl[:30].mean() < 0.05 and not inl[120:].any()
        assert np.abs(r.model.numpy() - cam_true).max() < 5e-3
    few = np.zeros(128, bool)
    few[:5] = True
    res = PP.pnp_ransac(torch.Generator().manual_seed(0), T(pts), T(uv_bad), T(few), T(K),
                        n_hypotheses=8)
    assert not bool(res.ok) and int(res.n_inliers) == 0 and not res.inliers.any()


# --- trajectory ----------------------------------------------------------------------


def test_trajectory_tools_match_jax_package(tmp_path):
    """The port's numpy copy: equal results (camera centres 1e-6: the
    rotation comes from the port's own fp32 ``rodrigues``)."""
    rng = np.random.default_rng(3)
    cams = rng.uniform(-1, 1, (9, 6))
    np.testing.assert_allclose(PTR.camera_centers(cams), JTR.camera_centers(cams), atol=1e-6)
    src = rng.normal(size=(40, 3))
    rot = np.asarray(JC.rodrigues(jnp.asarray([0.3, -0.2, 0.5]))).astype(np.float64)
    dst = 1.7 * src @ rot.T + np.array([0.5, -1.0, 2.0]) + rng.normal(0, 0.01, (40, 3))
    for with_scale in (True, False):
        a, b = PTR.umeyama(src, dst, with_scale), JTR.umeyama(src, dst, with_scale)
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])
    assert abs(PTR.umeyama(src, dst)[0] - 1.7) < 0.01
    assert PTR.ate_rmse(src, dst) == JTR.ate_rmse(src, dst) < 0.05
    path = tmp_path / "traj.txt"
    path.write_text("# a comment\n\n1.0 0.1 0.2 0.3 0 0 0 1\n1.5 1.1 1.2 1.3 0 0 0 1\n")
    for a, b in zip(PTR.load_tum_trajectory(str(path)), JTR.load_tum_trajectory(str(path))):
        np.testing.assert_array_equal(a, b)
    ts_a = np.array([0.0, 0.5, 1.01, 2.0, 3.3])
    ts_b = np.array([0.01, 0.52, 1.0, 1.6, 2.015, 3.0])
    for a, b in zip(PTR.associate(ts_a, ts_b), JTR.associate(ts_a, ts_b)):
        np.testing.assert_array_equal(a, b)
    assert PTR.associate(ts_a, ts_b)[0].tolist() == [0, 2, 3]      # 0.5 vs 0.52 is just over max_dt
