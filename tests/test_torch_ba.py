"""The port's bundle adjustment and pose graph against the JAX package on
the same numpy inputs (``siftmetal_tpu_torch/slam/{ba,pose_graph}.py``),
with the tolerance stated in each test, and held to the bars of
tests/test_slam.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from siftmetal_tpu.slam import ba as JB
from siftmetal_tpu.slam import pose_graph as JG
from siftmetal_tpu.slam.camera import project as jproject
from siftmetal_tpu.slam.camera import relative as jrelative
from siftmetal_tpu_torch.slam import ba as PB
from siftmetal_tpu_torch.slam import pose_graph as PG

torch.set_num_threads(2)

K = np.array([[400, 0, 320], [0, 400, 240], [0, 0, 1]], dtype=np.float32)


def T(a):
    return torch.tensor(np.asarray(a))


def _uv(cams, lms, cam_idx, lm_idx, k=K):
    return np.asarray(jax.vmap(lambda c, l: jproject(c, jnp.asarray(k), l))(
        jnp.asarray(cams)[cam_idx], jnp.asarray(lms)[lm_idx]))


def _problems(args, fixed):
    """The same numpy problem as a JAX and as a port BAProblem."""
    return (JB.BAProblem(*map(jnp.asarray, args), fixed_cameras=fixed),
            PB.BAProblem(*map(T, args), fixed_cameras=fixed))


def _rel_close(got, want, rtol, what):
    """|got - want| <= rtol * max|want| (elementwise against the largest)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rtol, f"{what}: {err:.3e} of its largest value > {rtol:.0e}"


@pytest.fixture(scope="module")
def ba_scene():
    """tests/test_slam.py's ba_scene: 6 cameras each seeing all 256
    landmarks."""
    rng = np.random.default_rng(42)
    n_cam, n_lm = 6, 256
    lms = rng.uniform([-3, -3, 6], [3, 3, 12], (n_lm, 3)).astype(np.float32)
    cams = np.zeros((n_cam, 6), dtype=np.float32)
    cams[:, 3] = np.linspace(-1, 1, n_cam)
    cams[:, :3] = rng.uniform(-0.05, 0.05, (n_cam, 3))
    cam_idx = np.repeat(np.arange(n_cam), n_lm).astype(np.int32)
    lm_idx = np.tile(np.arange(n_lm), n_cam).astype(np.int32)
    uv = _uv(cams, lms, cam_idx, lm_idx).astype(np.float32)
    valid = np.ones(len(uv), dtype=bool)
    return cams, lms, K, cam_idx, lm_idx, uv, valid


def _noisy(ba_scene, seed=0):
    cams, lms, k, cam_idx, lm_idx, uv, valid = ba_scene
    rng = np.random.default_rng(seed)
    noisy_cams = cams + rng.normal(0, 0.01, cams.shape).astype(np.float32)
    noisy_cams[:2] = cams[:2]
    noisy_lms = lms + rng.normal(0, 0.05, lms.shape).astype(np.float32)
    return noisy_cams, noisy_lms, k, cam_idx, lm_idx, uv, valid


# --- grouping -------------------------------------------------------------------


@pytest.mark.parametrize("case", ["overflow", "no_overflow", "all_invalid", "single_slot"])
def test_group_by_landmark_matches_jax_exactly(case):
    """Slots, cameras, pixels, validity and the dropped count equal the JAX
    package's bit for bit: landmarks over the cap, invalid observations,
    an unsorted observation order."""
    rng = np.random.default_rng(3)
    n_lm, n_cam = 40, 9
    deg = rng.integers(0, 8, n_lm)
    lm_idx = np.repeat(np.arange(n_lm), deg).astype(np.int32)
    cam_idx = rng.integers(0, n_cam, len(lm_idx)).astype(np.int32)
    perm = rng.permutation(len(lm_idx))
    lm_idx, cam_idx = lm_idx[perm], cam_idx[perm]
    uv = rng.uniform(0, 640, (len(lm_idx), 2)).astype(np.float32)
    valid = rng.uniform(size=len(lm_idx)) > 0.2
    m = {"overflow": 4, "no_overflow": 16, "all_invalid": 4, "single_slot": 1}[case]
    if case == "all_invalid":
        valid[:] = False
    args = (cam_idx, lm_idx, uv, valid)
    gj = JB.group_by_landmark(*map(jnp.asarray, args), n_lm, m)
    gp = PB.group_by_landmark(*map(T, args), n_lm, m)
    for name in ("cam", "uv", "valid"):
        np.testing.assert_array_equal(getattr(gp, name).numpy(), np.asarray(getattr(gj, name)), name)
    assert gp.cam.dtype == torch.int32 and gp.valid.dtype == torch.bool
    assert int(gp.dropped) == int(gj.dropped)
    want = int(np.maximum(np.bincount(lm_idx[valid], minlength=n_lm) - m, 0).sum())
    assert int(gp.dropped) == want
    if case == "overflow":
        assert want > 0


def test_ba_counts_dropped_observations_as_jax():
    """tests/test_slam.py::test_ba_counts_dropped_observations on the port:
    degree 6 > M = 4 drops 2 a landmark, counted as the JAX package counts."""
    rng = np.random.default_rng(1)
    n_cam, n_lm = 6, 8
    k = np.array([[100, 0, 32], [0, 100, 24], [0, 0, 1]], np.float32)
    lms = rng.uniform([-1, -1, 4], [1, 1, 8], (n_lm, 3)).astype(np.float32)
    cams = np.zeros((n_cam, 6), np.float32)
    cams[:, 3] = np.linspace(0, 0.5, n_cam)
    cam_idx = np.tile(np.arange(n_cam), n_lm).astype(np.int32)
    lm_idx = np.repeat(np.arange(n_lm), n_cam).astype(np.int32)
    uv = _uv(cams, lms, cam_idx, lm_idx, k)
    args = (cams + 0.01, lms, k, cam_idx, lm_idx, uv, np.ones(len(cam_idx), bool))
    pj, pp = _problems(args, 1)
    _, sj = JB.bundle_adjust(pj, n_iterations=1, max_obs_per_landmark=4)
    _, sp = PB.bundle_adjust(pp, n_iterations=1, max_obs_per_landmark=4)
    assert int(sp.obs_dropped) == int(sj.obs_dropped) == n_lm * 2
    assert int(sp.n_observations) == int(sj.n_observations) == n_cam * n_lm


# --- residuals, cost, Schur pieces ----------------------------------------------


@pytest.mark.parametrize("huber", [0.0, 2.0])
def test_residuals_and_cost_match_jax(ba_scene, huber):
    """Residuals and the plain / Huber cost at 1e-5 (relative)."""
    args = list(_noisy(ba_scene))
    args[6] = np.random.default_rng(2).uniform(size=len(args[5])) > 0.1   # some invalid
    pj, pp = _problems(args, 2)
    _rel_close(PB.residuals(pp).numpy(), JB.residuals(pj), 1e-5, "residuals")
    _rel_close(PB.cost(pp, huber).numpy(), JB.cost(pj, huber), 1e-5, "cost")
    g = PB.group_by_landmark(pp.cam_idx, pp.lm_idx, pp.uv, pp.valid, 256, 8)
    gj = JB.group_by_landmark(pj.cam_idx, pj.lm_idx, pj.uv, pj.valid, 256, 8)
    _rel_close(PB.grouped_cost(pp.cameras, pp.landmarks, pp.k, g, huber).numpy(),
               JB.grouped_cost(pj.cameras, pj.landmarks, pj.k, gj, huber), 1e-5, "grouped_cost")


def test_schur_pieces_and_finish_step_match_jax(ba_scene):
    """Every output of schur_pieces (Huber weights on, two fixed cameras)
    at 1e-4 relative to its largest value. finish_step on the same pieces:
    in float64 at 1e-4 of the JAX package's (also float64) step; in fp32
    within 1e-3 of that float64 step. The reduced system is a difference
    of nearly equal blocks: any two fp32 solves of it differ by ~1e-4 of
    the step (the JAX package's own fp32 step is 1.3e-4 off its float64
    one here), so fp32 steps are held to the float64 one, not to each
    other."""
    args = _noisy(ba_scene, seed=4)
    pj, pp = _problems(args, 2)
    n_lm = args[1].shape[0]
    gj = JB.group_by_landmark(pj.cam_idx, pj.lm_idx, pj.uv, pj.valid, n_lm, 8)
    gp = PB.group_by_landmark(pp.cam_idx, pp.lm_idx, pp.uv, pp.valid, n_lm, 8)
    lam, hd = 1e-3, 2.0

    @jax.jit
    def jax_pieces(p, g):
        with jax.default_matmul_precision("highest"):
            return JB.schur_pieces(p.cameras, p.landmarks, p.k, g, 6, jnp.float32(lam), hd, 2)

    pieces_j = jax_pieces(pj, gj)
    pieces_p = PB.schur_pieces(pp.cameras, pp.landmarks, pp.k, gp, 6, torch.tensor(lam), hd, 2)
    for name, a, b in zip(("hcc", "cross", "rhs", "hll_inv", "G", "b_l"), pieces_p, pieces_j):
        assert tuple(a.shape) == tuple(b.shape), name
        _rel_close(a.numpy(), b, 1e-4, name)

    with jax.enable_x64(True):
        step_j64 = JB.finish_step(*(jnp.asarray(np.asarray(a), jnp.float64) for a in pieces_j),
                                  gj.cam, 6, jnp.float64(lam), 2)
        step_j64 = [np.asarray(a) for a in step_j64]
    lam64 = torch.tensor(lam, dtype=torch.float64)
    step_p64 = PB.finish_step(*(T(a).double() for a in pieces_j), gp.cam, 6, lam64, 2)
    step_p32 = PB.finish_step(*map(T, pieces_j), gp.cam, 6, torch.tensor(lam), 2)
    for i, name in enumerate(("d_cam", "d_lm")):
        assert step_p64[i].dtype == torch.float64 and step_j64[i].dtype == np.float64
        _rel_close(step_p64[i].numpy(), step_j64[i], 1e-4, name + " (float64)")
        _rel_close(step_p32[i].numpy(), step_j64[i], 1e-3, name + " (fp32)")
    assert float(step_p32[0][:2].abs().max()) == 0.0        # gauge cameras do not move


def test_pair_chunks_sum_as_one(ba_scene):
    """The cross term summed chunk by chunk equals one chunk holding every
    landmark (the chunking only bounds the transient)."""
    args = _noisy(ba_scene)
    _, pp = _problems(args, 2)
    g = PB.group_by_landmark(pp.cam_idx, pp.lm_idx, pp.uv, pp.valid, 256, 8)
    lam = torch.tensor(1e-3)
    one = PB.schur_pieces(pp.cameras, pp.landmarks, pp.k, g, 6, lam, 1e12, 2)[1]
    orig = PB._pair_chunk
    try:
        PB._pair_chunk = lambda m: 37                      # 7 chunks, a short last one
        many = PB.schur_pieces(pp.cameras, pp.landmarks, pp.k, g, 6, lam, 1e12, 2)[1]
    finally:
        PB._pair_chunk = orig
    _rel_close(many.numpy(), one.numpy(), 1e-6, "chunked cross")
    assert PB._pair_chunk(4) == JB._pair_chunk(4) and PB._pair_chunk(16) == JB._pair_chunk(16)


# --- bundle_adjust ----------------------------------------------------------------


def test_bundle_adjust_matches_jax_and_converges(ba_scene):
    """tests/test_slam.py::test_ba_converges on both packages: final
    cameras and landmarks within 1e-3 of JAX's, and the JAX test's bars."""
    pj, pp = _problems(_noisy(ba_scene), 2)
    oj, sj = jax.jit(lambda p: JB.bundle_adjust(p, n_iterations=8, damping=1e-4))(pj)
    op, sp = PB.bundle_adjust(pp, n_iterations=8, damping=1e-4)
    np.testing.assert_allclose(op.cameras.numpy(), np.asarray(oj.cameras), atol=1e-3)
    np.testing.assert_allclose(op.landmarks.numpy(), np.asarray(oj.landmarks), atol=1e-3)
    np.testing.assert_allclose(float(sp.initial_cost), float(sj.initial_cost), rtol=1e-5)
    assert float(sp.initial_cost) > 1e3
    assert float(sp.final_cost) < 1e-2 * float(sp.initial_cost)
    rms = np.sqrt(2 * float(sp.final_cost) / float(sp.n_observations))
    assert rms < 0.05, rms
    np.testing.assert_array_equal(op.cameras[:2].numpy(), pp.cameras[:2].numpy())


def test_bundle_adjust_huber_matches_jax_and_rejects_outliers(ba_scene):
    """tests/test_slam.py::test_ba_huber_rejects_outliers on both packages:
    the Huber solution within 1e-3 of JAX's and the JAX test's bars (the
    plain solution is held to the bar, not to JAX: outliers make it
    ill-conditioned)."""
    cams, lms, k, cam_idx, lm_idx, uv, valid = ba_scene
    rng = np.random.default_rng(5)
    uv_bad = uv.copy()
    n_out = 100
    out_sel = rng.choice(len(uv), n_out, replace=False)
    uv_bad[out_sel] += rng.uniform(30, 80, (n_out, 2)).astype(np.float32)
    noisy_lms = lms + rng.normal(0, 0.05, lms.shape).astype(np.float32)
    pj, pp = _problems((cams, noisy_lms, k, cam_idx, lm_idx, uv_bad, valid), 2)
    oj, _ = jax.jit(lambda p: JB.bundle_adjust(p, n_iterations=25, damping=1e-4,
                                               huber_delta=2.0))(pj)
    op_h, _ = PB.bundle_adjust(pp, n_iterations=25, damping=1e-4, huber_delta=2.0)
    op_p, _ = PB.bundle_adjust(pp, n_iterations=25, damping=1e-4)
    np.testing.assert_allclose(op_h.cameras.numpy(), np.asarray(oj.cameras), atol=1e-3)
    np.testing.assert_allclose(op_h.landmarks.numpy(), np.asarray(oj.landmarks), atol=1e-3)
    hit = np.zeros(len(lms), dtype=bool)
    hit[lm_idx[out_sel]] = True
    err = lambda o: np.linalg.norm(o.landmarks.numpy() - lms, axis=1)[~hit].mean()
    assert err(op_h) < 0.1 * err(op_p), (err(op_h), err(op_p))
    assert err(op_h) < 0.05
    assert np.abs(op_h.cameras.numpy() - cams).max() < 0.05


def test_bundle_adjust_refuses_tf32_on_cuda_only():
    """The precision guard reads only CUDA tensors."""
    PB._check_precision(torch.zeros(1))


# --- pose graph ---------------------------------------------------------------------


def _loop_graph():
    """tests/test_slam.py::test_pose_graph_closes_loop's circle of 12
    poses with odometry + one closure, exact edges, noisy poses."""
    rng = np.random.default_rng(9)
    n = 12
    angles = np.linspace(0, 2 * np.pi, n, endpoint=False)
    gt = np.zeros((n, 6), dtype=np.float32)
    gt[:, 2] = angles
    gt[:, 3] = np.cos(angles) * 2.0
    gt[:, 4] = np.sin(angles) * 2.0
    ei = np.arange(n, dtype=np.int32)
    ej = np.roll(np.arange(n, dtype=np.int32), -1)
    rel = np.stack([np.asarray(jrelative(jnp.asarray(gt[i]), jnp.asarray(gt[j])))
                    for i, j in zip(ei, ej)]).astype(np.float32)
    noisy = gt + rng.normal(0, 0.05, gt.shape).astype(np.float32)
    noisy[0] = gt[0]
    return gt, (noisy, ei, ej, rel, np.ones(n, np.float32))


def _graphs(args, fixed=1):
    return (JG.PoseGraph(*map(jnp.asarray, args), fixed=fixed),
            PG.PoseGraph(*map(T, args), fixed=fixed))


def test_pose_graph_pieces_match_jax():
    """edge_residual, graph_cost, robust_edge_weights (scalar and per-edge
    delta, one edge trusted with inf) and one _step at 1e-5."""
    _, args = _loop_graph()
    rng = np.random.default_rng(1)
    args = list(args)
    args[3] = args[3] + rng.normal(0, 0.05, args[3].shape).astype(np.float32)  # inconsistent edges
    gj, gp = _graphs(args)
    rj = jax.jit(jax.vmap(JG.edge_residual))(gj.poses[gj.edge_i], gj.poses[gj.edge_j], gj.rel_ij)
    rp = PG.edge_residual(gp.poses[gp.edge_i.long()], gp.poses[gp.edge_j.long()], gp.rel_ij)
    np.testing.assert_allclose(rp.numpy(), np.asarray(rj), atol=1e-5)
    np.testing.assert_allclose(float(PG.graph_cost(gp)), float(jax.jit(JG.graph_cost)(gj)), rtol=1e-5)
    delta = np.full(len(args[1]), 0.05, np.float32)
    delta[3] = np.inf
    weights_j = jax.jit(JG.robust_edge_weights)
    for d in (0.1, delta):
        wj = weights_j(gj, jnp.asarray(d))
        wp = PG.robust_edge_weights(gp, T(d) if isinstance(d, np.ndarray) else d)
        np.testing.assert_allclose(wp.numpy(), np.asarray(wj), atol=1e-5)
    assert float(wp[3]) == 1.0
    with jax.default_matmul_precision("highest"):
        sj = jax.jit(JG._step)(gj, jnp.float32(1e-3))
    sp = PG._step(gp, torch.tensor(1e-3))
    np.testing.assert_allclose(sp.numpy(), np.asarray(sj), atol=1e-5)
    assert float(sp[0].abs().max()) == 0.0


def test_optimize_pose_graph_matches_jax_and_closes_loop():
    """tests/test_slam.py::test_pose_graph_closes_loop on both packages:
    poses within 1e-4 of JAX's, and the JAX test's bars."""
    gt, args = _loop_graph()
    gj, gp = _graphs(args)
    c0 = float(PG.graph_cost(gp))
    oj, _ = jax.jit(lambda x: JG.optimize_pose_graph(x, n_iterations=30))(gj)
    op, c1 = PG.optimize_pose_graph(gp, n_iterations=30)
    np.testing.assert_allclose(op.poses.numpy(), np.asarray(oj.poses), atol=1e-4)
    assert float(c1) < 1e-6 * c0, (c0, float(c1))
    assert np.abs(op.poses.numpy() - gt).max() < 1e-2
