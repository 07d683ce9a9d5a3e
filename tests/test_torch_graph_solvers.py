"""The port's solver and multi-device programs as device programs, on the
CPU.

On a CUDA device ``slam.sfm.replayed_bundle_adjust`` and
``_jit_optimize_pose_graph``, ``make_distributed_ba``'s ``run`` and the
sharded extractor and matcher replay CUDA graphs (``graphs.GraphCache``,
the counterparts of the JAX package's ``jax.jit``s); a graph holds no
host read. Held here, on the CPU, where every program runs eagerly:

  * the five programs read no device value on the host (outside the
    kernels' plain versions);
  * a 0-dim tensor gauge gives the bits of the int, and both match the
    JAX package's jitted functions, two gauges through one JAX compile;
  * the LM loops split into prologue, iteration and epilogue give the
    bits of the unrolled loops they replaced (kept here as the record);
  * the cache key: windowed BA calls share their bucket's key, a new
    bucket or static argument does not;
  * ``SfmMap(..., device="cpu")`` stays eager.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from siftmetal_tpu.slam import ba as JB
from siftmetal_tpu.slam import pose_graph as JG
from siftmetal_tpu.slam import sfm as JS
from siftmetal_tpu_torch import SiftConfig
from siftmetal_tpu_torch.graphs import GraphCache
from siftmetal_tpu_torch.slam import ba as PB
from siftmetal_tpu_torch.slam import pose_graph as PG
from siftmetal_tpu_torch.slam import sfm as PS
from siftmetal_tpu_torch.slam.camera import project, relative
from torch_bits import HostReads, same_bits

torch.set_num_threads(2)

K = np.array([[400, 0, 320], [0, 400, 240], [0, 0, 1]], np.float32)


def _ba_args(n_cam=6, n_lm=128, seed=42, outliers=True):
    """tests/test_slam.py's ba_scene at ``n_cam`` x ``n_lm`` (every camera
    sees every landmark), noisy start, outliers every 37th observation."""
    rng = np.random.default_rng(seed)
    lms = rng.uniform([-3, -3, 6], [3, 3, 12], (n_lm, 3)).astype(np.float32)
    cams = np.zeros((n_cam, 6), np.float32)
    cams[:, 3] = np.linspace(-1, 1, n_cam)
    cams[:, :3] = rng.uniform(-0.05, 0.05, (n_cam, 3))
    cam_idx = np.repeat(np.arange(n_cam), n_lm).astype(np.int32)
    lm_idx = np.tile(np.arange(n_lm), n_cam).astype(np.int32)
    uv = project(torch.from_numpy(cams)[cam_idx], torch.from_numpy(K),
                 torch.from_numpy(lms)[lm_idx]).numpy()
    if outliers:
        uv[::37] += 40.0
    cams = cams + rng.normal(0, 0.01, cams.shape).astype(np.float32)
    lms = lms + rng.normal(0, 0.05, lms.shape).astype(np.float32)
    return cams, lms, K, cam_idx, lm_idx, uv, np.ones(len(uv), bool)


def _problem(args, fixed):
    return PB.BAProblem(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args),
                        fixed_cameras=fixed)


def _ring(n=12, seed=9, bad_edge=True):
    """tests/test_slam.py's circle of poses, with one bad edge unless
    ``bad_edge`` is False: (args of a PoseGraph, per-edge Huber delta)."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    gt = np.zeros((n, 6), np.float32)
    gt[:, 2], gt[:, 3], gt[:, 4] = ang, np.cos(ang) * 2.0, np.sin(ang) * 2.0
    ei = np.arange(n, dtype=np.int32)
    ej = np.roll(ei, -1)
    rel = relative(torch.from_numpy(gt[ei]), torch.from_numpy(gt[ej])).numpy()
    rel[5] += 0.3 if bad_edge else 0.0
    noisy = gt + rng.normal(0, 0.05, gt.shape).astype(np.float32)
    noisy[0] = gt[0]
    return (noisy, ei, ej, rel, np.ones(n, np.float32)), np.full(n, 0.1, np.float32)


def _graph(args, fixed):
    return PG.PoseGraph(*(torch.from_numpy(a) for a in args), fixed=fixed)


def _tensor(v):
    return torch.tensor(v, dtype=torch.int64)


def _bits(a, b):
    return all(same_bits(x, y) for x, y in zip(a, b))


# --- the record: the unrolled LM loops before the split --------------------------


def _unrolled_bundle_adjust(problem, n_iterations, damping=1e-4, huber_delta=0.0, m=16):
    """What ``bundle_adjust`` computed before its loop was split: one
    Python loop over ``_gauss_newton_step`` rebinding the state."""
    hd = huber_delta if huber_delta > 0 else 1e12
    c_n = problem.cameras.shape[0]
    g = PB.group_by_landmark(problem.cam_idx, problem.lm_idx, problem.uv, problem.valid,
                             problem.landmarks.shape[0], m)
    k, cameras, landmarks = problem.k, problem.cameras, problem.landmarks
    lam = torch.full((), damping, dtype=cameras.dtype)
    c_init = PB.cost(problem)
    c0 = PB.grouped_cost(cameras, landmarks, k, g, huber_delta)
    segs = PB.schur_segments(g, c_n)
    c_first = torch.tensor(float("nan"), dtype=torch.float64)
    for i in range(n_iterations):
        d_cam, d_lm = PB._gauss_newton_step(cameras, landmarks, k, g, c_n, lam, hd,
                                            problem.fixed_cameras, segs)
        new_cams, new_lms = cameras + d_cam, landmarks + d_lm
        c1 = PB.grouped_cost(new_cams, new_lms, k, g, huber_delta)
        c_first = c1 if i == 0 else c_first
        accept = c1 < c0
        cameras = torch.where(accept, new_cams, cameras)
        landmarks = torch.where(accept, new_lms, landmarks)
        c0 = torch.where(accept, c1, c0)
        lam = torch.where(accept, lam * 0.5, lam * 10.0).clamp(1e-8, 1e6)
    out = problem._replace(cameras=cameras, landmarks=landmarks)
    return out, PB.BAStats(c_init, PB.cost(out), problem.valid.sum(dtype=torch.int32), g.dropped,
                           first_step_cost=c_first)


def _unrolled_pose_graph(g, n_iterations, damping=1e-4, huber_delta=0.1):
    """What ``optimize_pose_graph`` computed before its loop was split."""
    poses = g.poses
    lam = torch.full((), damping, dtype=poses.dtype)
    segs = PG._edge_segments(g)
    for _ in range(n_iterations):
        gg = g._replace(poses=poses)
        gw = gg._replace(weight=g.weight * PG.robust_edge_weights(gg, huber_delta))
        new_poses = poses + PG._step(gw, lam, segs)
        accept = PG.graph_cost(gw._replace(poses=new_poses)) < PG.graph_cost(gw)
        poses = torch.where(accept, new_poses, poses)
        lam = torch.where(accept, lam * 0.5, lam * 10.0).clamp(1e-8, 1e6)
    out = g._replace(poses=poses)
    return out, PG.graph_cost(out)


@pytest.mark.parametrize("huber, fixed", [(0.0, 2), (2.0, 2), (2.0, _tensor(3))])
def test_split_bundle_adjust_equals_the_unrolled_loop(huber, fixed):
    """Prologue, iteration and epilogue in a Python loop give the unrolled
    loop's bits in every output, and leave the problem's tensors alone."""
    problem = _problem(_ba_args(), fixed)
    before = [t.clone() for t in problem[:7]]
    got, stats = PB.bundle_adjust(problem, n_iterations=3, huber_delta=huber)
    want, wstats = _unrolled_bundle_adjust(problem, 3, huber_delta=huber)
    assert _bits(got[:7], want[:7]) and _bits(stats, wstats)
    assert _bits(problem[:7], before)
    assert float(stats.final_cost) < float(stats.initial_cost)


@pytest.mark.parametrize("huber", [0.1, "per_edge", float("inf")])
def test_split_pose_graph_equals_the_unrolled_loop(huber):
    """The same for the pose graph, scalar and per-edge Huber deltas."""
    args, delta = _ring()
    g = _graph(args, 1)
    hd = torch.from_numpy(delta) if huber == "per_edge" else huber
    got, cost = PG.optimize_pose_graph(g, n_iterations=3, huber_delta=hd)
    want, wcost = _unrolled_pose_graph(g, 3, huber_delta=hd)
    assert same_bits(got.poses, want.poses) and same_bits(cost, wcost)
    assert same_bits(g.poses, torch.from_numpy(args[0]))


# --- the gauge as a tensor, against the JAX jits ------------------------------------


def test_tensor_gauge_bundle_adjust_equals_int_and_jax():
    """SfmMap's BA solve with a 0-dim tensor gauge gives the int gauge's
    bits; at gauges 2 and 3 (one JAX compile: the JAX gauge is traced) it
    matches the JAX package's _jit_bundle_adjust within
    tests/test_torch_ba.py's 1e-3."""
    args = _ba_args()
    n0 = JS._jit_bundle_adjust._cache_size()
    for fixed in (2, 3):
        by_int = PB.bundle_adjust(_problem(args, fixed), n_iterations=6, huber_delta=2.0)
        out, stats = PS.replayed_bundle_adjust(_problem(args, _tensor(fixed)), 6, 2.0)
        assert _bits(out[:7], by_int[0][:7]) and _bits(stats, by_int[1])
        jp = JB.BAProblem(*map(jnp.asarray, args), fixed_cameras=jnp.asarray(fixed))
        jo, js = JS._jit_bundle_adjust(jp, 6, 2.0)
        np.testing.assert_allclose(out.cameras.numpy(), np.asarray(jo.cameras), atol=1e-3)
        np.testing.assert_allclose(out.landmarks.numpy(), np.asarray(jo.landmarks), atol=1e-3)
        np.testing.assert_allclose(float(stats.initial_cost), float(js.initial_cost), rtol=1e-5)
        np.testing.assert_array_equal(out.cameras[:fixed].numpy(), args[0][:fixed])
    assert JS._jit_bundle_adjust._cache_size() == n0 + 1


def test_tensor_gauge_pose_graph_equals_int_and_jax():
    """The pose graph's solve with a 0-dim tensor gauge gives the int's
    bits; at gauges 1 and 2 (one JAX compile) it matches the JAX package's
    _jit_optimize_pose_graph within tests/test_torch_ba.py's 1e-4, on that
    file's loop (exact edges)."""
    args, delta = _ring(bad_edge=False)
    n0 = JS._jit_optimize_pose_graph._cache_size()
    for fixed in (1, 2):
        by_int = PG.optimize_pose_graph(_graph(args, fixed), n_iterations=6,
                                        huber_delta=torch.from_numpy(delta))
        out, cost = PS._jit_optimize_pose_graph(_graph(args, _tensor(fixed)), 6,
                                                torch.from_numpy(delta))
        assert same_bits(out.poses, by_int[0].poses) and same_bits(cost, by_int[1])
        jg = JG.PoseGraph(*map(jnp.asarray, args), fixed=jnp.asarray(fixed))
        jo, _ = JS._jit_optimize_pose_graph(jg, 6, jnp.asarray(delta))
        np.testing.assert_allclose(out.poses.numpy(), np.asarray(jo.poses), atol=1e-4)
        np.testing.assert_array_equal(out.poses[:fixed].numpy(), args[0][:fixed])
    assert JS._jit_optimize_pose_graph._cache_size() == n0 + 1


# --- no host read in the five programs ------------------------------------------------


def test_solvers_read_nothing_back():
    """bundle_adjust (Huber, tensor gauge) and optimize_pose_graph
    (per-edge delta) make no host read: nothing a CUDA graph could not
    hold. The mode sees a read (the control)."""
    with HostReads() as control:
        bool((torch.arange(3) > 1).any())
    assert len(control.outside) == 1
    args, delta = _ring()
    with HostReads() as reads:
        PB.bundle_adjust(_problem(_ba_args(), _tensor(2)), n_iterations=3, huber_delta=2.0)
        PG.optimize_pose_graph(_graph(args, 1), n_iterations=3, huber_delta=torch.from_numpy(delta))
    assert reads.outside == [] and reads.inside == 0


@pytest.fixture
def cpu_mesh():
    """A one-rank gloo mesh (make_mesh sets the group up: no rank
    processes), torn down after the test."""
    from siftmetal_tpu_torch.parallel import make_mesh

    assert not torch.distributed.is_initialized()
    try:
        yield make_mesh(device="cpu")
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def test_parallel_programs_read_nothing_back(cpu_mesh):
    """The distributed BA's run, the sharded extractor's body (outside the
    kernels' plain versions) and the sharded matcher's body make no host
    read, and each equals its eager route (``run.eager``) bit for bit."""
    from siftmetal_tpu_torch.parallel import (
        make_batch_extractor,
        make_distributed_ba,
        make_sharded_matcher,
        shard_ba_problem,
    )

    cfg = SiftConfig(max_extrema_per_octave=512, max_keypoints=256, max_descriptors=512)
    frames = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (2, 96, 128)).astype(np.float32))
    sharded = shard_ba_problem(_problem(_ba_args(), 2), 1)
    runs = [make_distributed_ba(cpu_mesh, n_iterations=3, huber_delta=2.0),
            make_batch_extractor(cpu_mesh, 96, 128, cfg), make_sharded_matcher(cpu_mesh)]
    with HostReads() as reads:
        outs = [runs[0](sharded), runs[1](frames)]
        feats, valid = outs[1][1].features, outs[1][1].valid
        outs.append(runs[2](feats[0], valid[0], feats.reshape(-1, 128), valid.reshape(-1)))
    assert reads.outside == [] and reads.inside > 0
    eager = [runs[0].eager(sharded), runs[1].eager(frames),
             runs[2].eager(feats[0], valid[0], feats.reshape(-1, 128), valid.reshape(-1))]
    leaves = torch.utils._pytree.tree_leaves
    for got, want in zip(outs, eager):
        assert _bits(leaves(got), leaves(want))
    assert int(outs[2].valid.sum()) > 20
    assert all(run.graphs.graphs == {} for run in runs)


# --- the cache key and the CPU map ----------------------------------------------------


def _synthetic_frames(n_frames=4, n_lm=256):
    """tests/test_sfm.py's sequence at 256 landmarks and 4 frames."""
    rng = np.random.default_rng(21)
    lms = rng.uniform([-4, -3, 8], [4, 3, 16], (n_lm, 3)).astype(np.float32)
    descs = rng.integers(0, 200, (n_lm, 128)).astype(np.uint8)
    frames = []
    for i in range(n_frames):
        cam = np.zeros(6, np.float32)
        cam[3], cam[1] = 0.5 * i, 0.025 * i
        uv = project(torch.from_numpy(cam), torch.from_numpy(K), torch.from_numpy(lms)).numpy()
        uv = uv + rng.normal(0, 0.3, uv.shape).astype(np.float32)
        inside = (uv[:, 0] > 0) & (uv[:, 0] < 640) & (uv[:, 1] > 0) & (uv[:, 1] < 480)
        frames.append((uv[:, ::-1].copy(), descs, inside))
    return frames


@pytest.fixture(scope="module")
def cpu_map():
    smap = PS.SfmMap(K, PS.SfmConfig(max_cameras=8), device="cpu")
    frames = _synthetic_frames()
    assert smap.initialize(frames[0], frames[1]) > 100
    for f in frames[2:]:
        assert smap.add_frame(f)[0]
    return smap


def test_windowed_calls_share_their_bucket_key(cpu_map):
    """The key of SfmMap's BA: windows with other gauges and valid masks
    share it (the gauge is a 0-dim tensor input); a larger bucket or
    another static argument makes a new one."""
    c = cpu_map.config
    valid, nc, nlm, no = cpu_map._fill()
    key = lambda p, n=c.ba_iterations, hd=c.ba_huber_delta: PS._BA_GRAPHS.key(
        p, n_iterations=n, damping=1e-4, huber_delta=hd, max_obs_per_landmark=16)
    windows = []
    for first in (1, 2, 3):
        v = valid.copy()
        v[: cpu_map.n_obs] &= cpu_map.obs_cam[: cpu_map.n_obs] >= first
        windows.append(cpu_map._problem(v, nc, nlm, no, first))
    assert not torch.equal(windows[0].valid, windows[2].valid)
    assert key(windows[0]) == key(windows[1]) == key(windows[2])
    bigger = cpu_map._problem(np.zeros(2 * no, bool), nc, nlm, 2 * no, 1)
    assert key(bigger) != key(windows[0])
    assert key(windows[0], n=c.ba_iterations + 1) != key(windows[0])
    assert key(windows[0], hd=0.0) != key(windows[0])
    # An int gauge is a static leaf of the key: one program a value.
    assert key(windows[0]._replace(fixed_cameras=1)) != key(windows[0]._replace(fixed_cameras=2))


def test_cpu_map_stays_eager(cpu_map, monkeypatch):
    """SfmMap(device="cpu") runs its BA (global and windowed) and pose
    graph eagerly: no capture, nothing cached, the BA's bits those of
    ba.bundle_adjust on the map's problem."""
    def no_capture(*a, **k):
        raise AssertionError("a CPU map captured a graph")

    monkeypatch.setattr(GraphCache, "_capture", no_capture)
    c = cpu_map.config
    valid, nc, nlm, no = cpu_map._fill()
    want, _ = PB.bundle_adjust(cpu_map._problem(valid, nc, nlm, no, 1),
                               n_iterations=c.ba_iterations, huber_delta=c.ba_huber_delta)
    saved = cpu_map.cameras.copy(), cpu_map.landmarks.copy(), list(cpu_map.odometry)
    try:
        cpu_map.bundle_adjust()
        np.testing.assert_array_equal(cpu_map.cameras[:nc], want.cameras.numpy())
        np.testing.assert_array_equal(cpu_map.landmarks[:nlm], want.landmarks.numpy())
        cpu_map.bundle_adjust(window=2)
        assert np.isfinite(cpu_map.optimize_pose_graph(loop_closures=[(0, 3)], n_iterations=3))
    finally:
        cpu_map.cameras[:], cpu_map.landmarks[:] = saved[0], saved[1]
        cpu_map.odometry[:] = saved[2]
    assert PS._BA_GRAPHS.graphs == {} and PS._POSE_GRAPH_GRAPHS.graphs == {}
