"""The port's bundle adjustment on BAL's camera model and its pair-list
Schur assembly, against the plain float64 reference of the benchmark
(``portbench/reference/bal.py``), on the CPU at a small size. Each test
states its tolerance and why."""

import ast
import json
import pathlib

import numpy as np
import pytest
import torch

from portbench.harness.bal_scene import generate
from portbench.reference import bal as ref_bal
from siftmetal_tpu_torch.slam import ba as PB
from siftmetal_tpu_torch.slam.camera import project_bal
from siftmetal_tpu_torch.slam.sfm import (BA_MAX_OBS_PER_LANDMARK, SfmConfig, SfmMap,
                                          replayed_bundle_adjust)
from siftmetal_tpu_torch.utils import profiling

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "portbench/configs/bal_trafalgar257.json").read_text())


def _small_config(cameras=12, points=600, observations=2000):
    """The benchmark's BAL configuration at a small size: its scene, a
    degree tail up to ``cameras``."""
    return dict(CONFIG, cameras=cameras, points=points, observations=observations)


@pytest.fixture(scope="module")
def small_bal():
    return generate(_small_config(), 2 ** 31 + 77)


def _problem(bal, fixed=1):
    return PB.BAProblem(bal.cameras, bal.points, torch.eye(3), bal.cam_idx, bal.pt_idx, bal.uv,
                        torch.ones(bal.uv.shape[0], dtype=torch.bool), fixed_cameras=fixed)


def _reference(bal, n_iterations, damping=1e-4):
    obs = ref_bal.observations(bal.cam_idx, bal.pt_idx, bal.uv)
    return obs, ref_bal.solve(bal.cameras, bal.points, obs, n_iterations, damping, 1)


def test_reference_imports_nothing_of_the_port():
    """The reference is independent code: its imports are the standard
    library's and torch's alone."""
    tree = ast.parse((ROOT / "portbench/reference/bal.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert {m.split(".")[0] for m in names} <= {"__future__", "typing", "torch"}, names


def test_bal_projection_matches_the_reference():
    """BAL's projection on seeded cameras and points in front of them. In
    float64 within 1e-9 px of pixels up to ~1e3 px: the two compute one
    formula with rotations written differently, so they differ by
    rounding (~1e-13). In float32 within 2e-3 px: float32 carries ~7
    digits of a ~1e3 px pixel through ~20 roundings."""
    g = torch.Generator().manual_seed(5)
    n = 4096
    cams = torch.cat([torch.rand(n, 3, generator=g, dtype=torch.float64) * 4 - 2,
                      torch.rand(n, 3, generator=g, dtype=torch.float64) * 2 - 1,
                      500 + 700 * torch.rand(n, 1, generator=g, dtype=torch.float64),
                      torch.rand(n, 1, generator=g, dtype=torch.float64) * 0.2 - 0.1,
                      torch.rand(n, 1, generator=g, dtype=torch.float64) * 0.02 - 0.01], 1)
    # Points in front (camera z < 0), within 45 degrees of the axis.
    p_cam = torch.cat([torch.rand(n, 2, generator=g, dtype=torch.float64) * 2 - 1,
                       -(1.5 + 20 * torch.rand(n, 1, generator=g, dtype=torch.float64))], 1)
    rot = ref_bal.rotation(cams[:, :3])
    pts = (rot.mT @ (p_cam - cams[:, 3:6])[..., None])[..., 0]
    want = ref_bal.project(cams, pts)
    assert float(want.abs().max()) < 2e3
    assert float((project_bal(cams, pts) - want).abs().max()) < 1e-9
    assert float((project_bal(cams.float(), pts.float()).double() - want).abs().max()) < 2e-3


def test_small_bal_solve_matches_the_reference(small_bal):
    """12 cameras, 600 points, degrees up to 12, 10 iterations through
    the replayed solve (eager on the CPU) against the float64 reference.
    The program keeps its state in float32 and assembles in float64, so
    the two LM paths part by float32 rounding of the state: final cost
    within 1e-6 of the reference's (seen: ~1e-9), predicted pixels within
    0.01 px (seen: ~1e-4; the noise is 1 px), cameras and points within
    1e-3 of their scale (a free scale of the gauge can drift by rounding)."""
    out, stats = replayed_bundle_adjust(_problem(small_bal), 10, 0.0, max_obs_per_landmark=12)
    obs, ref = _reference(small_bal, 10)
    assert int(stats.obs_dropped) == 0 and int(stats.pairs_dropped) == 0
    assert float(stats.final_cost) < 0.02 * float(stats.initial_cost)
    cost = float(ref_bal.cost(out.cameras, out.landmarks, obs))
    assert abs(cost - ref.final_cost) <= 1e-6 * ref.final_cost
    px = ref_bal.predicted(out.cameras, out.landmarks, obs) - ref_bal.predicted(ref.cameras, ref.points, obs)
    assert float(px.abs().max()) < 0.01
    cams = out.cameras.double()
    for got, want in ((cams[:, :6], ref.cameras[:, :6]), (out.landmarks.double(), ref.points)):
        assert float((got - want).abs().max()) < 1e-3 * float(want.abs().max())
    assert float(((cams[:, 6] - ref.cameras[:, 6]) / ref.cameras[:, 6]).abs().max()) < 1e-3


def test_first_step_cost_tells_the_assembly_precision_apart(small_bal):
    """The cost the first step reaches (``BAStats.first_step_cost``)
    against the reference's first step: the program within 1e-4 of it
    (seen: 4e-6 here, up to 3e-5 on two more seeds: its residuals and
    Jacobians are float32, and the first step lands short of the optimum,
    where a change of the step moves the cost at first order); the same
    solve with its normal equations in float32 (``ba.ACC``) farther than
    1e-4 (seen: 3e-3 here, 5e-4 at the least of three seeds). The final
    costs of the two agree within 1e-6: the LM loop hides the assembly's
    precision by its end."""
    obs, ref = _reference(small_bal, 10)
    gaps, finals = [], []
    for acc in (torch.float64, torch.float32):
        saved, PB.ACC = PB.ACC, acc
        try:
            out, stats = PB.bundle_adjust(_problem(small_bal), 10, max_obs_per_landmark=12)
        finally:
            PB.ACC = saved
        gaps.append(abs(float(stats.first_step_cost) - ref.first_step_cost) / ref.first_step_cost)
        finals.append(abs(float(ref_bal.cost(out.cameras, out.landmarks, obs)) - ref.final_cost)
                      / ref.final_cost)
    assert gaps[0] <= 1e-4 < gaps[1]
    assert max(finals) <= 1e-6
    assert ref.first_step_cost < 0.02 * ref.initial_cost


def _p6_problem(seed=3, n_cam=9, n_lm=40, m=4):
    """A P = 6 problem with degrees 1..9 over M = ``m``: observations past
    M are dropped by the grouping, some invalid."""
    rng = np.random.default_rng(seed)
    k = np.array([[400, 0, 320], [0, 400, 240], [0, 0, 1]], np.float32)
    lms = rng.uniform([-3, -3, 6], [3, 3, 12], (n_lm, 3)).astype(np.float32)
    cams = np.zeros((n_cam, 6), np.float32)
    cams[:, 3] = np.linspace(-1, 1, n_cam)
    cams[:, :3] = rng.uniform(-0.05, 0.05, (n_cam, 3))
    deg = rng.integers(1, n_cam + 1, n_lm)
    lm_idx = np.repeat(np.arange(n_lm), deg).astype(np.int32)
    cam_idx = np.concatenate([rng.permutation(n_cam)[:d] for d in deg]).astype(np.int32)
    perm = rng.permutation(len(lm_idx))
    lm_idx, cam_idx = lm_idx[perm], cam_idx[perm]
    t = torch.from_numpy
    uv = PB.project(t(cams)[cam_idx], t(k), t(lms)[lm_idx]) + torch.from_numpy(
        rng.normal(0, 1.0, (len(lm_idx), 2)).astype(np.float32))
    valid = rng.uniform(size=len(lm_idx)) > 0.1
    noisy = cams + rng.normal(0, 0.01, cams.shape).astype(np.float32)
    return PB.BAProblem(t(noisy), t(lms + 0.05), t(k), t(cam_idx), t(lm_idx), uv, t(valid),
                        fixed_cameras=2), m


def test_pair_assembly_equals_the_grid_form():
    """On a P = 6 problem whose degrees pass M, the pair list's Hcc, cross
    term and right-hand side, and the step they give, equal the [L, M]
    grid form's (``schur_pieces``, ``finish_step``): the pieces within
    1e-9 of each one's largest value, as both sum the same float64
    products of the same kept observations in other orders (~1e-15
    apart); the step within 1e-6, as the dense solve magnifies their
    rounding by the system's condition (seen: ~2e-9)."""
    problem, m = _p6_problem()
    g = PB.group_by_landmark(problem.cam_idx, problem.lm_idx, problem.uv, problem.valid,
                             problem.landmarks.shape[0], m)
    assert int(g.dropped) > 0
    args = (problem.cameras, problem.landmarks, problem.k, g, 9, torch.tensor(1e-3), 2.0, 2)
    grid = PB.schur_pieces(*args)
    segs = PB.schur_segments(g, 9)
    pairs = PB.pair_pieces(*args, segs)
    for name, a, b in zip(("hcc", "cross", "rhs"), pairs[:3], grid[:3]):
        assert a.dtype == b.dtype == torch.float64 and a.shape == b.shape, name
        assert float((a - b).abs().max()) <= 1e-9 * float(b.abs().max()), name
    step_grid = PB.finish_step(*grid, g.cam, 9, torch.tensor(1e-3), 2)
    step_pairs = PB.pair_step(*pairs, g, 9, torch.tensor(1e-3), 2)
    for a, b in zip(step_pairs, step_grid):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


def test_landmark_blocks_hold_their_precision():
    """Hll^-1 on a chain of 128 cameras and 8,192 points, each seen by 3
    neighbouring cameras (baselines ~1/100 of the depth: Hll's condition
    up to ~1e7), against Hll summed by ``index_add_`` (a point's 3 terms
    added in order) and inverted: within 1e-7 of each block's largest
    value (seen: 2e-9). A running sum over the whole list, cut at each
    point's run, misses by 1.3e-6 here: the rounding of the running total
    magnified by the condition."""
    rng = np.random.default_rng(0)
    n_cam, n_lm = 128, 8192
    k = torch.tensor([[400.0, 0, 320], [0, 400, 240], [0, 0, 1]])
    lms = torch.from_numpy(rng.uniform([-8, -8, 6], [8, 8, 30], (n_lm, 3)).astype(np.float32))
    cams = torch.zeros(n_cam, 6)
    cams[:, 3] = torch.linspace(-4, 4, n_cam)
    first = torch.from_numpy(rng.integers(0, n_cam - 3, n_lm))
    cam_idx = (first[:, None] + torch.arange(3)).reshape(-1)
    lm_idx = torch.arange(n_lm).repeat_interleave(3)
    uv = PB.project(cams[cam_idx], k, lms[lm_idx])
    g = PB.sort_by_landmark(cam_idx, lm_idx, uv, torch.ones(len(lm_idx), dtype=torch.bool), n_lm, 4)
    f = g.flat
    hll_inv = PB.pair_pieces(cams, lms, k, g, n_cam, torch.tensor(1e-4), 1e12, 2,
                             PB.schur_segments(g, n_cam))[3]
    jl = PB._jacobians(cams[f.cam], lms[f.lm], k, f.uv)[2].double()
    hll = torch.zeros(n_lm, 3, 3, dtype=torch.float64).index_add_(
        0, f.lm, torch.einsum("oia,oib->oab", jl, jl))
    want = torch.linalg.inv(hll + 1e-4 * torch.eye(3, dtype=torch.float64))
    err = (hll_inv - want).abs().amax((1, 2)) / want.abs().amax((1, 2))
    assert float(err.max()) < 1e-7


def test_slot_form_assembles_the_same_bits():
    """The landmark-sharded solve's form (the [L, M] slots read flat by
    ``slot_obs``) assembles the same Hcc, cross term, right-hand side,
    Hll^-1 and step as the single-device form bit for bit, on a problem
    whose degrees pass M: the same products of the same kept observations
    summed in the same order, the slots' padding adding nothing. So a
    one-rank sharded solve is the single-device one."""
    problem, m = _p6_problem()
    g = PB.group_by_landmark(problem.cam_idx, problem.lm_idx, problem.uv, problem.valid,
                             problem.landmarks.shape[0], m)
    shard = PB.GroupedObs(None, None, None, g.dropped, PB.slot_obs(g.cam, g.uv, g.valid))
    lam = torch.tensor(1e-3)
    outs = []
    for form in (g, shard):
        pieces = PB.pair_pieces(problem.cameras, problem.landmarks, problem.k, form, 9, lam, 2.0,
                                2, PB.schur_segments(form, 9))
        outs.append(pieces[:4] + PB.pair_step(*pieces, form, 9, lam, 2))
    for name, a, b in zip(("hcc", "cross", "rhs", "hll_inv", "d_cam", "d_lm"), *outs):
        assert torch.equal(a, b), name


def test_shards_size_their_pair_lists_from_the_valid_slots():
    """``shard_ba_problem``'s ``max_pairs`` is the largest shard's count of
    same-landmark pairs of valid slots (exact: integer counts), not the
    slots' capacity L/D x M (M + 1) / 2; with it a shard's pair list drops
    no pair and the largest shard's fills it."""
    from siftmetal_tpu_torch.parallel import shard_ba_problem

    problem, _ = _p6_problem(n_lm=64)
    sharded = shard_ba_problem(problem, 4)
    counts = []
    for r in range(4):
        v = sharded.valid[r].sum(1)
        counts.append(int((v * (v + 1) // 2).sum()))
        g = PB.GroupedObs(None, None, None, torch.zeros((), dtype=torch.int32),
                          PB.slot_obs(sharded.cam[r], sharded.uv[r], sharded.valid[r]))
        segs = PB.schur_segments(g, 9, sharded.max_pairs)
        assert int(segs.dropped) == 0 and int((segs.weight > 0).sum()) == counts[-1]
    m = sharded.cam.shape[-1]
    assert sharded.max_pairs == max(counts) < 16 * m * (m + 1) // 2


def test_pairs_past_the_bound_are_counted(small_bal):
    """A pair list short of the problem's pairs drops the pairs past it and
    counts them; the host count equals what the device lists. The full
    list gives the reference's cost within 1e-6 (as below); a short one
    leaves the last points' cross terms out and misses it by more, within
    1e-2 at 40 of ~4,500 pairs (seen: 2e-3)."""
    valid = torch.ones(small_bal.uv.shape[0], dtype=torch.bool)
    n = PB.landmark_pairs(small_bal.pt_idx, valid, small_bal.points.shape[0], 12)
    d = np.bincount(small_bal.pt_idx.numpy(), minlength=600)
    assert n == int((d * (d + 1) // 2).sum()) > 0
    obs, ref = _reference(small_bal, 3)
    gaps = []
    for bound, dropped in ((n, 0), (n - 1, 1), (n - 40, 40)):
        out, stats = replayed_bundle_adjust(_problem(small_bal), 3, 0.0, max_obs_per_landmark=12,
                                            max_pairs=bound)
        assert int(stats.pairs_dropped) == dropped and int(stats.obs_dropped) == 0
        cost = float(ref_bal.cost(out.cameras, out.landmarks, obs))
        gaps.append(abs(cost - ref.final_cost) / ref.final_cost)
    assert gaps[0] <= 1e-6 < gaps[2] <= 1e-2


def test_spans_and_counters_on_the_eager_path(small_bal):
    """Under the tracer the eager solve records host spans ``ba.prologue``,
    one ``ba.iteration`` a pass and ``ba.epilogue``, and counts
    ``ba.solves``; its result is the untraced one's bit for bit and within
    1e-6 of the reference's cost (as above)."""
    problem = _problem(small_bal)
    untraced = PB.bundle_adjust(problem, n_iterations=3, max_obs_per_landmark=12)
    with profiling.tracing():
        profiling.drain()
        out, stats = PB.bundle_adjust(problem, n_iterations=3, max_obs_per_landmark=12)
        replayed_bundle_adjust(problem, 2, 0.0, max_obs_per_landmark=12)
        got = profiling.drain()
    names = ["ba.prologue"] + ["ba.iteration"] * 3 + ["ba.epilogue"]
    names += ["ba.prologue"] + ["ba.iteration"] * 2 + ["ba.epilogue"]
    assert [s.name for s in got.spans] == names
    assert all(s.parent is None and s.device_ms is None and s.host_ms > 0 for s in got.spans)
    assert got.counters == {"ba.solves": 2}
    assert torch.equal(out.cameras, untraced[0].cameras) and torch.equal(stats.final_cost,
                                                                          untraced[1].final_cost)
    obs, ref = _reference(small_bal, 3)
    cost = float(ref_bal.cost(out.cameras, out.landmarks, obs))
    assert abs(cost - ref.final_cost) <= 1e-6 * ref.final_cost


def test_map_counts_its_solve_and_pairs():
    """``SfmMap.bundle_adjust`` under the tracer: one ``ba.solves``, its
    program's spans, and ``ba.pairs`` equal to the pairs of the map's live
    observations counted here from its arrays (each landmark's degree d
    capped at the map's M, d (d + 1) / 2 pairs). Exact: both are integer
    counts."""
    rng = np.random.default_rng(21)
    k = np.array([[400, 0, 320], [0, 400, 240], [0, 0, 1]], np.float32)
    lms = rng.uniform([-4, -3, 8], [4, 3, 16], (256, 3)).astype(np.float32)
    desc = rng.integers(0, 200, (256, 128)).astype(np.uint8)
    frames = []
    for x in (0.0, 0.5, 1.0):
        cam = torch.tensor([0, 0, 0, x, 0, 0], dtype=torch.float32)
        uv = PB.project(cam, torch.from_numpy(k), torch.from_numpy(lms)).numpy()
        uv = uv + rng.normal(0, 0.3, uv.shape).astype(np.float32)
        inside = (uv[:, 0] > 0) & (uv[:, 0] < 640) & (uv[:, 1] > 0) & (uv[:, 1] < 480)
        frames.append((uv[:, ::-1].copy(), desc, inside))
    smap = SfmMap(k, SfmConfig(max_cameras=8), device="cpu")
    assert smap.initialize(frames[0], frames[1]) > 100
    assert smap.add_frame(frames[2])[0]
    alive = smap.obs_alive[: smap.n_obs]
    d = np.minimum(np.bincount(smap.obs_lm[: smap.n_obs][alive]), BA_MAX_OBS_PER_LANDMARK)
    with profiling.tracing():
        profiling.drain()
        smap.bundle_adjust()
        got = profiling.drain()
    assert got.counters == {"ba.solves": 1, "ba.pairs": int((d * (d + 1) // 2).sum())}
    names = ["ba.prologue"] + ["ba.iteration"] * smap.config.ba_iterations + ["ba.epilogue"]
    assert [s.name for s in got.spans] == names
