#!/usr/bin/env python3
"""Hold the port's compiled solver and multi-device programs against their
eager runs on one card.

    python3 scripts/bench_graph_solvers.py [--part NAME ...]

Each program's replay (``graphs.GraphCache``; its first call warms up
and captures) against its eager run on the same inputs, through
chip_smoke's ``_eager_vs_replay``: the first call's seconds and the
memory it keeps reserved, the bits of both (equal or the script fails),
ms a call in turns (eager, replay, replay, eager) and one profiled call
of each. Parts (all by default):

  ba        slam.sfm.replayed_bundle_adjust against slam.ba.bundle_adjust at
            two bucket shapes (8 Huber iterations), then windowed calls
            with two gauges (device scalars) on one program;
  mapping   the same at mapping size (256 cameras, 65,536 landmarks,
            196,608 observations, M=4, 3 iterations);
  pose      slam.sfm._jit_optimize_pose_graph against optimize_pose_graph
            on a 52-pose ring with closures padded to 64 poses and 64
            edges (the loop scene's buckets), 60 iterations;
  sync      each solver's replay under torch.cuda.set_sync_debug_mode
            ("error");
  parallel  over a one-rank NCCL mesh: make_distributed_ba at mapping
            size, make_batch_extractor on chip_smoke's 8x480x640 noise
            frames, make_sharded_matcher on its 4096 x 131072 map.

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PARTS = ("ba", "mapping", "pose", "sync", "parallel")


def _ba_scene(dev, n_cam, n_lm, seed=42):
    """tests/test_slam.py's ba_scene at ``n_cam`` cameras and ``n_lm``
    landmarks (every camera sees every landmark), outliers every 37th
    observation, noisy start, two fixed cameras."""
    import numpy as np
    import torch

    from siftmetal_tpu_torch.slam.ba import BAProblem
    from siftmetal_tpu_torch.slam.camera import project

    rng = np.random.default_rng(seed)
    k = np.array([[400, 0, 320], [0, 400, 240], [0, 0, 1]], np.float32)
    lms = rng.uniform([-3, -3, 6], [3, 3, 12], (n_lm, 3)).astype(np.float32)
    cams = np.zeros((n_cam, 6), np.float32)
    cams[:, 3] = np.linspace(-1, 1, n_cam)
    cams[:, :3] = rng.uniform(-0.05, 0.05, (n_cam, 3))
    cam_idx = np.repeat(np.arange(n_cam), n_lm).astype(np.int32)
    lm_idx = np.tile(np.arange(n_lm), n_cam).astype(np.int32)
    uv = project(torch.from_numpy(cams)[cam_idx], torch.from_numpy(k),
                 torch.from_numpy(lms)[lm_idx]).numpy()
    uv[::37] += 40.0
    cams = cams + rng.normal(0, 0.01, cams.shape).astype(np.float32)
    lms = lms + rng.normal(0, 0.05, lms.shape).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return BAProblem(t(cams), t(lms), t(k), t(cam_idx), t(lm_idx), t(uv),
                     torch.ones(len(uv), dtype=torch.bool, device=dev),
                     fixed_cameras=torch.full((), 2, dtype=torch.int64, device=dev))


def pose_ring(dev, n=52, bucket=64, seed=9):
    """A ring of ``n`` poses with odometry and a closure every 10 poses,
    padded to ``bucket`` poses and ``bucket`` edges (weight-0 padding) as
    SfmMap pads the loop scene; noisy poses, one bad edge. Returns
    (PoseGraph, per-edge Huber delta 0.1)."""
    import numpy as np
    import torch

    from siftmetal_tpu_torch.slam.camera import relative
    from siftmetal_tpu_torch.slam.pose_graph import PoseGraph

    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    gt = np.zeros((n, 6), np.float32)
    gt[:, 1], gt[:, 3], gt[:, 5] = ang, 3.0 * np.sin(ang), 3.0 * (1 - np.cos(ang))
    ei = list(range(n - 1)) + list(range(10, n, 10))
    ej = list(range(1, n)) + [i - 10 for i in range(10, n, 10)]
    m = len(ei)
    rel = relative(torch.from_numpy(gt[ei]), torch.from_numpy(gt[ej])).numpy()
    rel[5] += 0.3
    poses = np.zeros((bucket, 6), np.float32)
    poses[:n] = gt + rng.normal(0, 0.05, gt.shape).astype(np.float32)
    poses[0] = gt[0]
    pad = lambda a, shape, dt: np.concatenate([np.asarray(a, dt), np.zeros(shape, dt)])
    args = (poses, pad(ei, bucket - m, np.int32), pad(ej, bucket - m, np.int32),
            pad(rel, (bucket - m, 6), np.float32), pad(np.ones(m), bucket - m, np.float32))
    g = PoseGraph(*(torch.from_numpy(a).to(dev) for a in args), fixed=1)
    return g, torch.full((bucket,), 0.1, device=dev)


def part_ba(dev, smi):
    import torch

    from chip_smoke import _eager_vs_replay, _require
    from siftmetal_tpu_torch.slam import sfm
    from siftmetal_tpu_torch.slam.ba import bundle_adjust

    for n_cam, n_lm in ((8, 256), (16, 1024)):
        p = _ba_scene(dev, n_cam, n_lm)
        _eager_vs_replay(
            "ba", f"bundle_adjust {n_cam} cameras / {n_lm} landmarks, 8 Huber iterations",
            lambda: bundle_adjust(p, n_iterations=8, huber_delta=2.0),
            lambda: sfm.replayed_bundle_adjust(p, 8, 2.0), sfm._BA_GRAPHS, smi)
    before = len(sfm._BA_GRAPHS.graphs)
    p = _ba_scene(dev, 16, 1024)
    outs = []
    for fixed in (3, 9):
        q = p._replace(fixed_cameras=torch.full((), fixed, dtype=torch.int64, device=dev),
                       valid=p.valid & (p.cam_idx >= fixed - 1))
        got = sfm.replayed_bundle_adjust(q, 8, 2.0)
        want = bundle_adjust(q, n_iterations=8, huber_delta=2.0)
        _require(torch.equal(got[0].cameras, want[0].cameras)
                 and torch.equal(got[0].landmarks, want[0].landmarks),
                 f"ba: windowed replay at gauge {fixed} differs from eager")
        outs.append(got[0].cameras)
    added = len(sfm._BA_GRAPHS.graphs) - before
    _require(added == 0, f"ba: windowed calls captured {added} programs, expected the bucket's one")
    _require(not torch.equal(outs[0], outs[1]), "ba: two gauges gave one result")
    print(f"[ba] windowed calls at gauges 3 and 9 (valid masks by window) replayed the bucket's "
          f"one program, each equal to eager bit for bit; programs cached "
          f"{len(sfm._BA_GRAPHS.graphs)}", flush=True)


def part_mapping(dev, smi):
    from chip_smoke import _eager_vs_replay, _mapping_problem
    from siftmetal_tpu_torch.slam import sfm
    from siftmetal_tpu_torch.slam.ba import bundle_adjust

    p = _mapping_problem(dev)
    _eager_vs_replay(
        "mapping", "bundle_adjust 256 cameras / 65536 landmarks / 196608 observations, M=4, "
                   "3 iterations",
        lambda: bundle_adjust(p, n_iterations=3, max_obs_per_landmark=4),
        lambda: sfm.replayed_bundle_adjust(p, 3, 0.0, max_obs_per_landmark=4), sfm._BA_GRAPHS, smi)


def part_pose(dev, smi):
    from chip_smoke import _eager_vs_replay, _require
    from siftmetal_tpu_torch.slam import sfm
    from siftmetal_tpu_torch.slam.pose_graph import optimize_pose_graph

    g, huber = pose_ring(dev)
    _eager_vs_replay(
        "pose", "optimize_pose_graph 64 poses / 64 edges, 60 iterations",
        lambda: optimize_pose_graph(g, n_iterations=60, huber_delta=huber),
        lambda: sfm._jit_optimize_pose_graph(g, 60, huber), sfm._POSE_GRAPH_GRAPHS, smi,
        calls=1, profile_eager=False)
    plans = [[n for _, n in prog.plan] for prog in sfm._POSE_GRAPH_GRAPHS.graphs.values()]
    _require([1, 60, 1] in plans, f"pose: replay plans {plans}")
    print(f"[pose] replay plan (replays a captured graph): {plans}", flush=True)


def part_sync(dev, smi):
    import torch

    from siftmetal_tpu_torch.slam import sfm

    p = _ba_scene(dev, 8, 256)
    g, huber = pose_ring(dev)
    runs = (lambda: sfm.replayed_bundle_adjust(p, 4, 2.0),
            lambda: sfm._jit_optimize_pose_graph(g, 4, huber))
    for run in runs:
        run()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for run in runs:
            run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("[sync] the BA and pose-graph replays ran under set_sync_debug_mode('error')", flush=True)


def part_parallel(dev, smi):
    import torch

    from chip_smoke import _big_map, _eager_vs_replay, _mapping_problem, _noise_frames
    from siftmetal_tpu_torch import SiftConfig
    from siftmetal_tpu_torch.ops import cuda as C
    from siftmetal_tpu_torch.parallel import (
        make_batch_extractor,
        make_distributed_ba,
        make_mesh,
        make_sharded_matcher,
        shard_ba_problem,
    )

    C.build_all()
    mesh = make_mesh()
    try:
        sharded = shard_ba_problem(_mapping_problem(dev), 1, max_obs_per_landmark=4)
        run = make_distributed_ba(mesh, n_iterations=3)
        _eager_vs_replay("parallel", "make_distributed_ba (NCCL, world 1) at mapping size, M=4, "
                         "3 iterations", lambda: run.eager(sharded), lambda: run(sharded),
                         run.graphs, smi)
        x = _noise_frames(dev)
        extract = make_batch_extractor(mesh, 480, 640, SiftConfig())
        _eager_vs_replay("parallel", "make_batch_extractor (NCCL, world 1) 8x480x640",
                         lambda: extract.eager(x), lambda: extract(x), extract.graphs, smi, calls=5)
        q, t, qv, tv, _ = _big_map(dev)
        match = make_sharded_matcher(mesh)
        _eager_vs_replay("parallel", "make_sharded_matcher (NCCL, world 1) 4096 x 131072",
                         lambda: match.eager(q, qv, t, tv), lambda: match(q, qv, t, tv),
                         match.graphs, smi, calls=3)
    finally:
        torch.distributed.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", action="append", choices=PARTS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_graph_solvers: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from siftmetal_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    smi = chip_smoke._smi()
    print(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    for name in args.part or PARTS:
        globals()[f"part_{name}"](dev, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
