"""TUM RGB-D ATE runner on the PyTorch/CUDA port.

The counterpart of ``scripts/run_tum.py`` on ``siftmetal_tpu_torch``: the
same arguments plus ``--device``, the same final JSON line. It consumes a
standard TUM RGB-D sequence directory (``rgb.txt`` + ``rgb/*.png`` +
``groundtruth.txt``; ``siftmetal_tpu_torch/utils/datasets.py``), runs SIFT
extraction and the incremental SfM back-end (PnP, triangulation, periodic
windowed BA, optional loop closure + pose graph), writes the estimated
trajectory in TUM format, and scores ATE RMSE against the ground truth
with the standard timestamp-association + similarity-alignment protocol.

    python scripts/run_tum_torch.py /data/rgbd_dataset_freiburg1_desk
    python scripts/run_tum_torch.py /data/fr1_desk --stride 3 --max-frames 120

Prints progress to stderr and ONE final JSON line to stdout. Runs on the
CUDA card unless ``--device cpu`` is given. Default intrinsics are the TUM
Freiburg-1 calibration (fr1/desk); pass --fx/--fy/--cx/--cy for other
cameras.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from siftmetal_tpu_torch.config import FAST_BF16_CONFIG, FAST_CONFIG, SiftConfig
from siftmetal_tpu_torch.utils.datasets import (
    associate_ate,
    load_gray,
    tum_frames,
    tum_groundtruth,
)

CONFIGS = {
    "default": SiftConfig(),
    "fast": FAST_CONFIG,
    "fast_bf16": FAST_BF16_CONFIG,
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("sequence", help="TUM sequence dir (rgb.txt + groundtruth.txt)")
    ap.add_argument("--config", default="default", choices=sorted(CONFIGS))
    ap.add_argument("--stride", type=int, default=2, help="keyframe stride")
    ap.add_argument("--max-frames", type=int, default=0, help="0 = all")
    ap.add_argument("--ba-every", type=int, default=8,
                    help="windowed BA every N keyframes")
    ap.add_argument("--ba-window", type=int, default=16)
    ap.add_argument("--loop-closure", action="store_true",
                    help="detect loop closures during the run and correct "
                    "the trajectory with pose-graph optimization")
    ap.add_argument("--loop-every", type=int, default=5,
                    help="with --loop-closure: attempt detection every N "
                    "registered keyframes (detection proposes closures for "
                    "the latest keyframe only)")
    ap.add_argument("--max-cameras", type=int, default=512)
    ap.add_argument("--max-landmarks", type=int, default=32768)
    ap.add_argument("--max-observations", type=int, default=262144)
    ap.add_argument("--fx", type=float, default=517.3)
    ap.add_argument("--fy", type=float, default=516.5)
    ap.add_argument("--cx", type=float, default=318.6)
    ap.add_argument("--cy", type=float, default=255.3)
    ap.add_argument("--out", default="", help="trajectory output path "
                    "(default <sequence>/trajectory_siftmetal.txt)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from siftmetal_tpu_torch.device import resolve_device
    from siftmetal_tpu_torch.sift.extract import SIFT
    from siftmetal_tpu_torch.slam.sfm import SfmConfig, SfmMap
    from siftmetal_tpu_torch.utils.checkpoint import save_trajectory_tum

    dev = resolve_device(args.device)

    ts, paths = tum_frames(args.sequence)
    idx = np.arange(0, len(paths), args.stride)
    if args.max_frames:
        idx = idx[: args.max_frames]
    if len(idx) < 2:
        raise SystemExit(f"need >= 2 frames, got {len(idx)}")

    k = np.array(
        [[args.fx, 0, args.cx], [0, args.fy, args.cy], [0, 0, 1]],
        dtype=np.float32,
    )

    # Front-end: extract every selected frame.
    t0 = time.perf_counter()
    first = load_gray(paths[idx[0]])
    h, w = first.shape
    sift = SIFT(h, w, CONFIGS[args.config], device=dev)
    frames, used_ts = [], []
    for n, i in enumerate(idx):
        gray = first if n == 0 else load_gray(paths[i])
        _, descs, _ = sift.extract(gray)
        frames.append(
            (torch.stack([descs.x, descs.y], dim=1), descs.features, descs.valid)
        )
        used_ts.append(float(ts[i]))
        if n % 20 == 0:
            log(f"extracted {n + 1}/{len(idx)}")
    t_extract = time.perf_counter() - t0

    # Back-end: incremental SfM.
    t0 = time.perf_counter()
    smap = SfmMap(
        k,
        SfmConfig(
            max_cameras=args.max_cameras,
            max_landmarks=args.max_landmarks,
            max_observations=args.max_observations,
        ),
        device=dev,
    )
    n_lm = smap.initialize(frames[0], frames[1])
    log(f"bootstrap: {n_lm} landmarks")
    reg_ts = [used_ts[0], used_ts[1]]
    n_failed = 0
    loops: list = []
    for n in range(2, len(frames)):
        ok, n_in, n_new = smap.add_frame(frames[n])
        if not ok:
            n_failed += 1
            log(f"frame {n}: tracking failed ({n_in} inliers), skipped")
            continue
        reg_ts.append(used_ts[n])
        if smap.n_cameras % args.ba_every == 0:
            smap.bundle_adjust(window=args.ba_window)
        # detect_loop_closures proposes edges for the LATEST keyframe
        # only, so it must run during the loop (running it once at the
        # end would only ever close against the final keyframe), and a
        # detected closure must be fed to the pose graph.
        if args.loop_closure and smap.n_cameras % args.loop_every == 0:
            new_loops = smap.detect_loop_closures()
            if new_loops:
                log(f"keyframe {smap.n_cameras - 1}: "
                    f"{len(new_loops)} loop closure(s)")
                loops.extend(new_loops)
                smap.optimize_pose_graph(loop_closures=loops)
                smap.bundle_adjust(window=args.ba_window)
    if args.loop_closure:
        final_loops = smap.detect_loop_closures()
        if final_loops:
            loops.extend(final_loops)
        log(f"loop closures: {len(loops)}")
        if loops:
            smap.optimize_pose_graph(loop_closures=loops)
    stats = smap.bundle_adjust()
    t_sfm = time.perf_counter() - t0

    out_path = args.out or str(
        pathlib.Path(args.sequence) / "trajectory_siftmetal.txt"
    )
    cams = smap.cameras[: smap.n_cameras]
    save_trajectory_tum(out_path, np.asarray(reg_ts), cams)

    gt_ts, gt_pos = tum_groundtruth(args.sequence)
    ate, n_assoc = associate_ate(reg_ts, cams, gt_ts, gt_pos)

    summary = {
        "metric": "tum_ate_rmse",
        "sequence": pathlib.Path(args.sequence).name,
        "ate_rmse_m": round(float(ate), 4) if np.isfinite(ate) else None,
        "n_keyframes": int(smap.n_cameras),
        "n_failed": n_failed,
        "n_landmarks": int(smap.n_landmarks),
        "n_associated": n_assoc,
        "n_loop_closures": len(loops),
        "reproj_rms_px": round(smap.reprojection_rms(), 3),
        "ba_final_cost": round(float(stats.final_cost), 1),
        "extract_s": round(t_extract, 1),
        "sfm_s": round(t_sfm, 1),
        "config": args.config,
        "trajectory": out_path,
    }
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
