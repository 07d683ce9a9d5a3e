"""HPatches repeatability runner on the PyTorch/CUDA port.

The counterpart of ``scripts/run_hpatches.py`` on ``siftmetal_tpu_torch``:
the same arguments plus ``--device``, the same per-sequence JSON lines and
final summary line. It consumes the standard
``hpatches-sequences-release`` layout (``siftmetal_tpu_torch/utils/
datasets.py``): for every sequence it extracts keypoints on image 1 and
images 2..6 and scores the repeatability of image 1's keypoints under the
published homographies (Mikolajczyk et al. 2005), scored as the port's
warp battery scores it (``utils/repeatability.py``).

    python scripts/run_hpatches_torch.py /data/hpatches-sequences-release
    python scripts/run_hpatches_torch.py /data/hp --config=fast --limit 20
    python scripts/run_hpatches_torch.py tests/fixtures/hpatches_mini --device cpu

Runs on the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from siftmetal_tpu_torch.config import FAST_BF16_CONFIG, FAST_CONFIG, SiftConfig
from siftmetal_tpu_torch.utils.datasets import (
    hpatches_image_path,
    hpatches_sequences,
    load_gray,
    load_homography_rowcol,
)
from siftmetal_tpu_torch.utils.repeatability import keypoint_array, repeatability

CONFIGS = {
    "default": SiftConfig(),
    "fast": FAST_CONFIG,
    "fast_bf16": FAST_BF16_CONFIG,
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("root", help="hpatches-sequences-release dir (or one sequence)")
    ap.add_argument("--config", default="default", choices=sorted(CONFIGS))
    ap.add_argument("--limit", type=int, default=0, help="max sequences (0 = all)")
    ap.add_argument("--n-images", type=int, default=6)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from siftmetal_tpu_torch.device import resolve_device
    from siftmetal_tpu_torch.sift.extract import SIFT

    dev = resolve_device(args.device)
    config = CONFIGS[args.config]
    seqs = hpatches_sequences(args.root)
    if args.limit:
        seqs = seqs[: args.limit]
    if not seqs:
        raise SystemExit(f"no HPatches sequences under {args.root}")

    sift_cache: dict = {}

    def extract(gray: np.ndarray):
        shape = gray.shape
        if shape not in sift_cache:
            sift_cache[shape] = SIFT(shape[0], shape[1], config, device=dev)
        kp, _, _ = sift_cache[shape].extract(gray)
        return keypoint_array(kp)

    per_split: dict = {"i": [], "v": []}
    results = []
    for seq in seqs:
        g1 = load_gray(str(hpatches_image_path(seq, 1)))
        pts1, sig1 = extract(g1)
        scores = {}
        for k in range(2, args.n_images + 1):
            h_p = seq / f"H_1_{k}"
            if not h_p.exists():
                continue
            gk = load_gray(str(hpatches_image_path(seq, k)))
            hmat = load_homography_rowcol(h_p)
            ptsk, _ = extract(gk)
            scores[k] = repeatability(pts1, sig1, ptsk, hmat, gk.shape)
        vals = [v for v in scores.values() if not np.isnan(v)]
        mean = float(np.mean(vals)) if vals else float("nan")
        # Unknown-prefix directories go to their own bucket so they can't
        # skew the illumination/viewpoint split means.
        split = seq.name[0] if seq.name[:2] in ("i_", "v_") else "other"
        if not np.isnan(mean):
            per_split.setdefault(split, []).append(mean)
        row = {
            "sequence": seq.name,
            "repeatability": round(mean, 4),
            "per_image": {str(k): round(float(v), 4) for k, v in scores.items()},
            "n_ref_keypoints": int(len(pts1)),
            "config": args.config,
        }
        results.append(row)
        print(json.dumps(row), flush=True)

    summary = {
        "metric": "hpatches_repeatability",
        "mean_illumination": round(float(np.mean(per_split["i"])), 4)
        if per_split["i"] else None,
        "mean_viewpoint": round(float(np.mean(per_split["v"])), 4)
        if per_split["v"] else None,
        "mean_overall": round(
            float(np.mean(per_split["i"] + per_split["v"])), 4
        ) if (per_split["i"] or per_split["v"]) else None,
        "n_sequences": len(results),
        "config": args.config,
        "baseline_bar": 0.9,
    }
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
