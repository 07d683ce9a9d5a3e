#!/usr/bin/env python3
"""Time one tree's extraction facade against its eager pipeline, so that
two trees can be held against each other in turns on one card.

    python3 scripts/bench_graph_facade.py --tag NAME [--package-root DIR]

On chip_smoke's seeded 8x480x640 noise frames, for the
``siftmetal_tpu_torch`` under ``--package-root`` (default: this
checkout), in the parity configuration and under FAST_BF16_CONFIG: the
first ``SIFT.extract_batch`` call's seconds (where the tree captures a
CUDA graph: the eager warm-up and the capture), then
``SIFT.extract_batch`` (a graph replay where the tree has one, else the
eager pipeline) and the eager ``extract_gray_batch`` in turns, three
windows of 5 calls each (CUDA events), and one call of each under the
profiler (wall, device busy as the union of kernel spans, device ops,
idle share). Beside each route, the SHA-256 of its outputs: two trees'
lines with one digest give the same bits. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _digest(result) -> str:
    """SHA-256 of every tensor of a (Keypoints, Descriptors, counters)."""
    kps, descs, ctr = result
    h = hashlib.sha256()
    for t in [*kps, *descs, *(ctr[k] for k in sorted(ctr))]:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--package-root", default=str(ROOT),
                    help="directory holding the siftmetal_tpu_torch to measure")
    args = ap.parse_args()
    package_root = pathlib.Path(args.package_root).resolve()
    import torch

    if not torch.cuda.is_available():
        print("bench_graph_facade: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # imports no package at module level

    sys.path.insert(0, str(package_root))
    import siftmetal_tpu_torch
    from siftmetal_tpu_torch import FAST_BF16_CONFIG, SIFT, SiftConfig, extract_gray_batch
    from siftmetal_tpu_torch.ops import cuda as C

    where = pathlib.Path(siftmetal_tpu_torch.__file__).resolve().parent
    if where.parent != package_root:
        raise RuntimeError(f"imported {where}, not the package under {package_root}")
    smi = chip_smoke._smi()
    tag = f"[facade {args.tag}]"
    print(f"{tag} package {where}; {smi}", flush=True)
    C.build_all()
    x = chip_smoke._noise_frames(torch.device("cuda"))
    for label, cfg in (("parity", SiftConfig()), ("fast_bf16", FAST_BF16_CONFIG)):
        sift = SIFT(480, 640, cfg)
        extract_gray_batch(x, cfg, sift.n_octaves)          # the tables and the libraries
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sift.extract_batch(x)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        routes = {"extract_batch": lambda: sift.extract_batch(x),
                  "eager": lambda: extract_gray_batch(x, cfg, sift.n_octaves)}
        windows = {k: [] for k in routes}
        for _ in range(3):
            for k, fn in routes.items():
                windows[k] += chip_smoke._windows(fn, 1, 5)
        for k, fn in routes.items():
            digest = _digest(fn())
            wall, busy, kern, *_ = chip_smoke._device_profile(fn)
            med = chip_smoke._median(windows[k])
            print(f"{tag} {label} {k}: median {med:.3f} ms/batch, {8e3 / med:.2f} frames/s (windows "
                  f"of 5, in turns: {', '.join(f'{w:.3f}' for w in windows[k])}); profiled call: "
                  f"wall {wall:.3f} ms, busy {busy:.3f} ms in {len(kern)} device ops, idle "
                  f"{100.0 * (1.0 - busy / wall):.1f}%; outputs {digest}",
                  flush=True)
        print(f"{tag} {label}: first extract_batch {first_s:.3f} s ({smi})", flush=True)
        del sift
    return 0


if __name__ == "__main__":
    sys.exit(main())
