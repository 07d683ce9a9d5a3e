#!/usr/bin/env python3
"""Profile one extract_batch of the PyTorch/CUDA port under each patch
switch and print its device busy time and its patch kernels by form.

    python3 scripts/profile_patch_forms.py [--package-root DIR]

Runs ``SIFT(480, 640)`` once under ``torch.profiler`` (chip_smoke's
``_profile``) with ``use_fused_describe=True`` on chip_smoke's seeded
noise frames, and with ``use_band_patches=True`` on the proc_a views of
its pair phase. ``--package-root`` names the directory whose
``siftmetal_tpu_torch`` is profiled (default: this checkout), so that two
trees can be measured in turns on one card in one run. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package-root", default=str(ROOT),
                    help="directory holding the siftmetal_tpu_torch to profile")
    package_root = pathlib.Path(ap.parse_args().package_root).resolve()
    import torch

    if not torch.cuda.is_available():
        print("profile_patch_forms: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # imports no package at module level

    sys.path.insert(0, str(package_root))
    import siftmetal_tpu_torch
    from siftmetal_tpu_torch import SIFT, SiftConfig

    where = pathlib.Path(siftmetal_tpu_torch.__file__).resolve().parent
    if where.parent != package_root:
        raise RuntimeError(f"imported {where}, not the package under {package_root}")
    print(f"[forms] package {where}; {chip_smoke._smi()}", flush=True)
    dev = torch.device("cuda")
    runs = {"fused": (SiftConfig(use_fused_describe=True), chip_smoke._noise_frames(dev)),
            "band": (SiftConfig(use_band_patches=True), chip_smoke._pair_frames(dev)[0])}
    for tag, (cfg, frames) in runs.items():
        sift = SIFT(480, 640, cfg)
        sift.extract_batch(frames)      # builds, tables, allocator
        torch.cuda.synchronize()
        chip_smoke._profile(tag, lambda: sift.extract_batch(frames))
    return 0


if __name__ == "__main__":
    sys.exit(main())
