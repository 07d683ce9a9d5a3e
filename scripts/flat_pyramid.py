#!/usr/bin/env python3
"""What a flat image leaves in each package's pyramid and detector.

    python3 scripts/flat_pyramid.py --package torch [--device cpu|cuda]
    python3 scripts/flat_pyramid.py --package jax

A constant 0.5 frame through ``SIFT(h, w, cfg).extract``: 64x96 and
200x300 under tests/test_edge_cases.py's budgets, 480x640 under
``SiftConfig()``; prints ``n_extrema`` (a flat frame has no extremum).
Then the fused seed of a flat 200x256 frame and the one-shot octave of a
flat 200x256 first slice: of the Gaussian planes, how many hold more than
one value and the largest spread (max - min) of one; of the DoG samples,
how many differ from their plane's first sample. ``--package torch`` runs
``siftmetal_tpu_torch`` on ``--device`` (its plain versions on the CPU,
its kernels on the card); ``--package jax`` runs ``siftmetal_tpu`` on the
CPU, extraction through its CPU route and the two octaves through its
Pallas kernels in interpret mode (the TPU route's arithmetic).
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

EDGE = dict(max_extrema_per_octave=512, max_keypoints=256, max_descriptors=256)
EXTRACT = ((64, 96, EDGE), (200, 300, EDGE), (480, 640, {}))


def _octave_stats(name, gauss, dog):
    """One line of the spread of a [B, S, H, W] octave's planes."""
    g = np.asarray(gauss, np.float64).reshape(-1, gauss.shape[-2] * gauss.shape[-1])
    d = np.asarray(dog, np.float64).reshape(-1, dog.shape[-2] * dog.shape[-1])
    spread = g.max(1) - g.min(1)
    off = int((d != d[:, :1]).sum())
    print(f"[flat] {name}: {int((spread > 0).sum())} of {len(g)} Gaussian planes hold more "
          f"than one value, largest spread {spread.max():.3e}; {off} of {d.size} DoG samples "
          f"differ from their plane's first", flush=True)


def torch_counts(device):
    import torch

    from siftmetal_tpu_torch import SIFT, SiftConfig
    from siftmetal_tpu_torch.device import resolve_device
    from siftmetal_tpu_torch.ops.kernels import pyramid as KY

    dev = resolve_device(device)
    for h, w, kw in EXTRACT:
        _, _, ctr = SIFT(h, w, SiftConfig(**kw), device=dev).extract(
            np.full((h, w), 0.5, np.float32))
        print(f"[flat] torch ({dev}) {h}x{w}: n_extrema {int(ctr['n_extrema'])}", flush=True)
    cfg = SiftConfig()
    flat = torch.full((1, 200, 256), 0.5, device=dev)
    _octave_stats(f"torch ({dev}) seed_octave 200x256",
                  *(t.cpu().numpy() for t in KY.seed_octave(flat, cfg)))
    _octave_stats(f"torch ({dev}) octave_oneshot 200x256",
                  *(t.cpu().numpy() for t in KY.octave_oneshot(flat, cfg)))


def jax_counts():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from siftmetal_tpu.config import SiftConfig
    from siftmetal_tpu.ops.pallas import pyramid as JP
    from siftmetal_tpu.sift.extract import SIFT

    for h, w, kw in EXTRACT:
        _, _, ctr = SIFT(h, w, SiftConfig(**kw)).extract(np.full((h, w), 0.5, np.float32))
        print(f"[flat] jax (cpu) {h}x{w}: n_extrema {int(ctr['n_extrema'])}", flush=True)
    cfg = SiftConfig()
    flat = jnp.full((1, 200, 256), 0.5, jnp.float32)
    _octave_stats("jax seed_octave_pallas (interpret) 200x256",
                  *JP.seed_octave_pallas(flat, cfg, interpret=True))
    _octave_stats("jax octave_oneshot_pallas (interpret) 200x256",
                  *JP.octave_oneshot_pallas(flat, cfg, interpret=True))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("torch", "jax"), required=True)
    ap.add_argument("--device", default="cuda", help="the port's device (torch only)")
    args = ap.parse_args()
    if args.package == "torch":
        torch_counts(args.device)
    else:
        jax_counts()
    return 0


if __name__ == "__main__":
    sys.exit(main())
