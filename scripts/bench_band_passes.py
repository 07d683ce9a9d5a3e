#!/usr/bin/env python3
"""Time the pyramid kernels of one tree of the PyTorch/CUDA port and
fingerprint their outputs, so that two trees can be held against each
other in turns on one card.

    python3 scripts/bench_band_passes.py --tag NAME [--package-root DIR] [--out DIR]
    python3 scripts/bench_band_passes.py --compare A.json B.json

On chip_smoke's seeded 8x480x640 noise frames, for the
``siftmetal_tpu_torch`` under ``--package-root`` (default: this checkout):
the fused seed and the one-shot octave (fp32 and bf16 input, at the shapes
of the parity and fast paths), and the small-octave cascade of octave 3
(parity) and of octave 2 (fast preset, bf16 chain) through the tree's own
route (``blur_cascade`` where the tree has it, else five ``blur_stack``
calls, a stack and a subtraction). Each time is a CUDA-event mean after a
warm-up; beside it the SHA-256 of every output's bytes. Then one parity
``extract_batch`` under the profiler (chip_smoke's ``_profile``) and three
windows of 5 calls. Writes ``<out>/bench_bands_<tag>.json`` (default
``bench_out/`` in this checkout);
``--compare`` prints which outputs two such files share bit for bit.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _compare(a_path: str, b_path: str) -> int:
    a, b = (json.loads(pathlib.Path(p).read_text()) for p in (a_path, b_path))
    for key in a["digests"]:
        same = a["digests"][key] == b["digests"].get(key)
        print(f"[compare] {key}: {'equal bit for bit' if same else 'DIFFERENT'} "
              f"({a['tag']} vs {b['tag']})", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--package-root", default=str(ROOT),
                    help="directory holding the siftmetal_tpu_torch to measure")
    ap.add_argument("--out", default=str(ROOT / "bench_out"),
                    help="directory for the JSON record")
    ap.add_argument("--compare", nargs=2, metavar="JSON")
    args = ap.parse_args()
    if args.compare:
        return _compare(*args.compare)
    package_root = pathlib.Path(args.package_root).resolve()
    import torch

    if not torch.cuda.is_available():
        print("bench_band_passes: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # imports no package at module level

    sys.path.insert(0, str(package_root))
    import siftmetal_tpu_torch
    from siftmetal_tpu_torch import FAST_BF16_CONFIG, SIFT, SiftConfig
    from siftmetal_tpu_torch.ops import cuda as C
    from siftmetal_tpu_torch.ops.image import decimate_2x
    from siftmetal_tpu_torch.ops.kernels import blur as KB
    from siftmetal_tpu_torch.ops.kernels import pyramid as KY
    from siftmetal_tpu_torch.sift.pyramid import cascade_slices

    where = pathlib.Path(siftmetal_tpu_torch.__file__).resolve().parent
    if where.parent != package_root:
        raise RuntimeError(f"imported {where}, not the package under {package_root}")
    smi = chip_smoke._smi()
    print(f"[bands {args.tag}] package {where}; {smi}", flush=True)
    facts = {}
    for log in C.build_all().values():
        facts.update(chip_smoke._ptxas_facts(log))
    facts = {k: v for k, v in facts.items() if "band" in k or "blur_cascade" in k}
    for k, v in sorted(facts.items()):
        print(f"[bands {args.tag}] ptxas {k}: {json.dumps(v)}", flush=True)

    cfg, fast = SiftConfig(), FAST_BF16_CONFIG
    bf = torch.bfloat16
    gray = chip_smoke._noise_frames(torch.device("cuda"))
    n = cfg.n_scales_per_octave
    shapes = cfg.octave_shapes(480, 640, cfg.num_octaves(480, 640))
    fshapes = fast.octave_shapes(480, 640, fast.num_octaves(480, 640))
    one_launch = hasattr(KB, "blur_cascade")

    def cascade(first, c, o):
        if one_launch:
            return KB.blur_cascade(first, c.incremental_sigmas(o), c.pyramid_dtype == "bfloat16")
        stack = torch.stack(cascade_slices(first, o, c), dim=1)
        return stack, stack[:, 1:] - stack[:, :-1]

    def per_step(first, c, o):
        stack = torch.stack(cascade_slices(first, o, c), dim=1)
        return stack, stack[:, 1:] - stack[:, :-1]

    g0, d0 = KY.seed_octave(gray, cfg)
    first1 = decimate_2x(g0[:, n], shapes[1]).contiguous()
    g1, d1 = KY.octave_oneshot(first1, cfg)
    first2 = decimate_2x(g1[:, n], shapes[2]).contiguous()
    g2, _ = KY.octave_oneshot(first2, cfg)
    first3 = decimate_2x(g2[:, n], shapes[3]).contiguous()
    gray16 = gray.to(bf)
    f0, fd0 = KY.seed_octave(gray16, fast)
    ffirst1 = decimate_2x(f0[:, n].to(bf), fshapes[1]).contiguous()
    f1, fd1 = KY.octave_oneshot(ffirst1, fast)
    ffirst2 = decimate_2x(f1[:, n].to(bf), fshapes[2]).contiguous()
    runs = {
        "seed_octave 8x480x640": lambda: KY.seed_octave(gray, cfg),
        "octave_oneshot 8x480x640": lambda: KY.octave_oneshot(first1, cfg),
        "seed_octave_bf16 8x480x640": lambda: KY.seed_octave(gray16, fast),
        "octave_oneshot_bf16 8x240x320": lambda: KY.octave_oneshot(ffirst1, fast),
        "cascade octave 3 8x120x160": lambda: cascade(first3, cfg, 3),
        "cascade_bf16 octave 2 8x120x160": lambda: cascade(ffirst2, fast, 2),
        "per-step cascade octave 3 8x120x160": lambda: per_step(first3, cfg, 3),
        "per-step cascade_bf16 octave 2 8x120x160": lambda: per_step(ffirst2, fast, 2),
    }
    out = {"tag": args.tag, "card": smi, "one_launch_cascade": one_launch, "ms": {},
           "digests": {}, "ptxas": facts}
    for name, fn in runs.items():
        out["digests"][name] = _digest(*fn())
        out["ms"][name] = chip_smoke._time_ms(fn, 20 if "cascade" in name else 10)
        print(f"[bands {args.tag}] {name}: {out['ms'][name]:.4f} ms, outputs "
              f"{out['digests'][name]}", flush=True)
    del g0, d0, g1, d1, g2, f0, fd0, f1, fd1

    sift = SIFT(480, 640)
    sift.extract_batch(gray)
    torch.cuda.synchronize()
    chip_smoke._profile(f"bands {args.tag}", lambda: sift.extract_batch(gray))
    windows = chip_smoke._windows(lambda: sift.extract_batch(gray), 3, 5)
    out["ms_per_batch"] = windows
    print(f"[bands {args.tag}] parity extract_batch 8x480x640: windows of 5 calls "
          f"{', '.join(f'{w:.3f}' for w in windows)} ms/batch ({smi})", flush=True)
    dest = pathlib.Path(args.out) / f"bench_bands_{args.tag}.json"
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
