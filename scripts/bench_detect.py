#!/usr/bin/env python3
"""Time the detection kernel of one tree of the PyTorch/CUDA port and
fingerprint its outputs, so that two trees can be held against each other
in turns on one card.

    python3 scripts/bench_detect.py --tag NAME [--package-root DIR] [--out DIR]
    python3 scripts/bench_detect.py --compare A.json B.json

On chip_smoke's seeded 8x480x640 noise frames, for the
``siftmetal_tpu_torch`` under ``--package-root`` (default: this checkout):
detection at octave 0 of the parity pyramid in both forms (full and lean),
and over every octave of one parity batch and one FAST_BF16 batch: the
tree's detection launches alone (``detect_candidates_octaves`` where the
tree has it, else one ``detect_candidates`` an octave) and the tree's own
``detect_all_octaves_batch`` (detection and the refinement tail). Each
time is given three ways: device ms of the detection kernels under the
profiler, ms per call with the calls queued behind a sleep kernel (device
time of everything the call launches; not for the tail, which reads values
on the host), and ms per call on the host's clock (CUDA events, 10 calls
back to back). Beside each, the SHA-256 of
every output. Then one parity ``extract_batch`` under the profiler
(chip_smoke's ``_profile``: device busy, device ops, idle share) and three
windows of 5 calls. Writes ``<out>/bench_detect_<tag>.json`` (default
``bench_out/`` in this checkout); ``--compare`` prints which outputs two
such files share bit for bit. Needs a CUDA card.
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


def _tensors(obj):
    """Every tensor in nested tuples / lists / dicts / named tuples, in order."""
    import torch

    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for k in sorted(obj) for t in _tensors(obj[k])]
    if isinstance(obj, (tuple, list)):
        return [t for x in obj for t in _tensors(x)]
    return []


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
        print("bench_detect: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # imports no package at module level

    sys.path.insert(0, str(package_root))
    import siftmetal_tpu_torch
    from siftmetal_tpu_torch import FAST_BF16_CONFIG, SIFT, SiftConfig
    from siftmetal_tpu_torch.ops import cuda as C
    from siftmetal_tpu_torch.ops.kernels import detect as KD
    from siftmetal_tpu_torch.sift import detect as DT
    from siftmetal_tpu_torch.sift.batched import build_pyramid_batch

    where = pathlib.Path(siftmetal_tpu_torch.__file__).resolve().parent
    if where.parent != package_root:
        raise RuntimeError(f"imported {where}, not the package under {package_root}")
    smi = chip_smoke._smi()
    print(f"[detect {args.tag}] package {where}; {smi}", flush=True)
    facts = {}
    for log in C.build_all().values():
        facts.update(chip_smoke._ptxas_facts(log))
    facts = {k: v for k, v in facts.items() if "detect_kernel" in k and ("Li5E" in k or "ELi" not in k)}
    for k, v in sorted(facts.items()):
        print(f"[detect {args.tag}] ptxas {k}: {json.dumps(v)}", flush=True)

    gray = chip_smoke._noise_frames(torch.device("cuda"))
    one_launch = hasattr(KD, "detect_candidates_octaves")
    out = {"tag": args.tag, "card": smi, "one_launch": one_launch, "ms": {}, "digests": {},
           "ptxas": facts}

    def detection(dogs, cfg, fields=True):
        thr = 0.8 * cfg.dog_threshold
        if one_launch:
            return KD.detect_candidates_octaves(dogs, thr, cfg.edge_threshold, emit_fields=fields)
        return [KD.detect_candidates(d, thr, cfg.edge_threshold, emit_fields=fields) for d in dogs]

    runs = {}
    for label, cfg in (("parity", SiftConfig()), ("fast_bf16", FAST_BF16_CONFIG)):
        _, dogs = build_pyramid_batch(gray, cfg, cfg.num_octaves(480, 640))
        if label == "parity":
            d0 = dogs[0]
            thr = 0.8 * cfg.dog_threshold
            runs["octave 0 full 8x5x960x1280"] = (
                lambda d0=d0, thr=thr, c=cfg: KD.detect_candidates(d0, thr, c.edge_threshold), True)
            runs["octave 0 lean 8x5x960x1280"] = (
                lambda d0=d0, thr=thr, c=cfg: KD.detect_candidates(d0, thr, c.edge_threshold,
                                                                    emit_fields=False), True)
        runs[f"{label} batch detection ({len(dogs)} octaves)"] = (
            lambda dogs=dogs, c=cfg: detection(dogs, c), True)
        runs[f"{label} batch detection, lean"] = (
            lambda dogs=dogs, c=cfg: detection(dogs, c, False), True)
        runs[f"{label} batch detect_all_octaves_batch"] = (
            lambda dogs=dogs, c=cfg: DT.detect_all_octaves_batch(dogs, c), False)
    for name, (fn, kernel_only) in runs.items():
        out["digests"][name] = _digest(*_tensors(fn()))
        dev = chip_smoke._device_ms(fn, ("detect_kernel",), 5)["detect_kernel"]
        # The tail reads values on the host, so its calls cannot queue.
        queued = chip_smoke._queued_ms(fn) if kernel_only else None
        host = chip_smoke._time_ms(fn, 10)
        out["ms"][name] = {"device": dev, "queued": queued, "host": host}
        q = "" if queued is None else f"queued {queued:.4f} ms, "
        print(f"[detect {args.tag}] {name}: detection kernels {dev:.4f} ms of device time, "
              f"{q}host's clock {host:.4f} ms; outputs {out['digests'][name]}", flush=True)
    del runs

    sift = SIFT(480, 640)
    sift.extract_batch(gray)
    torch.cuda.synchronize()
    chip_smoke._profile(f"detect {args.tag}", lambda: sift.extract_batch(gray))
    windows = chip_smoke._windows(lambda: sift.extract_batch(gray), 3, 5)
    out["ms_per_batch"] = windows
    print(f"[detect {args.tag}] parity extract_batch 8x480x640: windows of 5 calls "
          f"{', '.join(f'{w:.3f}' for w in windows)} ms/batch ({smi})", flush=True)
    dest = pathlib.Path(args.out) / f"bench_detect_{args.tag}.json"
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
