#!/usr/bin/env python3
"""Time the fused cascade (PERF.md row 7) and the orientation kernel (row
5) of one tree of the PyTorch/CUDA port and fingerprint their outputs, so
that two trees can be held against each other in turns on one card.

    python3 scripts/bench_cascade_orient.py --tag NAME [--package-root DIR] [--out DIR] [--sweep]
    python3 scripts/bench_cascade_orient.py --compare A.json B.json

On chip_smoke's seeded 8x480x640 noise frames, for the
``siftmetal_tpu_torch`` under ``--package-root`` (default: this checkout):

  * row 7: ``octave_cascade`` on the parity seed (8x960x1280) and on its
    every other pixel (8x480x640), with the SHA-256 of every gauss and dog
    plane;
  * row 5: ``orientation_hist_lanes`` on the octave-0 lanes of the parity
    batch, and the orientation stage of one parity and one FAST_BF16
    ``extract_batch`` (every octave's compacted keypoints): the tree's
    one-launch ``orientation_hist_octaves`` where it has it, else one
    launch an octave and a concatenation, with the SHA-256 of the rows.

Each time three ways: device ms of the kernel under torch.profiler, ms per
call queued behind a sleep kernel (the device time of everything the call
launches), ms per call on the host's clock (CUDA events, back to back).
Then one call of the parity, fast and fused-cascade ``extract_batch``
under the profiler (chip_smoke's ``_profile``: device busy, device ops,
idle share). ``--sweep`` adds the cascade's strip x band sweep (trees
that have it). Writes ``<out>/bench_cascade_orient_<tag>.json`` (default
``bench_out/``); ``--compare`` prints which outputs two such files share
bit for bit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CASCADE = ("cascade_kernel", "stream_kernel")   # the first design's and the streamed kernel
ORIENT = ("::orientation_kernel",)


def _digest(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


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
    ap.add_argument("--out", default=str(ROOT / "bench_out"))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--compare", nargs=2, metavar="JSON")
    args = ap.parse_args()
    if args.compare:
        return _compare(*args.compare)
    package_root = pathlib.Path(args.package_root).resolve()
    import torch

    if not torch.cuda.is_available():
        print("bench_cascade_orient: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # imports no package at module level

    sys.path.insert(0, str(package_root))
    import siftmetal_tpu_torch
    from siftmetal_tpu_torch import FAST_BF16_CONFIG, SIFT, SiftConfig
    from siftmetal_tpu_torch.ops import cuda as C
    from siftmetal_tpu_torch.ops.kernels import cascade as KC
    from siftmetal_tpu_torch.ops.kernels import patches as KP
    from siftmetal_tpu_torch.sift import detect as DT
    from siftmetal_tpu_torch.sift.batched import build_pyramid_batch
    from siftmetal_tpu_torch.sift.pyramid import seed_image

    where = pathlib.Path(siftmetal_tpu_torch.__file__).resolve().parent
    if where.parent != package_root:
        raise RuntimeError(f"imported {where}, not the package under {package_root}")
    smi = chip_smoke._smi()
    tag = args.tag
    print(f"[bench {tag}] package {where}; {smi}", flush=True)
    facts = {}
    for log in C.build_all().values():
        facts.update(chip_smoke._ptxas_facts(log))
    facts = {k: v for k, v in facts.items() if any(f in k for f in
             ("cascade_kernel", "stream_kernel", "orientation_kernel"))}
    for k, v in sorted(facts.items()):
        print(f"[bench {tag}] ptxas {k}: {json.dumps(v)}", flush=True)
    out = {"tag": tag, "card": smi, "ms": {}, "digests": {}, "ptxas": facts}

    def timed(name, fn, frags, digest=True):
        res = fn()
        if digest:
            tensors = res if isinstance(res, (tuple, list)) else (res,)
            for i, t in enumerate(tensors):
                out["digests"][f"{name} [{i}]"] = _digest(t)
        dev = sum(chip_smoke._device_ms(fn, frags, 5).values())
        queued = chip_smoke._queued_ms(fn)
        host = chip_smoke._time_ms(fn, 10)
        out["ms"][name] = {"device": dev, "queued": queued, "host": host}
        print(f"[bench {tag}] {name}: {dev:.4f} ms of device time, queued {queued:.4f} ms, "
              f"host's clock {host:.4f} ms", flush=True)
        return res

    cfg = SiftConfig()
    gray = chip_smoke._noise_frames(torch.device("cuda"))
    seed0 = seed_image(gray, cfg)
    seed1 = seed0[:, ::2, ::2].contiguous()
    n_st = len(cfg.incremental_sigmas(0))
    for label, first in (("8x960x1280", seed0), ("8x480x640", seed1)):
        g, d = KC.octave_cascade(first, cfg)
        for s in range(n_st + 1):
            out["digests"][f"row 7 {label} gauss {s}"] = _digest(g[:, s])
        for s in range(n_st):
            out["digests"][f"row 7 {label} dog {s}"] = _digest(d[:, s])
        del g, d
        timed(f"row 7 {label}", lambda first=first: KC.octave_cascade(first, cfg), CASCADE, False)
        print(f"[bench {tag}] row 7 {label} planes: " + ", ".join(
            f"{k[len(f'row 7 {label} '):]} {v}" for k, v in out["digests"].items()
            if k.startswith(f"row 7 {label}")), flush=True)
    if args.sweep and hasattr(KC, "STRIP_CHOICES"):
        for label, first in (("8x960x1280", seed0), ("8x480x640", seed1)):
            ref = KC.octave_cascade(first, cfg)
            line = []
            for strip in KC.STRIP_CHOICES:
                for band in KC.BAND_CHOICES:
                    fn = lambda: KC.octave_cascade(first, cfg, strip, band)
                    got = fn()
                    if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
                        raise AssertionError(f"cascade at strip {strip} band {band} differs")
                    ms = sum(chip_smoke._device_ms(fn, CASCADE, 5).values())
                    out["ms"][f"sweep {label} strip {strip} band {band}"] = ms
                    line.append(f"{strip}x{band} {ms:.4f}")
            auto = KC.cascade_plan(cfg, *first.shape, sms=torch.cuda.get_device_properties(0)
                                   .multi_processor_count).band
            print(f"[bench {tag}] row 7 {label} sweep (strip x band: device ms; default strip "
                  f"{KC.STRIP}, band {auto} to fill one wave): " + "; ".join(line), flush=True)
    del seed0, seed1

    one_launch = hasattr(KP, "orientation_hist_octaves")
    for label, c in (("parity", cfg), ("fast_bf16", FAST_BF16_CONFIG)):
        gauss, dogs = build_pyramid_batch(gray, c, c.num_octaves(480, 640))
        per_octave, _ = DT.detect_all_octaves_batch(dogs, c)
        kpcs, fields = [], []
        for o, dg in enumerate(dogs):
            budget = DT.keypoint_budget(c, tuple(dg.shape[-2:]), o)
            kpcs.append(DT.compact_octave_keypoints(per_octave[o], o, c, budget)[0])
            fields.append(KP.prepare_patch_fields(gauss[o], c))
        b = gray.shape[0]

        def staged(kpcs=kpcs, fields=fields, c=c):
            rows = []
            for f, k in zip(fields, kpcs):
                n = k.valid.shape[1]
                fl = lambda a: a.reshape(-1)
                frame = torch.arange(b, dtype=torch.int32, device=gray.device).repeat_interleave(n)
                rows.append(KP.orientation_hist_lanes(
                    f, fl(k.scale), fl(k.x_oct), fl(k.y_oct), fl(k.sigma_oct), c,
                    valid=fl(k.valid), frame=frame).reshape(b, n, -1))
            return torch.cat(rows, 1)

        if label == "parity":
            k0, f0 = kpcs[0], fields[0]
            fl = lambda a: a.reshape(-1)
            frame = torch.arange(b, dtype=torch.int32, device=gray.device).repeat_interleave(
                k0.valid.shape[1])
            lanes = (fl(k0.scale), fl(k0.x_oct), fl(k0.y_oct), fl(k0.sigma_oct))
            timed("row 5 octave 0 lanes", lambda: KP.orientation_hist_lanes(
                f0, *lanes, c, valid=fl(k0.valid), frame=frame), ORIENT)
            print(f"[bench {tag}] row 5 octave 0: {int(k0.valid.sum())} valid of "
                  f"{k0.valid.numel()} lanes", flush=True)
        stage = ((lambda: KP.orientation_hist_octaves(fields, kpcs, c)) if one_launch else staged)
        timed(f"row 5 {label} batch ({len(dogs)} octaves)", stage, ORIENT)
        del gauss, dogs, kpcs, fields

    import dataclasses

    for label, c in (("parity", cfg), ("fast_bf16", FAST_BF16_CONFIG),
                     ("cascade", dataclasses.replace(cfg, use_oneshot_pyramid=False,
                                                     use_pallas_pyramid=True))):
        sift = SIFT(480, 640, config=c)
        sift.extract_batch(gray)
        torch.cuda.synchronize()
        chip_smoke._profile(f"{tag} {label}", lambda: sift.extract_batch(gray))
    dest = pathlib.Path(args.out) / f"bench_cascade_orient_{tag}.json"
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
