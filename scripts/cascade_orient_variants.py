#!/usr/bin/env python3
"""Split the fused cascade's (PERF.md row 7) and the orientation kernel's
(row 5) device time into their parts, for one tree of the port.

    python3 scripts/cascade_orient_variants.py --tag NAME [--package-root DIR]

Builds forms of the tree's ``csrc/cascade.cu`` and ``csrc/patches.cu``
with the package's nvcc command into ``bench_out/variants_<tag>/``, each
with one part taken out:

  * cascade: ``no_input`` (the input rows or halo are not read from device
    memory: shared memory gets a constant), ``no_x`` (no X pass), ``no_y``
    (no Y pass, and so none of its stores), ``no_stores`` (every output
    store, and the streamed design's read-back of the slice for the DoG,
    guarded by a test that never holds, so the passes still run);
  * orientation: ``no_accumulate`` (no samples), ``no_column_sum`` (each
    thread writes its own column instead of the sums), ``invalid_alone``
    (every lane taken as invalid: the grid's cost on lanes with nothing to
    do).

Each runs through the package's own wrapper (its library swapped in) on
chip_smoke's seeded 8x480x640 noise frames: the cascade at 8x960x1280 and
8x480x640, the orientation kernel on the octave-0 lanes of the parity
batch and over the batch's every octave (one launch where the tree has
it, else one an octave); device ms from torch.profiler. ``as_is`` is
checked against the plain versions. The substitutions match the first
designs (the tiled cascade, one block a lane for orientation) and the
streamed and one-launch designs; a source that matches neither stops the
script. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

CASCADE = {
    "tiled": {
        "no_input": [("    A[li * pitch + lj] =\n        src[(long long)reflect(i0 - R + li, H) * W + "
                      "reflect(j0 - R + lj, W)];", "    A[li * pitch + lj] = 0.5f;")],
        "no_x": [("      for (int p = tid; p < nr * ng; p += kThreads) {",
                  "      for (int p = tid; p < 0 * nr * ng; p += kThreads) {")],
        "no_y": [("      for (int p = tid; p < ng * nc; p += kThreads) {",
                  "      for (int p = tid; p < 0 * ng * nc; p += kThreads) {")],
        "no_stores": [("        if (gi < H && gj < W) {", "        if (gi < H && gj < W && cur == 1234.5f) {"),
                      ("      if (gi < H && gj < W) gb[", "      if (gi < H && gj < W && prev[n] == 1234.5f) gb[")],
    },
    "streamed": {
        "no_input": [("cp_async4(dst + k, srow + col[k]);", "dst[k] = 0.5f;")],
        "no_x": [("      x_dispatch<K>(L, s, sm, wrap(st[s].xp + q, L.st[s].dp), wrap(st[s].xx + q, L.st[s].dx),\n"
                  "                    i - q * gx);", "      (void)q;")],
        "no_y": [("      y_task(L, s, st[s], sm, i - (i >= gx) * gx, i >= gx, r0, r1, c0, src, gb, db, plane);",
                  "      (void)gx;")],
        "no_stores": [("    if (!out_cols || y < r0 || y >= r1) continue;",
                       "    if (!out_cols || y < r0 || y >= r1 || acc[q].x != 1234.5f) continue;")],
    },
}
ORIENT = {
    "per_lane": {
        "no_accumulate": [("  orientation_accumulate(hist, tid, nt, ln, plane_field(ln, gi, gj, S, H, W),\n"
                           "                         H, W, radius, n_bins, lam);", "  (void)ln;")],
        "no_column_sum": [("out_l[k] = column_sum(hist, k, nt);", "out_l[k] = hist[k * nt + tid];")],
        "invalid_alone": [("  if (!valid[l]) {", "  if (valid[l] < 2) {")],
    },
    "one_launch": {
        "no_accumulate": [("    orientation_accumulate(hist, tid, kOriThreads, ln,\n"
                           "                           plane_field(ln, oc.gi, oc.gj, oc.S, oc.H, oc.W),\n"
                           "                           oc.H, oc.W, L.radius, n_bins, L.lam);", "    (void)ln;")],
        "no_column_sum": [("out_l[k] = column_sum(hist, k);", "out_l[k] = hist[k * kOriThreads + tid];")],
        "invalid_alone": [("        const bool v = tid < n && oc.valid[l0 + tid];",
                           "        const bool v = tid < n && oc.valid[l0 + tid] > 1;")],
    },
}


def _forms(src, tables, what):
    for design, table in tables.items():
        if all(old in src for subs in table.values() for old, _ in subs):
            forms = {"as_is": src}
            for name, subs in table.items():
                text = src
                for old, new in subs:
                    text = text.replace(old, new)
                forms[name] = text
            return design, forms
    raise RuntimeError(f"{what}: the source matches no design this script knows")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--package-root", default=str(ROOT))
    args = ap.parse_args()
    package_root = pathlib.Path(args.package_root).resolve()
    import torch

    if not torch.cuda.is_available():
        print("cascade_orient_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    sys.path.insert(0, str(package_root))
    import siftmetal_tpu_torch
    from siftmetal_tpu_torch import SiftConfig
    from siftmetal_tpu_torch.ops import cuda as C
    from siftmetal_tpu_torch.ops.kernels import cascade as KC
    from siftmetal_tpu_torch.ops.kernels import patches as KP
    from siftmetal_tpu_torch.sift import describe as DS
    from siftmetal_tpu_torch.sift import detect as DT
    from siftmetal_tpu_torch.sift.batched import build_pyramid_batch
    from siftmetal_tpu_torch.sift.pyramid import seed_image

    if pathlib.Path(siftmetal_tpu_torch.__file__).resolve().parents[1] != package_root:
        raise RuntimeError(f"imported {siftmetal_tpu_torch.__file__}, not the package under {package_root}")
    out = ROOT / "bench_out" / f"variants_{args.tag}"
    out.mkdir(parents=True, exist_ok=True)
    libs = {}
    procs = {}
    for lib_name, tables in (("cascade", CASCADE), ("patches", ORIENT)):
        design, forms = _forms((C.CSRC / f"{lib_name}.cu").read_text(), tables, lib_name)
        print(f"[variants {args.tag}] {lib_name}.cu: the {design} design", flush=True)
        for form, text in forms.items():
            cu = out / f"{lib_name}_{form}.cu"
            cu.write_text(text)
            cmd = C._command(C.nvcc_path(), lib_name, out / f"lib{lib_name}_{form}.so")
            cmd[-1] = str(cu)
            cmd[-1:-1] = ["-I", str(C.CSRC)]
            procs[(lib_name, form)] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                       stderr=subprocess.STDOUT, text=True)
    for (lib_name, form), p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(log, file=sys.stderr)
            return 1
        lib = ctypes.CDLL(str(out / f"lib{lib_name}_{form}.so"))
        for fn, argtypes in C.SIGNATURES[lib_name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[(lib_name, form)] = lib

    cfg = SiftConfig()
    smi = chip_smoke._smi()
    gray = chip_smoke._noise_frames(torch.device("cuda"))
    seed0 = seed_image(gray, cfg)
    seed1 = seed0[:, ::2, ::2].contiguous()
    gauss, dogs = build_pyramid_batch(gray, cfg, cfg.num_octaves(480, 640))
    per_octave, _ = DT.detect_all_octaves_batch(dogs, cfg)
    kpcs, fields = [], []
    for o, dg in enumerate(dogs):
        budget = DT.keypoint_budget(cfg, tuple(dg.shape[-2:]), o)
        kpcs.append(DT.compact_octave_keypoints(per_octave[o], o, cfg, budget)[0])
        fields.append(KP.prepare_patch_fields(gauss[o], cfg))
    del gauss, dogs
    b = gray.shape[0]
    fl = lambda a: a.reshape(-1)

    def lanes(o):
        n = kpcs[o].valid.shape[1]
        frame = torch.arange(b, dtype=torch.int32, device=gray.device).repeat_interleave(n)
        k = kpcs[o]
        return (fl(k.scale), fl(k.x_oct), fl(k.y_oct), fl(k.sigma_oct)), fl(k.valid), frame

    def octave0():
        ln, valid, frame = lanes(0)
        return KP.orientation_hist_lanes(fields[0], *ln, cfg, valid=valid, frame=frame)

    def batch():
        if hasattr(KP, "orientation_hist_octaves"):
            return KP.orientation_hist_octaves(fields, kpcs, cfg)
        rows = []
        for o in range(len(kpcs)):
            ln, valid, frame = lanes(o)
            rows.append(KP.orientation_hist_lanes(fields[o], *ln, cfg, valid=valid, frame=frame))
        return rows

    built = C.library
    try:
        for (lib_name, form), lib in libs.items():
            C.library = lambda name, lib=lib, lib_name=lib_name: lib if name == lib_name else built(name)
            if lib_name == "cascade":
                if form == "as_is":
                    g, d = KC.octave_cascade(seed1, cfg)
                    gp, dp = KC.octave_cascade_plain(seed1, cfg)
                    if max(float((g - gp).abs().max()), float((d - dp).abs().max())) > 1e-5:
                        raise AssertionError("cascade as_is differs from the plain version")
                frags = ("cascade_kernel", "stream_kernel")
                t = [sum(chip_smoke._device_ms(lambda f=f: KC.octave_cascade(f, cfg), frags, 5).values())
                     for f in (seed0, seed1)]
                print(f"[variants {args.tag}] cascade {form:14s}: 8x960x1280 {t[0]:.4f} ms, "
                      f"8x480x640 {t[1]:.4f} ms of device time ({smi})", flush=True)
            else:
                if form == "as_is":
                    ln, valid, frame = lanes(0)
                    h = octave0()
                    hp = DS.orientation_hist_plain(fields[0].gi, fields[0].gj, frame.long(),
                                                   ln[0].long(), *ln[1:], valid, cfg)
                    rel = ((h - hp).abs().amax(1) / hp.abs().amax(1).clamp(min=1e-12)).max()
                    if float(rel) > 1e-4:
                        raise AssertionError("orientation as_is differs from the plain version")
                frags = ("::orientation_kernel",)
                t = [sum(chip_smoke._device_ms(fn, frags, 5).values()) for fn in (octave0, batch)]
                print(f"[variants {args.tag}] orientation {form:14s}: octave-0 lanes {t[0]:.4f} ms, "
                      f"the batch's {len(kpcs)} octaves {t[1]:.4f} ms of device time ({smi})", flush=True)
    finally:
        C.library = built
    return 0


if __name__ == "__main__":
    sys.exit(main())
