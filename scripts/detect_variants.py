#!/usr/bin/env python3
"""Split the detection kernel's time into its copies and its test.

    python3 scripts/detect_variants.py

Builds three forms of ``siftmetal_tpu_torch/csrc/detect.cu`` with the
package's nvcc command into ``bench_out/detect_variants/``:

  * ``as_is``: the source as it stands;
  * ``copies_alone``: the extremum test removed (every ballot empty), so
    the kernel moves the DoG into shared memory and does nothing else;
  * ``test_alone``: only each band's first chunk copied, and every chunk's
    test run on it, so the kernel does the test with almost no copies.

Each runs through the package's own wrapper (the library swapped in) on
the parity pyramid of chip_smoke's seeded 8x480x640 noise frames, at
octave 0 and over the seven octaves, at every band height; the device ms
of the detection kernel come from torch.profiler. Only ``as_is`` computes
the detection; it is checked against the plain version. Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

TEST = "    // Phase 1: the extremum test of this thread's column over its rows.\n    {\n"
NEXT_COPY = """    if (k + 1 < n_chunks)
      copy_chunk<S, R>(o, b, r0, c0 + kCols, smem + ((k + 1) & 1) * kBuf);
"""
CURRENT = "    const float* cur = smem + (k & 1) * kBuf;\n"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("detect_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from siftmetal_tpu_torch import SiftConfig
    from siftmetal_tpu_torch.ops import cuda as C
    from siftmetal_tpu_torch.ops.kernels import detect as KD
    from siftmetal_tpu_torch.sift.batched import build_pyramid_batch

    src = (C.CSRC / "detect.cu").read_text()
    for piece in (TEST, NEXT_COPY, CURRENT):
        if piece not in src:
            raise RuntimeError("csrc/detect.cu changed: update this script's substitutions")
    forms = {
        "as_is": src,
        "copies_alone": src.replace(TEST, "    if (tid < kMasks) mk[tid] = 0u;\n    if (false) {\n"),
        "test_alone": src.replace(NEXT_COPY, "").replace(CURRENT, "    const float* cur = smem;\n"),
    }
    out = ROOT / "bench_out" / "detect_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in forms.items():
        (out / f"{name}.cu").write_text(text)
        cmd = C._command(C.nvcc_path(), "detect", out / f"lib{name}.so")
        cmd[-1] = str(out / f"{name}.cu")
        cmd[-1:-1] = ["-I", str(C.CSRC)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(log, file=sys.stderr)
            return 1
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        for fn, argtypes in C.SIGNATURES["detect"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib

    cfg = SiftConfig()
    gray = chip_smoke._noise_frames(torch.device("cuda"))
    _, dogs = build_pyramid_batch(gray, cfg, cfg.num_octaves(480, 640))
    thr = 0.8 * cfg.dog_threshold
    smi = chip_smoke._smi()
    built = C.library
    try:
        for name, lib in libs.items():
            C.library = lambda _name, lib=lib: lib
            if name == "as_is":
                got = KD.detect_candidates_octaves(dogs, thr, cfg.edge_threshold)
                for g, d in zip(got, dogs):
                    ref = KD.detect_candidates_plain(d, thr, cfg.edge_threshold)
                    if not (torch.equal(g.cand_col, ref.cand_col) and torch.equal(g.n_raw, ref.n_raw)):
                        raise AssertionError(f"as_is differs from the plain version at {tuple(d.shape)}")
            rows = (8, 16, 32) if name == "as_is" else (KD.BAND_ROWS,)
            for r in rows:
                for fields in (True, False):
                    one = lambda: KD.detect_candidates(dogs[0], thr, cfg.edge_threshold,
                                                       emit_fields=fields, band_rows=r)
                    batch = lambda: KD.detect_candidates_octaves(dogs, thr, cfg.edge_threshold,
                                                                 emit_fields=fields, band_rows=r)
                    t0 = chip_smoke._device_ms(one, ("detect_kernel",), 5)["detect_kernel"]
                    tb = chip_smoke._device_ms(batch, ("detect_kernel",), 5)["detect_kernel"]
                    print(f"[variants] {name:12s} R {r:2d} {'full' if fields else 'lean'}: octave 0 "
                          f"{t0:.4f} ms, seven octaves {tb:.4f} ms of device time ({smi})", flush=True)
    finally:
        C.library = built
    return 0


if __name__ == "__main__":
    sys.exit(main())
