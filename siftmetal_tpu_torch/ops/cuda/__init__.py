"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, and loaded with ctypes: no PyTorch
headers are compiled, so a build takes seconds. Nothing here runs at
import time; the first launch of a kernel builds every library (one
``nvcc`` per source, all started together) into ``_build/`` next to the
package, which ``.gitignore`` lists. A library is rebuilt when its source
is newer.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on a nonzero code.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, List, Tuple

_PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# Per-source extra nvcc flags. detect.cu keeps every multiply and add
# separately rounded so its Taylor step matches the plain version bit
# for bit (the 0.6 convergence bound and the edge ratio flip on last bits).
EXTRA_FLAGS: Dict[str, Tuple[str, ...]] = {"detect": ("-fmad=false",)}

# C signatures: library -> {function: argtypes}; every function returns int.
SIGNATURES: Dict[str, Dict[str, List]] = {
    "pyramid": {
        # in, B, H, W_in, start, taps, ks, S, K, W_out, out, stream
        "band_x": [_P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P],
        # xs, B, S, H_in, W, start, taps, ks, K, H_out, first, gauss, dog,
        # stream
        "band_y": [_P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P],
    },
    "detect": {
        # dog, B, S, H, W, soft_thr, edge_bound, slots, cand_col, slot_ok,
        # c_oi, c_oj, c_os, c_val, c_edge, n_raw, n_soft, n_drop, stream
        "detect_candidates": [_P, _I, _I, _I, _I, _F, _F, _I] + [_P] * 11,
    },
    "patches": {
        # gi, gj, B, S, H, W, L, valid, frame, scale, x, y, sigma, radius,
        # n_bins, lam, out, stream
        "orientation_hist": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                             _P, _P, _I, _I, _F, _P, _P],
        # gi, gj, B, S, H, W, L, valid, frame, scale, x, y, sigma, theta,
        # radius, n_hist, n_ori, lam, out, stream
        "descriptor_hist": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                            _P, _P, _P, _I, _I, _I, _F, _P, _P],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    src = CSRC / f"{name}.cu"
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def build_all() -> Dict[str, str]:
    """Compile every stale ``csrc/*.cu`` in parallel; returns the
    compiler's output per source (``-Xptxas -v`` register/spill lines)."""
    names = [n for n in SIGNATURES if _stale(n)]
    if not names:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in names:
        tmp = BUILD_DIR / f"lib{n}.so.tmp{os.getpid()}"
        cmd = [
            nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            *EXTRA_FLAGS.get(n, ()), "-o", str(tmp), str(CSRC / f"{n}.cu"),
        ]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    logs, failed = {}, []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        logs[n] = out
        if p.returncode != 0:
            failed.append(n)
        else:
            os.replace(tmp, _lib_path(n))
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch (cudaError {code})")


def stream_of(t) -> int:
    """The current PyTorch stream handle of ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
