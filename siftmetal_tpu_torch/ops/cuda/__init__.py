"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, and loaded with ctypes: no PyTorch
headers are compiled, so a build takes seconds. Nothing here runs at
import time; the first launch of a kernel builds every library (one
``nvcc`` per source, all started together) into ``_build/`` next to the
package, which ``.gitignore`` lists. A library is rebuilt when its source
or a header of ``csrc/`` is newer, or when its nvcc command changed (a
stamp of the command sits beside each library).

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on a nonzero code. A wrapper
launches inside :func:`launch_on`, which makes its tensor's device the
current one (the C launchers read it for their per-device facts) and
hands over that device's current stream.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Callable, Dict, List, Tuple

_PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# Per-source extra nvcc flags. detect.cu keeps every multiply and add
# separately rounded so its Taylor step matches the plain version bit
# for bit (the 0.6 convergence bound and the edge ratio flip on last bits);
# describe.cu so that its peaks and quantisation round as the PyTorch
# route's separate kernels do.
EXTRA_FLAGS: Dict[str, Tuple[str, ...]] = {"detect": ("-fmad=false",),
                                           "describe": ("-fmad=false",)}

# C signatures: library -> {function: argtypes}; every function returns int.
SIGNATURES: Dict[str, Dict[str, List]] = {
    "pyramid": {
        # table (the launch's int64 host table), in, in_bf16, B, H_in, W_in,
        # S, upsample, first, first_bf16, gauss, dog, mid_bf16, stream
        "band_tiles": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P, _I, _P],
        # table, first, first_bf16, bf16_chain, B, H, W, n_stage, gauss,
        # dog, stream
        "blur_cascade": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    },
    "detect": {
        # table (the launch's int64 host table), soft_thr, edge_bound,
        # emit_fields, cand_col, slot_ok, c_oi, c_oj, c_os, c_val, c_edge,
        # counts, stream
        "detect_octaves": [_P, _F, _F, _I] + [_P] * 9,
        # table (int64 host table), reals (float32 host table), total,
        # flags, ints, reals_out, counters, movers, stream
        "refine_tail_octaves": [_P, _P, ctypes.c_longlong] + [_P] * 6,
    },
    "cascade": {
        # g0, table (the launch's int32 host table), taps (host float32),
        # n_taps, gauss, dog, stream
        "octave_cascade": [_P, _P, _P, _I, _P, _P, _P],
    },
    "patches": {
        # table (the launch's int64 host table), radius, n_bins, lam,
        # ticket, stream
        "orientation_octaves": [_P, _I, _I, _F, _P, _P],
        # gi, gj, n, n_bins, th, bins, stream (the wrap probe of the card tests)
        "orientation_wrap_pairs": [_P, _P, _I, _I, _P, _P, _P],
        # gi, gj, B, S, H, W, L, valid, frame, scale, x, y, sigma, theta,
        # radius, n_hist, n_ori, lam, out, stream
        "descriptor_hist": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                            _P, _P, _P, _I, _I, _I, _F, _P, _P],
        # gi, gj, B, S, H, W, L, valid, frame, scale, x, y, sigma,
        # ori_radius, n_bins, lam_ori, smooth_iters, peak_thr, max_ori,
        # desc_radius, n_hist, n_ori, lam_desc, raw, theta, ori_valid, stream
        "orient_desc": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                        _I, _I, _F, _I, _F, _I, _I, _I, _I, _F, _P, _P, _P,
                        _P],
        # gi, gj, B, S, H, W, heads, runs, run_end, src, frame, scale, x, y,
        # sigma, radius, tile, n_bins, lam, out, stream
        "orientation_hist_banded": [_P, _P, _I, _I, _I, _I] + [_P] * 9
                                   + [_I, _I, _I, _F, _P, _P],
        # B, S, H, W, L, valid, frame, scale, x, y, tile, count, start, rank,
        # src, first, run_end, heads, runs, stream
        "tile_runs": [_I, _I, _I, _I, _I] + [_P] * 5 + [_I] + [_P] * 9,
        # gi, gj, B, S, H, W, heads, runs, run_end, src, frame, scale, x, y,
        # sigma, theta, radius, tile, n_hist, n_ori, lam, out, stream
        "descriptor_hist_banded": [_P, _P, _I, _I, _I, _I] + [_P] * 10
                                  + [_I, _I, _I, _I, _F, _P, _P],
    },
    "describe": {
        # table (the launch's int64 host table), inv_delta (float32 host
        # table), total, valid, scale, reals, dropped, stream
        "keypoint_compact_octaves": [_P, _P, ctypes.c_longlong] + [_P] * 5,
        # table (int64 host table), consts (float32 host table), total,
        # valid, ints, reals, dropped, stream
        "lane_peaks_octaves": [_P, _P, ctypes.c_longlong] + [_P] * 5,
        # table (int64 host table), D, rows, out, stream
        "quantize_rows": [_P, _I, ctypes.c_longlong, _P, _P],
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


def _command(nvcc: str, name: str, out: pathlib.Path) -> List[str]:
    return [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        *EXTRA_FLAGS.get(name, ()), "-o", str(out), str(CSRC / f"{name}.cu"),
    ]


def stale(lib: pathlib.Path, stamp: str, sources) -> bool:
    """Whether ``lib`` must be (re)built: it is missing, the stamp of its
    command beside it (``.cmd``) is missing or differs from ``stamp``, or
    one of ``sources`` is newer."""
    cmd = lib.with_suffix(".cmd")
    if not lib.exists() or not cmd.exists() or cmd.read_text() != stamp:
        return True
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in sources)


def compile_libraries(
    jobs: Dict[str, Tuple[pathlib.Path, str, Callable[[pathlib.Path], List[str]]]],
) -> Dict[str, str]:
    """Run every job's compiler at once: ``name -> (library, stamp, argv
    for an output path)``. Each compiles to a temporary file of this
    process that replaces the library when its compiler succeeds, and its
    stamp is written after. Raises RuntimeError with the failed compilers'
    output; returns each job's output."""
    procs = {}
    for n, (lib, _, argv) in jobs.items():
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.tmp{os.getpid()}")
        cmd = argv(tmp)
        procs[n] = (tmp, pathlib.Path(cmd[0]).name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    logs, failed = {}, []
    for n, (tmp, tool, p) in procs.items():
        logs[n] = p.communicate()[0]
        if p.returncode != 0:
            failed.append(f"{tool} failed for {n}:\n{logs[n]}")
        else:
            lib, stamp, _ = jobs[n]
            os.replace(tmp, lib)
            lib.with_suffix(".cmd").write_text(stamp)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def _stamp(name: str) -> str:
    """What a library's build depends on besides its sources: the nvcc
    command with the output path left out."""
    return " ".join(_command("nvcc", name, pathlib.Path("lib.so")))


def _stamp_path(name: str) -> pathlib.Path:
    return _lib_path(name).with_suffix(".cmd")


def _stale(name: str) -> bool:
    return stale(_lib_path(name), _stamp(name), [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])


def build_all() -> Dict[str, str]:
    """Compile every stale ``csrc/*.cu`` in parallel; returns the
    compiler's output per source (``-Xptxas -v`` register/spill lines)."""
    names = [n for n in SIGNATURES if _stale(n)]
    if not names:
        return {}
    nvcc = nvcc_path()
    return compile_libraries({
        n: (_lib_path(n), _stamp(n), lambda out, n=n: _command(nvcc, n, out)) for n in names
    })


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


@contextlib.contextmanager
def launch_on(t):
    """Make ``t``'s device the current CUDA device for a launch and yield
    its current stream handle; the previous device is restored after."""
    import torch

    with torch.cuda.device(t.device):
        yield stream_of(t)
