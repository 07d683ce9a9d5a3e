"""ctypes binding of the repo's native frame-ingest library
(``native/frameloader.cpp``).

Port of ``siftmetal_tpu/utils/frame_loader.py``: PGM/PPM decode and pixel
conversion on CPU worker threads into float32 grayscale frames. A batch
comes back as one [n, H, W] tensor in pinned memory when CUDA is
available, so one ``.to(device, non_blocking=True)`` a batch moves it to
the card.

The library is compiled with ``g++`` at first use into ``_build/`` next to
the package (which ``.gitignore`` lists), as the CUDA kernels are, with
portable flags (no ``-march=native``: a build directory may travel to
another host). It is rebuilt when the source is newer or the compiler
command changed (a stamp of the command sits beside the library). A
failed build raises with the compiler's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import pathlib
import shutil
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.cuda import BUILD_DIR, compile_libraries, stale

SOURCE = pathlib.Path(__file__).resolve().parents[2] / "native" / "frameloader.cpp"
LIB_PATH = BUILD_DIR / "libframeloader.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _command(cxx: str, out: pathlib.Path) -> List[str]:
    return [cxx, "-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread",
            str(SOURCE), "-o", str(out)]


def _stamp() -> str:
    return " ".join(_command("g++", pathlib.Path("lib.so")))


def _stale() -> bool:
    return stale(LIB_PATH, _stamp(), [SOURCE])


def build() -> bool:
    """Compile the library if it is missing or stale; raises RuntimeError
    with the compiler's output when that fails. Returns True."""
    if not SOURCE.exists():
        raise RuntimeError(f"the frame loader's source {SOURCE} is missing")
    if not _stale():
        return True
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native frame loader cannot be built")
    compile_libraries({str(SOURCE): (LIB_PATH, _stamp(), lambda out: _command(cxx, out))})
    return True


def _load() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        build()
        lib = ctypes.CDLL(str(LIB_PATH))
        P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        sigs = {
            "fl_rgb_to_gray_f32": ([P, I64, I, P], None),
            "fl_bgra_to_gray_f32": ([P, I64, P], None),
            "fl_yuv420_y_to_gray_f32": ([P, I64, I, P], None),
            "fl_load_pnm_gray": ([ctypes.c_char_p, P, I64, ctypes.POINTER(I),
                                  ctypes.POINTER(I)], I),
            "fl_loader_create": ([I, I, I], P),
            "fl_loader_submit": ([P, ctypes.c_char_p], None),
            "fl_loader_next": ([P, P], I),
            "fl_loader_error_count": ([P], I),
            "fl_loader_destroy": ([P], None),
        }
        for name, (argtypes, restype) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
        return lib


def native_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3|4] -> float32 [H, W] gray (BT.709, gamma space)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, c = rgb.shape
    if c not in (3, 4):
        raise ValueError(f"expected 3 or 4 channels, got {c}")
    out = np.empty((h, w), dtype=np.float32)
    _load().fl_rgb_to_gray_f32(rgb.ctypes.data, h * w, c, out.ctypes.data)
    return out


def bgra_to_gray(bgra: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 4] BGRA -> float32 [H, W] gray."""
    bgra = np.ascontiguousarray(bgra, dtype=np.uint8)
    h, w, c = bgra.shape
    if c != 4:
        raise ValueError(f"expected 4 channels, got {c}")
    out = np.empty((h, w), dtype=np.float32)
    _load().fl_bgra_to_gray_f32(bgra.ctypes.data, h * w, out.ctypes.data)
    return out


def yuv420_to_gray(y_plane: np.ndarray, video_range: bool = False) -> np.ndarray:
    """The Y plane of a YUV 4:2:0 frame (uint8) -> float32 gray; video
    range maps 16..235 to 0..1."""
    y_plane = np.ascontiguousarray(y_plane, dtype=np.uint8)
    out = np.empty(y_plane.shape, dtype=np.float32)
    _load().fl_yuv420_y_to_gray_f32(
        y_plane.ctypes.data, y_plane.size, int(video_range), out.ctypes.data
    )
    return out


def load_pnm_gray(path: str) -> np.ndarray:
    """Binary PGM/PPM file (maxval <= 255) -> float32 [H, W] gray."""
    max_px = 64 * 1024 * 1024
    out = np.empty(max_px, dtype=np.float32)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = _load().fl_load_pnm_gray(
        str(path).encode(), out.ctypes.data, max_px, ctypes.byref(w), ctypes.byref(h)
    )
    if rc != 0:
        raise IOError(f"fl_load_pnm_gray({path}) -> {rc}")
    return out[: w.value * h.value].reshape(h.value, w.value).copy()


class FrameLoader:
    """Multithreaded prefetching PGM/PPM batch loader (native threads).

    Usage:
        fl = FrameLoader(480, 640, n_threads=8)
        fl.submit_all(paths)
        batch = fl.next_batch(8)        # [8, 480, 640] float32, pinned
        batch = batch.to("cuda", non_blocking=True)
    """

    def __init__(self, height: int, width: int, n_threads: int = 4):
        self._lib = _load()
        self.height = height
        self.width = width
        self._h = self._lib.fl_loader_create(width, height, n_threads)

    def submit(self, path: str) -> None:
        self._lib.fl_loader_submit(self._h, str(path).encode())

    def submit_all(self, paths: Sequence[str]) -> None:
        for p in paths:
            self.submit(p)

    def next_batch(self, n: int) -> torch.Tensor:
        """The next ``n`` frames in submission order as one [n, H, W]
        float32 tensor, pinned when CUDA is available. Raises when fewer
        than ``n`` frames are pending."""
        out = torch.empty((n, self.height, self.width), dtype=torch.float32,
                          pin_memory=torch.cuda.is_available())
        for i in range(n):
            if self._lib.fl_loader_next(self._h, out[i].data_ptr()) != 0:
                raise RuntimeError("no pending frames")
        return out

    def next_frame(self) -> torch.Tensor:
        """The next frame as an [H, W] float32 tensor."""
        return self.next_batch(1)[0]

    @property
    def error_count(self) -> int:
        return self._lib.fl_loader_error_count(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.fl_loader_destroy(self._h)
            self._h = None

    def __enter__(self) -> "FrameLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
