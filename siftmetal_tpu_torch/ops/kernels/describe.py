"""The describe stage's bookkeeping in three launches (``csrc/describe.cu``).

Replaces no Pallas kernel: the JAX package's steps between detection and
the descriptor rows are XLA glue around its patch kernels. In the port
they were ~600 small PyTorch ops a call, which stay as the CPU route
(``sift/detect.py`` ``compact_keypoints``, ``sift/describe.py``
``orientation_lanes`` and ``quantize_octaves`` dispatch between the two).
On CUDA tensors:

* :func:`keypoint_compact_octaves`: every octave's valid keypoint slots of
  the refinement tail's lists into the octave's keypoint budget, with the
  fields the patch kernels read and the count of slots that did not fit;
* :func:`lane_peaks_octaves`: the smoothing and peaks of every keypoint's
  raw orientation histogram, then every octave's (keypoint, peak) lanes
  compacted into its lane slots: the descriptor kernel's lane arrays and
  the rows' fields, and the dropped lanes added to the count;
* :func:`quantize_rows`: every octave's raw descriptor rows to uint8.

Each writes one allocation a kind over every octave (octave o's block
[B, n_o] after the blocks of the octaves before it), so each octave's
arrays are contiguous views of the dtypes the patch kernels read: their
wrappers copy nothing. Each equals the PyTorch route on the card bit for
bit, padding included. Bound on an H100: bytes; see csrc/describe.cu.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import cuda as _cuda
from . import LAUNCHES, require

MAX_OCTAVES = 16  # csrc/describe.cu kMaxOctaves
MAX_BINS = 64     # kMaxBins: the generic peak instance's bins
MAX_ORI = 8       # kMaxOri: and its peaks a keypoint

# The planes of each output kind, in order.
COMPACT_REALS = ("x_oct", "y_oct", "sigma_oct", "x", "y", "sigma", "value")
LANE_INTS = ("scale", "frame", "octave")
LANE_REALS = ("x_oct", "y_oct", "sigma_oct", "theta", "x", "y", "sigma")

# The fields of a keypoint slot list the compaction reads, with their dtypes.
_SLOT_FIELDS = (("cand_valid", torch.bool), ("pass_border", torch.bool),
                ("scale", torch.int32), ("i", torch.int32), ("j", torch.int32),
                ("ofst_i", torch.float32), ("ofst_j", torch.float32), ("x", torch.float32),
                ("y", torch.float32), ("sigma", torch.float32), ("value", torch.float32))
# And of a compacted keypoint set the lane pass reads.
_KP_FIELDS = (("valid", torch.bool), ("scale", torch.int32), ("x_oct", torch.float32),
              ("y_oct", torch.float32), ("sigma_oct", torch.float32), ("x", torch.float32),
              ("y", torch.float32), ("sigma", torch.float32))


def _checked(name: str, what: str, t: torch.Tensor, dtype, shape, dev) -> int:
    """``t``'s pointer, once it is a contiguous ``dtype`` ``shape`` on ``dev``."""
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name}: {what} needs contiguous {dtype} {shape} on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.data_ptr()


def keypoint_compact_octaves(
    per_octave: Sequence, budgets: Sequence[int], deltas: Sequence[float]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every octave's keypoint compaction in one launch on CUDA tensors:
    the refinement tail's per-octave slot lists (``OctaveKeypoints`` of
    [B, width_o]) -> (valid [T] bool, scale [T] int32, reals [7, T] f32
    (``COMPACT_REALS``), dropped [B] int32), T = B x sum(budgets); octave
    o's slots are [B, budgets[o]] from element B x sum(budgets[:o])."""
    name = "keypoint_compact"
    if not 1 <= len(per_octave) <= MAX_OCTAVES or len(budgets) != len(per_octave):
        raise ValueError(f"{name}: {len(per_octave)} octaves and {len(budgets)} budgets")
    dev = per_octave[0].scale.device
    b = per_octave[0].scale.shape[0]
    rows, out = [], 0
    for o, (kp, budget) in enumerate(zip(per_octave, budgets)):
        shape = (b, kp.scale.shape[-1])
        rows.append([_checked(name, f"octave {o} {f}", getattr(kp, f), dt, shape, dev)
                     for f, dt in _SLOT_FIELDS]
                    + [shape[1], budget, out])
        out += b * budget
    table = np.asarray([len(per_octave), b] + [v for row in rows for v in row], np.int64)
    inv = np.asarray([np.float32(1.0) / np.float32(d) for d in deltas], np.float32)
    valid = torch.empty(out, dtype=torch.bool, device=dev)
    ints = torch.empty(out + b, dtype=torch.int32, device=dev)
    reals = torch.empty((len(COMPACT_REALS), out), dtype=torch.float32, device=dev)
    with _cuda.launch_on(valid) as stream:
        code = _cuda.library("describe").keypoint_compact_octaves(
            table.ctypes.data_as(ctypes.c_void_p), inv.ctypes.data_as(ctypes.c_void_p), out,
            valid.data_ptr(), ints.data_ptr(), reals.data_ptr(), ints[out:].data_ptr(), stream)
    _cuda.check(code, name)
    LAUNCHES[name] += 1
    return valid, ints[:out], reals, ints[out:]


def lane_peaks_octaves(
    hist: torch.Tensor, kpcs: Sequence, n_lanes: Sequence[int], dropped: torch.Tensor, *,
    smoothing_iterations: int, peak_threshold: float, max_ori: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Peaks and lanes of every octave in one launch on CUDA tensors: the
    raw orientation histograms [B, sum of budgets, n_bins] of the
    compacted keypoints ``kpcs`` (``CompactOctaveKeypoints`` of [B,
    budget_o], octave after octave along a frame's rows), the lane slots
    of each octave and the keypoint compaction's count [B] -> (valid [T]
    bool, ints [3, T] int32 (``LANE_INTS``), reals [7, T] f32
    (``LANE_REALS``), dropped [B] int32: the count plus the dropped
    lanes), T = B x sum(n_lanes); octave o's lanes are [B, n_lanes[o]]
    from element B x sum(n_lanes[:o])."""
    name = "lane_peaks"
    if not 1 <= len(kpcs) <= MAX_OCTAVES or len(n_lanes) != len(kpcs):
        raise ValueError(f"{name}: {len(kpcs)} octaves and {len(n_lanes)} lane counts")
    dev = hist.device
    require(hist, name)
    b, total_rows, n_bins = hist.shape
    if not 3 <= n_bins <= MAX_BINS or not 1 <= max_ori <= MAX_ORI:
        raise ValueError(f"{name}: {n_bins} bins and {max_ori} peaks, the kernel takes "
                         f"3-{MAX_BINS} and 1-{MAX_ORI}")
    _checked(name, "the dropped count", dropped, torch.int32, (b,), dev)
    rows, row, out = [], 0, 0
    for o, (k, lanes) in enumerate(zip(kpcs, n_lanes)):
        shape = (b, k.valid.shape[-1])
        rows.append([_checked(name, f"octave {o} {f}", getattr(k, f), dt, shape, dev)
                     for f, dt in _KP_FIELDS]
                    + [row, shape[1], lanes, out])
        row += shape[1]
        out += b * lanes
    if row != total_rows:
        raise ValueError(f"{name}: {total_rows} histogram rows a frame for {row} keypoints")
    table = np.asarray([len(kpcs), b, total_rows, n_bins, max_ori, smoothing_iterations,
                        hist.data_ptr(), dropped.data_ptr()]
                       + [v for r in rows for v in r], np.int64)
    # The route's fp32 constants: / 3.0 is a product with fp32(1/3) on a
    # card, the rest Python numbers rounded to fp32.
    consts = np.asarray([np.float32(1.0) / np.float32(3.0), peak_threshold,
                         2.0 * math.pi / n_bins, math.pi, 2.0 * math.pi], np.float32)
    valid = torch.empty(out, dtype=torch.bool, device=dev)
    ints = torch.empty(len(LANE_INTS) * out + b, dtype=torch.int32, device=dev)
    reals = torch.empty((len(LANE_REALS), out), dtype=torch.float32, device=dev)
    n_int = len(LANE_INTS) * out
    with _cuda.launch_on(hist) as stream:
        code = _cuda.library("describe").lane_peaks_octaves(
            table.ctypes.data_as(ctypes.c_void_p), consts.ctypes.data_as(ctypes.c_void_p), out,
            valid.data_ptr(), ints.data_ptr(), reals.data_ptr(), ints[n_int:].data_ptr(), stream)
    _cuda.check(code, name)
    LAUNCHES[name] += 1
    return valid, ints[:n_int].view(len(LANE_INTS), out), reals, ints[n_int:]


def quantize_rows(raws: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every raw descriptor array of ``raws`` (contiguous f32 [..., D], one
    D) quantised in one launch on CUDA tensors: uint8 arrays of the same
    shapes, views of one allocation."""
    name = "quantize_rows"
    if not 1 <= len(raws) <= MAX_OCTAVES:
        raise ValueError(f"{name}: {len(raws)} arrays, 1-{MAX_OCTAVES} a launch")
    dev, d = raws[0].device, raws[0].shape[-1]
    parts, row = [], 0
    for o, raw in enumerate(raws):
        require(raw, name)
        if raw.device != dev or raw.shape[-1] != d:
            raise ValueError(f"{name}: array {o} is {tuple(raw.shape)} on {raw.device}")
        n = raw.numel() // d
        parts += [raw.data_ptr(), n, row]
        row += n
    table = np.asarray([len(raws)] + parts, np.int64)
    out = torch.empty((row, d), dtype=torch.uint8, device=dev)
    with _cuda.launch_on(out) as stream:
        code = _cuda.library("describe").quantize_rows(
            table.ctypes.data_as(ctypes.c_void_p), d, row, out.data_ptr(), stream)
    _cuda.check(code, name)
    LAUNCHES[name] += 1
    views = out.split([r.numel() // d for r in raws])
    return [v.view(r.shape) for v, r in zip(views, raws)]
