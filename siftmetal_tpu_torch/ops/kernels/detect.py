"""Fused extrema detection with per-row slot compaction (``csrc/detect.cu``).

Replaces ``siftmetal_tpu/ops/pallas/detect.py`` ``_detect_kernel``
(through ``detect_candidates_pallas`` :368 with ``emit_fields=True``).
For each (frame, scale, row) of a DoG stack it keeps the columns of the
first ``slots`` soft extrema in column order, with the iteration-1 Taylor
step and the edge flag at each, and counts raw / soft / row-dropped
extrema per frame. Rows are the true interior (H-2 of them; the TPU
kernel's tile padding is gone), and the column and edge flag are separate
tensors (the TPU packed both into one 13-bit word).

:func:`detect_candidates_octaves` runs every octave of a batch in one
launch: one task per (octave, frame, band of ``band_rows`` rows), laid
out by :func:`launch_plan`; each output kind is one allocation over all
octaves and the per-octave :class:`Candidates` are views of it.
:func:`detect_candidates` is the same launch over one octave.

``emit_fields=False`` is the lean form (the TPU kernel's
``emit_fields=False`` branches, ``detect.py`` :64, :222-225, :301-346):
the same test, ranking and counters, but only ``cand_col``, ``slot_ok``
and the counters leave the kernel; the tail derives the Taylor step at the
candidates it keeps. The outputs the two forms share are equal exactly.

Bound on an H100: bytes, one read of the DoG stack. See csrc/detect.cu.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import cuda as _cuda
from . import LAUNCHES, require, use_kernel


class Candidates(NamedTuple):
    """Per-(frame, scale, row) candidate slots; arrays [B, S-2, H-2, slots]."""

    cand_col: torch.Tensor     # int32: column c (center at c + 1)
    slot_ok: torch.Tensor      # bool
    # (ofst_i, ofst_j, ofst_s, value) at the candidate; None in the lean form
    cand_fields: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]]
    cand_edge: Optional[torch.Tensor]  # bool: edge test passed; None when lean
    n_raw: torch.Tensor        # [B] int32
    n_soft: torch.Tensor       # [B] int32
    n_row_dropped: torch.Tensor  # [B] int32


def _neighborhood(dog: torch.Tensor, ds: int, di: int, dj: int) -> torch.Tensor:
    """dog[:, s+ds, i+di, j+dj] over every interior (s, i, j)."""
    _, s, h, w = dog.shape
    return dog[:, 1 + ds:s - 1 + ds, 1 + di:h - 1 + di, 1 + dj:w - 1 + dj]


def taylor_step(nb, c):
    """Taylor step (ofst_i, ofst_j, ofst_s, value) and the Hessian terms the
    edge test needs, with the kernel's one-reciprocal formulas. ``nb(ds,
    di, dj)`` returns the neighbour values, ``c`` the centers."""
    gi = 0.5 * (nb(0, 1, 0) - nb(0, -1, 0))
    gj = 0.5 * (nb(0, 0, 1) - nb(0, 0, -1))
    gs = 0.5 * (nb(1, 0, 0) - nb(-1, 0, 0))
    hii = nb(0, 1, 0) + nb(0, -1, 0) - 2.0 * c
    hjj = nb(0, 0, 1) + nb(0, 0, -1) - 2.0 * c
    hss = nb(1, 0, 0) + nb(-1, 0, 0) - 2.0 * c
    hij = 0.25 * (nb(0, 1, 1) - nb(0, 1, -1) - nb(0, -1, 1) + nb(0, -1, -1))
    his = 0.25 * (nb(1, 1, 0) - nb(1, -1, 0) - nb(-1, 1, 0) + nb(-1, -1, 0))
    hjs = 0.25 * (nb(1, 0, 1) - nb(1, 0, -1) - nb(-1, 0, 1) + nb(-1, 0, -1))
    det = (
        hii * (hjj * hss - hjs * hjs)
        - hij * (hij * hss - hjs * his)
        + his * (hij * hjs - hjj * his)
    )
    inv_det = 1.0 / det
    aa = (hjj * hss - hjs * hjs) * inv_det
    ab = (his * hjs - hij * hss) * inv_det
    ac = (hij * hjs - his * hjj) * inv_det
    bb = (hii * hss - his * his) * inv_det
    bc = (his * hij - hii * hjs) * inv_det
    cc = (hii * hjj - hij * hij) * inv_det
    ofst_i = -(aa * gi + ab * gj + ac * gs)
    ofst_j = -(ab * gi + bb * gj + bc * gs)
    ofst_s = -(ac * gi + bc * gj + cc * gs)
    value = c + 0.5 * (gi * ofst_i + gj * ofst_j + gs * ofst_s)
    return ofst_i, ofst_j, ofst_s, value, hii, hjj, hij


def edge_ok(hii, hjj, hij, edge_threshold: float) -> torch.Tensor:
    """IPOL edge acceptance |(hii + hjj)^2 / (hii hjj - hij^2)| <= (r+1)^2/r."""
    tr = hii + hjj
    r = edge_threshold
    return (tr * tr / (hii * hjj - hij * hij)).abs() <= (r + 1.0) ** 2 / r


def detect_candidates_plain(
    dog: torch.Tensor,
    soft_threshold: float,
    edge_threshold: float,
    slots: int = 6,
    emit_fields: bool = True,
) -> Candidates:
    """The kernel's function in PyTorch (dense passes over the interior)."""
    nb = lambda ds, di, dj: _neighborhood(dog, ds, di, dj)
    c = nb(0, 0, 0)
    hi = torch.full_like(c, float("-inf"))
    lo = torch.full_like(c, float("inf"))
    for ds in (-1, 0, 1):
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                if ds == 0 and di == 0 and dj == 0:
                    continue
                n = nb(ds, di, dj)
                hi = torch.maximum(hi, n)
                lo = torch.minimum(lo, n)
    raw = (c > hi) | (c < lo)
    soft = raw & (c.abs() > soft_threshold)
    count = soft.sum(-1)                                    # [B, S-2, H-2]
    rank = soft.cumsum(-1)
    cols = torch.arange(c.shape[-1], device=dog.device)
    cand = torch.stack(
        [torch.where(soft & (rank == k + 1), cols, 0).amax(-1) for k in range(slots)],
        dim=-1,
    )
    ok = count[..., None] > torch.arange(slots, device=dog.device)
    fields = edge = None
    if emit_fields:
        oi, oj, os_, val, hii, hjj, hij = taylor_step(nb, c)
        eok = edge_ok(hii, hjj, hij, edge_threshold)
        pick = lambda f: torch.where(ok, torch.gather(f, -1, cand), torch.zeros((), dtype=f.dtype, device=f.device))
        fields = (pick(oi), pick(oj), pick(os_), pick(val))
        edge = pick(eok)
    to_i32 = lambda a: a.to(torch.int32)
    return Candidates(
        cand_col=to_i32(torch.where(ok, cand, 0)),
        slot_ok=ok,
        cand_fields=fields,
        cand_edge=edge,
        n_raw=to_i32(raw.sum((1, 2, 3))),
        n_soft=to_i32(soft.sum((1, 2, 3))),
        n_row_dropped=to_i32((count - slots).clamp(min=0).sum((1, 2))),
    )


class OctavePlan(NamedTuple):
    """Where one octave sits in a detection launch."""

    h: int
    w: int
    bands: int      # tasks per frame: ceil((h - 2) / band_rows) row bands
    task0: int      # first task of the octave
    out0: int       # first element of the octave in each flat output
    size: int       # elements of the octave: B * (S - 2) * (h - 2) * slots


# Output rows a block of csrc/detect.cu walks (its R template argument,
# kRows there): 32, the least device time in the band-height sweep; the
# sweep's 8 and 16 are built for 5 DoG planes (3 scales an octave) only.
BAND_ROWS = 32
BAND_ROW_CHOICES = (8, 16, 32)
MAX_OCTAVES = 16     # csrc/detect.cu kMaxOctaves
SCALES = range(3, 9)  # DoG planes an octave may have (instances built)


def launch_plan(
    shapes: Sequence[Tuple[int, int]], batch: int, n_dog: int, slots: int,
    band_rows: int = BAND_ROWS,
) -> Tuple[List[OctavePlan], int, int]:
    """The detection launch over octaves of ``shapes`` (in order): each
    octave's plan, the number of tasks and of output elements per kind.
    Task ``task0 + b * bands + k`` of an octave takes frame ``b``, rows
    ``[k * band_rows, (k + 1) * band_rows)`` of the interior and every
    scale; output (b, s, r, slot) of the octave is element
    ``out0 + ((b * (n_dog - 2) + s) * (h - 2) + r) * slots + slot``."""
    plans, task, out = [], 0, 0
    for h, w in shapes:
        bands = -(-(h - 2) // band_rows)
        size = batch * (n_dog - 2) * (h - 2) * slots
        plans.append(OctavePlan(h, w, bands, task, out, size))
        task += batch * bands
        out += size
    return plans, task, out


def detect_candidates_octaves(
    dogs: Sequence[torch.Tensor],
    soft_threshold: float,
    edge_threshold: float,
    slots: int = 6,
    emit_fields: bool = True,
    band_rows: int = BAND_ROWS,
) -> List[Candidates]:
    """Per-octave [B, S, H_o, W_o] fp32 DoGs -> one :class:`Candidates` per
    octave (see module doc), in one launch on CUDA tensors."""
    name = "detect_candidates" if emit_fields else "detect_candidates_lean"
    if not dogs:
        raise ValueError(f"{name}: no octaves")
    if not use_kernel(dogs[0], name):
        return [
            detect_candidates_plain(d, soft_threshold, edge_threshold, slots, emit_fields)
            for d in dogs
        ]
    if not 1 <= slots <= 32:
        raise ValueError(f"{name}: slots={slots} outside [1, 32]")
    if band_rows not in BAND_ROW_CHOICES:
        raise ValueError(f"{name}: band_rows={band_rows} not in {BAND_ROW_CHOICES}")
    if len(dogs) > MAX_OCTAVES:
        raise ValueError(f"{name}: {len(dogs)} octaves, at most {MAX_OCTAVES} a launch")
    b, s = dogs[0].shape[:2]
    for d in dogs:
        require(d, name)
        if d.device != dogs[0].device:
            raise ValueError(f"{name}: octaves on {d.device} and {dogs[0].device}")
        if d.ndim != 4 or tuple(d.shape[:2]) != (b, s) or min(d.shape[2:]) < 3:
            raise ValueError(f"{name}: expected [{b}, {s}, H>=3, W>=3], got {tuple(d.shape)}")
    if s not in SCALES:
        raise ValueError(f"{name}: {s} DoG planes, the kernel takes {SCALES.start}-{SCALES.stop - 1}")
    if band_rows != BAND_ROWS and s != 5:
        raise ValueError(f"{name}: band_rows={band_rows} is built for 5 DoG planes only")
    plans, _, total = launch_plan(
        [tuple(d.shape[2:]) for d in dogs], b, s, slots, band_rows)
    table = np.empty(5 + 6 * len(dogs), np.int64)
    table[:5] = (len(dogs), b, s, slots, band_rows)
    table[5:] = np.asarray(
        [(d.data_ptr(), p.h, p.w, p.bands, p.task0, p.out0) for d, p in zip(dogs, plans)],
        np.int64).reshape(-1)
    dev = dogs[0].device
    # One allocation per kind: the columns, the slot and edge flags (uint8
    # rows of one buffer), the four Taylor fields (rows of one buffer), and
    # the per-(octave, frame) counters with the launch's task ticket.
    cand = torch.empty(total, dtype=torch.int32, device=dev)
    flags = torch.empty((2 if emit_fields else 1, total), dtype=torch.uint8, device=dev)
    fields = torch.empty((4, total), dtype=torch.float32, device=dev) if emit_fields else None
    flat_counts = torch.zeros(3 * len(dogs) * b + 1, dtype=torch.int32, device=dev)
    row = lambda a, k: a.data_ptr() + k * a.stride(0) * a.element_size()
    with _cuda.launch_on(dogs[0]) as stream:
        r = edge_threshold
        code = _cuda.library("detect").detect_octaves(
            table.ctypes.data_as(ctypes.c_void_p), float(soft_threshold),
            float((r + 1.0) ** 2 / r), int(emit_fields), cand.data_ptr(), row(flags, 0),
            *((row(fields, k) for k in range(4)) if emit_fields else (None,) * 4),
            row(flags, 1) if emit_fields else None, flat_counts.data_ptr(), stream,
        )
    _cuda.check(code, name)
    LAUNCHES[name] += 1
    # Per-octave views: one split per buffer, one view (and unbind) a part.
    sizes = [p.size for p in plans]
    shapes = [(b, s - 2, p.h - 2, slots) for p in plans]
    cands = cand.split(sizes)
    flag_parts = flags.view(torch.bool).split(sizes, dim=1)
    field_parts = fields.split(sizes, dim=1) if emit_fields else None
    per_octave = flat_counts[:-1].view(3, len(dogs), b).unbind(1)
    out = []
    for o, shape in enumerate(shapes):
        fl = flag_parts[o].view(-1, *shape).unbind(0)
        n_raw, n_soft, n_drop = per_octave[o].unbind(0)
        out.append(Candidates(
            cand_col=cands[o].view(shape),
            slot_ok=fl[0],
            cand_fields=field_parts[o].view(4, *shape).unbind(0) if emit_fields else None,
            cand_edge=fl[1] if emit_fields else None,
            n_raw=n_raw,
            n_soft=n_soft,
            n_row_dropped=n_drop,
        ))
    return out


def detect_candidates(
    dog: torch.Tensor,
    soft_threshold: float,
    edge_threshold: float,
    slots: int = 6,
    emit_fields: bool = True,
    band_rows: int = BAND_ROWS,
) -> Candidates:
    """[B, S, H, W] fp32 DoG -> :class:`Candidates`: the launch of
    :func:`detect_candidates_octaves` over one octave."""
    if dog.ndim != 4:
        raise ValueError(f"detect_candidates: expected [B, S, H, W], got {tuple(dog.shape)}")
    return detect_candidates_octaves(
        [dog], soft_threshold, edge_threshold, slots, emit_fields, band_rows)[0]
