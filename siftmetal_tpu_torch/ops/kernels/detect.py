"""Fused extrema detection with per-row slot compaction (``csrc/detect.cu``).

Replaces ``siftmetal_tpu/ops/pallas/detect.py`` ``_detect_kernel``
(through ``detect_candidates_pallas`` :368 with ``emit_fields=True``).
For each (frame, scale, row) of a DoG stack it keeps the columns of the
first ``slots`` soft extrema in column order, with the iteration-1 Taylor
step and the edge flag at each, and counts raw / soft / row-dropped
extrema per frame. Rows are the true interior (H-2 of them; the TPU
kernel's tile padding is gone), and the column and edge flag are separate
tensors (the TPU packed both into one 13-bit word).

``emit_fields=False`` is the lean form (the TPU kernel's
``emit_fields=False`` branches, ``detect.py`` :64, :222-225, :301-346):
the same test, ranking and counters, but only ``cand_col``, ``slot_ok``
and the counters leave the kernel; the tail derives the Taylor step at the
candidates it keeps. The outputs the two forms share are equal exactly.

Bound on an H100: bytes, one read of the DoG stack. See csrc/detect.cu.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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


def detect_candidates(
    dog: torch.Tensor,
    soft_threshold: float,
    edge_threshold: float,
    slots: int = 6,
    emit_fields: bool = True,
) -> Candidates:
    """[B, S, H, W] fp32 DoG -> :class:`Candidates` (see module doc)."""
    name = "detect_candidates" if emit_fields else "detect_candidates_lean"
    if not use_kernel(dog, name):
        return detect_candidates_plain(
            dog, soft_threshold, edge_threshold, slots, emit_fields
        )
    require(dog, name)
    if not 1 <= slots <= 32:
        raise ValueError(f"{name}: slots={slots} outside [1, 32]")
    if dog.ndim != 4 or min(dog.shape[1:]) < 3:
        raise ValueError(f"{name}: expected [B, S>=3, H>=3, W>=3], got {tuple(dog.shape)}")
    b, s, h, w = dog.shape
    dev = dog.device
    shape = (b, s - 2, h - 2, slots)
    cand = torch.empty(shape, dtype=torch.int32, device=dev)
    ok = torch.empty(shape, dtype=torch.uint8, device=dev)
    counts = torch.zeros((3, b), dtype=torch.int32, device=dev)
    count_ptrs = [counts[k].data_ptr() for k in range(3)]
    f = edge = None
    with _cuda.launch_on(dog) as stream:
        lib = _cuda.library("detect")
        if emit_fields:
            f = tuple(torch.empty(shape, dtype=torch.float32, device=dev) for _ in range(4))
            edge = torch.empty(shape, dtype=torch.uint8, device=dev)
            r = edge_threshold
            code = lib.detect_candidates(
                dog.data_ptr(), b, s, h, w, float(soft_threshold),
                float((r + 1.0) ** 2 / r), slots, cand.data_ptr(), ok.data_ptr(),
                *(a.data_ptr() for a in f), edge.data_ptr(), *count_ptrs, stream,
            )
            edge = edge.bool()
        else:
            code = lib.detect_candidates_lean(
                dog.data_ptr(), b, s, h, w, float(soft_threshold), slots,
                cand.data_ptr(), ok.data_ptr(), *count_ptrs, stream,
            )
    _cuda.check(code, name)
    LAUNCHES[name] += 1
    return Candidates(
        cand_col=cand,
        slot_ok=ok.bool(),
        cand_fields=f,
        cand_edge=edge,
        n_raw=counts[0],
        n_soft=counts[1],
        n_row_dropped=counts[2],
    )
