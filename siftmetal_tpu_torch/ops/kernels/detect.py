"""Fused extrema detection with per-row slot compaction (``csrc/detect.cu``).

Replaces ``siftmetal_tpu/ops/pallas/detect.py`` ``_detect_kernel``
(through ``detect_candidates_pallas`` :368 with ``emit_fields=True``).
For each (frame, scale, row) of a DoG stack it keeps the columns of the
first ``slots`` soft extrema in column order, with the iteration-1 Taylor
step and the edge flag at each, and counts raw / soft / row-dropped
extrema per frame. Rows are the true interior (H-2 of them; the TPU
kernel's tile padding is gone), and the column and edge flag are separate
tensors (the TPU packed both into one 13-bit word).

Bound on an H100: bytes, one read of the DoG stack. See csrc/detect.cu.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import cuda as _cuda
from . import LAUNCHES, require, use_kernel


class Candidates(NamedTuple):
    """Per-(frame, scale, row) candidate slots; arrays [B, S-2, H-2, slots]."""

    cand_col: torch.Tensor     # int32: column c (center at c + 1)
    slot_ok: torch.Tensor      # bool
    cand_fields: Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
    cand_edge: torch.Tensor    # bool: edge test passed at the candidate
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
    dog: torch.Tensor, soft_threshold: float, edge_threshold: float, slots: int = 6
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
    oi, oj, os_, val, hii, hjj, hij = taylor_step(nb, c)
    eok = edge_ok(hii, hjj, hij, edge_threshold)
    pick = lambda f: torch.where(ok, torch.gather(f, -1, cand), torch.zeros((), dtype=f.dtype, device=f.device))
    to_i32 = lambda a: a.to(torch.int32)
    return Candidates(
        cand_col=to_i32(torch.where(ok, cand, 0)),
        slot_ok=ok,
        cand_fields=(pick(oi), pick(oj), pick(os_), pick(val)),
        cand_edge=pick(eok),
        n_raw=to_i32(raw.sum((1, 2, 3))),
        n_soft=to_i32(soft.sum((1, 2, 3))),
        n_row_dropped=to_i32((count - slots).clamp(min=0).sum((1, 2))),
    )


def detect_candidates(
    dog: torch.Tensor, soft_threshold: float, edge_threshold: float, slots: int = 6
) -> Candidates:
    """[B, S, H, W] fp32 DoG -> :class:`Candidates` (see module doc)."""
    if not use_kernel(dog, "detect_candidates"):
        return detect_candidates_plain(dog, soft_threshold, edge_threshold, slots)
    require(dog, "detect_candidates")
    if not 1 <= slots <= 32:
        raise ValueError(f"detect_candidates: slots={slots} outside [1, 32]")
    if dog.ndim != 4 or min(dog.shape[1:]) < 3:
        raise ValueError(f"detect_candidates: expected [B, S>=3, H>=3, W>=3], got {tuple(dog.shape)}")
    b, s, h, w = dog.shape
    dev = dog.device
    shape = (b, s - 2, h - 2, slots)
    cand = torch.empty(shape, dtype=torch.int32, device=dev)
    ok = torch.empty(shape, dtype=torch.uint8, device=dev)
    f = [torch.empty(shape, dtype=torch.float32, device=dev) for _ in range(4)]
    edge = torch.empty(shape, dtype=torch.uint8, device=dev)
    counts = torch.zeros((3, b), dtype=torch.int32, device=dev)
    r = edge_threshold
    lib = _cuda.library("detect")
    _cuda.check(
        lib.detect_candidates(
            dog.data_ptr(), b, s, h, w, float(soft_threshold),
            float((r + 1.0) ** 2 / r), slots, cand.data_ptr(), ok.data_ptr(),
            *(a.data_ptr() for a in f), edge.data_ptr(),
            counts[0].data_ptr(), counts[1].data_ptr(), counts[2].data_ptr(),
            _cuda.stream_of(dog),
        ),
        "detect_candidates",
    )
    LAUNCHES["detect_candidates"] += 1
    return Candidates(
        cand_col=cand,
        slot_ok=ok.bool(),
        cand_fields=tuple(f),
        cand_edge=edge.bool(),
        n_raw=counts[0],
        n_soft=counts[1],
        n_row_dropped=counts[2],
    )
