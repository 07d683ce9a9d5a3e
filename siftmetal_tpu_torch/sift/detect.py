"""DoG extrema refinement, acceptance and compaction (batched).

Port of ``siftmetal_tpu/sift/detect.py`` in the structure the TPU path
takes: the detection kernel (``ops/kernels/detect.py``) compacts each
octave's candidates into per-row slots with the iteration-1 Taylor step,
then ONE cross-octave tail (:func:`_tail_all_octaves`) accepts the
candidates that converge at once and walks the few that move, re-deriving
their Taylor step from 19-point DoG gathers. With
``detect_slot_fields=False`` the lean kernel emits candidate positions
only; the tail compacts each octave's slot grid to its candidate budget
and derives the iteration-1 step from the same 19-point gather. Every
array carries a leading frame axis [B, ...] where the JAX package vmapped
over frames. On CUDA tensors :func:`refine_tail` runs the whole tail as
one hand-written kernel (``csrc/detect.cu`` ``refine_tail_kernel``); the
PyTorch tail stays as its plain version, the route on the CPU.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from ..config import SiftConfig
from ..ops.kernels import use_kernel
from ..ops.kernels.describe import keypoint_compact_octaves
from ..ops.kernels.detect import (
    TAIL_COUNTERS,
    Candidates,
    detect_candidates_octaves,
    edge_ok,
    refine_tail_octaves,
    taylor_step,
)


class OctaveKeypoints(NamedTuple):
    """Padded per-octave keypoint slots [B, K] with per-stage flags."""

    cand_valid: torch.Tensor   # bool — slot holds a real extremum candidate
    converged: torch.Tensor    # bool — refinement converged (ExtrInterp)
    pass_hard: torch.Tensor    # bool — ... and |value| > dog_threshold
    pass_edge: torch.Tensor    # bool — ... and curvature test ok
    pass_border: torch.Tensor  # bool — ... and 1-sigma disc inside image
    scale: torch.Tensor        # int32 — DoG slice index (1..n_scales)
    i: torch.Tensor            # int32 — final discrete row, octave pixels
    j: torch.Tensor            # int32 — final discrete col, octave pixels
    ofst_i: torch.Tensor       # f32
    ofst_j: torch.Tensor       # f32
    ofst_s: torch.Tensor       # f32
    x: torch.Tensor            # f32 — row in input-image units
    y: torch.Tensor            # f32 — col in input-image units
    sigma: torch.Tensor        # f32 — blur in input-image units
    value: torch.Tensor        # f32 — interpolated DoG response

    @property
    def valid(self) -> torch.Tensor:
        return self.cand_valid & self.pass_border


class CompactOctaveKeypoints(NamedTuple):
    """Compacted per-octave keypoints [B, budget]: what the orientation
    and descriptor stages need."""

    valid: torch.Tensor      # bool
    scale: torch.Tensor      # int32 — discrete Gaussian/DoG slice (1..n)
    x_oct: torch.Tensor      # f32 — continuous row, octave pixels
    y_oct: torch.Tensor      # f32 — continuous col, octave pixels
    sigma_oct: torch.Tensor  # f32 — blur in octave-pixel units
    x: torch.Tensor          # f32 — row, input-image units
    y: torch.Tensor          # f32 — col, input-image units
    sigma: torch.Tensor      # f32 — input-image units
    value: torch.Tensor      # f32


class Keypoints(NamedTuple):
    """Global padded keypoint set across octaves, [B, N] per field (or
    [N] for a single frame)."""

    valid: torch.Tensor   # bool
    octave: torch.Tensor  # int32
    scale: torch.Tensor   # int32 — discrete DoG/Gaussian slice index
    i: torch.Tensor       # int32 — discrete row in octave pixels
    j: torch.Tensor       # int32
    ofst_s: torch.Tensor  # f32 — subpixel scale offset
    x: torch.Tensor       # f32 — row, input-image units
    y: torch.Tensor       # f32 — col, input-image units
    sigma: torch.Tensor   # f32 — input-image units
    value: torch.Tensor   # f32

    @property
    def count(self) -> torch.Tensor:
        return self.valid.sum(-1, dtype=torch.int32)


def _map(fn, *tuples):
    """Apply ``fn`` field by field across NamedTuples of one type."""
    return type(tuples[0])(*(fn(*fields) for fields in zip(*tuples)))


# --- static budgets ----------------------------------------------------------


def extrema_candidate_budget(config: SiftConfig, shape: Tuple[int, int]) -> int:
    """Per-octave candidate slots, scaled with the input-image area
    (1 slot per 32 input pixels), in multiples of 128."""
    h, w = shape
    input_area = h * w * config.delta_min ** 2
    k = max(256, int(input_area) // 32)
    k = min(k, config.max_extrema_per_octave)
    return (k + 127) // 128 * 128


def keypoint_budget(config: SiftConfig, shape: Tuple[int, int], octave: int = 0) -> int:
    """Per-octave keypoint slots after refinement: the candidate budget
    over 4 at octave 0, 2 at octave 1, 1 beyond."""
    div = max(1, 4 >> octave)
    k = max(256, extrema_candidate_budget(config, shape) // div)
    return min((k + 127) // 128 * 128, config.max_keypoints)


def mover_budget(config: SiftConfig, shape: Tuple[int, int]) -> int:
    """Mover lanes of one octave (the first tier of the JAX package's
    shared walk; the port walks the whole block at once)."""
    return max(192, extrema_candidate_budget(config, shape) // 24)


def mover_budget_all(config: SiftConfig, shapes: Sequence[Tuple[int, int]]) -> int:
    """Shared mover block of the cross-octave tail: 1/12 of the summed
    candidate budgets (natural images move ~25-30% of soft extrema)."""
    total = sum(extrema_candidate_budget(config, s) for s in shapes)
    return (max(256, total // 12) + 127) // 128 * 128


# --- compaction ---------------------------------------------------------------


def compact_indices(
    valid: torch.Tensor, size: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ascending indices of the True entries along the last axis, padded
    with 0 to ``size`` (cumsum + a scatter that drops overflow into a
    spare column). Returns (indices int64 [..., size], count int32,
    dropped int32)."""
    n = valid.shape[-1]
    pos = torch.cumsum(valid.to(torch.int64), -1) - 1
    total = pos[..., -1] + 1 if n > 0 else torch.zeros(valid.shape[:-1], dtype=torch.int64, device=valid.device)
    tgt = torch.where(valid & (pos < size), pos, size)
    src = torch.arange(n, device=valid.device).expand(valid.shape)
    out = torch.zeros(valid.shape[:-1] + (size + 1,), dtype=torch.int64, device=valid.device)
    out.scatter_(-1, tgt, src)
    count = torch.clamp(total, max=size)
    return out[..., :size], count.to(torch.int32), (total - count).to(torch.int32)


def compact_octave_keypoints(
    kp: OctaveKeypoints, octave: int, config: SiftConfig, budget: int
) -> Tuple[CompactOctaveKeypoints, torch.Tensor]:
    """Gather surviving keypoints into ``budget`` slots per frame; returns
    (compacted, n_dropped [B])."""
    delta = config.octave_delta(octave)
    order, count, dropped = compact_indices(kp.valid, budget)
    take = lambda a: torch.gather(a, -1, order)
    ar = torch.arange(budget, device=order.device)
    return CompactOctaveKeypoints(
        valid=ar < count[..., None],
        scale=take(kp.scale),
        x_oct=take(kp.i.float() + kp.ofst_i),
        y_oct=take(kp.j.float() + kp.ofst_j),
        sigma_oct=take(kp.sigma) / delta,
        x=take(kp.x),
        y=take(kp.y),
        sigma=take(kp.sigma),
        value=take(kp.value),
    ), dropped


def compact_keypoints(
    per_octave: Sequence[OctaveKeypoints], config: SiftConfig, budgets: Sequence[int]
) -> Tuple[List[CompactOctaveKeypoints], torch.Tensor]:
    """Every octave's keypoint compaction into ``budgets[o]`` slots and the
    slots dropped in all of them ([B] int32): :func:`compact_keypoints_plain`
    on CPU tensors; one launch of ``csrc/describe.cu``
    ``keypoint_compact_kernel`` on CUDA tensors (``keypoint_compact_octaves``,
    no fallback), equal to it bit for bit; raises for any other device. The
    compacted fields are views of the launch's three buffers."""
    if not use_kernel(per_octave[0].scale, "keypoint_compact"):
        return compact_keypoints_plain(per_octave, config, budgets)
    b = per_octave[0].scale.shape[0]
    valid, scale, reals, dropped = keypoint_compact_octaves(
        per_octave, budgets, [config.octave_delta(o) for o in range(len(per_octave))])
    sizes = [b * n for n in budgets]
    kpcs = [CompactOctaveKeypoints(v.view(b, n), s.view(b, n), *r.view(-1, b, n).unbind(0))
            for v, s, r, n in zip(valid.split(sizes), scale.split(sizes),
                                  reals.split(sizes, dim=1), budgets)]
    return kpcs, dropped


def compact_keypoints_plain(
    per_octave: Sequence[OctaveKeypoints], config: SiftConfig, budgets: Sequence[int]
) -> Tuple[List[CompactOctaveKeypoints], torch.Tensor]:
    """The PyTorch route of :func:`compact_keypoints`: one
    :func:`compact_octave_keypoints` an octave, the dropped slots summed."""
    scale = per_octave[0].scale
    dropped = torch.zeros((scale.shape[0],), dtype=torch.int32, device=scale.device)
    kpcs = []
    for o, (kp, budget) in enumerate(zip(per_octave, budgets)):
        kpc, kp_dropped = compact_octave_keypoints(kp, o, config, budget)
        dropped = dropped + kp_dropped
        kpcs.append(kpc)
    return kpcs, dropped


def gather_keypoints(
    per_octave: Sequence[OctaveKeypoints], config: SiftConfig
) -> Tuple[Keypoints, torch.Tensor]:
    """Compact the per-octave slots into one [B, max_keypoints] set;
    returns (keypoints, n_dropped [B])."""
    n = config.max_keypoints
    cat = lambda field: torch.cat([getattr(kp, field) for kp in per_octave], -1)
    valid = torch.cat([kp.valid for kp in per_octave], -1)
    octave = torch.cat(
        [torch.full_like(kp.scale, o) for o, kp in enumerate(per_octave)], -1
    )
    order, count, dropped = compact_indices(valid, n)
    take = lambda a: torch.gather(a, -1, order)
    keypoints = Keypoints(
        valid=torch.arange(n, device=order.device) < count[..., None],
        octave=take(octave),
        scale=take(cat("scale")),
        i=take(cat("i")),
        j=take(cat("j")),
        ofst_s=take(cat("ofst_s")),
        x=take(cat("x")),
        y=take(cat("y")),
        sigma=take(cat("sigma")),
        value=take(cat("value")),
    )
    return keypoints, dropped


# --- refinement ---------------------------------------------------------------

# The Taylor step's 19-point stencil: center, 6 faces, 12 edge midpoints
# of the 3x3x3 neighbourhood (the corners are never read).
_OFFS19 = tuple(
    (ds, di, dj)
    for ds in (-1, 0, 1)
    for di in (-1, 0, 1)
    for dj in (-1, 0, 1)
    if (ds != 0) + (di != 0) + (dj != 0) <= 2
)
_IDX19 = {o: n for n, o in enumerate(_OFFS19)}


def _taylor_from_stencil(v: torch.Tensor, edge_threshold: float):
    """Taylor step + edge acceptance from a gathered [..., 19, K] stencil:
    the detection kernel's formulas at K points. Returns (ofst_i, ofst_j,
    ofst_s, value, edge_ok)."""
    at = lambda ds, di, dj: v[..., _IDX19[(ds, di, dj)], :]
    oi, oj, os_, val, hii, hjj, hij = taylor_step(at, at(0, 0, 0))
    return oi, oj, os_, val, edge_ok(hii, hjj, hij, edge_threshold)


@functools.lru_cache(maxsize=None)
def _tail_tables(
    config: SiftConfig, shapes: Tuple[Tuple[int, int], ...], n_dog: int, device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The tail's constant tables on ``device``, copied from the host once
    per (config, octave shapes, DoG planes, device): a copy from pageable
    host memory cannot run inside a CUDA graph capture. Returns (the
    sigmas of every octave's slices [n_oct * S] f32, each octave's first
    element in the flat DoG concatenation [n_oct] int64, the 19-point
    stencil's offsets [19, 3] int64)."""
    sigmas = [s for o in range(len(shapes)) for s in config.octave_sigmas(o)]
    bases, off = [], 0
    for h, w in shapes:
        bases.append(off)
        off += n_dog * h * w
    return (
        torch.tensor(sigmas, dtype=torch.float32).to(device),
        torch.tensor(bases, dtype=torch.int64).to(device),
        torch.tensor(_OFFS19, dtype=torch.int64).to(device),
    )


def _stencil_lookup(dog_all, dbase, h, w, offs, edge_threshold: float):
    """``lookup(s, i, j)`` over lanes [B, K] of the flat DoG concatenation
    ``dog_all`` [B, total]: one 19-point gather with per-lane strides
    (octave shapes differ; ``offs`` the stencil's [19, 3] offsets), then
    the Taylor step and edge test there."""
    b = dog_all.shape[0]
    hw = h * w

    def lookup(s, i, j):
        base = dbase + (s * h + i) * w + j                      # [B, k]
        idx = (
            base[:, None, :]
            + offs[None, :, 0, None] * hw[:, None, :]
            + offs[None, :, 1, None] * w[:, None, :]
            + offs[None, :, 2, None]
        )                                                       # [B, 19, k]
        v = torch.gather(dog_all, 1, idx.reshape(b, -1)).reshape(idx.shape)
        return _taylor_from_stencil(v, edge_threshold)

    return lookup


def _refine_batched(
    lookup,
    s_max: int,
    s0: torch.Tensor,
    i0: torch.Tensor,
    j0: torch.Tensor,
    h,
    w,
    *,
    max_iterations: int,
    max_offset: float,
    active0: torch.Tensor,
):
    """IPOL refinement walk of every lane at once ([B, K] tensors; ``h``
    and ``w`` per lane). Moves are clamped to the interior; lanes stop
    when converged. The walk always runs ``max_iterations`` iterations,
    done lanes masked, and reads nothing back to the host: the values of
    the JAX package's ``lax.while_loop``, which stops once every lane is
    done.

    ``lookup(s, i, j)`` returns (ofst_i, ofst_j, ofst_s, value, edge_ok)
    at the integer positions; the edge flag of a lane's final position
    is carried out with it."""
    mo = max_offset
    zeros = torch.zeros(s0.shape, dtype=torch.float32, device=s0.device)
    falses = torch.zeros(s0.shape, dtype=torch.bool, device=s0.device)
    s, i, j = s0, i0, j0
    conv, edge = falses, falses
    oi = oj = os_ = val = zeros
    done = ~active0
    for _ in range(max_iterations):
        noi, noj, nos, nval, nedge = lookup(s, i, j)
        nconv = (noi.abs() < mo) & (noj.abs() < mo) & (nos.abs() < mo)
        di = ((noi > mo) & (i + 1 <= h - 2)).long() - ((noi < -mo) & (i - 1 >= 1)).long()
        dj = ((noj > mo) & (j + 1 <= w - 2)).long() - ((noj < -mo) & (j - 1 >= 1)).long()
        ds = ((nos > mo) & (s + 1 <= s_max)).long() - ((nos < -mo) & (s - 1 >= 1)).long()
        active = ~done
        conv = torch.where(active, nconv, conv)
        oi = torch.where(active, noi, oi)
        oj = torch.where(active, noj, oj)
        os_ = torch.where(active, nos, os_)
        val = torch.where(active, nval, val)
        edge = torch.where(active, nedge, edge)
        move = active & ~nconv
        i = torch.where(move, i + di, i)
        j = torch.where(move, j + dj, j)
        s = torch.where(move, s + ds, s)
        done = done | nconv
    return s, i, j, conv, oi, oj, os_, val, edge


def detect_all_octaves_batch(
    dogs: Sequence[torch.Tensor], config: SiftConfig
) -> Tuple[List[OctaveKeypoints], Dict[str, torch.Tensor]]:
    """Detection over all octaves: one detection launch over every octave,
    then one fused cross-octave tail. Returns (per-octave keypoint slot
    lists [B, m_o + k_move], aggregate counters [B])."""
    outs = detect_candidates_octaves(
        dogs, 0.8 * config.dog_threshold, config.edge_threshold,
        emit_fields=config.detect_slot_fields,
    )
    shapes = [tuple(dog.shape[-2:]) for dog in dogs]
    k_move = mover_budget_all(config, shapes)
    return refine_tail(outs, dogs, tuple(shapes), config, k_move)


def refine_tail(
    outs: Sequence[Candidates],
    dogs: Sequence[torch.Tensor],
    shapes: Tuple[Tuple[int, int], ...],
    config: SiftConfig,
    k_move: int,
) -> Tuple[List[OctaveKeypoints], Dict[str, torch.Tensor]]:
    """The cross-octave tail after detection: :func:`_tail_all_octaves`,
    the plain version, on CPU tensors; one launch of ``csrc/detect.cu``
    ``refine_tail_kernel`` on CUDA tensors (``refine_tail_octaves``, no
    fallback), whose fields equal the plain version's bit for bit; raises
    for any other device. The per-octave lists are views of the launch's
    three output buffers."""
    if not use_kernel(dogs[0], "refine_tail"):
        return _tail_all_octaves(outs, dogs, shapes, config, k_move)
    lean = not config.detect_slot_fields
    grid = [extrema_candidate_budget(config, s) if lean else math.prod(out.cand_col.shape[1:])
            for out, s in zip(outs, shapes)]
    flags, ints, reals, counters = refine_tail_octaves(
        outs, dogs, grid, k_move,
        [config.octave_delta(o) for o in range(len(dogs))],
        [config.octave_sigmas(o) for o in range(len(dogs))],
        max_offset=config.max_interpolation_offset,
        dog_threshold=config.dog_threshold,
        edge_threshold=config.edge_threshold,
        iterations=config.max_interpolation_iterations - 1,
        ratio=2.0 ** (1.0 / config.n_scales_per_octave),
    )
    b = dogs[0].shape[0]
    widths = [m + k_move for m in grid]

    def per_octave(buf):
        parts = buf.split([b * w for w in widths], dim=1)
        return [p.view(buf.shape[0], b, w).unbind(0) for p, w in zip(parts, widths)]

    kp_list = [OctaveKeypoints(*f, *n, *r)
               for f, n, r in zip(per_octave(flags), per_octave(ints), per_octave(reals))]
    return kp_list, dict(zip(TAIL_COUNTERS, counters.unbind(0)))


def detect(
    dogs: Sequence[torch.Tensor], config: SiftConfig
) -> Tuple[List[OctaveKeypoints], Dict[str, torch.Tensor]]:
    """Detection over every octave of ONE frame's DoG stacks ([S-1, H_o,
    W_o] each): :func:`detect_all_octaves_batch` at B=1, the frame axis
    taken off every output. Returns (per-octave keypoint slots, counters).
    The JAX package's per-octave XLA route is not ported: the port has one
    detection structure (the kernel's slots and the cross-octave tail)."""
    per_octave, counters = detect_all_octaves_batch([d[None] for d in dogs], config)
    first = lambda a: a[0]
    return (
        [_map(first, kp) for kp in per_octave],
        {k: first(v) for k, v in counters.items()},
    )


def _tail_all_octaves(
    outs: Sequence[Candidates],
    dogs: Sequence[torch.Tensor],
    shapes: Tuple[Tuple[int, int], ...],
    config: SiftConfig,
    k_move: int,
):
    """The cross-octave slot tail over a batch: iteration-1 acceptance of
    every octave's slot grid, one shared mover block walked by 19-point
    DoG gathers, the final acceptance, and the per-octave re-split."""
    lean = not config.detect_slot_fields
    mo = config.max_interpolation_offset
    ratio = 2.0 ** (1.0 / config.n_scales_per_octave)
    dev = dogs[0].device
    b = dogs[0].shape[0]

    seg = []
    s_c, i_c, j_c, ok_c = [], [], [], []
    oi_c, oj_c, os_c, val_c, edge_c = [], [], [], [], []
    delta_c, sgo_c, h_c, w_c, oct_c = [], [], [], [], []
    dog_parts = []
    n_ex = n_soft = drops = 0
    n_sig = len(config.octave_sigmas(0))
    flat = lambda a: a.reshape(b, -1)
    for o, out in enumerate(outs):
        n_sc, ht, slots = out.cand_col.shape[1:]
        m_o = n_sc * ht * slots
        lane = torch.arange(m_o, device=dev)
        s_l = (lane // (ht * slots) + 1).expand(b, m_o)
        i_l = ((lane % (ht * slots)) // slots + 1).expand(b, m_o)
        j_l = flat(out.cand_col).long() + 1
        ok_l = flat(out.slot_ok)
        if lean:
            # Compact the slot grid to the octave's candidate budget
            # BEFORE any per-lane work; what does not fit is counted.
            m_o = extrema_candidate_budget(config, shapes[o])
            order_o, n_k, c_drop = compact_indices(ok_l, m_o)
            ok_l = torch.arange(m_o, device=dev) < n_k[:, None]
            pick = lambda a: torch.where(ok_l, torch.gather(a, 1, order_o), 1)
            s_l, i_l, j_l = pick(s_l), pick(i_l), pick(j_l)
            drops = drops + c_drop
        else:
            c_oi, c_oj, c_os, c_val = out.cand_fields
            oi_c.append(flat(c_oi))
            oj_c.append(flat(c_oj))
            os_c.append(flat(c_os))
            val_c.append(flat(c_val))
            edge_c.append(flat(out.cand_edge))
        seg.append(m_o)
        s_c.append(s_l)
        i_c.append(i_l)
        j_c.append(j_l)
        ok_c.append(ok_l)
        h, w = shapes[o]
        full = lambda v, dt: torch.full((m_o,), v, dtype=dt, device=dev)
        delta_c.append(full(config.octave_delta(o), torch.float32))
        sgo_c.append(full(o * n_sig, torch.int64))
        h_c.append(full(h, torch.int64))
        w_c.append(full(w, torch.int64))
        oct_c.append(full(o, torch.int64))
        dog_parts.append(flat(dogs[o]))
        n_ex = n_ex + out.n_raw
        n_soft = n_soft + out.n_soft
        drops = drops + out.n_row_dropped

    cat = lambda xs: torch.cat(xs, -1)
    s_idx, i_idx, j_idx, ok = cat(s_c), cat(i_c), cat(j_c), cat(ok_c)
    delta_l, sgo_l, h_l, w_l, oct_l = cat(delta_c), cat(sgo_c), cat(h_c), cat(w_c), cat(oct_c)
    sig_table, dbase_o, offs = _tail_tables(config, shapes, dogs[0].shape[1], dev)
    n_sc_int = outs[0].cand_col.shape[1]
    dog_all = cat(dog_parts)                                # [B, total]
    dbase_l = dbase_o[oct_l]
    bcast = lambda a: a.expand(b, a.shape[-1])

    if lean:
        # Iteration-1 Taylor step + edge test of every compacted candidate:
        # one flat 19-point gather, exactly the mover walk's lookup.
        oi1, oj1, os1, val1, edge1 = _stencil_lookup(
            dog_all, bcast(dbase_l), bcast(h_l), bcast(w_l), offs, config.edge_threshold
        )(s_idx, i_idx, j_idx)
    else:
        oi1, oj1, os1, val1, edge1 = cat(oi_c), cat(oj_c), cat(os_c), cat(val_c), cat(edge_c)

    def accept(cand_valid, s_f, i_f, j_f, conv, oi, oj, os_, val, eok, dlt, sgo, hh, ww):
        pass_hard = conv & (val.abs() > config.dog_threshold)
        pass_edge = pass_hard & eok
        x = (i_f.float() + oi) * dlt
        y = (j_f.float() + oj) * dlt
        sigma = sig_table[sgo + s_f] * ratio ** os_
        img_h = hh.float() * dlt
        img_w = ww.float() * dlt
        border_ok = (
            (x - sigma > 0.0) & (x + sigma < img_h)
            & (y - sigma > 0.0) & (y + sigma < img_w)
        )
        pass_border = pass_edge & border_ok
        i32 = lambda a: a.to(torch.int32)
        return OctaveKeypoints(
            cand_valid=cand_valid,
            converged=conv & cand_valid,
            pass_hard=pass_hard & cand_valid,
            pass_edge=pass_edge & cand_valid,
            pass_border=pass_border & cand_valid,
            scale=i32(s_f), i=i32(i_f), j=i32(j_f),
            ofst_i=oi, ofst_j=oj, ofst_s=os_,
            x=x, y=y, sigma=sigma, value=val,
        )

    conv1 = (oi1.abs() < mo) & (oj1.abs() < mo) & (os1.abs() < mo)
    kp_g = accept(
        ok & conv1, s_idx, i_idx, j_idx, conv1 & ok, oi1, oj1, os1, val1,
        edge1, bcast(delta_l), bcast(sgo_l), bcast(h_l), bcast(w_l),
    )

    # --- movers: one compaction + one walk across every octave --------
    di = ((oi1 > mo) & (i_idx + 1 <= h_l - 2)).long() - ((oi1 < -mo) & (i_idx - 1 >= 1)).long()
    dj = ((oj1 > mo) & (j_idx + 1 <= w_l - 2)).long() - ((oj1 < -mo) & (j_idx - 1 >= 1)).long()
    ds = ((os1 > mo) & (s_idx + 1 <= n_sc_int)).long() - ((os1 < -mo) & (s_idx - 1 >= 1)).long()
    move = ok & ~conv1
    order, n_mov, mov_drop = compact_indices(move, k_move)
    mv_valid = torch.arange(k_move, device=dev) < n_mov[:, None]
    take = lambda a: torch.gather(bcast(a), -1, order)
    s0_all = torch.where(mv_valid, take(s_idx + ds), 1)
    i0_all = torch.where(mv_valid, take(i_idx + di), 1)
    j0_all = torch.where(mv_valid, take(j_idx + dj), 1)
    h_m, w_m, dbase_m = take(h_l), take(w_l), take(dbase_l)

    # One walk over the whole mover block. The JAX tail walks its first
    # tier (``mover_budget`` lanes) and, per frame under ``lax.cond``, the
    # rest only when the frame has more movers; a lane past a frame's
    # movers starts at s = i = j = 1, done, with zero offsets and false
    # flags, which is what the skipped branch returns, so one walk gives
    # the same values with no host read.
    s_m, i_m, j_m, conv_m, oi_m, oj_m, os_m, val_m, edge_m = _refine_batched(
        _stencil_lookup(dog_all, dbase_m, h_m, w_m, offs, config.edge_threshold),
        n_sc_int, s0_all, i0_all, j0_all, h_m, w_m,
        max_iterations=config.max_interpolation_iterations - 1,
        max_offset=mo,
        active0=mv_valid,
    )

    kp_m = accept(
        mv_valid, s_m, i_m, j_m, conv_m & mv_valid, oi_m, oj_m, os_m,
        val_m, edge_m, take(delta_l), take(sgo_l), h_m, w_m,
    )

    cnt = lambda a: a.sum(-1, dtype=torch.int32)
    counters = {
        "n_extrema": n_ex,
        "n_soft": n_soft,
        "n_interp": cnt(kp_g.converged) + cnt(kp_m.converged),
        "n_hard": cnt(kp_g.pass_hard) + cnt(kp_m.pass_hard),
        "n_edge": cnt(kp_g.pass_edge) + cnt(kp_m.pass_edge),
        "n_border": cnt(kp_g.pass_border) + cnt(kp_m.pass_border),
        "overflow": drops + mov_drop,
        # Total mover demand (live + dropped): n_movers <= k_move keeps
        # every mover walking.
        "n_movers": n_mov + mov_drop,
    }

    # --- re-split per octave: grid segment + octave-masked mover block
    oct_m = take(oct_l)
    kp_list = []
    start = 0
    for o, m_o in enumerate(seg):
        in_oct = mv_valid & (oct_m == o)
        kp_m_o = kp_m._replace(
            cand_valid=kp_m.cand_valid & in_oct,
            converged=kp_m.converged & in_oct,
            pass_hard=kp_m.pass_hard & in_oct,
            pass_edge=kp_m.pass_edge & in_oct,
            pass_border=kp_m.pass_border & in_oct,
        )
        kp_list.append(
            _map(lambda g, mv: torch.cat([g[:, start:start + m_o], mv], 1), kp_g, kp_m_o)
        )
        start += m_o
    return kp_list, counters
