"""Per-keypoint patch histograms (``csrc/patches.cu``).

Replaces ``siftmetal_tpu/ops/pallas/patches.py`` ``_orientation_kernel``
(through ``orientation_hist_lanes_pallas`` :1502) and
``_descriptor_kernel`` (through ``descriptor_lanes_pallas`` :1140). A lane
is one keypoint (orientation) or one (keypoint, orientation) pair
(descriptor); lanes of every frame of a batch go through one launch, each
with its ``frame`` index and ``valid`` flag (invalid lanes return zeros).
:func:`orientation_hist_octaves` takes every octave of a batch in one
orientation launch (an octave table laid out by :func:`orientation_plan`)
and writes the rows of all octaves into one [B, sum of budgets, n_bins]
array; :func:`orientation_hist_lanes` is the same kernel over one lane
array.

``orient_desc_lanes`` is the fused form (``_orient_desc_kernel`` through
``orient_desc_lanes_pallas`` :1835): per keypoint, histogram -> circular
smoothings -> peaks in BIN order, the first ``max_ori`` kept -> one raw
descriptor per kept peak, in one launch. The staged path keeps the
``max_ori`` HIGHEST peaks instead; the two differ in order always and in
the set only when a keypoint has more than ``max_ori`` peaks. Its block
has the staged descriptor block's warps (8 for the (4, 8) shape): the
staged orientation kernel's 128 columns give the raw histogram, one warp
smooths it and picks the peaks (bins across its lanes, ranks by ballot),
and the staged descriptor kernel's routine computes each kept peak, so
the fused descriptor equals the staged kernel's at the same theta bit for
bit.

What the TPU kernels needed and these do not: 8/128-aligned window DMAs
into padded fields, radius buckets, multi-keypoint lane packing, the
polynomial atan2 and the MXU entry reduction. The gradient fields here are
unpadded [B, n_scales, H, W]; the kernels bound-check instead.

The staged descriptor kernel splits each lane over 8 warps (one block a
lane): each warp takes every 8th round of 32 window candidates, queues the
accepted ones by ballot, weighs 32 at a time and contracts them into a
register histogram; the 8 partial histograms are summed in warp order, so
a run repeats bit for bit (csrc/patches.cu). Shapes other than (4, 8)
take a generic instance, one warp a lane.

``config.use_band_patches`` sends both staged stages through the
resident-tile route (``_lanes_banded_call`` :1053 on the TPU, where a
128-row full-width band of the stacked fields stayed in VMEM). On this
card the resident region is a 2-D tile of one (frame, scale) plane: every
lane is keyed by the tile of its clamped rounded centre, and the lanes of
one tile form a run whose windows' bounding box one block copies into
shared memory; each lane's row goes straight to its lane (no un-permute
pass) and equals the staged kernel's bit for bit. Both forms order the
lanes with :func:`tile_runs` (a counting sort in three small CUDA
kernels, the order inside a run free) and run a persistent grid that
takes the runs from a counter. Dropped TPU means: the sort-free
counting sort with one-hot gathers, the padding of each band to groups of
8 lanes, the per-call lane chunks of the scalar prefetch, the radius
buckets, and the ``rows >= band rows`` gate (a buffer-size condition:
every octave takes the route here). On a CPU tensor the route runs
:func:`tile_layout` for real and the plain histograms on the sorted
lanes, then un-permutes. The fused form has no resident variant (none in
the JAX package either).

Bound on an H100: operations for the descriptor forms (per-sample
exp/atan2/sqrt and tent weights), bytes for the orientation forms; see
csrc/patches.cu.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ...config import SiftConfig
from ...sift.describe import (
    _smooth_circular,
    descriptor_plain,
    gradients,
    orientation_hist_plain,
    orientation_peaks_bin_order,
)
from .. import cuda as _cuda
from . import LAUNCHES, require, use_kernel


class PatchFields(NamedTuple):
    """Gradient fields of one octave shared by both patch stages."""

    gi: torch.Tensor  # [B, n_scales, H, W] d/drow
    gj: torch.Tensor  # [B, n_scales, H, W] d/dcol


def prepare_patch_fields(gauss: torch.Tensor, config: SiftConfig) -> PatchFields:
    """Gradients of Gaussian slices 1..n of a [B, S, H, W] octave."""
    gi, gj = gradients(gauss[:, 1:config.n_scales_per_octave + 1])
    return PatchFields(gi.contiguous(), gj.contiguous())


def _lanes(scale, valid, frame):
    l = scale.shape[0]
    dev = scale.device
    if valid is None:
        valid = torch.ones((l,), dtype=torch.bool, device=dev)
    if frame is None:
        frame = torch.zeros((l,), dtype=torch.int32, device=dev)
    return valid, frame


def _as_uint8(valid: torch.Tensor) -> torch.Tensor:
    """A lane mask as the kernels read it: a bool mask is viewed as its
    0/1 bytes (no copy), any other dtype converted."""
    valid = valid.contiguous()
    return valid.view(torch.uint8) if valid.dtype == torch.bool else valid.to(torch.uint8)


def _kernel_args(fields: PatchFields, name, valid, frame, scale, *floats):
    """Checked, contiguous kernel operands (uint8 valid, int32 indices);
    ``frame`` None stays None (the lane's frame follows from its index)."""
    require(fields.gi, name)
    require(fields.gj, name)
    if fields.gi.ndim != 4 or fields.gi.shape != fields.gj.shape:
        raise ValueError(f"{name}: gradient fields must be two equal [B, S, H, W]")
    given = [t for t in (valid, frame, scale, *floats) if t is not None]
    lanes = {t.shape for t in given}
    if len(lanes) != 1 or len(next(iter(lanes))) != 1:
        raise ValueError(f"{name}: lane arrays must share one [L] shape, got {lanes}")
    if any(t.device != fields.gi.device for t in given):
        raise ValueError(f"{name}: lane arrays must be on the fields' device")
    ints = [None if t is None else t.to(torch.int32).contiguous() for t in (frame, scale)]
    fl = [require(t.to(torch.float32).contiguous(), name) for t in floats]
    return [_as_uint8(valid)] + ints + fl


# Lanes an orientation scan reads (csrc/patches.cu kOriScan) and the
# octaves a launch takes (kMaxOriOctaves).
ORI_SCAN = 32
MAX_ORI_OCTAVES = 16


class OrientationOctave(NamedTuple):
    """Where one octave sits in an orientation launch: lane l (frame l //
    budget, slot l % budget) of the octave's [lanes] arrays is lane
    lane0 + l of the launch and is written to row f * row_stride + first +
    l % budget of the output; scan c of the launch (c - scan0 <
    ceil(lanes / ORI_SCAN)) reads the flags of its lanes
    [(c - scan0) * ORI_SCAN, ...)."""

    lanes: int
    budget: int
    first: int
    scan0: int
    lane0: int


def orientation_plan(budgets: Sequence[int], batch: int) -> Tuple[List[OrientationOctave], int, int]:
    """The orientation launch over octaves of ``budgets`` keypoint slots a
    frame (in order), their rows concatenated frame by frame: each
    octave's plan, the number of scans and the rows of a frame."""
    plans, scan, first, lane0 = [], 0, 0, 0
    for budget in budgets:
        lanes = batch * budget
        plans.append(OrientationOctave(lanes, budget, first, scan, lane0))
        scan += -(-lanes // ORI_SCAN)
        first += budget
        lane0 += lanes
    return plans, scan, first


def _orientation_launch(octaves, out: torch.Tensor, row_stride: int, config: SiftConfig) -> None:
    """One launch of the orientation kernel over ``octaves``, each
    (fields, [valid, frame or None, scale, x, y, sigma] as _kernel_args
    gives them, budget): the rows of each octave placed by
    :func:`orientation_plan` in ``out`` ([..., n_bins] fp32)."""
    if len(octaves) > MAX_ORI_OCTAVES:
        raise ValueError(f"orientation_hist: {len(octaves)} octaves, at most {MAX_ORI_OCTAVES} a launch")
    budgets = [o[2] for o in octaves]
    plans, scans, _ = orientation_plan(budgets, octaves[0][1][0].shape[0] // budgets[0])
    n_bins = config.n_orientation_bins
    row_bytes = n_bins * out.element_size()
    table = np.zeros(1 + 18 * len(octaves), np.int64)
    table[0] = len(octaves)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    for o, ((fields, args, budget), p) in enumerate(zip(octaves, plans)):
        if args[0].shape[0] != p.lanes:
            raise ValueError(f"orientation_hist: octave {o} has {args[0].shape[0]} lanes, "
                             f"not {p.lanes}")
        table[1 + 18 * o:19 + 18 * o] = (
            fields.gi.data_ptr(), fields.gj.data_ptr(), *(ptr(a) for a in args),
            out.data_ptr() + p.first * row_bytes, *fields.gi.shape, p.lanes, budget,
            row_stride, p.scan0, p.lane0)
    if scans == 0:
        return
    # The kernel's counters and its queue of valid lanes, zeroed.
    work = torch.zeros((4 + sum(p.lanes for p in plans),), dtype=torch.int32, device=out.device)
    with _cuda.launch_on(out) as stream:
        _cuda.check(
            _cuda.library("patches").orientation_octaves(
                table.ctypes.data_as(ctypes.c_void_p), config.ori_patch_radius, n_bins,
                float(config.orientation_lambda), work.data_ptr(), stream),
            "orientation_hist",
        )
    LAUNCHES["orientation_hist"] += 1


# Tile sides of the resident route (centres per side), each the fastest
# of the sweep chip_smoke.py prints (for the orientation form, whose call
# is host-bound, by the device time of kernel and layout together: side 32
# spends the least, the layout's scan over fewer tiles outweighing a kernel
# a little slower than at smaller sides). A block holds (tile + 2 radius)^2
# pixels of gi and gj, plus the orientation form's histogram columns (18 KB;
# radius 18) or the descriptor form's staging (35 KB; radius 40: 109 KB in
# all at tile 16, two blocks an SM; csrc/patches.cu).
ORI_TILE = 32
DESC_TILE = 16


class TileLayout(NamedTuple):
    """Lanes in tile order: ``src[q]`` is the lane at sorted position q
    (valid lanes by tile key, stable; invalid lanes last); a run of lanes
    that share a tile starts at every q with ``first[q]`` and ends before
    ``run_end[q]``. Invalid lanes are in no run."""

    src: torch.Tensor      # [L] int64
    first: torch.Tensor    # [L] bool
    run_end: torch.Tensor  # [L] int64


def tile_layout(shape, valid, frame, scale, x_oct, y_oct, tile: int) -> TileLayout:
    """Tile order of [L] lanes over fields of ``shape`` [B, S, H, W]. The
    key of a lane is (frame, scale, row tile, column tile) of its rounded
    centre clamped into the image, as the kernels clamp it. No host
    synchronisation."""
    b, s, h, w = shape
    f = frame.long().clamp(0, b - 1)
    sc = scale.long().clamp(1, s) - 1
    zero = torch.zeros_like(x_oct)
    ci = torch.round(torch.where(valid, x_oct, zero)).long().clamp(0, h - 1)
    cj = torch.round(torch.where(valid, y_oct, zero)).long().clamp(0, w - 1)
    tr, tc = -(-h // tile), -(-w // tile)
    n_tiles = b * s * tr * tc
    key = ((f * s + sc) * tr + ci // tile) * tc + cj // tile
    key = torch.where(valid, key, torch.full_like(key, n_tiles))
    skey, src = torch.sort(key, stable=True)
    prev = torch.cat([skey.new_full((1,), -1), skey[:-1]])
    first = (skey != prev) & (skey < n_tiles)
    return TileLayout(src, first, torch.searchsorted(skey, skey, right=True))


class TileRuns(NamedTuple):
    """The resident forms' layout: ``src``, ``first`` and ``run_end`` as
    :func:`tile_layout` gives them, and the first sorted position of every
    run in ``heads[:runs[0]]``. From the CUDA layout the indices are int32,
    the order of lanes inside a run and of the heads is the atomics', and
    ``runs[1]`` is the kernel's counter of runs handed out."""

    src: torch.Tensor
    first: torch.Tensor
    run_end: torch.Tensor
    heads: torch.Tensor    # [L], the first runs[0] used
    runs: torch.Tensor     # [2] int32


def tile_runs(shape, valid, frame, scale, x_oct, y_oct, tile: int) -> TileRuns:
    """:func:`tile_layout` as the resident kernels take it: on a CUDA
    device a counting sort by tile key in three small kernels (count with
    ranks, one-block exclusive scan, scatter) and no host
    synchronisation; on the CPU the plain layout and its run heads. Part
    of the resident launch that uses it, which counts it."""
    if not use_kernel(x_oct, "tile_runs"):
        lay = tile_layout(shape, valid.bool(), frame, scale, x_oct, y_oct, tile)
        heads = torch.nonzero(lay.first).flatten()
        runs = torch.tensor([heads.numel(), 0], dtype=torch.int32)
        return TileRuns(*lay, heads, runs)
    lanes = [_as_uint8(valid), frame.to(torch.int32).contiguous(),
             scale.to(torch.int32).contiguous(),
             require(x_oct.contiguous(), "tile_runs"), require(y_oct.contiguous(), "tile_runs")]
    with _cuda.launch_on(x_oct) as stream:
        return _tile_runs_cuda(shape, lanes, tile, stream)


def _tile_runs_cuda(shape, lanes, tile, stream) -> TileRuns:
    """The CUDA layout of :func:`tile_runs` for lanes already in the
    kernels' types: [valid uint8, frame int32, scale int32, x, y float32]."""
    b, s, h, w = shape
    l = lanes[0].shape[0]
    n_tiles = b * s * (-(-h // tile)) * (-(-w // tile))
    dev = lanes[0].device
    ints = torch.empty((2 * (n_tiles + 1) + 4 * l + 2,), dtype=torch.int32, device=dev)
    count, start, rank, src, run_end, heads, runs = torch.split(
        ints, [n_tiles + 1, n_tiles + 1, l, l, l, l, 2])
    first = torch.empty((l,), dtype=torch.uint8, device=dev)
    _cuda.check(
        _cuda.library("patches").tile_runs(
            b, s, h, w, l, *(a.data_ptr() for a in lanes), tile,
            *(a.data_ptr() for a in (count, start, rank, src, first, run_end, heads, runs)),
            stream,
        ),
        "tile_runs",
    )
    return TileRuns(src, first.view(torch.bool), run_end, heads, runs)


def _resident_lanes(fields, name, tile, valid, frame, scale, floats, plain, kernel):
    """The resident-tile route of either stage: ``kernel()`` (the ``name``
    kernel) for CUDA fields; for CPU fields the layout for real, ``plain(
    valid, frame, scale, *floats)`` on the sorted lanes and the rows back
    to their lanes."""
    if use_kernel(fields.gi, name):
        return kernel()
    valid = valid.bool()
    src = tile_layout(fields.gi.shape, valid, frame, scale, floats[0], floats[1], tile).src
    rows = plain(valid[src], frame[src], scale[src], *(a[src] for a in floats))
    out = torch.empty_like(rows)
    out[src] = rows
    return out


def _resident_call(fields, name, tile, width, valid, frame, scale, floats, radius, *shape):
    """Resident kernel ``name`` on CUDA fields over the :func:`tile_runs`
    layout of its lanes: [L, width] rows, zeros for invalid lanes."""
    valid, frame = _lanes(scale, valid, frame)
    args = _kernel_args(fields, name, valid, frame, scale, *floats)
    b, s, h, w = fields.gi.shape
    out = torch.zeros((scale.shape[0], width), dtype=torch.float32, device=fields.gi.device)
    with _cuda.launch_on(fields.gi) as stream:
        lay = _tile_runs_cuda(fields.gi.shape, args[:5], tile, stream)
        _cuda.check(
            getattr(_cuda.library("patches"), name)(
                fields.gi.data_ptr(), fields.gj.data_ptr(), b, s, h, w,
                *(a.data_ptr() for a in (lay.heads, lay.runs, lay.run_end, lay.src)
                  + tuple(args[1:])),
                radius, tile, *shape, out.data_ptr(), stream,
            ),
            name,
        )
    LAUNCHES[name] += 1
    return out


def resident_orientation_lanes(
    fields: PatchFields, scale, x_oct, y_oct, sigma_oct, config: SiftConfig,
    valid, frame, tile: int = ORI_TILE,
) -> torch.Tensor:
    """``orientation_hist_lanes`` under ``use_band_patches`` on CUDA fields:
    the tile layout (:func:`tile_runs`) and the resident kernel. Equal to
    the staged kernel bit for bit."""
    return _resident_call(
        fields, "orientation_hist_banded", tile, config.n_orientation_bins, valid, frame,
        scale, (x_oct, y_oct, sigma_oct), config.ori_patch_radius,
        config.n_orientation_bins, float(config.orientation_lambda))


def resident_descriptor_lanes(
    fields: PatchFields, scale, x_oct, y_oct, sigma_oct, theta, config: SiftConfig,
    valid, frame, tile: int = DESC_TILE,
) -> torch.Tensor:
    """``descriptor_lanes`` under ``use_band_patches`` on CUDA fields: the
    tile layout (:func:`tile_runs`) and the resident kernel. Equal to the
    staged kernel bit for bit."""
    return _resident_call(
        fields, "descriptor_hist_banded", tile, config.descriptor_length, valid, frame,
        scale, (x_oct, y_oct, sigma_oct, theta), config.desc_patch_radius,
        config.n_histograms_per_axis, config.n_descriptor_bins, float(config.descriptor_lambda))


def orientation_hist_lanes(
    fields: PatchFields,
    scale: torch.Tensor,
    x_oct: torch.Tensor,
    y_oct: torch.Tensor,
    sigma_oct: torch.Tensor,
    config: SiftConfig,
    valid: Optional[torch.Tensor] = None,
    frame: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Raw (un-smoothed) [L, n_bins] orientation histograms."""
    valid, frame = _lanes(scale, valid, frame)
    if config.use_band_patches:
        floats = (x_oct, y_oct, sigma_oct)
        return _resident_lanes(
            fields, "orientation_hist_banded", ORI_TILE, valid, frame, scale, floats,
            lambda v, f, sc, x, y, sg: orientation_hist_plain(
                fields.gi, fields.gj, f.long(), sc.long(), x, y, sg, v, config),
            lambda: resident_orientation_lanes(fields, scale, *floats, config, valid, frame))
    if not use_kernel(fields.gi, "orientation_hist"):
        return orientation_hist_plain(
            fields.gi, fields.gj, frame.long(), scale.long(), x_oct, y_oct,
            sigma_oct, valid, config,
        )
    args = _kernel_args(fields, "orientation_hist", valid, frame, scale,
                        x_oct, y_oct, sigma_oct)
    l = scale.shape[0]
    out = torch.empty((l, config.n_orientation_bins), dtype=torch.float32,
                      device=fields.gi.device)
    # One octave whose lanes are one "frame" of l slots: row l is lane l.
    _orientation_launch([(fields, args, max(l, 1))], out, l, config)
    return out


def orientation_hist_octaves(
    fields: Sequence[PatchFields], kpcs: Sequence, config: SiftConfig
) -> torch.Tensor:
    """Raw [B, sum of budgets, n_bins] orientation histograms of every
    octave's compacted keypoints (``kpcs[o]``: ``valid``, ``scale``,
    ``x_oct``, ``y_oct``, ``sigma_oct`` of [B, budget_o]; ``fields[o]``
    its gradients), octave after octave along the rows of each frame. On
    CUDA fields one launch of the orientation kernel (no concatenation);
    under ``use_band_patches`` and on the CPU the per-octave calls of
    :func:`orientation_hist_lanes`, concatenated."""
    b = kpcs[0].valid.shape[0]
    if config.use_band_patches or not use_kernel(fields[0].gi, "orientation_hist"):
        hists = []
        for f, k in zip(fields, kpcs):
            budget = k.valid.shape[1]
            flat = lambda a: a.reshape(b * budget)
            frame = torch.arange(b, dtype=torch.int32, device=k.valid.device).repeat_interleave(budget)
            hists.append(orientation_hist_lanes(
                f, flat(k.scale), flat(k.x_oct), flat(k.y_oct), flat(k.sigma_oct), config,
                valid=flat(k.valid), frame=frame).reshape(b, budget, -1))
        return torch.cat(hists, dim=1)
    octaves = []
    for f, k in zip(fields, kpcs):
        if k.valid.shape[0] != b:
            raise ValueError(f"orientation_hist: octaves of {k.valid.shape[0]} and {b} frames")
        flat = lambda a: a.reshape(-1)
        args = _kernel_args(f, "orientation_hist", flat(k.valid), None, flat(k.scale),
                            flat(k.x_oct), flat(k.y_oct), flat(k.sigma_oct))
        octaves.append((f, args, k.valid.shape[1]))
    total = sum(o[2] for o in octaves)
    out = torch.empty((b, total, config.n_orientation_bins), dtype=torch.float32,
                      device=fields[0].gi.device)
    _orientation_launch(octaves, out, total, config)
    return out


def descriptor_lanes(
    fields: PatchFields,
    scale: torch.Tensor,
    x_oct: torch.Tensor,
    y_oct: torch.Tensor,
    sigma_oct: torch.Tensor,
    theta: torch.Tensor,
    config: SiftConfig,
    valid: Optional[torch.Tensor] = None,
    frame: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Raw (un-normalized) [L, n_hist^2 * n_ori] descriptor histograms."""
    valid, frame = _lanes(scale, valid, frame)
    if config.use_band_patches:
        return _resident_lanes(
            fields, "descriptor_hist_banded", DESC_TILE, valid, frame, scale,
            (x_oct, y_oct, sigma_oct, theta),
            lambda v, f, sc, x, y, sg, th: descriptor_plain(
                fields.gi, fields.gj, f.long(), sc.long(), x, y, sg, th, v, config),
            lambda: resident_descriptor_lanes(fields, scale, x_oct, y_oct, sigma_oct, theta,
                                              config, valid, frame))
    if not use_kernel(fields.gi, "descriptor_hist"):
        return descriptor_plain(
            fields.gi, fields.gj, frame.long(), scale.long(), x_oct, y_oct,
            sigma_oct, theta, valid, config,
        )
    args = _kernel_args(fields, "descriptor_hist", valid, frame, scale,
                        x_oct, y_oct, sigma_oct, theta)
    b, s, h, w = fields.gi.shape
    l = scale.shape[0]
    out = torch.empty((l, config.descriptor_length), dtype=torch.float32,
                      device=fields.gi.device)
    with _cuda.launch_on(out) as stream:
        _cuda.check(
            _cuda.library("patches").descriptor_hist(
                fields.gi.data_ptr(), fields.gj.data_ptr(), b, s, h, w, l,
                *(a.data_ptr() for a in args), config.desc_patch_radius,
                config.n_histograms_per_axis, config.n_descriptor_bins,
                float(config.descriptor_lambda), out.data_ptr(), stream,
            ),
            "descriptor_hist",
        )
    LAUNCHES["descriptor_hist"] += 1
    return out


def orient_desc_lanes_plain(
    fields: PatchFields, scale, x_oct, y_oct, sigma_oct, config: SiftConfig,
    valid, frame,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused kernel's function in PyTorch: plain histograms, smoothing,
    the bin-order peak pick, plain descriptors of the kept peaks."""
    m = config.max_orientations_per_keypoint
    fr, sc = frame.long(), scale.long()
    hist = orientation_hist_plain(
        fields.gi, fields.gj, fr, sc, x_oct, y_oct, sigma_oct, valid, config
    )
    hist = _smooth_circular(hist, config.orientation_smoothing_iterations)
    theta, ov = orientation_peaks_bin_order(hist, config)
    ov = ov & valid[:, None]
    rep = lambda a: a.repeat_interleave(m)
    raw = descriptor_plain(
        fields.gi, fields.gj, rep(fr), rep(sc), rep(x_oct), rep(y_oct),
        rep(sigma_oct), theta.reshape(-1), ov.reshape(-1), config,
    )
    return raw.reshape(scale.shape[0], m, -1), theta, ov


def orient_desc_lanes(
    fields: PatchFields,
    scale: torch.Tensor,
    x_oct: torch.Tensor,
    y_oct: torch.Tensor,
    sigma_oct: torch.Tensor,
    config: SiftConfig,
    valid: Optional[torch.Tensor] = None,
    frame: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused orientation + descriptor stage of [L] keypoints. Returns (raw
    [L, max_ori, n_hist^2 * n_ori] un-normalized descriptors, theta
    [L, max_ori] in [-pi, pi), ori_valid [L, max_ori] bool); invalid lanes
    and missing peaks are zeros."""
    valid, frame = _lanes(scale, valid, frame)
    if not use_kernel(fields.gi, "orient_desc"):
        return orient_desc_lanes_plain(
            fields, scale, x_oct, y_oct, sigma_oct, config, valid, frame
        )
    args = _kernel_args(fields, "orient_desc", valid, frame, scale,
                        x_oct, y_oct, sigma_oct)
    b, s, h, w = fields.gi.shape
    l = scale.shape[0]
    m = config.max_orientations_per_keypoint
    dev = fields.gi.device
    raw = torch.empty((l, m, config.descriptor_length), dtype=torch.float32, device=dev)
    theta = torch.empty((l, m), dtype=torch.float32, device=dev)
    ov = torch.empty((l, m), dtype=torch.uint8, device=dev)
    with _cuda.launch_on(raw) as stream:
        _cuda.check(
            _cuda.library("patches").orient_desc(
                fields.gi.data_ptr(), fields.gj.data_ptr(), b, s, h, w, l,
                *(a.data_ptr() for a in args), config.ori_patch_radius,
                config.n_orientation_bins, float(config.orientation_lambda),
                config.orientation_smoothing_iterations,
                float(config.orientation_peak_threshold), m,
                config.desc_patch_radius, config.n_histograms_per_axis,
                config.n_descriptor_bins, float(config.descriptor_lambda),
                raw.data_ptr(), theta.data_ptr(), ov.data_ptr(), stream,
            ),
            "orient_desc",
        )
    LAUNCHES["orient_desc"] += 1
    return raw, theta, ov.bool()
