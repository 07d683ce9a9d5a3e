"""Per-keypoint patch histograms (``csrc/patches.cu``).

Replaces ``siftmetal_tpu/ops/pallas/patches.py`` ``_orientation_kernel``
(through ``orientation_hist_lanes_pallas`` :1502) and
``_descriptor_kernel`` (through ``descriptor_lanes_pallas`` :1140). A lane
is one keypoint (orientation) or one (keypoint, orientation) pair
(descriptor); lanes of every frame of a batch go through one launch, each
with its ``frame`` index and ``valid`` flag (invalid lanes return zeros).

``orient_desc_lanes`` is the fused form (``_orient_desc_kernel`` through
``orient_desc_lanes_pallas`` :1835): per keypoint, histogram -> circular
smoothings -> peaks in BIN order, the first ``max_ori`` kept -> one raw
descriptor per kept peak, in one launch. The staged path keeps the
``max_ori`` HIGHEST peaks instead; the two differ in order always and in
the set only when a keypoint has more than ``max_ori`` peaks.

What the TPU kernels needed and these do not: 8/128-aligned window DMAs
into padded fields, radius buckets, multi-keypoint lane packing, the
polynomial atan2 and the MXU entry reduction. The gradient fields here are
unpadded [B, n_scales, H, W]; the kernels bound-check instead.

``config.use_band_patches`` sends both staged stages through the
resident-tile route (``_lanes_banded_call`` :1053 on the TPU, where a
128-row full-width band of the stacked fields stayed in VMEM). On this
card the resident region is a 2-D tile of one (frame, scale) plane:
:func:`tile_layout` keys every lane by the tile of its clamped rounded
centre, sorts the lanes by key with one stable sort and marks the runs;
one block per run copies the bounding box of the run's sample windows
into shared memory once and accumulates lane after lane with the staged
kernels' arithmetic, writing each row straight to its lane (no un-permute
pass, bit-identical to the staged kernels). Dropped TPU means: the
sort-free counting sort with one-hot gathers, the padding of each band to
groups of 8 lanes, the per-call lane chunks of the scalar prefetch, the
radius buckets, and the ``rows >= band rows`` gate (a buffer-size
condition: every octave takes the route here). On a CPU tensor the route
runs the layout for real and the plain histograms on the sorted lanes,
then un-permutes. The fused form has no resident variant (none in the JAX
package either).

Bound on an H100: operations for the descriptor forms (per-sample
exp/atan2/sqrt and tent weights), bytes for the orientation forms; see
csrc/patches.cu.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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


def _kernel_args(fields: PatchFields, name, valid, frame, scale, *floats):
    """Checked, contiguous kernel operands (uint8 valid, int32 indices)."""
    require(fields.gi, name)
    require(fields.gj, name)
    if fields.gi.ndim != 4 or fields.gi.shape != fields.gj.shape:
        raise ValueError(f"{name}: gradient fields must be two equal [B, S, H, W]")
    lanes = {t.shape for t in (valid, frame, scale, *floats)}
    if len(lanes) != 1 or len(next(iter(lanes))) != 1:
        raise ValueError(f"{name}: lane arrays must share one [L] shape, got {lanes}")
    if any(t.device != fields.gi.device for t in (valid, frame, scale, *floats)):
        raise ValueError(f"{name}: lane arrays must be on the fields' device")
    ints = [t.to(torch.int32).contiguous() for t in (frame, scale)]
    fl = [require(t.to(torch.float32).contiguous(), name) for t in floats]
    return [valid.to(torch.uint8).contiguous()] + ints + fl


# Tile sides of the resident route (centres per side). With the parity
# radii (18, 40) a block holds (tile + 2 radius)^2 pixels of gi and gj plus
# its histogram columns in 55 KB / 106 KB of shared memory (csrc/patches.cu).
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


def _resident_lanes(fields, name, tile, radius, valid, frame, scale, floats,
                    n_out, plain, shape_args):
    """The resident-tile route of either stage: ``plain(valid, frame,
    scale, *floats)`` on the sorted lanes for CPU fields, the
    ``name`` kernel for CUDA fields. ``shape_args``: the kernel's
    arguments between ``tile`` and ``out``."""
    lay = tile_layout(fields.gi.shape, valid, frame, scale, floats[0], floats[1], tile)
    if not use_kernel(fields.gi, name):
        src = lay.src
        rows = plain(valid[src], frame[src], scale[src], *(a[src] for a in floats))
        out = torch.empty_like(rows)
        out[src] = rows
        return out
    args = _kernel_args(fields, name, valid, frame, scale, *floats)[1:]
    b, s, h, w = fields.gi.shape
    l = scale.shape[0]
    out = torch.zeros((l, n_out), dtype=torch.float32, device=fields.gi.device)
    order = [lay.first.to(torch.uint8), lay.run_end.to(torch.int32),
             lay.src.to(torch.int32)]
    _cuda.check(
        getattr(_cuda.library("patches"), name)(
            fields.gi.data_ptr(), fields.gj.data_ptr(), b, s, h, w, l,
            *(a.data_ptr() for a in order + args), radius, tile, *shape_args,
            out.data_ptr(), _cuda.stream_of(out),
        ),
        name,
    )
    LAUNCHES[name] += 1
    return out


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
        return _resident_lanes(
            fields, "orientation_hist_banded", ORI_TILE, config.ori_patch_radius,
            valid, frame, scale, (x_oct, y_oct, sigma_oct), config.n_orientation_bins,
            lambda v, f, sc, x, y, sg: orientation_hist_plain(
                fields.gi, fields.gj, f.long(), sc.long(), x, y, sg, v, config),
            (config.n_orientation_bins, float(config.orientation_lambda)),
        )
    if not use_kernel(fields.gi, "orientation_hist"):
        return orientation_hist_plain(
            fields.gi, fields.gj, frame.long(), scale.long(), x_oct, y_oct,
            sigma_oct, valid, config,
        )
    args = _kernel_args(fields, "orientation_hist", valid, frame, scale,
                        x_oct, y_oct, sigma_oct)
    b, s, h, w = fields.gi.shape
    l = scale.shape[0]
    out = torch.empty((l, config.n_orientation_bins), dtype=torch.float32,
                      device=fields.gi.device)
    lib = _cuda.library("patches")
    _cuda.check(
        lib.orientation_hist(
            fields.gi.data_ptr(), fields.gj.data_ptr(), b, s, h, w, l,
            *(a.data_ptr() for a in args), config.ori_patch_radius,
            config.n_orientation_bins, float(config.orientation_lambda),
            out.data_ptr(), _cuda.stream_of(out),
        ),
        "orientation_hist",
    )
    LAUNCHES["orientation_hist"] += 1
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
            fields, "descriptor_hist_banded", DESC_TILE, config.desc_patch_radius,
            valid, frame, scale, (x_oct, y_oct, sigma_oct, theta),
            config.descriptor_length,
            lambda v, f, sc, x, y, sg, th: descriptor_plain(
                fields.gi, fields.gj, f.long(), sc.long(), x, y, sg, th, v, config),
            (config.n_histograms_per_axis, config.n_descriptor_bins,
             float(config.descriptor_lambda)),
        )
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
    lib = _cuda.library("patches")
    _cuda.check(
        lib.descriptor_hist(
            fields.gi.data_ptr(), fields.gj.data_ptr(), b, s, h, w, l,
            *(a.data_ptr() for a in args), config.desc_patch_radius,
            config.n_histograms_per_axis, config.n_descriptor_bins,
            float(config.descriptor_lambda), out.data_ptr(),
            _cuda.stream_of(out),
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
    lib = _cuda.library("patches")
    _cuda.check(
        lib.orient_desc(
            fields.gi.data_ptr(), fields.gj.data_ptr(), b, s, h, w, l,
            *(a.data_ptr() for a in args), config.ori_patch_radius,
            config.n_orientation_bins, float(config.orientation_lambda),
            config.orientation_smoothing_iterations,
            float(config.orientation_peak_threshold), m,
            config.desc_patch_radius, config.n_histograms_per_axis,
            config.n_descriptor_bins, float(config.descriptor_lambda),
            raw.data_ptr(), theta.data_ptr(), ov.data_ptr(),
            _cuda.stream_of(raw),
        ),
        "orient_desc",
    )
    LAUNCHES["orient_desc"] += 1
    return raw, theta, ov.bool()
