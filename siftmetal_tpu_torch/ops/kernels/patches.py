"""Per-keypoint patch histograms (``csrc/patches.cu``).

Replaces ``siftmetal_tpu/ops/pallas/patches.py`` ``_orientation_kernel``
(through ``orientation_hist_lanes_pallas`` :1502) and
``_descriptor_kernel`` (through ``descriptor_lanes_pallas`` :1140). A lane
is one keypoint (orientation) or one (keypoint, orientation) pair
(descriptor); lanes of every frame of a batch go through one launch, each
with its ``frame`` index and ``valid`` flag (invalid lanes return zeros).

What the TPU kernels needed and these do not: 8/128-aligned window DMAs
into padded fields, radius buckets, multi-keypoint lane packing, the
polynomial atan2 and the MXU entry reduction. The gradient fields here are
unpadded [B, n_scales, H, W]; the kernels bound-check instead.

Bound on an H100: operations (per-sample exp/atan2/sqrt and tent weights);
see csrc/patches.cu.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...config import SiftConfig
from ...sift.describe import descriptor_plain, gradients, orientation_hist_plain
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
