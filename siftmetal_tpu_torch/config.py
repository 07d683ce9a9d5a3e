"""SIFT configuration of the PyTorch/CUDA port.

The same frozen dataclass as the JAX package's ``siftmetal_tpu/config.py``:
every field, default and derived value is identical, so a configuration
written for one package carries over to the other through
:func:`config_from_dict`. Semantics follow the IPOL reference
implementation ("Anatomy of the SIFT Method", Rey-Otero & Delbracio 2014),
the origin of the golden test fixtures.

Several fields select TPU kernel variants of the JAX package
(``use_pallas_*``, ``use_mxu_pyramid``, ``mxu_blur_precision``, ...). They
are kept so that configurations round-trip unchanged; the port reads only
the algorithmic constants, the budgets and ``pyramid_dtype``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Tuple


@dataclasses.dataclass(frozen=True)
class SiftConfig:
    """All SIFT constants (hashable: usable as a cache key)."""

    # --- scale-space pyramid ---
    sigma_min: float = 0.8        # blur of the seed image v(0, 0)
    delta_min: float = 0.5        # sampling distance of the seed (0.5 = 2x upsample)
    sigma_input: float = 0.5      # assumed blur of the input image
    n_scales_per_octave: int = 3  # gaussians/octave = n+3, DoGs/octave = n+2

    # --- detection ---
    dog_threshold: float = 0.0133   # contrast threshold on |DoG|
    edge_threshold: float = 10.0    # curvature ratio r; reject trace^2/det >= (r+1)^2/r
    max_interpolation_iterations: int = 5
    max_interpolation_offset: float = 0.6

    # --- orientation ---
    n_orientation_bins: int = 36
    orientation_lambda: float = 1.5          # lambda_ori
    orientation_peak_threshold: float = 0.8  # accept peaks >= 0.8 * max
    orientation_smoothing_iterations: int = 6

    # --- descriptor ---
    n_histograms_per_axis: int = 4   # 4x4 spatial histograms
    n_descriptor_bins: int = 8       # 8 orientation bins -> 128-d descriptor
    descriptor_lambda: float = 6.0   # lambda_descr

    # --- static shape budgets (overflow is counted, never silent) ---
    max_extrema_per_octave: int = 8192
    max_keypoints: int = 4096
    max_orientations_per_keypoint: int = 4
    max_descriptors: int = 6144

    # Lanes per chunk of the plain (non-kernel) patch stages: bounds the
    # [chunk, patch^2, ...] temporaries.
    describe_lane_chunk: int = 128

    # --- TPU kernel selection of the JAX package (unused by the port) ---
    use_pallas_describe: bool = True
    use_patch_mxu_reduce: bool = True
    use_multikp_pack: bool = True
    use_band_patches: bool = False
    use_fused_describe: bool = False
    use_pallas_detect: bool = True
    detect_slot_fields: bool = True
    use_mxu_pyramid: bool = True
    mxu_blur_precision: str = "high"
    use_conv_blur: bool = False
    use_pallas_pyramid: bool = False
    use_oneshot_pyramid: bool = True

    # Precision of the Gaussian blur chain: "float32" (the IPOL-parity
    # default) or "bfloat16" (fast mode; not ported yet).
    pyramid_dtype: str = "float32"

    @property
    def n_gaussians_per_octave(self) -> int:
        return self.n_scales_per_octave + 3

    @property
    def n_dogs_per_octave(self) -> int:
        return self.n_scales_per_octave + 2

    @property
    def descriptor_length(self) -> int:
        return self.n_histograms_per_axis ** 2 * self.n_descriptor_bins

    def num_octaves(self, height: int, width: int) -> int:
        """IPOL default octave count: floor(log2(min(w,h)/delta_min/12) + 1)."""
        m = min(height, width) / self.delta_min
        return max(1, int(math.floor(math.log2(m / 12.0) + 1)))

    def octave_shapes(
        self, height: int, width: int, n_octaves: int
    ) -> Tuple[Tuple[int, int], ...]:
        """Per-octave (H, W): seed size then successive halving (IPOL).

        Raises if the top octave would fall below the 3x3x3 extrema
        stencil's needs (min dim < 4)."""
        h = int(height / self.delta_min)
        w = int(width / self.delta_min)
        shapes = [(h, w)]
        for _ in range(1, n_octaves):
            h, w = h // 2, w // 2
            shapes.append((h, w))
        if min(shapes[-1]) < 4:
            raise ValueError(
                f"n_octaves={n_octaves} gives top-octave shape "
                f"{shapes[-1]} for a {height}x{width} input (min dim < 4 "
                f"cannot hold the 3x3x3 extrema stencil); max supported "
                f"here is {self.num_octaves(height, width)} (the IPOL "
                f"formula)."
            )
        return tuple(shapes)

    def octave_delta(self, o: int) -> float:
        """Inter-pixel distance of octave ``o``."""
        return self.delta_min * (2.0 ** o)

    def octave_sigmas(self, o: int) -> Tuple[float, ...]:
        """Absolute blur of each Gaussian slice of octave ``o``:
        sigma_{o,s} = (delta_o / delta_min) * sigma_min * 2^(s/n)."""
        h = self.octave_delta(o) / self.delta_min
        return tuple(
            h * self.sigma_min * 2.0 ** (s / self.n_scales_per_octave)
            for s in range(self.n_gaussians_per_octave)
        )

    def seed_blur_sigma(self) -> float:
        """Blur applied to the upsampled seed, in seed pixels:
        sqrt(sigma_min^2 - sigma_input^2) / delta_min."""
        return (
            math.sqrt(self.sigma_min ** 2 - self.sigma_input ** 2) / self.delta_min
        )

    @property
    def sigma_oct_max(self) -> float:
        """Largest keypoint blur in octave-pixel units (bounds the static
        patch radii below)."""
        return (self.sigma_min / self.delta_min) * 2.0 ** (
            (self.n_scales_per_octave + self.max_interpolation_offset)
            / self.n_scales_per_octave
        )

    @property
    def ori_patch_radius(self) -> int:
        """Static orientation-patch radius in octave pixels: the box
        |m*delta - x| <= 3*lambda_ori*sigma, +0.5 for the rounded center."""
        return math.ceil(3.0 * self.orientation_lambda * self.sigma_oct_max + 0.5)

    @property
    def desc_patch_radius(self) -> int:
        """Static descriptor-patch radius in octave pixels: the rotated
        box has half-width sqrt(2)*lambda_descr*sigma*(n+1)/n."""
        return math.ceil(
            math.sqrt(2.0)
            * self.descriptor_lambda
            * self.sigma_oct_max
            * (self.n_histograms_per_axis + 1)
            / self.n_histograms_per_axis
            + 0.5
        )

    def incremental_sigmas(self, o: int) -> Tuple[float, ...]:
        """rho[s-1 -> s] = sqrt(sigma_s^2 - sigma_{s-1}^2) / delta_o, s=1..n+2."""
        sigmas = self.octave_sigmas(o)
        delta = self.octave_delta(o)
        return tuple(
            math.sqrt(sigmas[s] ** 2 - sigmas[s - 1] ** 2) / delta
            for s in range(1, len(sigmas))
        )


def config_from_dict(d: Mapping[str, Any]) -> SiftConfig:
    """Build a :class:`SiftConfig` from ``dataclasses.asdict`` of either
    package's config. Unknown keys raise (a silently dropped field would
    change the algorithm without notice)."""
    names = {f.name for f in dataclasses.fields(SiftConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown SiftConfig fields: {sorted(unknown)}")
    return SiftConfig(**dict(d))


DEFAULT_CONFIG = SiftConfig()

# Lowe-style fast preset: no 2x oversampling (delta_min = 1).
FAST_CONFIG = SiftConfig(delta_min=1.0)

# FAST with a bf16 blur chain (the port runs fp32 only so far; see ROADMAP).
FAST_BF16_CONFIG = SiftConfig(delta_min=1.0, pyramid_dtype="bfloat16")
