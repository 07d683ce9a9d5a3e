"""Elementary image ops: grayscale, 2x bilinear upsample, 2x decimation.

Port of ``siftmetal_tpu/ops/image.py``. All functions take [..., H, W]
float32 tensors, so a leading batch axis needs no special case.
"""

from __future__ import annotations

import torch

# BT.709 luma coefficients applied in gamma space (IPOL convention).
_LUMA_R = 0.212639005871510
_LUMA_G = 0.715168678767756
_LUMA_B = 0.072192315360734


def rgb_to_gray(image: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3|4] (gamma-space sRGB, 0..1) -> [..., H, W] luma."""
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    return _LUMA_R * r + _LUMA_G * g + _LUMA_B * b


def symmetrize_index(i: torch.Tensor, length: int) -> torch.Tensor:
    """Half-sample symmetric boundary index: -1 -> 0, L -> L-1."""
    ll = 2 * length
    i = torch.remainder(i + ll, ll)
    return torch.where(i > length - 1, ll - 1 - i, i)


def upsample_bilinear_2x(image: torch.Tensor) -> torch.Tensor:
    """IPOL 2x bilinear oversampling: [..., H, W] -> [..., 2H, 2W]. Even
    outputs copy the input, odd outputs are neighbour midpoints, with the
    last row/column repeated at the bottom/right border."""

    def interleave(a, b, dim):
        out = torch.stack([a, b], dim=dim + 1 if dim >= 0 else dim)
        shape = list(a.shape)
        shape[dim] = 2 * shape[dim]
        return out.reshape(shape)

    right = torch.cat([image[..., :, 1:], image[..., :, -1:]], dim=-1)
    cols = interleave(image, 0.5 * (image + right), -1)
    down = torch.cat([cols[..., 1:, :], cols[..., -1:, :]], dim=-2)
    return interleave(cols, 0.5 * (cols + down), -2)


def decimate_2x(image: torch.Tensor, out_shape) -> torch.Tensor:
    """Keep every 2nd pixel; ``out_shape`` comes from the octave schedule
    (successive integer halving)."""
    oh, ow = out_shape
    return image[..., : 2 * oh : 2, : 2 * ow : 2]
