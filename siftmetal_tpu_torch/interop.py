"""Carrying results between the port and code that holds plain arrays.

The JAX package's results (a ``RansacResult``, camera 6-vectors, [N, 2]
points) reach the port as numpy arrays, and the port's go back the same
way, so both packages can compute from the same state. Nothing here
imports the JAX package: anything ``np.asarray`` accepts will do.
"""

from __future__ import annotations

import numpy as np
import torch

from .geometry.ransac import RansacResult


def to_tensor(a, device="cpu", dtype=None) -> torch.Tensor:
    """An array-like -> a tensor on ``device`` (float64 -> float32 unless
    ``dtype`` says otherwise: the port computes in fp32)."""
    arr = np.asarray(a)
    if dtype is None and arr.dtype == np.float64:
        dtype = torch.float32
    return torch.tensor(arr).to(device=device, dtype=dtype)


def to_numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def ransac_result_from_arrays(res, device="cpu") -> RansacResult:
    """Any (model, inliers, n_inliers, ok) of array-likes -> the port's
    ``RansacResult`` on ``device``."""
    model, inliers, n_inliers, ok = res
    return RansacResult(
        model=to_tensor(model, device),
        inliers=to_tensor(inliers, device, torch.bool),
        n_inliers=to_tensor(n_inliers, device, torch.int32),
        ok=to_tensor(ok, device, torch.bool),
    )


def ransac_result_to_arrays(res: RansacResult):
    """The port's ``RansacResult`` as a tuple of numpy arrays in field
    order (what ``siftmetal_tpu.geometry.RansacResult(*...)`` takes)."""
    return tuple(to_numpy(f) for f in res)
