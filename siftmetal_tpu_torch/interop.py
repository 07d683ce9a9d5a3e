"""Carrying results between the port and code that holds plain arrays.

The JAX package's results (a ``RansacResult``, camera 6-vectors, [N, 2]
points, a whole ``SfmMap``'s state) reach the port as numpy arrays, and
the port's go back the same way, so both packages can compute from the
same state. Nothing here imports the JAX package: anything
``np.asarray`` accepts will do.
"""

from __future__ import annotations

import dataclasses

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


# An SfmMap's whole state: its arrays, fill counters and per-keyframe
# records (the .npz checkpoint carries only the first six arrays).
_MAP_ARRAYS = (
    "cameras", "landmarks", "lm_desc", "obs_cam", "obs_lm", "obs_uv",
    "lm_alive", "lm_created", "lm_nobs", "obs_alive",
)
_MAP_COUNTERS = ("n_cameras", "n_landmarks", "n_obs", "n_culled")


def sfm_map_to_arrays(smap) -> dict:
    """An SfmMap of either package -> a dict of numpy arrays and plain
    values: the arrays, ``k``, the counters, ``config`` (its fields),
    ``frames`` (per keyframe (xy, desc, valid)), ``odometry`` [n-1, 6],
    ``frame_lm`` ({keyframe: (keypoint rows, landmark ids)}) and
    ``delayed_init``."""
    out = {f: np.array(getattr(smap, f)) for f in _MAP_ARRAYS}
    out.update({c: int(getattr(smap, c)) for c in _MAP_COUNTERS})
    out["k"] = to_numpy(smap.k).astype(np.float32)
    out["config"] = dataclasses.asdict(smap.config)
    out["frames"] = [tuple(to_numpy(a) for a in f) for f in smap.frames]
    out["odometry"] = np.array([to_numpy(r) for r in smap.odometry], np.float32).reshape(-1, 6)
    out["frame_lm"] = {
        int(j): (np.array(kp, np.int32), np.array(lm, np.int32))
        for j, (kp, lm) in getattr(smap, "_frame_lm", {}).items()
    }
    out["delayed_init"] = bool(getattr(smap, "_delayed_init", False))
    return out


def sfm_map_from_arrays(state: dict, device=None):
    """The dict of :func:`sfm_map_to_arrays` -> the port's ``SfmMap`` on
    ``device`` (resolved as ``SfmMap`` resolves it: the card unless the
    CPU is asked for), with every array copied."""
    from .slam.sfm import SfmConfig, SfmMap

    smap = SfmMap(state["k"], SfmConfig(**state["config"]), device=device)
    for f in _MAP_ARRAYS:
        getattr(smap, f)[:] = state[f]
    for c in _MAP_COUNTERS:
        setattr(smap, c, int(state[c]))
    smap.frames = [smap._frame(f) for f in state["frames"]]
    smap.odometry = [np.array(r, np.float32) for r in state["odometry"]]
    smap._frame_lm = {
        int(j): (np.array(kp, np.int32), np.array(lm, np.int32))
        for j, (kp, lm) in state["frame_lm"].items()
    }
    if state["delayed_init"]:
        smap._delayed_init = True
    return smap
