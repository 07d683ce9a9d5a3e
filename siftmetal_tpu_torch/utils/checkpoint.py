"""Checkpoint / resume for maps and trajectories.

Port of ``siftmetal_tpu/utils/checkpoint.py``, in the same format: one
compressed ``.npz`` holding the map's arrays, its intrinsics ``k`` and a
JSON ``__meta__`` record of the fill counters. A map saved by either
package loads in the other.
"""

from __future__ import annotations

import json
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from ..slam.sfm import SfmMap


_FIELDS = (
    "cameras",
    "landmarks",
    "lm_desc",
    "obs_cam",
    "obs_lm",
    "obs_uv",
)
_COUNTERS = ("n_cameras", "n_landmarks", "n_obs")


def save_map(path: str, smap: "SfmMap") -> None:
    """Write an SfmMap checkpoint (.npz)."""
    from ..interop import to_numpy

    arrays = {f: getattr(smap, f) for f in _FIELDS}
    arrays["k"] = to_numpy(smap.k)
    meta = {c: int(getattr(smap, c)) for c in _COUNTERS}
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)


def load_map(path: str, config=None, device=None) -> "SfmMap":
    """Restore an SfmMap checkpoint onto ``device`` (CUDA by default)."""
    from ..slam.sfm import SfmConfig, SfmMap

    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["__meta__"]))
    cfg = config or SfmConfig(
        max_cameras=z["cameras"].shape[0],
        max_landmarks=z["landmarks"].shape[0],
        max_observations=z["obs_cam"].shape[0],
    )
    smap = SfmMap(z["k"], cfg, device=device)
    for f in _FIELDS:
        getattr(smap, f)[:] = z[f]
    for c in _COUNTERS:
        setattr(smap, c, meta[c])
    return smap


def rotation_to_quaternion(r: np.ndarray) -> np.ndarray:
    """[3,3] rotation -> unit quaternion (qx, qy, qz, qw), Shepperd-style:
    branch on the largest of (trace, r00, r11, r22) so the division is
    always by a well-conditioned component (the trace-only formula breaks
    near 180-degree rotations)."""
    tr = r[0, 0] + r[1, 1] + r[2, 2]
    if tr > max(r[0, 0], r[1, 1], r[2, 2]):
        s = np.sqrt(1.0 + tr) * 2.0  # = 4*qw
        qw = 0.25 * s
        qx = (r[2, 1] - r[1, 2]) / s
        qy = (r[0, 2] - r[2, 0]) / s
        qz = (r[1, 0] - r[0, 1]) / s
    elif r[0, 0] >= r[1, 1] and r[0, 0] >= r[2, 2]:
        s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2.0  # = 4*qx
        qw = (r[2, 1] - r[1, 2]) / s
        qx = 0.25 * s
        qy = (r[0, 1] + r[1, 0]) / s
        qz = (r[0, 2] + r[2, 0]) / s
    elif r[1, 1] >= r[2, 2]:
        s = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2.0  # = 4*qy
        qw = (r[0, 2] - r[2, 0]) / s
        qx = (r[0, 1] + r[1, 0]) / s
        qy = 0.25 * s
        qz = (r[1, 2] + r[2, 1]) / s
    else:
        s = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2.0  # = 4*qz
        qw = (r[1, 0] - r[0, 1]) / s
        qx = (r[0, 2] + r[2, 0]) / s
        qy = (r[1, 2] + r[2, 1]) / s
        qz = 0.25 * s
    q = np.array([qx, qy, qz, qw], dtype=np.float64)
    return q / np.linalg.norm(q)


def save_trajectory_tum(path: str, timestamps, cameras) -> None:
    """Write a camera trajectory in TUM format (timestamp tx ty tz qx qy qz
    qw), the format the ATE tooling and standard evaluators consume."""
    import torch

    from ..interop import to_numpy
    from ..slam.camera import rodrigues
    from ..slam.trajectory import camera_centers

    cams = to_numpy(cameras)
    centers = camera_centers(cams)
    rots = rodrigues(torch.from_numpy(cams[:, :3].astype(np.float32))).numpy()
    with open(path, "w") as f:
        for ts, r, c in zip(timestamps, rots, centers):
            qx, qy, qz, qw = rotation_to_quaternion(r.T)  # cam->world
            f.write(
                f"{ts:.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} "
                f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}\n"
            )
