"""Standard-benchmark dataset layouts: TUM RGB-D and HPatches.

Port of ``siftmetal_tpu/utils/datasets.py``. The parsers consume the
datasets' standard on-disk layouts:

  * TUM RGB-D sequence dir: ``rgb.txt`` ("timestamp filename" per line,
    '#' comments), the referenced ``rgb/*.png`` frames, and
    ``groundtruth.txt`` ("timestamp tx ty tz qx qy qz qw").
    https://cvg.cit.tum.de/data/datasets/rgbd-dataset/file_formats
  * HPatches full-sequences dir: ``<seq>/{1..6}.ppm`` + ``H_1_2 ..
    H_1_6`` (3x3 row-major text homographies in (x=col, y=row) pixel
    convention; sequences prefixed ``i_`` vary illumination, ``v_``
    viewpoint). https://github.com/hpatches/hpatches-dataset

Consumed by scripts/run_tum_torch.py and scripts/run_hpatches_torch.py;
the tests run them on tiny committed samples
(tests/fixtures/{tum,hpatches}_mini).
"""

from __future__ import annotations

import pathlib
from typing import List, Sequence, Tuple

import numpy as np

# (x=col, y=row) <-> (row, col) conversion for homographies: the port's
# warp/repeatability convention is (row, col) (ops/warp.py).
_SWAP = np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])


def tum_frames(seq_dir: str | pathlib.Path) -> Tuple[np.ndarray, List[str]]:
    """Parse ``rgb.txt``: returns (timestamps [N] f64, absolute paths).
    Lines are "timestamp filename"; '#' lines are comments."""
    seq = pathlib.Path(seq_dir)
    ts, paths = [], []
    with open(seq / "rgb.txt") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t, rel = line.split()[:2]
            ts.append(float(t))
            paths.append(str(seq / rel))
    return np.asarray(ts, dtype=np.float64), paths


def tum_groundtruth(seq_dir: str | pathlib.Path) -> Tuple[np.ndarray, np.ndarray]:
    """Parse ``groundtruth.txt`` -> (timestamps [N], positions [N, 3])."""
    from ..slam.trajectory import load_tum_trajectory

    return load_tum_trajectory(str(pathlib.Path(seq_dir) / "groundtruth.txt"))


def load_gray(path: str) -> np.ndarray:
    """Load an image file (PNG, PGM/PPM) as float32 grayscale [H, W] in
    [0, 1] with the pipeline's BT.709 gamma-space conversion."""
    from .frame_loader import rgb_to_gray
    from .io import load_image

    img = load_image(path)
    if img.ndim == 2:
        return img.astype(np.float32)
    # rgb_to_gray consumes uint8 (the native loader's contract); the
    # files are 8-bit sources, so the round-trip is lossless.
    return rgb_to_gray((img[..., :3] * 255.0 + 0.5).astype(np.uint8))


def hpatches_sequences(root: str | pathlib.Path) -> List[pathlib.Path]:
    """Sequence dirs under an HPatches release root (``1.ppm`` present),
    sorted by name. Accepts a single sequence dir too."""
    root = pathlib.Path(root)
    if (root / "1.ppm").exists() or (root / "1.png").exists():
        return [root]
    return sorted(
        d for d in root.iterdir()
        if d.is_dir() and ((d / "1.ppm").exists() or (d / "1.png").exists())
    )


def hpatches_image_path(seq: pathlib.Path, idx: int) -> pathlib.Path:
    for ext in (".ppm", ".png"):
        p = seq / f"{idx}{ext}"
        if p.exists():
            return p
    raise FileNotFoundError(f"{seq}/{idx}.(ppm|png)")


def load_homography_rowcol(path: str | pathlib.Path) -> np.ndarray:
    """Read an HPatches ``H_1_k`` file (3x3 row-major floats, (x, y) =
    (col, row) convention) and convert it to the port's (row, col)
    convention: H_rc = S @ H_xy @ S with S the axis swap."""
    vals = np.loadtxt(str(path), dtype=np.float64).reshape(3, 3)
    return (_SWAP @ vals @ _SWAP).astype(np.float32)


def associate_ate(
    est_ts: Sequence[float],
    est_cams: np.ndarray,
    gt_ts: np.ndarray,
    gt_pos: np.ndarray,
    max_dt: float = 0.02,
) -> Tuple[float, int]:
    """Associate estimated keyframe timestamps with ground truth and
    return (ATE RMSE after similarity alignment, #associated)."""
    from ..slam.trajectory import associate, ate_rmse, camera_centers

    est_ts = np.asarray(est_ts, dtype=np.float64)
    ia, ib = associate(est_ts, gt_ts, max_dt=max_dt)
    if len(ia) < 3:
        return float("nan"), int(len(ia))
    est = camera_centers(np.asarray(est_cams)[ia])
    return ate_rmse(est, gt_pos[ib]), int(len(ia))
