from .ransac import (
    RansacResult,
    find_fundamental,
    find_homography,
    ransac,
    ransac_from_indices,
)
from .twoview import (
    decompose_essential,
    essential_from_fundamental,
    fundamental_from_points,
    homography_from_points,
    homography_transfer_error,
    recover_pose,
    sampson_error,
    triangulate,
)

__all__ = [
    "RansacResult", "find_fundamental", "find_homography", "ransac",
    "ransac_from_indices",
    "decompose_essential", "essential_from_fundamental",
    "fundamental_from_points", "homography_from_points",
    "homography_transfer_error", "recover_pose", "sampson_error",
    "triangulate",
]
