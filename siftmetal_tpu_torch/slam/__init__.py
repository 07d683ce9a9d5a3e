"""SfM/SLAM back-end of the port: what is ported so far (camera math, PnP,
trajectory evaluation)."""

from .camera import compose, inverse, project, relative, rodrigues, so3_log, transform
from .pnp import pnp_dlt, pnp_ransac, pnp_ransac_from_indices, pnp_refine
from .trajectory import (
    associate,
    ate_rmse,
    camera_centers,
    load_tum_trajectory,
    umeyama,
)

__all__ = [
    "compose", "inverse", "project", "relative", "rodrigues", "so3_log",
    "transform",
    "pnp_dlt", "pnp_ransac", "pnp_ransac_from_indices", "pnp_refine",
    "associate", "ate_rmse", "camera_centers", "load_tum_trajectory",
    "umeyama",
]
