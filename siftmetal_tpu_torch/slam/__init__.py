"""SfM/SLAM back-end of the port: camera math, PnP, trajectory evaluation,
bundle adjustment, pose graph and the incremental ``SfmMap``."""

from .ba import BAProblem, BAStats, bundle_adjust
from .camera import compose, inverse, project, project_bal, relative, rodrigues, so3_log, transform
from .pnp import pnp_dlt, pnp_ransac, pnp_ransac_from_indices, pnp_refine
from .pose_graph import PoseGraph, optimize_pose_graph
from .sfm import SfmConfig, SfmMap, replayed_bundle_adjust
from .trajectory import (
    associate,
    ate_rmse,
    camera_centers,
    load_tum_trajectory,
    umeyama,
)

__all__ = [
    "BAProblem", "BAStats", "bundle_adjust",
    "compose", "inverse", "project", "project_bal", "relative", "rodrigues",
    "so3_log", "transform",
    "pnp_dlt", "pnp_ransac", "pnp_ransac_from_indices", "pnp_refine",
    "PoseGraph", "optimize_pose_graph", "SfmConfig", "SfmMap",
    "replayed_bundle_adjust",
    "associate", "ate_rmse", "camera_centers", "load_tum_trajectory",
    "umeyama",
]
