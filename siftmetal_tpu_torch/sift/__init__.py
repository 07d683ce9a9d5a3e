"""SIFT stages of the port: pyramid, detection, description, facade."""

from .extract import SIFT, Descriptors, extract, extract_gray
from .detect import Keypoints, gather_keypoints
from .detect import detect as detect_keypoints
from .pyramid import build_pyramid

# Re-import submodules LAST so the attributes `detect`/`describe`/... refer
# to the modules, not same-named functions (import a.b.c resolves through
# package attributes).
from . import describe, detect, extract as _extract_mod, pyramid  # noqa: F401,E402

__all__ = [
    "SIFT", "Descriptors", "Keypoints", "extract", "extract_gray",
    "detect_keypoints", "gather_keypoints", "build_pyramid",
]
