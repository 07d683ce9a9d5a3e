from .matcher import (
    Matches,
    geometry_score,
    match_bruteforce,
    match_guided,
    pairwise_sq_dists,
    pairwise_sq_dists_u8,
    raw_features,
)

__all__ = [
    "Matches", "geometry_score", "match_bruteforce", "match_guided",
    "pairwise_sq_dists", "pairwise_sq_dists_u8", "raw_features",
]
