"""Bytes and operations of one LM iteration of a bundle adjustment with
the Schur complement, whatever implements it, from the problem's
cameras C, points, observations O and same-landmark observation pairs
(each unordered pair of one point's observations once, an observation
with itself too: sum_l d_l (d_l + 1) / 2), for cameras of P numbers:

* operations: a pair's block of the cross term, W_a Hll^-1 W_b^T, 2 * P *
  P * 3; the Cholesky factorisation of the reduced system, (P C)^3 / 3;
  ``obs_ops(P)`` an observation (below); ``POINT_OPS`` a point (its 3 x
  3 block inverted, 45, and applied twice, to b_l and in the
  back-substitution, 18 each);
* bytes: each observation read once (camera and point index, 4 bytes
  each, and its pixel in float32, 8), and the reduced system, [P C, P C]
  in float64, written once and read once.

An observation's operations: its residual and Jacobian, about 40 a
parameter of the camera and the point (forward mode), and the products of
the normal equations in float64: J_c^T J_c (4 P^2), J_c^T r (4 P), J_l^T
J_l and J_l^T r (48), W = J_c^T J_l (12 P), W Hll^-1 (18 P), W y and the
back-substitution's W^T dc (6 P each)."""

from __future__ import annotations

from typing import Tuple

CAMERA_WIDTH = {"bal9": 9}
OBS_BYTES = 4 + 4 + 8
POINT_OPS = 45.0 + 18.0 + 18.0


def obs_ops(p: int) -> float:
    return 40.0 * (p + 3) + 4.0 * p * p + 4.0 * p + 48.0 + 12.0 * p + 18.0 * p + 12.0 * p


def work(cameras: int, points: int, observations: int, pairs: float, p: int) -> Tuple[float, float]:
    """(bytes, operations) of one iteration."""
    n = p * cameras
    nops = 6.0 * p * p * pairs + n ** 3 / 3.0 + obs_ops(p) * observations + POINT_OPS * points
    nbytes = OBS_BYTES * observations + 2.0 * 8.0 * n * n
    return nbytes, nops
