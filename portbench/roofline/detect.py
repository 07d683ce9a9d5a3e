"""Bytes and operations of one call's detection launch: every octave's
DoG stack read once, the candidate slots written once (column 4 bytes,
two flags, four Taylor fields, per slot); about 56 operations a sample of
the interior (26 comparisons each way and the tests) and 100 a soft
extremum (the Taylor step and the edge test)."""

from __future__ import annotations

from typing import Tuple

from ..reference.sift import Params

PATTERNS = (r"\bdetect_kernel<",)
SLOTS = 6
SLOT_BYTES = 4 + 2 + 16


def work(p: Params, h: int, w: int, batch: int, n_octaves: int, n_soft: float) -> Tuple[float, float]:
    """(bytes, operations) of one [batch, h, w] call with ``n_soft`` soft
    extrema over the batch (the call's ``n_soft`` counters summed)."""
    dogs = p.n_scales_per_octave + 2
    nbytes = nops = 0.0
    for oh, ow in p.octave_shapes(h, w, n_octaves):
        nbytes += 4.0 * batch * dogs * oh * ow
        nbytes += SLOT_BYTES * batch * (dogs - 2) * (oh - 2) * SLOTS
        nops += 56.0 * batch * (dogs - 2) * (oh - 2) * (ow - 2)
    return nbytes, nops + 100.0 * n_soft
