"""Bytes and operations of one call's pyramid kernels (the fused seed,
the one-shot octaves, the small-octave cascades), from the configuration
and the batch alone. Each input read once and each output written once,
4 bytes a sample; 2 operations a tap of both 1-D passes of every blurred
slice, one a DoG sample."""

from __future__ import annotations

import math
from typing import Tuple

from ..reference.sift import Params, oneshot_rhos, oneshot_route, seed_sigmas

# Device functions of the group, as patterns of the demangled name.
PATTERNS = (r"\bband_tiles_kernel<", r"\bblur_cascade_kernel<", r"\bstream_kernel<")


def _taps(sigmas) -> int:
    return sum(2 * math.ceil(4.0 * float(s)) + 1 for s in sigmas)


def work(p: Params, h: int, w: int, batch: int, n_octaves: int) -> Tuple[float, float]:
    """(bytes, operations) of the pyramid of one [batch, h, w] call on the
    route ``reference.sift.pyramid`` takes (the 2x seed)."""
    shapes = p.octave_shapes(h, w, n_octaves)
    s = p.n_scales_per_octave + 3
    nbytes = nops = 0.0
    for o, (oh, ow) in enumerate(shapes):
        plane = batch * oh * ow
        if o == 0:
            src, sig = batch * h * w, seed_sigmas(p)
        elif oneshot_route(p, oh):
            src, sig = plane, oneshot_rhos(p)
        else:
            src, sig = plane, p.incremental_sigmas(o)
        nbytes += 4.0 * (src + s * plane + (s - 1) * plane)
        nops += 4.0 * plane * _taps(sig) + (s - 1) * plane
    return nbytes, nops
