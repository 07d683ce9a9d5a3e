"""How far a frame's extraction lies from the reference's.

Answers are matched as sets, so the padded order of the outputs does not
matter: a descriptor of one side is *found* on the other when a valid row
there has the same octave, position within ``POS_TOL`` px, blur within
``SIGMA_TOL`` (relative), orientation within ``THETA_TOL`` rad and every
feature within ``FEAT_TOL`` levels; a keypoint when its octave, position
and blur do. The readings are shares of rows not found, over both sides,
in percent, the count gap, and the gap of each counter the reference
reports. Plain numpy; imports nothing of the measured program.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

POS_TOL = 0.01
SIGMA_TOL = 1e-3
THETA_TOL = 0.01
FEAT_TOL = 2

DESC_FIELDS = ("valid", "octave", "x", "y", "sigma", "theta", "features")
KP_FIELDS = ("valid", "octave", "x", "y", "sigma")


def _rows(d: Dict, fields) -> Dict[str, np.ndarray]:
    v = np.asarray(d["valid"]).astype(bool)
    return {f: np.asarray(d[f])[v] for f in fields if f != "valid"}


def _found(a: Dict, b: Dict, with_desc: bool, block: int = 1024) -> np.ndarray:
    """For each row of ``a``: whether ``b`` has a row that matches it."""
    n = len(a["x"])
    out = np.zeros(n, bool)
    if n == 0 or len(b["x"]) == 0:
        return out
    for s in range(0, n, block):
        e = min(n, s + block)
        m = a["octave"][s:e, None] == b["octave"][None, :]
        m &= np.abs(a["x"][s:e, None] - b["x"][None, :]) <= POS_TOL
        m &= np.abs(a["y"][s:e, None] - b["y"][None, :]) <= POS_TOL
        m &= np.abs(a["sigma"][s:e, None] - b["sigma"][None, :]) <= SIGMA_TOL * np.abs(a["sigma"][s:e, None])
        if with_desc:
            dt = np.abs(a["theta"][s:e, None] - b["theta"][None, :])
            m &= np.minimum(dt, 2 * np.pi - dt) <= THETA_TOL
            ii, jj = np.nonzero(m)
            gap = np.abs(a["features"][s:e][ii].astype(np.int16)
                         - b["features"][jj].astype(np.int16)).max(axis=1)
            ok = np.zeros(m.shape, bool)
            ok[ii, jj] = gap <= FEAT_TOL
            m = ok
        out[s:e] = m.any(axis=1)
    return out


def counter_gap(prog: Dict, ref: Dict) -> float:
    """Largest gap of one counter of a frame, % of the reference's count
    (of 1 where that is 0); a counter the program lacks is a gap of 100%."""
    worst = 0.0
    for name, r in ref.items():
        if name not in prog:
            return 100.0
        r = np.asarray(r, np.int64).ravel()
        g = np.abs(np.asarray(prog[name], np.int64).ravel() - r)
        worst = max(worst, float((100.0 * g / np.maximum(np.abs(r), 1)).max(initial=0.0)))
    return worst


def frame_readings(prog_kp: Dict, prog_desc: Dict, ref_kp: Dict, ref_desc: Dict,
                   prog_counters: Dict, ref_counters: Dict) -> Dict[str, float]:
    """Counts of one frame: rows of each side not found on the other, and
    the gap of its counters."""
    pk, rk = _rows(prog_kp, KP_FIELDS), _rows(ref_kp, KP_FIELDS)
    pd, rd = _rows(prog_desc, DESC_FIELDS), _rows(ref_desc, DESC_FIELDS)
    return {
        "counter_gap": counter_gap(prog_counters, ref_counters),
        "kp_missing": float((~_found(pk, rk, False)).sum() + (~_found(rk, pk, False)).sum()),
        "kp_total": float(len(pk["x"]) + len(rk["x"])),
        "desc_missing": float((~_found(pd, rd, True)).sum() + (~_found(rd, pd, True)).sum()),
        "desc_total": float(len(pd["x"]) + len(rd["x"])),
        "count_gap": float(abs(len(pd["x"]) - len(rd["x"]))),
        "count_ref": float(len(rd["x"])),
    }


def summarize(frames) -> Dict[str, float]:
    """The numbers compared, over the sampled frames: keypoints and
    descriptors not found (% of both sides' rows), the largest count gap
    of one frame (% of the reference's count) and the largest gap of one
    counter of one frame (% of the reference's)."""
    tot = lambda k: sum(f[k] for f in frames)
    return {
        "kp_missing_pct": 100.0 * tot("kp_missing") / max(tot("kp_total"), 1.0),
        "desc_missing_pct": 100.0 * tot("desc_missing") / max(tot("desc_total"), 1.0),
        "count_gap_pct": max(100.0 * f["count_gap"] / max(f["count_ref"], 1.0) for f in frames),
        "counter_gap_pct": max(f["counter_gap"] for f in frames),
    }
