"""Traffic of kind ``pairs``: verified pairs through the port's matcher
and RANSAC.

HPatches' protocol on procedural frames: each of ``references`` frames
is paired with each of its ``views`` (homographies of the traffic file,
made by a plain warp), and as many pairs of a reference with a view of
another reference stand for a retrieval shortlist's rejects. The
descriptors of every frame are made in set-up by the plain reference
extractor, so both sides get the same inputs and neither is the
program's. A closed loop over the pairs: ``match_bruteforce``, the
matched positions gathered, ``find_homography`` with a generator seeded
for the call, the host reads ``n_inliers`` and decides. Then a sample of
calls drawn from the seed is verified again by the plain reference with
the same samples and compared: the matches, the decision, and the
homography where both sides accept.

The generator's three functions (``spec.GENERATOR_FUNCTIONS``):
:func:`run_cell` one run; :func:`cell_loop` the window loop for the
program slice; :func:`calibration_run` one run of the program, of the
precision control (the plain reference with TF32 on, in the program's
place) or of the planted fault (the port with every decision a
rejection, its inlier count read as 0, the matches and models untouched).
"""

from __future__ import annotations

import random
import time
from typing import Dict, List

import torch

from ..reference import sift as ref_sift
from ..reference import verify as ref_verify
from .common import tf32
from .extract import REFERENCE_CHUNK
from .frames import procedural_frames
from .program import Loop
from .trace import Profiled, Trace
from .warp import views, warp

GOLDEN = 0x9E3779B97F4A7C15


def call_seed(seed: int, call: int) -> int:
    """The RANSAC generator's seed of one call."""
    return (int(seed) * 1_000_003 + (call + 1) * GOLDEN) % (2 ** 63)


class PairInputs:
    """Descriptor sets of every frame of the mix, made on the device."""

    def __init__(self, cell, seed: int, device, chunk: int):
        t, c = cell.traffic, cell.config
        h, w = int(c["height"]), int(c["width"])
        n_ref = int(t["references"])
        refs = procedural_frames(n_ref, h, w, seed, device)
        homs = views(t["views"], (h, w))
        frames = [refs] + [warp(refs, hom) for _, hom in homs]
        allf = torch.stack(frames, 1).reshape(-1, h, w)       # frame r * (1 + V) + v
        p = ref_sift.Params.from_dict(c["sift"])
        n_oct = p.num_octaves(h, w)
        feats, xy, valid = [], [], []
        block = int(t.get("extract_block", 8))
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for s in range(0, allf.shape[0], block):
                _, d, _ = ref_sift.extract(allf[s:s + block], p, n_oct, chunk)
                feats.append(d["features"])
                xy.append(torch.stack([d["x"], d["y"]], -1))
                valid.append(d["valid"])
        finally:
            torch.use_deterministic_algorithms(False)
        self.features = torch.cat(feats)
        self.xy = torch.cat(xy).contiguous()
        self.valid = torch.cat(valid)
        n_v = len(homs)
        rng = random.Random(seed)
        pairs = []
        for r in range(n_ref):
            for v in range(n_v):
                pairs.append((r * (1 + n_v), r * (1 + n_v) + 1 + v, True))
                other = rng.choice([q for q in range(n_ref) if q != r])
                pairs.append((r * (1 + n_v), other * (1 + n_v) + 1 + rng.randrange(n_v), False))
        rng.shuffle(pairs)
        self.pairs = pairs
        self.shape = (h, w)


class PortVerifier:
    """The timed path: the port's matcher and RANSAC."""

    def __init__(self, traffic: Dict):
        from siftmetal_tpu_torch.geometry import find_homography
        from siftmetal_tpu_torch.match import match_bruteforce

        self.match, self.find = match_bruteforce, find_homography
        self.thr = (float(traffic["absolute_threshold"]), float(traffic["ratio_threshold"]))
        self.hyp, self.inl = int(traffic["hypotheses"]), float(traffic["inlier_threshold"])

    def __call__(self, qf, tf, qv, tv, qxy, txy, gen, events=None):
        m = self.match(qf, tf, qv, tv, *self.thr)
        if events is not None:
            events[1].record()
        dst = txy.index_select(0, m.target_idx.clamp(min=0).long())
        r = self.find(gen, qxy, dst, m.valid, self.hyp, self.inl)
        return m.target_idx, r.model, r.n_inliers


class ReferenceVerifier:
    """The plain reference, with TF32 off; ``tf32=True`` is the precision
    control, the reference with TF32 on put in the program's place."""

    def __init__(self, traffic: Dict, control: bool = False):
        self.thr = (float(traffic["absolute_threshold"]), float(traffic["ratio_threshold"]))
        self.hyp, self.inl = int(traffic["hypotheses"]), float(traffic["inlier_threshold"])
        self.control = control

    def __call__(self, qf, tf, qv, tv, qxy, txy, gen, events=None):
        with tf32(self.control):
            v = ref_verify.verify(qf, tf, qv, tv, qxy, txy, gen, self.thr, self.hyp, self.inl)
        return v.target_idx, v.model, torch.tensor(v.n_inliers)


class RejectingVerifier(PortVerifier):
    """The planted fault: the port's verifier with every decision a
    rejection."""

    def __call__(self, *args, **kwargs):
        tgt, model, n_in = super().__call__(*args, **kwargs)
        return tgt, model, torch.zeros_like(n_in)


class PairsRun:
    """Set-up, window and check of one pair cell."""

    def __init__(self, cell, seed: int, device, chunk: int, verifier=None):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.t_start = time.perf_counter()
        self.inputs = PairInputs(cell, seed, self.device, chunk)
        self.t_inputs = time.perf_counter()
        if self.cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        self.verifier = verifier or PortVerifier(cell.traffic)
        self.accept_min = int(cell.traffic["accept_min_inliers"])
        self.gen = torch.Generator(device=self.device)
        self.results: List = []
        self.window_calls = 0
        # Warm the shapes: one positive and one negative pair.
        for k in range(2):
            self._call(k, keep=False)
        if self.cuda:
            torch.cuda.synchronize()

    def _call(self, n: int, keep: bool = True, events=None) -> bool:
        a, b, _ = self.inputs.pairs[n % len(self.inputs.pairs)]
        i = self.inputs
        self.gen.manual_seed(call_seed(self.seed, n))
        if events is not None:
            events[0].record()
        tgt, model, n_in = self.verifier(i.features[a], i.features[b], i.valid[a], i.valid[b],
                                         i.xy[a], i.xy[b], self.gen, events)
        if events is not None:
            events[2].record()
        accepted = int(n_in) >= self.accept_min
        if keep:
            self.results.append((tgt, model, int(n_in), accepted))
        return accepted

    def window(self, seconds: float, traced_calls: int = 0):
        """The closed loop for ``seconds``; returns (window calls, window
        s, trace or None). A traced run records CUDA events around the
        matcher and the geometry of every window call (the spans), then,
        once the window has closed, profiles ``traced_calls`` calls with
        the device alone and as many with the host's ranges, so that no
        profiler session has run in the process before the spans."""
        traced = bool(traced_calls) and self.cuda
        events = []
        t0 = self.t_window = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if traced else None
            self._call(len(self.results), events=ev)
            events.append(ev)
        window_s = time.perf_counter() - t0
        self.window_calls = len(self.results)
        if not traced_calls:
            return self.window_calls, window_s, None

        def run_slice(host: bool) -> Profiled:
            with Profiled(host) as profiled:
                for _ in range(traced_calls):
                    self._call(len(self.results))
            return profiled

        device_slice, named_slice = run_slice(host=False), run_slice(host=True)
        spans = {"match.ms": [e[0].elapsed_time(e[1]) for e in filter(None, events)],
                 "geometry.ms": [e[1].elapsed_time(e[2]) for e in filter(None, events)]}
        trace = Trace(device_slice.ops()[0], device_slice.window_s, traced_calls, traced_calls, spans,
                      {"config": self.cell.config, "traffic": self.cell.traffic}, named=named_slice.ops())
        return self.window_calls, window_s, trace

    def check(self, n_check: int) -> Dict[str, float]:
        """A seeded sample of the window's calls, verified again by the
        plain reference with the same samples."""
        rng = random.Random(self.seed)
        picks = sorted(rng.sample(range(self.window_calls), min(n_check, self.window_calls)))
        ref = ReferenceVerifier(self.cell.traffic)
        i = self.inputs
        h, w = i.shape
        rows = corner = decisions = 0.0
        for n in picks:
            a, b, _ = i.pairs[n % len(i.pairs)]
            self.gen.manual_seed(call_seed(self.seed, n))
            tgt, model, n_ref = ref(i.features[a], i.features[b], i.valid[a], i.valid[b],
                                    i.xy[a], i.xy[b], self.gen)
            p_tgt, p_model, _, p_ok = self.results[n]
            rows += float((p_tgt.long() != tgt.long()).sum())
            ref_ok = int(n_ref) >= self.accept_min
            decisions += float(p_ok != ref_ok)
            if p_ok and ref_ok:
                corner = max(corner, ref_verify.corner_gap(p_model, model, h, w))
        return {"match_rows_differ": rows, "decision_differs": decisions, "corner_gap_px": corner}


def run_cell(cell, seed: int, seconds: float, traced_calls: int, device, verifier=None) -> Dict:
    """One run of a pair cell: set-up, window, memory, then the check."""
    t = cell.traffic
    run = PairsRun(cell, seed, device, REFERENCE_CHUNK, verifier)
    n_window, window_s, trace = run.window(seconds, traced_calls)
    if trace is not None:
        trace.context.update(device_name=torch.cuda.get_device_name(0) if run.cuda else "cpu")
    memory = torch.cuda.max_memory_allocated() if run.cuda else 0
    t_check = time.perf_counter()
    readings = run.check(int(t["check_pairs"]))
    return {"t_window": run.t_window, "t_start": run.t_start, "t_inputs": run.t_inputs,
            "window_s": window_s, "check_s": time.perf_counter() - t_check,
            "attempted": n_window, "failed": 0, "memory": memory,
            "trace": trace, "readings": readings,
            "measured": {"pairs_per_s": n_window / window_s}}


def cell_loop(cell, seed: int, device) -> Loop:
    """The run's closed loop from a set-up of its own, no result kept: a
    warm-up call, the window."""
    pr = PairsRun(cell, seed, device, REFERENCE_CHUNK)

    def window(seconds: float):
        pr.results.clear()
        calls, wall_s, _ = pr.window(seconds)
        return calls, calls, wall_s

    return Loop(lambda: pr._call(0, keep=False), window, lambda: None)


def calibration_run(cell, seed: int, seconds: float, side: str, device) -> Dict:
    """One untraced run of ``side``: "program", "control" (the reference
    with TF32 on in the program's place) or "fault" (every decision a
    rejection)."""
    verifier = (ReferenceVerifier(cell.traffic, control=True) if side == "control"
                else RejectingVerifier(cell.traffic) if side == "fault" else None)
    return run_cell(cell, seed, seconds, 0, device, verifier)
