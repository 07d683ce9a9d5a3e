"""Traffic of kind ``extract``: frames through the port's ``SIFT`` facade.

A closed loop: ``batch`` frames a call, at most ``in_flight`` calls
queued, the frames cycling through a pool of ``pool`` procedural frames
made from the seed on the card (``host_input``: the pool kept in pinned
host memory, each call handed a host frame). A call counts when its
keypoints, descriptors and counters are in host memory. Then a sample of
frames drawn from the seed, each position of the batch among them, is
extracted again by the plain reference and compared: the outputs as
sets, the counters one by one.

The generator's three functions (``spec.GENERATOR_FUNCTIONS``):
:func:`run_cell` one run; :func:`cell_loop` the window loop for the
program slice; :func:`calibration_run` one run of the program or of the
precision control, the port's own bf16 blur chain (``CONTROL_OVERRIDE``)
held against the fp32 reference. This kind has no planted fault: its
faults are planted under the program by
``portbench/tests/test_portbench_faults.py``.
"""

from __future__ import annotations

import random
import time
from collections import deque
from typing import Dict, List, Optional

import torch

from ..reference import compare
from ..reference import sift as ref_sift
from .common import percentile, tf32
from .frames import procedural_frames
from .program import Loop
from .trace import Profiled, Trace

KP_OUT = ("valid", "octave", "x", "y", "sigma")
# The reference's lanes a chunk and frames a block: what fits the card
# beside nothing else at 480x640 (a few GB).
REFERENCE_CHUNK = 1024
REFERENCE_BLOCK = 4
DESC_OUT = ("valid", "octave", "x", "y", "sigma", "theta", "features")
# The precision control: the nearest precision below the configuration's
# float32 blur chain, in the program's place.
CONTROL_OVERRIDE = {"pyramid_dtype": "bfloat16"}


def sift_config(cell_config: Dict, override: Optional[Dict] = None):
    from siftmetal_tpu_torch import config_from_dict

    return config_from_dict({**cell_config["sift"], **(override or {})})


class _Slot:
    """Pinned host buffers of one call's outputs and the event that says
    they are filled."""

    def __init__(self, kps, descs, counters, pin: bool):
        like = lambda t: torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
        self.kp = {f: like(getattr(kps, f)) for f in KP_OUT}
        self.desc = {f: like(getattr(descs, f)) for f in DESC_OUT}
        self.counters = {k: like(v) for k, v in counters.items()}
        self.event = None
        self.frames: List[int] = []
        self.t_submit = 0.0

    def fill(self, kps, descs, counters, nb: bool):
        for f in KP_OUT:
            self.kp[f].copy_(getattr(kps, f), non_blocking=nb)
        for f in DESC_OUT:
            self.desc[f].copy_(getattr(descs, f), non_blocking=nb)
        for k, v in counters.items():
            self.counters[k].copy_(v, non_blocking=nb)

    def frame(self, i: int, features: bool = True) -> Dict:
        """Copies of frame ``i``'s outputs (without the descriptors'
        features where ``features`` is false)."""
        pick = lambda d: {k: v[i].numpy().copy() for k, v in d.items() if features or k != "features"}
        return {"kp": pick(self.kp), "desc": pick(self.desc), "counters": pick(self.counters)}


def sample_frames(rng: random.Random, pool: int, batch: int, n: int) -> List[int]:
    """``n`` frames of the pool drawn from ``rng``, each position of the
    batch among them: frame ``f`` sits at position ``f % batch`` of every
    call that takes it, so a fault in one position cannot miss the
    sample."""
    if n < batch:
        raise ValueError(f"{n} sampled frames cannot cover the {batch} positions of a batch")
    per_position = [rng.randrange(pool // batch) * batch + s for s in range(batch)]
    rest = rng.sample(sorted(set(range(pool)) - set(per_position)), n - batch)
    return sorted(per_position + rest)


class ExtractRun:
    """Set-up, window and check of one extraction cell."""

    def __init__(self, cell, seed: int, device, config_override: Optional[Dict] = None):
        from siftmetal_tpu_torch import SIFT

        t = cell.traffic
        c = cell.config
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.batch, self.in_flight, self.pool_n = int(t["batch"]), int(t["in_flight"]), int(t["pool"])
        if self.pool_n % self.batch:
            raise ValueError(f"a pool of {self.pool_n} frames does not split into batches of {self.batch}")
        self.h, self.w = int(c["height"]), int(c["width"])
        self.sift = SIFT(self.h, self.w, config=sift_config(c, config_override), device=self.device)
        self.cuda = self.device.type == "cuda"
        self.t_start = time.perf_counter()
        self.pool = procedural_frames(self.pool_n, self.h, self.w, seed, self.device)
        self.host_input = bool(t.get("host_input", False))
        if self.host_input:
            self.host_pool = self.pool.cpu().pin_memory() if self.cuda else self.pool.cpu()
        self._sync()
        self.t_inputs = time.perf_counter()
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
        self.sampled = sample_frames(random.Random(seed), self.pool_n, self.batch,
                                     int(t["check_frames"]))
        self.kept: Dict[int, Dict] = {}
        self.slice_outputs: Optional[Dict[int, Dict]] = None
        self.next_frame = 0
        # Warm every shape of the window: the batch's capture, one call in
        # each slot, the copies to pinned memory.
        self.slots = []
        for _ in range(self.in_flight):
            out = self._call(self._frames(0))
            self.slots.append(_Slot(*out, pin=self.cuda))
            self.slots[-1].fill(*out, nb=False)
        self._sync()

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def _frames(self, start: int):
        """The call's frames: a slice of the pool (``pool`` is a multiple
        of ``batch``), on the card or in pinned host memory."""
        src = self.host_pool if self.host_input else self.pool
        return src[start:start + self.batch]

    def _call(self, frames):
        return self.sift.extract_batch(frames)

    def _keep(self, slot: _Slot):
        """Copies of the sampled frames' results, for the check; in the
        named slice also every frame's outputs but the features, for the
        readers."""
        for k, f in enumerate(slot.frames):
            if f in self.sampled:
                self.kept[f] = slot.frame(k)
            if self.slice_outputs is not None and f not in self.slice_outputs:
                self.slice_outputs[f] = slot.frame(k, features=False)

    def window(self, seconds: float, traced_calls: int = 0):
        """The closed loop for ``seconds``, and until every sampled frame
        has been extracted once; with ``traced_calls``, that many calls
        under the profiler of the device alone just before it, then the
        same frames again under the host's profiler too. Returns (calls,
        frames done, per-call latency s, window s, trace or None)."""
        pending: deque = deque()
        free = deque(self.slots)
        latencies: List[float] = []
        calls = frames = 0

        def retire():
            nonlocal frames
            slot = pending.popleft()
            if slot.event is not None:
                slot.event.synchronize()
            latencies.append(time.perf_counter() - slot.t_submit)
            self._keep(slot)
            frames += len(slot.frames)
            free.append(slot)

        def submit():
            nonlocal calls
            if len(pending) == self.in_flight:
                retire()
            slot = free.popleft()
            slot.t_submit = time.perf_counter()
            start = self.next_frame
            slot.frames = [(start + k) % self.pool_n for k in range(self.batch)]
            self.next_frame = (start + self.batch) % self.pool_n
            out = self._call(self._frames(start))
            slot.fill(*out, nb=self.cuda)
            if self.cuda:
                slot.event = torch.cuda.Event()
                slot.event.record()
            pending.append(slot)
            calls += 1

        def run_slice(host: bool) -> Profiled:
            with Profiled(host) as profiled:
                for _ in range(traced_calls):
                    submit()
                while pending:
                    retire()
            return profiled

        if traced_calls:
            # The traced slices first, then the window: the profiler is
            # stopped before the window starts and read after it closes.
            start = self.next_frame
            slice_frames = [(start + k) % self.pool_n for k in range(traced_calls * self.batch)]
            device_slice = run_slice(host=False)
            self.next_frame, self.slice_outputs = start, {}
            named_slice = run_slice(host=True)
            outputs, self.slice_outputs = self.slice_outputs, None
        t0 = self.t_window = time.perf_counter()
        calls = frames = 0
        latencies.clear()
        self.kept.clear()
        while time.perf_counter() - t0 < seconds or len(self.kept) < len(self.sampled):
            submit()
        while pending:
            retire()
        window_s = time.perf_counter() - t0
        trace = None
        if traced_calls:
            device_ops, _ = device_slice.ops()
            context = dict(slice_frames=slice_frames, frame_outputs=outputs, config=self.cell.config,
                           batch=self.batch, n_octaves=self.sift.n_octaves, device=self.device,
                           device_name=torch.cuda.get_device_name(0) if self.cuda else "cpu")
            trace = Trace(device_ops, device_slice.window_s, traced_calls, traced_calls * self.batch,
                          {}, context, named=named_slice.ops())
        return calls, frames, latencies, window_s, trace

    def free_program(self):
        del self.sift, self.slots
        if self.cuda:
            torch.cuda.empty_cache()

    def check(self, chunk: int, block: int) -> Dict[str, float]:
        """The sampled frames through the plain reference, compared."""
        p = ref_sift.Params.from_dict(self.cell.config["sift"])
        n_oct = p.num_octaves(self.h, self.w)
        per_frame = []
        with tf32(False):
            for s in range(0, len(self.sampled), block):
                idx = self.sampled[s:s + block]
                kps, descs, counters = ref_sift.extract(self.pool[idx], p, n_oct, chunk)
                for k, f in enumerate(idx):
                    rk = {n: kps[n][k].cpu().numpy() for n in KP_OUT}
                    rd = {n: descs[n][k].cpu().numpy() for n in DESC_OUT}
                    rc = {n: v[k].cpu().numpy() for n, v in counters.items()}
                    got = self.kept[f]
                    per_frame.append(compare.frame_readings(got["kp"], got["desc"], rk, rd,
                                                            got["counters"], rc))
                del kps, descs, counters
        return compare.summarize(per_frame)


def run_cell(cell, seed: int, seconds: float, traced_calls: int, device,
             config_override: Optional[Dict] = None) -> Dict:
    """One run of an extraction cell: set-up, window, the trace's facts,
    memory, then the check against the reference."""
    run = ExtractRun(cell, seed, device, config_override)
    calls, frames, latencies, window_s, trace = run.window(seconds, traced_calls)
    memory = torch.cuda.max_memory_allocated() if run.cuda else 0
    run.free_program()
    t_check = time.perf_counter()
    readings = run.check(REFERENCE_CHUNK, REFERENCE_BLOCK)
    return {
        "t_start": run.t_start, "t_inputs": run.t_inputs, "t_window": run.t_window,
        "window_s": window_s, "check_s": time.perf_counter() - t_check,
        "attempted": frames, "failed": 0, "memory": memory,
        "trace": trace, "readings": readings,
        "measured": {"frames_per_s": frames / window_s,
                     "frame_ms_p95": 1e3 * percentile(latencies, 95.0)},
    }


def cell_loop(cell, seed: int, device) -> Loop:
    """The run's closed loop from a set-up of its own, with no frame
    sampled for the check: a warm-up call, the window, the program freed."""
    ex = ExtractRun(cell, seed, device)
    ex.sampled = []

    def window(seconds: float):
        calls, frames, _, wall_s, _ = ex.window(seconds)
        return calls, frames, wall_s

    return Loop(lambda: (ex._call(ex._frames(0)), ex._sync()), window, ex.free_program)


def calibration_run(cell, seed: int, seconds: float, side: str, device) -> Dict:
    """One untraced run of ``side``: "program", or "control" with
    ``CONTROL_OVERRIDE``; "fault" raises, since this kind plants none."""
    if side == "fault":
        raise ValueError(f"{cell.name}: an extraction cell has no planted fault to calibrate against")
    return run_cell(cell, seed, seconds, 0, device, CONTROL_OVERRIDE if side == "control" else None)
