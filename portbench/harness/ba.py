"""Traffic of kind ``ba``: a photo collection's global bundle adjustment
through the port's replayed solve.

The configuration's BAL problem is generated from the seed
(``bal_scene.generate``) and kept in pinned host memory. A closed loop,
one solve in flight: each call copies the problem to the card, runs the
solve ``SfmMap.bundle_adjust`` runs (``slam.sfm.replayed_bundle_adjust``,
the LM program replayed from CUDA graphs) for the configuration's
iterations, with the pair list as long as the problem's own pair count
(``landmark_pairs``), and copies cameras and points back to host memory.
A call counts its cameras as frames adjusted. The first call captures
the program and counts as set-up.

After the window its last solve is compared with the plain float64
reference (``reference/bal.py``) run on the same problem on the card:
the observations and pairs the program left out (0, exact); the gap of
the costs the first step reached (the solve's ``first_step_cost``) over
the reference's: the problem converges in a few of its iterations, after
which both sides sit at one optimum whatever their arithmetic, so the
first step is where the precision of the normal equations shows; the
gap of the final costs (both evaluated in float64 by the reference) over
the reference's; and the largest distance between the pixels the two
solutions predict, over all observations.

The generator's three functions (``spec.GENERATOR_FUNCTIONS``):
:func:`run_cell` one run; :func:`cell_loop` the window loop for the
program slice; :func:`calibration_run` one run of the program, of the
precision control (the same solve with its normal equations assembled
and solved in float32, ``slam.ba.ACC``, the nearest precision below the
configuration's float64) or of the planted fault (the solve keeping
``fault_max_obs_per_landmark`` observations a point).
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from ..reference import bal as ref_bal
from .bal_scene import generate
from .program import Loop
from .trace import Profiled, Trace


class Float32Assembly:
    """The precision control: the map's solve with its normal equations
    assembled and solved in float32 (``slam.ba.ACC``), from graphs of its
    own; in the program's place."""

    def __init__(self):
        from siftmetal_tpu_torch.graphs import GraphCache
        from siftmetal_tpu_torch.slam import ba

        self.ba = ba
        self.graphs = GraphCache(ba.lm_solve, "bundle_adjust (float32 normal equations)")

    def __call__(self, problem, **static):
        acc, self.ba.ACC = self.ba.ACC, torch.float32
        try:
            cameras, landmarks, stats = self.graphs(problem, **static)
        finally:
            self.ba.ACC = acc
        return problem._replace(cameras=cameras, landmarks=landmarks), stats


class BARun:
    """Set-up, window and check of one BA cell."""

    def __init__(self, cell, seed: int, device, solve=None, max_obs_per_landmark=None):
        from siftmetal_tpu_torch.slam.ba import BAProblem, landmark_pairs
        from siftmetal_tpu_torch.slam.sfm import replayed_bundle_adjust
        from siftmetal_tpu_torch.utils import profiling

        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.profiling = profiling
        self.t_start = time.perf_counter()
        c, sv = cell.config, cell.config["solver"]
        bal = generate(c, seed, self.device)
        pin = lambda t: t.pin_memory() if self.cuda else t
        self.problem = BAProblem(
            cameras=pin(bal.cameras), landmarks=pin(bal.points), k=pin(torch.eye(3)),
            cam_idx=pin(bal.cam_idx), lm_idx=pin(bal.pt_idx), uv=pin(bal.uv),
            valid=pin(torch.ones(bal.uv.shape[0], dtype=torch.bool)),
            fixed_cameras=int(sv["fixed_cameras"]))
        self.out = (pin(torch.empty_like(bal.cameras)), pin(torch.empty_like(bal.points)))
        self.t_inputs = time.perf_counter()
        if self.cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        self.m = int(max_obs_per_landmark or sv["max_obs_per_landmark"])
        self.pairs = landmark_pairs(bal.pt_idx, self.problem.valid, bal.points.shape[0], self.m)
        self.args = dict(n_iterations=int(sv["iterations"]), huber_delta=float(sv["huber_delta"]),
                         damping=float(sv["damping"]), max_obs_per_landmark=self.m,
                         max_pairs=self.pairs)
        self.solve = solve or replayed_bundle_adjust
        self.stats = None
        self.calls = 0
        self._call()             # the capture
        self.calls = 0

    def _call(self) -> None:
        """One solve: the problem from host memory, the solution back."""
        nb = self.cuda
        p = self.problem._replace(**{f: getattr(self.problem, f).to(self.device, non_blocking=nb)
                                     for f in self.problem._fields[:-1]})
        self.profiling.count("ba.pairs", self.pairs)
        out, self.stats = self.solve(p, **self.args)
        self.out[0].copy_(out.cameras, non_blocking=nb)
        self.out[1].copy_(out.landmarks, non_blocking=nb)
        if self.cuda:
            torch.cuda.current_stream(self.device).synchronize()
        self.calls += 1

    def window(self, seconds: float, traced_calls: int = 0):
        """The closed loop for ``seconds``; returns (calls, window s,
        trace or None). A traced run then profiles ``traced_calls`` calls
        with the device alone and as many with the host's ranges."""
        self.calls = 0
        t0 = self.t_window = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._call()
        window_s = time.perf_counter() - t0
        calls = self.calls
        if not traced_calls:
            return calls, window_s, None

        def run_slice(host: bool) -> Profiled:
            with Profiled(host) as profiled:
                for _ in range(traced_calls):
                    self._call()
            return profiled

        device_slice, named_slice = run_slice(host=False), run_slice(host=True)
        trace = Trace(device_slice.ops()[0], device_slice.window_s, traced_calls,
                      traced_calls * self.n_cameras, {}, self._context(), named=named_slice.ops())
        return calls, window_s, trace

    @property
    def n_cameras(self) -> int:
        return self.problem.cameras.shape[0]

    def _context(self) -> Dict:
        name = torch.cuda.get_device_name(self.device) if self.cuda else "cpu"
        return {"config": self.cell.config, "traffic": self.cell.traffic, "device_name": name}

    def check(self) -> Dict[str, float]:
        """The last solve against the plain reference on the same problem
        and device."""
        p, dev = self.problem, self.device
        obs = ref_bal.observations(p.cam_idx.to(dev), p.lm_idx.to(dev), p.uv.to(dev))
        sv = self.cell.config["solver"]
        ref = ref_bal.solve(p.cameras.to(dev), p.landmarks.to(dev), obs, int(sv["iterations"]),
                            float(sv["damping"]), int(sv["fixed_cameras"]))
        cams, pts = self.out[0].to(dev), self.out[1].to(dev)
        cost = float(ref_bal.cost(cams, pts, obs))
        gap_px = torch.linalg.vector_norm(ref_bal.predicted(cams, pts, obs)
                                          - ref_bal.predicted(ref.cameras, ref.points, obs), dim=1)
        first = float(self.stats.first_step_cost)
        return {"obs_dropped": float(self.stats.obs_dropped),
                "pairs_dropped": float(self.stats.pairs_dropped),
                "first_step_gap_rel": abs(first - ref.first_step_cost) / ref.first_step_cost,
                "cost_gap_rel": abs(cost - ref.final_cost) / ref.final_cost,
                "reproj_gap_px": float(gap_px.max())}


def run_cell(cell, seed: int, seconds: float, traced_calls: int, device, solve=None,
             max_obs_per_landmark=None) -> Dict:
    """One run of a BA cell: set-up, window, memory, then the check."""
    run = BARun(cell, seed, device, solve, max_obs_per_landmark)
    calls, window_s, trace = run.window(seconds, traced_calls)
    memory = torch.cuda.max_memory_allocated(run.device) if run.cuda else 0
    t_check = time.perf_counter()
    readings = run.check()
    return {"t_window": run.t_window, "t_start": run.t_start, "t_inputs": run.t_inputs,
            "window_s": window_s, "check_s": time.perf_counter() - t_check,
            "attempted": calls, "failed": 0, "memory": memory,
            "trace": trace, "readings": readings,
            "measured": {"frames_per_s": calls * run.n_cameras / window_s}}


def cell_loop(cell, seed: int, device) -> Loop:
    """The run's closed loop from a set-up of its own: a warm-up call, the
    window."""
    run = BARun(cell, seed, device)

    def window(seconds: float):
        calls, wall_s, _ = run.window(seconds)
        return calls, calls * run.n_cameras, wall_s

    return Loop(run._call, window, lambda: None)


def calibration_run(cell, seed: int, seconds: float, side: str, device) -> Dict:
    """One untraced run of ``side``: "program", "control" (the solve with
    its normal equations in float32) or "fault"
    (``fault_max_obs_per_landmark`` observations kept a point)."""
    if side == "control":
        return run_cell(cell, seed, seconds, 0, device, solve=Float32Assembly())
    if side == "fault":
        m = int(cell.traffic["fault_max_obs_per_landmark"])
        return run_cell(cell, seed, seconds, 0, device, max_obs_per_landmark=m)
    return run_cell(cell, seed, seconds, 0, device)
