"""Traffic of kind ``ba``: the generated BAL problem, the readers of the
bundle adjustment's spans, its roofline count, the program slice on the
CPU, the sound run, the precision control and the planted fault (CPU and,
the control, on a card)."""

import pytest
import torch

from portbench import calibrate
from portbench.harness import bal_scene, program, spec
from portbench.harness.trace import Trace
from portbench.roofline import ba as roof
from portbench.roofline import peaks
from portbench.tests.conftest import cells_of_kind, small_cell
from siftmetal_tpu_torch.utils.profiling import Span

CELLS = cells_of_kind("ba")
SEED = 2 ** 31 + 41


def _limits_failed(cell, readings):
    return [k for k, limit in cell.traffic["limits"].items() if readings[k] > limit]


@pytest.mark.parametrize("name", CELLS)
def test_problem_repeats_for_a_seed_and_keeps_the_counts(name):
    c = small_cell(name).config
    a, b = bal_scene.generate(c, SEED), bal_scene.generate(c, SEED)
    other = bal_scene.generate(c, SEED + 1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a.uv, other.uv)
    assert a.cameras.shape == (c["cameras"], 9) and a.points.shape == (c["points"], 3)
    assert a.uv.shape == (c["observations"], 2)
    deg = torch.bincount(a.pt_idx.long(), minlength=c["points"])
    assert int(deg.min()) >= c["scene"]["min_degree"] and int(deg.max()) <= c["cameras"]
    # One observation a camera and point; BAL's order: by camera, then point.
    key = a.cam_idx.long() * c["points"] + a.pt_idx.long()
    assert bool((key[1:] > key[:-1]).all())
    # Inside the image but for the 1 px noise.
    assert float(a.uv[:, 0].abs().max()) <= c["width"] / 2 + 6
    assert float(a.uv[:, 1].abs().max()) <= c["height"] / 2 + 6
    assert bool((a.cameras[:, 7:] == 0).all())


def _slice(iteration_ms=(10.0, 12.0, 11.0), solves=2, pairs=1000):
    spans, t = [], 0.0
    for name, ms in [("ba.prologue", 2.0)] + [("ba.iteration", m) for m in iteration_ms] + [("ba.epilogue", 1.0)]:
        spans.append(Span(name, len(spans), None, len(spans), 0, 0, t, t + ms))
        t += ms
    return program.Slice(spans, {"ba.solves": solves, "ba.pairs": solves * pairs}, solves, solves, 0.1)


def _trace(sl, name):
    tr = Trace([], 1.0, 1, 1, {}, {"config": small_cell(name).config,
                                   "device_name": "NVIDIA H100 80GB HBM3"})
    tr.program = sl
    return tr


@pytest.mark.parametrize("name", CELLS)
def test_readers_on_synthetic_spans(name):
    tr = _trace(_slice(), name)
    read = lambda m: spec.load_reader(m)(tr)
    assert read("ba.iteration_ms") == pytest.approx(11.0)
    assert read("ba.prologue_ms") == pytest.approx(2.0)
    c = tr.context["config"]
    least = peaks.least_seconds(*roof.work(c["cameras"], c["points"], c["observations"], 1000, 9),
                                "NVIDIA H100 80GB HBM3")
    assert read("ba_roofline") == pytest.approx(100.0 * least / 0.011)
    # No counters (a program without them), no slice, no device times: nothing.
    bare = _slice()._replace(counters={})
    assert spec.load_reader("ba_roofline")(_trace(bare, name)) is None
    host = _slice()._replace(spans=[s._replace(device_start_ms=None, device_end_ms=None)
                                    for s in _slice().spans])
    for m in ("ba.iteration_ms", "ba.prologue_ms", "ba_roofline"):
        assert spec.load_reader(m)(_trace(host, name)) is None


def test_roofline_by_hand():
    # 2 cameras of 9, 5 points, 10 observations, 7 pairs.
    nbytes, nops = roof.work(2, 5, 10, 7, 9)
    obs = 40 * 12 + 4 * 81 + 4 * 9 + 48 + 12 * 9 + 18 * 9 + 12 * 9
    assert roof.obs_ops(9) == obs
    assert nops == 6 * 81 * 7 + 18 ** 3 / 3 + obs * 10 + 81 * 5
    assert nbytes == 16 * 10 + 2 * 8 * 18 * 18


@pytest.mark.parametrize("name", CELLS)
def test_slice_spans_and_counters(name):
    cell = small_cell(name)
    sl = program.run_slice(cell, SEED, "cpu", seconds=1e-3)
    n, iters = sl.calls, cell.config["solver"]["iterations"]
    assert sl.items == n * cell.config["cameras"]
    assert [s.name for s in sl.spans] == (["ba.prologue"] + ["ba.iteration"] * iters + ["ba.epilogue"]) * n
    assert sl.counters["ba.solves"] == n and sl.counters["ba.pairs"] % n == 0


@pytest.mark.parametrize("name", CELLS)
def test_sound_control_and_fault_runs(name):
    """The sound run reads correct; the precision control (the solve with
    its normal equations in float32) reads not correct by the first
    step's cost, and the planted fault (few observations kept a point) by
    ``obs_dropped``."""
    cell = small_cell(name)
    got = {side: calibrate.readings(cell, SEED, 0.2, side, device="cpu")["readings"]
           for side in ("program", "control", "fault")}
    assert not _limits_failed(cell, got["program"])
    assert "first_step_gap_rel" in _limits_failed(cell, got["control"])
    assert "obs_dropped" in _limits_failed(cell, got["fault"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(name, cuda_card):
    cell = spec.resolve(spec.load_benchmark(), name)
    for seed in (11, 12, 13):
        control = calibrate.readings(cell, seed, 0.5, "control")
        assert "first_step_gap_rel" in _limits_failed(cell, control["readings"]), control
