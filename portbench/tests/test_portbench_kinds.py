"""A traffic kind is one generator module, ``portbench/harness/<kind>.py``,
that every entry point finds by name: a probe kind, put in place as a
module and given a small file and a metric reader outside the tree, runs
through ``run.py``, the program slice and ``calibrate.py`` and passes the
spec test's per-cell check with no existing file edited; an unknown kind
raises, naming the kind and the file looked for, in all three."""

import json
import sys
import time
import types

import pytest

from portbench import calibrate
from portbench import run as bench_run
from portbench.harness import common, program, spec
from portbench.harness.trace import Op, Trace
from portbench.tests import conftest
from portbench.tests.test_portbench_spec import check_cell
from siftmetal_tpu_torch.utils import profiling

PROBE = "probe_kind"
NAME = "probe_cfg.probe"
SEED = 2 ** 31 + 5
# The probe's compared number on each calibration side, and its limit.
GAPS = {"program": 0.0, "control": 1.0, "fault": 2.0}
LIMIT = 0.5
READER = '''import statistics


def read(trace):
    spans = trace.spans.get("probe.ms")
    return statistics.median(spans) if spans else None
'''


def _generator():
    mod = types.ModuleType(f"portbench.harness.{PROBE}")
    mod.__file__ = str(spec.HARNESS_DIR / f"{PROBE}.py")

    def run_cell(cell, seed, seconds, traced_calls, device, gap=0.0):
        t0 = time.perf_counter()
        calls = int(cell.traffic["calls"])
        trace = None
        if traced_calls:
            trace = Trace([Op("probe_kernel", 0.0, 500.0)], 0.002, traced_calls, traced_calls,
                          {"probe.ms": [1.0, 2.0, 4.0]}, {"config": cell.config, "device_name": device})
        return {"t_start": t0, "t_inputs": t0, "t_window": t0, "window_s": seconds, "check_s": 0.0,
                "attempted": calls, "failed": 0, "memory": 0, "trace": trace,
                "readings": {"probe_gap": gap}, "measured": {"probe_per_s": calls / seconds}}

    def cell_loop(cell, seed, device):
        def window(seconds):
            for _ in range(int(cell.traffic["calls"])):
                with profiling.span("probe.call"):
                    pass
            return int(cell.traffic["calls"]), int(cell.traffic["calls"]), seconds

        return program.Loop(lambda: None, window, lambda: None)

    def calibration_run(cell, seed, seconds, side, device):
        return run_cell(cell, seed, seconds, 0, device, gap=GAPS[side])

    mod.run_cell, mod.cell_loop, mod.calibration_run = run_cell, cell_loop, calibration_run
    return mod


@pytest.fixture
def probe(monkeypatch, tmp_path):
    """The probe kind's workload entry and cell: its generator in
    ``sys.modules``, its small file and metric reader under ``tmp_path``."""
    monkeypatch.setitem(sys.modules, f"portbench.harness.{PROBE}", _generator())
    (tmp_path / "small").mkdir()
    (tmp_path / "small" / f"{NAME}.json").write_text(json.dumps({"traffic": {"calls": 3}}))
    monkeypatch.setattr(conftest, "SMALL_DIR", tmp_path / "small")
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "probe.ms.py").write_text(READER)
    monkeypatch.setattr(spec, "METRICS_DIR", tmp_path / "metrics")
    w = {"name": NAME, "config": "probe_cfg", "traffic": "probe", "chips": 1,
         "why": "a probe of a traffic kind defined by one module"}
    e2e = [{"name": "probe_per_s", "unit": "calls/s", "better": "higher", "bound": 0.1,
            "source": "host_clock", "workloads": [NAME]},
           {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25, "source": "host_clock"}]
    layer = [{"name": "probe.ms", "unit": "ms", "better": "lower", "source": "program_span",
              "layer": "probe", "moves": "probe_per_s", "workloads": [NAME]}]
    cell = spec.Cell(NAME, 1, {"name": "probe_cfg"},
                     {"kind": PROBE, "calls": 5, "traced_calls": 2, "limits": {"probe_gap": LIMIT}},
                     e2e, layer)
    return w, cell


def _run(cell, trace, **run_args):
    fields, lines = bench_run.run(cell.name, SEED, 0.25, trace, device="cpu", cell=cell,
                                  t_start=time.perf_counter(), **run_args)
    return json.loads(common.result_line(**fields)), lines


def test_probe_passes_the_spec_check(probe):
    w, cell = probe
    check_cell(w, cell)
    assert conftest.small_cell(NAME, cell).traffic["calls"] == 3


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_probe_runs_through_run_py(probe, trace):
    _, cell = probe
    line, lines = _run(conftest.small_cell(NAME, cell), trace)
    assert line["correct"] is True and line["attempted"] == 3
    if trace:
        assert line["metrics"] == {"probe.ms": {"value": 2.0, "unit": "ms"}}
        assert line["device"]["busy_s"] == pytest.approx(5e-4)
        assert line["breakdown"]["device_ops"] == [["probe_kernel", pytest.approx(5e-4)]]
    else:
        assert set(line["metrics"]) == {"probe_per_s", "setup_s"}
        assert line["metrics"]["probe_per_s"]["value"] == pytest.approx(3 / 0.25)
    assert line["checks"] == {"probe_gap": {"value": 0.0, "limit": LIMIT, "ok": True}}
    assert lines[-1] == common.check_lines(line["checks"])[-1]
    bad, _ = _run(cell, trace, gap=1.0)
    assert bad["correct"] is False


def test_probe_slice(probe):
    _, cell = probe
    sl = program.run_slice(cell, SEED, "cpu", seconds=0.01)
    assert (sl.calls, sl.items) == (5, 5) and sl.wall_s == 0.01
    assert [s.name for s in sl.spans] == ["probe.call"] * 5
    assert program.from_json(program.to_json(sl)) == sl


def test_probe_calibration(probe):
    _, cell = probe
    for side, gap in GAPS.items():
        got = calibrate.readings(cell, SEED, 0.25, side, device="cpu")
        assert got == {"side": side, "seed": SEED, "readings": {"probe_gap": gap},
                       "check_s": 0.0, "attempted": 5}
    with pytest.raises(ValueError, match="side 'both'"):
        calibrate.readings(cell, SEED, 0.25, "both", device="cpu")


@pytest.mark.parametrize("kind", ["no_such_kind", "../traffic"])
def test_unknown_kind_raises_everywhere(probe, kind):
    _, cell = probe
    cell = cell._replace(traffic=dict(cell.traffic, kind=kind))
    entry_points = [lambda: _run(cell, False),
                    lambda: program.run_slice(cell, SEED, "cpu", seconds=0.01),
                    lambda: calibrate.readings(cell, SEED, 0.25, "program", device="cpu")]
    for call in entry_points:
        with pytest.raises(LookupError) as err:
            call()
        assert repr(kind) in str(err.value)
        assert f"portbench/harness/{kind}.py" in str(err.value)


def test_a_module_without_the_generator_functions_is_refused():
    with pytest.raises(LookupError, match="'trace'.*lacks run_cell, cell_loop, calibration_run"):
        spec.generator("trace")
