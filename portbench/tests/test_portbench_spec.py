"""BENCHMARK.json resolves to its files by name, and keeps the benchmark's
format rules."""

import json
import pathlib
import re

import pytest

from portbench.harness import spec
from portbench.harness.common import BENCH_DIR, ROOT
from portbench.tests import conftest

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def check_cell(w, cell):
    """What every cell holds, whatever its traffic kind: its kind's
    generator module under ``portbench/harness/`` with the generator's
    functions, a small file for the CPU tests, its metrics and limits."""
    gen = spec.generator(cell.traffic["kind"])
    assert pathlib.Path(gen.__file__).resolve() == spec.HARNESS_DIR / f"{cell.traffic['kind']}.py"
    for name in spec.GENERATOR_FUNCTIONS:
        assert callable(getattr(gen, name, None)), name
    small = json.loads(conftest.small_path(w["name"]).read_text())
    assert set(small) <= {"traffic", "config"}
    assert cell.chips == 1
    assert cell.config["name"] == w["config"]
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in e2e
    assert set(cell.traffic["limits"]), "every cell compares numbers against limits"
    assert len(w["why"]) <= 200 and NAME.match(w["name"]) and NAME.match(w["traffic"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(w):
    check_cell(w, spec.resolve(BENCH, w["name"]))


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_exists(m):
    assert spec.metric_path(m["name"]).is_file()
    assert callable(spec.load_reader(m["name"]))
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_entry(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    path = ROOT / c["file"]
    assert path.is_file() and path.resolve().is_relative_to(BENCH_DIR)
    cfg = json.loads(path.read_text())
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]
    assert len(c["source"]) <= 200


def test_every_config_used_and_names_unique():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
