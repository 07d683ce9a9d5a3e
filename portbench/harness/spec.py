"""A cell as ``BENCHMARK.json`` names it, resolved to its files by name:
``configs[].file`` for the deployment, ``traffic/<traffic>.json`` for the
mix, ``harness/<kind>.py`` for the generator of the mix's ``kind``,
``metrics/<name>.py`` for each per-layer metric."""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
from typing import Dict, List, NamedTuple

from .common import BENCH_DIR, ROOT

TRAFFIC_DIR = BENCH_DIR / "traffic"
METRICS_DIR = BENCH_DIR / "metrics"
HARNESS_DIR = BENCH_DIR / "harness"
# What a traffic kind's generator module defines: ``run_cell(cell, seed,
# seconds, traced_calls, device)`` one run; ``cell_loop(cell, seed,
# device)`` the run's window loop as a ``program.Loop``, for the program
# slice; ``calibration_run(cell, seed, seconds, side, device)`` one run
# of ``side`` ("program", "control" or "fault") for the limits.
GENERATOR_FUNCTIONS = ("run_cell", "cell_loop", "calibration_run")


class Cell(NamedTuple):
    name: str
    chips: int
    config: Dict             # the configuration file's contents
    traffic: Dict            # the traffic file's contents
    end_to_end: List[Dict]   # BENCHMARK.json entries this cell reports
    per_layer: List[Dict]


def load_benchmark(root: pathlib.Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reported(entry: Dict, cell: str, e2e_names: List[str]) -> bool:
    """An entry with ``workloads`` is reported in those cells; a per-layer
    metric without one wherever its end-to-end metric is."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return "moves" not in entry or entry["moves"] in e2e_names


def resolve(bench: Dict, workload: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell named ``workload`` with its files read."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json ({', '.join(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((TRAFFIC_DIR / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reported(m, workload, [])]
    names = [m["name"] for m in e2e]
    layer = [m for m in bench["per_layer"] if _reported(m, workload, names)]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, layer)


def generator(kind: str):
    """The generator of traffic kind ``kind``: the module
    ``portbench/harness/<kind>.py``, with the functions of
    ``GENERATOR_FUNCTIONS``. A new kind is a new file."""
    path = (HARNESS_DIR / f"{kind}.py").relative_to(ROOT)
    module_name = f"{__package__}.{kind}"
    if not kind.isidentifier():
        raise LookupError(f"traffic kind {kind!r} is not a module name: no generator {path}")
    try:
        module = importlib.import_module(module_name)
    except ModuleNotFoundError as err:
        if err.name != module_name:
            raise
        raise LookupError(f"no generator for traffic kind {kind!r}: {path} does not exist") from None
    missing = [f for f in GENERATOR_FUNCTIONS if not callable(getattr(module, f, None))]
    if missing:
        raise LookupError(f"{path}, the generator of traffic kind {kind!r}, lacks {', '.join(missing)}")
    return module


def metric_path(name: str) -> pathlib.Path:
    return METRICS_DIR / f"{name}.py"


def load_reader(name: str):
    """The ``read(trace)`` function of ``metrics/<name>.py``."""
    path = metric_path(name)
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
