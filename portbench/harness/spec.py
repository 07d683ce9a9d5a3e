"""A cell as ``BENCHMARK.json`` names it, resolved to its files by name:
``configs[].file`` for the deployment, ``traffic/<traffic>.json`` for the
mix, ``metrics/<name>.py`` for each per-layer metric."""

from __future__ import annotations

import importlib.util
import json
import pathlib
from typing import Dict, List, NamedTuple

from .common import BENCH_DIR, ROOT

TRAFFIC_DIR = BENCH_DIR / "traffic"
METRICS_DIR = BENCH_DIR / "metrics"


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


def metric_path(name: str) -> pathlib.Path:
    return METRICS_DIR / f"{name}.py"


def load_reader(name: str):
    """The ``read(trace)`` function of ``metrics/<name>.py``."""
    path = metric_path(name)
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
