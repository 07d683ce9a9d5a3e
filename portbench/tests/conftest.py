"""The benchmark's tests import it as ``portbench`` from the checkout's
root; small cells for the CPU, one file a cell in ``small/``."""

import json
import pathlib
import sys

import pytest
import torch

# Several test workers share the CPU: a few threads each.
torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import spec  # noqa: E402

# ``small/<workload>.json``: the cell's CPU size, as ``{"traffic": {...},
# "config": {...}}`` overrides; a config override whose value is an
# object is merged into the configuration's object of that key.
SMALL_DIR = pathlib.Path(__file__).resolve().parent / "small"
WORKLOADS = sorted(w["name"] for w in spec.load_benchmark()["workloads"])


def small_path(name) -> pathlib.Path:
    return SMALL_DIR / f"{name}.json"


def small_cell(name, cell=None, **traffic):
    """Cell ``name`` (or ``cell``, resolved already) at the size of its
    small file, with ``traffic`` set over that."""
    cell = cell or spec.resolve(spec.load_benchmark(), name)
    small = json.loads(small_path(name).read_text())
    config = dict(cell.config)
    for key, value in small.get("config", {}).items():
        both = isinstance(value, dict) and isinstance(config.get(key), dict)
        config[key] = {**config[key], **value} if both else value
    return cell._replace(config=config, traffic={**cell.traffic, **small.get("traffic", {}), **traffic})


def cells_of_kind(kind):
    """The workloads whose traffic is of ``kind``, for kind-specific tests."""
    bench = spec.load_benchmark()
    return [w for w in WORKLOADS if spec.resolve(bench, w).traffic["kind"] == kind]


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
