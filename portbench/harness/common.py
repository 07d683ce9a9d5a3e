"""What every run shares: the checkout's paths and caches, the card check,
the modules a run may not hold, and the result line."""

from __future__ import annotations

import json
import math
import os
import pathlib
import subprocess
import sys
from typing import Dict, Iterable, List, Optional

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
# Kernel caches at fixed paths inside the checkout, so only a checkout's
# first run builds. The port's nvcc libraries live in its own
# ``siftmetal_tpu_torch/_build/`` beside its sources.
CACHE_DIR = BENCH_DIR / ".cache"

# Top-level module names a run may not hold once its window has closed:
# the JAX stack and the JAX package the port was made from. Compared whole
# (``siftmetal_tpu_torch`` is not ``siftmetal_tpu``).
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "siftmetal_tpu"})


def set_cache_env() -> None:
    """Point every build and kernel cache into the checkout and keep
    libraries from loading JAX; call before torch is imported."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # One process with few threads: the host work is dispatch.
    os.environ["OMP_NUM_THREADS"] = "1"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The top-level names among ``names`` (module names, dotted or not)
    that are forbidden, compared whole."""
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN_MODULES)


class NoCard(RuntimeError):
    pass


def require_cards(chips: int) -> None:
    """Raise unless CUDA is there with at least ``chips`` cards."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark runs on a CUDA card")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"{torch.cuda.device_count()} CUDA cards, the cell asks for {chips}")


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi unavailable ({err})"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else "nvidia-smi unavailable"


def device_info(count: int, memory_peak_bytes: int) -> Dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(memory_peak_bytes)}


def metric(value: float, unit: str) -> Dict:
    return {"value": float(value), "unit": unit}


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default rule)."""
    if not values:
        raise ValueError("no values")
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict, device: Dict,
                checks: Dict, breakdown: Optional[Dict] = None) -> str:
    """The run's last line: the fixed result keys, then the numbers compared
    with their limits under ``checks``, last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def check_lines(checks: Dict) -> List[str]:
    """One line a compared number: its value beside its limit."""
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r}) {'ok' if c['ok'] else 'FAIL'}"
            for name, c in checks.items()]


def check(value: float, limit: float) -> Dict:
    """A compared number: fails above its limit (NaN fails)."""
    value = float(value)
    return {"value": value, "limit": float(limit), "ok": bool(value <= limit)}


class tf32:
    """TF32 for matmuls and cuDNN on or off inside the block, restored
    after (the reference runs with it off)."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        import torch

        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.on
        torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        import torch

        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
        return False
