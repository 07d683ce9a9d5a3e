"""Runs one cell of the port's benchmark once and prints one result line.

    python3 portbench/run.py --workload ipol_vga.batch8 --seed 7 --seconds 10 --trace 0

The cell, its configuration, its traffic mix, the mix's generator and
its per-layer metrics are found by name from ``BENCHMARK.json``
(``portbench/configs``, ``portbench/traffic``,
``portbench/harness/<kind>.py``, ``portbench/metrics``). A run makes its
inputs from ``--seed``, warms the shapes its traffic uses, measures for
``--seconds``, checks what the window produced against the plain
reference in ``portbench/reference`` and prints, as the last line of
standard output, ``{"correct", "attempted", "failed", "metrics",
"device"[, "breakdown"], "checks"}``: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics from a
profiled slice of the window. Without a CUDA card, or with fewer than the
cell asks for, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from portbench.harness import common  # noqa: E402

common.set_cache_env()

from portbench.harness import spec  # noqa: E402


def run(workload: str, seed: int, seconds: float, trace: bool, device="cuda", cell=None,
        t_start: float = T_START, **run_args):
    """One run of ``workload`` (or of ``cell``, resolved already). Returns
    (result line fields, stderr lines); ``device="cpu"`` (tests only)
    skips the card."""
    cell = cell or spec.resolve(spec.load_benchmark(), workload)
    if device == "cuda":
        common.require_cards(cell.chips)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    traced = int(cell.traffic["traced_calls"]) if trace else 0
    out = spec.generator(cell.traffic["kind"]).run_cell(cell, seed, seconds, traced, device, **run_args)
    lines = [f"card: {common.card_line() if device == 'cuda' else 'cpu'}"]
    setup_s = out["t_window"] - t_start
    if trace:
        tr = out["trace"]
        metrics = {}
        for m in cell.per_layer:
            value = spec.load_reader(m["name"])(tr)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = common.metric(value, m["unit"])
        breakdown = tr.breakdown()
    else:
        measured = dict(out["measured"], setup_s=setup_s)
        metrics = {m["name"]: common.metric(measured[m["name"]], m["unit"]) for m in cell.end_to_end}
        breakdown = None
    limits = cell.traffic["limits"]
    checks = {k: common.check(out["readings"][k], limits[k]) for k in limits}
    device_info = (common.device_info(cell.chips, out["memory"]) if device == "cuda"
                   else {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0})
    if trace:
        device_info.update(busy_s=out["trace"].busy_s, window_s=out["trace"].window_s)
    correct = all(c["ok"] for c in checks.values())
    lines.append(f"setup_s {setup_s:.3f}: start to the cell's code {out['t_start'] - t_start:.3f} s, "
                 f"inputs {out['t_inputs'] - out['t_start']:.3f} s, program and warm-up "
                 f"{out['t_window'] - out['t_inputs']:.3f} s")
    lines.append(f"window {out['window_s']:.3f} s, {out['attempted']} "
                 f"attempted; check {out['check_s']:.3f} s")
    lines += common.check_lines(checks)
    fields = dict(correct=correct, attempted=out["attempted"], failed=out["failed"],
                  metrics=metrics, device=device_info, checks=checks, breakdown=breakdown)
    return fields, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        fields, lines = run(args.workload, args.seed, args.seconds, bool(args.trace))
    except common.NoCard as err:
        print(f"portbench: {err}", file=sys.stderr)
        return 2
    bad = common.forbidden_modules(sys.modules)
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; it may load none of "
              f"{sorted(common.FORBIDDEN_MODULES)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(common.result_line(**fields), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
