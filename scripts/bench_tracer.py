#!/usr/bin/env python3
"""The port's tracer on the benchmark's loops: its cost, the stage split,
and the device-only slice's kernels.

    python3 scripts/bench_tracer.py [--package-root DIR] [--cells C ...]
        [--seconds S] [--rounds R] [--seed N] [--out FILE]

For each cell of ``BENCHMARK.json`` (default: all), the cell's own window
loop (``portbench/harness/program.py`` ``cell_loop``) before any profiler
session of the process: S seconds with the tracer off and on in turns
(off, on, on, off; R rounds), ms a call each, and the program slice's
readings of the last traced window. Then, for each cell again, the
device-only slice of a ``--trace 1`` run (S seconds under
``torch.profiler`` with the device alone): each kernel name's launches a
call, and the device ms a frame of
the pyramid, detection and describe kernel groups
(``portbench/roofline``). The ``siftmetal_tpu_torch`` imported is DIR's
(default: this checkout), so two trees' programs can be compared on one
card; a tree whose tracer predates ``tracing()`` is timed with it off
only. Prints one JSON line a cell, also appended to FILE. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
from collections import Counter

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEVICE = "cuda"


def _loop(name: str, seed: int):
    from portbench.harness import program, spec

    cell = spec.resolve(spec.load_benchmark(), name)
    return cell, program.cell_loop(cell, seed, DEVICE)


def _close(loop) -> None:
    import torch

    loop.close()
    del loop
    torch.cuda.empty_cache()


def _timing(name: str, seed: int, seconds: float, rounds: int):
    """The tracer off and on in turns, and the program slice's readings of
    the last traced window."""
    from portbench.harness import program, spec
    from portbench.harness.trace import Trace

    cell, loop = _loop(name, seed)
    tracer = program._tracer()
    out = {"cell": name, "seconds": seconds, "tracer": tracer is not None}
    loop.window(seconds)
    times = {"off": [], "on": []}
    last = None
    for _ in range(rounds):
        for mode in ("off", "on", "on", "off") if tracer is not None else ("off",):
            if mode == "on":
                last = program.traced(loop, seconds)   # its warm-up captures once
                calls, wall_s = last.calls, last.wall_s
            else:
                calls, _, wall_s = loop.window(seconds)
            times[mode].append(1e3 * wall_s / calls)
    out["ms_a_call"] = times
    out["ms_a_call_median"] = {k: statistics.median(v) for k, v in times.items() if v}
    if last is not None:
        tr = Trace([], 1.0, 1, 1, {}, {})
        tr.program = last
        readings = {m["name"]: spec.load_reader(m["name"])(tr)
                    for m in cell.per_layer if m["source"] == "program_span"}
        out["program_slice"] = {k: v for k, v in readings.items() if v is not None}
    _close(loop)
    return out


def _census(name: str, seed: int, seconds: float):
    """The device-only slice: kernels a call, busy time, the kernel
    groups' device ms a frame."""
    from portbench.harness.trace import Profiled, Trace
    from portbench.roofline import describe, detect, pyramid

    _, loop = _loop(name, seed)
    loop.window(seconds)
    with Profiled(host=False) as prof:
        calls, items, _ = loop.window(seconds)
    tr = Trace(prof.ops()[0], prof.window_s, calls, items, {}, {})
    _close(loop)
    return {
        "profiled_ms_a_call": 1e3 * prof.window_s / calls,
        "busy_ms_a_item": 1e3 * tr.busy_s / tr.items,
        "kernels_a_call": dict(sorted(
            (n, round(c / calls, 2)) for n, c in Counter(k.name for k in tr.kernels).items())),
        "group_ms_a_item": {g: 1e3 * tr.kernel_seconds(p) / tr.items for g, p in
                            [("pyramid", pyramid.PATTERNS), ("detect", detect.PATTERNS),
                             ("describe", describe.PATTERNS)]},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package-root", default=str(ROOT))
    ap.add_argument("--cells", nargs="*")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 11)
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from portbench.harness import common

    common.set_cache_env()
    sys.path.insert(0, str(pathlib.Path(args.package_root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("bench_tracer: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import siftmetal_tpu_torch

    from portbench.harness import spec

    names = args.cells or [w["name"] for w in spec.load_benchmark()["workloads"]]
    # Every timing before the first profiler session: one slows the
    # process's later launches.
    timed = [_timing(name, args.seed, args.seconds, args.rounds) for name in names]
    for name, out in zip(names, timed):
        line = dict(out, **_census(name, args.seed, args.seconds),
                    package=str(pathlib.Path(siftmetal_tpu_torch.__file__).parent),
                    card=common.card_line())
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
