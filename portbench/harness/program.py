"""The program slice of a traced run: the cell's own closed loop for
``SLICE_SECONDS`` with the port's tracer on (``siftmetal_tpu_torch.utils.
profiling``) and no profiler, after one warm-up call under the tracer
that captures the traced program. What the ``program_span`` metrics
read: today the extraction stages, the facade's copies and idle share,
and the pair path's wait and dispatch.

The loop is the generator's: :func:`cell_loop` finds the cell's traffic
kind's module, ``portbench/harness/<kind>.py`` (``spec.generator``), and
takes its ``cell_loop(cell, seed, device)``, a :class:`Loop` over the
run's own window with nothing kept for the check. A new kind's slice
needs no edit here.

The slice is made on the first reader's request (:func:`of`), once a run,
in a child process of its own (``python3 -m portbench.harness.program
--workload W --seed N``, which prints the slice as one JSON line): a
process in which no profiler session has run, since a session slows the
launches that follow it in its process. The child sets the cell up anew
from the workload and seed of the run's command line, so the generators'
loops run as they always did. On the CPU (tests) the slice is made in the
run's own process. A program whose profiling module has no tracer gives
no slice, and its readers read nothing. The slice raises if the program
captures a graph after its warm-up: the loop then met a shape it had not
warmed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

from . import common, spec

# Long enough for a median over tens of calls in every cell (batch8 ~130
# calls, stream1 ~200, pairs ~100 on an H100), short beside the window.
SLICE_SECONDS = 1.0
CHILD_TIMEOUT_S = 900


class Slice(NamedTuple):
    """The drained spans and counters of ``calls`` calls of ``items``
    frames or pairs in all, over ``wall_s`` of the host's clock."""

    spans: List
    counters: Dict[str, int]
    calls: int
    items: int
    wall_s: float


def of(trace) -> Optional[Slice]:
    """The run's program slice, made on the first request and kept on
    ``trace``; None where the program has no tracer or no cell is named
    on the command line."""
    if not hasattr(trace, "program"):
        trace.program = _for_run(trace)
    return trace.program


def _tracer():
    from siftmetal_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "tracing") else None


def _command_line():
    """(workload, seed) of ``run.py``'s command line, or None."""
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    args, _ = ap.parse_known_args(sys.argv[1:])
    return None if args.workload is None or args.seed is None else (args.workload, args.seed)


def _for_run(trace) -> Optional[Slice]:
    named = _command_line()
    if _tracer() is None or named is None:
        return None
    cell = spec.resolve(spec.load_benchmark(), named[0])
    if cell.config != trace.context.get("config"):
        return None
    if trace.context.get("device_name", "cpu") == "cpu":
        return run_slice(cell, named[1], "cpu")
    return in_child(*named)


def in_child(workload: str, seed: int) -> Slice:
    """The slice of ``workload`` made by a child process on the card."""
    cmd = [sys.executable, "-m", "portbench.harness.program", "--workload", workload,
           "--seed", str(seed)]
    done = subprocess.run(cmd, cwd=common.ROOT, capture_output=True, text=True,
                          timeout=CHILD_TIMEOUT_S)
    if done.returncode:
        raise RuntimeError(f"the program slice's process exited {done.returncode}:\n"
                           f"{done.stderr[-4000:]}")
    return from_json(done.stdout.strip().splitlines()[-1])


def to_json(sl: Slice) -> str:
    return json.dumps(dict(sl._asdict(), spans=[s._asdict() for s in sl.spans]))


def from_json(line: str) -> Slice:
    d = json.loads(line)
    Span = _tracer().Span
    return Slice(**dict(d, spans=[Span(**s) for s in d["spans"]]))


class Loop(NamedTuple):
    """A cell's closed loop: ``warm()`` one call; ``window(seconds)`` the
    run's own window loop for ``seconds``, returning (calls, items, wall
    s); ``close()``."""

    warm: Callable[[], None]
    window: Callable[[float], Tuple[int, int, float]]
    close: Callable[[], None]


def cell_loop(cell, seed: int, device) -> Loop:
    """The loop of ``cell`` from a set-up of its own, with nothing kept for
    a check: its traffic kind's generator's ``cell_loop``."""
    return spec.generator(cell.traffic["kind"]).cell_loop(cell, seed, device)


def traced(loop: Loop, seconds: float) -> Slice:
    """One warm-up call, then the loop's window for ``seconds``, with the
    tracer on; the spans and counters of the window."""
    tracer = _tracer()
    with tracer.tracing():
        loop.warm()
        tracer.drain()
        calls, items, wall_s = loop.window(seconds)
        got = tracer.drain()
    captured = got.counters.get("graphs.captures", 0)
    if captured:
        raise RuntimeError(f"the program captured {captured} graph(s) in the program slice "
                           "after its warm-up: the loop met a shape it had not warmed")
    return Slice(got.spans, got.counters, calls, items, wall_s)


def run_slice(cell, seed: int, device, seconds: float = SLICE_SECONDS) -> Slice:
    """The program slice of ``cell`` from a set-up of its own."""
    loop = cell_loop(cell, seed, device)
    try:
        return traced(loop, seconds)
    finally:
        loop.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Prints the program slice of a cell as one JSON line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    cell = spec.resolve(spec.load_benchmark(), args.workload)
    common.require_cards(cell.chips)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    sl = run_slice(cell, args.seed, "cuda")
    print(f"program slice: {sl.calls} calls, {sl.wall_s:.3f} s of {time.perf_counter() - t0:.3f}",
          file=sys.stderr)
    bad = common.forbidden_modules(sys.modules)
    if bad:
        print(f"program slice: loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print(to_json(sl), flush=True)
    return 0


if __name__ == "__main__":
    common.set_cache_env()
    sys.exit(main())
