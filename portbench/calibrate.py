"""Readings of a cell's compared numbers for its limits: the program on
many seeds, the precision control on a few, and a planted fault where the
cell's traffic kind has one, in one process.

    python3 portbench/calibrate.py --workload ipol_vga.batch8 --seeds 12 --control-seeds 3

Each side is run by the generator of the cell's traffic kind
(``portbench/harness/<kind>.py``, found by ``spec.generator``), whose
``calibration_run(cell, seed, seconds, side, device)`` says what its
control and its fault are: "control" is the nearest precision below the
configuration's in the program's place, "fault" a fault planted in the
timed path; a kind without a planted fault raises on ``--fault-seeds``.
Prints one JSON line a run: side, seed, readings, the check's seconds,
the calls or frames attempted.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from portbench.harness import common  # noqa: E402

common.set_cache_env()

from portbench.harness import spec  # noqa: E402

SIDES = ("program", "control", "fault")


def readings(cell, seed: int, seconds: float, side: str, device="cuda"):
    """One run of ``side`` of ``cell``, untraced, and its readings."""
    if side not in SIDES:
        raise ValueError(f"side {side!r} is none of {SIDES}")
    out = spec.generator(cell.traffic["kind"]).calibration_run(cell, seed, seconds, side, device)
    return {"side": side, "seed": seed,
            "readings": out["readings"], "check_s": out["check_s"], "attempted": out["attempted"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=0)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 1000)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    cell = spec.resolve(spec.load_benchmark(), args.workload)
    common.require_cards(cell.chips)
    sides = ["program"] * args.seeds + ["control"] * args.control_seeds + ["fault"] * args.fault_seeds
    for k, side in enumerate(sides):
        print(json.dumps(readings(cell, args.first_seed + k, args.seconds, side)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
