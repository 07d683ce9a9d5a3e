"""Readings of a cell's compared numbers for its limits: the program on
many seeds and the precision control on a few, in one process.

    python3 portbench/calibrate.py --workload ipol_vga.batch8 --seeds 12 --control-seeds 3

The control is the nearest precision below the configuration's, in the
program's place: for an extraction cell the port's own bf16 blur chain
(``pyramid_dtype="bfloat16"``) at the cell's size, held against the fp32
reference; for a pair cell the plain reference run with TF32 on. A pair
cell's ``--fault-seeds`` run the port with every decision a rejection
(its inlier count read as 0), the matches and models untouched. Prints
one JSON line a run: side, seed, readings, the check's seconds.
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

CONTROL_OVERRIDE = {"pyramid_dtype": "bfloat16"}


def _rejecting(traffic):
    """The port's verifier with every decision a rejection."""
    import torch

    from portbench.harness.pairs import PortVerifier

    class Rejecting(PortVerifier):
        def __call__(self, *args, **kwargs):
            tgt, model, n_in = super().__call__(*args, **kwargs)
            return tgt, model, torch.zeros_like(n_in)

    return Rejecting(traffic)


def readings(cell, seed: int, seconds: float, control: bool, device="cuda", fault: bool = False):
    if cell.traffic["kind"] == "extract":
        from portbench.harness.extract import run_cell

        out = run_cell(cell, seed, seconds, 0, device, CONTROL_OVERRIDE if control else None)
    else:
        from portbench.harness.pairs import ReferenceVerifier, run_cell

        verifier = (ReferenceVerifier(cell.traffic, control=True) if control
                    else _rejecting(cell.traffic) if fault else None)
        out = run_cell(cell, seed, seconds, 0, device, verifier)
    side = "control" if control else "fault" if fault else "program"
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
    sides = [(False, False)] * args.seeds + [(True, False)] * args.control_seeds
    sides += [(False, True)] * args.fault_seeds
    for k, (control, fault) in enumerate(sides):
        print(json.dumps(readings(cell, args.first_seed + k, args.seconds, control, fault=fault)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
