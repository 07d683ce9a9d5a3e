#!/usr/bin/env python3
"""How often torch.profiler loses a kernel event of a CUDA graph replay.

    python3 scripts/profile_drops.py [--calls N]

``SIFT(480, 640).extract_batch`` on chip_smoke's seeded 8x480x640 noise
frames, replayed under the profiler N times (default 100), one profile a
call: prints how many device events each profile holds and each profile
whose launches of the port's kernels (``ops.kernels.device_launches``)
differ from the most common count. A replay runs the same graph every
time, so every difference is the profiler's. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=100)
    n_calls = ap.parse_args().calls
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_drops: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke  # imports no package at module level
    from siftmetal_tpu_torch import SIFT
    from siftmetal_tpu_torch.ops import cuda as C
    from siftmetal_tpu_torch.ops.kernels import device_launches

    C.build_all()
    sift = SIFT(480, 640)
    x = chip_smoke._noise_frames(sift.device)
    sift.extract_batch(x)
    torch.cuda.synchronize()
    events, launches = [], []
    for _ in range(n_calls):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sift.extract_batch(x)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        events.append(len(names))
        launches.append(tuple(sorted(device_launches(names).items())))
    usual = collections.Counter(launches).most_common(1)[0][0]
    for i, got in enumerate(launches):
        if got != usual:
            lost = {"+".join(g): (n, m) for (g, n), (_, m) in zip(got, usual) if n != m}
            print(f"[profile_drops] call {i}: {events[i]} device events; port kernels "
                  f"(seen, usual) {lost}", flush=True)
    short = sum(got != usual for got in launches)
    print(f"[profile_drops] {n_calls} profiled replays: device events per profile "
          f"{dict(sorted(collections.Counter(events).items()))}; {short} lost a port kernel's "
          f"event ({chip_smoke._smi()})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
