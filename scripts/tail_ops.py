#!/usr/bin/env python3
"""Count the PyTorch ops that one stage of the extraction dispatches.

    python3 scripts/tail_ops.py [--package-root DIR] [--device cpu|cuda]
                                [--stage tail|describe]
                                [--batch B] [--height H] [--width W]

``extract_gray_batch`` of B seeded HxW noise frames (default 8x240x320)
in the parity configuration on the device, for the ``siftmetal_tpu_torch``
under ``--package-root`` (default: this checkout); prints the ops
dispatched inside the tree's stage (a ``TorchDispatchMode`` around it),
how many of them are not views, and how many read a value back to the
host. ``--stage tail`` (the default) counts the cross-octave refinement
tail (``sift/detect.py`` ``refine_tail`` where the tree has it, else
``_tail_all_octaves``); ``--stage describe`` counts ``sift/batched.py``
``_describe_octaves`` with the two histogram wrappers it calls
(``orientation_hist_octaves``, ``descriptor_lanes``; ``orient_desc_lanes``
in the fused form) left out. On the CPU each stage is its plain PyTorch
route; on a card each op that is not a view is a launch or more (a
hand-written kernel's own launch goes through ctypes and is not an op), so
two trees' counts predict how their device op counts and host dispatch
compare. On a card ``--stage describe`` also captures the stage alone in
a CUDA graph (``graphs.GraphCache``) and prints the device kernels and
the other device activities (copies, fills) of one replay, from
torch.profiler (the largest of three profiles: one loses an event now and
then).
"""

from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package-root", default=str(ROOT),
                    help="directory holding the siftmetal_tpu_torch to count")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--stage", choices=("tail", "describe"), default="tail")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--width", type=int, default=320)
    args = ap.parse_args()
    package_root = pathlib.Path(args.package_root).resolve()
    sys.path.insert(0, str(package_root))
    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from siftmetal_tpu_torch import SiftConfig
    from siftmetal_tpu_torch.sift import batched, detect
    from siftmetal_tpu_torch.sift.batched import extract_gray_batch

    reads = (torch.ops.aten._local_scalar_dense, torch.ops.aten.is_nonzero,
             torch.ops.aten.item, torch.ops.aten.nonzero)
    count = {"ops": 0, "views": 0, "host reads": 0}
    paused = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not paused[0]:
                count["ops"] += 1
                count["views"] += func.is_view
                count["host reads"] += func.overloadpacket in reads
            return func(*args, **(kwargs or {}))

    def wrapped(module, name, wrap):
        fn = getattr(module, name)
        setattr(module, name, lambda *a, **kw: wrap(fn, *a, **kw))

    def counted(fn, *a, **kw):
        with Count():
            return fn(*a, **kw)

    def left_out(fn, *a, **kw):
        paused[0] += 1
        try:
            return fn(*a, **kw)
        finally:
            paused[0] -= 1

    describe = batched._describe_octaves
    if args.stage == "tail":
        module = detect
        name = "refine_tail" if hasattr(detect, "refine_tail") else "_tail_all_octaves"
    else:
        module, name = batched, "_describe_octaves"
        for hist in ("orientation_hist_octaves", "descriptor_lanes", "orient_desc_lanes"):
            wrapped(batched, hist, left_out)
    wrapped(module, name, counted)
    cfg = SiftConfig()
    b, h, w = args.batch, args.height, args.width
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0, 1, (b, h, w)).astype(np.float32)).to(args.device)
    extract_gray_batch(x, cfg, cfg.num_octaves(h, w))
    print(f"[tail_ops] {pathlib.Path(module.__file__).resolve()}: {count['ops']} ops dispatched "
          f"in {name}, {count['ops'] - count['views']} of them not views, {count['host reads']} "
          f"host reads ({b}x{h}x{w} noise, parity, {x.device})")
    if args.stage == "describe" and x.device.type == "cuda":
        kernels, other = _replayed(batched, detect, describe, x, cfg)
        print(f"[tail_ops] one replay of {name} captured alone: {kernels} device kernels, "
              f"{other} copies and fills ({torch.cuda.get_device_name(x.device)})")
    return 0


def _replayed(batched, detect, describe, x, cfg):
    """Device kernels, and other device activities, of one replay of the
    describe stage on ``x``'s pyramid and detection, captured alone."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from siftmetal_tpu_torch.graphs import GraphCache

    gaussians, dogs = batched.build_pyramid_batch(x, cfg, cfg.num_octaves(*x.shape[-2:]))
    per_octave, _ = detect.detect_all_octaves_batch(dogs, cfg)
    cache = GraphCache(lambda steps, *a: steps.stage(describe, *a), "describe")
    cache(gaussians, dogs, per_octave, cfg)
    plan = next(iter(cache.graphs.values())).plan
    counts = []
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for graph, n in plan:
                for _ in range(n):
                    graph.replay()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        other = sum(e.name.startswith(("Memcpy", "Memset")) for e in dev)
        counts.append((len(dev) - other, other))
    return max(counts)


if __name__ == "__main__":
    sys.exit(main())
