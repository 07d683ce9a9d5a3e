#!/usr/bin/env python3
"""Count the PyTorch ops that the cross-octave refinement tail dispatches.

    python3 scripts/tail_ops.py [--package-root DIR] [--device cpu|cuda]
                                [--batch B] [--height H] [--width W]

``extract_gray_batch`` of B seeded HxW noise frames (default 8x240x320)
in the parity configuration on the device, for the ``siftmetal_tpu_torch``
under ``--package-root`` (default: this checkout); prints the ops
dispatched inside the tree's tail (a ``TorchDispatchMode`` around
``sift/detect.py`` ``refine_tail`` where the tree has it, else around
``_tail_all_octaves``), how many of them are not views, and how many read
a value back to the host. On the CPU the tail is the plain PyTorch one;
on a card each op that is not a view is a launch or more (the hand-written
tail kernel's own launch goes through ctypes and is not an op), so two
trees' counts predict how their device op counts and host dispatch
compare.
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
    from siftmetal_tpu_torch.sift import detect
    from siftmetal_tpu_torch.sift.batched import extract_gray_batch

    reads = (torch.ops.aten._local_scalar_dense, torch.ops.aten.is_nonzero,
             torch.ops.aten.item, torch.ops.aten.nonzero)
    count = {"ops": 0, "views": 0, "host reads": 0}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            count["ops"] += 1
            count["views"] += func.is_view
            count["host reads"] += func.overloadpacket in reads
            return func(*args, **(kwargs or {}))

    name = "refine_tail" if hasattr(detect, "refine_tail") else "_tail_all_octaves"
    tail = getattr(detect, name)

    def counted(*a, **kw):
        with Count():
            return tail(*a, **kw)

    setattr(detect, name, counted)
    cfg = SiftConfig()
    b, h, w = args.batch, args.height, args.width
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0, 1, (b, h, w)).astype(np.float32)).to(args.device)
    extract_gray_batch(x, cfg, cfg.num_octaves(h, w))
    print(f"[tail_ops] {pathlib.Path(detect.__file__).resolve()}: {count['ops']} ops dispatched "
          f"in {name}, {count['ops'] - count['views']} of them not views, {count['host reads']} "
          f"host reads ({b}x{h}x{w} noise, parity, {x.device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
