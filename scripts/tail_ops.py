#!/usr/bin/env python3
"""Count the PyTorch ops that the cross-octave refinement tail dispatches.

    python3 scripts/tail_ops.py [--package-root DIR]

``extract_gray_batch`` of 8 seeded 240x320 noise frames in the parity
configuration on the CPU, for the ``siftmetal_tpu_torch`` under
``--package-root`` (default: this checkout); prints the ops dispatched
inside ``sift/detect.py`` ``_tail_all_octaves`` (a ``TorchDispatchMode``)
and how many of them read a value back to the host. On a card each op is
a launch or more, so two trees' counts predict how their device op
counts and host dispatch compare.
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
    package_root = pathlib.Path(ap.parse_args().package_root).resolve()
    sys.path.insert(0, str(package_root))
    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from siftmetal_tpu_torch import SiftConfig
    from siftmetal_tpu_torch.sift import detect
    from siftmetal_tpu_torch.sift.batched import extract_gray_batch

    reads = (torch.ops.aten._local_scalar_dense, torch.ops.aten.is_nonzero,
             torch.ops.aten.item, torch.ops.aten.nonzero)
    count = {"ops": 0, "host reads": 0}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            count["ops"] += 1
            count["host reads"] += func.overloadpacket in reads
            return func(*args, **(kwargs or {}))

    tail = detect._tail_all_octaves

    def counted(*args, **kwargs):
        with Count():
            return tail(*args, **kwargs)

    detect._tail_all_octaves = counted
    cfg = SiftConfig()
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (8, 240, 320)).astype(np.float32))
    extract_gray_batch(x, cfg, cfg.num_octaves(240, 320))
    print(f"[tail_ops] {pathlib.Path(detect.__file__).resolve()}: {count['ops']} ops dispatched "
          f"in _tail_all_octaves, {count['host reads']} of them host reads (8x240x320 noise, parity, CPU)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
