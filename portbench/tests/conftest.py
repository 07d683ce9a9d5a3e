"""The benchmark's tests import it as ``portbench`` from the checkout's
root; small cells for the CPU."""

import pathlib
import sys

import pytest
import torch

# Several test workers share the CPU: a few threads each.
torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def small_cell(name, **traffic):
    """Cell ``name`` at 96x128 with small budgets, for the CPU."""
    from portbench.harness import spec

    cell = spec.resolve(spec.load_benchmark(), name)
    sift = dict(cell.config["sift"], max_keypoints=512, max_descriptors=768)
    return cell._replace(config=dict(cell.config, height=96, width=128, sift=sift),
                         traffic=dict(cell.traffic, **traffic))


SMALL = {
    "ipol_vga.batch8": dict(pool=8, batch=2, check_frames=3, traced_calls=2),
    "ipol_vga.stream1": dict(pool=4, check_frames=2, traced_calls=2),
    "ipol_vga.pairs": dict(references=2, check_pairs=6, traced_calls=2),
}


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
