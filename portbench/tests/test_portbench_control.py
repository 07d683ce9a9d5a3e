"""The precision control comes out not correct: the port's bf16 blur chain
against the fp32 reference (extraction), the reference with TF32 on
(pairs, on a card: the CPU has no TF32)."""

import pytest

from portbench import calibrate
from portbench.harness import spec
from portbench.tests.conftest import SMALL, small_cell


def _limits_failed(cell, readings):
    return [k for k, limit in cell.traffic["limits"].items() if readings[k] > limit]


@pytest.mark.parametrize("name", ["ipol_vga.batch8", "ipol_vga.stream1"])
def test_extract_control_fails_on_cpu(name):
    cell = small_cell(name, **dict(SMALL[name], check_frames=SMALL[name]["pool"]))
    sound = calibrate.readings(cell, 2 ** 31 + 3, 0.2, False, device="cpu")
    control = calibrate.readings(cell, 2 ** 31 + 3, 0.2, True, device="cpu")
    assert not _limits_failed(cell, sound["readings"])
    assert _limits_failed(cell, control["readings"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ipol_vga.batch8", "ipol_vga.pairs"])
def test_control_fails_on_the_card(name, cuda_card):
    # Pairs at the cell's own size: small frames give too few accepted pairs.
    cell = spec.resolve(spec.load_benchmark(), name) if name.endswith("pairs") else \
        small_cell(name, **dict(SMALL[name], check_frames=SMALL[name]["pool"]))
    for seed in (11, 12, 13):
        control = calibrate.readings(cell, seed, 0.5, True)
        assert _limits_failed(cell, control["readings"]), control
