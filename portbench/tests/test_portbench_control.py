"""The precision control comes out not correct: the port's bf16 blur chain
against the fp32 reference (extraction), the reference with TF32 on
(pairs, on a card: the CPU has no TF32)."""

import pytest

from portbench import calibrate
from portbench.harness import spec
from portbench.tests.conftest import cells_of_kind, small_cell


def _limits_failed(cell, readings):
    return [k for k, limit in cell.traffic["limits"].items() if readings[k] > limit]


def _every_frame_checked(name):
    cell = small_cell(name)
    return small_cell(name, check_frames=cell.traffic["pool"])


@pytest.mark.parametrize("name", cells_of_kind("extract"))
def test_extract_control_fails_on_cpu(name):
    cell = _every_frame_checked(name)
    sound = calibrate.readings(cell, 2 ** 31 + 3, 0.2, "program", device="cpu")
    control = calibrate.readings(cell, 2 ** 31 + 3, 0.2, "control", device="cpu")
    assert sound["side"] == "program" and control["side"] == "control"
    assert not _limits_failed(cell, sound["readings"])
    assert _limits_failed(cell, control["readings"])


@pytest.mark.parametrize("name", cells_of_kind("extract"))
def test_extract_has_no_planted_fault(name):
    with pytest.raises(ValueError, match="no planted fault"):
        calibrate.readings(small_cell(name), 2 ** 31 + 3, 0.2, "fault", device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ipol_vga.batch8", "ipol_vga.pairs"])
def test_control_fails_on_the_card(name, cuda_card):
    # Pairs at the cell's own size: small frames give too few accepted pairs.
    cell = spec.resolve(spec.load_benchmark(), name) if name.endswith("pairs") else \
        _every_frame_checked(name)
    for seed in (11, 12, 13):
        control = calibrate.readings(cell, seed, 0.5, "control")
        assert _limits_failed(cell, control["readings"]), control
