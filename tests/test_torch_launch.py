"""How the port's kernel wrappers launch, checked on the CPU: each launch
runs inside the device guard of its tensor, a library is rebuilt when its
nvcc command changes, and the resident-tile CPU route takes any lane mask
the staged route takes."""

import contextlib
import pathlib

import numpy as np
import pytest
import torch

from siftmetal_tpu_torch.config import SiftConfig
from siftmetal_tpu_torch.ops import cuda as C
from siftmetal_tpu_torch.ops import kernels as K
from siftmetal_tpu_torch.ops.kernels import blur as KB
from siftmetal_tpu_torch.ops.kernels import cascade as KC
from siftmetal_tpu_torch.ops.kernels import detect as KD
from siftmetal_tpu_torch.ops.kernels import patches as KP
from siftmetal_tpu_torch.ops.kernels import pyramid as KY

torch.set_num_threads(2)

CFG = SiftConfig()
BAND = SiftConfig(use_band_patches=True)


@pytest.fixture
def recorded(monkeypatch):
    """Every wrapper takes its kernel route on CPU tensors, against a
    library whose entry points record the guard they run under, and a
    guard that records the tensor it was entered with."""
    events = []
    guard = []

    @contextlib.contextmanager
    def launch_on(t):
        events.append(("enter", t.device))
        guard.append(t.device)
        try:
            yield 0
        finally:
            guard.pop()

    class Library:
        def __init__(self, name):
            self.name = name

        def __getattr__(self, fn):
            def launch(*args):
                events.append(("launch", fn, guard[-1] if guard else None))
                return 0
            return launch

    monkeypatch.setattr(C, "launch_on", launch_on)
    monkeypatch.setattr(C, "library", Library)
    for mod in (KY, KB, KC, KD, KP):
        monkeypatch.setattr(mod, "use_kernel", lambda t, name: True)
    return events


def _lanes(n=6):
    rng = np.random.default_rng(0)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return (torch.ones((n,), dtype=torch.int32), f(rng.uniform(4, 28, n)),
            f(rng.uniform(4, 28, n)), f(rng.uniform(1.0, 2.0, n)))


WRAPPERS = {
    "seed_octave": lambda: KY.seed_octave(torch.zeros((1, 170, 250)), CFG),
    "octave_oneshot": lambda: KY.octave_oneshot(torch.zeros((1, 176, 200)), CFG),
    "blur_stack": lambda: KB.blur_stack(torch.zeros((2, 20, 30)), 1.6),
    "blur_cascade": lambda: KB.blur_cascade(torch.zeros((2, 20, 30)), CFG.incremental_sigmas(3),
                                            False),
    "octave_cascade": lambda: KC.octave_cascade(torch.zeros((1, 64, 64)), CFG),
    "detect_candidates": lambda: KD.detect_candidates(torch.zeros((1, 5, 16, 16)), 0.01, 10.0),
    "detect_candidates_lean": lambda: KD.detect_candidates(
        torch.zeros((1, 5, 16, 16)), 0.01, 10.0, emit_fields=False),
    "orientation_hist": lambda: KP.orientation_hist_lanes(
        KP.PatchFields(torch.zeros((1, 3, 32, 32)), torch.zeros((1, 3, 32, 32))), *_lanes(), CFG),
    "descriptor_hist": lambda: KP.descriptor_lanes(
        KP.PatchFields(torch.zeros((1, 3, 32, 32)), torch.zeros((1, 3, 32, 32))), *_lanes(),
        torch.zeros((6,)), CFG),
    "orient_desc": lambda: KP.orient_desc_lanes(
        KP.PatchFields(torch.zeros((1, 3, 32, 32)), torch.zeros((1, 3, 32, 32))), *_lanes(), CFG),
    "orientation_hist_banded": lambda: KP.orientation_hist_lanes(
        KP.PatchFields(torch.zeros((1, 3, 32, 32)), torch.zeros((1, 3, 32, 32))), *_lanes(), BAND),
    "descriptor_hist_banded": lambda: KP.descriptor_lanes(
        KP.PatchFields(torch.zeros((1, 3, 32, 32)), torch.zeros((1, 3, 32, 32))), *_lanes(),
        torch.zeros((6,)), BAND),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_every_launch_runs_under_its_tensors_device(recorded, name):
    """Each wrapper enters the guard with a tensor on its input's device
    before its first launch, launches only inside it, and counts the
    launch under its own name."""
    before = dict(K.LAUNCHES)
    WRAPPERS[name]()
    launches = [e for e in recorded if e[0] == "launch"]
    assert launches and recorded[0][0] == "enter", recorded
    assert all(e[2] == torch.device("cpu") for e in launches), recorded
    assert all(e[1] == torch.device("cpu") for e in recorded if e[0] == "enter")
    grew = {k for k in K.LAUNCHES if K.LAUNCHES[k] != before[k]}
    assert grew == {name}, grew


def test_guard_makes_the_tensors_device_current(monkeypatch):
    """``launch_on`` enters ``torch.cuda.device`` of its tensor and yields
    that device's stream."""
    seen = []

    @contextlib.contextmanager
    def device(d):
        seen.append(("device", d))
        yield

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(C, "stream_of", lambda t: seen.append(("stream", t.device)) or 7)
    t = torch.zeros(1)
    with C.launch_on(t) as stream:
        assert stream == 7
    assert seen == [("device", t.device), ("stream", t.device)]


def _fake_build(tmp_path, monkeypatch):
    monkeypatch.setattr(C, "BUILD_DIR", tmp_path)
    for name in C.SIGNATURES:
        C._lib_path(name).write_bytes(b"")
        C._stamp_path(name).write_text(C._stamp(name))


def test_library_rebuilds_when_its_nvcc_flags_change(tmp_path, monkeypatch):
    """A library newer than its sources with a stamp of today's command is
    current; another EXTRA_FLAGS, or a missing stamp, makes it stale."""
    _fake_build(tmp_path, monkeypatch)
    assert not any(C._stale(n) for n in C.SIGNATURES)
    monkeypatch.setitem(C.EXTRA_FLAGS, "detect", ("-fmad=true",))
    assert C._stale("detect") and not C._stale("pyramid")
    monkeypatch.setitem(C.EXTRA_FLAGS, "pyramid", ("-lineinfo",))
    assert C._stale("pyramid")
    C._stamp_path("cascade").unlink()
    assert C._stale("cascade")


def test_library_rebuilds_when_a_header_is_newer(tmp_path, monkeypatch):
    """A library older than a shared header of csrc/ is stale."""
    import os

    _fake_build(tmp_path, monkeypatch)
    header = max(pathlib.Path(C.CSRC).glob("*.cuh"), key=lambda p: p.stat().st_mtime)
    old = header.stat().st_mtime - 10.0
    os.utime(C._lib_path("patches"), (old, old))
    assert C._stale("patches")


@pytest.mark.parametrize("stage", ["orientation", "descriptor"])
def test_resident_route_takes_an_int_lane_mask(stage):
    """Under ``use_band_patches`` on the CPU an int32 lane mask gives the
    same rows as the bool mask (the staged route and the CUDA route take
    both)."""
    rng = np.random.default_rng(4)
    g = lambda: torch.from_numpy(rng.normal(0, 0.1, (2, 3, 40, 48)).astype(np.float32))
    fields = KP.PatchFields(g(), g())
    n = 12
    scale = torch.from_numpy(rng.integers(1, 4, n).astype(np.int32))
    x = torch.from_numpy(rng.uniform(2, 38, n).astype(np.float32))
    y = torch.from_numpy(rng.uniform(2, 46, n).astype(np.float32))
    sig = torch.from_numpy(rng.uniform(1.0, 2.5, n).astype(np.float32))
    frame = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32))
    mask = rng.uniform(size=n) > 0.3
    if stage == "orientation":
        run = lambda v: KP.orientation_hist_lanes(fields, scale, x, y, sig, BAND, valid=v,
                                                  frame=frame)
    else:
        th = torch.from_numpy(rng.uniform(-3, 3, n).astype(np.float32))
        run = lambda v: KP.descriptor_lanes(fields, scale, x, y, sig, th, BAND, valid=v,
                                            frame=frame)
    want = run(torch.from_numpy(mask))
    got = run(torch.from_numpy(mask.astype(np.int32)))
    assert torch.equal(got, want)
    assert want[torch.from_numpy(mask)].abs().sum() > 0
