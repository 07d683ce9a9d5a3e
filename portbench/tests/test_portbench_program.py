"""The program slice (``harness/program.py``) and the readers of its spans:
the readers on synthetic spans, the slice of each small cell on the CPU
and its JSON form, the guards (no tracer or no cell named: no slice; a
capture after the warm-up: raised; a child that fails: raised with its
errors), and on a card the traced replay against the untraced one."""

import functools
import math
import sys

import pytest
import torch

from portbench.harness import program, spec
from portbench.harness.trace import Trace
from portbench.tests.conftest import WORKLOADS, cells_of_kind, small_cell
from siftmetal_tpu_torch.utils.profiling import Span

STAGES = ["sift.pyramid", "sift.detect", "sift.describe", "sift.compact"]
EXTRACT = ["sift.pyramid_ms", "sift.detect_ms", "sift.describe_ms", "sift.compact_ms",
           "sift.io_ms", "sift.device_idle_pct"]
PAIRS = ["geometry.wait_ms", "geometry.dispatch_ms"]


def _trace(sl, context=None):
    tr = Trace([], 1.0, 1, 1, {}, context or {})
    tr.program = sl
    return tr


def _read(name, tr):
    return spec.load_reader(name)(tr)


class _Spans:
    """Builds spans in the order they open, ids their places."""

    def __init__(self):
        self.spans = []

    def add(self, name, parent, call, host=(0, 0), dev=(None, None)):
        s = Span(name, len(self.spans), parent, call, host[0], host[1], *dev)
        self.spans.append(s)
        return s.id


def _extract_slice(batch=2):
    """Two calls: call 0 over device ms [0, 10], its stages 1+2+3+1 ms from
    1.0; call 1 over [12, 20], stages 2+2+2+1 from 12.5. Idle 2 of 20 ms."""
    b = _Spans()
    for start, end, ms in [(0.0, 10.0, [1, 2, 3, 1]), (12.0, 20.0, [2, 2, 2, 1])]:
        top = b.add("sift.extract", None, len(b.spans), dev=(start, end))
        t = start + 1.0 if start == 0.0 else start + 0.5
        for name, d in zip(STAGES, ms):
            b.add(name, top, top, dev=(t, t + d))
            t += d
    return program.Slice(b.spans, {}, 2, 2 * batch, 0.02)


def test_extract_readers_on_synthetic_spans():
    tr = _trace(_extract_slice())
    # Medians of two calls, over the batch of 2.
    assert _read("sift.pyramid_ms", tr) == pytest.approx(1.5 / 2)
    assert _read("sift.detect_ms", tr) == pytest.approx(2.0 / 2)
    assert _read("sift.describe_ms", tr) == pytest.approx(2.5 / 2)
    assert _read("sift.compact_ms", tr) == pytest.approx(1.0 / 2)
    # io: 10 - 7 and 8 - 7.
    assert _read("sift.io_ms", tr) == pytest.approx(2.0 / 2)
    assert _read("sift.device_idle_pct", tr) == pytest.approx(100.0 * 2.0 / 20.0)
    stages = sum(_read(n, tr) for n in EXTRACT[:5])
    assert stages == pytest.approx((10.0 + 8.0) / 2 / 2)


def test_idle_share_takes_the_union_of_overlapping_calls():
    b = _Spans()
    for start, end in [(0.0, 6.0), (4.0, 10.0), (14.0, 16.0)]:
        b.add("sift.extract", None, len(b.spans), dev=(start, end))
    tr = _trace(program.Slice(b.spans, {}, 3, 3, 0.02))
    assert _read("sift.device_idle_pct", tr) == pytest.approx(100.0 * 4.0 / 16.0)


def test_pair_readers_on_synthetic_spans():
    """Three pairs: geometry host ms 5, 7, 9 with SVD waits 1+2, 1+1, 3+3
    (one under a nested span); an SVD outside ``geometry`` is no part of
    either."""
    b = _Spans()
    ms = 1_000_000
    for total, waits in [(5, [1, 2]), (7, [1, 1]), (9, [3, 3])]:
        m = b.add("outside", None, len(b.spans), host=(0, 4 * ms))
        b.add("twoview.svd", m, m, host=(0, 50 * ms))
        g = b.add("geometry", None, len(b.spans), host=(0, total * ms))
        inner = b.add("solver", g, g)
        for k, w in enumerate(waits):
            b.add("twoview.svd", inner if k else g, g, host=(0, w * ms))
    tr = _trace(program.Slice(b.spans, {}, 3, 3, 0.03))
    assert _read("geometry.wait_ms", tr) == pytest.approx(3.0)
    assert _read("geometry.dispatch_ms", tr) == pytest.approx(3.0)


@pytest.mark.parametrize("name", EXTRACT + PAIRS)
def test_readers_read_nothing_without_a_slice(name, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["run.py"])
    assert _read(name, _trace(None)) is None
    tr = Trace([], 1.0, 1, 1, {}, {"config": {}, "device_name": "cpu"})
    assert _read(name, tr) is None and tr.program is None
    empty = _trace(program.Slice([], {}, 0, 0, 0.0))
    assert _read(name, empty) is None


def test_no_slice_for_another_cell_or_a_program_without_the_tracer(monkeypatch):
    made = []
    monkeypatch.setattr(program, "run_slice", lambda *a: made.append(a) or "slice")
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", "ipol_vga.batch8", "--seed", "7"])
    cell = spec.resolve(spec.load_benchmark(), "ipol_vga.batch8")
    other = Trace([], 1.0, 1, 1, {}, {"config": dict(cell.config, height=1), "device_name": "cpu"})
    assert program.of(other) is None
    same = Trace([], 1.0, 1, 1, {}, {"config": cell.config, "device_name": "cpu"})
    assert program.of(same) == "slice" and program.of(same) == "slice"
    assert made == [(cell, 7, "cpu")]
    children = []
    monkeypatch.setattr(program, "in_child", lambda *a: children.append(a) or "child")
    card = Trace([], 1.0, 1, 1, {}, {"config": cell.config, "device_name": "NVIDIA H100"})
    assert program.of(card) == "child" and children == [("ipol_vga.batch8", 7)]
    assert made == [(cell, 7, "cpu")]
    monkeypatch.setattr(program, "_tracer", lambda: None)
    assert program.of(Trace([], 1.0, 1, 1, {}, {"config": cell.config})) is None


@functools.cache
def _small_slice(name):
    """The program slice of the small cell ``name`` on the CPU, made once
    a test process for the generic and the kind's tests."""
    return program.run_slice(small_cell(name), 2 ** 31 + 17, "cpu", seconds=1e-3)


@pytest.mark.parametrize("name", WORKLOADS)
def test_slice_of_each_small_cell_on_the_cpu(name):
    sl = _small_slice(name)
    assert 1 <= sl.calls <= sl.items
    assert "graphs.captures" not in sl.counters and sl.wall_s > 0.0
    assert program.from_json(program.to_json(sl)) == sl
    for s in sl.spans:
        assert 0 <= s.call < len(sl.spans) and (s.parent is None or s.parent < s.id)


@pytest.mark.parametrize("name", cells_of_kind("extract"))
def test_extract_slice_spans(name):
    sl = _small_slice(name)
    n = sl.calls
    assert sl.items == n * int(small_cell(name).traffic["batch"]) and sl.counters == {}
    tops = [s for s in sl.spans if s.parent is None]
    assert [s.name for s in tops] == ["sift.extract"] * n
    for top in tops:
        assert [s.name for s in sl.spans if s.parent == top.id] == STAGES
    # The CPU has no device times: the device readers read nothing.
    assert all(_read(m, _trace(sl)) is None for m in EXTRACT)


@pytest.mark.parametrize("name", cells_of_kind("pairs"))
def test_pair_slice_spans(name):
    sl = _small_slice(name)
    n = sl.calls
    assert sl.items == n and sl.counters == {}
    assert [s.name for s in sl.spans] == ["geometry", "twoview.svd", "twoview.svd"] * n
    tr = _trace(sl)
    for m in PAIRS:
        assert math.isfinite(_read(m, tr)) and _read(m, tr) >= 0.0


def test_a_capture_after_the_warm_up_raises():
    from siftmetal_tpu_torch.utils import profiling

    def window():
        profiling.count("graphs.captures")
        return 2, 2, 0.1

    loop = program.Loop(lambda: profiling.count("graphs.captures", 3), lambda s: window(), None)
    with pytest.raises(RuntimeError, match="captured 1 graph"):
        program.traced(loop, 0.1)
    assert not profiling.enabled()


def test_a_child_that_fails_raises_with_its_errors():
    with pytest.raises(RuntimeError, match="(?s)exited 1.*no-such-cell"):
        program.in_child("no-such-cell", 1)


@pytest.mark.cuda
def test_traced_replay_equals_the_untraced_one_for_a_batch(cuda_card):
    from portbench.harness.extract import sift_config
    from portbench.harness.frames import procedural_frames
    from siftmetal_tpu_torch import SIFT
    from siftmetal_tpu_torch.utils import profiling

    cell = spec.resolve(spec.load_benchmark(), "ipol_vga.batch8")
    h, w = cell.config["height"], cell.config["width"]
    sift = SIFT(h, w, config=sift_config(cell.config), device="cuda")
    frames = procedural_frames(8, h, w, 5, torch.device("cuda"))
    off = sift.extract_batch(frames)
    with profiling.tracing():
        sift.extract_batch(frames)
        profiling.drain()
        on = sift.extract_batch(frames)
        sl = profiling.drain()
    for a, b in zip([*off[0], *off[1], *off[2].values()], [*on[0], *on[1], *on[2].values()]):
        assert torch.equal(a, b)
    tr = _trace(program.Slice(sl.spans, sl.counters, 1, 8, 0.0))
    values = {m: _read(m, tr) for m in EXTRACT}
    assert all(math.isfinite(v) for v in values.values()), values
    extract_ms = [s.device_ms for s in sl.spans if s.name == "sift.extract"][0]
    assert sum(values[m] for m in EXTRACT[:5]) * 8 == pytest.approx(extract_ms)
