"""The port's tracer (``utils/profiling.py``) and the spans at its layer
boundaries.

On the CPU: off, a span is one shared no-op and nothing is kept; on,
spans nest with their parents and call ids, counters add up and
``drain`` clears; the facade, ``extract_gray_batch`` and RANSAC record
their spans, and give the same bits with the tracer on and off; the graph
cache keys a call by the tracer's state, unless its program has no named
stage. On the card (``-m cuda``): the traced replay is one graph a stage,
timed by events, and equals the untraced replay, which stays one graph; a
program without a named stage is captured once for both. No JAX here, so on
a machine without it the card's cases run as

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_tracing.py
"""

import numpy as np
import pytest
import torch

from siftmetal_tpu_torch import SIFT, SiftConfig, extract_gray_batch
from siftmetal_tpu_torch.geometry import find_homography
from siftmetal_tpu_torch.graphs import EAGER, GraphCache
from siftmetal_tpu_torch.utils import profiling as P
from torch_bits import assert_same_bits

torch.set_num_threads(2)

STAGES = ["sift.pyramid", "sift.detect", "sift.describe", "sift.compact"]
CFG = SiftConfig()


@pytest.fixture(autouse=True)
def _empty_tracer():
    P.drain()
    yield
    P.drain()


def _frames(b=2, h=96, w=128, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0.0, 1.0, (b, h, w)).astype(np.float32))


def _names(drained):
    return [s.name for s in drained.spans]


def test_off_span_is_one_shared_object_and_keeps_nothing():
    assert not P.enabled()
    a, b = P.span("x"), P.span("y", device=torch.device("cpu"))
    assert a is b
    with a:
        with P.span("z"):
            P.count("n", 3)
    d = P.drain()
    assert d.spans == [] and d.counters == {}


def test_spans_nest_with_parents_and_call_ids_and_drain_clears():
    with P.tracing():
        assert P.enabled()
        with P.span("call"):
            with P.span("a"):
                with P.span("a.inner"):
                    pass
            with P.span("b"):
                pass
        with P.span("next"):
            pass
        d = P.drain()
    assert not P.enabled()
    assert _names(d) == ["call", "a", "a.inner", "b", "next"]
    assert [s.id for s in d.spans] == [0, 1, 2, 3, 4]
    assert [s.parent for s in d.spans] == [None, 0, 1, 0, None]
    assert [s.call for s in d.spans] == [0, 0, 0, 0, 4]
    call, a, inner = d.spans[:3]
    assert call.host_start_ns <= a.host_start_ns <= inner.host_start_ns
    assert inner.host_end_ns <= a.host_end_ns <= call.host_end_ns
    assert all(s.host_ms >= 0.0 and s.device_ms is None for s in d.spans)
    assert P.drain().spans == []


def test_counters_add_up_and_drain_clears_them():
    with P.tracing():
        P.count("graphs.captures")
        P.count("graphs.captures", 2)
        P.count("other", 5)
        assert P.drain().counters == {"graphs.captures": 3, "other": 5}
        assert P.drain().counters == {}


def test_drain_inside_an_open_span_raises_and_tracing_nests():
    with P.tracing():
        with P.tracing(False):
            assert not P.enabled()
        assert P.enabled()
        with P.span("open"):
            with pytest.raises(RuntimeError, match="open"):
                P.drain()
    assert _names(P.drain()) == ["open"]


def test_spans_are_profiler_ranges_only_under_a_profiler():
    from torch.profiler import ProfilerActivity, profile

    with P.tracing():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with P.span("traced.range"):
                torch.ones(3).sum()
        with P.span("unprofiled"):
            assert not torch.autograd._profiler_enabled()
    assert "traced.range" in [e.name for e in prof.events()]
    assert _names(P.drain()) == ["traced.range", "unprofiled"]


def test_cpu_facade_records_extract_with_four_stages_bit_equal():
    sift = SIFT(96, 128, CFG, device="cpu")
    x = _frames()
    off = sift.extract_batch(x)
    with P.tracing():
        on = sift.extract_batch(x)
        d = P.drain()
    assert_same_bits(on, off)
    (top,) = [s for s in d.spans if s.parent is None]
    assert top.name == "sift.extract" and top.device_ms is None
    children = [s.name for s in d.spans if s.parent == top.id]
    assert children == STAGES
    assert all(s.call == top.id for s in d.spans)
    ends = [s.host_end_ns for s in d.spans if s.name in STAGES]
    starts = [s.host_start_ns for s in d.spans if s.name in STAGES]
    assert all(e <= s for e, s in zip(ends, starts[1:]))
    assert d.counters == {}


def test_direct_call_records_the_four_stages_as_host_spans():
    x = _frames(b=1, seed=1)
    n_oct = CFG.num_octaves(96, 128)
    off = extract_gray_batch(x, CFG, n_oct)
    with P.tracing():
        on = extract_gray_batch(x, CFG, n_oct, EAGER)
        d = P.drain()
    assert_same_bits(on, off)
    assert _names(d) == STAGES
    assert [s.parent for s in d.spans] == [None] * 4


def test_graph_cache_key_holds_the_tracer_state():
    cache = GraphCache(lambda steps, x: steps.stage(torch.neg, x), "neg")
    x = torch.ones(3)
    off = cache.key(x)
    with P.tracing():
        on = cache.key(x)
    assert off != on and off._replace(traced=True) == on
    assert not off.traced and on.traced


def test_named_stage_of_an_eager_program_is_a_host_span():
    cache = GraphCache(lambda steps, x: steps.stage(torch.neg, steps.stage(torch.exp, x),
                                                    name="neg"), "neg of exp")
    x = torch.arange(4.0)
    with P.tracing():
        got = cache(x)
        d = P.drain()
    assert torch.equal(got, -torch.exp(x))
    assert _names(d) == ["neg"]


def _correspondences(n=300, seed=3):
    g = torch.Generator().manual_seed(seed)
    src = torch.rand((n, 2), generator=g) * torch.tensor([480.0, 640.0])
    h = torch.tensor([[1.02, 0.05, 3.0], [-0.04, 0.98, -2.0], [1e-5, -2e-5, 1.0]])
    p = torch.cat([src, torch.ones(n, 1)], 1) @ h.T
    dst = p[:, :2] / p[:, 2:]
    dst[: n // 4] += torch.rand((n // 4, 2), generator=g) * 50.0
    valid = torch.ones(n, dtype=torch.bool)
    valid[-10:] = False
    return src, dst, valid


def test_find_homography_records_geometry_with_two_svds_bit_equal():
    src, dst, valid = _correspondences()
    off = find_homography(torch.Generator().manual_seed(9), src, dst, valid)
    with P.tracing():
        on = find_homography(torch.Generator().manual_seed(9), src, dst, valid)
        d = P.drain()
    for a, b in zip(on, off):
        assert torch.equal(a, b)
    assert _names(d) == ["geometry", "twoview.svd", "twoview.svd"]
    geo = d.spans[0]
    assert [s.parent for s in d.spans[1:]] == [geo.id, geo.id]
    assert geo.host_ms >= sum(s.host_ms for s in d.spans[1:])


def test_graph_cache_key_ignores_the_tracer_for_a_program_without_named_stages():
    """Once a capture has shown the program names no stage (``named``
    False), a traced call has the untraced key: one program serves both.
    Before any capture, and for a program with named stages, the key
    holds the tracer's state."""
    cache = GraphCache(lambda steps, x: steps.stage(torch.neg, x), "neg")
    x = torch.ones(3)
    off = cache.key(x)
    for named, split in [(None, True), (True, True), (False, False)]:
        cache.named = named
        with P.tracing():
            assert (cache.key(x) != off) is split
        assert cache.key(x) == off


# --- on the card -------------------------------------------------------------------------


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the traced replay times CUDA graphs with CUDA events)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_traced_replay_times_each_stage_and_equals_the_untraced(cuda_dev):
    """Off: one graph a batch size, no name. On: the same batch replayed as
    one graph a stage, each inside its device span, bit-equal; the stages
    lie inside the call's span and are counted as one capture."""
    sift = SIFT(240, 320, CFG, device=cuda_dev)
    x = _frames(b=2, h=240, w=320, seed=5).to(cuda_dev)
    off = sift.extract_batch(x)
    off2 = sift.extract_batch(x)
    with P.tracing():
        first = sift.extract_batch(x)
        warm = P.drain()
        on = sift.extract_batch(x)
        d = P.drain()
    assert_same_bits(off2, off)
    assert_same_bits(first, off)
    assert_same_bits(on, off)
    assert warm.counters == {"graphs.captures": 1}
    (prog,) = sift._graphs.values()
    assert len(prog.plan) == 1 and prog.names == (None,)
    traced = [p for k, p in sift._cache.graphs.items() if k.traced]
    assert len(traced) == 1 and list(traced[0].names) == STAGES
    assert d.counters == {}
    by = {s.name: s for s in d.spans}
    top = by["sift.extract"]
    assert [s.name for s in d.spans if s.parent == top.id] == STAGES
    stages = [by[n] for n in STAGES]
    assert all(s.device_ms > 0.0 for s in stages)
    assert top.device_start_ms <= stages[0].device_start_ms
    assert stages[-1].device_end_ms <= top.device_end_ms
    assert sum(s.device_ms for s in stages) <= top.device_ms


@pytest.mark.cuda
def test_program_without_named_stages_is_captured_once_for_both(cuda_dev):
    cache = GraphCache(lambda steps, x: steps.stage(torch.neg, steps.stage(torch.exp, x)),
                       "neg of exp")
    x = torch.arange(4.0, device=cuda_dev)
    off = cache(x)
    with P.tracing():
        on = cache(x)
        d = P.drain()
    assert torch.equal(on, off) and torch.equal(off, -torch.exp(x))
    assert cache.named is False and d.counters == {} and d.spans == []
    (key,) = cache.graphs
    assert not key.traced


@pytest.mark.cuda
def test_device_span_inside_a_capture_raises(cuda_dev):
    graph = torch.cuda.CUDAGraph()
    x = torch.ones(4, device=cuda_dev)
    with P.tracing():
        with pytest.raises(RuntimeError, match="capture"):
            with torch.cuda.graph(graph):
                with P.span("inside", device=cuda_dev):
                    x.add_(1)
    P.drain()
