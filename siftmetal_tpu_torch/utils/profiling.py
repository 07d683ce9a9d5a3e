"""The port's tracer: spans and counters at its layer boundaries.

Off by default; ``with tracing():`` turns it on. Off, :func:`span`
returns one shared no-op context and :func:`count` does nothing, so a
traced boundary costs one module-global read. On:

* ``span(name)`` enters ``torch.profiler.record_function(name)`` while a
  profiler runs (it records the span on the clock of the device
  operations) and keeps a record in memory: its name, the span open
  around it, its call (the outermost span open: one facade call, one
  RANSAC call) and its host start and end
  (``time.perf_counter_ns``);
* ``span(name, device=d)`` with ``d`` a CUDA device also records a timing
  ``torch.cuda.Event`` on ``d``'s current stream at entry and at exit.
  Events cannot be recorded while a stream captures a CUDA graph: such a
  span raises there. On a CPU device it keeps host times only;
* ``count(name, n)`` adds ``n`` to a counter.

:func:`drain` synchronises, returns the closed spans (in the order they
opened) and the counters, and clears both. A device span's start and end
come back in ms from the first event of the drain window, so a reader
can take the union of spans across calls.

The port's spans (``sift/extract.py``, ``sift/batched.py``,
``graphs.py``, ``geometry/``, ``slam/ba.py``): ``sift.extract`` (device;
a facade call with its upload and output copies), ``sift.pyramid``,
``sift.detect``, ``sift.describe``, ``sift.compact`` (the four stages of
``extract_gray_batch``: device spans around their own graphs in a traced
replay, host spans when eager), ``geometry`` (``ransac``) and
``twoview.svd`` (the library SVD that synchronises), ``ba.prologue``,
``ba.iteration`` (one a pass of the LM loop) and ``ba.epilogue`` (the
bundle adjustment's program: device spans in a traced replay, host spans
when eager); the counters ``graphs.captures`` (programs captured),
``ba.solves`` (bundle adjustments run) and ``ba.pairs`` (the
same-landmark observation pairs of their Schur terms, counted by a
caller that holds the observations on the host: ``slam.ba.
landmark_pairs``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch

_on = False
_NOOP = contextlib.nullcontext()


class Span(NamedTuple):
    """A drained span. ``id`` is its place in the drain's list; ``parent``
    the id of the span open around it; ``call`` the id of the outermost
    span open at its start (its own id when it is the outermost). Device
    times are None for a host span."""

    name: str
    id: int
    parent: Optional[int]
    call: int
    host_start_ns: int
    host_end_ns: int
    device_start_ms: Optional[float]
    device_end_ms: Optional[float]

    @property
    def host_ms(self) -> float:
        return (self.host_end_ns - self.host_start_ns) * 1e-6

    @property
    def device_ms(self) -> Optional[float]:
        if self.device_start_ms is None:
            return None
        return self.device_end_ms - self.device_start_ms


class Drained(NamedTuple):
    spans: List[Span]
    counters: Dict[str, int]


class _Record:
    """An open or closed span before it is drained."""

    __slots__ = ("name", "id", "parent", "call", "t0", "t1", "device", "events", "profiled")

    def __init__(self, name: str, device):
        self.name = name
        self.device = device
        self.events = None

    def __enter__(self):
        if self.device is not None:
            self.events = (_event(self.device), None)
        st = _state
        self.id = len(st.records)
        self.parent = st.open[-1].id if st.open else None
        self.call = st.open[0].id if st.open else self.id
        st.records.append(self)
        st.open.append(self)
        # A range costs tens of µs on the host: entered only for a profiler.
        self.profiled = None
        if torch.autograd._profiler_enabled():
            self.profiled = torch.profiler.record_function(self.name)
            self.profiled.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events = (self.events[0], _event(self.device))
        _state.open.pop()
        if self.profiled is not None:
            self.profiled.__exit__(*exc)
        return False


class _State:
    def __init__(self):
        self.records: List[_Record] = []
        self.open: List[_Record] = []
        self.counters: Dict[str, int] = {}


_state = _State()


def _event(device: torch.device) -> torch.cuda.Event:
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a device span cannot record its events inside a CUDA graph capture")
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def enabled() -> bool:
    """Whether the tracer is on."""
    return _on


@contextlib.contextmanager
def tracing(on: bool = True) -> Iterator[None]:
    """The tracer on (or, with ``on=False``, off) inside the block."""
    global _on
    saved, _on = _on, on
    try:
        yield
    finally:
        _on = saved


def span(name: str, device=False):
    """A traced interval named ``name`` (see the module's docstring);
    ``device``: False, or the device whose current stream the span times
    (events on a CUDA device, host times only on any other)."""
    if not _on:
        return _NOOP
    dev = torch.device(device) if device is not False else None
    return _Record(name, dev if dev is not None and dev.type == "cuda" else None)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` while the tracer is on."""
    if _on:
        _state.counters[name] = _state.counters.get(name, 0) + n


def drain() -> Drained:
    """The spans closed and the counters kept since the last drain, with
    device times resolved; clears them. Raises inside an open span."""
    st = _state
    if st.open:
        raise RuntimeError(f"drain() inside the open span {st.open[-1].name!r}")
    timed = [r for r in st.records if r.events is not None]
    if timed:
        torch.cuda.synchronize()
    first = timed[0].events[0] if timed else None

    def ms(ev):
        return 0.0 if ev is first else first.elapsed_time(ev)

    spans = [
        Span(r.name, r.id, r.parent, r.call, r.t0, r.t1,
             *((ms(r.events[0]), ms(r.events[1])) if r.events is not None else (None, None)))
        for r in st.records
    ]
    out = Drained(spans, dict(st.counters))
    st.records.clear()
    st.counters.clear()
    return out
