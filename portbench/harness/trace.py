"""The traced slices: a bounded, steady run of calls under ``torch.profiler``
with the device alone, ended by a synchronise, reduced to device
operations, busy time and wall; then as many calls again with the host's
ranges too, for the idle gaps and what the host was doing in them."""

from __future__ import annotations

import re
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch


class Op(NamedTuple):
    name: str
    start_us: float
    dur_us: float


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


class Trace:
    """What the per-layer readers read. ``kernels`` are the device kernels
    of the slice, ``device_ops`` those with the copies and sets, both from
    the device-only slice whose wall is ``window_s``; ``named`` the device
    and host operations of a second slice of as many calls under the host
    profiler too, which names the idle gaps of ``breakdown``;
    ``spans`` the benchmark's own spans (ms, by name); ``calls`` the
    program calls and ``items`` the frames or pairs of one slice;
    ``context`` the cell's facts a reader needs (config, batch, outputs,
    device)."""

    def __init__(self, device_ops: List[Op], window_s: float, calls: int, items: int,
                 spans: Dict[str, List[float]], context: Dict,
                 named: Tuple[List[Op], List[Op]] = ([], [])):
        self.device_ops = sorted(device_ops, key=lambda o: o.start_us)
        self.kernels = [o for o in self.device_ops if not _is_copy(o.name)]
        self.window_s = window_s
        self.calls = calls
        self.items = items
        self.spans = spans
        self.context = context
        self.named_device_ops, self.host_ops = named
        self._intervals = _union([(o.start_us, o.start_us + o.dur_us) for o in self.device_ops])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._intervals) * 1e-6

    @property
    def idle_share(self) -> float:
        """1 - the device's busy time over the wall time of the same
        device-only slice, both ended by its synchronise. Busy time above
        the wall is a fault of the reading, raised, not read as 0."""
        share = 1.0 - self.busy_s / self.window_s
        if share < 0.0:
            raise ValueError(f"device busy {self.busy_s!r} s in a slice of {self.window_s!r} s of wall: "
                             "the trace's clock and the host's disagree")
        return share

    def kernel_seconds(self, patterns: Sequence[str]) -> float:
        """Device seconds of the kernels whose name matches any pattern."""
        regs = [re.compile(p) for p in patterns]
        return sum(o.dur_us for o in self.kernels if any(r.search(o.name) for r in regs)) * 1e-6

    def breakdown(self, top: int = 10) -> Dict:
        """The device operations that took most time in the device-only
        slice, and the longest idle gaps of the named slice, each named by
        the innermost host range open at its start."""
        by_name: Dict[str, float] = {}
        for o in self.device_ops:
            by_name[o.name] = by_name.get(o.name, 0.0) + o.dur_us * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = _union([(o.start_us, o.start_us + o.dur_us) for o in self.named_device_ops])
        gaps = [(b0 - a1, a1) for (_, a1), (b0, _) in zip(busy, busy[1:])]
        gaps.sort(key=lambda g: -g[0])
        named = [[self._host_at(t0), dur * 1e-6] for dur, t0 in gaps[:top]]
        return {"device_ops": [[_short(n), s] for n, s in ops], "idle_gaps": named}

    def _host_at(self, t_us: float) -> str:
        best: Optional[Op] = None
        for o in self.host_ops:
            if o.start_us <= t_us <= o.start_us + o.dur_us and (best is None or o.dur_us < best.dur_us):
                best = o
        return _short(best.name) if best is not None else "host outside any range"


def _short(name: str, n: int = 160) -> str:
    return name if len(name) <= n else name[: n - 3] + "..."


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Profiled:
    """Context manager: profiles its body between two synchronises, the
    device alone (no host ranges recorded; the tracer still lengthens each
    launch, a graph's most) or, with ``host``, the host's ranges too;
    ``ops()`` then gives the device and host operations."""

    def __init__(self, host: bool = False):
        self.host = host

    def __enter__(self):
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CUDA]
        if self.host:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        return False

    def ops(self) -> Tuple[List[Op], List[Op]]:
        device, host = [], []
        cuda = torch.autograd.DeviceType.CUDA
        for e in self.prof.events():
            op = Op(e.name, float(e.time_range.start), float(e.time_range.elapsed_us()))
            (device if e.device_type == cuda else host).append(op)
        return device, host
