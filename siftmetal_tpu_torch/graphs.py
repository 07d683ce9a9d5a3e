"""The port's counterpart of ``jax.jit``'s cache: one captured CUDA graph
program per argument shapes and static arguments, replayed on every later
call.

A *program* is a function ``program(steps, *args, **static)`` that runs
its work through ``steps``: ``steps.stage(fn, *a)`` runs one piece and
returns its result, ``steps.loop(n, body, *a)`` runs ``body`` n times
(the body writes its carried state in place, as a ``lax.fori_loop`` body
returns it). A stage may carry a name (``name=``): the tracer
(``utils/profiling.py``) times it. :data:`EAGER` runs them as plain
Python calls, each named stage in a host span; that is the program on
the CPU and in a direct call on any device.

:class:`GraphCache` runs a program on a CUDA device as graphs. Its key is
the shapes, dtypes and device of the tensor leaves of ``args``, the other
leaves and the ``static`` keyword arguments. On a key's first call it
copies the tensors into the program's static inputs, warms the program
up once eagerly on a side stream (each loop body once: this builds the
cuBLAS and cuSOLVER handles and fills the table caches), then captures
each stage, and each loop body once, into a graph of one memory pool a
cache; consecutive named stages go into one graph. Every call copies its
tensors into the static inputs, replays the graphs in order (a loop's
graph n times) and returns fresh copies of the outputs. A capture that
fails raises; nothing falls back to eager.

The key holds the tracer's state too, for a program with named stages
(learnt at its first capture). A call with the tracer on runs the program
captured with each named stage in a graph of its own, replayed inside a
device span of the stage's name (timing events between graphs); with the
tracer off the program holds no event and no split. A program without a
named stage has one form, which serves both.

The graphs of one cache share one pool: a call replays one key's graphs
from the first to the last, so a later key's captures may reuse what an
earlier key's freed, and each key's first stage rewrites its whole state.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from .utils import profiling
from .utils.profiling import span


class Steps:
    """Runs a program's stages and loops as Python calls (eagerly)."""

    def stage(self, fn: Callable, *args, name: Optional[str] = None):
        if name is None:
            return fn(*args)
        with span(name):
            return fn(*args)

    def loop(self, n: int, body: Callable, *args) -> None:
        for _ in range(n):
            body(*args)


EAGER = Steps()


class _WarmUp(Steps):
    """Every stage once and every loop body once (at most): what a capture
    needs to have run before it."""

    def loop(self, n: int, body: Callable, *args) -> None:
        if n:
            body(*args)


class _Capture(Steps):
    """Captures each stage, and each loop body once, into its own graph in
    ``pool``; ``plan`` lists (graph, replays) in the order they run and
    ``names`` each graph's stage name (None for a graph of no named
    stage). Untraced, a run of consecutive named stages is one graph,
    open from the first to the next other step or the program's end (the
    context's exit). ``named``: whether a stage carried a name."""

    def __init__(self, pool, traced: bool):
        self.pool = pool
        self.traced = traced
        self.plan = []
        self.names = []
        self.named = False
        self._open = None   # (graph, its capture context) of a run of named stages

    def _context(self, graph):
        # thread_local: another thread's CUDA calls (a process group's
        # watchdog) neither fail nor break the capture.
        return torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local")

    def _graph(self, fn: Callable, args):
        graph = torch.cuda.CUDAGraph()
        with self._context(graph):
            out = fn(*args)
        return graph, out

    def _add(self, graph, n: int, name: Optional[str] = None) -> None:
        self.plan.append((graph, n))
        self.names.append(name)

    def stage(self, fn: Callable, *args, name: Optional[str] = None):
        self.named = self.named or name is not None
        if name is not None and not self.traced:
            if self._open is None:
                graph = torch.cuda.CUDAGraph()
                ctx = self._context(graph)
                ctx.__enter__()
                self._open = (graph, ctx)
            return fn(*args)
        self._end(None, None, None)
        graph, out = self._graph(fn, args)
        self._add(graph, 1, name)
        return out

    def loop(self, n: int, body: Callable, *args) -> None:
        self._end(None, None, None)
        if n:
            graph, _ = self._graph(body, args)
            self._add(graph, n)

    def _end(self, *exc) -> None:
        """Ends the open capture of a run of named stages, if any."""
        if self._open is not None:
            graph, ctx = self._open
            self._open = None
            ctx.__exit__(*exc)
            if exc[0] is None:
                self._add(graph, 1)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._end(*exc)
        return False


class Key(NamedTuple):
    """A cache key: the tensor leaves' (shape, dtype, device), the other
    leaves, the argument tree's structure, the static arguments and
    whether the tracer is on (always False for a program without a named
    stage)."""

    tensors: Tuple
    leaves: Tuple
    tree: str
    static: Tuple
    traced: bool


class Program(NamedTuple):
    """One key's captured program: its graphs and replay counts in order,
    each graph's stage name (None but in a traced program), the tensors
    it reads and the outputs it writes."""

    plan: Tuple
    names: Tuple
    inputs: Tuple
    outputs: object


def _replay(graph, n: int) -> None:
    for _ in range(n):
        graph.replay()


def _clone(x):
    return x.clone() if torch.is_tensor(x) else x


class GraphCache:
    """A program's graphs, one :class:`Program` a key (``graphs``).

    ``cache(*args, **static)`` runs ``program(steps, *args, **static)``:
    eagerly when the tensors of ``args`` lie on the CPU, else by replaying
    the key's graphs (captured on its first call). ``what`` names the
    program in the error of a failed capture. ``named``: whether the
    program has a named stage (None until its first capture)."""

    def __init__(self, program: Callable, what: str):
        self.program = program
        self.what = what
        self.graphs: Dict[Key, Program] = {}
        self.named: Optional[bool] = None
        self._pool = None

    def key(self, *args, **static) -> Key:
        """The key of a call with these arguments."""
        leaves, tree = pytree.tree_flatten(args)
        return Key(
            tuple((tuple(x.shape), x.dtype, x.device) for x in leaves if torch.is_tensor(x)),
            tuple(x for x in leaves if not torch.is_tensor(x)),
            str(tree),
            tuple(sorted(static.items())),
            profiling.enabled() and self.named is not False,
        )

    def __call__(self, *args, **static):
        leaves, tree = pytree.tree_flatten(args)
        tensors = [x for x in leaves if torch.is_tensor(x)]
        dev = tensors[0].device
        if dev.type != "cuda":
            return self.eager(*args, **static)
        key = self.key(*args, **static)
        prog = self.graphs.get(key)
        with torch.cuda.device(dev):
            if prog is None:
                prog = self._capture(key, leaves, tree, static)
                self.graphs[key._replace(traced=key.traced and self.named)] = prog
            for dst, src in zip(prog.inputs, tensors):
                dst.copy_(src)
            for (graph, n), name in zip(prog.plan, prog.names):
                if name is None:
                    _replay(graph, n)
                else:
                    with span(name, device=dev):
                        _replay(graph, n)
            return pytree.tree_map(_clone, prog.outputs)

    def eager(self, *args, **static):
        """The program run eagerly on any device (what a replay is held
        against)."""
        return self.program(EAGER, *args, **static)

    def _capture(self, key: Key, leaves, tree, static) -> Program:
        """Static inputs of ``key``'s shapes, one eager warm-up on a side
        stream, then the program's stages captured in order (counted as
        ``graphs.captures`` while the tracer is on)."""
        inputs = tuple(x.clone() for x in leaves if torch.is_tensor(x))
        it = iter(inputs)
        args = pytree.tree_unflatten([next(it) if torch.is_tensor(x) else x for x in leaves], tree)
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.program(_WarmUp(), *args, **static)
        main.wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        steps = _Capture(self._pool, key.traced)
        try:
            with steps:
                outputs = self.program(steps, *args, **static)
        except Exception as err:
            shapes = [shape for shape, _, _ in key.tensors]
            raise RuntimeError(
                f"capturing {self.what} at {shapes} into a CUDA graph failed"
            ) from err
        profiling.count("graphs.captures")
        self.named = steps.named
        return Program(tuple(steps.plan), tuple(steps.names), inputs, outputs)
