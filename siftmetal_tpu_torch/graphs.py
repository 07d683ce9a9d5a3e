"""The port's counterpart of ``jax.jit``'s cache: one captured CUDA graph
program per argument shapes and static arguments, replayed on every later
call.

A *program* is a function ``program(steps, *args, **static)`` that runs
its work through ``steps``: ``steps.stage(fn, *a)`` runs one piece and
returns its result, ``steps.loop(n, body, *a)`` runs ``body`` n times
(the body writes its carried state in place, as a ``lax.fori_loop`` body
returns it). :data:`EAGER` runs them as plain Python calls; that is the
program on the CPU and in a direct call on any device.

:class:`GraphCache` runs a program on a CUDA device as graphs. Its key is
the shapes, dtypes and device of the tensor leaves of ``args``, the other
leaves and the ``static`` keyword arguments. On a key's first call it
copies the tensors into the program's static inputs, warms the program
up once eagerly on a side stream (each loop body once: this builds the
cuBLAS and cuSOLVER handles and fills the table caches), then captures
each stage, and each loop body once, into a graph of one memory pool a
cache. Every call copies its tensors into the static inputs, replays the
graphs in order (a loop's graph n times) and returns fresh copies of the
outputs. A capture that fails raises; nothing falls back to eager.

The graphs of one cache share one pool: a call replays one key's graphs
from the first to the last, so a later key's captures may reuse what an
earlier key's freed, and each key's first stage rewrites its whole state.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch
from torch.utils import _pytree as pytree


class Steps:
    """Runs a program's stages and loops as Python calls (eagerly)."""

    def stage(self, fn: Callable, *args):
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
    ``pool``; ``plan`` lists (graph, replays) in the order they run."""

    def __init__(self, pool):
        self.pool = pool
        self.plan = []

    def _graph(self, fn: Callable, args):
        graph = torch.cuda.CUDAGraph()
        # thread_local: another thread's CUDA calls (a process group's
        # watchdog) neither fail nor break the capture.
        with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
            out = fn(*args)
        return graph, out

    def stage(self, fn: Callable, *args):
        graph, out = self._graph(fn, args)
        self.plan.append((graph, 1))
        return out

    def loop(self, n: int, body: Callable, *args) -> None:
        if n:
            graph, _ = self._graph(body, args)
            self.plan.append((graph, n))


class Key(NamedTuple):
    """A cache key: the tensor leaves' (shape, dtype, device), the other
    leaves, the argument tree's structure and the static arguments."""

    tensors: Tuple
    leaves: Tuple
    tree: str
    static: Tuple


class Program(NamedTuple):
    """One key's captured program: its graphs and replay counts in order,
    the tensors it reads and the outputs it writes."""

    plan: Tuple
    inputs: Tuple
    outputs: object


def _clone(x):
    return x.clone() if torch.is_tensor(x) else x


class GraphCache:
    """A program's graphs, one :class:`Program` a key (``graphs``).

    ``cache(*args, **static)`` runs ``program(steps, *args, **static)``:
    eagerly when the tensors of ``args`` lie on the CPU, else by replaying
    the key's graphs (captured on its first call). ``what`` names the
    program in the error of a failed capture."""

    def __init__(self, program: Callable, what: str):
        self.program = program
        self.what = what
        self.graphs: Dict[Key, Program] = {}
        self._pool = None

    def key(self, *args, **static) -> Key:
        """The key of a call with these arguments."""
        leaves, tree = pytree.tree_flatten(args)
        return Key(
            tuple((tuple(x.shape), x.dtype, x.device) for x in leaves if torch.is_tensor(x)),
            tuple(x for x in leaves if not torch.is_tensor(x)),
            str(tree),
            tuple(sorted(static.items())),
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
                prog = self.graphs[key] = self._capture(key, leaves, tree, static)
            for dst, src in zip(prog.inputs, tensors):
                dst.copy_(src)
            for graph, n in prog.plan:
                for _ in range(n):
                    graph.replay()
            return pytree.tree_map(_clone, prog.outputs)

    def eager(self, *args, **static):
        """The program run eagerly on any device (what a replay is held
        against)."""
        return self.program(EAGER, *args, **static)

    def _capture(self, key: Key, leaves, tree, static) -> Program:
        """Static inputs of ``key``'s shapes, one eager warm-up on a side
        stream, then the program's stages captured in order."""
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
        steps = _Capture(self._pool)
        try:
            outputs = self.program(steps, *args, **static)
        except Exception as err:
            shapes = [shape for shape, _, _ in key.tensors]
            raise RuntimeError(
                f"capturing {self.what} at {shapes} into a CUDA graph failed"
            ) from err
        return Program(tuple(steps.plan), inputs, outputs)
