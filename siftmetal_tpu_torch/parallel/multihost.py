"""Multi-process runtime: initialization, barriers, and elastic recovery.

Port of ``siftmetal_tpu/parallel/multihost.py`` on ``torch.distributed``.
The JAX package runs one controller per host over a global device mesh;
PyTorch's idiom is one process (rank) per device. ``initialize`` joins the
job from torch's launcher variables (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, as ``torchrun`` exports them) or
from explicit arguments: NCCL with the rank on ``cuda:LOCAL_RANK``, gloo
when the caller asks for the CPU. ``barrier`` is an all-reduce that every
rank must reach, and ``run_elastic`` turns a failed step into a restore
from the last checkpoint instead of a dead job.

Collectives need no extra failure logic: a collective completes on every
rank or raises on every rank, which the supervisor treats as a restart
signal.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device

logger = logging.getLogger("siftmetal_tpu_torch.multihost")


# (default group, this rank's device) when this module set the group up.
_OWN: Optional[tuple] = None


def _init_group(dev: torch.device, world: int, rank: int, init_method=None, store=None) -> None:
    """Set up the default process group with this rank on ``dev``: NCCL
    for a CUDA device (made the current one), gloo for the CPU. The one
    place that picks the backend; it records ``dev`` for ``group_device``."""
    global _OWN
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=init_method, store=store, world_size=world, rank=rank,
    )
    _OWN = (dist.group.WORLD, dev)


def group_device() -> Optional[torch.device]:
    """The device that ``initialize`` or ``make_mesh`` set this rank's
    group up on; None when they did not set up the current group."""
    if _OWN is None or not dist.is_initialized() or dist.group.WORLD is not _OWN[0]:
        return None
    return _OWN[1]


def rank_device(mesh) -> torch.device:
    """The device of this rank's work on ``mesh``: the current CUDA device
    for a CUDA mesh, the CPU for a CPU mesh. Taken from the mesh, never
    from the backend's name (a group may hold several backends)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    raise ValueError(f"a mesh of {mesh.device_type} devices is not supported")


def backend_device_types() -> set:
    """The device types that the default group has a backend for, from
    its backend configuration ("cpu:gloo,cuda:nccl" and the like): the
    name alone says nothing for "undefined" or a mixed group."""
    config = dist.get_backend_config()
    return {entry.split(":")[0] for entry in config.split(",") if ":" in entry}


def _barrier_device() -> torch.device:
    """Where the barrier's tensor lies: the recorded device of the group;
    for a group set up elsewhere, the CPU when it has a CPU backend, else
    the current CUDA device."""
    dev = group_device()
    if dev is not None:
        return dev
    if dist.is_initialized() and "cpu" not in backend_device_types():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> Tuple[int, int]:
    """Join the job and return (rank, world size).

    ``coordinator_address`` is "host:port"; without it, ``MASTER_ADDR`` and
    ``MASTER_PORT`` give it, and ``num_processes`` / ``process_id`` default
    to ``WORLD_SIZE`` / ``RANK``. With no address at all this is a no-op
    returning (0, 1), as the JAX function is on one host. ``device`` is the
    rank's device: ``None`` means ``cuda:LOCAL_RANK`` (NCCL; raises without
    a card), ``"cpu"`` the gloo backend."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    addr = coordinator_address
    if not addr and os.environ.get("MASTER_ADDR"):
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if not addr:
        return 0, 1
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    if world is None or rank is None:
        raise ValueError(
            "initialize needs the world size and the rank: pass num_processes and "
            "process_id or export WORLD_SIZE and RANK"
        )
    local = _env_int("LOCAL_RANK") or 0
    dev = resolve_device(f"cuda:{local}" if device is None else device)
    _init_group(dev, world, rank, init_method=f"tcp://{addr}")
    return dist.get_rank(), dist.get_world_size()


def barrier(name: str = "barrier") -> float:
    """Barrier across every rank: an all-reduce of a one per rank must
    complete everywhere before anyone proceeds. Returns its result, the
    global device count (one device a rank; 1 without a process group),
    so callers can assert that every rank took part."""
    one = torch.ones((1,), dtype=torch.float32, device=_barrier_device())
    if dist.is_initialized():
        dist.all_reduce(one)
    count = float(one.item())
    logger.debug("barrier %s passed (%d devices)", name, int(count))
    return count


def run_elastic(
    step_fn: Callable[[int, object], object],
    init_state: object,
    n_steps: int,
    checkpoint_every: int = 50,
    save_fn: Optional[Callable[[int, object], None]] = None,
    restore_fn: Optional[Callable[[], Optional[Tuple[int, object]]]] = None,
    max_restarts: int = 3,
    backoff_s: float = 5.0,
):
    """Supervised step loop with checkpoint/restore-based recovery.

    ``step_fn(step, state) -> state`` runs the (possibly collective) work;
    ``save_fn(step, state)`` checkpoints; ``restore_fn()`` returns (step,
    state) or None. A failed step restores the last checkpoint and
    retries, up to ``max_restarts`` times."""
    state = init_state
    step = 0
    if restore_fn is not None:
        restored = restore_fn()
        if restored is not None:
            step, state = restored
            logger.info("resumed from checkpoint at step %d", step)

    restarts = 0
    while step < n_steps:
        try:
            state = step_fn(step, state)
            step += 1
            if save_fn is not None and step % checkpoint_every == 0:
                save_fn(step, state)
        except Exception:  # noqa: BLE001 — any runtime/collective failure
            restarts += 1
            logger.exception("step %d failed (restart %d)", step, restarts)
            if restarts > max_restarts:
                raise
            time.sleep(backoff_s * restarts)
            if restore_fn is not None:
                restored = restore_fn()
                if restored is not None:
                    step, state = restored
                    logger.info("restored to step %d", step)
    return step, state
