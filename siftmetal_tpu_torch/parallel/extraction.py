"""Multi-device data-parallel extraction and sharded matching.

Port of ``siftmetal_tpu/parallel/extraction.py`` on ``torch.distributed``:
one process (rank) per device, where the JAX package drives a device mesh
from one controller through ``shard_map``. Each rank runs the body of the
JAX ``shard_map`` on its contiguous shard, and an all-gather takes the
place of the JAX package's global output array:

  * ``make_batch_extractor``: the frame axis is the data-parallel axis.
    Every rank extracts its B/D frames with ``extract_gray_batch`` (the
    port's kernels on the card) and all-gathers every padded output
    field, so each rank returns what one device returns for the batch.
  * ``make_sharded_matcher``: the TARGET set is sharded. Each rank finds
    the exact top-2 of every query in its target shard; the [D, Q, 2]
    candidates are all-gathered and reduced to a global top-2.

Every output field has a static padded size, so one all-gather of the
fields packed as bytes moves them all, whatever their dtype (gloo gathers
no bool tensors), with no size exchange.

On the card each rank replays its body and the all-gather from one CUDA
graph a shard shape (``graphs``; the counterpart of the JAX ``jax.jit``
over ``shard_map``). The shard's slice and its copy to the device stay
outside, a copy into the graph's input. On the CPU (gloo) they run
eagerly.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import torch
import torch.distributed as dist

from ..config import SiftConfig
from ..device import resolve_device
from ..graphs import GraphCache
from ..match.matcher import _accept, _top2_blocked
from ..sift.batched import extract_gray_batch
from ..sift.detect import Keypoints
from ..sift.extract import Descriptors
from . import multihost
from .multihost import rank_device


def make_mesh(n_devices: int | None = None, axis: str = "batch", device=None):
    """A 1-D ``DeviceMesh`` named ``axis`` over every rank of the process
    group (one device a rank): PyTorch's counterpart of the JAX package's
    ``Mesh``. Its device is ``resolve_device(device)``; with ``device``
    None, the device ``initialize`` set this rank up on, else the card.
    Without a process group it first sets up a one-rank group on that
    device (NCCL on the card, gloo on the CPU), so a one-card caller needs
    no launcher. Raises when ``n_devices`` is given and differs from the
    world size, or when the group has no backend for the device."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device if device is not None else multihost.group_device())
    if not dist.is_initialized():
        multihost._init_group(dev, 1, 0, store=dist.HashStore())
    elif dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"a mesh of {n_devices} devices asked for in a process group of {world} "
            "ranks (one device a rank)"
        )
    if dev.type not in multihost.backend_device_types():
        raise ValueError(
            f"a {dev.type} mesh asked for over a process group with backends "
            f"{dist.get_backend_config()}"
        )
    return init_device_mesh(dev.type, (world,), mesh_dim_names=(axis,))


def _check_inputs(dev: torch.device, what: str, *tensors) -> None:
    """Refuse inputs that lie on another kind of device than the mesh's:
    a tensor on the card is never moved to a CPU mesh. Host inputs are
    copied to the rank's device (a loader's pinned batch, say)."""
    for t in tensors:
        if torch.is_tensor(t) and t.device.type not in ("cpu", dev.type):
            raise ValueError(f"{what} lies on {t.device}, the mesh on {dev.type}")


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def all_gather_rows(group, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """All-gather tensors of the same shapes on every rank in ONE
    collective: each rank's tensors go out packed as bytes, and each comes
    back as the ranks' tensors concatenated along dim 0 in rank order."""
    world = dist.get_world_size(group)
    packed = torch.cat([_as_bytes(t) for t in tensors])
    parts = [torch.empty_like(packed) for _ in range(world)]
    dist.all_gather(parts, packed, group=group)
    out, off = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        # clone: a fresh, aligned buffer to view as the field's dtype.
        out.append(torch.cat([
            p[off:off + n].clone().view(t.dtype).reshape(t.shape) for p in parts
        ]))
        off += n
    return out


def _routes(call, graphs: GraphCache):
    """``run(*args)``: ``call(graphs, *args)``, the program replayed from
    its graphs on the card (eager on the CPU); ``run.eager`` runs it
    eagerly on any device (the route a replay is measured and held
    against); ``run.graphs`` is the cache."""
    run = functools.partial(call, graphs)
    run.eager = functools.partial(call, graphs.eager)
    run.graphs = graphs
    return run


def _shard(mesh, axis: str, n: int, what: str) -> slice:
    world = mesh.size()
    if n % world:
        raise ValueError(f"{what} of {n} is not a multiple of the mesh size {world}")
    per = n // world
    rank = mesh.get_local_rank(axis)
    return slice(rank * per, (rank + 1) * per)


def make_batch_extractor(
    mesh,
    height: int,
    width: int,
    config: SiftConfig,
    n_octaves: int | None = None,
    axis: str = "batch",
):
    """Data-parallel extractor for GLOBAL [B, H, W] gray frame batches, B a
    multiple of the mesh size. Every rank calls it with the same batch,
    extracts its contiguous B/D frames on its device and returns the
    whole batch's (Keypoints, Descriptors, counters), [B, ...] each."""
    n_oct = n_octaves if n_octaves is not None else config.num_octaves(height, width)
    group = mesh.get_group(axis)
    dev = rank_device(mesh)

    def extract_and_gather(shard):
        kps, descs, counters = extract_gray_batch(shard, config, n_oct)
        keys = list(counters)
        nk, nd = len(kps), len(descs)
        out = all_gather_rows(group, [*kps, *descs, *(counters[k] for k in keys)])
        return (
            Keypoints(*out[:nk]),
            Descriptors(*out[nk:nk + nd]),
            dict(zip(keys, out[nk + nd:])),
        )

    graphs = GraphCache(lambda steps, shard: steps.stage(extract_and_gather, shard),
                        "the sharded extractor")

    def call(route, frames):
        frames = torch.as_tensor(frames)
        _check_inputs(dev, "the batch", frames)
        if tuple(frames.shape[1:]) != (height, width):
            raise ValueError(f"expected [B, {height}, {width}] frames, got {tuple(frames.shape)}")
        shard = frames[_shard(mesh, axis, frames.shape[0], "the batch")]
        return route(shard.to(device=dev, dtype=torch.float32).contiguous())

    return _routes(call, graphs)


def make_sharded_matcher(
    mesh,
    absolute_threshold: float = 1.176,
    ratio_threshold: float = 0.6,
    axis: str = "batch",
):
    """Matcher with the target descriptor set sharded across the ranks:
    ``run(query_features, query_valid, target_features, target_valid)``
    with the GLOBAL sets (T a multiple of the mesh size) returns the
    ``Matches`` of ``match_bruteforce`` on every rank.

    Each rank computes the exact top-2 against its contiguous target shard
    (the matcher's integer-exact product for uint8 descriptors, in blocks
    past 65536 targets), offsets its indices by rank x T/D, and the
    [D, Q, 2] candidates are all-gathered and laid out shard-major. The
    global top-2 is a stable sort of each query's 2D candidates: on equal
    distances the first position wins, as in ``lax.top_k``."""
    group = mesh.get_group(axis)
    dev = rank_device(mesh)
    world = mesh.size()

    def match(qf, qv, tf, tv, offset):
        b1, b2, i1, i2 = _top2_blocked(qf, tf, tv)
        d2_l = torch.stack([b1, b2], dim=1)
        idx_l = torch.stack([i1, i2], dim=1).to(torch.int32) + offset
        d2_all, idx_all = all_gather_rows(group, [d2_l, idx_l])       # [D * Q, 2]
        q_n = qf.shape[0]
        d2_flat = d2_all.reshape(world, q_n, 2).transpose(0, 1).reshape(q_n, 2 * world)
        idx_flat = idx_all.reshape(world, q_n, 2).transpose(0, 1).reshape(q_n, 2 * world)
        d2_sorted, pos = torch.sort(d2_flat, dim=1, stable=True)
        best = torch.gather(idx_flat, 1, pos[:, :2])
        d1 = torch.sqrt(torch.clamp(d2_sorted[:, 0], min=0.0))
        d2nd = torch.sqrt(torch.clamp(d2_sorted[:, 1], min=0.0))
        return _accept(d1, d2nd, best[:, 0], best[:, 1], qv, absolute_threshold, ratio_threshold)

    graphs = GraphCache(lambda steps, *a, offset: steps.stage(match, *a, offset),
                        "the sharded matcher")

    def call(route, query_features, query_valid, target_features, target_valid):
        _check_inputs(dev, "a descriptor set", query_features, query_valid,
                      target_features, target_valid)
        sl = _shard(mesh, axis, target_features.shape[0], "the target set")
        return route(query_features.to(dev), query_valid.to(dev), target_features[sl].to(dev),
                     target_valid[sl].to(dev), offset=sl.start)

    return _routes(call, graphs)
