"""The multi-device layer of the port on ``torch.distributed``: one
process (rank) per device, NCCL on the card and gloo on the CPU."""

from .distributed_ba import make_distributed_ba, shard_ba_problem
from .extraction import make_batch_extractor, make_mesh, make_sharded_matcher

__all__ = [
    "make_batch_extractor", "make_mesh", "make_sharded_matcher",
    "make_distributed_ba", "shard_ba_problem",
]
