"""One rank of the port's multi-device layer on the CPU (gloo).

Started once a rank by tests/test_torch_parallel.py with MASTER_ADDR,
MASTER_PORT, WORLD_SIZE and RANK exported:

    python tests/torch_parallel_worker.py INPUTS.npz OUT_DIR

It joins the group through ``multihost.initialize(device="cpu")``, passes a
barrier, runs the sharded extractor (in two configurations), the sharded
matcher and the distributed BA on the inputs, and an elastic loop with one
injected failure, then writes everything it got to OUT_DIR/rank<r>.npz.
It imports no JAX.
"""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from siftmetal_tpu_torch.config import SiftConfig
from siftmetal_tpu_torch.parallel import (
    make_batch_extractor,
    make_distributed_ba,
    make_mesh,
    make_sharded_matcher,
    multihost,
    shard_ba_problem,
)
from siftmetal_tpu_torch.slam.ba import BAProblem

# tests/test_parallel.py's configuration, and the same with the seed blur +
# cascade route that the JAX package takes on the CPU.
CFG = SiftConfig(max_extrema_per_octave=512, max_keypoints=256, max_descriptors=512)
CFG_CASCADE = dataclasses.replace(CFG, use_oneshot_pyramid=False)


def _fields(prefix, named):
    return {f"{prefix}.{k}": v.numpy() for k, v in named._asdict().items() if v is not None}


def main(inputs: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    rank, world = multihost.initialize(device="cpu")
    out = {"rank": rank, "world": world, "barrier": multihost.barrier("startup")}
    data = np.load(inputs)

    mesh = make_mesh(world)
    frames = torch.from_numpy(data["frames"])
    for tag, cfg in (("x", CFG), ("xc", CFG_CASCADE)):
        kb, db, cb = make_batch_extractor(mesh, 96, 128, cfg)(frames)
        out.update(_fields(f"{tag}.kp", kb))
        out.update(_fields(f"{tag}.desc", db))
        out.update({f"{tag}.ctr.{k}": v.numpy() for k, v in cb.items()})
        if tag == "x":
            qf, qv = db.features[0], db.valid[0]
            m = make_sharded_matcher(mesh)(qf, qv, db.features.reshape(-1, 128), db.valid.reshape(-1))
            out.update(_fields("match", m))

    t = torch.from_numpy
    problem = BAProblem(
        t(data["ba_cams"]), t(data["ba_lms"]), t(data["ba_k"]), t(data["ba_cam_idx"]),
        t(data["ba_lm_idx"]), t(data["ba_uv"]), t(data["ba_valid"]), fixed_cameras=2,
    )
    sharded = shard_ba_problem(problem, world)
    cams, lms, (c0, c1) = make_distributed_ba(mesh, n_iterations=8, damping=1e-4)(sharded)
    out.update({"ba.cams": cams.numpy(), "ba.lms": lms.numpy(), "ba.c0": c0.numpy(),
                "ba.c1": c1.numpy(), "ba.slot_cam": sharded.cam.numpy(),
                "ba.slot_uv": sharded.uv.numpy(), "ba.slot_valid": sharded.valid.numpy()})

    # Elastic loop with one injected failure on rank 0 (its steps hold a
    # collective, so every rank waits for the restored rank 0).
    saved = {}
    fail_at = {3} if rank == 0 else set()

    def step_fn(step, state):
        if step in fail_at:
            fail_at.discard(step)
            raise RuntimeError("injected failure")
        multihost.barrier(f"step {step}")
        return state + 1

    step, state = multihost.run_elastic(
        step_fn, 0, n_steps=5, checkpoint_every=1,
        save_fn=lambda s, st: saved.__setitem__("c", (s, st)),
        restore_fn=lambda: saved.get("c"), backoff_s=0.0,
    )
    out.update({"elastic.step": step, "elastic.state": state})
    out["barrier_end"] = multihost.barrier("shutdown")
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
