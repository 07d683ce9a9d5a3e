#!/usr/bin/env python3
"""Run the loop-closure scene of tests/test_sfm.py over many RANSAC streams.

    python3 scripts/loop_scene_streams.py --package torch [--device cpu] [--seeds 0-7]
    python3 scripts/loop_scene_streams.py --package jax [--seeds 0-7]

The scene, config and flow of ``test_loop_closure_drift_repair``: 52
keyframes orbiting inside a cylinder wall of 2600 landmarks, ``initialize``
on frames 0 and 1, ``add_frame`` for the rest (a global ``bundle_adjust``
every 10th frame), drift injected into the second half, then
``detect_loop_closures`` and ``optimize_pose_graph``. A stream stops at the
first frame that does not register.

Streams: ``default`` runs each method with no key or generator (each seeds
the constant the JAX method uses; the stream the JAX test runs), an integer
``s`` a seeded stream: in the port one ``torch.Generator`` seeded ``s`` and
passed to every call, in the JAX package ``fold_in(PRNGKey(s), call)`` for
the n-th call. The two packages draw different numbers from the same seed,
so a stream's outcome is compared across packages only as a rate.

``--package torch`` runs ``siftmetal_tpu_torch`` (through chip_smoke.py's
loop-scene functions) on ``--device`` (the card by default); ``--package
jax`` runs ``siftmetal_tpu`` on JAX's default backend. Prints one line a
stream and a summary: streams that registered every frame, and streams that
met the test's three bars.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _seeds(spec: str):
    out = []
    for part in spec.split(","):
        if part == "default":
            out.append(None)
        elif "-" in part:
            a, b = part.split("-")
            out.extend(range(int(a), int(b) + 1))
        else:
            out.append(int(part))
    return out


def torch_streams(seeds, device):
    import chip_smoke
    from siftmetal_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    k, cams, frames = chip_smoke._loop_scene(dev)
    for seed in seeds:
        yield chip_smoke._loop_stream(dev, k, cams, frames, seed)


def _jax_scene():
    """The scene exactly as tests/test_sfm.py builds it."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from siftmetal_tpu.slam.camera import project
    from siftmetal_tpu.slam.sfm import SfmMap

    rng = np.random.default_rng(17)
    n_frames, n_lm = 52, 2600
    k = np.array([[400, 0, 320], [0, 400, 240], [0, 0, 1]], np.float32)
    ang = rng.uniform(0, 2 * np.pi, n_lm)
    lms = np.stack([10 * np.cos(ang), rng.uniform(-3, 3, n_lm), 10 * np.sin(ang)],
                   axis=1).astype(np.float32)
    descs = rng.integers(0, 200, (n_lm, 128)).astype(np.uint8)
    cams = np.zeros((n_frames, 6), np.float32)
    for f in range(n_frames):
        yaw = 2 * np.pi * f / (n_frames - 2)
        cams[f, 1] = yaw
        cams[f, 3] = 3.0 * np.sin(yaw)
        cams[f, 5] = 3.0 * (1 - np.cos(yaw))
    frames = []
    for f in range(n_frames):
        uvs = np.asarray(jax.vmap(
            lambda p, f=f: project(jnp.asarray(cams[f]), jnp.asarray(k), p))(jnp.asarray(lms)))
        depth = SfmMap._depths(cams[f], lms)
        inside = ((depth > 1.0) & (uvs[:, 0] > 0) & (uvs[:, 0] < 640)
                  & (uvs[:, 1] > 0) & (uvs[:, 1] < 480))
        uvs = uvs + rng.normal(0, 0.2, uvs.shape)
        frames.append((jnp.asarray(uvs[:, ::-1].astype(np.float32)), jnp.asarray(descs),
                       jnp.asarray(inside)))
    return k, cams, frames


def jax_streams(seeds):
    import jax
    import numpy as np

    from siftmetal_tpu.slam.sfm import SfmConfig, SfmMap
    from siftmetal_tpu.slam.trajectory import ate_rmse, camera_centers

    k, cams, frames = _jax_scene()
    n = len(frames)
    for seed in seeds:
        key = (lambda i: None) if seed is None else (
            lambda i, base=jax.random.PRNGKey(seed): jax.random.fold_in(base, i))
        cfg = SfmConfig(max_cameras=64, max_landmarks=4096, max_observations=131072,
                        new_landmarks_per_frame=512)
        smap = SfmMap(k, cfg)
        t0 = time.perf_counter()
        smap.initialize(frames[0], frames[1], key=key(0))
        lost = None
        for fi, f in enumerate(frames[2:], start=2):
            ok, n_in, _ = smap.add_frame(f, key=key(fi))
            if not ok:
                lost = (fi, n_in)
                break
            if fi % 10 == 0:
                smap.bundle_adjust()
        if lost is not None:
            yield dict(seed=seed, registered=lost[0], inliers=lost[1],
                       build_s=time.perf_counter() - t0, bars=False)
            continue
        build_s = time.perf_counter() - t0
        ate = lambda: ate_rmse(camera_centers(smap.cameras[:n]), camera_centers(cams))
        base = ate()
        drift = np.zeros((n, 6), np.float32)
        g = np.linspace(0, 1, n - 26) ** 1.5
        drift[26:, 1] = 0.06 * g
        drift[26:, 3] = 0.8 * g
        smap.cameras[:n] += drift
        bad = ate()
        edges = smap.detect_loop_closures(key=key(10**6))
        smap.optimize_pose_graph(loop_closures=edges, n_iterations=60)
        repaired = ate()
        bars = (bad > 3 * base + 0.02, len(edges) >= 1 and min(e[0] for e in edges) <= 5,
                repaired < 0.5 * bad)
        yield dict(seed=seed, registered=n, build_s=build_s, base=base, bad=bad,
                   repaired=repaired, edges=[(int(e[0]), int(e[1])) for e in edges],
                   each_bar=bars, bars=all(bars))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("torch", "jax"), required=True)
    ap.add_argument("--device", default=None, help="torch only: cuda (default) or cpu")
    ap.add_argument("--seeds", default="default,0-7",
                    help="comma list of 'default', integers and ranges a-b")
    args = ap.parse_args()
    seeds = _seeds(args.seeds)
    runs = jax_streams(seeds) if args.package == "jax" else torch_streams(seeds, args.device)
    n_all = n_reg = n_bars = 0
    for r in runs:
        n_all += 1
        n_reg += r["registered"] == 52
        n_bars += r["bars"]
        name = "default" if r["seed"] is None else r["seed"]
        if r["registered"] < 52:
            print(f"{args.package} stream {name}: frame {r['registered']} did not register "
                  f"({r['inliers']} inliers; {r['build_s']:.1f} s)", flush=True)
        else:
            print(f"{args.package} stream {name}: 52 frames; ATE base {r['base']:.5f}, drifted "
                  f"{r['bad']:.5f}, repaired {r['repaired']:.5f}; closures {r['edges']}; bars "
                  f"{r['each_bar']}; {r['build_s']:.1f} s", flush=True)
    print(f"{args.package}: {n_reg} of {n_all} streams registered every frame, "
          f"{n_bars} of {n_all} met the three bars", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
