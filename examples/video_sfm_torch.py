"""End-to-end demo on the PyTorch port: frames -> SIFT -> matching ->
incremental SfM -> ATE.

The scene and the SfM flow of ``examples/video_sfm.py``: a synthetic
wall of textured blobs, a camera sweep rendered on the CPU, SIFT on
every frame (``siftmetal_tpu_torch.SIFT``), the incremental ``SfmMap``
(bootstrap, PnP registration, triangulation, global BA), reprojection
RMS and the ATE against the ground-truth trajectory. It writes the map
(``map.npz``), the TUM trajectory, frame 0 as a PGM and frame 0's
keypoints drawn over it (``frame0_keypoints.png``; drawing needs
matplotlib, the ``viz`` extra, and is skipped with a note without it).

Usage:
    python examples/video_sfm_torch.py [out_dir] [--device cpu]

``out_dir`` defaults to ``video_sfm_torch`` under the temporary directory
(``$TMPDIR``). It runs on the CUDA card unless ``--device cpu`` is given,
and asserts ATE < 0.1 as the original does.
"""

import argparse
import importlib.util
import math
import pathlib
import sys
import tempfile

# Allow running straight from a source checkout.
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch


def textured_scene(rng, n_blobs=2500, width_scale=1.0):
    """A wall of small Gaussian blobs at varying depths (z in [6, 9]);
    ``width_scale`` scales the blob radii (pixels) with the image."""
    centers = rng.uniform([-6, -4, 6], [6, 4, 9], (n_blobs, 3))
    amps = rng.uniform(0.4, 1.0, n_blobs) * rng.choice([-1.0, 1.0], n_blobs)
    widths = rng.uniform(1.5, 6.0, n_blobs) * width_scale  # blob radius in PIXELS
    return centers, amps, widths


def render(cam, k, centers, amps, widths, h, w, device, batch=256):
    """Splat renderer: project the blob centers, then add each blob's
    Gaussian (cut at 3 radii) to a 0.5 grey plane, ``batch`` blobs at a
    time with one ``index_add_``. Blobs whose center projects more than
    20 px outside the frame are skipped. The frame is drawn on the CPU,
    whose ``index_add_`` sums overlapping blobs in one fixed order (a
    card's atomics add them in any order, and the last bits of a frame,
    and so the SfM run on it, would change from run to run), then moved
    to ``device``."""
    from siftmetal_tpu_torch.slam.camera import project

    out_device, device = device, torch.device("cpu")
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    uv = project(f32(cam), f32(k), f32(centers))
    amps_t, r_t = f32(amps), f32(widths)
    shown = (uv[:, 0] > -20) & (uv[:, 0] < w + 20) & (uv[:, 1] > -20) & (uv[:, 1] < h + 20)
    reach = int(math.ceil(3.0 * float(np.max(widths)))) + 1
    off = torch.arange(-reach, reach + 1, device=device)
    img = torch.full((h * w,), 0.5, device=device)
    for s in range(0, len(centers), batch):
        u, v = uv[s:s + batch, 0], uv[s:s + batch, 1]
        r, a = r_t[s:s + batch, None], amps_t[s:s + batch, None, None]
        px = torch.floor(u).long()[:, None] + off          # [b, 2R+1] columns
        py = torch.floor(v).long()[:, None] + off          # [b, 2R+1] rows
        dx, dy = px - u[:, None], py - v[:, None]
        mx = (dx.abs() < 3 * r) & (px >= 0) & (px < w)
        my = (dy.abs() < 3 * r) & (py >= 0) & (py < h)
        inside = my[:, :, None] & mx[:, None, :] & shown[s:s + batch, None, None]
        val = 0.25 * a * torch.exp(
            -(dy[:, :, None] ** 2 + dx[:, None, :] ** 2) / (2 * r[:, :, None] ** 2)
        )
        idx = torch.where(inside, py[:, :, None] * w + px[:, None, :], 0)
        img.index_add_(0, idx.reshape(-1), torch.where(inside, val, 0.0).reshape(-1))
    return img.clamp(0.0, 1.0).reshape(h, w).to(out_device)


def frames_of(descs, i):
    """Frame ``i`` of a batched extraction as SfM input (xy, desc, valid)."""
    return torch.stack([descs.x[i], descs.y[i]], dim=1), descs.features[i], descs.valid[i]


def main(out_dir=None, device=None):
    from siftmetal_tpu_torch import SIFT, SiftConfig
    from siftmetal_tpu_torch.device import resolve_device
    from siftmetal_tpu_torch.slam.sfm import SfmConfig, SfmMap
    from siftmetal_tpu_torch.slam.trajectory import ate_rmse, camera_centers
    from siftmetal_tpu_torch.utils.checkpoint import save_map, save_trajectory_tum
    from siftmetal_tpu_torch.utils.io import save_image
    from siftmetal_tpu_torch.utils.viz import draw_keypoints

    dev = resolve_device(device)
    out = pathlib.Path(out_dir or pathlib.Path(tempfile.gettempdir()) / "video_sfm_torch")
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    h, w = 240, 320
    k = np.array([[260, 0, w / 2], [0, 260, h / 2], [0, 0, 1]], dtype=np.float32)

    centers, amps, widths = textured_scene(rng)
    n_frames = 5
    cams = np.zeros((n_frames, 6), dtype=np.float32)
    cams[:, 3] = np.linspace(0, 1.2, n_frames)       # truck right
    cams[:, 1] = np.linspace(0, 0.06, n_frames)      # slight pan

    print(f"rendering + extracting on {dev}...")
    imgs = torch.stack([render(c, k, centers, amps, widths, h, w, dev) for c in cams])
    save_image(str(out / "frame0.pgm"), imgs[0])
    _, descs, _ = SIFT(h, w, SiftConfig(max_descriptors=4096), device=dev).extract_batch(imgs)
    frames = [frames_of(descs, i) for i in range(n_frames)]
    for i in range(n_frames):
        print(f"  frame {i}: {int(descs.valid[i].sum())} descriptors")
    if importlib.util.find_spec("matplotlib") is None:
        print("  frame0_keypoints.png not drawn: matplotlib (the viz extra) is not installed")
    else:
        v = descs.valid[0]
        draw_keypoints(imgs[0], descs.x[0][v], descs.y[0][v], descs.sigma[0][v],
                       descs.theta[0][v], path=str(out / "frame0_keypoints.png"))

    print("reconstructing...")
    smap = SfmMap(k, SfmConfig(max_cameras=8, match_ratio_threshold=0.8), device=dev)
    n0 = smap.initialize(frames[0], frames[1])
    print(f"  bootstrap: {n0} landmarks")
    for i, f in enumerate(frames[2:], start=2):
        ok, n_in, n_new = smap.add_frame(f)
        if not ok:
            print(f"  frame {i}: tracking failed ({n_in} inliers), skipped")
            continue
        print(f"  frame {i}: {n_in} PnP inliers, {n_new} new landmarks")
    stats = smap.bundle_adjust()
    print(
        f"  BA cost {float(stats.initial_cost):.1f} -> {float(stats.final_cost):.1f}; "
        f"reproj RMS {smap.reprojection_rms():.3f}px"
    )

    est = camera_centers(smap.cameras[: smap.n_cameras])
    ate = ate_rmse(est, camera_centers(cams))
    print(f"  ATE (similarity-aligned): {ate:.4f} (baseline 1.2 units)")

    save_map(str(out / "map.npz"), smap)
    save_trajectory_tum(
        str(out / "trajectory_tum.txt"), np.arange(n_frames) * 0.1,
        smap.cameras[: smap.n_cameras],
    )
    print(f"artifacts in {out}")
    return ate


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir", nargs="?", default=None,
                    help="where the artifacts go (default: video_sfm_torch under $TMPDIR)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    ate = main(args.out_dir, args.device)
    assert ate < 0.1, f"trajectory diverged: ATE {ate}"
    print("OK")
