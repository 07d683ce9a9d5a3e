"""Two-image matching demo on the PyTorch/CUDA port: extract, match,
RANSAC-verify, visualize.

The counterpart of ``examples/match_pair.py`` on ``siftmetal_tpu_torch``
(the same steps, prints and drawing: up to 150 inlier matches side by
side, ``matches.png`` in ``out_dir``; drawing needs matplotlib, the
``viz`` extra, and is skipped with a note without it). Runs on the CUDA
card unless ``--device cpu`` is given, and raises without a card.

Usage:
    python examples/match_pair_torch.py image_a image_b [--out-dir DIR]
    python examples/match_pair_torch.py        # butterfly vs rotated butterfly
    python examples/match_pair_torch.py --device cpu

``out_dir`` defaults to ``match_pair_torch`` under the temporary directory
(``$TMPDIR``).
"""

import argparse
import importlib.util
import pathlib
import sys
import tempfile

# Allow running straight from a source checkout.
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch


def main(path_a=None, path_b=None, device=None, out_dir=None):
    """Returns (putative matches, RANSAC inliers, geometry score)."""
    from siftmetal_tpu_torch import SIFT
    from siftmetal_tpu_torch.device import resolve_device
    from siftmetal_tpu_torch.geometry import find_homography
    from siftmetal_tpu_torch.match import geometry_score, match_bruteforce
    from siftmetal_tpu_torch.ops.image import rgb_to_gray
    from siftmetal_tpu_torch.ops.warp import similarity_homography, warp_perspective
    from siftmetal_tpu_torch.utils.io import load_image
    from siftmetal_tpu_torch.utils.viz import draw_matches

    dev = resolve_device(device)
    out = pathlib.Path(out_dir or pathlib.Path(tempfile.gettempdir()) / "match_pair_torch")
    out.mkdir(parents=True, exist_ok=True)

    def gray_of(path):
        img = torch.from_numpy(load_image(path)).to(dev)
        return rgb_to_gray(img) if img.ndim == 3 else img

    if path_a is None:
        path_a = str(
            pathlib.Path(__file__).resolve().parents[1]
            / "tests" / "fixtures" / "butterfly.ppm"
        )
    gray_a = gray_of(path_a)

    if path_b is None:
        h, w = gray_a.shape
        hmat = similarity_homography(np.deg2rad(20.0), 0.95, center=(h / 2, w / 2))
        gray_b = warp_perspective(gray_a, hmat, (h, w))
        print("image B = A rotated 20deg, scaled 0.95")
    else:
        gray_b = gray_of(path_b)

    sift_a = SIFT(*gray_a.shape, device=dev)
    sift_b = sift_a if gray_a.shape == gray_b.shape else SIFT(*gray_b.shape, device=dev)
    _, da, _ = sift_a.extract(gray_a)
    _, db, _ = sift_b.extract(gray_b)
    print(f"descriptors: A {int(da.valid.sum())}, B {int(db.valid.sum())}")

    m = match_bruteforce(da.features, db.features, da.valid, db.valid)
    n_m = int(m.count)
    print(f"putative matches: {n_m}")

    xy_a = torch.stack([da.x, da.y], dim=1)
    xy_b = torch.stack([db.x, db.y], dim=1)
    gscore = float(geometry_score(m, xy_a, xy_b))
    print(f"geometry-consistency score: {gscore:.3f}")

    gen = torch.Generator(device=dev).manual_seed(0)
    res = find_homography(
        gen, xy_a, xy_b[m.target_idx.long()], m.valid, inlier_threshold=3.0
    )
    n_in = int(res.n_inliers)
    print(f"RANSAC homography inliers: {n_in}/{n_m}")

    if importlib.util.find_spec("matplotlib") is None:
        print("matches.png not drawn: matplotlib (the viz extra) is not installed")
        return n_m, n_in, gscore
    inl = res.inliers.cpu().numpy()
    target = m.target_idx.cpu().numpy()
    pairs = [(i, int(target[i])) for i in np.nonzero(inl)[0][:150]]
    draw_matches(gray_a, xy_a, gray_b, xy_b, pairs, path=str(out / "matches.png"))
    print(f"wrote {out / 'matches.png'}")
    return n_m, n_in, gscore


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("images", nargs="*", help="image_a [image_b]: PNG or binary PGM/PPM")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out-dir", default=None,
                    help="where matches.png goes (default: match_pair_torch under $TMPDIR)")
    args = ap.parse_args()
    if len(args.images) > 2:
        ap.error("at most two images")
    n_m, n_in, gscore = main(*args.images, device=args.device, out_dir=args.out_dir)
    if not args.images:  # self-test mode
        assert n_m > 300, n_m
        assert n_in > 0.8 * n_m, (n_in, n_m)
        assert gscore > 0.8, gscore
        print("OK")
