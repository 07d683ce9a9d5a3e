"""Visual debugging: keypoint, descriptor and match overlays.

Port of ``siftmetal_tpu/utils/viz.py``: the same matplotlib calls on the
Agg backend, so a drawing equals the JAX package's pixel for pixel on the
same inputs. The functions take tensors (on any device) or arrays, return
RGB uint8 arrays and can write PNGs. matplotlib is the optional ``viz``
extra and is imported only when a function draws.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _figure_to_rgb(fig) -> np.ndarray:
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())
    return buf[..., :3].copy()


def _to_display(image) -> np.ndarray:
    img = _np(image)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return img[..., :3]


def _finish(fig, path: Optional[str]) -> np.ndarray:
    out = _figure_to_rgb(fig)
    if path:
        fig.savefig(path, dpi=100)
    _pyplot().close(fig)
    return out


def plt_figure_for(img):
    """A figure of the image's pixel size with one axes filling it, the
    image shown in (row, col) pixel coordinates."""
    plt = _pyplot()
    img = _np(img)
    h, w = img.shape[:2]
    fig = plt.figure(figsize=(w / 100, h / 100), dpi=100)
    ax = fig.add_axes([0, 0, 1, 1])
    ax.imshow(img)
    ax.set_xlim(0, w)
    ax.set_ylim(h, 0)
    ax.axis("off")
    return fig


def draw_keypoints(
    image,
    x,
    y,
    sigma,
    theta=None,
    valid=None,
    color: str = "lime",
    path: Optional[str] = None,
) -> np.ndarray:
    """Circles of radius sigma (+ orientation spokes) over the image.

    x = row, y = col (detector convention)."""
    plt = _pyplot()
    img = _to_display(image)
    x, y, sigma = _np(x), _np(y), _np(sigma)
    theta = _np(theta) if theta is not None else None
    if valid is not None:
        sel = _np(valid).astype(bool)
        x, y, sigma = x[sel], y[sel], sigma[sel]
        theta = theta[sel] if theta is not None else None

    fig = plt_figure_for(img)
    ax = fig.axes[0]
    for i in range(len(x)):
        r = max(float(sigma[i]), 1.0)
        ax.add_patch(plt.Circle((y[i], x[i]), r, fill=False, color=color, linewidth=0.8))
        if theta is not None:
            # theta measured from the row axis toward the col axis.
            ax.plot(
                [y[i], y[i] + r * np.sin(theta[i])],
                [x[i], x[i] + r * np.cos(theta[i])],
                color=color, linewidth=0.8,
            )
    return _finish(fig, path)


def draw_descriptors(
    image,
    x,
    y,
    sigma,
    theta,
    valid=None,
    n_histograms: int = 4,
    color: str = "orange",
    path: Optional[str] = None,
) -> np.ndarray:
    """Rotated 4x4 descriptor sampling grids over the image.

    Each keypoint gets its oriented descriptor footprint: a square of side
    ``n_histograms * 3 * sigma`` (the per-cell width 3*sigma of the
    descriptor histograms) rotated by theta, with the interior cell
    gridlines drawn. x = row, y = col."""
    plt = _pyplot()
    img = _to_display(image)
    x, y, sigma, theta = _np(x), _np(y), _np(sigma), _np(theta)
    if valid is not None:
        sel = _np(valid).astype(bool)
        x, y, sigma, theta = x[sel], y[sel], sigma[sel], theta[sel]

    fig = plt_figure_for(img)
    ax = fig.axes[0]
    for i in range(len(x)):
        half = 0.5 * n_histograms * 3.0 * max(float(sigma[i]), 1.0)
        ct, st = np.cos(float(theta[i])), np.sin(float(theta[i]))
        # Grid lines in the keypoint frame (u along theta, v across),
        # mapped to image coords: row = x + u*ct - v*st, col = y + u*st
        # + v*ct (theta from the row axis toward the col axis).
        for t in np.linspace(-half, half, n_histograms + 1):
            for (u0, v0, u1, v1) in ((t, -half, t, half), (-half, t, half, t)):
                r0, c0 = x[i] + u0 * ct - v0 * st, y[i] + u0 * st + v0 * ct
                r1, c1 = x[i] + u1 * ct - v1 * st, y[i] + u1 * st + v1 * ct
                ax.plot([c0, c1], [r0, r1], color=color, linewidth=0.5)
        # Orientation spoke from center to the grid edge.
        ax.plot([y[i], y[i] + half * st], [x[i], x[i] + half * ct], color=color, linewidth=0.8)
    return _finish(fig, path)


def draw_matches(
    image_a,
    xy_a,
    image_b,
    xy_b,
    pairs: Sequence[Tuple[int, int]],
    path: Optional[str] = None,
) -> np.ndarray:
    """Side-by-side correspondence rendering: xy_* are [N, 2] (row, col);
    pairs are (idx_a, idx_b)."""
    plt = _pyplot()
    a, b = _to_display(image_a), _to_display(image_b)
    xy_a, xy_b = _np(xy_a), _np(xy_b)
    h = max(a.shape[0], b.shape[0])
    canvas = np.zeros((h, a.shape[1] + b.shape[1], 3), dtype=np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1]:] = b
    off = a.shape[1]

    fig = plt_figure_for(canvas)
    ax = fig.axes[0]
    cmap = plt.get_cmap("hsv")
    for n, (i, j) in enumerate(pairs):
        ax.plot(
            [xy_a[i][1], xy_b[j][1] + off],
            [xy_a[i][0], xy_b[j][0]],
            color=cmap((n * 0.61803) % 1.0), linewidth=0.6,
        )
    return _finish(fig, path)
