"""Seeded procedural frames with a natural-image-like spectrum, made on
the device in a few large calls.

The generator of the repository's procedural test images
(``tests/fixtures/make_procedural.py``), batched over frames in torch:
multi-octave value noise (1/f-ish spectrum) plus discs, rotated bars and
Gaussian blobs, stretched between the 1st and 99th percentile, clipped
and quantized to 8-bit levels. Every random number comes from one
``torch.Generator`` in a fixed order and nothing accumulates through
atomics, so one seed gives the same bits on every run on one device.
"""

from __future__ import annotations

import math

import torch

NOISE_OCTAVES = 6
PERSISTENCE = 0.55
SHAPES = 60


def _smoothstep_axis(n_out: int, n_grid: int, device):
    t = torch.linspace(0.0, n_grid - 1, n_out, device=device, dtype=torch.float64)
    i0 = torch.floor(t).long()
    i1 = torch.clamp(i0 + 1, max=n_grid - 1)
    f = (t - i0).float()
    return i0, i1, f * f * (3.0 - 2.0 * f)


def _value_noise(n, h, w, gen, device):
    img = torch.zeros((n, h, w), dtype=torch.float32, device=device)
    amp = 1.0
    for o in range(NOISE_OCTAVES):
        gh = max(2, h >> (NOISE_OCTAVES - 1 - o))
        gw = max(2, w >> (NOISE_OCTAVES - 1 - o))
        grid = torch.rand((n, gh, gw), generator=gen, device=device) * 2.0 - 1.0
        y0, y1, fy = _smoothstep_axis(h, gh, device)
        x0, x1, fx = _smoothstep_axis(w, gw, device)
        rows0, rows1 = grid[:, y0], grid[:, y1]
        top = rows0[:, :, x0] * (1 - fx) + rows0[:, :, x1] * fx
        bot = rows1[:, :, x0] * (1 - fx) + rows1[:, :, x1] * fx
        img += amp * (top * (1 - fy[:, None]) + bot * fy[:, None])
        amp *= PERSISTENCE
    return img


def _shapes(n, h, w, gen, device):
    u = torch.rand((9, n, SHAPES), generator=gen, device=device)
    kind = torch.floor(u[0] * 3.0).clamp(max=2)
    cy, cx = u[1] * h, u[2] * w
    amp = u[3] * 1.2 - 0.6
    radius = 3.0 + u[4] * 37.0
    theta = u[5] * math.pi
    half_w, half_l = 2.0 + u[6] * 10.0, 20.0 + u[7] * 100.0
    blob = 4.0 + u[8] * 26.0
    yy = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    img = torch.zeros((n, h, w), dtype=torch.float32, device=device)
    at = lambda a, k: a[:, k, None, None]
    for k in range(SHAPES):
        dy, dx = yy - at(cy, k), xx - at(cx, k)
        r2 = dy * dy + dx * dx
        c, s = torch.cos(at(theta, k)), torch.sin(at(theta, k))
        along, across = dy * c + dx * s, -dy * s + dx * c
        disc = (r2 < at(radius, k) ** 2).float()
        bar = ((along.abs() < at(half_w, k)) & (across.abs() < at(half_l, k))).float()
        gauss = torch.exp(-r2 / (2.0 * at(blob, k) ** 2))
        kk = at(kind, k)
        shape = torch.where(kk == 0, disc, torch.where(kk == 1, bar, gauss))
        img += at(amp, k) * shape
    return img


def procedural_frames(n: int, h: int, w: int, seed: int, device) -> torch.Tensor:
    """[n, h, w] float32 frames in [0, 1] on 8-bit levels, from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    img = 0.7 * _value_noise(n, h, w, gen, device) + _shapes(n, h, w, gen, device)
    flat = img.reshape(n, -1)
    m = flat.shape[1]
    lo = flat.kthvalue(max(1, round(0.01 * (m - 1)) + 1), dim=1).values
    hi = flat.kthvalue(max(1, round(0.99 * (m - 1)) + 1), dim=1).values
    img = ((img - lo[:, None, None]) / (hi - lo).clamp(min=1e-6)[:, None, None]).clamp(0.0, 1.0)
    return torch.floor(img * 255.0) / 255.0
