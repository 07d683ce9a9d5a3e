"""A BAL problem generated from a seed at a configuration's sizes.

The configuration names a problem of "Bundle Adjustment in the Large"
(Agarwal et al., ECCV 2010) by its counts: cameras, points, observations,
BAL's 9-parameter camera (``reference/bal.py``). Its ``scene`` holds what
the counts leave open, each listed under the file's ``assumed``:

* cameras on a ring of ``ring_radius_m`` at ``ring_height_m``, spaced
  evenly with a jitter of a quarter of the spacing, each facing the
  centre of a ``block_m`` block of points (x, y centred on the ring's
  axis, z from the ground up); f, k1, k2 uniform in their ranges;
* points uniform in the block; a point seen by fewer than
  ``min_degree`` cameras inside the ``width`` x ``height`` image is
  drawn again;
* degrees (cameras observing a point) from P(d) ~ d^-``degree_exponent``
  on [``min_degree``, cameras], then moved by one on points drawn at
  random until they sum to ``observations``; the largest degrees go to
  the points the most cameras see, each capped at that count (what the
  caps take is moved to points with room), and a point's cameras are
  drawn at random among those that see it, again until the rays of two of
  them to the point lie ``min_ray_angle_deg`` or more from parallel
  (Bundler's ray-angle threshold for triangulating a point; on the ring,
  cameras on opposite sides see a point between them along one line
  too);
* pixels: the true projection plus Gaussian noise of ``noise_px``; the
  start: each rotation turned by ``start_rotation_rad`` about a random
  axis, each translation and point moved by ``start_offset`` of the
  ring's radius in a random direction, f scaled by 1 + N(0,
  ``start_focal_sigma``^2), k1 = k2 = 0.

Every random number comes from one CPU ``torch.Generator`` seeded with
the run's seed, in a fixed order; the work over points x cameras runs on
``device``. So one seed gives the same problem on any device.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch

from ..reference import bal as ref_bal

F64 = torch.float64


class BALProblem(NamedTuple):
    """The start and the observations, on the CPU, observations in BAL's
    order (by camera, then point)."""

    cameras: torch.Tensor  # [C, 9] float32
    points: torch.Tensor   # [L, 3] float32
    cam_idx: torch.Tensor  # [O] int32
    pt_idx: torch.Tensor   # [O] int32
    uv: torch.Tensor       # [O, 2] float32


def _rand(gen, *shape):
    return torch.rand(shape, generator=gen, dtype=F64)


def _unit(gen, n):
    v = torch.randn((n, 3), generator=gen, dtype=F64)
    return v / torch.linalg.vector_norm(v, dim=1, keepdim=True)


def _rotvec(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [n, 3, 3] -> axis-angle [n, 3], through the
    quaternion of the largest of its four Shepperd forms."""
    t = r[:, 0, 0] + r[:, 1, 1] + r[:, 2, 2]
    d = torch.stack([t, r[:, 0, 0], r[:, 1, 1], r[:, 2, 2]], 1)
    k = torch.argmax(d, 1)
    q = torch.empty((r.shape[0], 4), dtype=r.dtype)
    for i in range(4):
        m = r[k == i]
        if i == 0:
            s = 2.0 * torch.sqrt(1.0 + m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2])
            qi = [0.25 * s, (m[:, 2, 1] - m[:, 1, 2]) / s, (m[:, 0, 2] - m[:, 2, 0]) / s,
                  (m[:, 1, 0] - m[:, 0, 1]) / s]
        else:
            a, b, c = i - 1, i % 3, (i + 1) % 3
            s = 2.0 * torch.sqrt(1.0 + m[:, a, a] - m[:, b, b] - m[:, c, c])
            qi = [None] * 4
            qi[0] = (m[:, c, b] - m[:, b, c]) / s
            qi[1 + a] = 0.25 * s
            qi[1 + b] = (m[:, b, a] + m[:, a, b]) / s
            qi[1 + c] = (m[:, c, a] + m[:, a, c]) / s
        q[k == i] = torch.stack(qi, 1)
    q = q * torch.where(q[:, :1] < 0, -1.0, 1.0)
    vn = torch.linalg.vector_norm(q[:, 1:], dim=1, keepdim=True)
    return q[:, 1:] / vn.clamp(min=1e-300) * 2.0 * torch.atan2(vn, q[:, :1])


def _true_cameras(c: Dict, gen) -> torch.Tensor:
    sc = c["scene"]
    n = int(c["cameras"])
    angle = 2.0 * math.pi * (torch.arange(n, dtype=F64) + (_rand(gen, n) - 0.5) * 0.5) / n
    rad, hgt = float(sc["ring_radius_m"]), float(sc["ring_height_m"])
    centre = torch.stack([rad * torch.cos(angle), rad * torch.sin(angle), torch.full_like(angle, hgt)], 1)
    target = torch.tensor([0.0, 0.0, float(sc["block_m"][2]) / 2.0], dtype=F64)
    fwd = target - centre
    fwd = fwd / torch.linalg.vector_norm(fwd, dim=1, keepdim=True)
    right = torch.linalg.cross(fwd, torch.tensor([0.0, 0.0, 1.0], dtype=F64).expand_as(fwd), dim=1)
    right = right / torch.linalg.vector_norm(right, dim=1, keepdim=True)
    up = torch.linalg.cross(right, fwd, dim=1)
    rot = torch.stack([right, up, -fwd], 1)                 # world -> camera; it looks down -z
    t = -(rot @ centre[:, :, None])[:, :, 0]
    lo = lambda key: float(sc[key][0])
    span = lambda key: float(sc[key][1]) - float(sc[key][0])
    f = lo("focal_px") + span("focal_px") * _rand(gen, n)
    k1 = lo("k1") + span("k1") * _rand(gen, n)
    k2 = lo("k2") + span("k2") * _rand(gen, n)
    return torch.cat([_rotvec(rot), t, f[:, None], k1[:, None], k2[:, None]], 1)


def _seen(cams, pts, c: Dict) -> torch.Tensor:
    """[L, C] bool: the point lies in front of the camera and projects
    inside the image."""
    rot = ref_bal.rotation(cams[:, :3])
    p = torch.einsum("cij,lj->lci", rot, pts) + cams[None, :, 3:6]
    px = ref_bal.project(cams[None, :, :], pts[:, None, :])
    inside = (px[..., 0].abs() <= c["width"] / 2.0) & (px[..., 1].abs() <= c["height"] / 2.0)
    return inside & (p[..., 2] < 0.0)


def _move(deg, room, gen, n):
    """Adds 1 (n > 0) or takes 1 (n < 0) at |n| points drawn where
    ``room`` allows."""
    idx = torch.nonzero(room).flatten()
    pick = idx[torch.randperm(idx.shape[0], generator=gen)[: abs(n)]]
    if pick.shape[0] < abs(n):
        raise ValueError(f"no room to move {n} observations")
    deg[pick] += 1 if n > 0 else -1


def degrees(c: Dict, seen_count: torch.Tensor, gen) -> torch.Tensor:
    """[L] int64 degrees summing to the configuration's observations."""
    sc = c["scene"]
    d_min, d_max = int(sc["min_degree"]), int(c["cameras"])
    values = torch.arange(d_min, d_max + 1, dtype=F64)
    cdf = torch.cumsum(values ** -float(sc["degree_exponent"]), 0)
    n = seen_count.shape[0]
    deg = torch.searchsorted(cdf / cdf[-1], _rand(gen, n)).clamp(max=len(values) - 1) + d_min
    _move(deg, deg < d_max if int(c["observations"]) > int(deg.sum()) else deg > d_min, gen,
          int(c["observations"]) - int(deg.sum()))
    # The largest degrees to the points the most cameras see; a tie of
    # counts broken at random.
    by_seen = torch.argsort(seen_count.to(F64) + _rand(gen, n), descending=True)
    out = torch.empty_like(deg)
    out[by_seen] = torch.sort(deg, descending=True).values
    cut = out - torch.minimum(out, seen_count)
    out -= cut
    if int(cut.sum()):
        _move(out, out < seen_count, gen, int(cut.sum()))
    return out


def _choose(cams, pts, seen, deg, c: Dict, gen) -> torch.Tensor:
    """[L, C] bool: each point's cameras, the first ``deg`` of the ones
    that see it in a random order, drawn again for the points whose rays
    all lie within ``min_ray_angle_deg`` of parallel to the first one's."""
    dev = cams.device
    n_pt, n_cam = seen.shape
    centre = -(ref_bal.rotation(cams[:, :3]).mT @ cams[:, 3:6, None])[:, :, 0]
    ray = centre[None, :, :] - pts[:, None, :]
    ray = ray / torch.linalg.vector_norm(ray, dim=2, keepdim=True)       # [L, C, 3]
    min_sine = math.sin(math.radians(float(c["scene"]["min_ray_angle_deg"])))
    chosen = torch.zeros_like(seen)
    redo = torch.ones(n_pt, dtype=torch.bool, device=dev)
    for _ in range(100):
        rows = torch.nonzero(redo).flatten()
        if rows.shape[0] == 0:
            return chosen
        keys = _rand(gen, rows.shape[0], n_cam).to(dev) + 2.0 * (~seen[rows]).to(F64)
        order = torch.argsort(keys, dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(n_cam, device=dev).expand_as(order))
        chosen[rows] = rank < deg[rows, None]
        first = ray[rows, order[:, 0]]                                     # [R, 3]
        sine = torch.linalg.vector_norm(torch.linalg.cross(first[:, None, :], ray[rows], dim=2), dim=2)
        wide = (torch.where(chosen[rows], sine, 0.0).amax(1) >= min_sine)
        redo[rows] = ~wide
    raise ValueError("points whose cameras all see them along one line")


def generate(c: Dict, seed: int, device="cpu") -> BALProblem:
    """The configuration's problem for ``seed``; the [L, C] visibility and
    the choice of cameras on ``device``."""
    gen = torch.Generator().manual_seed(int(seed))
    sc = c["scene"]
    dev = torch.device(device)
    n_pt = int(c["points"])
    cams = _true_cameras(c, gen)
    block = torch.tensor(sc["block_m"], dtype=F64)
    low = torch.tensor([-block[0] / 2, -block[1] / 2, 0.0], dtype=F64)
    pts = low + block * _rand(gen, n_pt, 3)
    seen = _seen(cams.to(dev), pts.to(dev), c).cpu()
    for _ in range(100):
        few = seen.sum(1) < int(sc["min_degree"])
        if not bool(few.any()):
            break
        pts[few] = low + block * _rand(gen, int(few.sum()), 3)
        seen[few] = _seen(cams.to(dev), pts[few].to(dev), c).cpu()
    else:
        raise ValueError("points the cameras do not see")
    deg = degrees(c, seen.sum(1), gen)
    chosen = _choose(cams.to(dev), pts.to(dev), seen.to(dev), deg.to(dev), c, gen)
    pt_idx, cam_idx = torch.nonzero(chosen, as_tuple=True)
    bal_order = torch.argsort(cam_idx * n_pt + pt_idx)          # BAL's order: by camera, then point
    cam_idx, pt_idx = cam_idx[bal_order].cpu(), pt_idx[bal_order].cpu()
    uv = ref_bal.project(cams[cam_idx], pts[pt_idx])
    uv = uv + float(sc["noise_px"]) * torch.randn(uv.shape, generator=gen, dtype=F64)

    rad = float(sc["ring_radius_m"])
    n_cam = cams.shape[0]
    start = cams.clone()
    turn = ref_bal.rotation(float(sc["start_rotation_rad"]) * _unit(gen, n_cam))
    start[:, :3] = _rotvec(turn @ ref_bal.rotation(cams[:, :3]))
    start[:, 3:6] += float(sc["start_offset"]) * rad * _unit(gen, n_cam)
    start[:, 6] *= 1.0 + float(sc["start_focal_sigma"]) * torch.randn(n_cam, generator=gen, dtype=F64)
    start[:, 7:] = 0.0
    start_pts = pts + float(sc["start_offset"]) * rad * _unit(gen, n_pt)
    return BALProblem(start.float(), start_pts.float(), cam_idx.to(torch.int32),
                      pt_idx.to(torch.int32), uv.float())
