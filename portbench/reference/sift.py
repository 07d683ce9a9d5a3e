"""Plain PyTorch reference of batched SIFT extraction (IPOL semantics).

A frozen copy of the plain route of the port's extraction for the routes
the benchmark's configurations take: a 2x seed with every octave-0 slice
blurred straight from the upsampled input, one-shot slices for octaves of
at least 176 rows whose radii fit, the incremental cascade below, the
dense extremum test with per-row candidate slots and the iteration-1
Taylor step, the cross-octave refinement tail, staged orientation and
descriptor histograms over lane chunks, and the global compactions.

It imports nothing of the measured program: every function here is plain
``torch`` and runs on whatever device its input lies on. Float32
throughout; a caller on a CUDA device turns TF32 off (the harness's
checks do).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_TWO_PI = 2.0 * math.pi
# The route of the configurations the reference covers: the fp32 chain,
# one-shot octaves, the incremental cascade below, staged describe.
ROUTE = {"pyramid_dtype": "float32", "use_oneshot_pyramid": True,
         "use_pallas_pyramid": False, "use_fused_describe": False}


@dataclasses.dataclass(frozen=True)
class Params:
    """The SIFT constants the reference reads (names as in a config file's
    ``sift`` group)."""

    sigma_min: float = 0.8
    delta_min: float = 0.5
    sigma_input: float = 0.5
    n_scales_per_octave: int = 3
    dog_threshold: float = 0.0133
    edge_threshold: float = 10.0
    max_interpolation_iterations: int = 5
    max_interpolation_offset: float = 0.6
    n_orientation_bins: int = 36
    orientation_lambda: float = 1.5
    orientation_peak_threshold: float = 0.8
    orientation_smoothing_iterations: int = 6
    n_histograms_per_axis: int = 4
    n_descriptor_bins: int = 8
    descriptor_lambda: float = 6.0
    max_extrema_per_octave: int = 8192
    max_keypoints: int = 4096
    max_orientations_per_keypoint: int = 4
    max_descriptors: int = 6144

    @classmethod
    def from_dict(cls, d: Dict) -> "Params":
        """The constants of a config file's ``sift`` group; raises where
        the group picks a route whose results this reference does not
        compute (the kernels' layout switches leave the results alone)."""
        for key, want in ROUTE.items():
            if d.get(key, want) != want:
                raise ValueError(f"the reference computes {key}={want!r}, the config asks {d[key]!r}")
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def num_octaves(self, height: int, width: int) -> int:
        m = min(height, width) / self.delta_min
        return max(1, int(math.floor(math.log2(m / 12.0) + 1)))

    def octave_shapes(self, height: int, width: int, n_octaves: int):
        h, w = int(height / self.delta_min), int(width / self.delta_min)
        shapes = [(h, w)]
        for _ in range(1, n_octaves):
            h, w = h // 2, w // 2
            shapes.append((h, w))
        return tuple(shapes)

    def octave_delta(self, o: int) -> float:
        return self.delta_min * (2.0 ** o)

    def octave_sigmas(self, o: int) -> Tuple[float, ...]:
        h = self.octave_delta(o) / self.delta_min
        n = self.n_scales_per_octave
        return tuple(h * self.sigma_min * 2.0 ** (s / n) for s in range(n + 3))

    def incremental_sigmas(self, o: int) -> Tuple[float, ...]:
        sig, d = self.octave_sigmas(o), self.octave_delta(o)
        return tuple(math.sqrt(sig[s] ** 2 - sig[s - 1] ** 2) / d for s in range(1, len(sig)))

    @property
    def sigma_oct_max(self) -> float:
        n = self.n_scales_per_octave
        return (self.sigma_min / self.delta_min) * 2.0 ** ((n + self.max_interpolation_offset) / n)

    @property
    def ori_patch_radius(self) -> int:
        return math.ceil(3.0 * self.orientation_lambda * self.sigma_oct_max + 0.5)

    @property
    def desc_patch_radius(self) -> int:
        nh = self.n_histograms_per_axis
        return math.ceil(math.sqrt(2.0) * self.descriptor_lambda * self.sigma_oct_max
                         * (nh + 1) / nh + 0.5)


# --- Gaussian passes -----------------------------------------------------------


def gaussian_taps(sigma: float) -> np.ndarray:
    radius = int(math.ceil(4.0 * sigma))
    k = np.arange(-radius, radius + 1, dtype=np.float64)
    w = np.exp(-0.5 * (k * k) / (sigma * sigma))
    return (w / w.sum()).astype(np.float32)


def conv1d_sym(image: torch.Tensor, taps: np.ndarray, dim: int) -> torch.Tensor:
    """Output i = sum_k taps[k] x[reflect(i - r + k)], tap 0 first, in fp32
    (half-sample symmetric reflection, period 2n)."""
    radius = len(taps) // 2
    n = image.shape[dim]
    idx = torch.remainder(torch.arange(-radius, n + radius, device=image.device), 2 * n)
    idx = torch.where(idx < n, idx, 2 * n - 1 - idx)
    x = image.index_select(dim, idx)
    acc = None
    for k in range(2 * radius + 1):
        term = float(taps[k]) * x.narrow(dim, k, n)
        acc = term if acc is None else acc + term
    return acc


def upsample_bilinear_2x(image: torch.Tensor) -> torch.Tensor:
    def interleave(a, b, dim):
        out = torch.stack([a, b], dim=dim + 1 if dim >= 0 else dim)
        shape = list(a.shape)
        shape[dim] = 2 * shape[dim]
        return out.reshape(shape)

    right = torch.cat([image[..., :, 1:], image[..., :, -1:]], dim=-1)
    cols = interleave(image, 0.5 * (image + right), -1)
    down = torch.cat([cols[..., 1:, :], cols[..., -1:, :]], dim=-2)
    return interleave(cols, 0.5 * (cols + down), -2)


def bands(x, sigmas, first, with_dog, upsample=False):
    """Every slice's X then Y pass over [B, H, W] (or its 2x upsample);
    ``first`` (if any) is slice 0. Returns (gauss, dog)."""
    x = x.float()
    if upsample:
        x = upsample_bilinear_2x(x)
    ys = [] if first is None else [first.float()]
    for s in sigmas:
        taps = gaussian_taps(float(s))
        ys.append(conv1d_sym(conv1d_sym(x, taps, -1), taps, -2))
    gauss = torch.stack(ys, dim=1)
    return gauss, (gauss[:, 1:] - gauss[:, :-1] if with_dog else None)


def seed_sigmas(p: Params) -> Tuple[float, ...]:
    d = p.delta_min
    s_in = p.sigma_input / d
    return tuple(math.sqrt((sig / d) ** 2 - s_in ** 2) for sig in p.octave_sigmas(0))


def oneshot_rhos(p: Params) -> Tuple[float, ...]:
    sig, d = p.octave_sigmas(0), p.octave_delta(0)
    return tuple(math.sqrt(sig[s] ** 2 - sig[0] ** 2) / d for s in range(1, len(sig)))


ONESHOT_MIN_ROWS = 176   # smallest octave of the one-shot route
ONESHOT_MAX_RADIUS = 24


def oneshot_route(p: Params, rows: int) -> bool:
    radii = [int(math.ceil(4.0 * r)) for r in oneshot_rhos(p)]
    return rows >= ONESHOT_MIN_ROWS and max(radii) <= ONESHOT_MAX_RADIUS


def seed_route(p: Params, h: int, w: int) -> bool:
    """Octave 0 blurred straight from the upsampled input (the fused seed)
    for the 2x seed at the frame sizes the benchmark runs."""
    return p.delta_min == 0.5 and h >= 96 and w >= 128


def pyramid(gray: torch.Tensor, p: Params, n_octaves: int):
    h, w = gray.shape[-2:]
    if not seed_route(p, h, w):
        raise ValueError("the reference covers the fused-seed route only (2x seed, h >= 96, w >= 128)")
    shapes = p.octave_shapes(h, w, n_octaves)
    gaussians, dogs = [], []
    for o in range(n_octaves):
        if o == 0:
            g, d = bands(gray, seed_sigmas(p), None, True, upsample=True)
        else:
            oh, ow = shapes[o]
            first = gaussians[o - 1][:, p.n_scales_per_octave][..., :2 * oh:2, :2 * ow:2]
            if oneshot_route(p, oh):
                g, d = bands(first, oneshot_rhos(p), first, True)
            else:
                slices = [first.float()]
                for rho in p.incremental_sigmas(o):
                    slices.append(bands(slices[-1], (rho,), None, False)[0][:, 0])
                g = torch.stack(slices, dim=1)
                d = g[:, 1:] - g[:, :-1]
        gaussians.append(g)
        dogs.append(d)
    return gaussians, dogs


# --- detection ---------------------------------------------------------------------


class Candidates(NamedTuple):
    cand_col: torch.Tensor
    slot_ok: torch.Tensor
    cand_fields: Tuple[torch.Tensor, ...]
    cand_edge: torch.Tensor
    n_raw: torch.Tensor
    n_soft: torch.Tensor
    n_row_dropped: torch.Tensor


def taylor_step(nb, c):
    gi = 0.5 * (nb(0, 1, 0) - nb(0, -1, 0))
    gj = 0.5 * (nb(0, 0, 1) - nb(0, 0, -1))
    gs = 0.5 * (nb(1, 0, 0) - nb(-1, 0, 0))
    hii = nb(0, 1, 0) + nb(0, -1, 0) - 2.0 * c
    hjj = nb(0, 0, 1) + nb(0, 0, -1) - 2.0 * c
    hss = nb(1, 0, 0) + nb(-1, 0, 0) - 2.0 * c
    hij = 0.25 * (nb(0, 1, 1) - nb(0, 1, -1) - nb(0, -1, 1) + nb(0, -1, -1))
    his = 0.25 * (nb(1, 1, 0) - nb(1, -1, 0) - nb(-1, 1, 0) + nb(-1, -1, 0))
    hjs = 0.25 * (nb(1, 0, 1) - nb(1, 0, -1) - nb(-1, 0, 1) + nb(-1, 0, -1))
    det = (hii * (hjj * hss - hjs * hjs) - hij * (hij * hss - hjs * his)
           + his * (hij * hjs - hjj * his))
    inv_det = 1.0 / det
    aa = (hjj * hss - hjs * hjs) * inv_det
    ab = (his * hjs - hij * hss) * inv_det
    ac = (hij * hjs - his * hjj) * inv_det
    bb = (hii * hss - his * his) * inv_det
    bc = (his * hij - hii * hjs) * inv_det
    cc = (hii * hjj - hij * hij) * inv_det
    oi = -(aa * gi + ab * gj + ac * gs)
    oj = -(ab * gi + bb * gj + bc * gs)
    os_ = -(ac * gi + bc * gj + cc * gs)
    value = c + 0.5 * (gi * oi + gj * oj + gs * os_)
    return oi, oj, os_, value, hii, hjj, hij


def edge_ok(hii, hjj, hij, r: float) -> torch.Tensor:
    tr = hii + hjj
    return (tr * tr / (hii * hjj - hij * hij)).abs() <= (r + 1.0) ** 2 / r


def candidates(dog: torch.Tensor, soft: float, edge: float, slots: int = 6) -> Candidates:
    """Strict 3x3x3 extrema over |DoG| > ``soft``; the first ``slots`` of
    each (frame, scale, row) in column order with their Taylor step."""
    _, s, h, w = dog.shape
    nb = lambda ds, di, dj: dog[:, 1 + ds:s - 1 + ds, 1 + di:h - 1 + di, 1 + dj:w - 1 + dj]
    c = nb(0, 0, 0)
    hi = torch.full_like(c, float("-inf"))
    lo = torch.full_like(c, float("inf"))
    for ds in (-1, 0, 1):
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                if ds or di or dj:
                    n = nb(ds, di, dj)
                    hi = torch.maximum(hi, n)
                    lo = torch.minimum(lo, n)
    raw = (c > hi) | (c < lo)
    keep = raw & (c.abs() > soft)
    count = keep.sum(-1)
    rank = keep.cumsum(-1)
    cols = torch.arange(c.shape[-1], device=dog.device)
    cand = torch.stack(
        [torch.where(keep & (rank == k + 1), cols, 0).amax(-1) for k in range(slots)], dim=-1)
    ok = count[..., None] > torch.arange(slots, device=dog.device)
    oi, oj, os_, val, hii, hjj, hij = taylor_step(nb, c)
    eok = edge_ok(hii, hjj, hij, edge)
    zero = lambda f: torch.zeros((), dtype=f.dtype, device=f.device)
    pick = lambda f: torch.where(ok, torch.gather(f, -1, cand), zero(f))
    i32 = lambda a: a.to(torch.int32)
    return Candidates(
        cand_col=i32(torch.where(ok, cand, 0)), slot_ok=ok,
        cand_fields=(pick(oi), pick(oj), pick(os_), pick(val)), cand_edge=pick(eok),
        n_raw=i32(raw.sum((1, 2, 3))), n_soft=i32(keep.sum((1, 2, 3))),
        n_row_dropped=i32((count - slots).clamp(min=0).sum((1, 2))),
    )


def extrema_budget(p: Params, shape) -> int:
    h, w = shape
    k = min(max(256, int(h * w * p.delta_min ** 2) // 32), p.max_extrema_per_octave)
    return (k + 127) // 128 * 128


def keypoint_budget(p: Params, shape, octave: int) -> int:
    k = max(256, extrema_budget(p, shape) // max(1, 4 >> octave))
    return min((k + 127) // 128 * 128, p.max_keypoints)


def mover_budget(p: Params, shapes) -> int:
    total = sum(extrema_budget(p, s) for s in shapes)
    return (max(256, total // 12) + 127) // 128 * 128


def compact_indices(valid: torch.Tensor, size: int):
    """(ascending indices of the True entries padded with 0 to ``size``,
    count, dropped)."""
    n = valid.shape[-1]
    pos = torch.cumsum(valid.to(torch.int64), -1) - 1
    total = pos[..., -1] + 1
    tgt = torch.where(valid & (pos < size), pos, size)
    src = torch.arange(n, device=valid.device).expand(valid.shape)
    out = torch.zeros(valid.shape[:-1] + (size + 1,), dtype=torch.int64, device=valid.device)
    out.scatter_(-1, tgt, src)
    count = torch.clamp(total, max=size)
    return out[..., :size], count.to(torch.int32), (total - count).to(torch.int32)


_OFFS19 = tuple((ds, di, dj) for ds in (-1, 0, 1) for di in (-1, 0, 1) for dj in (-1, 0, 1)
                if (ds != 0) + (di != 0) + (dj != 0) <= 2)
_IDX19 = {o: n for n, o in enumerate(_OFFS19)}


def _lookup(dog_all, dbase, h, w, offs, edge: float):
    b = dog_all.shape[0]

    def lookup(s, i, j):
        base = dbase + (s * h + i) * w + j
        idx = (base[:, None, :] + offs[None, :, 0, None] * (h * w)[:, None, :]
               + offs[None, :, 1, None] * w[:, None, :] + offs[None, :, 2, None])
        v = torch.gather(dog_all, 1, idx.reshape(b, -1)).reshape(idx.shape)
        at = lambda ds, di, dj: v[..., _IDX19[(ds, di, dj)], :]
        oi, oj, os_, val, hii, hjj, hij = taylor_step(at, at(0, 0, 0))
        return oi, oj, os_, val, edge_ok(hii, hjj, hij, edge)

    return lookup


def _walk(lookup, s_max, s, i, j, h, w, iterations, mo, active0):
    zeros = torch.zeros(s.shape, dtype=torch.float32, device=s.device)
    falses = torch.zeros(s.shape, dtype=torch.bool, device=s.device)
    conv, edge = falses, falses
    oi = oj = os_ = val = zeros
    done = ~active0
    for _ in range(iterations):
        noi, noj, nos, nval, nedge = lookup(s, i, j)
        nconv = (noi.abs() < mo) & (noj.abs() < mo) & (nos.abs() < mo)
        di = ((noi > mo) & (i + 1 <= h - 2)).long() - ((noi < -mo) & (i - 1 >= 1)).long()
        dj = ((noj > mo) & (j + 1 <= w - 2)).long() - ((noj < -mo) & (j - 1 >= 1)).long()
        ds = ((nos > mo) & (s + 1 <= s_max)).long() - ((nos < -mo) & (s - 1 >= 1)).long()
        active = ~done
        conv = torch.where(active, nconv, conv)
        oi, oj = torch.where(active, noi, oi), torch.where(active, noj, oj)
        os_, val = torch.where(active, nos, os_), torch.where(active, nval, val)
        edge = torch.where(active, nedge, edge)
        move = active & ~nconv
        i, j, s = torch.where(move, i + di, i), torch.where(move, j + dj, j), torch.where(move, s + ds, s)
        done = done | nconv
    return s, i, j, conv, oi, oj, os_, val, edge


KP_FIELDS = ("cand_valid", "converged", "pass_hard", "pass_edge", "pass_border", "scale",
             "i", "j", "ofst_i", "ofst_j", "ofst_s", "x", "y", "sigma", "value")


def detect(dogs: Sequence[torch.Tensor], p: Params):
    """Per-octave keypoint slot dicts and the per-frame counters."""
    outs = [candidates(d, 0.8 * p.dog_threshold, p.edge_threshold) for d in dogs]
    shapes = [tuple(d.shape[-2:]) for d in dogs]
    k_move = mover_budget(p, shapes)
    mo = p.max_interpolation_offset
    ratio = 2.0 ** (1.0 / p.n_scales_per_octave)
    dev, b = dogs[0].device, dogs[0].shape[0]
    n_sig = len(p.octave_sigmas(0))
    flat = lambda a: a.reshape(b, -1)
    seg, parts = [], {k: [] for k in ("s", "i", "j", "ok", "oi", "oj", "os", "val", "edge",
                                      "delta", "sgo", "h", "w", "oct")}
    n_ex = n_soft = drops = 0
    dog_parts, bases, off = [], [], 0
    for o, out in enumerate(outs):
        n_sc, ht, slots = out.cand_col.shape[1:]
        m_o = n_sc * ht * slots
        lane = torch.arange(m_o, device=dev)
        parts["s"].append((lane // (ht * slots) + 1).expand(b, m_o))
        parts["i"].append(((lane % (ht * slots)) // slots + 1).expand(b, m_o))
        parts["j"].append(flat(out.cand_col).long() + 1)
        parts["ok"].append(flat(out.slot_ok))
        for key, f in zip(("oi", "oj", "os", "val"), out.cand_fields):
            parts[key].append(flat(f))
        parts["edge"].append(flat(out.cand_edge))
        h, w = shapes[o]
        full = lambda v, dt: torch.full((m_o,), v, dtype=dt, device=dev)
        parts["delta"].append(full(p.octave_delta(o), torch.float32))
        parts["sgo"].append(full(o * n_sig, torch.int64))
        parts["h"].append(full(h, torch.int64))
        parts["w"].append(full(w, torch.int64))
        parts["oct"].append(full(o, torch.int64))
        seg.append(m_o)
        dog_parts.append(flat(dogs[o]))
        bases.append(off)
        off += dogs[o].shape[1] * h * w
        n_ex, n_soft = n_ex + out.n_raw, n_soft + out.n_soft
        drops = drops + out.n_row_dropped
    c = {k: torch.cat(v, -1) for k, v in parts.items()}
    sig_table = torch.tensor([s for o in range(len(shapes)) for s in p.octave_sigmas(o)],
                             dtype=torch.float32, device=dev)
    dbase_l = torch.tensor(bases, dtype=torch.int64, device=dev)[c["oct"]]
    offs = torch.tensor(_OFFS19, dtype=torch.int64, device=dev)
    n_sc_int = outs[0].cand_col.shape[1]
    dog_all = torch.cat(dog_parts, -1)
    bcast = lambda a: a.expand(b, a.shape[-1])

    def accept(cand_valid, s_f, i_f, j_f, conv, oi, oj, os_, val, eok, dlt, sgo, hh, ww):
        hard = conv & (val.abs() > p.dog_threshold)
        edge = hard & eok
        x = (i_f.float() + oi) * dlt
        y = (j_f.float() + oj) * dlt
        sigma = sig_table[sgo + s_f] * ratio ** os_
        img_h, img_w = hh.float() * dlt, ww.float() * dlt
        border = edge & (x - sigma > 0.0) & (x + sigma < img_h) & (y - sigma > 0.0) & (y + sigma < img_w)
        i32 = lambda a: a.to(torch.int32)
        return dict(cand_valid=cand_valid, converged=conv & cand_valid, pass_hard=hard & cand_valid,
                    pass_edge=edge & cand_valid, pass_border=border & cand_valid,
                    scale=i32(s_f), i=i32(i_f), j=i32(j_f), ofst_i=oi, ofst_j=oj, ofst_s=os_,
                    x=x, y=y, sigma=sigma, value=val)

    s_idx, i_idx, j_idx, ok = c["s"], c["i"], c["j"], c["ok"]
    oi1, oj1, os1 = c["oi"], c["oj"], c["os"]
    conv1 = (oi1.abs() < mo) & (oj1.abs() < mo) & (os1.abs() < mo)
    kp_g = accept(ok & conv1, s_idx, i_idx, j_idx, conv1 & ok, oi1, oj1, os1, c["val"], c["edge"],
                  bcast(c["delta"]), bcast(c["sgo"]), bcast(c["h"]), bcast(c["w"]))
    h_l, w_l = c["h"], c["w"]
    di = ((oi1 > mo) & (i_idx + 1 <= h_l - 2)).long() - ((oi1 < -mo) & (i_idx - 1 >= 1)).long()
    dj = ((oj1 > mo) & (j_idx + 1 <= w_l - 2)).long() - ((oj1 < -mo) & (j_idx - 1 >= 1)).long()
    ds = ((os1 > mo) & (s_idx + 1 <= n_sc_int)).long() - ((os1 < -mo) & (s_idx - 1 >= 1)).long()
    order, n_mov, mov_drop = compact_indices(ok & ~conv1, k_move)
    mv_valid = torch.arange(k_move, device=dev) < n_mov[:, None]
    take = lambda a: torch.gather(bcast(a), -1, order)
    s0 = torch.where(mv_valid, take(s_idx + ds), 1)
    i0 = torch.where(mv_valid, take(i_idx + di), 1)
    j0 = torch.where(mv_valid, take(j_idx + dj), 1)
    h_m, w_m, dbase_m = take(h_l), take(w_l), take(dbase_l)
    s_m, i_m, j_m, conv_m, oi_m, oj_m, os_m, val_m, edge_m = _walk(
        _lookup(dog_all, dbase_m, h_m, w_m, offs, p.edge_threshold), n_sc_int, s0, i0, j0,
        h_m, w_m, p.max_interpolation_iterations - 1, mo, mv_valid)
    kp_m = accept(mv_valid, s_m, i_m, j_m, conv_m & mv_valid, oi_m, oj_m, os_m, val_m, edge_m,
                  take(c["delta"]), take(c["sgo"]), h_m, w_m)
    cnt = lambda a: a.sum(-1, dtype=torch.int32)
    counters = {
        "n_extrema": n_ex, "n_soft": n_soft,
        "n_interp": cnt(kp_g["converged"]) + cnt(kp_m["converged"]),
        "n_hard": cnt(kp_g["pass_hard"]) + cnt(kp_m["pass_hard"]),
        "n_edge": cnt(kp_g["pass_edge"]) + cnt(kp_m["pass_edge"]),
        "n_border": cnt(kp_g["pass_border"]) + cnt(kp_m["pass_border"]),
        "overflow": drops + mov_drop, "n_movers": n_mov + mov_drop,
    }
    oct_m = take(c["oct"])
    per_octave, start = [], 0
    flags = ("cand_valid", "converged", "pass_hard", "pass_edge", "pass_border")
    for o, m_o in enumerate(seg):
        in_oct = mv_valid & (oct_m == o)
        kp = {}
        for k in KP_FIELDS:
            mv = kp_m[k] & in_oct if k in flags else kp_m[k]
            kp[k] = torch.cat([kp_g[k][:, start:start + m_o], mv], 1)
        kp["valid"] = kp["cand_valid"] & kp["pass_border"]
        per_octave.append(kp)
        start += m_o
    return per_octave, counters


# --- orientation and descriptors ------------------------------------------------


def gradients(gauss: torch.Tensor):
    lead = gauss.shape[:-2]
    g = gauss.reshape((-1, 1) + gauss.shape[-2:])
    gp = F.pad(g, (1, 1, 1, 1), mode="replicate").reshape(
        lead + (gauss.shape[-2] + 2, gauss.shape[-1] + 2))
    return 0.5 * (gp[..., 2:, 1:-1] - gp[..., :-2, 1:-1]), 0.5 * (gp[..., 1:-1, 2:] - gp[..., 1:-1, :-2])


def _smooth(hist: torch.Tensor, iterations: int) -> torch.Tensor:
    for _ in range(iterations):
        hist = (torch.roll(hist, 1, dims=-1) + hist + torch.roll(hist, -1, dims=-1)) / 3.0
    return hist


def orientation_peaks(hist: torch.Tensor, p: Params):
    n = p.n_orientation_bins
    prev, nxt = torch.roll(hist, 1, dims=-1), torch.roll(hist, -1, dims=-1)
    is_peak = ((hist > prev) & (hist > nxt)
               & (hist >= p.orientation_peak_threshold * hist.amax(-1, keepdim=True)) & (hist > 0.0))
    offset = (prev - nxt) / (2.0 * (prev + nxt - 2.0 * hist))
    bins = torch.arange(n, dtype=torch.float32, device=hist.device)
    theta = torch.remainder((bins + 0.5 + offset) * (_TWO_PI / n) + math.pi, _TWO_PI) - math.pi
    score = torch.where(is_peak, hist, torch.full_like(hist, float("-inf")))
    k = p.max_orientations_per_keypoint
    top, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    valid = torch.isfinite(top[..., :k])
    theta = torch.gather(theta, -1, idx[..., :k])
    return torch.where(valid, theta, torch.zeros_like(theta)), valid


def quantize(raw: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.vector_norm(raw, dim=-1, keepdim=True)
    clipped = torch.minimum(raw, 0.2 * norm)
    norm2 = torch.linalg.vector_norm(clipped, dim=-1, keepdim=True)
    q = torch.floor(512.0 * clipped / torch.clamp(norm2, min=1e-12))
    return torch.clamp(q, max=255.0).to(torch.uint8)


def _patches(gi_p, gj_p, idx, frame, scale, x, y, radius):
    b, s, hp, wp = gi_p.shape
    h, w = hp - 2 * radius, wp - 2 * radius
    n = 2 * radius + 1
    fr, sc = frame[idx].clamp(0, b - 1), scale[idx].clamp(1, s) - 1
    xs, ys = x[idx], y[idx]
    ci = torch.round(xs).long().clamp(0, h - 1)
    cj = torch.round(ys).long().clamp(0, w - 1)
    ar = torch.arange(n, device=gi_p.device)
    rows, cols = (ci[:, None] + ar)[:, :, None], (cj[:, None] + ar)[:, None, :]
    f3, s3 = fr[:, None, None], sc[:, None, None]
    arf = ar.to(torch.float32)
    dm = ((ci.to(torch.float32) - radius)[:, None] + arf - xs[:, None])[:, :, None]
    dn = ((cj.to(torch.float32) - radius)[:, None] + arf - ys[:, None])[:, None, :]
    return gi_p[f3, s3, rows, cols], gj_p[f3, s3, rows, cols], dm, dn


def _chunks(valid: torch.Tensor, chunk: int):
    live = torch.nonzero(valid).flatten()
    for c0 in range(0, live.numel(), chunk):
        yield live[c0:c0 + chunk]


def orientation_hist(gi, gj, frame, scale, x, y, sigma, valid, p: Params, chunk: int):
    r, nb, lam = p.ori_patch_radius, p.n_orientation_bins, p.orientation_lambda
    out = torch.zeros((scale.shape[0], nb), dtype=torch.float32, device=gi.device)
    gi_p, gj_p = F.pad(gi, (r, r, r, r)), F.pad(gj, (r, r, r, r))
    for idx in _chunks(valid, chunk):
        pi, pj, dm, dn = _patches(gi_p, gj_p, idx, frame, scale, x, y, r)
        sig = sigma[idx][:, None, None]
        r_max = 3.0 * lam * sig
        inside = (dm.abs() <= r_max) & (dn.abs() <= r_max)
        mag = torch.sqrt(pi * pi + pj * pj)
        wgt = torch.exp(-(dm * dm + dn * dn) / (2.0 * (lam * sig) ** 2)) * mag * inside
        theta = torch.remainder(torch.atan2(pj, pi), _TWO_PI)
        bins = torch.remainder(torch.round(theta * (nb / _TWO_PI)).long(), nb)
        c = idx.shape[0]
        hist = torch.zeros((c, nb), dtype=torch.float32, device=gi.device)
        hist.scatter_add_(1, bins.reshape(c, -1), wgt.reshape(c, -1))
        out[idx] = hist
    return out


def descriptor_hist(gi, gj, frame, scale, x, y, sigma, theta, valid, p: Params, chunk: int):
    r, nh, no, lam = p.desc_patch_radius, p.n_histograms_per_axis, p.n_descriptor_bins, p.descriptor_lambda
    dev = gi.device
    out = torch.zeros((scale.shape[0], nh * nh * no), dtype=torch.float32, device=dev)
    half, cell = lam * (nh + 1) / nh, 2.0 * lam / nh
    centers = (torch.arange(1, nh + 1, dtype=torch.float32, device=dev) - (nh + 1) / 2.0) * cell
    ocenters = torch.arange(no, dtype=torch.float32, device=dev) * (_TWO_PI / no)
    gi_p, gj_p = F.pad(gi, (r, r, r, r)), F.pad(gj, (r, r, r, r))
    for idx in _chunks(valid, chunk):
        pi, pj, dm, dn = _patches(gi_p, gj_p, idx, frame, scale, x, y, r)
        sig = sigma[idx][:, None, None]
        th = theta[idx][:, None, None]
        ct, st = torch.cos(th), torch.sin(th)
        xr, yr = (ct * dm + st * dn) / sig, (-st * dm + ct * dn) / sig
        inside = (xr.abs() < half) & (yr.abs() < half)
        mag = torch.sqrt(pi * pi + pj * pj)
        contrib = torch.exp(-(xr * xr + yr * yr) / (2.0 * lam * lam)) * mag * inside
        wr = torch.clamp(1.0 - (xr[..., None] - centers).abs() / cell, min=0.0)
        wc = torch.clamp(1.0 - (yr[..., None] - centers).abs() / cell, min=0.0)
        phi = torch.remainder(torch.atan2(pj, pi) - th, _TWO_PI)
        d = (phi[..., None] - ocenters).abs()
        d = torch.minimum(d, _TWO_PI - d)
        wo = torch.clamp(1.0 - d * (no / _TWO_PI), min=0.0)
        c = idx.shape[0]
        ab = (contrib[..., None, None] * wr[..., :, None] * wc[..., None, :]).reshape(c, -1, nh * nh)
        out[idx] = torch.einsum("cpa,cpk->cak", ab, wo.reshape(c, -1, no)).reshape(c, -1)
    return out


def describe(gaussians, dogs, per_octave, p: Params, chunk: int):
    b, dev = gaussians[0].shape[0], gaussians[0].device
    lane_overflow = torch.zeros((b,), dtype=torch.int32, device=dev)
    rows = []
    n = p.n_scales_per_octave
    for o, kp in enumerate(per_octave):
        h, w = dogs[o].shape[-2:]
        budget = keypoint_budget(p, (h, w), o)
        order, count, dropped = compact_indices(kp["valid"], budget)
        lane_overflow = lane_overflow + dropped
        take = lambda a: torch.gather(a, -1, order)
        kvalid = torch.arange(budget, device=dev) < count[..., None]
        delta = p.octave_delta(o)
        k = dict(scale=take(kp["scale"]), x_oct=take(kp["i"].float() + kp["ofst_i"]),
                 y_oct=take(kp["j"].float() + kp["ofst_j"]), sigma_oct=take(kp["sigma"]) / delta,
                 x=take(kp["x"]), y=take(kp["y"]), sigma=take(kp["sigma"]))
        gi, gj = gradients(gaussians[o][:, 1:n + 1])
        gi, gj = gi.contiguous(), gj.contiguous()
        flat = lambda a: a.reshape(b * budget)
        frame = torch.arange(b, device=dev).repeat_interleave(budget)
        hist = orientation_hist(gi, gj, frame, flat(k["scale"]).long(), flat(k["x_oct"]),
                                flat(k["y_oct"]), flat(k["sigma_oct"]), flat(kvalid), p, chunk)
        hist = _smooth(hist.reshape(b, budget, -1), p.orientation_smoothing_iterations)
        theta, ov = orientation_peaks(hist, p)
        m = theta.shape[-1]
        lane_valid = (ov & kvalid[:, :, None]).reshape(b, budget * m)
        n_lanes = (budget * 3 // 2 + 127) // 128 * 128
        lorder, lcount, ldropped = compact_indices(lane_valid, n_lanes)
        slot_valid = torch.arange(n_lanes, device=dev)[None, :] < lcount[:, None]
        lane_overflow = lane_overflow + ldropped
        rep = lambda a: torch.gather(a.repeat_interleave(m, dim=1), 1, lorder)
        theta_l = torch.gather(theta.reshape(b, budget * m), 1, lorder)
        fl = lambda a: a.reshape(b * n_lanes)
        frame_l = torch.arange(b, device=dev).repeat_interleave(n_lanes)
        raw = descriptor_hist(gi, gj, frame_l, fl(rep(k["scale"])).long(), fl(rep(k["x_oct"])),
                              fl(rep(k["y_oct"])), fl(rep(k["sigma_oct"])), fl(theta_l),
                              fl(slot_valid), p, chunk)
        rows.append(dict(valid=slot_valid,
                         octave=torch.full((b, n_lanes), o, dtype=torch.int32, device=dev),
                         x=rep(k["x"]), y=rep(k["y"]), sigma=rep(k["sigma"]), theta=theta_l,
                         features=quantize(raw).reshape(b, n_lanes, -1)))
    return rows, lane_overflow


def extract(grays: torch.Tensor, p: Params, n_octaves: int, chunk: int = 128):
    """[B, H, W] fp32 -> (keypoints, descriptors, counters), dicts of
    [B, ...] tensors with the port's field names and padded budgets."""
    gaussians, dogs = pyramid(grays, p, n_octaves)
    per_octave, counters = detect(dogs, p)
    rows, lane_overflow = describe(gaussians, dogs, per_octave, p, chunk)
    del gaussians, dogs
    dev = grays.device
    n_kp = p.max_keypoints
    valid = torch.cat([kp["valid"] for kp in per_octave], -1)
    octave = torch.cat([torch.full_like(kp["scale"], o) for o, kp in enumerate(per_octave)], -1)
    order, count, kp_dropped = compact_indices(valid, n_kp)
    take = lambda a: torch.gather(a, -1, order)
    cat = lambda f: torch.cat([kp[f] for kp in per_octave], -1)
    keypoints = dict(valid=torch.arange(n_kp, device=dev) < count[..., None], octave=take(octave),
                     scale=take(cat("scale")), x=take(cat("x")), y=take(cat("y")),
                     sigma=take(cat("sigma")), value=take(cat("value")))
    n = p.max_descriptors
    dvalid = torch.cat([r["valid"] for r in rows], 1)
    dorder, dcount, ddropped = compact_indices(dvalid, n)

    def dtake(field):
        a = torch.cat([r[field] for r in rows], 1)
        if a.ndim == 2:
            return torch.gather(a, 1, dorder)
        return torch.gather(a, 1, dorder[:, :, None].expand(-1, -1, a.shape[-1]))

    descriptors = dict(valid=torch.arange(n, device=dev)[None, :] < dcount[:, None],
                       **{f: dtake(f) for f in ("octave", "x", "y", "sigma", "theta", "features")})
    counters = dict(counters, n_descriptors=dcount, descriptor_overflow=ddropped + lane_overflow,
                    keypoint_overflow=kp_dropped)
    return keypoints, descriptors, counters
