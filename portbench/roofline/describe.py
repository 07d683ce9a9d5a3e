"""Operations and bytes of one frame's staged orientation and descriptor
kernels, from the frame's keypoints and descriptors: 90 fp32 operations a
sample of an orientation window inside the image, 284 a sample of a
rotated descriptor window inside the image (a division counted 8, sqrt
6, exp 6, atan2 35, the floor-mod by 2 pi 15); bytes only the lanes' own
reads and their histograms' writes (a lower bound: the gradient windows
are left out)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..reference.sift import Params

PATTERNS = (r"\borientation_kernel\b", r"\bdescriptor_kernel<")
ORI_OPS = 90.0
DESC_OPS = 284.0


def _plane(p: Params, h: int, w: int, octave: torch.Tensor):
    shapes = p.octave_shapes(h, w, int(octave.max()) + 1 if octave.numel() else 1)
    hh = torch.tensor([s[0] for s in shapes], device=octave.device)[octave.long()]
    ww = torch.tensor([s[1] for s in shapes], device=octave.device)[octave.long()]
    delta = p.delta_min * torch.pow(2.0, octave.float())
    return hh, ww, delta


def orientation_samples(p: Params, h: int, w: int, kp: Dict, device) -> float:
    v = torch.as_tensor(kp["valid"], device=device).bool()
    octave = torch.as_tensor(kp["octave"], device=device)[v]
    if octave.numel() == 0:
        return 0.0
    hh, ww, delta = _plane(p, h, w, octave)
    x = torch.as_tensor(kp["x"], device=device)[v] / delta
    y = torch.as_tensor(kp["y"], device=device)[v] / delta
    r = 3.0 * p.orientation_lambda * torch.as_tensor(kp["sigma"], device=device)[v] / delta
    lo = lambda c: torch.ceil(c - r).long()
    hi = lambda c: torch.floor(c + r).long()
    u0, u1 = torch.clamp(lo(x), min=0), torch.minimum(hi(x), hh - 1)
    v0, v1 = torch.clamp(lo(y), min=0), torch.minimum(hi(y), ww - 1)
    return float(((u1 - u0 + 1).clamp(min=0) * (v1 - v0 + 1).clamp(min=0)).sum())


def descriptor_samples(p: Params, h: int, w: int, desc: Dict, device, block: int = 1024) -> float:
    v = torch.as_tensor(desc["valid"], device=device).bool()
    octave = torch.as_tensor(desc["octave"], device=device)[v]
    if octave.numel() == 0:
        return 0.0
    hh, ww, delta = _plane(p, h, w, octave)
    x = torch.as_tensor(desc["x"], device=device)[v] / delta
    y = torch.as_tensor(desc["y"], device=device)[v] / delta
    sig = torch.as_tensor(desc["sigma"], device=device)[v] / delta
    th = torch.as_tensor(desc["theta"], device=device)[v]
    r = p.desc_patch_radius
    nh = p.n_histograms_per_axis
    half = p.descriptor_lambda * (nh + 1) / nh
    ar = torch.arange(-r, r + 1, device=device)
    total = 0.0
    for s in range(0, x.numel(), block):
        e = slice(s, s + block)
        rows = torch.round(x[e]).long()[:, None] + ar
        cols = torch.round(y[e]).long()[:, None] + ar
        dm = (rows.float() - x[e, None])[:, :, None]
        dn = (cols.float() - y[e, None])[:, None, :]
        ct, st = torch.cos(th[e])[:, None, None], torch.sin(th[e])[:, None, None]
        sg = sig[e][:, None, None]
        inside = (((ct * dm + st * dn) / sg).abs() < half) & (((-st * dm + ct * dn) / sg).abs() < half)
        inside &= ((rows >= 0) & (rows < hh[e, None]))[:, :, None]
        inside &= ((cols >= 0) & (cols < ww[e, None]))[:, None, :]
        total += float(inside.sum())
    return total


def work(p: Params, h: int, w: int, frame: Dict, device) -> Tuple[float, float]:
    """(bytes, operations) of one frame's orientation and descriptor
    kernels, from its keypoints and descriptors."""
    n_kp = float(torch.as_tensor(frame["kp"]["valid"]).sum())
    n_desc = float(torch.as_tensor(frame["desc"]["valid"]).sum())
    nops = (ORI_OPS * orientation_samples(p, h, w, frame["kp"], device)
            + DESC_OPS * descriptor_samples(p, h, w, frame["desc"], device))
    nbytes = 4.0 * (n_kp * (5 + p.n_orientation_bins)
                    + n_desc * (6 + p.n_histograms_per_axis ** 2 * p.n_descriptor_bins))
    return nbytes, nops
