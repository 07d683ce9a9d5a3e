#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (siftmetal_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

 1. device: the card's name and power limit (nvidia-smi), then a build of
    every CUDA source of the port with nvcc for sm_90a;
 2. kernels: each CUDA kernel against its plain PyTorch version on the
    same inputs, at the shapes the 640x480 batch-8 main path gives it,
    with its tolerance, its time (CUDA events) and its bound;
 3. main path: SIFT(480, 640).extract_batch on 8 seeded noise frames (as
    bench.py makes them), with every launch counter set to 0 just before
    and read just after; frames/s from CUDA events;
 4. IPOL parity: the butterfly fixture through SIFT(340, 512).extract on
    the card, held to the bounds of tests/test_detect.py and
    tests/test_describe.py.

The last two lines of standard output are the card's nvidia-smi line and
``{"ok": true, "device": {...}}``; the line before them lists every
kernel with its launches on the main path, error, times and bound.
"""

from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# Published peaks (NVIDIA data sheets, dense, no sparsity): device-memory
# rate in bytes/s and fp32 (non-tensor-core) rate in FLOP/s.
_PEAKS = {
    "PCIe": (2.0e12, 51.2e12),
    "NVL": (3.9e12, 60.0e12),
    "SXM": (3.35e12, 67.0e12),
}


def _peaks(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return _PEAKS[key]
    return _PEAKS["SXM"]


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi unavailable"


def _time_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _require(ok, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max().item()) if a.numel() else 0.0


class Report:
    def __init__(self, name, source, replaces, tol):
        self.row = dict(name=name, route="cuda", source=source, replaces=replaces,
                        launches=0, max_abs_err=None, ms=None, plain_ms=None,
                        bound_ms=None, bound_by=None, library_ms=None)
        self.tol = tol

    def bound(self, nbytes, nops, peaks):
        bw, fl = peaks
        t_b, t_o = nbytes / bw * 1e3, nops / fl * 1e3
        self.row["bound_ms"] = max(t_b, t_o)
        self.row["bound_by"] = "bytes" if t_b >= t_o else "operations"

    def check(self, err, abs_err=None):
        """Fail unless ``err`` (the kernel's own error measure) is within
        tolerance; ``abs_err`` (default ``err``) is the max absolute error
        reported in the kernels line."""
        self.row["max_abs_err"] = err if abs_err is None else abs_err
        ok = err <= self.tol
        r = self.row
        kind = "" if abs_err is None else f"rel {err:.3e}, "
        print(f"[kernel] {r['name']}: {kind}max_abs_err {r['max_abs_err']:.3e} (tol {self.tol:.1e}) "
              f"{'ok' if ok else 'FAIL'}; {r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms; "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
        if not ok:
            raise AssertionError(f"{r['name']} disagrees with its plain version: {err} > {self.tol}")


def _table_ops(b, n_rows, n_cols, tab):
    """2 flops per tap of a banded pass over [b, n_rows, n_cols] outputs."""
    return 2.0 * b * n_rows * n_cols * float(tab.ks.sum())


def phase_kernels(peaks):
    """Each kernel against its plain version at the main path's shapes."""
    import numpy as np
    import torch

    from siftmetal_tpu_torch.config import SiftConfig
    from siftmetal_tpu_torch.ops.image import decimate_2x
    from siftmetal_tpu_torch.ops.kernels import blur as KB
    from siftmetal_tpu_torch.ops.kernels import detect as KD
    from siftmetal_tpu_torch.ops.kernels import patches as KP
    from siftmetal_tpu_torch.ops.kernels import pyramid as KY
    from siftmetal_tpu_torch.sift import describe as DS
    from siftmetal_tpu_torch.sift import detect as DT

    cfg = SiftConfig()
    dev = torch.device("cuda")
    b, h, w = 8, 480, 640
    rng = np.random.default_rng(0)
    gray = torch.from_numpy(rng.uniform(0.0, 1.0, (b, h, w)).astype(np.float32)).to(dev)
    f4 = 4.0
    reports = {}

    # --- seed + octave 0 (fused upsample + blur tables) -----------------
    rep = Report("seed_octave", "siftmetal_tpu_torch/csrc/pyramid.cu",
                 "siftmetal_tpu/ops/pallas/pyramid.py:159", 1e-5)
    g0, d0 = KY.seed_octave(gray, cfg)
    g0p, d0p = KY.seed_octave_plain(gray, cfg)
    err = max(_max_err(g0, g0p), _max_err(d0, d0p))
    tx, ty = KY.seed_tables(cfg, h, w)
    H, W = g0.shape[-2:]
    rep.row["ms"] = _time_ms(lambda: KY.seed_octave(gray, cfg), 10)
    rep.row["plain_ms"] = _time_ms(lambda: KY.seed_octave_plain(gray, cfg), 2)
    rep.bound(f4 * (gray.numel() + g0.numel() + d0.numel()),
              _table_ops(b, h, W, tx) + _table_ops(b, H, W, ty) + d0.numel(), peaks)
    rep.check(err)
    reports[rep.row["name"]] = rep

    # --- one-shot octave 1 ------------------------------------------------
    rep = Report("octave_oneshot", "siftmetal_tpu_torch/csrc/pyramid.cu",
                 "siftmetal_tpu/ops/pallas/pyramid.py:159", 1e-5)
    shapes = cfg.octave_shapes(h, w, cfg.num_octaves(h, w))
    first1 = decimate_2x(g0[:, cfg.n_scales_per_octave], shapes[1]).contiguous()
    g1, d1 = KY.octave_oneshot(first1, cfg)
    g1p, d1p = KY.octave_oneshot_plain(first1, cfg)
    err = max(_max_err(g1, g1p), _max_err(d1, d1p))
    tx, ty = KY.oneshot_tables(cfg, *shapes[1])
    rep.row["ms"] = _time_ms(lambda: KY.octave_oneshot(first1, cfg), 10)
    rep.row["plain_ms"] = _time_ms(lambda: KY.octave_oneshot_plain(first1, cfg), 2)
    rep.bound(f4 * (first1.numel() + g1.numel() + d1.numel()),
              _table_ops(b, *shapes[1], tx) + _table_ops(b, *shapes[1], ty) + d1.numel(), peaks)
    rep.check(err)
    reports[rep.row["name"]] = rep

    # --- cascade blur of octave 3 (first incremental sigma) --------------
    rep = Report("blur_stack", "siftmetal_tpu_torch/csrc/pyramid.cu",
                 "siftmetal_tpu/ops/pallas/blur.py:34", 1e-5)
    g2, _ = KY.octave_oneshot(decimate_2x(g1[:, cfg.n_scales_per_octave], shapes[2]).contiguous(), cfg)
    first3 = decimate_2x(g2[:, cfg.n_scales_per_octave], shapes[3]).contiguous()
    rho = cfg.incremental_sigmas(3)[0]
    bx, by = KB.blur_tables(float(rho), *shapes[3])
    plain = lambda: KY.band_y_plain(KY.band_x_plain(first3, bx), by, None, False)[0][:, 0]
    out3 = KB.blur_stack(first3, rho)
    err = _max_err(out3, plain())
    rep.row["ms"] = _time_ms(lambda: KB.blur_stack(first3, rho), 20)
    rep.row["plain_ms"] = _time_ms(plain, 3)
    rep.bound(f4 * 2 * first3.numel(),
              _table_ops(b, *shapes[3], bx) + _table_ops(b, *shapes[3], by), peaks)
    rep.check(err)
    reports[rep.row["name"]] = rep

    # --- detection at octave 0 ---------------------------------------------
    rep = Report("detect_candidates", "siftmetal_tpu_torch/csrc/detect.cu",
                 "siftmetal_tpu/ops/pallas/detect.py:51", 1e-5)
    thr = 0.8 * cfg.dog_threshold
    cd = KD.detect_candidates(d0, thr, cfg.edge_threshold)
    cp = KD.detect_candidates_plain(d0, thr, cfg.edge_threshold)
    for name in ("cand_col", "slot_ok", "cand_edge", "n_raw", "n_soft", "n_row_dropped"):
        if not torch.equal(getattr(cd, name), getattr(cp, name)):
            raise AssertionError(f"detect_candidates: {name} differs from the plain version")
    # Taylor fields relative to max(1, |plain|): -fmad=false makes them
    # exact in practice; large values come from near-singular Hessians.
    err = max(float(((a - c).abs() / c.abs().clamp(min=1.0)).max())
              for a, c in zip(cd.cand_fields, cp.cand_fields))
    abs_err = max(_max_err(a, c) for a, c in zip(cd.cand_fields, cp.cand_fields))
    rep.row["ms"] = _time_ms(lambda: KD.detect_candidates(d0, thr, cfg.edge_threshold), 10)
    rep.row["plain_ms"] = _time_ms(lambda: KD.detect_candidates_plain(d0, thr, cfg.edge_threshold), 2)
    interior = b * (d0.shape[1] - 2) * (H - 2) * (W - 2)
    n_soft = int(cd.n_soft.sum())
    out_bytes = sum(t.numel() * t.element_size() for t in
                    (cd.cand_col, cd.slot_ok, cd.cand_edge, *cd.cand_fields))
    # ~56 ops per interior sample (26 max + 26 min + tests), ~100 per soft
    # extremum (Taylor step and edge test).
    rep.bound(f4 * d0.numel() + out_bytes, 56.0 * interior + 100.0 * n_soft, peaks)
    rep.check(err, abs_err)
    reports[rep.row["name"]] = rep

    # --- orientation + descriptors on the lanes of a real run --------------
    per_octave, _ = DT.detect_all_octaves_batch([d0], cfg)
    budget = DT.keypoint_budget(cfg, (H, W), 0)
    kpc, _ = DT.compact_octave_keypoints(per_octave[0], 0, cfg, budget)
    fields = KP.prepare_patch_fields(g0, cfg)
    frame = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(budget)
    fl = lambda a: a.reshape(-1)
    ori_args = (fl(kpc.scale), fl(kpc.x_oct), fl(kpc.y_oct), fl(kpc.sigma_oct))
    valid = fl(kpc.valid)
    rep = Report("orientation_hist", "siftmetal_tpu_torch/csrc/patches.cu",
                 "siftmetal_tpu/ops/pallas/patches.py:1253", 1e-4)
    hk = KP.orientation_hist_lanes(fields, *ori_args, cfg, valid=valid, frame=frame)
    hp = DS.orientation_hist_plain(fields.gi, fields.gj, frame.long(), ori_args[0].long(),
                                   *ori_args[1:], valid, cfg)
    # Relative to each lane's largest bin: the same positive terms summed
    # in another order.
    err = float(((hk - hp).abs().amax(1) / hp.abs().amax(1).clamp(min=1e-12)).max())
    abs_err = _max_err(hk, hp)
    rep.row["ms"] = _time_ms(lambda: KP.orientation_hist_lanes(
        fields, *ori_args, cfg, valid=valid, frame=frame), 10)
    rep.row["plain_ms"] = _time_ms(lambda: DS.orientation_hist_plain(
        fields.gi, fields.gj, frame.long(), ori_args[0].long(), *ori_args[1:], valid, cfg), 2)
    r_max = 3.0 * cfg.orientation_lambda * fl(kpc.sigma_oct)
    n_ori_samples, cov_o = _box_samples(fl(kpc.x_oct), fl(kpc.y_oct), r_max, r_max, valid,
                                        frame, fl(kpc.scale), H, W, b, cfg)
    # ~40 fp32 operations per sample (distance, Gaussian weight, magnitude,
    # atan2, bin) — exp/atan2/sqrt counted as a few operations each.
    rep.bound(f4 * (2 * cov_o + 5 * valid.numel() + hk.numel()), 40.0 * n_ori_samples, peaks)
    rep.check(err, abs_err)
    reports[rep.row["name"]] = rep

    hist = DS._smooth_circular(hk.reshape(b, budget, -1), cfg.orientation_smoothing_iterations)
    theta, ov = DS.orientation_peaks(hist, cfg)
    m = theta.shape[-1]
    lane_valid = (ov & kpc.valid[:, :, None]).reshape(b, budget * m)
    n_lanes = (budget * 3 // 2 + 127) // 128 * 128
    order, count, _ = DT.compact_indices(lane_valid, n_lanes)
    slot_valid = torch.arange(n_lanes, device=dev)[None] < count[:, None]
    rep4 = lambda a: torch.gather(a.repeat_interleave(m, dim=1), 1, order).reshape(-1)
    d_args = (rep4(kpc.scale), rep4(kpc.x_oct), rep4(kpc.y_oct), rep4(kpc.sigma_oct),
              torch.gather(theta.reshape(b, -1), 1, order).reshape(-1))
    frame_l = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(n_lanes)
    dvalid = slot_valid.reshape(-1)
    rep = Report("descriptor_hist", "siftmetal_tpu_torch/csrc/patches.cu",
                 "siftmetal_tpu/ops/pallas/patches.py:646", 1e-4)
    dk = KP.descriptor_lanes(fields, *d_args, cfg, valid=dvalid, frame=frame_l)
    dp = DS.descriptor_plain(fields.gi, fields.gj, frame_l.long(), d_args[0].long(),
                             *d_args[1:], dvalid, cfg)
    err = float(((dk - dp).abs().amax(1) / dp.abs().amax(1).clamp(min=1e-12)).max())
    abs_err = _max_err(dk, dp)
    qd = (DS.quantize_descriptors(dk, cfg).int() - DS.quantize_descriptors(dp, cfg).int()).abs()
    if int(qd.max()) > 1:
        raise AssertionError("descriptor_hist: quantized descriptors differ by more than 1")
    rep.row["ms"] = _time_ms(lambda: KP.descriptor_lanes(
        fields, *d_args, cfg, valid=dvalid, frame=frame_l), 10)
    rep.row["plain_ms"] = _time_ms(lambda: DS.descriptor_plain(
        fields.gi, fields.gj, frame_l.long(), d_args[0].long(), *d_args[1:], dvalid, cfg), 1, 0)
    n_desc_samples = _rotated_samples(d_args, dvalid, H, W, cfg)
    half = math.sqrt(2.0) * cfg.descriptor_lambda * (cfg.n_histograms_per_axis + 1) / cfg.n_histograms_per_axis
    reach = half * d_args[3]
    _, cov_d = _box_samples(d_args[1], d_args[2], reach, reach, dvalid, frame_l, d_args[0],
                            H, W, b, cfg)
    # ~150 fp32 operations per sample inside the rotated box (rotation,
    # Gaussian weight, magnitude, atan2, 16 tent weights, <= 8 bin adds).
    rep.bound(f4 * (2 * cov_d + 6 * dvalid.numel() + dk.numel()), 150.0 * n_desc_samples, peaks)
    rep.check(err, abs_err)
    reports[rep.row["name"]] = rep
    print(f"[kernels] lanes: orientation {int(valid.sum())} valid of {valid.numel()}, "
          f"descriptor {int(dvalid.sum())} valid of {dvalid.numel()}", flush=True)
    return reports


def _box_samples(x, y, rx, ry, valid, frame, scale, H, W, b, cfg):
    """(samples in every valid lane's axis-aligned box inside the image,
    distinct field pixels those boxes cover across lanes)."""
    import torch

    u0 = torch.clamp(torch.ceil(x - rx).long(), 0, H - 1)
    u1 = torch.clamp(torch.floor(x + rx).long(), 0, H - 1)
    v0 = torch.clamp(torch.ceil(y - ry).long(), 0, W - 1)
    v1 = torch.clamp(torch.floor(y + ry).long(), 0, W - 1)
    n = ((u1 - u0 + 1).clamp(min=0) * (v1 - v0 + 1).clamp(min=0))[valid].sum()
    # Distinct pixels: a 2-D difference array per (frame, scale) plane.
    s = cfg.n_scales_per_octave
    plane = frame.long() * s + (scale.long().clamp(1, s) - 1)
    diff = torch.zeros((b * s, H + 1, W + 1), dtype=torch.int32, device=x.device)
    one = valid.to(torch.int32)
    for du, dv, sign in ((u0, v0, 1), (u0, v1 + 1, -1), (u1 + 1, v0, -1), (u1 + 1, v1 + 1, 1)):
        diff.index_put_((plane, du, dv), sign * one, accumulate=True)
    cover = diff.cumsum(1).cumsum(2)[:, :H, :W] > 0
    return float(n), float(cover.sum())


def _rotated_samples(d_args, valid, H, W, cfg):
    """Samples inside every valid lane's rotated descriptor box and the
    image (what the descriptor kernel accumulates)."""
    import torch

    scale, x, y, sig, th = d_args
    r = cfg.desc_patch_radius
    half = cfg.descriptor_lambda * (cfg.n_histograms_per_axis + 1) / cfg.n_histograms_per_axis
    ar = torch.arange(-r, r + 1, device=x.device)
    total = 0.0
    idx = torch.nonzero(valid).flatten()
    for c0 in range(0, idx.numel(), 512):
        i = idx[c0:c0 + 512]
        ci, cj = torch.round(x[i]).long(), torch.round(y[i]).long()
        rows = ci[:, None] + ar
        cols = cj[:, None] + ar
        dm = (rows.float() - x[i, None])[:, :, None]
        dn = (cols.float() - y[i, None])[:, None, :]
        ct, st = torch.cos(th[i])[:, None, None], torch.sin(th[i])[:, None, None]
        s = sig[i][:, None, None]
        xr = (ct * dm + st * dn) / s
        yr = (-st * dm + ct * dn) / s
        inside = (xr.abs() < half) & (yr.abs() < half)
        inside &= ((rows >= 0) & (rows < H))[:, :, None] & ((cols >= 0) & (cols < W))[:, None, :]
        total += float(inside.sum())
    return total


def phase_main_path(reports, smi_line):
    """SIFT(480, 640).extract_batch on 8 noise frames through the kernels."""
    import numpy as np
    import torch

    from siftmetal_tpu_torch import SIFT
    from siftmetal_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    rng = np.random.default_rng(0)
    frames = rng.uniform(0.0, 1.0, (8, 480, 640)).astype(np.float32)
    sift = SIFT(480, 640)
    x = torch.from_numpy(frames).to(sift.device)
    sift.extract_batch(x)                    # warm-up: tables, allocator
    torch.cuda.synchronize()
    reset_launches()
    kps, descs, counters = sift.extract_batch(x)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    for name, rep in reports.items():
        rep.row["launches"] = launches[name]
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"main path never launched: {missing}")
    # Outputs: shapes, dtypes, finite values, no overflow.
    n = sift.config.max_descriptors
    _require(descs.features.shape == (8, n, 128) and descs.features.dtype == torch.uint8,
             f"descriptor features {tuple(descs.features.shape)} {descs.features.dtype}")
    _require(kps.x.shape == (8, sift.config.max_keypoints), f"keypoints {tuple(kps.x.shape)}")
    for t in (kps.x, kps.y, kps.sigma, descs.x, descs.y, descs.sigma, descs.theta):
        _require(bool(torch.isfinite(t).all()), "non-finite keypoint or descriptor values")
    ctr = {k: [int(v) for v in t.cpu()] for k, t in counters.items()}
    for key in ("overflow", "descriptor_overflow", "keypoint_overflow"):
        if any(ctr[key]):
            raise AssertionError(f"main path overflow: {key}={ctr[key]}")
    if min(ctr["n_descriptors"]) <= 0:
        raise AssertionError("main path returned no descriptors")
    # Frame 0 alone gives frame 0's batched result.
    k1, d1, c1 = sift.extract(x[0])
    _require(all(int(c1[k]) == ctr[k][0] for k in c1), "batched != single-frame counters")
    fd = (d1.features[d1.valid].int() - descs.features[0][descs.valid[0]].int()).abs()
    _require(int(fd.max()) <= 1, "batched != single-frame descriptors")
    # Three windows of 5 calls each: the host runs most of the main path,
    # and host time on a shared machine spreads more than device time.
    windows = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            sift.extract_batch(x)
        end.record()
        torch.cuda.synchronize()
        windows.append(start.elapsed_time(end) / 5)
    ms = sorted(windows)[1]
    _profile(sift, x)
    print(f"[main] launches {json.dumps(launches)}", flush=True)
    print(f"[main] counters (sum over 8 frames): "
          f"{json.dumps({k: sum(v) for k, v in ctr.items()})}", flush=True)
    print(f"[main] descriptors per frame {ctr['n_descriptors']}", flush=True)
    print(f"[main] extract_batch 8x480x640: median {ms:.3f} ms/batch, {8e3 / ms:.2f} frames/s "
          f"(windows of 5 calls: {', '.join(f'{w:.3f}' for w in windows)} ms; {smi_line})",
          flush=True)
    return ms


def _profile(sift, x):
    """One main-path call under torch.profiler: the union of device kernel
    time against the host's wall time (the idle share), each stage's host
    and device span, and the kernels with the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        sift.extract_batch(x)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    events = list(prof.events())
    on_dev = lambda e: e.device_type == DeviceType.CUDA
    kern = [e for e in events if on_dev(e) and not e.name.startswith("sift_")
            and not getattr(e, "is_user_annotation", False)]
    busy, end = 0.0, -1.0
    for s0, s1 in sorted((e.time_range.start, e.time_range.end) for e in kern):
        if s1 > end:
            busy += s1 - max(s0, end)
            end = s1
    busy /= 1e3
    spans = {}
    for e in events:
        if e.name.startswith("sift_"):
            key = e.name + ("_device" if on_dev(e) else "_host")
            spans[key] = round(spans.get(key, 0.0) + e.time_range.elapsed_us() / 1e3, 3)
    per = {}
    for e in kern:
        n, c = per.get(e.name, (0.0, 0))
        per[e.name] = (n + e.time_range.elapsed_us() / 1e3, c + 1)
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:8]
    print(f"[profile] one extract_batch under the profiler: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms in {len(kern)} device ops (idle {100.0 * (1.0 - busy / wall):.1f}%); "
          f"stage spans (ms) {json.dumps(spans)}", flush=True)
    print("[profile] most device time: " + "; ".join(
        f"{name[:44]} {ms:.3f} ms x{c}" for name, (ms, c) in top), flush=True)


def phase_ipol(smi_line):
    """The butterfly on the card, held to the IPOL fixture bounds."""
    import numpy as np

    from siftmetal_tpu_torch import SIFT
    from siftmetal_tpu_torch.utils.io import load_image

    fx = ROOT / "tests" / "fixtures"
    img = load_image(str(fx / "butterfly.ppm"))
    kp, ds, ctr = SIFT(340, 512).extract(img)
    ctr = {k: int(v) for k, v in ctr.items()}
    ipol = {"n_extrema": 3068, "n_soft": 2130, "n_interp": 1934, "n_hard": 1769,
            "n_edge": 1304, "n_border": 1304}
    for stage, want in ipol.items():
        if abs(ctr[stage] - want) > max(10, 0.01 * want):
            raise AssertionError(f"IPOL stage {stage}: {ctr[stage]} vs {want}")
    for key in ("overflow", "descriptor_overflow", "keypoint_overflow"):
        if ctr[key]:
            raise AssertionError(f"butterfly overflow {key}={ctr[key]}")
    v = kp.valid.cpu().numpy()
    pts = np.stack([kp.x.cpu().numpy()[v], kp.y.cpu().numpy()[v]], 1)
    sig = kp.sigma.cpu().numpy()[v]
    with open(fx / "extra_OnEdgeResp_butterfly.txt") as f:
        ref = np.asarray([[float(p) for p in line.split()[:3]] for line in f if line.split()])
    d2 = ((pts[None] - ref[:, None, :2]) ** 2).sum(-1)
    near = d2.argmin(1)
    matched = np.sqrt(d2[np.arange(len(ref)), near]) < 0.1
    sig_err = np.abs(sig[near[matched]] - ref[matched, 2]) / ref[matched, 2]
    if matched.mean() < 0.995 or np.quantile(sig_err, 0.99) >= 1e-3:
        raise AssertionError(f"IPOL keypoints: matched {matched.mean():.4f}")
    dv = ds.valid.cpu().numpy()
    dp = np.stack([ds.x.cpu().numpy()[dv], ds.y.cpu().numpy()[dv]], 1)
    th = ds.theta.cpu().numpy()[dv]
    feats = ds.features.cpu().numpy()[dv].astype(np.float64)
    fd = np.loadtxt(str(fx / "butterfly-descriptors.txt"))
    if abs(len(feats) - len(fd)) > 0.05 * len(fd):
        raise AssertionError(f"IPOL descriptor count {len(feats)} vs {len(fd)}")
    d2 = ((dp[None] - fd[:, None, :2]) ** 2).sum(-1)
    dth = np.abs(np.mod(th[None] - fd[:, 3, None] + np.pi, 2 * np.pi) - np.pi)
    dth = np.where(d2 < 0.05 ** 2, dth, np.inf)
    near = dth.argmin(1)
    dm = dth[np.arange(len(fd)), near] < 0.05
    rel = np.linalg.norm(feats[near[dm]] - fd[dm, 4:132], axis=1) / np.linalg.norm(fd[dm, 4:132], axis=1)
    med = float(np.quantile(rel, 0.5))
    if dm.mean() < 0.93 or med >= 0.01 or (rel < 0.1).mean() < 0.98:
        raise AssertionError(f"IPOL descriptors: matched {dm.mean():.4f}, median rel {med:.4f}")
    print(f"[ipol] stages {[ctr[k] for k in ipol]} (IPOL {list(ipol.values())}); "
          f"keypoints matched {matched.mean():.4f}; descriptors {len(feats)} "
          f"(IPOL {len(fd)}), matched {dm.mean():.4f}, median rel L2 {med:.5f}; "
          f"n_movers {ctr['n_movers']} ({smi_line})", flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 2
    if not (ROOT / "siftmetal_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the siftmetal_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t0 = time.time()

    smi_line = _smi()
    print(f"[device] {smi_line}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    from siftmetal_tpu_torch.device import resolve_device
    from siftmetal_tpu_torch.ops import cuda as _cuda

    resolve_device("cuda")
    tb = time.time()
    logs = _cuda.build_all()
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or ("spill" in line and "0 bytes spill stores" not in line):
                print(f"[nvcc {name}] {line.strip()}", flush=True)
    print(f"[device] built {sorted(logs) or 'nothing (up to date)'} in {time.time() - tb:.1f} s",
          flush=True)

    reports = phase_kernels(_peaks(torch.cuda.get_device_name(0)))
    phase_main_path(reports, smi_line)
    phase_ipol(smi_line)
    print(f"[done] {time.time() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": [r.row for r in reports.values()]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        import traceback

        traceback.print_exc()
        code = 1
    sys.exit(code)
