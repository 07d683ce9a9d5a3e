#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (siftmetal_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

 1. device: the card's name and power limit (nvidia-smi), then a build of
    every CUDA source of the port with nvcc for sm_90a;
 2. kernels: each CUDA kernel against its plain PyTorch version on the
    same inputs, at the shapes the 640x480 batch-8 paths give it, with
    its tolerance, its time (CUDA events) and its bound (sixteen rows;
    blur_cascade and blur_cascade_bf16, one launch a small-octave cascade,
    also against the five per-stage band launches they replace, bit for
    bit, there and at the butterfly's cascade octaves;
    orientation_hist_banded and descriptor_hist_banded also against the
    staged kernels, bit for bit, each with its CUDA lane layout against
    tile_layout run by run and a sweep of its tile side; orient_desc's
    descriptors against the staged descriptor kernel at its own theta,
    bit for bit; the descriptor rows, the fused row and the resident rows
    launched twice and equal bit for bit, with their registers, stack
    frame and spills from the build log; detection also over every octave
    of the parity batch in one launch, field by field against the plain
    version per octave and on dense rows, with the band-height sweep; the
    orientation kernel also over every octave of the parity batch in one
    launch, bit for bit against one launch an octave and the resident
    form; every pyramid kernel also beside a cuDNN yardstick of the same
    function, its library_ms);
 3. main path: SIFT(480, 640).extract_batch on 8 seeded noise frames (as
    bench.py makes them): its first call captures a CUDA graph (time and
    device memory printed), then a replay with every launch counter set to
    0 just before and read just after; a replay runs no wrapper, so its
    launches are counted on the device, by kernel name, in a profile of
    that call, and held group by group against an eager
    extract_gray_batch's counters (pyramid, detection and orientation
    launches checked exactly); the replay against the eager call bit for
    bit in every field, and again after a second replay on other frames
    (as in every phase that drives a configuration); the replay and the
    eager call timed in turns (CUDA events, frames/s) and each profiled
    once (idle share);
 4. fast path: SIFT(480, 640, config=FAST_BF16_CONFIG).extract_batch on
    the same frames and match_bruteforce over the 4 frame pairs, counters
    set to 0 just before and read just after; then a 4096 x 131072 map
    through the blocked matcher, and one extract_batch each under the
    fused-cascade, lean-detection and fused-describe switches;
 5. verified pairs: a natural-content 480x640 frame (tests/fixtures/
    proc_a.pgm), six views of it warped on the card by known homographies
    and one unrelated frame (proc_b.pgm) through
    SIFT(480, 640, SiftConfig(use_band_patches=True)).extract_batch (the
    two resident-tile patch kernels; counters set to 0 just before and
    read just after), match_bruteforce of frame 0 against each other frame
    and find_homography on each; gates on the recovered homographies, the
    unrelated frame, keypoint repeatability and equality with the staged
    route. Then the pose leg on synthetic scenes: find_fundamental ->
    essential_from_fundamental -> recover_pose -> triangulate, and
    pnp_ransac; times of RANSAC, the warp and the small batched SVDs;
 6. sfm: bundle_adjust at 256 cameras / 65,536 landmarks / 196,608
    observations (tests/test_slam.py's mapping-size gates, ms per call,
    peak memory, device busy and idle share), then SfmMap's solve of it
    (slam.sfm.replayed_bundle_adjust, CUDA graphs) against the eager call:
    bits, capture seconds, memory kept, ms in turns, one profiled call of
    each (as for every program below); examples/video_sfm_torch.py's
    scene at 480x640 rendered on the CPU (the same bits every run),
    extracted on the card with the launch counters set to 0 just before
    and read just after, then SfmMap at its
    full budgets (every frame registered, RMS < 1 px, ATE < 0.1; ms per
    add_frame and of the global BA; the programs cached and the memory
    reserved after it; the global BA's replay against its eager call); the
    52-keyframe loop-closure scene of tests/test_sfm.py (every frame
    registered and its three bars on one named RANSAC stream, whose
    60-iteration pose graph is replayed against its eager call; two more
    streams printed, the default stream among them:
    scripts/loop_scene_streams.py holds the statistic over many; the
    programs and memory after the scene);
 7. parallel: the multi-device layer in a child process (this script with
    --parallel-child), so its NCCL process group stays out of the other
    phases. The child starts before the kernels' build and gets ready
    meanwhile (imports, CUDA context, multihost.initialize at world size 1
    through NCCL and a barrier, the frame loader's build); it waits for
    the parent's go before it runs anything timed. Each of the three
    programs replays CUDA graphs with its collectives inside and is held
    against its eager route (``run.eager``) as in phase 6:
    make_batch_extractor on phase 3's frames (launch counters set to 0
    just before and read just after; the replay's launches counted on the
    device by kernel name and held against the eager route's counters,
    the main path's launches checked; every field equal to extract_batch
    bit for bit); make_sharded_matcher on phase 4's map (equal to
    match_bruteforce); make_distributed_ba at phase 6's mapping size (cost
    to below 1, within 1e-4 / 1e-3 of bundle_adjust); run_elastic with one
    injected failure;
    FrameLoader on eight PPM frames of the video scene, extracted on the
    card. ms of each beside its one-device counterpart;
 8. flat: eight flat 480x640 frames through every pyramid route (one
    value a Gaussian and DoG plane) and through extract_batch under the
    parity configuration and FAST_BF16_CONFIG (no extremum); the
    butterfly with a flat block pasted in (no strict extremum and one
    value a slice inside the block's interior);
 9. IPOL parity: the butterfly fixture through SIFT(340, 512).extract on
    the card, held to the bounds of tests/test_detect.py and
    tests/test_describe.py; then the fast-preset gates: bf16 against fp32
    keypoint agreement, and butterfly-vs-itself matching.

The last two lines of standard output are the card's nvidia-smi line and
``{"ok": true, "device": {...}}``; the line before them lists every
kernel with its launches on the path that runs it, error, times and bound.
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


def _ptxas_facts(log: str) -> dict:
    """Per kernel entry of an ``nvcc -Xptxas -v`` log: registers, stack
    frame and spill bytes, keyed by the mangled name."""
    import re

    facts, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            facts.setdefault(name, {}).update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                              spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            facts.setdefault(name, {})["registers"] = int(m.group(1))
    return facts


PTXAS = {}  # kernel entry -> ptxas facts of this run's build


def _ptxas_line(fragment: str) -> str:
    """The ptxas facts of the one entry whose name holds ``fragment``."""
    hits = [(k, v) for k, v in PTXAS.items() if fragment in k]
    if len(hits) != 1:
        return f"ptxas facts of {fragment}: not in this run's build log"
    f = hits[0][1]
    return (f"{fragment}: {f.get('registers')} registers, {f.get('stack')} B stack frame, "
            f"spills {f.get('spill_stores')} B stored / {f.get('spill_loads')} B loaded")


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


def _queued_ms(fn, iters: int = 20) -> float:
    """Device ms per call of ``fn`` with the host ahead of the card: a
    sleep kernel holds the stream while the host queues ``iters`` calls,
    so the events time the calls' device work and not their host work."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)                # ~20 ms of cycles
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
        self.ops = nops
        t_b, t_o = nbytes / bw * 1e3, nops / fl * 1e3
        self.sides = f"bytes {t_b:.4f} ms, operations {t_o:.4f} ms"
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
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}: {self.sides})", flush=True)
        if not ok:
            raise AssertionError(f"{r['name']} disagrees with its plain version: {err} > {self.tol}")


# fp32 operations per sample of the patch kernels' loops (csrc/patches.cu),
# a division counted as 8 (reciprocal and refinement), sqrtf 6, expf 6,
# atan2f 35, the floor-mod by 2 pi 15.
# Orientation: offsets and the box test 6, magnitude 9, Gaussian weight
# (3 + division + exp + 1) 18, atan2 35, mod 15, bin (scale, round, two
# integer mods counted 4) 6, the add 1.
ORI_OPS = 90.0
# Descriptor: rotation with two divisions 22, the box test 2, magnitude 9,
# Gaussian weight 18, eight spatial tent weights (sub, abs, division, sub,
# max: 12 each) 96, atan2 and mod 51, eight orientation tents of 7, and up
# to 2 x 2 x 2 bin updates of 3 with their 6 partial products 30.
DESC_OPS = 284.0


def _pass_ops(b, n_rows, n_cols, tab):
    """2 flops per tap of both passes of every slice of ``tab``
    (``slice_taps``) over [b, n_rows, n_cols] outputs."""
    return 2.0 * 2.0 * b * n_rows * n_cols * float((2 * tab.radius + 1).sum())


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

    # --- seed + octave 0 (upsample, then every slice's blur) -------------
    rep = Report("seed_octave", "siftmetal_tpu_torch/csrc/pyramid.cu",
                 "siftmetal_tpu/ops/pallas/pyramid.py:159", 1e-5)
    g0, d0 = KY.seed_octave(gray, cfg)
    g0p, d0p = KY.seed_octave_plain(gray, cfg)
    err = max(_max_err(g0, g0p), _max_err(d0, d0p))
    tab = KY.slice_taps(KY._seed_sigmas(cfg))
    H, W = g0.shape[-2:]
    rep.row["ms"] = _time_ms(lambda: KY.seed_octave(gray, cfg), 10)
    rep.row["plain_ms"] = _time_ms(lambda: KY.seed_octave_plain(gray, cfg), 2)
    rep.bound(f4 * (gray.numel() + g0.numel() + d0.numel()),
              _pass_ops(b, H, W, tab) + d0.numel(), peaks)
    _library(rep, lambda: _seed_library(gray, cfg), (g0, d0), 3)
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
    tab = KY.slice_taps(KY.oneshot_rhos(cfg))
    rep.row["ms"] = _time_ms(lambda: KY.octave_oneshot(first1, cfg), 10)
    rep.row["plain_ms"] = _time_ms(lambda: KY.octave_oneshot_plain(first1, cfg), 2)
    rep.bound(f4 * (first1.numel() + g1.numel() + d1.numel()),
              _pass_ops(b, *shapes[1], tab) + d1.numel(), peaks)
    _library(rep, lambda: _oneshot_library(first1, cfg), (g1, d1), 5)
    rep.check(err)
    reports[rep.row["name"]] = rep

    # --- cascade blur of octave 3 (first incremental sigma) --------------
    rep = Report("blur_stack", "siftmetal_tpu_torch/csrc/pyramid.cu",
                 "siftmetal_tpu/ops/pallas/blur.py:34", 1e-5)
    g2, _ = KY.octave_oneshot(decimate_2x(g1[:, cfg.n_scales_per_octave], shapes[2]).contiguous(), cfg)
    first3 = decimate_2x(g2[:, cfg.n_scales_per_octave], shapes[3]).contiguous()
    rho = cfg.incremental_sigmas(3)[0]
    plain = lambda: KY.bands_plain(first3, (float(rho),), None, False)[0][:, 0]
    out3 = KB.blur_stack(first3, rho)
    err = _max_err(out3, plain())
    rep.row["ms"] = _time_ms(lambda: KB.blur_stack(first3, rho), 20)
    rep.row["plain_ms"] = _time_ms(plain, 3)
    rep.bound(f4 * 2 * first3.numel(),
              _pass_ops(b, *shapes[3], KY.slice_taps((float(rho),))), peaks)
    _library(rep, lambda: (_blur_cascade_library(first3, (rho,))[0][:, 1],), (out3,), 20)
    print(f"[kernel] band passes: {_ptxas_line('17band_tiles_kernelIffLb0')}", flush=True)
    rep.check(err)
    reports[rep.row["name"]] = rep

    # --- the whole cascade of octave 3 in one launch ---------------------
    _cascade_row(reports, peaks, first3, cfg, 3, False)
    _cascade_shapes()

    # --- detection at octave 0 ---------------------------------------------
    rep = Report("detect_candidates", "siftmetal_tpu_torch/csrc/detect.cu",
                 "siftmetal_tpu/ops/pallas/detect.py:51", 0.0)
    thr = 0.8 * cfg.dog_threshold
    cd = KD.detect_candidates(d0, thr, cfg.edge_threshold)
    cp = KD.detect_candidates_plain(d0, thr, cfg.edge_threshold)
    for name in ("cand_col", "slot_ok", "cand_edge", "n_raw", "n_soft", "n_row_dropped"):
        if not torch.equal(getattr(cd, name), getattr(cp, name)):
            raise AssertionError(f"detect_candidates: {name} differs from the plain version")
    # -fmad=false: the Taylor fields equal the plain version's bit for bit.
    err = max(_max_err(a, c) for a, c in zip(cd.cand_fields, cp.cand_fields))
    one = lambda: KD.detect_candidates(d0, thr, cfg.edge_threshold)
    rep.row["ms"] = _queued_ms(one)
    rep.row["plain_ms"] = _time_ms(lambda: KD.detect_candidates_plain(d0, thr, cfg.edge_threshold), 2)
    print(f"[kernel] detect_candidates at {b}x{d0.shape[1]}x{H}x{W}: {rep.row['ms']:.4f} ms queued "
          f"(kernel alone {_device_ms(one, ('detect_kernel',))['detect_kernel']:.4f} ms of device time, "
          f"{_time_ms(one, 10):.4f} ms on the host's clock); "
          f"{_ptxas_line(f'detect_kernelILb1ELi5ELi{KD.BAND_ROWS}E')}; "
          f"{_ptxas_line(f'detect_kernelILb0ELi5ELi{KD.BAND_ROWS}E')}", flush=True)
    _detect_batch(peaks, gray, cfg)
    _refine_tail_row(reports, peaks, gray, cfg)
    _describe_glue_rows(reports, peaks, gray, cfg)
    interior = b * (d0.shape[1] - 2) * (H - 2) * (W - 2)
    n_soft = int(cd.n_soft.sum())
    out_bytes = sum(t.numel() * t.element_size() for t in
                    (cd.cand_col, cd.slot_ok, cd.cand_edge, *cd.cand_fields))
    # ~56 ops per interior sample (26 max + 26 min + tests), ~100 per soft
    # extremum (Taylor step and edge test).
    rep.bound(f4 * d0.numel() + out_bytes, 56.0 * interior + 100.0 * n_soft, peaks)
    rep.check(err)
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
    rep.bound(f4 * (2 * cov_o + 5 * valid.numel() + hk.numel()), ORI_OPS * n_ori_samples, peaks)
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
    _require(torch.equal(dk, KP.descriptor_lanes(fields, *d_args, cfg, valid=dvalid, frame=frame_l)),
             "descriptor_hist: a second launch differs")
    rep.row["ms"] = _time_ms(lambda: KP.descriptor_lanes(
        fields, *d_args, cfg, valid=dvalid, frame=frame_l), 10)
    rep.row["plain_ms"] = _time_ms(lambda: DS.descriptor_plain(
        fields.gi, fields.gj, frame_l.long(), d_args[0].long(), *d_args[1:], dvalid, cfg), 1, 0)
    n_desc_samples = _rotated_samples(d_args, dvalid, H, W, cfg)
    half = math.sqrt(2.0) * cfg.descriptor_lambda * (cfg.n_histograms_per_axis + 1) / cfg.n_histograms_per_axis
    reach = half * d_args[3]
    _, cov_d = _box_samples(d_args[1], d_args[2], reach, reach, dvalid, frame_l, d_args[0],
                            H, W, b, cfg)
    rep.bound(f4 * (2 * cov_d + 6 * dvalid.numel() + dk.numel()), DESC_OPS * n_desc_samples, peaks)
    print(f"[kernel] descriptor_hist: two launches equal bit for bit; "
          f"{_ptxas_line('17descriptor_kernelINS_6Hist48')}", flush=True)
    rep.check(err, abs_err)
    reports[rep.row["name"]] = rep
    print(f"[kernels] lanes: orientation {int(valid.sum())} valid of {valid.numel()}, "
          f"descriptor {int(dvalid.sum())} valid of {dvalid.numel()}", flush=True)
    ops = {"orientation": reports["orientation_hist"].ops, "descriptor": reports["descriptor_hist"].ops}
    _resident_kernels(reports, peaks, fields, cfg,
                      (ori_args, valid, frame, hk, hp), (d_args, dvalid, frame_l, dk, dp), ops)
    _orientation_batch(gray, cfg, reports["orientation_hist"], peaks)
    del dk, dp, hk, hp
    _slice2_kernels(reports, peaks, gray, g0, d0, cd, fields, kpc, frame, ori_args, valid,
                    n_ori_samples)
    return reports


def _orientation_batch(gray, cfg, rep, peaks):
    """The orientation kernel over every octave of the parity batch in one
    launch (the staged describe stage's call): equal bit for bit to one
    launch an octave and to the resident form (row 9a) octave by octave,
    within the row's tolerance of the plain version; its device time beside
    the per-octave launches' and the bound summed over the octaves, and the
    octave-0 launch's device time beside the row's bound."""
    import dataclasses

    import torch

    from siftmetal_tpu_torch.ops.kernels import patches as KP
    from siftmetal_tpu_torch.sift import describe as DS
    from siftmetal_tpu_torch.sift import detect as DT
    from siftmetal_tpu_torch.sift.batched import build_pyramid_batch

    gauss, dogs = build_pyramid_batch(gray, cfg, cfg.num_octaves(*gray.shape[-2:]))
    per_octave, _ = DT.detect_all_octaves_batch(dogs, cfg)
    kpcs, fields = [], []
    for o, d in enumerate(dogs):
        budget = DT.keypoint_budget(cfg, tuple(d.shape[-2:]), o)
        kpcs.append(DT.compact_octave_keypoints(per_octave[o], o, cfg, budget)[0])
        fields.append(KP.prepare_patch_fields(gauss[o], cfg))
    del gauss, dogs
    b = gray.shape[0]
    band = dataclasses.replace(cfg, use_band_patches=True)
    fl = lambda a: a.reshape(-1)

    def octave_args(k):
        frame = torch.arange(b, dtype=torch.int32, device=gray.device).repeat_interleave(
            k.valid.shape[1])
        return (fl(k.scale), fl(k.x_oct), fl(k.y_oct), fl(k.sigma_oct)), fl(k.valid), frame

    def per_octave_launches(c):
        rows = []
        for f, k in zip(fields, kpcs):
            lanes, valid, frame = octave_args(k)
            rows.append(KP.orientation_hist_lanes(f, *lanes, c, valid=valid, frame=frame)
                        .reshape(b, k.valid.shape[1], -1))
        return torch.cat(rows, 1)

    one = lambda: KP.orientation_hist_octaves(fields, kpcs, cfg)
    got = one()
    _require(torch.equal(got, per_octave_launches(cfg)),
             "orientation_hist_octaves differs from one launch an octave")
    _require(torch.equal(got, per_octave_launches(band)),
             "orientation_hist_octaves differs from the resident form")
    plain, samples, nbytes, lanes_n = [], 0.0, 0.0, 0
    for f, k in zip(fields, kpcs):
        (scale, x, y, sg), valid, frame = octave_args(k)
        plain.append(DS.orientation_hist_plain(f.gi, f.gj, frame.long(), scale.long(), x, y, sg,
                                               valid, cfg).reshape(b, k.valid.shape[1], -1))
        r_max = 3.0 * cfg.orientation_lambda * sg
        n_s, cov = _box_samples(x, y, r_max, r_max, valid, frame, scale, *f.gi.shape[-2:], b, cfg)
        samples += n_s
        nbytes += 4.0 * (2 * cov + 5 * valid.numel() + valid.numel() * cfg.n_orientation_bins)
        lanes_n += int(valid.sum())
    plain = torch.cat(plain, 1)
    rel = float(((got - plain).abs().amax(-1) / plain.abs().amax(-1).clamp(min=1e-12)).max())
    _require(rel <= rep.tol, f"orientation_hist_octaves: rel {rel:.3e} from the plain version")
    frag = ("::orientation_kernel",)
    dev_one = _device_ms(one, frag)[frag[0]]
    dev_per = _device_ms(lambda: per_octave_launches(cfg), frag)[frag[0]]
    bound = max(nbytes / peaks[0], ORI_OPS * samples / peaks[1]) * 1e3
    lanes0, valid0, frame0 = octave_args(kpcs[0])
    dev0 = _device_ms(lambda: KP.orientation_hist_lanes(fields[0], *lanes0, cfg, valid=valid0,
                                                        frame=frame0), frag)[frag[0]]
    print(f"[kernel] orientation_hist over the {len(kpcs)} parity octaves in one launch "
          f"({lanes_n} valid lanes of {sum(k.valid.numel() for k in kpcs)}): equal to one launch "
          f"an octave and to the resident form bit for bit, rel {rel:.3e} from the plain version; "
          f"{dev_one:.4f} ms of device time (the {len(kpcs)} per-octave launches {dev_per:.4f}), "
          f"queued call {_queued_ms(one):.4f} ms, host's clock {_time_ms(one, 10):.4f} ms; bound "
          f"{bound:.4f} ms; the octave-0 launch {dev0:.4f} ms of device time against the row's "
          f"bound {rep.row['bound_ms']:.4f} ms; {_ptxas_line('18orientation_kernelENS_9OriLaunch')}",
          flush=True)


def _conv_library(x, slice_taps, x_is_slice0):
    """A pyramid octave through cuDNN, the yardstick the port never calls:
    x [B, H, W] extended once by the largest radius (the half-sample
    reflection), each slice one separable F.conv2d (X, then Y) of it with
    its taps (float64 arrays), slice 0 being x itself when
    ``x_is_slice0``, the DoG a subtraction; TF32 off."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    b, h, w = x.shape
    x = x.float()
    R = max(len(t) // 2 for t in slice_taps)
    rows = torch.from_numpy(_reflect_index(h, R)).to(x.device)
    cols = torch.from_numpy(_reflect_index(w, R)).to(x.device)
    ext = x.index_select(1, rows).index_select(2, cols)[:, None]
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        slices = [x] if x_is_slice0 else []
        for k in slice_taps:
            m = len(k) // 2
            t = torch.from_numpy(k.astype(np.float32)).to(x.device)
            xs = F.conv2d(ext[:, :, R - m:R + h + m, :], t.view(1, 1, 1, -1))
            y = F.conv2d(xs, t.view(1, 1, -1, 1))
            slices.append(y[:, 0, :, R - m:R - m + w])
    finally:
        torch.backends.cudnn.allow_tf32 = before
    stack = torch.stack(slices, 1)
    return stack, stack[:, 1:] - stack[:, :-1]


def _composed(stage_taps):
    """The taps of slice s of an incremental cascade: stages 1..s convolved
    in float64."""
    import numpy as np

    out, k = [], np.ones(1)
    for t in stage_taps:
        k = np.convolve(k, np.asarray(t, np.float64))
        out.append(k)
    return out


def _cascade_library(first, cfg):
    """The fused cascade's function through cuDNN (``_conv_library`` with
    each slice's composed stage taps)."""
    from siftmetal_tpu_torch.ops.kernels import cascade as KC

    taps, radii = KC.cascade_taps(cfg)
    return _conv_library(first, _composed([taps[s, : 2 * int(r) + 1] for s, r in enumerate(radii)]),
                         True)


def _blur_cascade_library(first, sigmas):
    """A small-octave cascade (rows 3 and 11c) through cuDNN: composed
    taps of its incremental sigmas, from the first slice in fp32."""
    from siftmetal_tpu_torch.ops.gaussian import gaussian_taps

    return _conv_library(first, _composed([gaussian_taps(float(r)) for r in sigmas]), True)


def _oneshot_library(first, cfg):
    """A one-shot octave (rows 2 and 11b) through cuDNN: slice s blurred
    from the first slice by its one-shot sigma."""
    from siftmetal_tpu_torch.ops.gaussian import gaussian_taps
    from siftmetal_tpu_torch.ops.kernels import pyramid as KY

    return _conv_library(first, [gaussian_taps(float(r)) for r in KY.oneshot_rhos(cfg)], True)


def _seed_library(gray, cfg):
    """The seed octave (rows 1 and 11a) through cuDNN: at delta_min 0.5
    IPOL's 2x upsample (even outputs copy, odd ones are neighbour
    midpoints, the last sample repeated) as one F.conv_transpose2d of the
    replicate-padded frame with the bilinear [0.5, 1, 0.5] outer product,
    stride 2; then every slice blurred from it by its seed sigma."""
    import torch
    import torch.nn.functional as F

    from siftmetal_tpu_torch.ops.gaussian import gaussian_taps
    from siftmetal_tpu_torch.ops.kernels import pyramid as KY

    x = gray.float()
    if cfg.delta_min == 0.5:
        b, h, w = x.shape
        k1 = torch.tensor([0.5, 1.0, 0.5], device=x.device)
        pad = F.pad(x[:, None], (0, 1, 0, 1), mode="replicate")
        before = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            up = F.conv_transpose2d(pad, (k1[:, None] * k1[None, :])[None, None], stride=2, padding=1)
        finally:
            torch.backends.cudnn.allow_tf32 = before
        x = up[:, 0, : 2 * h, : 2 * w]
    return _conv_library(x, [gaussian_taps(float(s)) for s in KY._seed_sigmas(cfg)], False)


def _library(rep, fn, outs, iters):
    """Set the row's library_ms to ``fn``'s time and print how far the
    yardstick's outputs lie from the kernel's ``outs``."""
    lib = fn()
    err = max(_max_err(a, b) for a, b in zip(outs, lib))
    del lib
    rep.row["library_ms"] = _time_ms(fn, iters)
    print(f"[kernel] {rep.row['name']}: cuDNN yardstick {rep.row['library_ms']:.4f} ms, max "
          f"{err:.3e} from the kernel", flush=True)


def _reflect_index(n, r):
    """Indices of [-r, n + r) under the period-2n half-sample reflection."""
    import numpy as np

    m = np.mod(np.arange(-r, n + r), 2 * n)
    return np.where(m < n, m, 2 * n - 1 - m).astype(np.int64)


def _detect_batch(peaks, gray, cfg):
    """Detection over every octave of the parity batch in one launch: held
    field by field against the plain version octave by octave (and on
    dense noise rows that overflow their slots), its device time beside
    the byte bound summed over the octaves, and the band-height sweep
    (each height equal to the default bit for bit)."""
    import numpy as np
    import torch

    from siftmetal_tpu_torch.ops.kernels import detect as KD
    from siftmetal_tpu_torch.sift.batched import build_pyramid_batch

    _, dogs = build_pyramid_batch(gray, cfg, cfg.num_octaves(*gray.shape[-2:]))
    thr = 0.8 * cfg.dog_threshold
    names = ("cand_col", "slot_ok", "n_raw", "n_soft", "n_row_dropped")

    def held(stacks, fields, what):
        got = KD.detect_candidates_octaves(stacks, thr, cfg.edge_threshold, emit_fields=fields)
        for g, d in zip(got, stacks):
            ref = KD.detect_candidates_plain(d, thr, cfg.edge_threshold, emit_fields=fields)
            same = all(torch.equal(getattr(g, n), getattr(ref, n)) for n in names)
            if fields:
                same = same and torch.equal(g.cand_edge, ref.cand_edge) and all(
                    torch.equal(a, c) for a, c in zip(g.cand_fields, ref.cand_fields))
            _require(same, f"detect_candidates_octaves ({what}, fields={fields}): octave "
                           f"{tuple(d.shape)} differs from the plain version")
        return got

    outs = {fields: held(dogs, fields, "parity batch") for fields in (True, False)}
    # Dense rows: noise at the same threshold fills rows past their slots.
    rng = np.random.default_rng(3)
    dense = [torch.from_numpy(rng.normal(0.0, 0.02, (2,) + tuple(d.shape[1:])).astype(np.float32))
             .to(gray.device) for d in dogs]
    n_dense = sum(int(g.n_row_dropped.sum()) for g in held(dense, True, "dense rows"))
    held(dense, False, "dense rows")
    _require(n_dense > 0, "dense-row check: no row overflowed its slots")
    del dense
    dropped = sum(int(g.n_row_dropped.sum()) for g in outs[True])
    nbytes = sum(4.0 * d.numel() for d in dogs)
    out_bytes = sum(t.numel() * t.element_size() for g in outs[True]
                    for t in (g.cand_col, g.slot_ok, g.cand_edge, *g.cand_fields))
    bound = (nbytes + out_bytes) / peaks[0] * 1e3
    line = []
    for r in KD.BAND_ROW_CHOICES:
        for fields in (True, False):
            fn = lambda: KD.detect_candidates_octaves(dogs, thr, cfg.edge_threshold,
                                                      emit_fields=fields, band_rows=r)
            got = fn()
            _require(all(torch.equal(a.cand_col, c.cand_col) and torch.equal(a.n_soft, c.n_soft)
                         for a, c in zip(got, outs[fields])),
                     f"detection at band height {r} differs from the default")
            line.append(f"R {r} {'full' if fields else 'lean'}: batch "
                        f"{_device_ms(fn, ('detect_kernel',))['detect_kernel']:.4f} / octave 0 "
                        f"{_device_ms(lambda: KD.detect_candidates(dogs[0], thr, cfg.edge_threshold, emit_fields=fields, band_rows=r), ('detect_kernel',))['detect_kernel']:.4f}")
    full = lambda: KD.detect_candidates_octaves(dogs, thr, cfg.edge_threshold)
    lean = lambda: KD.detect_candidates_octaves(dogs, thr, cfg.edge_threshold, emit_fields=False)
    print(f"[kernel] detect_candidates_octaves over the {len(dogs)} parity octaves "
          f"({' '.join(f'{d.shape[-2]}x{d.shape[-1]}' for d in dogs)}, B {dogs[0].shape[0]}): "
          f"equal to the plain version octave by octave in every field, both forms "
          f"({dropped} soft extrema past full rows; on dense noise rows at B 2 {n_dense}, "
          f"equal as well); one launch "
          f"{_device_ms(full, ('detect_kernel',))['detect_kernel']:.4f} ms of device time "
          f"(lean {_device_ms(lean, ('detect_kernel',))['detect_kernel']:.4f}), queued call "
          f"{_queued_ms(full):.4f} ms (lean {_queued_ms(lean):.4f}), host's clock "
          f"{_time_ms(full, 10):.4f} ms; bound {bound:.4f} ms (bytes: {nbytes / 1e6:.1f} MB of DoG "
          f"read once + {out_bytes / 1e6:.2f} MB of slots); default band height {KD.BAND_ROWS}",
          flush=True)
    print("[kernel] detection band-height sweep (device ms of the kernel): " + "; ".join(line),
          flush=True)


def _refine_tail_row(reports, peaks, gray, cfg):
    """The refinement tail after detection (``refine_tail_kernel``, one
    launch a call) against its plain version (``_tail_all_octaves``) on the
    parity batch and on its first frame alone, both forms, every field and
    counter bit for bit; its device time beside the byte bound (the
    candidates read once, every output lane written once; the walk's DoG
    reads, ~0.2 MB a frame, left out) and the plain tail's time on the
    card. The row is the batch's, in the full form."""
    import torch

    from siftmetal_tpu_torch.config import SiftConfig
    from siftmetal_tpu_torch.ops.kernels import LAUNCHES
    from siftmetal_tpu_torch.ops.kernels import detect as KD
    from siftmetal_tpu_torch.sift import detect as DT
    from siftmetal_tpu_torch.sift.batched import build_pyramid_batch

    rep = Report("refine_tail", "siftmetal_tpu_torch/csrc/detect.cu",
                 "none: XLA glue (siftmetal_tpu/sift/detect.py detect_all_octaves_batch)", 0.0)
    lean_cfg = SiftConfig(detect_slot_fields=False)
    for frames in (gray, gray[:1]):
        _, dogs = build_pyramid_batch(frames, cfg, cfg.num_octaves(*frames.shape[-2:]))
        shapes = tuple(tuple(d.shape[-2:]) for d in dogs)
        k_move = DT.mover_budget_all(cfg, shapes)
        for c in (cfg, lean_cfg):
            outs = KD.detect_candidates_octaves(dogs, 0.8 * c.dog_threshold, c.edge_threshold,
                                                emit_fields=c.detect_slot_fields)
            kernel = lambda: DT.refine_tail(outs, dogs, shapes, c, k_move)
            plain = lambda: DT._tail_all_octaves(outs, dogs, shapes, c, k_move)
            n0 = LAUNCHES["refine_tail"]
            (kg, cg), (kw, cw) = kernel(), plain()
            _require(LAUNCHES["refine_tail"] == n0 + 1, "refine_tail: not one launch a call")
            bad = [k for k in cw if not _same_bits(cg[k], cw[k])] + [
                f"{o}.{n}" for o, (a, p) in enumerate(zip(kg, kw))
                for n, x, y in zip(a._fields, a, p) if not _same_bits(x, y)]
            _require(not bad, f"refine_tail differs from the plain tail in {bad}")
            lanes = sum(kp.cand_valid.numel() for kp in kg)
            read = sum(t.numel() * t.element_size() for o in outs
                       for t in (o.cand_col, o.slot_ok, *(o.cand_fields or ()),
                                 *((o.cand_edge,) if o.cand_fields else ())))
            written = sum(t.numel() * t.element_size() for kp in kg for t in kp)
            dev = _device_ms(kernel, ("refine_tail_kernel",), 5)["refine_tail_kernel"]
            plain_dev = _device_ms(plain, ("",), 3)[""]
            queued, host, plain_host = _queued_ms(kernel), _time_ms(kernel, 10), _time_ms(plain, 3)
            bound = (read + written) / peaks[0] * 1e3
            form = "full" if c.detect_slot_fields else "lean"
            print(f"[kernel] refine_tail {form} at {frames.shape[0]}x{frames.shape[1]}x"
                  f"{frames.shape[2]} ({len(dogs)} octaves, {lanes} output lanes, k_move {k_move}, "
                  f"movers {cw['n_movers'].tolist()}): equal to the plain tail in every field and "
                  f"counter bit for bit; kernel {dev:.4f} ms of device time, queued {queued:.4f} ms, "
                  f"host's clock {host:.4f} ms; bound {bound:.4f} ms (bytes: {read / 1e6:.2f} MB "
                  f"read, {written / 1e6:.2f} MB written); plain tail {plain_host:.4f} ms on the "
                  f"host's clock, {plain_dev:.4f} ms of device time", flush=True)
            if c is cfg and frames is gray:
                rep.row["ms"], rep.row["plain_ms"] = queued, plain_host
                rep.bound(read + written, 0.0, peaks)
    print(f"[kernel] refine_tail: {_ptxas_line('18refine_tail_kernelILb1ELi4')}; "
          f"{_ptxas_line('18refine_tail_kernelILb0ELi4')}", flush=True)
    rep.check(0.0)
    reports[rep.row["name"]] = rep


def _describe_glue_rows(reports, peaks, gray, cfg):
    """The describe stage's three glue kernels (``csrc/describe.cu``, one
    launch each a call) against the PyTorch route each replaces, on the
    parity batch and on its first frame alone: the keypoint compaction
    (``compact_keypoints`` against ``compact_keypoints_plain``), the peaks
    and lanes (``orientation_lanes`` against ``orientation_lanes_plain``)
    and the quantisation (``quantize_octaves`` against one
    ``quantize_descriptors`` an octave). Every output bit for bit (the
    features: the share of equal bytes, and the largest gap). Each
    kernel's device time beside its byte bound (each input byte it needs
    read once, each output byte written once) and the route's time on the
    card. The rows are the batch's."""
    import torch

    from siftmetal_tpu_torch.ops.kernels import LAUNCHES
    from siftmetal_tpu_torch.ops.kernels import patches as KP
    from siftmetal_tpu_torch.sift import describe as DS
    from siftmetal_tpu_torch.sift import detect as DT
    from siftmetal_tpu_torch.sift.batched import build_pyramid_batch

    src = "siftmetal_tpu_torch/csrc/describe.cu"
    glue = "none: XLA glue (siftmetal_tpu/sift/batched.py around the patch kernels)"
    names = ("keypoint_compact", "lane_peaks", "quantize_rows")
    for name in names:
        reports[name] = Report(name, src, glue, 0.0)
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    for frames in (gray, gray[:1]):
        b = frames.shape[0]
        gaussians, dogs = build_pyramid_batch(frames, cfg, cfg.num_octaves(*frames.shape[-2:]))
        per_octave, _ = DT.detect_all_octaves_batch(dogs, cfg)
        budgets = [DT.keypoint_budget(cfg, tuple(d.shape[-2:]), o) for o, d in enumerate(dogs)]
        kpcs, dropped = DT.compact_keypoints(per_octave, cfg, budgets)
        fields = [KP.prepare_patch_fields(g, cfg) for g in gaussians]
        hist = KP.orientation_hist_octaves(fields, kpcs, cfg)
        lanes, _ = DS.orientation_lanes(hist, kpcs, cfg, dropped)
        flat = lambda a: a.reshape(-1)
        raws = [KP.descriptor_lanes(f, flat(ln.scale), flat(ln.x_oct), flat(ln.y_oct),
                                    flat(ln.sigma_oct), flat(ln.theta), cfg,
                                    valid=flat(ln.valid), frame=flat(ln.frame))
                for f, ln in zip(fields, lanes)]
        n_kp = int(sum(k.valid.sum() for k in kpcs))
        n_lane = int(sum(ln.valid.sum() for ln in lanes))
        slots = sum(kp.scale.numel() for kp in per_octave)
        # Bytes: the keypoint scan reads two flags a slot and nine fields of
        # each kept slot, and writes its outputs; the lane pass reads the
        # histogram and eight fields of each valid keypoint, and writes its
        # lanes; the quantisation reads the raw rows and writes the bytes.
        calls = {
            "keypoint_compact": (
                lambda: DT.compact_keypoints(per_octave, cfg, budgets),
                lambda: DT.compact_keypoints_plain(per_octave, cfg, budgets),
                2 * slots + 36 * n_kp + nbytes([t for k in kpcs for t in k]) + 4 * b),
            "lane_peaks": (
                lambda: DS.orientation_lanes(hist, kpcs, cfg, dropped),
                lambda: DS.orientation_lanes_plain(hist, kpcs, cfg, dropped),
                n_kp * (4 * hist.shape[-1] + 29) + nbytes([t for ln in lanes for t in ln]) + 4 * b),
            "quantize_rows": (
                lambda: DS.quantize_octaves(raws, cfg),
                lambda: [DS.quantize_descriptors(r, cfg) for r in raws],
                nbytes(raws) * 5 // 4),
        }
        frag = {"keypoint_compact": "keypoint_compact_kernel", "lane_peaks": "lane_peaks_kernel",
                "quantize_rows": "quantize_rows_kernel"}
        for name, (kernel, plain, moved) in calls.items():
            n0 = LAUNCHES[name]
            got, want = kernel(), plain()
            _require(LAUNCHES[name] == n0 + 1, f"{name}: not one launch a call")
            if name == "quantize_rows":
                g = torch.cat([flat(a) for a in got]).int()
                w = torch.cat([flat(a) for a in want]).int()
                gap = int((g - w).abs().max())
                equal = float((g == w).double().mean())
                _require(gap <= 1 and equal >= 0.9999,
                         f"quantize_rows: {equal:.6f} of the bytes equal, largest gap {gap}")
                how = (f"features equal to the route's in {100 * equal:.4f}% of the bytes "
                       f"(largest gap {gap} level)")
            else:
                parts = [*((x, y) for a, c in zip(got[0], want[0]) for x, y in zip(a, c)),
                         (got[1], want[1])]
                bad = sum(not _same_bits(x, y) for x, y in parts)
                _require(not bad, f"{name}: {bad} of {len(parts)} outputs differ from the route's")
                how = f"all {len(parts)} outputs equal to the route's bit for bit"
            dev = _device_ms(kernel, (frag[name],), 5)[frag[name]]
            plain_dev = _device_ms(plain, ("",), 3)[""]
            queued, host, plain_host = _queued_ms(kernel), _time_ms(kernel, 10), _time_ms(plain, 3)
            bound = moved / peaks[0] * 1e3
            print(f"[kernel] {name} at {b}x{frames.shape[1]}x{frames.shape[2]} ({len(dogs)} octaves, "
                  f"{slots} keypoint slots, {n_kp} keypoints, {n_lane} lanes): {how}; kernel "
                  f"{dev:.4f} ms of device time, queued {queued:.4f} ms, host's clock {host:.4f} "
                  f"ms; bound {bound:.4f} ms ({moved / 1e6:.2f} MB); PyTorch route {plain_host:.4f} "
                  f"ms on the host's clock, {plain_dev:.4f} ms of device time", flush=True)
            if b == gray.shape[0]:
                rep = reports[name]
                rep.row["ms"], rep.row["plain_ms"] = queued, plain_host
                rep.bound(moved, 0.0, peaks)
    print(f"[kernel] describe glue: {_ptxas_line('23keypoint_compact_kernel')}; "
          f"{_ptxas_line('17lane_peaks_kernelILi36ELi4E')}; "
          f"{_ptxas_line('17lane_peaks_kernelILi0ELi0E')}; "
          f"{_ptxas_line('20quantize_rows_kernelILb1E')}", flush=True)
    for name in names:
        reports[name].check(0.0)


def _cascade_row(reports, peaks, first, cfg, o, bf16):
    """blur_cascade (or its bf16 chain) on octave ``o``'s first slice:
    equal bit for bit to the per-stage route it replaces (five blur_stack
    launches, a stack, a subtraction), and against its plain version (1e-5;
    the bf16 chain as tests/test_torch_fast.py holds it: 1e-5 on all but 2%
    of the samples, none beyond one bf16 ulp of the largest value)."""
    import torch

    from siftmetal_tpu_torch.ops.kernels import blur as KB
    from siftmetal_tpu_torch.ops.kernels import pyramid as KY
    from siftmetal_tpu_torch.sift.pyramid import cascade_slices

    name = "blur_cascade_bf16" if bf16 else "blur_cascade"
    rep = Report(name, "siftmetal_tpu_torch/csrc/pyramid.cu", "siftmetal_tpu/ops/pallas/blur.py:34",
                 1.0 if bf16 else 1e-5)
    sig = cfg.incremental_sigmas(o)
    b, h, w = first.shape
    g, d = KB.blur_cascade(first, sig, bf16)

    def per_step():
        stack = torch.stack(cascade_slices(first, o, cfg), dim=1)
        return stack, stack[:, 1:] - stack[:, :-1]

    gs, ds = per_step()
    _require(torch.equal(g, gs) and torch.equal(d, ds),
             f"{name}: differs from the per-stage route (max {max(_max_err(g, gs), _max_err(d, ds)):.3e})")
    gp, dp = KB.blur_cascade_plain(first, sig, bf16)
    abs_err = max(_max_err(g, gp), _max_err(d, dp))
    err = abs_err
    if bf16:
        share = max(float(((g - gp).abs() > 1e-5).float().mean()),
                    float(((d - dp).abs() > 1e-5).float().mean()))
        _require(share <= 0.02, f"{name}: {share:.4f} of the samples beyond 1e-5 of the plain version")
        err = abs_err / (2.0 ** -8 * max(float(gp.abs().max()), 1.0))
    rep.row["ms"] = _time_ms(lambda: KB.blur_cascade(first, sig, bf16), 20)
    rep.row["plain_ms"] = _time_ms(lambda: KB.blur_cascade_plain(first, sig, bf16), 2)
    steps_ms = _time_ms(per_step, 20)
    _library(rep, lambda: _blur_cascade_library(first, sig), (g, d), 20)
    tab = KY.slice_taps(tuple(float(r) for r in sig))
    rep.bound(first.element_size() * first.numel() + 4.0 * (g.numel() + d.numel()),
              _pass_ops(b, h, w, tab) + d.numel(), peaks)
    frag = "19blur_cascade_kernelI" + ("fLb1" if bf16 and first.dtype == torch.float32
                                       else "13__nv_bfloat16Lb1" if bf16 else "fLb0")
    print(f"[kernel] {name} at {b}x{h}x{w}: equal to the per-stage route bit for bit; that route "
          f"(5 blur_stack + stack + DoG) {steps_ms:.4f} ms here; {_ptxas_line(frag)}", flush=True)
    rep.check(err, abs_err if bf16 else None)
    reports[name] = rep


def _cascade_shapes():
    """blur_cascade against the per-stage route, bit for bit, at the
    butterfly's cascade octaves (parity: 170x256 down to 21x32) and on a
    plane smaller than its radii, for both chains and both first-slice
    types of the bf16 chain."""
    import numpy as np
    import torch

    from siftmetal_tpu_torch.config import SiftConfig
    from siftmetal_tpu_torch.ops.kernels import blur as KB
    from siftmetal_tpu_torch.sift.pyramid import cascade_slices

    rng = np.random.default_rng(5)
    shapes = [(1, 170, 256), (1, 85, 128), (1, 42, 64), (1, 21, 32), (2, 7, 10)]
    n = 0
    for shape in shapes:
        first = torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).to("cuda")
        for cfg, f in ((SiftConfig(), first),
                       (SiftConfig(pyramid_dtype="bfloat16"), first.to(torch.bfloat16)),
                       (SiftConfig(pyramid_dtype="bfloat16"), first)):
            bf16 = cfg.pyramid_dtype == "bfloat16"
            for o in (2, 5):
                g, d = KB.blur_cascade(f, cfg.incremental_sigmas(o), bf16)
                ref = torch.stack(cascade_slices(f, o, cfg), dim=1)
                _require(torch.equal(g, ref) and torch.equal(d, ref[:, 1:] - ref[:, :-1]),
                         f"blur_cascade at {shape} ({f.dtype}, bf16 chain {bf16}, octave {o}) "
                         f"differs from the per-stage route")
                n += 1
    print(f"[kernel] blur_cascade equal to the per-stage route bit for bit in {n} cases: "
          f"{', '.join('x'.join(map(str, s)) for s in shapes)}, fp32 chain and bf16 chain "
          f"(bf16 and fp32 first slice), the sigmas of octaves 2 and 5", flush=True)


def _resident_kernels(reports, peaks, fields, cfg, ori, desc, ops):
    """The resident-tile forms of the two staged patch kernels
    (``use_band_patches``) on the staged rows' lanes: against the plain
    version at the staged rows' tolerance, and against the staged kernel
    bit for bit. ``ori`` / ``desc``: (lane arguments, valid, frame, staged
    kernel's result, plain result); ``ops``: the staged rows' operation
    counts."""
    import torch

    from siftmetal_tpu_torch.config import SiftConfig
    from siftmetal_tpu_torch.ops.kernels import patches as KP
    from siftmetal_tpu_torch.sift import describe as DS

    band = SiftConfig(use_band_patches=True)
    b, _, H, W = fields.gi.shape
    half = math.sqrt(2.0) * cfg.descriptor_lambda * (cfg.n_histograms_per_axis + 1) / cfg.n_histograms_per_axis
    # Per stage: kernel name, tile, radius, lanes and results, the route
    # under use_band_patches, the resident kernel at a given tile, the
    # plain version, a lane's reach, the swept tiles, the kernel's name and
    # its ptxas entry.
    stages = {
        "orientation": (
            "orientation_hist_banded", KP.ORI_TILE, cfg.ori_patch_radius, ori,
            lambda a, v, f: KP.orientation_hist_lanes(fields, *a, band, valid=v, frame=f),
            lambda a, v, f, t: KP.resident_orientation_lanes(fields, *a, cfg, v, f, tile=t),
            lambda a, v, f: DS.orientation_hist_plain(fields.gi, fields.gj, f.long(), a[0].long(),
                                                      *a[1:], v, cfg),
            lambda sg: torch.ceil(3.0 * cfg.orientation_lambda * sg) + 1,
            (8, 16, 24, 32), "resident_orientation_kernel", "resident_orientation_kernel",
        ),
        "descriptor": (
            "descriptor_hist_banded", KP.DESC_TILE, cfg.desc_patch_radius, desc,
            lambda a, v, f: KP.descriptor_lanes(fields, *a, band, valid=v, frame=f),
            lambda a, v, f, t: KP.resident_descriptor_lanes(fields, *a, cfg, v, f, tile=t),
            lambda a, v, f: DS.descriptor_plain(fields.gi, fields.gj, f.long(), a[0].long(),
                                                *a[1:], v, cfg),
            lambda sg: torch.ceil(half * sg + 0.5) + 1,
            (8, 12, 16, 24, 32), "resident_descriptor_kernel", "26resident_descriptor_kernelINS_6Hist48",
        ),
    }
    for stage, (name, tile, radius, (args, valid, frame, staged, plain_out), kernel, at_tile, plain,
                reach_of, tiles, kernel_name, entry) in stages.items():
        rep = Report(name, "siftmetal_tpu_torch/csrc/patches.cu",
                     "siftmetal_tpu/ops/pallas/patches.py:1053", 1e-4)
        got = kernel(args, valid, frame)
        _require(torch.equal(got, staged),
                 f"{name}: differs from the staged kernel (max {_max_err(got, staged):.3e}); "
                 f"the two share their arithmetic and thread order")
        _require(torch.equal(got, kernel(args, valid, frame)), f"{name}: a second launch differs")
        err = float(((got - plain_out).abs().amax(1) / plain_out.abs().amax(1).clamp(min=1e-12)).max())
        lay = KP.tile_layout(fields.gi.shape, valid, frame, args[0], args[1], args[2], tile)

        def plain_route():
            src = lay.src
            rows = plain([a[src] for a in args], valid[src], frame[src])
            out = torch.empty_like(rows)
            out[src] = rows
            return out

        staged_cfg = SiftConfig()
        staged_fn = (KP.orientation_hist_lanes if stage == "orientation" else KP.descriptor_lanes)
        runs = {"resident": lambda: kernel(args, valid, frame),
                "staged": lambda: staged_fn(fields, *args, staged_cfg, valid=valid, frame=frame),
                "CUDA layout": lambda: KP.tile_runs(fields.gi.shape, valid, frame, args[0], args[1],
                                                    args[2], tile),
                "PyTorch layout": lambda: KP.tile_layout(fields.gi.shape, valid, frame, args[0],
                                                         args[1], args[2], tile)}
        _check_tile_runs(runs["CUDA layout"](), lay, valid)
        # In turns: each form forwards, then backwards.
        turns = {k: [] for k in runs}
        for key in list(runs) + list(runs)[::-1]:
            turns[key].append(_time_ms(runs[key], 10))
        t = {k: sum(v) / len(v) for k, v in turns.items()}
        rep.row["ms"] = t["resident"]
        rep.row["plain_ms"] = _time_ms(plain_route, 1, 0)
        # Bytes: the bounding box of every run's windows once (gi and gj),
        # the lane arrays and the layout, the output rows.
        reach = torch.clamp(reach_of(args[3]), max=radius).long()
        ci = torch.round(args[1]).long().clamp(0, H - 1)
        cj = torch.round(args[2]).long().clamp(0, W - 1)
        run = torch.cumsum(lay.first.long(), 0) - 1
        n_runs = int(lay.first.sum())
        nv = int(valid.sum())
        srt = lambda t_: t_[lay.src][:nv]
        box = lambda t_, how, init: torch.full((n_runs,), init, dtype=torch.long, device=t_.device).scatter_reduce(
            0, run[:nv], srt(t_), how)
        rows = box((ci + reach).clamp(max=H - 1), "amax", -1) - box((ci - reach).clamp(min=0), "amin", H) + 1
        cols = box((cj + reach).clamp(max=W - 1), "amax", -1) - box((cj - reach).clamp(min=0), "amin", W) + 1
        region = float((rows * cols).sum())
        per_run = torch.bincount(run[:nv], minlength=n_runs)
        rep.bound(4.0 * (2 * region + (len(args) + 4) * valid.numel() + got.numel()), ops[stage], peaks)
        print(f"[kernel] {name}: equal to the staged kernel bit for bit, two launches equal; {nv} valid "
              f"lanes in {n_runs} tile runs of side {tile} ({nv / max(n_runs, 1):.3f} lanes a run, most "
              f"{int(per_run.max())}; {int((per_run > 1).sum())} runs hold several), regions "
              f"{region / 1e6:.2f} Mpx; in turns (ms, forwards then backwards): "
              f"{json.dumps({k: [round(x, 4) for x in v] for k, v in turns.items()})}; its lane layout "
              f"(CUDA layout) {t['CUDA layout']:.4f} ms = {100.0 * t['CUDA layout'] / t['resident']:.1f}% "
              f"of it; {t['resident'] / t['staged']:.2f}x the staged kernel", flush=True)
        print(f"[kernel] {name}: {_ptxas_line(entry)}; {_ptxas_line('layout_count_kernel')}; "
              f"{_ptxas_line('layout_scan_kernel')}; {_ptxas_line('layout_scatter_kernel')}", flush=True)
        _tile_sweep(name, tiles, lambda t_: at_tile(args, valid, frame, t_), staged,
                    lambda t_: KP.tile_runs(fields.gi.shape, valid, frame, args[0], args[1], args[2], t_),
                    int(valid.sum()), tile, kernel_name)
        rep.check(err, _max_err(got, plain_out))
        reports[name] = rep


def _check_tile_runs(got, lay, valid):
    """The CUDA layout against tile_layout: the same run starts and ends,
    the same lanes in every run (in any order), one head per run."""
    import torch

    _require(torch.equal(got.first, lay.first) and torch.equal(got.run_end.long(), lay.run_end),
             "tile_runs: run starts or ends differ from tile_layout")
    n = lay.src.numel()
    run = torch.cumsum(lay.first.long(), 0) - 1
    run = torch.where(torch.arange(n, device=run.device) < int(valid.sum()), run, run.new_full((n,), n))
    as_sets = lambda src: torch.sort(run * n + src.long()).values
    _require(torch.equal(as_sets(got.src), as_sets(lay.src)), "tile_runs: a run holds other lanes")
    n_runs = int(got.runs[0])
    heads = torch.sort(got.heads[:n_runs].long()).values
    _require(n_runs == int(lay.first.sum()) and torch.equal(heads, torch.nonzero(lay.first).flatten()),
             "tile_runs: run heads differ")


def _device_ms(fn, frags, calls=3):
    """Device ms per call of ``fn`` spent in kernels whose names hold each
    of ``frags`` (torch.profiler over ``calls`` calls)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return {f: sum(e.time_range.elapsed_us() for e in dev if f in e.name) / 1e3 / calls for f in frags}


def _tile_sweep(name, tiles, at_tile, staged, layout_at, n_valid, chosen, kernel_frag):
    """A resident form (``at_tile(tile)``, with its layout) at other tile
    sides: lanes a run, time in turns (forwards, then backwards) and the
    device time of its kernel and of its layout, each equal to the staged
    kernel bit for bit."""
    import torch

    out = {}
    for tile in tiles + tiles[::-1]:
        fn = lambda: at_tile(tile)
        if tile not in out:
            _require(torch.equal(fn(), staged), f"{name} at tile {tile} differs from the staged kernel")
            dev = _device_ms(fn, (kernel_frag, "layout_"))
            out[tile] = [n_valid / max(int(layout_at(tile).runs[0]), 1), dev[kernel_frag], dev["layout_"]]
        out[tile].append(_time_ms(fn, 10))
    print(f"[kernel] {name} tile sweep (side: lanes a run, device ms of the kernel, of the layout, "
          f"ms forwards, ms backwards; chosen {chosen}): "
          + "; ".join(f"{k}: {v[0]:.3f}, {v[1]:.4f}, {v[2]:.4f}, {v[3]:.4f}, {v[4]:.4f}" for k, v in out.items()),
          flush=True)


def _slice2_kernels(reports, peaks, gray, g0, d0, cd, fields, kpc, frame, ori_args, valid,
                    n_ori_samples):
    """The kernels of the fast-preset slice against their plain versions:
    fused cascade, lean detection, fused orientation+descriptor and the
    bf16-input band passes."""
    import torch

    from siftmetal_tpu_torch.config import FAST_BF16_CONFIG, SiftConfig
    from siftmetal_tpu_torch.ops.image import decimate_2x
    from siftmetal_tpu_torch.ops.kernels import blur as KB
    from siftmetal_tpu_torch.ops.kernels import cascade as KC
    from siftmetal_tpu_torch.ops.kernels import detect as KD
    from siftmetal_tpu_torch.ops.kernels import patches as KP
    from siftmetal_tpu_torch.ops.kernels import pyramid as KY
    from siftmetal_tpu_torch.sift import describe as DS
    from siftmetal_tpu_torch.sift.pyramid import cascade_slices, seed_image

    cfg = SiftConfig()
    b, h, w = gray.shape
    H, W = g0.shape[-2:]
    f4, f2 = 4.0, 2.0

    def add(rep, err, abs_err=None):
        rep.check(err, abs_err)
        reports[rep.row["name"]] = rep

    # --- fused cascade at the two octaves that take it (960x1280, 480x640)
    rep = Report("octave_cascade", "siftmetal_tpu_torch/csrc/cascade.cu",
                 "siftmetal_tpu/ops/pallas/cascade.py:52", 1e-5)
    _, radii = KC.cascade_taps(cfg)
    per_px = 4.0 * float((2 * radii + 1).sum()) + len(radii)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    seed0 = seed_image(gray, cfg)                          # [8, 960, 1280]
    gc, dc = KC.octave_cascade(seed0, cfg)
    gp, dp = KC.octave_cascade_plain(seed0, cfg)
    err = max(_max_err(gc, gp), _max_err(dc, dp))
    del gp, dp
    gl, dl = _cascade_library(seed0, cfg)
    lib_err = max(_max_err(gc, gl), _max_err(dc, dl))
    del gl, dl
    frag = ("stream_kernel",)
    rep.row["ms"] = _time_ms(lambda: KC.octave_cascade(seed0, cfg), 5)
    rep.row["plain_ms"] = _time_ms(lambda: KC.octave_cascade_plain(seed0, cfg), 1)
    rep.row["library_ms"] = _time_ms(lambda: _cascade_library(seed0, cfg), 3)
    dev0 = _device_ms(lambda: KC.octave_cascade(seed0, cfg), frag)[frag[0]]
    staged0 = _time_ms(lambda: cascade_slices(seed0, 0, cfg), 5)
    rep.bound(f4 * (seed0.numel() + gc.numel() + dc.numel()), per_px * seed0.numel(), peaks)
    seed1 = decimate_2x(gc[:, cfg.n_scales_per_octave], (h, w)).contiguous()
    del gc, dc
    g1c, d1c = KC.octave_cascade(seed1, cfg)
    g1p, d1p = KC.octave_cascade_plain(seed1, cfg)
    err = max(err, _max_err(g1c, g1p), _max_err(d1c, d1p))
    ms1 = _time_ms(lambda: KC.octave_cascade(seed1, cfg), 10)
    dev1 = _device_ms(lambda: KC.octave_cascade(seed1, cfg), frag)[frag[0]]
    pl1 = _time_ms(lambda: KC.octave_cascade_plain(seed1, cfg), 2)
    lib1 = _time_ms(lambda: _cascade_library(seed1, cfg), 5)
    staged1 = _time_ms(lambda: cascade_slices(seed1, 0, cfg), 10)
    bound1 = max(f4 * (seed1.numel() + g1c.numel() + d1c.numel()) / peaks[0],
                 per_px * seed1.numel() / peaks[1]) * 1e3
    p0 = KC.cascade_plan(cfg, *seed0.shape, sms=sms)
    p1 = KC.cascade_plan(cfg, *seed1.shape, sms=sms)
    print(f"[kernel] octave_cascade at {b}x{H}x{W}: {dev0:.4f} ms of device time (strip "
          f"{p0.strip}, band {p0.band}: {p0.strips * p0.bands * b} blocks, "
          f"{KC.blocks_per_sm(p0.smem)} an SM, {p0.smem} B of shared memory); at {b}x{h}x{w}: "
          f"{ms1:.4f} ms ({dev1:.4f} of device time; band {p1.band}) vs plain {pl1:.4f} ms, cuDNN "
          f"yardstick {lib1:.4f} ms; bound {bound1:.4f} ms; total radius {int(radii.sum())}; the "
          f"five blur_stack launches it replaces take {staged1:.4f} ms here and {staged0:.4f} ms "
          f"at {b}x{H}x{W}, the row below (library_ms: F.conv2d of each slice's composed taps, X "
          f"then Y, on the plane extended once, TF32 off; max {lib_err:.3e} from the kernel); "
          f"{_ptxas_line('13stream_kernelINS_7DefaultE')}", flush=True)
    del g1c, d1c, g1p, d1p, seed0, seed1
    add(rep, err)

    # --- lean detection on octave 0, beside the full kernel ----------------
    rep = Report("detect_candidates_lean", "siftmetal_tpu_torch/csrc/detect.cu",
                 "siftmetal_tpu/ops/pallas/detect.py:51", 0.0)
    thr = 0.8 * cfg.dog_threshold
    cl = KD.detect_candidates(d0, thr, cfg.edge_threshold, emit_fields=False)
    cpl = KD.detect_candidates_plain(d0, thr, cfg.edge_threshold, emit_fields=False)
    for name in ("cand_col", "slot_ok", "n_raw", "n_soft", "n_row_dropped"):
        _require(torch.equal(getattr(cl, name), getattr(cd, name)),
                 f"detect_candidates_lean: {name} differs from the full kernel")
        _require(torch.equal(getattr(cl, name), getattr(cpl, name)),
                 f"detect_candidates_lean: {name} differs from the plain version")
    lean = lambda: KD.detect_candidates(d0, thr, cfg.edge_threshold, emit_fields=False)
    full = lambda: KD.detect_candidates(d0, thr, cfg.edge_threshold)
    # lean, full, full, lean: the two forms timed in turns in one run.
    t = [_queued_ms(f) for f in (lean, full, full, lean)]
    rep.row["ms"] = 0.5 * (t[0] + t[3])
    rep.row["plain_ms"] = _time_ms(
        lambda: KD.detect_candidates_plain(d0, thr, cfg.edge_threshold, emit_fields=False), 2)
    interior = b * (d0.shape[1] - 2) * (H - 2) * (W - 2)
    rep.bound(f4 * d0.numel() + cl.cand_col.numel() * 5.0, 56.0 * interior, peaks)
    print(f"[kernel] detect in turns (queued ms): lean {t[0]:.4f}, full {t[1]:.4f}, "
          f"full {t[2]:.4f}, lean {t[3]:.4f}; all outputs equal to the full kernel and to the "
          f"plain version", flush=True)
    add(rep, 0.0)

    # --- fused orientation + descriptor on octave 0's keypoints ------------
    rep = Report("orient_desc", "siftmetal_tpu_torch/csrc/patches.cu",
                 "siftmetal_tpu/ops/pallas/patches.py:1593", 1e-4)
    m = cfg.max_orientations_per_keypoint
    fused = lambda: KP.orient_desc_lanes(fields, *ori_args, cfg, valid=valid, frame=frame)
    raw, th, ov = fused()
    rp, tp, ovp = KP.orient_desc_lanes_plain(fields, *ori_args, cfg, valid, frame)
    hist = DS._smooth_circular(
        DS.orientation_hist_plain(fields.gi, fields.gj, frame.long(), ori_args[0].long(),
                                  *ori_args[1:], valid, cfg),
        cfg.orientation_smoothing_iterations)
    # Lanes whose peak sets differ must sit on a tie: some bin within 1e-6
    # (relative to the lane's largest) of the 0.8 max threshold or of a
    # neighbour.
    hmax = hist.amax(1, keepdim=True).clamp(min=1e-30)
    gap = torch.minimum(
        (hist - cfg.orientation_peak_threshold * hmax).abs(),
        torch.minimum((hist - hist.roll(1, 1)).abs(), (hist - hist.roll(-1, 1)).abs()),
    ).amin(1) / hmax[:, 0]
    differ = (ov != ovp).any(1)
    _require(not bool((differ & (gap >= 1e-6)).any()),
             "orient_desc: peak validity differs from the plain version away from any tie")
    same = ~differ
    cond = DS.peak_conditioning(hist, cfg)
    th_tol = 1e-5 * torch.clamp(0.02 * cond, min=1.0)
    th_err = (th - tp).abs()
    _require(bool((th_err[same] <= th_tol[same]).all()),
             f"orient_desc: theta differs by {float((th_err[same] / th_tol[same]).max()):.2f}x its "
             f"tolerance (1e-5, scaled where max/|curvature| > 50)")
    a, r = raw[same].reshape(-1, raw.shape[-1]), rp[same].reshape(-1, raw.shape[-1])
    err = float(((a - r).abs().amax(1) / r.abs().amax(1).clamp(min=1e-12)).max())
    qd = (DS.quantize_descriptors(a, cfg).int() - DS.quantize_descriptors(r, cfg).int()).abs()
    _require(int(qd.max()) <= 1, "orient_desc: quantized descriptors differ by more than 1")
    _require(bool((raw[~ov] == 0).all()) and bool((th[~ov] == 0).all()),
             "orient_desc: missing peaks are not zero")
    # The staged descriptor kernel on the keypoints repeated max_ori times,
    # at the fused theta and peak validity: the same warp routine.
    rep4 = lambda t_: t_.repeat_interleave(m)
    staged = KP.descriptor_lanes(fields, *(rep4(a) for a in ori_args), th.reshape(-1), cfg,
                                 valid=ov.reshape(-1), frame=rep4(frame))
    _require(torch.equal(raw.reshape(staged.shape), staged),
             f"orient_desc: differs from the staged descriptor kernel at its own theta (max "
             f"{_max_err(raw.reshape(staged.shape), staged):.3e})")
    r2, t2, o2 = fused()
    _require(torch.equal(raw, r2) and torch.equal(th, t2) and torch.equal(ov, o2),
             "orient_desc: a second launch differs")
    del staged, r2
    rep.row["ms"] = _time_ms(fused, 10)
    rep.row["plain_ms"] = _time_ms(
        lambda: KP.orient_desc_lanes_plain(fields, *ori_args, cfg, valid, frame), 1, 0)
    d_args = (rep4(ori_args[0]), rep4(ori_args[1]), rep4(ori_args[2]), rep4(ori_args[3]),
              tp.reshape(-1))
    n_desc = _rotated_samples(d_args, ovp.reshape(-1), H, W, cfg)
    half = math.sqrt(2.0) * cfg.descriptor_lambda * (cfg.n_histograms_per_axis + 1) / cfg.n_histograms_per_axis
    reach = half * ori_args[3]
    _, cov = _box_samples(ori_args[1], ori_args[2], reach, reach, valid, frame, ori_args[0],
                          H, W, b, cfg)
    rep.bound(f4 * (2 * cov + 5 * valid.numel() + raw.numel() + 2 * th.numel()),
              ORI_OPS * n_ori_samples + DESC_OPS * n_desc, peaks)
    print(f"[kernel] orient_desc: {int(valid.sum())} keypoints, {int(ovp.sum())} peaks; "
          f"{int(differ.sum())} lanes differ in peak validity, all on a tie (gap < 1e-6); "
          f"theta max err {float(th_err[same].max()):.3e} (largest share of its tolerance "
          f"{float((th_err[same] / th_tol[same]).max()):.3f}); max peaks per keypoint "
          f"{int(ovp.sum(1).max())}; descriptors equal to the staged descriptor kernel at the fused "
          f"theta bit for bit, two launches equal; {_ptxas_line('18orient_desc_kernelINS_6Hist48')}",
          flush=True)
    staged_pair = reports["orientation_hist"].row["ms"] + reports["descriptor_hist"].row["ms"]
    print(f"[kernel] orient_desc {rep.row['ms']:.4f} ms against the staged pair (rows 5 + 6) "
          f"{staged_pair:.4f} ms + 0.15 = {staged_pair + 0.15:.4f} ms", flush=True)
    add(rep, err, _max_err(a, r))
    del raw, rp, a, r

    # --- bf16-input band passes at the fast preset's shapes ----------------
    fast = FAST_BF16_CONFIG
    bf = torch.bfloat16
    shapes = fast.octave_shapes(h, w, fast.num_octaves(h, w))
    n = fast.n_scales_per_octave
    gray16 = gray.to(bf)
    rep = Report("seed_octave_bf16", "siftmetal_tpu_torch/csrc/pyramid.cu",
                 "siftmetal_tpu/ops/pallas/pyramid.py:159", 1e-5)
    _require(KY.seed_supports(fast, h, w), "the fast preset's octave 0 must take the fused seed")
    g0f, d0f = KY.seed_octave(gray16, fast)
    g0p, d0p = KY.seed_octave_plain(gray16, fast)
    err = max(_max_err(g0f, g0p), _max_err(d0f, d0p))
    tab = KY.slice_taps(KY._seed_sigmas(fast))
    rep.row["ms"] = _time_ms(lambda: KY.seed_octave(gray16, fast), 10)
    rep.row["plain_ms"] = _time_ms(lambda: KY.seed_octave_plain(gray16, fast), 2)
    gray32 = gray16.float()
    ms32 = _time_ms(lambda: KY.seed_octave(gray32, fast), 10)
    rep.bound(f2 * gray16.numel() + f4 * (g0f.numel() + d0f.numel()),
              _pass_ops(b, h, w, tab) + d0f.numel(), peaks)
    _library(rep, lambda: _seed_library(gray16, fast), (g0f, d0f), 5)
    print(f"[kernel] seed_octave at {b}x{h}x{w}, same values as fp32 input: {ms32:.4f} ms", flush=True)
    add(rep, err)

    rep = Report("octave_oneshot_bf16", "siftmetal_tpu_torch/csrc/pyramid.cu",
                 "siftmetal_tpu/ops/pallas/pyramid.py:159", 1e-5)
    _require(KY.supports(fast, shapes[1][0]), "the fast preset's octave 1 must take the one-shot route")
    first1 = decimate_2x(g0f[:, n].to(bf), shapes[1]).contiguous()
    g1f, d1f = KY.octave_oneshot(first1, fast)
    g1p, d1p = KY.octave_oneshot_plain(first1, fast)
    _require(torch.equal(g1f[:, 0], first1.float()), "octave_oneshot_bf16: slice 0 is not the input")
    err = max(_max_err(g1f, g1p), _max_err(d1f, d1p))
    tab = KY.slice_taps(KY.oneshot_rhos(fast))
    rep.row["ms"] = _time_ms(lambda: KY.octave_oneshot(first1, fast), 10)
    rep.row["plain_ms"] = _time_ms(lambda: KY.octave_oneshot_plain(first1, fast), 2)
    first1_32 = first1.float()
    ms32 = _time_ms(lambda: KY.octave_oneshot(first1_32, fast), 10)
    rep.bound(f2 * first1.numel() + f4 * (g1f.numel() + d1f.numel()),
              _pass_ops(b, *shapes[1], tab) + d1f.numel(), peaks)
    _library(rep, lambda: _oneshot_library(first1, fast), (g1f, d1f), 10)
    print(f"[kernel] octave_oneshot at {b}x{shapes[1][0]}x{shapes[1][1]}, same values as fp32 "
          f"input: {ms32:.4f} ms", flush=True)
    add(rep, err)

    rep = Report("blur_stack_bf16", "siftmetal_tpu_torch/csrc/pyramid.cu",
                 "siftmetal_tpu/ops/pallas/blur.py:34", 1e-5)
    first2 = decimate_2x(g1f[:, n].to(bf), shapes[2]).contiguous()
    rho = fast.incremental_sigmas(2)[0]
    plain = lambda: KY.bands_plain(first2, (float(rho),), None, False, bf)[0][:, 0]
    out2 = KB.blur_stack(first2, rho)
    err = _max_err(out2, plain())
    _library(rep, lambda: (_blur_cascade_library(first2, (rho,))[0][:, 1],), (out2,), 20)
    rep.row["ms"] = _time_ms(lambda: KB.blur_stack(first2, rho), 20)
    rep.row["plain_ms"] = _time_ms(plain, 3)
    rep.bound(f2 * first2.numel() + f4 * first2.numel(),
              _pass_ops(b, *shapes[2], KY.slice_taps((float(rho),))), peaks)
    add(rep, err)
    _cascade_row(reports, peaks, first2, fast, 2, True)


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


PARITY_KERNELS = ("seed_octave", "octave_oneshot", "blur_cascade", "detect_candidates",
                  "refine_tail", "orientation_hist", "descriptor_hist", "keypoint_compact",
                  "lane_peaks", "quantize_rows")
# Pyramid launches of one 640x480 extract_batch: fused seed, one-shot
# octaves 1-2, one cascade launch each for octaves 3-6 (parity); fused
# seed, one-shot octave 1, cascades of octaves 2-5 (fast preset).
PARITY_PYRAMID = {"seed_octave": 1, "octave_oneshot": 2, "blur_cascade": 4, "blur_stack": 0}
FAST_PYRAMID = {"seed_octave_bf16": 1, "octave_oneshot_bf16": 1, "blur_cascade_bf16": 4,
                "blur_stack_bf16": 0, "blur_stack": 0, "blur_cascade": 0}


# Detection launches of one extract_batch: every octave in one launch.
PARITY_DETECT = {"detect_candidates": 1, "detect_candidates_lean": 0, "refine_tail": 1}
LEAN_DETECT = {"detect_candidates": 0, "detect_candidates_lean": 1, "refine_tail": 1}
# Orientation launches of one extract_batch (staged describe stage): every
# octave in one launch.
ONE_ORIENTATION = {"orientation_hist": 1}
# The describe stage's glue launches of one extract_batch (staged; the
# fused form has no lane pass).
DESCRIBE_GLUE = {"keypoint_compact": 1, "lane_peaks": 1, "quantize_rows": 1}
FUSED_GLUE = {"keypoint_compact": 1, "lane_peaks": 0, "quantize_rows": 1}


def _require_launches(tag, launches, want, what="pyramid"):
    got = {k: launches[k] for k in want}
    _require(got == want, f"{tag}: {what} launches {got}, expected {want}")
    print(f"[{tag}] {what} launches {json.dumps(got)}", flush=True)
OVERFLOWS = ("overflow", "descriptor_overflow", "keypoint_overflow")


def _noise_frames(device):
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.uniform(0.0, 1.0, (8, 480, 640)).astype(np.float32)).to(device)


def _drive(tag, sift, x, required, reports, after=None, may_overflow=False):
    """One extract_batch (and ``after(descs)``, the rest of the path) with
    every launch counter set to 0 just before and read just after. The
    call replays the graph that the first call captured, which runs no
    wrapper: its launches are counted on the device, by kernel name, in a
    profile of that call and of two more replays (a profile loses a
    kernel event now and then, about one call in 60 on the H100: each
    group's count is the largest of the three), and held group by group
    against the counters of an eager ``extract_gray_batch`` on the same
    frames (plus any wrapper that ``after`` runs). Fails if a kernel in
    ``required`` was not launched, the replay's launches differ from the
    eager call's, an output is malformed or (unless ``may_overflow``:
    then they are only shown) a budget overflowed. Returns (keypoints,
    descriptors, counters as per-frame lists, launches, what ``after``
    returned)."""
    import torch

    from siftmetal_tpu_torch import extract_gray_batch
    from siftmetal_tpu_torch.ops.kernels import (
        KERNEL_GROUPS, LAUNCHES, device_launches, group_launches, reset_launches)

    sift.extract_batch(x)                    # the first call: warm-up, capture
    torch.cuda.synchronize()
    reset_launches()
    eager = extract_gray_batch(x, sift.config, sift.n_octaves)
    torch.cuda.synchronize()
    eager_launches = dict(LAUNCHES)
    out = {}

    def run():
        out["result"] = sift.extract_batch(x)
        out["extra"] = after(out["result"][1]) if after is not None else None

    reset_launches()
    _, _, kern, *_ = _device_profile(run)
    host = dict(LAUNCHES)                    # wrappers that ``after`` ran
    kps, descs, counters = out["result"]
    extra = out["extra"]
    profiles = [device_launches(e.name for e in kern)]
    for _ in range(2):
        profiles.append(device_launches(e.name for e in _device_profile(lambda: sift.extract_batch(x))[2]))
    seen = {g: max(p[g] for p in profiles) for g in profiles[0]}
    want = group_launches({k: eager_launches[k] + host[k] for k in LAUNCHES})
    bad = {"+".join(g): (seen[g], want[g]) for g in KERNEL_GROUPS.values() if seen[g] != want[g]}
    _require(not bad, f"{tag}: device launches of the replayed call differ from the eager call's "
                      f"(kernel group: (replay, eager)) {bad}")
    short = [i for i, p in enumerate(profiles) if p != seen]
    if short:
        print(f"[{tag}] profiles {short} of the three lost a kernel event: "
              f"{[{'+'.join(g): n for g, n in profiles[i].items() if n != seen[g]} for i in short]}",
              flush=True)
    # Each group's count is the replay's; a group of several wrappers (the
    # band kernels: seed, one-shot, single slice) is split as the eager
    # call's wrappers counted it.
    launches = {k: eager_launches[k] + host[k] for k in LAUNCHES}
    missing = [k for k in required if launches[k] == 0]
    if missing:
        raise AssertionError(f"{tag}: path never launched {missing}; launches {launches}")
    for name in required:
        # A kernel that several paths run keeps the count of the first.
        if reports[name].row["launches"] == 0:
            reports[name].row["launches"] = launches[name]
    n = sift.config.max_descriptors
    bsz = x.shape[0]
    _require(descs.features.shape == (bsz, n, 128) and descs.features.dtype == torch.uint8,
             f"{tag}: descriptor features {tuple(descs.features.shape)} {descs.features.dtype}")
    _require(kps.x.shape == (bsz, sift.config.max_keypoints), f"{tag}: keypoints {tuple(kps.x.shape)}")
    for t in (kps.x, kps.y, kps.sigma, descs.x, descs.y, descs.sigma, descs.theta):
        _require(bool(torch.isfinite(t).all()), f"{tag}: non-finite keypoint or descriptor values")
    ctr = {k: [int(v) for v in t.cpu()] for k, t in counters.items()}
    print(f"[{tag}] launches of the replayed call, counted on the device "
          f"{json.dumps({'+'.join(g): n for g, n in seen.items() if n})}; by wrapper "
          f"{json.dumps({k: v for k, v in launches.items() if v})}; wrapper calls in it "
          f"{sum(host.values())}", flush=True)
    print(f"[{tag}] counters (sum over {bsz} frames): "
          f"{json.dumps({k: sum(v) for k, v in ctr.items()})}; overflow counters "
          f"{json.dumps({k: ctr[k] for k in OVERFLOWS})}", flush=True)
    for key in OVERFLOWS:
        if any(ctr[key]) and not may_overflow:
            raise AssertionError(f"{tag}: overflow {key}={ctr[key]}")
    if min(ctr["n_descriptors"]) <= 0:
        raise AssertionError(f"{tag}: no descriptors")
    _hold_replay(tag, sift, x, (kps, descs, counters), eager)
    return kps, descs, ctr, launches, extra


def _same_bits(a, b) -> bool:
    """Equal dtype, shape and bytes."""
    import torch

    flat = lambda t: t.contiguous().reshape(-1).view(torch.uint8)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(flat(a), flat(b))


def _differing(got, want):
    """Fields of two (Keypoints, Descriptors, counters) results whose bits
    differ, and the number of fields."""
    (kg, dg, cg), (kw, dw, cw) = got, want
    pairs = [*zip(kg._fields, kg, kw), *zip(dg._fields, dg, dw), *((k, cg.get(k), cw[k]) for k in cw)]
    return [n for n, a, b in pairs if a is None or not _same_bits(a, b)], len(pairs)


def _hold_replay(tag, sift, x, got, want=None):
    """``sift.extract_batch``'s result ``got`` on ``x`` (a replay of the
    graph its first call captured) against the eager ``extract_gray_batch``
    on the same frames (``want``, when already made), bit for bit in every
    field; then a second replay on other frames against their eager call,
    and ``got`` unchanged by it."""
    from siftmetal_tpu_torch import extract_gray_batch

    eager = lambda f: extract_gray_batch(f, sift.config, sift.n_octaves)
    kept = tuple(type(r)(*(t.clone() for t in r)) for r in got[:2]) + (
        {k: v.clone() for k, v in got[2].items()},)
    bad, n = _differing(got, want if want is not None else eager(x))
    _require(not bad, f"{tag}: the replay differs from the eager call in {bad}")
    y = x.roll(1, 0).flip(-1).contiguous()
    bad, _ = _differing(sift.extract_batch(y), eager(y))
    _require(not bad, f"{tag}: a second replay on other frames differs from the eager call in {bad}")
    bad, _ = _differing(got, kept)
    _require(not bad, f"{tag}: the second replay changed the first call's result in {bad}")
    print(f"[{tag}] replay equal to the eager extract_gray_batch in all {n} fields bit for bit, "
          f"and again on other frames after a second replay (first result unchanged); "
          f"graphs captured for batch sizes {sorted(sift._graphs)}", flush=True)


def _differing_leaves(got, want):
    """Positions of the tensor leaves of two results whose bits differ
    (["structure"] when their trees differ)."""
    import torch
    from torch.utils import _pytree

    (a, ta), (b, tb) = _pytree.tree_flatten(got), _pytree.tree_flatten(want)
    if str(ta) != str(tb):
        return ["structure"]
    return [i for i, (x, y) in enumerate(zip(a, b)) if torch.is_tensor(x) and not _same_bits(x, y)]


def _eager_vs_replay(tag, what, eager, replay, cache, smi_line, calls=2, profile_eager=True):
    """A compiled program's replay against its eager run on the same
    inputs. ``replay``'s first call (it captures when ``cache``, its
    ``graphs.GraphCache``, has no program for its key: the eager warm-up,
    the capture, a replay), its seconds and the device memory reserved
    after it beyond before it (the allocator's cache emptied both times);
    then its result and a second replay's against ``eager``'s, bit for
    bit; then eager, replay, replay, eager, each a window of ``calls``
    calls (CUDA events); one profiled call of each (wall, device busy,
    device ops, idle share; the eager one only with ``profile_eager``).
    Fails unless the bits are equal. Returns {route: median ms}."""
    import torch
    from torch.utils import _pytree

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    res0 = torch.cuda.memory_reserved()
    n0 = len(cache.graphs)
    t0 = time.perf_counter()
    first = replay()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    captured = len(cache.graphs) - n0
    torch.cuda.empty_cache()
    kept = torch.cuda.memory_reserved() - res0
    want = eager()
    again = replay()
    bad = _differing_leaves(first, want) + _differing_leaves(again, want)
    _require(not bad, f"{tag}: {what} replayed differs from its eager run in leaves {bad}")
    n_leaves = sum(torch.is_tensor(x) for x in _pytree.tree_leaves(want))
    fns = {"eager": eager, "replay": replay}
    ms = {k: [] for k in fns}
    for order in (("eager", "replay"), ("replay", "eager")):
        for k in order:
            ms[k] += _windows(fns[k], 1, calls)
    prof = {}
    for k, fn in fns.items():
        if k == "eager" and not profile_eager:
            prof[k] = "not profiled"
            continue
        wall, busy, kern, *_ = _device_profile(fn)
        prof[k] = (f"wall {wall:.3f} ms, busy {busy:.3f} ms in {len(kern)} device ops, idle "
                   f"{100.0 * (1.0 - busy / wall):.1f}%")
    med = {k: _median(v) for k, v in ms.items()}
    first_call = ("warm-up, capture, replay" if captured else
                  "a replay of the program an earlier call captured")
    print(f"[{tag}] {what}: replay equal to eager in all {n_leaves} tensors bit for bit (twice); "
          f"first call ({first_call}) {capture_s:.3f} s, keeps {kept / 2**20:.1f} MiB reserved "
          f"({len(cache.graphs)} programs cached); ms a call in turns (windows of {calls}): eager "
          f"{', '.join(f'{v:.3f}' for v in ms['eager'])}, replay "
          f"{', '.join(f'{v:.3f}' for v in ms['replay'])} (median {med['eager']:.3f} against "
          f"{med['replay']:.3f}, {med['eager'] / med['replay']:.2f}x); one profiled call: replay "
          f"{prof['replay']}; eager {prof['eager']}; reserved now "
          f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB ({smi_line})", flush=True)
    return med


def _windows(fn, n_windows, calls):
    """ms per call of ``fn`` in each of ``n_windows`` windows (CUDA events)."""
    import torch

    out = []
    for _ in range(n_windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / calls)
    return out


def _median(v):
    return sorted(v)[len(v) // 2]


def phase_main_path(reports, smi_line):
    """SIFT(480, 640).extract_batch on 8 noise frames through the kernels:
    its first call (eager warm-up and capture), the replay's launches and
    bits against the eager call, then the replay and the eager
    extract_gray_batch timed in turns and each profiled once."""
    import torch

    from siftmetal_tpu_torch import SIFT, extract_gray_batch

    sift = SIFT(480, 640)
    x = _noise_frames(sift.device)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held0, res0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sift.extract_batch(x)                    # eager warm-up, capture, one replay
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    first_peak = torch.cuda.max_memory_allocated() - held0
    held = torch.cuda.memory_allocated() - held0
    torch.cuda.empty_cache()                 # what stays reserved is the graph's
    reserved = torch.cuda.memory_reserved() - res0
    _, descs, ctr, launches, _ = _drive("main", sift, x, PARITY_KERNELS, reports)
    _require_launches("main", launches, PARITY_PYRAMID)
    _require_launches("main", launches, PARITY_DETECT, "detection")
    _require_launches("main", launches, ONE_ORIENTATION, "orientation")
    _require_launches("main", launches, DESCRIBE_GLUE, "describe glue")
    # Frame 0 alone gives frame 0's batched result.
    _, d1, c1 = sift.extract(x[0])
    _require(all(int(c1[k]) == ctr[k][0] for k in c1), "batched != single-frame counters")
    fd = (d1.features[d1.valid].int() - descs.features[0][descs.valid[0]].int()).abs()
    _require(int(fd.max()) <= 1, "batched != single-frame descriptors")
    eager = lambda: extract_gray_batch(x, sift.config, sift.n_octaves)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eager()
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    sift.extract_batch(x)
    torch.cuda.synchronize()
    replay_peak = torch.cuda.max_memory_allocated() - base
    # In turns, three windows of 5 calls each route: the host runs most of
    # the eager route, and host time on a shared machine spreads more than
    # device time.
    runs = {"replay": lambda: sift.extract_batch(x), "eager": eager}
    times = {k: [] for k in runs}
    for _ in range(3):
        for k, fn in runs.items():
            times[k] += _windows(fn, 1, 5)
    idle = {k: _profile(f"main {k}", fn) for k, fn in runs.items()}
    gib = lambda n: f"{n / 2**30:.3f} GiB"
    print(f"[main] descriptors per frame {ctr['n_descriptors']}", flush=True)
    for k, v in times.items():
        ms = _median(v)
        print(f"[main] {k} 8x480x640: median {ms:.3f} ms/batch, {8e3 / ms:.2f} frames/s (windows of 5 "
              f"calls, in turns: {', '.join(f'{t:.3f}' for t in v)} ms); one profiled call: wall "
              f"{idle[k][0]:.3f} ms, device busy {idle[k][1]:.3f} ms, idle "
              f"{100.0 * (1.0 - idle[k][1] / idle[k][0]):.1f}%; against the median "
              f"{100.0 * (1.0 - idle[k][1] / ms):.1f}% ({smi_line})", flush=True)
    print(f"[main] first call (eager warm-up on a side stream, the capture, a replay) {capture_s:.3f} s; "
          f"device memory: allocated after it {gib(held)} (the graph's outputs and input), "
          f"reserved after it {gib(reserved)} (the graph's pool with them), first call peak "
          f"{gib(first_peak)}, a replay's peak {gib(replay_peak)} (its output copies), an eager "
          f"call's peak {gib(eager_peak)} ({smi_line})", flush=True)
    return ctr


def _big_map(dev):
    """A seeded 4096 x 131072 uint8 map query: each query is a target
    (``src``) plus noise of up to 3 levels a component; 2% of the targets
    invalid. Returns (queries, targets, query valid, target valid, src)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(1)
    tq, tt = 4096, 131072
    targets = torch.from_numpy(rng.integers(0, 256, (tt, 128), dtype=np.uint8)).to(dev)
    src = torch.from_numpy(rng.permutation(tt)[:tq]).to(dev)
    noise = torch.from_numpy(rng.integers(-3, 4, (tq, 128)).astype(np.int16)).to(dev)
    queries = (targets[src].to(torch.int16) + noise).clamp(0, 255).to(torch.uint8)
    qv = torch.ones((tq,), dtype=torch.bool, device=dev)
    tv = torch.from_numpy(rng.uniform(size=tt) > 0.02).to(dev)
    return queries, targets, qv, tv, src


def phase_fast_path(reports, parity_ctr, smi_line):
    """The fast-preset slice at full width: bf16 extraction of the 8 noise
    frames, pairwise matching, a map beyond ``target_block``, the parity
    configuration under each variant switch, and the fast preset with its
    direct pyramid routes off."""
    import dataclasses

    import numpy as np
    import torch

    from siftmetal_tpu_torch import FAST_BF16_CONFIG, FAST_CONFIG, SIFT, SiftConfig
    from siftmetal_tpu_torch.match import geometry_score, match_bruteforce

    sift = SIFT(480, 640, config=FAST_BF16_CONFIG)
    x = _noise_frames(sift.device)
    pairs = [(0, 1), (2, 3), (4, 5), (6, 7)]

    def match_pairs(descs):
        out = []
        for i, j in pairs:
            mt = match_bruteforce(descs.features[i], descs.features[j],
                                  descs.valid[i], descs.valid[j])
            xy = lambda k: torch.stack([descs.x[k], descs.y[k]], -1)
            out.append((mt, geometry_score(mt, xy(i), xy(j))))
        return out

    required = ("seed_octave_bf16", "octave_oneshot_bf16", "blur_cascade_bf16",
                "detect_candidates", "orientation_hist", "descriptor_hist")
    # Without the 2x oversampling a noise frame now and then has a row with
    # more soft extrema than the row has slots: counted in `overflow`.
    _, descs, ctr, fl, matched = _drive("fast", sift, x, required, reports, match_pairs,
                                        may_overflow=True)
    _require_launches("fast", fl, FAST_PYRAMID)
    _require_launches("fast", fl, PARITY_DETECT, "detection")
    _require_launches("fast", fl, ONE_ORIENTATION, "orientation")
    _require_launches("fast", fl, DESCRIBE_GLUE, "describe glue")
    nq = sift.config.max_descriptors
    for (i, j), (mt, score) in zip(pairs, matched):
        _require(mt.target_idx.shape == (nq,) and mt.target_idx.dtype == torch.int32,
                 f"fast: matches {tuple(mt.target_idx.shape)} {mt.target_idx.dtype}")
        v = descs.valid[i]
        _require(bool(torch.isfinite(mt.distance[v]).all()), "fast: non-finite match distances")
        _require(bool(((mt.best_idx[v] >= 0) & (mt.best_idx[v] < ctr["n_descriptors"][j])).all()),
                 "fast: a best match points at a padded target")
        _require(bool(torch.isfinite(score)) and 0.0 <= float(score) <= 1.0,
                 f"fast: geometry score {float(score)}")
    print(f"[fast] descriptors per frame {ctr['n_descriptors']}; matches per pair "
          f"{[int(mt.count) for mt, _ in matched]} (independent noise frames: none expected), "
          f"geometry scores {[round(float(sc), 4) for _, sc in matched]}", flush=True)

    # Times, in turns inside this one run: fast bf16, fast fp32, parity.
    sift32 = SIFT(480, 640, config=FAST_CONFIG)
    parity = SIFT(480, 640)
    _hold_replay("fast_fp32", sift32, x, sift32.extract_batch(x))
    parity.extract_batch(x)
    torch.cuda.synchronize()
    runs = {"fast_bf16": lambda: sift.extract_batch(x), "fast_fp32": lambda: sift32.extract_batch(x),
            "parity": lambda: parity.extract_batch(x)}
    times = {k: [] for k in runs}
    for _ in range(3):
        for k, fn in runs.items():
            times[k] += _windows(fn, 1, 5)
    for k, v in times.items():
        print(f"[fast] extract_batch 8x480x640 {k}: median {_median(v):.3f} ms/batch, "
              f"{8e3 / _median(v):.2f} frames/s (windows of 5 calls, in turns: "
              f"{', '.join(f'{t:.3f}' for t in v)} ms; {smi_line})", flush=True)
    mw = _windows(lambda: match_pairs(descs), 3, 3)
    print(f"[fast] match_bruteforce + geometry_score, 4 pairs of {nq} x {nq} x 128 uint8: median "
          f"{_median(mw):.3f} ms ({_median(mw) / 4:.3f} ms a pair; windows {', '.join(f'{t:.3f}' for t in mw)} ms)",
          flush=True)
    _profile("fast extract", lambda: sift.extract_batch(x))
    _profile("fast match", lambda: match_pairs(descs))

    # --- a map beyond target_block: 4096 queries x 131072 targets ----------
    queries, targets, qv, tv, src = _big_map(sift.device)
    tq, tt, blk = queries.shape[0], targets.shape[0], 65536
    big = match_bruteforce(queries, targets, qv, tv, target_block=blk)
    want = torch.where(tv[src], src, -1).to(torch.int32)
    hit = want >= 0
    _require(bool((big.target_idx[hit] == want[hit]).all()),
             "blocked matcher: a query did not find the target it was made from")
    single = match_bruteforce(queries, targets[:blk], qv, tv[:blk], target_block=blk)
    blocked = match_bruteforce(queries, targets[:blk], qv, tv[:blk], target_block=blk // 4)
    for name, a, c in zip(single._fields, single, blocked):
        _require(torch.equal(a, c), f"blocked matcher: {name} differs from the single-shot route")
    first_half = big.best_idx < blk
    _require(bool((big.best_idx[first_half] == single.best_idx[first_half]).all())
             and bool((big.distance <= single.distance).all()),
             "blocked matcher: the two-block result disagrees with its first block")
    torch.cuda.reset_peak_memory_stats()
    ms_big = _time_ms(lambda: match_bruteforce(queries, targets, qv, tv, target_block=blk), 3)
    ms_one = _time_ms(lambda: match_bruteforce(queries, targets[:blk], qv, tv[:blk], target_block=blk), 3)
    print(f"[fast] match_bruteforce {tq} x {tt} x 128 uint8 in blocks of {blk}: {ms_big:.3f} ms, "
          f"{int(big.count)} accepted of {int(hit.sum())} whose target is valid; single-shot on the "
          f"first {blk}: {ms_one:.3f} ms, equal to the blocked route (blocks of {blk // 4}) field by "
          f"field; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del targets, queries, big, single, blocked

    # --- the parity configuration under each variant switch ----------------
    variants = {
        "cascade": (SiftConfig(use_oneshot_pyramid=False, use_pallas_pyramid=True),
                    ("octave_cascade", "blur_stack", "blur_cascade")),
        "lean": (SiftConfig(detect_slot_fields=False), ("detect_candidates_lean",)),
        "fused": (SiftConfig(use_fused_describe=True), ("orient_desc",)),
    }
    for tag, (cfg, need) in variants.items():
        sv = SIFT(480, 640, config=cfg)
        _, _, vctr, vl, _ = _drive(tag, sv, x, need, reports)
        unused = {"cascade": ("seed_octave", "octave_oneshot"), "lean": ("detect_candidates",),
                  "fused": ("orientation_hist", "descriptor_hist")}[tag]
        _require(all(vl[k] == 0 for k in unused), f"{tag}: still launched {unused}: {vl}")
        _require_launches(tag, vl, LEAN_DETECT if tag == "lean" else PARITY_DETECT, "detection")
        if tag != "fused":
            _require_launches(tag, vl, ONE_ORIENTATION, "orientation")
        _require_launches(tag, vl, FUSED_GLUE if tag == "fused" else DESCRIBE_GLUE, "describe glue")
        stages = ("n_extrema", "n_soft", "n_interp", "n_hard", "n_edge", "n_border")
        if tag == "cascade":
            # Another order of the same blurs: counts within 1% of the
            # one-shot route's.
            for k in stages:
                a, c = sum(vctr[k]), sum(parity_ctr[k])
                _require(abs(a - c) <= max(10, 0.01 * c), f"cascade: {k} {a} vs {c}")
        else:
            _require(all(vctr[k] == parity_ctr[k] for k in stages + ("n_movers",)),
                     f"{tag}: detection counters differ from the default route")
            if tag == "lean":
                _require(vctr["n_descriptors"] == parity_ctr["n_descriptors"],
                         "lean: descriptor counts differ from the default route")
            else:
                diff = sum(abs(a - c) for a, c in zip(vctr["n_descriptors"], parity_ctr["n_descriptors"]))
                _require(diff <= 0.002 * sum(parity_ctr["n_descriptors"]),
                         f"fused: descriptor counts differ from the staged route by {diff}")
        t = []
        for _ in range(2):
            t += _windows(lambda: sv.extract_batch(x), 1, 5)
            t += _windows(lambda: parity.extract_batch(x), 1, 5)
        if tag in ("fused", "cascade"):
            _profile(tag, lambda: sv.extract_batch(x))
        print(f"[{tag}] extract_batch 8x480x640 in turns with the default route (ms/batch): "
              f"{tag} {t[0]:.3f}, default {t[1]:.3f}, {tag} {t[2]:.3f}, default {t[3]:.3f}; "
              f"descriptors {sum(vctr['n_descriptors'])} vs {sum(parity_ctr['n_descriptors'])} ({smi_line})",
              flush=True)
    # The fast preset without its direct routes: the bf16 seed blur
    # (blur_stack_bf16) and a bf16-chain cascade in every octave.
    bare = SIFT(480, 640, config=dataclasses.replace(FAST_BF16_CONFIG, use_oneshot_pyramid=False))
    _, _, _, bl, _ = _drive("fast_cascade", bare, x, ("blur_stack_bf16", "blur_cascade_bf16"),
                            reports, may_overflow=True)
    n_oct = bare.config.num_octaves(480, 640)
    _require_launches("fast_cascade", bl, {"blur_stack_bf16": 1, "blur_cascade_bf16": n_oct,
                                           "seed_octave_bf16": 0, "octave_oneshot_bf16": 0})


PAIR_KERNELS = ("seed_octave", "octave_oneshot", "blur_cascade", "detect_candidates",
                "orientation_hist_banded", "descriptor_hist_banded")
# Inlier share of the accepted matches that a warped view must reach, and
# the share an unrelated frame must stay under.
PAIR_INLIER_BARS = {"rot15": 0.8, "rot30": 0.6, "scale0.8": 0.8, "scale1.25": 0.8, "tilt": 0.6,
                    "sim20": 0.8}
# How far (px) the recovered H may move an image corner from where the
# known H moves it. 2 px where RANSAC's all-inlier refit is accepted; under
# rot15 and scale1.25 the refit (its 6144 slots padded with copies of the
# first inlier) loses an inlier or two at the 3 px threshold, the winning
# 4-point hypothesis is kept, and a corner, far from the matches, moves by
# 2-6 px with the draw. The JAX package's RANSAC is the same step for step.
PAIR_CORNER_BARS = {"rot15": 8.0, "scale1.25": 8.0}


def _pair_frames(device):
    """proc_a, its six warped views (made on ``device``) and proc_b:
    ([8, 480, 640] frames, [(name, H)] of frames 1..6)."""
    import numpy as np
    import torch

    from siftmetal_tpu_torch.ops.warp import similarity_homography, warp_perspective
    from siftmetal_tpu_torch.utils.io import load_image
    from siftmetal_tpu_torch.utils.repeatability import standard_warp_battery

    fx = ROOT / "tests" / "fixtures"
    a = torch.from_numpy(load_image(str(fx / "proc_a.pgm"))).to(device)
    b = torch.from_numpy(load_image(str(fx / "proc_b.pgm"))).to(device)
    shape = tuple(a.shape)
    _require(shape == (480, 640) and tuple(b.shape) == shape, f"pair: fixture shapes {shape}")
    warps = standard_warp_battery(shape) + [
        ("sim20", similarity_homography(np.deg2rad(20.0), 0.95, center=(shape[0] / 2, shape[1] / 2)))]
    views = [warp_perspective(a, h, shape) for _, h in warps]
    return torch.stack([a] + views + [b]).contiguous(), warps


def _verify_pairs(descs, gen):
    """match_bruteforce of frame 0 against frames 1..7 and find_homography
    on each: [(Matches, RansacResult, source points, matched points)]."""
    import torch

    from siftmetal_tpu_torch.geometry import find_homography
    from siftmetal_tpu_torch.match import match_bruteforce

    xy = lambda k: torch.stack([descs.x[k], descs.y[k]], -1)
    out = []
    for j in range(1, descs.valid.shape[0]):
        mt = match_bruteforce(descs.features[0], descs.features[j], descs.valid[0], descs.valid[j])
        src, dst = xy(0), xy(j)[mt.target_idx.long()]
        res = find_homography(gen, src, dst, mt.valid, n_hypotheses=512, inlier_threshold=3.0)
        out.append((mt, res, src, dst))
    return out


def _pair_gates(kps, verified, warps, shape):
    """The homography, distractor and repeatability gates of the pair
    phase; returns the lines to print."""
    import numpy as np
    import torch

    from siftmetal_tpu_torch.geometry import homography_from_points
    from siftmetal_tpu_torch.ops.warp import apply_homography, quad_corners
    from siftmetal_tpu_torch.sift.detect import Keypoints
    from siftmetal_tpu_torch.utils.repeatability import keypoint_array, repeatability

    frame = lambda k: Keypoints(*(t[k] for t in kps))
    pts0, sig0 = keypoint_array(frame(0))
    corners = torch.from_numpy(quad_corners(*shape))
    lines, reps = [], {}
    for k, ((name, h), (mt, res, src, dst)) in enumerate(zip(warps, verified), start=1):
        n_m, n_in = int(mt.count), int(res.n_inliers)
        _require(bool(res.ok) and n_m >= 50, f"pair {name}: {n_m} matches")
        want = apply_homography(torch.from_numpy(h), corners)
        off = lambda model: float((want - apply_homography(model.cpu(), corners)).norm(dim=-1).max())
        corner_err = off(res.model)
        # For the record: an unpadded least-squares fit of the same inliers.
        inl = torch.nonzero(res.inliers).flatten()
        plain_fit = off(homography_from_points(src[inl], dst[inl]))
        _require(corner_err <= PAIR_CORNER_BARS.get(name, 2.0),
                 f"pair {name}: recovered H moves a corner {corner_err:.3f} px from where the known "
                 f"H moves it")
        _require(n_in >= PAIR_INLIER_BARS[name] * n_m,
                 f"pair {name}: {n_in} inliers of {n_m} matches (bar {PAIR_INLIER_BARS[name]})")
        pts1, _ = keypoint_array(frame(k))
        reps[name] = repeatability(pts0, sig0, pts1, h, shape)
        lines.append(f"{name}: {n_m} matches, {n_in} inliers, corners within {corner_err:.3f} px "
                     f"(a least-squares fit of the inliers alone: {plain_fit:.3f} px), "
                     f"repeatability {reps[name]:.4f}")
    # The bars tests/test_repeatability.py holds the JAX package to on this
    # image (battery mean 0.78, least 0.72), and 0.6 for every view.
    battery = [reps[n] for n, _ in warps[:5]]
    _require(float(np.mean(battery)) >= 0.78 and min(battery) >= 0.72 and min(reps.values()) >= 0.6,
             f"pair: repeatability {reps}")
    mt, res = verified[-1][:2]
    n_m, n_in = int(mt.count), int(res.n_inliers)
    # A model fitted to 4 random matches explains those 4 and a few more.
    _require(n_in < max(0.2 * n_m, 8), f"pair distractor: {n_in} inliers of {n_m} matches")
    lines.append(f"unrelated frame: {n_m} matches, {n_in} inliers")
    return lines


def _pose_leg(device, gen):
    """find_fundamental -> essential -> recover_pose -> triangulate on the
    stereo scene of tests/test_geometry.py, and pnp_ransac on the scene of
    tests/test_slam.py, both made with numpy from their seeds."""
    import numpy as np
    import torch

    from siftmetal_tpu_torch.geometry import (
        essential_from_fundamental,
        find_fundamental,
        recover_pose,
        triangulate,
    )
    from siftmetal_tpu_torch.slam.camera import project
    from siftmetal_tpu_torch.slam.pnp import pnp_ransac

    t_ = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)
    rng = np.random.default_rng(7)
    n = 200
    pts3 = rng.uniform([-2, -2, 4], [2, 2, 8], (n, 3)).astype(np.float32)
    k = np.array([[500, 0, 320], [0, 500, 240], [0, 0, 1]], dtype=np.float32)
    (cx, sx), (cy, sy), (cz, sz) = ((np.cos(a), np.sin(a)) for a in (0.05, -0.1, 0.02))
    r_true = (np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
              @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
              @ np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])).astype(np.float32)
    t_true = np.array([0.5, 0.05, 0.02], dtype=np.float32)

    def proj(p, rr, tt):
        uv = (p @ rr.T + tt) @ k.T
        return (uv[:, :2] / uv[:, 2:]).astype(np.float32)

    x1, x2 = proj(pts3, np.eye(3, dtype=np.float32), np.zeros(3, np.float32)), proj(pts3, r_true, t_true)
    ones = torch.ones(n, dtype=torch.bool, device=device)
    # With 60 correspondences replaced by outliers RANSAC separates the two
    # sets (the bars of tests/test_geometry.py) ...
    x2_bad = x2.copy()
    x2_bad[:60] = np.random.default_rng(3).uniform(0, 640, (60, 2))
    inl = find_fundamental(gen, t_(x1), t_(x2_bad), ones).inliers.cpu().numpy()
    _require(inl[60:].mean() > 0.95 and inl[:60].mean() < 0.1,
             f"pose: fundamental inliers {inl[60:].mean():.3f} of the true, {inl[:60].mean():.3f} of the outliers")
    # ... and the pose comes from the scene itself (one outlier that slips
    # in turns the linear 8-point's translation by several degrees).
    res = find_fundamental(gen, t_(x1), t_(x2), ones)
    e = essential_from_fundamental(res.model, t_(k), t_(k))
    kinv = np.linalg.inv(k)
    n1 = (np.c_[x1, np.ones(n)] @ kinv.T)[:, :2]
    n2 = (np.c_[x2, np.ones(n)] @ kinv.T)[:, :2]
    w = res.inliers.to(torch.float32)
    r, t, n_front = recover_pose(e, t_(n1), t_(n2), w)
    r_err = float(np.abs(r.cpu().numpy() - r_true).max())
    td, tt = t.cpu().numpy() / float(t.norm()), t_true / np.linalg.norm(t_true)
    t_err = float(min(np.linalg.norm(td - tt), np.linalg.norm(td + tt)))
    _require(r_err < 1e-2 and t_err < 2e-2, f"pose: R off by {r_err:.4f}, t direction by {t_err:.4f}")
    _require(float(n_front) >= 0.95 * float(w.sum()), f"pose: {float(n_front)} of {float(w.sum())} in front")
    p1 = torch.cat([torch.eye(3, device=device), torch.zeros((3, 1), device=device)], 1)
    p2 = torch.cat([r, t[:, None]], 1)
    pts = triangulate(p1, p2, t_(n1), t_(n2))
    z2 = (pts @ r.T + t)[:, 2]
    sel = res.inliers.cpu()
    front = ((pts[:, 2] > 0) & (z2 > 0)).cpu()[sel]
    # Up to the unknown scale of t the points are the scene's.
    scale = float(np.linalg.norm(t_true)) / float(t.norm())
    p_err = float((pts.cpu()[sel] * scale - torch.from_numpy(pts3)[sel]).abs().max())
    _require(bool(front.all()) and p_err < 0.1, f"pose: triangulated points off by {p_err:.4f}")

    rng = np.random.default_rng(11)
    kp = np.array([[450, 0, 320], [0, 450, 240], [0, 0, 1]], dtype=np.float32)
    pts = rng.uniform([-2, -2, 5], [2, 2, 10], (128, 3)).astype(np.float32)
    cam_true = np.array([0.1, -0.05, 0.2, 0.3, -0.1, 0.4], dtype=np.float32)
    uv = project(t_(cam_true), t_(kp), t_(pts)).cpu().numpy()
    uv[:30] += rng.uniform(40, 120, (30, 2)).astype(np.float32)
    pres = pnp_ransac(gen, t_(pts), t_(uv), torch.ones(128, dtype=torch.bool, device=device), t_(kp))
    pinl = pres.inliers.cpu().numpy()
    cam_err = float(np.abs(pres.model.cpu().numpy() - cam_true).max())
    _require(bool(pres.ok) and pinl[30:].mean() > 0.97 and pinl[:30].mean() < 0.05 and cam_err < 5e-3,
             f"pose: PnP inliers {pinl[30:].mean():.3f} / {pinl[:30].mean():.3f}, camera off by {cam_err:.5f}")
    return (f"fundamental with 60 outliers of {n}: {int(inl[60:].sum())} of 140 true and "
            f"{int(inl[:60].sum())} outliers accepted; clean scene: {int(res.n_inliers)} inliers, "
            f"R within {r_err:.5f}, "
            f"t direction within {t_err:.5f}, {int(front.sum())} points in front of both cameras "
            f"(within {p_err:.4f} of the scene up to scale); PnP camera within {cam_err:.6f}, "
            f"{int(pres.n_inliers)} inliers of 128 (30 outliers)")


def phase_pair(reports, smi_line):
    """The verified-pair path at full width, through the resident-tile
    patch kernels."""
    import torch

    from siftmetal_tpu_torch import SIFT, SiftConfig
    from siftmetal_tpu_torch.geometry import find_homography
    from siftmetal_tpu_torch.ops.warp import warp_perspective

    band = SIFT(480, 640, SiftConfig(use_band_patches=True))
    dev = band.device
    frames, warps = _pair_frames(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    # A few rows of these natural-content frames hold more soft extrema
    # than a row has slots (the 2x seed packs them densely): counted in
    # `overflow` and shown, as for the fast preset; the other budgets hold.
    kps, descs, ctr, launches, verified = _drive(
        "pair", band, frames, PAIR_KERNELS, reports, lambda d: _verify_pairs(d, gen),
        may_overflow=True)
    _require(not any(ctr["descriptor_overflow"]) and not any(ctr["keypoint_overflow"]),
             f"pair: a descriptor or keypoint budget overflowed: {ctr}")
    _require(launches["orientation_hist"] == 0 and launches["descriptor_hist"] == 0
             and launches["orient_desc"] == 0, f"pair: a staged patch kernel was launched: {launches}")
    for line in _pair_gates(kps, verified, warps, (480, 640)):
        print(f"[pair] {line}", flush=True)
    print(f"[pair] descriptors per frame {ctr['n_descriptors']}", flush=True)

    # The same frames through the default (staged) route: equal results.
    staged = SIFT(480, 640)
    k0, d0, c0 = staged.extract_batch(frames)
    _require(all(ctr[k] == [int(v) for v in c0[k].cpu()] for k in ctr),
             "pair: counters differ from the staged route")
    fd = (descs.features.int() - d0.features.int()).abs()
    _require(torch.equal(descs.valid, d0.valid) and int(fd.max()) <= 1,
             f"pair: descriptors differ from the staged route by {int(fd.max())} steps")
    print(f"[pair] equal to the staged route: counters, validity, features "
          f"(largest difference {int(fd.max())} quantisation steps)", flush=True)
    print(f"[pair] pose leg: {_pose_leg(dev, gen)}", flush=True)

    # --- times ---------------------------------------------------------------
    t = []
    for _ in range(2):
        t += _windows(lambda: band.extract_batch(frames), 1, 5)
        t += _windows(lambda: staged.extract_batch(frames), 1, 5)
    print(f"[pair] extract_batch 8x480x640 (proc_a views) in turns with the default route (ms/batch): "
          f"band {t[0]:.3f}, default {t[1]:.3f}, band {t[2]:.3f}, default {t[3]:.3f} ({smi_line})",
          flush=True)
    mt, _, src, dst = verified[0]
    hw = _windows(lambda: find_homography(gen, src, dst, mt.valid), 3, 5)
    ww = _windows(lambda: warp_perspective(frames[0], warps[0][1], (480, 640)), 3, 20)
    svd = {}
    for name, shp in (("512x8x9", (512, 8, 9)), ("256x12x12", (256, 12, 12)), ("6144x4x4", (6144, 4, 4))):
        a = torch.randn(shp, device=dev, generator=gen)
        svd[name] = _median(_windows(lambda: torch.linalg.svd(a, full_matrices=True), 3, 5))
    print(f"[pair] find_homography, {src.shape[0]} padded correspondences ({int(mt.count)} valid), 512 "
          f"hypotheses: median {_median(hw):.3f} ms a pair (windows {', '.join(f'{v:.3f}' for v in hw)}); "
          f"warp_perspective 480x640: median {_median(ww):.3f} ms (windows "
          f"{', '.join(f'{v:.3f}' for v in ww)}); torch.linalg.svd (ms): "
          f"{json.dumps({k: round(v, 3) for k, v in svd.items()})} ({smi_line})", flush=True)
    _profile("pair", lambda: _verify_pairs(band.extract_batch(frames)[1], gen))


def _mapping_problem(dev):
    """tests/test_slam.py::test_ba_scales_to_mapping_size's problem on
    ``dev``: 256 cameras (2 fixed), 65,536 landmarks each seen by 3
    consecutive cameras (196,608 observations), noisy start."""
    import numpy as np
    import torch

    from siftmetal_tpu_torch.slam.ba import BAProblem
    from siftmetal_tpu_torch.slam.camera import project

    rng = np.random.default_rng(0)
    n_cam, n_lm, deg = 256, 65536, 3
    k = np.array([[400, 0, 320], [0, 400, 240], [0, 0, 1]], np.float32)
    lms = rng.uniform([-8, -8, 6], [8, 8, 30], (n_lm, 3)).astype(np.float32)
    cams = np.zeros((n_cam, 6), np.float32)
    cams[:, 3] = np.linspace(-4, 4, n_cam)
    cams[:, 1] = np.linspace(0, 0.2, n_cam)
    first = rng.integers(0, n_cam - deg, n_lm)
    cam_idx = (first[:, None] + np.arange(deg)[None, :]).reshape(-1).astype(np.int32)
    lm_idx = np.repeat(np.arange(n_lm), deg).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    uv = project(t(cams)[t(cam_idx).long()], t(k), t(lms)[t(lm_idx).long()])
    noisy_cams = cams + rng.normal(0, 0.002, cams.shape).astype(np.float32)
    noisy_cams[:2] = cams[:2]
    noisy_lms = lms + rng.normal(0, 0.01, lms.shape).astype(np.float32)
    return BAProblem(t(noisy_cams), t(noisy_lms), t(k), t(cam_idx), t(lm_idx), uv,
                     torch.ones(len(cam_idx), dtype=torch.bool, device=dev), fixed_cameras=2)


def _sfm_mapping_ba(dev, smi_line):
    """tests/test_slam.py::test_ba_scales_to_mapping_size on the card: 256
    cameras, 65,536 landmarks each seen by 3 consecutive cameras (196,608
    observations), max_obs_per_landmark=4, 3 iterations; its gates (no
    observation dropped, the cost below half the initial); then the same
    solve replayed from its CUDA graphs against the eager call."""
    import torch

    from siftmetal_tpu_torch.slam import sfm
    from siftmetal_tpu_torch.slam.ba import bundle_adjust

    problem = _mapping_problem(dev)
    n_cam, n_lm, cam_idx = problem.cameras.shape[0], problem.landmarks.shape[0], problem.cam_idx
    run = lambda: bundle_adjust(problem, n_iterations=3, damping=1e-4, max_obs_per_landmark=4)
    _, stats = run()
    c0, c1, dropped = float(stats.initial_cost), float(stats.final_cost), int(stats.obs_dropped)
    _require(dropped == 0, f"sfm: mapping-size BA dropped {dropped} observations")
    _require(c1 < 0.5 * c0, f"sfm: mapping-size BA cost {c0:.1f} -> {c1:.1f}, not below half")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    windows = _windows(run, 3, 2)
    peak = torch.cuda.max_memory_allocated(dev)
    wall, busy, kern, _, per, _ = _device_profile(run)
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:5]
    print(f"[sfm] bundle_adjust {n_cam} cameras / {n_lm} landmarks / {len(cam_idx)} observations, "
          f"M=4, 3 iterations: cost {c0:.1f} -> {c1:.3f}, dropped {dropped}; median "
          f"{_median(windows):.3f} ms a call (windows of 2: {', '.join(f'{v:.3f}' for v in windows)}); "
          f"peak memory {peak / 2**20:.1f} MiB ({(peak - held) / 2**20:.1f} MiB above the inputs); "
          f"under the profiler wall {wall:.3f} ms, device busy {busy:.3f} ms in {len(kern)} device "
          f"ops (idle {100.0 * (1.0 - busy / wall):.1f}%) ({smi_line})", flush=True)
    print("[sfm] bundle_adjust most device time: " + "; ".join(
        f"{name[:44]} {ms:.3f} ms x{c}" for name, (ms, c) in top), flush=True)
    _eager_vs_replay(
        "sfm", "mapping-size BA replayed as SfmMap runs it (slam.sfm.replayed_bundle_adjust, M=4, "
               "3 iterations)",
        run, lambda: sfm.replayed_bundle_adjust(problem, 3, 0.0, max_obs_per_landmark=4),
        sfm._BA_GRAPHS, smi_line)


def _sfm_video(reports, dev, smi_line):
    """examples/video_sfm_torch.py's scene at 480x640 (K and the blob
    radii scaled x2) and its camera sweep (a 1.2-unit truck, a 0.06 rad
    pan) in 8 frames, rendered on the CPU (the same bits every run); SIFT(480, 640, max_descriptors=4096)
    .extract_batch with the launch counters set to 0 just before and read
    just after; SfmMap(k, SfmConfig()) at its full budgets: initialize,
    add_frame for each frame, one global bundle_adjust. Gates: every frame
    registers, reprojection RMS < 1 px, ATE < 0.1. Then the programs
    cached and the memory reserved, and the global BA's solve replayed
    against its eager call."""
    import numpy as np
    import torch

    from examples.video_sfm_torch import frames_of, render, textured_scene
    from siftmetal_tpu_torch import SIFT, SiftConfig
    from siftmetal_tpu_torch.slam import sfm
    from siftmetal_tpu_torch.slam.ba import bundle_adjust
    from siftmetal_tpu_torch.slam.sfm import SfmConfig, SfmMap
    from siftmetal_tpu_torch.slam.trajectory import ate_rmse, camera_centers

    h, w, n = 480, 640, 8
    k = np.array([[520, 0, w / 2], [0, 520, h / 2], [0, 0, 1]], np.float32)
    centers, amps, widths = textured_scene(np.random.default_rng(0), width_scale=2.0)
    cams = np.zeros((n, 6), np.float32)
    cams[:, 3] = np.linspace(0, 1.2, n)
    cams[:, 1] = np.linspace(0, 0.06, n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    imgs = torch.stack([render(c, k, centers, amps, widths, h, w, dev) for c in cams])
    torch.cuda.synchronize()
    render_ms = (time.perf_counter() - t0) * 1e3
    sift = SIFT(h, w, SiftConfig(max_descriptors=4096))
    _, descs, ctr, launches, _ = _drive("sfm", sift, imgs, PARITY_KERNELS, reports, may_overflow=True)
    _require(not any(ctr["descriptor_overflow"]) and not any(ctr["keypoint_overflow"]),
             f"sfm: a descriptor or keypoint budget overflowed: {ctr}")
    frames = [frames_of(descs, i) for i in range(n)]
    cfg = SfmConfig()
    smap = SfmMap(k, cfg)
    _require((cfg.max_cameras, cfg.max_landmarks, cfg.max_observations) == (512, 65536, 262144),
             "sfm: SfmConfig() budgets changed")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n0 = smap.initialize(frames[0], frames[1])
    init_ms = (time.perf_counter() - t0) * 1e3
    add_ms, inliers = [], []
    for i, f in enumerate(frames[2:], start=2):
        t0 = time.perf_counter()
        ok, n_in, _ = smap.add_frame(f)
        torch.cuda.synchronize()
        add_ms.append((time.perf_counter() - t0) * 1e3)
        inliers.append(n_in if ok else -n_in)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    stats = smap.bundle_adjust()
    end.record()
    torch.cuda.synchronize()
    ba_ms = start.elapsed_time(end)
    rms = smap.reprojection_rms()
    ate = ate_rmse(camera_centers(smap.cameras[: smap.n_cameras]),
                   camera_centers(cams[: smap.n_cameras]))
    print(f"[sfm] video 8x{h}x{w}: rendered in {render_ms:.1f} ms; descriptors per frame "
          f"{ctr['n_descriptors']}; bootstrap {n0} landmarks ({init_ms:.1f} ms); add_frame (ms) "
          f"{', '.join(f'{v:.1f}' for v in add_ms)} (median {_median(add_ms):.1f}), PnP inliers "
          f"{inliers}; map {smap.n_landmarks} landmarks / {smap.n_obs} observations; global BA "
          f"{ba_ms:.1f} ms (cost {float(stats.initial_cost):.1f} -> {float(stats.final_cost):.1f}); "
          f"RMS {rms:.4f} px; ATE {ate:.5f} ({smi_line})", flush=True)
    _require(smap.n_cameras == n, f"sfm: {smap.n_cameras} of {n} frames registered")
    _require(rms < 1.0, f"sfm: reprojection RMS {rms:.3f} px >= 1")
    _require(ate < 0.1, f"sfm: ATE {ate:.4f} >= 0.1")
    _print_programs("after the video scene")
    valid, nc, nlm, no = smap._fill()
    problem = smap._problem(valid, nc, nlm, no, 1)
    _eager_vs_replay(
        "sfm", f"the video map's global BA ({nc} / {nlm} / {no} camera, landmark and observation "
               f"buckets, {cfg.ba_iterations} Huber iterations)",
        lambda: bundle_adjust(problem, n_iterations=cfg.ba_iterations, huber_delta=cfg.ba_huber_delta),
        lambda: sfm.replayed_bundle_adjust(problem, cfg.ba_iterations, cfg.ba_huber_delta),
        sfm._BA_GRAPHS, smi_line)


def _print_programs(when):
    """The SfM programs cached and the device memory reserved."""
    import torch

    from siftmetal_tpu_torch.slam import sfm

    print(f"[sfm] {when}: {len(sfm._BA_GRAPHS.graphs)} BA and "
          f"{len(sfm._POSE_GRAPH_GRAPHS.graphs)} pose-graph programs cached; device memory "
          f"reserved {torch.cuda.memory_reserved() / 2**30:.3f} GiB, allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB", flush=True)


# RANSAC streams of the loop scene: an int is one generator of that seed
# passed to every call, None no generator (each method seeds the constant
# its JAX method uses). The scene's opening pair has ~2 degrees of parallax,
# and whether the map built from it meets the test's bars depends on the
# stream in both packages (scripts/loop_scene_streams.py; the JAX test's
# own stream misses a bar on the CPU). LOOP_GATED, the stream that must
# register every frame and meet the three bars, is the first seeded one;
# two more (the default stream, which misses a bar, and seed 1) are run and
# printed; the statistic over many streams is that script's.
LOOP_GATED = 0
LOOP_STREAMS = (0, None, 1)


def _loop_scene(dev):
    """tests/test_sfm.py::test_loop_closure_drift_repair's scene: 52
    keyframes orbiting inside a cylinder wall of 2600 landmarks with
    unique descriptors, 0.2 px noise; frames projected on the card."""
    import numpy as np
    import torch

    from siftmetal_tpu_torch.slam.camera import project
    from siftmetal_tpu_torch.slam.sfm import SfmMap

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
    lms_t, k_t = torch.from_numpy(lms).to(dev), torch.from_numpy(k).to(dev)
    frames = []
    for f in range(n_frames):
        uvs = project(torch.from_numpy(cams[f]).to(dev), k_t, lms_t).cpu().numpy()
        depth = SfmMap._depths(cams[f], lms)
        inside = ((depth > 1.0) & (uvs[:, 0] > 0) & (uvs[:, 0] < 640)
                  & (uvs[:, 1] > 0) & (uvs[:, 1] < 480))
        uvs = uvs + rng.normal(0, 0.2, uvs.shape)
        frames.append((uvs[:, ::-1].copy().astype(np.float32), descs, inside))
    return k, cams, frames


def _loop_stream(dev, k, cams, frames, seed, smi_line):
    """One RANSAC stream through the loop scene with the test's config and
    flow (initialize on frames 0 and 1, add_frame for the rest, a global
    bundle_adjust every 10th frame); stops at the first frame that does
    not register. On the gated stream, the repair's pose graph replayed
    against its eager call before the repair. Returns its numbers."""
    import numpy as np
    import torch

    from siftmetal_tpu_torch.slam import sfm
    from siftmetal_tpu_torch.slam.pose_graph import optimize_pose_graph
    from siftmetal_tpu_torch.slam.sfm import SfmConfig, SfmMap
    from siftmetal_tpu_torch.slam.trajectory import ate_rmse, camera_centers

    n = len(frames)
    gen = None if seed is None else torch.Generator(device=dev).manual_seed(seed)
    cfg = SfmConfig(max_cameras=64, max_landmarks=4096, max_observations=131072,
                    new_landmarks_per_frame=512)
    smap = SfmMap(k, cfg, device=dev)
    t0 = time.perf_counter()
    smap.initialize(frames[0], frames[1], generator=gen)
    for fi, f in enumerate(frames[2:], start=2):
        ok, n_in, _ = smap.add_frame(f, generator=gen)
        if not ok:
            return dict(seed=seed, registered=fi, inliers=n_in, build_s=time.perf_counter() - t0,
                        bars=False)
        if fi % 10 == 0:
            smap.bundle_adjust()
    build_s = time.perf_counter() - t0
    ate = lambda: ate_rmse(camera_centers(smap.cameras[:n]), camera_centers(cams))
    base = ate()
    drift = np.zeros((n, 6), np.float32)
    g = np.linspace(0, 1, n - 26) ** 1.5
    drift[26:, 1] = 0.06 * g
    drift[26:, 3] = 0.8 * g
    smap.cameras[:n] += drift
    bad = ate()
    t0 = time.perf_counter()
    edges = smap.detect_loop_closures(generator=gen)
    detect_ms = (time.perf_counter() - t0) * 1e3
    if seed == LOOP_GATED:
        g, huber = smap._pose_graph(edges)
        _eager_vs_replay(
            "sfm", f"the loop map's pose graph ({g.poses.shape[0]} poses / {g.edge_i.shape[0]} "
                   f"edges buckets, 60 iterations)",
            lambda: optimize_pose_graph(g, n_iterations=60, huber_delta=huber),
            lambda: sfm._jit_optimize_pose_graph(g, 60, huber), sfm._POSE_GRAPH_GRAPHS,
            smi_line, calls=1, profile_eager=False)
    t0 = time.perf_counter()
    smap.optimize_pose_graph(loop_closures=edges, n_iterations=60)
    graph_ms = (time.perf_counter() - t0) * 1e3
    repaired = ate()
    bars = (bad > 3 * base + 0.02, len(edges) >= 1 and min(e[0] for e in edges) <= 5,
            repaired < 0.5 * bad)
    return dict(seed=seed, registered=n, build_s=build_s, base=base, bad=bad, repaired=repaired,
                edges=[(int(e[0]), int(e[1])) for e in edges], detect_ms=detect_ms,
                graph_ms=graph_ms, landmarks=smap.n_landmarks, culled=smap.n_culled,
                each_bar=bars, bars=all(bars), programs=len(sfm._BA_GRAPHS.graphs))


def _print_loop_stream(r, n, smi_line):
    if r["registered"] < n:
        print(f"[sfm] loop stream {r['seed']}: frame {r['registered']} did not register "
              f"({r['inliers']} inliers, {r['build_s']:.2f} s)", flush=True)
        return
    print(f"[sfm] loop stream {r['seed']}: {n} keyframes built in {r['build_s']:.2f} s "
          f"({r['landmarks']} landmarks, {r['culled']} culled); ATE base {r['base']:.5f}, "
          f"drifted {r['bad']:.5f}, repaired {r['repaired']:.5f}; closures {r['edges']}; "
          f"detect_loop_closures {r['detect_ms']:.1f} ms, optimize_pose_graph (60 iterations) "
          f"{r['graph_ms']:.1f} ms; three bars {r['each_bar']}; BA programs cached after it "
          f"{r['programs']} ({smi_line})", flush=True)


def _sfm_loop(dev, smi_line):
    """tests/test_sfm.py::test_loop_closure_drift_repair on the card: its
    scene, its config, its flow and its gates on the stream LOOP_GATED:
    every one of the 52 frames registers, the drifted ATE is above 3x the
    base ATE + 0.02, a closure lands on a frame <= 5, and the repaired ATE
    is below half the drifted one. The other streams of LOOP_STREAMS are
    run and printed (how many register every frame, how many meet the
    bars), not gated."""
    k, cams, frames = _loop_scene(dev)
    n = len(frames)
    runs = [_loop_stream(dev, k, cams, frames, seed, smi_line) for seed in LOOP_STREAMS]
    for r in runs:
        _print_loop_stream(r, n, smi_line)
    _print_programs("after the loop scene")
    print(f"[sfm] loop streams: {sum(r['registered'] == n for r in runs)} of {len(runs)} registered "
          f"every frame, {sum(r['bars'] for r in runs)} of {len(runs)} met the three bars", flush=True)
    gated = runs[LOOP_STREAMS.index(LOOP_GATED)]
    _require(gated["registered"] == n,
             f"sfm loop: frame {gated['registered']} of the gated stream did not register")
    _require(gated["each_bar"][0], "sfm loop: the drifted ATE is not above 3x base + 0.02")
    _require(gated["each_bar"][1], "sfm loop: no closure against a frame <= 5")
    _require(gated["each_bar"][2], "sfm loop: the repaired ATE is not below half the drifted one")


def phase_sfm(reports, smi_line):
    """The SfM back-end at full width: BA at mapping size, the video
    sequence at 480x640 through SIFT and SfmMap, the loop-closure scene."""
    import torch

    from siftmetal_tpu_torch.device import resolve_device

    t0 = time.time()
    dev = resolve_device("cuda")
    _sfm_mapping_ba(dev, smi_line)
    _sfm_video(reports, dev, smi_line)
    _sfm_loop(dev, smi_line)
    torch.cuda.synchronize()
    print(f"[sfm] phase {time.time() - t0:.1f} s", flush=True)


def _device_profile(fn):
    """One call of ``fn`` under torch.profiler: (host wall ms, device busy
    ms as the union of the kernels' spans, the kernel events, the events,
    {kernel name: (device ms, count)}, the on-device test)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
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
    per = {}
    for e in kern:
        n, c = per.get(e.name, (0.0, 0))
        per[e.name] = (n + e.time_range.elapsed_us() / 1e3, c + 1)
    return wall, busy / 1e3, kern, events, per, on_dev


def _profile(tag, fn):
    """One call of ``fn`` under torch.profiler: the union of device kernel
    time against the host's wall time (the idle share), each stage's host
    and device span (an eager call's: a graph replay records no range),
    and the kernels with the most device time. Returns (wall ms, busy ms)."""
    wall, busy, kern, events, per, on_dev = _device_profile(fn)
    spans = {}
    for e in events:
        if e.name.startswith("sift_"):
            key = e.name + ("_device" if on_dev(e) else "_host")
            spans[key] = round(spans.get(key, 0.0) + e.time_range.elapsed_us() / 1e3, 3)
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:8]
    print(f"[profile {tag}] one call under the profiler: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms in {len(kern)} device ops (idle {100.0 * (1.0 - busy / wall):.1f}%); "
          f"stage spans (ms) {json.dumps(spans)}", flush=True)
    print(f"[profile {tag}] most device time: " + "; ".join(
        f"{name[:44]} {ms:.3f} ms x{c}" for name, (ms, c) in top), flush=True)
    # The patch kernels by form, whether or not they are among the top.
    forms = {"orientation (staged)": "::orientation_kernel", "orientation (resident)": "resident_orientation",
             "descriptor (staged)": "::descriptor_kernel<", "descriptor (resident)": "resident_descriptor",
             "resident layout": "layout_", "fused orient_desc": "orient_desc_kernel"}
    sums = {}
    for form, frag in forms.items():
        hit = [v for k, v in per.items() if frag in k]
        if hit:
            sums[form] = f"{sum(ms for ms, _ in hit):.3f} ms x{sum(c for _, c in hit)}"
    if sums:
        print(f"[profile {tag}] patch kernels: {json.dumps(sums)}", flush=True)
    pyr = {}
    for form, frag in {"band tiles": "band_tiles_kernel", "blur cascade": "blur_cascade_kernel",
                       "fused cascade": "stream_kernel", "band_x": "band_x_kernel",
                       "band_y": "band_y_kernel"}.items():
        hit = [v for k, v in per.items() if frag in k]
        if hit:
            pyr[form] = f"{sum(ms for ms, _ in hit):.3f} ms x{sum(c for _, c in hit)}"
    print(f"[profile {tag}] pyramid kernels: {json.dumps(pyr)}", flush=True)
    hit = [v for k, v in per.items() if "detect_kernel" in k]
    print(f"[profile {tag}] detection kernel: {sum(ms for ms, _ in hit):.3f} ms "
          f"x{sum(c for _, c in hit)}", flush=True)
    return wall, busy


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_parallel_child():
    """Start the parallel phase's child process (this script with
    ``--parallel-child``) at world size 1: it imports, sets up its CUDA
    context, joins its NCCL group and builds the frame loader while the
    other phases run, then waits for ``go`` on its standard input before
    it touches a kernel or times anything."""
    import os

    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
    return subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--parallel-child"],
                            env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def phase_parallel(child, smi_line):
    """The multi-device layer, in the child process started by
    start_parallel_child, so that its NCCL process group cannot reach the
    other phases. Fails when the child does."""
    t0 = time.time()
    out, err = child.communicate("go\n", timeout=600)
    sys.stdout.write(out)
    sys.stderr.write(err)
    sys.stdout.flush()
    _require(child.returncode == 0, f"parallel: the child process exited with {child.returncode}")
    print(f"[parallel] phase {time.time() - t0:.1f} s from go to the child's exit "
          f"({smi_line})", flush=True)


def _parallel_extraction(mesh, smi_line):
    """make_batch_extractor at world size 1 on the main path's frames: its
    replay against its eager route (bit for bit, ms in turns); then a
    replay with every launch counter set to 0 just before and read just
    after: a replay runs no wrapper, so its launches are counted on the
    device by kernel name (the largest of three profiles, as in _drive)
    and held group by group against the eager route's counters (the main
    path's launches checked); every field equal to SIFT.extract_batch bit
    for bit; ms a batch of both in turns."""
    import torch

    from siftmetal_tpu_torch import SIFT, SiftConfig
    from siftmetal_tpu_torch.ops.kernels import (
        KERNEL_GROUPS, LAUNCHES, device_launches, group_launches, reset_launches)
    from siftmetal_tpu_torch.parallel import make_batch_extractor

    sift = SIFT(480, 640)
    x = _noise_frames(sift.device)
    extract = make_batch_extractor(mesh, 480, 640, SiftConfig())
    _eager_vs_replay("parallel", "make_batch_extractor (NCCL, world 1) 8x480x640",
                     lambda: extract.eager(x), lambda: extract(x), extract.graphs, smi_line, calls=5)
    ref = sift.extract_batch(x)
    torch.cuda.synchronize()
    reset_launches()
    extract.eager(x)
    torch.cuda.synchronize()
    eager_launches = dict(LAUNCHES)
    out, profiles = {}, []
    reset_launches()
    for _ in range(3):
        kern = _device_profile(lambda: out.__setitem__("result", extract(x)))[2]
        profiles.append(device_launches(e.name for e in kern))
    host = dict(LAUNCHES)
    _require(sum(host.values()) == 0, f"parallel: the replay ran kernel wrappers {host}")
    seen = {g: max(p[g] for p in profiles) for g in profiles[0]}
    want = group_launches(eager_launches)
    bad = {"+".join(g): (seen[g], want[g]) for g in KERNEL_GROUPS.values() if seen[g] != want[g]}
    _require(not bad, f"parallel: device launches of the replayed sharded extractor differ from "
                      f"its eager route's (kernel group: (replay, eager)) {bad}")
    launches = eager_launches
    missing = [k for k in PARITY_KERNELS if launches[k] == 0]
    _require(not missing, f"parallel: the sharded extractor never launched {missing}")
    _require_launches("parallel", launches, PARITY_PYRAMID)
    _require_launches("parallel", launches, PARITY_DETECT, "detection")
    _require_launches("parallel", launches, ONE_ORIENTATION, "orientation")
    _require_launches("parallel", launches, DESCRIBE_GLUE, "describe glue")
    kps, descs, ctr = out["result"]
    rk, rd, rc = ref
    for name, a, b in zip(kps._fields + descs._fields, (*kps, *descs), (*rk, *rd)):
        _require(a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b),
                 f"parallel: sharded {name} differs from extract_batch")
    _require(set(ctr) == set(rc) and all(torch.equal(ctr[k], rc[k]) for k in rc),
             "parallel: sharded counters differ from extract_batch")
    ms_shard, ms_one = [], []
    for _ in range(2):
        ms_shard += _windows(lambda: extract(x), 1, 5)
        ms_one += _windows(lambda: sift.extract_batch(x), 1, 5)
    print(f"[parallel] make_batch_extractor (NCCL, world 1) 8x480x640 replayed: every field equal "
          f"to SIFT.extract_batch bit for bit; launches of the replayed call, counted on the "
          f"device {json.dumps({'+'.join(g): n for g, n in seen.items() if n})}, by wrapper "
          f"{json.dumps({k: v for k, v in launches.items() if v})}; median {_median(ms_shard):.3f} "
          f"ms/batch (windows of 5: {', '.join(f'{v:.3f}' for v in ms_shard)}) against "
          f"extract_batch {_median(ms_one):.3f} ({', '.join(f'{v:.3f}' for v in ms_one)}) "
          f"({smi_line})", flush=True)


def _parallel_matcher(mesh, smi_line):
    """make_sharded_matcher on the fast phase's 4096 x 131072 map: its
    replay against its eager route; every field equal to
    match_bruteforce; ms of both in turns."""
    import torch

    from siftmetal_tpu_torch.match import match_bruteforce
    from siftmetal_tpu_torch.parallel import make_sharded_matcher

    queries, targets, qv, tv, src = _big_map(torch.device("cuda"))
    match = make_sharded_matcher(mesh)
    _eager_vs_replay("parallel", "make_sharded_matcher (NCCL, world 1) 4096 x 131072",
                     lambda: match.eager(queries, qv, targets, tv),
                     lambda: match(queries, qv, targets, tv), match.graphs, smi_line, calls=3)
    got = match(queries, qv, targets, tv)
    want = match_bruteforce(queries, targets, qv, tv)
    _require(torch.equal(got.valid, want.valid), "parallel: sharded matcher valid != match_bruteforce")
    ok = want.valid
    _require(torch.equal(got.target_idx[ok], want.target_idx[ok]),
             "parallel: sharded matcher target_idx != match_bruteforce where valid")
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    ms_shard, ms_one = [], []
    for _ in range(2):
        ms_shard.append(_time_ms(lambda: match(queries, qv, targets, tv), 3))
        ms_one.append(_time_ms(lambda: match_bruteforce(queries, targets, qv, tv), 3))
    print(f"[parallel] make_sharded_matcher 4096 x 131072 x 128 uint8: {int(got.count)} accepted, "
          f"valid and target_idx equal to match_bruteforce (every field equal: {same}); "
          f"{_median(ms_shard):.3f} ms ({', '.join(f'{v:.3f}' for v in ms_shard)}) against "
          f"match_bruteforce {_median(ms_one):.3f} ({', '.join(f'{v:.3f}' for v in ms_one)}) "
          f"({smi_line})", flush=True)


def _parallel_ba(mesh, smi_line):
    """make_distributed_ba at the sfm phase's mapping size, 3 iterations:
    the cost falls from ~228192 to below 1, as bundle_adjust's does; its
    replay against its eager route; ms a call of it and bundle_adjust in
    turns, and the peak memory of the distributed one."""
    import torch

    from siftmetal_tpu_torch.parallel import make_distributed_ba, shard_ba_problem
    from siftmetal_tpu_torch.slam.ba import bundle_adjust

    dev = torch.device("cuda")
    t_set = time.perf_counter()
    problem = _mapping_problem(dev)
    t0 = time.perf_counter()
    sharded = shard_ba_problem(problem, 1, max_obs_per_landmark=4)
    shard_ms = (time.perf_counter() - t0) * 1e3
    run = make_distributed_ba(mesh, n_iterations=3, damping=1e-4)
    single = lambda: bundle_adjust(problem, n_iterations=3, damping=1e-4, max_obs_per_landmark=4)
    t1 = time.perf_counter()
    cams, lms, (c0, c1) = run(sharded)
    t2 = time.perf_counter()
    out, stats = single()
    torch.cuda.synchronize()
    set_up = (t1 - t_set, t2 - t1, time.perf_counter() - t2)
    c0, c1 = float(c0), float(c1)
    _require(abs(c0 - float(stats.initial_cost)) <= 1e-4 * c0 and c1 < 1.0,
             f"parallel: distributed BA cost {c0:.1f} -> {c1:.4f}, not bundle_adjust's "
             f"{float(stats.initial_cost):.1f} -> below 1")
    dc = float((cams - out.cameras).abs().max())
    dl = float((lms.reshape(-1, 3) - out.landmarks).abs().max())
    _require(dc < 1e-4 and dl < 1e-3,
             f"parallel: distributed BA differs from bundle_adjust by {dc:.2e} (cameras), "
             f"{dl:.2e} (landmarks)")
    _eager_vs_replay("parallel", "make_distributed_ba (NCCL, world 1) at mapping size, M=4, "
                     "3 iterations", lambda: run.eager(sharded), lambda: run(sharded), run.graphs,
                     smi_line)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    ms_dist = _windows(lambda: run(sharded), 1, 2)
    peak = torch.cuda.max_memory_allocated(dev)
    ms_one = _windows(single, 1, 2)
    ms_dist += _windows(lambda: run(sharded), 1, 2)
    ms_one += _windows(single, 1, 2)
    print(f"[parallel] make_distributed_ba (NCCL, world 1) {problem.cameras.shape[0]} cameras / "
          f"{problem.landmarks.shape[0]} landmarks / {problem.cam_idx.shape[0]} observations, "
          f"M=4, 3 iterations: cost {c0:.1f} -> {c1:.4f} (bundle_adjust {float(stats.initial_cost):.1f}"
          f" -> {float(stats.final_cost):.4f}); cameras within {dc:.2e}, landmarks within {dl:.2e} "
          f"of bundle_adjust; shard_ba_problem {shard_ms:.1f} ms on the host; median "
          f"{_median(ms_dist):.3f} ms a call ({', '.join(f'{v:.3f}' for v in ms_dist)}) against "
          f"bundle_adjust {_median(ms_one):.3f} ({', '.join(f'{v:.3f}' for v in ms_one)}); peak "
          f"memory allocated in replayed calls {peak / 2**20:.1f} MiB ({(peak - held) / 2**20:.1f} "
          f"MiB above the inputs; the graphs' pool is reserved apart: the line above); set-up "
          f"wall s: problem {set_up[0]:.2f}, first distributed call (warm-up, capture, replay) "
          f"{set_up[1]:.2f}, first bundle_adjust {set_up[2]:.2f} ({smi_line})", flush=True)


def _parallel_elastic():
    """run_elastic with one injected failure, a barrier in every step."""
    from siftmetal_tpu_torch.parallel import multihost

    saved, fail_at = {}, {3}

    def step_fn(step, state):
        if step in fail_at:
            fail_at.discard(step)
            raise RuntimeError("injected failure")
        multihost.barrier(f"step {step}")
        return state + 1

    import logging

    logging.getLogger("siftmetal_tpu_torch.multihost").setLevel(logging.CRITICAL)
    step, state = multihost.run_elastic(
        step_fn, 0, n_steps=5, checkpoint_every=1,
        save_fn=lambda s, st: saved.__setitem__("c", (s, st)),
        restore_fn=lambda: saved.get("c"), backoff_s=0.0,
    )
    _require((step, state) == (5, 5), f"parallel: the elastic loop ended at {(step, state)}")
    print("[parallel] run_elastic: one injected failure at step 3, restored from the step-3 "
          "checkpoint, reached step 5 with state 5", flush=True)


def _parallel_loader(smi_line):
    """FrameLoader (the native library, built at first use): eight 480x640
    frames of the video scene written as PPM to a temporary directory,
    read back in one pinned batch, moved to the card and extracted there."""
    import tempfile

    import numpy as np
    import torch

    from examples.video_sfm_torch import render, textured_scene
    from siftmetal_tpu_torch import SIFT
    from siftmetal_tpu_torch.utils import frame_loader
    from siftmetal_tpu_torch.utils.io import save_image

    dev = torch.device("cuda")
    h, w, n = 480, 640, 8
    k = np.array([[520, 0, w / 2], [0, 520, h / 2], [0, 0, 1]], np.float32)
    centers, amps, widths = textured_scene(np.random.default_rng(0), width_scale=2.0)
    cams = np.zeros((n, 6), np.float32)
    cams[:, 3] = np.linspace(0, 1.2, n)
    cams[:, 1] = np.linspace(0, 0.06, n)
    imgs = torch.stack([render(c, k, centers, amps, widths, h, w, dev) for c in cams])
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for i, img in enumerate(imgs.cpu()):
            paths.append(f"{d}/frame{i}.ppm")
            save_image(paths[-1], torch.stack([img] * 3, -1))
        loads = []
        with frame_loader.FrameLoader(h, w, n_threads=8) as loader:
            for _ in range(3):
                t0 = time.perf_counter()
                loader.submit_all(paths)
                batch = loader.next_batch(n)
                loads.append(time.perf_counter() - t0)
            _require(loader.error_count == 0, f"parallel: the loader counted {loader.error_count} errors")
    _require(batch.is_pinned(), "parallel: the loader's batch is not in pinned memory")
    frames = batch.to(dev, non_blocking=True)
    # Written as 8-bit samples (truncated): within 1/255 of the rendered
    # frames, plus the float rounding of the loader's gray conversion.
    err = float((frames - imgs).abs().max())
    _require(err <= 1.0 / 255.0 + 1e-6,
             f"parallel: loaded frames differ from the written ones by {err:.2e}")
    _, descs, ctr = SIFT(h, w).extract_batch(frames)
    nd = [int(v) for v in ctr["n_descriptors"].cpu()]
    _require(min(nd) > 0, f"parallel: descriptors per loaded frame {nd}")
    fps = n / _median(loads)
    print(f"[parallel] FrameLoader: 8 PPM frames 480x640 "
          f"decoded to gray by 8 threads in {', '.join(f'{1e3 * v:.2f}' for v in loads)} ms "
          f"({fps:.1f} frames/s median, host clock); within {err:.2e} of the written frames; "
          f"extracted on the card: descriptors per frame {nd} ({smi_line})", flush=True)


def parallel_child() -> int:
    """The body of the parallel phase: world size 1 through NCCL. Gets
    ready (imports, CUDA context, initialize and a barrier, the frame
    loader's build), waits for ``go`` on standard input, then runs the
    checks, each timed on the host clock."""
    t_start = time.time()
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    smi_line = _smi()
    from siftmetal_tpu_torch.parallel import make_mesh, multihost
    from siftmetal_tpu_torch.utils import frame_loader

    torch.cuda.init()
    torch.zeros(1, device="cuda")
    t_ctx = time.time()
    rank, world = multihost.initialize()
    _require((rank, world) == (0, 1) and dist.get_backend() == "nccl",
             f"parallel: initialize gave rank {rank} of {world} on {dist.get_backend()}")
    count = multihost.barrier("startup")
    _require(count == 1.0, f"parallel: barrier counted {count} devices")
    mesh = make_mesh(1)
    _require(mesh.device_type == "cuda", f"parallel: a {mesh.device_type} mesh")
    t_init = time.time()
    frame_loader.build()
    t_build = time.time()
    print(f"[parallel] child ready: imports and CUDA context {t_ctx - t_start:.2f} s, initialize "
          f"(NCCL, rank 0 of 1) and barrier (counted {count:.0f} device) {t_init - t_ctx:.2f} s, "
          f"frame loader built {t_build - t_init:.2f} s ({smi_line})", flush=True)
    if sys.stdin.readline().strip() != "go":
        dist.destroy_process_group()
        return 1
    parts = {}
    try:
        for name, fn in (("extractor", lambda: _parallel_extraction(mesh, smi_line)),
                         ("matcher", lambda: _parallel_matcher(mesh, smi_line)),
                         ("distributed BA", lambda: _parallel_ba(mesh, smi_line)),
                         ("elastic", _parallel_elastic),
                         ("loader", lambda: _parallel_loader(smi_line))):
            t0 = time.time()
            fn()
            parts[name] = time.time() - t0
        multihost.barrier("shutdown")
    finally:
        dist.destroy_process_group()
    print("[parallel] parts, wall s on the host clock: "
          + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()), flush=True)
    return 0


# The flat frames of phase_flat, one value a frame; 0.1, 0.3 and 0.9 are
# not bf16 values, so the bf16 chain rounds them.
FLAT_VALUES = (0.5, 1.0, 0.1, 0.25, 0.75, 0.0, 0.3, 0.9)


def _many_valued(stacks, boxes=None):
    """(octave, kind, frame, slice) of every plane of the per-octave
    (gauss, dog) stacks [B, S, H, W] that holds more than one value: in the
    whole plane, or with ``boxes`` within that octave's (rows, cols)."""
    import torch

    bad = []
    for o, pair in enumerate(zip(*stacks)):
        rows, cols = (slice(None), slice(None)) if boxes is None else boxes[o]
        for kind, st in zip(("gauss", "dog"), pair):
            part = st[:, :, rows, cols].flatten(2)
            if part.shape[-1] == 0:
                continue
            diff = (part != part[:, :, :1]).any(-1)
            bad += [(o, kind, int(b), int(s)) for b, s in torch.nonzero(diff).tolist()]
    return bad


def _strict_extrema(dog, rows, cols):
    """Samples of the DoG stack [S, H, W] at its interior scales within
    ``rows`` x ``cols`` (at least one sample inside every border) that are
    strictly above or below all 26 neighbours: the extremum test of
    ``n_extrema``."""
    import torch

    c = dog[1:-1, rows, cols]
    hi = torch.full_like(c, -math.inf)
    lo = torch.full_like(c, math.inf)
    n_s = dog.shape[0]
    for ds in (-1, 0, 1):
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                if ds == di == dj == 0:
                    continue
                nb = dog[1 + ds:n_s - 1 + ds, rows.start + di:rows.stop + di,
                         cols.start + dj:cols.stop + dj]
                hi = torch.maximum(hi, nb)
                lo = torch.minimum(lo, nb)
    return int(((c > hi) | (c < lo)).sum())


def _flat_interiors(cfg, shapes, box):
    """Per octave, the (rows, cols) slices of the flat input block ``box``
    ((y0, y1, x0, x1) in input pixels) that no pixel outside it reaches:
    the block in octave pixels, shrunk by the reach of every blur so far
    (the seed's upsample and radius, then per octave half the reach before
    plus the octave's one-shot radius or its cascade's radii summed) and one
    sample for the extremum test's neighbours."""
    from siftmetal_tpu_torch.ops.kernels import pyramid as KY

    radius = lambda sig: int(math.ceil(4.0 * sig))
    out, reach = [], 0
    for o, (h, w) in enumerate(shapes):
        if o == 0:
            reach = max(radius(s) for s in KY._seed_sigmas(cfg)) + 2
        elif cfg.use_oneshot_pyramid and KY.supports(cfg, h):
            reach = (reach + 1) // 2 + 1 + max(radius(r) for r in KY.oneshot_rhos(cfg))
        else:
            reach = (reach + 1) // 2 + 1 + sum(radius(r) for r in cfg.incremental_sigmas(o))
        scale = 1.0 / (cfg.delta_min * 2 ** o)
        y0, y1, x0, x1 = (math.ceil(box[0] * scale), math.floor(box[1] * scale),
                          math.ceil(box[2] * scale), math.floor(box[3] * scale))
        m = reach + 1
        r0, c0 = max(y0 + m, 1), max(x0 + m, 1)
        out.append((slice(r0, max(r0, min(y1 - m, h - 1))),
                    slice(c0, max(c0, min(x1 - m, w - 1)))))
    return out


def phase_flat(smi_line):
    """A flat image stays flat on the card. Eight flat 480x640 frames (one
    value each, FLAT_VALUES) through build_pyramid_batch on every pyramid
    route (fused seed + one-shot + fp32 cascade, the fast preset's bf16
    chain, the unfused seed with the fp32 and bf16 cascades, the fused
    cascade kernel): every Gaussian and DoG plane holds one value; then
    extract_batch under the parity configuration and FAST_BF16_CONFIG: no
    extremum, keypoint or descriptor. Then the butterfly with a flat block
    pasted in, under both: every slice one value and no strict extremum
    inside the block's interior (what no pixel outside it reaches); the
    same extremum test over the whole frame gives extract_batch's
    n_extrema."""
    import dataclasses

    import torch

    from siftmetal_tpu_torch import FAST_BF16_CONFIG, SIFT, SiftConfig
    from siftmetal_tpu_torch.ops.image import rgb_to_gray
    from siftmetal_tpu_torch.sift.batched import build_pyramid_batch
    from siftmetal_tpu_torch.utils.io import load_image

    dev = torch.device("cuda")
    h, w = 480, 640
    flat = torch.tensor(FLAT_VALUES, device=dev)[:, None, None].expand(8, h, w).contiguous()
    extracted = {"parity": SiftConfig(), "fast_bf16": FAST_BF16_CONFIG}
    routes = dict(extracted, unfused=SiftConfig(use_oneshot_pyramid=False),
                  unfused_bf16=dataclasses.replace(FAST_BF16_CONFIG, use_oneshot_pyramid=False),
                  pallas_pyramid=SiftConfig(use_oneshot_pyramid=False, use_pallas_pyramid=True))
    for tag, cfg in routes.items():
        stacks = build_pyramid_batch(flat, cfg, cfg.num_octaves(h, w))
        bad = _many_valued(stacks)
        _require(not bad, f"flat {tag}: {len(bad)} planes hold more than one value, e.g. {bad[:4]}")
        del stacks
    line = []
    for tag, cfg in extracted.items():
        kps, descs, ctr = SIFT(h, w, config=cfg).extract_batch(flat)
        ext = [int(v) for v in ctr["n_extrema"].cpu()]
        _require(not any(ext), f"flat {tag}: n_extrema {ext}")
        _require(not bool(kps.valid.any()) and not bool(descs.valid.any()),
                 f"flat {tag}: keypoints or descriptors on a flat frame")
        line.append(f"{tag} n_extrema {ext}")
    print(f"[flat] 8 flat {h}x{w} frames ({', '.join(map(str, FLAT_VALUES))}): every Gaussian and "
          f"DoG plane one value a frame on routes {', '.join(routes)}; {'; '.join(line)}; no "
          f"keypoint or descriptor ({smi_line})", flush=True)

    img = torch.from_numpy(load_image(str(ROOT / "tests" / "fixtures" / "butterfly.ppm"))).to(dev)
    box = (40, 300, 64, 448)
    img[box[0]:box[1], box[2]:box[3]] = 0.5
    gray = rgb_to_gray(img)[None].contiguous()
    for tag, cfg in extracted.items():
        n_oct = cfg.num_octaves(*gray.shape[-2:])
        shapes = cfg.octave_shapes(*gray.shape[-2:], n_oct)
        inner = _flat_interiors(cfg, shapes, box)
        stacks = build_pyramid_batch(gray, cfg, n_oct)
        bad = _many_valued(stacks, inner)
        _require(not bad, f"flat block {tag}: {len(bad)} planes vary inside the block, e.g. {bad[:4]}")
        n_in = [_strict_extrema(d[0], r, c) for d, (r, c) in zip(stacks[1], inner)]
        _require(not any(n_in), f"flat block {tag}: strict extrema inside the block {n_in}")
        n_all = sum(_strict_extrema(d[0], slice(1, d.shape[-2] - 1), slice(1, d.shape[-1] - 1))
                    for d in stacks[1])
        _, _, ctr = SIFT(*gray.shape[-2:], config=cfg).extract_batch(gray)
        _require(n_all == int(ctr["n_extrema"][0]),
                 f"flat block {tag}: the extremum test counts {n_all}, extract_batch "
                 f"{int(ctr['n_extrema'][0])}")
        sizes = [f"{r.stop - r.start}x{c.stop - c.start}" for r, c in inner]
        print(f"[flat] butterfly with rows {box[0]}:{box[1]}, columns {box[2]}:{box[3]} flat, {tag}: "
              f"interiors by octave {' '.join(sizes)}, every slice one value there, strict extrema "
              f"there {n_in}; n_extrema of the frame {int(ctr['n_extrema'][0])}, the same as the "
              f"extremum test over every octave ({smi_line})", flush=True)


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


def phase_fast_gates(smi_line):
    """Fast-preset gates on the card: the butterfly under FAST_BF16_CONFIG
    keeps at least 90% keypoint agreement with FAST_CONFIG (the bar of
    tests/test_repeatability.py::test_bf16_pyramid_agreement), and
    matching the butterfly against itself is the identity."""
    import torch

    from siftmetal_tpu_torch import FAST_BF16_CONFIG, FAST_CONFIG, SIFT
    from siftmetal_tpu_torch.match import geometry_score, match_bruteforce
    from siftmetal_tpu_torch.utils.io import load_image
    from siftmetal_tpu_torch.utils.repeatability import keypoint_agreement, keypoint_array

    img = load_image(str(ROOT / "tests" / "fixtures" / "butterfly.ppm"))
    h, w = img.shape[:2]
    k32, _, c32 = SIFT(h, w, config=FAST_CONFIG).extract(img)
    k16, d16, c16 = SIFT(h, w, config=FAST_BF16_CONFIG).extract(img)
    # The fast preset packs this detail-dense image into a quarter of the
    # parity path's pixels, so a few rows hold more soft extrema than a
    # row has slots: counted and shown, not a failure of the gate.
    over = {name: {key: int(c[key]) for key in OVERFLOWS} for name, c in (("fp32", c32), ("bf16", c16))}
    p32, s32 = keypoint_array(k32)
    p16, _ = keypoint_array(k16)
    agree = keypoint_agreement(p32, s32, p16, (h, w))
    ratio = len(p16) / max(len(p32), 1)
    _require(agree >= 0.90, f"bf16 pyramid agreement {agree:.4f} < 0.90")
    _require(0.8 <= ratio <= 1.25, f"bf16 keypoint population {len(p16)} vs fp32 {len(p32)}")
    mt = match_bruteforce(d16.features, d16.features, d16.valid, d16.valid)
    v = d16.valid
    nv = int(v.sum())
    own = torch.arange(v.shape[0], device=v.device, dtype=torch.int32)
    _require(bool((mt.distance[v] == 0).all()), "self-match: a descriptor is not at distance 0 from itself")
    # Ties go to the lowest index, so a duplicated descriptor may report its
    # first copy: identical features, not necessarily the same index.
    _require(torch.equal(d16.features[mt.best_idx[v].long()], d16.features[v]),
             "self-match: best match is not the descriptor itself")
    same_idx = int((mt.best_idx[v] == own[v]).sum())
    _require(same_idx >= 0.99 * nv, f"self-match: {same_idx} of {nv} indices are the identity")
    xy = torch.stack([d16.x, d16.y], -1)
    score = float(geometry_score(mt, xy, xy))
    _require(int(mt.count) >= 0.95 * nv and score > 0.99,
             f"self-match: {int(mt.count)} of {nv} accepted, geometry score {score:.4f}")
    print(f"[gates] butterfly {h}x{w}: FAST_BF16 vs FAST keypoint agreement {agree:.4f} "
          f"({len(p16)} vs {len(p32)} keypoints); self-match {same_idx} of {nv} indices the identity, "
          f"{int(mt.count)} accepted under the ratio test, geometry score {score:.4f}; overflow "
          f"counters {json.dumps(over)} ({smi_line})",
          flush=True)


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

    resolve_device("cuda")
    child = start_parallel_child()
    try:
        return _main_phases(child, smi_line, t0)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()


def _main_phases(child, smi_line, t0) -> int:
    import torch

    from siftmetal_tpu_torch.ops import cuda as _cuda

    tb = time.time()
    logs = _cuda.build_all()
    for log in logs.values():
        PTXAS.update(_ptxas_facts(log))
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or ("spill" in line and "0 bytes spill stores" not in line):
                print(f"[nvcc {name}] {line.strip()}", flush=True)
    print(f"[device] built {sorted(logs) or 'nothing (up to date)'} in {time.time() - tb:.1f} s",
          flush=True)

    reports = phase_kernels(_peaks(torch.cuda.get_device_name(0)))
    parity_ctr = phase_main_path(reports, smi_line)
    phase_fast_path(reports, parity_ctr, smi_line)
    phase_pair(reports, smi_line)
    phase_sfm(reports, smi_line)
    phase_parallel(child, smi_line)
    phase_flat(smi_line)
    phase_ipol(smi_line)
    phase_fast_gates(smi_line)
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
        code = parallel_child() if sys.argv[1:] == ["--parallel-child"] else main()
    except Exception:
        import traceback

        traceback.print_exc()
        code = 1
    sys.exit(code)
