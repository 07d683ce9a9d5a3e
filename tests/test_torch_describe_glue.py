"""The describe stage's bookkeeping in three launches (``csrc/describe.cu``:
``keypoint_compact_kernel``, ``lane_peaks_kernel``, ``quantize_rows_kernel``
through ``sift/detect.py`` ``compact_keypoints`` and ``sift/describe.py``
``orientation_lanes`` / ``quantize_octaves``) against the PyTorch route
each replaces (``compact_keypoints_plain``, ``orientation_lanes_plain``,
``quantize_descriptors``).

On the CPU: the wrappers run the PyTorch route and launch nothing, raise on
any other device, and each kernel's name counts in its own profiler group
and in none of the benchmark's hand-written groups. On the card (``-m
cuda``): every field, lane array and count equal to the PyTorch route's on
the same inputs bit for bit, padding included, at B 1 and 8 at 480x640 in
the parity, fast bf16 and fused-describe configurations and on the edge
cases; the features equal in at least 99.99% of the valid rows' bytes and
never more than one level apart; one launch each a call, and all three
inside a captured graph. The file imports no JAX:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_describe_glue.py
"""

import dataclasses
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from siftmetal_tpu_torch.config import FAST_BF16_CONFIG, SiftConfig
from siftmetal_tpu_torch.graphs import GraphCache
from siftmetal_tpu_torch.ops.kernels import KERNEL_GROUPS, LAUNCHES, device_launches
from siftmetal_tpu_torch.ops.kernels.describe import LANE_INTS, LANE_REALS
from siftmetal_tpu_torch.ops.kernels.patches import (
    descriptor_lanes,
    orient_desc_lanes,
    orientation_hist_octaves,
    prepare_patch_fields,
)
from siftmetal_tpu_torch.sift import batched as PB
from siftmetal_tpu_torch.sift import describe as PDS
from siftmetal_tpu_torch.sift import detect as PD
from torch_bits import profiled_launches, same_bits

CFG = SiftConfig()
CONFIGS = {
    "parity": CFG,
    "fast_bf16": FAST_BF16_CONFIG,
    "fused": SiftConfig(use_fused_describe=True),
}
WRAPPERS = ("keypoint_compact", "lane_peaks", "quantize_rows")
GROUPS_FILE = pathlib.Path(__file__).resolve().parents[1] / "portbench/roofline/groups.py"


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (held on the H100 by chip_smoke.py)")
    return torch.device("cuda")


def _frames(b, h, w, dev, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0.0, 1.0, (b, h, w)).astype(np.float32)).to(dev)


def _detected(gray, cfg):
    """The pyramid and the detection stage of ``gray``: (gaussians, dogs,
    per-octave keypoint slot lists, budgets)."""
    gaussians, dogs = PB.build_pyramid_batch(gray, cfg, cfg.num_octaves(*gray.shape[-2:]))
    per_octave, _ = PD.detect_all_octaves_batch(dogs, cfg)
    budgets = [PD.keypoint_budget(cfg, tuple(d.shape[-2:]), o) for o, d in enumerate(dogs)]
    return gaussians, dogs, per_octave, budgets


def _launched(fn):
    """``fn()`` and the launches of each new wrapper it made."""
    n0 = {w: LAUNCHES[w] for w in WRAPPERS}
    out = fn()
    return out, {w: LAUNCHES[w] - n0[w] for w in WRAPPERS}


def _assert_fields_equal(got, want, what):
    """Two lists of NamedTuples (or of tensors) equal bit for bit."""
    assert len(got) == len(want), what
    for o, (a, b) in enumerate(zip(got, want)):
        pairs = zip(a._fields, a, b) if hasattr(a, "_fields") else [("", a, b)]
        for name, x, y in pairs:
            assert same_bits(x, y), (what, o, name, tuple(x.shape), tuple(y.shape))


def _assert_features(got, want, valid=None):
    """Quantised descriptors: equal in at least 99.99% of the bytes of the
    valid rows and never more than one level apart (the rule for a norm
    summed in another order); returns the share of equal bytes."""
    g = torch.cat([a.reshape(-1, a.shape[-1]) for a in got]).int()
    w = torch.cat([a.reshape(-1, a.shape[-1]) for a in want]).int()
    if valid is not None:
        keep = torch.cat([v.reshape(-1) for v in valid])
        g, w = g[keep], w[keep]
    diff = (g - w).abs()
    if not diff.numel():
        return 1.0
    assert int(diff.max()) <= 1
    equal = float((diff == 0).double().mean())
    assert equal >= 0.9999, equal
    return equal


# --- on the CPU ---------------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_wrappers_run_the_pytorch_route_on_the_cpu(name):
    """On CPU tensors each wrapper is its PyTorch route, bit for bit, and
    launches nothing."""
    cfg = CONFIGS[name]
    gaussians, _, per_octave, budgets = _detected(_frames(2, 60, 80, "cpu", seed=3), cfg)
    (kpcs, dropped), n = _launched(lambda: PD.compact_keypoints(per_octave, cfg, budgets))
    want_kpcs, want_dropped = PD.compact_keypoints_plain(per_octave, cfg, budgets)
    _assert_fields_equal(kpcs, want_kpcs, "keypoints")
    assert same_bits(dropped, want_dropped)
    assert int(sum(k.valid.sum() for k in kpcs)) > 0
    fields = [prepare_patch_fields(g, cfg) for g in gaussians]
    hist = orientation_hist_octaves(fields, kpcs, cfg)
    (lanes, lane_dropped), n2 = _launched(
        lambda: PDS.orientation_lanes(hist, kpcs, cfg, dropped))
    want_lanes, want_lane_dropped = PDS.orientation_lanes_plain(hist, kpcs, cfg, dropped)
    _assert_fields_equal(lanes, want_lanes, "lanes")
    assert same_bits(lane_dropped, want_lane_dropped)
    raws = [descriptor_lanes(f, *(a.reshape(-1) for a in (ln.scale, ln.x_oct, ln.y_oct,
                                                          ln.sigma_oct, ln.theta)),
                             cfg, valid=ln.valid.reshape(-1), frame=ln.frame.reshape(-1))
            for f, ln in zip(fields, lanes)]
    feats, n3 = _launched(lambda: PDS.quantize_octaves(raws, cfg))
    _assert_fields_equal(feats, [PDS.quantize_descriptors(r, cfg) for r in raws], "features")
    assert all(sum(c.values()) == 0 for c in (n, n2, n3))
    assert [tuple(ln.valid.shape) for ln in lanes] == [(2, PDS.lane_count(k)) for k in budgets]
    assert all(int(ln.octave.min()) == int(ln.octave.max()) == o for o, ln in enumerate(lanes))


def test_lane_planes_name_the_lane_fields():
    """The lane launch's planes are fields of ``DescribeLanes``, and the
    lane slots of an octave are 1.5 a keypoint slot in multiples of 128."""
    assert set(LANE_INTS + LANE_REALS) | {"valid"} == set(PDS.DescribeLanes._fields)
    assert [PDS.lane_count(k) for k in (256, 640, 1280, 2048)] == [384, 1024, 1920, 3072]


@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_wrappers_raise_for_other_devices(wrapper):
    """A meta tensor is neither the PyTorch route nor the kernels'."""
    meta = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")
    match = f"{wrapper}: unsupported device meta"
    with pytest.raises(ValueError, match=match):
        if wrapper == "keypoint_compact":
            kp = PD.OctaveKeypoints(*(meta(1, 8) for _ in PD.OctaveKeypoints._fields))
            PD.compact_keypoints([kp], CFG, [4])
        elif wrapper == "lane_peaks":
            PDS.orientation_lanes(meta(1, 4, 36), [None], CFG, meta(1, dtype=torch.int32))
        else:
            PDS.quantize_octaves([meta(4, 128)], CFG)


@pytest.mark.parametrize("name,wrapper", [
    ("keypoint_compact_kernel((anonymous namespace)::CompactLaunch)", "keypoint_compact"),
    ("void (anonymous namespace)::lane_peaks_kernel<36, 4>((anonymous namespace)::LaneLaunch)",
     "lane_peaks"),
    ("void (anonymous namespace)::lane_peaks_kernel<0, 0>((anonymous namespace)::LaneLaunch)",
     "lane_peaks"),
    ("void (anonymous namespace)::quantize_rows_kernel<true>((anonymous namespace)::QuantLaunch)",
     "quantize_rows"),
])
def test_kernels_count_in_their_own_group_only(name, wrapper):
    """Each kernel's name, as a profiler gives it, counts under its own
    group and under no other, and matches none of the benchmark's
    hand-written groups: its time stays glue there."""
    got = {group: n for group, n in device_launches([name]).items() if n}
    assert got == {(wrapper,): 1}
    assert (wrapper,) in KERNEL_GROUPS.values()
    spec = importlib.util.spec_from_file_location("roofline_groups", GROUPS_FILE)
    groups = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(groups)
    assert not any(re.search(p, name) for p in groups.KERNEL_PATTERNS)


# --- on the card --------------------------------------------------------------


def _glue_against_route(gaussians, per_octave, budgets, cfg):
    """Each kernel's outputs against the PyTorch route's on the same
    inputs: keypoints, lanes and counts bit for bit, features by the rule;
    returns (the launches of each wrapper, the share of equal feature
    bytes, valid lanes, dropped counts)."""
    (kpcs, dropped), n = _launched(lambda: PD.compact_keypoints(per_octave, cfg, budgets))
    want_kpcs, want_dropped = PD.compact_keypoints_plain(per_octave, cfg, budgets)
    _assert_fields_equal(kpcs, want_kpcs, "keypoints")
    assert same_bits(dropped, want_dropped)
    fields = [prepare_patch_fields(g, cfg) for g in gaussians]
    if cfg.use_fused_describe:
        b = kpcs[0].valid.shape[0]
        flat = lambda a: a.reshape(-1)
        raws, valid = [], []
        for f, k in zip(fields, kpcs):
            frame = torch.arange(b, dtype=torch.int32, device=f.gi.device).repeat_interleave(
                k.valid.shape[1])
            raw, _, ov = orient_desc_lanes(f, flat(k.scale), flat(k.x_oct), flat(k.y_oct),
                                           flat(k.sigma_oct), cfg, valid=flat(k.valid),
                                           frame=frame)
            raws.append(raw)
            valid.append(ov & k.valid.reshape(-1, 1))
        lane_dropped = dropped
    else:
        hist = orientation_hist_octaves(fields, kpcs, cfg)
        (lanes, lane_dropped), n2 = _launched(
            lambda: PDS.orientation_lanes(hist, kpcs, cfg, dropped))
        assert n2["lane_peaks"] == 1
        want_lanes, want_lane_dropped = PDS.orientation_lanes_plain(hist, kpcs, cfg, dropped)
        _assert_fields_equal(lanes, want_lanes, "lanes")
        assert same_bits(lane_dropped, want_lane_dropped)
        raws = [descriptor_lanes(f, *(a.reshape(-1) for a in (ln.scale, ln.x_oct, ln.y_oct,
                                                              ln.sigma_oct, ln.theta)),
                                 cfg, valid=ln.valid.reshape(-1), frame=ln.frame.reshape(-1))
                for f, ln in zip(fields, lanes)]
        valid = [ln.valid for ln in lanes]
    feats, n3 = _launched(lambda: PDS.quantize_octaves(raws, cfg))
    assert [tuple(f.shape) for f in feats] == [tuple(r.shape) for r in raws]
    equal = _assert_features(feats, [PDS.quantize_descriptors(r, cfg) for r in raws], valid)
    n_valid = int(sum(v.sum() for v in valid))
    return ({"keypoint_compact": n["keypoint_compact"], "quantize_rows": n3["quantize_rows"]},
            equal, n_valid, (dropped, lane_dropped))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_glue_kernels_equal_the_pytorch_route(cuda_dev, name, b):
    """Noise frames at 480x640 through the card's pyramid, detection,
    orientation and descriptor kernels: the three launches' outputs equal
    the PyTorch route's on the same inputs bit for bit, the features too,
    one launch each."""
    cfg = CONFIGS[name]
    gaussians, _, per_octave, budgets = _detected(_frames(b, 480, 640, cuda_dev, seed=b), cfg)
    launches, equal, n_valid, _ = _glue_against_route(gaussians, per_octave, budgets, cfg)
    assert launches == {"keypoint_compact": 1, "quantize_rows": 1}
    assert n_valid > 500 * b
    assert equal == 1.0  # 128 bins: the norms summed in vector_norm's order


@pytest.mark.cuda
def test_glue_kernels_on_an_empty_frame_and_small_budgets(cuda_dev):
    """A flat frame (no keypoint at all) beside noise frames, then the
    keypoint budgets forced small (the dropped keypoints counted; the
    lanes overflow in test_lane_peaks_on_crafted_histograms): everything
    equals the PyTorch route."""
    cfg = CFG
    gray = _frames(3, 240, 320, cuda_dev, seed=11)
    gray[1] = 0.5
    gaussians, _, per_octave, budgets = _detected(gray, cfg)
    assert int(per_octave[0].valid[1].sum()) == 0
    _, _, _, (dropped, lane_dropped) = _glue_against_route(gaussians, per_octave, budgets, cfg)
    assert int(dropped[1]) == 0 == int(lane_dropped[1])
    small = [max(1, k // 16) for k in budgets]
    _, _, _, (dropped, _) = _glue_against_route(gaussians, per_octave, small, cfg)
    assert int(dropped[0]) > 0 and int(dropped[1]) == 0


def _crafted_hists(cfg, dev, b=2, budget=256, seed=5):
    """Histogram rows for every case of the peak rule: random rows; rows
    with more than max_ori peaks, tied in height; flat rows (no peak);
    zero rows; a single peak; and every keypoint valid, so that the lanes
    overflow their slots."""
    rng = np.random.default_rng(seed)
    n = cfg.n_orientation_bins
    h = rng.gamma(1.0, 1.0, (b, budget, n)).astype(np.float32)
    teeth = np.zeros(n, np.float32)
    # Peaks every `period` bins (a divisor of n): tied after every smoothing.
    teeth[::next(p for p in range(6, n + 1) if n % p == 0)] = 2.0
    h[:, 1::4] = teeth
    h[:, 2::16] = 0.75                      # flat
    h[:, 3::16] = 0.0                       # empty
    h[:, 6::16] = 0.0
    h[:, 6::16, 7] = 1.0                    # one peak
    h[:, 0] = teeth                         # keypoint 0: tied peaks
    return torch.from_numpy(h).to(dev)


def _crafted_keypoints(b, budget, dev, seed=6, valid_share=1.0):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(dev)
    return PD.CompactOctaveKeypoints(
        valid=t(rng.random((b, budget)) < valid_share),
        scale=t(rng.integers(1, 4, (b, budget)).astype(np.int32)),
        **{f: t(rng.uniform(1, 100, (b, budget)).astype(np.float32))
           for f in ("x_oct", "y_oct", "sigma_oct", "x", "y", "sigma", "value")})


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["36x4", "32x3", "36x4-zero-smoothing"])
def test_lane_peaks_on_crafted_histograms(cuda_dev, shape):
    """Tied peaks beyond max_ori, flat and empty rows, a single peak, all
    keypoints valid (the lanes overflow) and a keypoint 0 with tied peaks,
    over two octaves: the kernel equals the PyTorch route bit for bit, in
    the (36, 4) instance and the generic one."""
    cfg = {"36x4": CFG,
           "32x3": dataclasses.replace(CFG, n_orientation_bins=32, max_orientations_per_keypoint=3),
           "36x4-zero-smoothing": dataclasses.replace(CFG, orientation_smoothing_iterations=0)}[shape]
    hist = torch.cat([_crafted_hists(cfg, cuda_dev, budget=256),
                      _crafted_hists(cfg, cuda_dev, budget=128, seed=9)], dim=1)
    kpcs = [_crafted_keypoints(2, 256, cuda_dev), _crafted_keypoints(2, 128, cuda_dev, 7, 0.5)]
    dropped = torch.tensor([3, 0], dtype=torch.int32, device=cuda_dev)
    (lanes, got_dropped), n = _launched(lambda: PDS.orientation_lanes(hist, kpcs, cfg, dropped))
    want, want_dropped = PDS.orientation_lanes_plain(hist, kpcs, cfg, dropped)
    assert n["lane_peaks"] == 1
    _assert_fields_equal(lanes, want, "lanes")
    assert same_bits(got_dropped, want_dropped)
    assert int((got_dropped - dropped).min()) > 0        # octave 0 overflows in both frames
    assert int(lanes[0].valid.sum()) == 2 * PDS.lane_count(256)
    assert float(lanes[1].theta[:, -1].abs().max()) > 0  # padding holds keypoint 0's theta


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 64])
def test_quantize_rows_on_crafted_rows(cuda_dev, d):
    """Zero rows, rows with one dominant bin (the clip), tiny and large
    magnitudes, over three arrays of different shapes: the quantisation
    follows the feature rule, exactly where the row has 128 bins."""
    rng = np.random.default_rng(d)
    raws = []
    for shape in ((40, d), (3, 4, d), (0, d)):
        r = rng.gamma(0.5, 1.0, shape).astype(np.float32)
        if r.size:
            r.reshape(-1, d)[::7] = 0.0
            r.reshape(-1, d)[1::7, 3] = 1e3
            r.reshape(-1, d)[2::7] *= 1e-15
            r.reshape(-1, d)[3::7] *= 1e15
        raws.append(torch.from_numpy(r).to(cuda_dev))
    feats, n = _launched(lambda: PDS.quantize_octaves(raws, CFG))
    assert n["quantize_rows"] == 1
    want = [PDS.quantize_descriptors(r, CFG) for r in raws]
    assert [f.shape for f in feats] == [w.shape for w in want]
    equal = _assert_features(feats, want)
    if d == 128:
        assert equal == 1.0


def _describe(steps, gaussians, dogs, per_octave, cfg):
    return steps.stage(PB._describe_octaves, gaussians, dogs, per_octave, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["parity", "fused"])
def test_describe_stage_replays_in_a_graph(cuda_dev, name):
    """The describe stage captured by a GraphCache: each replay equals the
    eager call bit for bit (on a second input too), runs no wrapper, and
    launches each glue kernel once on the device."""
    cfg = CONFIGS[name]
    cache = GraphCache(_describe, "describe")
    inputs = [_detected(_frames(2, 240, 320, cuda_dev, seed=s), cfg)[:3] for s in (7, 8)]
    for x in inputs:
        rows, dropped = cache(*x, cfg)
        want_rows, want_dropped = cache.eager(*x, cfg)
        assert same_bits(dropped, want_dropped)
        for r, w in zip(rows, want_rows):
            assert all(same_bits(r[k], w[k]) for k in w)
    n0 = dict(LAUNCHES)
    seen = profiled_launches(lambda: cache(*inputs[0], cfg))
    assert LAUNCHES == n0
    assert seen[("keypoint_compact",)] == 1 and seen[("quantize_rows",)] == 1
    assert seen[("lane_peaks",)] == (0 if cfg.use_fused_describe else 1)
    assert len(cache.graphs) == 1
