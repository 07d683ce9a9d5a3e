"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card and nvcc; elsewhere they skip. They import
no JAX, so on a machine without it they run as

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from siftmetal_tpu_torch.config import FAST_BF16_CONFIG, FAST_CONFIG, SiftConfig
from siftmetal_tpu_torch.ops import gaussian as PG
from siftmetal_tpu_torch.ops.kernels import LAUNCHES, group_launches
from siftmetal_tpu_torch.ops.kernels import pyramid as PP
from siftmetal_tpu_torch.ops.kernels.blur import (
    blur_cascade,
    blur_cascade_plain,
    blur_stack,
)
from siftmetal_tpu_torch.ops.kernels.cascade import (
    octave_cascade,
    octave_cascade_plain,
)
from siftmetal_tpu_torch.ops.kernels.detect import (
    BAND_ROW_CHOICES,
    BAND_ROWS,
    detect_candidates,
    detect_candidates_octaves,
    detect_candidates_plain,
)
from siftmetal_tpu_torch.ops.kernels.patches import (
    descriptor_lanes,
    orient_desc_lanes,
    orient_desc_lanes_plain,
    orientation_hist_lanes,
    prepare_patch_fields,
)
from siftmetal_tpu_torch.sift import describe as PDS
from torch_bits import assert_same_bits, profiled_launches

CFG = SiftConfig()
FAST = FAST_CONFIG


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (held on the H100 by chip_smoke.py)")
    return torch.device("cuda")


def _t(a, dev):
    return torch.tensor(np.array(a)).to(dev)


@pytest.mark.cuda
def test_pyramid_kernels_match_plain(cuda_dev):
    """Band kernels vs their plain versions (1e-5: the kernels contract
    each product into its sum, the plain versions round both)."""
    rng = np.random.default_rng(1)
    gray = _t(rng.uniform(0, 1, (2, 170, 250)).astype(np.float32), cuda_dev)
    n0 = LAUNCHES["seed_octave"]
    g, d = PP.seed_octave(gray, CFG)
    gr, dr = PP.seed_octave_plain(gray, CFG)
    assert LAUNCHES["seed_octave"] == n0 + 1
    assert (g - gr).abs().max().item() < 1e-5
    assert (d - dr).abs().max().item() < 1e-5
    first = g[:, 3].contiguous()
    g1, d1 = PP.octave_oneshot(first, CFG)
    g1r, d1r = PP.octave_oneshot_plain(first, CFG)
    assert (g1 - g1r).abs().max().item() < 1e-5
    assert (d1 - d1r).abs().max().item() < 1e-5
    small = first[:, :7, :10].contiguous()          # radius > size
    for sigma in (1.2489996, 4.6):
        b = blur_stack(small, sigma)
        assert (b - PG.blur(small, sigma)).abs().max().item() < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("value", [0.5, 1.0, 0.1])
def test_band_kernels_keep_a_flat_input_flat(cuda_dev, value):
    """Every output of a slice runs the same FMA chain on the same values,
    so a flat input gives one value a plane on every band kernel form: the
    seed at delta_min 0.5 (upsampled in the window) and 1, fp32 and bf16
    input; the one-shot octave; the blur and the cascade in both chains,
    on a plane smaller than its radii too."""
    def one_valued(t):
        f = t.flatten(-2)
        return bool((f == f[..., :1]).all())

    frames = torch.full((2, 200, 300), value, device=cuda_dev)
    for cfg in (CFG, SiftConfig(delta_min=1.0)):
        for x in (frames, frames.to(torch.bfloat16)):
            assert all(one_valued(t) for t in PP.seed_octave(x, cfg))
    first = frames[:, :180].contiguous()
    for x in (first, first.to(torch.bfloat16)):
        assert all(one_valued(t) for t in PP.octave_oneshot(x, CFG))
    for x in (first, first[:, :7, :10].contiguous()):
        for bf16 in (False, True):
            assert one_valued(blur_stack(x.to(torch.bfloat16) if bf16 else x, 4.6))
            assert all(one_valued(t) for t in blur_cascade(x, CFG.incremental_sigmas(3), bf16))


@pytest.mark.cuda
def test_detect_kernel_matches_plain(cuda_dev):
    """Built with -fmad=false, the detection kernel agrees exactly."""
    rng = np.random.default_rng(9)
    b, s, h, w = 2, 5, 200, 300
    base = rng.uniform(-1, 1, (b, s, h // 5 + 2, w // 5 + 2))
    dog = np.stack([[np.kron(base[i, j], np.ones((5, 5)))[:h, :w] for j in range(s)]
                    for i in range(b)]).astype(np.float32)
    dog += rng.normal(0, 0.05, dog.shape).astype(np.float32)
    dog = _t(dog, cuda_dev)
    got = detect_candidates(dog, 0.8 * 0.0133, 10.0)
    ref = detect_candidates_plain(dog, 0.8 * 0.0133, 10.0)
    for name in ("cand_col", "slot_ok", "cand_edge", "n_raw", "n_soft", "n_row_dropped"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    for g, r in zip(got.cand_fields, ref.cand_fields):
        assert torch.equal(g, r)


def _noise_octaves(seed, shapes, b, s, dev, sd=0.02):
    """Per-octave noise DoGs: at the 0.8 x 0.0133 threshold many rows hold
    more soft extrema than their slots."""
    rng = np.random.default_rng(seed)
    return [_t(rng.normal(0, sd, (b, s, h, w)).astype(np.float32), dev) for h, w in shapes]


def _assert_octaves_equal_plain(dogs, slots=6, emit_fields=True, band_rows=BAND_ROWS):
    """One launch over ``dogs`` against the plain version octave by
    octave: every output bit for bit, flags bool."""
    n0 = LAUNCHES["detect_candidates" if emit_fields else "detect_candidates_lean"]
    got = detect_candidates_octaves(dogs, 0.8 * 0.0133, 10.0, slots, emit_fields, band_rows)
    assert LAUNCHES["detect_candidates" if emit_fields else "detect_candidates_lean"] == n0 + 1
    dropped = 0
    for g, d in zip(got, dogs):
        ref = detect_candidates_plain(d, 0.8 * 0.0133, 10.0, slots, emit_fields)
        for name in ("cand_col", "slot_ok", "n_raw", "n_soft", "n_row_dropped"):
            assert torch.equal(getattr(g, name), getattr(ref, name)), name
        assert g.slot_ok.dtype == torch.bool
        if emit_fields:
            assert g.cand_edge.dtype == torch.bool and torch.equal(g.cand_edge, ref.cand_edge)
            for a, r in zip(g.cand_fields, ref.cand_fields):
                assert torch.equal(a, r)
        dropped += int(g.n_row_dropped.sum())
    return got, dropped


def _octave_shapes(cfg, h, w):
    return cfg.octave_shapes(h, w, cfg.num_octaves(h, w))


@pytest.mark.cuda
@pytest.mark.parametrize("emit_fields", [True, False])
@pytest.mark.parametrize("where", ["parity_640x480", "fast_640x480", "butterfly"])
def test_detect_octaves_match_plain(cuda_dev, where, emit_fields):
    """Every octave of a batch in one launch (B 2 at 640x480; B 1 at the
    butterfly's 340x512, down to a 10x16 octave) equals the plain version
    octave by octave, with full rows exercised."""
    shapes, b = {
        "parity_640x480": (_octave_shapes(CFG, 480, 640), 2),
        "fast_640x480": (_octave_shapes(FAST, 480, 640), 2),
        "butterfly": (_octave_shapes(CFG, 340, 512) + ((10, 16),), 1),
    }[where]
    dogs = _noise_octaves(12, shapes, b, 5, cuda_dev)
    _, dropped = _assert_octaves_equal_plain(dogs, emit_fields=emit_fields)
    assert dropped > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_dog,slots", [(4, 1), (4, 32), (6, 1), (6, 32), (3, 6), (8, 6)])
def test_detect_octaves_scales_and_slots(cuda_dev, n_dog, slots):
    """Other DoG plane counts and the slot range's ends; widths that are
    no multiple of a chunk (or of 4: 4-byte copies), octaves whose
    interior is shorter than a band."""
    shapes = ((70, 333), (35, 166), (17, 83), (8, 41), (5, 7))
    dogs = _noise_octaves(13, shapes, 2, n_dog, cuda_dev)
    for emit_fields in (True, False):
        _assert_octaves_equal_plain(dogs, slots=slots, emit_fields=emit_fields)


@pytest.mark.cuda
def test_detect_band_heights_agree(cuda_dev):
    """Every band height the kernel is built for gives the same outputs,
    and a dense field drops soft extrema at every one."""
    dogs = _noise_octaves(14, ((130, 300), (65, 150), (7, 10)), 2, 5, cuda_dev)
    for r in BAND_ROW_CHOICES:
        _, dropped = _assert_octaves_equal_plain(dogs, band_rows=r)
        assert dropped > 0


@pytest.mark.cuda
def test_detect_octaves_on_views_and_offsets(cuda_dev):
    """An octave that starts 4 bytes into its storage takes the 4-byte
    copies and still agrees; detect_candidates is the one-octave launch."""
    rng = np.random.default_rng(15)
    store = _t(rng.normal(0, 0.02, 2 * 5 * 40 * 64 + 1).astype(np.float32), cuda_dev)
    odd = store[1:].view(2, 5, 40, 64)
    _assert_octaves_equal_plain([odd])
    one = detect_candidates(odd, 0.8 * 0.0133, 10.0)
    many = detect_candidates_octaves([odd], 0.8 * 0.0133, 10.0)[0]
    assert torch.equal(one.cand_col, many.cand_col)


@pytest.mark.cuda
def test_detect_ignores_nan_neighbours_as_fmaxf_does(cuda_dev):
    """NaN samples: the test is max/min over the non-NaN neighbours, seeded
    with -inf / +inf (np.fmax / np.fmin, as CUDA's fmaxf / fminf), so a
    sample whose 26 neighbours are all NaN is a raw extremum; NaN centres
    never are."""
    rng = np.random.default_rng(16)
    dog = rng.normal(0, 0.02, (1, 5, 24, 40)).astype(np.float32)
    dog[0, :, 5:12, 6:14] = np.nan
    dog[0, 2, 8, 10] = 0.5                           # all 26 neighbours NaN
    dog[0, 1, 15, 20] = np.nan
    hi = np.full((3, 22, 38), -np.inf, np.float32)
    lo = np.full((3, 22, 38), np.inf, np.float32)
    for ds in (-1, 0, 1):
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                if ds == di == dj == 0:
                    continue
                n = dog[0, 1 + ds:4 + ds, 1 + di:23 + di, 1 + dj:39 + dj]
                hi, lo = np.fmax(hi, n), np.fmin(lo, n)
    c = dog[0, 1:4, 1:23, 1:39]
    raw = (c > hi) | (c < lo)
    soft = raw & (np.abs(c) > 0.8 * 0.0133)
    got = detect_candidates(_t(dog, cuda_dev), 0.8 * 0.0133, 10.0, slots=32)
    assert raw[1, 7, 9] and int(got.n_raw[0]) == int(raw.sum())
    assert int(got.n_soft[0]) == int(soft.sum())
    cols = [np.flatnonzero(soft[s, r])[:32] for s in range(3) for r in range(22)]
    ok = got.slot_ok[0].cpu().numpy().reshape(66, 32)
    cand = got.cand_col[0].cpu().numpy().reshape(66, 32)
    for k, want in enumerate(cols):
        assert ok[k].sum() == len(want) and (cand[k][: len(want)] == want).all()


@pytest.mark.cuda
def test_patch_kernels_match_plain(cuda_dev):
    rng = np.random.default_rng(3)
    b, h, w, n = 2, 96, 160, 64
    gauss = _t(rng.uniform(0, 1, (b, CFG.n_gaussians_per_octave, h, w)).astype(np.float32), cuda_dev)
    fields = prepare_patch_fields(gauss, CFG)
    scale = _t(rng.integers(1, 4, n).astype(np.int32), cuda_dev)
    x = _t(rng.uniform(-0.4, h - 0.6, n).astype(np.float32), cuda_dev)
    y = _t(rng.uniform(-0.4, w - 0.6, n).astype(np.float32), cuda_dev)
    sig = _t(rng.uniform(1.0, 3.6, n).astype(np.float32), cuda_dev)
    th = _t(rng.uniform(-3, 3, n).astype(np.float32), cuda_dev)
    valid = _t(np.arange(n) % 5 != 0, cuda_dev)
    frame = _t(rng.integers(0, b, n).astype(np.int32), cuda_dev)
    got = orientation_hist_lanes(fields, scale, x, y, sig, CFG, valid=valid, frame=frame)
    ref = PDS.orientation_hist_plain(fields.gi, fields.gj, frame.long(), scale.long(),
                                     x, y, sig, valid, CFG)
    assert ((got - ref).abs().amax(1) <= 1e-5 * ref.abs().amax(1) + 1e-7).all()
    assert (got[~valid] == 0).all()
    d = descriptor_lanes(fields, scale, x, y, sig, th, CFG, valid=valid, frame=frame)
    dr = PDS.descriptor_plain(fields.gi, fields.gj, frame.long(), scale.long(),
                              x, y, sig, th, valid, CFG)
    assert ((d - dr).abs().amax(1) <= 1e-4 * dr.abs().amax(1) + 1e-7).all()
    qd = PDS.quantize_descriptors(d, CFG).int()
    qr = PDS.quantize_descriptors(dr, CFG).int()
    assert (qd - qr).abs().max().item() <= 1
    # Deterministic: a second launch repeats bit for bit.
    assert torch.equal(d, descriptor_lanes(fields, scale, x, y, sig, th, CFG,
                                           valid=valid, frame=frame))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 96, 160, 64), (3, 200, 333, 700)])
def test_resident_patch_kernels_match_staged_and_plain(cuda_dev, shape):
    """``use_band_patches``: the resident-tile kernels equal the staged
    kernels bit for bit (same thread order and arithmetic, gi/gj read from
    a shared-memory copy) and the plain versions as the staged kernels do
    (1e-5 / 1e-4 relative to each lane's largest bin). Lanes cluster on a
    few centres so that tiles hold several lanes; some lie on the border,
    some are invalid with garbage coordinates."""
    band = SiftConfig(use_band_patches=True)
    b, h, w, n = shape
    rng = np.random.default_rng(13)
    gauss = _t(rng.uniform(0, 1, (b, CFG.n_gaussians_per_octave, h, w)).astype(np.float32), cuda_dev)
    fields = prepare_patch_fields(gauss, CFG)
    centres = rng.uniform([-0.4, -0.4], [h - 0.6, w - 0.6], (max(n // 8, 4), 2))
    pick = rng.integers(0, len(centres), n)
    xy = centres[pick] + rng.normal(0, 3.0, (n, 2))
    valid_np = np.arange(n) % 5 != 0
    xy[~valid_np] = 1e6
    x = _t(xy[:, 0].astype(np.float32), cuda_dev)
    y = _t(xy[:, 1].astype(np.float32), cuda_dev)
    scale = _t(rng.integers(1, 4, n).astype(np.int32), cuda_dev)
    sig = _t(rng.uniform(1.0, 3.6, n).astype(np.float32), cuda_dev)
    th = _t(np.where(valid_np, rng.uniform(-3, 3, n), np.nan).astype(np.float32), cuda_dev)
    valid = _t(valid_np, cuda_dev)
    frame = _t(rng.integers(0, b, n).astype(np.int32), cuda_dev)
    n_o, n_d = LAUNCHES["orientation_hist_banded"], LAUNCHES["descriptor_hist_banded"]
    s_o, s_d = LAUNCHES["orientation_hist"], LAUNCHES["descriptor_hist"]
    got = orientation_hist_lanes(fields, scale, x, y, sig, band, valid=valid, frame=frame)
    d = descriptor_lanes(fields, scale, x, y, sig, th, band, valid=valid, frame=frame)
    assert LAUNCHES["orientation_hist_banded"] == n_o + 1
    assert LAUNCHES["descriptor_hist_banded"] == n_d + 1
    assert LAUNCHES["orientation_hist"] == s_o and LAUNCHES["descriptor_hist"] == s_d
    staged = orientation_hist_lanes(fields, scale, x, y, sig, CFG, valid=valid, frame=frame)
    d_staged = descriptor_lanes(fields, scale, x, y, sig, th, CFG, valid=valid, frame=frame)
    assert torch.equal(got, staged) and torch.equal(d, d_staged)
    assert (got[~valid] == 0).all() and (d[~valid] == 0).all()
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(d).all())
    ref = PDS.orientation_hist_plain(fields.gi, fields.gj, frame.long(), scale.long(),
                                     x, y, sig, valid, CFG)
    assert ((got - ref).abs().amax(1) <= 1e-5 * ref.abs().amax(1) + 1e-7).all()
    dr = PDS.descriptor_plain(fields.gi, fields.gj, frame.long(), scale.long(),
                              x, y, sig, th, valid, CFG)
    assert ((d - dr).abs().amax(1) <= 1e-4 * dr.abs().amax(1) + 1e-7).all()
    from siftmetal_tpu_torch.ops.kernels.patches import DESC_TILE, tile_layout

    lay = tile_layout(fields.gi.shape, valid, frame, scale, x, y, DESC_TILE)
    runs = int(lay.first.sum())
    assert 0 < runs < int(valid.sum())          # some tile holds several lanes


def _border_lanes(rng, h, w, n, dev):
    """Lanes at all four borders and corners, in the interior, with sigmas
    whose reach is cut by ``desc_patch_radius``, and invalid lanes (with
    garbage coordinates) in between valid ones."""
    x = rng.uniform(-0.4, h - 0.6, n)
    y = rng.uniform(-0.4, w - 0.6, n)
    edge = np.arange(n) % 4
    x[edge == 0] = rng.uniform(-0.4, 1.5, (edge == 0).sum())          # top
    y[edge == 1] = rng.uniform(w - 2.5, w - 0.6, (edge == 1).sum())   # right
    x[edge == 2] = rng.uniform(h - 2.5, h - 0.6, (edge == 2).sum())   # bottom
    y[edge == 3] = rng.uniform(-0.4, 1.5, (edge == 3).sum())          # left
    x[:4], y[:4] = [0.0, 0.0, h - 1.0, h - 1.0], [0.0, w - 1.0, 0.0, w - 1.0]
    sig = rng.uniform(1.0, 3.6, n)
    sig[np.arange(n) % 3 == 0] = rng.uniform(3.7, 6.0, (np.arange(n) % 3 == 0).sum())
    valid = np.arange(n) % 7 != 3
    x[~valid], y[~valid] = np.nan, 1e9
    f32 = lambda a: _t(a.astype(np.float32), dev)
    return f32(x), f32(y), f32(sig), _t(valid, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 8), (3, 6), (2, 12)])
def test_descriptor_kernels_on_borders_large_sigma_and_shapes(cuda_dev, shape):
    """The warp-per-lane descriptor kernel, its (4, 8) instance and the
    generic one, against ``descriptor_plain`` (1e-4 relative to each lane's
    largest bin: the same positive terms summed in another order), on
    border lanes, lanes whose window the static radius cuts, and invalid
    lanes between valid ones; twice, bit for bit; and the resident form at
    several tiles equal to it bit for bit."""
    from siftmetal_tpu_torch.ops.kernels.patches import resident_descriptor_lanes

    cfg = SiftConfig(n_histograms_per_axis=shape[0], n_descriptor_bins=shape[1])
    rng = np.random.default_rng(21)
    b, h, w, n = 2, 120, 170, 160
    gauss = _t(rng.uniform(0, 1, (b, cfg.n_gaussians_per_octave, h, w)).astype(np.float32), cuda_dev)
    fields = prepare_patch_fields(gauss, cfg)
    x, y, sig, valid = _border_lanes(rng, h, w, n, cuda_dev)
    scale = _t(rng.integers(1, 4, n).astype(np.int32), cuda_dev)
    th = _t(rng.uniform(-3.2, 3.2, n).astype(np.float32), cuda_dev)
    frame = _t(rng.integers(0, b, n).astype(np.int32), cuda_dev)
    n0 = LAUNCHES["descriptor_hist"]
    d = descriptor_lanes(fields, scale, x, y, sig, th, cfg, valid=valid, frame=frame)
    assert LAUNCHES["descriptor_hist"] == n0 + 1
    assert d.shape == (n, cfg.descriptor_length)
    dr = PDS.descriptor_plain(fields.gi, fields.gj, frame.long(), scale.long(),
                              x, y, sig, th, valid, cfg)
    assert (d[~valid] == 0).all() and bool(torch.isfinite(d).all())
    assert ((d - dr).abs().amax(1) <= 1e-4 * dr.abs().amax(1) + 1e-7).all()
    assert bool((d[valid].abs().sum(1) > 0).all())
    assert torch.equal(d, descriptor_lanes(fields, scale, x, y, sig, th, cfg,
                                           valid=valid, frame=frame))
    for tile in (8, 16, 32):
        band = resident_descriptor_lanes(fields, scale, x, y, sig, th, cfg, valid, frame,
                                         tile=tile)
        assert torch.equal(band, d), tile


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [16, 24, 32])
def test_tile_runs_kernel_matches_tile_layout_as_sets(cuda_dev, tile):
    """The CUDA counting sort gives ``tile_layout``'s runs: the same run
    starts and ends, the same lanes in each run (in any order), invalid
    lanes after every run, and one head per run."""
    from siftmetal_tpu_torch.ops.kernels.patches import tile_layout, tile_runs

    rng = np.random.default_rng(tile)
    shape = (3, 3, 150, 230)
    b, s, h, w = shape
    n = 900
    c = rng.uniform([0, 0], [h, w], (40, 2))
    xy = c[rng.integers(0, 40, n)] + rng.normal(0, 4.0, (n, 2))
    valid = rng.random(n) < 0.8
    xy[~valid] = np.nan
    args = (_t(valid, cuda_dev), _t(rng.integers(0, b, n).astype(np.int32), cuda_dev),
            _t(rng.integers(1, s + 1, n).astype(np.int32), cuda_dev),
            _t(xy[:, 0].astype(np.float32), cuda_dev), _t(xy[:, 1].astype(np.float32), cuda_dev))
    ref = tile_layout(shape, *args, tile)
    got = tile_runs(shape, *args, tile)
    assert torch.equal(got.first.cpu(), ref.first.cpu())
    assert torch.equal(got.run_end.long().cpu(), ref.run_end.cpu())
    src, rsrc = got.src.long().cpu().numpy(), ref.src.cpu().numpy()
    ends = got.run_end.long().cpu().numpy()
    starts = np.nonzero(ref.first.cpu().numpy())[0]
    for p in starts:
        assert sorted(src[p:ends[p]]) == sorted(rsrc[p:ends[p]])
    nv = int(valid.sum())
    assert sorted(src[nv:]) == sorted(rsrc[nv:])
    n_runs = int(got.runs[0])
    assert n_runs == len(starts) and int(got.runs[1]) == 0
    assert sorted(got.heads[:n_runs].cpu().tolist()) == starts.tolist()


@pytest.mark.cuda
def test_bf16_band_kernels_match_plain(cuda_dev):
    """bf16-input band passes vs their plain versions. The cascade blur's
    bf16 scratch is bit-identical by construction (separate roundings on
    both sides), so its fp32 result differs only by the Y pass's FMA
    contraction (1e-5, as the fp32 forms); seed and one-shot never round
    between the passes (1e-5)."""
    fast = SiftConfig(delta_min=1.0, pyramid_dtype="bfloat16")
    rng = np.random.default_rng(4)
    gray = _t(rng.uniform(0, 1, (2, 200, 300)).astype(np.float32), cuda_dev).to(torch.bfloat16)
    assert PP.seed_supports(fast, 200, 300)
    n0 = LAUNCHES["seed_octave_bf16"]
    g, d = PP.seed_octave(gray, fast)
    gr, dr = PP.seed_octave_plain(gray, fast)
    assert LAUNCHES["seed_octave_bf16"] == n0 + 1
    assert g.dtype == torch.float32 and d.dtype == torch.float32
    assert (g - gr).abs().max().item() < 1e-5
    assert (d - dr).abs().max().item() < 1e-5
    first = g[:, 3].to(torch.bfloat16).contiguous()
    g1, d1 = PP.octave_oneshot(first, fast)
    g1r, d1r = PP.octave_oneshot_plain(first, fast)
    assert torch.equal(g1[:, 0], first.float())
    assert (g1 - g1r).abs().max().item() < 1e-5
    assert (d1 - d1r).abs().max().item() < 1e-5
    for img in (first, first[:, :7, :10].contiguous()):
        for sigma in (0.6131, 1.5453):
            tab = PP.slice_taps((float(sigma),))
            xs_plain = PP.band_x_plain(img, tab, torch.bfloat16)
            out = blur_stack(img, sigma)
            ref = PP.band_y_plain(xs_plain, tab, None, False)[0][:, 0]
            assert out.dtype == torch.float32
            assert (out - ref).abs().max().item() < 1e-5
    assert torch.equal(blur_stack(first, 0.6131), blur_stack(first, 0.6131))


# The small-octave cascades of the 640x480 batch (octave 3) and of the
# butterfly's parity octaves 2-5, and a plane smaller than its radii.
CASCADE_SHAPES = [(8, 120, 160), (1, 170, 256), (1, 85, 128), (1, 42, 64), (1, 21, 32),
                  (2, 7, 10)]


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", CASCADE_SHAPES)
def test_blur_cascade_equals_per_step_route(cuda_dev, shape, bf16):
    """One cooperative launch gives the per-step route's slices and DoGs
    (five blur_stack launches, a stack, a subtraction) bit for bit, and its
    plain version to 1e-5 (the kernels' FMA contraction). In the bf16 chain
    that last-bit difference now and then flips the bf16 rounding of a
    stage's input, which the later stages carry: there, as the fast
    preset's tests hold it, 1e-5 on all but 2% of the samples and no
    sample off by more than one bf16 ulp (2^-8) of the largest value."""
    from siftmetal_tpu_torch.sift.pyramid import cascade_slices

    cfg = SiftConfig(pyramid_dtype="bfloat16") if bf16 else CFG
    rng = np.random.default_rng(13)
    first = _t(rng.uniform(0, 1, shape).astype(np.float32), cuda_dev)
    firsts = [first.to(torch.bfloat16), first] if bf16 else [first]
    for f in firsts:
        name = "blur_cascade_bf16" if bf16 else "blur_cascade"
        n0, s0 = LAUNCHES[name], LAUNCHES["blur_stack"] + LAUNCHES["blur_stack_bf16"]
        g, d = blur_cascade(f, cfg.incremental_sigmas(3), bf16)
        assert LAUNCHES[name] == n0 + 1
        assert LAUNCHES["blur_stack"] + LAUNCHES["blur_stack_bf16"] == s0
        ref = torch.stack(cascade_slices(f, 3, cfg), dim=1)
        assert torch.equal(g, ref)
        assert torch.equal(d, ref[:, 1:] - ref[:, :-1])
        gp, dp = blur_cascade_plain(f, cfg.incremental_sigmas(3), bf16)
        for got, want in ((g, gp), (d, dp)):
            err = (got - want).abs()
            if bf16:
                assert err.max().item() <= 2.0 ** -8 * max(want.abs().max().item(), 1.0)
                assert (err > 1e-5).float().mean().item() <= 0.02
            else:
                assert err.max().item() < 1e-5
        g2, d2 = blur_cascade(f, cfg.incremental_sigmas(3), bf16)
        assert torch.equal(g, g2) and torch.equal(d, d2)


@pytest.mark.cuda
def test_kernels_launch_on_the_tensors_device(cuda_dev):
    """Tensors on the second card, with the first current: every kind of
    launcher (tiled bands, cooperative cascade, detection, a staged and a
    resident patch kernel) runs there and gives the first card's values."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    rng = np.random.default_rng(5)
    gray = rng.uniform(0, 1, (1, 200, 300)).astype(np.float32)
    band = SiftConfig(use_band_patches=True)
    outs = []
    for dev in (torch.device("cuda", 0), torch.device("cuda", 1)):
        torch.cuda.set_device(0)
        x = _t(gray, dev)
        g, d = PP.seed_octave(x, CFG)
        gc, dc = blur_cascade(g[:, 3].contiguous(), CFG.incremental_sigmas(3), False)
        cand = detect_candidates(d, 0.8 * CFG.dog_threshold, CFG.edge_threshold)
        fields = prepare_patch_fields(g, CFG)
        lane = (torch.full((4,), 2, dtype=torch.int32, device=dev),
                torch.tensor([50.0, 120.0, 200.0, 300.0], device=dev),
                torch.tensor([60.0, 200.0, 400.0, 500.0], device=dev),
                torch.full((4,), 2.0, device=dev))
        hs = orientation_hist_lanes(fields, *lane, CFG)
        hb = orientation_hist_lanes(fields, *lane, band)
        torch.cuda.synchronize(dev)
        outs.append([t.cpu() for t in (g, d, gc, dc, cand.cand_col, hs, hb)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 256, 320), (1, 70, 45), (3, 100, 200)])
def test_cascade_kernel_matches_plain(cuda_dev, shape):
    """Fused cascade vs the sequential band-table cascade (1e-5: the
    extension is made once instead of once per stage, and FMAs)."""
    rng = np.random.default_rng(6)
    first = _t(rng.uniform(0, 1, shape).astype(np.float32), cuda_dev)
    n0 = LAUNCHES["octave_cascade"]
    g, d = octave_cascade(first, CFG)
    assert LAUNCHES["octave_cascade"] == n0 + 1
    gr, dr = octave_cascade_plain(first, CFG)
    assert g.shape == gr.shape and d.shape == dr.shape
    assert torch.equal(g[:, 0], first)
    assert (g - gr).abs().max().item() < 1e-5
    assert (d - dr).abs().max().item() < 1e-5


@pytest.mark.cuda
def test_lean_detect_kernel_matches_full(cuda_dev):
    """The lean kernel's outputs equal the full kernel's exactly."""
    rng = np.random.default_rng(9)
    dog = _t(rng.normal(0, 0.02, (2, 5, 120, 333)).astype(np.float32), cuda_dev)
    n0 = LAUNCHES["detect_candidates_lean"]
    full = detect_candidates(dog, 0.8 * 0.0133, 10.0)
    lean = detect_candidates(dog, 0.8 * 0.0133, 10.0, emit_fields=False)
    plain = detect_candidates_plain(dog, 0.8 * 0.0133, 10.0, emit_fields=False)
    assert LAUNCHES["detect_candidates_lean"] == n0 + 1
    assert lean.cand_fields is None and lean.cand_edge is None
    assert int(full.n_row_dropped.sum()) > 0          # full rows are exercised
    for name in ("cand_col", "slot_ok", "n_raw", "n_soft", "n_row_dropped"):
        assert torch.equal(getattr(lean, name), getattr(full, name)), name
        assert torch.equal(getattr(lean, name), getattr(plain, name)), name


@pytest.mark.cuda
def test_fused_describe_kernel_matches_plain(cuda_dev):
    """Fused orientation+descriptor kernel vs its plain version: peaks'
    validity equal except where a bin sits within 1e-6 relative of the
    threshold or of a neighbour; theta to 1e-5; descriptors 1e-4 relative
    to each lane's largest bin, quantized within 1."""
    rng = np.random.default_rng(3)
    b, h, w, n = 2, 96, 160, 96
    gauss = _t(rng.uniform(0, 1, (b, CFG.n_gaussians_per_octave, h, w)).astype(np.float32), cuda_dev)
    fields = prepare_patch_fields(gauss, CFG)
    scale = _t(rng.integers(1, 4, n).astype(np.int32), cuda_dev)
    x = _t(rng.uniform(-0.4, h - 0.6, n).astype(np.float32), cuda_dev)
    y = _t(rng.uniform(-0.4, w - 0.6, n).astype(np.float32), cuda_dev)
    sig = _t(rng.uniform(1.0, 3.6, n).astype(np.float32), cuda_dev)
    valid = _t(np.arange(n) % 5 != 0, cuda_dev)
    frame = _t(rng.integers(0, b, n).astype(np.int32), cuda_dev)
    n0 = LAUNCHES["orient_desc"]
    raw, th, ov = orient_desc_lanes(fields, scale, x, y, sig, CFG, valid=valid, frame=frame)
    assert LAUNCHES["orient_desc"] == n0 + 1
    rr, tr, ovr = orient_desc_lanes_plain(fields, scale, x, y, sig, CFG, valid, frame)
    assert raw.shape == rr.shape == (n, 4, 128)
    same = (ov == ovr).all(1)
    assert same.float().mean().item() >= 0.95     # near-threshold lanes are rare
    assert (raw[~valid] == 0).all() and not ov[~valid].any()
    assert (raw[~ov] == 0).all() and (th[~ov] == 0).all()
    # theta to 1e-5, scaled where the parabolic offset is ill-conditioned
    # (max / |curvature| above 50: white-noise fields have flat histograms).
    hist = PDS._smooth_circular(
        PDS.orientation_hist_plain(fields.gi, fields.gj, frame.long(), scale.long(), x, y, sig,
                                   valid, CFG), CFG.orientation_smoothing_iterations)
    tol = 1e-5 * torch.clamp(0.02 * PDS.peak_conditioning(hist, CFG), min=1.0)
    assert ((th - tr).abs()[same] <= tol[same]).all()
    a, r = raw[same].reshape(-1, 128), rr[same].reshape(-1, 128)
    assert ((a - r).abs().amax(1) <= 1e-4 * r.abs().amax(1) + 1e-7).all()
    qd = PDS.quantize_descriptors(a, CFG).int() - PDS.quantize_descriptors(r, CFG).int()
    assert qd.abs().max().item() <= 1
    r2, t2, o2 = orient_desc_lanes(fields, scale, x, y, sig, CFG, valid=valid, frame=frame)
    assert torch.equal(raw, r2) and torch.equal(th, t2) and torch.equal(ov, o2)


def _fused_inputs(rng, cfg, dev, b=2, h=120, w=170, n=160):
    gauss = _t(rng.uniform(0, 1, (b, cfg.n_gaussians_per_octave, h, w)).astype(np.float32), dev)
    fields = prepare_patch_fields(gauss, cfg)
    x, y, sig, valid = _border_lanes(rng, h, w, n, dev)
    scale = _t(rng.integers(1, 4, n).astype(np.int32), dev)
    frame = _t(rng.integers(0, b, n).astype(np.int32), dev)
    return fields, (scale, x, y, sig), valid, frame


def _staged_at_fused_theta(fields, lanes, cfg, valid, frame, th, ov):
    """The staged descriptor kernel on the keypoint lanes repeated max_ori
    times, at the fused kernel's theta and peak validity."""
    rep = lambda a: a.repeat_interleave(th.shape[1])
    scale, x, y, sig = lanes
    d = descriptor_lanes(fields, rep(scale), rep(x), rep(y), rep(sig), th.reshape(-1), cfg,
                         valid=ov.reshape(-1), frame=rep(frame))
    return d.reshape(th.shape + (-1,))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 8), (3, 6), (2, 12)])
def test_fused_describe_equals_staged_at_its_theta(cuda_dev, shape):
    """The fused kernel's descriptors equal the staged descriptor kernel's
    at the fused theta bit for bit (the same warp routine), on border
    lanes, lanes whose reach ``desc_patch_radius`` cuts and invalid lanes
    between valid ones, for the (4, 8) instance and the generic one; its
    theta and peaks agree with the plain version (the gates of
    test_fused_describe_kernel_matches_plain); two launches are equal."""
    cfg = SiftConfig(n_histograms_per_axis=shape[0], n_descriptor_bins=shape[1])
    rng = np.random.default_rng(31)
    fields, lanes, valid, frame = _fused_inputs(rng, cfg, cuda_dev)
    raw, th, ov = orient_desc_lanes(fields, *lanes, cfg, valid=valid, frame=frame)
    assert raw.shape == (valid.shape[0], 4, cfg.descriptor_length)
    assert torch.equal(raw, _staged_at_fused_theta(fields, lanes, cfg, valid, frame, th, ov))
    assert not ov[~valid].any() and (raw[~ov] == 0).all() and (th[~ov] == 0).all()
    assert ov[valid].any(1).float().mean().item() > 0.99   # valid lanes have peaks
    rr, tr, ovr = orient_desc_lanes_plain(fields, *lanes, cfg, valid, frame)
    scale, x, y, sig = lanes
    hist = PDS._smooth_circular(
        PDS.orientation_hist_plain(fields.gi, fields.gj, frame.long(), scale.long(), x, y, sig,
                                   valid, cfg), cfg.orientation_smoothing_iterations)
    same = (ov == ovr).all(1)
    assert same.float().mean().item() >= 0.95
    tol = 1e-5 * torch.clamp(0.02 * PDS.peak_conditioning(hist, cfg), min=1.0)
    assert ((th - tr).abs()[same] <= tol[same]).all()
    a, r = raw[same].reshape(-1, raw.shape[-1]), rr[same].reshape(-1, raw.shape[-1])
    assert ((a - r).abs().amax(1) <= 1e-4 * r.abs().amax(1) + 1e-7).all()
    r2, t2, o2 = orient_desc_lanes(fields, *lanes, cfg, valid=valid, frame=frame)
    assert torch.equal(raw, r2) and torch.equal(th, t2) and torch.equal(ov, o2)


@pytest.mark.cuda
def test_fused_describe_keeps_the_first_peaks_in_bin_order(cuda_dev):
    """With more peaks than ``max_orientations_per_keypoint``, the fused
    kernel keeps the first ones in bin order: at max_ori 2 its outputs
    are the first two columns of its max_ori 8 outputs, bit for bit, and
    the peak sets agree with the plain bin-order rule."""
    few = SiftConfig(orientation_peak_threshold=0.4, orientation_smoothing_iterations=2,
                     max_orientations_per_keypoint=2)
    many = SiftConfig(orientation_peak_threshold=0.4, orientation_smoothing_iterations=2,
                      max_orientations_per_keypoint=8)
    rng = np.random.default_rng(5)
    fields, lanes, valid, frame = _fused_inputs(rng, few, cuda_dev)
    raw2, th2, ov2 = orient_desc_lanes(fields, *lanes, few, valid=valid, frame=frame)
    raw8, th8, ov8 = orient_desc_lanes(fields, *lanes, many, valid=valid, frame=frame)
    assert int((ov8.sum(1) > 2).sum()) >= 10          # lanes with more peaks than kept
    assert torch.equal(th2, th8[:, :2]) and torch.equal(ov2, ov8[:, :2])
    assert torch.equal(raw2, raw8[:, :2])
    assert torch.equal(ov2.sum(1), ov8.sum(1).clamp(max=2))
    # Bin order: ascending bins, so theta ascends once wrapped to [0, 2 pi).
    wrapped = torch.remainder(th8, 2 * np.pi)
    for l in torch.nonzero(ov8.sum(1) > 2).flatten().tolist():
        k = int(ov8[l].sum())
        assert bool((wrapped[l, 1:k] > wrapped[l, :k - 1]).all()), l
    _, tp, ovp = orient_desc_lanes_plain(fields, *lanes, few, valid, frame)
    assert (ov2 == ovp).all(1).float().mean().item() >= 0.95


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [8, 16, 32])
def test_resident_orientation_through_tile_runs_equals_staged(cuda_dev, tile):
    """The resident orientation kernel over the CUDA counting-sort layout,
    at several tile sides, equals the staged kernel bit for bit on border
    lanes, lanes whose reach the radius cuts, clustered lanes that share
    tiles and invalid lanes between valid ones."""
    from siftmetal_tpu_torch.ops.kernels.patches import resident_orientation_lanes

    rng = np.random.default_rng(40 + tile)
    fields, (scale, x, y, sig), valid, frame = _fused_inputs(rng, CFG, cuda_dev, n=400)
    near = torch.arange(400, device=cuda_dev) % 2 == 1     # half the lanes in 6 clusters
    c = _t(rng.uniform([5, 5], [115, 165], (6, 2)).astype(np.float32), cuda_dev)
    pick = _t(rng.integers(0, 6, 400), cuda_dev)
    x = torch.where(near & valid, c[pick, 0] + _t(rng.normal(0, 2, 400).astype(np.float32), cuda_dev), x)
    y = torch.where(near & valid, c[pick, 1] + _t(rng.normal(0, 2, 400).astype(np.float32), cuda_dev), y)
    n0 = LAUNCHES["orientation_hist_banded"]
    got = resident_orientation_lanes(fields, scale, x, y, sig, CFG, valid, frame, tile=tile)
    assert LAUNCHES["orientation_hist_banded"] == n0 + 1
    staged = orientation_hist_lanes(fields, scale, x, y, sig, CFG, valid=valid, frame=frame)
    assert torch.equal(got, staged)
    assert (got[~valid] == 0).all() and bool((got[valid].sum(1) > 0).all())


@pytest.mark.cuda
def test_resident_route_lays_out_lanes_on_the_card(cuda_dev, monkeypatch):
    """Under ``use_band_patches`` on CUDA fields both resident kernels take
    their layout from the CUDA counting sort: ``tile_layout`` (the
    PyTorch sort of the CPU route) is never called."""
    from siftmetal_tpu_torch.ops.kernels import patches as KP

    def refuse(*a, **kw):
        raise AssertionError("tile_layout called on CUDA fields")

    monkeypatch.setattr(KP, "tile_layout", refuse)
    band = SiftConfig(use_band_patches=True)
    rng = np.random.default_rng(8)
    fields, (scale, x, y, sig), valid, frame = _fused_inputs(rng, band, cuda_dev)
    th = _t(rng.uniform(-3, 3, valid.shape[0]).astype(np.float32), cuda_dev)
    n_o, n_d = LAUNCHES["orientation_hist_banded"], LAUNCHES["descriptor_hist_banded"]
    orientation_hist_lanes(fields, scale, x, y, sig, band, valid=valid, frame=frame)
    descriptor_lanes(fields, scale, x, y, sig, th, band, valid=valid, frame=frame)
    assert LAUNCHES["orientation_hist_banded"] == n_o + 1
    assert LAUNCHES["descriptor_hist_banded"] == n_d + 1


@pytest.mark.cuda
def test_wrappers_do_not_fall_back(cuda_dev, monkeypatch):
    """A wrapper given a CUDA tensor raises when its library cannot load;
    it never runs the plain version instead."""
    from siftmetal_tpu_torch.ops import cuda as C

    def broken(name):
        raise RuntimeError(f"library {name} unavailable")

    monkeypatch.setattr(C, "library", broken)
    x = torch.zeros((1, 64, 64), device=cuda_dev)
    with pytest.raises(RuntimeError, match="unavailable"):
        octave_cascade(x, CFG)
    with pytest.raises(RuntimeError, match="unavailable"):
        blur_stack(x.to(torch.bfloat16), 1.0)
    with pytest.raises(RuntimeError, match="unavailable"):
        blur_cascade(x, CFG.incremental_sigmas(3), False)
    with pytest.raises(RuntimeError, match="unavailable"):
        detect_candidates(torch.zeros((1, 5, 16, 16), device=cuda_dev), 0.01, 10.0,
                          emit_fields=False)
    with pytest.raises(RuntimeError, match="unavailable"):
        detect_candidates_octaves([torch.zeros((1, 5, 16, 16), device=cuda_dev),
                                   torch.zeros((1, 5, 8, 8), device=cuda_dev)], 0.01, 10.0)
    fields = prepare_patch_fields(torch.zeros((1, 6, 32, 32), device=cuda_dev), CFG)
    one = lambda v, dt: torch.full((1,), v, dtype=dt, device=cuda_dev)
    lane = (one(1, torch.int32), one(16.0, torch.float32), one(16.0, torch.float32),
            one(1.5, torch.float32))
    with pytest.raises(RuntimeError, match="unavailable"):
        orient_desc_lanes(fields, *lane, CFG)
    with pytest.raises(RuntimeError, match="unavailable"):
        orientation_hist_lanes(fields, *lane, SiftConfig(use_band_patches=True))


def _homography_scene(dev, n=512, n_out=200, pad=64):
    rng = np.random.default_rng(1)
    h_true = np.array([[0.9, 0.1, 10.0], [-0.05, 1.05, 20.0], [0, 0, 1.0]], np.float32)
    src = rng.uniform(0, 400, (n, 2)).astype(np.float32)
    p = np.c_[src, np.ones(n)] @ h_true.T
    dst = (p[:, :2] / p[:, 2:]).astype(np.float32)
    dst[:n_out] = rng.uniform(0, 400, (n_out, 2))
    valid = np.ones(n, bool)
    valid[-pad:] = False
    return h_true, _t(src, dev), _t(dst, dev), _t(valid, dev)


@pytest.mark.cuda
def test_ransac_and_pnp_ransac_synchronise_only_in_svd(cuda_dev, monkeypatch):
    """``find_homography``, ``find_fundamental`` and ``pnp_ransac`` queue
    their work without reading a value on the host, the library's SVDs
    aside (``torch.linalg.svd`` checks its convergence flag on the host and
    has no unchecked form): with ``torch.cuda.set_sync_debug_mode("error")``
    everywhere but inside ``torch.linalg.svd`` a synchronising call would
    raise."""
    from siftmetal_tpu_torch.geometry import find_fundamental, find_homography
    from siftmetal_tpu_torch.slam.camera import project
    from siftmetal_tpu_torch.slam.pnp import pnp_ransac

    h_true, src, dst, valid = _homography_scene(cuda_dev)
    rng = np.random.default_rng(11)
    k = _t(np.array([[450, 0, 320], [0, 450, 240], [0, 0, 1]], np.float32), cuda_dev)
    pts = _t(rng.uniform([-2, -2, 5], [2, 2, 10], (128, 3)).astype(np.float32), cuda_dev)
    cam = _t(np.array([0.1, -0.05, 0.2, 0.3, -0.1, 0.4], np.float32), cuda_dev)
    uv = project(cam, k, pts)
    uv[:30] += 80.0
    ones = torch.ones(128, dtype=torch.bool, device=cuda_dev)
    gen = torch.Generator(device=cuda_dev)

    def run():
        gen.manual_seed(0)
        return (find_homography(gen, src, dst, valid),
                find_fundamental(gen, src, dst, valid, n_hypotheses=64),
                pnp_ransac(gen, pts, uv, ones, k))

    run()                    # the libraries set up handles and workspaces
    torch.cuda.synchronize()
    real_svd = torch.linalg.svd
    n_svd = [0]

    def svd_outside_the_check(*args, **kwargs):
        n_svd[0] += 1
        torch.cuda.set_sync_debug_mode("default")
        try:
            return real_svd(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(torch.linalg, "svd", svd_outside_the_check)
    torch.cuda.set_sync_debug_mode("error")
    try:
        res_h, _, res_p = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert n_svd[0] == 2 + 4 + 2        # hypotheses and refit; F: two each; PnP: two in the DLT
    inl = res_h.inliers.cpu().numpy()
    assert inl[200:448].mean() > 0.98 and inl[:200].mean() < 0.05 and not inl[448:].any()
    assert np.abs(res_h.model.cpu().numpy() - h_true).max() < 0.05
    assert (res_p.model - cam).abs().max().item() < 5e-3


@pytest.mark.cuda
def test_warp_and_ransac_cpu_vs_cuda(cuda_dev):
    """``warp_perspective`` on the card against the CPU (1e-5: the same
    fp32 arithmetic, fused differently); RANSAC on shared indices gives
    the same inlier mask on both devices."""
    from siftmetal_tpu_torch.geometry import ransac_from_indices
    from siftmetal_tpu_torch.geometry.twoview import (
        homography_from_points,
        homography_transfer_error,
    )
    from siftmetal_tpu_torch.ops.warp import similarity_homography, warp_perspective
    from siftmetal_tpu_torch.utils.repeatability import standard_warp_battery

    rng = np.random.default_rng(2)
    img = torch.from_numpy(rng.uniform(0, 1, (2, 120, 160)).astype(np.float32))
    warps = standard_warp_battery((120, 160)) + [
        ("sim", similarity_homography(np.deg2rad(20.0), 0.95, (60.0, 80.0)))]
    for name, h in warps:
        a = warp_perspective(img, h, (120, 160))
        b = warp_perspective(img.to(cuda_dev), h, (120, 160))
        assert b.device.type == "cuda" and (a - b.cpu()).abs().max().item() < 1e-5, name
    _, src, dst, valid = _homography_scene(cuda_dev)
    idx = torch.from_numpy(rng.choice(448, (256, 4)).astype(np.int64))
    args = (homography_from_points, homography_transfer_error, 4, 3.0)
    on_card = ransac_from_indices(idx.to(cuda_dev), src, dst, valid, *args)
    on_cpu = ransac_from_indices(idx, src.cpu(), dst.cpu(), valid.cpu(), *args)
    assert torch.equal(on_card.inliers.cpu(), on_cpu.inliers)
    assert torch.allclose(on_card.model.cpu(), on_cpu.model, rtol=1e-3, atol=1e-3)


# --- the streamed cascade and the one-launch orientation ---------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 960, 1280), (8, 480, 640), (2, 37, 45), (1, 61, 23),
                                   (3, 257, 301)])
def test_streamed_cascade_matches_plain(cuda_dev, shape):
    """The streamed cascade vs its plain version (1e-5) at both octave
    sizes of the 640x480 batch and three odd shapes, and the same bits at
    every strip and band of the sweep (each block computes every value
    from the extended plane, whatever its strip)."""
    from siftmetal_tpu_torch.ops.kernels import cascade as KC

    rng = np.random.default_rng(61)
    first = _t(rng.uniform(0, 1, shape).astype(np.float32), cuda_dev)
    g, d = octave_cascade(first, CFG)
    gr, dr = octave_cascade_plain(first, CFG)
    assert torch.equal(g[:, 0], first)
    assert (g - gr).abs().max().item() < 1e-5
    assert (d - dr).abs().max().item() < 1e-5
    del gr, dr
    for strip in KC.STRIP_CHOICES:
        for band in KC.BAND_CHOICES[:2]:
            g2, d2 = octave_cascade(first, CFG, strip, band)
            assert torch.equal(g2, g) and torch.equal(d2, d), (strip, band)


@pytest.mark.cuda
def test_streamed_cascade_generic_radii(cuda_dev):
    """A schedule other than the default radii takes the generic
    instance: 4 and 2 scales an octave, and delta_min 1."""
    rng = np.random.default_rng(62)
    first = _t(rng.uniform(0, 1, (2, 91, 133)).astype(np.float32), cuda_dev)
    for cfg in (SiftConfig(n_scales_per_octave=4), SiftConfig(n_scales_per_octave=2),
                SiftConfig(delta_min=1.0)):
        g, d = octave_cascade(first, cfg)
        gr, dr = octave_cascade_plain(first, cfg)
        assert (g - gr).abs().max().item() < 1e-5 and (d - dr).abs().max().item() < 1e-5


def _octave_keypoints(dev, cfg, b=2, h=120, w=160):
    """Per-octave compacted keypoints and fields of a noise batch, as
    extract_gray_batch's Phase A makes them."""
    from siftmetal_tpu_torch.sift import detect as PDT
    from siftmetal_tpu_torch.sift.batched import build_pyramid_batch

    rng = np.random.default_rng(63)
    gray = _t(rng.uniform(0, 1, (b, h, w)).astype(np.float32), dev)
    gauss, dogs = build_pyramid_batch(gray, cfg, cfg.num_octaves(h, w))
    per_octave, _ = PDT.detect_all_octaves_batch(dogs, cfg)
    kpcs, fields = [], []
    for o, d in enumerate(dogs):
        budget = PDT.keypoint_budget(cfg, tuple(d.shape[-2:]), o)
        kpcs.append(PDT.compact_octave_keypoints(per_octave[o], o, cfg, budget)[0])
        fields.append(prepare_patch_fields(gauss[o], cfg))
    return kpcs, fields


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [CFG, FAST], ids=["parity", "fast"])
def test_orientation_octaves_equal_per_octave_and_resident(cuda_dev, cfg):
    """The one-launch orientation form equals the per-octave launches and
    the resident form (row 9a) bit for bit, and the plain version at 1e-4
    of each lane's largest bin."""
    from siftmetal_tpu_torch.ops.kernels.patches import orientation_hist_octaves

    kpcs, fields = _octave_keypoints(cuda_dev, cfg)
    n0 = LAUNCHES["orientation_hist"]
    got = orientation_hist_octaves(fields, kpcs, cfg)
    assert LAUNCHES["orientation_hist"] == n0 + 1
    b = got.shape[0]
    per, res, plain = [], [], []
    band = dataclasses.replace(cfg, use_band_patches=True)
    for f, k in zip(fields, kpcs):
        n = k.valid.shape[1]
        flat = lambda a: a.reshape(-1)
        frame = torch.arange(b, dtype=torch.int32, device=cuda_dev).repeat_interleave(n)
        lane = (flat(k.scale), flat(k.x_oct), flat(k.y_oct), flat(k.sigma_oct))
        per.append(orientation_hist_lanes(f, *lane, cfg, valid=flat(k.valid), frame=frame)
                   .reshape(b, n, -1))
        res.append(orientation_hist_lanes(f, *lane, band, valid=flat(k.valid), frame=frame)
                   .reshape(b, n, -1))
        plain.append(PDS.orientation_hist_plain(f.gi, f.gj, frame.long(), lane[0].long(),
                                                *lane[1:], flat(k.valid), cfg).reshape(b, n, -1))
    per, res, plain = (torch.cat(v, 1) for v in (per, res, plain))
    assert torch.equal(got, per) and torch.equal(got, res)
    rel = (got - plain).abs().amax(-1) / plain.abs().amax(-1).clamp(min=1e-12)
    assert rel.max().item() < 1e-4
    valid = torch.cat([k.valid for k in kpcs], 1)
    assert bool((got[~valid] == 0).all()) and bool((got[valid].sum(-1) > 0).all())


@pytest.mark.cuda
def test_orientation_wraps_equal_the_old_expressions(cuda_dev):
    """wrap_angle / wrap_bin against mod_2pi and the double modulo on
    gradients whose atan2 is +-0, +-pi, +-pi/2, near -0 and near 2 pi,
    and NaN: the same angle bits and the same bins."""
    from siftmetal_tpu_torch.ops import cuda as C

    z, one, tiny, nan = 0.0, 1.0, 1e-30, float("nan")
    pairs = [(z, z), (-z, z), (z, -z), (-z, -z), (-one, z), (-one, -z), (one, z), (one, -z),
             (z, one), (z, -one), (-one, tiny), (-one, -tiny), (one, -tiny), (one, tiny),
             (nan, one), (one, nan), (nan, nan), (-1e30, -1e-30), (3.0, -4.0), (-3.0, 4.0)]
    rng = np.random.default_rng(64)
    rnd = rng.normal(0, 1, (4096, 2)).astype(np.float32)
    gi = _t(np.r_[np.float32([p[0] for p in pairs]), rnd[:, 0]], cuda_dev)
    gj = _t(np.r_[np.float32([p[1] for p in pairs]), rnd[:, 1]], cuda_dev)
    n = gi.shape[0]
    for n_bins in (36, 8, 7):
        th = torch.empty((n, 2), dtype=torch.float32, device=cuda_dev)
        bins = torch.empty((n, 2), dtype=torch.int32, device=cuda_dev)
        with C.launch_on(gi) as stream:
            C.check(C.library("patches").orientation_wrap_pairs(
                gi.data_ptr(), gj.data_ptr(), n, n_bins, th.data_ptr(), bins.data_ptr(), stream),
                "orientation_wrap_pairs")
        bits = th.view(torch.int32)
        assert torch.equal(bits[:, 0], bits[:, 1])
        assert torch.equal(bins[:, 0], bins[:, 1])
        assert bool(((bins >= 0) & (bins < n_bins)).all())


@pytest.mark.cuda
def test_one_orientation_launch_per_extract_batch(cuda_dev):
    """Parity and fast configurations: exactly one orientation launch per
    extract_batch, whatever the number of octaves: counted on the device
    in a replay of the graph that the first call captured, which runs no
    wrapper."""
    from siftmetal_tpu_torch import SIFT

    rng = np.random.default_rng(65)
    x = _t(rng.uniform(0, 1, (2, 120, 160)).astype(np.float32), cuda_dev)
    for cfg in (CFG, FAST):
        sift = SIFT(120, 160, cfg, device=cuda_dev)
        sift.extract_batch(x)
        n0 = dict(LAUNCHES)
        seen = profiled_launches(lambda: sift.extract_batch(x))
        assert seen[("orientation_hist",)] == 1
        assert LAUNCHES == n0


# --- the facade's CUDA graphs ----------------------------------------------------------

GRAPH_CONFIGS = {
    "parity": CFG,
    "fast": FAST,
    "fast_bf16": FAST_BF16_CONFIG,
    "cascade": SiftConfig(use_oneshot_pyramid=False, use_pallas_pyramid=True),
    "lean": SiftConfig(detect_slot_fields=False),
    "fused": SiftConfig(use_fused_describe=True),
    "band": SiftConfig(use_band_patches=True),
}


def _fresh(result):
    kps, descs, ctr = result
    return (type(kps)(*(t.clone() for t in kps)), type(descs)(*(t.clone() for t in descs)),
            {k: v.clone() for k, v in ctr.items()})


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GRAPH_CONFIGS))
def test_replay_equals_eager_bit_for_bit(cuda_dev, name):
    """SIFT.extract_batch replays the graph its first call captured: every
    field equal to the eager extract_gray_batch bit for bit, on a first
    batch and on a second one; the first call's tensors are fresh (the
    second replay leaves them as they were); the replay runs, counted on
    the device, the kernel launches that the eager call's wrappers count,
    and runs no wrapper itself."""
    from siftmetal_tpu_torch import SIFT, extract_gray_batch

    cfg = GRAPH_CONFIGS[name]
    rng = np.random.default_rng(71)
    xs = [_t(rng.uniform(0, 1, (2, 240, 320)).astype(np.float32), cuda_dev) for _ in range(2)]
    sift = SIFT(240, 320, cfg, device=cuda_dev)
    first = sift.extract_batch(xs[0])
    kept = _fresh(first)
    assert_same_bits(first, extract_gray_batch(xs[0], cfg, sift.n_octaves))
    n0 = dict(LAUNCHES)
    out = {}
    replayed = profiled_launches(lambda: out.setdefault("second", sift.extract_batch(xs[1])))
    second = out["second"]
    assert LAUNCHES == n0
    want = extract_gray_batch(xs[1], cfg, sift.n_octaves)
    eager = group_launches({k: LAUNCHES[k] - n0[k] for k in n0})
    assert replayed == eager and sum(replayed.values()) > 0
    assert_same_bits(second, want)
    assert_same_bits(first, kept)
    assert not torch.equal(first[2]["n_extrema"], second[2]["n_extrema"])


@pytest.mark.cuda
def test_one_instance_holds_a_graph_per_batch_size(cuda_dev):
    """extract (batch size 1) and extract_batch at batch size 8 on one
    instance: one graph each in one memory pool, each equal to its eager
    call bit for bit, in either order."""
    from siftmetal_tpu_torch import SIFT, extract_gray, extract_gray_batch

    rng = np.random.default_rng(72)
    x = _t(rng.uniform(0, 1, (8, 240, 320)).astype(np.float32), cuda_dev)
    sift = SIFT(240, 320, CFG, device=cuda_dev)
    n_oct = sift.n_octaves
    assert_same_bits(sift.extract_batch(x), extract_gray_batch(x, CFG, n_oct))
    assert_same_bits(sift.extract(x[3]), extract_gray(x[3], CFG, n_oct))
    y = x.flip(-1).contiguous()
    assert_same_bits(sift.extract_batch(y), extract_gray_batch(y, CFG, n_oct))
    assert_same_bits(sift.extract(y[5]), extract_gray(y[5], CFG, n_oct))
    assert sorted(sift._graphs) == [1, 8]


@pytest.mark.cuda
def test_eager_extraction_makes_no_host_sync(cuda_dev):
    """extract_gray_batch under torch.cuda.set_sync_debug_mode("error")
    once its tables are on the card (one call before): no read of the
    card from the host anywhere in the pipeline."""
    from siftmetal_tpu_torch import extract_gray_batch

    rng = np.random.default_rng(73)
    x = _t(rng.uniform(0, 1, (2, 240, 320)).astype(np.float32), cuda_dev)
    n_oct = CFG.num_octaves(240, 320)
    extract_gray_batch(x, CFG, n_oct)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, ctr = extract_gray_batch(x, CFG, n_oct)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(ctr["n_descriptors"].sum()) > 0


_FAILING_CAPTURE = """
import numpy as np, pytest, torch
from siftmetal_tpu_torch import SIFT
from siftmetal_tpu_torch.sift import batched
compact = batched._compact_all
def reading(per_octave, desc_rows, lane_overflow, counters, config):
    int(lane_overflow.sum())
    return compact(per_octave, desc_rows, lane_overflow, counters, config)
batched._compact_all = reading
x = torch.from_numpy(np.random.default_rng(74).uniform(0, 1, (1, 120, 160)).astype(np.float32)).cuda()
sift = SIFT(120, 160)
with pytest.raises(RuntimeError, match="capturing extract_gray_batch"):
    sift.extract_batch(x)
assert sift._graphs == {}, sift._graphs
print("raised")
"""


@pytest.mark.cuda
def test_capture_failure_raises(cuda_dev):
    """A pipeline that reads the card from the host cannot be captured:
    SIFT raises, keeps no graph and does not run the eager route instead.
    In a child process: a failed capture leaves the
    allocator's capture state of that process behind."""
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", _FAILING_CAPTURE], cwd=root, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0 and out.stdout.strip().endswith("raised"), out.stderr[-4000:]


# --- SfM back-end on the card --------------------------------------------------------


def _ba_problem(dev, n_cam=6, n_lm=256, seed=42):
    """tests/test_slam.py's ba_scene (noisy start, two fixed cameras) as a
    port BAProblem on ``dev``."""
    from siftmetal_tpu_torch.slam.ba import BAProblem
    from siftmetal_tpu_torch.slam.camera import project

    rng = np.random.default_rng(seed)
    k = np.array([[400, 0, 320], [0, 400, 240], [0, 0, 1]], np.float32)
    lms = rng.uniform([-3, -3, 6], [3, 3, 12], (n_lm, 3)).astype(np.float32)
    cams = np.zeros((n_cam, 6), np.float32)
    cams[:, 3] = np.linspace(-1, 1, n_cam)
    cams[:, :3] = rng.uniform(-0.05, 0.05, (n_cam, 3))
    cam_idx = np.repeat(np.arange(n_cam), n_lm).astype(np.int32)
    lm_idx = np.tile(np.arange(n_lm), n_cam).astype(np.int32)
    uv = project(torch.from_numpy(cams)[cam_idx], torch.from_numpy(k),
                 torch.from_numpy(lms)[lm_idx]).numpy()
    uv[::37] += 40.0                                    # outliers for the Huber loss
    noisy_cams = cams + rng.normal(0, 0.01, cams.shape).astype(np.float32)
    noisy_cams[:2] = cams[:2]
    noisy_lms = lms + rng.normal(0, 0.05, lms.shape).astype(np.float32)
    args = (noisy_cams, noisy_lms, k, cam_idx, lm_idx, uv, np.ones(len(uv), bool))
    return BAProblem(*(_t(a, dev) for a in args), fixed_cameras=2)


def _pose_loop(dev):
    from siftmetal_tpu_torch.slam.camera import relative
    from siftmetal_tpu_torch.slam.pose_graph import PoseGraph

    rng = np.random.default_rng(9)
    n = 12
    angles = np.linspace(0, 2 * np.pi, n, endpoint=False)
    gt = np.zeros((n, 6), np.float32)
    gt[:, 2], gt[:, 3], gt[:, 4] = angles, np.cos(angles) * 2.0, np.sin(angles) * 2.0
    ei = np.arange(n, dtype=np.int32)
    ej = np.roll(ei, -1)
    rel = relative(torch.from_numpy(gt[ei]), torch.from_numpy(gt[ej])).numpy()
    rel[5] += 0.3                                       # one bad edge for the Huber weights
    noisy = gt + rng.normal(0, 0.05, gt.shape).astype(np.float32)
    noisy[0] = gt[0]
    args = (noisy, ei, ej, rel, np.ones(n, np.float32))
    return PoseGraph(*(_t(a, dev) for a in args), fixed=1)


@pytest.mark.cuda
def test_bundle_adjust_and_pose_graph_on_card_match_cpu(cuda_dev):
    """BA (plain and Huber) and the pose graph on the card agree with the
    CPU run at 1e-3 (other summation orders and another LU), and a second
    run on the card gives the same bits (segment sums in a fixed order)."""
    from siftmetal_tpu_torch.device import resolve_device
    from siftmetal_tpu_torch.slam.ba import bundle_adjust
    from siftmetal_tpu_torch.slam.pose_graph import optimize_pose_graph

    resolve_device("cuda")
    for huber in (0.0, 2.0):
        on_card, s_card = bundle_adjust(_ba_problem(cuda_dev), n_iterations=8, huber_delta=huber)
        on_cpu, s_cpu = bundle_adjust(_ba_problem("cpu"), n_iterations=8, huber_delta=huber)
        again, _ = bundle_adjust(_ba_problem(cuda_dev), n_iterations=8, huber_delta=huber)
        assert torch.equal(again.cameras, on_card.cameras) and torch.equal(again.landmarks, on_card.landmarks)
        assert on_card.cameras.is_cuda and s_card.final_cost.is_cuda
        np.testing.assert_allclose(on_card.cameras.cpu().numpy(), on_cpu.cameras.numpy(), atol=1e-3)
        np.testing.assert_allclose(on_card.landmarks.cpu().numpy(), on_cpu.landmarks.numpy(), atol=1e-3)
        np.testing.assert_allclose(float(s_card.final_cost), float(s_cpu.final_cost),
                                   rtol=1e-3, atol=1e-3)
    g_card, c_card = optimize_pose_graph(_pose_loop(cuda_dev), n_iterations=30)
    g_cpu, c_cpu = optimize_pose_graph(_pose_loop("cpu"), n_iterations=30)
    np.testing.assert_allclose(g_card.poses.cpu().numpy(), g_cpu.poses.numpy(), atol=1e-3)
    # The final cost at 1e-3 absolute: poses 1e-3 apart move the bad edge's
    # 0.3 residual's share of it by ~3e-4.
    assert abs(float(c_card) - float(c_cpu)) <= 1e-3


@pytest.mark.cuda
def test_lm_loops_make_no_host_sync(cuda_dev):
    """bundle_adjust (grouping included) and optimize_pose_graph read no
    value on the host: they run under torch.cuda.set_sync_debug_mode
    ("error") once their inputs lie on the card."""
    from siftmetal_tpu_torch.device import resolve_device
    from siftmetal_tpu_torch.slam.ba import bundle_adjust
    from siftmetal_tpu_torch.slam.pose_graph import optimize_pose_graph

    resolve_device("cuda")
    problem, graph = _ba_problem(cuda_dev), _pose_loop(cuda_dev)
    huber = torch.full((graph.edge_i.shape[0],), 0.1, device=cuda_dev)
    bundle_adjust(problem, n_iterations=2, huber_delta=2.0)     # warm-up: handles, workspaces
    optimize_pose_graph(graph, n_iterations=2, huber_delta=huber)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, stats = bundle_adjust(problem, n_iterations=4, huber_delta=2.0)
        g, cost = optimize_pose_graph(graph, n_iterations=4, huber_delta=huber)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(stats.final_cost) < float(stats.initial_cost)
    assert bool(torch.isfinite(g.poses).all()) and bool(torch.isfinite(cost))


@pytest.mark.cuda
def test_sfm_map_defaults_to_cuda_and_registers_frames(cuda_dev):
    """SfmMap(k) runs on the card; tests/test_sfm.py's synthetic sequence
    registers every frame there with its bars (sub-pixel RMS, ATE < 0.05)."""
    from siftmetal_tpu_torch.slam.camera import project
    from siftmetal_tpu_torch.slam.sfm import SfmConfig, SfmMap
    from siftmetal_tpu_torch.slam.trajectory import ate_rmse, camera_centers

    k = np.array([[400, 0, 320], [0, 400, 240], [0, 0, 1]], np.float32)
    assert SfmMap(k).device.type == "cuda"
    rng = np.random.default_rng(21)
    lms = rng.uniform([-4, -3, 8], [4, 3, 16], (512, 3)).astype(np.float32)
    descs = rng.integers(0, 200, (512, 128)).astype(np.uint8)
    cams = np.zeros((5, 6), np.float32)
    cams[:, 3] = np.linspace(0, 2.0, 5)
    cams[:, 1] = np.linspace(0, 0.1, 5)
    frames = []
    for c in cams:
        uv = project(torch.from_numpy(c), torch.from_numpy(k), torch.from_numpy(lms)).numpy()
        uv = uv + rng.normal(0, 0.3, uv.shape).astype(np.float32)
        inside = (uv[:, 0] > 0) & (uv[:, 0] < 640) & (uv[:, 1] > 0) & (uv[:, 1] < 480)
        frames.append((_t(uv[:, ::-1].copy(), cuda_dev), _t(descs, cuda_dev), _t(inside, cuda_dev)))
    smap = SfmMap(k, SfmConfig(max_cameras=8))
    assert smap.initialize(frames[0], frames[1]) > 200
    for f in frames[2:]:
        ok, n_in, _ = smap.add_frame(f)
        assert ok and n_in > 100
    stats = smap.bundle_adjust()
    assert stats.final_cost.is_cuda and float(stats.final_cost) <= float(stats.initial_cost)
    assert smap.reprojection_rms() < 1.0
    assert ate_rmse(camera_centers(smap.cameras[:5]), camera_centers(cams)) < 0.05


@pytest.fixture
def one_rank_mesh(cuda_dev):
    """A one-rank NCCL mesh set up by make_mesh (no launcher), torn down
    after the test."""
    import torch.distributed as dist

    from siftmetal_tpu_torch.device import resolve_device
    from siftmetal_tpu_torch.parallel import make_mesh

    resolve_device("cuda")
    if dist.is_initialized():
        pytest.skip("a process group is already set up in this process")
    try:
        mesh = make_mesh()
        assert dist.get_backend() == "nccl" and mesh.size() == 1
        yield mesh
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.cuda
def test_nccl_one_rank_extractor_and_matcher_equal_one_device(one_rank_mesh, cuda_dev):
    """make_batch_extractor over a one-rank NCCL mesh equals
    SIFT.extract_batch in every field bit for bit, and the sharded matcher
    equals match_bruteforce in every field."""
    from siftmetal_tpu_torch import SIFT
    from siftmetal_tpu_torch.match import match_bruteforce
    from siftmetal_tpu_torch.parallel import make_batch_extractor, make_sharded_matcher

    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.uniform(0, 1, (2, 96, 128)).astype(np.float32)).to(cuda_dev)
    kb, db, cb = make_batch_extractor(one_rank_mesh, 96, 128, CFG)(frames)
    k1, d1, c1 = SIFT(96, 128, CFG).extract_batch(frames)
    for a, b in zip((*kb, *db), (*k1, *d1)):
        assert a.is_cuda and torch.equal(a, b)
    assert all(torch.equal(cb[k], c1[k]) for k in c1)
    tf, tv = db.features.reshape(-1, 128), db.valid.reshape(-1)
    got = make_sharded_matcher(one_rank_mesh)(db.features[0], db.valid[0], tf, tv)
    want = match_bruteforce(db.features[0], tf, db.valid[0], tv)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_distributed_ba_makes_no_host_sync(one_rank_mesh, cuda_dev):
    """make_distributed_ba reads no value on the host in its LM loop (its
    accept/reject is a torch.where on the all-reduced cost): its eager
    route and its replay run under torch.cuda.set_sync_debug_mode("error")
    once its inputs lie on the card and its graphs are captured, give one
    result, and match bundle_adjust."""
    from siftmetal_tpu_torch.parallel import make_distributed_ba, shard_ba_problem
    from siftmetal_tpu_torch.slam.ba import bundle_adjust

    problem = _ba_problem(cuda_dev)
    sharded = shard_ba_problem(problem, 1)
    run = make_distributed_ba(one_rank_mesh, n_iterations=4, huber_delta=2.0)
    run(sharded)                              # warm-up and capture: communicator, handles
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = run.eager(sharded)
        cams, lms, (c0, c1) = run(sharded)   # a replay
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(eager[0], cams) and torch.equal(eager[1], lms)
    out, _ = bundle_adjust(problem, n_iterations=4, huber_delta=2.0,
                           max_obs_per_landmark=sharded.cam.shape[-1])
    assert float(c1) < float(c0)
    torch.testing.assert_close(cams, out.cameras, atol=1e-4, rtol=0)
    torch.testing.assert_close(lms.reshape(-1, 3), out.landmarks, atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", [None, "cpu:gloo,cuda:nccl"])
def test_init_device_mesh_cuda_keeps_the_work_on_the_card(cuda_dev, backend):
    """The torch idiom: a group set up without the package (its backend
    reads "undefined" or a mixed string, not "nccl") and
    init_device_mesh("cuda", (1,)). The extractor, the matcher and the BA
    over that mesh return tensors on the card equal to the one-device
    calls, and the barrier counts one device."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from siftmetal_tpu_torch import SIFT
    from siftmetal_tpu_torch.match import match_bruteforce
    from siftmetal_tpu_torch.parallel import (
        make_batch_extractor,
        make_distributed_ba,
        make_sharded_matcher,
        multihost,
        shard_ba_problem,
    )
    from siftmetal_tpu_torch.slam.ba import bundle_adjust

    if dist.is_initialized():
        pytest.skip("a process group is already set up in this process")
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    try:
        assert dist.get_backend() != "nccl"
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("batch",))
        rng = np.random.default_rng(0)
        frames = torch.from_numpy(rng.uniform(0, 1, (2, 96, 128)).astype(np.float32))
        kb, db, cb = make_batch_extractor(mesh, 96, 128, CFG)(frames.to(cuda_dev))
        k1, d1, c1 = SIFT(96, 128, CFG).extract_batch(frames.to(cuda_dev))
        for a, b in zip((*kb, *db), (*k1, *d1)):
            assert a.is_cuda and torch.equal(a, b)
        assert all(v.is_cuda and torch.equal(v, c1[k]) for k, v in cb.items())
        tf, tv = db.features.reshape(-1, 128), db.valid.reshape(-1)
        got = make_sharded_matcher(mesh)(db.features[0], db.valid[0], tf, tv)
        want = match_bruteforce(db.features[0], tf, db.valid[0], tv)
        assert all(a.is_cuda and torch.equal(a, b) for a, b in zip(got, want))
        problem = _ba_problem(cuda_dev)
        sharded = shard_ba_problem(problem, 1)
        cams, lms, _ = make_distributed_ba(mesh, n_iterations=2)(sharded)
        out, _ = bundle_adjust(problem, n_iterations=2, max_obs_per_landmark=sharded.cam.shape[-1])
        assert cams.is_cuda and lms.is_cuda
        torch.testing.assert_close(cams, out.cameras, atol=1e-4, rtol=0)
        torch.testing.assert_close(lms.reshape(-1, 3), out.landmarks, atol=1e-3, rtol=0)
        assert multihost.barrier() == 1.0
    finally:
        dist.destroy_process_group()


# --- the solvers and the multi-device layer as CUDA graphs --------------------------


def _leaves_equal(got, want):
    from torch.utils._pytree import tree_leaves

    from torch_bits import same_bits

    a, b = tree_leaves(got), tree_leaves(want)
    return len(a) == len(b) and all(
        same_bits(x, y) if torch.is_tensor(x) else x == y for x, y in zip(a, b))


def _gauge(fixed, dev):
    return torch.full((), fixed, dtype=torch.int64, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n_cam, n_lm", [(6, 256), (16, 1024)])
def test_bundle_adjust_replay_equals_eager_bit_for_bit(cuda_dev, n_cam, n_lm):
    """SfmMap's BA solve (slam.sfm._jit_bundle_adjust) at two bucket
    shapes: the first call (capture) and a later replay equal the eager
    bundle_adjust in every output bit for bit; the replay plan is the
    prologue, the iteration replayed n times, the epilogue."""
    from siftmetal_tpu_torch.device import resolve_device
    from siftmetal_tpu_torch.slam import sfm
    from siftmetal_tpu_torch.slam.ba import bundle_adjust

    resolve_device("cuda")
    p = _ba_problem(cuda_dev, n_cam=n_cam, n_lm=n_lm)._replace(fixed_cameras=_gauge(2, cuda_dev))
    first = sfm._jit_bundle_adjust(p, 8, 2.0)
    want = bundle_adjust(p, n_iterations=8, huber_delta=2.0)
    again = sfm._jit_bundle_adjust(p, 8, 2.0)
    assert _leaves_equal(first, want) and _leaves_equal(again, want)
    assert float(want[1].final_cost) < float(want[1].initial_cost)
    key = sfm._BA_GRAPHS.key(p, n_iterations=8, damping=1e-4, huber_delta=2.0,
                             max_obs_per_landmark=16)
    assert [n for _, n in sfm._BA_GRAPHS.graphs[key].plan] == [1, 8, 1]


@pytest.mark.cuda
def test_windowed_bundle_adjust_replays_one_graph_per_bucket(cuda_dev):
    """Windowed BA calls whose gauge (a device scalar) and valid mask move
    with the window replay the bucket's one program, each equal to its
    eager call bit for bit; another bucket captures one more."""
    from siftmetal_tpu_torch.device import resolve_device
    from siftmetal_tpu_torch.slam import sfm
    from siftmetal_tpu_torch.slam.ba import bundle_adjust

    resolve_device("cuda")
    p = _ba_problem(cuda_dev, n_cam=12, n_lm=512)
    n0 = len(sfm._BA_GRAPHS.graphs)
    results = []
    for fixed in (2, 5, 9):
        q = p._replace(fixed_cameras=_gauge(fixed, cuda_dev), valid=p.cam_idx >= fixed - 1)
        got = sfm._jit_bundle_adjust(q, 6, 2.0)
        assert _leaves_equal(got, bundle_adjust(q, n_iterations=6, huber_delta=2.0))
        results.append(got[0].cameras)
    assert len(sfm._BA_GRAPHS.graphs) == n0 + 1
    assert not torch.equal(results[0], results[2])
    sfm._jit_bundle_adjust(_ba_problem(cuda_dev, n_cam=12, n_lm=1024), 6, 2.0)
    assert len(sfm._BA_GRAPHS.graphs) == n0 + 2


def _pose_ring(dev):
    """scripts/bench_graph_solvers.py's ring: 52 poses with closures in
    SfmMap's 64-pose, 64-edge buckets."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "scripts"))
    from bench_graph_solvers import pose_ring

    return pose_ring(dev)


@pytest.mark.cuda
def test_pose_graph_60_iterations_capture_one_iteration(cuda_dev):
    """slam.sfm._jit_optimize_pose_graph at 60 iterations: one program of
    three graphs, the iteration captured once and replayed 60 times;
    equal to the eager optimize_pose_graph bit for bit, twice."""
    from siftmetal_tpu_torch.device import resolve_device
    from siftmetal_tpu_torch.slam import sfm
    from siftmetal_tpu_torch.slam.pose_graph import optimize_pose_graph

    resolve_device("cuda")
    g, huber = _pose_ring(cuda_dev)
    first = sfm._jit_optimize_pose_graph(g, 60, huber)
    want = optimize_pose_graph(g, n_iterations=60, huber_delta=huber)
    assert _leaves_equal(first, want) and _leaves_equal(sfm._jit_optimize_pose_graph(g, 60, huber), want)
    key = sfm._POSE_GRAPH_GRAPHS.key(g, huber, n_iterations=60, damping=1e-4)
    assert [n for _, n in sfm._POSE_GRAPH_GRAPHS.graphs[key].plan] == [1, 60, 1]


@pytest.mark.cuda
def test_parallel_replays_equal_eager_bit_for_bit(one_rank_mesh, cuda_dev):
    """Over a one-rank NCCL mesh: the distributed BA, the sharded
    extractor and the sharded matcher replay their graphs (one program
    each, collectives inside) and equal their eager routes bit for bit."""
    from siftmetal_tpu_torch.parallel import (
        make_batch_extractor,
        make_distributed_ba,
        make_sharded_matcher,
        shard_ba_problem,
    )

    sharded = shard_ba_problem(_ba_problem(cuda_dev), 1)
    ba = make_distributed_ba(one_rank_mesh, n_iterations=5, huber_delta=2.0)
    assert _leaves_equal(ba(sharded), ba.eager(sharded))
    assert _leaves_equal(ba(sharded), ba.eager(sharded))
    rng = np.random.default_rng(3)
    frames = torch.from_numpy(rng.uniform(0, 1, (2, 96, 128)).astype(np.float32)).to(cuda_dev)
    extract = make_batch_extractor(one_rank_mesh, 96, 128, CFG)
    kb, db, cb = extract(frames)
    assert _leaves_equal((kb, db, cb), extract.eager(frames))
    match = make_sharded_matcher(one_rank_mesh)
    tf, tv = db.features.reshape(-1, 128), db.valid.reshape(-1)
    got = match(db.features[1], db.valid[1], tf, tv)
    assert _leaves_equal(got, match.eager(db.features[1], db.valid[1], tf, tv))
    assert int(got.valid.sum()) > 20
    for run in (ba, extract, match):
        assert len(run.graphs.graphs) == 1


@pytest.mark.cuda
def test_replay_dispatches_only_input_and_output_copies(cuda_dev):
    """A replayed call of each solver dispatches no PyTorch op but one
    copy into each static input and one clone of each output."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from siftmetal_tpu_torch.device import resolve_device
    from siftmetal_tpu_torch.slam import sfm

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    resolve_device("cuda")
    p = _ba_problem(cuda_dev)._replace(fixed_cameras=_gauge(2, cuda_dev))
    g, huber = _pose_ring(cuda_dev)
    # (call, its tensor arguments, its program's outputs: cameras,
    # landmarks and four BAStats; poses and the cost)
    calls = ((lambda: sfm._jit_bundle_adjust(p, 4, 2.0), p, 6),
             (lambda: sfm._jit_optimize_pose_graph(g, 4, huber), (g, huber), 2))
    for call, args, n_out in calls:
        call()
        with Ops() as ops:
            out = call()
        n_in = sum(torch.is_tensor(x) for x in tree_leaves(args))
        assert sorted(set(ops.names)) == ["clone", "copy_"], ops.names
        assert ops.names.count("copy_") == n_in and ops.names.count("clone") == n_out
        assert all(t.is_cuda for t in tree_leaves(out) if torch.is_tensor(t))


_FAILING_SOLVER_CAPTURE = """
import pytest, torch
from siftmetal_tpu_torch.graphs import GraphCache

def reading(x):
    y = x * 2
    int(y.sum())                       # a host read: not capturable
    return y

cache = GraphCache(lambda steps, x: steps.stage(reading, x), "a reading program")
x = torch.ones(8, device="cuda")
with pytest.raises(RuntimeError, match="capturing a reading program"):
    cache(x)
assert cache.graphs == {}, cache.graphs
print("raised")
"""


@pytest.mark.cuda
def test_solver_capture_failure_raises(cuda_dev):
    """A program that reads the card from the host cannot be captured:
    GraphCache raises, keeps no program and runs no eager route instead
    (in a child process: a failed capture leaves the allocator's capture
    state of that process behind)."""
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", _FAILING_SOLVER_CAPTURE], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and out.stdout.strip().endswith("raised"), out.stderr[-4000:]
