"""The kernel variants behind the configuration switches, on the CPU: the
fused cascade's plain version against the Pallas kernel (interpret mode)
and the JAX sequential cascade; the lean detection tail against the JAX
lean tail and the port's full-fields path; the fused describe stage's
plain version against the JAX staged XLA reference; and the routing each
switch selects, observed at the wrappers (the resident-tile patch route
itself is held in tests/test_torch_band.py)."""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from siftmetal_tpu.config import SiftConfig as JConfig
from siftmetal_tpu_torch import FAST_BF16_CONFIG, SIFT, SiftConfig
from siftmetal_tpu_torch.ops.kernels import cascade as PC
from siftmetal_tpu_torch.ops.kernels import patches as KP
from siftmetal_tpu_torch.ops.kernels.detect import (
    detect_candidates,
    detect_candidates_plain,
)
from siftmetal_tpu_torch.ops.kernels.patches import (
    orient_desc_lanes,
    prepare_patch_fields,
)
from siftmetal_tpu_torch.sift import batched as PB
from siftmetal_tpu_torch.sift import describe as PDS
from siftmetal_tpu_torch.sift import detect as PD
from siftmetal_tpu_torch.utils.io import load_image

# Keep PyTorch's CPU pool small: the suite runs several test processes
# side by side, and oversubscribed pools slow every one of them down.
torch.set_num_threads(2)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
CFG = SiftConfig()
JCFG = JConfig()


def _gray():
    img = load_image(str(FIXTURES / "butterfly.ppm"))
    return (img[..., :3] @ np.array([0.212639005871510, 0.715168678767756,
                                     0.072192315360734], np.float32)).astype(np.float32)


# --- fused cascade -----------------------------------------------------------


def test_cascade_plain_matches_pallas_and_sequential():
    """1e-5, the bound tests/test_pallas.py holds the TPU kernel to
    against the sequential cascade."""
    from siftmetal_tpu.ops.pallas.cascade import octave_cascade_pallas
    from siftmetal_tpu.sift.pyramid import build_gaussian_octave

    rng = np.random.default_rng(0)
    g0 = rng.uniform(0, 1, (2, 70, 90)).astype(np.float32)
    pg, pd = PC.octave_cascade(torch.from_numpy(g0), CFG)
    assert pg.shape == (2, 6, 70, 90) and pd.shape == (2, 5, 70, 90)
    np.testing.assert_array_equal(pg[:, 0].numpy(), g0)
    for f in range(2):
        seq = np.asarray(build_gaussian_octave(jnp.asarray(g0[f]), 0, JCFG))
        assert np.abs(pg[f].numpy() - seq).max() < 1e-5
        assert np.abs(pd[f].numpy() - (seq[1:] - seq[:-1])).max() < 1e-5
    kg, kd = octave_cascade_pallas(jnp.asarray(g0[0]), JCFG, interpret=True)
    assert np.abs(pg[0].numpy() - np.asarray(kg)).max() < 1e-5
    assert np.abs(pd[0].numpy() - np.asarray(kd)).max() < 1e-5


def test_cascade_taps_and_tile():
    """One tap schedule for every octave; the default's total radius is
    43 and fits a 64 x 64 tile; a radius that fits no tile raises."""
    from siftmetal_tpu.ops.gaussian import gaussian_taps as j_taps

    taps, radii = PC.cascade_taps(CFG)
    assert int(radii.sum()) == 43 and PC.cascade_tile(CFG) == 64
    for s, rho in enumerate(JCFG.incremental_sigmas(2)):
        ref = j_taps(rho)
        np.testing.assert_array_equal(taps[s, : len(ref)], ref)
        assert not taps[s, len(ref):].any() and radii[s] == len(ref) // 2
    assert PC.cascade_tile(SiftConfig(delta_min=1.0)) == 64
    with pytest.raises(ValueError, match="radius"):
        PC.cascade_tile(SiftConfig(sigma_min=3.2))
    with pytest.raises(ValueError, match="fp32"):
        PC.octave_cascade(torch.zeros((1, 8, 8)), FAST_BF16_CONFIG)


# --- lean detection ----------------------------------------------------------


def _butterfly_dogs(b=2):
    gray = _gray()
    crops = np.stack([gray[:64, :96], gray[150:214, 300:396]][:b])
    _, dogs = PB.build_pyramid_batch(torch.from_numpy(crops), CFG, CFG.num_octaves(64, 96))
    return dogs


def _accepted(kp, bb, np_):
    sel = np_(kp.pass_border[bb]) & np_(kp.cand_valid[bb])
    rows = zip(
        np_(kp.scale[bb])[sel], np_(kp.i[bb])[sel], np_(kp.j[bb])[sel],
        np.round(np_(kp.x[bb])[sel], 4), np.round(np_(kp.y[bb])[sel], 4),
        np.round(np_(kp.sigma[bb])[sel], 4),
    )
    return {tuple(float(v) for v in t) for t in rows}


def test_lean_candidates_equal_full():
    """The lean form's outputs are the full form's, exactly."""
    dog = _butterfly_dogs()[0]
    full = detect_candidates(dog, 0.8 * CFG.dog_threshold, CFG.edge_threshold)
    lean = detect_candidates(dog, 0.8 * CFG.dog_threshold, CFG.edge_threshold, emit_fields=False)
    assert lean.cand_fields is None and lean.cand_edge is None
    for name in ("cand_col", "slot_ok", "n_raw", "n_soft", "n_row_dropped"):
        assert torch.equal(getattr(lean, name), getattr(full, name)), name
    again = detect_candidates_plain(dog, 0.8 * CFG.dog_threshold, CFG.edge_threshold, 6, False)
    assert torch.equal(again.cand_col, lean.cand_col)


def test_lean_tail_matches_jax_and_full_path(monkeypatch):
    """``detect_slot_fields=False``: the same counters and accepted
    keypoint sets as the JAX package's lean tail (its Pallas branch forced
    on the CPU, kernel in interpret mode) and as the port's full-fields
    path."""
    from siftmetal_tpu.ops.pallas import detect as pd
    from siftmetal_tpu.sift import detect as JD

    orig = pd.detect_candidates_pallas

    def interp(*args, **kw):
        kw["interpret"] = True
        kw["tile_h"] = 16
        return orig(*args, **kw)

    monkeypatch.setattr(pd, "detect_candidates_pallas", interp)
    monkeypatch.setattr(JD, "_use_pallas_detect", lambda cfg: True)

    b = 2
    dogs = _butterfly_dogs(b)
    lean_cfg = SiftConfig(detect_slot_fields=False)
    j_kp, j_ctr = JD.detect_all_octaves_batch(
        [jnp.asarray(d.numpy()) for d in dogs], JConfig(detect_slot_fields=False)
    )
    l_kp, l_ctr = PD.detect_all_octaves_batch(dogs, lean_cfg)
    f_kp, f_ctr = PD.detect_all_octaves_batch(dogs, CFG)
    for key in j_ctr:
        np.testing.assert_array_equal(l_ctr[key].numpy(), np.asarray(j_ctr[key]), err_msg=key)
        np.testing.assert_array_equal(l_ctr[key].numpy(), f_ctr[key].numpy(), err_msg=key)
    assert int(l_ctr["n_movers"].sum()) > 0 and int(l_ctr["overflow"].sum()) == 0
    n_acc = 0
    shapes = [tuple(d.shape[-2:]) for d in dogs]
    k_move = PD.mover_budget_all(lean_cfg, shapes)
    for o, (h, w) in enumerate(shapes):
        # The lean grid is compacted to the candidate budget before the
        # tail; the full grid keeps every (scale, row, slot).
        assert l_kp[o].scale.shape[1] == PD.extrema_candidate_budget(lean_cfg, (h, w)) + k_move
        assert f_kp[o].scale.shape[1] == 3 * (h - 2) * 6 + k_move
        for bb in range(b):
            got = _accepted(l_kp[o], bb, lambda t: t.numpy())
            assert got == _accepted(j_kp[o], bb, np.asarray), (o, bb)
            assert got == _accepted(f_kp[o], bb, lambda t: t.numpy()), (o, bb)
            n_acc += len(got)
    assert n_acc > 20


def test_lean_tail_counts_budget_overflow():
    """Candidates past the octave's budget are dropped and counted."""
    rng = np.random.default_rng(5)
    dog = torch.from_numpy(rng.normal(0, 0.05, (1, 5, 40, 200)).astype(np.float32))
    cfg = SiftConfig(detect_slot_fields=False, max_extrema_per_octave=128)
    _, ctr = PD.detect_all_octaves_batch([dog], cfg)
    full = detect_candidates(dog, 0.8 * cfg.dog_threshold, cfg.edge_threshold)
    kept = int(full.slot_ok.sum())
    budget = PD.extrema_candidate_budget(cfg, (40, 200))
    assert kept > budget
    assert int(ctr["overflow"]) >= kept - budget + int(full.n_row_dropped.sum())


# --- fused orientation + descriptor -------------------------------------------


def _fused_lanes(rng, n, h, w, borders):
    """Keypoint lanes on a 96 x 160 crop. Without ``borders``: interior
    lanes and three near an edge. With: lanes on all four borders and the
    four corners, and every third lane with a sigma (3.8-5) whose
    descriptor reach ``desc_patch_radius`` cuts."""
    scale = rng.integers(1, 4, n).astype(np.int32)
    if not borders:
        x = np.concatenate([rng.uniform(15, 80, n - 3), [1.3, 94.2, 40.0]])
        y = np.concatenate([rng.uniform(15, 145, n - 3), [70.0, 80.0, 0.8]])
        sig = rng.uniform(1.7, 3.4, n)
    else:
        x, y = rng.uniform(15, h - 15, n), rng.uniform(15, w - 15, n)
        edge = np.arange(n) % 5
        x[edge == 0] = rng.uniform(-0.4, 1.5, (edge == 0).sum())          # top
        y[edge == 1] = rng.uniform(w - 2.5, w - 0.6, (edge == 1).sum())   # right
        x[edge == 2] = rng.uniform(h - 2.5, h - 0.6, (edge == 2).sum())   # bottom
        y[edge == 3] = rng.uniform(-0.4, 1.5, (edge == 3).sum())          # left
        x[:4], y[:4] = [0.0, 0.0, h - 1.0, h - 1.0], [0.0, w - 1.0, 0.0, w - 1.0]
        sig = rng.uniform(1.7, 3.4, n)
        sig[np.arange(n) % 3 == 1] = rng.uniform(3.8, 5.0, (np.arange(n) % 3 == 1).sum())
    f32 = lambda a: np.asarray(a, np.float32)
    return scale, f32(x), f32(y), f32(sig)


# Case -> (crop origin, seed, lanes, lanes on the borders with cut reach).
FUSED_CASES = {
    "interior": ((100, 200), 1, 40, False),
    "borders_cut_reach": ((220, 40), 2, 45, True),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_describe_plain_matches_jax_staged(case):
    """The fused stage's plain version (bin-order peaks) vs the JAX staged
    XLA reference (``orientation_hists_xla`` -> smoothing -> peaks by
    height -> ``descriptor_lanes``): the same peak set per keypoint (a
    keypoint with more peaks than MAX_ORI aside), theta to 1e-5 and
    quantized descriptors within 1, on interior lanes and on lanes at
    every border whose reach the static radii cut."""
    from siftmetal_tpu.sift import describe as JDS

    (r0, c0), seed, n, borders = FUSED_CASES[case]
    gray = np.ascontiguousarray(_gray()[r0:r0 + 96, c0:c0 + 160])
    g = torch.from_numpy(gray[None])
    gauss = torch.stack([g] + [PC.blur(g, s) for s in (1.2, 1.6, 2.0, 2.6, 3.2)], 1)  # [1, 6, 96, 160]
    rng = np.random.default_rng(seed)
    scale, x, y, sig = _fused_lanes(rng, n, 96, 160, borders)
    valid = np.arange(n) % 9 != 4
    if borders:
        half = CFG.descriptor_lambda * (CFG.n_histograms_per_axis + 1) / CFG.n_histograms_per_axis
        reach = np.ceil(np.sqrt(2.0) * half * sig + 0.5) + 1
        assert (valid & (reach > CFG.desc_patch_radius)).sum() >= 10
    t = torch.from_numpy
    fields = prepare_patch_fields(gauss, CFG)
    raw, th, ov = orient_desc_lanes(fields, t(scale), t(x), t(y), t(sig), CFG, valid=t(valid))
    assert raw.shape == (n, 4, 128) and th.shape == (n, 4) and ov.dtype == torch.bool
    assert not ov[~t(valid)].any() and (raw[~ov] == 0).all() and (th[~ov] == 0).all()
    feats = PDS.quantize_descriptors(raw, CFG).numpy().astype(np.int32)

    jg = jnp.asarray(gauss[0].numpy())
    hist = JDS.orientation_hists_xla(jg, jnp.asarray(scale), jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(sig), JCFG)
    hist = JDS._smooth_circular(hist, JCFG.orientation_smoothing_iterations)
    jth, jov = JDS.orientation_peaks(hist, JCFG)
    jth, jov = np.asarray(jth), np.asarray(jov)
    is_peak, _ = PDS._peak_map(t(np.array(hist)), CFG)
    n_peaks = is_peak.sum(-1).numpy()
    checked = 0
    for l in np.nonzero(valid)[0]:
        if n_peaks[l] > CFG.max_orientations_per_keypoint:
            continue
        got = sorted(th[l][ov[l]].tolist())
        want = sorted(jth[l][jov[l]].tolist())
        assert len(got) == len(want) >= 1, l
        np.testing.assert_allclose(got, want, atol=1e-5)
        # Bin order: ascending bins, i.e. theta ascending from -pi after the
        # half-turn wrap of the upper bins.
        for p in np.nonzero(ov[l].numpy())[0]:
            ref = np.asarray(JDS.descriptor_lanes(
                jg, jnp.asarray(scale[l:l + 1]), jnp.asarray(x[l:l + 1]), jnp.asarray(y[l:l + 1]),
                jnp.asarray(sig[l:l + 1]), jnp.asarray(th[l, p:p + 1].numpy()), JCFG,
            )).astype(np.int32)[0]
            assert np.abs(feats[l, p] - ref).max() <= 1, (l, p)
            checked += 1
    assert checked >= 30
    assert (ov.sum(1) > 1).any()          # some keypoint has several peaks


def test_bin_order_peaks_differ_from_height_order_only_in_order():
    rng = np.random.default_rng(2)
    hist = torch.from_numpy(rng.uniform(0.5, 1, (50, 36)).astype(np.float32))
    hist = PDS._smooth_circular(hist, 2)
    tb, vb = PDS.orientation_peaks_bin_order(hist, CFG)
    th, vh = PDS.orientation_peaks(hist, CFG)
    is_peak, theta = PDS._peak_map(hist, CFG)
    few = is_peak.sum(-1) <= 4
    assert few.any() and (~few).any()
    for l in range(50):
        bins = torch.nonzero(is_peak[l]).flatten()[:4]
        np.testing.assert_array_equal(tb[l][vb[l]].numpy(), theta[l][bins].numpy())
        if few[l]:
            assert sorted(tb[l][vb[l]].tolist()) == sorted(th[l][vh[l]].tolist())
    cond = PDS.peak_conditioning(hist, CFG)
    assert cond.shape == tb.shape and ((cond > 0) == vb).all()


# --- routing -----------------------------------------------------------------


@pytest.fixture
def calls(monkeypatch):
    """Record which kernel wrappers the batched pipeline calls."""
    seen = []

    def spy(module, name, label=None):
        real = getattr(module, name)

        def wrapper(*a, **kw):
            tag = label or name
            if name == "detect_candidates_octaves":
                tag = "detect_candidates" if kw.get("emit_fields", True) else "detect_candidates_lean"
            if name == "blur_stack" and a[0].dtype == torch.bfloat16:
                tag = "blur_stack_bf16"
            if name == "blur_cascade" and a[2]:
                tag = "blur_cascade_bf16"
            if name in ("seed_octave", "octave_oneshot") and a[0].dtype == torch.bfloat16:
                tag = name + "_bf16"
            if name == "_resident_lanes":
                tag = a[1]                  # the resident kernel's name
            seen.append(tag)
            return real(*a, **kw)

        monkeypatch.setattr(module, name, wrapper)

    from siftmetal_tpu_torch.sift import pyramid as PPy

    spy(PB._oneshot, "seed_octave")
    spy(PB._oneshot, "octave_oneshot")
    spy(PB, "octave_cascade")
    spy(PB, "blur_cascade")
    spy(PPy, "blur_stack")
    spy(PD, "detect_candidates_octaves")
    spy(PB, "orientation_hist_octaves")
    spy(PB, "descriptor_lanes")
    spy(PB, "orient_desc_lanes")
    spy(KP, "_resident_lanes")
    return seen


# Route -> (config, calls expected of the wrappers, tolerance against the
# plain incremental cascade). 180 x 128 frame: the parity preset's octaves
# have 360, 180, 90, ... rows. The fused cascade is the same blurs in the
# same order (1e-5); a one-shot slice is ONE sampled Gaussian where the
# cascade composes several, which agree to 1e-4 only; the bf16 chain is
# held against the JAX package in tests/test_torch_fast.py.
PYRAMID_ROUTES = {
    "default": (SiftConfig(), {"seed_octave": 1, "octave_oneshot": 1}, 1e-4),
    "no_oneshot": (SiftConfig(use_oneshot_pyramid=False),
                   {"seed_octave": 0, "octave_oneshot": 0, "octave_cascade": 0}, 0.0),
    "cascade": (SiftConfig(use_oneshot_pyramid=False, use_pallas_pyramid=True),
                {"octave_cascade": 1, "seed_octave": 0, "octave_oneshot": 0}, 1e-5),
    "cascade_after_oneshot": (SiftConfig(use_pallas_pyramid=True),
                              {"seed_octave": 1, "octave_oneshot": 1, "octave_cascade": 0}, 1e-4),
    "fast_bf16": (FAST_BF16_CONFIG,
                  {"seed_octave_bf16": 1, "octave_oneshot": 0, "octave_oneshot_bf16": 0,
                   "blur_stack": 0}, None),
    "bf16_no_cascade_kernel": (
        dataclasses.replace(FAST_BF16_CONFIG, use_oneshot_pyramid=False, use_pallas_pyramid=True),
        {"octave_cascade": 0, "seed_octave_bf16": 0, "blur_stack": 0}, None),
}


@pytest.mark.parametrize("name", sorted(PYRAMID_ROUTES))
def test_pyramid_routing_follows_config(calls, name):
    cfg, want, tol = PYRAMID_ROUTES[name]
    rng = np.random.default_rng(0)
    gray = torch.from_numpy(rng.uniform(0, 1, (1, 180, 128)).astype(np.float32))
    n_oct = cfg.num_octaves(180, 128)
    gauss, dogs = PB.build_pyramid_batch(gray, cfg, n_oct)
    assert all(g.dtype == torch.float32 for g in gauss + dogs)
    for key, n in want.items():
        assert calls.count(key) == n, (key, calls)
    blurs = calls.count("blur_stack") + calls.count("blur_stack_bf16")
    cascades = calls.count("blur_cascade") + calls.count("blur_cascade_bf16")
    direct = sum(calls.count(k) for k in ("seed_octave", "seed_octave_bf16", "octave_oneshot",
                                          "octave_oneshot_bf16", "octave_cascade"))
    seed_blur = 0 if calls.count("seed_octave") + calls.count("seed_octave_bf16") else 1
    # One blur_cascade an octave that no direct route takes; blur_stack
    # only for the unfused seed image.
    assert cascades == n_oct - direct and blurs == seed_blur, calls
    assert calls.count("blur_cascade_bf16") == (cascades if cfg.pyramid_dtype == "bfloat16" else 0)
    if tol is not None:
        ref, _ = PB.build_pyramid_batch(gray, SiftConfig(use_oneshot_pyramid=False), n_oct)
        for a, b in zip(gauss, ref):
            assert (a - b).abs().max().item() <= tol


RESIDENT = ["orientation_hist_banded", "descriptor_hist_banded"]
DESCRIBE_ROUTES = {
    "default": (SiftConfig(), ["detect_candidates", "orientation_hist_octaves", "descriptor_lanes"],
                ["detect_candidates_lean", "orient_desc_lanes"] + RESIDENT),
    "band": (SiftConfig(use_band_patches=True),
             ["detect_candidates", "orientation_hist_octaves", "descriptor_lanes"] + RESIDENT,
             ["detect_candidates_lean", "orient_desc_lanes"]),
    "band_fused": (SiftConfig(use_band_patches=True, use_fused_describe=True),
                   ["detect_candidates", "orient_desc_lanes"],
                   ["orientation_hist_octaves", "descriptor_lanes"] + RESIDENT),
    "lean": (SiftConfig(detect_slot_fields=False), ["detect_candidates_lean", "descriptor_lanes"],
             ["detect_candidates", "orient_desc_lanes"]),
    "fused": (SiftConfig(use_fused_describe=True), ["detect_candidates", "orient_desc_lanes"],
              ["orientation_hist_octaves", "descriptor_lanes", "detect_candidates_lean"]),
}


@pytest.mark.parametrize("name", sorted(DESCRIBE_ROUTES))
def test_detect_and_describe_routing_follows_config(calls, name):
    """Each switch changes the wrappers taken, and the variants return the
    default route's keypoints and (as a set) its descriptors. Detection and
    the orientation histograms are one call over every octave of the
    batch; the other patch wrappers one call an octave."""
    cfg, used, unused = DESCRIBE_ROUTES[name]
    crop = _gray()[150:214, 300:396]
    kp, ds, ctr = SIFT(64, 96, cfg, device="cpu").extract(crop)
    n_oct = cfg.num_octaves(64, 96)
    for key in used:
        want = 1 if key.startswith("detect_candidates") or key == "orientation_hist_octaves" else n_oct
        assert calls.count(key) == want, (key, calls)
    for key in unused:
        assert calls.count(key) == 0, (key, calls)
    calls.clear()
    kp0, ds0, ctr0 = SIFT(64, 96, SiftConfig(), device="cpu").extract(crop)
    for key, v in ctr0.items():
        assert int(ctr[key]) == int(v), key
    rows = lambda k: sorted(zip(k.x[k.valid].tolist(), k.y[k.valid].tolist(), k.sigma[k.valid].tolist()))
    assert rows(kp) == rows(kp0) and len(rows(kp)) > 10
    drows = lambda d: sorted(
        (round(a, 3), round(b, 3), round(c, 3)) for a, b, c in
        zip(d.x[d.valid].tolist(), d.y[d.valid].tolist(), d.theta[d.valid].tolist())
    )
    assert drows(ds) == drows(ds0)


def test_jax_config_with_switches_round_trips():
    """A JAX SiftConfig with any of the variant switches set becomes the
    port's through ``config_from_dict``."""
    from siftmetal_tpu_torch.config import config_from_dict

    for kw in ({"use_oneshot_pyramid": False, "use_pallas_pyramid": True},
               {"use_fused_describe": True}, {"detect_slot_fields": False},
               {"use_band_patches": True}, {"pyramid_dtype": "bfloat16", "delta_min": 1.0}):
        jc = JConfig(**kw)
        pc = config_from_dict(dataclasses.asdict(jc))
        assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
        assert pc == SiftConfig(**kw)
