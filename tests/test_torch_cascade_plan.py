"""The streamed fused cascade's launch plan (``ops/kernels/cascade.py``
``cascade_plan``) on the CPU: its blocks cover every output pixel of every
frame once, each block's rows stay inside the extended plane, its rings fit
their pitches, and a step-by-step model of csrc/cascade.cu's supersteps
(the same rings, slots, row ranges and pass order, in numpy) gives the
plain cascade."""

import math

import numpy as np
import pytest
import torch

from siftmetal_tpu_torch.config import FAST_CONFIG, SiftConfig
from siftmetal_tpu_torch.ops.kernels import cascade as KC

CFG = SiftConfig()
G = KC.ROWS

SIZES = ((960, 1280), (480, 640), (37, 45), (61, 23), (5, 7))


@pytest.mark.parametrize("strip", KC.STRIP_CHOICES)
@pytest.mark.parametrize("hw", SIZES)
def test_blocks_cover_every_pixel_once(hw, strip):
    h, w = hw
    for band in KC.BAND_CHOICES + (13,):
        plan = KC.cascade_plan(CFG, 2, h, w, strip, band)
        hits = np.zeros((h, w), np.int64)
        for bi in range(plan.bands):
            r0, r1 = plan.block_rows(bi)
            assert 0 <= r0 < r1 <= h
            # The halo rows the block reads lie in the extended plane.
            assert -plan.radius <= r0 - plan.radius and r1 + plan.radius <= h + plan.radius
            for si in range(plan.strips):
                c0, c1 = plan.block_cols(si)
                assert 0 <= c0 < c1 <= w
                hits[r0:r1, c0:c1] += 1
        assert (hits == 1).all()          # the same for every frame: B is a grid axis


def test_default_plan_and_fits():
    """The default radii (5, 7, 8, 10, 13) at the default strip fit two
    blocks an SM; every strip of the sweep fits one block."""
    plan = KC.cascade_plan(CFG, 8, 960, 1280)
    assert [st.r for st in plan.stages] == [5, 7, 8, 10, 13] and plan.radius == 43
    assert KC.blocks_per_sm(plan.smem) == 2
    # One wave on 132 SMs: 2 bands of 480 rows x 14 strips x 8 frames.
    assert (plan.strip, plan.band, plan.bands, plan.strips) == (KC.STRIP, 480, 2, 14)
    half = KC.cascade_plan(CFG, 8, 480, 640)
    assert (half.band, half.bands * half.strips * 8) == (120, 224)
    assert KC.cascade_plan(CFG, 64, 480, 640).band == 480    # more frames than a wave
    assert 2 * (plan.smem + 1024) <= 228 * 1024
    for strip in KC.STRIP_CHOICES:
        assert KC.cascade_plan(CFG, 8, 960, 1280, strip).smem <= KC._SMEM_BYTES
    table = plan.table()
    assert table.dtype == np.int32 and table.size == 11 + 13 * 5
    assert plan.taps.size == sum(2 * st.r + 1 for st in plan.stages)


def _rings_fit(plan):
    """The pitch and depth rules csrc/cascade.cu relies on."""
    prev_end = 4                          # 4 floats of padding before the rings
    for s, st in enumerate(plan.stages):
        wp = plan.strip + 2 * (plan.radius - st.m)
        e_out = plan.radius - st.m - st.r
        assert st.wx == wp - 2 * st.r and st.gx == -(-(st.ax + st.wx) // 4)
        assert st.px == KC.X_COLS * -(-4 * st.gx // KC.X_COLS)
        assert st.dx == 2 * st.r + G and st.dp == (2 * G if s == 0 else G)
        # The strip's first output column (X-local e_out) is 16-byte aligned.
        assert 4 <= st.ax < 8 and (st.ax + e_out) % 4 == 0
        assert st.ap == (4 if s == 0 else plan.stages[s - 1].ax)
        # X task g reads P_s physical [8 g + ap - ax - 4, 8 g + ap - ax + 2 r + 12).
        assert st.pp >= st.px + st.ap - st.ax + 2 * st.r + 12
        assert st.pp >= (st.ap + wp if s == 0 else plan.stages[s - 1].px)
        assert st.op == prev_end and st.ox == st.op + st.pp * st.dp
        prev_end = st.ox + st.px * st.dx
        assert st.op % 4 == 0 and st.ox % 4 == 0 and st.pp % 4 == 0
    assert plan.oc == prev_end and plan.smem == 4 * (prev_end + plan.strip + 2 * plan.radius)


CONFIGS = [
    SiftConfig(n_scales_per_octave=n, sigma_min=sm, delta_min=dm)
    for n in (1, 2, 3, 4, 5, 6) for sm in (0.8, 1.0, 1.6, 2.0) for dm in (0.5, 1.0)
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: f"n{c.n_scales_per_octave}-s{c.sigma_min}-d{c.delta_min}")
def test_every_admitted_configuration_has_a_plan(cfg):
    """Whatever the first design admitted (``cascade_tile``), the streamed
    kernel plans at some strip inside shared memory; what it refused still
    raises."""
    try:
        KC.cascade_tile(cfg)
    except ValueError:
        with pytest.raises(ValueError, match="radius"):
            KC.cascade_plan(cfg, 1, 64, 64)
        return
    plan = KC.cascade_plan(cfg, 2, 64, 96)
    assert plan.smem <= KC._SMEM_BYTES and plan.strip >= 4
    _rings_fit(plan)


def _reflect(i, n):
    m = np.mod(i, 2 * n)
    return np.where(m < n, m, 2 * n - 1 - m)


def _model(plan, g0):
    """csrc/cascade.cu's blocks, superstep by superstep: rings filled with
    NaN (so a read of a row or column no pass wrote spoils an output), the
    next superstep's input rows copied before the passes read (as early as
    the cp.async may land), the Y passes in reverse stage order (so a DoG
    that read back a slice stored in the same superstep would find it
    missing). Returns gauss, dog and how many times each output was
    written."""
    b, h, w = g0.shape
    st, R, n = plan.stages, plan.radius, len(plan.stages)
    taps = [plan.taps[s.toff:s.toff + 2 * s.r + 1].astype(np.float64) for s in st]
    gauss = np.full((b, n + 1, h, w), np.nan)
    dog = np.full((b, n, h, w), np.nan)
    writes = np.zeros((b, 2 * n + 1, h, w), np.int64)
    for f in range(b):
        for bi in range(plan.bands):
            r0, r1 = plan.block_rows(bi)
            for si in range(plan.strips):
                c0 = si * plan.strip
                jend = min(c0 + plan.strip, w)
                col = _reflect(c0 - R + np.arange(plan.strip + 2 * R), w)
                P = [np.full((s.dp, s.pp), np.nan) for s in st]
                X = [np.full((s.dx, s.px), np.nan) for s in st]
                top, n_in = r0 - R, r1 - r0 + 2 * R

                def load(t):
                    for q in range(G):
                        i = top + t * G + q
                        if i >= top + n_in:
                            break
                        P[0][i % st[0].dp, :col.size] = g0[f, _reflect(i, h), col]

                load(0)
                for t in range(n - 1 + -(-n_in // G)):
                    if (t + 1) * G < n_in:
                        load(t + 1)
                    for s, S in enumerate(st):
                        bs = top + (t - s) * G - S.m
                        for q in range(max(0, top + S.m - bs), min(G, r1 + R - S.m - bs)):
                            row = P[s][(bs + q) % S.dp]
                            kn = 2 * S.r + 1
                            assert S.px + kn - 1 <= S.pp
                            X[s][(bs + q) % S.dx, :S.px] = sum(
                                taps[s][k] * row[k:k + S.px] for k in range(kn))
                    for s, S in reversed(list(enumerate(st))):
                        y0 = top + (t - s) * G - S.m - S.r
                        lo, hi = top + S.m + S.r, r1 + R - S.m - S.r
                        if y0 + G <= lo or y0 >= hi:
                            continue
                        e1 = R - S.m - S.r
                        for q in range(G):
                            y = y0 + q
                            if y < lo or y >= hi:
                                continue
                            acc = sum(taps[s][k] * X[s][(y - S.r + k) % S.dx]
                                      for k in range(2 * S.r + 1))
                            if s + 1 < n:
                                P[s + 1][y % st[s + 1].dp, :S.px] = acc
                            if not r0 <= y < r1:
                                continue
                            # Slice s read back: g0, or what stage s - 1 stored.
                            prev = g0[f, y] if s == 0 else gauss[f, s, y]
                            for lc in range(S.px):
                                j = c0 - e1 + lc
                                if not c0 <= j < jend:
                                    continue
                                assert s == 0 or writes[f, s, y, j] == 1
                                gauss[f, s + 1, y, j] = acc[lc]
                                dog[f, s, y, j] = acc[lc] - prev[j]
                                writes[f, s + 1, y, j] += 1
                                writes[f, n + 1 + s, y, j] += 1
                                if s == 0:
                                    gauss[f, 0, y, j] = prev[j]
                                    writes[f, 0, y, j] += 1
    return gauss, dog, writes


@pytest.mark.parametrize("shape,strip,band", [
    ((2, 37, 45), 16, 13),      # odd sizes, several strips and bands, R = 43 > H
    ((1, 61, 23), 8, 61),       # one band, strips narrower than the radius
    ((1, 9, 50), 32, 4),        # bands shorter than a superstep's rows
])
def test_superstep_model_equals_plain_cascade(shape, strip, band):
    rng = np.random.default_rng(11)
    g0 = rng.uniform(0, 1, shape).astype(np.float32)
    plan = KC.cascade_plan(CFG, *shape, strip, band)
    _rings_fit(plan)
    gauss, dog, writes = _model(plan, g0)
    assert (writes == 1).all()
    pg, pd = KC.octave_cascade_plain(torch.from_numpy(g0), CFG)
    np.testing.assert_array_equal(gauss[:, 0], g0)
    assert np.abs(gauss - pg.double().numpy()).max() < 1e-5
    assert np.abs(dog - pd.double().numpy()).max() < 1e-5


def test_superstep_model_other_radii():
    """A configuration of the generic instance (4 scales an octave, radii
    3-5 at delta_min 1) through the same model."""
    cfg = FAST_CONFIG
    rng = np.random.default_rng(12)
    g0 = rng.uniform(0, 1, (1, 29, 31)).astype(np.float32)
    plan = KC.cascade_plan(cfg, 1, 29, 31, 12, 10)
    assert [s.r for s in plan.stages] != [5, 7, 8, 10, 13]
    _rings_fit(plan)
    gauss, dog, writes = _model(plan, g0)
    assert (writes == 1).all()
    pg, pd = KC.octave_cascade_plain(torch.from_numpy(g0), cfg)
    assert np.abs(gauss - pg.double().numpy()).max() < 1e-5
    assert np.abs(dog - pd.double().numpy()).max() < 1e-5
    assert math.isclose(plan.taps.sum(), len(plan.stages), rel_tol=1e-5)
