"""The resident-tile patch route (``use_band_patches``) on the CPU: its
lane layout against a numpy reference, its histograms against the staged
route and the JAX package, and the switch end to end.

The JAX package's band-resident kernels are held equal to its per-lane
kernels at 2e-5 by its own slow-tier test (four interpret-mode calls, 96 s
on a CPU), so the default tier compares with the XLA reference that
``tests/test_torch_describe.py`` holds the staged route against, and runs
one banded kernel (orientation) in interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from siftmetal_tpu.config import SiftConfig as JConfig
from siftmetal_tpu.sift import describe as JDS
from siftmetal_tpu_torch import SIFT, SiftConfig
from siftmetal_tpu_torch.ops.kernels import patches as KP
from siftmetal_tpu_torch.sift import describe as PDS
from siftmetal_tpu_torch.utils.io import load_image

from conftest import FIXTURES

torch.set_num_threads(2)

CFG = SiftConfig()
BAND = SiftConfig(use_band_patches=True)
JCFG = JConfig()


def _band_inputs():
    """The inputs of the JAX package's band-equivalence test: 2 frames of
    96 x 160, 32 lanes in three sigma groups, ragged validity, sigma 0 and
    NaN theta in the invalid lanes."""
    rng = np.random.default_rng(23)
    s = CFG.n_gaussians_per_octave
    h, w, b, n = 96, 160, 2, 32
    gauss = rng.uniform(0, 1, (b, s, h, w)).astype(np.float32)
    sigs = np.concatenate([
        rng.uniform(0.6, 1.3, 16), rng.uniform(1.6, 2.4, 8), rng.uniform(2.8, 3.6, 8),
    ]).astype(np.float32)
    scale = rng.integers(1, CFG.n_scales_per_octave + 1, n).astype(np.int32)
    x = rng.uniform(20, h - 20, n).astype(np.float32)
    y = rng.uniform(20, w - 20, n).astype(np.float32)
    theta = rng.uniform(-3, 3, n).astype(np.float32)
    valid = rng.random(n) > 0.3
    frame = rng.integers(0, b, n).astype(np.int32)
    return gauss, dict(
        scale=scale, x=x, y=y, sigma=np.where(valid, sigs, 0.0).astype(np.float32),
        theta=np.where(valid, theta, np.nan).astype(np.float32), valid=valid, frame=frame,
    )


def _t(a):
    return torch.tensor(np.array(a))


def _port(gauss, ln, config, stage):
    fields = KP.prepare_patch_fields(_t(gauss), CFG)
    args = [_t(ln[k]) for k in ("scale", "x", "y", "sigma")]
    kw = dict(valid=_t(ln["valid"]), frame=_t(ln["frame"]))
    if stage == "orientation":
        return KP.orientation_hist_lanes(fields, *args, config, **kw)
    return KP.descriptor_lanes(fields, *args, _t(ln["theta"]), config, **kw)


def _assert_same_as_staged(got, staged, stage):
    """The banded route runs the same plain histograms on permuted lanes.
    Orientation (a scatter-add per lane): exactly equal. Descriptors: the
    plain version contracts each chunk of lanes with one batched matrix
    product, whose CPU kernel sums in an order that depends on where a
    lane sits in its chunk; the last bit of a few bins moves (5e-7 of the
    lane's largest bin allowed, 1.2e-7 seen) and the quantised descriptor
    does not. On the card the two kernels agree bit for bit
    (tests/test_torch_cuda.py)."""
    if stage == "orientation":
        assert torch.equal(got, staged)
        return
    assert bool(((got - staged).abs().amax(1) <= 5e-7 * staged.abs().amax(1)).all())
    assert torch.equal(PDS.quantize_descriptors(got, CFG), PDS.quantize_descriptors(staged, CFG))


@pytest.mark.parametrize("stage", ["orientation", "descriptor"])
def test_band_route_equals_staged_and_matches_jax(stage):
    """Banded == staged on the CPU; against the JAX XLA reference of each
    lane's own frame: orientation 1e-5 relative (+1e-5 of the largest
    bin), as tests/test_torch_describe.py; descriptors within one
    quantisation step. Invalid lanes are zero."""
    gauss, ln = _band_inputs()
    got = _port(gauss, ln, BAND, stage)
    _assert_same_as_staged(got, _port(gauss, ln, CFG, stage), stage)
    valid = ln["valid"]
    assert (got.numpy()[~valid] == 0).all() and bool(torch.isfinite(got).all())
    for f in range(gauss.shape[0]):
        sel = valid & (ln["frame"] == f)
        lanes = [jnp.asarray(ln[k][sel]) for k in ("scale", "x", "y", "sigma")]
        if stage == "orientation":
            ref = np.asarray(JDS.orientation_hists_xla(jnp.asarray(gauss[f]), *lanes, JCFG))
            np.testing.assert_allclose(got.numpy()[sel], ref, rtol=1e-5,
                                       atol=1e-5 * np.abs(ref).max())
        else:
            ref = np.asarray(JDS.descriptor_lanes(
                jnp.asarray(gauss[f]), *lanes, jnp.asarray(ln["theta"][sel]), JCFG,
            )).astype(np.int32)
            q = PDS.quantize_descriptors(got, CFG).numpy().astype(np.int32)[sel]
            assert np.abs(q - ref).max() <= 1


def test_band_orientation_matches_jax_banded_kernel():
    """The JAX package's band-resident orientation kernel itself (Pallas,
    interpret mode, ``use_band_patches=True``) on the same lanes. 5e-3
    relative to each lane's largest bin: the TPU kernel's polynomial atan2
    against ``atan2`` moves samples that sit on a bin edge (the bound
    tests/test_torch_describe.py uses for the per-lane kernel), on top of
    the 2e-5 the JAX package allows between its two forms."""
    from siftmetal_tpu.ops.pallas.patches import (
        orientation_hist_lanes_pallas,
        prepare_patch_fields as j_fields,
    )

    gauss, ln = _band_inputs()
    got = _port(gauss, ln, BAND, "orientation").numpy()
    jcfg = JConfig(use_band_patches=True)
    pal = np.asarray(orientation_hist_lanes_pallas(
        j_fields(jnp.asarray(gauss), jcfg),
        *(jnp.asarray(ln[k]) for k in ("scale", "x", "y", "sigma")), jcfg,
        valid=jnp.asarray(ln["valid"]), frame=jnp.asarray(ln["frame"]), interpret=True,
    ))
    assert pal.shape == got.shape
    assert (pal[~ln["valid"]] == 0).all()
    denom = np.abs(pal).max(axis=1, keepdims=True) + 1e-9
    assert (np.abs(pal - got) / denom).max() < 5e-3 + 2e-5


# --- the lane layout -----------------------------------------------------------


def _layout_reference(shape, valid, frame, scale, x, y, tile):
    """Tile key per lane and the tile-ordered lane list, in numpy."""
    b, s, h, w = shape
    f = np.clip(frame, 0, b - 1).astype(np.int64)
    sc = np.clip(scale, 1, s).astype(np.int64) - 1
    ci = np.clip(np.rint(np.where(valid, x, 0)).astype(np.int64), 0, h - 1)
    cj = np.clip(np.rint(np.where(valid, y, 0)).astype(np.int64), 0, w - 1)
    tr, tc = -(-h // tile), -(-w // tile)
    key = ((f * s + sc) * tr + ci // tile) * tc + cj // tile
    lanes = np.nonzero(valid)[0]
    order = lanes[np.argsort(key[lanes], kind="stable")]
    return key, order


LAYOUT_CASES = {
    "random": dict(n=200, seed=0),
    "clustered": dict(n=300, seed=1, clustered=True),
    "all_invalid": dict(n=40, seed=2, p_valid=0.0),
    "all_valid_one_tile": dict(n=17, seed=3, p_valid=1.0, one_tile=True),
    "empty": dict(n=0, seed=4),
    "edges_and_clamped": dict(n=64, seed=5, edges=True),
}


@pytest.mark.parametrize("name", sorted(LAYOUT_CASES))
@pytest.mark.parametrize("tile", [KP.DESC_TILE, KP.ORI_TILE])
def test_tile_layout_against_numpy(name, tile):
    """``src`` is a permutation: valid lanes first, by tile key, stable
    within a tile; invalid lanes last and in no run; the runs cover exactly
    the valid lanes, one run per occupied tile; centres beyond the image
    land in the tile of the clamped centre; the last row and column have a
    tile of their own."""
    case = LAYOUT_CASES[name]
    rng = np.random.default_rng(case["seed"])
    shape = (2, 3, 70, 101)
    b, s, h, w = shape
    n = case["n"]
    valid = rng.random(n) < case.get("p_valid", 0.7)
    frame = rng.integers(0, b, n).astype(np.int32)
    scale = rng.integers(1, s + 1, n).astype(np.int32)
    x = rng.uniform(-0.4, h - 0.6, n).astype(np.float32)
    y = rng.uniform(-0.4, w - 0.6, n).astype(np.float32)
    if case.get("clustered"):
        c = rng.uniform([5, 5], [h - 5, w - 5], (6, 2))
        xy = c[rng.integers(0, 6, n)] + rng.normal(0, 2.0, (n, 2))
        x, y = xy[:, 0].astype(np.float32), xy[:, 1].astype(np.float32)
    if case.get("one_tile"):
        frame[:], scale[:] = 1, 2
        x = rng.uniform(tile, 2 * tile - 1, n).astype(np.float32)
        y = rng.uniform(0, tile - 1, n).astype(np.float32)
    if case.get("edges"):
        valid[:12] = True
        x[:12] = [h - 1, h - 1, 0, 0, h + 30, -25, h - 0.51, 2.5, 3.5, 1e6, -1e6, h - 1.49]
        y[:12] = [w - 1, 0, w - 1, 0, w + 9, -3, w - 0.51, 2.5, 3.5, 1e6, -1e6, w - 1.49]
        x[~valid], y[~valid] = np.nan, 1e9          # garbage in invalid lanes
    lay = KP.tile_layout(shape, _t(valid), _t(frame), _t(scale), _t(x), _t(y), tile)
    src, first, run_end = (a.numpy() for a in lay)
    key, order = _layout_reference(shape, valid, frame, scale, x, y, tile)
    nv = int(valid.sum())
    assert sorted(src.tolist()) == list(range(n))
    np.testing.assert_array_equal(src[:nv], order)
    assert not valid[src[nv:]].any() and not first[nv:].any()
    np.testing.assert_array_equal(src[nv:], np.nonzero(~valid)[0])   # stable there too
    starts = np.nonzero(first)[0]
    covered = np.zeros(n, bool)
    for p in starts:
        run = src[p:run_end[p]]
        assert len(set(key[run])) == 1 and not covered[run].any()
        covered[run] = True
        assert p == 0 or key[src[p - 1]] != key[src[p]]
    np.testing.assert_array_equal(covered, valid)
    assert len(starts) == len(set(key[valid]))
    if case.get("edges"):
        tr, tc = -(-h // tile), -(-w // tile)
        tile_of = lambda l: (key[l] // tc % tr, key[l] % tc)
        assert tile_of(0) == (tr - 1, tc - 1) and tile_of(3) == (0, 0)
        assert tile_of(4) == tile_of(0) and tile_of(5) == tile_of(3)    # clamped
        assert tile_of(9) == tile_of(0) and tile_of(10) == tile_of(3)
        # Half-way centres round to even, as the kernels' rintf does.
        assert np.rint(np.float32(2.5)) == 2 and np.rint(np.float32(3.5)) == 4


@pytest.mark.parametrize("name", sorted(LAYOUT_CASES))
@pytest.mark.parametrize("tile", [KP.DESC_TILE, KP.ORI_TILE], ids=["desc_tile", "ori_tile"])
def test_tile_runs_on_cpu_is_tile_layout_with_its_heads(name, tile):
    """``tile_runs`` on CPU tensors (the plain version of the resident
    forms' CUDA layout, which orders lanes inside a run freely) is
    ``tile_layout`` itself, with ``heads[:runs[0]]`` the run starts and the
    hand-out counter at 0, at each resident form's tile."""
    case = LAYOUT_CASES[name]
    rng = np.random.default_rng(case["seed"] + 100)
    shape = (2, 3, 70, 101)
    n = case["n"]
    valid = rng.random(n) < case.get("p_valid", 0.7)
    args = (_t(valid), _t(rng.integers(0, 2, n).astype(np.int32)),
            _t(rng.integers(1, 4, n).astype(np.int32)),
            _t(rng.uniform(-0.4, 69.4, n).astype(np.float32)),
            _t(rng.uniform(-0.4, 100.4, n).astype(np.float32)))
    lay = KP.tile_layout(shape, *args, tile)
    runs = KP.tile_runs(shape, *args, tile)
    for a, b in zip(runs[:3], lay):
        assert torch.equal(a, b)
    starts = torch.nonzero(lay.first).flatten()
    assert int(runs.runs[0]) == starts.numel() and int(runs.runs[1]) == 0
    assert torch.equal(runs.heads[:starts.numel()], starts)


def test_band_route_on_border_and_shared_tiles():
    """Lanes whose windows leave the image and lanes that share a tile
    (two orientations of one keypoint) through both stages: equal to the
    staged route."""
    rng = np.random.default_rng(7)
    gauss = rng.uniform(0, 1, (1, CFG.n_gaussians_per_octave, 50, 60)).astype(np.float32)
    x = np.array([0.2, 0.2, 49.3, 25.0, 25.4, 25.0, 48.0, -0.4], np.float32)
    y = np.array([0.4, 0.4, 59.1, 30.0, 30.2, 30.0, 1.0, 59.4], np.float32)
    n = len(x)
    ln = dict(scale=rng.integers(1, 4, n).astype(np.int32), x=x, y=y,
              sigma=rng.uniform(0.8, 3.6, n).astype(np.float32),
              theta=rng.uniform(-3, 3, n).astype(np.float32),
              valid=np.ones(n, bool), frame=np.zeros(n, np.int32))
    for stage in ("orientation", "descriptor"):
        got = _port(gauss, ln, BAND, stage)
        _assert_same_as_staged(got, _port(gauss, ln, CFG, stage), stage)
        assert bool((got.abs().sum(1) > 0).all())


# --- the switch end to end -----------------------------------------------------


def _crop(r0, c0):
    img = load_image(str(FIXTURES / "butterfly.ppm"))
    gray = (img[..., :3] @ np.array([0.212639005871510, 0.715168678767756,
                                     0.072192315360734], np.float32)).astype(np.float32)
    return gray[r0:r0 + 64, c0:c0 + 96]


@pytest.mark.parametrize("origin", [(0, 0), (150, 300)])
def test_band_switch_equals_default_route_and_jax_counters(origin):
    """``SIFT(64, 96, SiftConfig(use_band_patches=True))`` returns the
    default route's keypoints and descriptors row for row, and the JAX
    package's counters for the same crop."""
    from siftmetal_tpu.sift.extract import SIFT as JSIFT

    crop = _crop(*origin)
    kp, ds, ctr = SIFT(64, 96, BAND, device="cpu").extract(crop)
    kp0, ds0, ctr0 = SIFT(64, 96, CFG, device="cpu").extract(crop)
    for a, c in zip(tuple(kp) + tuple(ds), tuple(kp0) + tuple(ds0)):
        assert torch.equal(a, c)
    assert int(ds.valid.sum()) > 10
    _, _, jctr = JSIFT(64, 96).extract(crop)
    for key, v in jctr.items():
        assert int(ctr[key]) == int(ctr0[key]) == int(v), key
