"""The port's one-launch orientation stage over every octave of a batch
(``orientation_hist_octaves``) on the CPU: its plain route against one
call an octave and the JAX package's XLA path and Pallas kernel (interpret
mode) octave by octave, the launch plan's coverage of every lane, the
launch wrapper's row placement on a stand-in library, and the describe
stage's Phase A restructure against the per-octave route and the JAX
package."""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from siftmetal_tpu.config import SiftConfig as JConfig
from siftmetal_tpu.sift import describe as JDS
from siftmetal_tpu_torch.config import FAST_CONFIG, SiftConfig
from siftmetal_tpu_torch.ops.kernels import LAUNCHES
from siftmetal_tpu_torch.ops.kernels import patches as KP
from siftmetal_tpu_torch.sift import batched as PB
from siftmetal_tpu_torch.sift import describe as PDS
from siftmetal_tpu_torch.sift import detect as PDT

torch.set_num_threads(2)

CFG = SiftConfig()
JCFG = JConfig()


def _octaves(seed, b=2, h=48, w=64, cfg=CFG):
    """Per-octave compacted keypoints and fields of a seeded batch, as the
    describe stage's Phase A makes them, and its Gaussian stacks."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (b, h // 4 + 1, w // 4 + 1))
    gray = np.kron(base, np.ones((1, 4, 4)))[:, :h, :w] + rng.normal(0, 0.05, (b, h, w))
    gray = torch.from_numpy(gray.astype(np.float32))
    gauss, dogs = PB.build_pyramid_batch(gray, cfg, cfg.num_octaves(h, w))
    per_octave, _ = PDT.detect_all_octaves_batch(dogs, cfg)
    kpcs, fields = [], []
    for o, d in enumerate(dogs):
        budget = PDT.keypoint_budget(cfg, tuple(d.shape[-2:]), o)
        kpcs.append(PDT.compact_octave_keypoints(per_octave[o], o, cfg, budget)[0])
        fields.append(KP.prepare_patch_fields(gauss[o], cfg))
    return kpcs, fields, gauss


def _per_octave(kpcs, fields, cfg):
    """One ``orientation_hist_lanes`` call an octave, concatenated."""
    rows = []
    for k, f in zip(kpcs, fields):
        b, n = k.valid.shape
        flat = lambda a: a.reshape(-1)
        frame = torch.arange(b, dtype=torch.int32).repeat_interleave(n)
        rows.append(KP.orientation_hist_lanes(
            f, flat(k.scale), flat(k.x_oct), flat(k.y_oct), flat(k.sigma_oct), cfg,
            valid=flat(k.valid), frame=frame).reshape(b, n, -1))
    return torch.cat(rows, 1)


@pytest.mark.parametrize("cfg", [CFG, FAST_CONFIG], ids=["parity", "fast"])
def test_octaves_equal_one_call_an_octave(cfg):
    kpcs, fields, _ = _octaves(1, cfg=cfg)
    assert len(kpcs) >= 3 and sum(int(k.valid.sum()) for k in kpcs) > 10
    before = dict(LAUNCHES)
    got = KP.orientation_hist_octaves(fields, kpcs, cfg)
    assert LAUNCHES == before                 # the CPU runs no kernel
    assert got.shape == (2, sum(k.valid.shape[1] for k in kpcs), cfg.n_orientation_bins)
    assert torch.equal(got, _per_octave(kpcs, fields, cfg))
    valid = torch.cat([k.valid for k in kpcs], 1)
    assert bool((got[~valid] == 0).all()) and bool((got[valid].sum(-1) > 0).all())


def test_octaves_match_xla_and_pallas_per_octave():
    """Each octave's rows against the JAX package's XLA histograms (1e-5),
    frame by frame, and frame 0's against its Pallas kernel in interpret
    mode (5e-3 of each lane's largest bin: the Pallas kernel's polynomial
    atan2)."""
    from siftmetal_tpu.ops.pallas.patches import orientation_hist_lanes_pallas
    from siftmetal_tpu.ops.pallas.patches import prepare_patch_fields as j_fields

    kpcs, fields, gauss = _octaves(2, b=1)
    got = KP.orientation_hist_octaves(fields, kpcs, CFG).numpy()
    first = 0
    checked = 0
    for o, k in enumerate(kpcs):
        n = k.valid.shape[1]
        for f in range(k.valid.shape[0]):
            sel = k.valid[f].numpy()
            if not sel.any():
                continue
            lanes = [np.asarray(a[f].numpy()[sel]) for a in (k.scale, k.x_oct, k.y_oct, k.sigma_oct)]
            rows = got[f, first:first + n][sel]
            ref = np.asarray(JDS.orientation_hists_xla(
                jnp.asarray(gauss[o][f].numpy()), *(jnp.asarray(a) for a in lanes), JCFG))
            np.testing.assert_allclose(rows, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
            checked += int(sel.sum())
            if f > 0:                     # the Pallas kernel (slow to interpret): frame 0
                continue
            m = len(rows)
            pad = -(-m // 8) * 8          # the Pallas kernel takes lanes in groups of 8
            padded = [np.concatenate([a, np.repeat(a[-1:], pad - m)]) for a in lanes]
            pal = np.asarray(orientation_hist_lanes_pallas(
                j_fields(jnp.asarray(gauss[o][f].numpy()), JCFG),
                *(jnp.asarray(a) for a in padded), JCFG, interpret=True))[:m]
            denom = np.abs(pal).max(axis=1, keepdims=True) + 1e-9
            assert (np.abs(pal - rows) / denom).max() < 5e-3
        first += n
    assert checked > 10


PLANS = {
    "parity_640x480": [2048, 512, 128, 32, 8, 8, 8],
    "fast": [512, 128, 32, 8, 8, 8],
    "one": [1],
    "odd": [7, 3, 1, 5],
}


@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_covers_every_lane_once(name, batch):
    """Walking the chunks as csrc/patches.cu does (octave by chunk0, then
    the chunk's lanes) reaches every lane of every octave once, and the
    lanes' rows tile the [B, sum of budgets] output exactly."""
    budgets = PLANS[name]
    plans, scans, rows = KP.orientation_plan(budgets, batch)
    assert rows == sum(budgets)
    starts = np.asarray([p.scan0 for p in plans])
    seen = [np.zeros(p.lanes, np.int64) for p in plans]
    hits = np.zeros((batch, rows), np.int64)
    numbers = []
    for c in range(scans):
        o = int(np.searchsorted(starts, c, side="right")) - 1
        p = plans[o]
        l0 = (c - p.scan0) * KP.ORI_SCAN
        lanes = np.arange(l0, min(l0 + KP.ORI_SCAN, p.lanes))
        assert lanes.size > 0
        seen[o][lanes] += 1
        numbers.extend(p.lane0 + lanes)       # what the scan queues
        f, k = lanes // p.budget, lanes % p.budget
        hits[f, p.first + k] += 1
    assert all((s == 1).all() for s in seen)
    assert (hits == 1).all()
    # Queued lane numbers are unique and map back to their octave.
    assert sorted(numbers) == list(range(sum(p.lanes for p in plans)))
    lane0 = np.asarray([p.lane0 for p in plans])
    for n in numbers[::7]:
        o = int(np.searchsorted(lane0, n, side="right")) - 1
        while o + 1 < len(plans) and plans[o + 1].lane0 == plans[o].lane0:
            o += 1                            # octaves without lanes share lane0
        assert 0 <= n - plans[o].lane0 < plans[o].lanes
    assert [p.first for p in plans] == list(np.cumsum([0] + budgets[:-1]))


class _FakeLibrary:
    """Stands in for the built library on the CPU: reads the launch table
    the way csrc/patches.cu does and writes each octave's plain rows where
    the table's output pointer and strides put them."""

    def __init__(self):
        self.calls = 0

    @staticmethod
    def _array(ptr, n, ctype):
        return np.ctypeslib.as_array((ctype * n).from_address(ptr))

    def orientation_octaves(self, table, radius, n_bins, lam, work, stream):
        self.calls += 1
        n_oct = int(self._array(table.value, 1, ctypes.c_int64)[0])
        rows = self._array(table.value, 1 + 18 * n_oct, ctypes.c_int64)[1:].reshape(n_oct, 18)
        n_lanes = int(rows[:, 13].sum())
        assert (self._array(work, 4 + n_lanes, ctypes.c_int32) == 0).all()   # zeroed
        scan = number = 0
        for (gi, gj, valid, frame, scale, x, y, sigma, out, b, s, h, w, lanes, budget, stride,
             scan0, lane0) in rows:
            assert frame == 0 and scan0 == scan and lane0 == number
            scan += -(-int(lanes) // KP.ORI_SCAN)
            number += int(lanes)
            plane = lambda p: torch.from_numpy(
                self._array(int(p), int(b * s * h * w), ctypes.c_float).reshape(b, s, h, w).copy())
            lane = lambda p, t: torch.from_numpy(self._array(int(p), int(lanes), t).copy())
            cfg = SiftConfig()
            assert radius == cfg.ori_patch_radius and n_bins == cfg.n_orientation_bins
            fr = torch.arange(int(lanes)) // int(budget)
            hist = PDS.orientation_hist_plain(
                plane(gi), plane(gj), fr, lane(scale, ctypes.c_int32).long(),
                lane(x, ctypes.c_float), lane(y, ctypes.c_float), lane(sigma, ctypes.c_float),
                lane(valid, ctypes.c_uint8).bool(), cfg)
            dst = self._array(int(out), int((b - 1) * stride + budget) * n_bins, ctypes.c_float)
            for f in range(int(b)):
                for k in range(int(budget)):
                    r = (f * int(stride) + k) * n_bins
                    dst[r:r + n_bins] = hist[f * int(budget) + k].numpy()
        return 0


def test_launch_wrapper_places_each_octave(monkeypatch):
    """The CUDA route's host side on the CPU, in one call: the launch
    table, the octaves' lane arrays and the rows of each octave in the
    [B, sum of budgets, n_bins] output equal the per-octave plain rows."""
    from contextlib import contextmanager

    from siftmetal_tpu_torch.ops import cuda as C

    kpcs, fields, _ = _octaves(3, b=3)
    ref = _per_octave(kpcs, fields, CFG)
    fake = _FakeLibrary()

    @contextmanager
    def on(t):
        yield 0

    monkeypatch.setattr(KP, "use_kernel", lambda t, name: True)
    monkeypatch.setattr(C, "launch_on", on)
    monkeypatch.setattr(C, "library", lambda name: fake)
    n0 = LAUNCHES["orientation_hist"]
    got = KP.orientation_hist_octaves(fields, kpcs, CFG)
    assert fake.calls == 1 and LAUNCHES["orientation_hist"] == n0 + 1
    assert torch.equal(got, ref)


def _old_phase_a(fields_all, kpcs, config):
    """The describe stage's orientation as it was: one call an octave and a
    concatenation."""
    return _per_octave(kpcs, fields_all, config)


@pytest.mark.parametrize("cfg", [CFG, FAST_CONFIG], ids=["parity", "fast"])
def test_extract_equals_per_octave_route(monkeypatch, cfg):
    """extract_gray_batch on the CPU with the one-call Phase A equals the
    same extraction with the per-octave route swapped in, field by
    field."""
    rng = np.random.default_rng(4)
    base = rng.uniform(0, 1, (2, 17, 25))
    gray = torch.from_numpy((np.kron(base, np.ones((1, 4, 4)))[:, :64, :96]
                             + rng.normal(0, 0.03, (2, 64, 96))).astype(np.float32))
    n_oct = cfg.num_octaves(64, 96)
    kp, ds, ctr = PB.extract_gray_batch(gray, cfg, n_oct)
    monkeypatch.setattr(PB, "orientation_hist_octaves", _old_phase_a)
    kp0, ds0, ctr0 = PB.extract_gray_batch(gray, cfg, n_oct)
    for a, c in zip(kp, kp0):
        assert torch.equal(a, c)
    for a, c in zip(ds, ds0):
        assert torch.equal(a, c)
    assert all(torch.equal(ctr[k], ctr0[k]) for k in ctr0)
    assert int(ctr["n_descriptors"].sum()) > 10


def test_extract_matches_jax_package():
    """The restructured extraction against the JAX package's SIFT.extract
    on a butterfly crop other than tests/test_torch_extract.py's: the same
    counters, keypoints to 1e-4 and descriptors within one quantization
    step."""
    import pathlib

    from siftmetal_tpu.sift.extract import SIFT as JSIFT
    from siftmetal_tpu_torch import SIFT
    from siftmetal_tpu_torch.utils.io import load_image

    fixture = pathlib.Path(__file__).resolve().parent / "fixtures" / "butterfly.ppm"
    frame = load_image(str(fixture))[150:214, 300:396]
    kp, ds, ctr = SIFT(64, 96, CFG, device="cpu").extract(frame)
    jkp, jds, jctr = JSIFT(64, 96, JCFG).extract(jnp.asarray(frame))
    for key, v in jctr.items():
        assert int(ctr[key]) == int(v), key
    rows = lambda k: np.sort(np.stack([np.asarray(k.x)[np.asarray(k.valid)],
                                       np.asarray(k.y)[np.asarray(k.valid)]], 1), axis=0)
    a, b = rows(kp), rows(jkp)
    assert a.shape == b.shape and a.shape[0] > 5
    np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)

    def desc(d):
        sel = np.asarray(d.valid)
        key = np.stack([np.asarray(d.x)[sel], np.asarray(d.y)[sel], np.asarray(d.theta)[sel]], 1)
        order = np.lexsort(np.round(key, 3).T[::-1])
        return np.asarray(d.features)[sel][order].astype(np.int32)

    fa, fb = desc(ds), desc(jds)
    assert fa.shape == fb.shape
    assert (np.abs(fa - fb) <= 1).mean() >= 0.99
