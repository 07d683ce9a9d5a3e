"""The port's one-launch detection over every octave of a batch
(``detect_candidates_octaves``) on the CPU: the same outputs as one call
an octave, the JAX package's Pallas kernel in interpret mode per octave,
and a launch plan that covers every (octave, frame, scale, row) once."""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from siftmetal_tpu_torch.config import FAST_CONFIG, SiftConfig
from siftmetal_tpu_torch.ops.kernels import LAUNCHES
from siftmetal_tpu_torch.ops.kernels import detect as KD

torch.set_num_threads(2)

THR = 0.8 * 0.0133
FIELDS = ("cand_col", "slot_ok", "n_raw", "n_soft", "n_row_dropped")


def _stack(seed, shapes, b=2, s=5):
    """Per-octave DoG stacks: blocky fields plus noise, dense enough for
    some rows to hold more soft extrema than they have slots."""
    rng = np.random.default_rng(seed)
    out = []
    for h, w in shapes:
        base = rng.uniform(-1, 1, (b, s, h // 3 + 2, w // 3 + 2))
        dog = np.kron(base, np.ones((1, 1, 3, 3)))[:, :, :h, :w]
        dog = dog + rng.normal(0, 0.05, dog.shape)
        out.append(dog.astype(np.float32))
    return out


SHAPES = ((60, 80), (30, 40), (15, 20))


@pytest.mark.parametrize("emit_fields", [True, False])
def test_octaves_equal_one_call_an_octave(emit_fields):
    dogs = [torch.from_numpy(d) for d in _stack(3, SHAPES)]
    before = dict(LAUNCHES)
    got = KD.detect_candidates_octaves(dogs, THR, 10.0, emit_fields=emit_fields)
    assert LAUNCHES == before                      # the CPU runs no kernel
    assert len(got) == len(dogs)
    for g, d in zip(got, dogs):
        ref = KD.detect_candidates(d, THR, 10.0, emit_fields=emit_fields)
        for name in FIELDS:
            assert torch.equal(getattr(g, name), getattr(ref, name)), name
        if emit_fields:
            assert torch.equal(g.cand_edge, ref.cand_edge)
            for a, c in zip(g.cand_fields, ref.cand_fields):
                assert torch.equal(a, c)
        else:
            assert g.cand_fields is None and g.cand_edge is None
    assert sum(int(g.n_row_dropped.sum()) for g in got) > 0   # full rows exercised


def test_octaves_match_pallas_per_octave():
    """Three octaves (B 2; 60x80, 30x40, 15x20) against the Pallas kernel
    in interpret mode, octave by octave (its rows past H-2 are tile
    padding and are cropped)."""
    from siftmetal_tpu.ops.pallas.detect import detect_candidates_pallas

    dogs = _stack(5, SHAPES)
    got = KD.detect_candidates_octaves([torch.from_numpy(d) for d in dogs], THR, 10.0)
    for g, dog in zip(got, dogs):
        h = dog.shape[2]
        jc, jok, jf, je, jraw, jsoft, jdrop = detect_candidates_pallas(
            jnp.asarray(dog), THR, 10.0, tile_h=16, interpret=True
        )
        crop = lambda a: np.asarray(a)[:, :, : h - 2]
        ok = crop(jok)
        np.testing.assert_array_equal(g.slot_ok.numpy(), ok)
        np.testing.assert_array_equal(g.cand_col.numpy(), np.where(ok, crop(jc), 0))
        np.testing.assert_array_equal(g.cand_edge.numpy(), crop(je) & ok)
        # The Taylor step agrees to fp32 rounding (XLA may fuse
        # multiply-adds; tests/test_torch_detect.py holds it the same way).
        for a, r in zip(g.cand_fields, jf):
            np.testing.assert_allclose(a.numpy(), np.where(ok, crop(r), 0.0), rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(g.n_raw.numpy(), np.asarray(jraw))
        np.testing.assert_array_equal(g.n_soft.numpy(), np.asarray(jsoft))
        np.testing.assert_array_equal(g.n_row_dropped.numpy(), np.asarray(jdrop))


def test_flags_are_bool_with_plain_values():
    dogs = [torch.from_numpy(d) for d in _stack(4, SHAPES[:2])]
    for g, d in zip(KD.detect_candidates_octaves(dogs, THR, 10.0), dogs):
        ref = KD.detect_candidates_plain(d, THR, 10.0)
        assert g.slot_ok.dtype == torch.bool and g.cand_edge.dtype == torch.bool
        assert torch.equal(g.slot_ok, ref.slot_ok) and torch.equal(g.cand_edge, ref.cand_edge)


def _shapes(cfg, h, w):
    return cfg.octave_shapes(h, w, cfg.num_octaves(h, w))


PLANS = {
    "parity_640x480": (_shapes(SiftConfig(), 480, 640), 8, 5),
    "fast_640x480": (_shapes(FAST_CONFIG, 480, 640), 8, 5),
    "butterfly": (_shapes(SiftConfig(), 340, 512) + ((10, 16),), 1, 5),
    "tail_7x10": (((40, 60), (20, 30), (10, 15), (7, 10)), 3, 4),
    "six_planes": (((33, 47), (16, 23), (8, 11)), 2, 6),
}


@pytest.mark.parametrize("band_rows", KD.BAND_ROW_CHOICES)
@pytest.mark.parametrize("name", sorted(PLANS))
def test_launch_plan_covers_every_row_once(name, band_rows):
    """Walking the tasks as csrc/detect.cu does (octave by task0, then
    frame, then band) reaches every (octave, frame, scale, row) once, and
    the rows' output slots tile each flat output exactly."""
    shapes, b, s = PLANS[name]
    slots = 6
    plans, n_tasks, total = KD.launch_plan(shapes, b, s, slots, band_rows)
    starts = np.asarray([p.task0 for p in plans])
    hits = np.zeros(total, np.int64)
    rows_seen = [np.zeros((b, s - 2, h - 2), np.int64) for h, _ in shapes]
    for task in range(n_tasks):
        o = int(np.searchsorted(starts, task, side="right")) - 1
        p = plans[o]
        local = task - p.task0
        bb, band = divmod(local, p.bands)
        assert bb < b
        r = np.arange(band * band_rows, min((band + 1) * band_rows, p.h - 2))
        assert r.size > 0
        rows_seen[o][bb, :, r] += 1
        sc = np.arange(s - 2)[:, None]
        first = p.out0 + ((bb * (s - 2) + sc) * (p.h - 2) + r[None, :]) * slots
        hits[(first[..., None] + np.arange(slots)).reshape(-1)] += 1
    assert all((seen == 1).all() for seen in rows_seen)
    assert (hits == 1).all()
    assert total == sum(p.size for p in plans)
    assert [p.out0 for p in plans] == list(np.cumsum([0] + [p.size for p in plans[:-1]]))


def test_octaves_refuse_what_the_kernel_does_not_take():
    """Argument checks that hold on every device."""
    dogs = [torch.zeros((1, 5, 16, 16))]
    with pytest.raises(ValueError, match="no octaves"):
        KD.detect_candidates_octaves([], THR, 10.0)
    with pytest.raises(ValueError, match="expected"):
        KD.detect_candidates(dogs[0][0], THR, 10.0)


class _FakeDetectLibrary:
    """Stands in for the built library on the CPU: reads the launch table
    the way csrc/detect.cu does, and writes the plain version's outputs of
    each octave where the table's offsets put them."""

    def __init__(self):
        self.calls = 0

    @staticmethod
    def _array(ptr, n, ctype):
        return np.ctypeslib.as_array((ctype * n).from_address(ptr))

    def detect_octaves(self, table, soft, edge_bound, emit, cand, ok, oi, oj, os_, val, edge,
                       counts, stream):
        self.calls += 1
        head = self._array(table.value, 5, ctypes.c_int64)
        n_oct, b, s, slots, _ = (int(v) for v in head)
        rows = self._array(table.value, 5 + 6 * n_oct, ctypes.c_int64)[5:].reshape(n_oct, 6)
        r = 10.0
        assert abs(edge_bound - (r + 1.0) ** 2 / r) < 1e-4
        total = sum(b * (s - 2) * (int(h) - 2) * slots for _, h, *_ in rows)
        outs = {"cand": (cand, ctypes.c_int32), "ok": (ok, ctypes.c_uint8)}
        if emit:
            outs.update(oi=(oi, ctypes.c_float), oj=(oj, ctypes.c_float), os=(os_, ctypes.c_float),
                        val=(val, ctypes.c_float), edge=(edge, ctypes.c_uint8))
        else:
            assert oi is None and edge is None
        bufs = {k: self._array(p, total, t) for k, (p, t) in outs.items()}
        cnt = self._array(counts, 3 * n_oct * b + 1, ctypes.c_int32)
        assert cnt[-1] == 0                       # the ticket starts at 0
        for o, (ptr, h, w, bands, task0, out0) in enumerate(rows):
            dog = torch.from_numpy(self._array(int(ptr), b * s * int(h) * int(w),
                                               ctypes.c_float).reshape(b, s, h, w).copy())
            ref = KD.detect_candidates_plain(dog, soft, r, slots, bool(emit))
            n = ref.cand_col.numel()
            put = lambda key, t: bufs[key].__setitem__(slice(out0, out0 + n), t.reshape(-1).numpy())
            put("cand", ref.cand_col)
            put("ok", ref.slot_ok.to(torch.uint8))
            if emit:
                for key, f in zip(("oi", "oj", "os", "val"), ref.cand_fields):
                    put(key, f)
                put("edge", ref.cand_edge.to(torch.uint8))
            for k, c in enumerate((ref.n_raw, ref.n_soft, ref.n_row_dropped)):
                cnt[(k * n_oct + o) * b:(k * n_oct + o + 1) * b] = c.numpy()
        return 0


@pytest.mark.parametrize("emit_fields", [True, False])
def test_launch_wrapper_places_each_octave(monkeypatch, emit_fields):
    """The CUDA route's host side on the CPU: the launch table, the flat
    outputs and their per-octave views (split, bool flags, unbound fields,
    counters) give each octave the plain version's outputs, in one call."""
    from contextlib import contextmanager

    from siftmetal_tpu_torch.ops import cuda as C

    fake = _FakeDetectLibrary()

    @contextmanager
    def on(t):
        yield 0

    monkeypatch.setattr(KD, "use_kernel", lambda t, name: True)
    monkeypatch.setattr(C, "launch_on", on)
    monkeypatch.setattr(C, "library", lambda name: fake)
    dogs = [torch.from_numpy(d) for d in _stack(6, SHAPES, b=3)]
    name = "detect_candidates" if emit_fields else "detect_candidates_lean"
    n0 = LAUNCHES[name]
    got = KD.detect_candidates_octaves(dogs, THR, 10.0, emit_fields=emit_fields)
    assert fake.calls == 1 and LAUNCHES[name] == n0 + 1
    for g, d in zip(got, dogs):
        ref = KD.detect_candidates_plain(d, THR, 10.0, emit_fields=emit_fields)
        for field in FIELDS:
            a, c = getattr(g, field), getattr(ref, field)
            assert a.dtype == c.dtype and torch.equal(a, c), field
        if emit_fields:
            assert g.cand_edge.dtype == torch.bool and torch.equal(g.cand_edge, ref.cand_edge)
            for a, c in zip(g.cand_fields, ref.cand_fields):
                assert a.is_contiguous() and torch.equal(a, c)
        assert g.cand_col.is_contiguous() and g.slot_ok.is_contiguous()
