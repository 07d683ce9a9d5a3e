"""The cross-octave refinement tail in one launch (``csrc/detect.cu``
``refine_tail_kernel`` through ``sift/detect.py`` ``refine_tail``)
against its plain version (``_tail_all_octaves``).

On the CPU: the wrapper runs the plain tail and launches nothing, raises
on any other device, and the kernel's name counts in its own profiler
group. On the card (``-m cuda``): every field of every octave and every
counter equal to the plain tail's on the same candidates, bit for bit, in
both detection forms, at B 1 and 8 at 480x640 and on the edge cases, one
launch a call, and inside a captured graph. The file imports no JAX:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_refine_tail.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from siftmetal_tpu_torch.config import FAST_CONFIG, SiftConfig
from siftmetal_tpu_torch.graphs import GraphCache
from siftmetal_tpu_torch.ops.kernels import KERNEL_GROUPS, LAUNCHES, device_launches
from siftmetal_tpu_torch.ops.kernels.detect import (
    TAIL_COUNTERS,
    TAIL_FLAGS,
    TAIL_INTS,
    TAIL_REALS,
    Candidates,
    _neighborhood,
    detect_candidates_octaves,
    edge_ok,
    taylor_step,
)
from siftmetal_tpu_torch.sift import detect as PD
from siftmetal_tpu_torch.sift.batched import build_pyramid_batch
from torch_bits import profiled_launches, same_bits

CFG = SiftConfig()
LEAN = SiftConfig(detect_slot_fields=False)
CONFIGS = {
    "parity": CFG,
    "parity_lean": LEAN,
    "fast": FAST_CONFIG,
    "fast_lean": dataclasses.replace(FAST_CONFIG, detect_slot_fields=False),
}


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (held on the H100 by chip_smoke.py)")
    return torch.device("cuda")


def _frames(b, h, w, dev, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0.0, 1.0, (b, h, w)).astype(np.float32)).to(dev)


def _dogs(gray, cfg):
    _, dogs = build_pyramid_batch(gray, cfg, cfg.num_octaves(*gray.shape[-2:]))
    return dogs


def _tails(dogs, cfg, outs=None):
    """The wrapper's and the plain tail's results on the same candidates
    (the detection's on ``dogs`` unless given), and the wrapper's
    launches."""
    if outs is None:
        outs = detect_candidates_octaves(dogs, 0.8 * cfg.dog_threshold, cfg.edge_threshold,
                                         emit_fields=cfg.detect_slot_fields)
    shapes = tuple(tuple(d.shape[-2:]) for d in dogs)
    k_move = PD.mover_budget_all(cfg, shapes)
    n0 = LAUNCHES["refine_tail"]
    got = PD.refine_tail(outs, dogs, shapes, cfg, k_move)
    launches = LAUNCHES["refine_tail"] - n0
    return got, PD._tail_all_octaves(outs, dogs, shapes, cfg, k_move), launches


def _n_differ(a, b):
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def _assert_tails_equal(got, want):
    """Every counter and every field of every octave bit for bit."""
    (kg, cg), (kw, cw) = got, want
    assert list(cg) == list(cw)
    for key in cw:
        assert same_bits(cg[key], cw[key]), (key, cg[key].tolist(), cw[key].tolist())
    assert len(kg) == len(kw)
    for o, (a, b) in enumerate(zip(kg, kw)):
        for name, x, y in zip(a._fields, a, b):
            assert same_bits(x, y), (o, name, tuple(x.shape), tuple(y.shape),
                                     _n_differ(x, y) if x.shape == y.shape else None)


# --- on the CPU ---------------------------------------------------------------


@pytest.mark.parametrize("cfg", [CFG, LEAN], ids=["full", "lean"])
def test_refine_tail_runs_the_plain_tail_on_the_cpu(cfg):
    """On CPU tensors the wrapper is the plain tail, bit for bit, and
    launches nothing; the kernel's planes and counters name the plain
    tail's fields and keys in order."""
    n0 = LAUNCHES["refine_tail"]
    got, want, launches = _tails(_dogs(_frames(2, 60, 80, "cpu"), cfg), cfg)
    assert launches == 0 and LAUNCHES["refine_tail"] == n0 == 0
    _assert_tails_equal(got, want)
    assert TAIL_FLAGS + TAIL_INTS + TAIL_REALS == PD.OctaveKeypoints._fields
    assert tuple(want[1]) == TAIL_COUNTERS
    assert int(want[1]["n_movers"].sum()) > 0


def test_refine_tail_raises_for_other_devices():
    """A meta tensor is neither the plain route nor the kernel's."""
    dogs = [torch.empty((1, 5, 20, 30), device="meta")]
    with pytest.raises(ValueError, match="refine_tail: unsupported device meta"):
        PD.refine_tail([None], dogs, ((20, 30),), CFG, 256)


@pytest.mark.parametrize("form", ["true, 4", "false, 4", "true, 5"])
def test_refine_tail_kernel_counts_in_its_own_group(form):
    """The kernel's name, as a profiler gives it, counts under
    ("refine_tail",) and under no other group (not as the detection
    kernel)."""
    anon = "(anonymous namespace)::"
    name = f"void {anon}refine_tail_kernel<{form}>({anon}TailLaunch)"
    got = {group: n for group, n in device_launches([name]).items() if n}
    assert got == {("refine_tail",): 1}
    assert KERNEL_GROUPS[r"\brefine_tail_kernel<"] == ("refine_tail",)


# --- on the card --------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_refine_tail_equals_plain_bit_for_bit(cuda_dev, name, b):
    """Noise frames at 480x640 through the card's pyramid and detection:
    the kernel's octave lists and counters equal the plain tail's bit for
    bit, in one launch."""
    cfg = CONFIGS[name]
    got, want, launches = _tails(_dogs(_frames(b, 480, 640, cuda_dev, seed=b), cfg), cfg)
    assert launches == 1
    _assert_tails_equal(got, want)
    ctr = want[1]
    assert int(ctr["n_movers"].min()) > 0 and int(ctr["n_border"].min()) > 100


def _crafted(cfg, dev, p, seed, b=2, shapes=((40, 56), (20, 28), (10, 14), (5, 7), (3, 3))):
    """Noise DoGs and candidates at arbitrary positions (no extrema): the
    Taylor steps there are large and point every way, so most lanes move
    and walk. Besides the draws at rate ``p``, every octave holds
    candidates on each face of the interior: rows 1 and H - 2, scales 1
    and 3 (slots 0 and 1), columns 1 and W - 2 (slots 2 and 3). The full
    form's fields are the plain Taylor step there. Returns the DoGs, the
    candidates and the iteration-1 moves that each face clamps."""
    rng = np.random.default_rng(seed)
    mo = cfg.max_interpolation_offset
    dogs, outs, clamps = [], [], np.zeros(6, np.int64)
    for h, w in shapes:
        rows, cols = h - 2, w - 2
        ok = rng.random((b, 3, rows, 6)) < p
        ok[:, :, [0, -1], 0] = True
        ok[:, [0, -1], :, 1] = True
        ok[:, :, :, 2:4] |= rng.random((b, 3, rows, 2)) < 0.2
        col = rng.integers(0, cols, (b, 3, rows, 6))
        col[..., 2], col[..., 3] = 0, cols - 1
        dog = torch.from_numpy(rng.normal(0, 0.05, (b, 5, h, w)).astype(np.float32)).to(dev)
        ok_t = torch.from_numpy(ok).to(dev)
        idx = torch.from_numpy(np.where(ok, col, 0)).to(dev)
        nb = lambda ds, di, dj: _neighborhood(dog, ds, di, dj)
        oi, oj, os_, val, hii, hjj, hij = taylor_step(nb, nb(0, 0, 0))
        pick = lambda f: torch.where(ok_t, torch.gather(f, -1, idx), torch.zeros((), dtype=f.dtype, device=dev))
        fields = (pick(oi), pick(oj), pick(os_), pick(val))
        counts = lambda: torch.from_numpy(rng.integers(0, 50, b).astype(np.int32)).to(dev)
        outs.append(Candidates(
            cand_col=idx.to(torch.int32), slot_ok=ok_t,
            cand_fields=fields if cfg.detect_slot_fields else None,
            cand_edge=pick(edge_ok(hii, hjj, hij, cfg.edge_threshold)) if cfg.detect_slot_fields else None,
            n_raw=counts(), n_soft=counts(), n_row_dropped=counts(),
        ))
        dogs.append(dog)
        s = torch.arange(1, 4, device=dev)[None, :, None, None]
        i = torch.arange(1, rows + 1, device=dev)[None, None, :, None]
        j = idx + 1
        faces = [(i == 1) & (fields[0] < -mo), (i == rows) & (fields[0] > mo),
                 (j == 1) & (fields[1] < -mo), (j == cols) & (fields[1] > mo),
                 (s == 1) & (fields[2] < -mo), (s == 3) & (fields[2] > mo)]
        clamps += np.array([int((ok_t & f).sum()) for f in faces])
    return dogs, outs, clamps


@pytest.mark.cuda
@pytest.mark.parametrize("lean", [False, True], ids=["full", "lean"])
@pytest.mark.parametrize("case", ["crowded", "faces", "flat"])
def test_refine_tail_edge_cases_equal_plain(cuda_dev, case, lean):
    """Crowded candidates: more movers than the block (it keeps the first
    in lane order, the rest counted as overflow) and, lean, more
    candidates than an octave's budget; candidates on every face of the
    interior, whose moves are clamped there; flat frames (no candidate at
    all). Each equal to the plain tail bit for bit, in one launch."""
    cfg = LEAN if lean else CFG
    outs = None
    if case == "flat":
        dogs = _dogs(torch.full((2, 240, 320), 0.5, device=cuda_dev), cfg)
    else:
        dogs, outs, clamps = _crafted(cfg, cuda_dev, 0.6 if case == "crowded" else 0.1, seed=6)
    shapes = tuple(tuple(d.shape[-2:]) for d in dogs)
    k_move = PD.mover_budget_all(cfg, shapes)
    budgets = [PD.extrema_candidate_budget(cfg, hw) for hw in shapes]
    got, want, launches = _tails(dogs, cfg, outs=outs)
    assert launches == 1
    _assert_tails_equal(got, want)
    ctr = want[1]
    row_drops = sum(out.n_row_dropped for out in outs) if outs else 0
    if case == "crowded":
        assert int(ctr["n_movers"].min()) > k_move
        lean_drops = ctr["overflow"] - row_drops - (ctr["n_movers"] - k_move)
        assert int(lean_drops.min()) > 0 if lean else int(lean_drops.abs().max()) == 0
    elif case == "faces":
        assert (clamps > 0).all(), clamps
        assert all(int(o.slot_ok[f].sum()) <= m for o, m in zip(outs, budgets) for f in range(2))
        assert int(ctr["n_movers"].max()) <= k_move
    else:
        assert int(ctr["n_extrema"].sum()) == 0 and int(ctr["n_movers"].sum()) == 0


def _detection(steps, dogs, cfg):
    return steps.stage(PD.detect_all_octaves_batch, dogs, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [CFG, LEAN], ids=["full", "lean"])
def test_refine_tail_replays_in_a_graph(cuda_dev, cfg):
    """Detection and the tail captured by a GraphCache: each replay equals
    the eager call bit for bit (on a second input too), runs no wrapper,
    and launches the tail kernel once on the device."""
    cache = GraphCache(_detection, "detection")
    dogs = [_dogs(_frames(2, 240, 320, cuda_dev, seed=s), cfg) for s in (7, 8)]
    for d in dogs:
        first = cache(d, cfg)
        _assert_tails_equal(first, cache.eager(d, cfg))
    n0 = dict(LAUNCHES)
    out = {}
    seen = profiled_launches(lambda: out.setdefault("replay", cache(dogs[0], cfg)))
    assert LAUNCHES == n0
    assert seen[("refine_tail",)] == 1
    assert seen[("detect_candidates",) if cfg.detect_slot_fields else ("detect_candidates_lean",)] == 1
    _assert_tails_equal(out["replay"], cache.eager(dogs[0], cfg))
    assert len(cache.graphs) == 1
