"""A run whose timed path is broken underneath reads ``correct`` false,
once for each fault its cell can have; the sound run reads true. The
harness's look for a card is skipped (CPU, small cells)."""

import random
import time

import pytest
import torch

from portbench import run as bench_run
from portbench.harness import pairs as P
from portbench.harness.extract import sample_frames
from portbench.tests.conftest import cells_of_kind, small_cell

SEED = 2 ** 31 + 7


def _extract_run(name, monkeypatch, fault):
    from siftmetal_tpu_torch.sift.extract import SIFT

    sound = SIFT._run
    prev = {}

    def broken(self, grays):
        kps, descs, counters = sound(self, grays)
        return fault(kps, descs, counters, prev)

    if fault is not None:
        monkeypatch.setattr(SIFT, "_run", broken)
    # As few sampled frames as a batch has positions: the draw covers each.
    cell = small_cell(name)
    cell = small_cell(name, check_frames=max(int(cell.traffic["batch"]), 2))
    fields, _ = bench_run.run(name, SEED, 0.3, False, device="cpu", cell=cell,
                              t_start=time.perf_counter())
    return fields["correct"]


def _half_batch(kps, descs, counters, prev):
    # Only the first half of the batch computed, its results stood in for the rest.
    half = lambda t: torch.cat([t[: (t.shape[0] + 1) // 2]] * 2)[: t.shape[0]]
    if kps.valid.shape[0] == 1:
        return kps, descs._replace(valid=torch.zeros_like(descs.valid)), counters
    return (type(kps)(*map(half, kps)), type(descs)(*map(half, descs)),
            {k: half(v) for k, v in counters.items()})


def _altered(kps, descs, counters, prev):
    # The last frame's descriptors altered where they are produced.
    f = descs.features.clone()
    f[-1] = (f[-1].int() + 8).clamp(max=255).to(torch.uint8)
    return kps, descs._replace(features=f), counters


def _counters(kps, descs, counters, prev):
    # The soft extrema counted twice, the outputs right.
    return kps, descs, dict(counters, n_soft=counters["n_soft"] * 2)


def _unchanged(kps, descs, counters, prev):
    # Each call hands back the previous call's results.
    out = prev.get("last", (kps, descs, counters))
    prev["last"] = (kps, descs, counters)
    return out


@pytest.mark.parametrize("name", cells_of_kind("extract"))
def test_extract_sound_run_is_correct(name, monkeypatch):
    assert _extract_run(name, monkeypatch, None) is True


@pytest.mark.parametrize("fault", [_half_batch, _altered, _counters, _unchanged], ids=lambda f: f.__name__[1:])
@pytest.mark.parametrize("name", cells_of_kind("extract"))
def test_extract_fault_is_caught(name, fault, monkeypatch):
    assert _extract_run(name, monkeypatch, fault) is False


class _Broken(P.PortVerifier):
    def __init__(self, traffic, fault):
        super().__init__(traffic)
        self.fault, self.last = fault, None

    def __call__(self, qf, tf, qv, tv, qxy, txy, gen, events=None):
        if self.fault == "half":
            # Every other query row left out (the valid rows lead the padded set).
            qv = qv & (torch.arange(qv.shape[0]) % 2 == 0)
        out = super().__call__(qf, tf, qv, tv, qxy, txy, gen, events)
        if self.fault == "altered":
            model = out[1].clone()
            model[0, 2] += 2.0
            tgt = out[0].clone()
            tgt[0] = tgt[0] + 1
            return tgt, model, out[2]
        if self.fault == "unchanged":
            last, self.last = self.last, out
            return last or out
        if self.fault in ("reject", "accept"):
            # The matches and the model right, the decision wrong.
            return out[0], out[1], torch.tensor(0 if self.fault == "reject" else 10 ** 6)
        return out


def _pairs_run(fault):
    name = "ipol_vga.pairs"
    cell = small_cell(name, accept_min_inliers=8, check_pairs=20)
    verifier = None if fault is None else _Broken(cell.traffic, fault)
    fields, _ = bench_run.run(name, SEED, 0.5, False, device="cpu", cell=cell,
                              t_start=time.perf_counter(), verifier=verifier)
    return fields["correct"]


def test_pairs_sound_run_is_correct():
    assert _pairs_run(None) is True


@pytest.mark.parametrize("fault", ["half", "altered", "unchanged", "reject", "accept"])
def test_pairs_fault_is_caught(fault):
    assert _pairs_run(fault) is False


@pytest.mark.parametrize("seed", range(20))
def test_sample_covers_every_position(seed):
    picks = sample_frames(random.Random(seed), 64, 8, 8)
    assert len(set(picks)) == 8 and sorted(f % 8 for f in picks) == list(range(8))
    assert len(set(sample_frames(random.Random(seed), 64, 1, 8))) == 8
