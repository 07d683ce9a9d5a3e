"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card and nvcc; elsewhere they skip. They import
no JAX, so on a machine without it they run as

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from siftmetal_tpu_torch.config import SiftConfig
from siftmetal_tpu_torch.ops import gaussian as PG
from siftmetal_tpu_torch.ops.kernels import LAUNCHES
from siftmetal_tpu_torch.ops.kernels import pyramid as PP
from siftmetal_tpu_torch.ops.kernels.blur import blur_stack
from siftmetal_tpu_torch.ops.kernels.detect import (
    detect_candidates,
    detect_candidates_plain,
)
from siftmetal_tpu_torch.ops.kernels.patches import (
    descriptor_lanes,
    orientation_hist_lanes,
    prepare_patch_fields,
)
from siftmetal_tpu_torch.sift import describe as PDS

CFG = SiftConfig()


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (held on the H100 by chip_smoke.py)")
    return torch.device("cuda")


def _t(a, dev):
    return torch.tensor(np.array(a)).to(dev)


@pytest.mark.cuda
def test_pyramid_kernels_match_plain(cuda_dev):
    """Band kernels vs their plain versions (1e-5: FMA contraction and
    fp32 sums in another order)."""
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
