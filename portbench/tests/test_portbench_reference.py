"""The plain reference computes what the port's plain CPU route computes,
bit for bit at a small size, and refuses routes it does not cover."""

import dataclasses

import pytest
import torch

from portbench.harness.frames import procedural_frames
from portbench.reference import sift as ref_sift
from portbench.reference import verify as ref_verify


def test_reference_extraction_equals_the_port_on_the_cpu():
    from siftmetal_tpu_torch import SIFT, SiftConfig

    cfg = SiftConfig(max_keypoints=512, max_descriptors=768)
    frames = procedural_frames(2, 96, 128, 2 ** 31 + 9, "cpu")
    kps, descs, counters = SIFT(96, 128, config=cfg, device="cpu").extract_batch(frames)
    p = ref_sift.Params.from_dict(dataclasses.asdict(cfg))
    rk, rd, rc = ref_sift.extract(frames, p, p.num_octaves(96, 128))
    for f in ("valid", "octave", "x", "y", "sigma"):
        assert torch.equal(getattr(kps, f), rk[f]), f
    for f in ("valid", "octave", "x", "y", "sigma", "theta", "features"):
        assert torch.equal(getattr(descs, f), rd[f]), f
    assert {k: v.tolist() for k, v in counters.items()} == {k: rc[k].tolist() for k in counters}


@pytest.mark.parametrize("key, value", [("pyramid_dtype", "bfloat16"), ("use_fused_describe", True),
                                        ("use_pallas_pyramid", True)])
def test_reference_refuses_routes_it_does_not_compute(key, value):
    with pytest.raises(ValueError):
        ref_sift.Params.from_dict({key: value})


def test_reference_verification_equals_the_port_on_the_cpu():
    from siftmetal_tpu_torch.geometry import find_homography
    from siftmetal_tpu_torch.match import match_bruteforce

    g = torch.Generator().manual_seed(3)
    n = 300
    qf = torch.randint(0, 256, (n, 128), generator=g, dtype=torch.uint8)
    perm = torch.randperm(n, generator=g)
    tf = qf[perm].clone()
    tf[:40] = torch.randint(0, 256, (40, 128), generator=g, dtype=torch.uint8)
    qxy = torch.rand((n, 2), generator=g) * 400
    h = torch.tensor([[0.9, -0.1, 20.0], [0.1, 0.95, -10.0], [1e-4, 0.0, 1.0]])
    p = torch.cat([qxy, torch.ones(n, 1)], 1) @ h.T
    txy = torch.empty_like(qxy)
    txy[torch.argsort(perm)] = p[:, :2] / p[:, 2:]
    qv = tv = torch.ones(n, dtype=torch.bool)
    m = match_bruteforce(qf, tf, qv, tv, 1.176, 0.6)
    gen = torch.Generator().manual_seed(77)
    r = find_homography(gen, qxy, txy[m.target_idx.clamp(min=0).long()], m.valid, 128, 3.0)
    v = ref_verify.verify(qf, tf, qv, tv, qxy, txy, torch.Generator().manual_seed(77),
                          (1.176, 0.6), 128, 3.0)
    assert torch.equal(m.target_idx.long(), v.target_idx)
    assert int(r.n_inliers) == v.n_inliers > 200
    assert ref_verify.corner_gap(r.model, v.model, 480, 640) < 1e-3
