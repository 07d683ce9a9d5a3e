"""The port's detection (plain detection kernel, cross-octave tail,
compaction) held against the JAX package's Pallas kernel in interpret
mode and its kernel-fed tail, on synthetic DoGs made with numpy and on
the DoGs of butterfly crops."""

import pathlib

import numpy as np
import torch

import jax.numpy as jnp

from siftmetal_tpu.config import SiftConfig as JConfig
from siftmetal_tpu_torch.config import SiftConfig
from siftmetal_tpu_torch.ops.kernels.detect import detect_candidates
from siftmetal_tpu_torch.sift import detect as PD

# Keep PyTorch's CPU pool small: the suite runs several test processes
# side by side, and oversubscribed pools slow every one of them down.
torch.set_num_threads(2)

THR = 0.8 * 0.0133
FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"


def _blocky_dogs(seed, b=2, s=5, h=70, w=150):
    """Smooth-ish blocks plus noise (tests/test_pallas.py's field): dense
    enough to overflow some rows' slots."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1, 1, (b, s, h // 5 + 2, w // 5 + 2))
    dog = np.stack([
        [np.kron(base[bb, ss], np.ones((5, 5)))[:h, :w] for ss in range(s)]
        for bb in range(b)
    ]).astype(np.float32)
    dog += rng.normal(0, 0.05, dog.shape).astype(np.float32)
    return dog


def _butterfly_dogs(b=2):
    """Real DoG stacks of two 64x96 butterfly crops (the port's fp32
    cascade; natural content makes refinement movers)."""
    from siftmetal_tpu_torch.sift.batched import build_pyramid_batch
    from siftmetal_tpu_torch.utils.io import load_image

    img = load_image(str(FIXTURES / "butterfly.ppm"))
    gray = img[..., :3] @ np.array([0.212639005871510, 0.715168678767756,
                                    0.072192315360734], np.float32)
    crops = np.stack([gray[:64, :96], gray[150:214, 300:396]][:b]).astype(np.float32)
    cfg = SiftConfig()
    _, dogs = build_pyramid_batch(torch.from_numpy(crops), cfg, cfg.num_octaves(64, 96))
    return [d.numpy() for d in dogs]


def test_detect_plain_matches_pallas():
    """Same slot sets, fields, edge flags and counters as the Pallas
    kernel (its rows past H-2 are tile padding and are cropped)."""
    from siftmetal_tpu.ops.pallas.detect import detect_candidates_pallas

    dog = _blocky_dogs(7)
    h = dog.shape[2]
    (jc, jok, jf, je, jraw, jsoft, jdrop) = detect_candidates_pallas(
        jnp.asarray(dog), THR, 10.0, tile_h=16, interpret=True
    )
    got = detect_candidates(torch.from_numpy(dog), THR, 10.0)
    crop = lambda a: np.asarray(a)[:, :, : h - 2]
    ok = crop(jok)
    np.testing.assert_array_equal(got.slot_ok.numpy(), ok)
    np.testing.assert_array_equal(got.cand_col.numpy(), np.where(ok, crop(jc), 0))
    np.testing.assert_array_equal(got.cand_edge.numpy(), crop(je) & ok)
    # The Taylor step agrees to fp32 rounding (XLA may fuse multiply-adds;
    # the step divides by a near-cancelling Hessian determinant).
    for g, r in zip(got.cand_fields, jf):
        np.testing.assert_allclose(
            g.numpy(), np.where(ok, crop(r), 0.0), rtol=1e-4, atol=1e-6
        )
    np.testing.assert_array_equal(got.n_raw.numpy(), np.asarray(jraw))
    np.testing.assert_array_equal(got.n_soft.numpy(), np.asarray(jsoft))
    np.testing.assert_array_equal(got.n_row_dropped.numpy(), np.asarray(jdrop))
    assert int(got.n_row_dropped.sum()) > 0  # the overflow path is exercised


def test_compact_indices_matches_jax():
    from siftmetal_tpu.sift.detect import compact_indices as j_compact

    rng = np.random.default_rng(2)
    for density in (0.05, 0.5, 1.0):
        v = rng.random((3, 500)) < density
        for size in (16, 300, 600):
            got = PD.compact_indices(torch.from_numpy(v), size)
            for bb in range(3):
                ref = j_compact(jnp.asarray(v[bb]), size)
                for g, r in zip(got, ref):
                    np.testing.assert_array_equal(g[bb].numpy(), np.asarray(r))


def test_detect_all_octaves_matches_jax_kernel_path(monkeypatch):
    """The port's kernel-fed cross-octave tail vs the JAX package's (its
    Pallas branch forced on the CPU with the kernel in interpret mode):
    equal counters and equal accepted keypoint sets per octave."""
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
    jcfg, pcfg = JConfig(), SiftConfig()
    j_kp, j_ctr = JD.detect_all_octaves_batch([jnp.asarray(d) for d in dogs], jcfg)
    p_kp, p_ctr = PD.detect_all_octaves_batch([torch.from_numpy(d) for d in dogs], pcfg)

    for key in j_ctr:
        np.testing.assert_array_equal(p_ctr[key].numpy(), np.asarray(j_ctr[key]), err_msg=key)
    assert int(p_ctr["n_movers"].sum()) > 0  # the mover walk is exercised

    def accepted(kp, bb, np_):
        sel = np_(kp.pass_border[bb]) & np_(kp.cand_valid[bb])
        rows = zip(
            np_(kp.scale[bb])[sel], np_(kp.i[bb])[sel], np_(kp.j[bb])[sel],
            np.round(np_(kp.x[bb])[sel], 4), np.round(np_(kp.y[bb])[sel], 4),
            np.round(np_(kp.sigma[bb])[sel], 4),
        )
        return {tuple(float(v) for v in t) for t in rows}

    n_acc = 0
    for o in range(len(dogs)):
        for bb in range(b):
            want = accepted(j_kp[o], bb, np.asarray)
            got = accepted(p_kp[o], bb, lambda t: t.numpy())
            assert got == want, (o, bb)
            n_acc += len(want)
    assert n_acc > 20

