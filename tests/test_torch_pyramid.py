"""The port's pyramid (band tables, one-shot octave, fused seed, cascade
blur) held against the JAX package: the Pallas kernels in interpret mode
and the XLA shift-add path, on inputs made from a seed with numpy."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from siftmetal_tpu.config import SiftConfig as JConfig
from siftmetal_tpu.ops import gaussian as JG
from siftmetal_tpu.ops.pallas import pyramid as JP
from siftmetal_tpu_torch.config import SiftConfig
from siftmetal_tpu_torch.ops import gaussian as PG
from siftmetal_tpu_torch.ops.kernels import pyramid as PP
from siftmetal_tpu_torch.ops.kernels.blur import blur_stack

# Keep PyTorch's CPU pool small: the suite runs several test processes
# side by side, and oversubscribed pools slow every one of them down.
torch.set_num_threads(2)

CFG = SiftConfig()
JCFG = JConfig()
RHOS = PP.oneshot_rhos(CFG)


def _dense(mat):
    """Expand a band table back into a dense fp32 [n_out, n_in] matrix."""
    start, taps = PG.band_table(mat)
    out = np.zeros(mat.shape, np.float32)
    for i in range(mat.shape[0]):
        out[i, start[i]:start[i] + taps.shape[1]] = taps[i]
    return out


def test_image_ops_match_jax():
    from siftmetal_tpu.ops import image as JI
    from siftmetal_tpu_torch.ops import image as PI

    rng = np.random.default_rng(2)
    rgb = rng.uniform(0, 1, (2, 9, 7, 4)).astype(np.float32)
    gray = rgb[..., 0]
    np.testing.assert_array_equal(
        PI.rgb_to_gray(torch.from_numpy(rgb)).numpy(), np.asarray(JI.rgb_to_gray(jnp.asarray(rgb)))
    )
    np.testing.assert_array_equal(
        PI.upsample_bilinear_2x(torch.from_numpy(gray)).numpy(),
        np.asarray(JI.upsample_bilinear_2x(jnp.asarray(gray))),
    )
    np.testing.assert_array_equal(
        PI.decimate_2x(torch.from_numpy(gray), (4, 3)).numpy(),
        np.asarray(JI.decimate_2x(jnp.asarray(gray), (4, 3))),
    )
    idx = np.arange(-20, 30)
    np.testing.assert_array_equal(
        PI.symmetrize_index(torch.from_numpy(idx), 7).numpy(),
        np.asarray(JI.symmetrize_index(jnp.asarray(idx), 7)),
    )


@pytest.mark.parametrize("sigma,n", [(RHOS[0], 200), (RHOS[-1], 300),
                                     (RHOS[-1], 15), (1.2489996, 64),
                                     (4.97, 20)])
def test_band_table_rebuilds_band_matrix(sigma, n):
    """Tables rebuild the JAX band matrix, including radius > n."""
    got = _dense(PG.band_matrix(float(sigma), n))
    np.testing.assert_allclose(got, JG._band_matrix(float(sigma), n), atol=1e-7, rtol=0)


@pytest.mark.parametrize("sigma,n", [(1.2489996, 170), (4.9749, 250), (3.0, 21)])
def test_band_table_rebuilds_upsample_blur_matrix(sigma, n):
    got = _dense(PG.upsample_blur_matrix(float(sigma), n))
    np.testing.assert_allclose(
        got, JG._upsample_blur_matrix(float(sigma), n), atol=1e-7, rtol=0
    )


@pytest.mark.parametrize("h", [176, 200, 480])
def test_band_table_rebuilds_y_band_matrices(h):
    """The TPU kernel's per-band Y blocks are windows of the same table."""
    for rho in RHOS:
        dense = _dense(PG.band_matrix(float(rho), h))
        ref = JP._y_band_matrices(float(rho), h)
        n_bands = ref.shape[0]
        hp = PP.BAND * n_bands
        got = np.zeros_like(ref)
        for bd in range(n_bands):
            base = min(max(PP.BAND * bd - PP.HALO, 0), hp - PP.ROWS_IN)
            for v in range(PP.BAND):
                g = PP.BAND * bd + v
                if g < h:
                    row = dense[g, base:base + PP.ROWS_IN]
                    got[bd, : row.shape[0], v] = row
        np.testing.assert_allclose(got, ref, atol=1e-7, rtol=0)


def test_routing_gates_match_jax():
    """The port routes (fused seed / one-shot / cascade) as the JAX
    package's TPU path does, for the same shapes."""
    for dm in (0.5, 1.0):
        pc, jc = SiftConfig(delta_min=dm), JConfig(delta_min=dm)
        for h, w in [(480, 640), (340, 512), (170, 250), (170, 130),
                     (64, 96), (95, 200), (160, 128), (100, 127)]:
            assert PP.seed_supports(pc, h, w) == JP.seed_supports(jc, h, w), (dm, h, w)
    for h in (120, 175, 176, 240, 480, 960):
        assert PP.supports(CFG, h) == JP.supports(JCFG, h)


def test_octave_oneshot_plain_matches_pallas():
    """Plain one-shot octave vs the Pallas kernel in interpret mode
    (bf16x3 on the JAX side, hence 2e-4 as tests/test_pallas.py holds it)."""
    rng = np.random.default_rng(7)
    first = rng.uniform(0, 1, (2, 200, 300)).astype(np.float32)
    jg, jd = JP.octave_oneshot_pallas(jnp.asarray(first), JCFG, interpret=True)
    pg, pd = PP.octave_oneshot(torch.from_numpy(first), CFG)
    assert pg.shape == jg.shape and pd.shape == jd.shape
    assert np.abs(pg.numpy() - np.asarray(jg)).max() < 2e-4
    assert np.abs(pd.numpy() - np.asarray(jd)).max() < 2e-4
    # Against the exact fp32 shift-add one-shot blurs.
    ref = np.stack([first] + [np.asarray(JG.blur(jnp.asarray(first), r)) for r in RHOS], 1)
    assert np.abs(pg.numpy() - ref).max() < 1e-5


@pytest.mark.parametrize("delta_min", [0.5, 1.0])
def test_seed_octave_plain_matches_pallas(delta_min):
    pc, jc = SiftConfig(delta_min=delta_min), JConfig(delta_min=delta_min)
    h, w = 170, 250
    assert PP.seed_supports(pc, h, w)
    rng = np.random.default_rng(11)
    gray = rng.uniform(0, 1, (2, h, w)).astype(np.float32)
    jg, jd = JP.seed_octave_pallas(jnp.asarray(gray), jc, interpret=True)
    pg, pd = PP.seed_octave(torch.from_numpy(gray), pc)
    assert pg.shape == jg.shape and pd.shape == jd.shape
    assert np.abs(pg.numpy() - np.asarray(jg)).max() < 2e-4
    assert np.abs(pd.numpy() - np.asarray(jd)).max() < 2e-4


@pytest.mark.parametrize("shape,sigma", [((96, 128), 1.2489996), ((60, 80), 4.6)])
def test_blur_plain_matches_pallas(shape, sigma):
    from siftmetal_tpu.ops.pallas.blur import blur_pallas

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, shape).astype(np.float32)
    ref = np.asarray(blur_pallas(jnp.asarray(img), sigma, interpret=True))
    got = blur_stack(torch.from_numpy(img), sigma).numpy()
    assert np.abs(ref - got).max() < 1e-6
    # The port's own shift-add reference agrees too.
    assert np.abs(PG.blur(torch.from_numpy(img), sigma).numpy() - got).max() < 1e-6


@pytest.mark.parametrize("o,shape", [(3, (60, 80)), (6, (7, 10))])
def test_cascade_matches_jax(o, shape):
    """Incremental cascade slices vs JAX cascade_slices (XLA shift-add),
    including a top octave whose radii exceed its size."""
    from siftmetal_tpu.sift.pyramid import cascade_slices as j_cascade
    from siftmetal_tpu_torch.sift.pyramid import cascade_slices

    rng = np.random.default_rng(3)
    first = rng.uniform(0, 1, (2,) + shape).astype(np.float32)
    ref = np.stack([np.asarray(a) for a in j_cascade(jnp.asarray(first), o, JCFG)], 1)
    got = torch.stack(cascade_slices(torch.from_numpy(first), o, CFG), 1).numpy()
    assert np.abs(ref - got).max() < 1e-6


def test_seed_image_matches_jax():
    from siftmetal_tpu.sift.pyramid import seed_image as j_seed
    from siftmetal_tpu_torch.sift.pyramid import seed_image

    rng = np.random.default_rng(5)
    gray = rng.uniform(0, 1, (2, 40, 60)).astype(np.float32)
    ref = np.asarray(j_seed(jnp.asarray(gray), JCFG))
    got = seed_image(torch.from_numpy(gray), CFG).numpy()
    assert np.abs(ref - got).max() < 1e-6

