"""The tiled band kernel's host tables and the one-launch small-octave
cascade of the port, on the CPU: the slices' taps and the tiles' windows,
a tile-by-tile model of the kernel's indexing against the plain passes,
and the cascade and the pyramid against the JAX package."""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from siftmetal_tpu.config import FAST_BF16_CONFIG as JFAST16
from siftmetal_tpu.config import SiftConfig as JConfig
from siftmetal_tpu_torch import FAST_BF16_CONFIG
from siftmetal_tpu_torch.config import SiftConfig
from siftmetal_tpu_torch.ops import image as PI
from siftmetal_tpu_torch.ops.gaussian import gaussian_taps
from siftmetal_tpu_torch.ops.kernels import pyramid as PP
from siftmetal_tpu_torch.ops.kernels.blur import blur_cascade, blur_cascade_plain
from siftmetal_tpu_torch.sift.batched import build_pyramid_batch
from siftmetal_tpu_torch.sift.pyramid import cascade_slices

from test_torch_fast import _assert_bf16_close, _bf16_round

# Keep PyTorch's CPU pool small: the suite runs several test processes
# side by side, and oversubscribed pools slow every one of them down.
torch.set_num_threads(2)

CFG = SiftConfig()
JCFG = JConfig()


def _launch(kind, h, w):
    """(sigmas, upsample) of one band launch."""
    if kind == "seed0.5":
        return PP._seed_sigmas(SiftConfig(delta_min=0.5)), True
    if kind == "seed1.0":
        return PP._seed_sigmas(SiftConfig(delta_min=1.0)), False
    if kind == "oneshot":
        return PP.oneshot_rhos(CFG), False
    return (4.6 if min(h, w) < 20 else 3.0901,), False


TILE = 64                  # csrc/pyramid.cu kTile
SMEM_BYTES = 232448        # shared memory a block may take on an H100


def _reflect(i, n):
    m = np.mod(i, 2 * n)
    return np.where(m < n, m, 2 * n - 1 - m)


@pytest.mark.parametrize("shape", [(480, 640), (170, 250), (7, 10)])
@pytest.mark.parametrize("kind", ["seed0.5", "seed1.0", "oneshot", "blur"])
def test_tile_windows_cover_every_tap(kind, shape):
    """Every slice's taps are its sigma's unfolded Gaussian taps, tap 0
    first, zero past 2 r + 1, in the C layout the kernel reads; the launch
    table carries them with the slice count, the taps a slice and the
    largest radius; every tile's window (the tile and that radius on each
    side, in padded coordinates) reads through the reflection inside the
    input (or its upsample), a radius above the size included; and the
    block's shared memory (taps, X buffer, window) fits the card."""
    sigmas, up = _launch(kind, *shape)
    tab = PP.slice_taps(tuple(sigmas))
    assert tab.taps.dtype == np.float32 and tab.radius.dtype == np.int32
    assert tab.taps.flags["C_CONTIGUOUS"] and tab.taps.shape[0] == len(sigmas)
    for s, sg in enumerate(sigmas):
        want = gaussian_taps(float(sg))
        r = int(tab.radius[s])
        assert len(want) == 2 * r + 1
        np.testing.assert_array_equal(tab.taps[s, : 2 * r + 1], want)
        assert not tab.taps[s, 2 * r + 1:].any()
    table = PP.launch_table(tuple(sigmas), torch.device("cpu"))
    words = np.ctypeslib.as_array((ctypes.c_int64 * 5).from_address(table))
    big = int(tab.radius.max())
    assert list(words[2:]) == [len(sigmas), tab.taps.shape[1], big]
    h, w = (2 * shape[0], 2 * shape[1]) if up else shape
    for n_out in (h, w):
        for t0 in range(0, n_out, TILE):
            idx = _reflect(np.arange(t0 - big, t0 + TILE + big), n_out)
            assert idx.min() >= 0 and idx.max() < n_out
    n = TILE + 2 * big
    floats = (len(sigmas) * tab.taps.shape[1] + 3) // 4 * 4 + n * (TILE + 1) + n * (n | 1)
    assert 4 * floats <= SMEM_BYTES // 2, "two blocks an SM"


def _tile_model(x, sigmas, up):
    """band_tile's indexing in PyTorch, tile by tile: the tile's window
    (R, the largest radius, on every side; each sample read through the
    reflection from the input or its 2x upsample), slice s's X pass at
    window rows R - r + row and columns R - r + j + k, its Y pass at X
    rows i + k; every product and sum rounded on its own, tap 0 first."""
    tab = PP.slice_taps(tuple(sigmas))
    src = PI.upsample_bilinear_2x(x.float()) if up else x.float()
    b, h, w = src.shape
    big = int(tab.radius.max())
    n = TILE + 2 * big
    out = torch.zeros((b, len(sigmas), -(-h // TILE) * TILE, -(-w // TILE) * TILE))
    for i0 in range(0, h, TILE):
        for j0 in range(0, w, TILE):
            rows = torch.from_numpy(_reflect(np.arange(i0 - big, i0 - big + n), h))
            cols = torch.from_numpy(_reflect(np.arange(j0 - big, j0 - big + n), w))
            win = src.index_select(1, rows).index_select(2, cols)
            for s in range(len(sigmas)):
                r = int(tab.radius[s])
                t = tab.taps[s]
                xb = None
                for k in range(2 * r + 1):
                    term = float(t[k]) * win[:, big - r:big + TILE + r, big - r + k:big - r + k + TILE]
                    xb = term if xb is None else xb + term
                y = None
                for k in range(2 * r + 1):
                    term = float(t[k]) * xb[:, k:k + TILE]
                    y = term if y is None else y + term
                out[:, s, i0:i0 + TILE, j0:j0 + TILE] = y
    return out[:, :, :h, :w]


@pytest.mark.parametrize("kind,shape", [("seed0.5", (45, 70)), ("seed1.0", (170, 250)),
                                        ("oneshot", (60, 80)), ("blur", (7, 10))])
def test_tap_blocks_sum_in_table_order(kind, shape):
    """The kernel's window offsets, reflection and upsample, tile by tile,
    give the plain passes bit for bit (with separate roundings; the
    kernels' fp32 passes contract the same terms in the same order)."""
    rng = np.random.default_rng(21)
    sigmas, up = _launch(kind, *shape)
    x = torch.from_numpy(rng.uniform(-1, 1, (2,) + shape).astype(np.float32))
    got = _tile_model(x, sigmas, up)
    assert torch.equal(got, PP.bands_plain(x, sigmas, None, False, upsample=up)[0])


@pytest.mark.parametrize("shape", [(60, 80), (7, 10)])
@pytest.mark.parametrize("bf16", [False, True])
def test_blur_cascade_matches_jax(bf16, shape):
    """The one-launch cascade's plain route against the JAX package's
    cascade_slices + stack + DoG (fp32: the XLA shift-add path to 1e-6, as
    tests/test_torch_pyramid.py holds it; bf16 chain: as
    tests/test_torch_fast.py holds it), and on the CPU equal bit for bit to
    the port's per-stage route."""
    from siftmetal_tpu.sift.pyramid import cascade_slices as j_cascade

    rng = np.random.default_rng(3)
    first = rng.uniform(0, 1, (2,) + shape).astype(np.float32)
    if bf16:
        first = _bf16_round(first)
    cfg, jcfg, o = (FAST_BF16_CONFIG, JFAST16, 4) if bf16 else (CFG, JCFG, 3)
    jfirst = jnp.asarray(first).astype(jnp.bfloat16) if bf16 else jnp.asarray(first)
    ref = np.stack([np.asarray(a) for a in j_cascade(jfirst, o, jcfg)], 1)
    t = torch.from_numpy(first)
    t = t.to(torch.bfloat16) if bf16 else t
    g, d = blur_cascade(t, cfg.incremental_sigmas(o), bf16)
    assert g.dtype == d.dtype == torch.float32 and tuple(g.shape) == ref.shape
    if bf16:
        _assert_bf16_close(g.numpy(), ref, "gauss")
        _assert_bf16_close(d.numpy(), ref[:, 1:] - ref[:, :-1], "dog")
    else:
        assert np.abs(g.numpy() - ref).max() < 1e-6
        assert np.abs(d.numpy() - (ref[:, 1:] - ref[:, :-1])).max() < 1e-6
    per_step = torch.stack(cascade_slices(t, o, cfg), 1)
    assert torch.equal(g, per_step)
    assert torch.equal(d, per_step[:, 1:] - per_step[:, :-1])
    # An fp32 first slice in the bf16 chain: read rounded, kept unrounded.
    if bf16:
        f32 = torch.from_numpy(rng.uniform(0, 1, (1,) + shape).astype(np.float32))
        g2, _ = blur_cascade_plain(f32, cfg.incremental_sigmas(o), True)
        assert torch.equal(g2[:, 0], f32)
        assert torch.equal(g2, torch.stack(cascade_slices(f32, o, cfg), 1))


@pytest.mark.parametrize("cfg,jcfg,tol", [
    (SiftConfig(use_oneshot_pyramid=False), JConfig(use_oneshot_pyramid=False), 1e-5),
    (SiftConfig(), JConfig(), 1e-4),
])
def test_build_pyramid_batch_matches_jax(cfg, jcfg, tol):
    """The port's pyramid on the CPU against the JAX package's (which runs
    seed blur + cascade in every octave on the CPU): the same route to
    1e-5, and the fused-seed / one-shot route to 1e-4 (a one-shot slice is
    one sampled Gaussian where the cascade composes several)."""
    from siftmetal_tpu.sift.batched import build_pyramid_batch as j_build

    rng = np.random.default_rng(17)
    gray = rng.uniform(0, 1, (1, 180, 128)).astype(np.float32)
    n_oct = cfg.num_octaves(180, 128)
    jg, jd = j_build(jnp.asarray(gray), jcfg, n_oct)
    pg, pd = build_pyramid_batch(torch.from_numpy(gray), cfg, n_oct)
    assert len(pg) == len(jg) == n_oct
    for o in range(n_oct):
        assert tuple(pg[o].shape) == jg[o].shape and tuple(pd[o].shape) == jd[o].shape
        assert np.abs(pg[o].numpy() - np.asarray(jg[o])).max() <= tol, o
        assert np.abs(pd[o].numpy() - np.asarray(jd[o])).max() <= 2 * tol, o
