"""The tiled band kernel's host tables and the one-launch small-octave
cascade of the port, on the CPU: the tap-block tables and tile windows
against the band tables they come from, the blocks' sum order against the
plain passes, and the cascade and the pyramid against the JAX package."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from siftmetal_tpu.config import FAST_BF16_CONFIG as JFAST16
from siftmetal_tpu.config import SiftConfig as JConfig
from siftmetal_tpu_torch import FAST_BF16_CONFIG
from siftmetal_tpu_torch.config import SiftConfig
from siftmetal_tpu_torch.ops.kernels import pyramid as PP
from siftmetal_tpu_torch.ops.kernels.blur import blur_cascade, blur_cascade_plain, blur_tables
from siftmetal_tpu_torch.sift.batched import build_pyramid_batch
from siftmetal_tpu_torch.sift.pyramid import cascade_slices

from test_torch_fast import _assert_bf16_close, _bf16_round

# Keep PyTorch's CPU pool small: the suite runs several test processes
# side by side, and oversubscribed pools slow every one of them down.
torch.set_num_threads(2)

CFG = SiftConfig()
JCFG = JConfig()


def _tables(kind, h, w):
    if kind == "seed0.5":
        return PP.seed_tables(SiftConfig(delta_min=0.5), h, w)
    if kind == "seed1.0":
        return PP.seed_tables(SiftConfig(delta_min=1.0), h, w)
    if kind == "oneshot":
        return PP.oneshot_tables(CFG, h, w)
    return blur_tables(4.6 if min(h, w) < 20 else 3.0901, h, w)


@pytest.mark.parametrize("shape", [(480, 640), (170, 250), (7, 10)])
@pytest.mark.parametrize("kind", ["seed0.5", "seed1.0", "oneshot", "blur"])
def test_tile_windows_cover_every_tap(kind, shape):
    """Every tap of every output lies in its block's reach, which lies in
    its tile's window inside the input; the block taps are the table's
    taps, exactly, at the right offsets and zero elsewhere; the arrays are
    C-ordered as the kernel indexes them."""
    for tab, tile in zip(_tables(kind, *shape), (PP.TILE_COLS, PP.TILE_ROWS)):
        tp = PP.tile_pass(tab, tile)
        for a, dt in ((tp.base, np.int32), (tp.span, np.int32), (tp.win, np.int32),
                      (tp.taps, np.float32)):
            assert a.dtype == dt and a.flags["C_CONTIGUOUS"]
        n_s, n_out = tab.start.shape
        i = np.arange(n_out)
        g, p, t = i // PP.TAP_BLOCK, i % PP.TAP_BLOCK, i // tile
        assert tp.win.shape[1] == -(-n_out // tile)
        assert (tp.win[..., 0] >= 0).all() and (tp.win[..., 1] <= tab.n_in).all()
        for s in range(n_s):
            k = int(tab.ks[s])
            d = tab.start[s] - tp.base[s, g]
            assert (d >= 0).all() and (d + k <= tp.span[s, g]).all()
            assert (tp.base[s, g] >= tp.win[s, t, 0]).all()
            assert (tp.base[s, g] + tp.span[s, g] <= tp.win[s, t, 1]).all()
            want = np.zeros((n_out, tp.taps.shape[2]), np.float32)
            want[i[:, None], d[:, None] + np.arange(k)] = tab.taps[s, :k].T
            np.testing.assert_array_equal(tp.taps[s, g, :, p], want)
            # Padded outputs past n_out carry no taps.
            pad = np.arange(n_out, tp.base.shape[1] * PP.TAP_BLOCK)
            assert not tp.taps[s, pad // PP.TAP_BLOCK, :, pad % PP.TAP_BLOCK].any()


def _tiled_pass(x, tab, tile):
    """The kernel's per-block sums on [B, R, n_in] rows, in PyTorch: acc of
    each output over m in order, every product and sum rounded on its own
    (the plain passes' arithmetic)."""
    tp = PP.tile_pass(tab, tile)
    n_out, n_in = tab.start.shape[1], tab.n_in
    outs = []
    for s in range(tab.start.shape[0]):
        m = np.arange(tp.taps.shape[2])
        idx = torch.from_numpy(np.minimum(tp.base[s][:, None] + m, n_in - 1)).long()
        xs = x[..., idx]                                   # [B, R, nb, kp]
        taps = torch.from_numpy(tp.taps[s])                # [nb, kp, P]
        acc = torch.zeros(xs.shape[:-1] + (PP.TAP_BLOCK,))
        for k in range(taps.shape[1]):
            acc = acc + taps[:, k, :] * xs[..., k, None]
        outs.append(acc.reshape(x.shape[:-1] + (-1,))[..., :n_out])
    return torch.stack(outs, 1)


@pytest.mark.parametrize("kind,shape", [("seed0.5", (45, 70)), ("seed1.0", (170, 250)),
                                        ("oneshot", (60, 80)), ("blur", (7, 10))])
def test_tap_blocks_sum_in_table_order(kind, shape):
    """A block's zero taps before and after an output's own leave its sum
    as the table's, tap 0 first: with separate roundings the block sums
    equal the plain X pass bit for bit (the kernels' fp32 passes contract
    the same terms in the same order)."""
    rng = np.random.default_rng(21)
    tab_x, tab_y = _tables(kind, *shape)
    x = torch.from_numpy(rng.uniform(-1, 1, (2,) + shape).astype(np.float32))
    assert torch.equal(_tiled_pass(x, tab_x, PP.TILE_COLS), PP.band_x_plain(x, tab_x))
    xt = x.transpose(1, 2).contiguous()
    assert torch.equal(_tiled_pass(xt, tab_y, PP.TILE_ROWS), PP.band_x_plain(xt, tab_y))


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
