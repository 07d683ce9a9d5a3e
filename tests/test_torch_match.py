"""The port's matcher held against the JAX package's on the same seeded
uint8 descriptor sets: integer-exact distances, index-exact 2-NN, the
blocked route, the ratio sentinel, ties, the guided matcher and the
geometry score. Also the helpers that carry the JAX package's
``Descriptors`` / ``Matches`` tuples (as numpy) into the port's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from siftmetal_tpu.match import matcher as JM
from siftmetal_tpu_torch.match import matcher as PM
from siftmetal_tpu_torch.sift.extract import Descriptors

# Keep PyTorch's CPU pool small: the suite runs several test processes
# side by side, and oversubscribed pools slow every one of them down.
torch.set_num_threads(2)


def to_port_tuple(cls, jax_tuple):
    """A JAX-package NamedTuple (``Descriptors``, ``Matches``, ...) as the
    port's ``cls`` with the same fields, through numpy."""
    return cls(**{
        k: None if v is None else torch.from_numpy(np.array(v))
        for k, v in jax_tuple._asdict().items()
    })


def to_port_descriptors(jax_descriptors) -> Descriptors:
    return to_port_tuple(Descriptors, jax_descriptors)


def to_port_matches(jax_matches) -> PM.Matches:
    return to_port_tuple(PM.Matches, jax_matches)


def assert_matches_equal(got: PM.Matches, ref: PM.Matches):
    """Indices and flags exactly, distances to 1e-6."""
    for name in ("target_idx", "valid", "best_idx", "second_idx"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), getattr(ref, name).numpy(), err_msg=name
        )
        assert getattr(got, name).dtype == getattr(ref, name).dtype, name
    for name in ("distance", "second_distance"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), getattr(ref, name).numpy(), rtol=0, atol=1e-6,
            err_msg=name,
        )


def _sets(seed, q=40, t=70, dup=3):
    """Descriptor-like uint8 sets: targets are sparse-ish random rows,
    queries noisy copies of some targets (so the ratio test passes for
    them) plus unrelated rows; target 3 has ``dup`` copies in all and
    query 1 equals them (an exact tie)."""
    rng = np.random.default_rng(seed)
    tf = (rng.gamma(0.6, 30.0, (t, 128))).clip(0, 255).astype(np.uint8)
    copies = [3, t // 2, t - 1][:dup]
    tf[copies] = tf[3]
    src = rng.integers(0, t, q)
    qf = tf[src].astype(np.int32) + rng.integers(-4, 5, (q, 128))
    qf[::7] = rng.integers(0, 256, (len(qf[::7]), 128))
    qf[min(1, q - 1)] = tf[3]
    qf = qf.clip(0, 255).astype(np.uint8)
    qv = rng.uniform(size=q) > 0.1
    tv = rng.uniform(size=t) > 0.15
    tv[copies] = True
    qv[min(1, q - 1)] = True
    return qf, tf, qv, tv


def _both(fn_name, *arrays, **kw):
    ref = getattr(JM, fn_name)(*(jnp.asarray(a) for a in arrays), **kw)
    got = getattr(PM, fn_name)(*(torch.from_numpy(a) for a in arrays), **kw)
    return got, ref


@pytest.mark.parametrize("seed,q,t", [(0, 40, 70), (1, 1, 5), (2, 33, 129)])
def test_pairwise_sq_dists_u8_integer_exact(seed, q, t):
    qf, tf, _, _ = _sets(seed, q, t)
    got, ref = _both("pairwise_sq_dists_u8", qf, tf)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    want = ((qf[:, None].astype(np.int64) - tf[None].astype(np.int64)) ** 2).sum(-1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pairwise_sq_dists_u8_extremes():
    """All-0 against all-255 rows reach the largest distance exactly."""
    a = np.zeros((2, 128), np.uint8)
    b = np.full((3, 128), 255, np.uint8)
    b[1, ::2] = 0
    got, ref = _both("pairwise_sq_dists_u8", a, b)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(got.max()) == 128 * 255 * 255


def test_pairwise_sq_dists_float_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (20, 128)).astype(np.float32)
    b = rng.uniform(0, 1, (30, 128)).astype(np.float32)
    got, ref = _both("pairwise_sq_dists", a, b)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(
        PM.raw_features(torch.from_numpy((a * 255).astype(np.uint8))).numpy(),
        np.asarray(JM.raw_features(jnp.asarray((a * 255).astype(np.uint8)))),
    )


@pytest.mark.parametrize("ratio", [0.6, 0.8, 1.0, 1.2])
def test_match_bruteforce_matches_jax(ratio):
    """Single-block route; ratio >= 1.0 is the sentinel that turns the
    ratio test off (1.0 and 1.2 give the same result)."""
    qf, tf, qv, tv = _sets(4)
    got, ref = _both("match_bruteforce", qf, tf, qv, tv, ratio_threshold=ratio)
    assert_matches_equal(got, to_port_matches(ref))
    assert int(got.count) == int(ref.count) and int(got.count) > 5
    if ratio >= 1.0:
        off, _ = _both("match_bruteforce", qf, tf, qv, tv, ratio_threshold=1.0)
        assert_matches_equal(got, off)
        # The exact tie (duplicated targets) is accepted only here.
        assert bool(got.valid[1])
    else:
        assert not bool(got.valid[1])


@pytest.mark.parametrize("block", [16, 32, 64])
def test_match_bruteforce_blocked_equals_single(block):
    """T = 70 is no multiple of the block; some targets are invalid; one
    query ties between two targets in different blocks. (With three or
    more equal targets the streaming merge of both packages may name
    another second index than the single-shot route: held against the JAX
    package only.)"""
    qf, tf, qv, tv = _sets(5, dup=2)
    single, _ = _both("match_bruteforce", qf, tf, qv, tv)
    got, ref = _both("match_bruteforce", qf, tf, qv, tv, target_block=block)
    assert_matches_equal(got, to_port_matches(ref))
    assert_matches_equal(got, single)
    qf, tf, qv, tv = _sets(5, dup=3)
    got, ref = _both("match_bruteforce", qf, tf, qv, tv, target_block=block)
    assert_matches_equal(got, to_port_matches(ref))


def test_match_bruteforce_ties_and_empty_rows():
    """Equal distances resolve to the lowest index, as ``jnp.argmin``; a
    target set with no valid entry gives infinite distances, index 0 and
    no match, in the single-shot route and the blocked one alike."""
    rng = np.random.default_rng(6)
    tf = np.repeat(rng.integers(0, 256, (4, 128), dtype=np.uint8), 5, axis=0)   # 5 copies each
    qf = tf[[0, 5, 10, 15, 3]]
    qv = np.ones(5, bool)
    tv = np.ones(20, bool)
    tv[0] = False                                   # lowest copy of row 0 is invalid
    for kw in ({}, {"target_block": 8}):
        got, ref = _both("match_bruteforce", qf, tf, qv, tv, ratio_threshold=1.0, **kw)
        assert_matches_equal(got, to_port_matches(ref))
        np.testing.assert_array_equal(got.best_idx.numpy(), [1, 5, 10, 15, 1])
        if not kw:
            np.testing.assert_array_equal(got.second_idx.numpy(), [2, 6, 11, 16, 2])
    none = np.zeros(20, bool)
    for kw in ({}, {"target_block": 8}):
        got, ref = _both("match_bruteforce", qf, tf, qv, none, **kw)
        assert_matches_equal(got, to_port_matches(ref))
        assert not got.valid.any() and bool(torch.isinf(got.distance).all())


def test_match_bruteforce_float_inputs():
    """Non-uint8 features take the float product, as in the JAX package."""
    qf, tf, qv, tv = _sets(7, dup=1)
    got, ref = _both("match_bruteforce", qf.astype(np.float32), tf.astype(np.float32), qv, tv)
    ref = to_port_matches(ref)
    np.testing.assert_array_equal(got.best_idx.numpy(), ref.best_idx.numpy())
    np.testing.assert_array_equal(got.valid.numpy(), ref.valid.numpy())
    # Squared: the float product cancels to ~1e-6 at an exact match, and
    # the root of that noise is not comparable.
    np.testing.assert_allclose(got.distance.numpy() ** 2, ref.distance.numpy() ** 2, atol=1e-4)


def test_tf32_is_refused(monkeypatch):
    """On a CUDA tensor the exact product refuses TF32; a CPU tensor is
    never affected by the switch."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    a = torch.zeros((2, 128), dtype=torch.uint8)
    assert PM.pairwise_sq_dists_u8(a, a).abs().sum() == 0

    class FakeCuda(torch.Tensor):
        is_cuda = True

    with pytest.raises(RuntimeError, match="allow_tf32"):
        PM._exact_matmul(torch.zeros((2, 4)).as_subclass(FakeCuda), torch.zeros((2, 4)))


@pytest.mark.parametrize("radius", [5.0, 40.0])
def test_match_guided_matches_jax(radius):
    qf, tf, qv, tv = _sets(8)
    rng = np.random.default_rng(9)
    tuv = rng.uniform(0, 100, (70, 2)).astype(np.float32)
    quv = tuv[rng.integers(0, 70, 40)] + rng.normal(0, 2.0, (40, 2)).astype(np.float32)
    got, ref = _both("match_guided", qf, tf, qv, tv, quv, tuv, gate_radius=radius)
    ref = to_port_matches(ref)
    assert_matches_equal(got, ref)


@pytest.mark.parametrize("seed,n_valid", [(10, 60), (11, 12), (12, 5), (13, 200)])
def test_geometry_score_matches_jax(seed, n_valid):
    """A consistent similarity map scores near 1, a scrambled one lower;
    fewer than min_samples windows give 0. Both packages to 1e-5."""
    rng = np.random.default_rng(seed)
    q = 220
    qxy = rng.uniform(0, 400, (q, 2)).astype(np.float32)
    idx = rng.permutation(q).astype(np.int32)
    ang = 0.3
    rot = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]], np.float32)
    txy = np.zeros((q, 2), np.float32)
    txy[idx] = 1.3 * qxy @ rot.T + 5.0
    if seed == 13:
        txy += rng.normal(0, 25.0, txy.shape).astype(np.float32)
    valid = np.zeros(q, bool)
    valid[rng.permutation(q)[:n_valid]] = True
    fields = dict(
        target_idx=np.where(valid, idx, -1).astype(np.int32),
        distance=rng.uniform(0, 1, q).astype(np.float32),
        second_distance=rng.uniform(1, 2, q).astype(np.float32),
        valid=valid, best_idx=idx, second_idx=idx,
    )
    jm = JM.Matches(**{k: jnp.asarray(v) for k, v in fields.items()})
    ref = float(JM.geometry_score(jm, jnp.asarray(qxy), jnp.asarray(txy)))
    got = float(PM.geometry_score(to_port_matches(jm), torch.from_numpy(qxy), torch.from_numpy(txy)))
    assert abs(got - ref) < 1e-5, (got, ref)
    if seed == 10:
        assert got > 0.99
    if n_valid < 10:
        assert got == 0.0


def test_matches_count_and_conversion():
    qf, tf, qv, tv = _sets(14)
    got, ref = _both("match_bruteforce", qf, tf, qv, tv)
    conv = to_port_matches(ref)
    assert conv._fields == got._fields == ref._fields
    assert int(conv.count) == int(ref.count) == int(got.valid.sum())
    assert got.target_idx.dtype == torch.int32 and got.valid.dtype == torch.bool
