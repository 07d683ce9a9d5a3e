"""The port's multi-device layer (``siftmetal_tpu_torch/parallel/``) on the
CPU: four gloo ranks, each a process of tests/torch_parallel_worker.py,
started once for the module. Their results are held against the port's
one-device functions and against the JAX package's SPMD functions on the
8-device CPU mesh, on the inputs of tests/test_parallel.py."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from siftmetal_tpu.config import SiftConfig as JConfig
from siftmetal_tpu.parallel import distributed_ba as JD
from siftmetal_tpu.parallel import extraction as JE
from siftmetal_tpu.slam.ba import BAProblem as JProblem
from siftmetal_tpu.slam.camera import project as jproject
from siftmetal_tpu_torch import SIFT, SiftConfig
from siftmetal_tpu_torch.match import match_bruteforce
from siftmetal_tpu_torch.parallel import multihost
from siftmetal_tpu_torch.slam.ba import BAProblem, bundle_adjust

torch.set_num_threads(2)

WORLD = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = SiftConfig(max_extrema_per_octave=512, max_keypoints=256, max_descriptors=512)
JCFG = JConfig(max_extrema_per_octave=512, max_keypoints=256, max_descriptors=512)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ba_inputs():
    """tests/test_parallel.py's BA problem: 5 cameras (2 fixed) each seeing
    all 256 landmarks, noisy start."""
    rng = np.random.default_rng(42)
    n_cam, n_lm = 5, 256
    k = np.array([[400, 0, 320], [0, 400, 240], [0, 0, 1]], dtype=np.float32)
    lms = rng.uniform([-3, -3, 6], [3, 3, 12], (n_lm, 3)).astype(np.float32)
    cams = np.zeros((n_cam, 6), dtype=np.float32)
    cams[:, 3] = np.linspace(-1, 1, n_cam)
    cam_idx = np.repeat(np.arange(n_cam), n_lm).astype(np.int32)
    lm_idx = np.tile(np.arange(n_lm), n_cam).astype(np.int32)
    uv = np.asarray(jax.vmap(lambda c, l: jproject(jnp.asarray(cams)[c], jnp.asarray(k),
                                                   jnp.asarray(lms)[l]))(cam_idx, lm_idx))
    noisy_cams = cams + rng.normal(0, 0.01, cams.shape).astype(np.float32)
    noisy_cams[:2] = cams[:2]
    noisy_lms = lms + rng.normal(0, 0.05, lms.shape).astype(np.float32)
    return dict(ba_cams=noisy_cams, ba_lms=noisy_lms, ba_k=k, ba_cam_idx=cam_idx,
                ba_lm_idx=lm_idx, ba_uv=uv.astype(np.float32), ba_valid=np.ones(len(uv), bool))


@pytest.fixture(scope="module")
def inputs(butterfly):
    # tests/test_parallel.py's 8 distinct crops of the butterfly image.
    crops = [
        np.asarray(butterfly[i * 8: i * 8 + 96, i * 16: i * 16 + 128, :3])
        @ np.array([0.2126, 0.7152, 0.0722], dtype=np.float32)
        for i in range(8)
    ]
    return dict(frames=np.stack(crops).astype(np.float32), **_ba_inputs())


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Start the four ranks once; returns each rank's outputs (dicts)."""
    d = tmp_path_factory.mktemp("ranks")
    np.savez(d / "inputs.npz", **inputs)
    port = _free_port()
    worker = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(WORLD), RANK=str(r), LOCAL_RANK=str(r), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, worker, str(d / "inputs.npz"), str(d)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log}"
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


def _fields(out, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in out.items() if k.startswith(prefix + ".")}


def test_every_rank_returns_the_same_global_result(ranks):
    """Every rank holds the whole batch's outputs, the whole match set and
    the same BA state, bit for bit (the all-gathers and all-reduces)."""
    for r in range(1, WORLD):
        for key, v in ranks[0].items():
            if key != "rank":
                np.testing.assert_array_equal(ranks[r][key], v, err_msg=f"rank {r} {key}")
    assert [int(o["rank"]) for o in ranks] == list(range(WORLD))


def test_barrier_counts_every_rank_and_elastic_loop_recovers(ranks):
    """tests/multiprocess_worker.py's bars: the barrier's all-reduce equals
    the global device count, and the elastic loop with one injected
    failure (on rank 0, with a collective in every step) reaches step 5."""
    for o in ranks:
        assert int(o["world"]) == WORLD
        assert float(o["barrier"]) == WORLD and float(o["barrier_end"]) == WORLD
        assert int(o["elastic.step"]) == 5 and int(o["elastic.state"]) == 5


@pytest.mark.parametrize("frame", [3, 6])
def test_sharded_extraction_equals_one_frame_extract(ranks, inputs, frame):
    """tests/test_parallel.py's bar, for a frame on rank 1 and one on rank
    3: every field of the sharded result equals the one-frame extract
    bit for bit (a frame's result does not depend on its batch)."""
    kp, ds, ctr = SIFT(96, 128, CFG, device="cpu").extract(inputs["frames"][frame])
    out = ranks[0]
    for name, a in kp._asdict().items():
        np.testing.assert_array_equal(out[f"x.kp.{name}"][frame], a.numpy(), err_msg=name)
    for name, a in ds._asdict().items():
        np.testing.assert_array_equal(out[f"x.desc.{name}"][frame], a.numpy(), err_msg=name)
    for key, v in ctr.items():
        assert int(out[f"x.ctr.{key}"][frame]) == int(v), key


@pytest.fixture(scope="module")
def jax_batch(inputs):
    """The JAX make_batch_extractor on the 8-device mesh, over the crops."""
    return JE.make_batch_extractor(JE.make_mesh(8), 96, 128, JCFG)(jnp.asarray(inputs["frames"]))


def test_sharded_extraction_matches_jax_batch_extractor(ranks, jax_batch):
    """Against the JAX make_batch_extractor on the 8-device mesh, in the
    seed-blur + cascade route that the JAX package takes on the CPU, at
    tests/test_torch_extract.py's tolerances: every frame's counters
    equal, its keypoints to 1e-4, its descriptors within one quantization
    step for 99% of the entries; positions and scales to 1e-4 plus 32
    fp32 ulps (4e-6 relative). The ulp term is there because the two
    packages' one-frame extracts of these crops already differ by up to
    1.83e-4 px (crop 2, octave 1, column 112.44; 24 ulps), where the
    64x96 crop of tests/test_torch_extract.py stays within 1e-4: pyramid
    rounding amplified by an ill-conditioned Taylor step, as
    test_largest_gap_to_jax_is_pyramid_rounding shows."""
    jk, jd, jc = jax_batch
    out = ranks[0]
    kp, ds, ctr = _fields(out, "xc.kp"), _fields(out, "xc.desc"), _fields(out, "xc.ctr")
    for f in range(8):
        for key, v in jc.items():
            assert int(ctr[key][f]) == int(np.asarray(v)[f]), (f, key)

        def kp_rows(k):
            sel = np.asarray(k["valid"])[f]
            return np.stack([np.asarray(k[n])[f][sel] for n in ("octave", "x", "y", "sigma")], 1)

        a, b = kp_rows(kp), kp_rows(jk._asdict())
        assert a.shape == b.shape and a.shape[0] > 10
        a, b = a[np.lexsort(a.T[::-1])], b[np.lexsort(b.T[::-1])]
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=4e-6)

        def desc_rows(d):
            sel = np.asarray(d["valid"])[f]
            key = np.stack([np.asarray(d[n])[f][sel] for n in ("octave", "x", "y", "theta")], 1)
            order = np.lexsort(np.round(key, 3).T[::-1])
            return key[order], np.asarray(d["features"])[f][sel][order].astype(np.int32)

        (ka, fa), (kb, fb) = desc_rows(ds), desc_rows(jd._asdict())
        assert ka.shape == kb.shape
        np.testing.assert_allclose(ka, kb, atol=1e-4, rtol=4e-6)
        assert (np.abs(fa - fb) <= 1).mean() >= 0.99


def _taylor64(n):
    """The Taylor offset (i, j, s) of a 3x3x3 DoG neighbourhood [s, i, j],
    solved in float64."""
    n = n.astype(np.float64)
    c = n[1, 1, 1]
    g = np.array([n[1, 2, 1] - n[1, 0, 1], n[1, 1, 2] - n[1, 1, 0], n[2, 1, 1] - n[0, 1, 1]]) / 2
    h = np.empty((3, 3))
    h[0, 0] = n[1, 2, 1] + n[1, 0, 1] - 2 * c
    h[1, 1] = n[1, 1, 2] + n[1, 1, 0] - 2 * c
    h[2, 2] = n[2, 1, 1] + n[0, 1, 1] - 2 * c
    h[0, 1] = h[1, 0] = (n[1, 2, 2] - n[1, 2, 0] - n[1, 0, 2] + n[1, 0, 0]) / 4
    h[0, 2] = h[2, 0] = (n[2, 2, 1] - n[2, 0, 1] - n[0, 2, 1] + n[0, 0, 1]) / 4
    h[1, 2] = h[2, 1] = (n[2, 1, 2] - n[2, 1, 0] - n[0, 1, 2] + n[0, 1, 0]) / 4
    return -np.linalg.solve(h, g)


def test_largest_gap_to_jax_is_pyramid_rounding(inputs, jax_batch):
    """Where the port's and the JAX package's one-frame extracts of the
    crops lie furthest apart (crop 2: 1.83e-4 px at column 112.44; the
    JAX keypoints from its batch extractor, whose frames equal its
    one-frame extracts, tests/test_parallel.py), each
    package's keypoint is the float64 Taylor solve on its own DoG to 1e-5
    px, so the refinement arithmetic adds nothing; the two DoG
    neighbourhoods differ by at most two ulps of the Gaussian slices they
    are differences of; and the float64 solves on the two reproduce the
    gap to 1e-5 px. The gap is pyramid rounding, amplified by the step."""
    import dataclasses

    from siftmetal_tpu.sift import batched as JB
    from siftmetal_tpu_torch.sift import build_pyramid

    cfg = dataclasses.replace(CFG, use_oneshot_pyramid=False)
    n_oct = cfg.num_octaves(96, 128)
    frame = inputs["frames"][2]
    kp, _, _ = SIFT(96, 128, cfg, device="cpu").extract(frame)

    def by_site(k, f=None):
        d = {n: np.asarray(v) if f is None else np.asarray(v)[f] for n, v in k._asdict().items()}
        return {(int(d["octave"][r]), int(d["scale"][r]), int(d["i"][r]), int(d["j"][r])):
                np.array([d["x"][r], d["y"][r]], np.float64) for r in np.nonzero(d["valid"])[0]}

    a, b = by_site(kp), by_site(jax_batch[0], 2)
    assert a.keys() == b.keys()
    site = max(a, key=lambda k: np.abs(a[k] - b[k]).max())
    o, s, i, j = site
    gap = a[site] - b[site]
    assert np.abs(gap).max() > 1e-4, gap

    _, pdogs = build_pyramid(torch.from_numpy(frame), cfg, n_oct)
    jgs, jdogs = jax.jit(lambda g: JB.build_pyramid_batch(g, JCFG, n_oct))(jnp.asarray(frame)[None])
    box = np.s_[s - 1:s + 2, i - 1:i + 2, j - 1:j + 2]
    pn, jn = pdogs[o].numpy()[box], np.asarray(jdogs[o])[0][box]
    delta = cfg.octave_delta(o)
    pos64 = {}
    for name, n, got in (("port", pn, a[site]), ("jax", jn, b[site])):
        pos64[name] = (np.array([i, j]) + _taylor64(n)[:2]) * delta
        np.testing.assert_allclose(got, pos64[name], atol=1e-5, err_msg=name)
    ulp = np.spacing(np.abs(np.asarray(jgs[o])[0][s - 1:s + 3, i - 1:i + 2, j - 1:j + 2]).max())
    assert np.abs(pn - jn).max() <= 2 * ulp
    np.testing.assert_allclose(pos64["port"] - pos64["jax"], gap, atol=1e-5)


def test_sharded_matcher_equals_bruteforce_and_jax(ranks):
    """Frame 0's descriptors against all 8 frames' (4096 targets, 1024 a
    rank): every field equal to the port's match_bruteforce; valid equal
    to the JAX sharded matcher's on the 8-device mesh, and target_idx
    wherever a match is valid."""
    out = ranks[0]
    feats, valid = out["x.desc.features"], out["x.desc.valid"]
    tf, tv = feats.reshape(-1, 128), valid.reshape(-1)
    exact = match_bruteforce(torch.from_numpy(feats[0]), torch.from_numpy(tf),
                             torch.from_numpy(valid[0]), torch.from_numpy(tv))
    got = _fields(out, "match")
    for name, a in exact._asdict().items():
        np.testing.assert_array_equal(got[name], a.numpy(), err_msg=name)
    assert int(got["valid"].sum()) >= 20

    jm = JE.make_sharded_matcher(JE.make_mesh(8))(
        jnp.asarray(feats[0]), jnp.asarray(valid[0]), jnp.asarray(tf), jnp.asarray(tv))
    np.testing.assert_array_equal(got["valid"], np.asarray(jm.valid))
    ok = got["valid"]
    np.testing.assert_array_equal(got["target_idx"][ok], np.asarray(jm.target_idx)[ok])


def test_distributed_ba_matches_single_device_and_jax(ranks, inputs):
    """tests/test_parallel.py's bars: the initial cost within rel 1e-4 of
    the one-device bundle_adjust's, the final cost < 1e-2, cameras within
    1e-4 and landmarks within 1e-3 of the port's bundle_adjust and of the
    JAX make_distributed_ba; shard_ba_problem's slots equal the JAX
    function's."""
    args = [inputs[k] for k in ("ba_cams", "ba_lms", "ba_k", "ba_cam_idx", "ba_lm_idx",
                                "ba_uv", "ba_valid")]
    single, stats = bundle_adjust(BAProblem(*map(torch.from_numpy, args), fixed_cameras=2),
                                  n_iterations=8, damping=1e-4)
    jsharded = JD.shard_ba_problem(JProblem(*map(jnp.asarray, args), fixed_cameras=2), 8)
    jcams, jlms, _ = JD.make_distributed_ba(JE.make_mesh(8), n_iterations=8, damping=1e-4)(
        jsharded)
    jshard4 = JD.shard_ba_problem(JProblem(*map(jnp.asarray, args), fixed_cameras=2), WORLD)

    out = ranks[0]
    assert float(out["ba.c0"]) == pytest.approx(float(stats.initial_cost), rel=1e-4)
    assert float(out["ba.c1"]) < 1e-2
    for ref_c, ref_l in ((single.cameras.numpy(), single.landmarks.numpy()),
                         (np.asarray(jcams), np.asarray(jlms).reshape(-1, 3))):
        np.testing.assert_allclose(out["ba.cams"], ref_c, atol=1e-4)
        np.testing.assert_allclose(out["ba.lms"].reshape(-1, 3), ref_l, atol=1e-3)
    np.testing.assert_array_equal(out["ba.slot_cam"], np.asarray(jshard4.cam))
    np.testing.assert_array_equal(out["ba.slot_uv"], np.asarray(jshard4.uv))
    np.testing.assert_array_equal(out["ba.slot_valid"], np.asarray(jshard4.valid))


@pytest.mark.parametrize("max_obs", [None, 3, 1])
def test_shard_ba_problem_equals_jax_with_drops(max_obs, caplog):
    """Slots, cameras, pixels, validity and the dropped-count warning equal
    the JAX function's on a problem with uneven degrees and invalid
    observations, with and without slot overflow."""
    from siftmetal_tpu_torch.parallel import shard_ba_problem

    rng = np.random.default_rng(3)
    n_obs, n_lm = 300, 64
    args = [rng.normal(size=(6, 6)).astype(np.float32), rng.normal(size=(n_lm, 3)).astype(np.float32),
            np.eye(3, dtype=np.float32), rng.integers(0, 6, n_obs).astype(np.int32),
            rng.integers(0, n_lm, n_obs).astype(np.int32),
            rng.normal(size=(n_obs, 2)).astype(np.float32), rng.random(n_obs) < 0.8]
    ref = JD.shard_ba_problem(JProblem(*map(jnp.asarray, args), fixed_cameras=1), 4, max_obs)
    with caplog.at_level("WARNING"):
        got = shard_ba_problem(BAProblem(*map(torch.from_numpy, args), fixed_cameras=1), 4, max_obs)
    for name in ("landmarks", "cam", "uv", "valid", "fixed_cameras"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    dropped = int(args[6].sum()) - int(got.valid.sum())
    assert (dropped > 0) == (max_obs is not None)
    assert (f"dropped {dropped} observations" in caplog.text) == (dropped > 0)


def test_initialize_without_launcher_variables_is_a_no_op(monkeypatch):
    """Without an address, initialize returns (0, 1) and sets up nothing,
    as the JAX function does on one host; the barrier then counts this
    process's one device."""
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize() == (0, 1)
    assert not torch.distributed.is_initialized()
    assert multihost.barrier() == 1.0
    # An address without a world size or a rank is refused before any
    # connection is tried.
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    with pytest.raises(ValueError, match="world size and the rank"):
        multihost.initialize(device="cpu")
    assert not torch.distributed.is_initialized()


def test_one_rank_mesh_on_the_cpu(inputs):
    """make_mesh without a process group sets up a one-rank gloo group for
    device="cpu"; the extractor over it equals SIFT.extract_batch bit for
    bit, and a mesh size other than the world size is refused."""
    from siftmetal_tpu_torch.parallel import make_batch_extractor, make_mesh

    assert not torch.distributed.is_initialized()
    try:
        mesh = make_mesh(device="cpu")
        assert mesh.size() == 1 and torch.distributed.get_backend() == "gloo"
        with pytest.raises(ValueError, match="mesh of 2 devices"):
            make_mesh(2)
        frames = torch.from_numpy(inputs["frames"][:2])
        kb, db, cb = make_batch_extractor(mesh, 96, 128, CFG)(frames)
        k1, d1, c1 = SIFT(96, 128, CFG, device="cpu").extract_batch(frames)
        for a, b in zip((*kb, *db), (*k1, *d1)):
            assert torch.equal(a, b)
        assert all(torch.equal(cb[k], c1[k]) for k in c1)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


@pytest.fixture
def one_rank_group():
    """Sets up a one-rank group with the backend it is given (and no
    launcher), torn down after the test."""
    dist = torch.distributed
    assert not dist.is_initialized()

    def init(backend):
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)

    try:
        yield init
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("backend", [None, "cpu:gloo", "gloo"])
def test_rank_device_comes_from_the_mesh_not_the_backend_name(one_rank_group, monkeypatch,
                                                              backend):
    """Over a group set up outside the package, whose backend reads
    "undefined", "cpu:gloo" or "gloo" (never "nccl"), a CUDA mesh still
    puts the rank's work on the current card and a CPU mesh on the CPU."""
    from types import SimpleNamespace

    one_rank_group(backend)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert multihost.rank_device(SimpleNamespace(device_type="cuda")) == torch.device("cuda", 0)
    assert multihost.rank_device(SimpleNamespace(device_type="cpu")) == torch.device("cpu")
    with pytest.raises(ValueError, match="not supported"):
        multihost.rank_device(SimpleNamespace(device_type="meta"))


@pytest.mark.parametrize("backend", [None, "cpu:gloo"])
def test_mesh_over_a_group_set_up_elsewhere(one_rank_group, inputs, backend):
    """The init_device_mesh idiom over a group whose backend is not the
    string "gloo": the matcher and the BA over it equal match_bruteforce
    and bundle_adjust, the barrier counts one device, and make_mesh
    without a device resolves to the card (it raises without one) instead
    of the CPU."""
    from torch.distributed.device_mesh import init_device_mesh

    from siftmetal_tpu_torch.parallel import (
        make_distributed_ba,
        make_mesh,
        make_sharded_matcher,
        shard_ba_problem,
    )

    one_rank_group(backend)
    assert multihost.group_device() is None
    with pytest.raises(RuntimeError, match="CUDA device"):
        make_mesh()
    for mesh in (init_device_mesh("cpu", (1,), mesh_dim_names=("batch",)),
                 make_mesh(1, device="cpu")):
        assert multihost.rank_device(mesh) == torch.device("cpu")
        rng = np.random.default_rng(5)
        tf = torch.from_numpy(rng.integers(0, 256, (64, 128)).astype(np.uint8))
        tv = torch.from_numpy(rng.random(64) < 0.9)
        qf = tf[:16].clone()
        qf[::2] ^= 1
        got = make_sharded_matcher(mesh)(qf, tv[:16], tf, tv)
        want = match_bruteforce(qf, tf, tv[:16], tv)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        args = [torch.from_numpy(inputs[k]) for k in ("ba_cams", "ba_lms", "ba_k", "ba_cam_idx",
                                                      "ba_lm_idx", "ba_uv", "ba_valid")]
        problem = BAProblem(*args, fixed_cameras=2)
        cams, lms, _ = make_distributed_ba(mesh, n_iterations=2)(shard_ba_problem(problem, 1))
        single, _ = bundle_adjust(problem, n_iterations=2)
        torch.testing.assert_close(cams, single.cameras, atol=1e-4, rtol=0)
        torch.testing.assert_close(lms.reshape(-1, 3), single.landmarks, atol=1e-3, rtol=0)
    assert multihost.barrier() == 1.0


def test_inputs_on_another_device_than_the_mesh_are_refused(one_rank_group, inputs):
    """A CPU mesh refuses inputs that lie on another device (here "meta"
    tensors) instead of moving them to the CPU; host inputs are taken."""
    from siftmetal_tpu_torch.parallel import (
        make_batch_extractor,
        make_distributed_ba,
        make_mesh,
        make_sharded_matcher,
        shard_ba_problem,
    )

    mesh = make_mesh(device="cpu")
    assert multihost.group_device() == torch.device("cpu")
    with pytest.raises(ValueError, match="the batch lies on meta"):
        make_batch_extractor(mesh, 96, 128, CFG)(torch.empty((1, 96, 128), device="meta"))
    f = torch.zeros((8, 128), dtype=torch.uint8)
    v = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError, match="a descriptor set lies on meta"):
        make_sharded_matcher(mesh)(f, v, f.to("meta"), v)
    args = [torch.from_numpy(inputs[k]) for k in ("ba_cams", "ba_lms", "ba_k", "ba_cam_idx",
                                                  "ba_lm_idx", "ba_uv", "ba_valid")]
    sharded = shard_ba_problem(BAProblem(*args, fixed_cameras=2), 1)
    with pytest.raises(ValueError, match="the problem lies on meta"):
        make_distributed_ba(mesh)(sharded._replace(landmarks=sharded.landmarks.to("meta")))


def test_make_mesh_refuses_a_device_without_a_backend(one_rank_group, monkeypatch):
    """make_mesh reads the group's backend configuration: a "cpu:gloo"
    group serves a CPU mesh, and a group without a CPU backend (an NCCL
    one, stood in for here) refuses one."""
    from siftmetal_tpu_torch.parallel import make_mesh

    one_rank_group("cpu:gloo")
    assert multihost.backend_device_types() == {"cpu"}
    assert make_mesh(device="cpu").device_type == "cpu"
    monkeypatch.setattr(torch.distributed, "get_backend_config", lambda group=None: "cuda:nccl")
    assert multihost.backend_device_types() == {"cuda"}
    with pytest.raises(ValueError, match="cpu mesh asked for over a process group with "
                                         "backends cuda:nccl"):
        make_mesh(device="cpu")
