"""The port's utilities (``siftmetal_tpu_torch/utils``: the IPOL text
formats, the PNM writer, checkpoints, logging) against the JAX package's
on the same inputs, and a guard that the port imports nothing of JAX.
The tracer of ``utils/profiling.py`` has its own tests,
``tests/test_torch_tracing.py``."""

import ast
import dataclasses
import logging
import pathlib

import numpy as np
import pytest
import torch

from siftmetal_tpu.utils import checkpoint as JC
from siftmetal_tpu.utils import io as JIO
from siftmetal_tpu_torch.utils import checkpoint as PC
from siftmetal_tpu_torch.utils import io as PIO

from conftest import FIXTURES

ROOT = pathlib.Path(__file__).resolve().parents[1]
K = np.array([[400, 0, 320], [0, 400, 240], [0, 0, 1]], dtype=np.float32)


def _keys(n=17, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 300, n).astype(np.float32)
    y = rng.uniform(0, 500, n).astype(np.float32)
    sigma = rng.uniform(1, 20, n).astype(np.float32)
    theta = rng.uniform(-3, 3, n).astype(np.float32)
    feats = rng.integers(0, 256, (n, 128)).astype(np.uint8)
    valid = rng.uniform(size=n) > 0.3
    return x, y, sigma, theta, feats, valid


# --- IPOL text formats ------------------------------------------------------------


def test_descriptor_io_roundtrip_and_same_text_as_jax(tmp_path):
    x, y, sigma, theta, feats, valid = _keys()
    p, pj = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    wrote = PIO.write_descriptors(p, x, y, sigma, theta, feats, valid)
    assert wrote == JIO.write_descriptors(pj, x, y, sigma, theta, feats, valid) == valid.sum()
    assert open(p).read() == open(pj).read()
    keys, f2 = PIO.read_descriptors(p)
    assert len(keys) == wrote and f2.dtype == np.uint8
    np.testing.assert_allclose(keys, np.stack([x, y, sigma, theta], 1)[valid], atol=1e-5)
    np.testing.assert_array_equal(f2, feats[valid])
    for a, b in zip(PIO.read_descriptors(pj), JIO.read_descriptors(pj)):
        np.testing.assert_array_equal(a, b)


def test_reads_reference_fixture_format():
    """The IPOL fixture (168 columns: 4 keys, 128 features, a 36-bin
    orientation histogram) reads as the JAX package reads it."""
    keys, feats = PIO.read_descriptors(str(FIXTURES / "butterfly-descriptors.txt"))
    assert keys.shape == (1609, 4) and feats.shape == (1609, 128)
    jk, jf = JIO.read_descriptors(str(FIXTURES / "butterfly-descriptors.txt"))
    np.testing.assert_array_equal(keys, jk)
    np.testing.assert_array_equal(feats, jf)
    kp = PIO.read_keypoints(str(FIXTURES / "extra_OnEdgeResp_butterfly.txt"))
    np.testing.assert_array_equal(
        kp, JIO.read_keypoints(str(FIXTURES / "extra_OnEdgeResp_butterfly.txt")))
    assert kp.shape[1] == 4 and len(kp) > 1000


@pytest.mark.parametrize("with_theta", [True, False])
def test_keypoint_io_roundtrip_and_same_text_as_jax(tmp_path, with_theta):
    x, y, sigma, theta, _, valid = _keys(9, seed=1)
    th = theta if with_theta else None
    p, pj = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    n = PIO.write_keypoints(p, x, y, sigma, th, valid)
    assert n == JIO.write_keypoints(pj, x, y, sigma, th, valid) == valid.sum()
    assert open(p).read() == open(pj).read()
    back = PIO.read_keypoints(p)
    want = np.stack([x, y, sigma, theta if with_theta else 0 * x], 1)[valid]
    np.testing.assert_allclose(back, want, atol=1e-5)


@pytest.mark.parametrize("kind", ["gray_float", "rgb_uint8", "gray_uint16", "gray_tensor"])
def test_save_image_roundtrips_through_pnm_reader(tmp_path, kind):
    rng = np.random.default_rng(2)
    if kind == "gray_float":
        img = rng.uniform(-0.1, 1.1, (13, 21)).astype(np.float32)
        want = (np.clip(img, 0, 1) * 255).astype(np.uint8)       # as the JAX save_image quantizes
    elif kind == "rgb_uint8":
        img = want = rng.integers(0, 256, (7, 5, 3)).astype(np.uint8)
    elif kind == "gray_uint16":
        img = want = rng.integers(0, 65536, (6, 4)).astype(np.uint16)
    else:
        want = rng.integers(0, 256, (8, 8)).astype(np.uint8)
        img = torch.from_numpy(want.astype(np.float32) / 255.0)
        want = (np.clip(want.astype(np.float32) / 255.0, 0, 1) * 255).astype(np.uint8)
    path = str(tmp_path / ("x.ppm" if kind == "rgb_uint8" else "x.pgm"))
    PIO.save_image(path, img)
    back = PIO.read_pnm(path)
    assert back.dtype == want.dtype
    np.testing.assert_array_equal(back, want)


def test_save_image_refuses_other_shapes(tmp_path):
    with pytest.raises(ValueError):
        PIO.save_image(str(tmp_path / "x.pgm"), np.zeros((4, 4, 2), np.uint8))


# --- checkpoints --------------------------------------------------------------------


def _fill(smap, seed=0):
    rng = np.random.default_rng(seed)
    smap.cameras[:3] = rng.normal(0, 0.1, (3, 6))
    smap.cameras[:3, 5] += 5.0
    smap.n_cameras = 3
    smap.landmarks[:40] = rng.uniform([-1, -1, 4], [1, 1, 8], (40, 3))
    smap.lm_desc[:40] = rng.integers(0, 256, (40, 128))
    smap.n_landmarks = 40
    smap.obs_cam[:100] = rng.integers(0, 3, 100)
    smap.obs_lm[:100] = rng.integers(0, 40, 100)
    smap.obs_uv[:100] = rng.uniform(0, 640, (100, 2))
    smap.n_obs = 100
    return smap


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_map_checkpoint_loads_across_packages(tmp_path, direction):
    """A map saved by either package's save_map loads in the other's
    load_map with every field, counter and the intrinsics equal, and the
    same reprojection RMS."""
    from siftmetal_tpu.slam.sfm import SfmConfig as JCfg
    from siftmetal_tpu.slam.sfm import SfmMap as JMap
    from siftmetal_tpu_torch.slam.sfm import SfmConfig as PCfg
    from siftmetal_tpu_torch.slam.sfm import SfmMap as PMap

    budgets = dict(max_cameras=4, max_landmarks=64, max_observations=128)
    p = str(tmp_path / "map.npz")
    if direction == "jax_to_port":
        src = _fill(JMap(K, JCfg(**budgets)))
        JC.save_map(p, src)
        back = PC.load_map(p, device="cpu")
        assert isinstance(back, PMap) and back.device.type == "cpu"
    else:
        src = _fill(PMap(K, PCfg(**budgets), device="cpu"))
        PC.save_map(p, src)
        back = JC.load_map(p)
        assert isinstance(back, JMap)
    for f in ("cameras", "landmarks", "lm_desc", "obs_cam", "obs_lm", "obs_uv"):
        np.testing.assert_array_equal(getattr(back, f), getattr(src, f), f)
    for c in ("n_cameras", "n_landmarks", "n_obs"):
        assert getattr(back, c) == getattr(src, c)
    assert back.config.max_landmarks == 64
    np.testing.assert_array_equal(np.asarray(back.k.cpu() if torch.is_tensor(back.k) else back.k), K)
    np.testing.assert_allclose(back.reprojection_rms(), src.reprojection_rms(), rtol=1e-5)


def _tum_rows(path):
    return [line.split() for line in open(path)]


def test_trajectory_tum_same_text_as_jax(tmp_path):
    """save_trajectory_tum writes the JAX package's text for the same
    cameras, including rotations near 180 degrees (Shepperd branches):
    every field equal, or (float32 rounding of the center or rotation
    crossing a printed digit) within one unit of the last printed digit."""
    rng = np.random.default_rng(4)
    cams = rng.normal(0, 1.0, (12, 6)).astype(np.float32)
    axis = np.array([0.6, -0.8, 0.0], np.float32)
    cams[0, :3] = 0.0
    cams[1, :3] = axis * np.float32(np.pi - 1e-4)
    cams[2, :3] = [0.0, 0.0, np.pi - 1e-3]
    ts = np.arange(12) * 0.1
    p, pj = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    PC.save_trajectory_tum(p, ts, cams)
    JC.save_trajectory_tum(pj, ts, cams)
    rows, rows_j = _tum_rows(p), _tum_rows(pj)
    assert len(rows) == len(rows_j) == 12
    n_equal = 0
    for a, b in zip(rows, rows_j):
        assert len(a) == len(b) == 8
        for u, v in zip(a, b):
            n_equal += u == v
            assert abs(float(u) - float(v)) <= 1.01e-6, (a, b)
    assert n_equal >= 0.9 * 12 * 8, n_equal
    from siftmetal_tpu_torch.slam.trajectory import camera_centers, load_tum_trajectory

    _, pos = load_tum_trajectory(p)
    np.testing.assert_allclose(pos, camera_centers(cams), atol=2e-6)


def test_rotation_to_quaternion_matches_jax():
    rng = np.random.default_rng(5)
    from siftmetal_tpu_torch.slam.camera import rodrigues

    w = rng.normal(0, 1.5, (32, 3)).astype(np.float32)
    w[:4] = np.array([[np.pi, 0, 0], [0, np.pi, 0], [0, 0, np.pi], [0, 0, 0]], np.float32)
    for r in rodrigues(torch.from_numpy(w)).numpy().astype(np.float64):
        np.testing.assert_array_equal(PC.rotation_to_quaternion(r), JC.rotation_to_quaternion(r))


# --- logging ------------------------------------------------------------------------


def test_logging_output_matches_jax(caplog):
    """log_counters on the same counters (the port's as 0-dim tensors)
    returns the same dict and logs the same records (level, message,
    counters payload, the overflow warning) under the port's namespace."""
    import jax.numpy as jnp

    from siftmetal_tpu.utils import logging as JL
    from siftmetal_tpu_torch.utils import logging as PL

    values = {"n_extrema": 100, "overflow": 3, "descriptor_overflow": 0}
    with caplog.at_level(logging.INFO):
        plain_j = JL.log_counters({k: jnp.int32(v) for k, v in values.items()})
        n_j = len(caplog.records)
        plain_p = PL.log_counters({k: torch.tensor(v, dtype=torch.int32) for k, v in values.items()})
    assert plain_p == plain_j == values
    rec_j, rec_p = caplog.records[:n_j], caplog.records[n_j:]
    assert len(rec_p) == len(rec_j) == 2
    for a, b in zip(rec_p, rec_j):
        assert a.levelname == b.levelname and a.getMessage() == b.getMessage()
        assert a.name == "siftmetal_tpu_torch." + b.name.split(".", 1)[1]
        assert getattr(a, "counters", None) == getattr(b, "counters", None)
    assert "dropped" in rec_p[1].getMessage()
    assert PL.get_logger("x").name == "siftmetal_tpu_torch.x"
    assert PL.get_logger().name == "siftmetal_tpu_torch"


def test_json_lines_format_matches_jax():
    """The JSON-lines handler formats a record as the JAX package's does."""
    import json

    from siftmetal_tpu.utils import logging as JL
    from siftmetal_tpu_torch.utils import logging as PL

    def formatted(mod, root):
        logger = logging.getLogger(root)
        saved = logger.handlers[:]
        logger.handlers.clear()
        try:
            mod.configure(json_lines=True)
            fmt = logger.handlers[0].formatter
        finally:
            logger.handlers[:] = saved
        rec = logging.LogRecord(root + ".extract", logging.INFO, __file__, 1, "counters %s",
                                ({"a": 1},), None)
        rec.counters = {"a": 1}
        return json.loads(fmt.format(rec))

    j, p = formatted(JL, "siftmetal_tpu"), formatted(PL, "siftmetal_tpu_torch")
    assert p.pop("logger") == "siftmetal_tpu_torch.extract"
    assert j.pop("logger") == "siftmetal_tpu.extract"
    assert p == j


# --- the port imports nothing of JAX ---------------------------------------------------


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def test_no_port_source_imports_jax():
    """No import statement anywhere in siftmetal_tpu_torch/, chip_smoke.py,
    the port's examples and dataset runners or the multi-rank test worker
    (function-level imports included) names jax, jaxlib or the JAX
    package."""
    files = sorted((ROOT / "siftmetal_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", *sorted((ROOT / "examples").glob("*_torch.py")),
              *sorted((ROOT / "scripts").glob("*_torch.py")),
              ROOT / "tests" / "torch_parallel_worker.py"]
    assert len(files) > 30 and (ROOT / "siftmetal_tpu_torch" / "slam" / "sfm.py") in files
    for module in ("parallel/multihost.py", "parallel/extraction.py", "parallel/distributed_ba.py",
                   "utils/frame_loader.py", "utils/datasets.py", "utils/viz.py"):
        assert ROOT / "siftmetal_tpu_torch" / module in files, module
    assert ROOT / "scripts" / "run_tum_torch.py" in files
    bad = [f"{f.relative_to(ROOT)}:{line} imports {mod}" for f in files
           for mod, line in _imported_roots(f) if mod in ("jax", "jaxlib", "siftmetal_tpu")]
    assert not bad, bad


def test_sfm_config_fields_and_defaults_match_jax():
    from siftmetal_tpu.slam.sfm import SfmConfig as JCfg
    from siftmetal_tpu_torch.slam.sfm import SfmConfig as PCfg

    assert dataclasses.asdict(PCfg()) == dataclasses.asdict(JCfg())
    assert [f.name for f in dataclasses.fields(PCfg)] == [f.name for f in dataclasses.fields(JCfg)]
