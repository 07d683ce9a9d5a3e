"""The port's native frame-ingest binding (``siftmetal_tpu_torch/utils/
frame_loader.py``): its first-use build of ``native/frameloader.cpp``,
tests/test_native.py's cases, and the JAX package's module on the same
inputs (to 1e-6, the bound test_native.py holds its conversions to)."""

import pathlib

import numpy as np
import pytest
import torch

from siftmetal_tpu.utils import frame_loader as jfl
from siftmetal_tpu_torch.utils import frame_loader as fl

W709 = np.array([0.212639005871510, 0.715168678767756, 0.072192315360734], dtype=np.float32)


def _write_ppm(path, arr):
    h, w, _ = arr.shape
    with open(path, "wb") as f:
        f.write(b"P6\n# comment\n%d %d\n255\n" % (w, h))
        f.write(arr.tobytes())


def test_rgb_to_gray_matches_python_and_jax():
    rng = np.random.default_rng(0)
    for c in (3, 4):
        rgb = rng.integers(0, 255, (37, 53, c)).astype(np.uint8)
        got = fl.rgb_to_gray(rgb)
        assert got.dtype == np.float32 and got.shape == (37, 53)
        np.testing.assert_allclose(got, (rgb[..., :3].astype(np.float32) / 255.0) @ W709, atol=1e-6)
        np.testing.assert_allclose(got, jfl.rgb_to_gray(rgb), atol=1e-6)


def test_bgra_and_yuv_match_python_and_jax():
    rng = np.random.default_rng(1)
    bgra = rng.integers(0, 255, (16, 16, 4)).astype(np.uint8)
    g1 = fl.bgra_to_gray(bgra)
    np.testing.assert_allclose(g1, fl.rgb_to_gray(bgra[..., [2, 1, 0]]), atol=1e-6)
    np.testing.assert_allclose(g1, jfl.bgra_to_gray(bgra), atol=1e-6)

    y = rng.integers(0, 255, (16, 16)).astype(np.uint8)
    full = fl.yuv420_to_gray(y, video_range=False)
    np.testing.assert_allclose(full, y / 255.0, atol=1e-6)
    vid = fl.yuv420_to_gray(y, video_range=True)
    np.testing.assert_allclose(vid, np.clip((y.astype(np.float32) - 16) / 219.0, 0, 1), atol=1e-6)
    for video in (False, True):
        np.testing.assert_allclose(fl.yuv420_to_gray(y, video), jfl.yuv420_to_gray(y, video),
                                   atol=1e-6)


def test_pnm_decode(tmp_path):
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 255, (24, 32, 3)).astype(np.uint8)
    p = str(tmp_path / "img.ppm")
    _write_ppm(p, rgb)
    gray = fl.load_pnm_gray(p)
    np.testing.assert_allclose(gray, fl.rgb_to_gray(rgb), atol=1e-6)
    np.testing.assert_allclose(gray, jfl.load_pnm_gray(p), atol=1e-6)
    with pytest.raises(IOError):
        fl.load_pnm_gray(str(tmp_path / "missing.ppm"))


def test_threaded_loader_returns_one_tensor_a_batch(tmp_path):
    """Frames come back in submission order as one [n, H, W] float32
    tensor (pinned when CUDA is available), equal to the JAX loader's."""
    rng = np.random.default_rng(3)
    paths, refs = [], []
    for i in range(12):
        rgb = rng.integers(0, 255, (24, 32, 3)).astype(np.uint8)
        p = str(tmp_path / f"f{i}.ppm")
        _write_ppm(p, rgb)
        paths.append(p)
        refs.append(fl.rgb_to_gray(rgb))

    with fl.FrameLoader(24, 32, n_threads=4) as loader:
        loader.submit_all(paths)
        batch = loader.next_batch(8)
        rest = torch.stack([loader.next_frame() for _ in range(4)])
        assert loader.error_count == 0
        with pytest.raises(RuntimeError, match="no pending frames"):
            loader.next_batch(1)
    assert torch.is_tensor(batch) and batch.shape == (8, 24, 32) and batch.dtype == torch.float32
    assert batch.is_pinned() == torch.cuda.is_available()
    np.testing.assert_allclose(torch.cat([batch, rest]).numpy(), np.stack(refs), atol=1e-6)
    if jfl.native_available():
        jl = jfl.FrameLoader(24, 32, n_threads=2)
        jl.submit_all(paths)
        np.testing.assert_allclose(torch.cat([batch, rest]).numpy(), jl.next_batch(12), atol=1e-6)
        jl.close()


def test_loader_counts_frames_of_another_size(tmp_path):
    rng = np.random.default_rng(4)
    p = str(tmp_path / "small.ppm")
    _write_ppm(p, rng.integers(0, 255, (8, 8, 3)).astype(np.uint8))
    with fl.FrameLoader(24, 32, n_threads=1) as loader:
        loader.submit(p)
        loader.next_batch(1)
        assert loader.error_count == 1


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    """The library build pointed at an empty directory."""
    monkeypatch.setattr(fl, "LIB_PATH", tmp_path / "libframeloader.so")
    return tmp_path


def test_first_use_build_and_rebuild_on_command_change(build_dir):
    """The library is built with g++ into the build directory with a stamp
    of its command, and rebuilt when the stamp differs or the source is
    newer; the command has no host-specific flags."""
    assert fl._stale()
    assert fl.build()
    lib, stamp = build_dir / "libframeloader.so", build_dir / "libframeloader.cmd"
    assert lib.exists() and "-march=native" not in stamp.read_text()
    assert not fl._stale()
    stamp.write_text("g++ -O0 an older command")
    assert fl._stale()
    fl.build()
    assert not fl._stale() and "-O3" in stamp.read_text()


def test_failed_build_raises_with_the_compiler_log(build_dir, monkeypatch):
    bad = build_dir / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(fl, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed .*broken.cpp"):
        fl.build()
    assert not (build_dir / "libframeloader.so").exists()


def test_source_is_the_repo_native_loader():
    assert fl.SOURCE == pathlib.Path(__file__).resolve().parents[1] / "native" / "frameloader.cpp"
    assert fl.native_available()
