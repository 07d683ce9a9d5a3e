"""The port's configuration, device rule, image reader and import hygiene,
held against the JAX package."""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import siftmetal_tpu.config as jcfg
import siftmetal_tpu_torch as port
from siftmetal_tpu_torch.config import config_from_dict

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures"

PRESETS = {
    "default": jcfg.SiftConfig(),
    "fast": jcfg.FAST_CONFIG,
    "fast_bf16": jcfg.FAST_BF16_CONFIG,
    "custom": jcfg.SiftConfig(sigma_min=1.0, n_scales_per_octave=4, max_keypoints=2048),
}


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_config_round_trip(name):
    """Every field and every derived value carries over unchanged."""
    from siftmetal_tpu.ops.pallas.pyramid import oneshot_rhos as j_rhos
    from siftmetal_tpu.sift import detect as JD
    from siftmetal_tpu_torch.ops.kernels.pyramid import oneshot_rhos
    from siftmetal_tpu_torch.sift import detect as PD

    jc = PRESETS[name]
    pc = config_from_dict(dataclasses.asdict(jc))
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    for h, w in [(480, 640), (340, 512), (64, 96)]:
        n = jc.num_octaves(h, w)
        assert pc.num_octaves(h, w) == n
        shapes = jc.octave_shapes(h, w, n)
        assert pc.octave_shapes(h, w, n) == shapes
        for o in range(n):
            assert pc.octave_sigmas(o) == jc.octave_sigmas(o)
            assert pc.incremental_sigmas(o) == jc.incremental_sigmas(o)
            assert pc.octave_delta(o) == jc.octave_delta(o)
            for s in shapes:
                assert PD.keypoint_budget(pc, s, o) == JD.keypoint_budget(jc, s, o)
        for s in shapes:
            assert PD.extrema_candidate_budget(pc, s) == JD.extrema_candidate_budget(jc, s)
            assert PD.mover_budget(pc, s) == JD.mover_budget(jc, s)
        assert PD.mover_budget_all(pc, shapes) == JD.mover_budget_all(jc, shapes)
    for attr in ("seed_blur_sigma",):
        assert getattr(pc, attr)() == getattr(jc, attr)()
    for attr in ("ori_patch_radius", "desc_patch_radius", "sigma_oct_max",
                 "n_gaussians_per_octave", "n_dogs_per_octave",
                 "descriptor_length"):
        assert getattr(pc, attr) == getattr(jc, attr)
    assert oneshot_rhos(pc) == j_rhos(jc)


def test_config_presets_and_unknown_fields():
    assert dataclasses.asdict(port.FAST_CONFIG) == dataclasses.asdict(jcfg.FAST_CONFIG)
    assert dataclasses.asdict(port.FAST_BF16_CONFIG) == dataclasses.asdict(jcfg.FAST_BF16_CONFIG)
    with pytest.raises(ValueError):
        config_from_dict({"not_a_field": 1})


def test_sift_without_device_raises_when_cuda_absent(monkeypatch):
    """The port never carries on on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.SIFT(64, 96)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.SIFT(64, 96, device="cuda")
    assert port.SIFT(64, 96, device="cpu").device.type == "cpu"


def test_ppm_reader_matches_png():
    """tests/fixtures/butterfly.ppm holds exactly the PNG's RGB channels."""
    from PIL import Image

    from siftmetal_tpu_torch.utils.io import load_image, read_pnm

    with Image.open(FIXTURES / "butterfly.png") as im:
        png = np.asarray(im)
    assert (png[..., 3] == 255).all()
    ppm = read_pnm(str(FIXTURES / "butterfly.ppm"))
    assert ppm.dtype == np.uint8
    np.testing.assert_array_equal(ppm, png[..., :3])
    np.testing.assert_array_equal(
        load_image(str(FIXTURES / "butterfly.ppm")),
        png[..., :3].astype(np.float32) / 255.0,
    )


@pytest.mark.parametrize("maxval", [255, 65535])
def test_pgm_reader(tmp_path, maxval):
    """Binary PGM (P5) with a header comment, 8- and 16-bit samples."""
    from siftmetal_tpu_torch.utils.io import load_image, read_pnm

    rng = np.random.default_rng(0)
    dt = np.dtype(">u2") if maxval > 255 else np.dtype(np.uint8)
    img = rng.integers(0, maxval + 1, (7, 5)).astype(dt)
    path = tmp_path / "x.pgm"
    path.write_bytes(f"P5\n# comment\n5 7\n{maxval}\n".encode() + img.tobytes())
    np.testing.assert_array_equal(read_pnm(str(path)), img.astype(np.int64))
    np.testing.assert_allclose(load_image(str(path)), img.astype(np.float32) / maxval)


def test_port_imports_no_jax():
    """Importing every module of the port (and chip_smoke.py) loads no jax
    and nothing of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import siftmetal_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'siftmetal_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
