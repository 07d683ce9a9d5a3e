"""The port's dataset parsers (``siftmetal_tpu_torch/utils/datasets.py``),
its PNG reader (``utils/io.py``) and its dataset runners
(``scripts/run_{hpatches,tum}_torch.py``) against the JAX package's on the
committed mini fixtures (tests/fixtures/{tum,hpatches}_mini)."""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from siftmetal_tpu.utils import datasets as JDS
from siftmetal_tpu.utils.io import load_image as jload_image
from siftmetal_tpu_torch.utils import datasets as DS
from siftmetal_tpu_torch.utils.io import load_image, read_png

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"
PNGS = sorted(str(p.relative_to(FIXTURES)) for p in FIXTURES.rglob("*.png"))

sys.path.insert(0, str(ROOT / "scripts"))


def test_tum_parsers_match_jax():
    ts, paths = DS.tum_frames(FIXTURES / "tum_mini")
    jts, jpaths = JDS.tum_frames(FIXTURES / "tum_mini")
    np.testing.assert_array_equal(ts, jts)
    assert paths == jpaths and len(paths) == 3
    gt_ts, gt_pos = DS.tum_groundtruth(FIXTURES / "tum_mini")
    jgt_ts, jgt_pos = JDS.tum_groundtruth(FIXTURES / "tum_mini")
    np.testing.assert_array_equal(gt_ts, jgt_ts)
    np.testing.assert_array_equal(gt_pos, jgt_pos)
    for p in paths:
        gray = DS.load_gray(p)
        assert gray.shape == (16, 24) and gray.dtype == np.float32
        np.testing.assert_allclose(gray, JDS.load_gray(p), atol=1e-6)


def test_associate_ate_matches_jax():
    """tests/test_datasets.py's exact trajectory (ATE ~ 0), and a noisy
    one against the JAX function (1e-5 relative: the two packages' fp32
    rotations)."""
    ts, _ = DS.tum_frames(FIXTURES / "tum_mini")
    gt_ts, gt_pos = DS.tum_groundtruth(FIXTURES / "tum_mini")
    cams = np.zeros((3, 6), dtype=np.float32)
    cams[:, 3] = -0.1 * np.arange(3)
    cams[:, 4] = -0.05 * np.arange(3)
    ate, n = DS.associate_ate(ts, cams, gt_ts, gt_pos)
    assert n == 3 and ate < 1e-6
    noisy = cams + np.random.default_rng(5).normal(0, 0.02, cams.shape).astype(np.float32)
    ate, n = DS.associate_ate(ts, noisy, gt_ts, gt_pos)
    jate, jn = JDS.associate_ate(ts, noisy, gt_ts, gt_pos)
    assert n == jn == 3 and ate == pytest.approx(jate, rel=1e-5, abs=1e-7)
    ate, n = DS.associate_ate(ts[:2], cams[:2], gt_ts, gt_pos)
    assert n == 2 and np.isnan(ate)


def test_hpatches_parsers_match_jax(tmp_path):
    seqs = DS.hpatches_sequences(FIXTURES / "hpatches_mini")
    assert seqs == JDS.hpatches_sequences(FIXTURES / "hpatches_mini")
    assert [s.name for s in seqs] == ["i_mini"]
    assert DS.hpatches_sequences(seqs[0]) == [seqs[0]]
    assert DS.hpatches_image_path(seqs[0], 1).name == "1.ppm"
    with pytest.raises(FileNotFoundError):
        DS.hpatches_image_path(seqs[0], 6)
    np.testing.assert_array_equal(DS.load_homography_rowcol(seqs[0] / "H_1_2"), np.eye(3))
    # x' = x + 3 (a column shift) becomes col' = col + 3.
    hxy = np.eye(3)
    hxy[0, 2] = 3.0
    hxy[2, 0] = 1e-4
    np.savetxt(tmp_path / "H", hxy)
    hrc = DS.load_homography_rowcol(tmp_path / "H")
    assert hrc[1, 2] == 3.0 and hrc[0, 2] == 0.0
    np.testing.assert_array_equal(hrc, JDS.load_homography_rowcol(tmp_path / "H"))
    for k in (1, 2):
        p = str(DS.hpatches_image_path(seqs[0], k))
        np.testing.assert_allclose(DS.load_gray(p), JDS.load_gray(p), atol=1e-6)


@pytest.mark.parametrize("name", PNGS)
def test_png_decode_equals_jax_load_image(name):
    """Every PNG of the fixtures (8-bit gray, RGB and RGBA; plain and
    Adam7-interlaced) decodes pixel for pixel as the JAX load_image
    (PIL) reads it."""
    got = load_image(str(FIXTURES / name))
    want = jload_image(str(FIXTURES / name))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode,interlace", [
    ("LA", False), ("P", False), ("PA", True), ("I;16", False), ("I;16", True),
    ("RGB;16", False),
])
def test_png_formats_beyond_the_fixtures(tmp_path, mode, interlace):
    """gray+alpha, palette (with and without transparency) and 16-bit
    images written by PIL: the samples PIL holds for them (palette
    expanded through the palette; 16-bit samples read raw, and scaled by
    1/65535 in load_image)."""
    from PIL import Image

    rng = np.random.default_rng(7)
    h, w = 37, 29
    if mode == "LA":
        im = Image.fromarray(rng.integers(0, 256, (h, w, 2), dtype=np.uint8), "LA")
        want = np.asarray(im)
    elif mode in ("P", "PA"):
        # A full 256-entry palette: PIL writes fewer bits a sample for
        # smaller ones.
        im = Image.fromarray(rng.integers(0, 256, (h, w), dtype=np.uint8), "P")
        im.putpalette(rng.integers(0, 256, 768, dtype=np.uint8).tolist())
        if mode == "PA":
            im.info["transparency"] = bytes(rng.integers(0, 256, 200, dtype=np.uint8))
        want = None
    elif mode == "I;16":
        arr = rng.integers(0, 65536, (h, w)).astype(np.uint16)
        im = Image.fromarray(arr)  # uint16 -> mode "I;16"
        want = arr
    else:
        arr = rng.integers(0, 65536, (h, w, 3)).astype(">u2")
        want = arr.astype(np.uint16)
        im = None
    path = tmp_path / "img.png"
    if im is not None:
        kw = {"interlace": 1} if interlace else {}
        if mode == "PA":
            kw["transparency"] = im.info["transparency"]
        im.save(path, **kw)
    else:
        _write_png_rgb16(path, arr)
    got = read_png(str(path))
    if mode in ("P", "PA"):
        with Image.open(path) as back:
            want = np.asarray(back.convert("RGBA" if mode == "PA" else "RGB"))
    np.testing.assert_array_equal(got, want)
    scale = 65535.0 if want.dtype == np.uint16 else 255.0
    np.testing.assert_array_equal(load_image(str(path)), want.astype(np.float32) / scale)


def _write_png_rgb16(path, arr):
    """A 16-bit RGB PNG (PIL cannot write one), filter type 0."""
    import struct
    import zlib

    h, w, _ = arr.shape
    raw = b"".join(b"\x00" + arr[r].tobytes() for r in range(h))

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))


def test_png_refuses_corrupt_and_unread_formats(tmp_path):
    from PIL import Image

    data = (FIXTURES / "tum_mini" / "rgb" / "130536210.123456.png").read_bytes()
    bad = bytearray(data)
    bad[40] ^= 0xFF
    (tmp_path / "bad.png").write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="corrupt PNG chunk"):
        read_png(str(tmp_path / "bad.png"))
    Image.fromarray(np.zeros((4, 4), bool)).save(tmp_path / "bits.png")
    with pytest.raises(ValueError, match="is not read"):
        read_png(str(tmp_path / "bits.png"))


def test_run_hpatches_torch_identity_pair_scores_high():
    """tests/test_datasets.py's bar for the JAX runner, on the port's."""
    import run_hpatches_torch

    summary = run_hpatches_torch.main(
        [str(FIXTURES / "hpatches_mini"), "--n-images", "2", "--device", "cpu"]
    )
    assert summary["n_sequences"] == 1
    assert summary["mean_illumination"] > 0.95


@pytest.mark.slow
def test_run_hpatches_torch_json_matches_jax_runner(capsys):
    """The port's runner prints the JAX runner's JSON lines (the JAX
    runner's test is slow-marked, so this one is too)."""
    import run_hpatches
    import run_hpatches_torch

    args = [str(FIXTURES / "hpatches_mini"), "--n-images", "2"]
    want = run_hpatches.main(args)
    jlines = capsys.readouterr().out.strip().splitlines()
    got = run_hpatches_torch.main(args + ["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert got == want
    assert [json.loads(x) for x in lines] == [json.loads(x) for x in jlines]


@pytest.mark.slow
def test_run_tum_torch_json_matches_jax_runner(tmp_path):
    """Both runners on tests/fixtures/tum_mini (16x24 frames: the map does
    not bootstrap, the plumbing runs to the JSON line): the same keys and
    the same counts."""
    import run_tum
    import run_tum_torch

    seq = str(FIXTURES / "tum_mini")
    want = run_tum.main([seq, "--stride", "1", "--out", str(tmp_path / "j.txt")])
    got = run_tum_torch.main([seq, "--stride", "1", "--out", str(tmp_path / "p.txt"),
                              "--device", "cpu"])
    assert set(got) == set(want)
    for key in ("metric", "sequence", "n_keyframes", "n_failed", "n_landmarks",
                "n_associated", "n_loop_closures", "config"):
        assert got[key] == want[key], key


def test_run_tum_torch_on_a_rendered_sequence(tmp_path):
    """The port's TUM runner end to end on a TUM-layout sequence written
    here: examples/video_sfm_torch.py's scene (5 frames at 240x320, PNG),
    its ground truth in TUM format. Every frame registers and the ATE
    after association and similarity alignment is < 0.1 (the example's
    bar)."""
    from PIL import Image

    sys.path.insert(0, str(ROOT))
    from examples.video_sfm_torch import render, textured_scene
    from siftmetal_tpu_torch.utils.checkpoint import save_trajectory_tum
    import run_tum_torch

    rng = np.random.default_rng(0)
    h, w = 240, 320
    k = np.array([[260, 0, w / 2], [0, 260, h / 2], [0, 0, 1]], dtype=np.float32)
    centers, amps, widths = textured_scene(rng)
    cams = np.zeros((5, 6), dtype=np.float32)
    cams[:, 3] = np.linspace(0, 1.2, 5)
    cams[:, 1] = np.linspace(0, 0.06, 5)
    seq = tmp_path / "seq"
    (seq / "rgb").mkdir(parents=True)
    ts = 1305031102.0 + 0.1 * np.arange(5)
    lines = ["# timestamp filename"]
    for t, c in zip(ts, cams):
        img = render(c, k, centers, amps, widths, h, w, torch.device("cpu")).numpy()
        name = f"rgb/{t:.6f}.png"
        Image.fromarray((img * 255 + 0.5).astype(np.uint8)).save(seq / name)
        lines.append(f"{t:.6f} {name}")
    (seq / "rgb.txt").write_text("\n".join(lines) + "\n")
    save_trajectory_tum(str(seq / "groundtruth.txt"), ts, cams)

    summary = run_tum_torch.main([
        str(seq), "--stride", "1", "--device", "cpu", "--fx", "260", "--fy", "260",
        "--cx", str(w / 2), "--cy", str(h / 2), "--max-cameras", "8",
        "--max-landmarks", "4096", "--max-observations", "16384",
        "--out", str(tmp_path / "traj.txt"),
    ])
    assert summary["n_keyframes"] == 5 and summary["n_failed"] == 0
    assert summary["n_associated"] == 5
    assert summary["ate_rmse_m"] is not None and summary["ate_rmse_m"] < 0.1
    assert (tmp_path / "traj.txt").read_text().count("\n") == 5
