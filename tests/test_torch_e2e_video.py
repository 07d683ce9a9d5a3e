"""End-to-end on the PyTorch port: examples/video_sfm_torch.py (rendered
sequence -> SIFT -> incremental SfM -> BA -> TUM trajectory and map
checkpoint) on the CPU, held to the bars of tests/test_e2e_video.py."""

import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


@pytest.mark.slow
def test_video_sfm_torch_end_to_end(tmp_path):
    from examples.video_sfm_torch import main
    from siftmetal_tpu_torch.slam.trajectory import camera_centers, load_tum_trajectory
    from siftmetal_tpu_torch.utils.checkpoint import load_map
    from siftmetal_tpu_torch.utils.io import read_pnm

    ate = main(str(tmp_path), device="cpu")
    assert ate < 0.1, ate
    ts, pos = load_tum_trajectory(str(tmp_path / "trajectory_tum.txt"))
    assert len(ts) == 5
    smap = load_map(str(tmp_path / "map.npz"), device="cpu")
    np.testing.assert_allclose(pos, camera_centers(smap.cameras[: smap.n_cameras]), atol=1e-4)
    assert smap.n_cameras == 5
    assert smap.reprojection_rms() < 2.0
    assert read_pnm(str(tmp_path / "frame0.pgm")).shape == (240, 320)
