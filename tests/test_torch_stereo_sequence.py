"""tests/test_stereo.py::test_stereo_tracks_metric on the port, from its own
images (the full entry point: extraction, matching, tracking) on the rig of
tests/test_torch_stereo_tracker.py: 20 float renders (as tests/test_stereo.py
feeds them), every frame tracked, unscaled ATE < 0.06 m, |scale - 1| < 0.03.
A file of its own, as tests/test_torch_rgbd_sequence.py, so that the test
workers split the stereo files."""

import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu_torch.datasets import synthetic
from orbslam3_cpp_fork_tpu_torch.runtime import tracker as tt
from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse
from test_torch_stereo_tracker import ATE_M, BASELINE, FX, H, N_FRAMES, SCALE_TOL, W, port_tracker


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_stereo_sequence_is_metric():
    scene = synthetic.make_scene(seed=5, n_points=1500, width=W, height=H, fx=FX)
    Rs, ts = synthetic.smooth_trajectory(n_frames=N_FRAMES, step=0.12, yaw_rate=0.002)
    trk = port_tracker(scene)
    poses = [
        trk.track_stereo(synthetic.render_frame(scene, R, t),
                         synthetic.render_frame(scene, *synthetic.stereo_right_pose(R, t, BASELINE)), 0.05 * i)
        for i, (R, t) in enumerate(zip(Rs, ts))
    ]
    assert trk.state == tt.TrackState.OK and all(p is not None for p in poses), "every frame tracked from the first"
    assert trk.loop_closer is None and trk.n_fused_declined == 0 and trk.n_pipelined_frames == 0
    ts_est, Twc = trk.export_trajectory()
    res = ate_rmse(ts_est, Twc[:, :3, 3], np.arange(N_FRAMES) * 0.05, ts)
    print(f"stereo 320x240: {res}")
    assert res.n_pairs == N_FRAMES and res.rmse < ATE_M and abs(res.scale - 1.0) < SCALE_TOL, res
