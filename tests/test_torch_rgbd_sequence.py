"""tests/test_stereo.py::test_rgbd_tracks_metric on the port, through
`Tracker.track_rgbd`. A file of its own, as tests/test_torch_stereo_sequence.py,
so that the test workers split the stereo files."""

import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu_torch import convert
from orbslam3_cpp_fork_tpu_torch.datasets import synthetic
from orbslam3_cpp_fork_tpu_torch.ops.orb import OrbParams
from orbslam3_cpp_fork_tpu_torch.runtime import tracker as tt
from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

BASELINE = 0.2
W, H, FX = 320, 240, 400.0
N_FEAT = 400


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_rgbd_sequence_is_metric():
    """Its scene cropped to 320x240 at 400 px, 400 features (the one-frame
    initialization asks for 300), 20 float renders and their depth maps;
    every frame tracked, unscaled ATE < 0.06 m, |scale - 1| < 0.03."""
    scene = synthetic.make_scene(seed=5, n_points=1500, width=W, height=H, fx=FX)
    Rs, ts = synthetic.smooth_trajectory(n_frames=20, step=0.12, yaw_rate=0.002)
    trk = tt.Tracker(tt.TrackerConfig(
        camera=convert.camera_from_numpy(FX, FX, scene.K[0, 2], scene.K[1, 2]), width=W, height=H,
        sensor=tt.Sensor.RGBD, orb=OrbParams(n_features=N_FEAT), bf=BASELINE * FX, th_depth=BASELINE * 40.0,
        depth_factor=1.0, stereo_init_min_features=300, async_mapping=False, enable_loop_closing=False,
        local_lm_cap=1024, ba_lm_cap=1024, ba_obs_cap=8192,
    ), "cpu")
    poses = [trk.track_rgbd(synthetic.render_frame(scene, R, t), synthetic.render_depth(scene, R, t), 0.05 * i)
             for i, (R, t) in enumerate(zip(Rs, ts))]
    assert trk.state == tt.TrackState.OK and all(p is not None for p in poses)
    ts_est, Twc = trk.export_trajectory()
    res = ate_rmse(ts_est, Twc[:, :3, 3], np.arange(len(Rs)) * 0.05, ts)
    print(f"rgbd 320x240: {res}")
    assert res.n_pairs == len(Rs) and res.rmse < 0.06 and abs(res.scale - 1.0) < 0.03, res
