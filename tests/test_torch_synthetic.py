"""The port's synthetic sequences (datasets/synthetic.py, numpy) against
the JAX reference's: `render_sequence` frames equal bit for bit, and
`imu_from_trajectory`'s rows (acc, gyro, dt per frame interval) within 1e-5
(absolute, f32), on a circle and on a smooth random walk.
"""

import numpy as np
import pytest

from orbslam3_cpp_fork_tpu.datasets import synthetic as jsyn
from orbslam3_cpp_fork_tpu_torch.datasets import synthetic as tsyn

TOL_IMU = 1e-5


def test_render_sequence_equals_the_reference():
    scene = tsyn.make_ring_scene(seed=7, n_points=300, size_range=(9, 15), width=160, height=120)
    Rs, ts = tsyn.circle_trajectory(n_frames=4, radius=2.5, total_angle=0.3)
    got = tsyn.render_sequence(scene, Rs, ts)
    ref = jsyn.render_sequence(jsyn.make_ring_scene(seed=7, n_points=300, size_range=(9, 15), width=160, height=120),
                               Rs, ts)
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and np.array_equal(g, r), "tolerance: exact"
    assert np.array_equal(got[2], tsyn.render_frame(scene, Rs[2], ts[2]))


@pytest.mark.parametrize("path", ["circle", "smooth"])
def test_imu_from_trajectory_equals_the_reference(path):
    if path == "circle":
        Rs, ts = tsyn.circle_trajectory(n_frames=6, radius=2.0, total_angle=0.6)
    else:
        Rs, ts = tsyn.smooth_trajectory(n_frames=6, step=0.08, yaw_rate=0.05)
    got = tsyn.imu_from_trajectory(Rs, ts, 0.1)
    ref = jsyn.imu_from_trajectory(Rs, ts, 0.1)
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            assert a.dtype == np.float32 and a.shape == b.shape == (20, 3)[: a.ndim]
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL_IMU)
    # The rows integrate to the trajectory: gravity removed, the mean
    # specific force of an interval is the body-frame acceleration.
    acc, gyro, dt = got[2]
    assert np.isclose(dt.sum(), 0.1, atol=1e-6) and np.allclose(gyro, gyro[0])


def test_so3_log_np_inverts_so3_exp_np():
    rng = np.random.default_rng(0)
    for w in [*rng.normal(size=(20, 3)).astype(np.float32), np.zeros(3, np.float32), np.float32([1e-7, 0, 0])]:
        w = w * np.float32(min(1.0, 3.0 / max(np.linalg.norm(w), 1e-12)))
        np.testing.assert_allclose(tsyn._so3_log_np(tsyn._so3_exp_np(w)), w, atol=1e-5)
