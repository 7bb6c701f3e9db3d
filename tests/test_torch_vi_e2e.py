"""tests/test_vi_tracking_e2e.py on the port (slow): the mono-inertial
regression on its 70-frame bobbing circle at 640x480 with 600 features, the
IMU init ladder recovering metric scale and a gravity-aligned world, the
default mode (mapping worker), and FullInertialBA on the global-BA thread
patching a keyframe inserted during its solve.

`-k full_width` runs the reference and the port at the chip smoke's sizes
(the inertial phase's parts A and C) on the CPU and prints the numbers
behind that phase's ATE gates:

    python -m pytest -m slow -rP tests/test_torch_vi_e2e.py -k full_width
"""

import threading
import time

import numpy as np
import pytest

from orbslam3_cpp_fork_tpu.datasets import synthetic as jsyn
from orbslam3_cpp_fork_tpu_torch import convert
from orbslam3_cpp_fork_tpu_torch.ops.orb import OrbParams
from orbslam3_cpp_fork_tpu_torch.runtime.tracker import ImuSettings, Sensor, Tracker, TrackerConfig, TrackState
from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

import test_vi_tracking_e2e as vie
import vi_rig

pytestmark = pytest.mark.slow


def _port_cfg(scene, **kw):
    K = scene.K
    return TrackerConfig(
        camera=convert.camera_from_numpy(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), width=scene.width,
        height=scene.height, sensor=Sensor.IMU_MONOCULAR, orb=OrbParams(n_features=600),
        imu=ImuSettings(freq=vie.IMU_HZ), enable_loop_closing=False, **vi_rig.LADDER, **kw,
    )


def _run(async_mapping):
    scene = jsyn.make_ring_scene(seed=5)
    stamps, Rs, ts, frames, rows = vi_rig.bob_sequence(70, scene, u8=False)
    trk = Tracker(_port_cfg(scene, async_mapping=async_mapping), "cpu")
    poses = [trk.track(frames[i], float(stamps[i]), imu=rows[i]) for i in range(70)]
    trk.flush_mapping()
    return trk, stamps, poses, Rs, ts


@pytest.fixture(scope="module")
def vi_tracked():
    return _run(False)


def test_vi_initializes_imu(vi_tracked):
    tracker, stamps, poses, Rs, ts = vi_tracked
    assert tracker.state == TrackState.OK
    assert tracker.map.imu_stage >= 1, "IMU never initialized"
    assert sum(p is not None for p in poses) > 50


def test_vi_metric_scale(vi_tracked):
    tracker, stamps, poses, Rs, ts = vi_tracked
    ts_est, Twc = tracker.export_trajectory()
    res = ate_rmse(ts_est, Twc[:, :3, 3], stamps, ts)
    print(f"port mono-inertial 640x480: {res}")
    assert res.n_pairs > 40
    assert abs(res.scale - 1.0) < 0.12, f"scale off: {res.scale}"
    assert res.rmse_scaled < 0.10, res


def test_vi_gravity_aligned(vi_tracked):
    tracker, stamps, poses, Rs, ts = vi_tracked
    _, Twc = tracker.export_trajectory()
    pos = Twc[:, :3, 3] - Twc[:, :3, 3].mean(0)
    normal = np.linalg.svd(pos)[2][2]
    assert abs(normal[2]) > 0.98, normal


def test_vi_async_pipeline_metric_scale(monkeypatch):
    """The default mode (the mapping worker) at the reference test's reduced
    rotation rate: the ladder runs on the worker against shim frames."""
    monkeypatch.setattr(vie, "OMEGA", 0.22)
    trk, stamps, poses, Rs, ts = _run(True)
    try:
        assert trk.worker is not None
        assert trk.state == TrackState.OK and trk.map.imu_stage >= 1
        assert sum(p is not None for p in poses) > 50
        ts_est, Twc = trk.export_trajectory()
        res = ate_rmse(ts_est, Twc[:, :3, 3], stamps, ts)
        assert res.n_pairs > 40 and abs(res.scale - 1.0) < 0.2 and res.rmse_scaled < 0.15, res
    finally:
        trk.worker.stop()


def test_vi_global_ba_background_patches_new_keyframe(vi_tracked):
    """FullInertialBA on the global-BA thread: the launch does not block, a
    keyframe inserted during the solve is patched through its anchor at
    apply time, and the VI state is written back."""
    tracker, stamps, poses, Rs, ts = vi_tracked
    m = tracker.map
    k_last = int(np.nonzero(m.kf_valid)[0][-1])
    inserted, applied = threading.Event(), threading.Event()
    orig_apply = Tracker._gba_apply

    def gated_apply(self, snap, R_new, t_new, X_new):
        assert inserted.wait(timeout=60)
        r = orig_apply(self, snap, R_new, t_new, X_new)
        applied.set()
        return r

    Tracker._gba_apply = gated_apply
    big0 = m.big_change_idx
    try:
        t0 = time.perf_counter()
        tracker._vi_global_ba_background(k_last)
        assert time.perf_counter() - t0 < 5.0 and tracker._gba_thread is not None
        anchor = k_last
        R_rel = np.eye(3, dtype=np.float32)
        t_rel = np.array([0.03, 0.0, 0.0], np.float32)
        nf = m.cfg.n_features
        j = m.add_keyframe(
            (R_rel @ m.kf_R[anchor]).astype(np.float32), (R_rel @ m.kf_t[anchor] + t_rel).astype(np.float32),
            m.kf_xy[anchor], m.kf_level[anchor], m.kf_angle[anchor], m.kf_desc[anchor], m.kf_feat_valid[anchor],
            np.full(nf, -1, np.int32), 999.0, 99999,
        )
        seen = m.kf_lm_idx[anchor][m.kf_lm_idx[anchor] >= 0][:50]
        m.obs[j, seen] = True
        m.mark_obs_dirty()
        inserted.set()
        assert applied.wait(timeout=300), "background VI BA never applied"
        tracker._join_global_ba()
    finally:
        Tracker._gba_apply = orig_apply
        inserted.set()
    assert np.allclose(m.kf_R[j], R_rel @ m.kf_R[anchor], atol=1e-4)
    assert np.allclose(m.kf_t[j], R_rel @ m.kf_t[anchor] + t_rel, atol=1e-4)
    assert m.big_change_idx == big0 + 1
    assert np.isfinite(m.kf_vel[np.nonzero(m.kf_valid)[0]]).all()


@pytest.mark.parametrize("impl", ["jax", "port"])
@pytest.mark.parametrize("kind,size,n", [("mono", (752, 480), 70), ("stereo", (752, 480), 70),
                                         ("stereo", (640, 480), 70), ("stereo", (640, 480), 40)])
def test_full_width(impl, kind, size, n):
    """The inertial phase's scenes on the CPU, synchronous, 1000 features,
    uint8 frames: IMU_MONOCULAR at 752x480 over 70 frames (part A),
    IMU_STEREO at 752x480 and at the test's own 640x480 over 70 frames, and
    at 640x480 over the 40 frames part C runs. Prints the stages reached,
    the frames tracked, the scale and the unscaled and scale-aligned ATE."""
    from orbslam3_cpp_fork_tpu.runtime.tracker import Tracker as JTracker
    from orbslam3_cpp_fork_tpu.utils.evaluation import ate_rmse as j_ate

    scene = jsyn.make_ring_scene(seed=5, width=size[0], height=size[1])
    stamps, Rs, ts, frames, rows = vi_rig.bob_sequence(n, scene, kind)
    cref, cport = vi_rig.configs(scene, "IMU_MONOCULAR" if kind == "mono" else "IMU_STEREO", 1000,
                                 enable_loop_closing=False, async_mapping=False)
    trk = JTracker(cref) if impl == "jax" else Tracker(cport, "cpu")
    stages, poses = {}, []
    for i in range(n):
        poses.append(vi_rig.step(trk, kind, frames[i], stamps[i], rows[i]))
        stages.setdefault(int(trk.map.imu_stage), i)
    ts_est, Twc = trk.export_trajectory()
    res = j_ate(ts_est, Twc[:, :3, 3], stamps, ts)
    print(f"{impl} IMU_{kind.upper()} {size[0]}x{size[1]}, {n} frames: stages at frames {stages}, "
          f"{sum(p is not None for p in poses)}/{n} tracked, scale {res.scale!r}, unscaled ATE {res.rmse!r} m, "
          f"scale-aligned ATE {res.rmse_scaled!r} m")
    assert trk.map.imu_stage >= 1 and sum(p is not None for p in poses) > 0.7 * n
