"""The port's trajectory files, settings loader and mono `System` facade
against the reference's.

`write_tum` / `write_kitti` on the same seeded poses give byte-equal files and
`read_tum` reads them back to the same arrays (1e-6: float32 quaternions on
both sides); `load_settings` on the same YAML text gives the same values; the
`System` facade scales its camera as the reference does and runs the default
(asynchronous) mode end to end on "cpu"; what is not ported is refused by
name.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.ops import camera as jcam
from orbslam3_cpp_fork_tpu.utils import settings as jsettings
from orbslam3_cpp_fork_tpu.utils import trajectory as jtraj
from orbslam3_cpp_fork_tpu_torch.datasets import synthetic
from orbslam3_cpp_fork_tpu_torch.ops.camera import Camera
from orbslam3_cpp_fork_tpu_torch.runtime.system import System
from orbslam3_cpp_fork_tpu_torch.runtime.tracker import Sensor, TrackState
from orbslam3_cpp_fork_tpu_torch.utils import settings as tsettings
from orbslam3_cpp_fork_tpu_torch.utils import trajectory as ttraj
from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

YAML = """%YAML:1.0
File.version: "1.0"
Camera.type: "PinHole"
Camera1.fx: 458.654
Camera1.fy: 457.296
Camera1.cx: 367.215
Camera1.cy: 248.375
Camera1.k1: -0.28340811
Camera1.k2: 0.07395907
Camera1.p1: 0.00019359
Camera1.p2: 0.00001762
Camera.width: 752
Camera.height: 480
Camera.newWidth: 376
Camera.newHeight: 240
Camera.fps: 20
Camera.RGB: 1
ORBextractor.nFeatures: 1200
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""

LEGACY_YAML = """%YAML:1.0
Camera.type: "PinHole"
Camera.fx: 435.2
Camera.fy: 435.2
Camera.cx: 367.45
Camera.cy: 252.2
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 752
Camera.height: 480
Camera.fps: 20.0
Camera.bf: 47.9
Camera.RGB: 1
ThDepth: 35.0
ORBextractor.nFeatures: 1200
"""


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The shapes here are small and two Python threads dispatch at once: with
    the default thread count every op wakes a team of OpenMP threads that spin
    against the other test workers. One intra-op thread is faster."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _poses(seed, n=40):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x, y, z, w = q.T
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = rng.uniform(-5, 5, (n, 3))
    # Rotations by nearly pi and the identity: every branch of the quaternion extraction.
    T[0, :3, :3] = np.eye(3)
    T[1, :3, :3] = np.diag([1.0, -1.0, -1.0])
    T[2, :3, :3] = np.diag([-1.0, 1.0, -1.0])
    T[3, :3, :3] = np.diag([-1.0, -1.0, 1.0])
    return np.sort(rng.uniform(0, 1e4, n)), T


@pytest.mark.parametrize("seed", [0, 1])
def test_trajectory_files_are_byte_equal(tmp_path, seed):
    ts, Twc = _poses(seed)
    for name, args in (("tum", (ts, Twc)), ("kitti", (Twc,))):
        a, b = tmp_path / f"ref.{name}", tmp_path / f"got.{name}"
        getattr(jtraj, f"write_{name}")(str(a), *args)
        getattr(ttraj, f"write_{name}")(str(b), *args)
        assert a.read_bytes() == b.read_bytes(), f"write_{name}: tolerance byte-equal"
        assert len(a.read_text().splitlines()) == len(ts)
    ts_r, T_r = jtraj.read_tum(str(tmp_path / "ref.tum"))
    ts_g, T_g = ttraj.read_tum(str(tmp_path / "ref.tum"))
    assert np.array_equal(ts_g, ts_r) and np.abs(T_g - T_r).max() <= 1e-6, "read_tum: tolerance 1e-6"
    assert np.abs(T_g[:, :3, 3] - Twc[:, :3, 3]).max() <= 1e-6 and np.abs(T_g[:, :3, :3] - Twc[:, :3, :3]).max() <= 1e-5
    empty = tmp_path / "empty.tum"
    empty.write_text("# no poses\n")
    assert ttraj.read_tum(str(empty))[1].shape == (0, 4, 4)
    gt = tmp_path / "gt.csv"
    gt.write_text("#timestamp,p\n1000000000,1.0,2.0,3.0,1,0,0,0\n")
    assert np.array_equal(ttraj.read_euroc_gt(str(gt))[1], jtraj.read_euroc_gt(str(gt))[1])


@pytest.mark.parametrize("text", [YAML, LEGACY_YAML], ids=["v1", "legacy"])
def test_load_settings_matches_the_reference(tmp_path, text):
    p = tmp_path / "settings.yaml"
    p.write_text(text)
    ref, got = jsettings.load_settings(str(p)), tsettings.load_settings(str(p))
    for f in dataclasses.fields(tsettings.Settings):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if f.name == "camera":
            assert isinstance(a, Camera)
            for k in ("fx", "fy", "cx", "cy"):
                assert getattr(a, k) == float(getattr(b, k)), k
            assert np.array_equal(np.asarray(a.dist, np.float32), np.asarray(b.dist))
        else:
            assert a == b, f.name
    assert [f.name for f in dataclasses.fields(tsettings.Settings)] == [f.name for f in dataclasses.fields(jsettings.Settings)]


def test_settings_need_no_yaml_package_until_a_file_is_read(tmp_path, monkeypatch):
    """`yaml` is imported inside the YAML reader only: a Settings object made
    in code works where the package is absent."""
    src = open(tsettings.__file__).read()
    assert "\nimport yaml" not in src and "    import yaml" in src
    monkeypatch.setitem(sys.modules, "yaml", None)  # makes `import yaml` fail
    s = _settings(320, 240)
    assert s.camera.fx == 300.0
    p = tmp_path / "s.yaml"
    p.write_text(YAML)
    with pytest.raises(ImportError):
        tsettings.load_settings(str(p))
    p.write_text(YAML.replace("PinHole", "KannalaBrandt8"))
    monkeypatch.delitem(sys.modules, "yaml")
    kb8 = tsettings.load_settings(str(p)).camera
    assert kb8.kind == "kb8" and kb8.dist[:2] == (float(np.float32(-0.28340811)), float(np.float32(0.07395907)))


def _settings(w, h, camera=None, **kw):
    return tsettings.Settings(
        camera_type="PinHole", camera=camera or Camera.pinhole(300.0, 300.0, w / 2, h / 2), width=w, height=h, fps=30.0, rgb=False,
        n_features=400, scale_factor=1.2, n_levels=8, ini_th_fast=20, min_th_fast=7, **kw,
    )


def test_camera_scaling_matches_the_reference():
    cam = Camera.pinhole(458.654, 457.296, 367.215, 248.375, (-0.2834, 0.0739, 1.9e-4, 1.7e-5, 0.0))
    ref = jcam.Camera.pinhole(458.654, 457.296, 367.215, 248.375, (-0.2834, 0.0739, 1.9e-4, 1.7e-5, 0.0))
    a, b = cam.scaled(0.5, 0.5), ref.scaled(0.5, 0.5)
    c, d = cam.scaled(376 / 752, 200 / 480), ref.scaled(376 / 752, 200 / 480)
    for x, y in ((a, b), (c, d)):
        assert (x.fx, x.fy, x.cx, x.cy) == (float(y.fx), float(y.fy), float(y.cx), float(y.cy)), "tolerance: exact (f32)"
        assert x.dist == cam.dist and x.kind == cam.kind


def test_system_builds_the_tracker_configuration(tmp_path):
    p = tmp_path / "settings.yaml"
    p.write_text(YAML)
    system = System(str(p), Sensor.MONOCULAR, enable_loop_closing=False, device="cpu")
    try:
        cfg = system.tracker.cfg
        assert (cfg.width, cfg.height) == (376, 240) and system.get_image_scale() == 0.5
        assert cfg.camera.fx == float(np.float32(np.float32(458.654) * np.float32(0.5)))
        assert cfg.orb.n_features == 1200 and cfg.kf_max_interval == 20
        assert cfg.async_mapping and system.tracker.pipeline_lag == 2 and system.tracker.worker is not None
        assert system.tracker.device == torch.device("cpu")
        assert system.get_tracking_state() == TrackState.NO_IMAGES_YET and not system.is_lost()
        assert system.get_tracked_map_points().shape == (0,) and system.get_tracked_keypoints_un().shape == (0, 2)
        rgb = np.zeros((480, 752, 3), np.float32)
        rgb[..., 1] = 100.0
        gray = system._preprocess(rgb)
        assert gray.shape == (240, 376) and gray.dtype == np.float32 and np.allclose(gray, 58.7, atol=1e-3)
    finally:
        system.shutdown()
    assert system.is_shutdown() and system.tracker.worker is None
    with pytest.raises(RuntimeError, match="shut down"):
        system.track_monocular(np.zeros((480, 752), np.float32), 0.0)


@pytest.mark.parametrize(
    "kw,item",
    [
        # The two A13 cases (IMU sensors) construct now: they are cases of
        # tests/test_torch_tracker.py::test_unsupported_configs_are_refused.
        # The viewers (A15) are ported: they construct and shut down, and
        # nothing is refused in their name (tests/test_torch_shell.py).
        pytest.param(dict(use_viewer=True), "A15", id="kw2-A15"),
        pytest.param(dict(live_viewer=True), "A15", id="kw3-A15"),
    ],
)
def test_system_refuses_what_is_not_ported(kw, item, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the offline viewer writes viewer_out/ here
    system = System(_settings(320, 240), **{"device": "cpu", "async_mapping": False, **kw})
    assert (system.viewer is not None) == kw.get("use_viewer", False)
    assert (system.live_viewer is not None) == kw.get("live_viewer", False)
    system.shutdown()
    assert system.live_viewer is None
    assert os.path.exists("viewer_out/map.ply") == kw.get("use_viewer", False)


def test_system_loads_an_atlas(tmp_path):
    """System(load_atlas=...) resumes from a checkpoint: the saved maps, the
    keyframe database rebuilt by (map, slot), tracking LOST."""
    from orbslam3_cpp_fork_tpu_torch.models.atlas import Atlas
    from orbslam3_cpp_fork_tpu_torch.models.map_state import MapConfig
    from orbslam3_cpp_fork_tpu_torch.runtime import checkpoint

    import test_torch_atlas

    cfg = System(_settings(320, 240), async_mapping=False, device="cpu").tracker.cfg.map_cfg
    atlas = Atlas(MapConfig(max_keyframes=cfg.max_keyframes, max_landmarks=cfg.max_landmarks,
                            n_features=cfg.n_features, imu_cap=cfg.imu_cap))
    test_torch_atlas.fill_map(atlas.maps[0], np.random.default_rng(0), 5, cfg.n_features + 50, imu=False)
    atlas.create_new_map()
    test_torch_atlas.fill_map(atlas.maps[1], np.random.default_rng(1), 3, cfg.n_features + 50, frame0=20, imu=False)
    path = str(tmp_path / "atlas.npz")
    checkpoint.save_atlas(atlas, path)
    system = System(_settings(320, 240), async_mapping=False, load_atlas=path, device="cpu")
    trk = system.tracker
    assert system.get_tracking_state() == TrackState.LOST and system.atlas.n_maps() == 2
    assert trk.loop_closer.atlas is system.atlas and trk.map.map_id == 1
    assert np.array_equal(trk.atlas.maps[0].kf_R, atlas.maps[0].kf_R)
    rows = sorted(trk.kfdb._desc_store)
    K = cfg.max_keyframes
    assert rows == [0, 1, 2, 3, 4, K, K + 1, K + 2], "database rows by (map, slot)"
    system.shutdown()


def test_system_refuses_unported_calls_and_defaults_to_the_card(tmp_path):
    from orbslam3_cpp_fork_tpu_torch.runtime import checkpoint

    system = System(_settings(320, 240), enable_loop_closing=False, async_mapping=False, device="cpu")
    path = str(tmp_path / "atlas.npz")
    system.save_atlas(path)  # the Atlas is ported: saving writes a checkpoint
    back, extra = checkpoint.load_atlas(path)
    assert back.n_maps() == 1 and extra["kfdb_n_words"] == system.tracker.kfdb.n_words
    img = np.zeros((240, 320), np.float32)
    for call in (lambda: system.track_stereo(img, img, 0.0), lambda: system.track_rgbd(img, img, 0.0)):
        with pytest.raises(ValueError, match="MONOCULAR"):
            call()
    # Localization mode pauses keyframe insertion.
    system.activate_localization_mode()
    assert system.tracker.localization_only
    system.deactivate_localization_mode()
    assert not system.tracker.localization_only
    assert system.tracker.worker is None and system.tracker.pipeline_lag == 0
    system.shutdown(save_atlas_path=str(tmp_path / "at_shutdown.npz"))
    assert checkpoint.load_atlas(str(tmp_path / "at_shutdown.npz"))[0].n_maps() == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            System(_settings(320, 240), enable_loop_closing=False)  # no device given means the card


def test_system_mono_end_to_end_on_the_cpu(tmp_path):
    """The default mode through the facade: a Settings object made in code,
    input at twice the working size (resized, camera scaled), 44 frames of the
    small ring, then shutdown and the three trajectory files."""
    w, h, n = 320, 240, 44
    scene = synthetic.make_ring_scene(seed=7, n_points=900, size_range=(5, 9), width=w, height=h)
    Rs, ts = synthetic.circle_trajectory(n_frames=n, radius=2.5, total_angle=0.8 * np.pi * n / 120)
    K = scene.K
    settings = _settings(
        2 * w, 2 * h, Camera.pinhole(2 * K[0, 0], 2 * K[1, 1], 2 * K[0, 2], 2 * K[1, 2]), new_width=w, new_height=h,
    )
    system = System(settings, enable_loop_closing=False, device="cpu")
    trk = system.tracker
    trk.cfg.pipeline_min_kfs, trk.cfg.young_map_kfs = 4, 6
    trk.cfg.map_wait_budget_ms = 5000.0  # a loaded test machine must not starve the tracker of its frontier
    trk.cfg.local_lm_cap = trk.cfg.ba_lm_cap = 1024
    trk.cfg.ba_obs_cap = 8192
    assert trk.cfg.camera.fx == float(np.float32(K[0, 0])) and (trk.cfg.width, trk.cfg.height) == (w, h)
    for i in range(n):
        img = synthetic.render_frame(scene, Rs[i], ts[i])
        big = np.repeat(np.repeat(img, 2, axis=0), 2, axis=1)  # the facade halves it again
        system.track_monocular(big, 0.05 * i)
    assert system.get_tracking_state() == TrackState.OK and not system.is_lost() and not system.map_changed()
    lm = system.get_tracked_map_points()
    assert lm.shape == (400,) and (lm >= 0).sum() > 30 and system.get_tracked_keypoints_un().shape == (400, 2)
    worker = trk.worker
    stats = system.shutdown()
    assert trk.worker is None and not worker._thread.is_alive() and worker.n_processed >= 1
    assert stats["track_total"]["count"] == n and "map_step" in stats
    assert trk.n_pipelined_frames > 5 and trk.n_lost_events == 0 and not trk._pipe

    system.save_trajectory_tum(str(tmp_path / "f.tum"))
    system.save_keyframe_trajectory_tum(str(tmp_path / "kf.tum"))
    system.save_trajectory_kitti(str(tmp_path / "f.kitti"))
    ts_est, Twc = ttraj.read_tum(str(tmp_path / "f.tum"))
    assert len(ts_est) > 0.8 * n and np.all(np.diff(ts_est) > 0)
    assert len((tmp_path / "f.kitti").read_text().splitlines()) == len(ts_est)
    ts_kf, _ = ttraj.read_tum(str(tmp_path / "kf.tum"))
    assert len(ts_kf) == trk.map.n_keyframes() and np.all(np.diff(ts_kf) > 0)
    ate = ate_rmse(ts_est, Twc[:, :3, 3], np.arange(n) * 0.05, ts)
    assert ate.rmse_scaled < 0.15, ate  # a 0.9 m arc; the bar of the 48-frame case of test_torch_pipeline.py is relative


def test_shutdown_reraises_a_failure_of_the_mapping_thread():
    w, h = 320, 240
    scene = synthetic.make_ring_scene(seed=7, n_points=900, size_range=(5, 9), width=w, height=h)
    Rs, ts = synthetic.circle_trajectory(n_frames=30, radius=2.5, total_angle=0.8 * np.pi * 30 / 120)
    K = scene.K
    system = System(
        _settings(w, h, Camera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2])), enable_loop_closing=False, device="cpu",
    )
    trk = system.tracker
    trk.cfg.young_map_kfs = 0
    trk.cfg.map_wait_budget_ms = 0.0  # race freely: only shutdown can surface the failure

    def boom(k, map_ref):
        raise RuntimeError("mapping step failed on purpose")

    trk._mapping_step = boom
    worker = trk.worker
    for i in range(16):
        system.track_monocular(synthetic.render_frame(scene, Rs[i], ts[i]), 0.05 * i)
    assert trk.n_kf_inserted >= 3
    with pytest.raises(RuntimeError, match="on purpose"):
        system.shutdown()
    assert not worker._thread.is_alive(), "the thread is stopped even though shutdown raised"


# ------------------------------------------------------------- stereo, RGB-D


def _stereo_scene():
    return synthetic.make_scene(seed=5, n_points=1500, width=320, height=240, fx=400.0)


@pytest.mark.parametrize("sensor,async_mapping", [(Sensor.STEREO, False), (Sensor.RGBD, False), (Sensor.STEREO, True)])
def test_system_tracks_stereo_and_rgbd(sensor, async_mapping):
    """STEREO and RGBD Systems (refused until A11) are built from settings
    (bf, ThDepth, DepthMapFactor), track two frames through the facade and
    shut down."""
    scene = _stereo_scene()
    Rs, ts = synthetic.smooth_trajectory(n_frames=2, step=0.12, yaw_rate=0.002)
    s = _settings(320, 240, Camera.pinhole(400.0, 400.0, 160.0, 120.0), bf=80.0, stereo_th_depth=40.0,
                  depth_map_factor=5000.0)
    system = System(s, sensor, async_mapping=async_mapping, device="cpu")
    trk = system.tracker
    cfg = trk.cfg
    assert cfg.sensor == sensor and cfg.bf == 80.0 and cfg.th_depth == 8.0 and cfg.depth_factor == 1.0 / 5000.0
    cfg.stereo_init_min_features = 300
    cfg.local_lm_cap = cfg.ba_lm_cap = 1024
    cfg.ba_obs_cap = 8192
    try:
        for i in range(2):
            img = synthetic.render_frame(scene, Rs[i], ts[i])
            if sensor == Sensor.STEREO:
                T = system.track_stereo(img, synthetic.render_frame(scene, *synthetic.stereo_right_pose(Rs[i], ts[i], 0.2)), 0.05 * i)
            else:
                T = system.track_rgbd(img, synthetic.render_depth(scene, Rs[i], ts[i]) * 5000.0, 0.05 * i)
            assert T is not None and system.get_tracking_state() == TrackState.OK, i
        assert trk.loop_closer.cfg.fix_scale and (trk.worker is not None) == async_mapping
        with pytest.raises(ValueError, match=sensor.name):
            system.track_monocular(img, 1.0)
    finally:
        system.shutdown()


@pytest.fixture(scope="module")
def pinhole_rig():
    """The EuRoC-like unrectified rig of tests/test_rectify.py."""
    from orbslam3_cpp_fork_tpu_torch.utils import rectify

    K1 = np.array([[458.0, 0, 367.2], [0, 457.3, 248.4], [0, 0, 1.0]])
    K2 = np.array([[457.6, 0, 379.9], [0, 456.1, 255.2], [0, 0, 1.0]])
    dist1 = np.array([-0.28, 0.074, 1.8e-4, 1.5e-5, 0.0])
    dist2 = np.array([-0.284, 0.076, -1.0e-4, 2.0e-5, 0.0])
    T = np.eye(4)
    T[:3, :3] = rectify._rodrigues_inv(np.array([0.004, -0.015, 0.008]))
    T[:3, 3] = [0.110, 0.0004, -0.0008]
    return K1, dist1, K2, dist2, T


def test_system_wires_rectification(pinhole_rig):
    """tests/test_rectify.py::test_system_wires_rectification on the port:
    the tracker gets the rectified linear camera and bf = baseline * fx, and
    a raw pair runs through `remap_bilinear` and stereo tracking."""
    K1, dist1, K2, dist2, T = pinhole_rig
    s = tsettings.Settings(
        camera_type="PinHole", camera=Camera.pinhole(K1[0, 0], K1[1, 1], K1[0, 2], K1[1, 2], dist=dist1),
        camera2=Camera.pinhole(K2[0, 0], K2[1, 1], K2[0, 2], K2[1, 2], dist=dist2), width=752, height=480, fps=20.0,
        rgb=False, n_features=500, scale_factor=1.2, n_levels=4, ini_th_fast=20, min_th_fast=7, Tlr=T,
        stereo_th_depth=35.0,
    )
    system = System(s, Sensor.STEREO, async_mapping=False, enable_loop_closing=False, device="cpu")
    try:
        assert system._rect is not None
        cam = system.tracker.cfg.camera
        assert max(abs(d) for d in cam.dist) == 0.0
        assert system.tracker.cfg.bf == pytest.approx(system._rect.baseline * cam.fx, rel=1e-6)
        img = np.random.default_rng(0).uniform(0, 255, (480, 752)).astype(np.float32)
        system.track_stereo(img, img, 0.0)
        l, r = system._remap_pair(img, img)
        assert l.shape == (480, 752) and np.isfinite(l).all() and np.isfinite(r).all() and (l > 0).mean() > 0.9
    finally:
        system.shutdown()


def test_system_legacy_rectification(tmp_path):
    """tests/test_rectify_legacy.py on the port: LEFT./RIGHT. K, D, R, P."""
    from test_settings_io import LEGACY_YAML as LEGACY_RECT_YAML

    p = tmp_path / "legacy.yaml"
    p.write_text(LEGACY_RECT_YAML)
    system = System(tsettings.load_settings(str(p)), Sensor.STEREO, async_mapping=False, enable_loop_closing=False,
                    device="cpu")
    try:
        assert system._rect is not None
        assert system.tracker.cfg.bf == pytest.approx(47.90639384423901, rel=1e-6)
        assert system.tracker.cfg.camera.fx == pytest.approx(435.2047, rel=1e-5)
        img = np.random.default_rng(1).uniform(0, 255, (480, 752)).astype(np.float32)
        system.track_stereo(img, img, 0.0)
    finally:
        system.shutdown()


TUMVI_YAML = """%YAML:1.0
File.version: "1.0"
Camera.type: "KannalaBrandt8"
Camera1.fx: 190.978477
Camera1.fy: 190.973307
Camera1.cx: 254.931706
Camera1.cy: 256.897443
Camera1.k1: 0.003482
Camera1.k2: 0.000715
Camera1.k3: -0.002053
Camera1.k4: 0.000202
Camera2.fx: 190.44237
Camera2.fy: 190.434438
Camera2.cx: 252.599497
Camera2.cy: 254.917231
Camera2.k1: 0.003400
Camera2.k2: 0.001766
Camera2.k3: -0.002663
Camera2.k4: 0.000330
Stereo.T_c1_c2: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [0.999999, 0.000792, 0.000694, 0.101063,
         -0.000823, 0.998899, 0.046895, 0.001946,
         -0.000656, -0.046896, 0.998900, 0.001015,
         0.0, 0.0, 0.0, 1.0]
Camera1.overlappingBegin: 0
Camera1.overlappingEnd: 511
Camera2.overlappingBegin: 0
Camera2.overlappingEnd: 511
Camera.width: 512
Camera.height: 512
Camera.fps: 20
Camera.RGB: 1
ORBextractor.nFeatures: 256
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def test_tumvi_settings_build_system(tmp_path):
    """tests/test_fisheye_stereo.py::test_tumvi_settings_build_system on the
    port, with the visual STEREO sensor (its IMU_STEREO case is one of
    tests/test_torch_tracker.py::test_unsupported_configs_are_refused): a
    KB8 rig builds the fisheye stereo configuration and tracks a pair."""
    p = tmp_path / "tumvi.yaml"
    p.write_text(TUMVI_YAML)
    system = System(str(p), Sensor.STEREO, async_mapping=False, enable_loop_closing=False, device="cpu")
    try:
        cfg = system.tracker.cfg
        assert cfg.camera.kind == cfg.camera2.kind == "kb8"
        assert abs(cfg.bf - 0.1011 * 190.978477) / cfg.bf < 0.01 and cfg.lapping_l == (0.0, 511.0)
        assert np.allclose(cfg.R_rl @ cfg.R_rl.T, np.eye(3), atol=1e-5) and abs(np.linalg.norm(cfg.t_rl) - 0.1011) < 1e-3
        img = np.random.default_rng(2).uniform(0, 255, (512, 512)).astype(np.float32)
        system.track_stereo(img, img, 0.0)
    finally:
        system.shutdown()


def test_system_resets_and_changes_dataset():
    """System::Reset, ResetActiveMap and ChangeDataset: a fresh tracker on
    the same device; a map of fewer than 10 keyframes rebuilt under its id;
    the next sequence's first frame does not trip the timestamp guard."""
    system = System(_settings(320, 240), async_mapping=True, device="cpu")
    old = system.tracker
    system.reset()
    assert system.tracker is not old and old.worker is None and old.loop_worker is None
    assert system.tracker.device == old.device and system.tracker.worker is not None
    trk = system.tracker
    trk.last = type("F", (), {"timestamp": 5.0})()
    system.change_dataset()
    assert trk.last is None and system.atlas.n_maps() == 1 and trk.state == TrackState.NO_IMAGES_YET
    system.reset_active_map()
    assert system.atlas.n_maps() == 1 and system.atlas.active.map_id == 0
    system.shutdown()


def test_imu_stereo_rectified_rig_carries_tbc(pinhole_rig):
    """IMU_STEREO on the unrectified pinhole rig: the rectifying rotation R1
    reaches the IMU extrinsic (Tbc T_u1_r1, src/Settings.cc:524-530), and the
    tracker's Tbc, bf and rectified camera equal the reference's from the
    same settings (1e-6)."""
    from orbslam3_cpp_fork_tpu.runtime import system as jsys
    from orbslam3_cpp_fork_tpu.runtime.tracker import Sensor as JSensor

    K1, dist1, K2, dist2, T = pinhole_rig
    Tbc = np.eye(4, dtype=np.float32)
    Tbc[:3, :3] = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    Tbc[:3, 3] = [-0.02, 0.06, 0.01]
    runs = []
    for cam_mod, smod, sys_cls, sensor, kw in (
        (jcam, jsettings, jsys.System, JSensor.IMU_STEREO, {}),
        (None, tsettings, System, Sensor.IMU_STEREO, dict(enable_loop_closing=False, device="cpu")),
    ):
        pin = cam_mod.Camera.pinhole if cam_mod is not None else Camera.pinhole
        s = smod.Settings(
            camera_type="PinHole", camera=pin(K1[0, 0], K1[1, 1], K1[0, 2], K1[1, 2], dist=tuple(dist1)),
            camera2=pin(K2[0, 0], K2[1, 1], K2[0, 2], K2[1, 2], dist=tuple(dist2)), width=752, height=480, fps=20.0,
            rgb=False, n_features=500, scale_factor=1.2, n_levels=4, ini_th_fast=20, min_th_fast=7, Tlr=T,
            stereo_th_depth=35.0,
            imu=smod.ImuSettings(noise_gyro=1.7e-4, noise_acc=2e-3, walk_gyro=1.9e-5, walk_acc=3e-3, frequency=200.0,
                                 Tbc=Tbc),
        )
        system = sys_cls(s, sensor, async_mapping=False, **kw)
        cfg = system.tracker.cfg
        runs.append((np.asarray(cfg.imu.Tbc, np.float64), float(cfg.bf),
                     np.array([cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy], np.float64)))
        system.shutdown()
    (Tr, bfr, camr), (Tg, bfg, camg) = runs
    assert not np.allclose(Tg, Tbc)  # R1 is not the identity on this rig
    assert np.abs(Tg - Tr).max() <= 1e-6 and abs(bfg - bfr) <= 1e-6 * bfr and np.abs(camg - camr).max() <= 1e-4
