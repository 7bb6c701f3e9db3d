"""The port's synchronous monocular Tracker (runtime/tracker.py).

(a) initial map: the features of the JAX `extract_orb` on two rendered
    frames go through both trackers' `_initialize` with the same RANSAC index
    sets; (b) one `_mapping_step` on a map loaded into both through
    `convert.map_state_from_numpy`; (c) the slice as a whole, port only, on
    the scene of tests/test_tracking_e2e.py; (d) the inertial configurations,
    once refused, construct with the reference's settings, and the
    asynchronous ones construct. A JAX-vs-port run of the whole sequence is marked
    slow.

Cut to size for the CPU: 600 features (as the reference's e2e test), a map
of 32 keyframe and 4096 landmark slots; every other capacity is the default.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.models import map_state as jms
from orbslam3_cpp_fork_tpu.ops import camera as jcam
from orbslam3_cpp_fork_tpu.ops import orb as jorb
from orbslam3_cpp_fork_tpu.ops import ransac as jransac
from orbslam3_cpp_fork_tpu.runtime import tracker as jt
from orbslam3_cpp_fork_tpu_torch import convert
from orbslam3_cpp_fork_tpu_torch.datasets import synthetic
from orbslam3_cpp_fork_tpu_torch.models.map_state import MapConfig
from orbslam3_cpp_fork_tpu_torch.ops.orb import OrbParams
from orbslam3_cpp_fork_tpu_torch.runtime import tracker as tt
from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

N_FRAMES = 40
MAP_CFG = dict(max_keyframes=32, max_landmarks=4096)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the whole file. Its small ops gain nothing
    from a team of threads, and beside the other test workers a team of 8
    spinning threads a process made the cold start's fixture ~13x slower
    than alone (PERF.md, Findings PR 9)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sequence():
    scene = synthetic.make_scene(seed=3)
    Rs, ts = synthetic.smooth_trajectory(n_frames=N_FRAMES, step=0.12, yaw_rate=0.002)
    frames = synthetic.render_sequence(scene, Rs, ts)
    return scene, Rs, ts, frames


def port_tracker(scene, n_features, **kw):
    K = scene.K
    cfg = tt.TrackerConfig(
        camera=convert.camera_from_numpy(K[0, 0], K[1, 1], K[0, 2], K[1, 2]),
        width=scene.width, height=scene.height, orb=OrbParams(n_features=n_features),
        async_mapping=False, enable_loop_closing=False, map_cfg=MapConfig(**MAP_CFG), **kw,
    )
    return tt.MonoTracker(cfg, "cpu")


def ref_tracker(scene, n_features):
    K = scene.K
    cfg = jt.TrackerConfig(
        camera=jcam.Camera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]),
        width=scene.width, height=scene.height, orb=jorb.OrbParams(n_features=n_features),
        async_mapping=False, enable_loop_closing=False, mapping_backend="cpu", map_cfg=jms.MapConfig(**MAP_CFG),
    )
    return jt.MonoTracker(cfg)


def jax_features(img, n_features):
    """The reference extractor's features of one frame, as host arrays."""
    f = jorb.extract_orb_jit(jnp.asarray(np.clip(img, 0, 255).astype(np.uint8), jnp.float32), jorb.OrbParams(n_features=n_features))
    desc = np.asarray(f.desc)
    return dict(
        xy=np.asarray(f.xy), level=np.asarray(f.level), angle=np.asarray(f.angle), desc=desc,
        desc_i8=np.unpackbits(desc.view(np.uint8), axis=-1, bitorder="little").astype(np.int8),
        valid=np.asarray(f.valid),
    )


def frame_of(mod, feats, frame_id, ts):
    n = len(feats["valid"])
    return mod.FrameData(
        frame_id=frame_id, timestamp=ts, lm_idx=np.full(n, -1, np.int32),
        ur=np.full(n, -1.0, np.float32), depth=np.full(n, -1.0, np.float32), **{k: v.copy() for k, v in feats.items()},
    )


# --------------------------------------------------------------------- (a)


def test_initial_map_parity(sequence):
    scene, Rs, ts, frames = sequence
    n_feat = 600
    f0, f1 = jax_features(frames[0], n_feat), jax_features(frames[2], n_feat)
    ref = ref_tracker(scene, n_feat)
    got = port_tracker(scene, n_feat)
    # The reference draws its hypotheses from the key its first `_next_key`
    # returns; the port gets the same index sets.
    key = jax.random.split(jax.random.PRNGKey(0))[1]
    got._sample_hypotheses = lambda valid: torch.from_numpy(
        np.asarray(jransac._sample_indices(key, 256, 8, jnp.asarray(valid.numpy()))).astype(np.int64)
    )
    for trk, mod in ((ref, jt), (got, tt)):
        for feats, fid in ((f0, 0), (f1, 2)):
            frame = frame_of(mod, feats, fid, 0.05 * fid)
            trk.frame_id = fid
            trk._initialize(frame)
    assert ref.state == jt.TrackState.OK and got.state == tt.TrackState.OK
    mr, mg = ref.map, got.map
    assert mg.n_keyframes() == mr.n_keyframes() == 2
    assert mg.n_landmarks() == mr.n_landmarks() > 100, "same landmark count"
    assert np.array_equal(mg.kf_lm_idx[:2], mr.kf_lm_idx[:2]), "same bindings"
    assert np.abs(mg.kf_R[:2] - mr.kf_R[:2]).max() <= 1e-4, "tolerance: poses 1e-4"
    assert np.abs(mg.kf_t[:2] - mr.kf_t[:2]).max() <= 1e-4, "tolerance: poses 1e-4"
    v = mr.lm_valid
    rel = np.linalg.norm(mg.lm_pos[v] - mr.lm_pos[v], axis=1) / np.linalg.norm(mr.lm_pos[v], axis=1)
    assert rel.max() <= 1e-3, "tolerance: positions 1e-3 relative after the two-keyframe BA"
    assert np.array_equal(mg.lm_desc[v], mr.lm_desc[v])
    # Unit median depth, and the second keyframe moved.
    z = mg.lm_pos[v][:, 2]
    assert abs(np.median(z) - 1.0) < 0.05 and np.linalg.norm(mg.kf_t[1]) > 1e-3


# --------------------------------------------------------------------- (c)


@pytest.fixture(scope="module")
def tracked(sequence):
    """The port over the whole sequence; the map and the frame of the 5th
    keyframe insertion are kept aside for the mapping-step test."""
    scene, Rs, ts, frames = sequence
    trk = port_tracker(scene, 600)
    snap = {}
    insert = trk._insert_keyframe

    def spy(frame):
        if trk.n_kf_inserted == 5 and not snap:
            snap["map"] = convert.map_state_to_numpy(trk.map)
            snap["frame"] = dict(
                R=frame.R.copy(), t=frame.t.copy(), xy=frame.xy.copy(), level=frame.level.copy(),
                angle=frame.angle.copy(), desc=frame.desc.copy(), valid=frame.valid.copy(),
                lm_idx=frame.lm_idx.copy(), timestamp=frame.timestamp, frame_id=frame.frame_id,
            )
            snap["ref_kf"] = trk.ref_kf
        insert(frame)

    trk._insert_keyframe = spy
    stamps = np.arange(N_FRAMES) * 0.05
    poses = [trk.track(f, float(stamps[i])) for i, f in enumerate(frames)]
    return trk, stamps, poses, ts, snap


def test_cold_start_tracks_the_sequence(tracked):
    trk, stamps, poses, ts, _ = tracked
    assert trk.state == tt.TrackState.OK
    assert sum(p is not None for p in poses) > 30
    assert trk.map.n_keyframes() >= 2 and trk.map.n_landmarks() > 100
    assert trk.n_fused_declined == 0 and trk.n_lost_frames == 0
    m = trk.map
    assert np.isfinite(m.kf_R[m.kf_valid]).all() and np.isfinite(m.lm_pos[m.lm_valid]).all()
    T = next(p for p in poses if p is not None)
    assert T.shape == (4, 4) and T.dtype == np.float32


def test_cold_start_ate(tracked):
    trk, stamps, poses, ts, _ = tracked
    ts_est, Twc = trk.export_trajectory()
    assert len(ts_est) > 30
    res = ate_rmse(ts_est, Twc[:, :3, 3], stamps, ts)
    # The trajectory covers ~2.4 m; the reference's own bar.
    assert res.n_pairs > 30 and res.rmse_scaled < 0.05, res


def test_stage_counts(tracked, sequence):
    """The timers show one extraction per frame, one fused tracking call per
    frame after initialization and each mapping stage once per inserted
    keyframe."""
    trk, _, poses, _, _ = tracked
    s = trk.timers.summary()
    n_ok_frames = trk.n_sync_frames
    assert s["track_fused"]["count"] == n_ok_frames and s["orb_extract"]["count"] == N_FRAMES
    n_steps = trk.n_kf_inserted - 2
    assert n_steps >= 1
    for stage in ("map_step", "map_triangulate", "map_cull_lm", "map_cull_kf", "map_local_ba"):
        assert s[stage]["count"] == n_steps, stage


# --------------------------------------------------------------------- (b)


def ref_map_from_numpy(d):
    m = jms.MapState(jms.MapConfig(n_features=d["kf_xy"].shape[1], imu_cap=d["kf_imu"].shape[1], **MAP_CFG))
    for k in convert.MAP_ARRAYS:
        getattr(m, k)[...] = d[k]
    for k in convert.MAP_SCALARS:
        setattr(m, k, d[k])
    m.mark_obs_dirty()
    return m


def test_mapping_step_parity(tracked, sequence):
    scene = sequence[0]
    snap = tracked[4]
    assert snap, "the sequence inserts at least six keyframes"
    fr = snap["frame"]
    ref, got = ref_tracker(scene, 600), port_tracker(scene, 600)
    ref.atlas.maps[ref.atlas.active_idx] = ref_map_from_numpy(snap["map"])
    got.map = convert.map_state_from_numpy(snap["map"])
    new = {}
    for name, trk in (("ref", ref), ("got", got)):
        m = trk.map
        n0 = m.n_landmarks()
        k = m.add_keyframe(
            fr["R"], fr["t"], fr["xy"], fr["level"], fr["angle"], fr["desc"], fr["valid"], fr["lm_idx"],
            fr["timestamp"], fr["frame_id"],
        )
        trk.state = type(trk.state).OK
        trk.ref_kf, trk.n_kf_inserted, trk.last_kf_frame_id, trk.frame_id = k, 6, fr["frame_id"], fr["frame_id"] + 1
        trk._mapping_step(k, map_ref=m)
        new[name] = (k, n0, m)
    (kr, n0r, mr), (kg, n0g, mg) = new["ref"], new["got"]
    assert kr == kg and n0r == n0g
    assert np.array_equal(mg.lm_replaced, mr.lm_replaced), "same fused pairs"
    assert np.array_equal(mg.kf_valid, mr.kf_valid), "same keyframes culled"
    dn_r, dn_g = mr.n_landmarks() - n0r, mg.n_landmarks() - n0g
    assert dn_r > 20 and abs(dn_g - dn_r) <= max(1, 0.01 * dn_r), "tolerance: new-landmark count within 1%"
    assert np.mean(mg.kf_lm_idx == mr.kf_lm_idx) >= 0.999, "tolerance: bindings equal on >= 99.9% of feature slots"
    kv = mr.kf_valid
    moved = np.abs(mr.kf_t[kv] - snap["map"]["kf_t"][kv]).max()
    assert moved > 1e-5, "the window BA moved the keyframes"
    assert np.abs(mg.kf_R[kv] - mr.kf_R[kv]).max() <= 1e-4, "tolerance: BA-moved poses 1e-4"
    assert np.abs(mg.kf_t[kv] - mr.kf_t[kv]).max() <= 1e-4, "tolerance: BA-moved poses 1e-4"
    both = mr.lm_valid & mg.lm_valid
    rel = np.linalg.norm(mg.lm_pos[both] - mr.lm_pos[both], axis=1) / np.linalg.norm(mr.lm_pos[both], axis=1)
    assert np.quantile(rel, 0.99) <= 1e-3, "tolerance: positions 1e-3 relative on 99% of landmarks"


# --------------------------------------------------------------------- (d)


# The IMU block of tests/test_fisheye_stereo.py's TUM-VI settings.
IMU_YAML = """IMU.NoiseGyro: 0.00016
IMU.NoiseAcc: 0.0028
IMU.GyroWalk: 0.000022
IMU.AccWalk: 0.00086
IMU.Frequency: 200.0
IMU.T_b_c1: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [-0.99953, 0.00930, -0.02907, 0.04536,
         0.02941, 0.01216, -0.99949, -0.07139,
         -0.00894, -0.99988, -0.01243, -0.04491,
         0.0, 0.0, 0.0, 1.0]
"""


def _imu_yaml(tmp_path, sensor_name):
    """A settings file with that IMU block: tests/test_torch_system.py's
    EuRoC mono YAML for IMU_MONOCULAR, its TUM-VI KB8 rig for IMU_STEREO
    (tests/test_fisheye_stereo.py:168)."""
    import test_torch_system as ts

    p = tmp_path / "settings.yaml"
    p.write_text((ts.TUMVI_YAML if sensor_name == "IMU_STEREO" else ts.YAML) + IMU_YAML)
    return str(p)


def _same_config(ref, got):
    """The reference's tracker and the port's agree on the sensor, the IMU
    settings and calibration, the body-from-camera extrinsic, bf and the loop
    closer's scale mode (1e-6 on floats, f32 on both sides)."""
    rc, gc = ref.cfg, got.cfg
    assert gc.sensor.name == rc.sensor.name and got.inertial == ref.inertial
    assert abs(gc.bf - float(rc.bf)) <= 1e-6 * max(1.0, abs(float(rc.bf)))
    assert (rc.imu is None) == (gc.imu is None)
    if rc.imu is not None:
        for f in ("noise_gyro", "noise_acc", "walk_gyro", "walk_acc", "freq"):
            assert getattr(gc.imu, f) == getattr(rc.imu, f), f
        assert np.allclose(np.asarray(gc.imu.Tbc), np.asarray(rc.imu.Tbc), atol=1e-6)
    if ref.inertial:
        assert np.allclose(got.Rbc, ref.Rbc, atol=1e-6) and np.allclose(got.tcb, ref.tcb, atol=1e-6)
        for f in ("sigma_gyro", "sigma_acc", "walk_gyro", "walk_acc"):
            assert float(getattr(got.imu_calib, f)) == float(getattr(ref.imu_calib, f)), f
    assert (ref.loop_closer is None) == (got.loop_closer is None)
    if ref.loop_closer is not None:
        assert got.loop_closer.cfg.fix_scale == ref.loop_closer.cfg.fix_scale


@pytest.mark.parametrize(
    "kw,item",
    [
        (dict(sensor="IMU_MONOCULAR"), "A13"),
        (dict(imu=True), "A13"),
        (dict(sensor="IMU_STEREO", bf=80.0), "A13"),
        (dict(sensor="IMU_RGBD", bf=80.0), "A13"),
        pytest.param(dict(system="IMU_MONOCULAR"), "A13", id="system-IMU_MONOCULAR"),
        pytest.param(dict(system="IMU_STEREO"), "A13", id="system-IMU_STEREO"),
    ],
)
def test_unsupported_configs_are_refused(kw, item, tmp_path):
    """The configurations that used to be refused naming ROADMAP `item`
    (A13, the inertial slice) now construct, through Tracker and through
    System (the IMU_STEREO case is the TUM-VI KB8 rig of
    tests/test_fisheye_stereo.py:168, which also tracks a pair), each with
    the reference's configuration from the same settings (`_same_config`).
    The reference's default (loop closing and global BA on, both workers) is
    the port's too."""
    if "system" in kw:
        from orbslam3_cpp_fork_tpu.runtime import system as jsys
        from orbslam3_cpp_fork_tpu_torch.runtime.system import System

        path = _imu_yaml(tmp_path, kw["system"])
        ref = jsys.System(path, jt.Sensor[kw["system"]], async_mapping=False)
        got = System(path, tt.Sensor[kw["system"]], async_mapping=False, device="cpu")
        try:
            _same_config(ref.tracker, got.tracker)
            if kw["system"] == "IMU_STEREO":
                assert got.tracker.cfg.camera2.kind == "kb8" and got.tracker.cfg.lapping_l == (0.0, 511.0)
                img = np.random.default_rng(2).uniform(0, 255, (512, 512)).astype(np.float32)
                got.track_stereo(img, img, 0.0, imu=np.zeros((0, 7), np.float32))
        finally:
            ref.shutdown()
            got.shutdown()
    else:
        cam = dict(camera=(400.0, 400.0, 320.0, 240.0))
        fields = dict(async_mapping=False, enable_loop_closing=True)
        if "sensor" in kw:
            fields["sensor"] = kw["sensor"]
        if "bf" in kw:
            fields["bf"] = kw["bf"]
        imu = kw.get("imu")
        ref = jt.Tracker(jt.TrackerConfig(
            camera=jcam.Camera.pinhole(*cam["camera"]), imu=jt.ImuSettings(freq=100.0) if imu else None,
            **{**fields, "sensor": jt.Sensor[fields.get("sensor", "MONOCULAR")]},
        ))
        got = tt.Tracker(tt.TrackerConfig(
            camera=convert.camera_from_numpy(*cam["camera"]), imu=tt.ImuSettings(freq=100.0) if imu else None,
            **{**fields, "sensor": tt.Sensor[fields.get("sensor", "MONOCULAR")]},
        ), "cpu")
        _same_config(ref, got)
    trk = tt.MonoTracker(tt.TrackerConfig(camera=convert.camera_from_numpy(400, 400, 320, 240)), "cpu")
    try:
        assert trk.cfg.enable_loop_closing and trk.cfg.enable_global_ba
        assert trk.loop_closer is not None and trk.loop_worker is not None and trk.worker is not None
    finally:
        trk.worker.stop()
        trk.loop_worker.stop()


@pytest.mark.parametrize(
    "kw,lag,worker",
    [(dict(), 2, True), (dict(async_mapping=False), 0, False), (dict(async_mapping=False, pipeline_lag=2), 2, False),
     (dict(pipeline_lag=0), 0, True)],
)
def test_async_and_pipelined_configs_construct(kw, lag, worker):
    """The reference's default mode (`async_mapping=True`, `pipeline_lag`
    resolving to 2) constructs, as does every combination of the two."""
    cfg = tt.TrackerConfig(
        camera=convert.camera_from_numpy(400, 400, 320, 240), enable_loop_closing=False,
        orb=OrbParams(n_features=300), map_cfg=MapConfig(max_keyframes=8, max_landmarks=512), **kw,
    )
    ref = jt.TrackerConfig(**kw)
    trk = tt.MonoTracker(cfg, "cpu")
    try:
        assert trk.pipeline_lag == lag == (ref.pipeline_lag if ref.pipeline_lag is not None else (2 if ref.async_mapping else 0))
        assert (trk.worker is not None) == worker
        assert not trk._pipeline_active(), "a young map never pipelines"
        assert trk._min_accept_inliers() == cfg.min_localmap_inliers
    finally:
        if trk.worker is not None:
            trk.worker.stop()


@pytest.mark.parametrize(
    "sensor,kw",
    [
        (tt.Sensor.STEREO, dict(async_mapping=False, enable_loop_closing=False)),
        (tt.Sensor.RGBD, dict(async_mapping=False, enable_loop_closing=False)),
        (tt.Sensor.STEREO, dict()),  # the reference's default: workers, loop closing, global BA
        (tt.Sensor.RGBD, dict()),
    ],
)
def test_stereo_and_rgbd_trackers_track_a_frame(sensor, kw):
    """STEREO and RGBD trackers are built (they were refused until A11),
    initialize from the first frame's depth and track the second; a loop
    closer of either closes loops in SE(3) (fix_scale)."""
    scene = synthetic.make_scene(seed=5, n_points=1500, width=320, height=240, fx=400.0)
    Rs, ts = synthetic.smooth_trajectory(n_frames=2, step=0.12, yaw_rate=0.002)
    trk = tt.Tracker(tt.TrackerConfig(
        camera=convert.camera_from_numpy(400.0, 400.0, 160.0, 120.0), width=320, height=240, sensor=sensor,
        orb=OrbParams(n_features=400), bf=80.0, th_depth=8.0, stereo_init_min_features=300, local_lm_cap=1024,
        ba_lm_cap=1024, ba_obs_cap=8192, map_cfg=MapConfig(max_keyframes=32, max_landmarks=4096), **kw,
    ), "cpu")
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for i in range(2):
            img = synthetic.render_frame(scene, Rs[i], ts[i])
            if sensor == tt.Sensor.STEREO:
                T = trk.track_stereo(img, synthetic.render_frame(scene, *synthetic.stereo_right_pose(Rs[i], ts[i], 0.2)), 0.05 * i)
            else:
                T = trk.track_rgbd(img, synthetic.render_depth(scene, Rs[i], ts[i]), 0.05 * i)
            assert T is not None and trk.state == tt.TrackState.OK, i
        assert trk.map.n_landmarks() > 100 and (trk.last.ur >= 0).sum() > 50 and trk.n_pipelined_frames == 0
        assert (trk.loop_closer is not None) == kw.get("enable_loop_closing", True)
        assert trk.loop_closer is None or trk.loop_closer.cfg.fix_scale
    finally:
        torch.set_num_threads(n_threads)
        if trk.worker is not None:
            trk.worker.stop()
            trk.loop_worker.stop()


def test_supported_config_and_device_default():
    cfg = convert.tracker_config_from_reference(dict(
        camera=dict(fx=400, fy=400, cx=320, cy=240), async_mapping=False, enable_loop_closing=False,
        pipeline_lag=0, sensor="MONOCULAR", mapping_backend="auto", young_map_kfs=12,
        orb=dict(n_features=300), map_cfg=dict(max_keyframes=8, max_landmarks=512),
    ))
    trk = tt.MonoTracker(cfg, "cpu")
    assert trk.device == torch.device("cpu") and trk.map.cfg.n_features == 300
    assert dataclasses.asdict(cfg)["ba_obs_cap"] == jt.TrackerConfig().ba_obs_cap
    for f in dataclasses.fields(tt.TrackerConfig):
        if f.name not in ("camera", "orb", "map_cfg", "sensor", "imu"):
            assert getattr(tt.TrackerConfig(), f.name) == getattr(jt.TrackerConfig(), f.name), f.name
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tt.MonoTracker(cfg)  # no device given means the card


# ------------------------------------------------------------------ slow


@pytest.mark.slow
def test_whole_sequence_against_the_reference(tracked, sequence):
    """The reference's MonoTracker over the same frames: both track the
    sequence, and the two scale-aligned ATEs are printed for PERF.md."""
    scene, Rs, ts, frames = sequence
    trk, stamps, poses, _, _ = tracked
    ref = ref_tracker(scene, 600)
    ref_poses = [ref.track(np.clip(f, 0, 255).astype(np.uint8), float(stamps[i])) for i, f in enumerate(frames)]
    res = []
    for t in (ref, trk):
        ts_est, Twc = t.export_trajectory()
        res.append(ate_rmse(ts_est, Twc[:, :3, 3], stamps, ts))
    print(f"reference: {sum(p is not None for p in ref_poses)} tracked, {ref.map.n_keyframes()} KFs, "
          f"{ref.map.n_landmarks()} landmarks, ATE {res[0].rmse_scaled:.6f} m; port: "
          f"{sum(p is not None for p in poses)} tracked, {trk.map.n_keyframes()} KFs, {trk.map.n_landmarks()} "
          f"landmarks, ATE {res[1].rmse_scaled:.6f} m")
    assert res[0].rmse_scaled < 0.05 and res[1].rmse_scaled < 0.05
    assert abs(ref.map.n_keyframes() - trk.map.n_keyframes()) <= 3
