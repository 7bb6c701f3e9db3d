"""The stereo tracker against the JAX reference on the CPU, and the port's
stereo sequence of tests/test_stereo.py.

The rig: tests/test_stereo.py's scene (`make_scene(seed=5, n_points=1500)`)
cropped to 320x240 at its own focal length (400 px), baseline 0.2 m, 400
features (the one-frame initialization asks for 300 of them, the
reference's 500 of 600 scaled). The reference tracks the first frames; its
map and live state after frame SNAP are loaded into a reference tracker and
a port tracker, and both get the reference's features and stereo matches
(numpy) of the frames that follow. Tolerances:

- `_initialize_from_depth`: landmarks and bindings exact, positions 1e-5;
- one split-phase stereo pose optimization (`_pose_optimize` with ur, bf
  and the stereo rows): matches exact, pose 1e-4, inliers exact;
- `_seed_depth_points`: exact;
- one stereo mapping step: the tolerances of
  tests/test_torch_tracker.py::test_mapping_step_parity.

The port-only sequence on this rig is in tests/test_torch_stereo_sequence.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.models import map_state as jms
from orbslam3_cpp_fork_tpu.ops import camera as jcam
from orbslam3_cpp_fork_tpu.ops import orb as jorb
from orbslam3_cpp_fork_tpu.ops import stereo as jst
from orbslam3_cpp_fork_tpu.runtime import tracker as jt
from orbslam3_cpp_fork_tpu_torch import convert
from orbslam3_cpp_fork_tpu_torch.datasets import synthetic
from orbslam3_cpp_fork_tpu_torch.ops.orb import OrbParams
from orbslam3_cpp_fork_tpu_torch.runtime import tracker as tt
from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

W, H, FX, N_FEAT = 320, 240, 400.0, 400
BASELINE = 0.2
N_FRAMES = 20
SNAP = 8  # the reference's state after this frame is loaded into both
MAP_CFG = dict(max_keyframes=32, max_landmarks=4096)
STEREO_KW = dict(bf=BASELINE * FX, th_depth=BASELINE * 40.0, stereo_init_min_features=300, async_mapping=False,
                 enable_loop_closing=False, local_lm_cap=1024, ba_lm_cap=1024, ba_obs_cap=8192)
TOL_POS = 1e-5
TOL_POSE = 1e-4
ATE_M, SCALE_TOL = 0.06, 0.03


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rig():
    scene = synthetic.make_scene(seed=5, n_points=1500, width=W, height=H, fx=FX)
    Rs, ts = synthetic.smooth_trajectory(n_frames=N_FRAMES, step=0.12, yaw_rate=0.002)
    pairs = []
    for R, t in zip(Rs, ts):
        l = synthetic.to_u8(synthetic.render_frame(scene, R, t)).astype(np.float32)
        r = synthetic.to_u8(synthetic.render_frame(scene, *synthetic.stereo_right_pose(R, t, BASELINE))).astype(np.float32)
        pairs.append((l, r))
    return scene, Rs, ts, pairs


def cam(mod, scene):
    return mod.Camera.pinhole(FX, FX, scene.K[0, 2], scene.K[1, 2])


def ref_tracker(scene):
    return jt.Tracker(jt.TrackerConfig(
        camera=cam(jcam, scene), width=W, height=H, sensor=jt.Sensor.STEREO, orb=jorb.OrbParams(n_features=N_FEAT),
        mapping_backend="cpu", map_cfg=jms.MapConfig(**MAP_CFG), **STEREO_KW,
    ))


def port_tracker(scene):
    from orbslam3_cpp_fork_tpu_torch.models.map_state import MapConfig

    return tt.Tracker(tt.TrackerConfig(
        camera=convert.camera_from_numpy(FX, FX, scene.K[0, 2], scene.K[1, 2]), width=W, height=H,
        sensor=tt.Sensor.STEREO, orb=OrbParams(n_features=N_FEAT), map_cfg=MapConfig(**MAP_CFG), **STEREO_KW,
    ), "cpu")


def ref_features(pair):
    """The reference's ORB features and rectified stereo matches of a pair."""
    fl = jorb.extract_orb_jit(jnp.asarray(pair[0]), jorb.OrbParams(n_features=N_FEAT))
    fr = jorb.extract_orb_jit(jnp.asarray(pair[1]), jorb.OrbParams(n_features=N_FEAT))
    ur, depth, _ = jst.compute_stereo_matches(
        jnp.asarray(pair[0]), jnp.asarray(pair[1]), fl.desc_i8, fl.xy, fl.level, fl.valid,
        fr.desc_i8, fr.xy, fr.level, fr.valid, jnp.float32(BASELINE * FX), jnp.float32(BASELINE * FX / FX),
    )
    return dict(xy=np.asarray(fl.xy), level=np.asarray(fl.level), angle=np.asarray(fl.angle), desc=np.asarray(fl.desc),
                valid=np.asarray(fl.valid), ur=np.asarray(ur), depth=np.asarray(depth))


def frame_of(mod, f, frame_id):
    return mod.FrameData(frame_id=frame_id, timestamp=0.05 * frame_id, lm_idx=np.full(N_FEAT, -1, np.int32),
                         **{k: v.copy() for k, v in f.items()})


def ref_map_from_numpy(d):
    m = jms.MapState(jms.MapConfig(n_features=d["kf_xy"].shape[1], imu_cap=d["kf_imu"].shape[1], **MAP_CFG))
    for k in convert.MAP_ARRAYS:
        getattr(m, k)[...] = d[k]
    for k in convert.MAP_SCALARS:
        setattr(m, k, d[k])
    m.mark_obs_dirty()
    return m


def load_ref_state(ref, state, map_arrays):
    ref.atlas.maps[ref.atlas.active_idx] = ref_map_from_numpy(map_arrays)
    ref.state = jt.TrackState[state["state"]]
    ref.frame_id, ref.ref_kf = state["frame_id"], state["ref_kf"]
    ref.last_kf_frame_id, ref.n_kf_inserted = state["last_kf_frame_id"], state["n_kf_inserted"]
    ref._last_n_in, ref.lost_t = state["last_n_in"], state["lost_t"]
    ref.velocity = None if state["velocity"] is None else tuple(v.copy() for v in state["velocity"])
    f = state["last"]
    ref.last = jt.FrameData(frame_id=f["frame_id"], timestamp=f["timestamp"], R=f["R"].copy(), t=f["t"].copy(),
                            **{k: f[k].copy() for k in convert.FRAME_ARRAYS})
    ref._dev_local = None


@pytest.fixture(scope="module")
def snap(rig):
    """The reference tracks frames 0..SNAP; its state after SNAP, with the
    reference's features of frame SNAP + 1."""
    scene, _, _, pairs = rig
    ref = ref_tracker(scene)
    for i in range(SNAP + 1):
        ref.track_stereo(pairs[i][0], pairs[i][1], 0.05 * i)
    assert ref.state == jt.TrackState.OK and ref.map.n_keyframes() >= 2
    return convert.tracker_state_to_numpy(ref), convert.map_state_to_numpy(ref.map), ref_features(pairs[SNAP + 1])


def both_loaded(rig, snap):
    state, arrays, _ = snap
    ref, got = ref_tracker(rig[0]), port_tracker(rig[0])
    load_ref_state(ref, state, arrays)
    convert.load_tracker_state(got, state, arrays)
    return ref, got


def test_initialize_from_depth_parity(rig):
    f0 = ref_features(rig[3][0])
    out = {}
    for name, trk, mod in (("ref", ref_tracker(rig[0]), jt), ("got", port_tracker(rig[0]), tt)):
        frame = frame_of(mod, f0, 0)
        trk._initialize_from_depth(frame)
        out[name] = (trk, frame)
    (ref, fr), (got, fg) = out["ref"], out["got"]
    assert ref.state.name == got.state.name == "OK" and got.n_kf_inserted == 1 and got.ref_kf == ref.ref_kf
    mr, mg = ref.map, got.map
    assert mr.n_landmarks() == mg.n_landmarks() > 100, "landmarks exact"
    assert np.array_equal(fg.lm_idx, fr.lm_idx) and np.array_equal(mg.kf_lm_idx, mr.kf_lm_idx), "bindings exact"
    v = mr.lm_valid
    assert np.array_equal(mg.lm_valid, v)
    for k in ("lm_pos", "lm_normal", "lm_min_dist", "lm_max_dist"):
        assert np.abs(getattr(mg, k)[v] - getattr(mr, k)[v]).max() <= TOL_POS * max(1.0, np.abs(getattr(mr, k)[v]).max()), k
    assert np.array_equal(mg.kf_ur[0], mr.kf_ur[0]) and np.array_equal(mg.kf_depth[0], mr.kf_depth[0])
    assert np.array_equal(got.kfdb.present, ref.kfdb.present[: len(got.kfdb.present)])


def track_split(trk, mod, f):
    """Stage 1 of the split-phase path on the features `f` of frame SNAP+1:
    constant-velocity prediction, the last frame's landmarks matched by
    projection, the stereo pose optimization."""
    frame = frame_of(mod, f, SNAP + 1)
    trk._predict_pose(frame)
    last_lms = np.unique(trk.last.lm_idx[trk.last.lm_idx >= 0])
    last_lms = last_lms[trk.map.lm_valid[last_lms]]
    lm_hit, feat_hit = trk._match_landmarks_into_frame(frame, last_lms, 15.0)
    frame.lm_idx[feat_hit] = lm_hit
    n_st = int((frame.ur[feat_hit] >= 0).sum())
    return frame, lm_hit, feat_hit, n_st, trk._pose_optimize(frame)


def test_stereo_pose_optimization_parity(rig, snap):
    ref, got = both_loaded(rig, snap)
    frr, lr, fr_, nsr, nr = track_split(ref, jt, snap[2])
    frg, lg, fg, nsg, ng = track_split(got, tt, snap[2])
    assert len(lr) > 50 and nsr > 20, "stereo rows take part"
    assert np.array_equal(lg, lr) and np.array_equal(fg, fr_), "matches exact"
    assert ng == nr and np.array_equal(frg.lm_idx, frr.lm_idx), "inliers exact"
    assert np.abs(frg.R - frr.R).max() <= TOL_POSE and np.abs(frg.t - frr.t).max() <= TOL_POSE, "tolerance: pose 1e-4"


def test_seed_depth_points_and_mapping_step_parity(rig, snap):
    """Frame SNAP+1, tracked by the reference's pose optimization in both,
    becomes a keyframe of the reference's map in both: its close points are
    seeded from depth, then one mapping step (triangulation with the
    rig-depth policy, fusion, culls, window BA with stereo residuals)."""
    ref, _ = both_loaded(rig, snap)
    frame, *_ = track_split(ref, jt, snap[2])
    fr = convert.frame_to_numpy(frame)
    out = {}
    for name, trk, mod in (("ref", ref_tracker(rig[0]), jt), ("got", port_tracker(rig[0]), tt)):
        m = convert.map_state_from_numpy(snap[1]) if mod is tt else ref_map_from_numpy(snap[1])
        trk.atlas.maps[trk.atlas.active_idx] = m
        n0 = m.n_landmarks()
        frame = mod.FrameData(frame_id=fr["frame_id"], timestamp=fr["timestamp"], R=fr["R"].copy(), t=fr["t"].copy(),
                              **{k: fr[k].copy() for k in convert.FRAME_ARRAYS})
        k = m.add_keyframe(frame.R, frame.t, frame.xy, frame.level, frame.angle, frame.desc, frame.valid,
                           frame.lm_idx, frame.timestamp, frame.frame_id, ur=frame.ur, depth=frame.depth)
        ids = trk._seed_depth_points(frame, k)
        seeded = (list(ids), frame.lm_idx.copy(), m.lm_pos[ids].copy(), m.obs[k].copy())
        trk.state = type(trk.state).OK
        trk.ref_kf, trk.last_kf_frame_id, trk.frame_id = k, fr["frame_id"], fr["frame_id"] + 1
        trk._mapping_step(k, map_ref=m)
        out[name] = (k, n0, m, seeded)
    (kr, n0r, mr, sr), (kg, n0g, mg, sg) = out["ref"], out["got"]
    assert kr == kg and n0r == n0g
    assert len(sr[0]) >= 100 and sg[0] == sr[0], "seeded landmark ids exact"
    assert all(np.array_equal(a, b) for a, b in zip(sg[1:], sr[1:])), "bindings, positions and observations exact"
    assert np.array_equal(mg.lm_replaced, mr.lm_replaced), "same fused pairs"
    assert np.array_equal(mg.kf_valid, mr.kf_valid), "same keyframes culled"
    dn_r, dn_g = mr.n_landmarks() - n0r, mg.n_landmarks() - n0g
    assert dn_r > 50 and abs(dn_g - dn_r) <= max(1, 0.01 * dn_r), "tolerance: new-landmark count within 1%"
    assert np.mean(mg.kf_lm_idx == mr.kf_lm_idx) >= 0.999, "tolerance: bindings equal on >= 99.9% of feature slots"
    kv = mr.kf_valid & snap[1]["kf_valid"]
    assert np.abs(mr.kf_t[kv] - snap[1]["kf_t"][kv]).max() > 1e-5, "the window BA moved the keyframes"
    kv = mr.kf_valid
    assert np.abs(mg.kf_R[kv] - mr.kf_R[kv]).max() <= TOL_POSE and np.abs(mg.kf_t[kv] - mr.kf_t[kv]).max() <= TOL_POSE
    both = mr.lm_valid & mg.lm_valid
    rel = np.linalg.norm(mg.lm_pos[both] - mr.lm_pos[both], axis=1) / np.linalg.norm(mr.lm_pos[both], axis=1)
    assert np.quantile(rel, 0.99) <= 1e-3, "tolerance: positions 1e-3 relative on 99% of landmarks"


# ---------------------------------------------------------------- slow (CPU)


def _full_width_tracker(impl, scene, sensor, **kw):
    """A reference or port tracker with chip_smoke.py's stereo settings."""
    import chip_smoke

    if impl == "port":
        cfg = chip_smoke.stereo_config(scene, OrbParams(n_features=1000), sensor=getattr(tt.Sensor, sensor), **kw)
        return tt.Tracker(cfg, "cpu")
    K = scene.K
    return jt.Tracker(jt.TrackerConfig(
        camera=jcam.Camera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), width=scene.width, height=scene.height,
        sensor=getattr(jt.Sensor, sensor), orb=jorb.OrbParams(n_features=1000), mapping_backend="cpu",
        bf=chip_smoke.STEREO_BASELINE * float(K[0, 0]), th_depth=chip_smoke.STEREO_BASELINE * 40.0, **kw,
    ))


@pytest.mark.slow
@pytest.mark.parametrize("impl", ["reference", "port"])
def test_stereo_loop_full_width(impl):
    """tests/test_stereo_loop_e2e.py as chip_smoke.py's stereo phase runs it
    (its 110-frame circle at 752x480, uint8 pairs, 1000 features,
    synchronous, loop closing and global BA on), by the reference or the
    port: the CPU constants behind part A's gate (PERF.md). Minutes a run."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    scene, Rs, ts, pairs = chip_smoke.render_stereo_loop()
    trk = _full_width_tracker(impl, scene, "STEREO", async_mapping=False)
    assert trk.loop_closer.cfg.fix_scale
    ok = [trk.track_stereo(l, r, 0.05 * i) is not None for i, (l, r) in enumerate(pairs)]
    ts_est, Twc = trk.export_trajectory()
    res = ate_rmse(ts_est, Twc[:, :3, 3], np.arange(len(pairs)) * 0.05, ts)
    print(f"stereo loop {impl}: tracked {sum(ok)}/{len(ok)}, first {ok[0]}, loops {trk.loop_closer.events}, "
          f"unscaled ATE {res.rmse:.6f} m, scale {res.scale:.4f}, scaled {res.rmse_scaled:.6f} m")
    assert ok[0] and sum(ok) > chip_smoke.STEREO_MIN_TRACKED and trk.loop_closer.n_loops_closed >= 1
    assert res.rmse < chip_smoke.STEREO_MAX_ATE_M and abs(res.scale - 1.0) < chip_smoke.STEREO_SCALE_TOL
    if impl == "port":
        assert res.rmse <= max(chip_smoke.STEREO_JAX_ATE_M, chip_smoke.STEREO_PORT_ATE_M) + chip_smoke.TOL_LOOP_ATE_M


@pytest.mark.slow
@pytest.mark.parametrize("impl", ["reference", "port"])
def test_rgbd_full_width(impl):
    """tests/test_stereo.py's RGB-D sequence at 640x480 with 1000 features
    (chip_smoke.py's part B): the CPU constants behind its gate."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    scene, Rs, ts, frames = chip_smoke.render_rgbd()
    trk = _full_width_tracker(impl, scene, "RGBD", async_mapping=False)
    ok = [trk.track_rgbd(img, dep, 0.05 * i) is not None for i, (img, dep) in enumerate(frames)]
    ts_est, Twc = trk.export_trajectory()
    res = ate_rmse(ts_est, Twc[:, :3, 3], np.arange(len(frames)) * 0.05, ts)
    print(f"rgbd {impl}: tracked {sum(ok)}/{len(ok)}, unscaled ATE {res.rmse:.6f} m, scale {res.scale:.4f}")
    assert all(ok) and abs(res.scale - 1.0) < chip_smoke.RGBD_SCALE_TOL
    if impl == "port":
        assert res.rmse <= max(chip_smoke.RGBD_JAX_ATE_M, chip_smoke.RGBD_PORT_ATE_M) + chip_smoke.TOL_LOOP_ATE_M


def _noisy_mono():
    """tests/test_noisy_renders.py's mono sequence: 80 frames of a 0.8 pi arc
    with noise, blur and exposure jitter."""
    scene = synthetic.make_ring_scene(seed=11, n_points=900, size_range=(9, 15))
    n = 80
    Rs, ts = synthetic.circle_trajectory(n_frames=n, radius=2.5, total_angle=0.8 * np.pi)
    rng = np.random.default_rng(7)
    frames = [synthetic.degrade(f, noise_sigma=6.0, blur_sigma=0.7, exposure=float(rng.uniform(0.85, 1.15)),
                                seed=100 + i) for i, f in enumerate(synthetic.render_sequence(scene, Rs, ts))]
    return scene, Rs, ts, frames


@pytest.mark.slow
def test_mono_tracks_on_noisy_renders():
    """The mono half of tests/test_noisy_renders.py on the port, from a cold
    start, synchronous with loop closing; its gates (state OK, > 80%
    tracked, scale-aligned ATE < 0.2 m). ROADMAP C3: with the generator's
    default seed this run loses the map at frame 55."""
    scene, Rs, ts, frames = _noisy_mono()
    n = len(frames)
    K = scene.K
    trk = tt.Tracker(tt.TrackerConfig(
        camera=convert.camera_from_numpy(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), width=scene.width, height=scene.height,
        orb=OrbParams(n_features=1000), async_mapping=False, enable_loop_closing=True,
    ), "cpu")
    stamps = np.arange(n) * 0.05
    tracked = sum(trk.track(f, float(stamps[i])) is not None for i, f in enumerate(frames))
    assert trk.state == tt.TrackState.OK, trk.state
    assert tracked > 0.8 * n, tracked
    ts_est, Twc = trk.export_trajectory()
    res = ate_rmse(ts_est, Twc[:, :3, 3], stamps, ts)
    print(f"mono noisy: tracked {tracked}/{n}, {res}")
    assert res.rmse_scaled < 0.2, res


@pytest.mark.slow
@pytest.mark.parametrize("at", [4, 30])
def test_mono_noisy_renders_from_the_references_state(at):
    """ROADMAP C3: the reference tracks the noisy mono sequence from a cold
    start; loaded with the reference's state after frame `at` (4: its
    initial map), the port tracks the rest within the same gates."""
    import test_torch_loop_drift as drift

    seq = _noisy_mono()
    scene, Rs, ts, frames = seq
    ref = drift.ref_tracker(scene)
    for i in range(at + 1):
        ref.track(frames[i], 0.05 * i)
    trk = drift.loaded("port", seq, drift.snapshot(ref))
    r = drift.step(trk, seq, len(frames) - 1)
    ts_est, Twc = r["traj"]
    res = ate_rmse(ts_est, Twc[:, :3, 3], np.arange(len(frames)) * 0.05, ts)
    print(f"mono noisy from the reference's state after frame {at}: port {trk.state.name}, {res}")
    # The loaded tracker exports the frames it tracked, after `at`.
    assert trk.state == tt.TrackState.OK and len(ts_est) > 0.8 * (len(frames) - at - 1) and res.rmse_scaled < 0.2, res


@pytest.mark.slow
def test_stereo_tracks_metric_on_noisy_renders():
    """The stereo half of tests/test_noisy_renders.py on the port."""
    scene = synthetic.make_scene(seed=5, n_points=1500)
    Rs, ts = synthetic.smooth_trajectory(n_frames=30, step=0.12, yaw_rate=0.002)
    K = scene.K
    trk = tt.Tracker(tt.TrackerConfig(
        camera=convert.camera_from_numpy(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), width=scene.width, height=scene.height,
        sensor=tt.Sensor.STEREO, orb=OrbParams(n_features=600), bf=BASELINE * float(K[0, 0]),
        th_depth=BASELINE * 40.0, async_mapping=False,
    ), "cpu")
    poses = []
    for i in range(len(Rs)):
        img_l = synthetic.degrade(synthetic.render_frame(scene, Rs[i], ts[i]), noise_sigma=6.0, blur_sigma=0.7,
                                  exposure=1.05, seed=200 + i)
        img_r = synthetic.degrade(synthetic.render_frame(scene, *synthetic.stereo_right_pose(Rs[i], ts[i], BASELINE)),
                                  noise_sigma=6.0, blur_sigma=0.7, exposure=0.97, seed=500 + i)
        poses.append(trk.track_stereo(img_l, img_r, 0.05 * i))
    assert sum(p is not None for p in poses) > 24
    ts_est, Twc = trk.export_trajectory()
    res = ate_rmse(ts_est, Twc[:, :3, 3], np.arange(len(Rs)) * 0.05, ts)
    print(f"stereo noisy: {res}")
    assert res.rmse < 0.15 and abs(res.scale - 1.0) < 0.08, res
