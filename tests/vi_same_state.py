"""The inertial trackers of the port against the reference's from the same
state (tests/test_torch_vi_tracker*.py, one file a sensor so that the test
workers split them): tests/test_vi_tracking_e2e.py's bobbing circle (exact
200 Hz IMU) tracked by the reference's IMU_MONOCULAR, IMU_RGBD or
IMU_STEREO Tracker until its mapping step calls `_initialize_imu`.

(a) `check_initialize_imu`: the reference's state at that call (map, live
    tracking and inertial state) is loaded into the port with
    `convert.load_tracker_state` and into a fresh reference; both run the
    init: Rwg and biases of InertialOptimization to 1e-4, its cost to 1e-5
    relative and its scale to 2e-3 relative (mono: a valley flat to f32
    precision); the map after the gravity alignment and the full
    visual-inertial BA: rotations and biases to 1e-4, positions and
    velocities to TOL_MAP.
(b) `check_next_frames`: the reference's state after that frame is loaded
    the same way and both trackers step the next 5 frames on the
    reference's features and the same IMU rows (the VI pose optimization
    against the last keyframe, then against the last frame with its marginal
    prior): poses to 1e-4.

Cut to size for the CPU: 400 features and caps of 1024; the mono scene at
its own 640x480 (at 320x240 the reference's mono map is lost before its IMU
initializes), the stereo and RGB-D scenes at 320x240."""

import numpy as np

from orbslam3_cpp_fork_tpu.datasets import synthetic as jsyn
from orbslam3_cpp_fork_tpu.optim import inertial as jvi
from orbslam3_cpp_fork_tpu.runtime import tracker as jt
from orbslam3_cpp_fork_tpu_torch import convert
from orbslam3_cpp_fork_tpu_torch.optim import inertial as tvi
from orbslam3_cpp_fork_tpu_torch.runtime import tracker as tt

from vi_rig import bob_sequence, configs, frame_of, load_ref_state, ref_features, step

N_FEAT = 400
MAX_FRAMES = 30
N_AFTER = 5
TOL = 1e-4
TOL_SCALE = {"mono": 2e-3, "rgbd": 1e-6, "stereo": 1e-6}  # relative
TOL_MAP = {"mono": 3e-3, "rgbd": 2e-4, "stereo": 2e-4}  # positions (m), velocities (m/s) after the init
KW = dict(async_mapping=False, enable_loop_closing=False, local_lm_cap=1024, ba_lm_cap=1024, ba_obs_cap=8192,
          vi_obs_cap=8192)
MAP_CFG = dict(max_keyframes=32, max_landmarks=4096)
KF_FIELDS = ("kf_R", "kf_t", "kf_vel", "kf_bg", "kf_ba")
SENSOR = {"mono": "IMU_MONOCULAR", "rgbd": "IMU_RGBD", "stereo": "IMU_STEREO"}
SIZE = {"mono": (640, 480), "rgbd": (320, 240), "stereo": (320, 240)}


def tracked(kind):
    """The reference tracks (through its own entry points) until the frame
    whose mapping step initializes the IMU: its state at the
    `_initialize_imu` call and after the frame, the call's arguments, and the
    next frames' features and IMU rows."""
    W, H = SIZE[kind]
    scene = jsyn.make_ring_scene(seed=5, width=W, height=H)
    stamps, Rs, ts, frames, rows = bob_sequence(MAX_FRAMES, scene, kind)
    extra = {} if kind == "mono" else dict(stereo_init_min_features=300)
    cref, cport = configs(scene, SENSOR[kind], N_FEAT, map_cfg=MAP_CFG, **KW, **extra)
    ref = jt.Tracker(cref)
    at_init = {}
    orig = ref._initialize_imu

    def spy(frame, k, prior_g, prior_a, fix_scale):
        if not at_init:
            at_init.update(state=convert.tracker_state_to_numpy(ref), arrays=convert.map_state_to_numpy(ref.map),
                           call=(int(frame.frame_id), float(frame.timestamp), k, prior_g, prior_a, fix_scale))
        return orig(frame, k, prior_g, prior_a, fix_scale)

    ref._initialize_imu = spy
    for i in range(MAX_FRAMES - N_AFTER):
        step(ref, kind, frames[i], stamps[i], rows[i])
        if ref.map.imu_stage >= 1:
            break
    assert ref.map.imu_stage >= 1 and at_init, "the reference never initialized its IMU"
    after = (convert.tracker_state_to_numpy(ref), convert.map_state_to_numpy(ref.map))
    bf = float(cport.bf)
    nxt = [(ref_features(kind, frames[j], N_FEAT, bf), float(stamps[j]), rows[j])
           for j in range(i + 1, i + 1 + N_AFTER)]
    return kind, cref, cport, at_init, after, nxt


def both_loaded(cref, cport, state, arrays):
    ref, got = jt.Tracker(cref), tt.Tracker(cport, "cpu")
    load_ref_state(ref, state, arrays)
    convert.load_tracker_state(got, state, arrays)
    return ref, got


def check_initialize_imu(tracked):
    kind, cref, cport, at_init, _, _ = tracked
    ref, got = both_loaded(cref, cport, at_init["state"], at_init["arrays"])
    fid, stamp, k, prior_g, prior_a, fix_scale = at_init["call"]
    assert fix_scale == (kind != "mono")
    results = {}
    for name, trk, mod, vi in (("ref", ref, jt, jvi), ("got", got, tt, tvi)):
        orig = vi.inertial_init

        def spy(*a, _orig=orig, _name=name, **kw):
            res = _orig(*a, **kw)
            results.setdefault(_name, res)
            return res

        vi.inertial_init = spy
        try:
            assert trk._initialize_imu(mod.FrameData(frame_id=fid, timestamp=stamp), k, prior_g, prior_a, fix_scale)
        finally:
            vi.inertial_init = orig
    r, g = results["ref"], results["got"]
    for f in ("Rwg", "bg", "ba"):
        assert np.abs(getattr(g, f).numpy() - np.asarray(getattr(r, f))).max() <= TOL, f
    # The cost InertialOptimization reaches agrees to 1e-5; with a free scale
    # (mono) the scale lies in a valley that f32 cannot resolve (the two
    # answers' costs differ by ~3e-6 relative), so it agrees to 2e-3 relative.
    assert abs(float(g.cost) - float(r.cost)) <= 1e-5 * abs(float(r.cost))
    assert abs(float(g.scale) - float(r.scale)) <= TOL_SCALE[kind] * float(r.scale)
    assert ref.map.imu_stage == got.map.imu_stage == 1
    kv = ref.map.kf_valid
    assert np.array_equal(got.map.kf_valid, kv)
    # The map after the gravity alignment, the rescale and the full VI BA:
    # rotations and biases to 1e-4; positions and velocities, which the
    # 15-iteration BA spreads the f32 differences into, to TOL_MAP.
    for f in KF_FIELDS:
        tol = TOL if f in ("kf_R", "kf_bg", "kf_ba") else TOL_MAP[kind]
        assert np.abs(getattr(got.map, f)[kv] - getattr(ref.map, f)[kv]).max() <= tol, f
    assert np.abs(got.cur_v - ref.cur_v).max() <= TOL_MAP[kind]
    for f in ("cur_bg", "cur_ba"):
        assert np.abs(getattr(got, f) - getattr(ref, f)).max() <= TOL, f
    print(f"{SENSOR[kind]}: IMU init at frame {fid}: scale {float(g.scale):.6f} (reference {float(r.scale):.6f})")


def check_next_frames(tracked):
    kind, cref, cport, _, (state, arrays), nxt = tracked
    ref, got = both_loaded(cref, cport, state, arrays)
    for feats, stamp, rows in nxt:
        Ts = []
        for trk, mod in ((ref, jt), (got, tt)):
            trk._ingest_imu(rows, stamp)
            Ts.append(trk._process(frame_of(mod, feats, trk.frame_id, stamp)))
        Tr, Tg = Ts
        assert Tr is not None and Tg is not None
        assert np.abs(Tg - Tr).max() <= TOL, np.abs(Tg - Tr).max()
        for f in ("cur_v", "cur_bg", "cur_ba"):
            assert np.abs(getattr(got, f) - getattr(ref, f)).max() <= TOL, f
    assert got.state == tt.TrackState.OK and got.prior_H is not None
