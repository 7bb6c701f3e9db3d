"""The visual-inertial scenes of the parity tests: tests/test_vi_tracking_e2e.py's
circle with vertical bobbing (exact 200 Hz IMU), rendered as mono frames,
rectified stereo pairs (a 0.2 m rig) or RGB-D frames, and the matching
tracker configuration for the reference and for the port."""

import numpy as np

from orbslam3_cpp_fork_tpu.datasets import synthetic as jsyn
from orbslam3_cpp_fork_tpu.ops.camera import Camera as JCamera
from orbslam3_cpp_fork_tpu.ops.orb import OrbParams as JOrbParams
from orbslam3_cpp_fork_tpu.runtime import tracker as jtr
from orbslam3_cpp_fork_tpu_torch import convert
from orbslam3_cpp_fork_tpu_torch.datasets.synthetic import to_u8
from orbslam3_cpp_fork_tpu_torch.ops.orb import OrbParams as TOrbParams
from orbslam3_cpp_fork_tpu_torch.runtime import tracker as ttr

import test_vi_tracking_e2e as vie

BASELINE = 0.2
# The ladder schedule of tests/test_vi_tracking_e2e.py.
LADDER = dict(imu_init_min_kfs=6, imu_init_time=0.6, viba1_time=3.0, viba2_time=1e9, imu_kf_period=0.3)


def bob_sequence(n_frames, scene, kind="mono", u8=True):
    """Stamps, ground-truth camera-to-world poses (camera == body), the
    rendered frames (mono images, (left, right) pairs or (image, depth)) and
    the IMU rows of every frame (None for the first)."""
    stamps = np.arange(n_frames) / vie.FPS
    Rs, ts = (np.stack(x) for x in zip(*[vie.bob_state(t)[:2] for t in stamps]))
    conv = to_u8 if u8 else (lambda x: x)

    def img(R, t):
        return conv(jsyn.render_frame(scene, R, t))

    if kind == "mono":
        frames = [img(R, t) for R, t in zip(Rs, ts)]
    elif kind == "stereo":
        frames = [(img(R, t), img(*jsyn.stereo_right_pose(R, t, BASELINE))) for R, t in zip(Rs, ts)]
    else:
        frames = [(img(R, t), jsyn.render_depth(scene, R, t)) for R, t in zip(Rs, ts)]
    rows = [None] + [vie.imu_rows(stamps[i - 1], stamps[i]) for i in range(1, n_frames)]
    return stamps, Rs, ts, frames, rows


def configs(scene, sensor_name, n_features, map_cfg=None, **kw):
    """(reference TrackerConfig, port TrackerConfig) of the same fields: the
    ladder schedule above, the scene's pinhole camera, a 0.2 m rig for the
    depth sensors (bf = 0.2 fx, th_depth = 0.2 x 40), `map_cfg` (a dict of
    MapConfig fields) and `kw`. The reference runs its mapping solvers on
    the CPU backend, as the port does on "cpu"."""
    from orbslam3_cpp_fork_tpu.models.map_state import MapConfig as JMapConfig
    from orbslam3_cpp_fork_tpu_torch.models.map_state import MapConfig as TMapConfig

    K = scene.K
    fields = dict(width=scene.width, height=scene.height, **LADDER, **kw)
    if sensor_name != "IMU_MONOCULAR":
        fields.update(bf=BASELINE * float(K[0, 0]), th_depth=BASELINE * 40.0)
    ref = jtr.TrackerConfig(
        camera=JCamera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), sensor=jtr.Sensor[sensor_name],
        orb=JOrbParams(n_features=n_features), imu=jtr.ImuSettings(freq=vie.IMU_HZ), mapping_backend="cpu",
        **({} if map_cfg is None else dict(map_cfg=JMapConfig(**map_cfg))), **fields,
    )
    port = ttr.TrackerConfig(
        camera=convert.camera_from_numpy(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), sensor=ttr.Sensor[sensor_name],
        orb=TOrbParams(n_features=n_features), imu=ttr.ImuSettings(freq=vie.IMU_HZ),
        **({} if map_cfg is None else dict(map_cfg=TMapConfig(**map_cfg))), **fields,
    )
    return ref, port


def step(trk, kind, frame, stamp, rows):
    """One frame through the entry point of its kind."""
    if kind == "mono":
        return trk.track(frame, float(stamp), imu=rows)
    if kind == "stereo":
        return trk.track_stereo(frame[0], frame[1], float(stamp), imu=rows)
    return trk.track_rgbd(frame[0], frame[1], float(stamp), imu=rows)


def ref_map_from_numpy(d, calib):
    """The reference MapState with the arrays of `convert.map_state_to_numpy`
    and the IMU calibration `calib`."""
    from orbslam3_cpp_fork_tpu.models import map_state as jms

    K, L = d["obs"].shape
    m = jms.MapState(jms.MapConfig(max_keyframes=K, max_landmarks=L, n_features=d["kf_xy"].shape[1],
                                   imu_cap=d["kf_imu"].shape[1]), map_id=int(d["map_id"]))
    for k in convert.MAP_ARRAYS:
        getattr(m, k)[...] = d[k]
    for k in convert.MAP_SCALARS:
        setattr(m, k, d[k])
    m._imu_calib = calib
    m.mark_obs_dirty()
    return m


def load_ref_state(ref, state, map_arrays):
    """The reference tracker on a map and in a live state (with its inertial
    part) made by `convert.tracker_state_to_numpy` / `map_state_to_numpy`:
    the counterpart of `convert.load_tracker_state` for the reference."""
    import jax.numpy as jnp

    from orbslam3_cpp_fork_tpu.ops import imu as jimu

    ref.atlas.maps[ref.atlas.active_idx] = ref_map_from_numpy(map_arrays, ref.imu_calib)
    ref.state = jtr.TrackState[state["state"]]
    ref.frame_id, ref.ref_kf = state["frame_id"], state["ref_kf"]
    ref.last_kf_frame_id, ref.n_kf_inserted = state["last_kf_frame_id"], state["n_kf_inserted"]
    ref._last_n_in, ref.lost_t = state["last_n_in"], state["lost_t"]
    ref._seen_change_idx = state["seen_change_idx"]
    ref.velocity = None if state["velocity"] is None else tuple(v.copy() for v in state["velocity"])
    f = state["last"]
    ref.last = None if f is None else jtr.FrameData(
        frame_id=f["frame_id"], timestamp=f["timestamp"], R=None if f["R"] is None else f["R"].copy(),
        t=None if f["t"] is None else f["t"].copy(), **{k: f[k].copy() for k in convert.FRAME_ARRAYS},
    )
    ref._dev_local = None
    vi = state.get("vi")
    if vi is not None:
        ref.cur_v, ref.cur_bg, ref.cur_ba = (vi[k].copy() for k in ("cur_v", "cur_bg", "cur_ba"))
        ref.last_body = None if vi["last_body"] is None else tuple(x.copy() for x in vi["last_body"])
        ref.prior_H = None if vi["prior_H"] is None else vi["prior_H"].copy()
        pre = vi["pre_from_kf"]
        ref._pre_from_kf = None if pre is None else jimu.Preintegrated(**{k: jnp.asarray(v) for k, v in pre.items()})
        ref._imu_since_kf = [r.copy() for r in vi["imu_since_kf"]]
        ref._imu_since_kf_t = list(vi["imu_since_kf_t"])
        ref._last_imu_t = vi["last_imu_t"]
        ref.last_kf_slot = vi["last_kf_slot"]
        ref._scale_refine_idx = vi["scale_refine_idx"]
        ref._kf_inserted_last_frame = vi["kf_inserted_last_frame"]


def ref_features(kind, frame, n_features, bf=0.0):
    """The reference's features of a frame, as the inputs both trackers are
    stepped with: its ORB on the (left) image, with its rectified stereo
    matches (stereo) or depth samples (RGB-D); no distortion, so the
    undistorted keypoints are the raw ones."""
    import jax.numpy as jnp

    from orbslam3_cpp_fork_tpu.ops import orb as jorb
    from orbslam3_cpp_fork_tpu.ops import stereo as jst

    params = jorb.OrbParams(n_features=n_features)
    img = jnp.asarray(frame if kind == "mono" else frame[0], jnp.float32)
    fl = jorb.extract_orb_jit(img, params)
    out = dict(xy=np.asarray(fl.xy), level=np.asarray(fl.level), angle=np.asarray(fl.angle),
               desc=np.asarray(fl.desc), valid=np.asarray(fl.valid))
    if kind == "stereo":
        fr = jorb.extract_orb_jit(jnp.asarray(frame[1], jnp.float32), params)
        ur, depth, _ = jst.compute_stereo_matches(
            img, jnp.asarray(frame[1], jnp.float32), fl.desc_i8, fl.xy, fl.level, fl.valid,
            fr.desc_i8, fr.xy, fr.level, fr.valid, jnp.float32(bf), jnp.float32(BASELINE),
        )
        out.update(ur=np.asarray(ur), depth=np.asarray(depth))
    elif kind == "rgbd":
        _, d, ok = jst.depth_to_stereo(jnp.asarray(frame[1], jnp.float32), fl.xy, jnp.float32(bf), jnp.float32(1.0))
        d, ok = np.asarray(d), np.asarray(ok)
        out.update(ur=np.where(ok, out["xy"][:, 0] - bf / np.maximum(d, 1e-6), -1.0).astype(np.float32),
                   depth=d.astype(np.float32))
    else:
        n = len(out["valid"])
        out.update(ur=np.full(n, -1.0, np.float32), depth=np.full(n, -1.0, np.float32))
    return out


def frame_of(mod, feats, frame_id, stamp):
    """A FrameData of tracker module `mod` carrying the features `feats`."""
    return mod.FrameData(frame_id=frame_id, timestamp=stamp, lm_idx=np.full(len(feats["valid"]), -1, np.int32),
                         **{k: v.copy() for k, v in feats.items()})
