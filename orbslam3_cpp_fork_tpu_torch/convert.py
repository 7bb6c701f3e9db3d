"""The state carried across from the reference runtime: camera, local-map
snapshot, a map and the whole Atlas, a window-BA problem, a preintegration
and a visual-inertial BA problem, the tracker configuration, the tracker's
live state (last frame, motion model, reference keyframe, trajectory
records, keyframe aliases, and the inertial state: velocity, biases, the
last body state, the marginal prior, the running preintegration since the
last keyframe and its raw rows), the keyframe database (rows by (map,
slot)) and the loop closer's state.

The system has no weights. Its tracking state is the camera and the
local-map snapshot the reference uploads in Tracker._refresh_dev_local:
numpy pos (L,3) f32, normal (L,3) f32, mind (L,) f32, maxd (L,) f32,
desc (L,8) uint32 and valid (L,) bool. Descriptor words stay uint32 at
this numpy boundary and become int64 inside the port, where shifts and
masks behave on every device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import get_device
from .models.atlas import Atlas
from .models.map_state import MapConfig, MapState
from .ops.camera import Camera
from .ops.imu import Preintegrated
from .ops.orb import OrbParams
from .optim.inertial import VIBAProblem
from .optim.local_ba import BAProblem
from .runtime.keyframe_database import KeyFrameDatabase
from .runtime.localization import LocalMap
from .runtime.tracker import DeviceKFStore, FrameData, ImuSettings, Sensor, Tracker, TrackerConfig, TrackState

SNAPSHOT_KEYS = ("pos", "normal", "mind", "maxd", "desc", "valid")


def local_map_from_numpy(d: dict, device) -> LocalMap:
    """Snapshot dict of numpy arrays -> the port's `LocalMap` on `device`."""
    missing = [k for k in SNAPSHOT_KEYS if k not in d]
    if missing:
        raise KeyError(f"local-map snapshot lacks {missing}")
    desc = np.asarray(d["desc"])
    if desc.dtype != np.uint32 or desc.ndim != 2 or desc.shape[1] != 8:
        raise ValueError(f"desc must be (L,8) uint32, got {desc.dtype} {desc.shape}")
    dev = get_device(device)

    def f32(k):
        return torch.from_numpy(np.ascontiguousarray(d[k], np.float32)).to(dev)

    return LocalMap(
        pos=f32("pos"),
        normal=f32("normal"),
        mind=f32("mind"),
        maxd=f32("maxd"),
        desc=torch.from_numpy(desc.astype(np.int64)).to(dev),
        valid=torch.from_numpy(np.asarray(d["valid"], bool)).to(dev),
    )


def camera_from_numpy(fx, fy, cx, cy, dist=(0.0, 0.0, 0.0, 0.0, 0.0)) -> Camera:
    """Pinhole + radial-tangential camera from plain numbers."""
    return Camera.pinhole(fx, fy, cx, cy, tuple(np.asarray(dist, np.float64).ravel()))


# Every SoA field of the reference's MapState, by name (scalars first).
MAP_SCALARS = ("map_id", "big_change_idx", "imu_stage", "imu_t0", "_next_kf_slot", "_next_lm_slot")
MAP_ARRAYS = (
    "kf_valid", "kf_R", "kf_t", "kf_timestamp", "kf_frame_id",
    "kf_xy", "kf_level", "kf_angle", "kf_desc", "kf_feat_valid", "kf_lm_idx", "kf_ur", "kf_depth",
    "kf_vel", "kf_bg", "kf_ba", "kf_prev", "kf_next",
    "kf_pre_valid", "kf_pre_dR", "kf_pre_dV", "kf_pre_dP", "kf_pre_C", "kf_pre_J", "kf_pre_dT",
    "kf_pre_bias", "kf_imu", "kf_imu_n",
    "lm_valid", "lm_pos", "lm_desc", "lm_desc_i8", "lm_normal", "lm_min_dist", "lm_max_dist",
    "lm_level", "lm_visible", "lm_found", "lm_first_kf", "lm_birth_fid", "lm_obs_count",
    "kf_gen", "lm_gen", "lm_replaced", "obs",
)


def map_state_to_numpy(m) -> dict:
    """Every SoA field of a MapState (the reference's or the port's: the
    field names are the same) as a dict of numpy arrays and scalars."""
    d = {k: getattr(m, k) for k in MAP_SCALARS}
    d.update({k: np.array(getattr(m, k)) for k in MAP_ARRAYS})
    return d


def map_state_from_numpy(arrays: dict) -> MapState:
    """Dict of the reference MapState's fields (`map_state_to_numpy`) ->
    the port's MapState, capacities taken from the array shapes. The
    covisibility mirror is rebuilt from `obs` on its first query."""
    missing = [k for k in MAP_ARRAYS if k not in arrays]
    if missing:
        raise KeyError(f"map state lacks {missing}")
    K, L = arrays["obs"].shape
    cfg = MapConfig(
        max_keyframes=K, max_landmarks=L, n_features=arrays["kf_xy"].shape[1], imu_cap=arrays["kf_imu"].shape[1],
    )
    m = MapState(cfg, map_id=int(arrays.get("map_id", 0)))
    for k in MAP_ARRAYS:
        dst = getattr(m, k)
        src = np.asarray(arrays[k])
        if src.shape != dst.shape:
            raise ValueError(f"{k}: shape {src.shape}, expected {dst.shape}")
        dst[...] = src.astype(dst.dtype)
    for k in MAP_SCALARS:
        if k in arrays and k != "map_id":
            setattr(m, k, type(getattr(m, k))(arrays[k]))
    m.mark_obs_dirty()
    return m


def atlas_to_numpy(atlas) -> dict:
    """Every map of an Atlas (the reference's or the port's) as
    `map_state_to_numpy` dicts, with the active index and the next map id."""
    return dict(
        maps=[map_state_to_numpy(m) for m in atlas.maps],
        active_idx=int(atlas.active_idx), next_map_id=int(atlas._next_map_id),
    )


def atlas_from_numpy(d: dict) -> Atlas:
    """The port's Atlas in the state of `atlas_to_numpy`."""
    maps = [map_state_from_numpy(a) for a in d["maps"]]
    atlas = Atlas(maps[0].cfg)
    atlas.maps = maps
    atlas.active_idx = d["active_idx"]
    atlas._next_map_id = d["next_map_id"]
    return atlas


BA_FIELDS = (
    "R", "t", "kf_valid", "kf_fixed", "Xw", "lm_valid", "obs_kf", "obs_lm",
    "obs_uvr", "obs_sigma2", "obs_stereo", "obs_valid",
)


def ba_problem_from_numpy(d: dict, device) -> BAProblem:
    """Dict of the reference BAProblem's fields -> the port's BAProblem on
    `device` (indices int64, masks bool, the rest f32; fx, fy, bf floats)."""
    dev = get_device(device)
    kinds = {"kf_valid": bool, "kf_fixed": bool, "lm_valid": bool, "obs_stereo": bool, "obs_valid": bool,
             "obs_kf": np.int64, "obs_lm": np.int64}
    fields = {
        k: torch.from_numpy(np.ascontiguousarray(d[k], kinds.get(k, np.float32))).to(dev) for k in BA_FIELDS
    }
    return BAProblem(**fields, fx=float(d["fx"]), fy=float(d["fy"]), bf=float(d["bf"]))


PREINT_FIELDS = tuple(f.name for f in dataclasses.fields(Preintegrated))


def preintegrated_to_numpy(pre) -> dict:
    """A Preintegrated (the reference's or the port's: the field names are
    the same) as a dict of f32 numpy arrays."""
    return {k: _host(getattr(pre, k)).astype(np.float32) for k in PREINT_FIELDS}


def preintegrated_from_numpy(d: dict, device) -> Preintegrated:
    """Dict of a Preintegrated's fields -> the port's record on `device`."""
    dev = get_device(device)
    return Preintegrated(**{k: torch.from_numpy(np.array(d[k], np.float32)).to(dev) for k in PREINT_FIELDS})


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.array(x)


VIBA_FIELDS = (
    "Rwb", "twb", "vel", "bg", "ba", "kf_valid", "kf_fixed", "Xw", "lm_valid", "obs_kf", "obs_lm",
    "obs_uvr", "obs_sigma2", "obs_stereo", "obs_valid", "edge_i", "edge_j", "edge_valid", "Rcb", "tcb",
)


def vi_problem_from_numpy(d, device) -> VIBAProblem:
    """The reference VIBAProblem (or a dict of its fields) -> the port's on
    `device`: indices int64, masks bool, the rest f32; fx, fy, bf, prior_g
    and prior_a floats, prior_kf an int."""
    get = (lambda k: d[k]) if isinstance(d, dict) else (lambda k: getattr(d, k))
    dev = get_device(device)
    kinds = {"kf_valid": bool, "kf_fixed": bool, "lm_valid": bool, "obs_stereo": bool, "obs_valid": bool,
             "edge_valid": bool, "obs_kf": np.int64, "obs_lm": np.int64, "edge_i": np.int64, "edge_j": np.int64}
    fields = {
        k: torch.from_numpy(np.ascontiguousarray(_host(get(k)), kinds.get(k, np.float32))).to(dev)
        for k in VIBA_FIELDS
    }
    pre = get("pre")
    pre = preintegrated_from_numpy(pre if isinstance(pre, dict) else preintegrated_to_numpy(pre), dev)
    return VIBAProblem(
        **fields, pre=pre, fx=float(get("fx")), fy=float(get("fy")), bf=float(get("bf")),
        prior_kf=int(get("prior_kf")), prior_g=float(get("prior_g")), prior_a=float(get("prior_a")),
    )


def kf_store_from_numpy(m: MapState, device) -> DeviceKFStore:
    """Device keyframe store mirroring every valid keyframe of map `m`."""
    store = DeviceKFStore(m.cfg.max_keyframes, m.cfg.n_features, get_device(device))
    store.sync(m, np.nonzero(m.kf_valid)[0])
    return store


def tracker_config_from_reference(d: dict) -> TrackerConfig:
    """The reference TrackerConfig's fields as a dict (e.g.
    `dataclasses.asdict` without its nested objects) -> the port's config,
    for the fields the port reads. `camera` may be a dict of fx, fy, cx,
    cy[, dist]; `orb`, `map_cfg` and `imu` dicts of their fields (or, for
    `imu`, the reference's ImuSettings); `sensor` an enum member or its name.
    Unknown fields are ignored."""
    known = {f.name for f in dataclasses.fields(TrackerConfig)}
    kw = {k: v for k, v in d.items() if k in known}
    cam = kw.get("camera")
    if isinstance(cam, dict):
        kw["camera"] = camera_from_numpy(cam["fx"], cam["fy"], cam["cx"], cam["cy"], cam.get("dist", (0.0,) * 5))
    if isinstance(kw.get("orb"), dict):
        kw["orb"] = OrbParams(**kw["orb"])
    if isinstance(kw.get("map_cfg"), dict):
        kw["map_cfg"] = MapConfig(**kw["map_cfg"])
    imu = kw.get("imu")
    if imu is not None and not isinstance(imu, ImuSettings):
        d_imu = imu if isinstance(imu, dict) else dataclasses.asdict(imu)
        kw["imu"] = ImuSettings(**{**d_imu, "Tbc": np.array(d_imu["Tbc"], np.float32)})
    sensor = kw.get("sensor")
    if sensor is not None and not isinstance(sensor, Sensor):
        kw["sensor"] = Sensor[getattr(sensor, "name", sensor)]
    return TrackerConfig(**kw)


FRAME_ARRAYS = ("xy", "level", "angle", "desc", "valid", "lm_idx", "ur", "depth")


def frame_to_numpy(frame) -> dict | None:
    """A tracker's frame record (the reference's FrameData or the port's)
    as host arrays: pose, features and landmark bindings."""
    if frame is None:
        return None
    d = {k: np.array(getattr(frame, k)) for k in FRAME_ARRAYS}
    d.update(
        frame_id=int(frame.frame_id), timestamp=float(frame.timestamp),
        R=None if frame.R is None else np.array(frame.R, np.float32),
        t=None if frame.t is None else np.array(frame.t, np.float32),
    )
    return d


def frame_from_numpy(d: dict | None) -> FrameData | None:
    if d is None:
        return None
    kw = {k: np.array(d[k]) for k in FRAME_ARRAYS}
    kw["desc"] = kw["desc"].astype(np.uint32)
    return FrameData(
        frame_id=d["frame_id"], timestamp=d["timestamp"],
        R=None if d["R"] is None else np.array(d["R"], np.float32),
        t=None if d["t"] is None else np.array(d["t"], np.float32), **kw,
    )


def tracker_state_to_numpy(trk) -> dict:
    """The live tracking state of a tracker (the reference's or the port's:
    the attribute names are the same) as plain numbers and numpy arrays: the
    state machine, the `last` frame with its bindings, the motion model, the
    reference keyframe, the local-map snapshot's landmark ids and anchor,
    and an inertial tracker's state (`vi`: velocity, biases, the last body
    state, the marginal prior, the running preintegration since the last
    keyframe with its raw rows, the IMU clock, the chain's tail, the next
    ScaleRefinement window). With `map_state_to_numpy(trk.map)` it is
    everything one frame of tracking reads, so a reference tracker and a
    port tracker can be put in the same state and stepped side by side."""
    snap = trk._dev_local
    anchor = None if snap is None else snap.get("anchor")
    vi = None
    if getattr(trk, "inertial", False):
        pre = trk._pre_from_kf
        vi = dict(
            cur_v=np.array(trk.cur_v, np.float32), cur_bg=np.array(trk.cur_bg, np.float32),
            cur_ba=np.array(trk.cur_ba, np.float32),
            last_body=None if trk.last_body is None else tuple(np.array(x, np.float32) for x in trk.last_body),
            prior_H=None if trk.prior_H is None else np.array(trk.prior_H, np.float32),
            pre_from_kf=None if pre is None else preintegrated_to_numpy(pre),
            imu_since_kf=[np.array(r, np.float32) for r in trk._imu_since_kf],
            imu_since_kf_t=[float(t) for t in trk._imu_since_kf_t],
            last_imu_t=None if trk._last_imu_t is None else float(trk._last_imu_t),
            last_kf_slot=int(trk.last_kf_slot), scale_refine_idx=int(trk._scale_refine_idx),
            kf_inserted_last_frame=bool(trk._kf_inserted_last_frame),
        )
    return dict(
        state=trk.state.name, frame_id=int(trk.frame_id), ref_kf=int(trk.ref_kf),
        last_kf_frame_id=int(trk.last_kf_frame_id), n_kf_inserted=int(trk.n_kf_inserted),
        last_n_in=int(trk._last_n_in), lost_t=float(trk.lost_t),
        velocity=None if trk.velocity is None else tuple(np.array(v, np.float32) for v in trk.velocity),
        last=frame_to_numpy(trk.last),
        snapshot_ids=None if snap is None else np.array(snap["ids"]),
        snapshot_anchor=None if anchor is None else (int(anchor[0]), np.array(anchor[1]), np.array(anchor[2])),
        seen_change_idx=int(trk._seen_change_idx),
        trajectory=[(int(f), float(t), int(mid), int(k), np.array(R), np.array(tt)) for f, t, mid, k, R, tt in trk.trajectory],
        traj_anchor_ptr=int(trk._traj_anchor_ptr), lost_frames=int(trk.lost_frames),
        kf_alias={(int(a), int(b)): (int(c), int(d)) for (a, b), (c, d) in trk._kf_alias.items()},
        vi=vi,
    )


def load_tracker_state(
    trk: Tracker, state: dict, map_arrays: dict | None = None, atlas: dict | None = None,
    trajectory: bool = False,
) -> None:
    """Put a port tracker into a state made by `tracker_state_to_numpy`:
    with `map_arrays` (`map_state_to_numpy`) onto that map as its active
    one, with `atlas` (`atlas_to_numpy`) onto that whole Atlas, which the
    loop closer then reads too. The keyframe aliases are loaded; the
    trajectory records only with `trajectory=True` (else the new run records
    its own). The device snapshot and keyframe store are not carried over:
    the tracker rebuilds them from the map at its next frame."""
    if atlas is not None:
        trk.atlas = atlas_from_numpy(atlas)
        if trk.loop_closer is not None:
            trk.loop_closer.atlas = trk.atlas
    if map_arrays is not None:
        trk.map = map_state_from_numpy(map_arrays)
    trk._kf_store.invalidate()
    trk.state = TrackState[state["state"]]
    trk.frame_id = state["frame_id"]
    trk.ref_kf = state["ref_kf"]
    trk.last_kf_frame_id = state["last_kf_frame_id"]
    trk.n_kf_inserted = state["n_kf_inserted"]
    trk._last_n_in = state["last_n_in"]
    trk.lost_t = state["lost_t"]
    trk.velocity = None if state["velocity"] is None else tuple(np.array(v, np.float32) for v in state["velocity"])
    trk.last = frame_from_numpy(state["last"])
    trk._seen_change_idx = state["seen_change_idx"]
    trk.lost_frames = state.get("lost_frames", 0)
    trk._kf_alias = dict(state.get("kf_alias", {}))
    vi = state.get("vi")
    if vi is not None:
        trk.cur_v, trk.cur_bg, trk.cur_ba = (vi[k].copy() for k in ("cur_v", "cur_bg", "cur_ba"))
        trk.last_body = None if vi["last_body"] is None else tuple(x.copy() for x in vi["last_body"])
        trk.prior_H = None if vi["prior_H"] is None else vi["prior_H"].copy()
        trk._pre_from_kf = None if vi["pre_from_kf"] is None else preintegrated_from_numpy(vi["pre_from_kf"], trk.device)
        trk._imu_since_kf = [r.copy() for r in vi["imu_since_kf"]]
        trk._imu_since_kf_t = list(vi["imu_since_kf_t"])
        trk._last_imu_t = vi["last_imu_t"]
        trk.last_kf_slot = vi["last_kf_slot"]
        trk._scale_refine_idx = vi["scale_refine_idx"]
        trk._kf_inserted_last_frame = vi["kf_inserted_last_frame"]
    if getattr(trk, "inertial", False):
        trk.atlas.imu_calib = trk.imu_calib
        for m in trk.atlas.maps:
            m._imu_calib = trk.imu_calib
    if trajectory:
        trk.trajectory = [(f, t, mid, k, R.copy(), tt.copy()) for f, t, mid, k, R, tt in state["trajectory"]]
        trk._traj_anchor_ptr = state["traj_anchor_ptr"]
    trk._dev_local = None
    trk._chain = None
    trk._pipe.clear()


def kfdb_to_numpy(db) -> dict:
    """A keyframe database (the reference's or the port's: the attribute
    names are the same) as numpy: the codebook (None before the vocabulary
    exists), the word histograms and presence of every row, the stored
    packed descriptors, the keyframes waiting for the vocabulary and the
    descriptor pool that will seed it."""
    return dict(
        n_words=int(db.n_words), seed=int(db._seed), n_refreshes=int(db.n_refreshes),
        codebook=None if db.codebook is None else np.array(db.codebook),
        hists=np.array(db.hists), present=np.array(db.present),
        desc_store={int(k): (np.array(d), np.array(v)) for k, (d, v) in db._desc_store.items()},
        pending={int(k): (np.array(d), np.array(v)) for k, (d, v) in db._pending.items()},
        pool=[np.array(p) for p in db._pool], pool_count=int(db._pool_count),
    )


def kfdb_from_numpy(d: dict, device) -> KeyFrameDatabase:
    """The port's KeyFrameDatabase in the state of `kfdb_to_numpy`."""
    db = KeyFrameDatabase(d["hists"].shape[0], get_device(device), n_words=d["n_words"], seed=d["seed"])
    db.hists[...] = d["hists"]
    db.present[...] = d["present"]
    db.n_refreshes = d["n_refreshes"]
    db._desc_store = {k: (dd.copy(), v.copy()) for k, (dd, v) in d["desc_store"].items()}
    db._pending = {k: (dd.copy(), v.copy()) for k, (dd, v) in d["pending"].items()}
    db._pool = [p.copy() for p in d["pool"]]
    db._pool_count = d["pool_count"]
    if d["codebook"] is not None:
        db.codebook = d["codebook"].astype(np.int8)
        db._cb_j = db._put(db.codebook)
    return db


def loop_state_to_numpy(lc) -> dict:
    """A loop closer's state: the pending hypothesis (candidate gid, count,
    (s, R, t), keyframe), the last corrected keyframe, the persisted loop
    edges and the numbers of loops closed and merges proposed."""
    p = lc.pending
    return dict(
        pending=None if p is None else (int(p[0]), int(p[1]), (float(p[2][0]), np.array(p[2][1]), np.array(p[2][2])), int(p[3])),
        last_loop_kf=int(lc.last_loop_kf),
        loop_edges=[(int(mid), int(i), int(j), (float(S[0]), np.array(S[1]), np.array(S[2]))) for mid, i, j, S in lc.loop_edges],
        n_loops_closed=int(lc.n_loops_closed), n_merges=int(lc.n_merges),
    )


def load_loop_state(lc, d: dict) -> None:
    """Put a port loop closer into a state made by `loop_state_to_numpy`."""
    p = d["pending"]
    lc.pending = None if p is None else (p[0], p[1], (p[2][0], p[2][1].copy(), p[2][2].copy()), p[3])
    lc.last_loop_kf = d["last_loop_kf"]
    lc.loop_edges = [(mid, i, j, (S[0], S[1].copy(), S[2].copy())) for mid, i, j, S in d["loop_edges"]]
    lc.n_loops_closed = d["n_loops_closed"]
    lc.n_merges = d["n_merges"]


def load_place_recognition(trk: Tracker, kfdb: dict, loop: dict | None = None) -> None:
    """Give a port tracker (and its loop closer) the keyframe database of
    `kfdb_to_numpy` and, with `loop`, the loop state of `loop_state_to_numpy`."""
    trk.kfdb = kfdb_from_numpy(kfdb, trk.device)
    if trk.loop_closer is not None:
        trk.loop_closer.kfdb = trk.kfdb
        if loop is not None:
            load_loop_state(trk.loop_closer, loop)
