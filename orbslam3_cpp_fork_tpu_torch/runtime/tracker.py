"""Monocular tracking + local mapping (port of runtime/tracker.py).

Host-orchestrated state machine (Tracking.cc + LocalMapping.cc) whose heavy
stages are fixed-shape device programs:

frame -> extract_orb -> [two-view init | fused three-stage track] ->
keyframe policy -> (insert KF -> triangulate new landmarks -> fuse
duplicates -> cull -> window BA -> cull keyframes)

Ported: the monocular, stereo and RGB-D runtime with place recognition, in
both of the reference's modes, at the reference's defaults (loop closing and
global BA on). `async_mapping=True` (the default) runs the mapping step on a
background thread (`runtime/mapping_worker.py`), the loop step on a second
one (`LoopWorker`) and a global BA after a loop closure on a third, and
resolves `pipeline_lag=2`: on an established, comfortably tracked map each
frame is one chained dispatch of `fused_frame_program` whose result block is
copied to the host asynchronously and retired `pipeline_lag` frames later.
`async_mapping=False` with `pipeline_lag=0` is the frame-synchronous,
bit-reproducible control, with the loop step and the global BA inline. A
frame the fused path declines is retried by the split-phase path
(`_track_frame_slow`), and a failure there enters the
OK -> RECENTLY_LOST -> LOST ladder, where frames are relocalized through the
keyframe database (`_relocalize`). Corrections made on another thread reach
the live frame through `MapState.big_change_idx` (`_rebase_after_map_change`).
Stereo and RGB-D frames (`track_stereo`, `track_rgbd`) carry a right
coordinate and a depth per feature, initialize the map from one frame, take
the split-phase path with stereo rows in the pose optimization, seed close
points at every keyframe and close loops in SE(3). The inertial sensors
(IMU_MONOCULAR, IMU_STEREO, IMU_RGBD) take `imu=` rows with every frame: the
rows are preintegrated on the device (`ops/imu.py`), a keyframe chain carries
velocities, biases and the preintegration between keyframes, tracking adds
one inertial edge to the pose optimization once the IMU is initialized
(`_pose_optimize_vi`), the mapping step runs the IMU init ladder
(InitializeIMU -> VIBA1 -> VIBA2 -> ScaleRefinement, `_imu_ladder`) and
visual-inertial window BA, loops close with the 4-DoF essential graph, and
the global BA after a loop is FullInertialBA. The Atlas
holds many maps: past `reloc_patience` failed relocalizations (or at a frame
older than its predecessor) a map of fewer than 10 keyframes is reset and a
larger one kept while a fresh one starts (`_spawn_or_reset_map`); when the
loop closer later validates a revisit of a kept map, `_execute_merge` welds
the active map into it through the validated Sim(3), fuses the seam, runs a
welding BA and the merge essential graph. Trajectory records of a merged
map follow its keyframes through `_kf_alias`.

The host side is numpy, as in the reference; device work runs on
`Tracker.device` in f32 (window BA included), each stage fetches its
result block in one transfer (`device.fetch_block`), and every shape is
padded to the configured caps so the programs stay capturable. Both threads
launch their device work on the current (default) stream: the card is idle
most of the time, one stream orders every tensor that crosses the threads
(keyframe-store rows, the local-map snapshot, a frame's features) without
events, and the price is that a fetch of the mapping thread also waits for
the tracking work queued before it. The map lock guards the numpy gathers
and write-backs; the one device fetch under it is an inertial keyframe's
preintegration at its insertion (as in the reference).

Trajectory bookkeeping stores (ref_kf, T_frame<-refkf) like
Tracking::mlRelativeFramePoses, so BA corrections reach the exported
trajectory.

Scale-out: when a `torch.distributed` default group of more than one rank
is initialized, the foreground whole-map BAs (`_global_ba` and the sparse
FullInertialBA) shard their observations over its ranks
(parallel/dist_ba.py); background solves stay local. The contract is the
reference's under `shard_map` and multi-process JAX: every rank runs the
same program on the same input, and there is no server rank.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import logging
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from ..device import GraphedCall, block_nbytes, fetch_block, fetch_block_async, get_device
from ..models.atlas import Atlas
from ..models.map_state import LEVEL_SIGMA2, MapConfig, MapState
from ..ops import geometry, matching, orb, ransac, stereo
from ..ops import imu as imu_ops
from ..ops.camera import Camera, true_div, undistort_points
from ..ops.image import N_LEVELS, SCALE_FACTOR
from ..ops.image import scale_pow as _scale_pow
from ..utils import lie
from ..utils.timers import StageTimers
from .keyframe_database import MAX_MAPS, KeyFrameDatabase, row_of, split_row

log = logging.getLogger("orbslam3_torch.tracker")

# log(1.2) evaluated in f32, as the reference's jnp.log(SCALE_FACTOR).
_LOG_SCALE = torch.log(torch.tensor(SCALE_FACTOR, dtype=torch.float32)).item()


def informed_obs_drop(o_lm: np.ndarray, cap: int, rng: np.random.Generator, keep_per_lm: int = 4) -> np.ndarray:
    """Select `cap` observation indices, keeping a core of up to
    `keep_per_lm` observations per landmark before any landmark loses more
    (a uniform random drop can remove all observations of a landmark).
    Which observations form a landmark's core is randomized."""
    n = len(o_lm)
    if n <= cap:
        return np.arange(n)
    perm = rng.permutation(n)
    lm_p = o_lm[perm]
    srt = np.argsort(lm_p, kind="stable")
    lm_s = lm_p[srt]
    new_grp = np.r_[True, lm_s[1:] != lm_s[:-1]]
    grp_start_idx = np.nonzero(new_grp)[0]
    grp_id = np.cumsum(new_grp) - 1
    rank = np.arange(n) - grp_start_idx[grp_id]
    rank_p = np.empty(n, np.int64)
    rank_p[srt] = rank
    core = perm[rank_p < keep_per_lm]
    rest = perm[rank_p >= keep_per_lm]
    if len(core) >= cap:
        return core[:cap]
    return np.concatenate([core, rest[: cap - len(core)]])


class TrackState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    RECENTLY_LOST = 3
    LOST = 4


class Sensor(enum.Enum):
    """System::eSensor."""

    MONOCULAR = 0
    STEREO = 1
    RGBD = 2
    IMU_MONOCULAR = 3
    IMU_STEREO = 4
    IMU_RGBD = 5


@dataclasses.dataclass
class ImuSettings:
    """IMU noise and extrinsics (Settings::readIMU, src/Settings.cc:387-414).
    Tbc maps camera coordinates to body/IMU coordinates (mImuCalib.mTbc)."""

    noise_gyro: float = 1.7e-4
    noise_acc: float = 2e-3
    walk_gyro: float = 1.9e-5
    walk_acc: float = 3e-3
    freq: float = 200.0
    Tbc: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4, dtype=np.float32))


@dataclasses.dataclass
class TrackerConfig:
    """The reference's tracker configuration (same names, same defaults)."""

    camera: Camera = None
    width: int = 752
    height: int = 480
    sensor: Sensor = Sensor.MONOCULAR
    imu: ImuSettings | None = None
    # IMU init ladder (LocalMapping::Run :232-286): the temporal chain's
    # minimum length and elapsed seconds for InitializeIMU, then the VIBA1 /
    # VIBA2 refinements.
    imu_init_min_kfs: int = 10
    imu_init_time: float = 1.0
    viba1_time: float = 5.0
    viba2_time: float = 15.0
    # Mono-inertial ScaleRefinement windows and the bad-IMU thresholds
    # (src/LocalMapping.cc:265-276 and :170-179).
    scale_refine_times: tuple = (25.0, 35.0, 45.0, 55.0, 65.0, 75.0)
    scale_refine_window: float = 0.5
    bad_imu_time: float = 10.0
    bad_imu_dist: float = 0.02
    imu_kf_period: float = 0.25  # keyframe cadence until IMU init
    # Visual-inertial BA capacities.
    vi_kf_cap: int = 16
    vi_full_kf_cap: int = 48
    vi_obs_cap: int = 24576
    # IMU rows integrated per frame interval (later rows are dropped, as the
    # reference's fixed window drops them).
    imu_frame_cap: int = 64
    orb: orb.OrbParams = dataclasses.field(default_factory=orb.OrbParams)
    # Stereo / RGB-D: bf = baseline * fx (mbf); the close/far point
    # threshold mThDepth = bf * ThDepth / fx; the RGB-D depth map's factor
    # to meters.
    bf: float = 0.0
    th_depth: float = 0.0
    depth_factor: float = 1.0
    # Unrectified (fisheye) stereo: the right camera, left -> right
    # extrinsics (mTrl) and the lapping areas. With camera2 set,
    # track_stereo matches descriptors in the lapping areas and
    # triangulates instead of the rectified row-band match.
    camera2: Camera | None = None
    R_rl: np.ndarray | None = None
    t_rl: np.ndarray | None = None
    lapping_l: tuple = (0.0, 1e9)
    lapping_r: tuple = (0.0, 1e9)
    stereo_init_min_features: int = 500  # StereoInitialization
    enable_loop_closing: bool = True
    # Run the mapping step on a background thread so per-frame track latency
    # stays flat across keyframe insertions. Tracking reads a bounded-stale
    # map. Set False for bit-deterministic runs.
    async_mapping: bool = True
    # Software-pipelined tracking: per-frame device programs chain on the
    # device (pose prediction and the bound-landmark carry are device
    # tensors of the previous program) and the host retires results
    # `pipeline_lag` frames late from asynchronous host copies. None
    # resolves to 2 when async_mapping else 0.
    pipeline_lag: int | None = None
    # The tracker pipelines while inliers stay above pipeline_enter_inliers
    # on a map of at least pipeline_min_kfs keyframes, shortens the lag to 1
    # below pipeline_exit_inliers, and tracks young maps synchronously.
    pipeline_enter_inliers: int = 60
    pipeline_exit_inliers: int = 45
    pipeline_min_kfs: int = 8
    # While the map has fewer keyframes than this, the track thread drains
    # the mapping worker after every insertion: a young mono map cannot
    # absorb a trailing frontier.
    young_map_kfs: int = 12
    # Bounded-staleness budget: before tracking each frame, wait up to this
    # many ms for the mapping worker's in-flight step to reach its frontier.
    # 0 disables (race freely).
    map_wait_budget_ms: float = 250.0
    # Re-center the device local-map snapshot at least this often (frames).
    snapshot_max_age_frames: int = 3
    # Matching / tracking thresholds (reference values).
    init_min_matches: int = 100
    min_track_matches: int = 20
    min_track_inliers: int = 10
    min_localmap_inliers: int = 30
    # Acceptance floor while the mapping worker is behind on an established
    # map; equal to the strict floor by default (a transient RECENTLY_LOST
    # recovers cleanly, a map corrupted by weak frames does not).
    min_localmap_inliers_degraded: int = 30
    # Relocalization acceptance (after the projection-search escalation).
    reloc_min_inliers: int = 50
    kf_max_interval: int = 30
    kf_min_interval: int = 4
    # Temporally newest keyframes placed ahead of the covisibles in the
    # triangulation pair set.
    tri_recent_first: int = 8
    # Covisible neighbours triangulated against per new keyframe.
    triangulate_neighbors: int = 6
    # Seconds of RECENTLY_LOST grace before declaring LOST.
    time_recently_lost: float = 5.0
    kf_ref_ratio: float = 0.9
    # Maximum frame gap a relative trajectory record may span before it is
    # re-anchored onto the next inserted keyframe.
    max_record_gap: int = 15
    local_window_kfs: int = 10
    ba_iters_per_kf: int = 6
    # Static capacities of the device programs.
    local_lm_cap: int = 4096
    ba_kf_cap: int = 16
    ba_fixed_cap: int = 8
    ba_lm_cap: int = 4096
    ba_obs_cap: int = 24576
    # Whole-map (global) BA after a loop closure: the sparse PCG-Schur
    # solver; observations are padded to multiples of gba_obs_bucket.
    enable_global_ba: bool = True
    gba_obs_cap: int = 98304
    gba_obs_bucket: int = 16384
    gba_iters: int = 10
    map_cfg: MapConfig = dataclasses.field(default_factory=MapConfig)


# ----------------------------------------------------------------------------
# Device programs
# ----------------------------------------------------------------------------


def project_landmarks(
    R, t, pos, normal, min_dist, max_dist, lm_valid,
    fx, fy, cx, cy, width, height, n_levels: int = N_LEVELS,
):
    """Frustum + scale-band + viewing-angle gate and predicted search level
    for map landmarks (Frame::isInFrustum, MapPoint::PredictScale).

    Returns (uv (L,2), level (L,) int32, dist (L,), ok (L,) bool).
    """
    pc = lie.se3_apply(R, t, pos)
    z = pc[:, 2]
    z_safe = torch.where(z < 1e-6, torch.full_like(z, 1e-6), z)
    u = fx * pc[:, 0] / z_safe + cx
    v = fy * pc[:, 1] / z_safe + cy
    cam_center = -torch.einsum("ji,j->i", R, t)
    d = pos - cam_center
    dist = torch.linalg.vector_norm(d, dim=-1)
    cos_view = torch.sum(d * normal, dim=-1) / torch.clamp_min(dist, 1e-9)
    ok = (
        lm_valid
        & (z > 0.05)
        & (u >= 0) & (u < width) & (v >= 0) & (v < height)
        & (dist >= min_dist * 0.8) & (dist <= max_dist * 1.2)
        & (cos_view > 0.5)
    )
    ratio = torch.clamp_min(max_dist, 1e-9) / torch.clamp_min(dist, 1e-9)
    # f32 as the reference. A landmark seen from its own keyframe sits on a
    # level boundary, where the last bit of the f32 log decides the level,
    # and that bit differs between the CPU and CUDA libraries.
    level = torch.ceil(true_div(torch.log(ratio), _LOG_SCALE)).to(torch.int32)
    level = torch.clamp(level, 0, n_levels - 1)
    return torch.stack([u, v], dim=-1), level, dist, ok


def match_initialization(desc1_i8, xy1, valid1, angle1, desc2_i8, xy2, valid2, angle2):
    """2-view init matching: windowed (100 px) ratio 0.9 + rotation check
    (ORBmatcher::SearchForInitialization)."""
    dist = matching.hamming_matrix(desc1_i8, desc2_i8)
    pen = matching.window_penalty(xy1, xy2, torch.full((xy1.shape[0],), 100.0, device=xy1.device))
    idx, ok = matching.match_nn(dist, valid1, valid2, max_dist=50, ratio=0.9, cross_check=True, extra_penalty=pen)
    ok = matching.rotation_consistency(angle1, angle2, idx, ok)
    return idx, ok


def match_by_projection_leveled(
    lm_bits, lm_valid, uv_pred, pred_level, radius_base, f_bits, f_xy, f_level, f_valid,
):
    """Projection search with the per-landmark radius scaled by the
    predicted level (SearchByProjection map->frame)."""
    radius = radius_base * _scale_pow(pred_level)
    return matching.search_by_projection(
        lm_bits, lm_valid, uv_pred, pred_level, f_bits, f_xy, f_level, f_valid, radius,
        max_dist=matching.TH_HIGH, ratio=0.9, level_band=1,
    )


def match_bow_like(desc1_i8, valid1, angle1, desc2_i8, valid2, angle2):
    """Unwindowed ratio-0.7 matching with rotation check: stands in for
    SearchByBoW (the BoW node alignment is only an acceleration; the dense
    distance matrix needs none)."""
    dist = matching.hamming_matrix(desc1_i8, desc2_i8)
    idx, ok = matching.match_nn(dist, valid1, valid2, max_dist=matching.TH_LOW, ratio=0.7, cross_check=True)
    ok = matching.rotation_consistency(angle1, angle2, idx, ok)
    return idx, ok


def match_triangulation(desc1_i8, xy1, free1, angle1, desc2_i8, xy2, free2, angle2, sigma2_2, F12):
    """Epipolar-constrained matching of unbound features for new-landmark
    triangulation (ORBmatcher::SearchForTriangulation)."""
    dist = matching.hamming_matrix(desc1_i8, desc2_i8)
    pen = matching.epipolar_penalty(F12, xy1, xy2, sigma2_2)
    idx, ok = matching.match_nn(
        dist, free1, free2, max_dist=matching.TH_LOW, ratio=0.8, cross_check=True, extra_penalty=pen,
    )
    ok = matching.rotation_consistency(angle1, angle2, idx, ok)
    return idx, ok


def triangulate_and_check(
    R1, t1, R2, t2, K, uv1, uv2, sigma2_1, sigma2_2,
    z_st1, z_st2, ur1, ur2, bf, oct_ratio, valid,
):
    """Batched new-landmark geometry with the reference's full policy
    (LocalMapping::CreateNewMapPoints):

    - Parallax arbitration: DLT-triangulate only when the two-view ray
      parallax beats the stereo rig's own parallax cos(2*atan2(b/2, z));
      otherwise unproject from the stereo depth of whichever keyframe has
      the stronger rig parallax (mono features carry depth < 0 and always
      take the two-view route).
    - Acceptance: positive depth in both views; reprojection chi2 < 5.991
      (mono) / 7.815 with the ur residual (stereo features); octave
      scale-consistency ratio within 1.5x the scale factor.

    z_st*/ur*: per-feature stereo depth / right-u (< 0 = mono feature).
    oct_ratio: scale1/scale2 = 1.2^(lvl1-lvl2) per candidate pair.
    Returns (X (N,3), good (N,)).
    """
    st1 = z_st1 > 0
    st2 = z_st2 > 0
    b = bf / K[0, 0]
    two = torch.full_like(z_st1, 2.0)
    cs1 = torch.where(st1, torch.cos(2.0 * torch.atan2(b / 2.0, z_st1)), two)
    cs2 = torch.where(st2, torch.cos(2.0 * torch.atan2(b / 2.0, z_st2)), two)
    cs = torch.minimum(cs1, cs2)

    # Ray parallax from the keypoint bearings (not the DLT point).
    Kinv = geometry._inv(K)
    ones = torch.ones((uv1.shape[0], 1), dtype=uv1.dtype, device=uv1.device)
    xn1 = torch.cat([uv1, ones], -1) @ Kinv.T
    xn2 = torch.cat([uv2, ones], -1) @ Kinv.T
    ray1 = xn1 @ R1  # = R1^T xn rowwise (world direction)
    ray2 = xn2 @ R2
    cosp = torch.sum(ray1 * ray2, -1) / torch.clamp_min(
        torch.linalg.vector_norm(ray1, dim=-1) * torch.linalg.vector_norm(ray2, dim=-1), 1e-12
    )

    P1 = geometry.projection_matrix(K, R1, t1)
    P2 = geometry.projection_matrix(K, R2, t2)
    X_dlt = geometry.triangulate_dlt(P1, P2, uv1, uv2)
    # Rig unprojections: X = R^T (z * K^-1 [u,v,1] - t).
    X_s1 = (xn1 * z_st1[:, None] - t1) @ R1
    X_s2 = (xn2 * z_st2[:, None] - t2) @ R2

    use_dlt = (cosp > 0) & (cosp < cs) & (st1 | st2 | (cosp < 0.9998))
    use_s1 = ~use_dlt & st1 & (cs1 < cs2)
    use_s2 = ~use_dlt & ~use_s1 & st2
    X = torch.where(use_dlt[:, None], X_dlt, torch.where(use_s1[:, None], X_s1, X_s2))
    accepted = use_dlt | use_s1 | use_s2

    pc1 = lie.se3_apply(R1, t1, X)
    pc2 = lie.se3_apply(R2, t2, X)
    z1, z2 = pc1[:, 2], pc2[:, 2]

    def reproj_chi2(pc, uv, ur, st, sigma2):
        zs = torch.where(torch.abs(pc[:, 2]) < 1e-9, torch.full_like(pc[:, 2], 1e-9), pc[:, 2])
        p = (pc / zs[:, None]) @ K.T
        e = torch.sum((p[:, :2] - uv) ** 2, dim=-1)
        e_r = (p[:, 0] - bf / zs - ur) ** 2
        chi = (e + torch.where(st, e_r, torch.zeros_like(e_r))) / sigma2
        return chi < torch.where(st, 7.815, 5.991)

    ok1 = reproj_chi2(pc1, uv1, ur1, st1, sigma2_1)
    ok2 = reproj_chi2(pc2, uv2, ur2, st2, sigma2_2)
    c1 = -torch.einsum("ji,j->i", R1, t1)
    c2 = -torch.einsum("ji,j->i", R2, t2)
    dist1 = torch.linalg.vector_norm(X - c1, dim=-1)
    dist2 = torch.linalg.vector_norm(X - c2, dim=-1)
    ratio_dist = dist2 / torch.clamp_min(dist1, 1e-12)
    ratio_factor = 1.5 * SCALE_FACTOR
    scale_ok = (ratio_dist * ratio_factor >= oct_ratio) & (ratio_dist <= oct_ratio * ratio_factor)
    good = (
        valid
        & accepted
        & torch.all(torch.isfinite(X), dim=-1)
        & (z1 > 0.01) & (z2 > 0.01)
        & ok1 & ok2 & scale_ok
    )
    return X, good


def _unpack_desc(desc_packed: torch.Tensor) -> torch.Tensor:
    """(...,8) packed descriptor words (int64 holding uint32) -> (...,256)
    int8 bits on the device (np.unpackbits little order)."""
    shifts = torch.arange(32, dtype=torch.int64, device=desc_packed.device)
    bits = (desc_packed[..., :, None] >> shifts) & 1
    return bits.reshape(*desc_packed.shape[:-1], 256).to(torch.int8)


# Compacted result capacities: the device compacts accepted candidates so
# that the fetched block is small (triangulation rarely yields more than
# ~300 accepted candidates per pair, fusion ~300 matches per target).
TRI_CAP = 384
FUSE_CAP = 512


def _compact(good: torch.Tensor, cap: int):
    """Indices of the True entries first, in order (stable), cut to `cap`;
    and which of the kept rows are True."""
    sel = torch.argsort((~good).to(torch.int8), stable=True)[:cap]
    return sel, good[sel]


def fused_triangulate_batch(
    R1, t1, desc1, xy1, free1, angle1, level1, depth1, ur1,
    R2s, t2s, desc2s, xy2s, free2s, angle2s, level2s, depth2s, ur2s,
    pair_ok, K, bf,
):
    """All neighbour-pair triangulation for one keyframe insertion as one
    device program: per covisible neighbour, fundamental -> epipolar
    matching -> triangulation + acceptance policy. The pairs run back to
    back with no host read in between, one 1000x1000 matching block alive
    at a time. Results are compacted on the device: per pair, up to TRI_CAP
    accepted candidates as (f1, f2, X) rows with f1 = -1 padding.
    Returns (f1 (T,C) int32, f2 (T,C) int32, X (T,C,3), n_match (T,))."""
    bits1 = _unpack_desc(desc1)
    sig2_1 = _scale_pow(2 * level1)
    f1s, f2s, Xs, n_matches = [], [], [], []
    for j in range(R2s.shape[0]):
        R2, t2, lvl2, pok = R2s[j], t2s[j], level2s[j], pair_ok[j]
        bits2 = _unpack_desc(desc2s[j])
        sig2_2 = _scale_pow(2 * lvl2)
        F12 = geometry.fundamental_from_poses(R1, t1, R2, t2, K, K)
        idx, ok = match_triangulation(
            bits1, xy1, free1 & pok, angle1, bits2, xy2s[j], free2s[j] & pok, angle2s[j], sig2_2, F12.T,
        )
        oct_ratio = _scale_pow(level1 - lvl2[idx])
        X, good = triangulate_and_check(
            R1, t1, R2, t2, K, xy1, xy2s[j][idx], sig2_1, sig2_2[idx],
            depth1, depth2s[j][idx], ur1, ur2s[j][idx], bf, oct_ratio, ok & pok,
        )
        sel, keep = _compact(good, TRI_CAP)  # accepted rows first, stable
        f1s.append(torch.where(keep, sel, torch.full_like(sel, -1)).to(torch.int32))
        f2s.append(idx[sel].to(torch.int32))
        Xs.append(X[sel])
        n_matches.append(torch.sum((ok & pok).to(torch.int32)))
    return torch.stack(f1s), torch.stack(f2s), torch.stack(Xs), torch.stack(n_matches)


def fused_triangulate_store(
    s_desc, s_xy, s_level, s_angle, s_depth, s_ur,  # device KF store
    k1, tri_idx,  # new-KF row, (T,) neighbour rows
    R1, t1, R2s, t2s,
    free1, free2s,  # (N,), (T,N) host-computed unbound masks
    pair_ok, K, bf,
):
    """fused_triangulate_batch with the keyframe-row gathers inside the
    program: the caller passes the whole device keyframe store plus row
    indices instead of pre-gathered rows."""
    return fused_triangulate_batch(
        R1, t1, s_desc[k1], s_xy[k1], free1, s_angle[k1], s_level[k1], s_depth[k1], s_ur[k1],
        R2s, t2s, s_desc[tri_idx], s_xy[tri_idx], free2s,
        s_angle[tri_idx], s_level[tri_idx], s_depth[tri_idx], s_ur[tri_idx],
        pair_ok, K, bf,
    )


def fused_fuse_batch(
    lm_pos, lm_normal, lm_min_dist, lm_max_dist, lm_desc, lm_valid,
    tgt_mask,  # (T,L): per-target landmark subset
    kf_R, kf_t,  # (T,3,3), (T,3)
    kf_desc, kf_xy, kf_level, kf_valid,  # (T,N,8),(T,N,2),(T,N),(T,N)
    fx, fy, cx, cy, width, height,
):
    """The matching half of SearchInNeighbors duplicate fusion
    (ORBmatcher::Fuse) over all target keyframes as one device program:
    project each landmark subset into its target, window-match at the
    scale-predicted radius, chi2-gate. The targets run back to back with no
    host read in between. Returns compacted (lm_slot (T,FUSE_CAP), feat
    (T,FUSE_CAP)) match pairs (lm_slot = -1 padding); the merge bookkeeping
    (Replace policy) stays on the host."""
    lm_bits = _unpack_desc(lm_desc)
    lmcs, feats = [], []
    for j in range(kf_R.shape[0]):
        R, t, xy, lvl = kf_R[j], kf_t[j], kf_xy[j], kf_level[j]
        bits_kf = _unpack_desc(kf_desc[j])
        pc = lie.se3_apply(R, t, lm_pos)
        z = pc[:, 2]
        zs = torch.where(z < 1e-6, torch.full_like(z, 1e-6), z)
        u = fx * pc[:, 0] / zs + cx
        v = fy * pc[:, 1] / zs + cy
        c = -torch.einsum("ji,j->i", R, t)
        dvec = lm_pos - c
        dist = torch.linalg.vector_norm(dvec, dim=-1)
        cosv = torch.sum(dvec * lm_normal, dim=-1) / torch.clamp_min(dist, 1e-9)
        okp = (
            tgt_mask[j] & lm_valid & (z > 0.05)
            & (u >= 0) & (u < width) & (v >= 0) & (v < height)
            & (dist >= lm_min_dist) & (dist <= lm_max_dist)
            & (cosv > 0.5)
        )
        ratio = torch.clamp_min(lm_max_dist / torch.clamp_min(dist, 1e-9), 1.0)
        lvl_pred = torch.clamp(torch.ceil(true_div(torch.log(ratio), _LOG_SCALE)), 0, N_LEVELS - 1).to(torch.int32)
        radius = 3.0 * _scale_pow(lvl_pred)
        uv = torch.stack([u, v], -1)
        dmat = matching.hamming_matrix(lm_bits, bits_kf)
        pen = matching.window_penalty(uv, xy, radius, lvl, lvl_pred - 1, lvl_pred + 1)
        idx, mok = matching.match_nn(
            dmat, okp, kf_valid[j], matching.TH_LOW, 1.0, cross_check=True, extra_penalty=pen,
        )
        # Reprojection chi2 gate at the matched keypoint's octave.
        e2 = torch.sum((xy[idx] - uv) ** 2, dim=-1)
        sig2 = _scale_pow(2 * lvl[idx])
        mok = mok & (e2 <= 5.991 * sig2)
        sel, keep = _compact(mok, FUSE_CAP)
        lmcs.append(torch.where(keep, sel, torch.full_like(sel, -1)).to(torch.int32))
        feats.append(idx[sel].to(torch.int32))
    return torch.stack(lmcs), torch.stack(feats)


def fused_fuse_store(
    lm_geom,  # (L,8) f32: pos xyz, normal xyz, min_dist, max_dist
    lm_desc, lm_valid,
    cur_mask, fuse_mask, is_last,  # (L,), (L,), (T,) target-row masks
    s_desc, s_xy, s_level, s_valid,  # device KF store
    fuse_idx,  # (T,) target keyframe rows
    kf_R, kf_t,
    fx, fy, cx, cy, width, height,
):
    """fused_fuse_batch with keyframe-row gathers inside the program and
    the landmark geometry packed into one upload. Target rows project the
    new KF's landmarks (`cur_mask`); the final row (`is_last`) projects the
    neighbourhood's landmarks back into the new KF (`fuse_mask`)."""
    tgt_mask = torch.where(is_last[:, None], fuse_mask[None, :], cur_mask[None, :])
    return fused_fuse_batch(
        lm_geom[:, 0:3], lm_geom[:, 3:6], lm_geom[:, 6], lm_geom[:, 7],
        lm_desc, lm_valid, tgt_mask,
        kf_R, kf_t,
        s_desc[fuse_idx], s_xy[fuse_idx], s_level[fuse_idx], s_valid[fuse_idx],
        fx, fy, cx, cy, width, height,
    )


# ----------------------------------------------------------------------------
# Frame record (host)
# ----------------------------------------------------------------------------


class FrameData:
    """Per-frame record (the reference's Frame).

    Feature arrays are lazy: extraction output stays on the device and the
    host copies materialize on first attribute access in one batched
    transfer. `desc_i8` is never transferred: it is recomputed from the
    packed descriptors on the host."""

    def __init__(self, frame_id, timestamp, xy=None, level=None, angle=None,
                 desc=None, desc_i8=None, valid=None, R=None, t=None,
                 lm_idx=None, ur=None, depth=None, feats_dev=None,
                 xy_dev=None, img_u8=None):
        self.frame_id = frame_id
        self.timestamp = timestamp
        self.img_u8 = img_u8  # raw frame; kept until features exist
        self._xy = xy
        self._level = level
        self._angle = angle
        self._desc = desc
        self._desc_i8 = desc_i8
        self._valid = valid
        self.R = R  # Tcw
        self.t = t
        self.lm_idx = lm_idx  # (N,) bound landmark ids (-1 none)
        self.ur = ur  # (N,) right-u (<0 mono feature)
        self.depth = depth  # (N,) depth (<0 unknown)
        self._feats_dev = feats_dev  # orb.Features on the device
        self._xy_dev = xy_dev  # undistorted keypoints, device

    def _materialize(self):
        fd = self._feats_dev
        if fd is None:
            return
        xy, level, angle, desc, valid = fetch_block(
            (self._xy_dev if self._xy_dev is not None else fd.xy, fd.level, fd.angle, fd.desc, fd.valid)
        )
        if self._xy is None:
            self._xy = xy
        if self._level is None:
            self._level = level
        if self._angle is None:
            self._angle = angle
        if self._desc is None:
            self._desc = desc.astype(np.uint32)
        if self._valid is None:
            self._valid = valid

    def _lazy(self, name):
        if getattr(self, name) is None:
            self._materialize()
        return getattr(self, name)

    def host_keypoints(self) -> tuple[np.ndarray, np.ndarray]:
        """(xy, valid) where the host copies exist, else two empty arrays:
        nothing is fetched from the device (the viewers' read)."""
        if self._xy is None or self._valid is None:
            return np.zeros((0, 2), np.float32), np.zeros(0, bool)
        return self._xy, self._valid

    @property
    def xy(self) -> np.ndarray:
        return self._lazy("_xy")

    @property
    def level(self) -> np.ndarray:
        return self._lazy("_level")

    @property
    def angle(self) -> np.ndarray:
        return self._lazy("_angle")

    @property
    def desc(self) -> np.ndarray:
        return self._lazy("_desc")

    @property
    def valid(self) -> np.ndarray:
        return self._lazy("_valid")

    @property
    def desc_i8(self) -> np.ndarray:
        if self._desc_i8 is None:
            self._desc_i8 = np.unpackbits(
                np.ascontiguousarray(self.desc).view(np.uint8), axis=-1, bitorder="little",
            ).astype(np.int8)
        return self._desc_i8


class DeviceKFStore:
    """Device-resident mirror of the per-keyframe static feature arrays
    (descriptors, keypoints, levels, angles, validity, stereo depth).

    Triangulation and fusion consume whole keyframe rows; rows are uploaded
    once per keyframe (lazily, generation-checked, so every mutation path
    is covered) and the device programs gather them by index. Poses are not
    mirrored: they move with every optimization and are small."""

    def __init__(self, K: int, N: int, device: torch.device):
        self.device = device
        self.gen = np.full(K, -1, np.int64)
        self.map_id = -1
        self.desc = torch.zeros((K, N, 8), dtype=torch.int64, device=device)
        self.xy = torch.zeros((K, N, 2), dtype=torch.float32, device=device)
        self.level = torch.zeros((K, N), dtype=torch.int32, device=device)
        self.angle = torch.zeros((K, N), dtype=torch.float32, device=device)
        self.valid = torch.zeros((K, N), dtype=torch.bool, device=device)
        self.depth = torch.zeros((K, N), dtype=torch.float32, device=device)
        self.ur = torch.zeros((K, N), dtype=torch.float32, device=device)

    def invalidate(self) -> None:
        """Forget every row: the next `sync` uploads what it is asked for.
        Needed where a map keeps its id while its keyframe generations
        restart (a reset map, a loaded Atlas: ROADMAP R13)."""
        self.gen[:] = -1
        self.map_id = -1

    def sync(self, m, ks) -> None:
        """Ensure rows `ks` mirror map `m` (call under the map lock)."""
        if m.map_id != self.map_id:
            self.gen[:] = -1
            self.map_id = m.map_id
        need = np.unique([int(k) for k in ks if self.gen[k] != m.kf_gen[k]]).astype(np.int64)
        if len(need) == 0:
            return
        at = torch.from_numpy(need).to(self.device)

        def put(dst, src):
            dst.index_copy_(0, at, torch.from_numpy(np.ascontiguousarray(src)).to(self.device))

        put(self.desc, m.kf_desc[need].astype(np.int64))
        put(self.xy, m.kf_xy[need])
        put(self.level, m.kf_level[need])
        put(self.angle, m.kf_angle[need])
        put(self.valid, m.kf_feat_valid[need])
        put(self.depth, m.kf_depth[need])
        put(self.ur, m.kf_ur[need])
        self.gen[need] = m.kf_gen[need]


# ----------------------------------------------------------------------------
# The tracker
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class CullStats:
    """What keyframe culling decided, counted over a tracker's life: the
    calls, the valid keyframes that were no neighbour at weight 15 (never
    candidates), and every candidate by the reason it was kept or culled.
    `redundancy` holds the redundant fraction of every candidate whose
    fraction was computed. Reading only: nothing here feeds a decision."""

    calls: int = 0
    not_neighbour: int = 0
    candidates: int = 0
    protected: int = 0  # the new keyframe, the reference, the chain's tail, the map origin
    inertial_gap: int = 0
    few_landmarks: int = 0
    below_redundancy: int = 0
    max_cull: int = 0  # left once the call's bound was reached
    culled: int = 0
    redundancy: list = dataclasses.field(default_factory=list)


class Tracker:
    """Visual SLAM front end + local mapping (System::TrackMonocular /
    TrackStereo / TrackRGBD + Tracking::Track + LocalMapping::Run), with the
    mapping step on the caller's thread or on a `MappingWorker`."""

    def __init__(self, cfg: TrackerConfig, device: str | torch.device = "cuda"):
        assert cfg.camera is not None
        self.cfg = cfg
        self.device = get_device(device)
        self.cam = cfg.camera
        self.fx, self.fy, self.cx, self.cy = self.cam.fx, self.cam.fy, self.cam.cx, self.cam.cy
        self.K = np.array([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]], np.float32)
        self._K_dev = torch.from_numpy(self.K).to(self.device)
        # Feature capacity follows the extractor budget.
        cfg.map_cfg.n_features = cfg.orb.n_features
        self.timers = StageTimers()
        # Inertial setup: the calibration lives on the tracker's device, where
        # every preintegration runs.
        self.inertial = cfg.sensor in (Sensor.IMU_MONOCULAR, Sensor.IMU_STEREO, Sensor.IMU_RGBD)
        self.imu_calib = None
        if self.inertial:
            s = cfg.imu or ImuSettings()
            cfg.imu = s
            Tbc = np.asarray(s.Tbc, np.float32)
            self.imu_calib = imu_ops.ImuCalib.create(
                s.noise_gyro, s.noise_acc, s.walk_gyro, s.walk_acc, s.freq,
                Tbc_R=Tbc[:3, :3], Tbc_t=Tbc[:3, 3], device=self.device,
            )
            self.Rbc = Tbc[:3, :3]
            self.tbc = Tbc[:3, 3]
            self.Rcb = self.Rbc.T
            self.tcb = (-self.Rbc.T @ self.tbc).astype(np.float32)
        # IMU runtime state.
        self._imu_since_kf: list[np.ndarray] = []  # rows [dt, acc3, gyro3] since the last keyframe
        self._imu_since_kf_t: list[float] = []  # their absolute stamps
        self._frame_imu: np.ndarray | None = None  # this frame's rows
        self._pre_from_kf: imu_ops.Preintegrated | None = None  # running, since the last keyframe
        self._last_imu_t: float | None = None
        self.cur_v = np.zeros(3, np.float32)
        self.cur_bg = np.zeros(3, np.float32)
        self.cur_ba = np.zeros(3, np.float32)
        self.last_body = None  # (Rwb, p, v) of the last tracked frame
        self.prior_H = None  # 15x15 marginal prior of the last-frame VI optimization
        self._kf_inserted_last_frame = False
        self._scale_refine_idx = 0  # next ScaleRefinement window
        # A bad-IMU verdict of the mapping thread: the map reset it asks for
        # rewrites live tracking state, so the track thread performs it.
        self._pending_reset = False
        # The VI pose optimization by anchor variant, as one CUDA graph each on
        # the card (`_vi_pose_call`).
        self._vi_pose_calls: dict[bool, GraphedCall] = {}
        self._preint_call: GraphedCall | None = None  # `_preintegrate_rows`
        self.atlas = Atlas(cfg.map_cfg, imu_calib=self.imu_calib)
        self.map_lock = threading.RLock()
        self.state = TrackState.NO_IMAGES_YET
        self.last: FrameData | None = None
        self.init_ref: FrameData | None = None
        self.velocity: tuple[np.ndarray, np.ndarray] | None = None  # Tcl
        self.ref_kf: int = -1
        self.last_kf_slot = -1  # temporal-chain tail (inertial only)
        self.last_kf_frame_id: int = -1
        self.frame_id: int = 0
        # RANSAC hypotheses of the initializer and of relocalization are
        # drawn from this generator.
        self.rng = torch.Generator().manual_seed(0)
        self.n_hyp = 256
        self.n_hyp_pnp = 128
        # Trajectory bookkeeping: (frame_id, timestamp, map_id, ref_kf, R_cr, t_cr)
        self.trajectory: list[tuple] = []
        self._traj_anchor_ptr = 0
        self.n_kf_inserted = 0
        self.cull_stats = CullStats()
        self._dev_local: dict | None = None  # device local-map snapshot
        self._snap_seq = 0  # bumped on every _dev_local swap
        self._last_n_in = 0  # latest tracked-inlier count (any path)
        self.n_sync_frames = 0
        self.n_pipelined_frames = 0
        # Frames the fused path declined and handed to the split-phase path.
        self.n_fused_declined = 0
        # Whole-map BAs solved with their observations sharded over the
        # default process group (parallel/dist_ba.py).
        self.n_sharded_solves = 0
        # Frames without a pose after the loss ladder (RECENTLY_LOST without
        # re-acquisition, LOST without relocalization).
        self.n_lost_frames = 0
        # Consecutive failed relocalizations in LOST; past `reloc_patience`
        # the active map is reset or a new one spawned, and the event counted.
        self.lost_frames = 0
        self.reloc_patience = 12
        self.n_reloc_patience_exceeded = 0
        self.n_lost_events = 0  # OK -> RECENTLY_LOST/LOST transitions
        self.n_frames_dropped = 0  # in-flight frames discarded on failure
        self.n_kf_skipped_backpressure = 0
        self.localization_only = False  # System.activate_localization_mode
        self.lost_t = 0.0  # timestamp at which RECENTLY_LOST began
        # Per-frame cause tags for latency attribution (frame_id -> [tags]):
        # every event that can stall a frame records why.
        self.frame_causes: dict[int, list[str]] = collections.defaultdict(list)
        self.n_fused_last = 0  # duplicates merged by the last mapping step
        # Software-pipelined tracking state. `_pipe` holds in-flight
        # dispatched frames; `_chain` the newest program's device outputs.
        self.pipeline_lag = cfg.pipeline_lag if cfg.pipeline_lag is not None else (2 if cfg.async_mapping else 0)
        self._pipe: collections.deque = collections.deque()
        self._chain: dict | None = None
        self._last_retired_T: np.ndarray | None = None
        self._identity_remap: torch.Tensor | None = None  # cached (cap,) arange
        # Pinned host buffers of the asynchronous result fetch, one per
        # pipeline slot (allocated at the first pipelined frame on a card).
        self._pipe_bufs: list[torch.Tensor] = []
        self._kf_store = DeviceKFStore(cfg.map_cfg.max_keyframes, cfg.orb.n_features, self.device)
        # Per-KF scene median depth cache (triangulation baseline gate).
        self._kf_med_depth = np.zeros(cfg.map_cfg.max_keyframes, np.float32)
        self._kf_med_depth_ver = (-1, -1)
        # Place recognition: one keyframe database with a row per (map,
        # keyframe slot) (`_gid`), and the loop closer sharing the device
        # keyframe store and the map lock.
        from .loop_closing import LoopCloser, LoopConfig

        self.kfdb = KeyFrameDatabase(MAX_MAPS * cfg.map_cfg.max_keyframes, self.device)
        self.loop_closer = None
        if cfg.enable_loop_closing:
            self.loop_closer = LoopCloser(
                self.atlas, self.kfdb, self.fx, self.fy, self.cx, self.cy, self.device,
                LoopConfig(fix_scale=cfg.sensor != Sensor.MONOCULAR),
            )
            self.loop_closer.global_ba_hook = self._global_ba_after_loop
            self.loop_closer.lock = self.map_lock
            self.loop_closer.kf_store = self._kf_store
        # The big_change_idx this thread last rebased onto (corrections of
        # other threads bump the map's).
        self._seen_change_idx = 0
        # Keyframe aliases across map merges: (map_id, kf) -> (map_id', kf').
        self._kf_alias: dict[tuple[int, int], tuple[int, int]] = {}
        # A merge proposal of the loop thread, executed by the track thread
        # at its next frame: (keyframe, proposal).
        self._pending_merge: tuple | None = None
        # Correction events (global BA applied or dropped; relocalizations).
        self.events: list[dict] = []
        self._gba_thread: threading.Thread | None = None
        self._gba_error: BaseException | None = None
        # Last, once everything its threads may touch exists.
        self.worker = None
        self.loop_worker = None
        if cfg.async_mapping:
            from .mapping_worker import LoopWorker, MappingWorker

            self.worker = MappingWorker(self)
            if self.loop_closer is not None:
                self.loop_worker = LoopWorker(self)

    @property
    def map(self) -> MapState:
        return self.atlas.active

    @map.setter
    def map(self, m: MapState) -> None:
        """Replace the active map (a state loaded through `convert`)."""
        self.atlas.maps[self.atlas.active_idx] = m

    def _gid(self, k: int, map_id: int | None = None) -> int:
        """Keyframe-database row of (map, keyframe slot)."""
        return row_of(self.map.map_id if map_id is None else map_id, k, self.cfg.map_cfg.max_keyframes)

    # ------------------------------------------------------------------

    def _put(self, x, dtype=None) -> torch.Tensor:
        """Host array -> tensor on the tracker's device."""
        a = np.ascontiguousarray(x) if dtype is None else np.ascontiguousarray(x, dtype)
        return torch.from_numpy(a).to(self.device)

    def _dev_feats(self, frame: "FrameData"):
        """(xy undistorted, level, desc_i8, valid, angle) of a frame on the
        device: the extractor's own tensors, or uploads of host arrays."""
        fd = frame._feats_dev
        if fd is not None:
            return frame._xy_dev, fd.level, fd.desc_i8, fd.valid, fd.angle
        put = self._put
        return put(frame.xy), put(frame.level), put(frame.desc_i8), put(frame.valid), put(frame.angle)

    def _sample_hypotheses(self, valid: torch.Tensor) -> torch.Tensor:
        return ransac.sample_indices(self.rng, self.n_hyp, 8, valid)

    def _extract(self, img: np.ndarray, timestamp: float) -> FrameData:
        """Build the per-frame record carrying the raw image; extraction is
        dispatched by `_ensure_feats`."""
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        n = self.cfg.orb.n_features
        return FrameData(
            frame_id=self.frame_id,
            timestamp=timestamp,
            img_u8=img,
            lm_idx=np.full(n, -1, np.int32),
            ur=np.full(n, -1.0, np.float32),
            depth=np.full(n, -1.0, np.float32),
        )

    def _upload(self, img: np.ndarray) -> torch.Tensor:
        """A host image on the tracker's device (through pinned memory on a
        card)."""
        host = torch.from_numpy(np.ascontiguousarray(img))
        if self.device.type == "cuda":
            host = host.pin_memory().to(self.device, non_blocking=True)
        return host

    def _upload_image(self, frame: FrameData) -> torch.Tensor:
        """The frame's raw uint8 image on the tracker's device."""
        return self._upload(frame.img_u8)

    def _ensure_feats(self, frame: FrameData):
        """Dispatch extraction + undistortion; results stay on the device
        (host copies materialize lazily in one batched fetch)."""
        if frame._feats_dev is not None or frame.img_u8 is None:
            return
        with self.timers.span("orb_extract"):
            feats = orb.extract_orb(self._upload_image(frame).to(torch.float32), self.cfg.orb)
        frame._feats_dev = feats
        frame._xy_dev = undistort_points(self.cam, feats.xy)
        frame.img_u8 = None

    # ------------------------------------------------------------------
    # IMU plumbing (Tracking::GrabImuData + PreintegrateIMU)
    # ------------------------------------------------------------------

    def _ingest_imu(self, imu: np.ndarray | None, timestamp: float):
        """Absolute-time IMU rows [t, acc3, gyro3] covering the interval since
        the previous frame -> [dt, acc3, gyro3] steps, with a partial last
        step up to the frame's stamp."""
        if not self.inertial:
            return
        rows, times = [], []
        if imu is not None and len(imu):
            imu = np.asarray(imu, np.float32)
            t_prev = self._last_imu_t if self._last_imu_t is not None else float(imu[0, 0])
            for r in imu:
                t = float(r[0])
                dt = t - t_prev
                t_prev = t
                if dt <= 0:
                    continue
                rows.append(np.concatenate([[dt], r[1:4], r[4:7]]).astype(np.float32))
                times.append(t)
            if timestamp > t_prev:  # partial tail step to the frame stamp
                last = imu[-1]
                rows.append(np.concatenate([[timestamp - t_prev], last[1:4], last[4:7]]).astype(np.float32))
                times.append(timestamp)
        self._last_imu_t = timestamp
        self._frame_imu = np.stack(rows) if rows else None
        self._imu_since_kf.extend(rows)
        self._imu_since_kf_t.extend(times)

    def _preintegrate_rows(self, rows, bg, ba, init=None) -> imu_ops.Preintegrated:
        """Preintegrate up to `imu_frame_cap` [dt, acc, gyro] rows on the
        tracker's device, from biases (bg, ba) or continuing `init`. The rows
        are padded to a multiple of 8 with masked steps (which leave the state
        as it is, bit for bit), so that a few CUDA graphs serve every frame
        (`GraphedCall`)."""
        n = 0 if rows is None else min(len(rows), self.cfg.imu_frame_cap)
        if init is None:
            init = imu_ops.Preintegrated.identity(self._put(bg, np.float32), self._put(ba, np.float32))
        if n == 0:
            return init
        buf = np.zeros((-(-n // 8) * 8, 8), np.float32)
        buf[:n, :7] = rows[:n]
        buf[:n, 7] = 1.0
        dev_buf = self._put(buf)
        fields = dataclasses.fields(imu_ops.Preintegrated)
        if self._preint_call is None:
            calib = self.imu_calib

            def fn(b, *state):
                s0 = imu_ops.Preintegrated(*state)
                out = imu_ops.preintegrate(b[:, 1:4], b[:, 4:7], b[:, 0], calib, s0.bias_gyro, s0.bias_acc,
                                           init=s0, valid=b[:, 7] > 0)
                return [getattr(out, f.name) for f in fields]

            self._preint_call = GraphedCall(fn)
        return imu_ops.Preintegrated(*self._preint_call(dev_buf, *[getattr(init, f.name) for f in fields]))

    def _body_from_cam_np(self, R, t):
        """Twb from Tcw (numpy, batched)."""
        Rwc = np.swapaxes(np.asarray(R), -1, -2)
        twc = -np.einsum("...ij,...j->...i", Rwc, np.asarray(t))
        Rwb = Rwc @ self.Rbc.T
        twb = twc - np.einsum("...ij,j->...i", Rwb, self.tbc)
        return Rwb.astype(np.float32), twb.astype(np.float32)

    def _cam_from_body_np(self, Rwb, twb):
        """Tcw from Twb (numpy, batched)."""
        Rwc = np.asarray(Rwb) @ self.Rbc
        twc = np.asarray(twb) + np.einsum("...ij,j->...i", np.asarray(Rwb), self.tbc)
        Rcw = np.swapaxes(Rwc, -1, -2)
        tcw = -np.einsum("...ij,...j->...i", Rcw, twc)
        return Rcw.astype(np.float32), tcw.astype(np.float32)

    def _reset_vi_runtime(self):
        self._imu_since_kf = []
        self._imu_since_kf_t = []
        self._pre_from_kf = None
        self.last_body = None
        self.prior_H = None
        self.last_kf_slot = -1
        self.cur_v = np.zeros(3, np.float32)
        self.cur_bg = np.zeros(3, np.float32)
        self.cur_ba = np.zeros(3, np.float32)
        self._kf_inserted_last_frame = False
        self._scale_refine_idx = 0

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------

    def track(self, img: np.ndarray, timestamp: float, imu: np.ndarray | None = None) -> np.ndarray | None:
        """Monocular frame; returns 4x4 Tcw or None while initializing/lost.
        `imu`: (M,7) rows [t, ax, ay, az, gx, gy, gz] since the previous
        frame (System::TrackMonocular's vImuMeas), for an inertial sensor."""
        self._ingest_imu(imu, timestamp)
        frame = self._extract(img, timestamp)
        return self._process(frame)

    def _upload_float(self, img: np.ndarray) -> torch.Tensor:
        """A host image as f32 on the tracker's device, values as given (the
        reference's stereo and RGB-D entry points take jnp.float32 of the
        input)."""
        return self._upload(np.asarray(img, np.float32))

    def _depth_frame(self, feats, xy_dev, ur, depth, timestamp: float) -> FrameData:
        n = self.cfg.orb.n_features
        return FrameData(
            frame_id=self.frame_id, timestamp=timestamp, lm_idx=np.full(n, -1, np.int32),
            ur=ur.astype(np.float32), depth=depth.astype(np.float32), feats_dev=feats, xy_dev=xy_dev,
        )

    def track_stereo(self, img_l: np.ndarray, img_r: np.ndarray, timestamp: float,
                     imu: np.ndarray | None = None) -> np.ndarray | None:
        """Stereo pair (System::TrackStereo): ORB on both images (one
        describe launch each), then the rectified row-band match with SAD
        refinement, or, with `camera2`, the fisheye lapping-area match and
        triangulation. `imu` as in `track`. Returns 4x4 Tcw or None."""
        self._ingest_imu(imu, timestamp)
        cfg = self.cfg
        with self.timers.span("orb_extract"):
            jl, jr = self._upload_float(img_l), self._upload_float(img_r)
            fl = orb.extract_orb(jl, cfg.orb)
            fr = orb.extract_orb(jr, cfg.orb)
        with self.timers.span("stereo_match"):
            if cfg.camera2 is not None:
                depth, _, ok = stereo.match_stereo_fisheye(
                    fl.desc_i8, fl.xy, fl.level, fl.valid, fr.desc_i8, fr.xy, fr.level, fr.valid,
                    self.cam, cfg.camera2, self._put(cfg.R_rl, np.float32), self._put(cfg.t_rl, np.float32),
                    float(cfg.lapping_l[0]), float(cfg.lapping_r[1]),
                )
                xy_dev = undistort_points(self.cam, fl.xy)
                xy_ud, d, ok = fetch_block((xy_dev, depth, ok))
                ur = np.where(ok, xy_ud[:, 0] - cfg.bf / np.maximum(d, 1e-6), -1.0)
            else:
                # Rectified input: the keypoints are already undistorted.
                ur, depth, _ = stereo.compute_stereo_matches(
                    jl, jr, fl.desc_i8, fl.xy, fl.level, fl.valid, fr.desc_i8, fr.xy, fr.level, fr.valid,
                    cfg.bf, cfg.bf / self.fx,
                )
                xy_dev = fl.xy
                ur, d = fetch_block((ur, depth))
        return self._process(self._depth_frame(fl, xy_dev, ur, d, timestamp))

    def track_rgbd(self, img: np.ndarray, depth_map: np.ndarray, timestamp: float,
                   imu: np.ndarray | None = None) -> np.ndarray | None:
        """RGB-D frame (System::TrackRGBD): the depth map sampled at the raw
        keypoints gives each feature its depth and a virtual right
        coordinate against its undistorted u. `imu` as in `track`. Returns
        4x4 Tcw or None."""
        self._ingest_imu(imu, timestamp)
        cfg = self.cfg
        with self.timers.span("orb_extract"):
            feats = orb.extract_orb(self._upload_float(img), cfg.orb)
        xy_dev = undistort_points(self.cam, feats.xy)
        _, d, ok = stereo.depth_to_stereo(self._upload_float(depth_map), feats.xy, cfg.bf, cfg.depth_factor)
        xy_ud, d, ok = fetch_block((xy_dev, d, ok))
        # ur against the undistorted u (ComputeStereoFromRGBD).
        ur = np.where(ok, xy_ud[:, 0] - cfg.bf / np.maximum(d, 1e-6), -1.0)
        return self._process(self._depth_frame(feats, xy_dev, ur, d, timestamp))

    def _process(self, frame: FrameData) -> np.ndarray | None:
        # Bounded-staleness wait (see TrackerConfig.map_wait_budget_ms):
        # give the in-flight mapping step a bounded chance to land before
        # this frame tracks.
        if self.worker is not None and self.cfg.map_wait_budget_ms > 0 and self.worker.busy():
            t_w = time.perf_counter()
            done = self.worker.wait_idle(self.cfg.map_wait_budget_ms / 1e3)
            waited = (time.perf_counter() - t_w) * 1e3
            if waited > 2.0:
                self.frame_causes[frame.frame_id].append(f"map_wait:{waited:.0f}ms" + ("" if done else "+"))
        # Hand-backs of the mapping and loop threads: a bad-IMU verdict's map
        # reset and a merge proposal execute here on the track thread (they
        # rewrite live tracking state), and a correction (loop closure, global
        # BA, IMU re-alignment) rebases the last frame before this one tracks.
        if self._pending_reset:
            self._pending_reset = False
            self._spawn_or_reset_map()
        if self._pending_merge is not None:
            mk, proposal = self._pending_merge
            self._pending_merge = None
            self._drain_pipeline()
            if self.worker is not None:
                self.worker.flush()
            if self.map.kf_valid[mk] and self.last is not None and self.last.R is not None:
                with self.map_lock:
                    self._execute_merge(mk, self.last, *proposal)
        self._rebase_after_map_change()
        self._timestamp_guards(frame.timestamp)
        if self.state == TrackState.OK and self._pipeline_active():
            T = self._track_frame_pipelined(frame)
            self.frame_id += 1
            return T
        self._ensure_feats(frame)
        if self.state in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED):
            if self.cfg.sensor in (Sensor.MONOCULAR, Sensor.IMU_MONOCULAR):
                self._initialize(frame)
            else:
                self._initialize_from_depth(frame)
        elif self.state == TrackState.RECENTLY_LOST:
            self._recently_lost_step(frame)
        elif self.state == TrackState.LOST:
            if self._relocalize(frame):
                self.lost_frames = 0
            else:
                self.n_lost_frames += 1
                self.lost_frames += 1
                if self.lost_frames > self.reloc_patience:
                    self.n_reloc_patience_exceeded += 1
                    self._spawn_or_reset_map()
        else:
            self._track_frame(frame)
        self.frame_id += 1
        if frame.R is not None:
            self._record_trajectory(frame)
            return self._pose_T(frame)
        return None

    # ------------------------------------------------------------------
    # Initialization (MonocularInitialization)
    # ------------------------------------------------------------------

    def _initialize(self, frame: FrameData):
        n_feat = int(frame.valid.sum())
        if self.init_ref is None or n_feat < self.cfg.init_min_matches:
            if n_feat >= self.cfg.init_min_matches:
                self.init_ref = frame
                self.state = TrackState.NOT_INITIALIZED
            self.last = frame
            return
        ref = self.init_ref
        xy1, _, bits1, valid1, angle1 = self._dev_feats(ref)
        xy2, _, bits2, valid2, angle2 = self._dev_feats(frame)
        idx_d, ok_d = match_initialization(bits1, xy1, valid1, angle1, bits2, xy2, valid2, angle2)
        idx, ok = fetch_block((idx_d, ok_d))
        n_matches = int(ok.sum())
        if n_matches < self.cfg.init_min_matches:
            # Too few: re-seed the initializer with the new frame.
            self.init_ref = frame
            self.last = frame
            return
        res = ransac.reconstruct_two_views(
            xy1, xy2[idx_d], ok_d, self._K_dev, self._sample_hypotheses(ok_d),
        )
        success, R, t, points, good = fetch_block((res.success, res.R, res.t, res.points, res.good))
        if not bool(success):
            self.last = frame
            return
        self._create_initial_map(ref, frame, idx, R, t, points, good)
        self.last = frame

    def _feat_sigma2(self, level: np.ndarray) -> np.ndarray:
        return LEVEL_SIGMA2[np.clip(level, 0, N_LEVELS - 1)]

    def _create_initial_map(self, ref: FrameData, frame: FrameData, idx, R2, t2, pts, good):
        """Two keyframes and the triangulated landmarks of a successful
        two-view reconstruction (R2, t2, pts, good as numpy), normalized to
        unit median depth, then a two-keyframe BA
        (CreateInitialMapMonocular)."""
        med_depth = float(np.median(pts[good][:, 2]))
        if med_depth <= 0:
            return
        scale = 1.0 / med_depth
        pts = pts * scale
        t2 = t2 * scale

        # Keyframe 1 at identity, keyframe 2 at (R2, t2).
        ref.R, ref.t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
        frame.R, frame.t = R2.astype(np.float32), t2.astype(np.float32)

        gi = np.nonzero(good)[0]  # indices into ref features
        fi = idx[gi]  # matched feature in current frame
        m = self.map
        lm_ids = m.add_landmarks(
            pos=pts[gi],
            desc_packed=frame.desc[fi],
            desc_i8=frame.desc_i8[fi],
            first_kf=0,
            level=frame.level[fi],
            normal=np.zeros((len(gi), 3), np.float32),
            min_dist=np.full(len(gi), 0.1, np.float32),
            max_dist=np.full(len(gi), 100.0, np.float32),
        )
        ref_lm = np.full(len(ref.valid), -1, np.int32)
        ref_lm[gi] = lm_ids
        cur_lm = np.full(len(frame.valid), -1, np.int32)
        cur_lm[fi] = lm_ids
        k1 = m.add_keyframe(
            ref.R, ref.t, ref.xy, ref.level, ref.angle, ref.desc, ref.valid,
            ref_lm, ref.timestamp, ref.frame_id,
        )
        k2 = m.add_keyframe(
            frame.R, frame.t, frame.xy, frame.level, frame.angle, frame.desc,
            frame.valid, cur_lm, frame.timestamp, frame.frame_id,
        )
        m.update_landmark_stats(lm_ids)
        frame.lm_idx = cur_lm
        self.kfdb.add(self._gid(k1), ref.desc_i8, ref.valid)
        self.kfdb.add(self._gid(k2), frame.desc_i8, frame.valid)
        # Initial BA over both KFs (GlobalBundleAdjustemnt(20) at init).
        self._local_ba([k1, k2], fix=[k1])
        self.ref_kf = k2
        self.last_kf_frame_id = frame.frame_id
        self.velocity = None
        self.state = TrackState.OK
        self.n_kf_inserted = 2
        if self.inertial:
            # Seed the temporal chain: KF1 has no predecessor; KF2 gets the
            # IMU rows between the two initialization frames.
            m.set_keyframe_inertial(k1, np.zeros(3, np.float32), self.cur_bg, self.cur_ba, -1, None)
            rows_t = np.asarray(self._imu_since_kf_t)
            rows = np.stack(self._imu_since_kf) if self._imu_since_kf else np.zeros((0, 7), np.float32)
            sel = (rows_t > ref.timestamp) & (rows_t <= frame.timestamp + 1e-9)
            m.set_keyframe_inertial(k2, np.zeros(3, np.float32), self.cur_bg, self.cur_ba, k1,
                                    rows[sel] if sel.any() else None)
            self._start_chain(k2, ref.timestamp)
            Rwb, p = self._body_from_cam_np(frame.R, frame.t)
            self.last_body = (Rwb, p, np.zeros(3, np.float32))
        log.info("map initialized: %d landmarks from %d matches", len(gi), len(idx))

    def _start_chain(self, k: int, t0: float):
        """Keyframe k becomes the temporal chain's tail at a map's start; the
        IMU clock of the map starts at t0."""
        self._imu_since_kf = []
        self._imu_since_kf_t = []
        self._pre_from_kf = None
        self.last_kf_slot = k
        self.map.imu_t0 = t0
        self._kf_inserted_last_frame = True

    # ------------------------------------------------------------------
    # Stereo / RGB-D initialization (StereoInitialization): depth gives
    # metric structure from one frame, which becomes KF 0 at the origin.
    # ------------------------------------------------------------------

    def _unproject_depth(self, frame: FrameData, feats: np.ndarray) -> np.ndarray:
        """Back-project features with known depth to world points."""
        z = frame.depth[feats]
        x = (frame.xy[feats, 0] - self.cx) / self.fx * z
        y = (frame.xy[feats, 1] - self.cy) / self.fy * z
        pc = np.stack([x, y, z], 1).astype(np.float32)
        Rwc = frame.R.T
        return pc @ Rwc.T + (-Rwc @ frame.t)

    def _initialize_from_depth(self, frame: FrameData):
        if int(frame.valid.sum()) < self.cfg.stereo_init_min_features:
            self.last = frame
            self.state = TrackState.NOT_INITIALIZED
            return
        frame.R = np.eye(3, dtype=np.float32)
        frame.t = np.zeros(3, np.float32)
        feats = np.nonzero(frame.valid & (frame.depth > 0))[0]
        if len(feats) < 100:
            frame.R = frame.t = None
            self.last = frame
            return
        m = self.map
        X = self._unproject_depth(frame, feats)
        dist = np.linalg.norm(X, axis=1)  # the camera sits at the origin
        with self.map_lock:
            lm_ids = m.add_landmarks(
                pos=X,
                desc_packed=frame.desc[feats],
                desc_i8=frame.desc_i8[feats],
                first_kf=0,
                level=frame.level[feats],
                normal=(X / np.maximum(dist[:, None], 1e-9)).astype(np.float32),
                min_dist=(dist * 0.5).astype(np.float32),
                max_dist=(dist * 2.0).astype(np.float32),
            )
            frame.lm_idx[feats] = lm_ids
            k = m.add_keyframe(
                frame.R, frame.t, frame.xy, frame.level, frame.angle, frame.desc,
                frame.valid, frame.lm_idx, frame.timestamp, frame.frame_id,
                ur=frame.ur, depth=frame.depth,
            )
            m.update_landmark_stats(lm_ids)
        self.kfdb.add(self._gid(k), frame.desc_i8, frame.valid)
        self.ref_kf = k
        self.last_kf_frame_id = frame.frame_id
        self.velocity = None
        self.state = TrackState.OK
        self.n_kf_inserted = 1
        if self.inertial:
            m.set_keyframe_inertial(k, np.zeros(3, np.float32), self.cur_bg, self.cur_ba, -1, None)
            self._start_chain(k, frame.timestamp)
            Rwb, p = self._body_from_cam_np(frame.R, frame.t)
            self.last_body = (Rwb, p, np.zeros(3, np.float32))
        self.last = frame
        log.info("stereo/RGB-D map initialized: %d landmarks", len(feats))

    # ------------------------------------------------------------------
    # Frame tracking
    # ------------------------------------------------------------------

    def _predict_pose(self, frame: FrameData):
        if self.inertial and self.map.imu_stage >= 1 and self.last_body is not None:
            # IMU dead reckoning from the last frame's body state
            # (Tracking::PredictStateIMU).
            pre = self._preintegrate_rows(self._frame_imu, self.cur_bg, self.cur_ba)
            Rwb, p, v = self.last_body
            put = self._put
            R2, p2, v2 = imu_ops.predict_state(put(Rwb), put(p), put(v), pre, put(self.cur_bg), put(self.cur_ba))
            Rwb2, p2, v2 = fetch_block((R2, p2, v2))
            frame.R, frame.t = self._cam_from_body_np(Rwb2, p2)
            self.cur_v = v2
            return
        if self.velocity is not None and self.last.R is not None:
            Rv, tv = self.velocity
            frame.R = (Rv @ self.last.R).astype(np.float32)
            frame.t = (Rv @ self.last.t + tv).astype(np.float32)
        else:
            frame.R = self.last.R.copy()
            frame.t = self.last.t.copy()

    def _check_replaced_in_last_frame(self):
        """Re-point last-frame bindings at fusion survivors
        (Tracking::CheckReplacedInLastFrame)."""
        if self.last is None or self.last.lm_idx is None:
            return
        m = self.map
        idx = self.last.lm_idx
        bound = np.nonzero(idx >= 0)[0]
        if len(bound) == 0:
            return
        with self.map_lock:
            ids = m.resolve_replaced(idx[bound])
            idx[bound] = np.where(m.lm_valid[ids], ids, -1)

    def _track_frame(self, frame: FrameData):
        """Per-frame OK-state tracking: the fused single-program device
        path (one result fetch per frame); a frame that path cannot
        confidently track runs the split-phase path."""
        self._check_replaced_in_last_frame()
        self.n_sync_frames += 1
        # Stereo and RGB-D frames take the split-phase path: the fused
        # program has no stereo rows.
        if self.cfg.sensor == Sensor.MONOCULAR and self.last is not None and self.last.R is not None:
            with self.timers.span("track_fused"):
                if self._track_frame_fused(frame):
                    return
            self.n_fused_declined += 1
        self._track_frame_slow(frame)

    def _local_map_version(self) -> tuple:
        """Cache key for the device local-map snapshot: anything that
        creates/moves/merges landmarks bumps one of these. The frame-id
        bucket bounds snapshot age: the window is anchored at the pose it
        was built from, and a rotating camera walks out of its own snapshot
        before the next mapping event unless the window re-centers."""
        m = self.map
        w = self.worker
        return (
            m.map_id, self.n_kf_inserted, m.big_change_idx,
            (w.n_processed, w.n_frontier) if w is not None else 0,
            self.frame_id // self.cfg.snapshot_max_age_frames,
        )

    def _refresh_dev_local(self) -> bool:
        """(Re)build the device-resident local-map snapshot from the
        previous frame's local keyframes, when its version changed."""
        ver = self._local_map_version()
        c = self._dev_local
        if c is not None and c["ver"] == ver:
            return True
        # Never stall the track thread behind a long map-lock hold: with an
        # existing snapshot, bounded staleness is the designed behaviour;
        # reuse it and refresh on a later frame.
        if not self.map_lock.acquire(blocking=False):
            if c is not None:
                return True
            self.map_lock.acquire()
        try:
            return self._refresh_dev_local_locked(self.map, self.cfg.local_lm_cap, ver)
        finally:
            self.map_lock.release()

    def _refresh_dev_local_locked(self, m, cap, ver) -> bool:
        last_bound = np.unique(self.last.lm_idx[self.last.lm_idx >= 0])
        last_bound = last_bound[m.lm_valid[last_bound]]
        local_kfs = self._local_keyframes(self.last)
        # K2 expansion (UpdateLocalKeyFrames): covisible neighbours of the
        # strongest sharers extend the window ahead of the motion.
        if len(local_kfs):
            k2 = [local_kfs]
            for k1 in local_kfs[:3]:
                neigh, _ = m.covisible_keyframes(int(k1), min_weight=15, top=5)
                k2.append(neigh)
            local_kfs = np.unique(np.concatenate(k2))
        lm_ids = m.local_map_landmarks(local_kfs)
        # Frustum augmentation: add every map landmark that projects into a
        # widened window around the last pose, so that a weak frame cannot
        # thin its own snapshot.
        if self.last.R is not None:
            ids_all = np.nonzero(m.lm_valid)[0]
            if len(ids_all):
                pc = m.lm_pos[ids_all] @ self.last.R.T + self.last.t
                z = np.maximum(pc[:, 2], 1e-6)
                u = self.fx * pc[:, 0] / z + self.cx
                v = self.fy * pc[:, 1] / z + self.cy
                wmar = 0.3 * self.cfg.width
                hmar = 0.3 * self.cfg.height
                okf = (
                    (pc[:, 2] > 0.05)
                    & (u >= -wmar) & (u < self.cfg.width + wmar)
                    & (v >= -hmar) & (v < self.cfg.height + hmar)
                )
                lm_ids = np.union1d(lm_ids, ids_all[okf])
        # Last-frame-bound landmarks first so capacity truncation can never
        # drop the stage-1 carry set.
        rest = np.setdiff1d(lm_ids, last_bound)
        lm_ids = np.concatenate([last_bound, rest])[:cap]
        n = len(lm_ids)
        if n < 30:
            self._dev_local = None
            return False
        pad = cap - n

        def padf(x, fill=0):
            return np.concatenate([x, np.full((pad, *x.shape[1:]), fill, x.dtype)])

        self._snap_seq += 1
        # Anchor for the retirement-time rebase: a snapshot-window keyframe
        # whose pose IS the snapshot's world frame. When the background
        # window BA moves the map between a frame's dispatch and its
        # retirement, composing the anchor's pose delta re-expresses the
        # pose in the current map. The last inserted keyframe is in every
        # window-BA window, so it rides every correction.
        if self.ref_kf >= 0 and m.kf_valid[self.ref_kf]:
            a = int(self.ref_kf)
        else:
            a = int(local_kfs[0]) if len(local_kfs) else -1
        anchor = (a, m.kf_R[a].copy(), m.kf_t[a].copy()) if a >= 0 else None
        self._dev_local = {
            "ver": ver,
            "ids": lm_ids,
            "anchor": anchor,
            "pos": self._put(padf(m.lm_pos[lm_ids])),
            "normal": self._put(padf(m.lm_normal[lm_ids])),
            "mind": self._put(padf(m.lm_min_dist[lm_ids])),
            "maxd": self._put(padf(m.lm_max_dist[lm_ids], 1.0)),
            "desc": self._put(padf(m.lm_desc[lm_ids]), np.int64),
            "valid": self._put(padf(m.lm_valid[lm_ids], False)),
        }
        return True

    def _track_frame_fused(self, frame: FrameData) -> bool:
        """One-dispatch tracking against the device-resident local map
        (refreshed on map change, bounded-stale between): run
        fused_track_stages, fetch the small result block. Returns False
        when the frame cannot be tracked this way."""
        m = self.map
        cap = self.cfg.local_lm_cap
        last_bound = np.unique(self.last.lm_idx[self.last.lm_idx >= 0])
        last_bound = last_bound[m.lm_valid[last_bound]]
        if len(last_bound) < 10:
            return False
        if not self._refresh_dev_local():
            return False
        c = self._dev_local
        lm_ids = c["ids"]
        n = len(lm_ids)
        stage1 = np.zeros(cap, bool)
        stage1[:n] = np.isin(lm_ids, last_bound)
        if not stage1.any():
            return False
        self._predict_pose(frame)
        f_xy, f_level, f_bits, f_valid, _ = self._dev_feats(frame)
        from .device_step import fused_track_stages  # lazy: import cycle

        out = fused_track_stages(
            f_xy, f_level, f_bits, f_valid,
            self._put(frame.R), self._put(frame.t),
            c["pos"], c["normal"], c["mind"], c["maxd"], c["desc"], c["valid"],
            self._put(stage1), self.cfg.min_track_matches,
            self.fx, self.fy, self.cx, self.cy,
            float(self.cfg.width), float(self.cfg.height),
        )
        R, t, idx_m, mok_m, inl, n_in, n_s1, vis = fetch_block(out)
        n_in = int(n_in)
        log.debug(
            "frame %d fused: %d local-lms, %d stage1, %d inliers", frame.frame_id, n, int(n_s1), n_in,
        )
        if n_in < self._min_accept_inliers():
            return False
        frame.R = R
        frame.t = t
        sel = np.nonzero(mok_m & inl)[0]
        sel = sel[sel < n]
        with self.map_lock:
            # The mapping worker can move the map between this snapshot's
            # build and this frame: same rebase as the pipelined retirement.
            frame.R, frame.t = self._rebase_onto_map(frame.R, frame.t, c["anchor"])
            # Forward snapshot-stale (fused-away) ids to survivors; drop
            # only truly dead landmarks.
            ids_r = m.resolve_replaced(lm_ids)
            sel = sel[m.lm_valid[ids_r[sel]]]
            frame.lm_idx[:] = -1
            frame.lm_idx[idx_m[sel]] = ids_r[sel]
            vis_ids = ids_r[vis[:n]]
            m.lm_visible[vis_ids[m.lm_valid[vis_ids]]] += 1
            m.lm_found[ids_r[sel]] += 1
        self._finish_tracked_frame(frame, n_in)
        return True

    def _rebase_onto_map(self, R, t, anchor):
        """Re-express a pose solved against a snapshot in the CURRENT map:
        the program solved it against the snapshot's landmark positions,
        i.e. in the snapshot's world frame. If the window BA moved the map
        since, compose the snapshot anchor's pose delta
        (T' = T o T_a0^-1 o T_a1). Caller holds map_lock."""
        if anchor is None:
            return R, t
        m = self.map
        a, R_a0, t_a0 = anchor
        if not m.kf_valid[a] or (np.array_equal(m.kf_R[a], R_a0) and np.array_equal(m.kf_t[a], t_a0)):
            return R, t
        R_d = R_a0.T @ m.kf_R[a]
        t_d = R_a0.T @ (m.kf_t[a] - t_a0)
        return R @ R_d, R @ t_d + t

    # ------------------------------------------------------------------
    # Software-pipelined tracking (no synchronous device round trip per frame)
    # ------------------------------------------------------------------

    def _min_accept_inliers(self) -> int:
        """TrackLocalMap acceptance floor (reference: 30), dropped to the
        degraded floor while the mapping worker is behind on an established
        map (see TrackerConfig.min_localmap_inliers_degraded)."""
        if (
            self.worker is not None
            and self.worker.busy()
            and self.map.n_keyframes() >= self.cfg.pipeline_min_kfs
        ):
            return self.cfg.min_localmap_inliers_degraded
        return self.cfg.min_localmap_inliers

    def _pipeline_active(self) -> bool:
        if self.pipeline_lag == 0 or self.cfg.sensor != Sensor.MONOCULAR:
            return False
        if self._pipe:
            return True  # already engaged; retirement decides exits
        # Engage only from comfortable tracking on an established map: the
        # lag delays keyframe decisions and map refreshes, which a young or
        # struggling map cannot absorb.
        return (
            self.map.n_keyframes() >= self.cfg.pipeline_min_kfs
            and self._last_n_in >= self.cfg.pipeline_enter_inliers
        )

    # Result keys fetched to the host every frame (one small block with the
    # feature arrays; f_desc_i8 stays on the device).
    _PIPE_FETCH = (
        "R", "t", "idx", "bound", "visible", "n_inliers", "n_stage1",
        "ok", "f_xy", "f_level", "f_angle", "f_desc", "f_valid",
    )

    def _pose_T(self, frame: FrameData) -> np.ndarray:
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = frame.R
        T[:3, 3] = frame.t
        return T

    def _pipe_buffer(self, tensors) -> torch.Tensor | None:
        """The pinned host buffer of the next pipeline slot. A slot is not
        handed out again while its frame is in flight: at most
        `pipeline_lag` frames are in flight when one more is dispatched."""
        if self.device.type != "cuda":
            return None
        if not self._pipe_bufs:
            n = block_nbytes(tensors)
            self._pipe_bufs = [
                torch.empty(n, dtype=torch.uint8, pin_memory=True) for _ in range(self.pipeline_lag + 1)
            ]
        return self._pipe_bufs[self.n_pipelined_frames % len(self._pipe_bufs)]

    def _snapshot_remap(self, old_ids: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """(cap,) new-slot -> old-slot indices (-1 none) that carry the
        bound mask across a snapshot swap."""
        order = np.argsort(old_ids, kind="stable")
        pos = np.searchsorted(old_ids, ids, sorter=order)
        pos = np.clip(pos, 0, len(old_ids) - 1)
        old_slot = order[pos].astype(np.int32)
        hit = old_ids[old_slot] == ids
        rm = np.full(self.cfg.local_lm_cap, -1, np.int32)
        rm[: len(ids)] = np.where(hit, old_slot, -1)
        return rm

    def _track_frame_pipelined(self, frame: FrameData) -> np.ndarray | None:
        """Dispatch this frame's fused program chained to the previous one;
        retire the result that is `pipeline_lag` frames old. The per-frame
        host cost is numpy bookkeeping + dispatch: no device value of this
        frame is read before its retirement."""
        from .device_step import fused_frame_program  # lazy: import cycle

        self._check_replaced_in_last_frame()
        if not self._refresh_dev_local():
            # Local map too small for the device path: fall back to the
            # synchronous ladder for this frame.
            self.frame_causes[frame.frame_id].append("snapshot_thin_sync")
            self._drain_pipeline()
            self._ensure_feats(frame)
            self._track_frame(frame)
            if frame.R is not None:
                self._record_trajectory(frame)
                self._last_retired_T = self._pose_T(frame)
                return self._last_retired_T
            return None
        c = self._dev_local
        ids = c["ids"]
        cap = self.cfg.local_lm_cap
        if self._identity_remap is None:
            self._identity_remap = torch.arange(cap, dtype=torch.int64, device=self.device)

        if self._chain is None:
            # (Re)start: host-side prediction from the last retired frame.
            self._predict_pose(frame)
            R_pred, t_pred = self._put(frame.R), self._put(frame.t)
            R_prev, t_prev = self._put(self.last.R), self._put(self.last.t)
            pb = np.zeros(cap, bool)
            last_bound = self.last.lm_idx[self.last.lm_idx >= 0]
            pb[: len(ids)] = np.isin(ids, last_bound)
            prev_bound = self._put(pb)
            remap = self._identity_remap
        else:
            ch = self._chain
            R_pred, t_pred = ch["pred"]
            R_prev, t_prev = ch["R"], ch["t"]
            prev_bound = ch["bound"]
            if ch["snap_seq"] != self._snap_seq:
                # Snapshot swapped since the previous dispatch: carry the
                # bound mask across via new-slot -> old-slot indices.
                remap = self._put(self._snapshot_remap(ch["ids"], ids), np.int64)
            else:
                remap = self._identity_remap

        out = fused_frame_program(
            self._upload_image(frame), self.cam,
            R_pred, t_pred, R_prev, t_prev,
            c["pos"], c["normal"], c["mind"], c["maxd"], c["desc"], c["valid"],
            prev_bound, remap,
            self.cfg.min_track_matches, self._min_accept_inliers(),
            self.fx, self.fy, self.cx, self.cy,
            float(self.cfg.width), float(self.cfg.height),
            orb_params=self.cfg.orb,
        )
        block = [out[k] for k in self._PIPE_FETCH]
        fetch = fetch_block_async(block, self._pipe_buffer(block))
        self._chain = dict(
            R=out["R"], t=out["t"], pred=(out["R_pred_next"], out["t_pred_next"]),
            bound=out["bound"], ids=ids, snap_seq=self._snap_seq,
        )
        self._pipe.append((frame, out, fetch, ids, c["anchor"]))
        self.n_pipelined_frames += 1
        frame.img_u8 = None  # upload done; free host memory
        # Adaptive depth: full lag while tracking is comfortable; a cautious
        # lag of 1 (decisions only one frame late) when the inlier count
        # runs low. Hard failures at retirement still fall back to the
        # synchronous ladder.
        lag = self.pipeline_lag if self._last_n_in >= self.cfg.pipeline_exit_inliers else 1
        while self._pipe and len(self._pipe) > lag:
            self._retire_oldest()
            if self.state != TrackState.OK:
                break
        return self._last_retired_T

    def _drop_in_flight(self) -> int:
        dropped = len(self._pipe)
        self.n_frames_dropped += dropped
        for f_drop, *_ in self._pipe:
            f_drop.img_u8 = None
        self._pipe.clear()
        self._chain = None
        return dropped

    def _retire_oldest(self):
        """Fetch + apply the oldest in-flight frame's results: bindings,
        landmark stats, state machine, keyframe policy, trajectory. The
        block was copied to the host asynchronously at dispatch; this waits
        for that copy alone."""
        frame, out, fetch, ids, anchor = self._pipe.popleft()
        r = dict(zip(self._PIPE_FETCH, fetch.get()))
        n = len(ids)
        n_in = int(r["n_inliers"])

        # Fill the frame's host feature arrays from the fetched block
        # (keyframe insertion and any fallback path below never re-fetch).
        frame._xy = r["f_xy"]
        frame._level = r["f_level"]
        frame._angle = r["f_angle"]
        frame._desc = r["f_desc"].astype(np.uint32)
        frame._valid = r["f_valid"]
        frame._feats_dev = orb.Features(
            xy=out["f_xy"], level=out["f_level"], angle=out["f_angle"], score=out["f_score"],
            desc=out["f_desc"], desc_i8=out["f_desc_i8"], valid=out["f_valid"],
        )
        frame._xy_dev = out["f_xy"]

        if not bool(r["ok"]) or n_in < self._min_accept_inliers():
            # Tracking failed `pipeline_lag` frames ago: everything in
            # flight was predicted from a failing chain. Drop it, then
            # retry THIS frame through the synchronous ladder exactly as
            # the frame-synchronous path does before declaring a loss.
            dropped = self._drop_in_flight()
            log.warning(
                "pipelined tracking failed at frame %d (%d inliers); dropping %d in-flight frames, "
                "retrying synchronously", frame.frame_id, n_in, dropped,
            )
            self.frame_causes[frame.frame_id].append(f"pipeline_fail_retry:{n_in}in,drop{dropped}")
            frame.lm_idx[:] = -1
            self._track_frame_slow(frame)
            if self.state == TrackState.OK and frame.R is not None:
                self._record_trajectory(frame)
                self._last_retired_T = self._pose_T(frame)
            return

        sel = r["bound"][:n]
        vis = r["visible"][:n]
        idx = r["idx"][:n]
        m = self.map
        with self.map_lock:
            frame.R, frame.t = self._rebase_onto_map(r["R"], r["t"], anchor)
            # The snapshot is bounded-stale: landmarks fused since it was
            # built are matched under their OLD id; forward them to their
            # survivors (dropping them instead starves the next frame's
            # carry set at the fusion rate). Truly dead (culled) landmarks
            # are dropped.
            ids_r = m.resolve_replaced(ids)
            alive = m.lm_valid[ids_r]
            sel = sel & alive
            m.lm_visible[ids_r[vis & alive]] += 1
            m.lm_found[ids_r[sel]] += 1
            frame.lm_idx[:] = -1
            frame.lm_idx[idx[sel]] = ids_r[sel]
        self._finish_tracked_frame(frame, n_in)
        if self.state == TrackState.OK:
            self._record_trajectory(frame)
            self._last_retired_T = self._pose_T(frame)

    def _drain_pipeline(self):
        """Retire every in-flight frame (pipeline barrier). Called before
        anything that reads live tracking state as a whole: trajectory
        export, shutdown."""
        while self._pipe:
            self._retire_oldest()
        self._chain = None

    def flush_mapping(self):
        """Drain the tracking pipeline, the background mapping stage, the
        loop-closing stage and any global BA in flight, re-raising a failure
        of any of their threads. Call before reading a consistent whole-map
        state."""
        self._drain_pipeline()
        if self.worker is not None:
            self.worker.flush()
        if self.loop_worker is not None:
            self.loop_worker.flush()
        self._join_global_ba()

    def _join_global_ba(self):
        """Wait for the background global BA and re-raise its failure."""
        t = self._gba_thread
        if t is not None:
            t.join()
        self._gba_thread = None
        if self._gba_error is not None:
            err, self._gba_error = self._gba_error, None
            raise err

    def _rebase_after_map_change(self):
        """If a correction of another thread (loop closure, global BA) moved
        the map since this thread last looked, drop the frames in flight
        (they were tracked against the pre-correction map) and re-derive the
        last frame's pose from its reference keyframe's corrected pose through
        its stored relative pose (the map-change rebase of Tracking::Track)."""
        m = self.map
        if m.big_change_idx == self._seen_change_idx:
            return
        self.frame_causes[self.frame_id].append(f"map_correction_rebase:drop{len(self._pipe)}")
        self._drop_in_flight()
        self._seen_change_idx = m.big_change_idx
        self.velocity = None
        if self.last is None or self.last.R is None or not self.trajectory:
            return
        if self.inertial and self.last_kf_slot >= 0 and m.kf_valid[self.last_kf_slot]:
            # The inertial rebase (Tracking::UpdateFrameIMU): a gravity/scale
            # re-alignment rescales the world, so the visual relative record
            # is in the old units. Re-anchor at the last keyframe's corrected
            # body state and dead-reckon through the body-frame
            # preintegration since it, which the re-alignment leaves as it is.
            k = self.last_kf_slot
            with self.map_lock:
                Rwb_k, p_k = self._body_from_cam_np(m.kf_R[k], m.kf_t[k])
                v_k = m.kf_vel[k].copy()
                self.cur_bg = m.kf_bg[k].copy()
                self.cur_ba = m.kf_ba[k].copy()
            if self._pre_from_kf is not None:
                put = self._put
                R2, p2, v2 = imu_ops.predict_state(put(Rwb_k), put(p_k), put(v_k), self._pre_from_kf,
                                                   put(self.cur_bg), put(self.cur_ba))
                Rwb2, p2, v2 = fetch_block((R2, p2, v2))
            else:
                Rwb2, p2, v2 = Rwb_k, p_k, v_k
            self.last.R, self.last.t = self._cam_from_body_np(Rwb2, p2)
            self.cur_v = v2.astype(np.float32)
            self.last_body = (Rwb2, p2, self.cur_v.copy())
            self.prior_H = None
            return
        fid, ts, map_id, kref, R_cr, t_cr = self.trajectory[-1]
        while (map_id, kref) in self._kf_alias:
            map_id, kref = self._kf_alias[(map_id, kref)]
        with self.map_lock:
            if fid == self.last.frame_id and map_id == m.map_id and m.kf_valid[kref]:
                self.last.R = (R_cr @ m.kf_R[kref]).astype(np.float32)
                self.last.t = (R_cr @ m.kf_t[kref] + t_cr).astype(np.float32)
            elif self.ref_kf >= 0 and m.kf_valid[self.ref_kf]:
                # No record of the last frame: re-anchor at the reference
                # keyframe; the next frame's wide re-acquisition absorbs it.
                self.last.R = m.kf_R[self.ref_kf].copy()
                self.last.t = m.kf_t[self.ref_kf].copy()

    def _execute_merge(self, k: int, frame: FrameData, dst_map_id: int, c: int, S_kc, src_map_id_expect: int,
                       k_expect: int):
        """Weld the active map into the Atlas map with id `dst_map_id`
        through the validated Sim(3) S_kc (candidate camera -> current
        camera), then fuse duplicates and run a welding BA
        (LoopClosing::MergeLocal). Caller holds the map lock.

        The proposal crossed a thread boundary: everything it names is
        re-validated against the current Atlas, by map id (spawns and merges
        between detection and execution reorder `atlas.maps`)."""
        atlas = self.atlas
        src = atlas.active
        dst_idx = next((i for i, mm in enumerate(atlas.maps) if mm.map_id == dst_map_id), None)
        if (
            dst_idx is None
            or src.map_id != src_map_id_expect
            or k != k_expect
            or atlas.maps[dst_idx] is src
            or not src.kf_valid[k]
            or not atlas.maps[dst_idx].kf_valid[c]
        ):
            log.warning("dropping stale merge proposal (map %d -> %d, KF %d -> %d)", src.map_id, dst_map_id, k, c)
            return
        with self.timers.span("merge"):
            dst = atlas.maps[dst_idx]
            s, R, t = S_kc

            def T(x):
                return torch.as_tensor(np.asarray(x, np.float32))

            # S_k_w1 = S_kc o T_c_w1; M (w1 -> w2) = T_k_w2^-1 o S_k_w1, in f32.
            S_k_w1 = lie.sim3_mul(T(s), T(R), T(t), T(1.0), T(dst.kf_R[c]), T(dst.kf_t[c]))
            Tk_inv = lie.sim3_inv(T(1.0), T(src.kf_R[k]), T(src.kf_t[k]))
            sM, RM, tM = [x.numpy() for x in lie.sim3_mul(*Tk_inv, *S_k_w1)]
            src_map_id = src.map_id
            kf_remap, lm_remap = atlas.merge_into(dst_idx, atlas.active_idx, (float(sM), RM, tM))

            # Aliases for the trajectory records; database rows move to dst.
            for k_old, k_new in kf_remap.items():
                self._kf_alias[(src_map_id, k_old)] = (dst.map_id, k_new)
                self.kfdb.erase(self._gid(k_old, src_map_id))
            for k_new in kf_remap.values():
                bits = np.unpackbits(dst.kf_desc[k_new].view(np.uint8), axis=-1, bitorder="little").astype(np.int8)
                self.kfdb.add(self._gid(k_new, dst.map_id), bits, dst.kf_feat_valid[k_new])

            # Re-anchor the live tracking state in the destination map.
            k_new = kf_remap[k]
            self.ref_kf = k_new
            if self.inertial:
                if self.last_kf_slot >= 0:
                    self.last_kf_slot = kf_remap.get(int(self.last_kf_slot), -1)
                self.cur_v = ((self.cur_v @ RM) / sM).astype(np.float32)
                # Preintegrations are body-frame: the weld leaves them as they
                # are. The body state follows the welded frame pose.
                self.last_body = None
                self.prior_H = None
            lm_lut = np.full(self.cfg.map_cfg.max_landmarks, -1, np.int32)
            for a, b in lm_remap.items():
                lm_lut[a] = b
            bound = frame.lm_idx >= 0
            frame.lm_idx[bound] = lm_lut[frame.lm_idx[bound]]
            # Frame pose: T_new = T_old o M (then SE(3) through / s).
            frame.R, frame.t = (
                (frame.R @ RM).astype(np.float32),
                ((frame.R @ tM + frame.t) / sM).astype(np.float32),
            )
            if self.velocity is not None:
                Rv, tv = self.velocity
                self.velocity = (Rv, (tv / sM).astype(np.float32))
            if self.loop_closer is not None:
                self.loop_closer.on_merge(src_map_id, dst.map_id, kf_remap)

            # The rigidly welded geometry: the merge essential graph measures its
            # edges from this internally consistent state.
            R_snap = dst.kf_R.copy()
            t_snap = dst.kf_t.copy()

            # Fuse duplicates around the weld, then the welding BA with the
            # matched map's keyframe as the gauge.
            nb, _ = dst.covisible_keyframes(k_new, min_weight=1, top=10)
            window = np.concatenate([[k_new], nb]).astype(np.int64)
            if self.loop_closer is not None:
                self.loop_closer._search_and_fuse(window, c)
            if dst._imu_calib is not None and dst.imu_stage >= 1:
                self._merge_inertial_ba(k_new, c)
            else:
                self._local_ba([int(x) for x in window], fix=[c])
                # Carry the weld's correction to the rest of the merged-in map.
                from .loop_closing import optimize_essential_graph_merge

                win = {int(x) for x in window}
                rest = [v for v in kf_remap.values() if v not in win]
                if len(rest) >= 3:
                    mode = "se3" if self.cfg.sensor != Sensor.MONOCULAR else "sim3"
                    with self.timers.span("merge_eg"):
                        optimize_essential_graph_merge(dst, rest, R_snap, t_snap, mode, device=self.device)
            # The live frame follows its welded and optimized keyframe.
            frame.R = dst.kf_R[k_new].copy()
            frame.t = dst.kf_t[k_new].copy()
            self.velocity = None
            self.events.append({"kind": "merge", "frame": int(frame.frame_id), "kf": int(k), "src_map": src_map_id,
                                "dst_map": int(dst.map_id), "match": int(c), "scale": float(sM)})
            log.info("map merge complete: now tracking in map %d (%d KFs, %d lms)",
                     dst.map_id, dst.n_keyframes(), dst.n_landmarks())

    def _merge_inertial_ba(self, k_new: int, c: int):
        """Optimizer::MergeInertialBA (src/Optimizer.cc:3919-4456): a VI BA
        around the welding zone: the current keyframe's 6-keyframe temporal
        chain plus the merge keyframe's temporal neighbourhood (3 back,
        forward to ~12 in all), the gauge fixed on the old map's chain
        boundary."""
        m = self.map
        nd = 6
        chain_k = m.temporal_window(k_new, nd)[::-1]  # oldest..newest
        chain_c = m.temporal_window(c, nd // 2)[::-1]
        fwd = []
        cur = c
        while len(chain_c) + len(fwd) + len(chain_k) < 2 * nd:
            nxt = int(m.kf_next[cur])
            if nxt < 0 or not m.kf_valid[nxt] or nxt in chain_k:
                break
            fwd.append(nxt)
            cur = nxt
        opt = chain_c + fwd + chain_k  # opt[0]: the old map's boundary
        built = self._build_vi_problem(opt, K_cap=2 * self.cfg.vi_kf_cap, obs_cap=self.cfg.ba_obs_cap)
        if built is None:
            return
        with self.timers.span("merge_vi_ba"):
            self._run_vi_ba(built, iters=10, gate_at=5)

    def _timestamp_guards(self, ts: float):
        """The timestamp guards of Tracking::Track: a frame older than its
        predecessor, or a gap of more than 1 s on an inertial run, spawns a
        fresh Atlas map (an established map is kept) or resets a small one."""
        if self.state is TrackState.NO_IMAGES_YET or self.last is None:
            return
        prev = self.last.timestamp
        if ts < prev:
            log.warning("frame timestamp %.6f older than previous %.6f; new map", ts, prev)
            self._last_imu_t = None
            self._spawn_or_reset_map()
        elif self.inertial and ts > prev + 1.0:
            log.warning("timestamp jump %.2f s on inertial run", ts - prev)
            self._last_imu_t = None
            self._spawn_or_reset_map()

    def new_dataset(self):
        """System::ChangeDataset: close out the current sequence (a small map
        is rebuilt, an established one kept and a fresh map started) and
        forget the last frame and the IMU clock, so that the next sequence's
        first frame does not trip the timestamp guards."""
        self._spawn_or_reset_map()
        self._last_imu_t = None
        self.last = None

    def _spawn_or_reset_map(self):
        """Unrecoverable loss: a map of fewer than 10 keyframes is discarded
        and rebuilt (Tracking::ResetActiveMap); an established one is kept in
        the Atlas and a fresh one started (CreateMapInAtlas), to be welded
        back by a later merge. The reset map keeps its id and its keyframe
        generations restart, so the device keyframe store and the local-map
        snapshot are invalidated (ROADMAP R13)."""
        self.flush_mapping()
        self._pending_merge = None
        self.lost_frames = 0
        m = self.map
        if m.n_keyframes() < 10:
            log.warning("resetting active map (%d KFs)", m.n_keyframes())
            with self.map_lock:
                for k in np.nonzero(m.kf_valid)[0]:
                    self.kfdb.erase(self._gid(int(k)))
                fresh = MapState(self.cfg.map_cfg, map_id=m.map_id)
                fresh._imu_calib = self.atlas.imu_calib
                self.atlas.maps[self.atlas.active_idx] = fresh
                self._kf_store.invalidate()
        else:
            log.warning("spawning new Atlas map (keeping map %d: %d KFs)", m.map_id, m.n_keyframes())
            new = self.atlas.create_new_map()
            shared = [mm.map_id for mm in self.atlas.maps
                      if mm is not new and mm.map_id % MAX_MAPS == new.map_id % MAX_MAPS]
            if shared:
                log.warning("map %d shares its keyframe-database rows with map(s) %s (%d map namespaces, "
                            "ROADMAP R16): each overwrites the other's rows", new.map_id, shared, MAX_MAPS)
        self._dev_local = None
        self.state = TrackState.NO_IMAGES_YET
        self.init_ref = None
        self.velocity = None
        self.ref_kf = -1
        self.n_kf_inserted = 0
        self._kf_med_depth[:] = 0.0  # slots reused by the fresh map
        # A new scene is coming: re-train the place-recognition vocabulary
        # from the whole corpus (KeyFrameDatabase.refresh_codebook).
        self.kfdb.refresh_codebook()
        if self.inertial:
            self._reset_vi_runtime()

    # ------------------------------------------------------------------
    # Split-phase tracking and the loss ladder
    # ------------------------------------------------------------------

    def _match_landmarks_into_frame(
        self, frame: FrameData, lm_ids: np.ndarray, radius_base: float, exclude_bound: bool = True,
    ):
        """Project the given landmarks into the frame and match. Returns
        (lm_ids_matched, feat_idx_matched)."""
        cap = self.cfg.local_lm_cap
        lm_ids = lm_ids[:cap]
        n = len(lm_ids)
        if n == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        pad = cap - n
        m = self.map

        def padf(x, fill=0):
            return np.concatenate([x, np.full((pad, *x.shape[1:]), fill, x.dtype)])

        put = self._put
        uv, level, _, ok_d = project_landmarks(
            put(frame.R, np.float32), put(frame.t, np.float32), put(padf(m.lm_pos[lm_ids])),
            put(padf(m.lm_normal[lm_ids])), put(padf(m.lm_min_dist[lm_ids])), put(padf(m.lm_max_dist[lm_ids])),
            put(padf(m.lm_valid[lm_ids], False)),
            self.fx, self.fy, self.cx, self.cy, float(self.cfg.width), float(self.cfg.height),
        )
        f_xy, f_level, f_bits, f_valid, _ = self._dev_feats(frame)
        if exclude_bound:
            f_valid = f_valid & put(frame.lm_idx < 0)
        idx_d, mok_d = match_by_projection_leveled(
            put(padf(m.lm_desc_i8[lm_ids])), ok_d, uv, level, radius_base, f_bits, f_xy, f_level, f_valid,
        )
        ok, idx, mok = fetch_block((ok_d, idx_d, mok_d))
        m.lm_visible[lm_ids[ok[:n]]] += 1
        mok = mok[:n]
        idx = idx[:n]
        sel = np.nonzero(mok)[0]
        # Deduplicate features matched by multiple landmarks (keep first).
        feat = idx[sel]
        _, first = np.unique(feat, return_index=True)
        sel = sel[first]
        return lm_ids[sel], idx[sel]

    def _pose_optimize(self, frame: FrameData) -> int:
        """Motion-only pose optimization over the frame's bound features;
        unbinds the outliers and returns the inlier count."""
        from ..optim import pose_opt

        bound = np.nonzero(frame.lm_idx >= 0)[0]
        if len(bound) < 3:
            return 0
        cap = self.cfg.local_lm_cap
        bound = bound[:cap]
        pad = cap - len(bound)
        Xw = np.concatenate([self.map.lm_pos[frame.lm_idx[bound]], np.zeros((pad, 3), np.float32)])
        uv_c = np.concatenate(
            [frame.xy[bound] - [self.cx, self.cy], np.zeros((pad, 2), np.float32)]
        ).astype(np.float32)
        sig2 = np.concatenate([self._feat_sigma2(frame.level[bound]), np.ones(pad, np.float32)])
        valid = np.concatenate([np.ones(len(bound), bool), np.zeros(pad, bool)])
        # Stereo rows: centred right-u of the features with a stereo match.
        ur_c = np.concatenate([frame.ur[bound] - self.cx, np.zeros(pad, np.float32)]).astype(np.float32)
        is_st = np.concatenate([frame.ur[bound] >= 0, np.zeros(pad, bool)])
        put = self._put
        res = pose_opt.pose_optimization(
            put(frame.R, np.float32), put(frame.t, np.float32), put(Xw), put(uv_c), put(sig2), put(valid),
            self.fx, self.fy, ur=put(ur_c), bf=float(np.float32(self.cfg.bf)), is_stereo=put(is_st),
        )
        frame.R, frame.t, inl = fetch_block((res.R, res.t, res.inliers))
        inl = inl[: len(bound)]
        # Unbind outliers (the reference clears mvpMapPoints for outliers).
        frame.lm_idx[bound[~inl]] = -1
        self.map.lm_found[frame.lm_idx[bound[inl]]] += 1
        return int(inl.sum())

    def _pose_opt_dispatch(self, frame: FrameData) -> int:
        if self.inertial and self.map.imu_stage >= 1:
            return self._pose_optimize_vi(frame)
        return self._pose_optimize(frame)

    def _pose_optimize_vi(self, frame: FrameData) -> int:
        """Tracking-time VI state estimation (PoseInertialOptimization*):
        reprojection + one inertial edge from the anchor: the last keyframe
        when the map just changed, else the last frame with its marginal
        prior. Unbinds the outliers and returns the inlier count."""
        m = self.map
        bound = np.nonzero(frame.lm_idx >= 0)[0]
        if len(bound) < 3:
            return 0
        cap = self.cfg.local_lm_cap
        bound = bound[:cap]
        pad = cap - len(bound)
        Xw = np.concatenate([m.lm_pos[frame.lm_idx[bound]], np.zeros((pad, 3), np.float32)])
        uv_c = np.concatenate([frame.xy[bound] - [self.cx, self.cy], np.zeros((pad, 2), np.float32)]).astype(np.float32)
        ur_c = np.concatenate([frame.ur[bound] - self.cx, np.zeros(pad, np.float32)]).astype(np.float32)
        uvr = np.concatenate([uv_c, ur_c[:, None]], 1)
        sig2 = np.concatenate([self._feat_sigma2(frame.level[bound]), np.ones(pad, np.float32)])
        valid = np.concatenate([np.ones(len(bound), bool), np.zeros(pad, bool)])
        is_st = np.concatenate([frame.ur[bound] >= 0, np.zeros(pad, bool)])

        put = self._put
        use_kf = (self._kf_inserted_last_frame or self.last_body is None or self.prior_H is None) \
            and self.last_kf_slot >= 0
        if use_kf:
            k = self.last_kf_slot
            Rwb1, p1 = self._body_from_cam_np(m.kf_R[k], m.kf_t[k])
            v1, bg1, ba1 = m.kf_vel[k], m.kf_bg[k], m.kf_ba[k]
            if self._pre_from_kf is None:
                return self._pose_optimize(frame)
            pre = self._pre_from_kf
            H_prior = None
            anchor_fixed = True
        else:
            Rwb1, p1, v1 = self.last_body
            bg1, ba1 = self.cur_bg, self.cur_ba
            pre = self._preintegrate_rows(self._frame_imu, bg1, ba1)
            H_prior = put(self.prior_H, np.float32)
            anchor_fixed = False
        Rwb2, p2 = self._body_from_cam_np(frame.R, frame.t)
        f32 = np.float32
        args = [put(x, f32) for x in (Rwb1, p1, v1, bg1, ba1, Rwb2, p2, self.cur_v, self.cur_bg, self.cur_ba)]
        args += [getattr(pre, f.name) for f in dataclasses.fields(imu_ops.Preintegrated)]
        args += [put(Xw, f32), put(uvr, f32), put(sig2, f32), put(valid), put(is_st), put(self.Rcb, f32),
                 put(self.tcb, f32)] + ([] if anchor_fixed else [H_prior])
        out = self._vi_pose_call(anchor_fixed)(*args)
        Rwb, p, v, bg, ba, H, inl = fetch_block(out)
        frame.R, frame.t = self._cam_from_body_np(Rwb, p)
        self.cur_v, self.cur_bg, self.cur_ba, self.prior_H = v, bg, ba, H
        inl = inl[: len(bound)]
        frame.lm_idx[bound[~inl]] = -1
        self.map.lm_found[frame.lm_idx[bound[inl]]] += 1
        return int(inl.sum())

    def _vi_pose_call(self, anchor_fixed: bool) -> GraphedCall:
        """`pose_inertial_optimization` of one anchor variant as a call on
        tensors, replayed from one CUDA graph on the card (its 4 x 10 LM
        iterations are thousands of small launches; the graph returns the same
        bits as the eager call). Its arguments: the anchor and frame states,
        the preintegration's fields, the observations, Rcb, tcb and, for the
        last-frame variant, the prior."""
        call = self._vi_pose_calls.get(anchor_fixed)
        if call is None:
            from ..optim import inertial as vi

            n_pre = len(dataclasses.fields(imu_ops.Preintegrated))
            fx, fy, bf = (float(np.float32(x)) for x in (self.fx, self.fy, self.cfg.bf))

            def fn(*a):
                pre = imu_ops.Preintegrated(*a[10:10 + n_pre])
                Xw, uvr, sig2, valid, is_st, Rcb, tcb = a[10 + n_pre:17 + n_pre]
                res = vi.pose_inertial_optimization(
                    *a[:10], pre, Xw, uvr, sig2, valid, is_st, Rcb, tcb, fx, fy, bf,
                    H_prior=None if anchor_fixed else a[17 + n_pre], anchor_fixed=anchor_fixed,
                )
                return res.Rwb, res.p, res.v, res.bg, res.ba, res.H_marg, res.inliers

            call = self._vi_pose_calls[anchor_fixed] = GraphedCall(fn)
        return call

    def _track_frame_slow(self, frame: FrameData):
        """Split-phase tracking (TrackWithMotionModel with its wide retry,
        TrackReferenceKeyFrame, TrackLocalMap), each stage a device program
        with its own result fetch: the ladder a frame climbs before a loss
        is declared."""
        if self.inertial and self.last_kf_slot >= 0:
            # Extend the running since-keyframe preintegration by this
            # frame's rows (mpImuPreintegratedFromLastKF).
            k = self.last_kf_slot
            self._pre_from_kf = self._preintegrate_rows(self._frame_imu, self.map.kf_bg[k], self.map.kf_ba[k],
                                                        init=self._pre_from_kf)
        self._predict_pose(frame)
        m = self.map

        # 1) Motion-model tracking vs the last frame's landmarks.
        last_lms = np.unique(self.last.lm_idx[self.last.lm_idx >= 0])
        last_lms = last_lms[m.lm_valid[last_lms]]
        lm_hit, feat_hit = self._match_landmarks_into_frame(frame, last_lms, 15.0)
        if len(lm_hit) < self.cfg.min_track_matches:
            lm_hit2, feat_hit2 = self._match_landmarks_into_frame(frame, last_lms, 30.0)
            if len(lm_hit2) > len(lm_hit):
                lm_hit, feat_hit = lm_hit2, feat_hit2
        frame.lm_idx[feat_hit] = lm_hit
        n_in = self._pose_opt_dispatch(frame)
        log.debug(
            "frame %d stage1: %d last-lms, %d hits, %d inliers", frame.frame_id, len(last_lms), len(lm_hit), n_in,
        )

        if n_in < self.cfg.min_track_inliers:
            # Fallback: reference-KF matching (TrackReferenceKeyFrame).
            frame.lm_idx[:] = -1
            frame.R = self.last.R.copy()
            frame.t = self.last.t.copy()
            put = self._put
            _, _, f_bits, f_valid, f_angle = self._dev_feats(frame)
            idx_d, ok_d = match_bow_like(
                put(self._kf_bits(self.ref_kf)), put(m.kf_feat_valid[self.ref_kf]), put(m.kf_angle[self.ref_kf]),
                f_bits, f_valid, f_angle,
            )
            idx, ok = fetch_block((idx_d, ok_d))
            ref_lm = m.kf_lm_idx[self.ref_kf]
            sel = np.nonzero(ok & (ref_lm >= 0))[0]
            frame.lm_idx[idx[sel]] = ref_lm[sel]
            n_in = self._pose_optimize(frame)
            if n_in < self.cfg.min_track_inliers:
                self._set_lost(frame)
                return

        # 2) Track local map.
        local_kfs = self._local_keyframes(frame)
        local_lms = m.local_map_landmarks(local_kfs)
        lm_hit, feat_hit = self._match_landmarks_into_frame(frame, local_lms, 6.0)
        frame.lm_idx[feat_hit] = lm_hit
        n_in = self._pose_opt_dispatch(frame)
        log.debug(
            "frame %d stage2: %d local-lms, %d new hits, %d inliers", frame.frame_id, len(local_lms), len(lm_hit), n_in,
        )

        if n_in < self._min_accept_inliers():
            self._set_lost(frame)
            return

        self._finish_tracked_frame(frame, n_in)

    def _set_lost(self, frame: FrameData):
        """Track failure from OK: enter the resilience ladder
        OK -> RECENTLY_LOST -> LOST. On an established map the tracker keeps
        the last pose and the constant-velocity motion model for
        `time_recently_lost` seconds and tries to re-acquire the map each
        frame: the dominant loss mode under a lagging mapping stage is
        transient frontier starvation, and the last healthy velocity
        extrapolates the true view for tens of frames."""
        if self.map.big_change_idx != self._seen_change_idx and self.last is not None and self.last.R is not None:
            # A correction of another thread moved the map while this frame
            # tracked against it: drop the frame and let the next one rebase
            # instead of declaring a loss.
            log.info("track miss during a background map correction at frame %d; rebasing", frame.frame_id)
            frame.R = None
            frame.t = None
            return
        n_kf = self.map.n_keyframes()
        imu_ready = self.inertial and self.map.imu_stage >= 1
        frame.lm_idx[:] = -1
        self.n_lost_events += 1
        if n_kf > 10 or imu_ready:
            # An initialized IMU keeps predicting: the reference publishes
            # IMU-predicted poses while RECENTLY_LOST.
            log.warning("tracking RECENTLY_LOST at frame %d (%d KFs)", frame.frame_id, n_kf)
            self.state = TrackState.RECENTLY_LOST
            self.lost_t = frame.timestamp
        else:
            log.warning("tracking LOST at frame %d (%d KFs)", frame.frame_id, n_kf)
            self.state = TrackState.LOST
            self.velocity = None
            frame.R = None
            frame.t = None
        self.last = frame

    def _recently_lost_step(self, frame: FrameData):
        """One frame while RECENTLY_LOST: predict the pose (constant
        velocity) and try to RE-ACQUIRE the local map around the reference
        keyframe with a wide search window, then fall back to full
        relocalization. A frame recovered by neither is counted in
        `n_lost_frames` and its kept pose carries the prediction to the next
        frame. Falls to LOST after `time_recently_lost` seconds."""
        m = self.map
        imu_ready = self.inertial and m.imu_stage >= 1
        recovered = False
        if self.last is not None and self.last.R is not None:
            self._predict_pose(frame)  # IMU dead reckoning once the IMU is initialized
            if imu_ready and self.last_body is not None:
                Rwb, p = self._body_from_cam_np(frame.R, frame.t)
                self.last_body = (Rwb, p, self.cur_v.copy())
            # Re-acquisition: project the reference-KF neighbourhood's
            # landmarks into the predicted pose with a wide window.
            if self.ref_kf >= 0 and m.kf_valid[self.ref_kf]:
                neigh, _ = m.covisible_keyframes(self.ref_kf, min_weight=15)
                kfs = np.asarray([self.ref_kf, *neigh[:10]], np.int64)
                local_lms = m.local_map_landmarks(kfs)
                lm_hit, feat_hit = self._match_landmarks_into_frame(frame, local_lms, 15.0)
                frame.lm_idx[feat_hit] = lm_hit
                log.debug(
                    "recently-lost frame %d: %d local lms, %d hits", frame.frame_id, len(local_lms), len(lm_hit),
                )
                if len(lm_hit) >= 20:
                    n_in = self._pose_optimize(frame)
                    if n_in >= 30:
                        log.info("re-acquired tracking at frame %d (%d inliers)", frame.frame_id, n_in)
                        recovered = True
                        self.prior_H = None
            if not recovered and not imu_ready:
                # Full relocalization clears the frame's pose on failure; the
                # kept pose is what the next re-acquisition predicts from.
                R_keep, t_keep = frame.R, frame.t
                recovered = self._relocalize(frame)
                if not recovered:
                    frame.R, frame.t = R_keep, t_keep
            if not recovered:
                self.n_lost_frames += 1
                self.last = frame
        else:
            recovered = self._relocalize(frame)
            if not recovered:
                self.n_lost_frames += 1
        if recovered:
            self.state = TrackState.OK
            self.velocity = None
            self.lost_frames = 0
            if self.inertial and frame.R is not None:
                Rwb, p = self._body_from_cam_np(frame.R, frame.t)
                self.last_body = (Rwb, p, self.cur_v.copy())
            self.last = frame
        elif frame.timestamp - self.lost_t > self.cfg.time_recently_lost:
            log.warning(
                "tracking LOST at frame %d (RECENTLY_LOST for %.1f s)",
                frame.frame_id, frame.timestamp - self.lost_t,
            )
            self.state = TrackState.LOST
            self.velocity = None
            self.lost_frames = 0

    def _finish_tracked_frame(self, frame: FrameData, n_in: int):
        """Post-track bookkeeping: motion model update, keyframe policy,
        last-frame state."""
        m = self.map
        self.state = TrackState.OK
        self._last_n_in = n_in
        # Motion model: velocity = Tcw_cur * Twc_last.
        Rl_inv, tl_inv = np.asarray(self.last.R).T, -np.asarray(self.last.R).T @ self.last.t
        self.velocity = (
            (frame.R @ Rl_inv).astype(np.float32),
            (frame.R @ tl_inv + frame.t).astype(np.float32),
        )

        # Keyframe policy (NeedNewKeyFrame, simplified thresholds).
        ref_tracked = int((m.kf_lm_idx[self.ref_kf] >= 0).sum())
        frames_since_kf = frame.frame_id - self.last_kf_frame_id
        need = (
            frames_since_kf >= self.cfg.kf_max_interval
            or (
                n_in < self.cfg.kf_ref_ratio * ref_tracked
                and frames_since_kf >= self.cfg.kf_min_interval
            )
        ) and n_in > 15
        if self.inertial and self.last_kf_slot >= 0:
            # Inertial cadence: a steady keyframe stream keeps the
            # preintegration chain short, mandatory until IMU init
            # (NeedNewKeyFrame).
            dt_kf = frame.timestamp - float(m.kf_timestamp[self.last_kf_slot])
            if m.imu_stage == 0:
                need = dt_kf >= self.cfg.imu_kf_period and n_in > 15
            else:
                need = need or (dt_kf >= 0.5 and n_in > 15)
        self._kf_inserted_last_frame = False
        if need and self.worker is not None and not self.worker.accepting():
            # Back-pressure: mapping is saturated; skip this insertion and
            # retry next frame. Exception: when tracking is starving
            # (inliers well below the ref ratio or a long gap since the
            # last keyframe), insert anyway: losing the map costs far more
            # than a deeper queue.
            starving = (
                frames_since_kf >= self.cfg.kf_max_interval
                or n_in < 0.5 * self.cfg.kf_ref_ratio * max(ref_tracked, 1)
            )
            if not starving:
                self.n_kf_skipped_backpressure += 1
                need = False
        if need and not self.localization_only:
            with self.timers.span("new_kf"):
                self._insert_keyframe(frame)
        if self.inertial:
            Rwb, p = self._body_from_cam_np(frame.R, frame.t)
            self.last_body = (Rwb, p, self.cur_v.copy())
        self.last = frame

    def _kf_bits(self, k: int) -> np.ndarray:
        """Unpack a keyframe's stored packed descriptors to int8 bits."""
        return np.unpackbits(self.map.kf_desc[k].view(np.uint8), axis=-1, bitorder="little").astype(np.int8)

    def _kf_bits_dev(self, k: int) -> torch.Tensor:
        """A keyframe's unpacked descriptors from the device keyframe store
        (a lost stretch retries the same candidates every frame)."""
        with self.map_lock:
            self._kf_store.sync(self.map, [int(k)])
        return _unpack_desc(self._kf_store.desc[int(k)])

    def _relocalize(self, frame: FrameData) -> bool:
        """Relocalization (Tracking::Relocalization): candidates from the
        keyframe database by place signature with covisible-group
        accumulation, then the most recent keyframes; per candidate,
        descriptor matching to its bound features -> MLPnP RANSAC -> pose
        optimization -> projection-search escalation, accepted at
        `reloc_min_inliers`."""
        m = self.map
        cand = np.nonzero(m.kf_valid)[0]
        if len(cand) == 0:
            self.last = frame
            return False
        hist = self.kfdb.histogram(frame.desc_i8, frame.valid)
        db_cand = []
        if hist is not None:
            max_k = self.cfg.map_cfg.max_keyframes
            ns = m.map_id % MAX_MAPS

            def covis_gids(g):
                mid, c2 = split_row(g, max_k)
                if mid != ns or not m.kf_valid[c2]:
                    return []
                return [row_of(mid, x, max_k) for x in m.covisible_keyframes(c2, min_weight=1, top=10)[0]]

            # Only candidates in the active map: recovery in another map goes
            # through a merge, not relocalization.
            gids = self.kfdb.query_groups(hist, covis_gids, n_best=8, min_score=0.02)[0]
            db_cand = [c for ns_c, c in (split_row(g, max_k) for g in gids) if ns_c == ns]
        # Candidates from the database, then the most recent keyframes.
        recency = cand[np.argsort(-m.kf_frame_id[cand], kind="stable")][:5]
        cand = list(dict.fromkeys(db_cand + recency.tolist()))
        cand = np.asarray([c for c in cand if m.kf_valid[c]])[:8]
        # Dispatch every candidate's descriptor match, fetch them together.
        _, _, f_bits, f_valid, f_angle = self._dev_feats(frame)
        pending = []
        for k in cand:
            ref_lm = m.kf_lm_idx[k]
            pending.append(match_bow_like(
                self._kf_bits_dev(k), self._put(m.kf_feat_valid[k] & (ref_lm >= 0)), self._put(m.kf_angle[k]),
                f_bits, f_valid, f_angle,
            ))
        fetched = fetch_block([x for pair in pending for x in pair]) if pending else []
        scored = []
        for j, k in enumerate(cand):
            ref_lm = m.kf_lm_idx[k]
            idx_np, ok_np = fetched[2 * j], fetched[2 * j + 1]
            sel = np.nonzero(ok_np & (ref_lm >= 0) & m.lm_valid[np.maximum(ref_lm, 0)])[0]
            scored.append((len(sel), int(k), ref_lm, idx_np, sel))
        # The best few by match count (stable: ties keep candidate order).
        scored.sort(key=lambda x: -x[0])
        for n_match, k, ref_lm, idx_np, sel in scored[:3]:
            if n_match < 15:
                continue
            cap = self.cfg.local_lm_cap
            n = min(len(sel), cap)
            sel = sel[:n]
            pad = cap - n
            Xw = np.concatenate([m.lm_pos[ref_lm[sel]], np.zeros((pad, 3), np.float32)])
            uv = np.concatenate([frame.xy[idx_np[sel]], np.zeros((pad, 2), np.float32)]).astype(np.float32)
            valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
            # Per-octave inlier gate (mvMaxError = mvSigma2 * th2).
            sig2 = np.concatenate([self._feat_sigma2(frame.level[idx_np[sel]]), np.ones(pad, np.float32)])
            valid_d = self._put(valid)
            R, t, inl, _, ok_pnp = fetch_block(ransac.mlpnp_ransac(
                self._put(Xw), self._put(uv), valid_d, self._K_dev,
                ransac.sample_indices(self.rng, self.n_hyp_pnp, 6, valid_d), sigma2=self._put(sig2),
            ))
            if not bool(ok_pnp):
                continue
            frame.R, frame.t = R, t
            inl_np = inl[:n]
            frame.lm_idx[:] = -1
            frame.lm_idx[idx_np[sel[inl_np]]] = ref_lm[sel[inl_np]]
            n_in = self._pose_optimize(frame)
            if n_in < 10:
                continue
            # Escalation: add matches by projecting the candidate's landmarks
            # through the current estimate, a coarse pass (window 10) and if
            # still marginal a narrow one (window 3).
            th = self.cfg.reloc_min_inliers
            if n_in < th:
                lms_k = ref_lm[ref_lm >= 0]
                lms_k = np.unique(lms_k[m.lm_valid[lms_k]])
                lm_hit, feat_hit = self._match_landmarks_into_frame(frame, lms_k, 10.0)
                if len(lm_hit) and int((frame.lm_idx >= 0).sum()) + len(lm_hit) >= th:
                    frame.lm_idx[feat_hit] = lm_hit
                    n_in = self._pose_optimize(frame)
                    if 30 <= n_in < th:
                        lm_hit, feat_hit = self._match_landmarks_into_frame(frame, lms_k, 3.0)
                        if len(lm_hit):
                            frame.lm_idx[feat_hit] = lm_hit
                            n_in = self._pose_optimize(frame)
            if n_in >= th:
                source = "database" if k in db_cand else "recency"
                log.info("relocalized at frame %d against KF %d (%s, %d inliers)", frame.frame_id, k, source, n_in)
                self.events.append({"kind": "reloc", "frame": int(frame.frame_id), "kf": k, "source": source,
                                    "n_inliers": int(n_in)})
                self.state = TrackState.OK
                self.velocity = None
                self.ref_kf = k
                self.last = frame
                return True
        frame.R = None
        frame.t = None
        self.last = frame
        return False

    def _local_keyframes(self, frame: FrameData) -> np.ndarray:
        """K1 = KFs sharing landmarks with the frame, ranked by overlap;
        the top sharer becomes the reference KF (UpdateLocalKeyFrames)."""
        m = self.map
        bound = frame.lm_idx[frame.lm_idx >= 0]
        if len(bound) == 0:
            return np.zeros(0, np.int64)
        counts = m.obs[:, bound].sum(axis=1)
        counts[~m.kf_valid] = 0
        order = np.argsort(-counts)
        k1 = order[: self.cfg.local_window_kfs]
        k1 = k1[counts[k1] > 0]
        if len(k1):
            self.ref_kf = int(k1[0])
        return k1

    # ------------------------------------------------------------------
    # Mapping (LocalMapping::Run main steps, synchronous)
    # ------------------------------------------------------------------

    def _insert_keyframe(self, frame: FrameData):
        """Keyframe insertion head (the synchronous part of
        CreateNewKeyFrame): the keyframe row is added on the track thread;
        the mapping step runs on the mapping worker when there is one, else
        here."""
        m = self.map
        if self.worker is not None:
            # Never block the track thread on a mapping-held lock: skip and
            # retry next frame.
            if not self.map_lock.acquire(blocking=False):
                self.n_kf_skipped_backpressure += 1
                return
            self.map_lock.release()
            if m.big_change_idx != self._seen_change_idx:
                # The map was corrected after this frame was tracked: its pose
                # is in the pre-correction frame. Skip; the next frame rebases
                # and decides again.
                self.n_kf_skipped_backpressure += 1
                return
        with self.map_lock:
            try:
                k = m.add_keyframe(
                    frame.R, frame.t, frame.xy, frame.level, frame.angle,
                    frame.desc, frame.valid, frame.lm_idx, frame.timestamp,
                    frame.frame_id, ur=frame.ur, depth=frame.depth,
                )
            except RuntimeError:
                # Keyframe capacity exhausted: cull around the reference KF
                # and skip this insertion.
                log.warning(
                    "keyframe capacity exhausted (%d slots); culling and skipping insertion", m.cfg.max_keyframes,
                )
                if self.ref_kf >= 0 and m.kf_valid[self.ref_kf]:
                    self._cull_keyframes(self.ref_kf)
                return
            self.last_kf_frame_id = frame.frame_id
            self.ref_kf = k
            self.n_kf_inserted += 1
            self._reanchor_trajectory_records(k)
            if self.inertial:
                self._attach_inertial_kf(k, frame)
            # Stereo/RGB-D: seed close points from depth (CreateNewKeyFrame)
            # on the track thread, so that the live frame sees its new
            # bindings.
            if self.cfg.sensor not in (Sensor.MONOCULAR, Sensor.IMU_MONOCULAR):
                self._seed_depth_points(frame, k)
        if self.worker is not None:
            self.worker.submit(k, {"map_ref": m})
            if m.n_keyframes() < self.cfg.young_map_kfs:
                # Young-map phase: drain before the next frame (see
                # TrackerConfig.young_map_kfs).
                self.frame_causes[frame.frame_id].append("young_map_drain")
                self.worker.flush()
        else:
            self._mapping_step(k, map_ref=m, frame=frame)

    def _seed_depth_points(self, frame: FrameData, k: int) -> list[int]:
        """Landmarks for the unbound features of a new stereo/RGB-D keyframe
        with a depth: every close one (depth < th_depth), and at least the
        100 nearest (CreateNewKeyFrame). Call under the map lock."""
        m = self.map
        cand = np.nonzero(frame.valid & (frame.depth > 0) & (frame.lm_idx < 0))[0]
        if len(cand) == 0:
            return []
        order = cand[np.argsort(frame.depth[cand])]
        close = frame.depth[order] < max(self.cfg.th_depth, 0.0)
        take = order[: max(int(close.sum()), min(100, len(order)))]
        X = self._unproject_depth(frame, take)
        dirs = X - (-frame.R.T @ frame.t)
        dist = np.linalg.norm(dirs, axis=1)
        try:
            ids = m.add_landmarks(
                pos=X,
                desc_packed=frame.desc[take],
                desc_i8=frame.desc_i8[take],
                first_kf=k,
                level=frame.level[take],
                normal=(dirs / np.maximum(dist[:, None], 1e-9)).astype(np.float32),
                min_dist=(dist * 0.5).astype(np.float32),
                max_dist=(dist * 2.0).astype(np.float32),
            )
        except RuntimeError:  # landmark capacity exhausted
            return []
        frame.lm_idx[take] = ids
        m.add_observation(k, take, ids)
        return [int(i) for i in ids]

    def _mapping_step_batch(self, ks: list[int], map_ref: MapState, frame: FrameData | None = None):
        """Catch-up processing of a drained keyframe queue: older keyframes
        are registered (landmark statistics, and the full loop step: the
        reference's loop thread detects on every queued keyframe) and the
        newest gets the full mapping step; its triangulation pair set always
        includes the most recent keyframes, so the skipped keyframes' fresh
        features still seed the map frontier."""
        m = map_ref
        live = [k for k in ks if m is self.map and m.kf_valid[k]]
        if not live:
            return
        for k in live[:-1]:
            seen = m.kf_lm_idx[k][m.kf_lm_idx[k] >= 0]
            m.update_landmark_stats(np.unique(seen))
            self._hand_to_loop(k, m)
        log.info("mapping catch-up: registered %d queued KFs, full step on %d", len(live) - 1, live[-1])
        self._mapping_step(live[-1], map_ref=m, frame=frame)

    def _mapping_step(self, k: int, map_ref: MapState, frame: FrameData | None = None):
        """The LocalMapping work for one keyframe (LocalMapping::Run loop
        body): triangulate, fuse, cull landmarks, window BA, cull
        keyframes. Runs on the caller's thread or on the MappingWorker."""
        m = map_ref
        if m is not self.map or not m.kf_valid[k]:
            return
        # Keyframes already waiting behind this one: the step is
        # "interrupted" (LocalMapping::InterruptBA) and skips keyframe
        # culling, the one deferrable stage.
        interrupted = self.worker is not None and self.worker.q.qsize() > 0
        with self.timers.span("map_step"):
            neigh, _ = m.covisible_keyframes(k, min_weight=15, top=self.cfg.local_window_kfs)
            # Triangulation pair set = temporally newest keyframes first,
            # then the strongest covisibles: at the map frontier the
            # covisible list points backward. The baseline-ratio gate in
            # _triangulate_dispatch protects mono scale from the
            # short-baseline recent pairs.
            valid = np.nonzero(m.kf_valid)[0]
            valid = valid[valid != k]
            recent = valid[np.argsort(-m.kf_frame_id[valid])][: self.cfg.tri_recent_first]
            seen_r = {int(x) for x in recent}
            tri_neigh = np.asarray(
                [int(x) for x in recent] + [int(x) for x in neigh if int(x) not in seen_r], np.int64,
            )

            # Both mapping device programs are dispatched up front, as in
            # the reference: fusion projects the pre-triangulation landmark
            # set, so this keyframe's new points get their duplicate check
            # one keyframe later.
            with self.timers.span("map_triangulate_dispatch"):
                tri = self._triangulate_dispatch(k, tri_neigh)
            with self.map_lock:
                with self.timers.span("map_fuse_dispatch"):
                    fuse = self._fuse_dispatch(k)

            # Refresh normals/descriptors of the tracked bindings
            # (ProcessNewKeyFrame's UpdateNormalAndDepth).
            with self.timers.span("map_stats"):
                seen = m.kf_lm_idx[k][m.kf_lm_idx[k] >= 0]
                m.update_landmark_stats(np.unique(seen))

            with self.timers.span("map_triangulate"):
                new_ids = self._triangulate_apply(tri)
            if new_ids:
                with self.timers.span("map_stats"):
                    m.update_landmark_stats(np.asarray(new_ids))

            if fuse is not None:
                with self.timers.span("map_fuse"):
                    self._fuse_apply(fuse)
            # Cull weak recent landmarks (MapPointCulling).
            with self.map_lock:
                with self.timers.span("map_cull_lm"):
                    self._cull_landmarks(k)
            # The map FRONTIER of this step is now fresh (triangulations,
            # fusion forwarding and the landmark cull all landed): release
            # the track thread's bounded-staleness wait so that it tracks
            # against it while the window BA below solves concurrently.
            if self.worker is not None:
                self.worker.release_frontier()
                interrupted = interrupted or not self.worker.q.empty()
            # Window BA on every keyframe, interrupted or not: visual-inertial
            # over the temporal window once the IMU is initialized.
            ba_ctx = None
            if self.inertial and m.imu_stage >= 1:
                with self.timers.span("map_local_vi_ba"):
                    self._local_inertial_ba(k)
            else:
                window = [k] + [int(x) for x in neigh[: self.cfg.ba_kf_cap - 1]]
                with self.timers.span("map_local_ba_dispatch"):
                    ba_ctx = self._local_ba_dispatch(window, iters=self.cfg.ba_iters_per_kf)

            # Redundant-keyframe culling (LocalMapping::KeyFrameCulling).
            if not interrupted:
                with self.map_lock:
                    with self.timers.span("map_cull_kf"):
                        self._cull_keyframes(k)

            # The BA write-back lands before the IMU ladder: an IMU
            # initialization rewrites the whole map (gravity alignment and
            # rescale), which a stale BA result applied after it would undo.
            if ba_ctx is not None:
                with self.timers.span("map_local_ba"):
                    self._local_ba_apply(ba_ctx)
            # The IMU init ladder. On the mapping worker it runs against a
            # shim frame carrying the keyframe's stamp and pose: its map
            # rewrites reach the live frame through big_change_idx and the
            # track thread's rebase, and a bad-IMU verdict is handed back
            # (`_pending_reset`).
            if self.inertial:
                if frame is None:
                    frame_l = FrameData(frame_id=int(m.kf_frame_id[k]), timestamp=float(m.kf_timestamp[k]))
                    frame_l.R, frame_l.t = m.kf_R[k].copy(), m.kf_t[k].copy()
                else:
                    frame_l = frame
                with self.timers.span("map_imu_ladder"):
                    self._imu_ladder(frame_l, k)
        # Place recognition hand-off (LoopClosing::InsertKeyFrame).
        self._hand_to_loop(k, m, frame)
        log.info(
            "KF %d mapped: %d new lms, map: %d KFs / %d lms", k, len(new_ids), m.n_keyframes(), m.n_landmarks(),
        )

    def _hand_to_loop(self, k: int, m: MapState, frame: FrameData | None = None):
        """The loop step of keyframe k: on the LoopWorker thread when there
        is one, else inline."""
        if self.loop_worker is not None:
            self.loop_worker.submit(k, m)
        else:
            self._loop_step(k, m, frame=frame)

    def _loop_step(self, k: int, map_ref: MapState, frame: FrameData | None = None):
        """One LoopClosing iteration for keyframe k: detection, validation,
        correction or merge proposal, database registration. On the
        LoopWorker thread (frame=None) the live frame learns of a correction
        through big_change_idx and `_rebase_after_map_change`, and a merge
        proposal is parked in `_pending_merge` for the track thread; inline,
        a merge executes here and a correction re-anchors `frame` on its own
        corrected keyframe."""
        m = map_ref
        if m is not self.map or not m.kf_valid[k]:
            return
        if self.loop_closer is None:
            self.kfdb.add(self._gid(k), self._kf_bits(k), m.kf_feat_valid[k])
            return
        big0 = m.big_change_idx
        with self.timers.span("map_loop"):
            merge = self.loop_closer.process_keyframe(k)
        if merge is not None:
            if self.worker is not None:
                self._pending_merge = (k, merge)
            else:
                self._execute_merge(k, frame, *merge)
        elif m.big_change_idx != big0 and frame is not None:
            frame.R = m.kf_R[k].copy()
            frame.t = m.kf_t[k].copy()
            self.velocity = None
            self._seen_change_idx = m.big_change_idx
            if self.inertial:
                self._sync_after_global(frame, k)

    def _scene_median_depth(self, k: int) -> float:
        """Median depth of a keyframe's bound landmarks in its own frame
        (KeyFrame::ComputeSceneMedianDepth)."""
        m = self.map
        lm2 = m.kf_lm_idx[k]
        lm2 = lm2[lm2 >= 0]
        if len(lm2) == 0:
            return 1.0
        z = m.lm_pos[lm2] @ m.kf_R[k][2] + m.kf_t[k][2]
        return max(float(np.median(z)), 1e-6)

    def _triangulate_dispatch(self, k1: int, neigh):
        """Dispatch half of the covisible-pair triangulation
        (LocalMapping::CreateNewMapPoints): enqueue one
        fused_triangulate_store program for all neighbour pairs and return
        the un-fetched device handles."""
        m = self.map
        T = self.cfg.triangulate_neighbors
        cand = [int(x) for x in neigh]
        if not cand:
            return None
        # Baseline-vs-depth gate over the whole candidate pool, before the
        # T pair slots are assigned (the reference skips short baselines,
        # ratio vs the neighbour's scene median depth).
        c1 = -m.kf_R[k1].T @ m.kf_t[k1]
        ver = (m.map_id, m.big_change_idx)
        if ver != self._kf_med_depth_ver:
            self._kf_med_depth[:] = 0.0
            self._kf_med_depth_ver = ver
        self._kf_med_depth[k1] = self._scene_median_depth(k1)
        ksa = np.asarray(cand)
        c2s = -np.einsum("kji,kj->ki", m.kf_R[ksa], m.kf_t[ksa])
        baselines = np.linalg.norm(c2s - c1[None, :], axis=1)
        meds = self._kf_med_depth[ksa]
        for j in np.nonzero(meds <= 0)[0]:
            meds[j] = self._kf_med_depth[ksa[j]] = self._scene_median_depth(int(ksa[j]))
        ratio = baselines / np.maximum(meds, 1e-6)
        sel = np.nonzero(ratio >= 0.01)[0][:T]
        if len(sel) == 0:
            return None
        ks = [cand[i] for i in sel]
        pair_ok = np.zeros(T, bool)
        pair_ok[: len(ks)] = True
        arr = np.asarray(ks + [ks[0]] * (T - len(ks)))
        free1 = m.kf_feat_valid[k1] & (m.kf_lm_idx[k1] < 0)
        free2 = m.kf_feat_valid[arr] & (m.kf_lm_idx[arr] < 0)
        with self.map_lock:
            s = self._kf_store
            s.sync(m, [k1, *arr])
        out = fused_triangulate_store(
            s.desc, s.xy, s.level, s.angle, s.depth, s.ur,
            int(k1), self._put(arr, np.int64),
            self._put(m.kf_R[k1]), self._put(m.kf_t[k1]),
            self._put(m.kf_R[arr]), self._put(m.kf_t[arr]),
            self._put(free1), self._put(free2),
            self._put(pair_ok), self._K_dev, float(self.cfg.bf),
        )
        return (k1, ks, pair_ok, free1, out, m.big_change_idx)

    def _triangulate_apply(self, ctx) -> list[int]:
        """Fetch half: land the triangulation results and allocate landmark
        slots with cross-pair feature dedup (a feature binds at its first
        successful pair)."""
        if ctx is None:
            return []
        k1, ks, pair_ok, free1, out, big0 = ctx
        m = self.map
        f1s, f2s, Xs, n_match = fetch_block(out)
        if m.big_change_idx != big0:
            return []
        if log.isEnabledFor(logging.DEBUG):
            log.debug(
                "tri KF %d: %d free, matches %s, accepted %s", k1, int(free1.sum()),
                [int(x) for x in n_match[: len(ks)]], [int((f1s[j] >= 0).sum()) for j in range(len(ks))],
            )
        new_ids: list[int] = []
        bound1 = ~free1
        bits1 = self._kf_bits(k1)
        for j, k2 in enumerate(ks):
            if not pair_ok[j]:
                continue
            row = f1s[j]
            keep = np.nonzero((row >= 0) & ~bound1[np.maximum(row, 0)])[0]
            if len(keep) == 0:
                continue
            f1 = row[keep]
            f2 = f2s[j][keep]
            with self.map_lock:
                try:
                    ids = m.add_landmarks(
                        pos=Xs[j][keep],
                        desc_packed=m.kf_desc[k1, f1],
                        desc_i8=bits1[f1],
                        first_kf=k1,
                        level=m.kf_level[k1, f1],
                        normal=np.zeros((len(f1), 3), np.float32),
                        min_dist=np.full(len(f1), 0.1, np.float32),
                        max_dist=np.full(len(f1), 100.0, np.float32),
                    )
                except RuntimeError:
                    return new_ids
                m.add_observation(k1, f1, ids)
                m.add_observation(k2, f2, ids)
            bound1[f1] = True
            new_ids.extend(int(i) for i in ids)
        return new_ids

    def _apply_fuse_matches(self, lm_ids: np.ndarray, kf: int, lm_slots: np.ndarray, feats: np.ndarray) -> int:
        """Merge bookkeeping for compacted fuse matches (lm_slot into
        `lm_ids`, feature index; slot -1 = padding) into keyframe `kf` (the
        host half of ORBmatcher::Fuse, MapPoint::Replace policy): a match
        bound to a different landmark merges into whichever has more
        observations; an unbound match gains an observation."""
        m = self.map
        n_fused = 0
        n_ids = len(lm_ids)
        for j in np.nonzero((lm_slots >= 0) & (lm_slots < n_ids))[0]:
            lm = int(lm_ids[lm_slots[j]])
            if not m.lm_valid[lm]:
                continue  # merged away earlier in this loop
            f = int(feats[j])
            cur = int(m.kf_lm_idx[kf, f])
            if cur == lm:
                continue
            if cur >= 0 and m.lm_valid[cur]:
                # Positional sanity on merges: gate laterally at ~2% of
                # depth, along the ray at ~25% (triangulation noise is
                # anisotropic).
                cc = -m.kf_R[kf].T @ m.kf_t[kf]
                ray = m.lm_pos[cur] - cc
                depth = max(float(np.linalg.norm(ray)), 1e-3)
                ray = ray / depth
                delta = m.lm_pos[lm] - m.lm_pos[cur]
                along = float(delta @ ray)
                perp = float(np.linalg.norm(delta - along * ray))
                if perp > 0.02 * depth or abs(along) > 0.25 * depth:
                    continue
                if m.lm_obs_count[cur] >= m.lm_obs_count[lm]:
                    m.replace_landmark(lm, cur)
                else:
                    m.replace_landmark(cur, lm)
            else:
                m.add_observation(kf, np.asarray([f]), np.asarray([lm]))
            n_fused += 1
        return n_fused

    def _fuse_dispatch(self, k: int):
        """Dispatch half of duplicate-landmark fusion
        (LocalMapping::SearchInNeighbors): project the new KF's landmarks
        into its first- and second-order covisible keyframes and the
        neighbourhood's landmarks back into the new KF. Enqueues one
        fused_fuse_store program over a fixed 16 target rows and returns
        the un-fetched handles for _fuse_apply."""
        m = self.map
        n1, _ = m.covisible_keyframes(k, min_weight=15, top=10)
        targets: list[int] = []
        seen = {int(k)}
        for n in [int(x) for x in n1]:
            if n not in seen:
                targets.append(n)
                seen.add(n)
            n2, _ = m.covisible_keyframes(n, min_weight=15, top=5)
            for nn in [int(x) for x in n2]:
                if nn not in seen:
                    targets.append(nn)
                    seen.add(nn)
        targets = targets[:12]
        if not targets:
            return None
        cur_lms = m.kf_lm_idx[k]
        cur_lms = np.unique(cur_lms[cur_lms >= 0])
        cur_lms = cur_lms[m.lm_valid[cur_lms]]
        fuse_lms = m.kf_lm_idx[np.asarray(targets)]
        fuse_lms = np.unique(fuse_lms[fuse_lms >= 0])
        fuse_lms = fuse_lms[m.lm_valid[fuse_lms]]
        cap = self.cfg.local_lm_cap
        # New-KF landmarks first so capacity truncation drops fusion
        # candidates, not the landmarks being fused.
        ids = np.concatenate([cur_lms, np.setdiff1d(fuse_lms, cur_lms)])[:cap]
        n_ids = len(ids)
        if n_ids == 0:
            return None
        T_CAP = 16
        rows = [int(x) for x in targets] + [int(k)]
        nT = len(rows)
        arr = np.asarray(rows + [rows[0]] * (T_CAP - nT))
        s = self._kf_store
        s.sync(m, arr)  # called under the map lock
        cur_mask = np.zeros(cap, bool)
        cur_mask[:n_ids] = np.isin(ids, cur_lms)
        fuse_mask = np.zeros(cap, bool)
        fuse_mask[:n_ids] = np.isin(ids, fuse_lms)
        is_last = np.zeros(T_CAP, bool)
        is_last[nT - 1] = True
        # Landmark geometry packed into one (L,8) upload.
        geom = np.zeros((cap, 8), np.float32)
        geom[:n_ids, 0:3] = m.lm_pos[ids]
        geom[:n_ids, 3:6] = m.lm_normal[ids]
        geom[:n_ids, 6] = m.lm_min_dist[ids]
        geom[:n_ids, 7] = m.lm_max_dist[ids]
        geom[n_ids:, 7] = 1.0
        lm_desc = np.zeros((cap, 8), np.int64)
        lm_desc[:n_ids] = m.lm_desc[ids]
        lm_val = np.zeros(cap, bool)
        lm_val[:n_ids] = m.lm_valid[ids]

        out = fused_fuse_store(
            self._put(geom), self._put(lm_desc), self._put(lm_val),
            self._put(cur_mask), self._put(fuse_mask), self._put(is_last),
            s.desc, s.xy, s.level, s.valid,
            self._put(arr, np.int64),
            self._put(m.kf_R[arr]), self._put(m.kf_t[arr]),
            self.fx, self.fy, self.cx, self.cy,
            float(self.cfg.width), float(self.cfg.height),
        )
        return (k, ids, rows, nT, n_ids, out, m.big_change_idx)

    def _fuse_apply(self, ctx):
        """Fetch half of duplicate-landmark fusion: land the match tables
        and run the merge bookkeeping."""
        if ctx is None:
            return
        k, ids, rows, nT, n_ids, out, big0 = ctx
        m = self.map
        slots_b, feats_b = fetch_block(out)
        if m.big_change_idx != big0:
            return
        with self.map_lock:
            n_fused = 0
            for j in range(nT):
                n_fused += self._apply_fuse_matches(ids, rows[j], slots_b[j], feats_b[j])
            self.n_fused_last = n_fused
            if n_fused:
                # Refresh descriptors/normals of everything the new KF sees.
                cur = m.kf_lm_idx[k]
                m.update_landmark_stats(np.unique(cur[cur >= 0]))
                log.debug("fused %d duplicate landmarks around KF %d", n_fused, k)

    def _cull_keyframes(self, k: int):
        """Remove covisible keyframes whose landmarks are >= 90% redundant
        (50% for the stereo and RGB-D inertial sensors): seen by >= 3 other
        keyframes at the same or finer scale (LocalMapping::KeyFrameCulling).
        Inertial guard: never open a gap of more than 3 s in the
        preintegration chain."""
        m = self.map
        st = self.cull_stats
        st.calls += 1
        neigh, _ = m.covisible_keyframes(k, min_weight=15)
        valid_ids = np.nonzero(m.kf_valid)[0]
        st.not_neighbour += len(valid_ids) - 1 - len(neigh)
        if len(neigh) == 0:
            return
        st.candidates += len(neigh)
        fid_min = int(m.kf_frame_id[valid_ids].min())
        red_th = 0.5 if self.inertial and self.cfg.sensor != Sensor.IMU_MONOCULAR else 0.9
        # Work bound per insertion, lifted under capacity pressure so the
        # fixed-capacity map cannot grow into exhaustion.
        occupancy = len(valid_ids) / m.cfg.max_keyframes
        max_cull = 2 if occupancy < 0.7 else 8
        n_culled = 0
        for i, kf in enumerate(int(x) for x in neigh):
            if n_culled >= max_cull:
                st.max_cull += len(neigh) - i
                break
            if kf in (k, self.ref_kf, self.last_kf_slot) or int(m.kf_frame_id[kf]) == fid_min:  # or the map origin
                st.protected += 1
                continue
            if self.inertial:
                p, nx = int(m.kf_prev[kf]), int(m.kf_next[kf])
                if p < 0 or nx < 0 or float(m.kf_timestamp[nx] - m.kf_timestamp[p]) > 3.0:
                    st.inertial_gap += 1
                    continue
            lm = m.kf_lm_idx[kf]
            f = np.nonzero(lm >= 0)[0]
            if len(f) < 10:
                st.few_landmarks += 1
                continue
            lm_sel = lm[f]
            lvl_kf = m.kf_level[kf, f]
            obs_kfs = np.nonzero(m.obs[:, lm_sel].any(axis=1) & m.kf_valid)[0]
            count = np.zeros(len(lm_sel), np.int32)
            for k2 in obs_kfs:
                if k2 == kf:
                    continue
                lut = np.full(m.cfg.max_landmarks, -1, np.int32)
                fv = np.nonzero(m.kf_lm_idx[k2] >= 0)[0]
                lut[m.kf_lm_idx[k2, fv]] = m.kf_level[k2, fv]
                l2 = lut[lm_sel]
                count += ((l2 >= 0) & (l2 <= lvl_kf + 1)).astype(np.int32)
            redundant = count >= 3
            st.redundancy.append(float(redundant.mean()))
            if redundant.mean() < red_th:
                st.below_redundancy += 1
                continue
            self._remove_keyframe_full(kf)
            n_culled += 1
            st.culled += 1
        if n_culled:
            log.info("culled %d redundant keyframes", n_culled)

    def _remove_keyframe_full(self, kf: int):
        """Cull one keyframe: re-anchor the trajectory entries that
        reference it onto its strongest covisible neighbour, then remove it
        from the map."""
        m = self.map
        nb, _ = m.covisible_keyframes(kf, min_weight=1, top=1)
        rep = int(nb[0]) if len(nb) else int(m.kf_prev[kf])
        if rep >= 0 and m.kf_valid[rep]:
            R_rp = m.kf_R[kf] @ m.kf_R[rep].T
            t_rp = m.kf_t[kf] - R_rp @ m.kf_t[rep]
            for i, (fid, t, mid, rk, R_cr, t_cr) in enumerate(self.trajectory):
                if mid == m.map_id and rk == kf:
                    self.trajectory[i] = (
                        fid, t, mid, rep,
                        (R_cr @ R_rp).astype(np.float32),
                        (R_cr @ t_rp + t_cr).astype(np.float32),
                    )
        self.kfdb.erase(self._gid(kf))
        self._kf_med_depth[kf] = 0.0  # slot may be reused
        m.remove_keyframe(kf)

    def _cull_landmarks(self, k: int | None = None):
        """Remove recent landmarks with a poor found/visible ratio or too
        few observations (LocalMapping::MapPointCulling); only points
        younger than ~3 keyframes are ratio-culled."""
        m = self.map
        cur_fid = int(m.kf_frame_id[k]) if k is not None and m.kf_valid[k] else self.frame_id
        age = cur_fid - m.lm_birth_fid  # frames since creation
        young = (m.lm_birth_fid >= 0) & (age <= 12)
        ratio = m.lm_found / np.maximum(m.lm_visible, 1)
        weak = m.lm_valid & young & (
            ((ratio < 0.25) & (m.lm_visible > 3))
            | ((m.lm_obs_count < 2) & (m.lm_visible > 6) & (age >= 6))
        )
        ids = np.nonzero(weak)[0]
        if len(ids):
            m.remove_landmarks(ids)
        # Capacity pressure: above 90% occupancy, also drop the
        # worst-observed landmarks so slots never run out mid-sequence.
        n_valid = int(m.lm_valid.sum())
        cap = m.cfg.max_landmarks
        if n_valid > 0.9 * cap:
            score = np.where(m.lm_valid, m.lm_obs_count * 10 + m.lm_found, np.iinfo(np.int32).max)
            n_drop = n_valid - int(0.8 * cap)
            drop = np.argsort(score)[:n_drop]
            m.remove_landmarks(drop[m.lm_valid[drop]])
            log.info("landmark capacity pressure: dropped %d weakest", n_drop)

    def _local_ba(self, window: list[int], fix: list[int] | None = None, iters: int = 10):
        """Assemble a fixed-capacity BAProblem from the window and run it
        (dispatch + apply back to back)."""
        self._local_ba_apply(self._local_ba_dispatch(window, fix, iters))

    def _local_ba_dispatch(self, window: list[int], fix: list[int] | None = None, iters: int = 10):
        """Assemble the window BA problem, padded to the configured caps,
        and enqueue one LM schedule on the tracker's device; returns the
        un-fetched handles for _local_ba_apply."""
        from ..optim.local_ba import BAProblem, local_ba

        m = self.map
        cfg = self.cfg
        window = list(dict.fromkeys(window))[: cfg.ba_kf_cap]
        # Landmarks seen by the window.
        lms = m.local_map_landmarks(np.asarray(window, np.int64))[: cfg.ba_lm_cap]
        if len(lms) < 8 or len(window) < 2:
            return None
        # Fixed KFs: other KFs observing these landmarks (boundary).
        other = m.obs[:, lms].any(axis=1) & m.kf_valid
        other[window] = False
        fixed_extra = np.nonzero(other)[0][: cfg.ba_fixed_cap]
        kfs = np.asarray(window + [int(x) for x in fixed_extra], np.int64)
        K_n = cfg.ba_kf_cap + cfg.ba_fixed_cap
        pad_k = K_n - len(kfs)

        kf_fixed = np.zeros(len(kfs), bool)
        kf_fixed[len(window):] = True
        if fix:
            for f in fix:
                kf_fixed[np.nonzero(kfs == f)[0]] = True
        # Gauge anchor: the map-origin KF is always held fixed when it
        # participates (LocalBundleAdjustment fixes the init KF).
        valid_ids = np.nonzero(m.kf_valid)[0]
        origin = int(valid_ids[np.argmin(m.kf_frame_id[valid_ids])])
        kf_fixed[kfs == origin] = True
        if not kf_fixed.any():
            # No fixed camera at all: abort like the reference.
            return None

        lm_lookup = np.full(m.cfg.max_landmarks, -1, np.int64)
        lm_lookup[lms] = np.arange(len(lms))

        # Gather observations, batched over the whole window.
        lm_sub = m.kf_lm_idx[kfs]  # (Kk, N)
        li = lm_lookup[np.maximum(lm_sub, 0)]
        sel2 = (lm_sub >= 0) & (li >= 0)
        ki_idx, f_idx = np.nonzero(sel2)
        kf_rows = kfs[ki_idx]
        o_kf = ki_idx
        o_lm = li[ki_idx, f_idx]
        o_uv = (m.kf_xy[kf_rows, f_idx] - [self.cx, self.cy]).astype(np.float32)
        o_sig = self._feat_sigma2(m.kf_level[kf_rows, f_idx])
        ur_raw = m.kf_ur[kf_rows, f_idx]
        o_ur = (ur_raw - self.cx).astype(np.float32)
        o_st = ur_raw >= 0
        if len(o_kf) > cfg.ba_obs_cap:
            keep = informed_obs_drop(o_lm, cfg.ba_obs_cap, np.random.default_rng(0))
            o_kf, o_lm, o_uv, o_sig = o_kf[keep], o_lm[keep], o_uv[keep], o_sig[keep]
            o_ur, o_st = o_ur[keep], o_st[keep]
        pad_o = cfg.ba_obs_cap - len(o_kf)
        pad_l = cfg.ba_lm_cap - len(lms)

        def padk(x, fill=0):
            return np.concatenate([x, np.full((pad_k, *x.shape[1:]), fill, x.dtype)])

        put = self._put
        prob = BAProblem(
            R=put(padk(m.kf_R[kfs])),
            t=put(padk(m.kf_t[kfs])),
            kf_valid=put(np.concatenate([np.ones(len(kfs), bool), np.zeros(pad_k, bool)])),
            kf_fixed=put(np.concatenate([kf_fixed, np.ones(pad_k, bool)])),
            Xw=put(np.concatenate([m.lm_pos[lms], np.zeros((pad_l, 3), np.float32)])),
            lm_valid=put(np.concatenate([np.ones(len(lms), bool), np.zeros(pad_l, bool)])),
            obs_kf=put(np.concatenate([o_kf, np.zeros(pad_o)]), np.int64),
            obs_lm=put(np.concatenate([o_lm, np.zeros(pad_o)]), np.int64),
            obs_uvr=put(
                np.concatenate([np.concatenate([o_uv, o_ur[:, None]], 1), np.zeros((pad_o, 3), np.float32)])
            ),
            obs_sigma2=put(np.concatenate([o_sig, np.ones(pad_o, np.float32)])),
            obs_stereo=put(np.concatenate([o_st, np.zeros(pad_o, bool)])),
            obs_valid=put(np.concatenate([np.ones(len(o_kf), bool), np.zeros(pad_o, bool)])),
            fx=self.fx, fy=self.fy, bf=float(cfg.bf),
        )
        # One schedule per call: the window BA runs on the tracker's own
        # device in f32.
        res = local_ba(prob, iters=iters, gate_at=iters // 2)
        return (res, kfs, lms, m, m.kf_gen[kfs].copy(), m.big_change_idx)

    def _local_ba_apply(self, ctx):
        """Fetch the BA result and write it back. Keyframe rows are guarded
        by generation, landmark rows by liveness."""
        if ctx is None:
            return
        res, kfs, lms, m, gen0, big0 = ctx
        R_new, t_new, X_new = fetch_block((res.R, res.t, res.Xw))
        R_new = R_new[: len(kfs)]
        t_new = t_new[: len(kfs)]
        X_new = X_new[: len(lms)]
        with self.map_lock:
            if m is not self.map or m.big_change_idx != big0:
                return
            okk = m.kf_valid[kfs] & (m.kf_gen[kfs] == gen0)
            m.kf_R[kfs[okk]] = R_new[okk]
            m.kf_t[kfs[okk]] = t_new[okk]
            okl = m.lm_valid[lms]
            m.lm_pos[lms[okl]] = X_new[okl]

    # ------------------------------------------------------------------
    # Visual-inertial mapping (the IMU init ladder, LocalInertialBA,
    # FullInertialBA)
    # ------------------------------------------------------------------

    def _attach_inertial_kf(self, k: int, frame: FrameData):
        """Link the new keyframe into the temporal chain with its velocity,
        biases and the preintegration since the previous keyframe. Caller
        holds the map lock."""
        m = self.map
        prev = self.last_kf_slot
        if prev < 0 or not m.kf_valid[prev]:
            prev = -1
        raw = np.stack(self._imu_since_kf) if self._imu_since_kf else None
        m.set_keyframe_inertial(k, self.cur_v, self.cur_bg, self.cur_ba, prev, raw)
        self._imu_since_kf = []
        self._imu_since_kf_t = []
        self._pre_from_kf = None
        self.last_kf_slot = k
        if m.imu_t0 < 0:
            m.imu_t0 = frame.timestamp
        self._kf_inserted_last_frame = True

    def _imu_ladder(self, frame: FrameData, k: int):
        """Staged IMU initialization (LocalMapping::Run :232-286):
        InitializeIMU -> VIBA1 -> VIBA2 -> ScaleRefinement, and the bad-IMU
        verdict (:170-179)."""
        m = self.map
        cfg = self.cfg
        if m.imu_t0 < 0:
            return
        elapsed = frame.timestamp - m.imu_t0
        if m.imu_stage == 0:
            chain = m.temporal_window(k, cfg.imu_init_min_kfs + 1)
            if len(chain) >= cfg.imu_init_min_kfs and elapsed >= cfg.imu_init_time:
                mono = cfg.sensor == Sensor.IMU_MONOCULAR
                self._initialize_imu(frame, k, prior_g=1e2, prior_a=1e10 if mono else 1e5, fix_scale=not mono)
            return
        # Bad IMU: initialized, but (almost) no camera motion over the last
        # two keyframe intervals early on means an unconstrained solution:
        # reset the active map (consumed at src/Tracking.cc:1782).
        if m.imu_stage < 3:
            p = int(m.kf_prev[k])
            pp = int(m.kf_prev[p]) if p >= 0 else -1
            if p >= 0 and pp >= 0:
                def cam_c(i):
                    return -m.kf_R[i].T @ m.kf_t[i]

                dist = np.linalg.norm(cam_c(k) - cam_c(p)) + np.linalg.norm(cam_c(p) - cam_c(pp))
                if elapsed < cfg.bad_imu_time and dist < cfg.bad_imu_dist:
                    log.warning("bad IMU: %.3f m motion over the last 2 KFs at t=%.1fs; resetting the active map",
                                dist, elapsed)
                    if threading.current_thread().name == "mapping":
                        self._pending_reset = True  # the track thread resets
                    else:
                        self._spawn_or_reset_map()
                    return
        if m.imu_stage == 1 and elapsed >= cfg.viba1_time:
            log.info("VIBA1 at t=%.1fs", elapsed)
            self._full_inertial_ba(k, prior_g=1.0, prior_a=1e5)
            m.imu_stage = 2
            self._sync_after_global(frame, k)
        elif m.imu_stage == 2 and elapsed >= cfg.viba2_time:
            log.info("VIBA2 at t=%.1fs", elapsed)
            self._full_inertial_ba(k, prior_g=0.0, prior_a=0.0)
            m.imu_stage = 3
            self._sync_after_global(frame, k)
        elif (
            m.imu_stage >= 3
            and cfg.sensor == Sensor.IMU_MONOCULAR
            and m.n_keyframes() <= 200
            and self._scale_refine_idx < len(cfg.scale_refine_times)
        ):
            # ScaleRefinement windows (mTinit in (25,25.5) ... (75,75.5)).
            t_due = cfg.scale_refine_times[self._scale_refine_idx]
            if elapsed >= t_due:
                self._scale_refine_idx += 1
                if elapsed < t_due + cfg.scale_refine_window:
                    self._scale_refinement(frame, k)

    def _chain_edges(self, k: int):
        """The whole temporal chain ending at k, oldest first, and its edges
        (i, j) with their keyframes' stored preintegrations."""
        m = self.map
        ks = np.asarray(m.temporal_window(k, 10**6)[::-1], np.int64)
        ei, ej, pre_ks = [], [], []
        for idx in range(1, len(ks)):
            a, b = int(ks[idx - 1]), int(ks[idx])
            if m.kf_pre_valid[b] and int(m.kf_prev[b]) == a:
                ei.append(idx - 1)
                ej.append(idx)
                pre_ks.append(b)
        return ks, ei, ej, pre_ks

    def _scale_refinement(self, frame: FrameData, k: int):
        """LocalMapping::ScaleRefinement (src/LocalMapping.cc:1465): gravity
        direction and scale alone over the whole chain, everything else
        fixed; the map is re-aligned when the scale moved by more than 0.2%."""
        from ..optim import inertial as vi

        m = self.map
        ks, ei, ej, pre_ks = self._chain_edges(k)
        if len(ei) < 5:
            return
        put = self._put
        Rwb, twb = self._body_from_cam_np(m.kf_R[ks], m.kf_t[ks])
        steps = np.linalg.norm(np.diff(twb, axis=0), axis=1)
        sigma_p = 0.05 * float(np.median(steps)) if len(steps) else 0.0
        res = vi.inertial_init(
            put(Rwb), put(twb), put(m.kf_vel[ks]), put(ei, np.int64), put(ej, np.int64),
            put(np.ones(len(ei), bool)), m.stacked_preint(pre_ks, self.device), 0.0, 0.0,
            bg0=put(m.kf_bg[k]), ba0=put(m.kf_ba[k]), iters=30, fix_bias=True, fix_vel=True, sigma_p=sigma_p,
        )
        Rwg, s = fetch_block((res.Rwg, res.scale))
        s = float(s)
        if not np.isfinite(s) or s < 0.1:
            log.warning("scale refinement rejected: s=%.4f", s)
            return
        if abs(s - 1.0) > 0.002:
            with self.map_lock:
                m.apply_gravity_scale(Rwg.T.astype(np.float32), s, scale_vel=True)
            bias = np.concatenate([m.kf_bg[k], m.kf_ba[k]]).astype(np.float32)
            for b in ks:
                if m.kf_pre_valid[b]:
                    m._reintegrate(int(b), bias=bias)
            log.info("scale refinement: s=%.4f applied (%d KFs)", s, len(ks))
            self._sync_after_global(frame, k)
        else:
            log.info("scale refinement: s=%.4f (no change needed)", s)

    def _initialize_imu(self, frame: FrameData, k: int, prior_g: float, prior_a: float, fix_scale: bool) -> bool:
        """LocalMapping::InitializeIMU (src/LocalMapping.cc:1189-1463): gravity,
        scale, biases and velocities with the poses fixed, the world aligned
        to gravity and rescaled, then a full visual-inertial BA."""
        from ..optim import inertial as vi

        m = self.map
        ks, ei, ej, pre_ks = self._chain_edges(k)
        if len(ei) < 3:
            return False
        Rwb, twb = self._body_from_cam_np(m.kf_R[ks], m.kf_t[ks])
        # Closed-form linear alignment (the scale/gravity/velocity seed),
        # immune to the whitened GN's scale collapse under keyframe-pose noise.
        s_lin, g_lin, v_lin = vi.linear_inertial_init(Rwb, twb, ei, ej, m.stacked_preint(pre_ks))
        if fix_scale:
            s_lin = 1.0
        if not np.isfinite(s_lin) or s_lin < 1e-3:
            log.warning("IMU linear init rejected: scale %.5f", s_lin)
            return False
        # Pre-align gravity from the linear estimate, so that the 2-dof
        # gravity parametrization starts near the identity.
        g_dir = g_lin / max(np.linalg.norm(g_lin), 1e-9)
        gI = np.array([0.0, 0.0, -1.0])
        vx = np.cross(gI, g_dir)
        ang = np.arctan2(np.linalg.norm(vx), float(gI @ g_dir))
        axis = vx / max(np.linalg.norm(vx), 1e-9)
        Rwg_seed = lie.so3_exp(torch.as_tensor(axis * ang, dtype=torch.float32)).numpy()
        Rg = Rwg_seed.T
        Rwb_p = np.einsum("ij,kjl->kil", Rg, Rwb).astype(np.float32)
        twb_p = (twb @ Rg.T).astype(np.float32)
        # The velocity seed in map units, in the pre-rotated frame.
        v0 = ((v_lin / s_lin) @ Rg.T).astype(np.float32)
        # The keyframe-position noise floor: a fraction of the median step.
        steps = np.linalg.norm(np.diff(twb, axis=0), axis=1)
        sigma_p = 0.05 * float(np.median(steps)) if len(steps) else 0.0
        put = self._put
        res = vi.inertial_init(
            put(Rwb_p), put(twb_p), put(v0), put(ei, np.int64), put(ej, np.int64), put(np.ones(len(ei), bool)),
            m.stacked_preint(pre_ks, self.device), prior_g, prior_a, iters=100, fix_scale=fix_scale,
            log_s0=float(np.float32(np.log(s_lin))), sigma_p=sigma_p,
        )
        Rwg, s, bg, ba, vel = fetch_block((res.Rwg, res.scale, res.bg, res.ba, res.vel))
        s = float(s)
        if not np.isfinite(s) or (not fix_scale and s < 1e-2):
            log.warning("IMU init rejected: scale %.4f", s)
            return False
        Ryw = (Rwg_seed @ Rwg).T.astype(np.float32)
        with self.map_lock:
            # Velocities come back in the pre-rotated world: undo the seed.
            m.kf_vel[ks] = vel @ Rwg_seed.T
            m.kf_bg[m.kf_valid] = bg
            m.kf_ba[m.kf_valid] = ba
            m.apply_gravity_scale(Ryw, s)
        bias = np.concatenate([bg, ba]).astype(np.float32)
        for b in ks:
            if m.kf_pre_valid[b]:
                m._reintegrate(int(b), bias=bias)
        m.imu_stage = 1
        log.info("IMU initialized: scale %.3f, |bg| %.4f, |ba| %.4f (%d KFs)",
                 s, np.linalg.norm(bg), np.linalg.norm(ba), len(ks))
        self._full_inertial_ba(k, prior_g=prior_g, prior_a=prior_a)
        self._sync_after_global(frame, k)
        return True

    def _sync_after_global(self, frame: FrameData, k: int):
        """Re-anchor the live tracking state after a global map change
        (Tracking::UpdateFrameIMU)."""
        m = self.map
        m.big_change_idx += 1
        frame.R = m.kf_R[k].copy()
        frame.t = m.kf_t[k].copy()
        self.cur_v = m.kf_vel[k].copy()
        self.cur_bg = m.kf_bg[k].copy()
        self.cur_ba = m.kf_ba[k].copy()
        Rwb, p = self._body_from_cam_np(frame.R, frame.t)
        self.last_body = (Rwb, p, self.cur_v.copy())
        self.velocity = None
        self.prior_H = None
        self._kf_inserted_last_frame = True

    def _stacked_pre_padded(self, pre_ks: list[int], cap: int) -> imu_ops.Preintegrated:
        """The keyframes' stored preintegrations on the tracker's device,
        padded to `cap` with empty intervals (dR = I, C = 0, dT = 0: their
        residuals vanish)."""
        m = self.map
        n = len(pre_ks)
        pad = cap - n
        eye = np.eye(3, dtype=np.float32)
        z3, z33 = np.zeros(3, np.float32), np.zeros((3, 3), np.float32)
        fill = dict(dR=eye, dV=z3, dP=z3, C=np.zeros((15, 15), np.float32), JRg=z33, JVg=z33, JVa=z33,
                    JPg=z33, JPa=z33, dT=np.float32(0.0), bias_gyro=z3, bias_acc=z3)
        base = m.stacked_preint(np.asarray(pre_ks, np.int64)) if n else None

        def fld(name):
            shape = np.shape(fill[name])
            real = getattr(base, name).numpy() if base is not None else np.zeros((0, *shape), np.float32)
            return self._put(np.concatenate([real, np.broadcast_to(fill[name], (pad, *shape))]), np.float32)

        return imu_ops.Preintegrated(**{name: fld(name) for name in fill})

    def _build_vi_problem(self, opt_kfs: list[int], K_cap: int, obs_cap: int, prior_g: float = 0.0,
                          prior_a: float = 0.0, lm_cap: int | None = None):
        """A fixed-capacity VIBAProblem on the tracker's device: the
        optimizable temporal window, the fixed boundary and observer
        keyframes, the reprojection observations and the inertial chain
        edges among them. Returns the problem with what the write-back needs
        (keyframe slots and generations, landmark ids, the map and its
        big_change_idx), or None with fewer than 8 landmarks."""
        from ..optim.inertial import VIBAProblem

        m = self.map
        cfg = self.cfg
        lm_cap = cfg.ba_lm_cap if lm_cap is None else lm_cap
        opt_kfs = list(dict.fromkeys(opt_kfs))
        # Fixed: the temporal boundary and covisible observers of the window's
        # landmarks.
        fixed: list[int] = []
        b = int(m.kf_prev[opt_kfs[0]])
        if b >= 0 and m.kf_valid[b] and b not in opt_kfs:
            fixed.append(b)
        lms = m.local_map_landmarks(np.asarray(opt_kfs, np.int64))[:lm_cap]
        if len(lms) < 8:
            return None
        other = m.obs[:, lms].any(axis=1) & m.kf_valid
        other[opt_kfs] = False
        if fixed:
            other[fixed] = False
        fixed += [int(x) for x in np.nonzero(other)[0][: cfg.ba_fixed_cap]]
        kfs = (opt_kfs + fixed)[:K_cap]
        n_opt = min(len(opt_kfs), K_cap)
        pad_k = K_cap - len(kfs)
        kfs_arr = np.asarray(kfs, np.int64)
        kf_fixed = np.zeros(len(kfs), bool)
        kf_fixed[n_opt:] = True
        if not kf_fixed.any():
            kf_fixed[0] = True

        lm_lookup = np.full(m.cfg.max_landmarks, -1, np.int64)
        lm_lookup[lms] = np.arange(len(lms))
        lm_sub = m.kf_lm_idx[kfs_arr]  # (Kk, N)
        li = lm_lookup[np.maximum(lm_sub, 0)]
        o_kf, f_idx = np.nonzero((lm_sub >= 0) & (li >= 0))
        kf_rows = kfs_arr[o_kf]
        o_lm = li[o_kf, f_idx]
        o_uv = (m.kf_xy[kf_rows, f_idx] - [self.cx, self.cy]).astype(np.float32)
        o_sig = self._feat_sigma2(m.kf_level[kf_rows, f_idx])
        o_ur = (m.kf_ur[kf_rows, f_idx] - self.cx).astype(np.float32)
        o_st = m.kf_ur[kf_rows, f_idx] >= 0
        if len(o_kf) > obs_cap:
            keep = informed_obs_drop(o_lm, obs_cap, np.random.default_rng(0))
            o_kf, o_lm, o_uv, o_sig = o_kf[keep], o_lm[keep], o_uv[keep], o_sig[keep]
            o_ur, o_st = o_ur[keep], o_st[keep]
        pad_o = obs_cap - len(o_kf)
        pad_l = lm_cap - len(lms)

        # Inertial edges among the problem's keyframes (the prev -> k chain).
        slot_of = {int(kk): i for i, kk in enumerate(kfs)}
        ei, ej, pre_ks = [], [], []
        for kk in kfs:
            pkf = int(m.kf_prev[kk])
            if m.kf_pre_valid[kk] and pkf in slot_of:
                ei.append(slot_of[pkf])
                ej.append(slot_of[int(kk)])
                pre_ks.append(int(kk))
        E_cap = K_cap
        n_e = min(len(ei), E_cap)
        ei, ej, pre_ks = ei[:n_e], ej[:n_e], pre_ks[:n_e]
        Rwb, twb = self._body_from_cam_np(m.kf_R[kfs_arr], m.kf_t[kfs_arr])

        def padk(x, fill=0):
            return np.concatenate([x, np.full((pad_k, *x.shape[1:]), fill, x.dtype)])

        def cat(x, n, fill, dtype):
            x = np.asarray(x, dtype)
            return np.concatenate([x, np.full((n, *x.shape[1:]), fill, dtype)])

        put = self._put
        prob = VIBAProblem(
            Rwb=put(np.concatenate([Rwb, np.tile(np.eye(3, dtype=np.float32), (pad_k, 1, 1))])),
            twb=put(padk(twb)), vel=put(padk(m.kf_vel[kfs_arr])),
            bg=put(padk(m.kf_bg[kfs_arr])), ba=put(padk(m.kf_ba[kfs_arr])),
            kf_valid=put(cat(np.ones(len(kfs), bool), pad_k, False, bool)),
            kf_fixed=put(cat(kf_fixed, pad_k, True, bool)),
            Xw=put(cat(m.lm_pos[lms], pad_l, 0.0, np.float32)),
            lm_valid=put(cat(np.ones(len(lms), bool), pad_l, False, bool)),
            obs_kf=put(cat(o_kf, pad_o, 0, np.int64)), obs_lm=put(cat(o_lm, pad_o, 0, np.int64)),
            obs_uvr=put(cat(np.concatenate([o_uv, o_ur[:, None]], 1), pad_o, 0.0, np.float32)),
            obs_sigma2=put(cat(o_sig, pad_o, 1.0, np.float32)),
            obs_stereo=put(cat(o_st, pad_o, False, bool)),
            obs_valid=put(cat(np.ones(len(o_kf), bool), pad_o, False, bool)),
            edge_i=put(cat(ei, E_cap - n_e, 0, np.int64)), edge_j=put(cat(ej, E_cap - n_e, 0, np.int64)),
            edge_valid=put(cat(np.ones(n_e, bool), E_cap - n_e, False, bool)),
            pre=self._stacked_pre_padded(pre_ks, E_cap),
            Rcb=put(self.Rcb, np.float32), tcb=put(self.tcb, np.float32),
            fx=float(np.float32(self.fx)), fy=float(np.float32(self.fy)), bf=float(np.float32(cfg.bf)),
            prior_kf=n_opt - 1,  # the newest optimizable keyframe
            prior_g=float(np.float32(prior_g)), prior_a=float(np.float32(prior_a)),
        )
        return prob, kfs_arr, np.asarray(lms), m, m.kf_gen[kfs_arr].copy(), m.big_change_idx

    def _solve_vi(self, built, iters: int, gate_at: int, sparse: bool = False, background: bool = False):
        """Solve a built problem on its device; host (Rcw, tcw, vel, bg, ba)
        of its keyframes and the positions of its landmarks. A foreground
        sparse solve shards as `_gba_solve` does; a background one never."""
        prob, kfs_arr, lms = built[:3]
        if sparse:
            from ..optim.sparse_ba import sparse_vi_ba
            from ..parallel.dist_ba import default_group, sparse_vi_ba_sharded

            group = None if background else default_group()
            if group is not None and prob.obs_kf.shape[0] % dist.get_world_size(group) == 0:
                res = sparse_vi_ba_sharded(group, prob, iters=iters, gate_at=gate_at)
                self.n_sharded_solves += 1
            else:
                res = sparse_vi_ba(prob, iters=iters, gate_at=gate_at)
        else:
            from ..optim.inertial import visual_inertial_ba

            res = visual_inertial_ba(prob, iters=iters, gate_at=gate_at)
        n = len(kfs_arr)
        Rwb, twb, vel, bg, ba, Xw = fetch_block((res.Rwb, res.twb, res.vel, res.bg, res.ba, res.Xw))
        Rcw, tcw = self._cam_from_body_np(Rwb[:n], twb[:n])
        return Rcw, tcw, vel[:n], bg[:n], ba[:n], Xw[: len(lms)]

    def _run_vi_ba(self, built, iters: int, gate_at: int, sparse: bool = False):
        """Solve and write back under the map lock: keyframe rows guarded by
        generation, landmark rows by liveness, and the whole result dropped
        if another thread corrected the map meanwhile."""
        Rcw, tcw, vel, bg, ba, Xw = self._solve_vi(built, iters, gate_at, sparse)
        _, kfs, lms, m, gen0, big0 = built
        with self.map_lock:
            if m is not self.map or m.big_change_idx != big0:
                return
            ok = m.kf_valid[kfs] & (m.kf_gen[kfs] == gen0)
            k = kfs[ok]
            m.kf_R[k], m.kf_t[k] = Rcw[ok], tcw[ok]
            m.kf_vel[k], m.kf_bg[k], m.kf_ba[k] = vel[ok], bg[ok], ba[ok]
            okl = m.lm_valid[lms]
            m.lm_pos[lms[okl]] = Xw[okl]

    def _local_inertial_ba(self, k: int):
        """LocalInertialBA (src/Optimizer.cc:2371): the temporal window of the
        last keyframes through the prev chain, the boundary and the observers
        fixed."""
        window = self.map.temporal_window(k, self.cfg.local_window_kfs)[::-1]
        built = self._build_vi_problem(window, K_cap=self.cfg.vi_kf_cap, obs_cap=self.cfg.ba_obs_cap)
        if built is not None:
            self._run_vi_ba(built, iters=10, gate_at=5)

    def _full_vi_problem(self, k: int, prior_g: float = 0.0, prior_a: float = 0.0):
        """The whole temporal chain ending at k as one problem: the dense
        window capacities up to `vi_full_kf_cap` keyframes, else map-scale
        capacities (keyframes bucketed to multiples of 64) for the sparse
        solver. Returns (built, sparse)."""
        cfg = self.cfg
        chain = self.map.temporal_window(k, 10**6)[::-1]
        if len(chain) <= cfg.vi_full_kf_cap:
            return self._build_vi_problem(chain, K_cap=cfg.vi_full_kf_cap + cfg.ba_fixed_cap, obs_cap=cfg.vi_obs_cap,
                                          prior_g=prior_g, prior_a=prior_a), False
        K_cap = -(-(len(chain) + cfg.ba_fixed_cap) // 64) * 64
        K_cap = min(K_cap, cfg.map_cfg.max_keyframes + cfg.ba_fixed_cap)
        return self._build_vi_problem(chain, K_cap=K_cap, obs_cap=cfg.gba_obs_cap, prior_g=prior_g,
                                      prior_a=prior_a, lm_cap=cfg.map_cfg.max_landmarks), True

    def _full_inertial_ba(self, k: int, prior_g: float, prior_a: float, iters: int = 15):
        """FullInertialBA (src/Optimizer.cc:378): the whole temporal chain,
        the bias prior on the newest keyframe; the dense solver for short
        chains, the sparse PCG-Schur solver for long ones."""
        built, sparse = self._full_vi_problem(k, prior_g, prior_a)
        if built is not None:
            self._run_vi_ba(built, iters=iters, gate_at=min(8, iters - 2) if sparse else 8, sparse=sparse)

    def _vi_global_ba_background(self, k: int):
        """FullInertialBA on the global-BA thread (RunGlobalBundleAdjustment
        with FullInertialBA): the problem is built under the map lock, solved
        on its own thread and written back through `_gba_apply`, which
        patches keyframes and landmarks created during the solve; velocities
        and biases follow, generation-guarded. A failure of the thread is
        re-raised at the next `flush_mapping`."""
        if self._gba_thread is not None and self._gba_thread.is_alive():
            log.warning("global BA already running; skipping new request")
            return
        m = self.map
        with self.map_lock:
            built, sparse = self._full_vi_problem(k)
            if built is None:
                return
            kfs_arr, lms = built[1], built[2]
            snap = dict(map=m, kf_R=m.kf_R.copy(), kf_t=m.kf_t.copy(), kf_valid=m.kf_valid.copy(),
                        kf_gen=m.kf_gen.copy(), Xw=m.lm_pos.copy(), lm_valid=m.lm_valid.copy(),
                        lm_gen=m.lm_gen.copy())

        def run():
            try:
                with self.timers.span("global_ba"):
                    Rcw, tcw, vel, bg, ba, Xw = self._solve_vi(built, iters=7, gate_at=4, sparse=sparse, background=True)
                    # Full-size update arrays: unsolved rows keep their snapshot.
                    R_new, t_new, X_new = snap["kf_R"].copy(), snap["kf_t"].copy(), snap["Xw"].copy()
                    R_new[kfs_arr], t_new[kfs_arr] = Rcw, tcw
                    X_new[lms] = Xw
                    self._gba_apply(snap, R_new, t_new, X_new)
                    with self.map_lock:
                        if m is self.map:
                            ok = m.kf_valid[kfs_arr] & (m.kf_gen[kfs_arr] == snap["kf_gen"][kfs_arr])
                            m.kf_vel[kfs_arr[ok]] = vel[ok]
                            m.kf_bg[kfs_arr[ok]] = bg[ok]
                            m.kf_ba[kfs_arr[ok]] = ba[ok]
            except BaseException as e:  # noqa: BLE001 - re-raised at the next flush
                log.exception("background inertial global BA failed")
                self._gba_error = e

        self._gba_thread = threading.Thread(target=run, name="global_ba_vi", daemon=True)
        self._gba_thread.start()

    # ------------------------------------------------------------------
    # Global BA (whole map)
    # ------------------------------------------------------------------

    def _global_ba(self, fix: list[int] | None = None, iters: int | None = None):
        """Whole-map visual BA (Optimizer::GlobalBundleAdjustemnt) with the
        sparse PCG-Schur solver, on the calling thread."""
        snap = self._gba_gather(fix)
        if snap is None:
            return
        self._gba_apply(snap, *self._gba_solve(snap, iters))

    def _gba_gather(self, fix: list[int] | None = None):
        """Snapshot the whole-map BA problem under the map lock. Keyframe and
        landmark slots map 1:1 to problem slots, so only the observation
        table is gathered; slot generations let a background solve detect
        slots culled and reused while it computed."""
        m = self.map
        cfg = self.cfg
        with self.map_lock:
            if m.n_keyframes() < 3 or m.n_landmarks() < 32:
                return None
            kf_fixed = ~m.kf_valid.copy()
            if fix:
                kf_fixed[list(fix)] = True
            else:
                # Gauge: the map-origin keyframe.
                valid_ids = np.nonzero(m.kf_valid)[0]
                kf_fixed[int(valid_ids[np.argmin(m.kf_frame_id[valid_ids])])] = True
            ks, fs = np.nonzero(m.kf_valid[:, None] & m.kf_feat_valid & (m.kf_lm_idx >= 0))
            o_lm = m.kf_lm_idx[ks, fs]
            keep = m.lm_valid[o_lm]
            ks, fs, o_lm = ks[keep], fs[keep], o_lm[keep]
            if len(ks) < 64:
                return None
            if len(ks) > cfg.gba_obs_cap:
                log.warning("global BA: subsampling %d observations to cap %d", len(ks), cfg.gba_obs_cap)
                keep = informed_obs_drop(o_lm, cfg.gba_obs_cap, np.random.default_rng(0))
                ks, fs, o_lm = ks[keep], fs[keep], o_lm[keep]
            return dict(
                map=m, kf_R=m.kf_R.copy(), kf_t=m.kf_t.copy(), kf_valid=m.kf_valid.copy(), kf_fixed=kf_fixed,
                kf_gen=m.kf_gen.copy(), Xw=m.lm_pos.copy(), lm_valid=m.lm_valid.copy(), lm_gen=m.lm_gen.copy(),
                ks=ks, o_lm=o_lm, n_obs=len(ks),
                o_uv=(m.kf_xy[ks, fs] - [self.cx, self.cy]).astype(np.float32),
                o_sig=self._feat_sigma2(m.kf_level[ks, fs]),
                o_ur=(m.kf_ur[ks, fs] - self.cx).astype(np.float32),
                o_st=m.kf_ur[ks, fs] >= 0,
            )

    def _gba_solve(self, snap: dict, iters: int | None = None, background: bool = False):
        """Solve the snapshotted problem on the tracker's device; returns host
        (R, t, Xw) of every slot. A foreground solve shards its observations
        over the default process group when there is one and the padded
        count divides by its size (parallel/dist_ba.py: every rank runs this
        same call on the same map); a background solve never shards."""
        from ..optim.sparse_ba import sparse_ba
        from ..parallel.dist_ba import default_group, sparse_ba_sharded

        iters = self.cfg.gba_iters if iters is None else iters
        prob = self._gba_problem(snap)
        group = None if background else default_group()
        if group is not None and prob.obs_kf.shape[0] % dist.get_world_size(group) == 0:
            res = sparse_ba_sharded(group, prob, iters=iters, gate_at=max(2, iters // 2))
            self.n_sharded_solves += 1
        else:
            res = sparse_ba(prob, iters=iters, gate_at=max(2, iters // 2))
        R_new, t_new, X_new, cost = fetch_block((res.R, res.t, res.Xw, res.cost))
        log.info("global BA solved: %d obs, cost %.1f", snap["n_obs"], float(cost))
        return R_new, t_new, X_new

    def _gba_problem(self, snap: dict):
        """The snapshotted whole-map BA problem on the tracker's device, the
        observation count padded to a multiple of gba_obs_bucket."""
        from ..optim.local_ba import BAProblem

        cfg = self.cfg
        n_obs = snap["n_obs"]
        pad_o = min(-(-n_obs // cfg.gba_obs_bucket) * cfg.gba_obs_bucket, cfg.gba_obs_cap) - n_obs

        def pado(x, fill=0):
            return np.concatenate([x, np.full((pad_o, *x.shape[1:]), fill, x.dtype)])

        put = self._put
        prob = BAProblem(
            R=put(snap["kf_R"]), t=put(snap["kf_t"]),
            kf_valid=put(snap["kf_valid"]), kf_fixed=put(snap["kf_fixed"]),
            Xw=put(snap["Xw"]), lm_valid=put(snap["lm_valid"]),
            obs_kf=put(pado(snap["ks"]), np.int64), obs_lm=put(pado(snap["o_lm"]), np.int64),
            obs_uvr=put(pado(np.concatenate([snap["o_uv"], snap["o_ur"][:, None]], 1))),
            obs_sigma2=put(pado(snap["o_sig"].astype(np.float32), 1.0)),
            obs_stereo=put(pado(snap["o_st"])),
            obs_valid=put(np.concatenate([np.ones(n_obs, bool), np.zeros(pad_o, bool)])),
            fx=self.fx, fy=self.fy, bf=float(cfg.bf),
        )
        return prob

    def _gba_apply(self, snap: dict, R_new, t_new, X_new):
        """Write the result back under the map lock, propagating corrections
        to keyframes and landmarks created while the solve ran (the post-GBA
        spanning-tree patch of RunGlobalBundleAdjustment): a new keyframe
        rides its strongest snapshot covisible, a new landmark its first
        observing keyframe."""
        m = snap["map"]
        with self.map_lock:
            if m not in self.atlas.maps:
                self.events.append({"kind": "gba_drop", "why": "map_gone"})
                return
            in_snap = m.kf_valid & snap["kf_valid"] & (m.kf_gen == snap["kf_gen"])
            in_snap_l = m.lm_valid & snap["lm_valid"] & (m.lm_gen == snap["lm_gen"])
            new_k = np.nonzero(m.kf_valid & ~in_snap)[0]
            new_l = np.nonzero(m.lm_valid & ~in_snap_l)[0]
            # Old (pre-correction) poses of every live anchor candidate.
            R_old_all = m.kf_R.copy()
            t_old_all = m.kf_t.copy()
            R_old_all[in_snap] = snap["kf_R"][in_snap]
            t_old_all[in_snap] = snap["kf_t"][in_snap]
            m.kf_R[in_snap] = R_new[in_snap]
            m.kf_t[in_snap] = t_new[in_snap]
            m.lm_pos[in_snap_l] = X_new[in_snap_l]
            snap_slots = np.nonzero(in_snap)[0]
            if len(new_k) and len(snap_slots):
                counts = m.obs[snap_slots].astype(np.int32) @ m.obs[new_k].astype(np.int32).T  # (S, N)
                a_for = snap_slots[np.argmax(counts, axis=0)]
                has = counts.max(axis=0) > 0
                for j, a, h in zip(new_k, a_for, has):
                    if not h:
                        continue
                    R_rel = m.kf_R[j] @ snap["kf_R"][a].T
                    t_rel = m.kf_t[j] - R_rel @ snap["kf_t"][a]
                    m.kf_R[j] = (R_rel @ R_new[a]).astype(np.float32)
                    m.kf_t[j] = (R_rel @ t_new[a] + t_rel).astype(np.float32)
            if len(new_l):
                anchors = m.lm_first_kf[new_l]
                ok_a = (anchors >= 0) & m.kf_valid[np.maximum(anchors, 0)]
                for a in np.unique(anchors[ok_a]):
                    lsel = new_l[(anchors == a) & ok_a]
                    xc = m.lm_pos[lsel] @ R_old_all[a].T + t_old_all[a]
                    m.lm_pos[lsel] = ((xc - m.kf_t[a]) @ m.kf_R[a]).astype(np.float32)
            self.events.append({
                "kind": "gba_apply", "n_kf": int(in_snap.sum()), "n_new_kf": len(new_k), "n_new_lm": len(new_l),
            })
            # Inside the lock: results of other threads in flight are guarded
            # by big_change_idx, so the bump must be visible before anyone
            # can read the corrected poses.
            m.big_change_idx += 1

    def _global_ba_after_loop(self, k: int, c: int):
        """LoopCloser hook (RunGlobalBundleAdjustment): a whole-map BA with
        the loop candidate fixed. Inline without a mapping worker; else on its
        own thread against a snapshot, so that the mapping queue keeps
        draining. A failure of that thread is re-raised at the next
        `flush_mapping` (and so at shutdown)."""
        if not self.cfg.enable_global_ba:
            return
        m = self.map
        if self.inertial and m.imu_stage >= 1:
            # FullInertialBA(7), inline or on the global-BA thread.
            if self.worker is None:
                with self.timers.span("global_ba"):
                    self._full_inertial_ba(k, prior_g=0.0, prior_a=0.0, iters=7)
                m.big_change_idx += 1  # the inline solve writes directly
            else:
                self._vi_global_ba_background(k)
            return
        if self.worker is None:
            with self.timers.span("global_ba"):
                self._global_ba(fix=[c])
            return
        if self._gba_thread is not None and self._gba_thread.is_alive():
            log.warning("global BA already running; skipping new request")
            return
        snap = self._gba_gather(fix=[c])
        if snap is None:
            return

        def run():
            try:
                with self.timers.span("global_ba"):
                    self._gba_apply(snap, *self._gba_solve(snap, background=True))
            except BaseException as e:  # noqa: BLE001 - re-raised at the next flush
                log.exception("background global BA failed")
                self._gba_error = e

        self._gba_thread = threading.Thread(target=run, name="global_ba", daemon=True)
        self._gba_thread.start()

    # ------------------------------------------------------------------
    # Trajectory
    # ------------------------------------------------------------------

    def _reanchor_trajectory_records(self, k_new: int):
        """Rebase pending relative trajectory records that ride a long
        frame gap onto the just-inserted keyframe, composed through the
        current poses of both anchors, so that later corrections reach
        them. Caller holds map_lock."""
        m = self.map
        cap = self.cfg.max_record_gap
        fid_new = int(m.kf_frame_id[k_new])
        Rk, tk = m.kf_R[k_new], m.kf_t[k_new]
        for i in range(self._traj_anchor_ptr, len(self.trajectory)):
            fid, t, map_id, kref, R_cr, t_cr = self.trajectory[i]
            while (map_id, kref) in self._kf_alias:
                map_id, kref = self._kf_alias[(map_id, kref)]
            if map_id != m.map_id or not m.kf_valid[kref]:
                continue
            gap = abs(fid - int(m.kf_frame_id[kref]))
            if gap <= cap or gap <= abs(fid - fid_new):
                continue
            Rr, tr = m.kf_R[kref], m.kf_t[kref]
            R_fw = R_cr @ Rr
            t_fw = R_cr @ tr + t_cr
            R_new = (R_fw @ Rk.T).astype(np.float32)
            t_new = (t_fw - R_new @ tk).astype(np.float32)
            self.trajectory[i] = (fid, t, map_id, k_new, R_new, t_new)
        self._traj_anchor_ptr = len(self.trajectory)

    def _record_trajectory(self, frame: FrameData):
        """Store T_cam<-refKF so later KF-pose optimization propagates into
        the exported trajectory (mlRelativeFramePoses)."""
        k = self.ref_kf
        with self.map_lock:
            if self.map.big_change_idx != self._seen_change_idx:
                # A correction landed after this frame was tracked: its pose
                # is pre-correction. Skip; the next frame rebases.
                return
            Rr, tr = self.map.kf_R[k].copy(), self.map.kf_t[k].copy()
        # Tcr = Tcw * Trw^-1
        R_cr = frame.R @ Rr.T
        t_cr = frame.t - R_cr @ tr
        self.trajectory.append(
            (frame.frame_id, frame.timestamp, self.map.map_id, k, R_cr.copy(), t_cr.copy())
        )

    def export_trajectory(self):
        """Return (timestamps, Twc 4x4 array), TUM-style camera-to-world
        (SaveTrajectoryTUM semantics), for the frames of every map of the
        Atlas, each in its own map's world frame: a record of a merged-away
        map follows its keyframe's aliases into the map it was welded into.
        Drains the pipeline and the workers first."""
        self.flush_mapping()
        ts, poses = [], []
        maps_by_id = {m.map_id: m for m in self.atlas.maps}
        for fid, t, map_id, k, R_cr, t_cr in self.trajectory:
            while (map_id, k) in self._kf_alias:
                map_id, k = self._kf_alias[(map_id, k)]
            m = maps_by_id.get(map_id)
            if m is None or not m.kf_valid[k]:
                continue
            R_cw = R_cr @ m.kf_R[k]
            t_cw = R_cr @ m.kf_t[k] + t_cr
            T = np.eye(4)
            T[:3, :3] = R_cw.T
            T[:3, 3] = -R_cw.T @ t_cw
            ts.append(t)
            poses.append(T)
        return np.asarray(ts), np.asarray(poses)


# The reference's name for the monocular-only API.
MonoTracker = Tracker
