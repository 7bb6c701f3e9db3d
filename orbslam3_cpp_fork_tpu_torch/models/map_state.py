"""The SLAM map as fixed-capacity structure-of-arrays state (a copy of the
reference's models/map_state.py: host-side numpy; the IMU re-integration
runs the port's preintegration on the device of the attached calibration).

Replaces the reference's mutex-guarded pointer graph — KeyFrame
(src/KeyFrame.cc), MapPoint (src/MapPoint.cc), Map (src/Map.cc) — with
flat arrays + validity masks managed by the host orchestrator:

- Keyframes: poses (Tcw), per-feature keypoints/descriptors, and the
  observation table `kf_lm_idx` (feature -> landmark id, -1 if none) —
  the SoA equivalent of Frame::mvpMapPoints.
- Landmarks: position, representative descriptor, viewing normal and
  scale-invariance band (MapPoint::UpdateNormalAndDepth,
  src/MapPoint.cc:471-541), found/visible counters for culling.
- Covisibility is not stored as an adjacency list: the boolean
  incidence matrix `obs` (K x L) makes covisibility weights one matmul
  (`obs @ obs[k]`), replacing KeyFrame::UpdateConnections
  (src/KeyFrame.cc:476-575).

Everything device-facing is padded to the capacities below; slots are
recycled through free lists (compaction instead of deletion), so device
programs never see a shape change. This file is host-side numpy; heavy
math stays in ops/ and optim/.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np

# Per-level scale info (matching ORBextractor defaults).
SCALE_FACTOR = 1.2
N_LEVELS = 8
LEVEL_SIGMA2 = (SCALE_FACTOR ** (2 * np.arange(N_LEVELS))).astype(np.float32)

# Byte-popcount lookup table for Hamming distances on packed descriptors.
_POPCOUNT8 = np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=1
).sum(1).astype(np.uint16)


@dataclasses.dataclass
class MapConfig:
    max_keyframes: int = 256
    max_landmarks: int = 16384
    n_features: int = 1000  # per-keyframe feature capacity
    # Raw IMU samples kept per keyframe interval (for re-integration after
    # bias updates, like IMU::Preintegrated's stored mvMeasurements).
    imu_cap: int = 512


class MapState:
    """One map of the Atlas (reference Map). Host-side, numpy-backed."""

    def __init__(self, cfg: MapConfig = MapConfig(), map_id: int = 0):
        self.cfg = cfg
        self.map_id = map_id
        # Bumped on loop correction / merge / IMU-init rescale / global
        # BA (Map big-change index, src/Map.cc:154-162); consumed by
        # System.map_changed().
        self.big_change_idx = 0
        K, L, N = cfg.max_keyframes, cfg.max_landmarks, cfg.n_features

        # Keyframes.
        self.kf_valid = np.zeros(K, bool)
        self.kf_R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))  # Tcw
        self.kf_t = np.zeros((K, 3), np.float32)
        self.kf_timestamp = np.zeros(K, np.float64)
        self.kf_frame_id = np.full(K, -1, np.int64)
        # Per-keyframe features.
        self.kf_xy = np.zeros((K, N, 2), np.float32)  # undistorted px
        self.kf_level = np.zeros((K, N), np.int32)
        self.kf_angle = np.zeros((K, N), np.float32)
        self.kf_desc = np.zeros((K, N, 8), np.uint32)  # packed 256-bit
        self.kf_feat_valid = np.zeros((K, N), bool)
        self.kf_lm_idx = np.full((K, N), -1, np.int32)  # feature -> landmark
        # Stereo/RGB-D right coordinate (<0 = mono feature).
        self.kf_ur = np.full((K, N), -1.0, np.float32)
        self.kf_depth = np.full((K, N), -1.0, np.float32)

        # Inertial per-keyframe state (KeyFrame mVw/mImuBias + mPrevKF
        # chain, include/KeyFrame.h). kf_prev/next form the temporal chain
        # used by LocalInertialBA's sliding window and KF culling.
        self.kf_vel = np.zeros((K, 3), np.float32)  # world-frame body vel
        self.kf_bg = np.zeros((K, 3), np.float32)
        self.kf_ba = np.zeros((K, 3), np.float32)
        self.kf_prev = np.full(K, -1, np.int32)
        self.kf_next = np.full(K, -1, np.int32)
        # Preintegration from kf_prev[k] to k (IMU::Preintegrated fields,
        # include/ImuTypes.h:209-247), SoA so windows stack to one record.
        self.kf_pre_valid = np.zeros(K, bool)
        self.kf_pre_dR = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
        self.kf_pre_dV = np.zeros((K, 3), np.float32)
        self.kf_pre_dP = np.zeros((K, 3), np.float32)
        self.kf_pre_C = np.zeros((K, 15, 15), np.float32)
        self.kf_pre_J = np.zeros((K, 5, 3, 3), np.float32)  # JRg,JVg,JVa,JPg,JPa
        self.kf_pre_dT = np.zeros(K, np.float32)
        self.kf_pre_bias = np.zeros((K, 6), np.float32)  # [bg, ba] lin. point
        # Raw measurements for re-integration: [dt, acc(3), gyro(3)].
        self.kf_imu = np.zeros((K, cfg.imu_cap, 7), np.float32)
        self.kf_imu_n = np.zeros(K, np.int32)

        # Landmarks.
        self.lm_valid = np.zeros(L, bool)
        self.lm_pos = np.zeros((L, 3), np.float32)
        self.lm_desc = np.zeros((L, 8), np.uint32)
        self.lm_desc_i8 = np.zeros((L, 256), np.int8)  # unpacked bits
        self.lm_normal = np.zeros((L, 3), np.float32)
        self.lm_min_dist = np.zeros(L, np.float32)
        self.lm_max_dist = np.zeros(L, np.float32)
        self.lm_level = np.zeros(L, np.int32)  # reference observation level
        self.lm_visible = np.zeros(L, np.int32)
        self.lm_found = np.zeros(L, np.int32)
        self.lm_first_kf = np.full(L, -1, np.int32)
        # Frame id at creation (the recency window of MapPointCulling:
        # the reference only ratio-culls points younger than ~3
        # keyframes, src/LocalMapping.cc:382-416 — mnFirstKFid there;
        # a frame stamp here because KF slots are recycled).
        self.lm_birth_fid = np.full(L, -1, np.int64)
        self.lm_obs_count = np.zeros(L, np.int32)
        # Slot generations: bumped on (re)allocation so long-running
        # background consumers (concurrent global BA) can detect a slot
        # that was culled and recycled while they computed.
        self.kf_gen = np.zeros(K, np.int64)
        self.lm_gen = np.zeros(L, np.int64)
        # Replacement forwarding (MapPoint::GetReplaced): merged-away
        # landmark -> its survivor, so live-frame bindings can follow
        # fusion (Tracking::CheckReplacedInLastFrame).
        self.lm_replaced = np.full(L, -1, np.int64)

        # Observation incidence (covisibility source of truth).
        self.obs = np.zeros((K, L), bool)

        self._next_kf_slot = 0
        self._next_lm_slot = 0
        # Native (C++) covisibility/spanning-tree core (native/mapgraph.cpp):
        # mirrors the observation graph incrementally through the mediated
        # mutators below; code that writes `obs` directly (landmark fusion,
        # map merge) must call `mark_obs_dirty()` and the mirror is rebuilt
        # lazily on the next query. Falls back to dense numpy if no
        # toolchain. Every access to the mirror, and every `obs` write that
        # the mirror follows, holds `_graph_lock`: ctypes calls release the
        # interpreter lock, and the track, mapping and loop threads all read
        # covisibility while others write the graph.
        self._graph_lock = threading.RLock()
        self._native = None
        self._native_dirty = False
        try:
            from .. import native as native_mod

            if native_mod.load() is not None:
                self._native = native_mod.MapGraph(K, L)
        except Exception:
            self._native = None
        # IMU calibration attached by the tracker for
        # re-integration; None for visual-only maps.
        self._imu_calib = None
        # IMU init ladder progress for this map (Map::SetInertialSensor /
        # SetIniertialBA1/BA2 flags): 0 none, 1 init, 2 VIBA1, 3 VIBA2.
        self.imu_stage = 0
        self.imu_t0 = -1.0  # timestamp of first KF in the temporal chain

    # ------------------------------------------------------------------
    # Slot allocation (free-list compaction: invalid slots are reused).
    # ------------------------------------------------------------------

    def alloc_keyframe(self) -> int:
        free = np.nonzero(~self.kf_valid)[0]
        if len(free) == 0:
            raise RuntimeError("keyframe capacity exhausted")
        return int(free[0])

    def alloc_landmarks(self, count: int) -> np.ndarray:
        free = np.nonzero(~self.lm_valid)[0]
        if len(free) < count:
            raise RuntimeError("landmark capacity exhausted")
        return free[:count]

    # ------------------------------------------------------------------
    # Insertion / removal
    # ------------------------------------------------------------------

    def add_keyframe(
        self,
        R: np.ndarray,
        t: np.ndarray,
        xy: np.ndarray,
        level: np.ndarray,
        angle: np.ndarray,
        desc_packed: np.ndarray,
        feat_valid: np.ndarray,
        lm_idx: np.ndarray,
        timestamp: float,
        frame_id: int,
        ur: np.ndarray | None = None,
        depth: np.ndarray | None = None,
    ) -> int:
        k = self.alloc_keyframe()
        self.kf_gen[k] += 1
        self.kf_R[k] = R
        self.kf_t[k] = t
        self.kf_timestamp[k] = timestamp
        self.kf_frame_id[k] = frame_id
        self.kf_xy[k] = xy
        self.kf_level[k] = level
        self.kf_angle[k] = angle
        self.kf_desc[k] = desc_packed
        self.kf_feat_valid[k] = feat_valid
        self.kf_lm_idx[k] = np.where(feat_valid, lm_idx, -1)
        self.kf_ur[k] = -1.0 if ur is None else ur
        self.kf_depth[k] = -1.0 if depth is None else depth
        # Update incidence + landmark observation counts.
        seen = self.kf_lm_idx[k]
        seen = seen[seen >= 0]
        with self._graph_lock:
            self.obs[k, :] = False
            self.obs[k, seen] = True
            self.lm_obs_count[seen] += 1
            # Validity flips LAST: concurrent lock-free readers (the track
            # thread under the mapping pipeline) must never see a
            # half-initialized row behind a True validity bit.
            self.kf_valid[k] = True
            if self._native is not None and not self._native_dirty:
                self._native.add_keyframe(int(k))
                if len(seen):
                    self._native.add_observations(int(k), seen)
        return k

    def remove_keyframe(self, k: int):
        """KeyFrame::SetBadFlag equivalent (no spanning tree needed: poses
        are absolute, trajectory export keeps its own per-frame record).
        Repairs the inertial temporal chain by splicing k's raw IMU buffer
        into its successor (IMU::Preintegrated::MergePrevious,
        src/ImuTypes.cc:263)."""
        p, n = int(self.kf_prev[k]), int(self.kf_next[k])
        if n >= 0:
            if self.kf_pre_valid[k] and self.kf_pre_valid[n]:
                cap = self.cfg.imu_cap
                merged = np.concatenate(
                    [
                        self.kf_imu[k, : self.kf_imu_n[k]],
                        self.kf_imu[n, : self.kf_imu_n[n]],
                    ]
                )[-cap:]
                self.kf_imu[n, : len(merged)] = merged
                self.kf_imu_n[n] = len(merged)
                self._reintegrate(n)
            self.kf_prev[n] = p
        if p >= 0:
            self.kf_next[p] = n
        self.kf_prev[k] = self.kf_next[k] = -1
        self.kf_pre_valid[k] = False
        self.kf_imu_n[k] = 0
        seen = self.kf_lm_idx[k]
        seen = seen[seen >= 0]
        with self._graph_lock:
            self.lm_obs_count[seen] -= 1
            self.kf_valid[k] = False
            self.kf_feat_valid[k] = False
            self.kf_lm_idx[k] = -1
            self.obs[k, :] = False
            if self._native is not None and not self._native_dirty:
                self._native.remove_keyframe(int(k))

    # ------------------------------------------------------------------
    # Inertial state
    # ------------------------------------------------------------------

    def set_keyframe_inertial(
        self,
        k: int,
        vel: np.ndarray,
        bg: np.ndarray,
        ba: np.ndarray,
        prev: int,
        raw_imu: np.ndarray | None,  # (M,7) [dt, acc, gyro] since prev KF
    ):
        """Attach velocity/bias state + the temporal chain link and
        preintegrate prev->k from the raw buffer."""
        self.kf_vel[k] = vel
        self.kf_bg[k] = bg
        self.kf_ba[k] = ba
        self.kf_prev[k] = prev
        if prev >= 0:
            self.kf_next[prev] = k
        if raw_imu is not None and prev >= 0 and len(raw_imu):
            m = min(len(raw_imu), self.cfg.imu_cap)
            self.kf_imu[k, :m] = raw_imu[-m:]
            self.kf_imu_n[k] = m
            self._reintegrate(k, bias=np.concatenate([self.kf_bg[prev], self.kf_ba[prev]]))

    def _reintegrate(self, k: int, bias: np.ndarray | None = None):
        """Recompute the stored preintegration of interval prev->k from the
        raw buffer (IMU::Preintegrated::Reintegrate, src/ImuTypes.cc:193), on
        the device of the attached IMU calibration. Only the buffer's real
        rows are integrated: the reference's masked padding rows leave the
        state unchanged."""
        import torch

        from ..ops import imu as imu_ops

        if self._imu_calib is None:
            raise RuntimeError("map has no IMU calibration attached")
        if bias is None:
            bias = self.kf_pre_bias[k]
        n = int(self.kf_imu_n[k])
        dev = self._imu_calib.device
        rows = torch.from_numpy(np.ascontiguousarray(self.kf_imu[k, :n])).to(dev)
        b = torch.from_numpy(np.asarray(bias, np.float32)).to(dev)
        pre = imu_ops.preintegrate(rows[:, 1:4], rows[:, 4:7], rows[:, 0], self._imu_calib, b[:3], b[3:])
        self.store_preint(k, pre)

    def store_preint(self, k: int, pre):
        """Store a Preintegrated (tensors on any device, fetched in one
        block) into the SoA slots."""
        from ..device import fetch_block

        dR, dV, dP, C, JRg, JVg, JVa, JPg, JPa, dT, bg, ba = fetch_block(
            [pre.dR, pre.dV, pre.dP, pre.C, pre.JRg, pre.JVg, pre.JVa, pre.JPg, pre.JPa, pre.dT,
             pre.bias_gyro, pre.bias_acc]
        )
        self.kf_pre_valid[k] = True
        self.kf_pre_dR[k] = dR
        self.kf_pre_dV[k] = dV
        self.kf_pre_dP[k] = dP
        self.kf_pre_C[k] = C
        self.kf_pre_J[k] = np.stack([JRg, JVg, JVa, JPg, JPa])
        self.kf_pre_dT[k] = float(dT)
        self.kf_pre_bias[k] = np.concatenate([bg, ba])

    def stacked_preint(self, ks: np.ndarray, device=None):
        """Preintegrated record with leading dim len(ks), on `device` (the
        CPU by default)."""
        import torch

        from ..ops import imu as imu_ops

        ks = np.asarray(ks)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device or "cpu")

        return imu_ops.Preintegrated(
            dR=t(self.kf_pre_dR[ks]), dV=t(self.kf_pre_dV[ks]), dP=t(self.kf_pre_dP[ks]), C=t(self.kf_pre_C[ks]),
            JRg=t(self.kf_pre_J[ks, 0]), JVg=t(self.kf_pre_J[ks, 1]), JVa=t(self.kf_pre_J[ks, 2]),
            JPg=t(self.kf_pre_J[ks, 3]), JPa=t(self.kf_pre_J[ks, 4]), dT=t(self.kf_pre_dT[ks]),
            bias_gyro=t(self.kf_pre_bias[ks, :3]), bias_acc=t(self.kf_pre_bias[ks, 3:]),
        )

    def temporal_window(self, k: int, n: int) -> list[int]:
        """Last n keyframes ending at k through the kf_prev chain
        (LocalInertialBA window build, src/Optimizer.cc:2384-2408)."""
        out = [k]
        cur = k
        while len(out) < n and self.kf_prev[cur] >= 0:
            cur = int(self.kf_prev[cur])
            if not self.kf_valid[cur]:
                break
            out.append(cur)
        return out

    def apply_gravity_scale(self, Ryw: np.ndarray, s: float, scale_vel: bool = True):
        """Rotate the world so gravity is -z and rescale to metric
        (Map::ApplyScaledRotation, src/Map.cc:257-288): X_y = s Ryw X_w,
        Rcy = Rcw Ryw^T, tcy = s tcw, v_y = s Ryw v_w."""
        self.big_change_idx += 1
        valid_k = self.kf_valid
        self.kf_R[valid_k] = self.kf_R[valid_k] @ Ryw.T
        self.kf_t[valid_k] = s * self.kf_t[valid_k]
        self.kf_vel[valid_k] = (
            (s if scale_vel else 1.0) * self.kf_vel[valid_k] @ Ryw.T
        )
        self.lm_pos[self.lm_valid] = s * self.lm_pos[self.lm_valid] @ Ryw.T
        # Viewing normals rotate with the world (the reference re-derives
        # them via UpdateNormalAndDepth after ApplyScaledRotation; without
        # this the view-angle gate rejects nearly every projection match
        # after the gravity alignment).
        self.lm_normal[self.lm_valid] = self.lm_normal[self.lm_valid] @ Ryw.T
        self.lm_min_dist[self.lm_valid] *= s
        self.lm_max_dist[self.lm_valid] *= s

    def add_landmarks(
        self,
        pos: np.ndarray,  # (M,3)
        desc_packed: np.ndarray,  # (M,8)
        desc_i8: np.ndarray,  # (M,256)
        first_kf: int,
        level: np.ndarray,  # (M,)
        normal: np.ndarray,  # (M,3)
        min_dist: np.ndarray,
        max_dist: np.ndarray,
    ) -> np.ndarray:
        ids = self.alloc_landmarks(len(pos))
        self.lm_gen[ids] += 1
        self.lm_replaced[ids] = -1  # recycled slot: clear forwarding
        self.lm_pos[ids] = pos
        self.lm_desc[ids] = desc_packed
        self.lm_desc_i8[ids] = desc_i8
        self.lm_normal[ids] = normal
        self.lm_min_dist[ids] = min_dist
        self.lm_max_dist[ids] = max_dist
        self.lm_level[ids] = level
        self.lm_first_kf[ids] = first_kf
        self.lm_birth_fid[ids] = (
            self.kf_frame_id[first_kf] if first_kf >= 0 else -1
        )
        self.lm_obs_count[ids] = 0
        self.lm_visible[ids] = 1
        self.lm_found[ids] = 1
        # Validity LAST (lock-free reader discipline; see add_keyframe).
        self.lm_valid[ids] = True
        return ids

    def remove_landmarks(self, ids: np.ndarray):
        """MapPoint::SetBadFlag: detach from all observing keyframes."""
        ids = np.asarray(ids, np.int64)
        if len(ids) == 0:
            return
        self.lm_valid[ids] = False
        with self._graph_lock:
            # Detach observations.
            ks = np.nonzero(self.obs[:, ids].any(axis=1))[0]
            for k in ks:
                mask = np.isin(self.kf_lm_idx[k], ids)
                self.kf_lm_idx[k][mask] = -1
            self.obs[:, ids] = False
            self.lm_obs_count[ids] = 0
            if self._native is not None and not self._native_dirty:
                for lm in ids:
                    self._native.remove_landmark(int(lm))

    def replace_landmark(self, old: int, new: int):
        """Merge landmark `old` into `new` (MapPoint::Replace,
        src/MapPoint.cc:301): rebind every observation (dropping
        keyframes that already observe `new`), carry over found/visible
        counters, invalidate `old`."""
        if old == new or not self.lm_valid[old] or not self.lm_valid[new]:
            return
        with self._graph_lock:
            ks = np.nonzero(self.obs[:, old])[0]
            for ki in ks:
                for f in np.nonzero(self.kf_lm_idx[ki] == old)[0]:
                    if self.obs[ki, new]:
                        self.kf_lm_idx[ki, f] = -1  # already observes new
                    else:
                        self.kf_lm_idx[ki, f] = new
                        self.obs[ki, new] = True
                        self.lm_obs_count[new] += 1
            self.obs[:, old] = False
            self.lm_valid[old] = False
            self.lm_obs_count[old] = 0
            self.lm_replaced[old] = new
            self.mark_obs_dirty()  # direct obs writes bypass the native mirror
        self.lm_found[new] += self.lm_found[old]
        self.lm_visible[new] += self.lm_visible[old]

    def resolve_replaced(self, ids: np.ndarray) -> np.ndarray:
        """Follow replacement forwarding (bounded chain walk); returns
        the surviving landmark for each id, or the id itself."""
        ids = np.asarray(ids).copy()
        for _ in range(4):
            rep = self.lm_replaced[ids]
            hit = rep >= 0
            if not hit.any():
                break
            ids = np.where(hit, rep, ids)
        return ids

    def add_observation(self, k: int, feat_idx: np.ndarray, lm_ids: np.ndarray):
        """Bind features of KF k to landmarks (MapPoint::AddObservation +
        KeyFrame::AddMapPoint)."""
        feat_idx = np.asarray(feat_idx)
        lm_ids = np.asarray(lm_ids)
        # Drop bindings where the feature already has a landmark.
        with self._graph_lock:
            fresh = self.kf_lm_idx[k, feat_idx] < 0
            feat_idx, lm_ids = feat_idx[fresh], lm_ids[fresh]
            self.kf_lm_idx[k, feat_idx] = lm_ids
            newly = ~self.obs[k, lm_ids]
            self.obs[k, lm_ids] = True
            self.lm_obs_count[lm_ids[newly]] += 1
            if self._native is not None and not self._native_dirty:
                self._native.add_observations(int(k), lm_ids)

    # ------------------------------------------------------------------
    # Queries
    # ------------------------------------------------------------------

    def mark_obs_dirty(self):
        """Call after writing `obs` directly (landmark fusion, map merge,
        checkpoint restore): the native graph mirror rebuilds lazily."""
        with self._graph_lock:
            if self._native is not None:
                self._native_dirty = True

    def _native_sync(self):
        """Rebuild a dirty mirror from `obs` (the caller holds `_graph_lock`)."""
        if self._native is None or not self._native_dirty:
            return
        from .. import native as native_mod

        self._native = native_mod.MapGraph(self.cfg.max_keyframes, self.cfg.max_landmarks)
        for k in np.nonzero(self.kf_valid)[0]:
            self._native.add_keyframe(int(k))
            lms = np.nonzero(self.obs[k])[0]
            if len(lms):
                self._native.add_observations(int(k), lms)
        self._native_dirty = False

    def covisibility_weights(self, k: int) -> np.ndarray:
        """(K,) number of landmarks shared with keyframe k
        (KeyFrame::UpdateConnections weight computation). Served by the
        native incremental graph when built; dense matmul fallback."""
        with self._graph_lock:
            if self._native is not None:
                self._native_sync()
                w = self._native.covis_row(int(k))
                w[~self.kf_valid] = 0
                return w
            w = self.obs.astype(np.int32) @ self.obs[k].astype(np.int32)
        w[k] = 0
        w[~self.kf_valid] = 0
        return w

    def covisible_keyframes(self, k: int, min_weight: int = 15, top: int | None = None):
        w = self.covisibility_weights(k)
        ids = np.nonzero(w >= min_weight)[0]
        ids = ids[np.argsort(-w[ids])]
        if top is not None:
            ids = ids[:top]
        return ids, w[ids]

    def local_map_landmarks(self, kf_ids: np.ndarray) -> np.ndarray:
        """Union of landmark ids observed by the given keyframes."""
        if len(kf_ids) == 0:
            return np.zeros(0, np.int64)
        mask = self.obs[kf_ids].any(axis=0) & self.lm_valid
        return np.nonzero(mask)[0]

    def n_keyframes(self) -> int:
        return int(self.kf_valid.sum())

    def n_landmarks(self) -> int:
        return int(self.lm_valid.sum())

    MAX_STAT_OBS = 16  # observations per landmark considered for stats

    def update_landmark_stats(self, ids: np.ndarray):
        """Recompute representative descriptor, normal and scale band for
        the given landmarks (MapPoint::ComputeDistinctiveDescriptors +
        UpdateNormalAndDepth, src/MapPoint.cc:376-541). Fully vectorized
        over (landmark, observation) pairs — this runs once per keyframe
        insertion on the mapping stage and a Python loop here stalls the
        pipeline's track thread through the GIL."""
        ids = np.asarray(ids)
        ids = ids[self.lm_valid[ids]] if len(ids) else ids
        if len(ids) == 0:
            return
        obs_sub = self.obs[:, ids]  # (K, n)
        ks_all = np.nonzero(obs_sub.any(axis=1))[0]
        if len(ks_all) == 0:
            return
        # Feature index of each (kf, lm) pair: one landmark->column
        # lookup + one (K_obs, n_features) gather over the observing
        # keyframes' binding rows (a per-KF row of max_landmarks LUT
        # slots here cost ~10 ms of GIL-holding host time per call).
        col_of = np.full(self.cfg.max_landmarks, -1, np.int32)
        col_of[ids] = np.arange(len(ids), dtype=np.int32)
        lm_sub = self.kf_lm_idx[ks_all]  # (K_obs, F)
        ci = np.where(lm_sub >= 0, col_of[np.maximum(lm_sub, 0)], -1)
        rows, feats = np.nonzero(ci >= 0)
        cols = ci[rows, feats]
        if len(rows) == 0:
            return
        p_kf = ks_all[rows]

        n = len(ids)
        M = self.MAX_STAT_OBS
        # Rank pairs within each landmark (stable order by kf slot).
        order = np.lexsort((p_kf, cols))
        cols_s, kf_s, f_s = cols[order], p_kf[order], feats[order]
        starts = np.searchsorted(cols_s, np.arange(n))
        counts = np.diff(np.append(starts, len(cols_s)))
        rank = np.arange(len(cols_s)) - starts[cols_s]
        keep = rank < M
        cols_k, kf_k, f_k, rank_k = cols_s[keep], kf_s[keep], f_s[keep], rank[keep]

        # Padded per-landmark observation tables.
        D = np.zeros((n, M, 8), np.uint32)  # packed descriptors
        Lv = np.zeros((n, M), np.int32)
        Cc = np.zeros((n, M, 3), np.float32)  # camera centers
        Vm = np.zeros((n, M), bool)
        D[cols_k, rank_k] = self.kf_desc[kf_k, f_k]
        Lv[cols_k, rank_k] = self.kf_level[kf_k, f_k]
        Cc[cols_k, rank_k] = -np.einsum(
            "pji,pj->pi", self.kf_R[kf_k], self.kf_t[kf_k]
        )
        Vm[cols_k, rank_k] = True
        n_obs = Vm.sum(axis=1)
        has = n_obs > 0
        if not has.any():
            return

        # Min-median-Hamming representative descriptor per landmark.
        # Popcount via byte LUT (unpackbits would materialize an 8x
        # larger intermediate) and median via sort + lower-middle pick
        # (np.nanmedian partitions per row and dominated the mapping
        # stage's host time at ~45 ms per call). The reference's median
        # is also the lower middle: vDists[0.5*(N-1)],
        # src/MapPoint.cc:456.
        x = D[:, :, None, :] ^ D[:, None, :, :]  # (n,M,M,8)
        dist = _POPCOUNT8[x.view(np.uint8)].sum(-1, dtype=np.uint16)
        dist = dist.astype(np.float32)
        pair_ok = Vm[:, :, None] & Vm[:, None, :]
        dist = np.where(pair_ok, dist, np.inf)
        ds = np.sort(dist, axis=2)  # invalid entries sort to the end
        mid = np.maximum((n_obs - 1) // 2, 0)  # lower middle per landmark
        med = np.take_along_axis(
            ds, np.broadcast_to(mid[:, None, None], (n, M, 1)), axis=2
        )[..., 0]
        med = np.where(Vm, med, np.inf)
        best = np.argmin(med, axis=1)  # (n,)
        bd = D[np.arange(n), best]  # (n,8)
        sel = ids[has]
        self.lm_desc[sel] = bd[has]
        self.lm_desc_i8[sel] = np.unpackbits(
            bd[has].view(np.uint8), axis=-1, bitorder="little"
        ).astype(np.int8)

        # Viewing normal: mean unit direction camera->landmark.
        dirs = self.lm_pos[ids][:, None, :] - Cc  # (n,M,3)
        dirs = dirs / np.maximum(
            np.linalg.norm(dirs, axis=-1, keepdims=True), 1e-9
        )
        normal = (dirs * Vm[:, :, None]).sum(axis=1) / np.maximum(
            n_obs[:, None], 1
        )
        nn = np.linalg.norm(normal, axis=-1, keepdims=True)
        normal = np.where(nn > 1e-9, normal / np.maximum(nn, 1e-9), normal)
        self.lm_normal[sel] = normal[has]

        # Scale band from the reference observation (the last one in
        # keyframe-slot order = rank n_obs-1, matching the loop's ks[-1]).
        ref = np.clip(n_obs - 1, 0, M - 1)
        lvl = Lv[np.arange(n), ref]
        dist_ref = np.linalg.norm(
            self.lm_pos[ids] - Cc[np.arange(n), ref], axis=-1
        )
        self.lm_max_dist[sel] = (dist_ref * SCALE_FACTOR ** lvl * 1.2)[has]
        self.lm_min_dist[sel] = (
            dist_ref * SCALE_FACTOR ** (lvl - N_LEVELS + 1) / 1.2
        )[has]
        self.lm_level[sel] = lvl[has]
