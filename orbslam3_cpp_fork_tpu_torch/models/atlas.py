"""Atlas: the multi-map container (port of models/atlas.py).

The SLAM session owns a set of disconnected maps and tracks in the active
one. When tracking is lost beyond recovery a fresh map is spawned
(Tracking::CreateMapInAtlas) and the old one is kept; when place
recognition later finds the current position inside a stored map, the two
are welded together (LoopClosing::MergeLocal).

Each map is a fixed-capacity MapState (SoA arrays), so a merge is an
array-to-array transplant with index remapping: two gather/scatter passes
(keyframes, landmarks) plus a Sim(3) applied to the moved block. It is host
numpy, as in the reference, and bit for bit the same: that includes ROADMAP
R14, the reference's double count of the moved landmarks' observations (it
copies the source's `lm_obs_count` and `add_keyframe` counts every moved
observation again), which the port copies until a PR of its own repairs it
in both.
"""

from __future__ import annotations

import logging

import numpy as np

from .map_state import MapConfig, MapState

log = logging.getLogger("orbslam3_torch.atlas")


class Atlas:
    def __init__(self, cfg: MapConfig, imu_calib=None):
        self.cfg = cfg
        self.imu_calib = imu_calib
        self.maps: list[MapState] = [MapState(cfg, map_id=0)]
        self.maps[0]._imu_calib = imu_calib
        self.active_idx = 0
        self._next_map_id = 1

    @property
    def active(self) -> MapState:
        return self.maps[self.active_idx]

    def create_new_map(self) -> MapState:
        """CreateNewMap: keep the old map, activate a fresh one."""
        m = MapState(self.cfg, map_id=self._next_map_id)
        m._imu_calib = self.imu_calib
        self._next_map_id += 1
        self.maps.append(m)
        self.active_idx = len(self.maps) - 1
        log.info("atlas: new map %d (now %d maps)", m.map_id, len(self.maps))
        return m

    def n_maps(self) -> int:
        return len(self.maps)

    # ------------------------------------------------------------------

    def merge_into(
        self,
        dst_idx: int,
        src_idx: int,
        M: tuple[float, np.ndarray, np.ndarray],
    ) -> tuple[dict[int, int], dict[int, int]]:
        """Weld map `src` into map `dst`.

        M = (s, R, t) is the Sim(3) mapping DST-world coordinates to
        SRC-world coordinates (w_dst -> w_src): a source keyframe pose
        T_i_wsrc becomes T_i_wdst = T_i_wsrc o M, and source landmarks move
        by X_dst = M^-1(X_src).

        Returns (kf_remap, lm_remap): source slot -> destination slot. The
        destination becomes the active map; the source map leaves the Atlas.
        Every write that the covisibility graph mirrors goes through
        `add_keyframe`, under the destination's graph lock."""
        dst = self.maps[dst_idx]
        src = self.maps[src_idx]
        s, R, t = M
        R = np.asarray(R, np.float32)
        t = np.asarray(t, np.float32)
        s = float(s)

        src_kfs = np.nonzero(src.kf_valid)[0]
        src_lms = np.nonzero(src.lm_valid)[0]

        # Landmarks: X_dst = M^-1(X_src) = R^T (X_src - t) / s.
        lm_remap: dict[int, int] = {}
        if len(src_lms):
            X_dst = ((src.lm_pos[src_lms] - t) @ R) / s
            ids = dst.alloc_landmarks(len(src_lms))
            dst.lm_valid[ids] = True
            dst.lm_pos[ids] = X_dst
            dst.lm_desc[ids] = src.lm_desc[src_lms]
            dst.lm_desc_i8[ids] = src.lm_desc_i8[src_lms]
            # Normals rotate; the scale band re-scales by 1/s.
            dst.lm_normal[ids] = src.lm_normal[src_lms] @ R
            dst.lm_min_dist[ids] = src.lm_min_dist[src_lms] / s
            dst.lm_max_dist[ids] = src.lm_max_dist[src_lms] / s
            dst.lm_level[ids] = src.lm_level[src_lms]
            dst.lm_visible[ids] = src.lm_visible[src_lms]
            dst.lm_found[ids] = src.lm_found[src_lms]
            dst.lm_first_kf[ids] = -1  # ages out of "recent" culling
            dst.lm_birth_fid[ids] = -1  # (recycled slots hold stale stamps)
            # add_keyframe below counts these observations again (R14).
            dst.lm_obs_count[ids] = src.lm_obs_count[src_lms]
            lm_remap = {int(a): int(b) for a, b in zip(src_lms, ids)}

        # Keyframes: S_i_wdst = T_i_wsrc o M = (s, R_i R, R_i t + t_i), stored
        # back as SE(3) through t / s.
        kf_remap: dict[int, int] = {}
        for k in src_kfs:
            R_new = src.kf_R[k] @ R
            t_new = (src.kf_R[k] @ t + src.kf_t[k]) / s
            lm_idx = src.kf_lm_idx[k].copy()
            bound = lm_idx >= 0
            lm_idx[bound] = np.asarray([lm_remap.get(int(x), -1) for x in lm_idx[bound]], np.int32)
            knew = dst.add_keyframe(
                R_new.astype(np.float32), t_new.astype(np.float32),
                src.kf_xy[k], src.kf_level[k], src.kf_angle[k],
                src.kf_desc[k], src.kf_feat_valid[k], lm_idx,
                float(src.kf_timestamp[k]), int(src.kf_frame_id[k]),
                ur=src.kf_ur[k], depth=src.kf_depth[k],
            )
            kf_remap[int(k)] = int(knew)

        # Inertial state rides along: velocities rotate into the dst world
        # and rescale (v_dst = R^T v_src / s); the temporal chain and the
        # preintegrations transplant unchanged (body-frame quantities).
        dst._imu_calib = dst._imu_calib or src._imu_calib
        for k, knew in kf_remap.items():
            dst.kf_vel[knew] = (src.kf_vel[k] @ R) / s
            dst.kf_bg[knew] = src.kf_bg[k]
            dst.kf_ba[knew] = src.kf_ba[k]
            p = int(src.kf_prev[k])
            n = int(src.kf_next[k])
            dst.kf_prev[knew] = kf_remap.get(p, -1) if p >= 0 else -1
            dst.kf_next[knew] = kf_remap.get(n, -1) if n >= 0 else -1
            dst.kf_pre_valid[knew] = src.kf_pre_valid[k]
            dst.kf_pre_dR[knew] = src.kf_pre_dR[k]
            dst.kf_pre_dV[knew] = src.kf_pre_dV[k]
            dst.kf_pre_dP[knew] = src.kf_pre_dP[k]
            dst.kf_pre_C[knew] = src.kf_pre_C[k]
            dst.kf_pre_J[knew] = src.kf_pre_J[k]
            dst.kf_pre_dT[knew] = src.kf_pre_dT[k]
            dst.kf_pre_bias[knew] = src.kf_pre_bias[k]
            dst.kf_imu[knew] = src.kf_imu[k]
            dst.kf_imu_n[knew] = src.kf_imu_n[k]

        dst.imu_stage = max(dst.imu_stage, src.imu_stage)
        if dst.imu_t0 < 0:
            dst.imu_t0 = src.imu_t0

        self.maps.pop(src_idx)
        self.active_idx = dst_idx - 1 if dst_idx > src_idx else dst_idx
        dst.big_change_idx += 1
        log.info(
            "atlas: merged map %d into map %d (%d KFs, %d landmarks moved)",
            src.map_id, dst.map_id, len(src_kfs), len(src_lms),
        )
        return kf_remap, lm_remap
