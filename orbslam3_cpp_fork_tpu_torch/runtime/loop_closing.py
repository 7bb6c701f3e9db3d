"""Loop detection, correction and the Atlas merge proposal (port of
runtime/loop_closing.py; LoopClosing.cc).

Host-orchestrated: every heavy stage is a device program on the tracker's
device (signature word assignment, descriptor matching, Sim(3) RANSAC, Sim(3)
refinement, guided projection, the essential-graph solve), the bookkeeping
is numpy.

Pipeline per keyframe (NewDetectCommonRegions + CorrectLoop / MergeLocal):
 1. guards: enough keyframes, distance from the last correction;
 2. a KeyFrameDatabase query over every map of the Atlas, excluding the
    temporally recent keyframes; database rows are (map, keyframe slot)
    pairs (`keyframe_database.row_of`);
 3. geometric validation of each candidate as ONE device program
    (`_validate_candidate_fused`): descriptor match on landmark-bound
    features -> Sim(3) RANSAC on matched camera-frame points -> Sim(3)
    refinement -> guided projection of the candidate window's landmarks;
    a candidate in another map reads its rows from that map's arrays;
 4. temporal consistency: a hypothesis must validate on
    `LoopConfig.consecutive_kfs` consecutive keyframes; each new keyframe
    first re-validates the pending hypothesis through the tracked relative
    motion and falls back to a fresh query when none is pending;
 5. a confirmed hypothesis in the active map is corrected here: propagate
    the corrective Sim(3) through the covisible window, re-anchor its
    landmarks, fuse duplicates against the loop window (SearchAndFuse), then
    the essential graph over all keyframes (4-DoF once the map's IMU is
    initialized). One in another map becomes a
    merge proposal that the tracker executes (`Tracker._execute_merge`),
    whose last stage is `optimize_essential_graph_merge`.

Randomness: the Sim(3) RANSAC draws its index sets from the closer's own
`torch.Generator` (`_validate_candidate_fused` takes the raw draws).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time

import numpy as np
import torch

from ..device import fetch_block
from ..models.map_state import LEVEL_SIGMA2, N_LEVELS, SCALE_FACTOR, MapState
from ..ops import matching, ransac
from ..ops.camera import true_div
from ..optim import pose_graph, sim3_opt
from .keyframe_database import MAX_MAPS, KeyFrameDatabase, row_of, split_row
from .tracker import _scale_pow
from .tracker import _unpack_desc as _unpack_bits

log = logging.getLogger("orbslam3_torch.loop")

# Padded landmark capacity of the guided-projection verification (fixed
# shapes keep the programs capturable).
_PROJ_CAP = 4096
# RANSAC hypotheses of the Sim(3) validation (the reference's default).
N_HYP_SIM3 = 128
_LOG_SCALE = torch.log(torch.tensor(SCALE_FACTOR, dtype=torch.float32)).item()


def _match_loop_pair(bits_k, bound_k, angle_k, bits_c, bound_c, angle_c):
    """SearchByBoW-analog matching between two keyframes' landmark-bound
    features (ratio 0.75, rotation histogram)."""
    dist = matching.hamming_matrix(bits_k, bits_c)
    idx, ok = matching.match_nn(dist, bound_k, bound_c, max_dist=matching.TH_LOW, ratio=0.75, cross_check=True)
    ok = matching.rotation_consistency(angle_k, angle_c, idx, ok)
    return idx, ok


def _proj_count(lm_desc, okp, uv, lvl, rad, kf_desc, kf_xy, kf_level, kf_valid) -> torch.Tensor:
    """Guided-projection match count (a 0-dim tensor)."""
    _, mok = matching.search_by_projection(
        _unpack_bits(lm_desc), okp, uv, lvl, _unpack_bits(kf_desc), kf_xy, kf_level, kf_valid, rad,
        max_dist=matching.TH_HIGH, ratio=0.95, level_band=1,
    )
    return torch.sum(mok.to(torch.int32))


def _validate_candidate_fused(
    bits_k, bound_k, angle_k, pc_k_all, uv_k_all, sig_k_all,
    bits_c, bound_c, angle_c, pc_c_all, uv_c_all, sig_c_all,
    w_desc, w_pos, w_maxd, w_ok,
    R_c, t_c,
    kf_desc_k, kf_xy_k, kf_level_k, kf_valid_k,
    draws, fx, fy, cx, cy, width, height,
    fix_scale: bool,
) -> dict:
    """The whole geometric validation of a loop candidate as one device
    program: BoW-style matching -> Sim(3) RANSAC -> Sim(3) refinement ->
    guided projection count (Sim3Solver + OptimizeSim3 + SearchByProjection).
    Downstream stages compute on garbage when an upstream gate fails; the
    host applies the thresholds to the returned counters.

    pc_*_all / uv_*_all / sig_*_all are per-feature tables of the bound
    landmark (camera-frame position, centered pixel, sigma^2; zeros where
    unbound); w_* are the candidate window's landmarks padded to a fixed cap.
    `draws` (n_hyp, 3) are the RANSAC's raw draws in [0, N), mapped onto the
    matched features as `ransac.sample_indices` does."""
    dist = matching.hamming_matrix(bits_k, bits_c)
    idx, ok = matching.match_nn(dist, bound_k, bound_c, max_dist=matching.TH_LOW, ratio=0.75, cross_check=True)
    ok = matching.rotation_consistency(angle_k, angle_c, idx, ok)
    n_bow = torch.sum(ok.to(torch.int32))

    pc_c = pc_c_all[idx]
    s0, R0, t0, _, n_ransac, ok_r = ransac.sim3_ransac(
        pc_c, pc_k_all, ok, ransac.indices_from_draws(draws, ok), fix_scale=fix_scale
    )
    res = sim3_opt.optimize_sim3(
        s0, R0, t0, pc_k_all, pc_c, uv_k_all, uv_c_all[idx], sig_k_all, sig_c_all[idx], ok, fx, fy,
        fix_scale=fix_scale,
    )
    s, R, t = res.s, res.R, res.t

    # Corrected pose S_kw = S_kc o T_cw; project the candidate window.
    R_kw = R @ R_c
    t_kw = s * (R @ t_c) + t
    pc = (w_pos @ R_kw.T) * s + t_kw
    z = pc[:, 2]
    zs = torch.clamp_min(z, 1e-6)
    u = fx * pc[:, 0] / zs + cx
    v = fy * pc[:, 1] / zs + cy
    okp = w_ok & (z > 0.05) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    uv = torch.stack([u, v], -1)
    # PredictScale + the scale-banded radius, distances in candidate-map units.
    dist_w = torch.linalg.vector_norm(pc, dim=-1) / torch.clamp_min(s, 1e-9)
    ratio = torch.clamp_min(w_maxd / torch.clamp_min(dist_w, 1e-9), 1e-9)
    lvl = torch.clamp(torch.ceil(true_div(torch.log(ratio), _LOG_SCALE)), 0, N_LEVELS - 1).to(torch.int32)
    rad = 8.0 * _scale_pow(lvl)
    _, mok_p = matching.search_by_projection(
        _unpack_bits(w_desc), okp, uv, lvl, _unpack_bits(kf_desc_k), kf_xy_k, kf_level_k, kf_valid_k, rad,
        max_dist=matching.TH_HIGH, ratio=0.95, level_band=1,
    )
    return dict(
        n_bow=n_bow, ok_r=ok_r, n_ransac=n_ransac, s=s, R=R, t=t, n_opt=res.n_inliers,
        n_proj=torch.sum(mok_p.to(torch.int32)),
    )


@dataclasses.dataclass
class LoopConfig:
    min_kfs: int = 12  # guard (src/LoopClosing.cc:361)
    min_bow_matches: int = 20  # nBoWMatches
    min_ransac_inliers: int = 12  # RANSAC is before the refinement
    min_sim3_inliers: int = 20  # nSim3Inliers
    min_proj_weak: int = 50  # nProjMatches
    min_proj_strong: int = 80  # nProjOptMatches
    covis_edge_weight: int = 100  # minFeat of essential-graph covisibility edges
    kf_gap_after_loop: int = 10
    # Temporal consistency: the same region must validate on this many
    # consecutive keyframes before correction.
    consecutive_kfs: int = 3
    fix_scale: bool = False  # stereo/RGB-D/inertial
    # Fallback retrieval-score floor when too few rows exist for the
    # relative floor (KeyFrameDatabase.adaptive_floor).
    min_candidate_score: float = 0.12
    loop_floor_z: float = 2.0
    # Absolute lower clamp on the derived floor.
    min_floor: float = 0.03


def _sim3_mul_np(s1, R1, t1, s2, R2, t2):
    """Sim(3) composition on the host (action x -> s R x + t)."""
    return float(s1) * float(s2), R1 @ R2, float(s1) * (R1 @ t2) + t1


def _sim3_inv_np(s, R, t):
    Rt = R.T
    return 1.0 / float(s), Rt, -(Rt @ t) / float(s)


def _covis_pairs(m: MapState, order: np.ndarray, min_weight: int):
    """(a_slot, b_slot) pairs (b_slot >= a_slot+2) with covisibility >=
    min_weight, by one float32 matmul over the incidence rows."""
    ob = m.obs[order].astype(np.float32)
    Wm = ob @ ob.T
    iu = np.triu_indices(len(order), 2)
    hit = Wm[iu] >= min_weight
    return iu[0][hit], iu[1][hit]


def optimize_essential_graph_merge(
    m: MapState,
    free_ids,
    R_snap: np.ndarray,
    t_snap: np.ndarray,
    mode: str,
    covis_edge_weight: int = 100,
    iters: int = 12,
    device: torch.device | str = "cuda",
):
    """Merge-variant essential graph (the merge overload of
    Optimizer::OptimizeEssentialGraph): after a weld and its welding BA have
    corrected the window around the seam, this pose graph carries the
    correction to the rest of the merged-in map.

    Vertices: every valid keyframe, seeded at its current pose. Fixed: all but
    `free_ids` (the source map's keyframes outside the window). Edge
    measurements come from the pre-welding-BA snapshot (R_snap, t_snap), the
    merged-in map's internally consistent geometry. Landmarks first observed
    by a free keyframe ride its correction. The solve is the exact-shape
    `pose_graph.optimize_pose_graph` on `device` (ROADMAP R4)."""
    free_ids = [int(x) for x in free_ids]
    free_set = set(free_ids)
    valid = np.nonzero(m.kf_valid)[0]
    if len(valid) < 3 or not free_set:
        return
    order = valid[np.argsort(m.kf_frame_id[valid], kind="stable")]
    K = len(order)
    slot = {int(kf): i for i, kf in enumerate(order)}

    ei, ej, es, eR, et = [], [], [], [], []

    def add_edge_snap(a, b):
        if a not in free_set and b not in free_set:
            return  # both ends fixed: no information
        sm, Rm, tm = _sim3_mul_np(1.0, R_snap[b], t_snap[b], *_sim3_inv_np(1.0, R_snap[a], t_snap[a]))
        ei.append(slot[a]); ej.append(slot[b])  # noqa: E702
        es.append(float(sm)); eR.append(Rm); et.append(tm)  # noqa: E702

    # The temporal chain over the merged map and the covisibility edges.
    for a, b in zip(order[:-1], order[1:]):
        add_edge_snap(int(a), int(b))
    for ii, jj in zip(*_covis_pairs(m, order, covis_edge_weight)):
        add_edge_snap(int(order[ii]), int(order[jj]))
    if not ei:
        return

    fixed = np.ones(K, bool)
    for f in free_ids:
        if f in slot:
            fixed[slot[f]] = False
    dev = torch.device(device)

    def put(x, dtype=None):
        a = np.ascontiguousarray(x) if dtype is None else np.ascontiguousarray(x, dtype)
        return torch.from_numpy(a).to(dev)

    res = pose_graph.optimize_pose_graph(
        put(np.ones(K, np.float32)), put(m.kf_R[order]), put(m.kf_t[order]), put(np.ones(K, bool)), put(fixed),
        put(np.asarray(ei), np.int64), put(np.asarray(ej), np.int64), put(np.asarray(es), np.float32),
        put(np.stack(eR), np.float32), put(np.stack(et), np.float32), put(np.ones(len(ei)), np.float32),
        put(pose_graph.FREE_DIMS[mode]), iters=iters,
    )
    s_n, R_n, t_n, cost = fetch_block((res.s, res.R, res.t, res.cost))

    # Re-anchor the landmarks of free keyframes: X' = S_new^-1(S_snap(X)).
    lm_ids = np.nonzero(m.lm_valid)[0]
    if len(lm_ids):
        obs_sub = m.obs[order][:, lm_ids]
        seen = obs_sub.any(axis=0)
        first_slot = np.argmax(obs_sub, axis=0)
        for sl in np.unique(first_slot[seen]):
            i = int(order[sl])
            if i not in free_set:
                continue
            selm = lm_ids[(first_slot == sl) & seen]
            pc = m.lm_pos[selm] @ R_snap[i].T + t_snap[i]
            sinv, Rinv, tinv = _sim3_inv_np(s_n[sl], R_n[sl], t_n[sl])
            m.lm_pos[selm] = (pc @ Rinv.T) * sinv + tinv

    # The optimized poses of the free set back as SE(3) (t / s).
    for f in free_ids:
        if f in slot:
            sl = slot[f]
            m.kf_R[f] = R_n[sl]
            m.kf_t[f] = t_n[sl] / s_n[sl]
    log.info("merge essential graph: %d free / %d KFs, %d edges, cost %.3f", len(free_ids), K, len(ei), float(cost))


class LoopCloser:
    def __init__(
        self,
        atlas,
        kfdb: KeyFrameDatabase,
        fx: float, fy: float, cx: float, cy: float,
        device: torch.device,
        cfg: LoopConfig | None = None,
    ):
        self.atlas = atlas
        self.kfdb = kfdb
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.device = torch.device(device)
        self.cfg = LoopConfig() if cfg is None else cfg
        self.kf_store = None  # shared DeviceKFStore (set by the Tracker)
        self.last_loop_kf = -10**9
        # (candidate gid, count, (s, R, t), kf)
        self.pending: tuple | None = None
        self.n_loops_closed = 0
        self.n_merges = 0  # merge proposals handed to the tracker
        # One dict per closed loop: frame ids and the corrective scale.
        self.events: list[dict] = []
        # Whole-map BA after a correction, bound by the Tracker; called as
        # hook(kf, candidate).
        self.global_ba_hook = None
        # Bound by the Tracker; called under the lock as hook(map, kfs,
        # scales) after an essential graph that rescaled keyframes (Sim(3)
        # mode), with each keyframe's corrective scale.
        self.rescale_hook = None
        # Map mutation lock, shared with the Tracker (held through a
        # correction, as Map::mMutexMapUpdate through CorrectLoop).
        self.lock = contextlib.nullcontext()
        # Persisted loop edges: (map_id, i, j, (s, R, t)).
        self.loop_edges: list[tuple[int, int, int, tuple]] = []
        # The Sim(3) RANSAC's draws.
        self.rng = torch.Generator().manual_seed(7)
        # Seconds spent in validation fetches (they wait for the tracking
        # work queued on the stream before them) and their count.
        self.validate_s: list[float] = []

    @property
    def m(self) -> MapState:
        return self.atlas.active

    def _put(self, x, dtype=None) -> torch.Tensor:
        a = np.ascontiguousarray(x) if dtype is None else np.ascontiguousarray(x, dtype)
        return torch.from_numpy(a).to(self.device)

    def on_merge(self, src_map_id: int, dst_map_id: int, kf_remap: dict):
        """Carry the loop edges of a merged-away map over to its destination."""
        edges = []
        for (mid, i, j, S) in self.loop_edges:
            if mid == src_map_id:
                if i in kf_remap and j in kf_remap:
                    edges.append((dst_map_id, kf_remap[i], kf_remap[j], S))
            else:
                edges.append((mid, i, j, S))
        self.loop_edges = edges

    # ------------------------------------------------------------------

    def _dev_rows(self, k: int, m_c: MapState):
        """The shared device keyframe store with row k in sync, or None when
        the keyframe lives in a map that is not active (a merge candidate) or
        no store is attached: callers then upload the map's host rows."""
        st = self.kf_store
        if st is None or m_c is not self.m:
            return None
        with self.lock:
            st.sync(m_c, [int(k)])
        return st

    def _kf_rows(self, k: int, m: MapState):
        """(packed desc, xy, level, valid) of keyframe k on the device: copies
        of the shared store's rows, enqueued before any later reuse of the
        slot can overwrite them."""
        st = self._dev_rows(k, m)
        if st is not None:
            with self.lock:
                return st.desc[k].clone(), st.xy[k].clone(), st.level[k].clone(), st.valid[k].clone()
        return (
            self._put(m.kf_desc[k], np.int64), self._put(m.kf_xy[k]),
            self._put(m.kf_level[k]), self._put(m.kf_feat_valid[k]),
        )

    def _kf_bits(self, k: int, m: MapState | None = None) -> np.ndarray:
        m = self.m if m is None else m
        return np.unpackbits(m.kf_desc[k].view(np.uint8), axis=-1, bitorder="little").astype(np.int8)

    def _sigma2(self, level: np.ndarray) -> np.ndarray:
        return LEVEL_SIGMA2[np.clip(level, 0, N_LEVELS - 1)]

    @staticmethod
    def _predict_level_radius(max_dist, dist, r_base):
        """MapPoint::PredictScale + the matcher's scale-dependent search
        radius (radius = th * scaleFactor^level)."""
        ratio = np.maximum(max_dist / np.maximum(dist, 1e-9), 1e-9)
        level = np.clip(np.ceil(np.log(ratio) / np.log(SCALE_FACTOR)), 0, N_LEVELS - 1).astype(np.int32)
        radius = (r_base * SCALE_FACTOR ** level).astype(np.float32)
        return level, radius

    def process_keyframe(self, k: int, detect: bool = True):
        """Detect and (maybe) correct a loop at the new keyframe k, then
        register it in the database (the reference adds the current keyframe
        at the end of each detection attempt). `detect=False` re-validates a
        pending hypothesis only. Returns None, or a merge proposal
        (dst_map_id, candidate, (s, R, t), src_map_id, k) for the tracker to
        execute."""
        m = self.m
        bits = self._kf_bits(k)
        hist = self.kfdb.histogram(bits, m.kf_feat_valid[k])
        proposal = None
        imu_ready = m._imu_calib is None or m.imu_stage >= 3
        try:
            if (
                imu_ready
                and m.n_keyframes() >= self.cfg.min_kfs
                and k - self.last_loop_kf > self.cfg.kf_gap_after_loop
                and (detect or self.pending is not None)
            ):
                proposal = self._detect_and_correct(k, bits, hist, fresh=detect)
        finally:
            self.kfdb.add(row_of(m.map_id, k, m.cfg.max_keyframes), bits, m.kf_feat_valid[k], hist=hist)
        return proposal

    # ------------------------------------------------------------------
    # Detection
    # ------------------------------------------------------------------

    def _detect_and_correct(self, k: int, bits: np.ndarray, hist: np.ndarray | None = None, fresh: bool = True):
        """Returns a merge proposal (dst_map_id, c, (s, R, t), src_map_id, k)
        or None. Detections in the active map are corrected in place (loop
        closing); detections in another map become merge proposals (the
        loop-vs-merge split of NewDetectCommonRegions). A hypothesis must
        validate on `consecutive_kfs` consecutive keyframes; each keyframe
        first re-validates the pending one (DetectAndReffineSim3FromLastKF)
        and falls back to a fresh database query when there is none."""
        m = self.m
        max_k = m.cfg.max_keyframes
        maps_by_ns = {mm.map_id % MAX_MAPS: mm for mm in self.atlas.maps}

        def act(g, m_c, c, s, R, t, n_proj, count):
            """Confirmed enough? correct or propose, else keep pending."""
            if count < self.cfg.consecutive_kfs:
                self.pending = (int(g), count, (float(s), np.asarray(R), np.asarray(t)), k)
                return None
            self.pending = None
            if m_c is m:
                self._correct_loop(k, c, s, R, t)
                return None
            self.n_merges += 1
            log.info("map merge detected: KF %d (map %d) -> KF %d (map %d), %d proj",
                     k, m.map_id, c, m_c.map_id, n_proj)
            # The proposal crosses a thread boundary (the track thread
            # executes it at its next frame): maps are named by id, never by
            # Atlas index, which spawns and merges reorder.
            return m_c.map_id, c, (s, R, t), m.map_id, k

        # 1) Re-validate the pending hypothesis by propagating its Sim(3)
        # through the tracked camera motion and re-counting guided
        # projection matches.
        if self.pending is not None:
            g, count, (sp, Rp, tp), last_k = self.pending
            ns, c = split_row(g, max_k)
            m_c = maps_by_ns.get(ns)
            if m_c is not None and m.kf_valid[last_k] and m_c.kf_valid[c]:
                # S_k'c = T_k'k o S_kc with T_k'k from the current poses.
                Tk = _sim3_mul_np(1.0, m.kf_R[k], m.kf_t[k], *_sim3_inv_np(1.0, m.kf_R[last_k], m.kf_t[last_k]))
                s2, R2, t2 = _sim3_mul_np(*Tk, sp, Rp, tp)
                n_proj = self._projection_matches(k, c, s2, R2, t2, m_c)
                if n_proj >= self.cfg.min_proj_weak:
                    count += 1
                    if count >= self.cfg.consecutive_kfs:
                        # Refine once more at full strength before acting;
                        # keep the propagated Sim(3) if the refinement is
                        # rejected.
                        res = self._validate_candidate(k, c, m_c)
                        if res is not None:
                            s2, R2, t2, n_proj = res
                    return act(g, m_c, c, s2, R2, t2, n_proj, count)
                log.info("pending loop hypothesis KF %d -> %d dropped at KF %d (%d proj)", last_k, c, k, n_proj)
            # The hypothesis did not survive this keyframe: drop it and fall
            # through to a fresh detection in the same call.
            self.pending = None

        if not fresh:
            return None
        # 2) Fresh detection. Exclusion set: temporally recent keyframes and
        # k itself (a temporally distant covisible keyframe is an already
        # verified loop whose drift still needs the correction).
        recent = np.nonzero(m.kf_valid & (m.kf_frame_id > m.kf_frame_id[k] - 3 * 30))[0]
        exclude = np.asarray([row_of(m.map_id, x, max_k) for x in [k, *recent]])
        if hist is None:
            return None

        def covis_gids(g):
            ns2, c2 = split_row(g, max_k)
            mm = maps_by_ns.get(ns2)
            if mm is None or not mm.kf_valid[c2]:
                return []
            return [row_of(ns2, x, max_k) for x in mm.covisible_keyframes(c2, min_weight=1, top=10)[0]]

        gids, scores = self.kfdb.query_groups(hist, covis_gids, exclude, n_best=3)
        # Relative validation floor (LoopConfig.loop_floor_z).
        floor = self.cfg.min_candidate_score
        adaptive = self.kfdb.adaptive_floor(hist, exclude=exclude, z=self.cfg.loop_floor_z)
        if adaptive is not None:
            floor = max(self.cfg.min_floor, adaptive)
        for g, sc in zip(gids, scores):
            if float(sc) < floor:
                continue  # aliasing noise: not worth a validation
            ns, c = split_row(g, max_k)
            m_c = maps_by_ns.get(ns)
            if m_c is None or not m_c.kf_valid[c]:
                continue
            res = self._validate_candidate(k, c, m_c)
            if res is None:
                continue
            s, R, t, n_proj = res
            if n_proj >= self.cfg.min_proj_weak:
                return act(g, m_c, c, s, R, t, n_proj, 1)
        self.pending = None
        return None

    def _validate_candidate(self, k: int, c: int, m_c: MapState | None = None):
        """Geometric validation; returns (s, R, t, n_proj) of S_kc
        (candidate camera -> current camera) or None. The host inputs are
        gathered under the map lock (the mapping thread mutates the map and
        its covisibility graph); the program runs and is fetched outside."""
        m = self.m
        m_c = m if m_c is None else m_c
        cfg = self.cfg
        with self.lock:
            lm_k = m.kf_lm_idx[k].copy()
            lm_c = m_c.kf_lm_idx[c].copy()
            bound_k = m.kf_feat_valid[k] & (lm_k >= 0)
            bound_c = m_c.kf_feat_valid[c] & (lm_c >= 0)
            if bound_k.sum() < cfg.min_bow_matches or bound_c.sum() < cfg.min_bow_matches:
                return None
            desc_k, xy_k, level_k, valid_k = self._kf_rows(k, m)
            desc_c, _, _, _ = self._kf_rows(c, m_c)

            def feat_tables(mm, kf, lm, bound):
                pc = np.zeros((lm.shape[0], 3), np.float32)
                pc[bound] = mm.lm_pos[lm[bound]] @ mm.kf_R[kf].T + mm.kf_t[kf]
                uv = (mm.kf_xy[kf] - [self.cx, self.cy]).astype(np.float32)
                return pc, uv, self._sigma2(mm.kf_level[kf])

            pc_k, uv_k, sig_k = feat_tables(m, k, lm_k, bound_k)
            pc_c, uv_c, sig_c = feat_tables(m_c, c, lm_c, bound_c)

            # Candidate-window landmarks for the guided-projection count.
            lms = self._loop_window_landmarks(c, m_c)
            n = min(len(lms), _PROJ_CAP)
            pad = _PROJ_CAP - n

            def padf(x, fill=0):
                x = x[:n]
                return np.concatenate([x, np.full((pad, *x.shape[1:]), fill, x.dtype)])

            host = dict(
                angle_k=m.kf_angle[k].copy(), angle_c=m_c.kf_angle[c].copy(),
                w_desc=padf(m_c.lm_desc[lms]).astype(np.int64), w_pos=padf(m_c.lm_pos[lms]).astype(np.float32),
                w_maxd=padf(m_c.lm_max_dist[lms], 1.0), w_ok=padf(np.ones(n, bool), False),
                R_c=m_c.kf_R[c].copy(), t_c=m_c.kf_t[c].copy(),
            )
        put = self._put
        draws = torch.randint(0, lm_k.shape[0], (N_HYP_SIM3, 3), generator=self.rng).to(self.device)
        out = _validate_candidate_fused(
            _unpack_bits(desc_k), put(bound_k), put(host["angle_k"]), put(pc_k), put(uv_k), put(sig_k),
            _unpack_bits(desc_c), put(bound_c), put(host["angle_c"]), put(pc_c), put(uv_c), put(sig_c),
            put(host["w_desc"]), put(host["w_pos"]), put(host["w_maxd"]), put(host["w_ok"]),
            put(host["R_c"]), put(host["t_c"]),
            desc_k, xy_k, level_k, valid_k,
            draws, self.fx, self.fy, self.cx, self.cy, float(2 * self.cx), float(2 * self.cy),
            fix_scale=cfg.fix_scale,
        )
        t0 = time.perf_counter()
        keys = ("n_bow", "ok_r", "n_ransac", "n_opt", "n_proj", "s", "R", "t")
        o = dict(zip(keys, fetch_block([out[key] for key in keys])))
        self.validate_s.append(time.perf_counter() - t0)
        n_bow = int(o["n_bow"])
        if n_bow < cfg.min_bow_matches:
            log.debug("cand KF %d: %d bow matches < %d", c, n_bow, cfg.min_bow_matches)
            return None
        if not bool(o["ok_r"]) or int(o["n_ransac"]) < cfg.min_ransac_inliers:
            log.debug("cand KF %d: sim3 ransac %d inl (ok=%s)", c, int(o["n_ransac"]), bool(o["ok_r"]))
            return None
        if int(o["n_opt"]) < cfg.min_sim3_inliers:
            log.debug("cand KF %d: sim3 refine %d inl", c, int(o["n_opt"]))
            return None
        s, R, t = float(o["s"]), np.asarray(o["R"]), np.asarray(o["t"])
        n_proj = int(o["n_proj"])
        if n_proj < cfg.min_proj_weak:
            log.debug("cand KF %d: %d proj matches < %d", c, n_proj, cfg.min_proj_weak)
            return None
        log.info("loop candidate KF %d -> %d: %d bow, %d sim3 inl, %d proj", k, c, n_bow, int(o["n_opt"]), n_proj)
        return s, R, t, n_proj

    def _loop_window_landmarks(self, c: int, m_c: MapState | None = None, top: int = 10) -> np.ndarray:
        m = self.m if m_c is None else m_c
        with self.lock:
            nb, _ = m.covisible_keyframes(c, min_weight=1, top=top)
            kfs = np.concatenate([[c], nb]).astype(np.int64)
            return m.local_map_landmarks(kfs)

    def _projection_matches(self, k: int, c: int, s, R, t, m_c: MapState | None = None) -> int:
        """Matches when projecting the candidate's window landmarks into KF k
        through the corrected pose S_kw = S_kc o S_cw."""
        m = self.m
        m_c = m if m_c is None else m_c
        with self.lock:
            lms = self._loop_window_landmarks(c, m_c)
            if len(lms) == 0:
                return 0
            s_kw, R_kw, t_kw = _sim3_mul_np(s, R, t, 1.0, m_c.kf_R[c], m_c.kf_t[c])
            pc = (m_c.lm_pos[lms] @ R_kw.T) * s_kw + t_kw
            lm_desc, lm_max_dist = m_c.lm_desc[lms], m_c.lm_max_dist[lms]
        z = pc[:, 2]
        u = self.fx * pc[:, 0] / np.maximum(z, 1e-6) + self.cx
        v = self.fy * pc[:, 1] / np.maximum(z, 1e-6) + self.cy
        okp = (z > 0.05) & (u >= 0) & (u < 2 * self.cx) & (v >= 0) & (v < 2 * self.cy)
        if okp.sum() < 3:
            return 0
        uv = np.stack([u, v], 1).astype(np.float32)
        # The predicted level follows from the viewing distance in
        # candidate-map units (|pc| / s_kw).
        lvl, rad = self._predict_level_radius(lm_max_dist, np.linalg.norm(pc, axis=1) / max(s_kw, 1e-9), r_base=8.0)
        n = min(len(lms), _PROJ_CAP)
        pad = _PROJ_CAP - n

        def padf(x, fill=0):
            x = x[:n]
            return np.concatenate([x, np.full((pad, *x.shape[1:]), fill, x.dtype)])

        put = self._put
        n_proj = _proj_count(
            put(padf(lm_desc), np.int64), put(padf(okp, False)), put(padf(uv)), put(padf(lvl)),
            put(padf(rad)), *self._kf_rows(k, m),
        )
        return int(fetch_block([n_proj])[0])

    # ------------------------------------------------------------------
    # Correction
    # ------------------------------------------------------------------

    def _correct_loop(self, k: int, c: int, s, R, t):
        """Propagate the corrective Sim(3), fuse, optimize the essential
        graph (CorrectLoop), holding the map lock throughout."""
        with self.lock:
            self._correct_loop_locked(k, c, s, R, t)
        # Whole-map bundle adjustment (RunGlobalBundleAdjustment): the
        # essential graph repairs poses but leaves structure error.
        if self.global_ba_hook is not None:
            self.global_ba_hook(k, c)

    def _correct_loop_locked(self, k: int, c: int, s, R, t):
        m = self.m
        log.info(
            "closing loop: KF %d (frame %d) -> KF %d (frame %d), scale %.4f",
            k, int(m.kf_frame_id[k]), c, int(m.kf_frame_id[c]), s,
        )
        self.events.append({
            "kind": "loop", "kf": int(k), "kf_frame": int(m.kf_frame_id[k]), "match": int(c),
            "match_frame": int(m.kf_frame_id[c]), "scale": float(s),
        })
        # Corrected Sim(3) pose of k: S_kw_corr = S_kc o S_cw.
        s_corr, R_corr, t_corr = _sim3_mul_np(s, R, t, 1.0, m.kf_R[c], m.kf_t[c])
        # Pre-correction poses: the essential-graph measurements come from
        # the original (drifted) geometry (NonCorrectedSim3).
        R_snap = m.kf_R.copy()
        t_snap = m.kf_t.copy()

        # The current covisible window (CorrectedSim3).
        nb, _ = m.covisible_keyframes(k, min_weight=1, top=20)
        window = np.concatenate([[k], nb]).astype(np.int64)
        S_old, S_new = {}, {}
        R_kw, t_kw = m.kf_R[k].copy(), m.kf_t[k].copy()
        for i in window:
            i = int(i)
            S_old[i] = (1.0, m.kf_R[i].copy(), m.kf_t[i].copy())
            si, Ri, ti = _sim3_mul_np(1.0, m.kf_R[i], m.kf_t[i], *_sim3_inv_np(1.0, R_kw, t_kw))
            sn, Rn, tn = _sim3_mul_np(si, Ri, ti, s_corr, R_corr, t_corr)
            S_new[i] = (float(sn), Rn, tn)

        # Re-anchor the window's landmarks (X' = S_iw_new^-1(S_iw_old(X)),
        # each through its first observing window keyframe); remember the
        # anchors for the essential-graph landmark update.
        lms = m.local_map_landmarks(window)
        lm_anchor: dict[int, int] = {}
        if len(lms):
            anchor = np.full(len(lms), -1, np.int64)
            for i in window:
                unset = anchor < 0
                anchor[np.nonzero(m.obs[i, lms] & unset)[0]] = int(i)
            for i in window:
                i = int(i)
                selm = lms[anchor == i]
                if len(selm) == 0:
                    continue
                so, Ro, to = S_old[i]
                sn, Rn, tn = S_new[i]
                pc = (m.lm_pos[selm] @ Ro.T) * so + to
                sinv, Rinv, tinv = _sim3_inv_np(sn, Rn, tn)
                m.lm_pos[selm] = (pc @ Rinv.T) * sinv + tinv
                for lm in selm:
                    lm_anchor[int(lm)] = i

        # Corrected window poses (SE(3): t / s).
        for i in window:
            sn, Rn, tn = S_new[int(i)]
            m.kf_R[i] = Rn
            m.kf_t[i] = tn / sn

        self._search_and_fuse(window, c)
        self._essential_graph(k, c, window, S_new, R_snap, t_snap, lm_anchor)

        self.last_loop_kf = k
        self.n_loops_closed += 1
        m.big_change_idx += 1
        # Persist the loop edge for later essential graphs.
        sji, Rji, tji = pose_graph.relative_sim3(np.ones(m.cfg.max_keyframes, np.float32), m.kf_R, m.kf_t, c, k)
        self.loop_edges.append((m.map_id, c, k, (float(sji), Rji.numpy(), tji.numpy())))

    def _search_and_fuse(self, window: np.ndarray, c: int):
        """SearchAndFuse: project the loop window's landmarks into each
        corrected window keyframe and merge the duplicates. All targets are
        dispatched first and fetched in one transfer."""
        m = self.m
        loop_lms = self._loop_window_landmarks(c)
        if len(loop_lms) == 0:
            return
        bits_dev = self._put(m.lm_desc[loop_lms], np.int64)
        bits_dev = _unpack_bits(bits_dev)
        pending = []
        for i in window:
            pc = m.lm_pos[loop_lms] @ m.kf_R[i].T + m.kf_t[i]
            z = pc[:, 2]
            u = self.fx * pc[:, 0] / np.maximum(z, 1e-6) + self.cx
            v = self.fy * pc[:, 1] / np.maximum(z, 1e-6) + self.cy
            okp = (z > 0.05) & (u >= 0) & (u < 2 * self.cx) & (v >= 0) & (v < 2 * self.cy)
            if okp.sum() < 3:
                continue
            uv = np.stack([u, v], 1).astype(np.float32)
            # ORBmatcher::Fuse: radius 3 * scaleFactor^predictedLevel, level
            # within [l-1, l+1].
            lvl, rad = self._predict_level_radius(m.lm_max_dist[loop_lms], np.linalg.norm(pc, axis=1), r_base=3.0)
            desc_i, xy_i, level_i, valid_i = self._kf_rows(int(i), m)
            idx, mok = matching.search_by_projection(
                bits_dev, self._put(okp), self._put(uv), self._put(lvl),
                _unpack_bits(desc_i), xy_i, level_i, valid_i, self._put(rad),
                max_dist=matching.TH_LOW, ratio=0.9, level_band=1,
            )
            pending.append((int(i), idx, mok))
        if not pending:
            return
        fetched = fetch_block([x for _, idx, mok in pending for x in (idx, mok)])
        n_fused = 0
        for j, (i, _, _) in enumerate(pending):
            idx, mok = fetched[2 * j], fetched[2 * j + 1]
            for jj in np.nonzero(mok)[0]:
                loop_lm = int(loop_lms[jj])
                f = int(idx[jj])
                cur_lm = int(m.kf_lm_idx[i, f])
                if cur_lm == loop_lm:
                    continue
                if cur_lm >= 0:
                    # Replace the window landmark by the (older) loop
                    # landmark everywhere (MapPoint::Replace).
                    m.replace_landmark(cur_lm, loop_lm)
                else:
                    m.add_observation(i, np.asarray([f]), np.asarray([loop_lm]))
                n_fused += 1
        if n_fused:
            log.info("loop fuse: %d duplicate bindings merged", n_fused)

    def _essential_graph(self, k: int, c: int, window, S_new, R_snap, t_snap, lm_anchor):
        """Pose graph over all keyframes. Edge measurements come from the
        pre-correction snapshot; window vertices are seeded with their
        corrected Sim(3); the loop candidate is the fixed gauge."""
        m = self.m
        valid = np.nonzero(m.kf_valid)[0]
        if len(valid) < 3:
            return
        order = valid[np.argsort(m.kf_frame_id[valid], kind="stable")]
        K = len(order)
        slot = {int(kf): i for i, kf in enumerate(order)}
        win = {int(i) for i in window}

        s0 = np.ones(K, np.float32)
        R0 = m.kf_R[order].copy()
        t0 = m.kf_t[order].copy()
        for i in win:
            if i in slot:
                sn, Rn, tn = S_new[i]
                s0[slot[i]] = sn
                R0[slot[i]] = Rn
                t0[slot[i]] = tn

        ei, ej, es, eR, et, ew = [], [], [], [], [], []

        def add_edge_snap(a, b, wgt=1.0):
            # S_ji = S_b o S_a^-1 from the pre-correction snapshot.
            sm, Rm, tm = _sim3_mul_np(1.0, R_snap[b], t_snap[b], *_sim3_inv_np(1.0, R_snap[a], t_snap[a]))
            ei.append(slot[a]); ej.append(slot[b])  # noqa: E702
            es.append(float(sm)); eR.append(Rm); et.append(tm); ew.append(wgt)  # noqa: E702

        # Temporal chain (the spanning-tree analog), covisibility edges,
        # earlier loop edges of this map, and the new loop edge.
        for a, b in zip(order[:-1], order[1:]):
            add_edge_snap(int(a), int(b))
        for ii, jj in zip(*_covis_pairs(m, order, self.cfg.covis_edge_weight)):
            add_edge_snap(int(order[ii]), int(order[jj]))
        for (mid, a, b, (sm, Rm, tm)) in self.loop_edges:
            if mid == m.map_id and a in slot and b in slot:
                ei.append(slot[a]); ej.append(slot[b])  # noqa: E702
                es.append(sm); eR.append(Rm); et.append(tm); ew.append(1.0)  # noqa: E702
        sk, Rk, tk = S_new[k]
        sm, Rm, tm = _sim3_mul_np(sk, Rk, tk, *_sim3_inv_np(1.0, m.kf_R[c], m.kf_t[c]))
        ei.append(slot[c]); ej.append(slot[k])  # noqa: E702
        es.append(float(sm)); eR.append(Rm); et.append(tm); ew.append(2.0)  # noqa: E702

        fixed = np.zeros(K, bool)
        fixed[slot[c]] = True
        # Inertial maps: the gravity-aligned world makes roll, pitch and scale
        # observable, so the graph optimizes yaw and translation only
        # (OptimizeEssentialGraph4DoF).
        if m.imu_stage >= 1:
            mode = "4dof"
        else:
            mode = "se3" if self.cfg.fix_scale else "sim3"
        put = self._put
        res = pose_graph.optimize_pose_graph(
            put(s0), put(R0), put(t0), put(np.ones(K, bool)), put(fixed),
            put(np.asarray(ei), np.int64), put(np.asarray(ej), np.int64),
            put(np.asarray(es), np.float32), put(np.stack(eR), np.float32), put(np.stack(et), np.float32),
            put(np.asarray(ew), np.float32), put(pose_graph.FREE_DIMS[mode]),
        )
        s_n, R_n, t_n = fetch_block((res.s, res.R, res.t))

        # Re-anchor every landmark through the pose it is consistent with:
        # window-corrected landmarks through their recorded window anchor
        # (with its corrected Sim(3)), the rest through their first
        # observing keyframe's snapshot pose.
        lm_ids = np.nonzero(m.lm_valid)[0]
        if len(lm_ids):
            obs_o = m.obs[order][:, lm_ids]
            first_slot = np.argmax(obs_o, axis=0)
            seen = obs_o.any(axis=0)
            anchor_slot = first_slot.copy()
            use_corrected = np.zeros(len(lm_ids), bool)
            for j, lm in enumerate(lm_ids):
                a = lm_anchor.get(int(lm))
                if a is not None and a in slot:
                    anchor_slot[j] = slot[a]
                    use_corrected[j] = True
            for sl in np.unique(anchor_slot[seen]):
                for corrected in (False, True):
                    selm = lm_ids[(anchor_slot == sl) & seen & (use_corrected == corrected)]
                    if len(selm) == 0:
                        continue
                    i = int(order[sl])
                    so, Ro, to = S_new[i] if corrected else (1.0, R_snap[i], t_snap[i])
                    pc = (m.lm_pos[selm] @ Ro.T) * so + to
                    sinv, Rinv, tinv = _sim3_inv_np(s_n[sl], R_n[sl], t_n[sl])
                    m.lm_pos[selm] = (pc @ Rinv.T) * sinv + tinv

        # Optimized poses back as SE(3) (t / s).
        m.kf_R[order] = R_n
        m.kf_t[order] = t_n / s_n[:, None]
        if mode == "sim3" and self.rescale_hook is not None:
            self.rescale_hook(m, order, s_n)
