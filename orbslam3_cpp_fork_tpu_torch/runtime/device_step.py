"""The per-frame tracking program (port of runtime/device_step.py).

Image in, optimized pose and match bindings out: ORB extraction ->
undistortion -> local-map projection -> three Hamming match passes with
three motion-only pose optimizations -> constant-velocity prediction for
the next frame (Tracking::Track, TrackWithMotionModel, TrackLocalMap).

The reference compiles this into one XLA program. Here it runs eagerly as
a fixed sequence of PyTorch ops and kernel launches whose every
data-dependent choice (thin carry set, wide-window retry, acceptance
gate) is a `torch.where`: nothing on the path reads a device value back
to the host, so consecutive frames chain on the device with no sync.
"""

from __future__ import annotations

import torch

from ..ops import matching, orb
from ..ops.camera import Camera, undistort_points
from ..optim import pose_opt
from .tracker import _scale_pow, project_landmarks


def _centered(xy: torch.Tensor, cx, cy) -> torch.Tensor:
    """Pixel coordinates relative to the principal point."""
    return torch.stack([xy[:, 0] - cx, xy[:, 1] - cy], dim=-1)


def fused_track_step(
    img: torch.Tensor,  # (H,W) float32 grayscale 0..255
    R_pred: torch.Tensor,  # (3,3) predicted Tcw
    t_pred: torch.Tensor,  # (3,)
    lm_pos: torch.Tensor,  # (L,3) local-map landmarks (padded)
    lm_normal: torch.Tensor,
    lm_min_dist: torch.Tensor,
    lm_max_dist: torch.Tensor,
    lm_bits: torch.Tensor,  # (L,256) int8 descriptor bits
    lm_valid: torch.Tensor,
    fx, fy, cx, cy, width, height,
    orb_params: orb.OrbParams = orb.OrbParams(),
):
    """Extract ORB -> project the local map -> windowed Hamming match ->
    motion-only pose optimization. Returns (features, R, t, lm_to_feat,
    match_ok, inliers, n_inliers)."""
    feats = orb.extract_orb(img, orb_params)
    uv, level, _, ok = project_landmarks(
        R_pred, t_pred, lm_pos, lm_normal, lm_min_dist, lm_max_dist, lm_valid,
        fx, fy, cx, cy, width, height,
    )
    radius = 15.0 * _scale_pow(level)
    idx, mok = matching.search_by_projection(
        lm_bits, ok, uv, level,
        feats.desc_i8, feats.xy, feats.level, feats.valid,
        radius, max_dist=matching.TH_HIGH, ratio=0.9, level_band=1,
    )
    uv_obs = _centered(feats.xy[idx], cx, cy)
    sigma2 = _scale_pow(2 * feats.level[idx])
    res = pose_opt.pose_optimization(
        R_pred, t_pred, lm_pos, uv_obs, sigma2, mok, fx, fy, rounds=4, iters=2,
    )
    return feats, res.R, res.t, idx, mok, res.inliers, res.n_inliers


def _track_stages_core(
    xy_ud, f_level, f_desc_i8, f_valid,
    R_pred, t_pred,
    lm_pos, lm_normal, lm_min_dist, lm_max_dist, lm_desc, lm_valid,
    stage1_mask, min_stage1,
    fx, fy, cx, cy, width, height,
    pose_iters: int = 3,
):
    """Motion-model matching (radius 15, wide 30 retry) -> pose opt ->
    two local-map passes (radius 6 or 12, then 4) -> pose opt each.

    `lm_desc` is (L,8) int64 packed words. Returns (R, t, lm_to_feat,
    bound_mask, inlier_mask, n_inliers, n_stage1, visible_mask).
    """
    lm_bits = orb.unpack_bits(lm_desc)
    # One Hamming matrix, reused by all three matching passes.
    dmat = matching.hamming_matrix(lm_bits, f_desc_i8)

    def match_pass(uv, level, ok_lm, ok_feat, radius_base):
        sigma = _scale_pow(level)
        pen = matching.window_penalty(
            uv, xy_ud, radius_base * sigma, f_level, level - 1, level + 1,
        )
        return matching.match_nn(
            dmat, ok_lm, ok_feat, matching.TH_HIGH, 0.9,
            cross_check=True, extra_penalty=pen,
        )

    def pose_pass(R0, t0, idx, mask):
        uv_obs = _centered(xy_ud[idx], cx, cy)
        sigma2 = _scale_pow(2 * f_level[idx])
        return pose_opt.pose_optimization(
            R0, t0, lm_pos, uv_obs, sigma2, mask, fx, fy, rounds=4, iters=pose_iters,
        )

    # Stage 1: motion-model tracking vs the last frame's landmarks; a thin
    # carried set falls back to the whole snapshot.
    uv1, lvl1, _, ok_p1 = project_landmarks(
        R_pred, t_pred, lm_pos, lm_normal, lm_min_dist, lm_max_dist,
        lm_valid, fx, fy, cx, cy, width, height,
    )
    thin = torch.sum((stage1_mask & lm_valid).to(torch.int32)) < 20
    ok1 = ok_p1 & torch.where(thin, lm_valid, stage1_mask)
    idx_a, mok_a = match_pass(uv1, lvl1, ok1, f_valid, 15.0)
    n_a = torch.sum(mok_a.to(torch.int32))
    idx_b, mok_b = match_pass(uv1, lvl1, ok1, f_valid, 30.0)
    wide = n_a < min_stage1
    idx1 = torch.where(wide, idx_b, idx_a)
    mok1 = torch.where(wide, mok_b, mok_a)
    n_stage1 = torch.sum(mok1.to(torch.int32))
    res1 = pose_pass(R_pred, t_pred, idx1, mok1)

    N = f_valid.shape[0]

    def bound_mask(keep, idx):
        # Scatter only kept entries into an (N+1) buffer whose last slot
        # absorbs the unkept rows (sentinel index N).
        buf = torch.zeros(N + 1, dtype=torch.bool, device=keep.device)
        buf.index_put_((torch.where(keep, idx, torch.full_like(idx, N)),), torch.ones_like(keep))
        return buf[:N]

    def local_pass(R0, t0, prev_keep, prev_idx, radius):
        """Project the local map from (R0, t0), match unbound features,
        merge with carried matches, re-optimize (TrackLocalMap)."""
        fb = bound_mask(prev_keep, prev_idx)
        uv, lvl, _, ok_p = project_landmarks(
            R0, t0, lm_pos, lm_normal, lm_min_dist, lm_max_dist,
            lm_valid, fx, fy, cx, cy, width, height,
        )
        ok_lm = ok_p & ~prev_keep
        idx_n, mok_n = match_pass(uv, lvl, ok_lm, f_valid & ~fb, radius)
        idx_m = torch.where(prev_keep, prev_idx, idx_n)
        mok_m = prev_keep | mok_n
        res = pose_pass(R0, t0, idx_m, mok_m)
        return res, idx_m, mok_m, ok_p

    # Stage 2: local-map tracking from the refined pose, wider when stage
    # 1 was weak.
    keep1 = mok1 & res1.inliers
    r2 = torch.where(res1.n_inliers < 40, 12.0, 6.0)
    res2, idx_m2, mok_m2, ok_p2 = local_pass(res1.R, res1.t, keep1, idx1, r2)

    # Stage 3: one more local-map pass from the stage-2 pose.
    keep2 = mok_m2 & res2.inliers
    res3, idx_m3, mok_m3, ok_p3 = local_pass(res2.R, res2.t, keep2, idx_m2, 4.0)

    visible = ok_p1 | ok_p2 | ok_p3
    return (
        res3.R, res3.t, idx_m3, mok_m3, res3.inliers,
        res3.n_inliers, n_stage1, visible,
    )


# The un-jitted core under the reference's name: the synchronous tracker
# calls it once per frame on already-extracted features and fetches its
# small result block.
fused_track_stages = _track_stages_core


def fused_frame_program(
    img_u8: torch.Tensor,  # (H,W) uint8 raw camera frame
    cam: Camera,
    R_pred: torch.Tensor,  # (3,3) predicted Tcw for THIS frame
    t_pred: torch.Tensor,
    R_prev: torch.Tensor,  # optimized pose of the PREVIOUS frame
    t_prev: torch.Tensor,
    lm_pos: torch.Tensor,  # (L,3) local-map snapshot (padded)
    lm_normal: torch.Tensor,
    lm_min_dist: torch.Tensor,
    lm_max_dist: torch.Tensor,
    lm_desc: torch.Tensor,  # (L,8) int64 packed descriptor words
    lm_valid: torch.Tensor,
    prev_bound: torch.Tensor,  # (L,) bool: prev frame's bound mask
    remap: torch.Tensor,  # (L,) int64: this snapshot's slot -> prev slot (-1 none)
    min_stage1,  # wide-window retry threshold
    min_ok,  # inlier gate below which the pose falls back to the prediction
    fx, fy, cx, cy, width, height,
    orb_params: orb.OrbParams = orb.OrbParams(),
) -> dict:
    """The whole per-frame tracking step: raw image -> ORB -> undistortion
    -> three-stage match/pose-opt -> next-frame constant-velocity
    prediction. On failure (n_inliers < min_ok) the pose stays at the
    prediction (dead reckoning through short dropouts)."""
    feats = orb.extract_orb(img_u8.to(torch.float32), orb_params)
    xy_ud = undistort_points(cam, feats.xy)

    L = lm_valid.shape[0]
    mapped = torch.where(remap >= 0, remap, torch.full_like(remap, L))
    pb = torch.cat([prev_bound, torch.zeros(1, dtype=torch.bool, device=prev_bound.device)])[mapped]
    stage1 = pb & lm_valid

    (R, t, idx_m, mok_m, inl, n_in, n_stage1, visible) = _track_stages_core(
        xy_ud, feats.level, feats.desc_i8, feats.valid,
        R_pred, t_pred,
        lm_pos, lm_normal, lm_min_dist, lm_max_dist, lm_desc, lm_valid,
        stage1, min_stage1,
        fx, fy, cx, cy, width, height,
    )

    ok = n_in >= min_ok
    R_out = torch.where(ok, R, R_pred)
    t_out = torch.where(ok, t, t_pred)
    bound_out = mok_m & inl & ok

    # V = T_out o T_prev^-1 ; T_pred_next = V o T_out.
    Rv = R_out @ R_prev.T
    tv = t_out - Rv @ t_prev
    R_pred_next = Rv @ R_out
    t_pred_next = Rv @ t_out + tv

    return dict(
        R=R_out, t=t_out,
        R_pred_next=R_pred_next, t_pred_next=t_pred_next,
        idx=idx_m, bound=bound_out, visible=visible,
        n_inliers=n_in, n_stage1=n_stage1, ok=ok,
        f_xy=xy_ud, f_level=feats.level, f_angle=feats.angle,
        f_desc=feats.desc, f_valid=feats.valid,
        f_desc_i8=feats.desc_i8, f_score=feats.score,
    )


def fused_track_scan(
    imgs: torch.Tensor,  # (T,H,W) float32 frames
    R0: torch.Tensor,
    t0: torch.Tensor,
    lm_pos, lm_normal, lm_min_dist, lm_max_dist, lm_bits, lm_valid,
    fx, fy, cx, cy, width, height,
    orb_params: orb.OrbParams = orb.OrbParams(),
):
    """Tracking over a frame batch, carrying the pose from frame to frame.
    Returns per-frame stacks (R (T,3,3), t (T,3), n_inliers (T,))."""
    R, t = R0, t0
    Rs, ts, ns = [], [], []
    for img in imgs:
        _, R, t, _, _, _, n_in = fused_track_step(
            img, R, t, lm_pos, lm_normal, lm_min_dist, lm_max_dist,
            lm_bits, lm_valid, fx, fy, cx, cy, width, height,
            orb_params=orb_params,
        )
        Rs.append(R)
        ts.append(t)
        ns.append(n_in)
    return torch.stack(Rs), torch.stack(ts), torch.stack(ns)
