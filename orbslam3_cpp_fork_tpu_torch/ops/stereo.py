"""Stereo correspondence (port of ops/stereo.py): Frame::ComputeStereoMatches
and ComputeStereoFromRGBD as plain functions on tensors.

- The per-row candidate lists of the reference become one dense L x R
  Hamming matrix (`matching.hamming_matrix`, int32) with an additive f32
  penalty for the epipolar row band (|vR - vL| <= 2 sigma_L), the disparity
  range and the +-1 octave gate. At L = R = 1000 the penalty and the masked
  distance are two 4 MB f32 matrices; no f32 matrix is built from bytes.
- The sub-pixel SAD refinement (11x11 patch slid +-5 px along the row,
  parabola fit) is one batched gather and one reduction over all matches.
  The sums run in float64 and are rounded once to f32, so that the result
  does not depend on the order in which a device adds the 121 terms (on
  integer images every order gives the same exact value, the reference's).
  The best shift is the lowest index among equal sums (the Ties rule).
- The outlier cut at 1.5 * 1.4 * median(SAD) is a masked median.

`jnp.round` and `torch.round` both round half to even, so a keypoint at
x.5 lands on the same integer centre on both sides.
"""

from __future__ import annotations

import numpy as np
import torch

from . import camera as cam_mod
from . import geometry, matching
from .image import scale_pow

INF = 1e9
# (TH_HIGH + TH_LOW) / 2: the coarse acceptance of ComputeStereoMatches.
TH_ORB = (matching.TH_HIGH + matching.TH_LOW) // 2
SAD_W = 5  # half window of the 11x11 SAD patch
SAD_L = 5  # slide range +-L


def _row_band_penalty(xy_l, level_l, xy_r, level_r, min_disp: float, max_disp: float) -> torch.Tensor:
    """(N,M) penalty: 0 where right feature r is a legal epipolar candidate
    for left feature l, INF elsewhere."""
    band = 2.0 * scale_pow(level_l)
    dv = torch.abs(xy_l[:, None, 1] - xy_r[None, :, 1])
    disp = xy_l[:, None, 0] - xy_r[None, :, 0]
    dlvl = level_r[None, :] - level_l[:, None]
    ok = (dv <= band[:, None]) & (disp >= min_disp) & (disp <= max_disp) & (dlvl >= -1) & (dlvl <= 1)
    return torch.where(ok, torch.zeros_like(dv), torch.full_like(dv, INF))


def match_stereo_coarse(bits_l, xy_l, level_l, valid_l, bits_r, xy_r, level_r, valid_r,
                        min_disp: float, max_disp: float):
    """Coarse descriptor match along epipolar rows. Returns (idx_r (N,),
    ok (N,)): the best right feature per left feature, accepted at Hamming
    <= TH_ORB inside the row/disparity/octave band."""
    dist = matching.hamming_matrix(bits_l, bits_r)
    pen = _row_band_penalty(xy_l, level_l, xy_r, level_r, min_disp, max_disp)
    return matching.match_nn(dist, valid_l, valid_r, max_dist=TH_ORB, ratio=1.0, cross_check=False, extra_penalty=pen)


def _gather_patch(img, cy, cx, hh: int, hw: int) -> torch.Tensor:
    """Batched (2hh+1, 2hw+1) patches around integer centres, clamped at the
    borders. img (H,W); cy, cx (N,) integer."""
    H, W = img.shape
    dy = torch.arange(-hh, hh + 1, device=img.device)
    dx = torch.arange(-hw, hw + 1, device=img.device)
    yy = torch.clamp(cy[:, None, None] + dy[None, :, None], 0, H - 1)
    xx = torch.clamp(cx[:, None, None] + dx[None, None, :], 0, W - 1)
    return img[yy, xx]


def first_argmin(x: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum along the last axis, by an explicit
    index tie-break (the reference's `jnp.argmin`)."""
    idx = torch.arange(x.shape[-1], device=x.device).expand_as(x)
    at_min = x == torch.amin(x, dim=-1, keepdim=True)
    return torch.amin(torch.where(at_min, idx, torch.full_like(idx, x.shape[-1])), dim=-1)


def subpixel_refine(img_l, img_r, xy_l, ur_coarse, ok):
    """Sub-pixel disparity by sliding SAD and a parabola fit, batched over
    all matches, at full resolution. Returns (ur (N,), sad_best (N,),
    ok (N,))."""
    cy = torch.round(xy_l[:, 1]).long()
    cxl = torch.round(xy_l[:, 0]).long()
    cxr = torch.round(ur_coarse).long()
    pl = _gather_patch(img_l, cy, cxl, SAD_W, SAD_W)  # (N,11,11)
    pr = _gather_patch(img_r, cy, cxr, SAD_W, SAD_W + SAD_L)  # (N,11,21)
    # Centre-intensity normalization (`IL - center`).
    pl = pl - pl[:, SAD_W, SAD_W][:, None, None]
    pr = pr - pr[:, SAD_W, SAD_W + SAD_L][:, None, None]
    n_shift = 2 * SAD_L + 1
    wins = pr.unfold(2, 2 * SAD_W + 1, 1).permute(0, 2, 1, 3)  # (N, 11 shifts, 11, 11)
    sad = torch.abs(wins - pl[:, None]).double().sum(dim=(-2, -1)).float()  # (N, 11)
    best = first_argmin(sad)
    ctr = torch.clamp(best, 1, n_shift - 2)
    d0 = torch.gather(sad, 1, (ctr - 1)[:, None])[:, 0]
    d1 = torch.gather(sad, 1, ctr[:, None])[:, 0]
    d2 = torch.gather(sad, 1, (ctr + 1)[:, None])[:, 0]
    denom = d0 + d2 - 2.0 * d1
    fit = torch.abs(denom) > 1e-6
    delta = torch.where(fit, (d0 - d2) / torch.where(fit, 2.0 * denom, torch.ones_like(denom)), torch.zeros_like(denom))
    # Reject fits outside (-1, 1) and minima at the edge of the slide.
    good = ok & (torch.abs(delta) < 1.0) & (best == ctr)
    ur = cxr.to(torch.float32) + (ctr - SAD_L).to(torch.float32) + delta
    return ur, d1, good


def median_outlier_cut(sad, ok):
    """Drop matches with SAD above 1.5 * 1.4 * the median of the accepted
    ones: the sorted SADs (inf where not ok) at index n_ok // 2, with the
    threshold floored at 1.0."""
    big = torch.where(ok, sad, torch.full_like(sad, float("inf")))
    n_ok = torch.sum(ok)
    order = torch.sort(big).values
    med = order[torch.clamp(n_ok // 2, 0, sad.shape[0] - 1)]
    th = torch.clamp_min(1.5 * 1.4 * med, 1.0)
    return ok & (sad <= th) & (n_ok > 0)


def max_disparity(bf: float, min_z: float) -> float:
    """bf / min_z in f32, as the reference's f32 scalars divide."""
    return float(np.float32(bf) / np.float32(min_z))


def compute_stereo_matches(img_l, img_r, bits_l, xy_l, level_l, valid_l, bits_r, xy_r, level_r, valid_r,
                           bf: float, min_z: float):
    """Coarse match -> SAD sub-pixel -> median cut. Returns per left feature
    (ur (N,), depth (N,), has_depth (N,)); ur and depth are -1 where there
    is no stereo match (mvuRight/mvDepth)."""
    max_disp = max_disparity(bf, min_z)
    idx, ok = match_stereo_coarse(bits_l, xy_l, level_l, valid_l, bits_r, xy_r, level_r, valid_r, 0.0, max_disp)
    ur, sad, ok = subpixel_refine(img_l, img_r, xy_l, xy_r[idx, 0], ok)
    disp = xy_l[:, 0] - ur
    # Clamp near-zero disparity as the reference does.
    tiny = (disp >= 0.0) & (disp < 0.01)
    disp = torch.where(tiny, torch.full_like(disp, 0.01), disp)
    ur = torch.where(tiny, xy_l[:, 0] - 0.01, ur)
    ok = ok & (disp > 0.0) & (disp < max_disp)
    ok = median_outlier_cut(torch.where(ok, sad, torch.full_like(sad, float("inf"))), ok)
    bf_t = torch.full_like(disp, np.float32(bf))
    depth = torch.where(ok, bf_t / torch.clamp_min(disp, 1e-6), torch.full_like(disp, -1.0))
    ur = torch.where(ok, ur, torch.full_like(ur, -1.0))
    return ur, depth, ok


def depth_to_stereo(depth_map, xy_raw, bf: float, depth_factor: float):
    """RGB-D: sample the registered depth image at the raw keypoints and
    synthesize the right coordinate ur = u - bf/d (ComputeStereoFromRGBD).
    Returns (ur, depth, has_depth), -1 where the depth is not positive."""
    H, W = depth_map.shape
    yi = torch.clamp(torch.round(xy_raw[:, 1]).long(), 0, H - 1)
    xi = torch.clamp(torch.round(xy_raw[:, 0]).long(), 0, W - 1)
    d = depth_map[yi, xi] * np.float32(depth_factor)
    ok = d > 0
    depth = torch.where(ok, d, torch.full_like(d, -1.0))
    ur = torch.where(ok, xy_raw[:, 0] - torch.full_like(d, np.float32(bf)) / torch.clamp_min(d, 1e-6),
                     torch.full_like(d, -1.0))
    return ur, depth, ok


def match_stereo_fisheye(bits_l, xy_l, level_l, valid_l, bits_r, xy_r, level_r, valid_r,
                         cam_l, cam_r, R_rl, t_rl, lap_l_start: float, lap_r_end: float,
                         max_hamming: int = TH_ORB, max_cos_parallax: float = 0.9998, chi2_th: float = 5.991):
    """Unrectified (fisheye) stereo matching and triangulation
    (Frame::ComputeStereoFishEyeMatches + KannalaBrandt8::TriangulateMatches):
    one dense Hamming matrix restricted to the lapping areas (u_L >=
    lap_l_start, u_R <= lap_r_end) and to +-1 octave, mutual best under the
    threshold, then DLT triangulation of the unprojected rays with the
    reference's gates: parallax (0 < cos < 0.9998), positive depth in both
    cameras, reprojection chi2 <= 5.991 sigma2 in both.

    R_rl, t_rl: left camera -> right camera (mTrl). Returns (depth_l (N,),
    ray_l (N,3) unit bearings, ok (N,)); depth is the z of the point in the
    left camera."""
    dist = matching.hamming_matrix(bits_l, bits_r).to(torch.float32)
    in_lap = (xy_l[:, 0:1] >= lap_l_start) & (xy_r[None, :, 0] <= lap_r_end)
    lvl_ok = torch.abs(level_l[:, None] - level_r[None, :]) <= 1
    pen = torch.where(in_lap & lvl_ok, torch.zeros_like(dist), torch.full_like(dist, INF))
    idx, ok = matching.match_nn(dist, valid_l, valid_r, max_dist=max_hamming, ratio=1.0, cross_check=True,
                                extra_penalty=pen)

    ray_l = cam_mod.unproject(cam_l, xy_l)
    ray_r = cam_mod.unproject(cam_r, xy_r[idx])
    ray_l = ray_l / torch.linalg.vector_norm(ray_l, dim=-1, keepdim=True)
    ray_r = ray_r / torch.linalg.vector_norm(ray_r, dim=-1, keepdim=True)
    # Parallax between the rays in the left frame (R_lr = R_rl^T).
    ray_r_in_l = ray_r @ R_rl
    cosp = torch.sum(ray_l * ray_r_in_l, dim=-1)
    ok = ok & (cosp < max_cos_parallax) & (cosp > 0.0)

    # Triangulate on the normalized image planes of both cameras.
    eye = torch.eye(3, dtype=xy_l.dtype, device=xy_l.device)
    P1 = torch.cat([eye, torch.zeros((3, 1), dtype=xy_l.dtype, device=xy_l.device)], dim=1)
    P2 = torch.cat([R_rl, t_rl[:, None]], dim=1)
    x1 = ray_l[:, :2] / torch.clamp_min(ray_l[:, 2:3], 1e-6)
    x2 = ray_r[:, :2] / torch.clamp_min(ray_r[:, 2:3], 1e-6)
    n = x1.shape[0]
    X = geometry.triangulate_dlt(P1.expand(n, 3, 4), P2.expand(n, 3, 4), x1, x2)
    Xr = X @ R_rl.T + t_rl
    ok = ok & (X[:, 2] > 0) & (Xr[:, 2] > 0)
    # Reprojection gates in both images.
    uv1 = cam_mod.project(cam_l, X)
    uv2 = cam_mod.project(cam_r, Xr)
    sigma2_l = scale_pow(2 * level_l)
    sigma2_r = scale_pow(2 * level_r[idx])
    e1 = torch.sum((uv1 - xy_l) ** 2, dim=-1)
    e2 = torch.sum((uv2 - xy_r[idx]) ** 2, dim=-1)
    ok = ok & (e1 <= chi2_th * sigma2_l) & (e2 <= chi2_th * sigma2_r)
    depth = torch.where(ok, X[:, 2], torch.full_like(X[:, 2], -1.0))
    return depth, ray_l, ok
