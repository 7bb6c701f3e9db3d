"""Batched-hypothesis RANSAC solvers (port of ops/ransac.py).

Every hypothesis is generated, solved (batched SVD / eigendecomposition) and
scored against all points at once; the winner is the first hypothesis with
the most inliers.

- `reconstruct_two_views`: the monocular initializer. 8-point F and DLT H on
  the same index sets, model selection by the score ratio RH > 0.5, motion
  recovery from E (4 candidates) or the Faugeras H decomposition (8
  candidates), cheirality scoring
  (TwoViewReconstruction::{Reconstruct,ReconstructF,ReconstructH}).
- `mlpnp_ransac`: relocalization PnP with the maximum-likelihood nullspace
  formulation (MLPnPsolver), general and planar linear solves, then
  Gauss-Newton on the winner's inliers; `pnp_ransac` is the 6-point DLT
  resection baseline.
- `sim3_ransac`: Horn's closed-form Sim(3) on 3-point sets (Sim3Solver),
  refined once on the winner's inliers.

Randomness: the reference draws its index sets from a JAX PRNG key, which
PyTorch cannot reproduce. Every sampler here therefore takes its
(n_hyp, k) index sets as an argument (k = 8 two-view, 6 PnP, 3 Sim(3));
`sample_indices` makes them from an explicit `torch.Generator` by the same
valid-first-permutation rule. Singular and eigen vectors have an arbitrary
sign; every quantity returned is invariant to it.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import lie
from . import geometry

CHI2_1DOF = 3.841
CHI2_2DOF = 5.991


def indices_from_draws(raw: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Index sets from raw draws in [0, N): positions taken modulo the valid
    count and mapped through a valid-first permutation (stable argsort), so
    that every set is drawn from *valid* slots only. Duplicates within a set
    give degenerate models that score poorly, so there is no rejection
    loop."""
    order = torch.argsort((~valid).to(torch.int8), stable=True)  # valid indices first
    nv = torch.clamp_min(torch.sum(valid.to(torch.int64)), 1)
    return order[raw.to(valid.device) % nv]


def sample_indices(generator: torch.Generator, n_hyp: int, k: int, valid: torch.Tensor) -> torch.Tensor:
    """(n_hyp, k) random index sets drawn from the valid slots of the
    fixed-capacity mask `valid` (`indices_from_draws`). The draw comes from
    `generator` (a CPU generator) and is moved to `valid`'s device."""
    raw = torch.randint(0, valid.shape[0], (n_hyp, k), generator=generator)
    return indices_from_draws(raw, valid)


@dataclasses.dataclass(frozen=True)
class TwoViewResult:
    success: torch.Tensor  # bool scalar
    R: torch.Tensor  # (3,3) cam1->cam2
    t: torch.Tensor  # (3,)
    points: torch.Tensor  # (N,3) in cam1 frame
    good: torch.Tensor  # (N,) triangulated-inlier mask
    parallax: torch.Tensor  # scalar, degrees (median of inliers)


def _score(e1, e2, valid, sigma2, th):
    chi1 = e1 / sigma2
    chi2 = e2 / sigma2
    ok1 = chi1 <= th
    ok2 = chi2 <= th
    zero = torch.zeros_like(chi1)
    score = torch.where(ok1 & valid, CHI2_2DOF - chi1, zero) + torch.where(ok2 & valid, CHI2_2DOF - chi2, zero)
    return torch.sum(score, dim=-1), ok1 & ok2 & valid


def _score_fundamental(F, x1, x2, valid, sigma2):
    """Score and inlier mask of F (...,3,3) over all points (CheckFundamental)."""
    e1, e2 = geometry.epipolar_sq_errors(F, x1, x2)
    return _score(e1, e2, valid, sigma2, CHI2_1DOF)


def _score_homography(H, x1, x2, valid, sigma2):
    """Score and inlier mask of H (...,3,3) over all points (CheckHomography)."""
    e1, e2 = geometry.homography_sq_errors(H, x1, x2)
    return _score(e1, e2, valid, sigma2, CHI2_2DOF)


def _faugeras_solutions(H: torch.Tensor, K: torch.Tensor):
    """8 (R, t) candidates from a homography (ReconstructH)."""
    A = geometry._inv(K) @ H @ K
    U, d, Vt = torch.linalg.svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vt.T)
    d1, d2, d3 = d[0], d[1], d[2]
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)
    denom = torch.clamp_min(d1 * d1 - d3 * d3, 1e-12)
    aux1 = torch.sqrt(torch.clamp_min((d1 * d1 - d2 * d2) / denom, 0.0))
    aux3 = torch.sqrt(torch.clamp_min((d2 * d2 - d3 * d3) / denom, 0.0))
    x1s = [aux1, aux1, -aux1, -aux1]
    x3s = [aux3, -aux3, aux3, -aux3]
    signs = [1.0, -1.0, -1.0, 1.0]
    prod = torch.sqrt(torch.clamp_min((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0))

    def unit(t):
        return t / torch.clamp_min(torch.linalg.vector_norm(t), 1e-12)

    Rs, ts = [], []
    # Case d' = +d2.
    den_p = torch.clamp_min((d1 + d3) * d2, 1e-12)
    aux_st = prod / den_p
    ct = (d2 * d2 + d1 * d3) / den_p
    for i in range(4):
        st = signs[i] * aux_st
        Rp = torch.stack([torch.stack([ct, zero, -st]), torch.stack([zero, one, zero]), torch.stack([st, zero, ct])])
        Rs.append(s * U @ Rp @ Vt)
        tp = torch.stack([x1s[i], zero, -x3s[i]]) * (d1 - d3)
        ts.append(unit(U @ tp))
    # Case d' = -d2.
    den_m = torch.clamp_min((d1 - d3) * d2, 1e-12)
    aux_sp = prod / den_m
    cp = (d1 * d3 - d2 * d2) / den_m
    for i in range(4):
        sp = signs[i] * aux_sp
        Rp = torch.stack([torch.stack([cp, zero, sp]), torch.stack([zero, -one, zero]), torch.stack([sp, zero, -cp])])
        Rs.append(s * U @ Rp @ Vt)
        tp = torch.stack([x1s[i], zero, x3s[i]]) * (d1 + d3)
        ts.append(unit(U @ tp))
    return torch.stack(Rs), torch.stack(ts)


def reconstruct_two_views(
    x1: torch.Tensor,
    x2: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
    idx: torch.Tensor,
    sigma: float = 1.0,
    min_parallax_deg: float = 1.0,
    min_triangulated: int = 50,
) -> TwoViewResult:
    """Monocular map initialization from matched undistorted pixels.

    x1, x2: (N,2) pixel correspondences (same index = same match), valid:
    (N,) mask, idx: (n_hyp, 8) minimal sets (`sample_indices`). Returns the
    pose of camera 2 w.r.t. camera 1 (R21, t21) and the triangulated points
    in camera-1 coordinates. No host sync inside.
    """
    sigma2 = sigma * sigma
    n = x1.shape[0]
    x1n, T1 = geometry.normalize_points(x1, valid)
    x2n, T2 = geometry.normalize_points(x2, valid)
    hyp_ok = torch.all(valid[idx], dim=1)
    neg = torch.full((), -1.0, dtype=x1.dtype, device=x1.device)

    # --- Fundamental hypotheses (normalized space, then denormalized).
    Fn = geometry.fundamental_8pt(x1n[idx], x2n[idx])
    F = torch.einsum("ji,njk,kl->nil", T2, Fn, T1)  # T2^T Fn T1
    sF, _ = _score_fundamental(F, x1, x2, valid, sigma2)
    sF = torch.where(hyp_ok, sF, neg)
    F_best = F[torch.argmax(sF)]
    # Polish: refit on all inliers of the winning hypothesis (twice).
    for _ in range(2):
        _, inl = _score_fundamental(F_best, x1, x2, valid, sigma2)
        Fn_ref = geometry.fundamental_weighted(x1n, x2n, inl.to(x1.dtype))
        F_best = T2.T @ Fn_ref @ T1
    score_F, inl_F = _score_fundamental(F_best, x1, x2, valid, sigma2)

    # --- Homography hypotheses.
    Hn = geometry.homography_dlt(x1n[idx], x2n[idx])
    T2inv = geometry._inv(T2)
    H = torch.einsum("ij,njk,kl->nil", T2inv, Hn, T1)
    sH, _ = _score_homography(H, x1, x2, valid, sigma2)
    sH = torch.where(hyp_ok, sH, neg)
    H_best = H[torch.argmax(sH)]
    for _ in range(2):
        _, inl = _score_homography(H_best, x1, x2, valid, sigma2)
        Hn_ref = geometry.homography_weighted(x1n, x2n, inl.to(x1.dtype))
        H_best = T2inv @ Hn_ref @ T1
    score_H, inl_H = _score_homography(H_best, x1, x2, valid, sigma2)

    rh = score_H / torch.clamp_min(score_H + score_F, 1e-9)
    use_H = rh > 0.5

    # --- Motion candidates: 4 from E, 8 from H; the inactive set is masked out.
    E = K.T @ F_best @ K
    R1e, R2e, te = geometry.decompose_essential(E)
    R_E = torch.stack([R1e, R1e, R2e, R2e])
    t_E = torch.stack([te, -te, te, -te])
    R_H, t_H = _faugeras_solutions(H_best, K)
    R_all = torch.cat([R_E, R_H])  # (12,3,3)
    t_all = torch.cat([t_E, t_H])
    active = torch.cat([(~use_H).expand(4), use_H.expand(8)])
    inliers = torch.where(use_H, inl_H, inl_F)

    n_good, good, par, X = geometry.check_rt(R_all, t_all, x1, x2, K, inliers, 4.0 * sigma2)
    n_good = torch.where(active, n_good, torch.full_like(n_good, -1))
    best = torch.argmax(n_good)
    n_best = n_good[best]
    n_inl = torch.sum(inliers.to(torch.int32))
    # Uniqueness: the second-best candidate must be clearly worse (the
    # reference requires nsimilar <= 1 with a 0.75 * maxGood threshold).
    second = torch.sort(n_good).values[-2]
    unique = second.to(torch.float32) < 0.75 * n_best.to(torch.float32)

    good_best = good[best]
    # Median parallax over good points; padding sorts last as +inf.
    par_best = par[best]
    n_g = torch.clamp_min(torch.sum(good_best.to(torch.int64)), 1)
    par_sorted = torch.sort(torch.where(good_best, par_best, torch.full_like(par_best, float("inf")))).values
    med_par = par_sorted[torch.clamp_max(n_g // 2, n - 1)]
    med_par = torch.where(torch.isfinite(med_par), med_par, torch.zeros_like(med_par))

    success = (
        (n_best >= min_triangulated)
        & (n_best.to(torch.float32) > 0.8 * n_inl.to(torch.float32))
        & unique
        & (med_par > min_parallax_deg)
    )
    return TwoViewResult(
        success=success, R=R_all[best], t=t_all[best], points=X[best], good=good_best, parallax=med_par,
    )


# ----------------------------------------------------------------------------
# PnP (relocalization): DLT resection hypotheses + reprojection scoring.
# ----------------------------------------------------------------------------


def _dlt_pnp(Xw: torch.Tensor, xn: torch.Tensor):
    """Camera resection from 6 3D-2D pairs per hypothesis: Xw (...,6,3)
    world points, xn (...,6,2) normalized image coordinates. Returns
    (R (...,3,3), t (...,3))."""
    X, Y, Z = Xw[..., 0], Xw[..., 1], Xw[..., 2]
    u, v = xn[..., 0], xn[..., 1]
    o = torch.ones_like(X)
    z = torch.zeros_like(X)
    r1 = torch.stack([X, Y, Z, o, z, z, z, z, -u * X, -u * Y, -u * Z, -u], dim=-1)
    r2 = torch.stack([z, z, z, z, X, Y, Z, o, -v * X, -v * Y, -v * Z, -v], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # (...,12,12)
    P = torch.linalg.svd(A).Vh[..., 11, :].reshape(*A.shape[:-2], 3, 4)
    # Orthonormalize: M = s R.
    U, S, Vt = torch.linalg.svd(P[..., :3])
    R = U @ Vt
    sgn = torch.sign(torch.linalg.det(R))
    R = R * sgn[..., None, None]
    scale = torch.mean(S, dim=-1) * sgn
    t = P[..., 3] / torch.where(torch.abs(scale) < 1e-12, torch.full_like(scale, 1e-12), scale)[..., None]
    # Cheirality: the majority of points must have positive depth; else flip.
    zc = torch.einsum("...j,...nj->...n", R[..., 2, :], Xw) + t[..., 2:3]
    flip = (torch.sum(torch.sign(zc), dim=-1) < 0)
    R = torch.where(flip[..., None, None], -R, R)
    t = torch.where(flip[..., None], -t, t)
    # Re-orthonormalize the sign flip (det(-R) = -1 for 3x3).
    U2, _, Vt2 = torch.linalg.svd(R)
    d = torch.linalg.det(U2 @ Vt2)
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    return U2 @ D @ Vt2, t


def _score_pnp(R, t, Xw, uv, valid, K, th):
    """Inlier count and mask of poses (...,3,3),(...,3) over all points:
    squared reprojection error below `th` (N,) with positive depth."""
    Xc = torch.einsum("...ij,nj->...ni", R, Xw) + t[..., None, :]
    zs = torch.clamp_min(Xc[..., 2:3], 1e-9)
    uv_p = torch.einsum("ij,...nj->...ni", K, Xc / zs)[..., :2]
    e = torch.sum((uv_p - uv) ** 2, dim=-1)
    inl = valid & (Xc[..., 2] > 0) & (e < th)
    return torch.sum(inl.to(torch.int32), dim=-1), inl


def _normalized(uv: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    uvh = torch.cat([uv, torch.ones_like(uv[:, :1])], dim=-1)
    return uvh @ geometry._inv(K).T


def pnp_ransac(
    Xw: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
    idx: torch.Tensor,
    px_threshold: float = 5.99,
    sigma2: torch.Tensor | None = None,
):
    """RANSAC PnP: world points (N,3) vs undistorted pixels (N,2), index sets
    idx (n_hyp, 6). Returns (R, t, inliers, n_inliers, success); the gate is
    on squared reprojection error / sigma2 (per-observation octave variance,
    default 1)."""
    if sigma2 is None:
        sigma2 = torch.ones(Xw.shape[0], dtype=Xw.dtype, device=Xw.device)
    xn = _normalized(uv, K)[:, :2]
    hyp_ok = torch.all(valid[idx], dim=1)
    R_h, t_h = _dlt_pnp(Xw[idx], xn[idx])
    n_inl, inl = _score_pnp(R_h, t_h, Xw, uv, valid, K, px_threshold * sigma2)
    n_inl = torch.where(hyp_ok, n_inl, torch.full_like(n_inl, -1))
    best = torch.argmax(n_inl)
    return R_h[best], t_h[best], inl[best], n_inl[best], n_inl[best] >= 10


# ----------------------------------------------------------------------------
# ML-PnP (relocalization): nullspace bearing-vector formulation.
# ----------------------------------------------------------------------------


def _bearing_nullspaces(v: torch.Tensor) -> torch.Tensor:
    """(N,3) unit bearings -> (N,2,3) orthonormal nullspace bases (the r/s
    tangent vectors of MLPnPsolver::computePose), by cross products."""
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=v.dtype, device=v.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=v.dtype, device=v.device)
    e = torch.where(torch.abs(v[:, :1]) > 0.9, ey[None, :], ex[None, :])
    r = torch.linalg.cross(v, e)
    r = r / torch.clamp_min(torch.linalg.vector_norm(r, dim=-1, keepdim=True), 1e-12)
    s = torch.linalg.cross(v, r)
    return torch.stack([r, s], dim=1)


def _so3_frobenius(M: torch.Tensor) -> torch.Tensor:
    """Closest rotation to M (...,3,3), negating the whole matrix when
    det < 0 (the linear solution is defined up to a global sign)."""
    U, _, Vt = torch.linalg.svd(M)
    R = U @ Vt
    return R * torch.sign(torch.linalg.det(R))[..., None, None]


def _mlpnp_linear(X: torch.Tensor, ns: torch.Tensor, v: torch.Tensor):
    """ML-PnP linear solves of a batch of minimal sets: X (H,k,3) world
    points, ns (H,k,2,3) bearing nullspaces, v (H,k,3) unit bearings. Both
    the general 12-unknown system and the planar 9-unknown eigenframe system
    are solved and chosen by a rank test on sum(X X^T); the sign ambiguities
    are resolved by bearing alignment over the minimal set. Returns
    (R (H,3,3), t (H,3)) with camera-frame point p = R X + t."""
    H, k = X.shape[0], X.shape[1]
    n_flat = ns.reshape(H, 2 * k, 3)  # nullspace rows, point-major
    X2 = torch.repeat_interleave(X, 2, dim=1)

    # General case: unknowns [R00 R01 R02 t0 | R10 R11 R12 t1 | R20 R21 R22 t2].
    A12 = torch.cat([n_flat[..., :, None] * X2[..., None, :], n_flat[..., :, None]], dim=3).reshape(H, 2 * k, 12)
    m = torch.linalg.eigh(A12.transpose(1, 2) @ A12).eigenvectors[..., 0]  # (H,12)
    M = m[:, [0, 1, 2, 4, 5, 6, 8, 9, 10]].reshape(H, 3, 3)
    col_n = torch.linalg.vector_norm(M, dim=1)
    scale_g = torch.pow(torch.clamp_min(col_n[:, 0] * col_n[:, 1] * col_n[:, 2], 1e-12), 1.0 / 3.0)
    R_g = _so3_frobenius(M)
    t_g = m[:, [3, 7, 11]] / scale_g[:, None]

    # Planar case: rotate the points into the eigenframe of sum X X^T (first
    # axis = plane normal); unknowns m9 = [R'[:,1] | R'[:,2] | t].
    S = X.transpose(1, 2) @ X
    w_eig, E = torch.linalg.eigh(S)  # ascending
    # Make E a rotation by flipping its (sign-arbitrary) normal column.
    E = torch.cat([E[..., :1] * torch.sign(torch.linalg.det(E))[:, None, None], E[..., 1:]], dim=-1)
    planar = w_eig[:, 0] < 1e-5 * torch.clamp_min(w_eig[:, 2], 1e-12)
    Xp2 = torch.repeat_interleave(X @ E, 2, dim=1)
    A9 = torch.cat(
        [n_flat[..., :, None] * Xp2[..., None, 1:2], n_flat[..., :, None] * Xp2[..., None, 2:3], n_flat[..., :, None]],
        dim=3,
    ).reshape(H, 2 * k, 9)[:, :, [0, 3, 6, 1, 4, 7, 2, 5, 8]]
    m9 = torch.linalg.eigh(A9.transpose(1, 2) @ A9).eigenvectors[..., 0]
    c1, c2 = m9[:, 0:3], m9[:, 3:6]
    scale_p = torch.sqrt(torch.clamp_min(torch.linalg.vector_norm(c1, dim=-1) * torch.linalg.vector_norm(c2, dim=-1), 1e-12))
    c0 = torch.linalg.cross(c1, c2)
    c0 = c0 / torch.clamp_min(torch.linalg.vector_norm(c0, dim=-1, keepdim=True), 1e-12) * scale_p[:, None]
    t_p = m9[:, 6:9] / scale_p[:, None]

    # Four planar candidates (normal column sign s0, global sign s1); the
    # general case has R fixed and t sign-ambiguous.
    cand_R, cand_t = [], []
    for s0, s1 in ((1.0, 1.0), (1.0, -1.0), (-1.0, 1.0), (-1.0, -1.0)):
        Mp = torch.stack([s0 * c0, s1 * c1, s1 * c2], dim=2)
        cand_R.append(_so3_frobenius(Mp) @ E.transpose(1, 2))
        cand_t.append(s1 * t_p)
    Rp, tp = torch.stack(cand_R, 1), torch.stack(cand_t, 1)  # (H,4,...)
    Rg = R_g[:, None].expand(H, 4, 3, 3)
    sg = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=X.dtype, device=X.device)
    tg = t_g[:, None, :] * sg[None, :, None]
    cands_R = torch.where(planar[:, None, None, None], Rp, Rg)
    cands_t = torch.where(planar[:, None, None], tp, tg)

    # Bearing alignment + cheirality on the minimal set.
    p = torch.einsum("hcij,hnj->hcni", cands_R, X) + cands_t[:, :, None, :]
    u = p / torch.clamp_min(torch.linalg.vector_norm(p, dim=-1, keepdim=True), 1e-12)
    d = torch.sum(u * v[:, None], dim=-1)
    errs = torch.sum(1.0 - d, dim=-1) + 10.0 * torch.sum((p[..., 2] < 0).to(X.dtype), dim=-1)
    best = torch.argmin(errs, dim=1)
    ar = torch.arange(H, device=X.device)
    return cands_R[ar, best], cands_t[ar, best]


def _mlpnp_gn(R, t, Xw, ns, w, iters: int):
    """Gauss-Newton on the nullspace residuals over the inlier set (mlpnp_gn;
    Jacobians by forward-mode differentiation)."""
    eye6 = torch.eye(6, dtype=Xw.dtype, device=Xw.device)

    def residuals(dx, R, t):
        # (1,3) and not (3,): forward-mode tangents of 0-dim intermediates
        # divided by a Python scalar come out float64.
        Rp = lie.so3_exp(dx[None, :3])[0] @ R
        p = Xw @ Rp.T + (t + dx[3:])
        u = p / torch.clamp_min(torch.linalg.vector_norm(p, dim=-1, keepdim=True), 1e-12)
        r = torch.einsum("nkj,nj->nk", ns, u)
        return (r * w[:, None]).reshape(-1)

    z = torch.zeros(6, dtype=Xw.dtype, device=Xw.device)
    for _ in range(iters):
        r0 = residuals(z, R, t)
        J = torch.func.jacfwd(residuals)(z, R, t)
        dx, info = torch.linalg.solve_ex(J.T @ J + 1e-8 * eye6, -(J.T @ r0), check_errors=False)
        ok = torch.all(torch.isfinite(dx)) & (info == 0)
        dx = torch.where(ok, dx, torch.zeros_like(dx))
        R, t = lie.so3_exp(dx[:3]) @ R, t + dx[3:]
    return R, t


def mlpnp_ransac(
    Xw: torch.Tensor,
    uv: torch.Tensor,
    valid: torch.Tensor,
    K: torch.Tensor,
    idx: torch.Tensor,
    px_threshold: float = 5.99,
    gn_iters: int = 4,
    sigma2: torch.Tensor | None = None,
):
    """Maximum-likelihood PnP RANSAC (MLPnPsolver::iterate): world points
    (N,3) vs ideal-pinhole pixels (N,2) with intrinsics K, index sets idx
    (n_hyp, 6). Every minimal set is solved with the nullspace formulation at
    once, the winner is Gauss-Newton-refined on its inliers and kept if it
    scores no worse; scoring is pixel reprojection + cheirality with the
    squared-pixel gate scaled per observation octave by `sigma2` (N,).

    Returns (R, t, inliers, n_inliers, success)."""
    if sigma2 is None:
        sigma2 = torch.ones(Xw.shape[0], dtype=Xw.dtype, device=Xw.device)
    bear = _normalized(uv, K)
    bear = bear / torch.clamp_min(torch.linalg.vector_norm(bear, dim=-1, keepdim=True), 1e-12)
    ns = _bearing_nullspaces(bear)
    th = px_threshold * sigma2

    hyp_ok = torch.all(valid[idx], dim=1)
    R_h, t_h = _mlpnp_linear(Xw[idx], ns[idx], bear[idx])
    n_inl, inl = _score_pnp(R_h, t_h, Xw, uv, valid, K, th)
    n_inl = torch.where(hyp_ok, n_inl, torch.full_like(n_inl, -1))
    best = torch.argmax(n_inl)
    R_b, t_b = R_h[best], t_h[best]
    # Refine on the winning hypothesis' inliers, then rescore.
    R_r, t_r = _mlpnp_gn(R_b, t_b, Xw, ns, inl[best].to(Xw.dtype), gn_iters)
    n_ref, inl_ref = _score_pnp(R_r, t_r, Xw, uv, valid, K, th)
    use_ref = n_ref >= n_inl[best]
    R_f = torch.where(use_ref, R_r, R_b)
    t_f = torch.where(use_ref, t_r, t_b)
    n_f = torch.where(use_ref, n_ref, n_inl[best])
    inl_f = torch.where(use_ref, inl_ref, inl[best])
    return R_f, t_f, inl_f, n_f, n_f >= 10


# ----------------------------------------------------------------------------
# Sim(3) (loop closing): Horn's closed form.
# ----------------------------------------------------------------------------


def _horn_rotation(M: torch.Tensor) -> torch.Tensor:
    """Rotation of Horn's method from the cross-covariance M (...,3,3): the
    eigenvector of the largest eigenvalue of the 4x4 quaternion matrix."""
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack(
        [
            torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
            torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
            torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
            torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
        ],
        -2,
    )
    q_wxyz = torch.linalg.eigh(N).eigenvectors[..., :, 3]  # largest eigenvalue
    return lie.quat_to_rot(q_wxyz[..., [1, 2, 3, 0]])  # (x,y,z,w)


def horn_sim3(pa: torch.Tensor, pb: torch.Tensor, fix_scale: bool = False):
    """Closed-form similarity aligning point sets (...,n,3): pb ~ s R pa + t
    (Sim3Solver::ComputeSim3, Horn 1987)."""
    ca = torch.mean(pa, dim=-2)
    cb = torch.mean(pb, dim=-2)
    a = pa - ca[..., None, :]
    b = pb - cb[..., None, :]
    R = _horn_rotation(a.transpose(-1, -2) @ b)
    Ra = a @ R.transpose(-1, -2)
    if fix_scale:
        s = torch.ones(R.shape[:-2], dtype=pa.dtype, device=pa.device)
    else:
        s = torch.sum(b * Ra, dim=(-1, -2)) / torch.clamp_min(torch.sum(Ra * Ra, dim=(-1, -2)), 1e-12)
    t = cb - s[..., None] * torch.einsum("...ij,...j->...i", R, ca)
    return s, R, t


def sim3_ransac(
    pa: torch.Tensor,
    pb: torch.Tensor,
    valid: torch.Tensor,
    idx: torch.Tensor,
    fix_scale: bool = False,
    threshold: float = 0.05,
):
    """RANSAC Horn alignment of matched 3D point sets (N,3), index sets idx
    (n_hyp, 3). `threshold` is a relative euclidean error
    (|| s R pa + t - pb || / mean |pb|). Returns
    (s, R, t, inliers, n_inliers, success)."""
    hyp_ok = torch.all(valid[idx], dim=1)
    s_h, R_h, t_h = horn_sim3(pa[idx], pb[idx], fix_scale)
    vf = valid.to(pa.dtype)
    scale_ref = torch.clamp_min(torch.sum(torch.linalg.vector_norm(pb, dim=-1) * vf) / torch.sum(vf), 1e-6)

    def score(s, R, t):
        pred = s[..., None, None] * torch.einsum("...ij,nj->...ni", R, pa) + t[..., None, :]
        e = torch.linalg.vector_norm(pred - pb, dim=-1) / scale_ref
        inl = valid & (e < threshold)
        return torch.sum(inl.to(torch.int32), dim=-1), inl

    n_inl, inl = score(s_h, R_h, t_h)
    n_inl = torch.where(hyp_ok, n_inl, torch.full_like(n_inl, -1))
    best = torch.argmax(n_inl)
    # Refine on the inliers of the best hypothesis (one weighted Horn pass).
    w = inl[best].to(torch.float32)[:, None]
    nw = torch.clamp_min(torch.sum(w), 3.0)
    ca = torch.sum(pa * w, dim=0) / nw
    cb = torch.sum(pb * w, dim=0) / nw
    a = (pa - ca) * w
    b = (pb - cb) * w
    R = _horn_rotation(a.T @ b)
    Ra = a @ R.T
    if fix_scale:
        s = torch.ones((), dtype=pa.dtype, device=pa.device)
    else:
        s = torch.sum(b * Ra) / torch.clamp_min(torch.sum(Ra * Ra), 1e-12)
    t = cb - s * (R @ ca)
    n_ref, inl_ref = score(s, R, t)
    return s, R, t, inl_ref, n_ref, n_ref >= 6
