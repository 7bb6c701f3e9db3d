"""Batched-hypothesis two-view reconstruction (port of ops/ransac.py, the
monocular initializer only).

Every hypothesis is generated, solved (batched SVD) and scored against all
points at once: 8-point F and DLT H on the same index sets, model selection
by the score ratio RH > 0.5, motion recovery from E (4 candidates) or the
Faugeras H decomposition (8 candidates), cheirality scoring
(TwoViewReconstruction::{Reconstruct,ReconstructF,ReconstructH}).

Randomness: the reference draws its index sets from a JAX PRNG key, which
PyTorch cannot reproduce. `reconstruct_two_views` therefore takes the
(n_hyp, 8) index sets as an argument; `sample_indices` makes them from an
explicit `torch.Generator` by the same valid-first-permutation rule. PnP,
MLPnP and Sim(3) RANSAC are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from . import geometry

CHI2_1DOF = 3.841
CHI2_2DOF = 5.991


def sample_indices(generator: torch.Generator, n_hyp: int, k: int, valid: torch.Tensor) -> torch.Tensor:
    """(n_hyp, k) random index sets drawn from *valid* slots only.

    Inputs are fixed-capacity masked arrays: positions are sampled modulo
    the valid count and mapped through a valid-first permutation (stable
    argsort). Duplicates within a set give degenerate models that score
    poorly, so there is no rejection loop. The draw comes from `generator`
    (a CPU generator) and is moved to `valid`'s device.
    """
    n = valid.shape[0]
    order = torch.argsort((~valid).to(torch.int8), stable=True)  # valid indices first
    nv = torch.clamp_min(torch.sum(valid.to(torch.int64)), 1)
    raw = torch.randint(0, n, (n_hyp, k), generator=generator).to(valid.device)
    return order[raw % nv]


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
