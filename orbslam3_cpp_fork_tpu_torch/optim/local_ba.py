"""Local bundle adjustment: batched sparse LM with a Schur complement
(port of optim/local_ba.py; Optimizer::LocalBundleAdjustment).

- The problem is fixed-capacity SoA: K keyframe slots, L landmark slots, O
  observation slots (COO triplets kf x lm x uv), each with validity masks.
- Per iteration: all residuals and Jacobians batched (optim/residuals.py),
  normal-equation blocks reduced by segment sums, landmarks eliminated by
  the Schur complement with the cross term W (K,L,6,3) kept dense-blocked,
  and the reduced (6K,6K) camera system solved by LU.
- g2o's edge-level outlier switching (chi2 5.991/7.815) is a carried inlier
  mask re-evaluated mid-schedule; fixed vertices are rows and columns masked
  out of the reduced system.
- Levenberg damping is multiplicative on the block diagonals, with the
  accept/reject a `torch.where`: the schedule issues no host sync.

Segment sums are deterministic on either device, so two runs on the same
input give the same bits. On the CPU they are `index_add_`, which adds the
rows one after another (`index_put_` accumulates from several threads
there). On CUDA `index_add_` sums with atomics in no fixed order, so: sums
over the few keyframe segments are a one-hot matrix product, and sums over
landmarks and (keyframe, landmark) pairs are `index_put_(accumulate=True)`,
which sorts the indices and adds each segment in order. That kernel walks
the duplicates of one index serially, so the padding observations (whose
values are zero) are spread over all segments instead of piling on segment
0. The reduced solve is `solve_ex(check_errors=False)`; its failure flag
joins the non-finite guard of the step.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import lie
from . import residuals


@dataclasses.dataclass(frozen=True)
class BAProblem:
    """Fixed-capacity BA problem. All observations use centered pixels
    (u-cx, v-cy[, ur-cx]); mono rows carry ur=0 and is_stereo=False."""

    R: torch.Tensor  # (K,3,3) Tcw rotations
    t: torch.Tensor  # (K,3)
    kf_valid: torch.Tensor  # (K,)
    kf_fixed: torch.Tensor  # (K,)
    Xw: torch.Tensor  # (L,3)
    lm_valid: torch.Tensor  # (L,)
    obs_kf: torch.Tensor  # (O,) int64
    obs_lm: torch.Tensor  # (O,) int64
    obs_uvr: torch.Tensor  # (O,3)
    obs_sigma2: torch.Tensor  # (O,)
    obs_stereo: torch.Tensor  # (O,)
    obs_valid: torch.Tensor  # (O,)
    fx: float
    fy: float
    bf: float


@dataclasses.dataclass(frozen=True)
class BAResult:
    R: torch.Tensor
    t: torch.Tensor
    Xw: torch.Tensor
    obs_inlier: torch.Tensor  # (O,) post-gating inlier mask
    cost: torch.Tensor
    # Slice-chaining state (see local_ba it0/inlier0/lam0).
    inlier_carry: torch.Tensor | None = None
    lam: torch.Tensor | None = None


def _inv3x3_sym(H: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of batched symmetric 3x3 blocks (...,3,3)."""
    h00, h01, h02 = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    h11, h12, h22 = H[..., 1, 1], H[..., 1, 2], H[..., 2, 2]
    c00 = h11 * h22 - h12 * h12
    c01 = h02 * h12 - h01 * h22
    c02 = h01 * h12 - h02 * h11
    c11 = h00 * h22 - h02 * h02
    c12 = h01 * h02 - h00 * h12
    c22 = h00 * h11 - h01 * h01
    det = h00 * c00 + h01 * c01 + h02 * c02
    det = torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
    row0 = torch.stack([c00, c01, c02], -1)
    row1 = torch.stack([c01, c11, c12], -1)
    row2 = torch.stack([c02, c12, c22], -1)
    return torch.stack([row0, row1, row2], -2) / det[..., None, None]


def _segment_sum(n: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """(O, ...) values summed into n segments, in a fixed order."""
    out = torch.zeros((n, *vals.shape[1:]), dtype=vals.dtype, device=vals.device)
    if vals.is_cuda:
        return out.index_put_((idx,), vals, accumulate=True)
    return out.index_add_(0, idx, vals)


def _segment_plan(p: BAProblem):
    """(sum over keyframes, landmark indices, pair indices) for the
    normal-equation sums of problem `p` on its device (module docstring)."""
    return segment_plan(p.R.shape[0], p.Xw.shape[0], p.obs_kf, p.obs_lm, p.obs_valid, p.Xw)


def segment_plan(K: int, L: int, obs_kf, obs_lm, obs_valid, like: torch.Tensor):
    """`_segment_plan` of K keyframes, L landmarks and the observations
    (obs_kf, obs_lm, obs_valid), for sums of `like`'s dtype and device."""
    O = obs_kf.shape[0]
    obs_kf, obs_lm = obs_kf.long(), obs_lm.long()
    obs_pair = obs_kf * L + obs_lm
    if not like.is_cuda:
        return (lambda v: _segment_sum(K, obs_kf, v)), obs_lm, obs_pair
    spread = torch.arange(O, device=like.device)
    onehot = (obs_kf[None, :] == torch.arange(K, device=like.device)[:, None]).to(like.dtype)  # (K,O)

    def sum_kf(v):
        return (onehot @ v.reshape(O, -1)).reshape(K, *v.shape[1:])

    return (
        sum_kf,
        torch.where(obs_valid, obs_lm, spread % L),
        torch.where(obs_valid, obs_pair, spread % (K * L)),
    )


def _huber_rho(chi2, d2):
    return torch.where(chi2 <= d2, chi2, 2.0 * torch.sqrt(d2 * torch.clamp_min(chi2, 0.0)) - d2)


def _residual_model(p: BAProblem, robust: bool):
    """The reprojection model shared by `local_ba` and `sparse_ba`:
    (resid, chi2_of, cost_of, build_cost, d2). Mono rows carry a zero third
    residual; the chi2 gate is 5.991 (mono) / 7.815 (stereo)."""
    dev, dt = p.Xw.device, p.Xw.dtype
    obs_kf, obs_lm = p.obs_kf.long(), p.obs_lm.long()
    row_w = torch.where(
        p.obs_stereo[:, None], torch.ones(3, dtype=dt, device=dev), torch.tensor([1.0, 1.0, 0.0], dtype=dt, device=dev)
    )
    d2 = torch.where(p.obs_stereo, residuals.CHI2_STEREO, residuals.CHI2_MONO).to(dt)

    def resid(R, t, Xw):
        r3, Jp3, Jl3, z = residuals.stereo_reprojection(
            R[obs_kf], t[obs_kf], Xw[obs_lm], p.obs_uvr, p.fx, p.fy, p.bf
        )
        return r3 * row_w, Jp3 * row_w[..., None], Jl3 * row_w[..., None], z

    def chi2_of(r):
        return torch.sum(r * r, dim=-1) / p.obs_sigma2

    def cost_of(chi2, active):
        rho = _huber_rho(chi2, d2) if robust else chi2
        return torch.sum(torch.where(active, rho, torch.zeros_like(rho)))

    def build_cost(R, t, Xw, inlier):
        r, _, _, z = resid(R, t, Xw)
        return cost_of(chi2_of(r), inlier & p.obs_valid & (z > 0))

    return resid, chi2_of, cost_of, build_cost, d2


def local_ba(
    p: BAProblem,
    iters: int = 10,
    gate_at: int = 5,
    robust: bool = True,
    damping_init: float = 1e-4,
    it0: int = 0,
    inlier0: torch.Tensor | None = None,
    lam0: torch.Tensor | None = None,
) -> BAResult:
    """One LM schedule, or a slice of one: pass it0/inlier0/lam0 from the
    previous slice's result to chain slices on the device."""
    K = p.R.shape[0]
    L = p.Xw.shape[0]
    dev, dt = p.Xw.device, p.Xw.dtype
    obs_kf, obs_lm = p.obs_kf.long(), p.obs_lm.long()
    sum_kf, seg_lm, seg_pair = _segment_plan(p)

    free_f = (p.kf_valid & ~p.kf_fixed).to(dt)  # (K,)
    free6 = torch.repeat_interleave(free_f, 6)
    dmask = free6[:, None] * free6[None, :]
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eyeK = torch.eye(K, dtype=dt, device=dev)
    eye6K = torch.eye(K * 6, dtype=torch.bool, device=dev)
    lm_valid_f = p.lm_valid.to(dt)
    resid, chi2_of, cost_of, build_cost, d2 = _residual_model(p, robust)

    R, t, Xw = p.R, p.t, p.Xw
    inlier = p.obs_valid if inlier0 is None else inlier0
    lam = torch.tensor(damping_init, dtype=dt, device=dev) if lam0 is None else lam0

    for it in range(int(it0), int(it0) + iters):
        r, Jp, Jl, z = resid(R, t, Xw)
        chi2 = chi2_of(r)
        # Mid-schedule outlier gate, from the residuals of this state.
        if it == int(gate_at):
            inlier = p.obs_valid & (chi2 <= d2) & (z > 0)

        active = inlier & p.obs_valid & (z > 0)
        w_huber = residuals.huber_weight(chi2, d2) if robust else torch.ones_like(chi2)
        wgt = active.to(dt) * w_huber / p.obs_sigma2  # (O,)

        # Normal-equation blocks.
        JpW = Jp * wgt[:, None, None]  # (O,3,6) pre-weighted
        JlW = Jl * wgt[:, None, None]
        Hcc = sum_kf(torch.einsum("ori,orj->oij", JpW, Jp))
        bc = sum_kf(-torch.einsum("ori,or->oi", JpW, r))
        Hll = _segment_sum(L, seg_lm, torch.einsum("ori,orj->oij", JlW, Jl))
        bl = _segment_sum(L, seg_lm, -torch.einsum("ori,or->oi", JlW, r))
        Wd = _segment_sum(K * L, seg_pair, torch.einsum("ori,orj->oij", JpW, Jl)).reshape(K, L, 6, 3)

        # Damped landmark blocks and their closed-form inverses.
        tr = torch.einsum("lii->l", Hll)
        dHll = Hll + (lam * tr / 3.0 + 1e-9)[:, None, None] * eye3
        Hll_inv = _inv3x3_sym(dHll)
        Hll_inv = torch.where(p.lm_valid[:, None, None], Hll_inv, torch.zeros_like(Hll_inv))

        # Schur complement.
        T = torch.einsum("alip,lpq->aliq", Wd, Hll_inv)  # (K,L,6,3)
        S = -torch.einsum("aliq,bljq->aibj", T, Wd)  # (K,6,K,6)
        S = S + torch.einsum("ab,aij->aibj", eyeK, Hcc)
        rhs = bc - torch.einsum("aliq,lq->ai", T, bl)  # (K,6)

        # Camera damping; fixed and invalid keyframes get identity rows.
        Sm = S.reshape(K * 6, K * 6) * dmask
        diag = torch.diagonal(Sm)
        new_diag = torch.where(free6 > 0, diag * (1.0 + lam) + 1e-8, torch.ones_like(diag))
        Sm = torch.where(eye6K, new_diag[None, :].expand(K * 6, K * 6), Sm)
        rhs_v = (rhs * free_f[:, None]).reshape(K * 6)

        dxc, info = torch.linalg.solve_ex(Sm, rhs_v, check_errors=False)
        dxc = dxc.reshape(K, 6) * free_f[:, None]
        # Back-substitute landmarks.
        bl_corr = bl - torch.einsum("alip,ai->lp", Wd, dxc)
        dxl = torch.einsum("lpq,lq->lp", Hll_inv, bl_corr) * lm_valid_f[:, None]

        # Candidate update.
        dR, dtr = lie.se3_exp(dxc)
        R_new = lie.so3_normalize(dR @ R)
        t_new = torch.einsum("kij,kj->ki", dR, t) + dtr
        Xw_new = Xw + dxl

        ok = (info == 0) & torch.all(torch.isfinite(dxc)) & torch.all(torch.isfinite(dxl))
        cost_old = cost_of(chi2, active)
        cost_new = build_cost(R_new, t_new, Xw_new, inlier)
        accept = ok & (cost_new < cost_old)
        lam = torch.where(accept, torch.clamp_min(lam * 0.5, 1e-7), torch.clamp_max(lam * 4.0, 1e2))
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        Xw = torch.where(accept, Xw_new, Xw)

    # Final inlier classification.
    r, _, _, z = resid(R, t, Xw)
    chi2 = chi2_of(r)
    inlier_final = p.obs_valid & (chi2 <= d2) & (z > 0)
    return BAResult(
        R=R, t=t, Xw=Xw, obs_inlier=inlier_final,
        cost=cost_of(chi2, inlier_final & (z > 0)),
        inlier_carry=inlier, lam=lam,
    )
