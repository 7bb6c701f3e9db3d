"""Map-scale bundle adjustment: block-sparse Schur with matrix-free PCG
(port of optim/sparse_ba.py: the visual solver,
Optimizer::GlobalBundleAdjustemnt, run after a loop closure, and the
visual-inertial one, Optimizer::FullInertialBA at map scale).

The dense-blocked Schur of `local_ba` keeps the camera-landmark cross term
as a (K, L, 6, 3) tensor, right for a covisibility window but tens of GB at
map scale. Here landmark elimination is implicit: the reduced camera system

    S x = (Hpp - W Hll^-1 W^T) x

is applied matrix-free in O(observations) work (per-observation 6x3 W
blocks, two segment sums, one batched 3x3 product) and solved by conjugate
gradients preconditioned with the exact block diagonal of S. The LM loop
(damping, chi2 gating, Huber IRLS, mid-schedule inlier re-classification,
accept/reject on cost by `torch.where`) matches `local_ba`, so the two
solvers are interchangeable per problem size. Every segment sum is the
ordered form of `local_ba._segment_plan`: two runs give the same bits.

`sparse_vi_ba` is the single-device form. The reference also runs it with
its observations sharded over a device mesh; that is ROADMAP A14.
"""

from __future__ import annotations

import torch

from ..utils import lie
from . import residuals
from .inertial import D, VIBAProblem, VIBAResult, _ViModel, _vi_states
from .local_ba import BAProblem, BAResult, _residual_model, _segment_plan, _segment_sum, segment_plan
from .residuals import nan_where_failed


def _pcg(matvec, b, precond, iters: int, rtol: float = 1e-6):
    """Preconditioned conjugate gradients with convergence masking (fixed
    trip count, no host sync). b and x are (K,D)."""
    bb = torch.sum(b * b)
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    pv = z
    rz = torch.sum(r * z)
    zero = torch.zeros_like(rz)
    for _ in range(iters):
        Ap = matvec(pv)
        pAp = torch.sum(pv * Ap)
        active = (torch.sum(r * r) > rtol * rtol * bb) & (pAp > 1e-20)
        alpha = torch.where(active, rz / torch.clamp_min(pAp, 1e-20), zero)
        x = x + alpha * pv
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = torch.where(active, rz_new / torch.clamp_min(rz, 1e-20), zero)
        pv = z + beta * pv
        rz = torch.where(active, rz_new, rz)
    return x


def sparse_ba(
    p: BAProblem,
    iters: int = 12,
    gate_at: int = 6,
    cg_iters: int = 60,
    robust: bool = True,
    damping_init: float = 1e-4,
) -> BAResult:
    """Whole-map visual BA (GlobalBundleAdjustemnt semantics) on a BAProblem
    of any size."""
    K = p.R.shape[0]
    L = p.Xw.shape[0]
    dev, dt = p.Xw.device, p.Xw.dtype
    obs_kf, obs_lm = p.obs_kf.long(), p.obs_lm.long()
    sum_kf, seg_lm, _ = _segment_plan(p)
    resid, chi2_of, cost_of, build_cost, d2 = _residual_model(p, robust)

    def sum_lm(v):
        return _segment_sum(L, seg_lm, v)

    kf_free = p.kf_valid & ~p.kf_fixed
    free_f = kf_free.to(dt)[:, None]  # (K,1)
    lm_f = p.lm_valid.to(dt)[:, None]
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)

    R, t, Xw = p.R, p.t, p.Xw
    inlier = p.obs_valid
    lam = torch.tensor(damping_init, dtype=dt, device=dev)
    for it in range(iters):
        r, Jp, Jl, z = resid(R, t, Xw)
        chi2 = chi2_of(r)
        if it == gate_at:
            inlier = p.obs_valid & (chi2 <= d2) & (z > 0)
        active = inlier & p.obs_valid & (z > 0)
        w_h = residuals.huber_weight(chi2, d2) if robust else torch.ones_like(chi2)
        wgt = active.to(dt) * w_h / p.obs_sigma2

        JpW = Jp * wgt[:, None, None]  # (O,3,6)
        JlW = Jl * wgt[:, None, None]  # (O,3,3)
        # Per-observation blocks: each (kf, lm) pair has at most one
        # observation, so these are the block-sparse W entries.
        Wo = torch.einsum("ori,orj->oij", JpW, Jl)  # (O,6,3)
        Hcc = sum_kf(torch.einsum("ori,orj->oij", JpW, Jp))
        bc = sum_kf(-torch.einsum("ori,or->oi", JpW, r))
        Hll = sum_lm(torch.einsum("ori,orj->oij", JlW, Jl))
        bl = sum_lm(-torch.einsum("ori,or->oi", JlW, r))

        dHll = Hll + (lam * torch.einsum("lii->l", Hll) / 3.0 + 1e-9)[:, None, None] * eye3
        Hll_inv = torch.linalg.inv_ex(dHll, check_errors=False)[0] * lm_f[..., None]

        # Reduced right-hand side: bc - W Hll^-1 bl.
        hb = torch.einsum("lpq,lq->lp", Hll_inv, bl)
        rhs = (bc - sum_kf(torch.einsum("oij,oj->oi", Wo, hb[obs_lm]))) * free_f
        dvec = torch.einsum("kii->ki", Hcc)  # damped diagonal of Hpp

        def matvec(x):
            xm = x * free_f
            u = torch.einsum("oij,oi->oj", Wo, xm[obs_kf])  # (O,3)
            w = torch.einsum("lpq,lq->lp", Hll_inv, sum_lm(u))
            zz = sum_kf(torch.einsum("oij,oj->oi", Wo, w[obs_lm]))
            out = torch.einsum("kij,kj->ki", Hcc, xm) - zz + (lam * dvec + 1e-8) * xm
            return out * free_f + x * (1.0 - free_f)

        # Exact block diagonal of S for the preconditioner.
        WH = torch.einsum("oij,ojq->oiq", Wo, Hll_inv[obs_lm])  # (O,6,3)
        Sdiag = Hcc - sum_kf(torch.einsum("oiq,ojq->oij", WH, Wo))
        Sdiag = Sdiag + eye6 * (lam * dvec + 1e-6)[:, :, None] * eye6 + 1e-6 * eye6
        Pinv = torch.linalg.inv_ex(Sdiag, check_errors=False)[0]
        Pinv = torch.where(kf_free[:, None, None], Pinv, eye6)

        def precond(rv):
            return torch.einsum("kij,kj->ki", Pinv, rv)

        dxc = _pcg(matvec, rhs, precond, cg_iters) * free_f
        # Landmark back-substitution.
        bl_corr = bl - sum_lm(torch.einsum("oij,oi->oj", Wo, dxc[obs_kf]))
        dxl = torch.einsum("lpq,lq->lp", Hll_inv, bl_corr) * lm_f

        dR, dtr = lie.se3_exp(dxc)
        R_new = lie.so3_normalize(dR @ R)
        t_new = torch.einsum("kij,kj->ki", dR, t) + dtr
        Xw_new = Xw + dxl
        ok = torch.all(torch.isfinite(dxc)) & torch.all(torch.isfinite(dxl))
        cost_old = cost_of(chi2, active)
        cost_new = build_cost(R_new, t_new, Xw_new, inlier)
        accept = ok & (cost_new < cost_old)
        lam = torch.where(accept, torch.clamp_min(lam * 0.5, 1e-7), torch.clamp_max(lam * 4.0, 1e2))
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        Xw = torch.where(accept, Xw_new, Xw)

    r, _, _, z = resid(R, t, Xw)
    chi2 = chi2_of(r)
    inlier_final = p.obs_valid & (chi2 <= d2) & (z > 0)
    return BAResult(R=R, t=t, Xw=Xw, obs_inlier=inlier_final, cost=cost_of(chi2, inlier_final))


def sparse_vi_ba(
    p: VIBAProblem,
    iters: int = 12,
    gate_at: int = 6,
    cg_iters: int = 80,
    damping_init: float = 1e-4,
    axis_name: str | None = None,
) -> VIBAResult:
    """FullInertialBA at map scale: 15-dim body states, the landmarks
    eliminated matrix-free, the inertial and bias-walk chain edges applied as
    block-tridiagonal contributions inside the CG matvec."""
    if axis_name is not None:
        raise NotImplementedError("the sharded visual-inertial BA is not ported yet (ROADMAP A14)")
    K, L = p.Rwb.shape[0], p.Xw.shape[0]
    dev, dt = p.Xw.device, p.Xw.dtype
    mdl = _ViModel(p)
    sum_kf, seg_lm, _ = segment_plan(K, L, p.obs_kf, p.obs_lm, p.obs_valid, p.Xw)
    obs_kf, obs_lm = mdl.obs_kf, mdl.obs_lm
    ei, ej = mdl.ei, mdl.ej
    pk = int(p.prior_kf)

    def sum_lm(v):
        return _segment_sum(L, seg_lm, v)

    kf_free = p.kf_valid & ~p.kf_fixed
    free_f = kf_free.to(dt)[:, None]  # (K,1)
    lm_f = p.lm_valid.to(dt)[:, None]
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eyeD = torch.eye(D, dtype=dt, device=dev)
    prior_H = torch.diag(mdl.prior_diag)

    states, Xw = _vi_states(p), p.Xw
    inlier = p.obs_valid
    lam = torch.full((), damping_init, dtype=dt, device=dev)
    c_old = None
    for it in range(iters):
        if it == gate_at:
            inlier = mdl.gate(states, Xw)
            c_old = None
        if c_old is None:
            # The cost of the current state, carried between iterations (an
            # accepted step's new cost; the reference recomputes it).
            c_old = mdl.build_cost(states, Xw, inlier)
        r, Jp, Jl, z = mdl.reproj(states[0], states[1], Xw)
        chi2 = mdl.chi2_of(r)
        active = inlier & p.obs_valid & (z > 0)
        wgt = active.to(dt) * residuals.huber_weight(chi2, mdl.d2) / p.obs_sigma2

        JpW = Jp * wgt[:, None, None]
        JlW = Jl * wgt[:, None, None]
        Wo = torch.einsum("ori,orj->oij", JpW, Jl)  # (O,6,3)
        Hcc6 = sum_kf(torch.einsum("ori,orj->oij", JpW, Jp))
        bc6 = sum_kf(-torch.einsum("ori,or->oi", JpW, r))
        Hll = sum_lm(torch.einsum("ori,orj->oij", JlW, Jl))
        bl = sum_lm(-torch.einsum("ori,or->oi", JlW, r))
        dHll = Hll + (lam * torch.einsum("lii->l", Hll) / 3.0 + 1e-9)[:, None, None] * eye3
        Hll_inv = nan_where_failed(*torch.linalg.inv_ex(dHll, check_errors=False)) * lm_f[..., None]

        # Inertial edge blocks at the current linearization.
        Hii, Hij, Hjj, bi, bj = mdl.edge_blocks(states)

        # Right-hand side over the full 15-dim states.
        hb = torch.einsum("lpq,lq->lp", Hll_inv, bl)
        rhs6 = bc6 - sum_kf(torch.einsum("oij,oj->oi", Wo, hb[obs_lm]))
        rhs = torch.cat([rhs6, torch.zeros((K, D - 6), dtype=dt, device=dev)], 1)
        rhs = rhs + _segment_sum(K, ei, bi)
        rhs = rhs + _segment_sum(K, ej, bj)
        rhs[pk] += mdl.prior_rhs(states)
        rhs = rhs * free_f

        # Block diagonal (the damping vector and the preconditioner).
        Dblk = torch.zeros((K, D, D), dtype=dt, device=dev)
        Dblk[:, :6, :6] = Hcc6
        Dblk = Dblk + _segment_sum(K, ei, Hii)
        Dblk = Dblk + _segment_sum(K, ej, Hjj)
        Dblk[pk] += prior_H
        dvec = torch.einsum("kii->ki", Dblk)  # (K,D)

        def matvec(x):
            xm = x * free_f
            x6 = xm[:, :6]
            u = torch.einsum("oij,oi->oj", Wo, x6[obs_kf])
            w = torch.einsum("lpq,lq->lp", Hll_inv, sum_lm(u))
            zz6 = sum_kf(torch.einsum("oij,oj->oi", Wo, w[obs_lm]))
            out = torch.cat([torch.einsum("kij,kj->ki", Hcc6, x6) - zz6,
                             torch.zeros((K, D - 6), dtype=dt, device=dev)], 1)
            # Chain: y_i += Hii x_i + Hij x_j; y_j += Hij^T x_i + Hjj x_j.
            xi, xj = xm[ei], xm[ej]
            out = out + _segment_sum(K, ei, torch.einsum("eij,ej->ei", Hii, xi) + torch.einsum("eij,ej->ei", Hij, xj))
            out = out + _segment_sum(K, ej, torch.einsum("eji,ej->ei", Hij, xi) + torch.einsum("eij,ej->ei", Hjj, xj))
            prior = torch.zeros_like(out)
            prior[pk] = mdl.prior_diag * xm[pk]
            out = out + prior + (lam * dvec + 1e-8) * xm
            return out * free_f + x * (1.0 - free_f)

        # Preconditioner: the exact block diagonal of the reduced system.
        WH = torch.einsum("oij,ojq->oiq", Wo, Hll_inv[obs_lm])
        Ssub = sum_kf(torch.einsum("oiq,ojq->oij", WH, Wo))
        P = Dblk.clone()
        P[:, :6, :6] -= Ssub
        P = P + (lam * dvec + 1e-6)[:, :, None] * eyeD + 1e-6 * eyeD
        Pinv = nan_where_failed(*torch.linalg.inv_ex(P, check_errors=False))
        Pinv = torch.where(kf_free[:, None, None], Pinv, eyeD)

        def precond(rv):
            return torch.einsum("kij,kj->ki", Pinv, rv)

        dx = _pcg(matvec, rhs, precond, cg_iters) * free_f
        bl_corr = bl - sum_lm(torch.einsum("oij,oi->oj", Wo, dx[obs_kf, :6]))
        dxl = torch.einsum("lpq,lq->lp", Hll_inv, bl_corr) * lm_f

        states_new = mdl.retract_all(states, dx)
        Xw_new = Xw + dxl
        ok = torch.all(torch.isfinite(dx)) & torch.all(torch.isfinite(dxl))
        c_new = mdl.build_cost(states_new, Xw_new, inlier)
        accept = ok & (c_new < c_old)
        c_old = torch.where(accept, c_new, c_old)
        lam = torch.where(accept, torch.clamp_min(lam * 0.5, 1e-7), torch.clamp_max(lam * 4.0, 1e2))
        states = tuple(torch.where(accept, n, o) for n, o in zip(states_new, states))
        Xw = torch.where(accept, Xw_new, Xw)

    inlier_final = mdl.gate(states, Xw)
    return VIBAResult(
        Rwb=states[0], twb=states[1], vel=states[2], bg=states[3], ba=states[4], Xw=Xw,
        obs_inlier=inlier_final, cost=mdl.build_cost(states, Xw, inlier_final),
    )
