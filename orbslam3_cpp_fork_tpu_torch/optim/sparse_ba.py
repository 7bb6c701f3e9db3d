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
solvers are interchangeable per problem size. Every product of small
per-observation blocks is written as elementwise products and adds
(`_mm`, `_mv`): a batched GEMM on the card picks its kernel by the batch
size, and a row's bits would then depend on how many rows share the call.

Every sum over the observation rows (the normal-equation blocks, the two
segment sums of each CG matvec, the back-substitution and the reprojection
cost) runs in one fixed order (`_ObsSums`): the rows fall into `CHUNKS`
contiguous chunks, each chunk is an ordered segment sum of its own, and the
chunk sums are added up a binary tree, adjacent pairs first. Two runs give
the same bits, and so does the same solve with its rows sharded.

Observation sharding (parallel/dist_ba.py): with a `torch.distributed`
process group of n ranks (n dividing `CHUNKS`), the observation arrays are
this rank's shard, an aligned block of the chunks, and the keyframe and
landmark state is replicated. A rank sums its block up its subtree; the n
subtree sums meet in one all-reduce of a zero-filled (n, ...) buffer, one
slot a rank (a slot plus zeros is the slot, exactly), and every rank adds
the slots up the top of the same tree (with two ranks the all-reduce's own
sum is that top: two values add the same in either order). The sharded solve therefore computes
the local solve's bits on any map, however badly conditioned. Sums that do
not depend on each other share one all-reduce. The inertial chain of
`sparse_vi_ba` (O(K) edges, replicated) is computed on every rank without a
collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils import lie
from . import residuals
from .inertial import D, VIBAProblem, VIBAResult, _ViModel, _vi_states
from .local_ba import BAProblem, BAResult, _huber_rho, _segment_sum
from .residuals import nan_where_failed, pose_jacobian_frame, project_stereo

CHUNKS = 8  # observation chunks of every sum over observations (module docstring)

# All-reduces issued by `_psum` in this process (read by the smoke and the
# tests; a sharded solve's count is the difference around it).
n_all_reduces = 0


def _psum(group, x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the ranks of `group` by one all-reduce."""
    global n_all_reduces
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    n_all_reduces += 1
    return x


def _mm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Per-row (..., a, k) @ (..., k, b) as elementwise products added in the
    order k = 0, 1, ... (module docstring)."""
    out = A[..., :, 0, None] * B[..., None, 0, :]
    for k in range(1, A.shape[-1]):
        out = out + A[..., :, k, None] * B[..., None, k, :]
    return out


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-row (..., a, k) @ (..., k), as `_mm`."""
    out = A[..., 0] * x[..., 0, None]
    for k in range(1, A.shape[-1]):
        out = out + A[..., k] * x[..., k, None]
    return out


def _T(A: torch.Tensor) -> torch.Tensor:
    return A.transpose(-1, -2)


def _sq3(r: torch.Tensor) -> torch.Tensor:
    """Squared norm of (..., 3) rows, elementwise."""
    return r[..., 0] * r[..., 0] + r[..., 1] * r[..., 1] + r[..., 2] * r[..., 2]


def _row_weights(obs_stereo: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(O,3) row mask: mono observations carry no third residual."""
    dev, dt = like.device, like.dtype
    return torch.where(obs_stereo[:, None], torch.ones(3, dtype=dt, device=dev),
                       torch.tensor([1.0, 1.0, 0.0], dtype=dt, device=dev))


def _reprojection_rows(p: BAProblem, R, t, Xw):
    """residuals.stereo_reprojection over the observations of `p` with the
    per-row products of `_mm` / `_mv`, mono rows masked: (r, J_pose,
    J_point, z)."""
    obs_kf, obs_lm = p.obs_kf.long(), p.obs_lm.long()
    Ro = R[obs_kf]
    pc = _mv(Ro, Xw[obs_lm]) + t[obs_kf]
    r, Jproj, z = project_stereo(pc, p.obs_uvr, p.fx, p.fy, p.bf)
    w = _row_weights(p.obs_stereo, Xw)
    return r * w, _mm(Jproj, pose_jacobian_frame(pc)) * w[..., None], _mm(Jproj, Ro) * w[..., None], z


class _RowViModel(_ViModel):
    """`_ViModel` whose reprojection rows and chi2 use `_mm` / `_mv`
    (residuals.stereo_reprojection_body's math)."""

    def reproj(self, Rwb, twb, Xw):
        p = self.p
        Rb = Rwb[self.obs_kf]
        y = _mv(_T(Rb), Xw[self.obs_lm] - twb[self.obs_kf])  # body coordinates
        pc = _mv(p.Rcb, y) + p.tcb
        r, Jproj, z = project_stereo(pc, p.obs_uvr, p.fx, p.fy, p.bf)
        # dpc/dphi = Rcb hat(y); dpc/dp = -Rcb; dpc/dXw = Rcb Rwb^T.
        J_pose = torch.cat([_mm(Jproj, _mm(p.Rcb, lie.hat(y))), _mm(Jproj, -p.Rcb)], dim=-1)
        J_point = _mm(Jproj, _mm(p.Rcb, _T(Rb)))
        w = self.row_w
        return r * w, J_pose * w[..., None], J_point * w[..., None], z

    def chi2_of(self, r):
        return _sq3(r) / self.p.obs_sigma2


def _tree(x: torch.Tensor) -> torch.Tensor:
    """(m, ...) -> (...): adjacent pairs added, level by level (m a power of
    two)."""
    while x.shape[0] > 1:
        x = x[0::2] + x[1::2]
    return x[0]


class _ObsSums:
    """Sums over the observation rows of a problem (or of this rank's shard
    of it) in the order of the module docstring: `kf`, `lm` and `rows` give
    this rank's per-chunk partial sums, (m, K, ...), (m, L, ...) and (m,);
    `total` adds partials up the tree and over the ranks of `group`."""

    def __init__(self, K: int, L: int, obs_kf, obs_lm, obs_valid, like: torch.Tensor, group=None):
        n, r = (1, 0) if group is None else (dist.get_world_size(group), dist.get_rank(group))
        if CHUNKS % n:
            raise ValueError(f"world size {n} does not divide the {CHUNKS} observation chunks")
        self.K, self.L, self.group, self.n, self.r, self.m = K, L, group, n, r, CHUNKS // n
        O_all = obs_kf.shape[0] * n  # every rank holds an equal shard
        off = r * obs_kf.shape[0]
        bounds = [c * O_all // CHUNKS - off for c in range(r * self.m, (r + 1) * self.m + 1)]
        self.spans = list(zip(bounds[:-1], bounds[1:]))
        dev = like.device
        obs_kf, obs_lm = obs_kf.long(), obs_lm.long()
        chunk = torch.cat([torch.full((b - a,), i, dtype=torch.long, device=dev) for i, (a, b) in enumerate(self.spans)])
        if like.is_cuda:
            # Keyframe sums as one (K, rows) one-hot product a chunk; padding
            # rows spread over the landmarks (no long serial chain at index 0).
            within = torch.cat([torch.arange(b - a, device=dev) for a, b in self.spans])
            self.lm_idx = chunk * L + torch.where(obs_valid, obs_lm, within % L)
            keys = torch.arange(K, device=dev)[:, None]
            self.onehot = [(obs_kf[None, a:b] == keys).to(like.dtype) for a, b in self.spans]
        else:
            self.onehot = None
            self.kf_idx = chunk * K + obs_kf
            self.lm_idx = chunk * L + obs_lm

    def kf(self, v: torch.Tensor) -> torch.Tensor:
        shape = (self.m, self.K, *v.shape[1:])
        if self.onehot is not None:
            return torch.stack([oh @ v[a:b].reshape(b - a, -1) for oh, (a, b) in zip(self.onehot, self.spans)]).reshape(shape)
        return _segment_sum(self.m * self.K, self.kf_idx, v).reshape(shape)

    def lm(self, v: torch.Tensor) -> torch.Tensor:
        return _segment_sum(self.m * self.L, self.lm_idx, v).reshape(self.m, self.L, *v.shape[1:])

    def rows(self, v: torch.Tensor) -> torch.Tensor:
        return torch.stack([v[a:b].sum() for a, b in self.spans])

    def total(self, *parts: torch.Tensor):
        """Each partial's total; one all-reduce for all of them with a group.
        Returns a tuple, or the tensor when given one."""
        subs = [_tree(x) for x in parts]
        if self.group is not None:
            flat = torch.cat([x.reshape(-1) for x in subs])
            if self.n == 2:  # the top of the tree: two values add the same in either order
                flat = _psum(self.group, flat)
            else:
                slots = torch.zeros((self.n, flat.numel()), dtype=flat.dtype, device=flat.device)
                slots[self.r] = flat
                flat = _tree(_psum(self.group, slots))
            subs = [v.view_as(x) for v, x in zip(torch.split(flat, [x.numel() for x in subs]), subs)]
        return tuple(subs) if len(subs) > 1 else subs[0]


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
    group=None,
) -> BAResult:
    """Whole-map visual BA (GlobalBundleAdjustemnt semantics) on a BAProblem
    of any size. With `group`, the obs_* arrays are this rank's shard of an
    observation set sharded over the group's ranks (module docstring)."""
    K = p.R.shape[0]
    L = p.Xw.shape[0]
    dev, dt = p.Xw.device, p.Xw.dtype
    obs_kf, obs_lm = p.obs_kf.long(), p.obs_lm.long()
    sums = _ObsSums(K, L, p.obs_kf, p.obs_lm, p.obs_valid, p.Xw, group)
    d2 = torch.where(p.obs_stereo, residuals.CHI2_STEREO, residuals.CHI2_MONO).to(dt)

    def resid(R, t, Xw):
        return _reprojection_rows(p, R, t, Xw)

    def chi2_of(r):
        return _sq3(r) / p.obs_sigma2

    def rho_rows(chi2, active):
        """Per-row robust cost of the active rows, 0 elsewhere."""
        rho = _huber_rho(chi2, d2) if robust else chi2
        return torch.where(active, rho, torch.zeros_like(rho))

    def cost(R, t, Xw, inlier):
        r, _, _, z = resid(R, t, Xw)
        return sums.total(sums.rows(rho_rows(chi2_of(r), inlier & p.obs_valid & (z > 0))))

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
        Wo = _mm(_T(JpW), Jl)  # (O,6,3)
        Hcc, bc, Hll, bl, cost_old = sums.total(
            sums.kf(_mm(_T(JpW), Jp)),
            sums.kf(-_mv(_T(JpW), r)),
            sums.lm(_mm(_T(JlW), Jl)),
            sums.lm(-_mv(_T(JlW), r)),
            sums.rows(rho_rows(chi2, active)),
        )

        dHll = Hll + (lam * torch.einsum("lii->l", Hll) / 3.0 + 1e-9)[:, None, None] * eye3
        Hll_inv = torch.linalg.inv_ex(dHll, check_errors=False)[0] * lm_f[..., None]

        # Reduced right-hand side bc - W Hll^-1 bl, and the exact block
        # diagonal of S for the preconditioner.
        hb = torch.einsum("lpq,lq->lp", Hll_inv, bl)
        WH = _mm(Wo, Hll_inv[obs_lm])  # (O,6,3)
        rhs_sub, S_sub = sums.total(sums.kf(_mv(Wo, hb[obs_lm])), sums.kf(_mm(WH, _T(Wo))))
        rhs = (bc - rhs_sub) * free_f
        dvec = torch.einsum("kii->ki", Hcc)  # damped diagonal of Hpp

        def matvec(x):
            xm = x * free_f
            u = _mv(_T(Wo), xm[obs_kf])  # (O,3)
            w = torch.einsum("lpq,lq->lp", Hll_inv, sums.total(sums.lm(u)))
            zz = sums.total(sums.kf(_mv(Wo, w[obs_lm])))
            out = torch.einsum("kij,kj->ki", Hcc, xm) - zz + (lam * dvec + 1e-8) * xm
            return out * free_f + x * (1.0 - free_f)

        Sdiag = Hcc - S_sub
        Sdiag = Sdiag + eye6 * (lam * dvec + 1e-6)[:, :, None] * eye6 + 1e-6 * eye6
        Pinv = torch.linalg.inv_ex(Sdiag, check_errors=False)[0]
        Pinv = torch.where(kf_free[:, None, None], Pinv, eye6)

        def precond(rv):
            return torch.einsum("kij,kj->ki", Pinv, rv)

        dxc = _pcg(matvec, rhs, precond, cg_iters) * free_f
        # Landmark back-substitution.
        bl_corr = bl - sums.total(sums.lm(_mv(_T(Wo), dxc[obs_kf])))
        dxl = torch.einsum("lpq,lq->lp", Hll_inv, bl_corr) * lm_f

        dR, dtr = lie.se3_exp(dxc)
        R_new = lie.so3_normalize(dR @ R)
        t_new = torch.einsum("kij,kj->ki", dR, t) + dtr
        Xw_new = Xw + dxl
        ok = torch.all(torch.isfinite(dxc)) & torch.all(torch.isfinite(dxl))
        cost_new = cost(R_new, t_new, Xw_new, inlier)
        accept = ok & (cost_new < cost_old)
        lam = torch.where(accept, torch.clamp_min(lam * 0.5, 1e-7), torch.clamp_max(lam * 4.0, 1e2))
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        Xw = torch.where(accept, Xw_new, Xw)

    r, _, _, z = resid(R, t, Xw)
    chi2 = chi2_of(r)
    inlier_final = p.obs_valid & (chi2 <= d2) & (z > 0)
    return BAResult(R=R, t=t, Xw=Xw, obs_inlier=inlier_final, cost=sums.total(sums.rows(rho_rows(chi2, inlier_final))))


def sparse_vi_ba(
    p: VIBAProblem,
    iters: int = 12,
    gate_at: int = 6,
    cg_iters: int = 80,
    damping_init: float = 1e-4,
    group=None,
) -> VIBAResult:
    """FullInertialBA at map scale: 15-dim body states, the landmarks
    eliminated matrix-free, the inertial and bias-walk chain edges applied as
    block-tridiagonal contributions inside the CG matvec. With `group`, the
    obs_* arrays are this rank's shard (module docstring); the chain and the
    bias prior are replicated and computed locally."""
    K, L = p.Rwb.shape[0], p.Xw.shape[0]
    dev, dt = p.Xw.device, p.Xw.dtype
    sums = _ObsSums(K, L, p.obs_kf, p.obs_lm, p.obs_valid, p.Xw, group)
    mdl = _RowViModel(p, reduce=lambda v: sums.total(sums.rows(v)))
    obs_kf, obs_lm = mdl.obs_kf, mdl.obs_lm
    ei, ej = mdl.ei, mdl.ej
    pk = int(p.prior_kf)

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
        Wo = _mm(_T(JpW), Jl)  # (O,6,3)
        Hcc6, bc6, Hll, bl = sums.total(
            sums.kf(_mm(_T(JpW), Jp)),
            sums.kf(-_mv(_T(JpW), r)),
            sums.lm(_mm(_T(JlW), Jl)),
            sums.lm(-_mv(_T(JlW), r)),
        )
        dHll = Hll + (lam * torch.einsum("lii->l", Hll) / 3.0 + 1e-9)[:, None, None] * eye3
        Hll_inv = nan_where_failed(*torch.linalg.inv_ex(dHll, check_errors=False)) * lm_f[..., None]

        # Inertial edge blocks at the current linearization.
        Hii, Hij, Hjj, bi, bj = mdl.edge_blocks(states)

        # Right-hand side over the full 15-dim states, and the landmark part
        # of the reduced system's block diagonal (the preconditioner below).
        hb = torch.einsum("lpq,lq->lp", Hll_inv, bl)
        WH = _mm(Wo, Hll_inv[obs_lm])
        rhs_sub, Ssub = sums.total(sums.kf(_mv(Wo, hb[obs_lm])), sums.kf(_mm(WH, _T(Wo))))
        rhs6 = bc6 - rhs_sub
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
            u = _mv(_T(Wo), x6[obs_kf])
            w = torch.einsum("lpq,lq->lp", Hll_inv, sums.total(sums.lm(u)))
            zz6 = sums.total(sums.kf(_mv(Wo, w[obs_lm])))
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
        P = Dblk.clone()
        P[:, :6, :6] -= Ssub
        P = P + (lam * dvec + 1e-6)[:, :, None] * eyeD + 1e-6 * eyeD
        Pinv = nan_where_failed(*torch.linalg.inv_ex(P, check_errors=False))
        Pinv = torch.where(kf_free[:, None, None], Pinv, eyeD)

        def precond(rv):
            return torch.einsum("kij,kj->ki", Pinv, rv)

        dx = _pcg(matvec, rhs, precond, cg_iters) * free_f
        bl_corr = bl - sums.total(sums.lm(_mv(_T(Wo), dx[obs_kf, :6])))
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
