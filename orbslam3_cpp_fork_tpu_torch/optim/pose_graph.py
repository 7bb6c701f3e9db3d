"""Pose-graph (essential-graph) optimization over Sim(3) / SE(3) / 4DoF
(port of optim/pose_graph.py; Optimizer::OptimizeEssentialGraph and its
4DoF variant).

Vertices are per-keyframe world-to-camera Sim(3) transforms, edges relative
Sim(3) measurements S_ji with the residual

    e(i,j) = log( S_ji_meas o S_i o S_j^-1 )  in sim(3)

Gauss-Newton with right-multiplicative tangent updates S_i <- S_i o exp(d_i),
so freezing tangent dimensions gives the reference's restricted variants
exactly (`FREE_DIMS`). Per-edge (7,14) Jacobians come from forward-mode
differentiation batched over all edges; the dense (7K,7K) normal system is
assembled with ordered segment sums (the same bits on every run) and solved
by LU. This is the exact-shape solver: the reference's bucket padding of K
and E exists only to avoid XLA recompiles and is not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import lie
from .local_ba import _segment_sum

FREE_DIMS = {
    "sim3": np.ones(7, np.float32),
    "se3": np.array([1, 1, 1, 1, 1, 1, 0], np.float32),
    "4dof": np.array([1, 1, 1, 0, 0, 1, 0], np.float32),
}


@dataclasses.dataclass(frozen=True)
class PoseGraphResult:
    s: torch.Tensor  # (K,)
    R: torch.Tensor  # (K,3,3)
    t: torch.Tensor  # (K,3)
    cost: torch.Tensor


def _edge_residual(si, Ri, ti, sj, Rj, tj, sm, Rm, tm):
    """log( S_m o S_i o S_j^-1 ) per edge (leading batch dimensions)."""
    sji, Rji, tji = lie.sim3_inv(sj, Rj, tj)
    s1, R1, t1 = lie.sim3_mul(si, Ri, ti, sji, Rji, tji)
    s2, R2, t2 = lie.sim3_mul(sm, Rm, tm, s1, R1, t1)
    return lie.sim3_log(s2, R2, t2)


def _batched_jacobian(f, x: torch.Tensor) -> torch.Tensor:
    """Jacobians of a row-wise map f: (E,n) -> (E,m) whose rows are
    independent: one forward-mode pass per input dimension, batched over the
    n basis directions. Returns (E,m,n)."""
    n = x.shape[1]
    basis = torch.eye(n, dtype=x.dtype, device=x.device)[:, None, :].expand(n, *x.shape)

    def column(v):
        return torch.func.jvp(f, (x,), (v,))[1]

    return torch.func.vmap(column)(basis).permute(1, 2, 0)


def optimize_pose_graph(
    s: torch.Tensor,  # (K,) initial scales (1 for SE3)
    R: torch.Tensor,  # (K,3,3) Tcw rotations
    t: torch.Tensor,  # (K,3)
    kf_valid: torch.Tensor,  # (K,)
    kf_fixed: torch.Tensor,  # (K,)
    edge_i: torch.Tensor,  # (E,) int64
    edge_j: torch.Tensor,  # (E,)
    edge_s: torch.Tensor,  # (E,) measured S_ji
    edge_R: torch.Tensor,  # (E,3,3)
    edge_t: torch.Tensor,  # (E,3)
    edge_w: torch.Tensor,  # (E,) weights (0 disables an edge slot)
    free_dims: torch.Tensor,  # (7,) 1 = optimized tangent dimension
    iters: int = 12,
    damping: float = 1e-5,
) -> PoseGraphResult:
    K = R.shape[0]
    dev, dt = R.device, R.dtype
    ei, ej = edge_i.long(), edge_j.long()
    E = ei.shape[0]
    free_dims = free_dims.to(dt)
    free_v = (kf_valid & ~kf_fixed).to(dt)  # (K,)
    mask = free_v[:, None] * free_dims[None, :]  # (K,7)
    n = K * 7
    mflat = mask.reshape(n)
    diag_at = torch.eye(n, dtype=torch.bool, device=dev)
    # Block targets of the four scatter-adds into the (K*K,7,7) block grid.
    seg = torch.cat([ei * K + ei, ej * K + ej, ei * K + ej, ej * K + ei])
    seg_b = torch.cat([ei, ej])

    cost = torch.zeros((), dtype=dt, device=dev)
    for _ in range(iters):
        si, Ri, ti = s[ei], R[ei], t[ei]
        sj, Rj, tj = s[ej], R[ej], t[ej]

        def edge_res_d(delta):
            dsi, dRi, dti = lie.sim3_exp(delta[:, :7] * free_dims)
            dsj, dRj, dtj = lie.sim3_exp(delta[:, 7:] * free_dims)
            si2, Ri2, ti2 = lie.sim3_mul(si, Ri, ti, dsi, dRi, dti)
            sj2, Rj2, tj2 = lie.sim3_mul(sj, Rj, tj, dsj, dRj, dtj)
            return _edge_residual(si2, Ri2, ti2, sj2, Rj2, tj2, edge_s, edge_R, edge_t)

        zero = torch.zeros((E, 14), dtype=dt, device=dev)
        r = edge_res_d(zero)  # (E,7)
        J = _batched_jacobian(edge_res_d, zero)  # (E,7,14)
        Ji, Jj = J[:, :, :7], J[:, :, 7:]
        w = edge_w[:, None, None]
        Hii = torch.einsum("eri,erj->eij", Ji * w, Ji)
        Hjj = torch.einsum("eri,erj->eij", Jj * w, Jj)
        Hij = torch.einsum("eri,erj->eij", Ji * w, Jj)
        bi = -torch.einsum("eri,er->ei", Ji * w, r)
        bj = -torch.einsum("eri,er->ei", Jj * w, r)

        blocks = _segment_sum(K * K, seg, torch.cat([Hii, Hjj, Hij, Hij.transpose(1, 2)]))
        H = blocks.reshape(K, K, 7, 7).permute(0, 2, 1, 3)  # (K,7,K,7)
        b = _segment_sum(K, seg_b, torch.cat([bi, bj]))

        # Freeze fixed vertices and disabled tangent dimensions.
        Hf = (H * mask[:, :, None, None] * mask[None, None, :, :]).reshape(n, n)
        diag = torch.diagonal(Hf)
        new_diag = torch.where(mflat > 0, diag * (1.0 + damping) + 1e-8, torch.ones_like(diag))
        Hf = torch.where(diag_at, new_diag[None, :].expand(n, n), Hf)
        dx, info = torch.linalg.solve_ex(Hf, (b * mask).reshape(n), check_errors=False)
        dx = dx.reshape(K, 7) * mask
        ok = torch.all(torch.isfinite(dx)) & (info == 0)
        dx = torch.where(ok, dx, torch.zeros_like(dx))

        ds, dR, dtr = lie.sim3_exp(dx)
        s, R, t = lie.sim3_mul(s, R, t, ds, dR, dtr)
        R = lie.so3_normalize(R)
        cost = torch.sum(edge_w * torch.sum(r * r, -1))
    return PoseGraphResult(s=s, R=R, t=t, cost=cost)


def relative_sim3(s, R, t, i, j):
    """Measured S_ji = S_j o S_i^-1 from absolute poses (numpy or tensors)."""
    T = lambda x: torch.as_tensor(np.asarray(x, np.float32))  # noqa: E731
    si, Ri, ti = lie.sim3_inv(T(s[i]), T(R[i]), T(t[i]))
    return lie.sim3_mul(T(s[j]), T(R[j]), T(t[j]), si, Ri, ti)
