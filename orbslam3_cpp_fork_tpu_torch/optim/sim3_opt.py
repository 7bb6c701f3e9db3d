"""Sim(3) refinement between two keyframes from matched map points (port of
optim/sim3_opt.py; Optimizer::OptimizeSim3).

One Sim(3) vertex S12 and bidirectional reprojection edges

  e1 = obs1 - proj(K1, S12 * pc2)      (EdgeSim3ProjectXYZ)
  e2 = obs2 - proj(K2, S12^-1 * pc1)   (EdgeInverseSim3ProjectXYZ)

with a Huber kernel at sqrt(10) and two passes with chi2-10 inlier pruning
between them (a carried mask). Levenberg-Marquardt on the 7-dim tangent
(6-dim with the scale frozen, `fix_scale`), accept/reject by `torch.where`;
the Jacobian of the whitened residual is taken by forward-mode
differentiation, as the reference's `jax.jacfwd`.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import lie

CHI2_SIM3 = 10.0


@dataclasses.dataclass(frozen=True)
class Sim3Result:
    s: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor  # (N,)
    n_inliers: torch.Tensor


def _project(pc, fx, fy):
    z = torch.where(torch.abs(pc[..., 2]) < 1e-9, torch.full_like(pc[..., 2], 1e-9), pc[..., 2])
    return torch.stack([fx * pc[..., 0] / z, fy * pc[..., 1] / z], -1), pc[..., 2]


def optimize_sim3(
    s0, R0, t0,
    pc1: torch.Tensor,  # (N,3) points in camera-1 frame
    pc2: torch.Tensor,  # (N,3) points in camera-2 frame
    uv1: torch.Tensor,  # (N,2) centered pixel obs in image 1
    uv2: torch.Tensor,  # (N,2) centered pixel obs in image 2
    sigma2_1: torch.Tensor,
    sigma2_2: torch.Tensor,
    valid: torch.Tensor,
    fx, fy,
    fix_scale: bool = False,
    iters: int = 10,
) -> Sim3Result:
    """Refine S12 = (s0, R0, t0) mapping camera-2 coordinates to camera 1."""
    dev, dt = pc1.device, pc1.dtype
    s0 = torch.as_tensor(s0, dtype=dt, device=dev)
    inv_s1 = 1.0 / sigma2_1
    inv_s2 = 1.0 / sigma2_2

    def residuals(params, inlier):
        # A (1,7) batch: forward-mode tangents of 0-dim intermediates divided
        # by a Python scalar come out float64.
        ds, dR, dtr = (x[0] for x in lie.sim3_exp(params[None]))
        s = s0 * ds
        R = dR @ R0
        t = ds * (dR @ t0) + dtr
        p1 = s * (pc2 @ R.T) + t  # pc2 -> cam1
        pr1, z1 = _project(p1, fx, fy)
        e1 = uv1 - pr1
        p2 = (pc1 - t) @ R / s  # pc1 -> cam2 through S^-1
        pr2, z2 = _project(p2, fx, fy)
        e2 = uv2 - pr2
        chi1 = torch.sum(e1 * e1, -1) * inv_s1
        chi2 = torch.sum(e2 * e2, -1) * inv_s2
        w = (inlier & valid).to(torch.float32)
        w1 = w * (z1 > 0)
        w2 = w * (z2 > 0)
        return e1, e2, chi1, chi2, w1 * inv_s1, w2 * inv_s2

    def rho(chi):
        return torch.where(chi <= CHI2_SIM3, chi, 2.0 * torch.sqrt(chi * CHI2_SIM3) - CHI2_SIM3)

    def robust_cost(params, inlier):
        _, _, chi1, chi2, _, _ = residuals(params, inlier)
        w = (inlier & valid).to(torch.float32)
        return torch.sum(w * (rho(chi1) + rho(chi2)))

    eye7 = torch.eye(7, dtype=dt, device=dev)
    free = torch.ones(7, dtype=dt, device=dev)
    if fix_scale:
        free[6] = 0.0

    def lm_step(params, inlier, lam, cost):
        # Levenberg-Marquardt with accept/reject: near-coincident cameras make
        # the scale unobservable, and LM keeps the step small along it.
        _, _, chi1, chi2, _, _ = residuals(params, inlier)
        h1 = torch.clamp_max(torch.sqrt(CHI2_SIM3 / torch.clamp_min(chi1, 1e-12)), 1.0)
        h2 = torch.clamp_max(torch.sqrt(CHI2_SIM3 / torch.clamp_min(chi2, 1e-12)), 1.0)

        def flat_res(p):
            e1, e2, _, _, w1, w2 = residuals(p, inlier)
            return torch.cat([e1 * torch.sqrt(w1 * h1)[:, None], e2 * torch.sqrt(w2 * h2)[:, None]]).reshape(-1)

        r = flat_res(params)
        J = torch.func.jacfwd(flat_res)(params) * free  # (4N, 7)
        H = J.T @ J
        g = -J.T @ r
        if fix_scale:
            H = torch.where(eye7.bool() & (free == 0), torch.ones_like(H), H)
        dx, info = torch.linalg.solve_ex(H + lam * eye7, g, check_errors=False)
        cand = params + dx
        new_cost = robust_cost(cand, inlier)
        ok = torch.all(torch.isfinite(dx)) & (info == 0) & (new_cost < cost)
        params = torch.where(ok, cand, params)
        cost = torch.where(ok, new_cost, cost)
        lam = torch.where(ok, torch.clamp_min(lam * 0.5, 1e-5), torch.clamp_max(lam * 4.0, 1e6))
        return params, lam, cost

    def run_pass(params, inlier, length):
        lam = torch.tensor(1e-3, dtype=dt, device=dev)
        cost = robust_cost(params, inlier)
        for _ in range(length):
            params, lam, cost = lm_step(params, inlier, lam, cost)
        return params

    params = torch.zeros(7, dtype=dt, device=dev)
    params = run_pass(params, valid, iters // 2)
    # Inlier pruning at chi2 10 in both images.
    _, _, chi1, chi2, _, _ = residuals(params, valid)
    inlier = valid & (chi1 < CHI2_SIM3) & (chi2 < CHI2_SIM3)
    params = run_pass(params, inlier, iters - iters // 2)
    _, _, chi1, chi2, _, _ = residuals(params, inlier)
    inlier = valid & (chi1 < CHI2_SIM3) & (chi2 < CHI2_SIM3)

    ds, dR, dtr = lie.sim3_exp(params)
    return Sim3Result(
        s=s0 * ds, R=lie.so3_normalize(dR @ R0), t=ds * (dR @ t0) + dtr,
        inliers=inlier, n_inliers=torch.sum(inlier.to(torch.int32)),
    )
