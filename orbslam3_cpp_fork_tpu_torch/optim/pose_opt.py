"""Motion-only pose optimization (port of optim/pose_opt.py).

Optimizer::PoseOptimization: one SE(3) pose against fixed landmarks,
`rounds` rounds of `iters` damped Gauss-Newton steps on the dense 6x6
normal equations, chi2 inlier re-classification between rounds (5.991
mono / 7.815 stereo) and the Huber kernel in the first two rounds only.
The reference's `lax.scan` over rounds*iters steps is a Python loop here;
every decision inside it (re-classification, the non-finite guard) is a
`torch.where`, so the loop issues no host sync.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import lie
from . import residuals


@dataclasses.dataclass(frozen=True)
class PoseOptResult:
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor  # (N,) bool (valid & chi2-accepted)
    n_inliers: torch.Tensor


def chol_solve6(A: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve the small SPD system A x = b by Cholesky.

    Returns (x, ok): `ok` is False where the factorization failed; it is a
    device tensor (no error check, hence no host sync), for the caller's
    non-finite guard. The reference unrolls the same factorization by hand
    because LU lowers badly on a TPU; here it is one batched library call.
    """
    L, info = torch.linalg.cholesky_ex(A, check_errors=False)
    x = torch.cholesky_solve(b[..., None], L)[..., 0]
    return x, info == 0


def pose_optimization(
    R0: torch.Tensor,
    t0: torch.Tensor,
    Xw: torch.Tensor,
    uv: torch.Tensor,
    sigma2: torch.Tensor,
    valid: torch.Tensor,
    fx,
    fy,
    ur: torch.Tensor | None = None,
    bf=0.0,
    is_stereo: torch.Tensor | None = None,
    rounds: int = 4,
    iters: int = 10,
) -> PoseOptResult:
    """Optimize Tcw=(R0,t0) against fixed landmarks.

    Xw (N,3) world points; uv (N,2) centered undistorted pixels
    (u - cx, v - cy); sigma2 (N,) per-observation pyramid variance;
    valid (N,) observation mask. Stereo rows take ur (N,) centered
    right-u, bf (baseline*fx) and is_stereo (N,).
    """
    n = Xw.shape[0]
    dev, dt = Xw.device, Xw.dtype
    if ur is None:
        ur = torch.zeros((n,), dtype=dt, device=dev)
    if is_stereo is None:
        is_stereo = torch.zeros((n,), dtype=torch.bool, device=dev)
    uvr = torch.cat([uv, ur[:, None]], dim=-1)
    inv_sigma2 = 1.0 / sigma2
    # Mono rows use only (u, v); stereo rows also u_right.
    one = torch.ones((n,), dtype=dt, device=dev)
    w_row = torch.stack([one, one, is_stereo.to(dt)], dim=-1)
    delta2 = torch.where(is_stereo, residuals.CHI2_STEREO, residuals.CHI2_MONO).to(dt)
    eye6 = torch.eye(6, dtype=dt, device=dev)

    def linearize(R, t):
        r3, Jp3, _, z = residuals.stereo_reprojection(R, t, Xw, uvr, fx, fy, bf)
        r = r3 * w_row
        chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
        return r, Jp3 * w_row[..., None], chi2, z

    R, t, inlier = R0, t0, valid
    for step in range(rounds * iters):
        # Re-classify at the first linearization of every round after the
        # first; the Huber kernel is dropped in rounds 3 and 4.
        reclass = step % iters == 0 and step > 0
        robust = step // iters < 2
        r, Jp, chi2, z = linearize(R, t)
        if reclass:
            inlier = valid & (chi2 <= delta2) & (z > 0)
        w_huber = residuals.huber_weight(chi2, delta2) if robust else torch.ones_like(chi2)
        wgt = (inlier & valid & (z > 0)).to(dt) * inv_sigma2 * w_huber
        H = torch.einsum("nri,n,nrj->ij", Jp, wgt, Jp)
        b = -torch.einsum("nri,n,nr->i", Jp, wgt, r)
        # Small fixed Levenberg damping keeps steps stable without a
        # host-synced accept/reject loop.
        damp = 1e-3 * torch.diag(torch.diag(H)) + 1e-8 * eye6
        dx, solved = chol_solve6(H + damp, b)
        dR, dtr = lie.se3_exp(dx)
        R_new, t_new = lie.se3_mul(dR, dtr, R, t)
        ok = solved & torch.all(torch.isfinite(dx))
        R = lie.so3_normalize(torch.where(ok, R_new, R))
        t = torch.where(ok, t_new, t)
    # Final re-classification at the converged pose.
    _, _, chi2, z = linearize(R, t)
    inlier = valid & (chi2 <= delta2) & (z > 0)
    return PoseOptResult(R=R, t=t, inliers=inlier, n_inliers=torch.sum(inlier.to(torch.int32)))
