"""Reprojection residuals with analytic Jacobians (port of optim/residuals.py).

Pose convention: Tcw = (R, t) world->camera, left-multiplicative tangent
update T' = exp(xi) * T with xi = (rho, phi), as g2o::VertexSE3Expmap.
Ported: the Huber IRLS weight, the mono residual, the stereo residual
(whose first two rows are the mono one) that pose optimization and window
BA share, the stereo residual over a world->body pose that the
visual-inertial solvers use, and the 9-dim preintegration residual.
"""

from __future__ import annotations

import torch

from ..ops import imu as imu_ops
from ..utils import lie

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def huber_weight(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """IRLS weight of the Huber kernel on squared error chi2."""
    return torch.where(
        chi2 <= delta2, torch.ones_like(chi2), torch.sqrt(delta2 / torch.clamp_min(chi2, 1e-12))
    )


def mono_reprojection(R, t, Xw, uv, fx, fy):
    """Mono residual (u, v) (EdgeSE3ProjectXYZ); uv (N,2) centered
    observations. Returns r (N,2), J_pose (N,2,6), J_point (N,2,3), z (N,)."""
    pc = lie.se3_apply(R, t, Xw)
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    z_safe = torch.where(z < 1e-6, torch.full_like(z, 1e-6), z)
    iz = 1.0 / z_safe
    iz2 = iz * iz
    r = torch.stack([fx * x * iz, fy * y * iz], dim=-1) - uv
    zero = torch.zeros_like(x)
    Jproj = torch.stack(
        [
            torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1),
            torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1),
        ],
        dim=-2,
    )  # (N,2,3)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(*pc.shape[:-1], 3, 3)
    Jx = torch.cat([eye, -lie.hat(pc)], dim=-1)  # (N,3,6)
    return r, Jproj @ Jx, Jproj @ R.expand(*pc.shape[:-1], 3, 3), z


def stereo_reprojection(R, t, Xw, uvr, fx, fy, bf):
    """Stereo residual (u, v, u_right) with u_r = u - bf/z
    (EdgeStereoSE3ProjectXYZ); uvr (N,3) centered observations.
    Returns r (N,3), J_pose (N,3,6), J_point (N,3,3), z (N,)."""
    pc = lie.se3_apply(R, t, Xw)
    r, Jproj, z = project_stereo(pc, uvr, fx, fy, bf)
    Jx = pose_jacobian_frame(pc)  # (N,3,6)
    J_pose = Jproj @ Jx
    J_point = Jproj @ R.expand(*pc.shape[:-1], 3, 3)
    return r, J_pose, J_point, z


def project_stereo(pc, uvr, fx, fy, bf):
    """Camera points pc (N,3) -> the residual (u, v, u_right) against uvr,
    d(u, v, u_right)/d(pc) (N,3,3) and the depth z; elementwise."""
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    z_safe = torch.where(z < 1e-6, torch.full_like(z, 1e-6), z)
    iz = 1.0 / z_safe
    iz2 = iz * iz
    u = fx * x * iz
    v = fy * y * iz
    ur = u - bf * iz
    r = torch.stack([u, v, ur], dim=-1) - uvr
    zero = torch.zeros_like(x)
    Jproj = torch.stack(
        [
            torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1),
            torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1),
            torch.stack([fx * iz, zero, (-fx * x + bf) * iz2], dim=-1),
        ],
        dim=-2,
    )  # (N,3,3)
    return r, Jproj, z


def pose_jacobian_frame(pc):
    """d(pc)/d(left se3 increment) = [I, -hat(pc)] (N,3,6)."""
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(*pc.shape[:-1], 3, 3)
    return torch.cat([eye, -lie.hat(pc)], dim=-1)


def stereo_reprojection_body(Rwb, twb, Xw, uvr, Rcb, tcb, fx, fy, bf):
    """Reprojection residual over the world->body pose of visual-inertial
    optimization (EdgeMono/EdgeStereo over VertexPose,
    include/G2oTypes.h:366-528), with ImuCamPose::Update's right-
    multiplicative update Rwb <- Rwb Exp(dphi), twb <- twb + Rwb dp.
    Rcb/tcb map body to camera coordinates (pc = Rcb x_b + tcb).
    Returns r (N,3), J_pose (N,3,6) wrt [dphi, dp], J_point (N,3,3), z (N,);
    the caller masks the third row of mono observations."""
    y = torch.einsum("...ji,...j->...i", Rwb, Xw - twb)  # body coordinates
    pc = torch.einsum("ij,...j->...i", Rcb, y) + tcb
    r, Jproj, z = project_stereo(pc, uvr, fx, fy, bf)
    # dpc/dphi = Rcb hat(y); dpc/dp = -Rcb; dpc/dXw = Rcb Rwb^T.
    dpc_dphi = torch.einsum("ij,...jk->...ik", Rcb, lie.hat(y))
    dpc_dp = (-Rcb).expand(*pc.shape[:-1], 3, 3)
    J_pose = torch.cat([Jproj @ dpc_dphi, Jproj @ dpc_dp], dim=-1)
    Rcw = torch.einsum("ij,...kj->...ik", Rcb, Rwb)
    J_point = Jproj @ Rcw.expand(*pc.shape[:-1], 3, 3)
    return r, J_pose, J_point, z


def inertial_residual(Rwb1, p1, v1, bg, ba, Rwb2, p2, v2, pre: imu_ops.Preintegrated):
    """9-dim preintegration residual [er, ev, ep] between body states 1 and 2
    (EdgeInertial::computeError, src/G2oTypes.cc), with (bg, ba) state 1's
    biases, and its information, the inverse of the preintegrated 9x9
    covariance, symmetrized. A singular covariance gives a NaN information
    (the reference's inverse gives inf/NaN there too)."""
    dT = pre.dT[..., None]
    g = imu_ops.gravity_vec(Rwb1.device, Rwb1.dtype)
    dR = imu_ops.delta_rotation(pre, bg)
    dV = imu_ops.delta_velocity(pre, bg, ba)
    dP = imu_ops.delta_position(pre, bg, ba)
    R1t = Rwb1.transpose(-1, -2)
    er = lie.so3_log(dR.transpose(-1, -2) @ R1t @ Rwb2)
    ev = torch.einsum("...ij,...j->...i", R1t, v2 - v1 - g * dT) - dV
    ep = torch.einsum("...ij,...j->...i", R1t, p2 - p1 - v1 * dT - 0.5 * g * dT * dT) - dP
    C = pre.C[..., :9, :9] + torch.eye(9, dtype=pre.C.dtype, device=pre.C.device) * 1e-9
    info = nan_where_failed(*torch.linalg.inv_ex(C, check_errors=False))
    return torch.cat([er, ev, ep], dim=-1), 0.5 * (info + info.transpose(-1, -2))


def nan_where_failed(x: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """The result of a `*_ex` factorization or solve with NaN wherever its
    `info` flags a failure: JAX returns NaN or inf there, and the LM loops
    reject a non-finite step, where torch's checked calls would raise."""
    bad = (info != 0).reshape(info.shape + (1,) * (x.dim() - info.dim()))
    return torch.where(bad, torch.full_like(x, float("nan")), x)
