"""Reprojection residuals with analytic Jacobians (port of optim/residuals.py).

Pose convention: Tcw = (R, t) world->camera, left-multiplicative tangent
update T' = exp(xi) * T with xi = (rho, phi), as g2o::VertexSE3Expmap.
Ported: the Huber IRLS weight, the mono residual, and the stereo residual
(whose first two rows are the mono one) that pose optimization and window
BA share.
"""

from __future__ import annotations

import torch

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
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(*pc.shape[:-1], 3, 3)
    Jx = torch.cat([eye, -lie.hat(pc)], dim=-1)  # (N,3,6)
    J_pose = Jproj @ Jx
    J_point = Jproj @ R.expand(*pc.shape[:-1], 3, 3)
    return r, J_pose, J_point, z
