"""SO(3)/SE(3) helpers for the tracking path (port of utils/lie.py).

Rotations are (...,3,3) matrices and SE(3) poses are (R, t) acting as
x -> R @ x + t (Tcw maps world to camera). Every function broadcasts over
leading batch dimensions and selects small-angle Taylor branches with
`torch.where` on safe operands, as the reference does. The rest of the
reference module (so3_log, Sim(3), right-Jacobian inverse) waits for the
slices that need it: neither tracking nor local mapping reaches it.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: w (...,3) -> skew-symmetric (...,3,3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def _theta(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp_min(theta2, 0.0))
    safe = torch.where(theta < _EPS, torch.ones_like(theta), theta)
    return theta, safe


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: (...,3) tangent -> (...,3,3) rotation."""
    theta, safe = _theta(w)
    theta2 = torch.sum(w * w, dim=-1)
    W = hat(w)
    WW = W @ W
    small = theta < 1e-4
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe) / safe)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(safe)) / safe**2)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * WW


def so3_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Jr(w): d/d(dw) log(exp(w) exp(dw)) at dw=0."""
    theta, safe = _theta(w)
    theta2 = torch.sum(w * w, dim=-1)
    W = hat(w)
    WW = W @ W
    small = theta < 1e-4
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(safe)) / safe**2)
    c = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (safe - torch.sin(safe)) / safe**3
    )
    return _eye_like(W) - b[..., None, None] * W + c[..., None, None] * WW


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Jl(w) = Jr(-w)."""
    return so3_right_jacobian(-w)


def _quat_unnormalized(R: torch.Tensor) -> torch.Tensor:
    """(...,3,3) -> the best-conditioned of the four Shepperd candidates,
    (x,y,z,w) up to a positive scale and a sign."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = torch.clamp_min(1.0 + tr, 0.0)
    qx2 = torch.clamp_min(1.0 + m00 - m11 - m22, 0.0)
    qy2 = torch.clamp_min(1.0 - m00 + m11 - m22, 0.0)
    qz2 = torch.clamp_min(1.0 - m00 - m11 + m22, 0.0)
    cw = torch.stack([m21 - m12, m02 - m20, m10 - m01, qw2], dim=-1)
    cx = torch.stack([qx2, m10 + m01, m02 + m20, m21 - m12], dim=-1)
    cy = torch.stack([m10 + m01, qy2, m21 + m12, m02 - m20], dim=-1)
    cz = torch.stack([m02 + m20, m21 + m12, qz2, m10 - m01], dim=-1)
    mags = torch.stack([qx2, qy2, qz2, qw2], dim=-1)
    k = torch.argmax(mags, dim=-1)
    cands = torch.stack([cx, cy, cz, cw], dim=-2)  # (...,4cand,4)
    idx = k[..., None, None].expand(*k.shape, 1, 4)
    return torch.gather(cands, -2, idx).squeeze(-2)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(...,3,3) -> unit quaternion (...,4) as (x,y,z,w), w >= 0
    (branch-free Shepperd extraction)."""
    q = _quat_unnormalized(R)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., 3:4] < 0, -q, q)


def rot_to_quat_files(R: torch.Tensor) -> torch.Tensor:
    """`rot_to_quat` for trajectory files that are compared byte by byte
    with the reference's: float32, with the squared norm accumulated in
    index order by fused multiply-adds, which is how the reference's CPU
    build rounds it (a file prints 7 decimals, so the last bit of a float32
    shows). Each fused step is evaluated in float64 and rounded once."""
    q = _quat_unnormalized(R.float())
    s = torch.zeros_like(q[..., 0])
    for i in range(4):
        s = (q[..., i].double() * q[..., i].double() + s.double()).float()
    q = q / torch.sqrt(s)[..., None]
    return torch.where(q[..., 3:4] < 0, -q, q)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (x,y,z,w) -> rotation matrix."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1)
    row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def so3_normalize(R: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize a drifting rotation via a quaternion round trip."""
    return quat_to_rot(rot_to_quat(R))


def se3_exp(xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """xi = (rho, phi) (...,6) -> (R, t) with t = Jl(phi) @ rho."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = torch.einsum("...ij,...j->...i", so3_left_jacobian(phi), rho)
    return R, t


def se3_mul(Ra, ta, Rb, tb):
    """(Ra,ta) * (Rb,tb)."""
    return Ra @ Rb, torch.einsum("...ij,...j->...i", Ra, tb) + ta


def se3_inv(R, t):
    """Inverse of the rigid transform (R, t)."""
    Rt = R.transpose(-1, -2)
    return Rt, -torch.einsum("...ij,...j->...i", Rt, t)


def se3_apply(R, t, x):
    """Transform points x (...,3)."""
    return torch.einsum("...ij,...j->...i", R, x) + t
