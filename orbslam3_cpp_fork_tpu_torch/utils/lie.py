"""Lie groups SO(3), SE(3) and Sim(3) (port of utils/lie.py).

Rotations are (...,3,3) matrices and SE(3) poses are (R, t) acting as
x -> R @ x + t (Tcw maps world to camera); Sim(3) elements are (s, R, t)
acting as x -> s R x + t (loop closing, the essential graph). Every function
broadcasts over leading batch dimensions and selects small-angle Taylor
branches with `torch.where` on safe operands, as the reference does, so that
forward-mode derivatives (`torch.func.jvp` / `jacfwd`) stay finite.
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


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (...,3,3) -> (...,3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


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


def so3_right_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Jr(w)^-1."""
    theta, safe = _theta(w)
    theta2 = torch.sum(w * w, dim=-1)
    W = hat(w)
    WW = W @ W
    small = theta < 1e-4
    # 1/theta^2 - (1+cos)/(2 theta sin)
    sin_safe = torch.sin(torch.where(torch.abs(torch.sin(safe)) < _EPS, torch.ones_like(safe), safe))
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        1.0 / safe**2 - (1.0 + torch.cos(safe)) / (2.0 * safe * sin_safe),
    )
    return _eye_like(W) + 0.5 * W + cot_term[..., None, None] * WW


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Matrix log: (...,3,3) rotation -> (...,3) tangent, |w| in [0, pi],
    through the quaternion (well conditioned at every angle)."""
    q = rot_to_quat(R)
    xyz = q[..., :3]
    w = q[..., 3]  # >= 0 by construction
    n = torch.linalg.vector_norm(xyz, dim=-1)
    theta = 2.0 * torch.atan2(n, w)
    small = n < 1e-6
    n_safe = torch.where(small, torch.ones_like(n), n)
    # theta/n -> 2/w for n -> 0 (w -> 1).
    scale = torch.where(small, 2.0 / torch.clamp_min(w, 0.5), theta / n_safe)
    return xyz * scale[..., None]


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


def se3_identity(batch_shape=(), dtype=torch.float32, device=None):
    """(R, t) of the identity, broadcast to `batch_shape`."""
    R = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3).clone()
    return R, torch.zeros((*batch_shape, 3), dtype=dtype, device=device)


def se3_exp(xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """xi = (rho, phi) (...,6) -> (R, t) with t = Jl(phi) @ rho."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = torch.einsum("...ij,...j->...i", so3_left_jacobian(phi), rho)
    return R, t


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> xi = (rho, phi) (...,6), the inverse of se3_exp."""
    phi = so3_log(R)
    rho = torch.einsum("...ij,...j->...i", so3_right_jacobian_inv(-phi), t)
    return torch.cat([rho, phi], dim=-1)


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


# ----------------------------------------------------------------------------
# Sim(3): (s: (...,), R: (...,3,3), t: (...,3)); x -> s R x + t.
# ----------------------------------------------------------------------------


def sim3_identity(batch_shape=(), dtype=torch.float32, device=None):
    R, t = se3_identity(batch_shape, dtype, device)
    return torch.ones(batch_shape, dtype=dtype, device=device), R, t


def sim3_mul(sa, Ra, ta, sb, Rb, tb):
    return sa * sb, Ra @ Rb, sa[..., None] * torch.einsum("...ij,...j->...i", Ra, tb) + ta


def sim3_inv(s, R, t):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return s_inv, Rt, -s_inv[..., None] * torch.einsum("...ij,...j->...i", Rt, t)


def sim3_apply(s, R, t, x):
    return s[..., None] * torch.einsum("...ij,...j->...i", R, x) + t


def _sim3_V(phi: torch.Tensor, sigma: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """V of the Sim(3) exponential (t = V rho), the closed form of
    Strasdat's thesis with the reference's small-angle and small-scale
    branches."""
    theta, safe_t = _theta(phi)
    W = hat(phi)
    WW = W @ W
    eps = 1e-5
    small_s = torch.abs(sigma) < eps
    small_t = theta < eps
    safe_s = torch.where(small_s, torch.ones_like(sigma), sigma)
    c0 = torch.where(small_s, 1.0 + sigma / 2.0 + sigma**2 / 6.0, (s - 1.0) / safe_s)
    denom = safe_s**2 + safe_t**2
    a_ = s * torch.sin(safe_t)
    b_ = s * torch.cos(safe_t)
    c1_gen = (a_ * safe_s + (1.0 - b_) * safe_t) / (safe_t * denom)
    c2_gen = (c0 - ((b_ - 1.0) * safe_s + a_ * safe_t) / denom) / (safe_t**2)
    c1_s0 = (1.0 - torch.cos(safe_t)) / safe_t**2
    c2_s0 = (safe_t - torch.sin(safe_t)) / safe_t**3
    c1_t0 = torch.where(small_s, 0.5 + sigma / 3.0, ((safe_s - 1.0) * s + 1.0) / safe_s**2)
    c2_t0 = torch.where(
        small_s, 1.0 / 6.0 + sigma / 8.0, (s * (0.5 * safe_s**2 - safe_s + 1.0) - 1.0) / safe_s**3,
    )
    C1 = torch.where(small_t, c1_t0, torch.where(small_s, c1_s0, c1_gen))
    C2 = torch.where(small_t, c2_t0, torch.where(small_s, c2_s0, c2_gen))
    return c0[..., None, None] * _eye_like(W) + C1[..., None, None] * W + C2[..., None, None] * WW


def sim3_exp(xi: torch.Tensor):
    """xi = (rho, phi, sigma) (...,7) -> (s, R, t)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    R = so3_exp(phi)
    t = torch.einsum("...ij,...j->...i", _sim3_V(phi, sigma, s), rho)
    return s, R, t


def sim3_log(s: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Inverse of sim3_exp: solves V rho = t."""
    sigma = torch.log(s)
    phi = so3_log(R)
    rho = torch.linalg.solve(_sim3_V(phi, sigma, s), t[..., None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)
