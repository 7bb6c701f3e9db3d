"""Visual-inertial optimization (port of optim/inertial.py): IMU
initialization, tracking-time VI pose optimization and visual-inertial
bundle adjustment.

- `inertial_init` <- Optimizer::InertialOptimization (gravity direction,
  scale, biases and velocities with the poses fixed,
  src/Optimizer.cc:3032-3483), and its scale-only overload
  (ScaleRefinement, :3379); `linear_inertial_init` seeds it in closed form
  and `gravity_seed` is InitializeIMU's gravity direction.
- `pose_inertial_optimization` <- PoseInertialOptimizationLastKeyFrame /
  ...LastFrame (src/Optimizer.cc:4457-5237): reprojection + one
  preintegration edge + bias random walk + the optional 15-dim marginal
  prior, and the next frame's prior by Schur marginalization
  (Optimizer::Marginalize, :2950-3031).
- `visual_inertial_ba` <- LocalInertialBA (src/Optimizer.cc:2371-2949) and
  FullInertialBA (:378-784): 15-dim body states [dphi, dp, dv, dbg, dba]
  and landmarks, the landmark block eliminated by the Schur complement and
  the reduced system solved densely (windows are small).

The reference takes every inertial Jacobian by forward-mode autodiff of the
9-dim residual at the retraction origin. Here `inertial_init` does the same
(`torch.func.jacfwd`: it runs a few times per map), while the edges of the
per-frame pose optimization and of the BA take the closed form of
EdgeInertial::linearizeOplus (src/G2oTypes.cc), the same derivatives without
functorch's per-operation overhead, which dominated the pose optimization. Under `jacfwd` a 0-d tensor met by a Python number
computes in float64, so the differentiated state carries a leading
dimension. The retraction is ImuCamPose::Update (include/G2oTypes.h:88):
Rwb <- Rwb Exp(dphi), twb <- twb + Rwb dp.

The LM loops are Python loops with `torch.where` accept/reject and no host
sync inside. Cholesky factorizations, solves and inverses are the `_ex`
forms with NaN where they fail, as JAX's are, so a step through a matrix
that is not positive definite or is singular is a rejected step. Scatters
into the normal equations are the ordered segment sums of `local_ba`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import imu as imu_ops
from ..utils import lie
from . import residuals
from .local_ba import _huber_rho, _segment_sum, segment_plan
from .residuals import nan_where_failed

D = 15  # body-state tangent: [dphi, dp, dv, dbg, dba]


def _mv(A, x):
    return torch.einsum("...ij,...j->...i", A, x)


# ----------------------------------------------------------------------------
# Body-state helpers (camera Tcw <-> body Twb through the Tbc extrinsic)
# ----------------------------------------------------------------------------


def cam_to_body(Rcw, tcw, Tbc_R, Tbc_t):
    """Twb from Tcw. Tbc maps camera to body coordinates (x_b = Tbc_R x_c +
    Tbc_t), the reference's mImuCalib.mTbc (include/ImuTypes.h:94-134)."""
    Rwc = Rcw.transpose(-1, -2)
    twc = -_mv(Rwc, tcw)
    Rwb = torch.einsum("...ij,kj->...ik", Rwc, Tbc_R)
    twb = twc - torch.einsum("...ij,j->...i", Rwb, Tbc_t)
    return Rwb, twb


def body_to_cam(Rwb, twb, Tbc_R, Tbc_t):
    """Tcw from Twb (the inverse of cam_to_body)."""
    Rwc = torch.einsum("...ij,jk->...ik", Rwb, Tbc_R)
    twc = twb + torch.einsum("...ij,j->...i", Rwb, Tbc_t)
    Rcw = Rwc.transpose(-1, -2)
    return Rcw, -_mv(Rcw, twc)


def body_to_cam_frame(Tbc_R, Tbc_t):
    """(Rcb, tcb) such that pc = Rcb x_b + tcb."""
    return Tbc_R.T, -Tbc_R.T @ Tbc_t


def _retract(Rwb, p, v, bg, ba, d):
    """15-dim retraction (ImuCamPose::Update + additive velocity and biases);
    broadcasts over leading dimensions."""
    R2 = Rwb @ lie.so3_exp(d[..., 0:3])
    p2 = p + _mv(Rwb, d[..., 3:6])
    return R2, p2, v + d[..., 6:9], bg + d[..., 9:12], ba + d[..., 12:15]


def _inertial_residual_gs(Rwb1, p1, v1, Rwb2, p2, v2, bg, ba, pre, Rwg, s, dR=None):
    """EdgeInertialGS::computeError (include/G2oTypes.h:587): the 9-dim
    preintegration residual with a free gravity direction Rwg and scale s.
    With Rwg = I, s = 1 it is EdgeInertial (:531). `dR` may carry the
    bias-corrected delta rotation at `bg` already computed."""
    dT = pre.dT[..., None]
    g = _mv(Rwg, imu_ops.gravity_vec(Rwb1.device, Rwb1.dtype))
    dR = imu_ops.delta_rotation(pre, bg) if dR is None else dR
    dV = imu_ops.delta_velocity(pre, bg, ba)
    dP = imu_ops.delta_position(pre, bg, ba)
    R1t = Rwb1.transpose(-1, -2)
    er = lie.so3_log(dR.transpose(-1, -2) @ R1t @ Rwb2)
    ev = _mv(R1t, s * (v2 - v1) - g * dT) - dV
    ep = _mv(R1t, s * (p2 - p1 - v1 * dT) - 0.5 * g * dT * dT) - dP
    return torch.cat([er, ev, ep], dim=-1)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _edge_sqrt_info(pre):
    """Lower-triangular L with L L^T = C9 + 1e-8 I: whitening by the
    Cholesky factor of the 9x9 preintegration covariance (NaN where the
    factorization fails)."""
    C = pre.C[..., :9, :9] + _eye(9, pre.C) * 1e-8
    return nan_where_failed(*torch.linalg.cholesky_ex(C, check_errors=False))


def _whiten(L, r):
    """L^-1 r, so that |r_white|^2 = r^T C^-1 r."""
    return torch.linalg.solve_triangular(L, r[..., None], upper=False)[..., 0]


def _sym_inv(C):
    inv = nan_where_failed(*torch.linalg.inv_ex(C, check_errors=False))
    return 0.5 * (inv + inv.transpose(-1, -2))


def _edge_info9(pre):
    return _sym_inv(pre.C[..., :9, :9] + _eye(9, pre.C) * 1e-8)


def _walk_infos(pre):
    """Bias random-walk information from the preintegration covariance
    (EdgeGyroRW/EdgeAccRW take inv(C[9:12,9:12]) / inv(C[12:15,12:15]))."""
    eye = _eye(3, pre.C) * 1e-10
    return _sym_inv(pre.C[..., 9:12, 9:12] + eye), _sym_inv(pre.C[..., 12:15, 12:15] + eye)


def _solve(H, b):
    """H^-1 b, NaN where H is singular."""
    x, info = torch.linalg.solve_ex(H, b, check_errors=False)
    return nan_where_failed(x, info)


# ----------------------------------------------------------------------------
# IMU initialization: gravity direction + scale + biases + velocities
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InertialInitResult:
    Rwg: torch.Tensor  # (3,3) gravity-frame-from-world rotation estimate
    scale: torch.Tensor  # scalar
    bg: torch.Tensor  # (3,)
    ba: torch.Tensor  # (3,)
    vel: torch.Tensor  # (K,3) world-frame body velocities
    cost: torch.Tensor


def linear_inertial_init(Rwb, twb, edge_i, edge_j, pre, eps=1e-9):
    """Closed-form scale/gravity/velocity seed (VINS-Mono-style linear
    alignment): with the rotations fixed, the equations

        v_j - v_i - g dT                     = Rwb_i dV
        s (p_j - p_i) - v_i dT - 0.5 g dT^2  = Rwb_i dP

    are linear in theta = [s, g(3), v_0..v_{K-1}] (v metric). Unweighted
    least squares is immune to the noise-induced scale collapse of the
    covariance-whitened GN, so this seeds `inertial_init`. Host numpy (the
    problems are tiny); tensors are read to the host. Returns (s, g_w (3,),
    v (K,3) metric)."""

    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    Rwb, twb = host(Rwb), host(twb)
    edge_i, edge_j = host(edge_i), host(edge_j)
    dV, dP, dT = host(pre.dV), host(pre.dP), host(pre.dT)
    K = Rwb.shape[0]
    E = len(edge_i)
    n = 1 + 3 + 3 * K
    A = np.zeros((6 * E, n))
    b = np.zeros(6 * E)
    for e in range(E):
        i, j = int(edge_i[e]), int(edge_j[e])
        t = float(dT[e])
        r0 = 6 * e
        # ev rows.
        A[r0 : r0 + 3, 4 + 3 * j : 7 + 3 * j] = np.eye(3)
        A[r0 : r0 + 3, 4 + 3 * i : 7 + 3 * i] = -np.eye(3)
        A[r0 : r0 + 3, 1:4] = -t * np.eye(3)
        b[r0 : r0 + 3] = Rwb[i] @ dV[e]
        # ep rows.
        A[r0 + 3 : r0 + 6, 0] = twb[j] - twb[i]
        A[r0 + 3 : r0 + 6, 4 + 3 * i : 7 + 3 * i] = -t * np.eye(3)
        A[r0 + 3 : r0 + 6, 1:4] = -0.5 * t * t * np.eye(3)
        b[r0 + 3 : r0 + 6] = Rwb[i] @ dP[e]
    theta, *_ = np.linalg.lstsq(A, b, rcond=None)
    return float(theta[0]), theta[1:4], theta[4:].reshape(K, 3)


def inertial_init(
    Rwb, twb, vel0, edge_i, edge_j, edge_valid, pre: imu_ops.Preintegrated, prior_g, prior_a,
    bg0=None, ba0=None, iters: int = 60, fix_scale: bool = False, fix_gravity: bool = False,
    fix_bias: bool = False, fix_vel: bool = False, log_s0=None, sigma_p=None,
) -> InertialInitResult:
    """Gravity direction, metric scale, one shared bias pair and per-KF
    velocities with every pose fixed (Optimizer::InertialOptimization
    src/Optimizer.cc:3032; with fix_scale + fix_gravity the bias/velocity
    overload :3222; with fix_bias + fix_vel only gravity and scale are free,
    the ScaleRefinement overload :3379).

    Rwb (K,3,3), twb (K,3), vel0 (K,3) in map units; edges (E,) with their
    stacked preintegrations `pre`. `sigma_p` is a per-KF position-noise
    floor in map units: the ep rows' covariance is inflated by
    2 (s sigma_p)^2, so that keyframe-pose noise (absent from the
    preintegration covariance) cannot drive the scale to zero. Seed
    `log_s0` from `linear_inertial_init`."""
    dev, dt = twb.device, twb.dtype
    K = Rwb.shape[0]
    z3 = torch.zeros(3, dtype=dt, device=dev)
    bg0 = z3 if bg0 is None else bg0
    ba0 = z3 if ba0 is None else ba0
    log_s0 = torch.as_tensor(0.0 if log_s0 is None else log_s0, dtype=dt).to(dev).reshape(1)
    sigma_p = torch.as_tensor(0.0 if sigma_p is None else sigma_p, dtype=dt).to(dev)
    prior_g = torch.as_tensor(prior_g, dtype=dt).to(dev)
    prior_a = torch.as_tensor(prior_a, dtype=dt).to(dev)
    ei, ej = edge_i.long(), edge_j.long()
    ev_f = edge_valid.to(dt)[:, None]
    Rwb_i, Rwb_j, twb_i, twb_j = Rwb[ei], Rwb[ej], twb[ei], twb[ej]
    C9 = pre.C[..., :9, :9]
    floor_rv = torch.full((6,), 1e-8, dtype=dt, device=dev)

    def unpack(x):
        thg = torch.zeros(2, dtype=dt, device=dev) if fix_gravity else x[0:2]
        Rwg = lie.so3_exp(torch.cat([thg, torch.zeros(1, dtype=dt, device=dev)])[None])  # (1,3,3)
        s = torch.ones(1, dtype=dt, device=dev) if fix_scale else torch.exp(x[2:3])  # (1,)
        bg = bg0 if fix_bias else x[3:6]
        ba = ba0 if fix_bias else x[6:9]
        v = vel0 if fix_vel else x[9:].reshape(K, 3)
        return Rwg, s, bg, ba, v

    def res_fn(x):
        Rwg, s, bg, ba, v = unpack(x)
        # Noise floor: rotation and velocity 1e-8, position 2 (s sigma_p)^2.
        floor = torch.cat([floor_rv, (2.0 * (s * sigma_p) ** 2 + 1e-8).expand(3)])
        r = _inertial_residual_gs(Rwb_i, twb_i, v[ei], Rwb_j, twb_j, v[ej], bg, ba, pre, Rwg, s)
        L = nan_where_failed(*torch.linalg.cholesky_ex(C9 + torch.diag(floor), check_errors=False))
        r9 = _whiten(L, r) * ev_f
        return torch.cat([r9.reshape(-1), torch.sqrt(prior_g) * bg, torch.sqrt(prior_a) * ba])

    x = torch.cat([torch.zeros(2, dtype=dt, device=dev), log_s0, bg0, ba0, vel0.reshape(-1)])
    lam = torch.tensor(1e-2, dtype=dt, device=dev)
    eye_n = _eye(x.shape[0], x)
    for _ in range(iters):
        r = res_fn(x)
        J = torch.func.jacfwd(res_fn)(x)
        H = J.T @ J
        g = J.T @ r
        Hd = H + lam * torch.diag(torch.clamp_min(torch.diagonal(H), 1e-6)) + 1e-8 * eye_n
        x_new = x - _solve(Hd, g)
        c_old = torch.sum(r * r)
        r_new = res_fn(x_new)
        c_new = torch.sum(r_new * r_new)
        ok = torch.all(torch.isfinite(x_new)) & (c_new < c_old)
        lam = torch.where(ok, torch.clamp_min(lam * 0.3, 1e-9), torch.clamp_max(lam * 5.0, 1e6))
        x = torch.where(ok, x_new, x)
    Rwg, s, bg, ba, v = unpack(x)
    r = res_fn(x)
    return InertialInitResult(Rwg=Rwg[0], scale=s[0], bg=bg, ba=ba, vel=v, cost=torch.sum(r * r))


def gravity_seed(Rwb, edge_i, edge_valid, pre):
    """Initial Rwg from the accumulated preintegrated velocity deltas
    (LocalMapping::InitializeIMU's dirG, src/LocalMapping.cc:1251)."""
    dt = Rwb.dtype
    dirG = torch.sum(_mv(Rwb[edge_i.long()], pre.dV) * edge_valid.to(dt)[:, None], dim=0)
    dirG = -dirG / torch.clamp_min(torch.linalg.vector_norm(dirG), 1e-9)
    gI = torch.tensor([0.0, 0.0, -1.0], dtype=dt, device=Rwb.device)
    # The rotation taking gI to dirG (world gravity direction): Rwg gI = dirG.
    v = torch.linalg.cross(gI, dirG)
    nv = torch.linalg.vector_norm(v)
    ang = torch.atan2(nv, torch.dot(gI, dirG))
    return lie.so3_exp(v / torch.clamp_min(nv, 1e-9) * ang)


# ----------------------------------------------------------------------------
# Tracking-time VI pose optimization (motion-only, one inertial edge)
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VIPoseResult:
    Rwb: torch.Tensor
    p: torch.Tensor
    v: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    inliers: torch.Tensor  # (N,)
    n_inliers: torch.Tensor
    H_marg: torch.Tensor  # (15,15) marginal information of the frame state


def _reproj_rows(is_stereo, like):
    """(N,3) row weights: (1, 1, 0) for mono observations, ones for stereo."""
    rows = torch.arange(3, device=like.device) < 2
    return (rows | is_stereo[:, None]).to(like.dtype)


def _inertial_jacobians(Rwb1, p1, v1, bg1, ba1, Rwb2, p2, v2, pre, need_J1=True):
    """The 9-dim residual of EdgeInertial and its Jacobians (...,9,15) with
    respect to the tangents [dphi, dp, dv, dbg, dba] of states 1 and 2, in
    closed form (EdgeInertial::linearizeOplus, src/G2oTypes.cc): the exact
    derivatives of `_inertial_residual_gs` at Rwg = I, s = 1 under
    `_retract`, which the reference takes by forward-mode autodiff. Without
    `need_J1` the first Jacobian comes back as None."""
    dR = imu_ops.delta_rotation(pre, bg1)
    r = _inertial_residual_gs(Rwb1, p1, v1, Rwb2, p2, v2, bg1, ba1, pre, _eye(3, p1), 1.0, dR=dR)
    batch = r.shape[:-1]
    dT = pre.dT[..., None]
    g = imu_ops.gravity_vec(p1.device, p1.dtype)
    R1t = Rwb1.transpose(-1, -2)
    dbg = bg1 - pre.bias_gyro
    eR = dR.transpose(-1, -2) @ R1t @ Rwb2
    invJr = lie.so3_right_jacobian_inv(r[..., 0:3])
    eye = _eye(3, p1).expand(*batch, 3, 3)
    z = torch.zeros_like(eye)
    hat = lie.hat
    J2 = torch.cat([
        torch.cat([invJr, z, z, z, z], -1),
        torch.cat([z, z, R1t.expand(*batch, 3, 3), z, z], -1),
        torch.cat([z, R1t @ Rwb2, z, z, z], -1),
    ], -2)
    if not need_J1:
        return r, None, J2
    J1 = torch.cat([
        torch.cat([-invJr @ Rwb2.transpose(-1, -2) @ Rwb1, z, z,
                   -invJr @ eR.transpose(-1, -2) @ lie.so3_right_jacobian(_mv(pre.JRg, dbg)) @ pre.JRg, z], -1),
        torch.cat([hat(_mv(R1t, v2 - v1 - g * dT)), z, -R1t.expand(*batch, 3, 3), -pre.JVg, -pre.JVa], -1),
        torch.cat([hat(_mv(R1t, p2 - p1 - v1 * dT - 0.5 * g * dT * dT)), -eye, -R1t * dT[..., None], -pre.JPg,
                   -pre.JPa], -1),
    ], -2)
    return r, J1, J2


def _walk_jacobians(like, batch=()):
    """Jacobians (...,6,15) of the bias walks [bg2 - bg1, ba2 - ba1] with
    respect to the tangents of states 1 and 2."""
    J2 = torch.zeros((6, D), dtype=like.dtype, device=like.device)
    J2[:, 9:] = torch.eye(6, dtype=like.dtype, device=like.device)
    J2 = J2.expand(*batch, 6, D)
    return -J2, J2


def pose_inertial_optimization(
    Rwb1, p1, v1, bg1, ba1,  # anchor (last keyframe or last frame) body state
    Rwb2, p2, v2, bg2, ba2,  # the current frame's initial body state
    pre: imu_ops.Preintegrated,  # anchor -> frame
    Xw, uvr, sigma2, valid, is_stereo,  # the frame's reprojection observations
    Rcb, tcb, fx, fy, bf,
    H_prior=None,  # 15-dim prior on the anchor (last-frame variant)
    rounds: int = 4,
    iters: int = 10,
    anchor_fixed: bool = True,
) -> VIPoseResult:
    """PoseInertialOptimizationLastKeyFrame (anchor_fixed=True,
    src/Optimizer.cc:4457) / ...LastFrame (anchor_fixed=False with the
    marginal prior H_prior, :4830): `rounds` x `iters` LM iterations with
    chi2 inlier re-classification after each round (Huber on the first two),
    then Schur marginalization of the anchor for the next frame's prior
    (Optimizer::Marginalize :2950)."""
    dev, dt = Xw.device, Xw.dtype
    if H_prior is None:
        H_prior = torch.zeros((D, D), dtype=dt, device=dev)
    inv_sigma2 = 1.0 / sigma2
    L9 = _edge_sqrt_info(pre)
    info_g, info_a = _walk_infos(pre)
    W_rw = torch.block_diag(info_g, info_a)  # (6,6)
    J1_rw, J2_rw = _walk_jacobians(Xw)
    R0, p0 = Rwb1, p1  # the prior's mean (the anchor as given)
    R0t = R0.T
    row_w = _reproj_rows(is_stereo, Xw)
    d2 = torch.where(is_stereo, residuals.CHI2_STEREO, residuals.CHI2_MONO).to(dt)
    zD = torch.zeros(D, dtype=dt, device=dev)
    eye3 = _eye(3, Xw)

    def whiten_J(J):
        return torch.linalg.solve_triangular(L9, J, upper=False)

    def prior_res(s1):
        """Log-difference of the anchor from its prior mean, and its Jacobian
        with respect to the anchor's tangent."""
        er = lie.so3_log(R0t @ s1[0])
        r = torch.cat([er, R0t @ (s1[1] - p0), s1[2] - v1, s1[3] - bg1, s1[4] - ba1])
        J = torch.block_diag(lie.so3_right_jacobian_inv(er), R0t @ s1[0], eye3, eye3, eye3)
        return r, J

    def rw_res(s1, s2):
        return torch.cat([s2[3] - s1[3], s2[4] - s1[4]])

    def reproj_system(s2, inlier, robust: bool):
        r3, Jp3, _, z = residuals.stereo_reprojection_body(s2[0], s2[1], Xw, uvr, Rcb, tcb, fx, fy, bf)
        r = r3 * row_w
        chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
        w_h = residuals.huber_weight(chi2, d2) if robust else torch.ones_like(chi2)
        act = inlier & valid & (z > 0)
        wgt = act.to(dt) * inv_sigma2 * w_h
        Jp = Jp3 * row_w[..., None]  # (N,3,6) wrt [dphi, dp]
        JpW = (Jp * wgt[:, None, None]).reshape(-1, 6)
        H15 = torch.zeros((D, D), dtype=dt, device=dev)
        H15[:6, :6] = JpW.T @ Jp.reshape(-1, 6)
        b15 = torch.cat([-(JpW.T @ r.reshape(-1)), torch.zeros(D - 6, dtype=dt, device=dev)])
        cost = torch.sum(torch.where(act, chi2, torch.zeros_like(chi2)))
        return H15, b15, cost

    def system(s1, s2, inlier, robust):
        """The normal equations at (s1, s2) and the total cost there (the
        reference's total_cost: reprojection chi2, the whitened inertial
        residual, the bias walk and, for the last-frame variant, the prior).
        With the anchor fixed only the frame's blocks are formed (the anchor's
        are zero-weighted or unused there)."""
        r9, J1, J2 = _inertial_jacobians(s1[0], s1[1], s1[2], s1[3], s1[4], s2[0], s2[1], s2[2], pre,
                                         need_J1=not anchor_fixed)
        r_in = _whiten(L9, r9)
        J2_in = whiten_J(J2)
        r_rw = rw_res(s1, s2)
        H22r, b22r, c_rep = reproj_system(s2, inlier, robust)
        H22 = J2_in.T @ J2_in + J2_rw.T @ W_rw @ J2_rw + H22r
        b2 = b22r - J2_in.T @ r_in - J2_rw.T @ W_rw @ r_rw
        cost = c_rep + torch.sum(r_in * r_in) + r_rw @ W_rw @ r_rw
        if anchor_fixed:
            return None, None, H22, None, b2, cost
        J1_in = whiten_J(J1)
        r_pr, Jp_pr = prior_res(s1)
        H11 = J1_in.T @ J1_in + J1_rw.T @ W_rw @ J1_rw + Jp_pr.T @ H_prior @ Jp_pr
        H12 = J1_in.T @ J2_in + J1_rw.T @ W_rw @ J2_rw
        b1 = -(J1_in.T @ r_in + J1_rw.T @ W_rw @ r_rw + Jp_pr.T @ (H_prior @ r_pr))
        return H11, H12, H22, b1, b2, cost + r_pr @ H_prior @ r_pr

    def step(state, sys_, lam):
        s1, s2 = state
        H11, H12, H22, b1, b2, _ = sys_
        if anchor_fixed:
            Hd = H22 + lam * torch.diag(torch.clamp_min(torch.diagonal(H22), 1e-6))
            d2_ = _solve(Hd + 1e-8 * _eye(D, Hd), b2)
            d1 = zD
        else:
            H = torch.cat([torch.cat([H11, H12], 1), torch.cat([H12.T, H22], 1)], 0)
            b = torch.cat([b1, b2])
            Hd = H + lam * torch.diag(torch.clamp_min(torch.diagonal(H), 1e-6))
            d = _solve(Hd + 1e-8 * _eye(2 * D, Hd), b)
            d1, d2_ = d[:D], d[D:]
        return _retract(*s1, d1), _retract(*s2, d2_)

    # Each LM iteration evaluates the system once, at the candidate: its cost
    # decides the step, and an accepted candidate's system is the next
    # iteration's (the reference evaluates the same values twice).
    state = ((Rwb1, p1, v1, bg1, ba1), (Rwb2, p2, v2, bg2, ba2))
    inlier = valid
    for ri in range(rounds):
        robust = ri < 2  # Huber dropped from the third round (reference :970-982)
        lam = torch.full((), 1e-3, dtype=dt, device=dev)
        sys_ = system(*state, inlier, robust)
        for _ in range(iters):
            st_new = step(state, sys_, lam)
            sys_new = system(*st_new, inlier, robust)
            finite = torch.stack([torch.all(torch.isfinite(x)) for s in st_new for x in s]).all()
            ok = finite & (sys_new[5] < sys_[5])
            lam = torch.where(ok, torch.clamp_min(lam * 0.5, 1e-8), torch.clamp_max(lam * 4.0, 1e4))
            state = tuple(tuple(torch.where(ok, n, o) for n, o in zip(sn, so)) for sn, so in zip(st_new, state))
            sys_ = tuple(None if n is None else torch.where(ok, n, o) for n, o in zip(sys_new, sys_))
        # Re-classify inliers.
        r3, _, _, z = residuals.stereo_reprojection_body(state[1][0], state[1][1], Xw, uvr, Rcb, tcb, fx, fy, bf)
        chi2 = torch.sum((r3 * row_w) ** 2, dim=-1) * inv_sigma2
        inlier = valid & (chi2 <= d2) & (z > 0)
    s1, s2 = state

    # Marginal information of the frame state: H22 - H12^T H11^-1 H12 over
    # the full system at the solution (Marginalize :2950).
    H11, H12, H22, _, _, _ = system(s1, s2, inlier, False)
    if anchor_fixed:
        H_marg = H22
    else:
        H11_inv = nan_where_failed(*torch.linalg.inv_ex(H11 + 1e-6 * _eye(D, H11), check_errors=False))
        H_marg = H22 - H12.T @ H11_inv @ H12
    H_marg = 0.5 * (H_marg + H_marg.T)
    return VIPoseResult(
        Rwb=s2[0], p=s2[1], v=s2[2], bg=s2[3], ba=s2[4],
        inliers=inlier, n_inliers=torch.sum(inlier), H_marg=H_marg,
    )


# ----------------------------------------------------------------------------
# Visual-inertial bundle adjustment (local temporal window / full map)
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VIBAProblem:
    """Fixed-capacity VI BA problem over body states; observations use
    centred pixels (u-cx, v-cy, ur-cx), mono rows carry is_stereo False."""

    Rwb: torch.Tensor  # (K,3,3)
    twb: torch.Tensor  # (K,3)
    vel: torch.Tensor  # (K,3)
    bg: torch.Tensor  # (K,3)
    ba: torch.Tensor  # (K,3)
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
    edge_i: torch.Tensor  # (E,) inertial edges (the temporal chain)
    edge_j: torch.Tensor  # (E,)
    edge_valid: torch.Tensor  # (E,)
    pre: imu_ops.Preintegrated  # stacked (E,...)
    Rcb: torch.Tensor  # (3,3)
    tcb: torch.Tensor  # (3,)
    fx: float
    fy: float
    bf: float
    # Bias prior on one keyframe (EdgePriorGyro/EdgePriorAcc that
    # FullInertialBA attaches at IMU initialization, :438-476).
    prior_kf: int = 0
    prior_g: float = 0.0
    prior_a: float = 0.0


@dataclasses.dataclass(frozen=True)
class VIBAResult:
    Rwb: torch.Tensor
    twb: torch.Tensor
    vel: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    Xw: torch.Tensor
    obs_inlier: torch.Tensor
    cost: torch.Tensor


def _vi_states(p: VIBAProblem):
    return (p.Rwb, p.twb, p.vel, p.bg, p.ba)


class _ViModel:
    """What `visual_inertial_ba` and `sparse_vi_ba` share: the reprojection
    rows over body poses, the inertial and bias-walk chain edges with their
    Jacobian blocks, the bias prior and the robust cost. `reduce` sums the
    per-row reprojection cost (`torch.sum`; `sparse_vi_ba` passes its
    fixed-order sum over the rows and the ranks); the chain and the prior are
    replicated and stay local."""

    def __init__(self, p: VIBAProblem, reduce=torch.sum):
        self.p = p
        self.reduce = reduce
        dev, dt = p.Xw.device, p.Xw.dtype
        self.dt = dt
        self.obs_kf, self.obs_lm = p.obs_kf.long(), p.obs_lm.long()
        self.ei, self.ej = p.edge_i.long(), p.edge_j.long()
        self.ev_f = (p.edge_valid & p.kf_valid[self.ei] & p.kf_valid[self.ej]).to(dt)[:, None]
        self.L9s = _edge_sqrt_info(p.pre)  # (E,9,9)
        self.ig, self.ia = _walk_infos(p.pre)  # (E,3,3) each
        self.row_w = _reproj_rows(p.obs_stereo, p.Xw)
        self.d2 = torch.where(p.obs_stereo, residuals.CHI2_STEREO, residuals.CHI2_MONO).to(dt)
        self.eye3 = _eye(3, p.Xw)
        self.one = torch.ones((), dtype=dt, device=dev)
        self.z15 = torch.zeros(D, dtype=dt, device=dev)
        self.prior_diag = torch.cat([
            torch.zeros(9, dtype=dt, device=dev),
            torch.full((3,), float(p.prior_g), dtype=dt, device=dev),
            torch.full((3,), float(p.prior_a), dtype=dt, device=dev),
        ])

    def reproj(self, Rwb, twb, Xw):
        p = self.p
        r3, Jp3, Jl3, z = residuals.stereo_reprojection_body(
            Rwb[self.obs_kf], twb[self.obs_kf], Xw[self.obs_lm], p.obs_uvr, p.Rcb, p.tcb, p.fx, p.fy, p.bf,
        )
        w = self.row_w
        return r3 * w, Jp3 * w[..., None], Jl3 * w[..., None], z

    def chi2_of(self, r):
        return torch.sum(r * r, dim=-1) / self.p.obs_sigma2

    def edge_res(self, states):
        """Whitened inertial residuals (E,9) and bias walks (E,3), (E,3)."""
        Rwb, twb, vel, bg, ba = states
        ei, ej = self.ei, self.ej
        r9 = _inertial_residual_gs(Rwb[ei], twb[ei], vel[ei], Rwb[ej], twb[ej], vel[ej], bg[ei], ba[ei], self.p.pre,
                                   self.eye3, self.one)
        ev = self.ev_f
        return _whiten(self.L9s, r9) * ev, (bg[ej] - bg[ei]) * ev, (ba[ej] - ba[ei]) * ev

    def edge_blocks(self, states):
        """Per-edge normal-equation contributions (Hii, Hij, Hjj, bi, bj)."""
        Rwb, twb, vel, bg, ba = states
        ei, ej = self.ei, self.ej
        r9, J9i, J9j = _inertial_jacobians(Rwb[ei], twb[ei], vel[ei], bg[ei], ba[ei], Rwb[ej], twb[ej], vel[ej],
                                           self.p.pre)
        ev = self.ev_f
        r9 = _whiten(self.L9s, r9) * ev
        J9i = torch.linalg.solve_triangular(self.L9s, J9i, upper=False) * ev[..., None]
        J9j = torch.linalg.solve_triangular(self.L9s, J9j, upper=False) * ev[..., None]
        rg, ra = (bg[ej] - bg[ei]) * ev, (ba[ej] - ba[ei]) * ev
        Jwi, Jwj = _walk_jacobians(r9, r9.shape[:-1])
        Jwi, Jwj = Jwi * ev[..., None], Jwj * ev[..., None]
        Jgi, Jai, Jgj, Jaj = Jwi[..., :3, :], Jwi[..., 3:, :], Jwj[..., :3, :], Jwj[..., 3:, :]
        Wg, Wa = self.ig, self.ia
        tr = lambda J: J.transpose(-1, -2)  # noqa: E731
        Hii = tr(J9i) @ J9i + tr(Jgi) @ Wg @ Jgi + tr(Jai) @ Wa @ Jai
        Hjj = tr(J9j) @ J9j + tr(Jgj) @ Wg @ Jgj + tr(Jaj) @ Wa @ Jaj
        Hij = tr(J9i) @ J9j + tr(Jgi) @ Wg @ Jgj + tr(Jai) @ Wa @ Jaj
        bi = -(_mv(tr(J9i), r9) + _mv(tr(Jgi), _mv(Wg, rg)) + _mv(tr(Jai), _mv(Wa, ra)))
        bj = -(_mv(tr(J9j), r9) + _mv(tr(Jgj), _mv(Wg, rg)) + _mv(tr(Jaj), _mv(Wa, ra)))
        return Hii, Hij, Hjj, bi, bj

    def inertial_cost(self, states):
        r9, rg, ra = self.edge_res(states)
        return torch.sum(torch.sum(r9 * r9, -1) + torch.sum(rg * _mv(self.ig, rg), -1)
                         + torch.sum(ra * _mv(self.ia, ra), -1))

    def prior_cost(self, states):
        p = self.p
        return p.prior_g * torch.sum(states[3][p.prior_kf] ** 2) + p.prior_a * torch.sum(states[4][p.prior_kf] ** 2)

    def build_cost(self, states, Xw, inlier):
        r, _, _, z = self.reproj(states[0], states[1], Xw)
        chi2 = self.chi2_of(r)
        active = inlier & self.p.obs_valid & (z > 0)
        rho = _huber_rho(chi2, self.d2)
        return self.reduce(torch.where(active, rho, torch.zeros_like(rho))) + self.inertial_cost(states) \
            + self.prior_cost(states)

    def prior_rhs(self, states):
        p = self.p
        return torch.cat([torch.zeros(9, dtype=self.dt, device=self.z15.device),
                          -p.prior_g * states[3][p.prior_kf], -p.prior_a * states[4][p.prior_kf]])

    def retract_all(self, states, dx):
        new = _retract(*states, dx)
        return (lie.so3_normalize(new[0]), *new[1:])

    def gate(self, states, Xw):
        r, _, _, z = self.reproj(states[0], states[1], Xw)
        return self.p.obs_valid & (self.chi2_of(r) <= self.d2) & (z > 0)


def visual_inertial_ba(p: VIBAProblem, iters: int = 10, gate_at: int = 5, damping_init: float = 1e-4) -> VIBAResult:
    """LocalInertialBA / FullInertialBA: 15-dim body states + landmarks,
    reprojection + inertial + bias random-walk edges, landmark Schur
    elimination, the reduced (15K, 15K) system solved by LU."""
    K, L = p.Rwb.shape[0], p.Xw.shape[0]
    dev, dt = p.Xw.device, p.Xw.dtype
    mdl = _ViModel(p)
    sum_kf, seg_lm, seg_pair = segment_plan(K, L, p.obs_kf, p.obs_lm, p.obs_valid, p.Xw)
    kf_free = p.kf_valid & ~p.kf_fixed
    free_f = kf_free.to(dt)
    freeD = torch.repeat_interleave(free_f, D)
    dmask = freeD[:, None] * freeD[None, :]
    eyeKD = torch.eye(K * D, dtype=torch.bool, device=dev)
    eye3 = _eye(3, p.Xw)
    diag_k = torch.arange(K, device=dev) * (K + 1)
    ei, ej = mdl.ei, mdl.ej
    pk = int(p.prior_kf)

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

        JpW = Jp * wgt[:, None, None]  # (O,3,6)
        JlW = Jl * wgt[:, None, None]
        Hcc6 = sum_kf(torch.einsum("ori,orj->oij", JpW, Jp))
        bc6 = sum_kf(-torch.einsum("ori,or->oi", JpW, r))
        Hll = _segment_sum(L, seg_lm, torch.einsum("ori,orj->oij", JlW, Jl))
        bl = _segment_sum(L, seg_lm, -torch.einsum("ori,or->oi", JlW, r))
        Wd6 = _segment_sum(K * L, seg_pair, torch.einsum("ori,orj->oij", JpW, Jl)).reshape(K, L, 6, 3)

        # Landmark elimination.
        dHll = Hll + (lam * torch.einsum("lii->l", Hll) / 3.0 + 1e-9)[:, None, None] * eye3
        Hll_inv = nan_where_failed(*torch.linalg.inv_ex(dHll, check_errors=False))
        Hll_inv = torch.where(p.lm_valid[:, None, None], Hll_inv, torch.zeros_like(Hll_inv))
        T = torch.einsum("alip,lpq->aliq", Wd6, Hll_inv)  # (K,L,6,3)
        S6 = -torch.einsum("aliq,bljq->abij", T, Wd6).reshape(K * K, 6, 6)
        S6 = S6.index_add(0, diag_k, Hcc6)
        rhs6 = bc6 - torch.einsum("aliq,lq->ai", T, bl)  # (K,6)

        # The 6-dim visual system lifted into the 15-dim body system, as
        # (K*K, 15, 15) blocks.
        S = torch.zeros((K * K, D, D), dtype=dt, device=dev)
        S[:, :6, :6] = S6
        rhs = torch.zeros((K, D), dtype=dt, device=dev)
        rhs[:, :6] = rhs6

        # Inertial + bias random-walk edges, then the bias prior.
        Hii, Hij, Hjj, bi, bj = mdl.edge_blocks(states)
        S = S + _segment_sum(K * K, ei * (K + 1), Hii)
        S = S + _segment_sum(K * K, ej * (K + 1), Hjj)
        S = S + _segment_sum(K * K, ei * K + ej, Hij)
        S = S + _segment_sum(K * K, ej * K + ei, Hij.transpose(-1, -2))
        rhs = rhs + _segment_sum(K, ei, bi)
        rhs = rhs + _segment_sum(K, ej, bj)
        S[pk * (K + 1)] += torch.diag(mdl.prior_diag)
        rhs[pk] += mdl.prior_rhs(states)

        # Freeze fixed and invalid keyframes; damp; solve.
        Sm = S.reshape(K, K, D, D).permute(0, 2, 1, 3).reshape(K * D, K * D) * dmask
        diag = torch.diagonal(Sm)
        new_diag = torch.where(freeD > 0, diag * (1.0 + lam) + 1e-8, torch.ones_like(diag))
        Sm = torch.where(eyeKD, new_diag[None, :].expand(K * D, K * D), Sm)
        dx = _solve(Sm, (rhs * free_f[:, None]).reshape(K * D)).reshape(K, D) * free_f[:, None]

        # Back-substitute the landmarks (the visual part touches dims :6).
        bl_corr = bl - torch.einsum("alip,ai->lp", Wd6, dx[:, :6])
        dxl = torch.einsum("lpq,lq->lp", Hll_inv, bl_corr) * p.lm_valid.to(dt)[:, None]

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
