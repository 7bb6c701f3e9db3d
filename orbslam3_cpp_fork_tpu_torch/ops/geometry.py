"""Multi-view geometry primitives (port of ops/geometry.py).

Fundamental from poses, DLT triangulation, 8-point fundamental, homography
DLT, essential decomposition and the cheirality check of the two-view
initializer (GeometricTools.cc, TwoViewReconstruction.cc). Where the
reference maps a function over hypotheses with `jax.vmap`, the port's
function takes leading batch dimensions instead. RANSAC drivers live in
ransac.py.

Singular vectors are defined up to sign (and, for repeated singular
values, up to a basis): F and H agree with the reference up to sign and
scale, poses after the cheirality vote.
"""

from __future__ import annotations

import torch

from ..utils import lie


def _inv(A: torch.Tensor) -> torch.Tensor:
    """Matrix inverse without the host-side error check (no sync); a
    singular input gives non-finite or huge entries, as the reference's."""
    return torch.linalg.inv_ex(A, check_errors=False)[0]


def _homog(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """DLT triangulation (GeometricTools::Triangulate).

    P1, P2: (...,3,4) projection matrices; x1, x2: (...,2) image points in
    the same normalization as P. Returns (...,3) euclidean points.

    The null vector of the 4x4 system is found by the inhomogeneous
    formulation (w = 1): closed-form 3x3 normal equations on row-normalized
    A, no SVD. It differs from the homogeneous route only for points at
    infinity, which every caller rejects; the acceptance gates downstream
    were tuned on this form.
    """
    rows = torch.broadcast_tensors(
        x1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        x1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        x2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        x2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    )
    A = torch.stack(rows, dim=-2)  # (...,4,4)
    A = A / torch.clamp_min(torch.linalg.vector_norm(A, dim=-1, keepdim=True), 1e-12)
    B = A[..., :, :3]
    b = -A[..., :, 3]
    H = torch.einsum("...ki,...kj->...ij", B, B)
    g = torch.einsum("...ki,...k->...i", B, b)
    # Cramer's rule on the symmetric 3x3 (elementwise).
    h00, h01, h02 = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    h11, h12, h22 = H[..., 1, 1], H[..., 1, 2], H[..., 2, 2]
    c00 = h11 * h22 - h12 * h12
    c01 = h02 * h12 - h01 * h22
    c02 = h01 * h12 - h02 * h11
    c11 = h00 * h22 - h02 * h02
    c12 = h01 * h02 - h00 * h12
    c22 = h00 * h11 - h01 * h01
    det = h00 * c00 + h01 * c01 + h02 * c02
    det_safe = torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
    g0, g1, g2 = g[..., 0], g[..., 1], g[..., 2]
    X = torch.stack(
        [
            c00 * g0 + c01 * g1 + c02 * g2,
            c01 * g0 + c11 * g1 + c12 * g2,
            c02 * g0 + c12 * g1 + c22 * g2,
        ],
        dim=-1,
    )
    return X / det_safe[..., None]


def projection_matrix(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(3,3),(...,3,3),(...,3) -> (...,3,4) P = K [R|t]."""
    return K @ torch.cat([R, t[..., None]], dim=-1)


def fundamental_from_poses(R1w, t1w, R2w, t2w, K1, K2) -> torch.Tensor:
    """F12 such that x1^T F12 x2 = 0 (GeometricTools::ComputeF12)."""
    R12 = R1w @ R2w.transpose(-1, -2)
    t12 = t1w - torch.einsum("...ij,...j->...i", R12, t2w)
    E12 = lie.hat(t12) @ R12
    return _inv(K1.transpose(-1, -2)) @ E12 @ _inv(K2)


def normalize_points(x: torch.Tensor, valid: torch.Tensor):
    """Hartley normalization: zero mean, mean absolute deviation 1 per axis
    (TwoViewReconstruction::Normalize). Returns (xn (N,2), T (3,3))."""
    w = valid.to(x.dtype)
    n = torch.clamp_min(torch.sum(w), 1.0)
    mean = torch.sum(x * w[:, None], dim=0) / n
    d = torch.abs(x - mean) * w[:, None]
    md = torch.sum(d, dim=0) / n
    s = 1.0 / torch.where(md < 1e-9, torch.ones_like(md), md)
    xn = (x - mean) * s
    zero, one = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack(
        [
            torch.stack([s[0], zero, -mean[0] * s[0]]),
            torch.stack([zero, s[1], -mean[1] * s[1]]),
            torch.stack([zero, zero, one]),
        ]
    )
    return xn, T


def _rank2(F: torch.Tensor) -> torch.Tensor:
    U, S, Vt = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return U @ torch.diag_embed(S) @ Vt


def _f_rows(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)], dim=-1)


def _h_rows(x1: torch.Tensor, x2: torch.Tensor):
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    z, o = torch.zeros_like(u1), torch.ones_like(u1)
    r1 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], dim=-1)
    r2 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], dim=-1)
    return r1, r2


def fundamental_8pt(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """8-point fundamental from (...,8,2)+(...,8,2) normalized
    correspondences (TwoViewReconstruction::ComputeF21), rank 2 enforced.
    The 8x9 system's null vector is the 9th right-singular vector."""
    A = _f_rows(x1, x2)  # (...,8,9)
    _, _, vt = torch.linalg.svd(A, full_matrices=True)
    return _rank2(vt[..., 8, :].reshape(*A.shape[:-2], 3, 3))


def fundamental_weighted(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Least-squares 8-point F over N weighted correspondences (the inlier
    polish after RANSAC; rows with w = 0 drop out)."""
    A = _f_rows(x1, x2) * w[..., None]
    _, _, vt = torch.linalg.svd(A, full_matrices=False)
    return _rank2(vt[..., -1, :].reshape(*A.shape[:-2], 3, 3))


def homography_weighted(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Least-squares DLT homography over N weighted correspondences."""
    r1, r2 = _h_rows(x1, x2)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)
    _, _, vt = torch.linalg.svd(A, full_matrices=False)
    return vt[..., -1, :].reshape(*A.shape[:-2], 3, 3)


def homography_dlt(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """DLT homography x2 ~ H x1 from (...,n>=4,2) correspondences
    (TwoViewReconstruction::ComputeH21)."""
    r1, r2 = _h_rows(x1, x2)
    A = torch.cat([r1, r2], dim=-2)  # (...,2n,9)
    _, _, vt = torch.linalg.svd(A, full_matrices=True)
    return vt[..., 8, :].reshape(*A.shape[:-2], 3, 3)


def epipolar_sq_errors(F21: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """Squared point-to-epipolar-line distances both ways
    (CheckFundamental residuals). F21 (...,3,3), x (N,2) -> (...,N) each."""
    x1h, x2h = _homog(x1), _homog(x2)
    l2 = x1h @ F21.transpose(-1, -2)  # line in image 2
    l1 = x2h @ F21
    num = torch.sum(l2 * x2h, dim=-1) ** 2
    e2 = num / torch.clamp_min(l2[..., 0] ** 2 + l2[..., 1] ** 2, 1e-12)
    e1 = num / torch.clamp_min(l1[..., 0] ** 2 + l1[..., 1] ** 2, 1e-12)
    return e1, e2


def homography_sq_errors(H21: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """Symmetric transfer errors for H (CheckHomography residuals).
    H21 (...,3,3), x (N,2) -> (...,N) each."""

    def transfer(H, a, b):
        p = _homog(a) @ H.transpose(-1, -2)
        w = torch.where(torch.abs(p[..., 2]) < 1e-12, torch.full_like(p[..., 2], 1e-12), p[..., 2])
        uv = p[..., :2] / w[..., None]
        return torch.sum((uv - b) ** 2, dim=-1)

    return transfer(_inv(H21), x2, x1), transfer(H21, x1, x2)


def decompose_essential(E: torch.Tensor):
    """E -> (R1, R2, t) candidate motions (DecomposeE)."""
    U, _, Vt = torch.linalg.svd(E)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R1 = torch.where(torch.linalg.det(R1) < 0, -R1, R1)
    R2 = U @ W.T @ Vt
    R2 = torch.where(torch.linalg.det(R2) < 0, -R2, R2)
    t = U[:, 2]
    t = t / torch.clamp_min(torch.linalg.vector_norm(t), 1e-12)
    return R1, R2, t


def check_rt(R, t, x1, x2, K, valid, th2: float = 4.0):
    """Cheirality + reprojection check for (R, t) hypotheses (CheckRT).

    R (...,3,3), t (...,3); x1, x2 (N,2) pixel coordinates; valid (N,).
    Returns (n_good (...,), good (...,N), parallax in degrees (...,N),
    points3d in the camera-1 frame (...,N,3)).
    """
    eye = torch.eye(3, dtype=K.dtype, device=K.device)
    P1 = projection_matrix(K, eye, torch.zeros(3, dtype=K.dtype, device=K.device))
    P2 = projection_matrix(K, R, t)
    X = triangulate_dlt(P1, P2[..., None, :, :], x1, x2)  # (...,N,3) in cam1
    finite = torch.all(torch.isfinite(X), dim=-1)
    z1 = X[..., 2]
    X2 = X @ R.transpose(-1, -2) + t[..., None, :]
    z2 = X2[..., 2]
    # Parallax between viewing rays.
    O2 = -torch.einsum("...ji,...j->...i", R, t)
    n1 = X
    n2 = X - O2[..., None, :]
    cosp = torch.sum(n1 * n2, dim=-1) / torch.clamp_min(
        torch.linalg.vector_norm(n1, dim=-1) * torch.linalg.vector_norm(n2, dim=-1), 1e-12
    )
    # Reprojection errors.
    uv1 = ((X / torch.clamp_min(z1[..., None], 1e-12)) @ K.T)[..., :2]
    uv2 = ((X2 / torch.clamp_min(z2[..., None], 1e-12)) @ K.T)[..., :2]
    e1 = torch.sum((uv1 - x1) ** 2, dim=-1)
    e2 = torch.sum((uv2 - x2) ** 2, dim=-1)
    good = valid & finite & (z1 > 0) & (z2 > 0) & (cosp < 0.99998) & (e1 < th2) & (e2 < th2)
    n_good = torch.sum(good.to(torch.int32), dim=-1)
    par = torch.where(good, torch.rad2deg(torch.acos(torch.clamp(cosp, -1, 1))), torch.zeros_like(cosp))
    return n_good, good, par, X
