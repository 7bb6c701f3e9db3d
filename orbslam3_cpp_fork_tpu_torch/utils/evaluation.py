"""Trajectory evaluation: ATE RMSE with Umeyama/Horn alignment.

Native implementation of evaluation/evaluate_ate_scale.py (the
reference's offline evaluation protocol): associate two trajectories by
timestamp, align with the closed-form similarity (rotation + translation
+ optional scale, evaluate_ate_scale.py:49-99), report RMSE of
translational error both with and without optimal scale.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class AteResult:
    rmse: float  # with unit scale (GT scale)
    rmse_scaled: float  # with optimal scale
    scale: float
    n_pairs: int


def associate(ts_a: np.ndarray, ts_b: np.ndarray, max_dt: float = 0.02):
    """Greedy nearest-timestamp association (associate.py semantics)."""
    pairs = []
    used_b = set()
    for ia, ta in enumerate(ts_a):
        ib = int(np.argmin(np.abs(ts_b - ta)))
        if abs(ts_b[ib] - ta) <= max_dt and ib not in used_b:
            pairs.append((ia, ib))
            used_b.add(ib)
    return np.asarray(pairs, np.int64).reshape(-1, 2)


def align_umeyama(model: np.ndarray, data: np.ndarray, with_scale: bool):
    """Find s, R, t minimizing || data - (s R model + t) ||^2."""
    mu_m = model.mean(axis=0)
    mu_d = data.mean(axis=0)
    mc = model - mu_m
    dc = data - mu_d
    W = dc.T @ mc / len(model)
    U, S, Vt = np.linalg.svd(W)
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    if with_scale:
        var_m = (mc**2).sum() / len(model)
        s = float(np.trace(np.diag(S) @ D) / var_m)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_m
    return s, R, t


def ate_rmse(
    ts_est: np.ndarray,
    pos_est: np.ndarray,
    ts_gt: np.ndarray,
    pos_gt: np.ndarray,
    max_dt: float = 0.02,
) -> AteResult:
    """ATE of estimated positions vs ground truth, both aligned with
    7-dof (optimal scale) and 6-dof-after-7-dof-rotation like the
    reference script (it reports 'ATE RMSE (GT scale)' using the
    scale-optimal rotation but unit scale)."""
    pairs = associate(ts_est, ts_gt, max_dt)
    if len(pairs) < 3:
        return AteResult(np.inf, np.inf, 1.0, len(pairs))
    pe = pos_est[pairs[:, 0]]
    pg = pos_gt[pairs[:, 1]]
    s, R, t = align_umeyama(pe, pg, with_scale=True)
    err_scaled = (s * (R @ pe.T).T + t) - pg
    # Unit-scale error with the same rotation (reference prints both).
    t1 = pg.mean(0) - (R @ pe.T).T.mean(0)
    err_unit = ((R @ pe.T).T + t1) - pg
    return AteResult(
        rmse=float(np.sqrt((err_unit**2).sum(axis=1).mean())),
        rmse_scaled=float(np.sqrt((err_scaled**2).sum(axis=1).mean())),
        scale=s,
        n_pairs=len(pairs),
    )
