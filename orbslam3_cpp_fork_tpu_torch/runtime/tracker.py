"""Landmark projection for the tracking path (port of runtime/tracker.py's
`project_landmarks`; the rest of the mono tracker is not ported yet)."""

from __future__ import annotations

import torch

from ..ops.camera import true_div
from ..ops.image import N_LEVELS, SCALE_FACTOR
from ..utils import lie

# log(1.2) evaluated in f32, as the reference's jnp.log(SCALE_FACTOR).
_LOG_SCALE = torch.log(torch.tensor(SCALE_FACTOR, dtype=torch.float32)).item()


def project_landmarks(
    R, t, pos, normal, min_dist, max_dist, lm_valid,
    fx, fy, cx, cy, width, height, n_levels: int = N_LEVELS,
):
    """Frustum + scale-band + viewing-angle gate and predicted search level
    for map landmarks (Frame::isInFrustum, MapPoint::PredictScale).

    Returns (uv (L,2), level (L,) int32, dist (L,), ok (L,) bool).
    """
    pc = lie.se3_apply(R, t, pos)
    z = pc[:, 2]
    z_safe = torch.where(z < 1e-6, torch.full_like(z, 1e-6), z)
    u = fx * pc[:, 0] / z_safe + cx
    v = fy * pc[:, 1] / z_safe + cy
    cam_center = -torch.einsum("ji,j->i", R, t)
    d = pos - cam_center
    dist = torch.linalg.vector_norm(d, dim=-1)
    cos_view = torch.sum(d * normal, dim=-1) / torch.clamp_min(dist, 1e-9)
    ok = (
        lm_valid
        & (z > 0.05)
        & (u >= 0) & (u < width) & (v >= 0) & (v < height)
        & (dist >= min_dist * 0.8) & (dist <= max_dist * 1.2)
        & (cos_view > 0.5)
    )
    ratio = torch.clamp_min(max_dist, 1e-9) / torch.clamp_min(dist, 1e-9)
    # f32 as the reference. A landmark seen from its own keyframe sits on a
    # level boundary, where the last bit of the f32 log decides the level,
    # and that bit differs between the CPU and CUDA libraries.
    level = torch.ceil(true_div(torch.log(ratio), _LOG_SCALE)).to(torch.int32)
    level = torch.clamp(level, 0, n_levels - 1)
    return torch.stack([u, v], dim=-1), level, dist, ok
