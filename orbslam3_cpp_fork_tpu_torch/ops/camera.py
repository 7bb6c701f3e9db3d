"""Pinhole camera with radial-tangential distortion (port of ops/camera.py).

A `Camera` holds its intrinsics as Python floats rounded to float32 (the
reference keeps them as f32 scalars), so arithmetic against f32 tensors
runs in f32 on every device and needs no device tensor of its own. The
Kannala-Brandt-8 fisheye model waits for the slice that needs it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

PINHOLE = "pinhole"


def _f32(x) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class Camera:
    """Camera intrinsics; dist = (k1, k2, p1, p2, k3) radial-tangential."""

    fx: float
    fy: float
    cx: float
    cy: float
    dist: tuple[float, float, float, float, float] = (0.0, 0.0, 0.0, 0.0, 0.0)
    kind: str = PINHOLE

    @staticmethod
    def pinhole(fx, fy, cx, cy, dist=(0.0, 0.0, 0.0, 0.0, 0.0)) -> "Camera":
        d = [0.0] * 5
        for i, v in enumerate(tuple(dist)[:5]):
            d[i] = _f32(v)
        return Camera(_f32(fx), _f32(fy), _f32(cx), _f32(cy), tuple(d), PINHOLE)


def _check_kind(cam: Camera) -> None:
    if cam.kind != PINHOLE:
        raise NotImplementedError(f"camera model {cam.kind!r} is not ported yet")


def _distort_radtan(cam: Camera, xn, yn):
    k1, k2, p1, p2, k3 = cam.dist
    r2 = xn * xn + yn * yn
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = xn * radial + 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2.0 * yn * yn) + 2.0 * p2 * xn * yn
    return xd, yd


def project(cam: Camera, pc: torch.Tensor, distort: bool = True) -> torch.Tensor:
    """Project camera-frame 3D points (...,3) to pixels (...,2)."""
    _check_kind(cam)
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    xn, yn = x / z_safe, y / z_safe
    if distort:
        xn, yn = _distort_radtan(cam, xn, yn)
    return torch.stack([cam.fx * xn + cam.cx, cam.fy * yn + cam.cy], dim=-1)


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d rounded as an IEEE division on every device (CUDA turns a
    division by a Python scalar into a multiply by its reciprocal)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def unproject(cam: Camera, uv: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Pixels (...,2) -> unit-depth bearing (...,3) with z=1 (fixed-point
    radtan undistortion, cv::undistortPoints semantics)."""
    _check_kind(cam)
    u = true_div(uv[..., 0] - cam.cx, cam.fx)
    v = true_div(uv[..., 1] - cam.cy, cam.fy)
    xn, yn = u, v
    for _ in range(iters):
        xd, yd = _distort_radtan(cam, xn, yn)
        xn, yn = xn + (u - xd), yn + (v - yd)
    return torch.stack([xn, yn, torch.ones_like(xn)], dim=-1)


def undistort_points(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Raw pixel keypoints -> ideal-pinhole pixel coordinates
    (Frame::UndistortKeyPoints)."""
    b = unproject(cam, uv)
    return torch.stack([cam.fx * b[..., 0] + cam.cx, cam.fy * b[..., 1] + cam.cy], dim=-1)
