"""Camera models: pinhole with radial-tangential distortion and
Kannala-Brandt-8 fisheye (port of ops/camera.py).

A `Camera` holds its intrinsics as Python floats rounded to float32 (the
reference keeps them as f32 scalars), so arithmetic against f32 tensors
runs in f32 on every device and needs no device tensor of its own. KB8
unprojection is the reference's fixed-count Newton iteration on theta.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

PINHOLE = "pinhole"
KANNALA_BRANDT8 = "kb8"


def _f32(x) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class Camera:
    """Camera intrinsics; dist = (k1, k2, p1, p2, k3) radial-tangential for
    pinhole, (k1, k2, k3, k4, 0) equidistant polynomial for kb8."""

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

    @staticmethod
    def kb8(fx, fy, cx, cy, k1=0.0, k2=0.0, k3=0.0, k4=0.0) -> "Camera":
        d = (_f32(k1), _f32(k2), _f32(k3), _f32(k4), 0.0)
        return Camera(_f32(fx), _f32(fy), _f32(cx), _f32(cy), d, KANNALA_BRANDT8)

    def scaled(self, sx: float, sy: float) -> "Camera":
        """Intrinsics after resizing the image by (sx, sy). The products are
        rounded to float32, as the reference's f32 scalars are."""
        sx, sy = np.float32(sx), np.float32(sy)
        return Camera(
            _f32(np.float32(self.fx) * sx), _f32(np.float32(self.fy) * sy),
            _f32(np.float32(self.cx) * sx), _f32(np.float32(self.cy) * sy), self.dist, self.kind,
        )

    @property
    def K(self) -> torch.Tensor:
        """The (3, 3) float32 intrinsic matrix, on the CPU."""
        return torch.tensor([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]], dtype=torch.float32)


def _distort_radtan(cam: Camera, xn, yn):
    k1, k2, p1, p2, k3 = cam.dist
    r2 = xn * xn + yn * yn
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = xn * radial + 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2.0 * yn * yn) + 2.0 * p2 * xn * yn
    return xd, yd


def _kb8_theta_d(cam: Camera, theta):
    k1, k2, k3, k4 = cam.dist[:4]
    t2 = theta * theta
    return theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))


def project(cam: Camera, pc: torch.Tensor, distort: bool = True) -> torch.Tensor:
    """Project camera-frame 3D points (...,3) to pixels (...,2). Pinhole with
    distort=False is the ideal model of undistorted keypoints; KB8 always
    projects with the fisheye model."""
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    if cam.kind == PINHOLE:
        z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        xn, yn = x / z_safe, y / z_safe
        if distort:
            xn, yn = _distort_radtan(cam, xn, yn)
        return torch.stack([cam.fx * xn + cam.cx, cam.fy * yn + cam.cy], dim=-1)
    r = torch.sqrt(x * x + y * y)
    on_axis = r < 1e-9
    r_safe = torch.where(on_axis, torch.full_like(r, 1e-9), r)
    theta_d = _kb8_theta_d(cam, torch.atan2(r, z))
    u = torch.where(on_axis, torch.full_like(r, cam.cx), cam.fx * theta_d * (x / r_safe) + cam.cx)
    v = torch.where(on_axis, torch.full_like(r, cam.cy), cam.fy * theta_d * (y / r_safe) + cam.cy)
    return torch.stack([u, v], dim=-1)


def project_jacobian(cam: Camera, pc: torch.Tensor) -> torch.Tensor:
    """d(uv)/d(pc): (...,2,3). The ideal-pinhole Jacobian in closed form
    (distortion is handled by undistorting the observations), the KB8 model
    by forward-mode autodiff of `project`, vectorized over the batch."""
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    if cam.kind == PINHOLE:
        z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        iz = 1.0 / z_safe
        iz2 = iz * iz
        zero = torch.zeros_like(x)
        row_u = torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], dim=-1)
        row_v = torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], dim=-1)
        return torch.stack([row_u, row_v], dim=-2)
    # Each point keeps a leading dim of 1: under jacfwd a 0-d tensor met by
    # a Python number would compute in float64.
    flat = pc.reshape(-1, 1, 3)
    J = torch.func.vmap(torch.func.jacfwd(lambda p: project(cam, p)[0]))(flat)
    return J.reshape(*pc.shape[:-1], 2, 3)


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d rounded as an IEEE division on every device (CUDA turns a
    division by a Python scalar into a multiply by its reciprocal)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def unproject(cam: Camera, uv: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Pixels (...,2) -> unit-depth bearing (...,3) with z=1. Pinhole:
    fixed-point radtan undistortion (cv::undistortPoints semantics); KB8:
    `iters` Newton steps on theta from theta_d clamped to +-pi/2."""
    u = true_div(uv[..., 0] - cam.cx, cam.fx)
    v = true_div(uv[..., 1] - cam.cy, cam.fy)
    if cam.kind == PINHOLE:
        xn, yn = u, v
        for _ in range(iters):
            xd, yd = _distort_radtan(cam, xn, yn)
            xn, yn = xn + (u - xd), yn + (v - yd)
        return torch.stack([xn, yn, torch.ones_like(xn)], dim=-1)
    theta_d = torch.sqrt(u * u + v * v)
    theta_d_c = torch.clamp(theta_d, -np.pi / 2, np.pi / 2)
    k1, k2, k3, k4 = cam.dist[:4]
    theta = theta_d_c
    for _ in range(iters):
        t2 = theta * theta
        f = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - theta_d_c
        df = 1.0 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + t2 * 9 * k4)))
        theta = theta - f / torch.where(torch.abs(df) < 1e-9, torch.full_like(df, 1e-9), df)
    far = theta_d > 1e-9
    scale = torch.where(far, torch.tan(theta) / torch.where(far, theta_d, torch.ones_like(theta_d)),
                        torch.ones_like(theta_d))
    return torch.stack([u * scale, v * scale, torch.ones_like(u)], dim=-1)


def undistort_points(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Raw pixel keypoints -> ideal-pinhole pixel coordinates
    (Frame::UndistortKeyPoints). KB8 keypoints are mapped onto the ideal
    pinhole plane too (the batched optimizers use one pinhole residual),
    with the bearing's radius clamped at 9.5 (theta <= ~84 degrees) so that
    the periphery of a wide lens stays bounded."""
    b = unproject(cam, uv)
    u, v = cam.fx * b[..., 0], cam.fy * b[..., 1]
    if cam.kind != PINHOLE:
        r = torch.sqrt(b[..., 0] ** 2 + b[..., 1] ** 2)
        s = torch.clamp(9.5 / torch.clamp_min(r, 1e-9), max=1.0)
        u, v = u * s, v * s
    return torch.stack([u + cam.cx, v + cam.cy], dim=-1)
