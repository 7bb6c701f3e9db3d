"""Stereo rectification precompute for unrectified pinhole rigs.

Replaces the reference's OpenCV-backed precompute
(`Settings::precomputeRectificationMaps`, src/Settings.cc:458-530:
cv::stereoRectify + cv::initUndistortRectifyMap) with a native
implementation: Bouguet epipolar rectification splitting the relative
rotation evenly between the cameras, then per-pixel inverse maps
(rectified pixel -> raw distorted pixel) consumed on-device by
`ops.image.remap_bilinear` (the cv::remap of System::TrackStereo,
src/System.cc:282-301).

All of this is one-time host-side setup (numpy, float64 internally);
the per-frame remap runs on the tracker's device. (Copy of
utils/rectify.py: numpy only.)
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class StereoRectification:
    """Precomputed rectification of a two-camera pinhole rig.

    R1/R2 rotate raw camera-1/2 coords into the rectified frames.
    K_new is the shared rectified intrinsic matrix; bf = baseline * fx.
    map*_x/y are (H, W) float32 inverse maps for remap_bilinear.
    """

    R1: np.ndarray
    R2: np.ndarray
    K_new: np.ndarray
    baseline: float
    bf: float
    map1_x: np.ndarray
    map1_y: np.ndarray
    map2_x: np.ndarray
    map2_y: np.ndarray


def _rodrigues(R: np.ndarray) -> np.ndarray:
    """SO3 log (rotation vector)."""
    cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos)
    if theta < 1e-12:
        return np.zeros(3)
    w = (
        np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
        / (2.0 * np.sin(theta))
    )
    return w * theta


def _rodrigues_inv(w: np.ndarray) -> np.ndarray:
    """SO3 exp."""
    theta = np.linalg.norm(w)
    if theta < 1e-12:
        return np.eye(3)
    k = w / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def _distort_radtan(xn, yn, dist):
    k1, k2, p1, p2, k3 = (float(dist[i]) if i < len(dist) else 0.0 for i in range(5))
    r2 = xn * xn + yn * yn
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = xn * radial + 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2.0 * yn * yn) + 2.0 * p2 * xn * yn
    return xd, yd


def stereo_rectify(
    K1: np.ndarray,
    dist1: np.ndarray,
    K2: np.ndarray,
    dist2: np.ndarray,
    T_c1_c2: np.ndarray,
    size: tuple[int, int],
) -> StereoRectification:
    """Bouguet rectification of a calibrated pinhole stereo rig.

    T_c1_c2 is the 4x4 pose of camera 2 in camera 1 coordinates
    (the `Stereo.T_c1_c2` YAML key: x_c1 = R12 x_c2 + t12), matching
    Settings::readCamera2 (src/Settings.cc:258-311). size = (H, W).
    """
    h, w = size
    T = np.asarray(T_c1_c2, np.float64)
    R12, t12 = T[:3, :3], T[:3, 3]
    # OpenCV convention: x2 = R x1 + t.
    R = R12.T
    t = -R12.T @ t12

    # Split the relative rotation evenly: each camera rotates by half.
    om = _rodrigues(R)
    r_half = _rodrigues_inv(-om / 2.0)
    t_half = r_half @ t

    # Rotate so the baseline becomes the rectified x axis.
    e1 = t_half / np.linalg.norm(t_half)
    if e1[0] < 0:
        e1 = -e1  # keep left camera on the left
    e2 = np.array([-e1[1], e1[0], 0.0])
    n2 = np.linalg.norm(e2)
    e2 = np.array([0.0, 1.0, 0.0]) if n2 < 1e-12 else e2 / n2
    e3 = np.cross(e1, e2)
    Rrect = np.stack([e1, e2, e3])

    R1 = Rrect @ r_half.T
    R2 = Rrect @ r_half
    baseline = float(np.linalg.norm(t))

    # Shared rectified intrinsics: mean focal length, principal point
    # centered on where the raw optical axes land (mean of the two).
    f = (K1[0, 0] + K1[1, 1] + K2[0, 0] + K2[1, 1]) / 4.0
    cx = (K1[0, 2] + K2[0, 2]) / 2.0
    cy = (K1[1, 2] + K2[1, 2]) / 2.0
    K_new = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])

    map1_x, map1_y = init_undistort_rectify_map(K1, dist1, R1, K_new, size)
    map2_x, map2_y = init_undistort_rectify_map(K2, dist2, R2, K_new, size)
    return StereoRectification(
        R1=R1,
        R2=R2,
        K_new=K_new,
        baseline=baseline,
        bf=baseline * f,
        map1_x=map1_x,
        map1_y=map1_y,
        map2_x=map2_x,
        map2_y=map2_y,
    )


def init_undistort_rectify_map(
    K: np.ndarray,
    dist: np.ndarray,
    R_rect: np.ndarray,
    K_new: np.ndarray,
    size: tuple[int, int],
) -> tuple[np.ndarray, np.ndarray]:
    """Inverse maps: for each rectified pixel, the raw-image pixel to
    sample (cv::initUndistortRectifyMap). size = (H, W)."""
    h, w = size
    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    x = (u - K_new[0, 2]) / K_new[0, 0]
    y = (v - K_new[1, 2]) / K_new[1, 1]
    ones = np.ones_like(x)
    # Rectified ray -> raw camera frame.
    d = np.stack([x, y, ones], axis=-1) @ R_rect  # = R_rect.T applied rowwise
    xn = d[..., 0] / d[..., 2]
    yn = d[..., 1] / d[..., 2]
    xd, yd = _distort_radtan(xn, yn, np.asarray(dist, np.float64))
    map_x = (K[0, 0] * xd + K[0, 2]).astype(np.float32)
    map_y = (K[1, 1] * yd + K[1, 2]).astype(np.float32)
    return map_x, map_y


def rectify_points(
    pts: np.ndarray,
    K: np.ndarray,
    dist: np.ndarray,
    R_rect: np.ndarray,
    K_new: np.ndarray,
    iters: int = 8,
) -> np.ndarray:
    """Forward transform of raw distorted pixel coords into the
    rectified image (cv::undistortPoints with R and P): Newton
    undistortion, rotate by R_rect, reproject with K_new."""
    pts = np.asarray(pts, np.float64)
    xd = (pts[:, 0] - K[0, 2]) / K[0, 0]
    yd = (pts[:, 1] - K[1, 2]) / K[1, 1]
    xn, yn = xd.copy(), yd.copy()
    for _ in range(iters):
        xe, ye = _distort_radtan(xn, yn, np.asarray(dist, np.float64))
        xn += xd - xe
        yn += yd - ye
    d = np.stack([xn, yn, np.ones_like(xn)], axis=-1) @ R_rect.T
    u = K_new[0, 0] * d[:, 0] / d[:, 2] + K_new[0, 2]
    v = K_new[1, 1] * d[:, 1] / d[:, 2] + K_new[1, 2]
    return np.stack([u, v], axis=-1)
