"""Synthetic test sequences with exact ground truth (numpy; port of
datasets/synthetic.py) and a seeded localization map.

A random 3D blob field observed from a smooth camera trajectory. Blob
intensity is a property of the 3D point and on-screen blob size is fixed,
so ORB descriptors are stable across views. `seed_local_map` builds the
local-map snapshot the localization tracker runs against, from the
rendered frames, their exact depth and the port's own ORB features.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _so3_exp_np(w: np.ndarray) -> np.ndarray:
    """Rodrigues formula in f32 numpy (the reference calls utils.lie.so3_exp)."""
    w = np.asarray(w, np.float32)
    theta2 = np.float32(np.sum(w * w))
    theta = np.float32(np.sqrt(theta2))
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]], np.float32)
    if theta < 1e-4:
        a, b = 1.0 - theta2 / 6.0, 0.5 - theta2 / 24.0
    else:
        a, b = np.sin(theta) / theta, (1.0 - np.cos(theta)) / theta2
    return (np.eye(3, dtype=np.float32) + np.float32(a) * W + np.float32(b) * (W @ W)).astype(np.float32)


def _so3_log_np(R: np.ndarray) -> np.ndarray:
    """Rotation -> tangent (3,) in f32 numpy, through the quaternion of
    Shepperd's method as the reference's utils.lie.so3_log."""
    R = np.asarray(R, np.float32)
    (m00, m01, m02), (m10, m11, m12), (m20, m21, m22) = R
    z = np.float32(0.0)
    mags = [max(z, 1 + m00 - m11 - m22), max(z, 1 - m00 + m11 - m22), max(z, 1 - m00 - m11 + m22),
            max(z, 1 + (m00 + m11 + m22))]
    cands = [
        [mags[0], m10 + m01, m02 + m20, m21 - m12],
        [m10 + m01, mags[1], m21 + m12, m02 - m20],
        [m02 + m20, m21 + m12, mags[2], m10 - m01],
        [m21 - m12, m02 - m20, m10 - m01, mags[3]],
    ]
    q = np.asarray(cands[int(np.argmax(mags))], np.float32)
    q = (q / np.float32(np.linalg.norm(q))).astype(np.float32)
    if q[3] < 0:
        q = -q
    n = np.float32(np.linalg.norm(q[:3]))
    if n < 1e-6:
        scale = np.float32(2.0) / max(q[3], np.float32(0.5))
    else:
        scale = np.float32(2.0) * np.float32(np.arctan2(n, q[3])) / n
    return (q[:3] * np.float32(scale)).astype(np.float32)


@dataclasses.dataclass
class SyntheticScene:
    points: np.ndarray  # (P,3) world
    intensity: np.ndarray  # (P,)
    size: np.ndarray  # (P,) fixed on-screen blob size (viewpoint-invariant
    # so ORB descriptors stay stable across frames)
    width: int
    height: int
    K: np.ndarray  # (3,3)
    # (P,s,s) per-point texture patch: makes BRIEF descriptors DISTINCT
    # between points (untextured squares all look alike to a binary
    # descriptor, starving the matcher's ratio test).
    pattern: np.ndarray | None = None



def _make_patterns(rng, n_points: int, s_max: int, intensity: np.ndarray) -> np.ndarray:
    """Per-point texture patches (s_max, s_max): base intensity modulated
    by LOW-FREQUENCY point-specific noise (a coarse grid bilinearly
    upsampled). Low frequency matters: per-pixel noise makes BRIEF
    comparisons flip under the sub-pixel sampling shifts of small
    viewpoint changes, which no real image exhibits after the 7x7
    Gaussian blur ORB applies."""
    g = 4  # coarse grid
    coarse = rng.uniform(-70.0, 70.0, (n_points, g, g)).astype(np.float32)
    # Bilinear upsample g x g -> s_max x s_max.
    xs = np.linspace(0, g - 1, s_max)
    x0 = np.floor(xs).astype(int)
    x1 = np.minimum(x0 + 1, g - 1)
    wx = (xs - x0).astype(np.float32)
    rows = (
        coarse[:, :, x0] * (1 - wx) + coarse[:, :, x1] * wx
    )  # (P,g,s_max)
    noise = (
        rows[:, x0, :] * (1 - wx)[None, :, None]
        + rows[:, x1, :] * wx[None, :, None]
    )  # (P,s_max,s_max)
    pat = np.clip(intensity[:, None, None] + noise, 20.0, 250.0)
    return pat.astype(np.float32)


def make_scene(
    n_points=1200,
    extent=12.0,
    depth=(3.0, 10.0),
    width=640,
    height=480,
    fx=400.0,
    seed=0,
    size_range=(5, 11),
) -> SyntheticScene:
    rng = np.random.default_rng(seed)
    # Points spread in a thick frontal slab the trajectory flies along.
    pts = np.stack(
        [
            rng.uniform(-extent, extent, n_points),
            rng.uniform(-extent * 0.4, extent * 0.4, n_points),
            rng.uniform(depth[0], depth[1], n_points),
        ],
        axis=1,
    ).astype(np.float32)
    K = np.array(
        [[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1]], np.float32
    )
    intensity = rng.uniform(70, 240, n_points).astype(np.float32)
    size = rng.integers(*size_range, n_points).astype(np.int32)
    return SyntheticScene(
        points=pts,
        intensity=intensity,
        size=size,
        width=width,
        height=height,
        K=K,
        pattern=_make_patterns(rng, n_points, int(size_range[1]), intensity),
    )


def make_ring_scene(
    n_points=3000,
    r_inner=8.0,
    r_outer=14.0,
    half_height=4.0,
    width=640,
    height=480,
    fx=400.0,
    seed=0,
    size_range=(5, 11),
) -> SyntheticScene:
    """Points in an annulus around the origin — for loop-closure tests
    where a camera circles inside looking outward and revisits its
    starting view after 360 degrees."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, 2 * np.pi, n_points)
    r = rng.uniform(r_inner, r_outer, n_points)
    pts = np.stack(
        [r * np.cos(th), r * np.sin(th), rng.uniform(-half_height, half_height, n_points)],
        axis=1,
    ).astype(np.float32)
    K = np.array(
        [[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1]], np.float32
    )
    intensity = rng.uniform(70, 240, n_points).astype(np.float32)
    size = rng.integers(*size_range, n_points).astype(np.int32)
    return SyntheticScene(
        points=pts,
        intensity=intensity,
        size=size,
        width=width,
        height=height,
        K=K,
        pattern=_make_patterns(rng, n_points, int(size_range[1]), intensity),
    )


def circle_trajectory(n_frames=120, radius=2.5, total_angle=2.35 * np.pi):
    """Camera on a circle looking radially outward; sweeps total_angle
    (default ~360 deg + overlap so the loop actually re-observes the
    start). Returns camera-to-world (R_wc, t_wc) stacks."""
    Rs, ts = [], []
    for i in range(n_frames):
        th = total_angle * i / n_frames
        z_w = np.array([np.cos(th), np.sin(th), 0.0])  # optical axis: outward
        x_w = np.array([-np.sin(th), np.cos(th), 0.0])  # image x: tangent
        y_w = np.cross(z_w, x_w)
        Rwc = np.stack([x_w, y_w, z_w], axis=1).astype(np.float32)
        twc = np.array([radius * np.cos(th), radius * np.sin(th), 0.0], np.float32)
        Rs.append(Rwc)
        ts.append(twc)
    return np.stack(Rs), np.stack(ts)


def smooth_trajectory(n_frames=60, step=0.06, yaw_rate=0.004, seed=1):
    """Forward-lateral dolly with slow yaw — returns (R_wc, t_wc) lists
    of camera-to-world poses (camera looks along +z)."""
    Rs, ts = [], []
    R = np.eye(3, dtype=np.float32)
    t = np.zeros(3, np.float32)
    rng = np.random.default_rng(seed)
    for i in range(n_frames):
        Rs.append(R.copy())
        ts.append(t.copy())
        yaw = yaw_rate * (1.0 + 0.3 * np.sin(i * 0.15))
        dR = _so3_exp_np(np.array([0.0, yaw, 0.0], np.float32))
        R = (R @ dR).astype(np.float32)
        # Move mostly laterally (good parallax) with slight forward drift.
        step_vec = np.array([step, 0.12 * step * np.sin(i * 0.2), 0.3 * step], np.float32)
        t = t + R @ step_vec
    return np.stack(Rs), np.stack(ts)


def render_frame(scene: SyntheticScene, R_wc: np.ndarray, t_wc: np.ndarray) -> np.ndarray:
    """Render one grayscale frame (float32, 0..255) from a camera pose
    given in camera-to-world convention."""
    R_cw = R_wc.T
    t_cw = -R_cw @ t_wc
    pc = scene.points @ R_cw.T + t_cw
    z = pc[:, 2]
    vis = z > 0.3
    uv = pc[vis] @ scene.K.T
    uv = uv[:, :2] / uv[:, 2:3]
    zz = z[vis]
    ii = scene.intensity[vis]
    ss = scene.size[vis]
    img = np.full((scene.height, scene.width), 35.0, np.float32)
    vis_idx = np.nonzero(vis)[0]
    order = np.argsort(-zz)  # far first (near blobs overwrite)
    for j in order:
        u, v = uv[j]
        s = int(ss[j])
        half = s // 2
        iu, iv = int(round(u)) - half, int(round(v)) - half
        if -s < iu < scene.width and -s < iv < scene.height:
            u0, u1 = max(iu, 0), min(iu + s, scene.width)
            v0, v1 = max(iv, 0), min(iv + s, scene.height)
            if scene.pattern is not None:
                pat = scene.pattern[vis_idx[j], : s, : s]
                img[v0:v1, u0:u1] = pat[v0 - iv : v1 - iv, u0 - iu : u1 - iu]
            else:
                img[v0:v1, u0:u1] = ii[j]
    return img


def degrade(
    img: np.ndarray,
    noise_sigma: float = 0.0,
    blur_sigma: float = 0.0,
    exposure: float = 1.0,
    seed: int = 0,
) -> np.ndarray:
    """Photometric degradation for realism gates: additive Gaussian
    sensor noise, Gaussian motion/defocus blur, and a global exposure
    gain. The noiseless renders make every ATE best-case; tests also run
    on degraded variants."""
    out = img.astype(np.float32) * float(exposure)
    if blur_sigma > 0:
        # Separable Gaussian blur via erf-integrated taps.
        r = max(1, int(np.ceil(3 * blur_sigma)))
        x = np.arange(-r, r + 1, dtype=np.float32)
        k = np.exp(-0.5 * (x / blur_sigma) ** 2)
        k /= k.sum()
        out = np.apply_along_axis(
            lambda row: np.convolve(row, k, mode="same"), 1, out
        )
        out = np.apply_along_axis(
            lambda col: np.convolve(col, k, mode="same"), 0, out
        )
    if noise_sigma > 0:
        rng = np.random.default_rng(seed)
        out = out + rng.normal(0.0, noise_sigma, out.shape).astype(np.float32)
    return np.clip(out, 0.0, 255.0)


def render_depth(scene: SyntheticScene, R_wc: np.ndarray, t_wc: np.ndarray) -> np.ndarray:
    """Depth map matching render_frame's rasterization (for RGB-D tests)."""
    R_cw = R_wc.T
    t_cw = -R_cw @ t_wc
    pc = scene.points @ R_cw.T + t_cw
    z = pc[:, 2]
    vis = z > 0.3
    uv = pc[vis] @ scene.K.T
    uv = uv[:, :2] / uv[:, 2:3]
    zz = z[vis]
    ss = scene.size[vis]
    dep = np.zeros((scene.height, scene.width), np.float32)
    order = np.argsort(-zz)
    for j in order:
        u, v = uv[j]
        s = int(ss[j])
        half = s // 2
        iu, iv = int(round(u)) - half, int(round(v)) - half
        if -s < iu < scene.width and -s < iv < scene.height:
            u0, u1 = max(iu, 0), min(iu + s, scene.width)
            v0, v1 = max(iv, 0), min(iv + s, scene.height)
            dep[v0:v1, u0:u1] = zz[j]
    return dep


def stereo_right_pose(R_wc: np.ndarray, t_wc: np.ndarray, baseline: float):
    """Camera-to-world pose of the right camera of a rectified pair."""
    return R_wc, t_wc + R_wc @ np.array([baseline, 0.0, 0.0], np.float32)


def render_sequence(scene, Rs_wc, ts_wc):
    """Float frames of the camera-to-world poses (Rs_wc, ts_wc)."""
    return [render_frame(scene, R, t) for R, t in zip(Rs_wc, ts_wc)]


def imu_from_trajectory(Rs_wc, ts_wc, frame_dt: float, imu_rate: int = 200):
    """Exact IMU measurements for a piecewise-linear interpolation of the
    trajectory: per frame interval a list entry (acc, gyro, dt) of f32
    arrays at `imu_rate`, the rotation at constant rate between frames and
    the acceleration from central differences of the positions. Gravity is
    -9.81 along world z."""
    from ..ops.imu import GRAVITY

    g = np.array([0.0, 0.0, -GRAVITY])
    n = len(Rs_wc)
    sub = max(int(round(imu_rate * frame_dt)), 2)
    out = []
    for i in range(n - 1):
        R0, R1 = Rs_wc[i], Rs_wc[i + 1]
        t0, t1 = ts_wc[i], ts_wc[i + 1]
        w = _so3_log_np(R0.T @ R1) / frame_dt
        accs, gyrs, dts = [], [], []
        dt = frame_dt / sub
        v0 = (t1 - (ts_wc[i - 1] if i > 0 else t0)) / (frame_dt * (2 if i > 0 else 1))
        v1 = ((ts_wc[i + 2] if i + 2 < n else t1) - t0) / (frame_dt * (2 if i + 2 < n else 1))
        a_w = (v1 - v0) / frame_dt
        for s in range(sub):
            alpha = (s + 0.5) / sub
            R_ws = R0 @ _so3_exp_np(w * frame_dt * alpha)
            accs.append(R_ws.T @ (a_w - g))
            gyrs.append(w)
            dts.append(dt)
        out.append((np.asarray(accs, np.float32), np.asarray(gyrs, np.float32), np.asarray(dts, np.float32)))
    return out


def to_u8(img: np.ndarray) -> np.ndarray:
    """Rendered float frame -> raw uint8 camera frame (clip and truncate,
    as the reference tracker converts float input)."""
    return np.clip(img, 0, 255).astype(np.uint8)


def seed_local_map(
    scene: SyntheticScene,
    Rs_wc: np.ndarray,
    ts_wc: np.ndarray,
    capacity: int,
    kf_every: int,
    orb_params=None,
    device="cuda",
    min_sep: float = 0.05,
) -> dict:
    """A localization map built from rendered keyframes with exact depth.

    Every `kf_every`-th pose of (Rs_wc, ts_wc) is a keyframe: its frame is
    rendered, the port's ORB runs on it (on `device`: the card unless the
    caller asks for the CPU), and every valid
    feature is back-projected with `render_depth` at its pixel. A point
    within `min_sep` of an existing landmark is skipped; the map stops at
    `capacity`. Each landmark keeps the feature's packed descriptor, the
    unit normal from the keyframe's centre, and the scale band MapState
    uses: max = d*1.2^level*1.2, min = d*1.2^(level-7)/1.2.

    Returns the snapshot the runtime uploads (Tracker._refresh_dev_local):
    pos (L,3) f32, normal (L,3) f32, mind (L,) f32, maxd (L,) f32 (padding
    1.0), desc (L,8) uint32, valid (L,) bool, with L = capacity.
    """
    import torch

    from ..device import get_device
    from ..ops import orb

    device = get_device(device)
    p = orb_params if orb_params is not None else orb.OrbParams()
    fx, fy, cx, cy = (float(v) for v in (scene.K[0, 0], scene.K[1, 1], scene.K[0, 2], scene.K[1, 2]))
    pos = np.zeros((capacity, 3), np.float32)
    normal = np.zeros((capacity, 3), np.float32)
    mind = np.zeros((capacity,), np.float32)
    maxd = np.ones((capacity,), np.float32)
    desc = np.zeros((capacity, 8), np.uint32)
    n = 0
    for i in range(0, len(Rs_wc), kf_every):
        if n >= capacity:
            break
        R, t = Rs_wc[i], ts_wc[i]
        img = torch.from_numpy(to_u8(render_frame(scene, R, t)).astype(np.float32)).to(device)
        feats = orb.extract_orb(img, p)
        valid = feats.valid.cpu().numpy()
        xy = feats.xy.cpu().numpy()[valid]
        lvl = feats.level.cpu().numpy()[valid]
        words = feats.desc_numpy()[valid]
        depth = render_depth(scene, R, t)
        px = np.clip(np.round(xy).astype(np.int64), 0, [scene.width - 1, scene.height - 1])
        z = depth[px[:, 1], px[:, 0]]
        for j in np.nonzero(z > 0)[0]:
            if n >= capacity:
                break
            xc = np.array([(xy[j, 0] - cx) / fx * z[j], (xy[j, 1] - cy) / fy * z[j], z[j]], np.float32)
            X = (R @ xc + t).astype(np.float32)
            if n and np.min(np.sum((pos[:n] - X) ** 2, axis=1)) < min_sep**2:
                continue
            ray = X - t
            d = float(np.linalg.norm(ray))
            pos[n] = X
            normal[n] = ray / d
            maxd[n] = d * 1.2 ** int(lvl[j]) * 1.2
            mind[n] = d * 1.2 ** (int(lvl[j]) - 7) / 1.2
            desc[n] = words[j]
            n += 1
    valid_lm = np.zeros((capacity,), bool)
    valid_lm[:n] = True
    return dict(pos=pos, normal=normal, mind=mind, maxd=maxd, desc=desc, valid=valid_lm)
