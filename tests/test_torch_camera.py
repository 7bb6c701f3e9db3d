"""Kannala-Brandt-8 camera, `remap_bilinear`, the copied rectification and
the TUM-VI calibration, against the JAX reference on the same numpy inputs.

Tolerances: KB8 `project`, `unproject`, `undistort_points` 1e-5 (pixels
relative to the largest coordinate, bearings relative to their own size);
`remap_bilinear` 1e-5 of the gray range; the copied
`utils/rectify.py` equal to the reference's outputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.datasets import tumvi as jtumvi
from orbslam3_cpp_fork_tpu.ops import camera as jcam
from orbslam3_cpp_fork_tpu.ops import image as jimage
from orbslam3_cpp_fork_tpu.utils import rectify as jrect
from orbslam3_cpp_fork_tpu_torch.datasets import tumvi as ttumvi
from orbslam3_cpp_fork_tpu_torch.ops import camera as tcam
from orbslam3_cpp_fork_tpu_torch.ops import image as timage
from orbslam3_cpp_fork_tpu_torch.utils import rectify as trect

TOL_CAM = 1e-5
TOL_REMAP = 1e-5
# TUM-VI's cam0 (Examples/Stereo-Inertial/TUM-VI.yaml).
KB8 = (190.978477, 190.973307, 254.931706, 256.897443, 0.003482, 0.000715, -0.002053, 0.000202)


def _cams():
    return tcam.Camera.kb8(*KB8), jcam.Camera.kb8(*KB8)


def _points(n=512, seed=0):
    """Camera-frame points up to ~80 degrees off axis, with the on-axis
    point and one behind the camera's plane."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0.0, 1.4, n)
    phi = rng.uniform(-np.pi, np.pi, n)
    z = rng.uniform(0.5, 8.0, n)
    r = np.tan(theta) * z
    X = np.stack([r * np.cos(phi), r * np.sin(phi), z], 1)
    X[0] = [0.0, 0.0, 2.0]
    X[1] = [1.0, 0.5, -0.2]
    return X.astype(np.float32)


def test_kb8_camera_matches_the_reference_fields():
    got, ref = _cams()
    assert got.kind == ref.kind == "kb8"
    assert (got.fx, got.fy, got.cx, got.cy) == tuple(float(v) for v in (ref.fx, ref.fy, ref.cx, ref.cy))
    assert got.dist == tuple(float(v) for v in np.asarray(ref.dist)), "tolerance: exact (f32)"
    s = got.scaled(0.5, 0.5)
    assert s.kind == "kb8" and s.dist == got.dist


def test_kb8_project_unproject_undistort():
    got, ref = _cams()
    X = _points()
    uv_r = np.asarray(jcam.project(ref, jnp.asarray(X)))
    uv_g = tcam.project(got, torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(uv_g, uv_r, rtol=0, atol=TOL_CAM * np.abs(uv_r).max())
    assert tuple(uv_g[0]) == (got.cx, got.cy), "an on-axis point lands on the principal point"
    uv = uv_r[2:].copy()
    b_r = np.asarray(jcam.unproject(ref, jnp.asarray(uv)))
    b_g = tcam.unproject(got, torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(b_g, b_r, rtol=TOL_CAM, atol=TOL_CAM)
    u_r = np.asarray(jcam.undistort_points(ref, jnp.asarray(uv)))
    u_g = tcam.undistort_points(got, torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(u_g, u_r, rtol=0, atol=TOL_CAM * np.abs(u_r).max())
    # The round trip recovers the bearing of every point inside 84 degrees.
    Xn = X[2:, :2] / X[2:, 2:]
    inside = np.linalg.norm(Xn, axis=1) < 9.0
    np.testing.assert_allclose(b_g[inside, :2], Xn[inside], rtol=1e-3, atol=1e-3)


def test_pinhole_paths_are_unchanged():
    """The KB8 branch leaves the pinhole model as it was: radtan
    projection and fixed-point undistortion against the reference."""
    d = (-0.28, 0.074, 1.8e-4, 1.5e-5, 0.0)
    got, ref = tcam.Camera.pinhole(458.0, 457.3, 367.2, 248.4, d), jcam.Camera.pinhole(458.0, 457.3, 367.2, 248.4, d)
    X = _points(seed=1)[2:]
    X = X[np.linalg.norm(X[:, :2] / X[:, 2:], axis=1) < 0.8]
    uv_r = np.asarray(jcam.project(ref, jnp.asarray(X)))
    np.testing.assert_allclose(tcam.project(got, torch.from_numpy(X)).numpy(), uv_r, rtol=0,
                               atol=TOL_CAM * np.abs(uv_r).max())
    u_r = np.asarray(jcam.undistort_points(ref, jnp.asarray(uv_r)))
    np.testing.assert_allclose(tcam.undistort_points(got, torch.from_numpy(uv_r.copy())).numpy(), u_r, rtol=0,
                               atol=TOL_CAM * np.abs(u_r).max())


def test_remap_bilinear():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (48, 64)).astype(np.float32)
    # Source coordinates inside, on the border and outside the image, and
    # exact integers (floor of an integer is itself).
    mx = rng.uniform(-3.0, 66.0, (40, 56)).astype(np.float32)
    my = rng.uniform(-3.0, 50.0, (40, 56)).astype(np.float32)
    mx[0, :8] = np.arange(8, dtype=np.float32)
    my[0, :8] = 5.0
    mx[1, :4] = [-1.0, -0.5, 63.0, 63.5]
    ref = np.asarray(jimage.remap_bilinear(jnp.asarray(img), jnp.asarray(mx), jnp.asarray(my)))
    got = timage.remap_bilinear(torch.from_numpy(img), torch.from_numpy(mx), torch.from_numpy(my)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL_REMAP * 255)
    assert np.array_equal(got[0, :8], img[5, :8]), "integer coordinates read the pixel itself"
    assert got[1, 0] == 0.0 and got[1, 3] == ref[1, 3], "out-of-bounds neighbours read 0"


@pytest.fixture(scope="module")
def rig():
    """The EuRoC-like rig of tests/test_rectify.py."""
    K1 = np.array([[458.0, 0, 367.2], [0, 457.3, 248.4], [0, 0, 1.0]])
    K2 = np.array([[457.6, 0, 379.9], [0, 456.1, 255.2], [0, 0, 1.0]])
    dist1 = np.array([-0.28, 0.074, 1.8e-4, 1.5e-5, 0.0])
    dist2 = np.array([-0.284, 0.076, -1.0e-4, 2.0e-5, 0.0])
    T = np.eye(4)
    T[:3, :3] = jrect._rodrigues_inv(np.array([0.004, -0.015, 0.008]))
    T[:3, 3] = [0.110, 0.0004, -0.0008]
    return K1, dist1, K2, dist2, T


def test_rectify_copy_equals_the_reference(rig):
    K1, dist1, K2, dist2, T = rig
    a = trect.stereo_rectify(K1, dist1, K2, dist2, T, (120, 188))
    b = jrect.stereo_rectify(K1, dist1, K2, dist2, T, (120, 188))
    for f in ("R1", "R2", "K_new", "baseline", "bf", "map1_x", "map1_y", "map2_x", "map2_y"):
        assert np.array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f))), f
    pts = np.random.default_rng(4).uniform(0, 180, (50, 2))
    assert np.array_equal(trect.rectify_points(pts, K1, dist1, a.R1, a.K_new),
                          jrect.rectify_points(pts, K1, dist1, b.R1, b.K_new))
    m_a = trect.init_undistort_rectify_map(K1, dist1, a.R1, a.K_new, (60, 94))
    m_b = jrect.init_undistort_rectify_map(K1, dist1, b.R1, b.K_new, (60, 94))
    assert all(np.array_equal(x, y) for x, y in zip(m_a, m_b))


def test_tumvi_calibration_is_kb8():
    a1, a2, Ta = ttumvi.default_cameras()
    b1, b2, Tb = jtumvi.default_cameras()
    for x, y in ((a1, b1), (a2, b2)):
        assert x.kind == y.kind == "kb8"
        assert (x.fx, x.fy, x.cx, x.cy) == tuple(float(v) for v in (y.fx, y.fy, y.cx, y.cy))
        assert x.dist == tuple(float(v) for v in np.asarray(y.dist))
    assert np.array_equal(Ta, Tb)
