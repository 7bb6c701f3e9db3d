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


# tests/test_camera.py's six cases on the port, each also held against the
# reference on the same points. Tolerances: round trips as the reference
# test's bars; Jacobians against torch autodiff and against the reference,
# pinhole 1e-6 relative, KB8 1e-4 relative (of the largest entry).
TOL_JAC_PINHOLE = 1e-6
TOL_JAC_KB8 = 1e-4


def _rand_points(seed, n=256, zmin=0.5, zmax=10.0, spread=0.6):
    rng = np.random.default_rng(seed)
    z = rng.uniform(zmin, zmax, size=(n, 1))
    xy = rng.uniform(-spread, spread, size=(n, 2)) * z
    return np.concatenate([xy, z], axis=1).astype(np.float32)


EUROC = (458.654, 457.296, 367.215, 248.375, (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0))
TUMVI = (190.97847715128717, 190.9733070521226, 254.93170605935475, 256.8974428996504,
         0.0034823894022493434, 0.0007150348452162257, -0.0020532361418706202, 0.00020293673591811182)


def _pinhole(*args):
    return tcam.Camera.pinhole(*args), jcam.Camera.pinhole(*args)


def test_pinhole_ideal_roundtrip():
    got, ref = _pinhole(458.0, 457.0, 367.0, 248.0)
    pc = _rand_points(10)
    uv = tcam.project(got, torch.from_numpy(pc))
    np.testing.assert_allclose(uv.numpy(), np.asarray(jcam.project(ref, jnp.asarray(pc))), rtol=TOL_CAM, atol=0)
    b = tcam.unproject(got, uv).numpy()
    np.testing.assert_allclose(b[..., :2], pc[..., :2] / pc[..., 2:3], atol=1e-5)
    assert np.array_equal(got.K.numpy(), np.asarray(ref.K)), "tolerance: exact K"
    assert got.K.dtype == torch.float32 and got.K.shape == (3, 3)


def test_pinhole_radtan_roundtrip():
    got, ref = _pinhole(*EUROC)
    pc = _rand_points(11, spread=0.5)
    uv = tcam.project(got, torch.from_numpy(pc))
    b = tcam.unproject(got, uv).numpy()
    b_ref = np.asarray(jcam.unproject(ref, jcam.project(ref, jnp.asarray(pc))))
    np.testing.assert_allclose(b, b_ref, rtol=0, atol=TOL_CAM)
    np.testing.assert_allclose(b[..., :2], pc[..., :2] / pc[..., 2:3], atol=1e-4)


def test_undistort_points_ideal_reproject():
    got, ref = _pinhole(*EUROC)
    pc = torch.from_numpy(_rand_points(12, spread=0.4))
    uv_ideal = tcam.undistort_points(got, tcam.project(got, pc))
    np.testing.assert_allclose(uv_ideal.numpy(), tcam.project(got, pc, distort=False).numpy(), atol=0.05)
    u_ref = np.asarray(jcam.undistort_points(ref, jcam.project(ref, jnp.asarray(pc.numpy()))))
    np.testing.assert_allclose(uv_ideal.numpy(), u_ref, rtol=0, atol=TOL_CAM * np.abs(u_ref).max())


def test_kb8_roundtrip():
    got = tcam.Camera.kb8(*TUMVI)
    pc = _rand_points(13, spread=1.5)
    b = tcam.unproject(got, tcam.project(got, torch.from_numpy(pc))).numpy()
    dir_ref = pc / np.linalg.norm(pc, axis=-1, keepdims=True)
    np.testing.assert_allclose(b / np.linalg.norm(b, axis=-1, keepdims=True), dir_ref, atol=1e-4)


def _jacobians(got, ref, pc, distort):
    J = tcam.project_jacobian(got, torch.from_numpy(pc)).numpy()
    J_ad = torch.func.vmap(torch.func.jacfwd(lambda p: tcam.project(got, p[None], distort=distort)[0]))(
        torch.from_numpy(pc)).numpy()
    J_ref = np.asarray(jcam.project_jacobian(ref, jnp.asarray(pc)))
    assert J.shape == J_ref.shape == (len(pc), 2, 3) and J.dtype == np.float32
    return J, J_ad, J_ref


def test_pinhole_jacobian_matches_autodiff():
    got, ref = _pinhole(458.0, 457.0, 367.0, 248.0)
    pc = _rand_points(14, 16)
    J, J_ad, J_ref = _jacobians(got, ref, pc, distort=False)
    np.testing.assert_allclose(J, J_ad, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(J, J_ref, rtol=0, atol=TOL_JAC_PINHOLE * np.abs(J_ref).max())
    # A batch of any leading shape.
    J2 = tcam.project_jacobian(got, torch.from_numpy(pc.reshape(4, 4, 3))).numpy()
    assert np.array_equal(J2.reshape(16, 2, 3), J)


def test_kb8_jacobian_matches_autodiff():
    got, ref = tcam.Camera.kb8(*TUMVI), jcam.Camera.kb8(*TUMVI)
    pc = _rand_points(15, 16, spread=1.0)
    J, J_ad, J_ref = _jacobians(got, ref, pc, distort=True)
    np.testing.assert_allclose(J, J_ad, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(J, J_ref, rtol=0, atol=TOL_JAC_KB8 * np.abs(J_ref).max())
