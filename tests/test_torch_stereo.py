"""Stereo correspondence (ops/stereo.py) against the JAX reference, and the
port's own gates of tests/test_stereo.py and tests/test_fisheye_stereo.py.

Both sides get the same features: the reference's ORB arrays of a rendered
rectified pair (uint8 frames, `make_scene(seed=5)` at 320x240, baseline 0.2
m) as numpy. Tolerances: `match_stereo_coarse` indices and mask exact;
`subpixel_refine` ur within 1e-4 px and mask exact (on integer images every
SAD sum is exact, so no near-tie can flip; on the float renders the
mismatches allowed are the near-ties, counted and named);
`median_outlier_cut` exact; `compute_stereo_matches` ur/depth 1e-4
relative, mask exact; `depth_to_stereo` exact; `match_stereo_fisheye`
mask exact, depth 1e-4 relative on the median and 1e-3 on every point: the
f32 DLT of a 10 cm fisheye baseline is conditioned no better (the test
prints how far either side's depths lie from the float64 solution of the
same rays).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.datasets import tumvi as jtumvi
from orbslam3_cpp_fork_tpu.ops import camera as jcam
from orbslam3_cpp_fork_tpu.ops import stereo as jst
from orbslam3_cpp_fork_tpu.ops.orb import OrbParams as JOrbParams
from orbslam3_cpp_fork_tpu.ops.orb import extract_orb_jit
from orbslam3_cpp_fork_tpu_torch.datasets import synthetic
from orbslam3_cpp_fork_tpu_torch.datasets import tumvi as ttumvi
from orbslam3_cpp_fork_tpu_torch.ops import camera as tcam
from orbslam3_cpp_fork_tpu_torch.ops import stereo as tst

BASELINE = 0.2
W, H, FX = 320, 240, 200.0
N_FEAT = 400
TOL_UR = 1e-4
TOL_REL = 1e-4
TOL_FISHEYE_DLT = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(x):
    return torch.from_numpy(np.array(x))


def _feats(img):
    f = extract_orb_jit(jnp.asarray(img, jnp.float32), JOrbParams(n_features=N_FEAT))
    return dict(bits=np.asarray(f.desc_i8), xy=np.asarray(f.xy), level=np.asarray(f.level), valid=np.asarray(f.valid))


@pytest.fixture(scope="module")
def pair():
    """A rectified pair (float renders and their uint8 frames) with the
    reference's features of the uint8 frames."""
    scene = synthetic.make_scene(seed=5, n_points=1500, width=W, height=H, fx=FX)
    R, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    img_l = synthetic.render_frame(scene, R, t)
    img_r = synthetic.render_frame(scene, *synthetic.stereo_right_pose(R, t, BASELINE))
    u8_l, u8_r = (synthetic.to_u8(i).astype(np.float32) for i in (img_l, img_r))
    return dict(img=(img_l, img_r), u8=(u8_l, u8_r), fl=_feats(u8_l), fr=_feats(u8_r), bf=BASELINE * FX,
                depth=synthetic.render_depth(scene, R, t))


def _args(fl, fr, torch_side):
    conv = T if torch_side else jnp.asarray
    return [conv(fl[k]) for k in ("bits", "xy", "level", "valid")] + [conv(fr[k]) for k in ("bits", "xy", "level", "valid")]


def _coarse(pair):
    max_disp = tst.max_disparity(pair["bf"], BASELINE)
    ref = jst.match_stereo_coarse(*_args(pair["fl"], pair["fr"], False), jnp.float32(0.0), jnp.float32(max_disp))
    got = tst.match_stereo_coarse(*_args(pair["fl"], pair["fr"], True), 0.0, max_disp)
    return [np.asarray(x) for x in ref], [x.numpy() for x in got]


def test_match_stereo_coarse(pair):
    (ir, okr), (ig, okg) = _coarse(pair)
    assert okr.sum() > 100
    assert np.array_equal(ig, ir) and np.array_equal(okg, okr), "tolerance: exact"


@pytest.mark.parametrize("images", ["u8", "img"])
def test_subpixel_refine(pair, images):
    (ir, okr), _ = _coarse(pair)
    il, irr = pair[images]
    xy_l, ur0 = pair["fl"]["xy"], pair["fr"]["xy"][ir, 0]
    ref = [np.asarray(x) for x in jst.subpixel_refine(jnp.asarray(il), jnp.asarray(irr), jnp.asarray(xy_l),
                                                      jnp.asarray(ur0), jnp.asarray(okr))]
    got = [x.numpy() for x in tst.subpixel_refine(T(il), T(irr), T(xy_l), T(ur0), T(okr))]
    (ur_r, sad_r, ok_r), (ur_g, sad_g, ok_g) = ref, got
    assert ok_r.sum() > 100
    both = ok_r & ok_g
    assert np.abs(ur_g[both] - ur_r[both]).max() <= TOL_UR, "tolerance: ur 1e-4 px"
    if images == "u8":
        assert np.array_equal(ok_g, ok_r) and np.array_equal(sad_g, sad_r), "integer images: mask and SAD exact"
        return
    # Float renders: the SAD sums round differently; a mask may differ only
    # where the reference's own sums nearly tie (the edge test best == ctr
    # or the parabola's |delta| < 1 sits on a rounding boundary).
    diff = np.nonzero(ok_g != ok_r)[0]
    print(f"float renders: {len(diff)} mask differences of {okr.sum()} coarse matches: {diff.tolist()}")
    assert np.allclose(sad_g[okr], sad_r[okr], rtol=1e-5, atol=1e-3)
    assert len(diff) <= 2, diff


def test_median_outlier_cut():
    rng = np.random.default_rng(0)
    cases = []
    for n_ok in (0, 1, 2, 7, 200, 399):
        sad = rng.uniform(0, 400, 400).astype(np.float32)
        sad[:40] = np.round(sad[:40])  # ties
        ok = np.zeros(400, bool)
        ok[rng.choice(400, n_ok, replace=False)] = True
        cases.append((np.where(ok, sad, np.inf).astype(np.float32), ok))
    sad = np.zeros(64, np.float32)  # near-zero median: the 1.0 floor
    sad[:3] = [0.5, 1.0, 1.5]
    cases.append((sad, np.ones(64, bool)))
    for sad, ok in cases:
        ref = np.asarray(jst.median_outlier_cut(jnp.asarray(sad), jnp.asarray(ok)))
        got = tst.median_outlier_cut(T(sad), T(ok)).numpy()
        assert np.array_equal(got, ref), f"tolerance: exact (n_ok {ok.sum()})"
    assert got[:2].all() and not got[2], "the threshold's floor is 1.0"


def _full(pair, images="u8"):
    il, irr = pair[images]
    ref = jst.compute_stereo_matches(jnp.asarray(il), jnp.asarray(irr), *_args(pair["fl"], pair["fr"], False),
                                     jnp.float32(pair["bf"]), jnp.float32(BASELINE))
    got = tst.compute_stereo_matches(T(il), T(irr), *_args(pair["fl"], pair["fr"], True), pair["bf"], BASELINE)
    return [np.asarray(x) for x in ref], [x.numpy() for x in got]


def test_compute_stereo_matches(pair):
    (ur_r, d_r, ok_r), (ur_g, d_g, ok_g) = _full(pair)
    assert ok_r.sum() > 100 and np.array_equal(ok_g, ok_r), "mask exact"
    np.testing.assert_allclose(ur_g, ur_r, rtol=TOL_REL, atol=0)
    np.testing.assert_allclose(d_g, d_r, rtol=TOL_REL, atol=0)
    assert (ur_g[~ok_g] == -1).all() and (d_g[~ok_g] == -1).all()


def test_stereo_match_depth():
    """tests/test_stereo.py::test_stereo_match_depth on the port, from its
    own features: metric depth against the rasterized depth at each matched
    keypoint. The test's 640x480 scene cropped to 320x240 at its own focal
    length (400 px, the same disparity per metre), 400 features."""
    from orbslam3_cpp_fork_tpu_torch.ops.orb import OrbParams, extract_orb

    scene = synthetic.make_scene(seed=5, n_points=1500, width=W, height=H, fx=400.0)
    R, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    img_l = synthetic.render_frame(scene, R, t)
    img_r = synthetic.render_frame(scene, *synthetic.stereo_right_pose(R, t, BASELINE))
    fl, fr = (extract_orb(T(i), OrbParams(n_features=N_FEAT)) for i in (img_l, img_r))
    _, depth, ok = tst.compute_stereo_matches(T(img_l), T(img_r), fl.desc_i8, fl.xy, fl.level, fl.valid, fr.desc_i8,
                                              fr.xy, fr.level, fr.valid, BASELINE * float(scene.K[0, 0]), BASELINE)
    ok, depth, xy = ok.numpy(), depth.numpy(), fl.xy.numpy()
    assert ok.sum() > 100, ok.sum()
    sel = np.nonzero(ok)[0]
    dep = synthetic.render_depth(scene, R, t)
    z_gt = dep[np.clip(np.round(xy[sel, 1]).astype(int), 0, scene.height - 1),
               np.clip(np.round(xy[sel, 0]).astype(int), 0, scene.width - 1)]
    has = z_gt > 0
    rel = np.abs(depth[sel[has]] - z_gt[has]) / z_gt[has]
    assert np.median(rel) < 0.05 and (rel < 0.10).mean() > 0.8, (np.median(rel), (rel < 0.10).mean())


def test_depth_to_stereo_and_round_half_to_even(pair):
    dep = pair["depth"].copy()
    dep[::7] = 0.0  # holes
    xy = pair["fl"]["xy"].copy()
    # Keypoints at x.5 / y.5: jnp.round and torch.round both round half to
    # even (2.5 -> 2, 3.5 -> 4).
    xy[:4] = [[2.5, 3.5], [3.5, 2.5], [100.5, 50.5], [W - 0.5, H - 0.5]]
    dep[4, 2], dep[2, 4], dep[50, 100] = 7.0, 3.0, 5.0
    bf, factor = pair["bf"], 1.0 / 5000.0
    dep_raw = dep * 5000.0
    ref = [np.asarray(x) for x in jst.depth_to_stereo(jnp.asarray(dep_raw), jnp.asarray(xy), jnp.float32(bf), jnp.float32(factor))]
    got = [x.numpy() for x in tst.depth_to_stereo(T(dep_raw), T(xy), bf, factor)]
    for a, b in zip(got, ref):
        assert np.array_equal(a, b), "tolerance: exact"
    assert got[1][0] == np.float32(7.0 * 5000.0) * np.float32(factor) and got[2][:3].all()
    assert torch.round(torch.tensor([2.5, 3.5])).tolist() == [2.0, 4.0]


# ----------------------------------------------------------------- fisheye


def _rig(mod):
    cam1, cam2, T12 = mod.default_cameras()
    R_rl = T12[:3, :3].T
    return cam1, cam2, R_rl.astype(np.float32), (-R_rl @ T12[:3, 3]).astype(np.float32)


def _fisheye_features(n, seed=0):
    """Points in front of both cameras inside their shared field of view,
    with random descriptors; the right features shuffled."""
    rng = np.random.default_rng(seed)
    theta, phi, z = rng.uniform(0.0, 0.9, n), rng.uniform(-np.pi, np.pi, n), rng.uniform(1.0, 8.0, n)
    r = np.tan(theta) * z
    X = np.stack([r * np.cos(phi), r * np.sin(phi), z], 1).astype(np.float32)
    bits = rng.integers(0, 2, (n, 256)).astype(np.int8)
    cam1, cam2, R_rl, t_rl = _rig(jtumvi)
    uv_l = np.asarray(jcam.project(cam1, jnp.asarray(X)))
    Xr = X @ R_rl.T + t_rl
    uv_r = np.asarray(jcam.project(cam2, jnp.asarray(Xr)))
    inside = (uv_l > 8).all(1) & (uv_l < 504).all(1) & (uv_r > 8).all(1) & (uv_r < 504).all(1) & (Xr[:, 2] > 0.1)
    perm = np.random.default_rng(seed + 1).permutation(n)
    lvl = (np.arange(n) % 3).astype(np.int32)
    return X, dict(bits=bits, xy=uv_l, level=lvl, valid=inside), dict(bits=bits[perm], xy=uv_r[perm], level=lvl[perm],
                                                                         valid=inside[perm])


def _fisheye(fl, fr, lap=(0.0, 512.0)):
    j1, j2, R, t = _rig(jtumvi)
    c1, c2, _, _ = _rig(ttumvi)
    ref = jst.match_stereo_fisheye(*_args(fl, fr, False), j1, j2, jnp.asarray(R), jnp.asarray(t),
                                   jnp.float32(lap[0]), jnp.float32(lap[1]))
    got = tst.match_stereo_fisheye(*_args(fl, fr, True), c1, c2, T(R), T(t), lap[0], lap[1])
    return [np.asarray(x) for x in ref], [x.numpy() for x in got]


def test_match_stereo_fisheye_parity():
    from orbslam3_cpp_fork_tpu_torch.ops import geometry

    _, fl, fr = _fisheye_features(256)
    for lap in ((0.0, 512.0), (100.0, 400.0)):
        (d_r, ray_r, ok_r), (d_g, ray_g, ok_g) = _fisheye(fl, fr, lap)
        assert ok_r.sum() > 50 and np.array_equal(ok_g, ok_r), "mask exact"
        rel = np.abs(d_g - d_r) / np.abs(d_r)
        assert np.median(rel[ok_r]) <= TOL_REL and rel.max() <= TOL_FISHEYE_DLT, (np.median(rel[ok_r]), rel.max())
        np.testing.assert_allclose(ray_g, ray_r, rtol=0, atol=1e-5)
    # The DLT's conditioning: the same rays of the matched pairs
    # triangulated in float64 (the port's DLT), against either side's f32.
    _, c2, R, t = _rig(ttumvi)
    ray_r2 = tcam.unproject(c2, T(fr["xy"])).double()
    ray_r2 = ray_r2 / torch.linalg.vector_norm(ray_r2, dim=-1, keepdim=True)
    perm = np.random.default_rng(1).permutation(256)
    inv = np.argsort(perm)  # right feature of each left one (the shuffle of _fisheye_features)
    x1 = torch.from_numpy(ray_g[:, :2] / ray_g[:, 2:3]).double()
    x2 = (ray_r2[:, :2] / ray_r2[:, 2:3])[torch.from_numpy(inv)]
    P1 = torch.cat([torch.eye(3), torch.zeros(3, 1)], 1).double().expand(256, 3, 4)
    P2 = torch.cat([T(R), T(t)[:, None]], 1).double().expand(256, 3, 4)
    z64 = geometry.triangulate_dlt(P1, P2, x1, x2)[:, 2].numpy()
    sel = ok_r  # the accepted matches of the last lapping area: true correspondences
    dev_r, dev_g = (float(np.max(np.abs(d[sel] - z64[sel]) / z64[sel])) for d in (d_r, d_g))
    print(f"fisheye DLT against float64: reference {dev_r:.2e}, port {dev_g:.2e} (relative, {sel.sum()} points)")
    assert max(dev_r, dev_g) <= TOL_FISHEYE_DLT


def test_fisheye_stereo_depth_recovery():
    """tests/test_fisheye_stereo.py's gates on the port."""
    X, fl, fr = _fisheye_features(256)
    _, (depth, _, ok) = _fisheye(fl, fr)
    enough = fl["valid"] & (X[:, 2] < 4.0)
    assert ok[enough].mean() > 0.8, (ok[enough].sum(), enough.sum())
    rel = np.abs(depth[ok] - X[ok, 2]) / X[ok, 2]
    assert np.median(rel) < 0.02 and (depth[ok] > 0).all()


def test_fisheye_stereo_rejects_unmatched():
    _, fl, _ = _fisheye_features(128, seed=2)
    fr = dict(fl, bits=np.random.default_rng(3).integers(0, 2, (128, 256)).astype(np.int8))
    fl = dict(fl, valid=np.ones(128, bool))
    fr["valid"] = fl["valid"]
    _, (_, _, ok) = _fisheye(fl, fr)
    assert int(ok.sum()) == 0


def test_kb8_undistort_to_pinhole_plane():
    cam1 = ttumvi.default_cameras()[0]
    rng = np.random.default_rng(0)
    X = np.stack([rng.uniform(-1, 1, 64), rng.uniform(-1, 1, 64), np.ones(64)], 1).astype(np.float32)
    X = X * rng.uniform(2, 6, (64, 1)).astype(np.float32)
    ud = tcam.undistort_points(cam1, tcam.project(cam1, T(X))).numpy()
    assert np.allclose(ud[:, 0], cam1.fx * X[:, 0] / X[:, 2] + cam1.cx, atol=0.1)
    assert np.allclose(ud[:, 1], cam1.fy * X[:, 1] / X[:, 2] + cam1.cy, atol=0.1)
