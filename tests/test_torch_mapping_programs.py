"""Parity of the port's mapping device programs (runtime/tracker.py:
init and triangulation matching, new-landmark geometry, the batched
triangulation and fusion programs over a device keyframe store) with the
JAX reference on the CPU, on a small seeded store (K=6, N=300, L=256)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.ops import geometry as jg
from orbslam3_cpp_fork_tpu.runtime import tracker as jt
from orbslam3_cpp_fork_tpu.utils import lie as jlie
from orbslam3_cpp_fork_tpu_torch.runtime import tracker as tt

K_MAT = np.array([[420.0, 0.0, 320.0], [0.0, 415.0, 240.0], [0.0, 0.0, 1.0]], np.float32)
FX, FY, CX, CY, W, H = 420.0, 415.0, 320.0, 240.0, 640.0, 480.0
K_N, N_F, L_N = 6, 300, 256


def T(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def pack(bits):
    return np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little").view(np.uint32)


def store(seed, n_pts=260):
    """A small keyframe store: K_N views of n_pts points, N_F feature slots
    each (real observations first, then invalid padding, shuffled)."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2.5, 3.5, n_pts), rng.uniform(-1.5, 1.5, n_pts), rng.uniform(4, 8, n_pts)], 1)
    base_bits = rng.integers(0, 2, (n_pts, 256)).astype(np.int8)
    base_angle = rng.uniform(-np.pi, np.pi, n_pts)
    s = dict(
        desc=np.zeros((K_N, N_F, 8), np.uint32), xy=np.zeros((K_N, N_F, 2), np.float32),
        level=np.zeros((K_N, N_F), np.int32), angle=np.zeros((K_N, N_F), np.float32),
        valid=np.zeros((K_N, N_F), bool), depth=np.full((K_N, N_F), -1.0, np.float32),
        ur=np.full((K_N, N_F), -1.0, np.float32), pt=np.full((K_N, N_F), -1, np.int64),
    )
    Rs, ts = [], []
    for k in range(K_N):
        R = np.asarray(jlie.so3_exp(jnp.asarray([0.0, 0.03 * k, 0.01 * k], jnp.float32)))
        t = np.array([-0.35 * k, 0.03 * k, 0.0], np.float32)
        pc = X @ R.T + t
        uv = np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], 1)
        vis = np.nonzero((uv[:, 0] > 5) & (uv[:, 0] < W - 5) & (uv[:, 1] > 5) & (uv[:, 1] < H - 5))[0]
        vis = rng.permutation(vis)[: N_F - 20]
        slots = rng.permutation(N_F)[: len(vis)]
        bits = base_bits[vis].copy()
        for row in bits:
            row[rng.choice(256, 6, replace=False)] ^= 1
        dist = np.linalg.norm(pc[vis], axis=1)
        s["desc"][k, slots] = pack(bits)
        s["xy"][k, slots] = uv[vis] + rng.normal(0, 0.3, (len(vis), 2))
        s["level"][k, slots] = np.clip(np.round(np.log(8.5 / dist) / np.log(1.2)), 0, 7).astype(np.int32)
        s["angle"][k, slots] = base_angle[vis] + 0.02 * k + rng.normal(0, 0.02, len(vis))
        s["valid"][k, slots] = True
        s["pt"][k, slots] = vis
        Rs.append(R)
        ts.append(t)
    s["R"], s["t"], s["X"] = np.stack(Rs).astype(np.float32), np.stack(ts), X.astype(np.float32)
    return s


def torch_store(s):
    return dict(
        desc=torch.from_numpy(s["desc"].astype(np.int64)), xy=torch.from_numpy(s["xy"]),
        level=torch.from_numpy(s["level"]), angle=torch.from_numpy(s["angle"]),
        valid=torch.from_numpy(s["valid"]), depth=torch.from_numpy(s["depth"]), ur=torch.from_numpy(s["ur"]),
    )


def bits_of(s, k):
    return np.unpackbits(s["desc"][k].view(np.uint8), axis=-1, bitorder="little").astype(np.int8)


@pytest.mark.parametrize("seed", [0, 1])
def test_match_initialization_exact(seed):
    s = store(seed)
    a = (bits_of(s, 0), s["xy"][0], s["valid"][0], s["angle"][0], bits_of(s, 1), s["xy"][1], s["valid"][1], s["angle"][1])
    ri, ro = [np.asarray(v) for v in jt.match_initialization(*[jnp.asarray(x) for x in a])]
    gi, go = [v.numpy() for v in tt.match_initialization(*T(*a))]
    assert np.array_equal(go, ro) and np.array_equal(gi[ro], ri[ro]), "tolerance: exact"
    assert ro.sum() > 100
    assert np.mean(s["pt"][0][ro] == s["pt"][1][ri[ro]]) > 0.95, "matches pair the same 3D points"


@pytest.mark.parametrize("seed", [0, 1])
def test_match_triangulation_exact(seed):
    s = store(seed)
    F12 = np.asarray(jg.fundamental_from_poses(s["R"][0], s["t"][0], s["R"][2], s["t"][2], K_MAT, K_MAT))
    sig2 = (1.2 ** (2.0 * s["level"][2])).astype(np.float32)
    a = (bits_of(s, 0), s["xy"][0], s["valid"][0], s["angle"][0], bits_of(s, 2), s["xy"][2], s["valid"][2],
         s["angle"][2], sig2, F12.T.copy())
    ri, ro = [np.asarray(v) for v in jt.match_triangulation(*[jnp.asarray(x) for x in a])]
    gi, go = [v.numpy() for v in tt.match_triangulation(*T(*a))]
    assert np.array_equal(go, ro) and np.array_equal(gi[ro], ri[ro]), "tolerance: exact"
    assert ro.sum() > 80


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_triangulate_and_check(seed):
    s = store(seed)
    rng = np.random.default_rng(seed)
    # Pair slots of keyframe 0 with the slot of the same point in keyframe 3
    # (a wrong slot for every tenth).
    lut = {p: j for j, p in enumerate(s["pt"][3]) if p >= 0}
    idx = np.array([lut.get(p, 0) for p in s["pt"][0]])
    valid = np.array([p in lut for p in s["pt"][0]])
    wrong = rng.uniform(size=N_F) < 0.1
    idx[wrong] = rng.integers(0, N_F, int(wrong.sum()))
    l1, l2 = s["level"][0], s["level"][3][idx]
    a = (
        s["R"][0], s["t"][0], s["R"][3], s["t"][3], K_MAT, s["xy"][0], s["xy"][3][idx],
        (1.2 ** (2.0 * l1)).astype(np.float32), (1.2 ** (2.0 * l2)).astype(np.float32),
        s["depth"][0], s["depth"][3][idx], s["ur"][0], s["ur"][3][idx],
    )
    oct_ratio = (1.2 ** (l1 - l2).astype(np.float32)).astype(np.float32)
    rX, rg = [np.asarray(v) for v in jt.triangulate_and_check(*[jnp.asarray(x) for x in a], jnp.float32(0.0), jnp.asarray(oct_ratio), jnp.asarray(valid))]
    gX, gg = [v.numpy() for v in tt.triangulate_and_check(*T(*a), 0.0, *T(oct_ratio, valid))]
    assert np.mean(gg == rg) >= 0.99, "tolerance: good equal away from the thresholds (>= 99% of slots)"
    both = gg & rg
    assert both.sum() > 100
    assert np.abs(gX[both] - rX[both]).max() <= 1e-4 * np.abs(rX[both]).max(), "tolerance: X 1e-4 relative"
    true = s["X"][s["pt"][0][both]]
    assert np.median(np.linalg.norm(gX[both] - true, axis=1)) < 0.1


def _tri_args(s, k1, arr, pair_ok, rng):
    free1 = s["valid"][k1] & (rng.uniform(size=N_F) < 0.8)
    free2 = s["valid"][arr] & (rng.uniform(size=(len(arr), N_F)) < 0.8)
    return free1, free2


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_triangulate_store(seed):
    s = store(seed)
    rng = np.random.default_rng(seed)
    k1, arr = 5, np.array([4, 3, 1, 4])  # the last pair is padding (pair_ok False)
    pair_ok = np.array([True, True, True, False])
    free1, free2 = _tri_args(s, k1, arr, pair_ok, rng)
    ref = jt.fused_triangulate_store(
        *[jnp.asarray(s[k]) for k in ("desc", "xy", "level", "angle", "depth", "ur")],
        jnp.int32(k1), jnp.asarray(arr, jnp.int32),
        jnp.asarray(s["R"][k1]), jnp.asarray(s["t"][k1]), jnp.asarray(s["R"][arr]), jnp.asarray(s["t"][arr]),
        jnp.asarray(free1), jnp.asarray(free2), jnp.asarray(pair_ok), jnp.asarray(K_MAT), jnp.float32(0.0),
    )
    ts_ = torch_store(s)
    got = tt.fused_triangulate_store(
        *[ts_[k] for k in ("desc", "xy", "level", "angle", "depth", "ur")],
        k1, torch.from_numpy(arr),
        *T(s["R"][k1], s["t"][k1], s["R"][arr], s["t"][arr], free1, free2, pair_ok, K_MAT), 0.0,
    )
    rf1, rf2, rX, rn = [np.asarray(v) for v in ref]
    gf1, gf2, gX, gn = [v.numpy() for v in got]
    assert gf1.shape == rf1.shape == (4, N_F) and gf1.dtype == np.int32
    assert np.array_equal(gn, rn), "match counts equal"
    assert np.array_equal(gf1, rf1), "tolerance: compacted rows equal, in order"
    keep = rf1 >= 0
    assert np.array_equal(gf2[keep], rf2[keep])
    for j, tol in ((0, 3e-4), (1, 1e-4), (2, 1e-4)):
        # Pair 0 is the adjacent keyframe: over that short baseline the 3x3
        # normal equations of the triangulation are ill-conditioned in f32.
        err = np.abs(gX[j][keep[j]] - rX[j][keep[j]]).max()
        assert err <= tol * np.abs(rX[j][keep[j]]).max(), f"tolerance: X {tol} relative for pair {j}"
    assert keep[:3].sum(1).min() > 30 and keep[3].sum() == 0 and rn[3] == 0
    # Accepted rows come first, in feature order.
    for row in gf1:
        n = int((row >= 0).sum())
        assert (row[:n] >= 0).all() and (np.diff(row[:n]) > 0).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_fuse_store(seed):
    s = store(seed)
    rng = np.random.default_rng(seed)
    n_lm = 230
    pts = rng.permutation(len(s["X"]))[:n_lm]
    geom = np.zeros((L_N, 8), np.float32)
    c0 = -s["R"][2].T @ s["t"][2]
    d = s["X"][pts] - c0
    dist = np.linalg.norm(d, axis=1)
    geom[:n_lm, 0:3] = s["X"][pts] + rng.normal(0, 0.01, (n_lm, 3))
    geom[:n_lm, 3:6] = d / dist[:, None]
    geom[:n_lm, 6] = dist / 1.2**4
    geom[:n_lm, 7] = dist * 1.2**3
    geom[n_lm:, 7] = 1.0
    lm_desc = np.zeros((L_N, 8), np.uint32)
    for i, p in enumerate(pts):
        k = int(rng.integers(0, K_N))
        j = np.nonzero(s["pt"][k] == p)[0]
        lm_desc[i] = s["desc"][k, j[0]] if len(j) else rng.integers(0, 2**32, 8, dtype=np.uint64).astype(np.uint32)
    lm_valid = np.zeros(L_N, bool)
    lm_valid[:n_lm] = rng.uniform(size=n_lm) < 0.95
    cur_mask = np.zeros(L_N, bool)
    cur_mask[:n_lm] = rng.uniform(size=n_lm) < 0.6
    fuse_mask = np.zeros(L_N, bool)
    fuse_mask[:n_lm] = rng.uniform(size=n_lm) < 0.7
    arr = np.array([0, 1, 3, 5, 0, 0])
    is_last = np.array([False, False, False, True, False, False])
    ref = jt.fused_fuse_store(
        jnp.asarray(geom), jnp.asarray(lm_desc), jnp.asarray(lm_valid), jnp.asarray(cur_mask), jnp.asarray(fuse_mask),
        jnp.asarray(is_last), *[jnp.asarray(s[k]) for k in ("desc", "xy", "level", "valid")],
        jnp.asarray(arr, jnp.int32), jnp.asarray(s["R"][arr]), jnp.asarray(s["t"][arr]), FX, FY, CX, CY, W, H,
    )
    ts_ = torch_store(s)
    got = tt.fused_fuse_store(
        *T(geom, lm_desc.astype(np.int64), lm_valid, cur_mask, fuse_mask, is_last),
        *[ts_[k] for k in ("desc", "xy", "level", "valid")],
        torch.from_numpy(arr), *T(s["R"][arr], s["t"][arr]), FX, FY, CX, CY, W, H,
    )
    rl, rf = [np.asarray(v) for v in ref]
    gl, gf = [v.numpy() for v in got]
    assert gl.shape == rl.shape == (6, L_N)
    assert np.array_equal(gl, rl), "tolerance: compacted landmark slots equal, in order"
    keep = rl >= 0
    assert np.array_equal(gf[keep], rf[keep]), "matched features equal"
    assert keep[:4].sum(1).min() > 20
    # The last real row projects the `fuse_mask` subset, the others `cur_mask`.
    assert fuse_mask[rl[3][keep[3]]].all() and cur_mask[rl[0][keep[0]]].all()
    # Matches bind a landmark to the feature of the same 3D point.
    same = [s["pt"][arr[j]][gf[j][keep[j]]] == pts[gl[j][keep[j]]] for j in range(4)]
    assert np.mean(np.concatenate(same)) > 0.9


def test_unpack_desc_and_scale_table():
    rng = np.random.default_rng(0)
    w = rng.integers(0, 2**32, (3, 5, 8), dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(jt._unpack_desc(jnp.asarray(w)))
    got = tt._unpack_desc(torch.from_numpy(w.astype(np.int64))).numpy()
    assert got.dtype == np.int8 and np.array_equal(got, ref), "tolerance: exact"
    k = torch.arange(-14, 15)
    ref_p = np.asarray(jnp.float32(1.2) ** jnp.arange(-14, 15).astype(jnp.float32))
    assert np.abs(tt._scale_pow(k).numpy() - ref_p).max() <= 2e-6 * ref_p.max(), "tolerance: 1 ulp of f32 pow"
