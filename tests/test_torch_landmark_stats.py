"""The port's vectorized MapPoint statistics (`MapState.update_landmark_stats`:
ComputeDistinctiveDescriptors + UpdateNormalAndDepth) against
tests/test_landmark_stats.py's per-landmark `_reference_stats` and against
the reference MapState on the same random map. Tolerances: descriptor and
level exact; normal 1e-5; distance band 1e-5 relative; the reference
MapState's outputs equal the port's (normal and band within 1e-6).
"""

import numpy as np

from orbslam3_cpp_fork_tpu.models.map_state import MapConfig as JConfig, MapState as JMapState
from orbslam3_cpp_fork_tpu_torch.models.map_state import N_LEVELS, SCALE_FACTOR, MapConfig, MapState


def _reference_stats(m, lm):
    """tests/test_landmark_stats.py's straightforward per-landmark version."""
    ks = np.nonzero(m.obs[:, lm])[0]
    descs, dirs = [], []
    for k in ks:
        f = np.nonzero(m.kf_lm_idx[k] == lm)[0]
        if len(f) == 0:
            continue
        descs.append(m.kf_desc[k, f[0]])
        d = m.lm_pos[lm] - (-m.kf_R[k].T @ m.kf_t[k])
        dirs.append(d / max(np.linalg.norm(d), 1e-9))
    D = np.array(descs)
    dist = np.unpackbits((D[:, None, :] ^ D[None, :, :]).view(np.uint8), axis=-1).sum(-1)
    med = np.sort(dist, axis=1)[:, (dist.shape[1] - 1) // 2]  # the lower-middle median
    normal = np.mean(dirs, axis=0)
    normal = normal / max(np.linalg.norm(normal), 1e-9)
    k_ref = ks[-1]
    lvl = int(m.kf_level[k_ref, np.nonzero(m.kf_lm_idx[k_ref] == lm)[0][0]])
    dist_ref = np.linalg.norm(m.lm_pos[lm] - (-m.kf_R[k_ref].T @ m.kf_t[k_ref]))
    return (D[int(np.argmin(med))], normal, lvl, dist_ref * SCALE_FACTOR**lvl * 1.2,
            dist_ref * SCALE_FACTOR ** (lvl - N_LEVELS + 1) / 1.2)


def _fill(m, seed=0):
    rng = np.random.default_rng(seed)
    n_lm, nf = 60, 32
    ids = m.add_landmarks(
        pos=rng.uniform(-3, 3, (n_lm, 3)).astype(np.float32),
        desc_packed=rng.integers(0, 2**32, (n_lm, 8), dtype=np.uint32),
        desc_i8=np.zeros((n_lm, 256), np.int8), first_kf=0, level=np.zeros(n_lm, np.int32),
        normal=np.tile(np.array([0, 0, 1], np.float32), (n_lm, 1)),
        min_dist=np.full(n_lm, 0.1, np.float32), max_dist=np.full(n_lm, 10.0, np.float32),
    )
    for k in range(8):
        take = rng.permutation(n_lm)[:nf]
        m.add_keyframe(
            R=np.eye(3, dtype=np.float32), t=rng.normal(0, 1, 3).astype(np.float32),
            xy=rng.uniform(0, 100, (nf, 2)).astype(np.float32),
            level=rng.integers(0, N_LEVELS, nf).astype(np.int32), angle=np.zeros(nf, np.float32),
            desc_packed=rng.integers(0, 2**32, (nf, 8), dtype=np.uint32), feat_valid=np.ones(nf, bool),
            lm_idx=ids[take].astype(np.int32), timestamp=float(k), frame_id=k,
        )
    return ids


def test_vectorized_stats_match_reference():
    cfg = dict(max_keyframes=16, max_landmarks=128, n_features=32)
    m, r = MapState(MapConfig(**cfg)), JMapState(JConfig(**cfg))
    ids, ids_r = _fill(m), _fill(r)
    assert np.array_equal(ids, ids_r)
    expect = {int(lm): _reference_stats(m, lm) for lm in ids if m.obs[:, lm].any()}
    assert len(expect) > 40
    m.update_landmark_stats(ids)
    r.update_landmark_stats(ids_r)
    for lm, (desc, normal, lvl, maxd, mind) in expect.items():
        np.testing.assert_array_equal(m.lm_desc[lm], desc)
        np.testing.assert_allclose(m.lm_normal[lm], normal, atol=1e-5)
        assert m.lm_level[lm] == lvl
        np.testing.assert_allclose(m.lm_max_dist[lm], maxd, rtol=1e-5)
        np.testing.assert_allclose(m.lm_min_dist[lm], mind, rtol=1e-5)
    for f in ("lm_desc", "lm_level"):
        assert np.array_equal(getattr(m, f), getattr(r, f)), f
    for f in ("lm_normal", "lm_max_dist", "lm_min_dist"):
        np.testing.assert_allclose(getattr(m, f), getattr(r, f), rtol=1e-6, atol=1e-6, err_msg=f)
