"""The port's native map graph (native/mapgraph.cpp and its ctypes loader)
against the reference's and a dense-numpy model: the six cases of
tests/test_native_mapgraph.py, each driven through the port's graph and the
reference's with the same operations (answers equal, exactly), and
`MapState`'s covisibility through the native graph and through the numpy
fallback that `native.load()` returning None selects.
"""

import numpy as np
import pytest

from orbslam3_cpp_fork_tpu import native as jnative
from orbslam3_cpp_fork_tpu_torch import native as tnative


@pytest.fixture(scope="module")
def lib_available():
    if tnative.load() is None or jnative.load() is None:
        pytest.skip("no native toolchain")


class Both:
    """The port's and the reference's MapGraph, driven together; every
    query is answered by both and must agree exactly."""

    def __init__(self, K, L):
        self.g = [tnative.MapGraph(K, L), jnative.MapGraph(K, L)]

    def __getattr__(self, name):
        def call(*args):
            out = [getattr(g, name)(*args) for g in self.g]
            a, b = (np.asarray(o) if o is not None else None for o in out)
            assert (a is None and b is None) or np.array_equal(a, b), (name, args, out)
            return out[0]

        return call


def _dense_weights(obs):
    w = obs.astype(np.int32) @ obs.astype(np.int32).T
    np.fill_diagonal(w, 0)
    return w


def test_incremental_covisibility_matches_dense(lib_available):
    rng = np.random.default_rng(0)
    K, L = 24, 400
    g = Both(K, L)
    obs = np.zeros((K, L), bool)
    alive = np.zeros(K, bool)
    for _ in range(200):
        k = int(rng.integers(0, K))
        alive[k] = True
        if rng.uniform() < 0.7:
            lms = rng.integers(0, L, size=rng.integers(1, 30))
            g.add_observations(k, lms)
            obs[k, lms] = True
        else:
            have = np.nonzero(obs[k])[0]
            if len(have):
                rm = rng.choice(have, size=min(len(have), 10), replace=False)
                g.remove_observations(k, rm)
                obs[k, rm] = False
    w_ref = _dense_weights(obs)
    for k in np.nonzero(alive)[0]:
        ref = np.where(alive, w_ref[k], 0)
        ref[k] = 0
        assert np.array_equal(g.covis_row(int(k)), ref), k


def test_covis_neighbors_sorted(lib_available):
    rng = np.random.default_rng(1)
    K, L = 12, 300
    g = Both(K, L)
    obs = np.zeros((K, L), bool)
    for k in range(K):
        lms = rng.integers(0, L, size=60)
        g.add_observations(k, lms)
        obs[k, lms] = True
    w = _dense_weights(obs)
    for k in range(K):
        nb = g.covis_neighbors(k, 15)
        want = [i for i in np.argsort(-w[k], kind="stable") if w[k, i] >= 15 and i != k]
        assert list(w[k, nb]) == sorted(w[k, nb], reverse=True)
        assert set(nb.tolist()) == set(want)


def test_landmark_removal_updates_weights(lib_available):
    g = Both(4, 10)
    g.add_observations(0, np.array([1, 2, 3]))
    g.add_observations(1, np.array([1, 2, 4]))
    assert g.covis_weight(0, 1) == 2
    g.remove_landmark(1)
    assert g.covis_weight(0, 1) == 1
    assert g.n_obs(1) == 0
    assert 1 not in g.kf_landmarks(0).tolist()


def test_spanning_tree_and_cull_reparenting(lib_available):
    g = Both(8, 100)
    g.add_observations(0, np.arange(0, 30))
    g.add_observations(1, np.arange(10, 40))
    g.add_observations(2, np.arange(25, 55))
    assert g.parent(0) == -1 and g.parent(1) == 0 and g.parent(2) == 1
    g.remove_keyframe(1)
    assert g.parent(2) == 0
    assert g.covis_weight(2, 1) == 0 and g.covis_row(2)[1] == 0


def test_essential_edges(lib_available):
    g = Both(6, 300)
    for k in range(5):
        g.add_observations(k, np.arange(k * 40, k * 40 + 150))
    g.add_loop_edge(0, 4)
    e = {tuple(x) for x in g.essential_edges(100).tolist()}
    assert (0, 4) in e
    for k in range(1, 5):
        assert (min(k, g.parent(k)), max(k, g.parent(k))) in e
    assert (0, 1) in e and (3, 4) in e


def _drive(m, rng):
    """tests/test_native_mapgraph.py's mutations of a MapState: keyframes
    binding fresh and earlier landmarks, mediated removals, then a direct
    obs write marked dirty; yields after each stage."""
    kfs = []
    for i in range(8):
        m.add_landmarks(
            rng.normal(size=(24, 3)).astype(np.float32), np.zeros((24, 8), np.uint32), np.zeros((24, 256), np.int8),
            first_kf=-1, level=np.zeros(24, np.int32), normal=np.tile(np.array([0, 0, 1], np.float32), (24, 1)),
            min_dist=np.full(24, 0.1, np.float32), max_dist=np.full(24, 10.0, np.float32),
        )
        lm_idx = np.full(64, -1, np.int32)
        valid_lms = np.nonzero(m.lm_valid)[0]
        chosen = rng.choice(valid_lms, size=min(40, len(valid_lms)), replace=False)
        lm_idx[: len(chosen)] = chosen
        kfs.append(m.add_keyframe(
            np.eye(3, dtype=np.float32), np.zeros(3, np.float32), np.zeros((64, 2), np.float32),
            np.zeros(64, np.int32), np.zeros(64, np.float32), np.zeros((64, 8), np.uint32), np.ones(64, bool),
            lm_idx, float(i), i,
        ))
    yield kfs
    m.remove_landmarks(np.nonzero(m.lm_valid)[0][:30])
    m.remove_keyframe(kfs[2])
    yield kfs
    m.obs[kfs[0], :] = False
    m.kf_lm_idx[kfs[0]] = -1
    m.mark_obs_dirty()
    yield kfs


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_map_state_native_consistency(lib_available, monkeypatch, backend):
    """The port's MapState covisibility equals the dense formula and the
    reference MapState's through mediated mutations and after direct obs
    writes + dirty mark, with the native graph and with the numpy fallback
    (`native.load()` returning None)."""
    from orbslam3_cpp_fork_tpu.models.map_state import MapConfig as JConfig, MapState as JMapState
    from orbslam3_cpp_fork_tpu_torch.models.map_state import MapConfig, MapState

    if backend == "numpy":
        monkeypatch.setattr(tnative, "load", lambda: None)
    m = MapState(MapConfig(max_keyframes=16, max_landmarks=512, n_features=64))
    assert (m._native is not None) == (backend == "native")
    r = JMapState(JConfig(max_keyframes=16, max_landmarks=512, n_features=64))

    def dense(k):
        w = m.obs.astype(np.int32) @ m.obs[k].astype(np.int32)
        w[k] = 0
        w[~m.kf_valid] = 0
        return w

    for kfs, kfs_r in zip(_drive(m, np.random.default_rng(7)), _drive(r, np.random.default_rng(7))):
        assert kfs == kfs_r
        for k in kfs:
            if m.kf_valid[k]:
                w = m.covisibility_weights(k)
                assert np.array_equal(w, dense(k)), k
                assert np.array_equal(w, r.covisibility_weights(k)), k
