"""The keyframe database (online codebook, histograms, queries, group
accumulation, the adaptive floor), port against reference: the five tests of
tests/test_retrieval.py and tests/test_retrieval_scale.py::
test_cold_start_loop_in_first_20_kfs, each run on both databases fed the same
descriptors, with the reference tests' gates held on the port's results.

Tolerances: the codebook, the histograms, presence, query and query_groups
ids and the adaptive floor exact; scores within 1e-6. The codebook refresh
across two scenes and the noisy-render tier of the relative floor extract
ORB features from ~120 frames with the reference and are marked slow (~35 s
together).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.datasets import synthetic
from orbslam3_cpp_fork_tpu.ops.orb import OrbParams, extract_orb_jit
from orbslam3_cpp_fork_tpu.runtime.keyframe_database import KeyFrameDatabase as RefDB
from orbslam3_cpp_fork_tpu_torch.runtime import keyframe_database as tkd
from orbslam3_cpp_fork_tpu_torch.runtime.keyframe_database import KeyFrameDatabase as PortDB


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small shapes, six test workers: one intra-op thread each is faster
    than teams of OpenMP threads spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _scene(seed, n_points=3000, size_range=(5, 11)):
    return synthetic.make_ring_scene(seed=seed, n_points=n_points, size_range=size_range)


@functools.lru_cache(maxsize=None)
def _feats(scene_key, n_frames, total, i, n_features=500, radius=2.5, degrade_seed=None):
    scene = _scene(*scene_key)
    Rs, ts = synthetic.circle_trajectory(n_frames=n_frames, radius=radius, total_angle=total)
    img = synthetic.render_frame(scene, Rs[i], ts[i])
    if degrade_seed is not None:
        img = synthetic.degrade(img, noise_sigma=4.0, blur_sigma=0.4, seed=degrade_seed)
    f = extract_orb_jit(jnp.asarray(img), OrbParams(n_features=n_features))
    return np.asarray(f.desc_i8), np.asarray(f.valid)


class Pair:
    """A reference and a port database fed the same calls."""

    def __init__(self, max_keyframes, **kw):
        self.ref = RefDB(max_keyframes, **kw)
        self.got = PortDB(max_keyframes, torch.device("cpu"), **kw)

    def add(self, k, d, v):
        self.ref.add(k, d, v)
        self.got.add(k, d, v)

    def check_state(self):
        r, g = self.ref, self.got
        assert (r.codebook is None) == (g.codebook is None)
        if r.codebook is not None:
            assert np.array_equal(r.codebook, g.codebook), "tolerance: exact"
        assert np.array_equal(r.hists, g.hists) and np.array_equal(r.present, g.present), "tolerance: exact"
        assert sorted(r._pending) == sorted(g._pending) and r.n_refreshes == g.n_refreshes

    def histogram(self, d, v):
        hr, hg = self.ref.histogram(d, v), self.got.histogram(d, v)
        assert (hr is None) == (hg is None)
        if hr is not None:
            assert np.array_equal(hr, hg), "tolerance: exact"
        return hg

    def query(self, hist, **kw):
        ir, sr = self.ref.query(hist, **kw)
        ig, sg = self.got.query(hist, **kw)
        assert np.array_equal(ir, ig), "tolerance: exact ids"
        np.testing.assert_allclose(sg, sr, atol=1e-6)
        return ig, sg

    def adaptive_floor(self, hist, **kw):
        fr, fg = self.ref.adaptive_floor(hist, **kw), self.got.adaptive_floor(hist, **kw)
        assert fr == fg, "tolerance: exact"
        return fg

    def refresh(self):
        self.ref.refresh_codebook()
        self.got.refresh_codebook()
        self.check_state()


def test_nearest_words_is_a_first_index_argmin():
    rng = np.random.default_rng(0)
    cb = rng.integers(0, 2, (64, 256)).astype(np.int8)
    d = np.concatenate([cb[[5, 5, 9]], rng.integers(0, 2, (40, 256)).astype(np.int8)])
    cb[7] = cb[5]  # a tie: the first index wins
    w = tkd._nearest_words(torch.from_numpy(d), torch.from_numpy(cb)).numpy()
    assert w[0] == w[1] == 5 and w[2] == 9
    dist = (d[:, None, :] != cb[None, :, :]).sum(-1)
    assert np.array_equal(w, np.argmin(dist, axis=1)), "tolerance: exact"


def test_revisit_ranks_first():
    db = Pair(32)
    key = (2,)
    for k, i in enumerate(range(0, 36, 3)):
        db.add(k, *_feats(key, 36, 2 * np.pi, i))
    db.check_state()
    assert db.got.codebook is not None
    hist = db.histogram(*_feats(key, 36, 2 * np.pi, 1))
    ids, _ = db.query(hist, n_best=3, min_score=0.0)
    assert ids[0] == 0
    all_scores = np.full(12, -1.0)
    ids_all, sc_all = db.query(hist, n_best=12, min_score=-1.0)
    all_scores[ids_all] = sc_all
    assert all_scores[0] > all_scores[3:10].max() + 0.05


def test_query_excludes():
    db = Pair(32)
    key = (4,)
    feats = [_feats(key, 12, 2 * np.pi, k) for k in range(12)]
    for k, (d, v) in enumerate(feats):
        db.add(k, d, v)
    db.check_state()
    hist = db.histogram(*feats[0])
    ids, scores = db.query(hist, exclude=np.asarray([0, 1, 11]), n_best=3, min_score=-1.0)
    assert all(i not in (0, 1, 11) for i in ids) and len(ids) >= 1
    assert scores.max() < 0.03
    ids2, _ = db.query(hist, n_best=1, min_score=0.0)
    assert ids2[0] == 0


@pytest.mark.slow
def test_codebook_refresh_cross_scene():
    a, b = (11,), (12, 700)
    db = Pair(64)
    for k, i in enumerate(range(0, 36, 3)):
        db.add(k, *_feats(a, 36, 2 * np.pi, i))
    for k, i in enumerate(range(0, 36, 3)):
        db.add(12 + k, *_feats(b, 36, 2 * np.pi, i))
    db.check_state()

    def recall():
        hits = 0
        for key, base in ((a, 0), (b, 12)):
            for q in range(12):
                hist = db.histogram(*_feats(key, 36, 2 * np.pi, q * 3 + 1))
                ids, sc = db.query(hist, n_best=24, min_score=-1.0)
                s = np.full(24, -1.0)
                s[ids] = sc
                hits += s[base + q] == s[base:base + 12].max()
        return hits / 24.0

    r_frozen = recall()
    db.refresh()
    assert db.got.n_refreshes == 1
    assert recall() >= r_frozen
    ids, _ = db.query(db.histogram(*_feats(b, 36, 2 * np.pi, 1)), n_best=3, min_score=0.0)
    assert ids[0] == 12


def test_pending_flush_before_vocab():
    """As the reference's test, with 500 features a frame in place of its 300
    (one ORB program compiled for the whole file): the vocabulary of 1024
    words still waits for a third keyframe."""
    db = Pair(8, n_words=1024)
    key = (6,)
    db.add(0, *_feats(key, 8, 2 * np.pi, 0))
    db.check_state()
    assert db.got.codebook is None and not db.got.present[0]
    assert db.got.histogram(*_feats(key, 8, 2 * np.pi, 0)) is None
    for k in range(1, 5):
        db.add(k, *_feats(key, 8, 2 * np.pi, k))
    db.check_state()
    assert db.got.codebook is not None and db.got.present[0]
    db.got.erase(2)
    db.ref.erase(2)
    db.check_state()
    assert not db.got.present[2]


@pytest.mark.parametrize("degraded", [False, pytest.param(True, marks=pytest.mark.slow)])
def test_relative_floor_tracks_distribution(degraded):
    key = (21,)
    db = Pair(64)

    def feats(i, seed=0):
        return _feats(key, 72, 4 * np.pi, i, degrade_seed=seed if degraded else None)

    for k, i in enumerate(range(0, 72, 3)):
        db.add(k, *feats(i, seed=k))
    db.check_state()

    def check():
        hist = db.histogram(*feats(40, seed=99))
        excl = np.arange(12, 24)
        floor = db.adaptive_floor(hist, exclude=excl)
        assert floor is not None
        floor = max(0.03, floor)
        ids, scores = db.query(hist, exclude=excl, n_best=24, min_score=-1.0)
        s = dict(zip(ids.tolist(), scores.tolist()))
        assert s.get(1) is not None and s[1] >= floor
        assert max(v for k2, v in s.items() if 3 <= k2 <= 9) < floor
        # Group accumulation over a covisibility that links neighbours.
        covis = lambda r: [x for x in (r - 1, r + 1) if 0 <= x < 24]  # noqa: E731
        gr = db.ref.query_groups(hist, covis, exclude=excl, n_best=3)
        gg = db.got.query_groups(hist, covis, exclude=excl, n_best=3)
        assert np.array_equal(gr[0], gg[0]), "tolerance: exact ids"
        np.testing.assert_allclose(gg[1], gr[1], atol=1e-6)
        assert len(gg[0]) and gg[0][0] in (0, 1, 2)

    check()
    db.refresh()
    check()


def test_cold_start_loop_in_first_20_kfs():
    key = (42, 900, (9, 15))
    db = Pair(64)
    for k in range(18):
        db.add(k, *_feats(key, 20, 2 * np.pi, k))
    db.check_state()
    hist = db.histogram(*_feats(key, 20, 2 * np.pi, 19))
    assert hist is not None
    ids, _ = db.query(hist, exclude=np.asarray([17, 16, 15]), n_best=3)
    assert len(ids) >= 1 and int(ids[0]) in (0, 1, 18)
