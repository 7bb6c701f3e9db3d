"""Loop closing, port against reference: the fused geometric validation of a
candidate on the same inputs and RANSAC draws, and the
three-consecutive-keyframe confirmation (the four cases of
tests/test_loop_confirmation.py). The correction is
tests/test_torch_loop_correction.py's.

Tolerances: validation counters (`n_bow`, `n_ransac`, `n_opt`, `n_proj`)
exact and the Sim(3) within 1e-4; confirmation exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.runtime import loop_closing as jlc
from orbslam3_cpp_fork_tpu.utils import lie as jl
from orbslam3_cpp_fork_tpu_torch.models import map_state as tms
from orbslam3_cpp_fork_tpu_torch.runtime import loop_closing as tlc

import test_loop_confirmation as tlconf

FX, FY, CX, CY = 400.0, 400.0, 320.0, 240.0


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small shapes, six test workers: one intra-op thread each is faster
    than teams of OpenMP threads spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x, dtype=None):
    a = np.ascontiguousarray(np.asarray(x))
    return torch.from_numpy(a if dtype is None else a.astype(dtype))


# ------------------------------------------------------- fused validation


def _pack(bits):
    """(n,256) 0/1 -> (n,8) uint32 words (little bit order)."""
    return np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little").view(np.uint32)


def _validation_inputs(seed, s_true=1.3):
    """Two keyframes k and c seeing the same 3D points; the candidate's map
    is scaled by 1/s_true, so S_kc has scale s_true."""
    rng = np.random.default_rng(seed)
    N, M = 300, 220
    X = np.stack([rng.uniform(-3, 3, M), rng.uniform(-2, 2, M), rng.uniform(5, 10, M)], 1).astype(np.float32)
    R_c = np.asarray(jl.so3_exp(jnp.asarray(rng.normal(0, 0.05, 3).astype(np.float32))))
    t_c = np.array([0.1, 0.0, 0.2], np.float32)
    R_k = np.asarray(jl.so3_exp(jnp.asarray(rng.normal(0, 0.05, 3).astype(np.float32))))
    t_k = np.array([-0.2, 0.05, 0.1], np.float32)
    pt_bits = rng.integers(0, 2, (M, 256)).astype(np.int8)

    def frame(R, t, scale):
        pc = X @ R.T + t
        uv = pc[:, :2] / pc[:, 2:3] * [FX, FY] + [CX, CY]
        bits = pt_bits.copy()
        flip = rng.random(bits.shape) < 0.02
        bits[flip] ^= 1
        xy = np.concatenate([uv, rng.uniform([0, 0], [2 * CX, 2 * CY], (N - M, 2))]).astype(np.float32)
        allbits = np.concatenate([bits, rng.integers(0, 2, (N - M, 256)).astype(np.int8)])
        perm = rng.permutation(N)
        inv = np.argsort(perm)
        xy, allbits = xy[perm], allbits[perm]
        valid = np.ones(N, bool)
        bound = np.zeros(N, bool)
        bound[inv[:M]] = rng.random(M) < 0.9
        pc_all = np.zeros((N, 3), np.float32)
        pc_all[inv[:M]] = pc / scale
        angle = np.full(N, 0.3, np.float32) + rng.normal(0, 0.01, N).astype(np.float32)
        return dict(xy=xy, bits=allbits, valid=valid, bound=bound, pc=pc_all * bound[:, None], angle=angle,
                    level=np.zeros(N, np.int32), pt_of=inv[:M])

    k = frame(R_k, t_k, 1.0)
    c = frame(R_c, t_c, s_true)
    # The candidate window's landmarks, in the candidate map's world frame.
    w_pos = np.zeros((4096, 3), np.float32)
    w_pos[:M] = X / s_true
    w_desc = np.zeros((4096, 8), np.uint32)
    w_desc[:M] = _pack(pt_bits)
    w_ok = np.zeros(4096, bool)
    w_ok[:M] = True
    w_maxd = np.ones(4096, np.float32)  # predicted level 0
    Rc, tc = R_c, (t_c / s_true).astype(np.float32)
    args = [
        k["bits"], k["bound"], k["angle"], k["pc"], (k["xy"] - [CX, CY]).astype(np.float32), np.ones(N, np.float32),
        c["bits"], c["bound"], c["angle"], c["pc"], (c["xy"] - [CX, CY]).astype(np.float32), np.ones(N, np.float32),
        w_desc, w_pos, w_maxd, w_ok, Rc, tc,
        _pack(k["bits"]), k["xy"], k["level"], k["valid"],
    ]
    return args, N


@pytest.mark.parametrize("seed", [0, 1])
def test_validate_candidate_fused_matches_the_reference(seed):
    args, N = _validation_inputs(seed)
    key = jnp.asarray(np.asarray([0, 1234 + seed], np.uint32))
    ref = jax.device_get(jlc._validate_candidate_fused(
        *[jnp.asarray(a) for a in args], key, FX, FY, CX, CY, 2 * CX, 2 * CY, fix_scale=False,
    ))
    # The reference's Sim(3) RANSAC draws, as `ransac._sample_indices` makes them.
    draws = np.asarray(jax.random.randint(key, (tlc.N_HYP_SIM3, 3), 0, N))
    targs = [_t(a, np.int64) if i in (12, 18) else _t(a) for i, a in enumerate(args)]
    got = tlc._validate_candidate_fused(
        *targs, _t(draws).long(), FX, FY, CX, CY, 2 * CX, 2 * CY, fix_scale=False,
    )
    for name in ("n_bow", "n_ransac", "n_opt", "n_proj", "ok_r"):
        assert int(got[name]) == int(ref[name]), (name, "tolerance: exact")
    assert int(got["n_bow"]) > 100 and int(got["n_proj"]) > 100
    np.testing.assert_allclose(float(got["s"]), float(ref["s"]), atol=1e-4)
    np.testing.assert_allclose(got["R"].numpy(), np.asarray(ref["R"]), atol=1e-4)
    np.testing.assert_allclose(got["t"].numpy(), np.asarray(ref["t"]), atol=1e-4)
    assert abs(float(got["s"]) - 1.3) < 0.01
    # The BoW-style pair matcher alone.
    idx_r, ok_r = jlc._match_loop_pair(*[jnp.asarray(args[i]) for i in (0, 1, 2, 6, 7, 8)])
    idx_g, ok_g = tlc._match_loop_pair(*[targs[i] for i in (0, 1, 2, 6, 7, 8)])
    assert np.array_equal(ok_g.numpy(), np.asarray(ok_r)) and int(ok_g.sum()) == int(got["n_bow"])
    assert np.array_equal(idx_g.numpy()[ok_g.numpy()], np.asarray(idx_r)[np.asarray(ok_r)]), "tolerance: exact"


# ------------------------------------------------------------ confirmation


class _PortScripted(tlc.LoopCloser):
    """The port's closer with the scripted validation of
    tests/test_loop_confirmation.py."""

    def __init__(self, atlas, kfdb, script, cfg):
        super().__init__(atlas, kfdb, 400.0, 400.0, 320.0, 240.0, torch.device("cpu"), cfg)
        self.script = list(script)
        self.calls = 0
        self.corrected = []
        self._cur = None

    def process_keyframe(self, k):
        self._cur = self.script[min(self.calls, len(self.script) - 1)]
        out = super().process_keyframe(k)
        self.calls += 1
        return out

    def _validate_candidate(self, k, c, m_c=None):
        if self._cur is None:
            return None
        return 1.0, np.eye(3, dtype=np.float32), np.zeros(3, np.float32), self._cur

    def _projection_matches(self, k, c, s, R, t, m_c=None):
        return 0 if self._cur is None else self._cur

    def _correct_loop(self, k, c, s, R, t):
        self.corrected.append((k, c))
        self.last_loop_kf = k


def _port_map(n_kf=20):
    m = tms.MapState(tms.MapConfig(max_keyframes=64, max_landmarks=256, n_features=8))
    for i in range(n_kf):
        m.add_keyframe(
            R=np.eye(3, dtype=np.float32), t=np.array([-0.1 * i, 0, 0], np.float32),
            xy=np.zeros((8, 2), np.float32), level=np.zeros(8, np.int32), angle=np.zeros(8, np.float32),
            desc_packed=np.zeros((8, 8), np.uint32), feat_valid=np.ones(8, bool), lm_idx=np.full(8, -1, np.int32),
            timestamp=float(i), frame_id=i,
        )
    return m


@pytest.mark.parametrize("script,n_closed", [
    ([120, 120, None, None, None], 0),  # two consecutive validations do not close
    ([120, 120, 120, None], 1),  # three do
    ([120, 120, None, 120, 120, None, None], 0),  # an interrupted streak resets
    ([55, 55, 55], 1),  # weak but sufficient validations count
])
def test_confirmation_streak_matches_the_reference(script, n_closed):
    ref = tlconf._run(script)
    m = _port_map()
    got = _PortScripted(tlconf._FakeAtlas(m), tlconf._FakeKFDB(gid=0), script,
                        tlc.LoopConfig(min_kfs=2, kf_gap_after_loop=0))
    for k in range(12, 12 + len(script)):
        got.process_keyframe(k)
    assert got.corrected == ref.corrected and len(got.corrected) == n_closed, "tolerance: exact"
    assert (got.pending is None) == (ref.pending is None)
    if got.pending is not None:
        assert got.pending[:2] == ref.pending[:2] and got.pending[3] == ref.pending[3]


def test_the_atlas_creates_and_merges_maps():
    """A merge proposal needs a hypothesis in a second map: the Atlas makes
    one (`create_new_map`, a new id, active) and welds it back
    (`merge_into`), leaving one map with the keyframes of both."""
    from orbslam3_cpp_fork_tpu_torch.models.atlas import Atlas

    atlas = Atlas(tms.MapConfig(max_keyframes=64, max_landmarks=32, n_features=8))
    atlas.maps[0] = _port_map(5)
    m1 = atlas.create_new_map()
    assert atlas.n_maps() == 2 and atlas.active is m1 and m1.map_id == 1 and atlas._next_map_id == 2
    atlas.maps[1] = _port_map(4)
    atlas.maps[1].map_id = 1
    kf_remap, lm_remap = atlas.merge_into(0, 1, (2.0, np.eye(3, dtype=np.float32), np.zeros(3, np.float32)))
    assert atlas.n_maps() == 1 and atlas.active.map_id == 0 and atlas.active.n_keyframes() == 9
    assert sorted(kf_remap.values()) == [5, 6, 7, 8] and lm_remap == {}
    # T_new = T_old o M with M = (2, I, 0), stored as SE(3) through t / s.
    assert np.allclose(atlas.active.kf_t[kf_remap[3]], [-0.15, 0, 0])
