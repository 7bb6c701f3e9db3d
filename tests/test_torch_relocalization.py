"""Relocalization and the hand-offs of a correction, port against reference:
one `_relocalize` from the same map, keyframe database and lost frame (the
RANSAC index sets the reference draws are handed to the port); the
`_rebase_after_map_change` of the live frame after a correction of another
thread; `LoopWorker` against the reference's on a stub tracker (with the
reference's idle-event race, repaired); and ROADMAP R9, the reference's
background global BA swallowing its failure where the port re-raises it.

Tolerances: the candidate list, the bindings, the state and the reference
keyframe exact, the pose within 1e-4; the rebase exact (both are the same
numpy); the workers' calls and counters exact.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.ops import ransac as jr
from orbslam3_cpp_fork_tpu.runtime import mapping_worker as jmw
from orbslam3_cpp_fork_tpu.runtime import tracker as jt
from orbslam3_cpp_fork_tpu_torch import convert
from orbslam3_cpp_fork_tpu_torch.datasets import synthetic
from orbslam3_cpp_fork_tpu_torch.ops import ransac as tr
from orbslam3_cpp_fork_tpu_torch.runtime import mapping_worker as tmw
from orbslam3_cpp_fork_tpu_torch.runtime import tracker as tt

from orbslam3_cpp_fork_tpu_torch.utils import lie as tl

from test_torch_slow_path import (  # noqa: F401  (states is a fixture)
    CAPS, MAP_CFG, N_FEAT, N_FRAMES, H, W, frame_of, frame_features, load_ref_state, no_features, port_tracker,
    ref_tracker, states,
)

WAIT = 10.0
KEY = jax.random.PRNGKey(17)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small shapes, six test workers: one intra-op thread each is faster
    than teams of OpenMP threads spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loaded(states, **kw):
    """A reference and a port tracker on the same established map, live
    state, trajectory records and keyframe database."""
    scene, snaps, _ = states
    state, arrays = snaps[N_FRAMES - 1]
    ref, got = ref_tracker(scene, **kw), port_tracker(scene, **kw)
    load_ref_state(ref, state, arrays)
    ref._seen_change_idx = state["seen_change_idx"]
    convert.load_tracker_state(got, state, arrays)
    for trk in (ref, got):
        trk.trajectory = [(f, t, mid, k, R.copy(), tt_.copy()) for f, t, mid, k, R, tt_ in state["trajectory"]]
    m = ref.map
    for k in np.nonzero(m.kf_valid)[0][np.argsort(m.kf_frame_id[m.kf_valid], kind="stable")]:
        ref.kfdb.add(ref._gid(int(k)), ref._kf_bits(int(k)), m.kf_feat_valid[k])
    convert.load_place_recognition(got, convert.kfdb_to_numpy(ref.kfdb))
    assert got.kfdb.codebook is not None
    return scene, ref, got


@pytest.mark.parametrize("at", [6, N_FRAMES - 2])
def test_relocalize_matches_the_reference(states, monkeypatch, at):
    """A frame far from the recent keyframes (database candidates) and one
    next to them (recency candidates)."""
    scene, ref, got = _loaded(states)
    Rs, ts = synthetic.circle_trajectory(n_frames=N_FRAMES + 8, radius=2.5, total_angle=0.8 * np.pi * (N_FRAMES + 8) / 120)
    feats = frame_features(synthetic.render_frame(scene, Rs[at], ts[at]))
    # The reference draws its MLPnP index sets from one key; the port gets
    # the same sets.
    monkeypatch.setattr(ref, "_next_key", lambda: KEY)
    monkeypatch.setattr(
        tr, "sample_indices",
        lambda gen, n_hyp, k, valid: torch.from_numpy(np.asarray(jr._sample_indices(KEY, n_hyp, k, jnp.asarray(valid.numpy())))),
    )
    seen = {"ref": [], "got": []}
    for name, trk in (("ref", ref), ("got", got)):
        orig = trk._kf_bits_dev

        def rec(k, orig=orig, name=name):
            seen[name].append(int(k))
            return orig(k)

        monkeypatch.setattr(trk, "_kf_bits_dev", rec)
    fr, fg = frame_of(jt, feats, N_FRAMES + 1), frame_of(tt, feats, N_FRAMES + 1)
    ok_r, ok_g = ref._relocalize(fr), got._relocalize(fg)
    assert seen["got"] == seen["ref"] and len(seen["got"]) >= 5, "tolerance: the same candidates in order"
    assert ok_g == ok_r and ok_g, "the frame relocalizes"
    assert got.state.name == ref.state.name == "OK" and got.ref_kf == ref.ref_kf
    assert np.array_equal(fg.lm_idx, fr.lm_idx), "tolerance: exact bindings"
    np.testing.assert_allclose(fg.R, fr.R, atol=1e-4)
    np.testing.assert_allclose(fg.t, fr.t, atol=1e-4)
    (ev,) = [e for e in got.events if e["kind"] == "reloc"]
    assert ev["kf"] == got.ref_kf and ev["source"] in ("database", "recency")
    if at == 6:  # far from every recent keyframe: only the database finds it
        assert ev["source"] == "database"


def test_relocalize_fails_on_a_featureless_frame(states):
    _, ref, got = _loaded(states)
    fr, fg = frame_of(jt, no_features(), N_FRAMES + 1), frame_of(tt, no_features(), N_FRAMES + 1)
    assert ref._relocalize(fr) is False and got._relocalize(fg) is False
    assert fg.R is None and got.last is fg


@pytest.mark.parametrize("has_record", [True, False])
def test_rebase_after_map_change_matches_the_reference(states, has_record):
    _, ref, got = _loaded(states)
    if not has_record:
        ref.trajectory.pop()
        got.trajectory.pop()
    rng = np.random.default_rng(0)
    dR = tl.so3_exp(torch.tensor([0.01, -0.02, 0.015])).numpy()
    dt = rng.normal(0, 0.05, 3).astype(np.float32)
    for trk in (ref, got):
        m = trk.map
        m.kf_R[:] = (m.kf_R @ dR.T).astype(np.float32)  # a correction moves every keyframe
        m.kf_t[:] = (m.kf_t + dt).astype(np.float32)
        m.big_change_idx += 1
        trk._pipe.extend([(trk.last, None, None, None, None)] * 2)  # two frames in flight
    ref._rebase_after_map_change()
    got._rebase_after_map_change()
    assert got.n_frames_dropped == ref.n_frames_dropped == 2 and not got._pipe and got._chain is None
    assert got._seen_change_idx == ref._seen_change_idx == got.map.big_change_idx
    assert got.velocity is None and ref.velocity is None
    assert np.array_equal(got.last.R, ref.last.R) and np.array_equal(got.last.t, ref.last.t), "tolerance: exact"
    assert dict(got.frame_causes) == dict(ref.frame_causes)
    # A frame tracked against the moved map is not recorded and is not a loss.
    got.map.big_change_idx += 1
    n = len(got.trajectory)
    got._record_trajectory(got.last)
    frame = frame_of(tt, {k: v.copy() for k, v in states[2][N_FRAMES].items()}, N_FRAMES + 1)
    got._set_lost(frame)
    assert len(got.trajectory) == n and got.state == tt.TrackState.OK and got.n_lost_events == 0


# ------------------------------------------------------------- LoopWorker


class StubTracker:
    """Records the loop steps; a step blocks until `go` is set."""

    def __init__(self):
        self.worker = None
        self.calls = []
        self.entered = threading.Semaphore(0)
        self.go = threading.Event()
        self.go.set()
        self.fail_on = None
        self.late_set = False

    def _loop_step(self, k, map_ref):
        self.calls.append((k, map_ref))
        self.entered.release()
        if self.late_set and hasattr(self.worker, "idle"):
            # What the reference's consumer does when its queue looked empty
            # just before the producer cleared `idle` for a new keyframe (the
            # port's worker has no such event).
            self.late_set = False
            self.worker.idle.set()
        assert self.go.wait(WAIT)
        if k == self.fail_on:
            raise ValueError(f"boom {k}")


@pytest.fixture(params=["ref", "port"])
def loop_rig(request):
    trk = StubTracker()
    w = (tmw if request.param == "port" else jmw).LoopWorker(trk)
    trk.worker = w
    yield request.param, trk, w
    trk.go.set()
    w.error = None
    w.stop()
    assert not w._thread.is_alive()


def test_loop_worker_runs_every_keyframe_in_order(loop_rig):
    _, trk, w = loop_rig
    trk.go.clear()
    for k in range(5):
        w.submit(k, "m")
    assert trk.entered.acquire(timeout=WAIT) and w.busy()
    trk.go.set()
    w.flush()
    assert trk.calls == [(k, "m") for k in range(5)] and not w.busy(), "tolerance: exact"


def test_loop_worker_failure_reaches_flush(loop_rig):
    _, trk, w = loop_rig
    trk.fail_on = 1
    for k in range(3):
        w.submit(k, "m")
    with pytest.raises(ValueError, match="boom 1"):
        w.flush()
    w.flush()  # raised once
    assert [k for k, _ in trk.calls] == [0, 1, 2]


def test_loop_worker_busy_while_a_step_runs(loop_rig):
    """The reference's `idle` event can be set by its consumer after the
    producer cleared it for a new keyframe: `busy()` then reads False while
    that keyframe's step runs. The port counts instead."""
    which, trk, w = loop_rig
    trk.go.clear()
    trk.late_set = True
    w.submit(0, "m")
    assert trk.entered.acquire(timeout=WAIT)
    if which == "port":
        assert w.busy() and w.n_processed == 0
    else:
        assert not w.busy(), "the reference's stale event"
    trk.go.set()
    w.flush()
    assert not w.busy()


# --------------------------------------------------------------------- R9


@pytest.mark.parametrize("which", ["ref", "port"])
def test_background_global_ba_failure(states, which, monkeypatch):
    """ROADMAP R9: the reference's background global BA logs its failure and
    carries on; the port re-raises it at the next flush."""
    scene = states[0]
    if which == "port":
        trk = port_tracker(scene, async_mapping=True, enable_loop_closing=True)
    else:
        from orbslam3_cpp_fork_tpu.models import map_state as jms
        from orbslam3_cpp_fork_tpu.ops import camera as jcam
        from orbslam3_cpp_fork_tpu.ops import orb as jorb

        K = scene.K
        trk = jt.MonoTracker(jt.TrackerConfig(
            camera=jcam.Camera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), width=W, height=H,
            orb=jorb.OrbParams(n_features=N_FEAT), mapping_backend="cpu", map_cfg=jms.MapConfig(**MAP_CFG), **CAPS,
        ))
    try:
        monkeypatch.setattr(trk, "_gba_gather", lambda fix=None: {"n_obs": 0})

        def fail(*a, **kw):
            raise RuntimeError("solver failed")

        monkeypatch.setattr(trk, "_gba_solve", fail)
        trk._global_ba_after_loop(0, 0)
        trk._gba_thread.join(WAIT)
        if which == "ref":
            trk.flush_mapping()  # the failure is gone
        else:
            with pytest.raises(RuntimeError, match="solver failed"):
                trk.flush_mapping()
            trk.flush_mapping()  # raised once
    finally:
        trk.worker.stop()
        trk.loop_worker.stop()
