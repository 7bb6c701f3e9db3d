"""Where the port and the reference part on the loop scene (ROADMAP C1), on
the CPU, slow (minutes a test).

The scene is chip_smoke.py's loop phase (tests/test_loop_e2e.py's ring at
752x480, 1000 features, synchronous, loop closing and the global BA on).
From a cold start the two differ from the first map on: the two-view
RANSAC draws its hypotheses from a JAX key in the reference and from a
torch generator in the port. These tests put both in the same state
instead (the reference's live state, map, keyframe database and loop state
through `convert`), step both over the same frames and compare the stages
in order:

- from the reference's state after frame 80: poses, bindings and every
  mapping step's new landmarks agree until a window BA's f32 summation
  order (ordered segment sums in the port, XLA's order in the reference)
  leaves a difference of a few 1e-5 in a keyframe pose, inside the window
  BA's 1e-4 tolerance; a keyframe or two later a landmark decision flips,
  and from there the maps part;
- from the port's own map just before the loop keyframe (grown from the
  reference's state after frame 40), the reference closes the same loop
  with the same Sim(3): the loop, essential-graph and global-BA stages are
  not where the two part;
- the reference against itself: one ulp on one keyframe pose of its own
  window BA (the first stage where the two implementations differ), or on
  its live pose, moves its loop scale and ATE, and noise of the size of the
  implementations' difference after each window BA moves them as far as
  the port lies from it;
- from a cold start, the reference with two PRNG keys and the port with its
  own draws and with the reference's.

PERF.md (Findings, PR 6) holds the numbers these tests print.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu_torch import convert
from orbslam3_cpp_fork_tpu_torch.ops.orb import OrbParams
from orbslam3_cpp_fork_tpu_torch.runtime import tracker as tt
from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the loop scene)

pytestmark = pytest.mark.slow

TOL_POSE = 1e-4  # pose_optimization / window BA parity tolerance (PERF.md)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    return chip_smoke.render_loop()


def ref_tracker(scene):
    from orbslam3_cpp_fork_tpu.ops.camera import Camera
    from orbslam3_cpp_fork_tpu.ops.orb import OrbParams as JOrbParams
    from orbslam3_cpp_fork_tpu.runtime import tracker as jt

    K = scene.K
    return jt.Tracker(jt.TrackerConfig(
        camera=Camera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), width=scene.width, height=scene.height,
        orb=JOrbParams(n_features=1000), mapping_backend="cpu", async_mapping=False, enable_loop_closing=True,
    ))


def port_tracker(scene):
    K = scene.K
    return tt.Tracker(tt.TrackerConfig(
        camera=convert.camera_from_numpy(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), width=scene.width,
        height=scene.height, orb=OrbParams(n_features=1000), async_mapping=False,
    ), "cpu")


def snapshot(trk) -> dict:
    return dict(state=convert.tracker_state_to_numpy(trk), map=convert.map_state_to_numpy(trk.map),
                kfdb=convert.kfdb_to_numpy(trk.kfdb), loop=convert.loop_state_to_numpy(trk.loop_closer))


def load_ref(trk, S):
    """The reference tracker in the state of `snapshot` (its own loaders do
    not exist; the fields are set as convert.load_* sets the port's)."""
    from orbslam3_cpp_fork_tpu.models import map_state as jms
    from orbslam3_cpp_fork_tpu.runtime import tracker as jt

    d = S["map"]
    m = jms.MapState(jms.MapConfig(n_features=d["kf_xy"].shape[1], imu_cap=d["kf_imu"].shape[1],
                                   max_keyframes=d["obs"].shape[0], max_landmarks=d["obs"].shape[1]))
    for k in convert.MAP_ARRAYS:
        getattr(m, k)[...] = d[k]
    for k in convert.MAP_SCALARS:
        setattr(m, k, d[k])
    m.mark_obs_dirty()
    trk.atlas.maps[trk.atlas.active_idx] = m
    st = S["state"]
    trk.state = jt.TrackState[st["state"]]
    trk.frame_id, trk.ref_kf = st["frame_id"], st["ref_kf"]
    trk.last_kf_frame_id, trk.n_kf_inserted = st["last_kf_frame_id"], st["n_kf_inserted"]
    trk._last_n_in, trk.lost_t = st["last_n_in"], st["lost_t"]
    trk.velocity = None if st["velocity"] is None else tuple(v.copy() for v in st["velocity"])
    f = st["last"]
    trk.last = jt.FrameData(frame_id=f["frame_id"], timestamp=f["timestamp"], R=f["R"].copy(), t=f["t"].copy(),
                            **{k: f[k].copy() for k in convert.FRAME_ARRAYS})
    trk._seen_change_idx = st["seen_change_idx"]
    trk._dev_local = None
    load_ref_place_recognition(trk, S["kfdb"], S["loop"])


def load_ref_place_recognition(trk, kd, ls):
    """The reference tracker's keyframe database and loop state from
    `convert.kfdb_to_numpy` / `loop_state_to_numpy` (the counterpart of
    `convert.load_place_recognition`)."""
    import jax

    db = trk.kfdb
    db.hists[...] = kd["hists"]
    db.present[...] = kd["present"]
    db.n_refreshes = kd["n_refreshes"]
    db._desc_store = {k: (a.copy(), b.copy()) for k, (a, b) in kd["desc_store"].items()}
    db._pending = {k: (a.copy(), b.copy()) for k, (a, b) in kd["pending"].items()}
    db._pool = [p.copy() for p in kd["pool"]]
    db._pool_count = kd["pool_count"]
    if kd["codebook"] is not None:
        db.codebook = kd["codebook"].astype(np.int8)
        db._cb_j = jax.device_put(db.codebook, db.device) if db.device is not None else jax.numpy.asarray(db.codebook)
    lc = trk.loop_closer
    lc.pending, lc.last_loop_kf = ls["pending"], ls["last_loop_kf"]
    lc.loop_edges, lc.n_loops_closed = list(ls["loop_edges"]), ls["n_loops_closed"]


def loaded(impl, scene, S):
    if impl == "reference":
        trk = ref_tracker(scene[0])
        load_ref(trk, S)
    else:
        trk = port_tracker(scene[0])
        convert.load_tracker_state(trk, S["state"], S["map"])
        convert.load_place_recognition(trk, S["kfdb"], S["loop"])
    return trk


def step(trk, scene, last, perturb=None, snap_at=None):
    """Track frames from the loaded state to `last`: per-frame poses and
    bindings, each mapping step's new landmark ids, the loop events, a
    snapshot after frame `snap_at`. `perturb`: ("kf", k, sign) moves keyframe
    k's window-BA output translation by one ulp; ("noise", sigma, seed) adds
    Gaussian noise of `sigma` to the ten newest keyframes' translations
    after every mapping step; ("pose", sign) moves the live frame's
    translation by one ulp before the first frame."""
    frames = scene[3]
    steps, orig = [], trk._mapping_step
    kind = perturb[0] if perturb else None
    rng = np.random.default_rng(perturb[2]) if kind == "noise" else None

    def spy(k, map_ref, frame=None):
        lm0 = map_ref.lm_valid.copy()
        out = orig(k, map_ref=map_ref, frame=frame)
        steps.append((int(k), np.nonzero(map_ref.lm_valid & ~lm0)[0]))
        if kind == "kf" and int(k) == perturb[1]:
            t = map_ref.kf_t[k].astype(np.float32)
            map_ref.kf_t[k] = np.nextafter(t, np.float32(np.inf) * np.float32(perturb[2]))
            map_ref.kf_gen[k] += 1
        elif kind == "noise":
            kv = np.nonzero(map_ref.kf_valid)[0]
            kv = kv[np.argsort(map_ref.kf_frame_id[kv])][-10:]
            kv = kv[kv != 0]
            map_ref.kf_t[kv] = (map_ref.kf_t[kv] + rng.normal(0, perturb[1], (len(kv), 3))).astype(np.float32)
            map_ref.kf_gen[kv] += 1
        return out

    trk._mapping_step = spy
    if kind == "pose":
        t = trk.last.t.astype(np.float32)
        trk.last.t = np.nextafter(t, np.float32(np.inf) * np.float32(perturb[1])).astype(np.float32)
    rec, snap = [], None
    for i in range(trk.frame_id, last + 1):
        trk.track(frames[i], 0.05 * i)
        rec.append((i, np.array(trk.last.R), np.array(trk.last.t), trk.last.lm_idx.copy()))
        if i == snap_at:
            snap = snapshot(trk)
    return dict(rec=rec, steps=steps, loops=[e for e in trk.loop_closer.events if e["kind"] == "loop"],
                traj=trk.export_trajectory(), snap=snap)


def ate_of(r, gt) -> float:
    ts_est, Twc = r["traj"]
    return ate_rmse(ts_est, Twc[:, :3, 3], np.arange(len(gt)) * 0.05, gt).rmse_scaled


@pytest.fixture(scope="module")
def ref_states(scene):
    """The reference from a cold start: its state after frames 40 and 80."""
    trk = ref_tracker(scene[0])
    out = {}
    for i, f in enumerate(scene[3][:81]):
        trk.track(f, 0.05 * i)
        if i in (40, 80):
            out[i] = snapshot(trk)
    return out


def first_divergence(a, b):
    """Frame of the first pose beyond TOL_POSE and the first mapping step
    whose new landmark ids differ."""
    frame = next((ra[0] for ra, rb in zip(a["rec"], b["rec"])
                  if max(np.abs(ra[1] - rb[1]).max(), np.abs(ra[2] - rb[2]).max()) > TOL_POSE), None)
    kf = next((sa[0] for sa, sb in zip(a["steps"], b["steps"]) if not np.array_equal(sa[1], sb[1])), None)
    return frame, kf


def test_same_state_same_stages(scene, ref_states):
    """From the reference's state after frame 80, both step to frame 101."""
    a, b = (step(loaded(impl, scene, ref_states[80]), scene, 101) for impl in ("reference", "port"))
    frame, kf = first_divergence(a, b)
    n_same = next((j for j, (sa, sb) in enumerate(zip(a["steps"], b["steps"])) if not np.array_equal(sa[1], sb[1])),
                  len(a["steps"]))
    print(f"from frame 80: first pose beyond {TOL_POSE} at frame {frame}; mapping steps with the same new landmarks "
          f"{n_same} of {len(a['steps'])}, first differing keyframe {kf}")
    for ra, rb in zip(a["rec"], b["rec"]):
        print(f"  frame {ra[0]}: |dR| {np.abs(ra[1] - rb[1]).max():.2e} |dt| {np.abs(ra[2] - rb[2]).max():.2e} "
              f"bindings equal {np.mean(ra[3] == rb[3]):.4f}")
    assert n_same >= 3, "three mapping steps from the same state give the same landmarks"
    assert frame is None or frame > 90, "the poses agree within 1e-4 over the first ten frames and more"


def test_loop_stage_on_the_ports_map(scene, ref_states):
    """The port grows its own map from the reference's state after frame 40
    to frame 101; loaded with that map, the reference closes the same loop
    with the same Sim(3) as the port."""
    grown = step(loaded("port", scene, ref_states[40]), scene, 101, snap_at=101)
    a, b = (step(loaded(impl, scene, grown["snap"]), scene, 109) for impl in ("reference", "port"))
    print(f"on the port's map at frame 101: reference loops {a['loops']}, port loops {b['loops']}")
    assert a["loops"] and len(a["loops"]) == len(b["loops"])
    for ea, eb in zip(a["loops"], b["loops"]):
        assert (ea["kf"], ea["match"]) == (eb["kf"], eb["match"]) and abs(ea["scale"] - eb["scale"]) <= 1e-4 * ea["scale"]


def test_reference_moves_under_one_ulp(scene, ref_states):
    """The reference against itself from its state after frame 40: one ulp
    on keyframe 12's or 13's window-BA output translation (the first stage
    where the two implementations differ), one ulp on the live pose, and
    3e-5 of noise after every window BA (the size of the implementations'
    difference); the loop scale and the ATE over frames 40-109 of each,
    beside the port's from the same state, with and without one ulp."""
    gt = scene[2]
    runs = [("reference", "reference", None)]
    runs += [(f"reference, KF {k} BA {sg:+d} ulp", "reference", ("kf", k, sg)) for k in (12, 13) for sg in (1, -1)]
    runs += [(f"reference, live pose {sg:+d} ulp", "reference", ("pose", sg)) for sg in (1, -1)]
    runs += [(f"reference, 3e-5 BA noise seed {n}", "reference", ("noise", 3e-5, n)) for n in range(4)]
    runs += [("port", "port", None), ("port, live pose +1 ulp", "port", ("pose", 1))]
    out = {}
    for name, impl, perturb in runs:
        r = step(loaded(impl, scene, ref_states[40]), scene, 109, perturb=perturb)
        out[name] = r
        print(f"from frame 40, {name}: loops {[(e['kf_frame'], round(e['scale'], 4)) for e in r['loops']]}, "
              f"scale-aligned ATE over frames 40-109 {ate_of(r, gt):.6f} m")
    base = out["reference"]["rec"]
    for name, r in out.items():
        if name.startswith("reference,"):
            assert any(not np.array_equal(x[2], y[2]) for x, y in zip(base, r["rec"])), f"{name} moved nothing"


def test_cold_start_draws(scene):
    """From a cold start: the reference with two PRNG keys, the port with its
    own two-view RANSAC draws and with the reference's (`_sample_indices`
    over the reference tracker's key sequence)."""
    import jax
    import jax.numpy as jnp
    from orbslam3_cpp_fork_tpu.ops import ransac as jr

    gt, frames = scene[2], scene[3]
    out = {}
    for name in ("reference key 0", "reference key 1", "port", "port with the reference's draws"):
        trk = ref_tracker(scene[0]) if name.startswith("reference") else port_tracker(scene[0])
        if name == "reference key 1":
            trk.rng_key = jax.random.PRNGKey(1)
        if name == "port with the reference's draws":
            keys = {"key": jax.random.PRNGKey(0)}

            def draws(valid):
                keys["key"], k = jax.random.split(keys["key"])
                idx = jr._sample_indices(k, 256, 8, jnp.asarray(valid.numpy()))
                return torch.from_numpy(np.asarray(idx).astype(np.int64))

            trk._sample_hypotheses = draws
        for i, f in enumerate(frames):
            trk.track(f, 0.05 * i)
        ts_est, Twc = trk.export_trajectory()
        out[name] = ate_rmse(ts_est, Twc[:, :3, 3], np.arange(len(frames)) * 0.05, gt).rmse_scaled
        print(f"cold start, {name}: loops {[(e['kf_frame'], round(e['scale'], 4)) for e in trk.loop_closer.events]}, "
              f"scale-aligned ATE {out[name]:.6f} m")
    assert all(np.isfinite(v) for v in out.values())
