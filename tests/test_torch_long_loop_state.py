"""ROADMAP C4 from one state: the loop correction at frame 418 of the
port's long run on the CPU, applied by the reference and by the port to the
same map.

The state is the port's own, on the CPU with one torch thread, just after
the mapping step of keyframe 93 (frame 418) and just before its loop step
(tests/long_loop_rig.py, stored in tests/data/long_cpu_loop_state.npz): 94
live keyframes, two loop edges already in the map, and the loop closer's
hypothesis 93 -> 35 pending with two of its three consecutive validations.
The file also holds the run's exported ATE after every frame since the loop
before (frame 328): it leaves the long phase's 0.12 m bar at frame 370,
when no loop runs, and the loop at 418 lowers it. Both trackers are loaded
with the state and run that one loop step, the global BA inline as in the
synchronous run; the stages of the correction are recorded on both sides by
chip_smoke.record_loop_stages and compared in order:

1. the candidate validated and its Sim(3): the same (k, c), scales within
   1e-4 relative;
2. the window correction: keyframe poses within 1e-4, landmarks within
   1e-3 map units;
3. SearchAndFuse: the same landmarks fused (tables exact);
4. the essential graph (the reference pads it to 64-vertex and 1024-edge
   buckets; this map exceeds one bucket in both): poses within 1e-4,
   landmarks within 1e-3;
5. the global BA (ROADMAP R21): it does not converge in its 10 iterations
   on this map, and its output moves by centimetres of map units under one
   ulp of one input pose in the reference itself. The reference's own
   solve with another f32 summation order (its sharded solve over
   tests/conftest.py's 8 host devices) lies farther from its local solve
   than the port's does; the reference runs its local solve here, as in a
   plain process.

After each stage the scale-aligned ATE of the live keyframes against their
frames' true centres is printed for both sides, and the ground truth of the
loop's two frames says whether the match is a true revisit.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from long_loop_rig import load_state, loaded

TOL_POSE = 1e-4
TOL_LM = 1e-3
TOL_SCALE = 1e-4  # relative


@pytest.fixture(scope="module")
def runs():
    """The stored state, its meta, the true poses and, for each side, the
    tracker after the loop step with its stage records and the global BA's
    snapshot."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        S, meta = load_state()
        scene, _, Rs, ts = chip_smoke.render_long()
        out = {}
        for impl in ("reference", "port"):
            trk = loaded(impl, scene, S)
            loops = chip_smoke.record_loop_stages(trk, ts, keep=True)
            real, snaps = trk._gba_solve, []

            def solve(snap, iters=None, background=False, real=real, snaps=snaps):
                snaps.append(snap)
                # The reference's local solve (a plain process's route).
                return real(snap, iters, True)

            trk._gba_solve = solve
            trk._loop_step(meta["kf"], trk.map)
            out[impl] = dict(trk=trk, loops=loops, gba_snap=snaps[0], gba_solve=real)
    finally:
        torch.set_num_threads(n)
    return S, meta, Rs, ts, out


def _loop(runs, impl):
    (rec,) = runs[4][impl]["loops"]
    return rec


def _apart(a, b, kv, lv):
    """Largest differences of two (R, t, Xw) over the live keyframes and
    landmarks."""
    return (float(np.abs(a[0][kv] - b[0][kv]).max()), float(np.abs(a[1][kv] - b[1][kv]).max()),
            float(np.abs(a[2][lv] - b[2][lv]).max()))


def test_the_state_is_the_long_runs_before_its_loop(runs):
    S, meta, Rs, ts, _ = runs
    m = S["map"]
    assert m["kf_valid"][meta["kf"]] and m["kf_valid"][meta["match"]]
    assert m["kf_frame_id"][meta["kf"]] == meta["kf_frame"] and m["kf_frame_id"][meta["match"]] == meta["match_frame"]
    p = S["loop"]["pending"]
    assert p is not None and p[0] % m["kf_valid"].shape[0] == meta["match"], "the loop's candidate is pending"
    assert len(S["loop"]["loop_edges"]) == S["loop"]["n_loops_closed"] == meta["loops_before"] >= 2
    since = meta["ate_since_last_loop"]
    left = next(i for i, (f, ate) in enumerate(since) if ate > chip_smoke.LONG_MAX_ATE_M)
    dist, deg = chip_smoke.revisit(Rs, ts, meta)
    print(f"\nstate: frame {meta['frame']}, keyframe {meta['kf']} (frame {meta['kf_frame']}) -> {meta['match']} "
          f"(frame {meta['match_frame']}), {int(m['kf_valid'].sum())} live keyframes, {int(m['lm_valid'].sum())} "
          f"landmarks, {meta['loops_before']} loop edges; ground truth of the match: centres {dist:.3f} m apart, "
          f"optical axes {deg:.1f} deg apart; the run's exported ATE {since[0][1]:.6f} m after frame {since[0][0]}, "
          f"{since[left - 1][1]:.6f} m after frame {since[left - 1][0]}, {since[left][1]:.6f} m after frame "
          f"{since[left][0]}, {meta['ate_before']:.6f} m before the loop and {meta['ate_after']:.6f} m after it")
    assert since[left][0] < meta["frame"] and meta["ate_after"] < meta["ate_before"], \
        "the run leaves the bar before this loop, and the loop lowers its ATE"
    assert deg <= chip_smoke.LOOP_REVISIT_DEG, "a true revisit"


def test_same_candidate_and_sim3(runs):
    a, b = _loop(runs, "reference"), _loop(runs, "port")
    meta = runs[1]
    for name, r in (("reference", a), ("port", b)):
        print(f"\n{name}: validations {[(k, c, None if v is None else (v[0], v[3])) for k, c, v in r['validations']]}, "
              f"projection counts {r['projections']}, database queries {r['queries']}, Sim(3) scale {r['s']!r}")
        assert runs[4][name]["trk"].loop_closer.n_loops_closed == meta["loops_before"] + 1
    assert (a["kf"], a["match"]) == (b["kf"], b["match"]) == (meta["kf"], meta["match"])
    assert [v[:2] for v in a["validations"]] == [v[:2] for v in b["validations"]]
    assert [p[:2] for p in a["projections"]] == [p[:2] for p in b["projections"]]
    assert abs(a["s"] - b["s"]) <= TOL_SCALE * a["s"], "tolerance: 1e-4 relative"
    np.testing.assert_allclose(b["R"], a["R"], atol=TOL_POSE)
    np.testing.assert_allclose(b["t"], a["t"], atol=TOL_POSE)


@pytest.mark.parametrize("stage", ["window", "essential_graph"])
def test_poses_and_landmarks_agree_after(runs, stage):
    a, b = _loop(runs, "reference")["stages"][stage], _loop(runs, "port")["stages"][stage]
    assert np.array_equal(a["kf_valid"], b["kf_valid"]) and np.array_equal(a["lm_valid"], b["lm_valid"])
    dR, dt, dX = _apart((a["kf_R"], a["kf_t"], a["lm_pos"]), (b["kf_R"], b["kf_t"], b["lm_pos"]), a["kf_valid"],
                        a["lm_valid"])
    print(f"\nafter {stage}: max |dR| {dR:.2e}, max |dt| {dt:.2e} over {int(a['kf_valid'].sum())} keyframes, max "
          f"|dX| {dX:.2e} over {int(a['lm_valid'].sum())} landmarks")
    assert dR <= TOL_POSE and dt <= TOL_POSE, "tolerance: 1e-4"
    assert dX <= TOL_LM, "tolerance: 1e-3 map units"


def test_search_and_fuse_fuses_the_same_landmarks(runs):
    a, b = _loop(runs, "reference")["stages"]["fuse"], _loop(runs, "port")["stages"]["fuse"]
    n_fused = int((runs[0]["map"]["lm_valid"] & ~a["lm_valid"]).sum())
    print(f"\nSearchAndFuse: {n_fused} landmarks replaced")
    assert n_fused > 0
    for key in ("lm_valid", "lm_replaced", "kf_lm_idx", "obs"):
        assert np.array_equal(a[key], b[key]), f"{key}: tolerance exact"


def test_global_ba_parts_as_the_reference_parts_from_itself(runs):
    """ROADMAP R21's witness. On the port's global-BA snapshot (the map after
    the port's essential graph): the port's solve against the reference's
    local solve, beside the reference's sharded solve (another f32
    summation order, as the port's is) and its local solve with one ulp on
    the loop keyframe's translation. The reference moves by more than the
    tolerance under the ulp, and its two summation orders lie farther
    apart than the port lies from it."""
    meta, out = runs[1], runs[4]
    solve = out["reference"]["gba_solve"]
    snap = out["port"]["gba_snap"]
    kv, lv = snap["kf_valid"], snap["lm_valid"]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = out["port"]["gba_solve"](snap)
    finally:
        torch.set_num_threads(n)
    local = solve(snap, None, True)
    sharded = solve(snap, None, False)
    t = snap["kf_t"].copy()
    t[meta["kf"]] = np.nextafter(t[meta["kf"]], np.float32(np.inf))
    ulp = solve(dict(snap, kf_t=t), None, True)
    port_apart, sharded_apart, ulp_apart = (_apart(x, local, kv, lv) for x in (got, sharded, ulp))
    print(f"\nglobal BA on the port's snapshot, max |dR|, |dt|, |dX| from the reference's local solve: port "
          f"{port_apart}, the reference's sharded solve {sharded_apart}, the reference with one ulp on keyframe "
          f"{meta['kf']}'s translation {ulp_apart}")
    assert min(ulp_apart[:2]) > 10 * TOL_POSE, "the reference moves under one ulp"
    assert port_apart[0] <= sharded_apart[0] and port_apart[1] <= sharded_apart[1]


def test_keyframe_ate_by_stage(runs):
    """The scale-aligned keyframe ATE before the correction and after each
    stage, on both sides: alike through the essential graph; the global BA
    lowers it on both sides, each by its own amount (R21)."""
    a, b = _loop(runs, "reference")["stages"], _loop(runs, "port")["stages"]
    assert list(a) == list(b) == ["before", *chip_smoke.LOOP_STAGES]
    print()
    for stage in a:
        print(f"keyframe ATE after {stage:>15}: reference {a[stage]['ate']:.6f} m, port {b[stage]['ate']:.6f} m "
              f"(host ms: reference {a[stage]['ms']:.1f}, port {b[stage]['ms']:.1f}; CPU)")
    for stage in ("before", "window", "fuse", "essential_graph"):
        assert abs(a[stage]["ate"] - b[stage]["ate"]) <= 1e-4, stage
    assert a["global_ba"]["ate"] < a["essential_graph"]["ate"] and b["global_ba"]["ate"] < b["essential_graph"]["ate"]


# ---------------------------------------------------------------- slow

S0_BACK = 7  # frames between S0 and the frame after which the run's ATE leaves the bar
STEP_PAST = 12  # frames stepped past the loop's frame


@pytest.mark.slow
def test_same_state_same_steps_through_the_loop(capsys):
    """S0: the port from a cold start (one torch thread) to a few frames
    before the run's exported ATE leaves the bar (frame 370, before the loop
    at 418 holds its candidate). The reference and the port are loaded with
    it, each also with one ulp on the live pose, and stepped through the
    loop to a dozen frames past it on the same frames: poses per frame
    (1e-4), each mapping step's new landmarks, the loops closed and the ATE
    of the poses exported over the stepped frames. The two part where the
    reference parts from itself under one ulp (ROADMAP R21)."""
    from test_torch_loop_drift import first_divergence, step

    from long_loop_rig import port_tracker, snapshot
    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

    _, meta = load_state()
    left = next(f for f, ate in meta["ate_since_last_loop"] if ate > chip_smoke.LONG_MAX_ATE_M)
    s0 = left - S0_BACK
    last = meta["frame"] + STEP_PAST
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        scene, stamps, Rs, ts = chip_smoke.render_long()
        frames = {}
        trk = port_tracker(scene)
        for i, img in enumerate(chip_smoke.long_frames(scene, Rs, ts)):
            if i > last:
                break
            if i <= s0:
                trk.track(img, float(stamps[i]))
            else:
                frames[i] = img
        S0 = snapshot(trk)
        runs = {(impl, ulp): step(loaded(impl, scene, S0), (scene, None, None, frames), last,
                                  perturb=("pose", 1) if ulp else None)
                for impl in ("reference", "port") for ulp in (False, True)}
    finally:
        torch.set_num_threads(n)
    ref, port = runs["reference", False], runs["port", False]

    def n_same(a, b):
        return next((j for j, (sa, sb) in enumerate(zip(a["steps"], b["steps"])) if not np.array_equal(sa[1], sb[1])),
                    len(a["steps"]))

    parted = {"port": first_divergence(ref, port), "reference, one ulp": first_divergence(ref, runs["reference", True]),
              "port against the port with one ulp": first_divergence(port, runs["port", True])}
    with capsys.disabled():
        print(f"\nfrom S0 (after frame {s0}) to frame {last}, against the reference: first pose beyond {TOL_POSE} and "
              f"first keyframe with other new landmarks: {parted}; mapping steps with the same new landmarks "
              f"{n_same(ref, port)} of {len(ref['steps'])}")
        for (impl, ulp), r in runs.items():
            ts_est, Twc = r["traj"]
            ate = ate_rmse(ts_est, Twc[:, :3, 3], stamps, ts).rmse_scaled
            print(f"  {impl}{', one ulp on the live pose' if ulp else ''}: loops "
                  f"{[(e['kf'], e['match'], e['kf_frame'], round(e['scale'], 4)) for e in r['loops']]}, scale-aligned "
                  f"ATE of frames {s0 + 1}-{last} {ate:.6f} m")
        for ra, rb in zip(ref["rec"], port["rec"]):
            print(f"  frame {ra[0]}: |dR| {np.abs(ra[1] - rb[1]).max():.2e} |dt| {np.abs(ra[2] - rb[2]).max():.2e} "
                  f"bindings equal {np.mean(ra[3] == rb[3]):.4f}")
    frame, kf = parted["port"]
    assert frame is not None and frame > s0 + S0_BACK, "the poses agree within 1e-4 through the frame the bar is left"
    assert n_same(ref, port) >= 2
    assert parted["reference, one ulp"] == parted["port"], "the port parts where the reference parts from itself"
