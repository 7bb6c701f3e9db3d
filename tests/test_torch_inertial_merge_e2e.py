"""chip_smoke.py's inertial merge phase on the CPU (slow): the numbers behind
its gates.

`-k full_width` runs part A's inputs (the inertial merge scene at 752x480
with 1,000 features on EuRoC's camera rig, 540 frames with two flat
stretches, the reference's default ladder, loop closing and the global BA
on, the user's loss settings, synchronous) through the reference and through
the port, one torch thread each, and prints each run's spawns and resets,
map 1's IMU stages and VIBA2 frame after its first keyframe, the welds with
their scale and tilt, the loops after them and the scale-aligned ATE of the
poses tracked while OK at the weld and at the end
(chip_smoke.VIM_JAX_WELD_ATE_M, VIM_PORT_WELD_ATE_M, VIM_JAX_ATE_M,
VIM_PORT_ATE_M, VIM_JAX_VIBA2_AFTER_T0, VIM_JAX_TILT_DEG). The reference runs
with ROADMAP R13's repair (tests/inertial_merge_rig.py's `repair_r13`: its
reset map is otherwise lost at 4-5 keyframes, again and again);
`-k r13_witness` runs the reference without it to the frame where the reset
map would reach its IMU init, and shows the loss. `-k next_frames` steps
the reference from tests/inertial_merge_rig.py's state "after" through the
five frames the tier-1 tests/test_torch_inertial_merge_frames.py holds the
port to, and holds it to the outputs stored there. `-k driver` writes part
B's EuRoC tree and runs the reference's examples/mono_inertial_euroc.py on
it three times at once in the default mode (subprocesses), and prints the
merges each executed (chip_smoke.VIM_JAX_DRIVER_MERGES is the fewest):

    python -m pytest -m slow -s tests/test_torch_inertial_merge_e2e.py -k full_width
    python -m pytest -m slow -s tests/test_torch_inertial_merge_e2e.py -k r13_witness
    python -m pytest -m slow -s tests/test_torch_inertial_merge_e2e.py -k next_frames
    python -m pytest -m slow -s tests/test_torch_inertial_merge_e2e.py -k driver
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.slow

REPO = str(Path(__file__).resolve().parents[1])


def _tracker(impl, scene, repair=True):
    from inertial_long_rig import ref_tracker
    from inertial_merge_rig import repair_r13

    if impl == "reference":
        trk = ref_tracker(scene, chip_smoke.VIL_FEATURES, map_cfg=None)
        return repair_r13(trk) if repair else trk
    from orbslam3_cpp_fork_tpu_torch.runtime.tracker import Tracker

    return Tracker(chip_smoke.inertial_long_config(scene), "cpu")


@pytest.mark.parametrize("impl", ["reference", "port"])
def test_full_width(impl, capsys):
    from inertial_long_rig import modules

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        scene, stamps, Rs, ts, frames, rows = chip_smoke.render_inertial_merge()
        trk = _tracker(impl, scene)
        _, vi, pg, solver = modules(impl)
        rec = chip_smoke.record_inertial_path(trk, vi, pg, solver)
        rep = chip_smoke.drive_inertial_merge(trk, frames, stamps, rows, ts)
        end = chip_smoke.vim_ate(trk, rep["spawn"], rep["dead"], stamps, ts)
    finally:
        torch.set_num_threads(n)
    mid, viba2, f0, _ = chip_smoke.vim_viba2_keyframes(rep, chip_smoke.VIM_JAX_VIBA2_AFTER_T0)
    with capsys.disabled():
        chip_smoke.inertial_path_lines(f"inertial merge CPU {impl}", rec, Rs, ts, trk.loop_closer.events)
        print(f"\ninertial merge CPU, {impl}: spawns and resets "
              f"{[(r['frame'], r['kind'], r['map_id'], r['kfs'], r['stage']) for r in rep['spawn']]}; maps seen "
              f"{rep['maps_seen']}; map {mid}'s stages at frames {rep['stages'].get(mid)}, imu_t0 frame {f0}, VIBA2 "
              f"at frame {viba2} ({None if viba2 is None else viba2 - f0} frames after imu_t0); welds "
              f"{[(r['frame'], r['src'], r['dst'], r['kfs'], r['s'], r['tilt_deg']) for r in rep['welds']]}; "
              f"at the weld {rep['weld']}; tracked {rep['tracked']} of {rep['n_outside']} outside the blind "
              f"stretches; {trk.atlas.n_maps()} map(s), state {trk.state.name}, stage {trk.map.imu_stage} at the end; "
              f"at the end {end} (ate: the poses tracked while OK in a live map; ate_all: with the frames the reset "
              f"discarded, ROADMAP R24); {rep['seconds']:.0f} s")
    assert rep["welds"] and [r["kind"] for r in rep["spawn"]] == ["spawn", "reset"]


def test_r13_witness(capsys):
    """ROADMAP R13 on this scene: the reference without the repair loses
    the reset map before its IMU init, at fewer than 10 keyframes, and resets
    it again."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        last = chip_smoke.VIM_BLIND[1][1] + 60
        scene, stamps, Rs, ts, frames, rows = chip_smoke.render_inertial_merge(n_frames=last)
        trk = _tracker("reference", scene, repair=False)
        rep = chip_smoke.drive_inertial_merge(trk, frames, stamps, rows, ts)
    finally:
        torch.set_num_threads(n)
    kinds = [(r["frame"], r["kind"], r["kfs"]) for r in rep["spawn"]]
    with capsys.disabled():
        print(f"\nthe reference without R13's repair, {last} frames: spawns and resets {kinds}; IMU stage "
              f"{trk.map.imu_stage} at the end")
        print(f"ROADMAP R24: the frames each reset discarded {[r['orphans'] for r in rep['spawn'] if 'orphans' in r]}")
    resets = [r for r in rep["spawn"] if r["kind"] == "reset"]
    assert len(resets) >= 2 and trk.map.imu_stage == 0, "the reset map is lost again before its IMU init (R13)"


def test_next_frames_reference_gives_the_stored_outputs(capsys):
    """The reference loaded with state "after" and stepped through the
    stored next frames gives the outputs the rig stored (within 1e-5: the
    rig runs in a plain process, pytest's conftest sets XLA flags)."""
    from inertial_merge_rig import STATES, load_states, next_frames, scene_and_frames

    states, _ = load_states(STATES)
    S = states["after"]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = next_frames("reference", scene_and_frames(render=False)[0], S)
    finally:
        torch.set_num_threads(n)
    for j, (r, g) in enumerate(zip(S["reference_next"], got)):
        with capsys.disabled():
            print(f"\nframe +{j + 1}: stored {r['state']}, now {g['state']}; pose apart "
                  f"{np.abs(g['T'] - r['T']).max():.2e}")
        assert (g["state"], g["kfs"]) == (r["state"], r["kfs"])
        assert np.abs(g["T"] - r["T"]).max() <= 1e-5
        for k in ("cur_v", "cur_bg", "cur_ba"):
            assert np.abs(g[k] - r[k]).max() <= 1e-5, k


def test_driver_merges(tmp_path, capsys):
    """Part B's tree through the reference's driver, three runs at once in
    the default mode; prints each run's merges (its log's "map merge
    complete" lines), spawns and resets, and the poses it exported."""
    scene, stamps, Rs, ts, frames, rows = chip_smoke.render_inertial_merge()
    chip_smoke.write_euroc_tree(tmp_path, "BOB", stamps, frames, imu_rows=np.concatenate(rows[1:]))
    chip_smoke.euroc_settings(tmp_path / "vim.yaml", scene, chip_smoke.VI_FPS,
                              chip_smoke.imu_yaml(chip_smoke.EUROC_T_B_C1))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    logs = [open(tmp_path / f"ref{r}.log", "w") for r in range(3)]
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "examples", "mono_inertial_euroc.py"),
                               str(tmp_path / "vim.yaml"), str(tmp_path), "BOB", "--log-level", "INFO",
                               "--traj", str(tmp_path / f"ref{r}.txt"), "--kf-traj", str(tmp_path / f"ref{r}_kf.txt")],
                              stdout=fh, stderr=subprocess.STDOUT, text=True, env=env)
             for r, fh in enumerate(logs)]
    merges, exported = [], []
    for r, (p, fh) in enumerate(zip(procs, logs)):
        p.wait(timeout=10800)
        fh.close()
        out = (tmp_path / f"ref{r}.log").read_text()
        assert p.returncode == 0, out[-2000:]
        done = [line for line in out.splitlines() if "map merge complete" in line]
        merges.append(len(done))
        exported.append(len((tmp_path / f"ref{r}.txt").read_text().splitlines()))
        with capsys.disabled():
            print(f"\ninertial merge B on the CPU, reference driver run {r}: {exported[-1]} of {len(frames)} poses "
                  f"exported; {len(done)} merges {done}; spawns and "
                  f"resets {[line for line in out.splitlines() if 'spawning' in line or 'resetting' in line]}; IMU "
                  f"lines {[line for line in out.splitlines() if 'VIBA' in line or 'IMU initialized' in line]}")
    with capsys.disabled():
        print(f"\nthe reference driver's merges over three runs: {merges}, fewest {min(merges)}; poses exported "
              f"{exported} of {len(frames)}")
