"""chip_smoke.py's stereo inertial long phase on the CPU (slow): the numbers
behind its gates.

`-k full_width` runs part A's inputs (the scene at 752x480 with 1,200
features as pairs of EuRoC's baseline on EuRoC's camera rig, 360 pairs, the
reference's default ladder, loop closing and the global BA on, synchronous)
through the reference and through the port, one torch thread each, and
prints each run's IMU init, stages, whole-chain solves with their route and
stereo rows, ScaleRefinement calls, loops and unscaled ATE
(chip_smoke.SIL_JAX_ATE_M, SIL_PORT_ATE_M, SIL_JAX_VIBA2_FRAME). `-k driver`
writes part B's EuRoC tree and runs the reference's
examples/stereo_inertial_euroc.py on it three times at once in the default
mode (subprocesses), and prints the IMU stages each reached and the loops
each closed (chip_smoke.SIL_JAX_DRIVER_STAGE is the lowest stage,
SIL_JAX_DRIVER_LOOPS the fewest loops):

    python -m pytest -m slow -s tests/test_torch_stereo_inertial_long_e2e.py -k full_width
    python -m pytest -m slow -s tests/test_torch_stereo_inertial_long_e2e.py -k driver
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


@pytest.mark.parametrize("impl", ["reference", "port"])
def test_full_width(impl, capsys):
    from inertial_long_rig import modules
    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse
    from stereo_inertial_long_rig import ref_tracker

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        scene, stamps, Rs, ts, pairs, rows = chip_smoke.render_stereo_inertial_long()
        if impl == "reference":
            trk = ref_tracker(scene, chip_smoke.SIL_FEATURES, map_cfg=None)
        else:
            from orbslam3_cpp_fork_tpu_torch.runtime.tracker import Tracker

            trk = Tracker(chip_smoke.stereo_inertial_long_config(scene), "cpu")
        _, vi, pg, solver = modules(impl)
        rec = chip_smoke.record_inertial_path(trk, vi, pg, solver)
        stages, tracked = {}, 0
        for i, (left, right) in enumerate(pairs):
            tracked += trk.track_stereo(left, right, float(stamps[i]), imu=rows[i]) is not None
            stages.setdefault(int(trk.map.imu_stage), i)
        ts_est, Twc = trk.export_trajectory()
        ate = ate_rmse(ts_est, Twc[:, :3, 3], stamps, ts)
    finally:
        torch.set_num_threads(n)
    loops = [e for e in trk.loop_closer.events if e["kind"] == "loop"]
    with capsys.disabled():
        chip_smoke.inertial_path_lines(f"stereo inertial long CPU {impl}", rec, Rs, ts, trk.loop_closer.events)
        for r in rec["fiba"]:
            print(f"stereo inertial long CPU {impl}: FullInertialBA at frame {r['frame']} ({r['iters']} iterations, "
                  f"after a loop: {r['loop_gba']}): {chip_smoke.solve_line(r)}")
        inits = [(r["frame"], r["fix_scale"], r["ok"], r["s"]) for r in rec["init"]]
        print(f"\nstereo inertial long CPU, {impl}: IMU inits {inits}; stages at frames {stages}, "
              f"{tracked}/{len(pairs)} tracked, state {trk.state.name}, keyframes {trk.map.n_keyframes()}, landmarks "
              f"{trk.map.n_landmarks()}; VIBA2 at frame {stages.get(3)}; ScaleRefinement calls {len(rec['refine'])}; "
              f"loops {[(e['kf_frame'], e['match_frame']) for e in loops]}; "
              f"global BAs after them {[b['kind'] for b in rec['gba']]}; scale {ate.scale!r}, unscaled ATE "
              f"{ate.rmse!r} m (scale-aligned {ate.rmse_scaled!r})")
    assert trk.map.imu_stage == 3 and loops and not rec["refine"]


def test_driver(tmp_path, capsys):
    """Part B's tree through the reference's driver, three runs at once in
    the default mode; prints each run's IMU lines, loops (its log's "closing
    loop" lines) and poses exported."""
    k = chip_smoke.SIL_DRIVER_PAIRS
    scene, stamps, Rs, ts, pairs, rows = chip_smoke.render_stereo_inertial_long(n_frames=k)
    chip_smoke.write_euroc_tree(tmp_path, "SIL", stamps, pairs, imu_rows=np.concatenate(rows[1:]))
    chip_smoke.euroc_settings(
        tmp_path / "sil.yaml", scene, chip_smoke.VI_FPS,
        f"Camera.bf: {chip_smoke.SIL_BASELINE * float(scene.K[0, 0])!r}\nStereo.ThDepth: {chip_smoke.SIL_TH_DEPTH!r}\n"
        + chip_smoke.imu_yaml(chip_smoke.EUROC_T_B_C1), n_features=chip_smoke.SIL_FEATURES)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    logs = [open(tmp_path / f"ref{r}.log", "w") for r in range(3)]
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "examples", "stereo_inertial_euroc.py"),
                               str(tmp_path / "sil.yaml"), str(tmp_path), "SIL", "--log-level", "INFO",
                               "--traj", str(tmp_path / f"ref{r}.txt"), "--kf-traj", str(tmp_path / f"ref{r}_kf.txt")],
                              stdout=fh, stderr=subprocess.STDOUT, text=True, env=env)
             for r, fh in enumerate(logs)]
    loops, stages = [], []
    for r, (p, fh) in enumerate(zip(procs, logs)):
        p.wait(timeout=7200)
        fh.close()
        out = (tmp_path / f"ref{r}.log").read_text()
        assert p.returncode == 0, out[-2000:]
        closing = [line for line in out.splitlines() if "closing loop" in line]
        imu = [line for line in out.splitlines() if "VIBA" in line or "IMU initialized" in line]
        stage = 3 if any("VIBA2" in line for line in imu) else 2 if any("VIBA1" in line for line in imu) else \
            1 if imu else 0
        loops.append(len(closing))
        stages.append(stage)
        n_poses = len((tmp_path / f"ref{r}.txt").read_text().splitlines())
        with capsys.disabled():
            print(f"\nstereo inertial long B on the CPU, reference driver run {r}: highest IMU stage {stage}, "
                  f"{len(closing)} loops {closing}; IMU lines {imu}; {n_poses} poses exported; losses "
                  f"{[line for line in out.splitlines() if 'lost' in line.lower()][:6]}")
    with capsys.disabled():
        print(f"\nthe reference driver over three runs: stages {stages}, lowest {min(stages)}; loops {loops}, "
              f"fewest {min(loops)}")
