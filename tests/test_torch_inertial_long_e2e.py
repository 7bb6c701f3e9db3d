"""chip_smoke.py's inertial long phase on the CPU (slow): the numbers behind
its gates.

`-k full_width` runs part A's inputs (the scene at 752x480 with 1,000
features on EuRoC's camera rig, 360 frames, the reference's default ladder,
loop closing and the global BA on, synchronous) through the reference and
through the port, one torch thread each, and prints each run's IMU stages,
VIBA2 frame, ScaleRefinement calls, loops and scale-aligned ATE
(chip_smoke.VIL_JAX_ATE_M, VIL_PORT_ATE_M, VIL_JAX_VIBA2_FRAME,
VIL_JAX_REFINEMENTS). `-k driver` writes part B's EuRoC tree and runs the
reference's examples/mono_inertial_euroc.py on it three times at once in the
default mode (subprocesses), and prints the loops each closed
(chip_smoke.VIL_JAX_DRIVER_LOOPS is the fewest):

    python -m pytest -m slow -s tests/test_torch_inertial_long_e2e.py -k full_width
    python -m pytest -m slow -s tests/test_torch_inertial_long_e2e.py -k driver
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
    from inertial_long_rig import modules, ref_tracker
    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        scene, stamps, Rs, ts, frames, rows = chip_smoke.render_inertial_long()
        if impl == "reference":
            trk = ref_tracker(scene, chip_smoke.VIL_FEATURES, map_cfg=None)
        else:
            from orbslam3_cpp_fork_tpu_torch.runtime.tracker import Tracker

            trk = Tracker(chip_smoke.inertial_long_config(scene), "cpu")
        _, vi, pg, solver = modules(impl)
        rec = chip_smoke.record_inertial_path(trk, vi, pg, solver)
        stages, tracked = {}, 0
        for i, f in enumerate(frames):
            tracked += trk.track(f, float(stamps[i]), imu=rows[i]) is not None
            stages.setdefault(int(trk.map.imu_stage), i)
        ts_est, Twc = trk.export_trajectory()
        ate = ate_rmse(ts_est, Twc[:, :3, 3], stamps, ts)
    finally:
        torch.set_num_threads(n)
    loops = [e for e in trk.loop_closer.events if e["kind"] == "loop"]
    with capsys.disabled():
        chip_smoke.inertial_path_lines(f"inertial long CPU {impl}", rec, Rs, ts, trk.loop_closer.events)
        print(f"\ninertial long CPU, {impl}: stages at frames {stages}, {tracked}/{len(frames)} tracked, state "
              f"{trk.state.name}; VIBA2 at frame {stages.get(3)}; ScaleRefinement calls {len(rec['refine'])}; loops "
              f"{[(e['kf_frame'], e['match_frame']) for e in loops]}; global BAs after them "
              f"{[b['kind'] for b in rec['gba']]}; scale {ate.scale!r}, scale-aligned ATE {ate.rmse_scaled!r} m")
    assert trk.map.imu_stage == 3 and loops and rec["refine"]


def test_driver_loops(tmp_path, capsys):
    """Part B's tree through the reference's driver, three runs at once in
    the default mode; prints each run's loops (its log's "closing loop"
    lines), its IMU init and poses exported."""
    k = chip_smoke.VIL_DRIVER_FRAMES
    scene, stamps, Rs, ts, frames, rows = chip_smoke.render_inertial_long(n_frames=k)
    chip_smoke.write_euroc_tree(tmp_path, "BOB", stamps, frames, imu_rows=np.concatenate(rows[1:]))
    chip_smoke.euroc_settings(tmp_path / "vil.yaml", scene, chip_smoke.VI_FPS,
                              chip_smoke.imu_yaml(chip_smoke.EUROC_T_B_C1))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    logs = [open(tmp_path / f"ref{r}.log", "w") for r in range(3)]
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "examples", "mono_inertial_euroc.py"),
                               str(tmp_path / "vil.yaml"), str(tmp_path), "BOB", "--log-level", "INFO",
                               "--traj", str(tmp_path / f"ref{r}.txt"), "--kf-traj", str(tmp_path / f"ref{r}_kf.txt")],
                              stdout=fh, stderr=subprocess.STDOUT, text=True, env=env)
             for r, fh in enumerate(logs)]
    loops = []
    for r, (p, fh) in enumerate(zip(procs, logs)):
        p.wait(timeout=7200)
        fh.close()
        out = (tmp_path / f"ref{r}.log").read_text()
        assert p.returncode == 0, out[-2000:]
        closing = [line for line in out.splitlines() if "closing loop" in line]
        loops.append(len(closing))
        with capsys.disabled():
            print(f"\ninertial long B on the CPU, reference driver run {r}: {len(closing)} loops {closing}; "
                  f"IMU lines {[line for line in out.splitlines() if 'VIBA' in line or 'IMU initialized' in line]}")
    with capsys.disabled():
        print(f"\nthe reference driver's loops over three runs: {loops}, fewest {min(loops)}")
