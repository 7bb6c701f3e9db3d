"""The revisit sweep of tests/test_torch_loop_e2e.py in the default mode:
mapping worker, loop worker and the global BA on its own thread (~60 s on
one CPU thread; a file of its own so that the test workers split the two
runs). Slow: six such runs at once beside CPU-bound processes, which shows
what the mode loses when its threads are starved (PERF.md)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu_torch.utils.evaluation import align_umeyama, ate_rmse
from test_torch_loop_e2e import SWEEP_ATE_M, revisit_run, sweep_tracker, track_sweep

import chip_smoke  # noqa: E402  (on the path through test_torch_loop_e2e)

BURN = "import torch\ntorch.set_num_threads(4)\na = torch.randn(1024, 1024)\nwhile True:\n    a @ a"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_revisit_closes_a_loop_and_relocalizes_async():
    revisit_run("async")


def _loaded_run():
    """One default-mode sweep: the frames where a map correction dropped
    the frames in flight or a pipelined frame failed, the error of each pose
    recorded while not OK (ROADMAP R8) after the Sim(3) that aligns the
    tracked poses, and the scale-aligned ATE over every exported pose and
    over the tracked ones."""
    torch.set_num_threads(1)
    scene, Rs, ts, trk, dead = sweep_tracker("async")
    try:
        track_sweep(trk, scene, Rs, ts)
        ts_est, Twc = trk.export_trajectory()
    finally:
        trk.worker.stop()
        trk.loop_worker.stop()
    stamps = np.arange(len(Rs)) * 0.05
    keep = chip_smoke.tracked_mask(ts_est, dead)
    idx = np.round(ts_est / 0.05).astype(int)
    s, R, t = align_umeyama(Twc[keep, :3, 3], ts[idx[keep]], True)
    err = np.linalg.norm(s * Twc[:, :3, 3] @ R.T + t - ts[idx], axis=1)
    return dict(
        events={int(f): c for f, c in trk.frame_causes.items()
                if any(x.startswith(("map_correction", "pipeline_fail")) for x in c)},
        lost=trk.n_lost_events, dead={int(i): round(float(e), 3) for i, e, k in zip(idx, err, keep) if not k},
        ate=ate_rmse(ts_est, Twc[:, :3, 3], stamps, ts).rmse_scaled,
        ate_tracked=ate_rmse(ts_est[keep], Twc[keep, :3, 3], stamps, ts).rmse_scaled,
    )


@pytest.mark.slow
def test_default_mode_under_load():
    """Six default-mode sweeps at once, as the tier-1 command's six workers,
    beside two four-thread matrix products (the reference's XLA tests
    compile on every core): minutes. Prints what each run lost. Every run
    keeps the poses it tracked within the default mode's bound; a run fails
    test_revisit_closes_a_loop_and_relocalizes_async when, after the loop
    correction drops the frames in flight, the map is lost and a
    dead-reckoned pose is exported."""
    tests = str(Path(__file__).resolve().parent)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": os.pathsep.join([str(Path(tests).parent), tests])}
    burners = [subprocess.Popen([sys.executable, "-c", BURN], env=env) for _ in range(2)]
    try:
        procs = [subprocess.Popen([sys.executable, __file__], stdout=subprocess.PIPE, text=True, env=env)
                 for _ in range(6)]
        runs = [json.loads(p.communicate(timeout=1200)[0].strip().splitlines()[-1]) for p in procs]
    finally:
        for b in burners:
            b.kill()
            b.wait()
    bound = chip_smoke.ASYNC_ATE_FACTOR * SWEEP_ATE_M + chip_smoke.ASYNC_ATE_SLACK_M
    for r in runs:
        print(json.dumps(r))
    print(f"runs over the bound {bound:.2f} m: {sum(r['ate'] >= bound for r in runs)} of {len(runs)}; with a loss "
          f"{sum(r['lost'] > 0 for r in runs)}; with a dead-reckoned pose exported {sum(bool(r['dead']) for r in runs)}")
    assert all(r["ate_tracked"] < bound for r in runs)


if __name__ == "__main__":
    print(json.dumps(_loaded_run()))
