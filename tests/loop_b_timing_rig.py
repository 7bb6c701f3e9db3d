"""Loop B of chip_smoke.py (the default mode on the loop scene) repeated on a
CUDA card beside the smoke's three child processes, with a delay added
before each tracked frame and each mapping step, to see which outcomes the
threads' timing gives: the frames tracked, the loop's keyframes and Sim(3)
scale, the loss events, and the ATE of the poses tracked while OK against
loop B's bound (ROADMAP R25, R26).

    python tests/loop_b_timing_rig.py OUT.jsonl [SECONDS]

Each run appends one JSON line to OUT.jsonl and prints its summary. The
delays cycle through PLAN (seconds a frame, seconds a mapping step) until
SECONDS (default 600) have passed. Needs one card.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

PLAN = [(0.0, 0.0), (0.02, 0.05), (0.01, 0.05), (0.0, 0.05), (0.03, 0.0), (0.0, 0.1), (0.005, 0.05), (0.02, 0.03)]


class _Grab(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.msgs = []

    def emit(self, record):
        self.msgs.append(record.getMessage())


def run_b(dev, scene, Rs, ts, frames, orb_params, bound, dt, dm):
    """One loop B run with the delays; returns its record."""
    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

    grab = _Grab()
    logging.getLogger().addHandler(grab)
    system = cs.make_system(dev, scene, orb_params, enable_loop_closing=True)
    trk = system.tracker
    dead = cs.spy_dead_reckoned(trk)
    step = trk._mapping_step

    def slow_step(*a, **kw):
        time.sleep(dm)
        return step(*a, **kw)

    trk._mapping_step = slow_step
    t0 = time.perf_counter()
    for i, f in enumerate(frames):
        time.sleep(dt)
        system.track_monocular(f, i * 0.05)
    secs = time.perf_counter() - t0
    ts_b, Twc_b = trk.export_trajectory()
    tracked = cs.tracked_mask(ts_b, dead)
    stamps = np.arange(len(frames)) * 0.05
    ate = ate_rmse(ts_b[tracked], Twc_b[tracked, :3, 3], stamps, ts)
    rec = dict(dt=dt, dm=dm, secs=secs, exported=len(ts_b), tracked=int(tracked.sum()), ate=ate.rmse_scaled,
               bound=bound, loss_events=trk.n_lost_events, warnings=len(grab.msgs), loops=[
                   (e["kf"], e["kf_frame"], e["match"], e["match_frame"], e["scale"])
                   for e in trk.loop_closer.events if e["kind"] == "loop"])
    system.shutdown()
    logging.getLogger().removeHandler(grab)
    return rec


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out = Path(argv[0])
    budget = float(argv[1]) if len(argv) > 1 else 600.0
    import torch

    from orbslam3_cpp_fork_tpu_torch.device import get_device
    from orbslam3_cpp_fork_tpu_torch.ops import _kernels
    from orbslam3_cpp_fork_tpu_torch.ops.orb import OrbParams
    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

    if not torch.cuda.is_available():
        print("loop_b_timing_rig: needs a CUDA card", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    dev = get_device()
    for name in _kernels.build_all():
        _kernels.load(name)
    orb_params = OrbParams(n_features=cs.N_FEATURES)
    scene, Rs, ts, frames = cs.render_loop()
    trk, ok, ts_est, Twc, _, _ = cs.run_loop_sync(dev, scene, frames, orb_params)
    ate_a = ate_rmse(ts_est, Twc[:, :3, 3], np.arange(len(frames)) * 0.05, ts).rmse_scaled
    bound = cs.ASYNC_ATE_FACTOR * ate_a + cs.ASYNC_ATE_SLACK_M
    kids = [cs.start_parallel_part(cs.FRAMES), cs.start_parallel_part(cs.FRAMES, "--inertial-long-part"),
            cs.start_parallel_part(cs.FRAMES, "--inertial-merge-part")]
    t0 = time.perf_counter()
    try:
        i = 0
        while time.perf_counter() - t0 < budget:
            rec = run_b(dev, scene, Rs, ts, frames, orb_params, bound, *PLAN[i % len(PLAN)])
            with open(out, "a") as fh:
                fh.write(json.dumps(rec) + "\n")
            print(json.dumps(rec), flush=True)
            i += 1
    finally:
        for proc, *_ in kids:
            proc.kill()
            proc.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
