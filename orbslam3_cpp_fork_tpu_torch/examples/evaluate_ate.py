"""ATE evaluation CLI — drop-in for evaluation/evaluate_ate_scale.py.

Compares a TUM-format trajectory (t x y z qx qy qz qw per line) against
ground truth and prints the same three numbers the reference script does
(evaluate_ate_scale.py:162-173): ATE RMSE at GT scale, the optimal
scale factor, and ATE RMSE at optimal scale.

Usage: python -m orbslam3_cpp_fork_tpu_torch.examples.evaluate_ate GT.txt CameraTrajectory.txt
"""

import argparse

import numpy as np

from ..utils.evaluation import ate_rmse


def load_tum(path: str):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.replace(",", " ").split()]
            if len(vals) >= 4:
                rows.append(vals[:4])
    a = np.asarray(rows)
    ts = a[:, 0]
    # EuRoC GT files use nanosecond stamps
    if ts.max() > 1e14:
        ts = ts * 1e-9
    return ts, a[:, 1:4]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("ground_truth")
    p.add_argument("estimate")
    p.add_argument("--max-dt", type=float, default=0.02,
                   help="association window in seconds (associate.py)")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    ts_gt, pos_gt = load_tum(args.ground_truth)
    ts_est, pos_est = load_tum(args.estimate)
    r = ate_rmse(ts_est, pos_est, ts_gt, pos_gt, max_dt=args.max_dt)
    if args.verbose:
        print(f"compared_pose_pairs {r.n_pairs} pairs")
    # Matches the reference's stdout: rmse (GT scale), scale, rmse (opt scale)
    print(f"{r.rmse:.6f},{r.scale:.6f},{r.rmse_scaled:.6f}")


if __name__ == "__main__":
    main()
