"""Per-stage wall-clock accumulation — the REGISTER_TIMES machinery
(include/Tracking.h:190-204, Tracking::PrintTimeStats
src/Tracking.cc:256-515) as a tiny always-on host utility.

Stage names mirror the reference's vectors (orb_extract, stereo_match,
imu_integration, pose_pred, lm_track, new_kf, track_total; local-mapping
counterparts) so per-stage numbers stay comparable."""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np


class StageTimers:
    def __init__(self):
        self.samples: dict[str, list[float]] = defaultdict(list)

    def add(self, stage: str, seconds: float):
        self.samples[stage].append(seconds)

    class _Span:
        def __init__(self, timers, stage):
            self.timers = timers
            self.stage = stage

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.timers.add(self.stage, time.perf_counter() - self.t0)
            return False

    def span(self, stage: str) -> "StageTimers._Span":
        return self._Span(self, stage)

    def summary(self) -> dict[str, dict]:
        out = {}
        for name, xs in self.samples.items():
            a = np.asarray(xs) * 1e3
            out[name] = {
                "count": len(a),
                "mean_ms": float(a.mean()),
                "p50_ms": float(np.percentile(a, 50)),
                "p95_ms": float(np.percentile(a, 95)),
                "max_ms": float(a.max()),
                "total_s": float(a.sum() / 1e3),
            }
        return out
