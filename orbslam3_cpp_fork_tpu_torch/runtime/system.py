"""System facade: the library's top-level entry point (port of
runtime/system.py, monocular part).

Owns the tracker; exposes the per-frame `track_monocular` call with input
pre-processing (RGB -> gray, resize with the camera scaled to match), state
queries, trajectory export in TUM/KITTI formats and `shutdown`, which
flushes and stops the mapping and loop-closing workers and joins a global BA
in flight. Loop closing is on by default, as in the reference. Stereo, RGB-D, inertial input, the
viewers, Atlas save/load and localization mode raise `NotImplementedError`
naming their ROADMAP item, as the tracker does.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..ops.image import resize_bilinear
from ..ops.orb import OrbParams
from ..utils import timers as timers_mod
from ..utils.settings import Settings, load_settings
from ..utils.trajectory import write_kitti, write_tum
from .tracker import Sensor, Tracker, TrackerConfig, TrackState

log = logging.getLogger("orbslam3_torch.system")


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


class System:
    """System(settings, sensor) -> track_monocular(...) -> shutdown().

    `settings` is a Settings object or a path to a "File.version 1.0" YAML
    (the reference's per-dataset configs). The tracker runs on the card
    unless `device` says "cpu"."""

    def __init__(
        self,
        settings: Settings | str,
        sensor: Sensor = Sensor.MONOCULAR,
        use_viewer: bool = False,
        load_atlas: str | None = None,
        async_mapping: bool = True,
        live_viewer: bool = False,
        enable_loop_closing: bool = True,
        device: str | torch.device = "cuda",
    ):
        if isinstance(settings, str):
            settings = load_settings(settings)
        if sensor != Sensor.MONOCULAR:
            raise _not_ported(f"sensor {sensor.name}", "A13" if sensor.name.startswith("IMU") else "A11")
        if use_viewer or live_viewer:
            raise _not_ported("the viewers", "A15")
        if load_atlas or settings.load_atlas or settings.save_atlas:
            raise _not_ported("Atlas save/load", "A12")
        self.settings = settings
        self.sensor = sensor
        s = settings
        width = s.new_width or s.width
        height = s.new_height or s.height
        self._resize = (height, width) if (s.new_width or s.new_height) else None
        self._scale_x = width / s.width
        self._scale_y = height / s.height
        cam = s.camera
        if self._resize:
            cam = cam.scaled(self._scale_x, self._scale_y)
        cfg = TrackerConfig(
            camera=cam,
            width=width,
            height=height,
            sensor=sensor,
            orb=OrbParams(
                n_features=s.n_features,
                n_levels=s.n_levels,
                scale_factor=s.scale_factor,
                th_fast_high=float(s.ini_th_fast),
                th_fast_low=float(s.min_th_fast),
            ),
            bf=(s.bf or 0.0) * self._scale_x,
            kf_max_interval=int(round(s.fps)) if s.fps else 30,
            async_mapping=async_mapping,
            enable_loop_closing=enable_loop_closing,
        )
        self.tracker = Tracker(cfg, device)
        self.timers = timers_mod.StageTimers()
        self._shutdown = False
        self._last_big_change = 0

    # ------------------------------------------------------------------
    # Per-frame entry point (System::TrackMonocular)
    # ------------------------------------------------------------------

    def _preprocess(self, img: np.ndarray) -> np.ndarray:
        if img.ndim == 3:  # RGB/BGR -> gray (cvtColor in Track*)
            img = img @ np.array([0.299, 0.587, 0.114], img.dtype)
        if self._resize is not None and img.shape != self._resize:
            dev = self.tracker.device
            img = resize_bilinear(torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(dev), self._resize)
            img = img.cpu().numpy()
        return np.ascontiguousarray(img, np.float32)

    def track_monocular(self, img: np.ndarray, timestamp: float) -> np.ndarray | None:
        if self._shutdown:
            raise RuntimeError("System was shut down")
        t0 = time.perf_counter()
        T = self.tracker.track(self._preprocess(img), timestamp)
        self.timers.add("track_total", time.perf_counter() - t0)
        return T

    def track_stereo(self, *args, **kw):
        raise _not_ported("stereo tracking", "A11")

    def track_rgbd(self, *args, **kw):
        raise _not_ported("RGB-D tracking", "A11")

    # ------------------------------------------------------------------
    # State (GetTrackingState, MapChanged, GetTracked*)
    # ------------------------------------------------------------------

    def activate_localization_mode(self):
        """Camera-only tracking; keyframe insertion (and so mapping) pauses
        (System::ActivateLocalizationMode)."""
        self.tracker.flush_mapping()
        self.tracker.localization_only = True

    def deactivate_localization_mode(self):
        self.tracker.localization_only = False

    def get_tracking_state(self) -> TrackState:
        return self.tracker.state

    def is_lost(self) -> bool:
        return self.tracker.state in (TrackState.LOST, TrackState.RECENTLY_LOST)

    def is_shutdown(self) -> bool:
        return self._shutdown

    @property
    def n_loops_closed(self) -> int:
        lc = self.tracker.loop_closer
        return lc.n_loops_closed if lc is not None else 0

    def map_changed(self) -> bool:
        """System::MapChanged: true once per big map change (loop closure,
        global BA)."""
        idx = self.tracker.map.big_change_idx
        if idx > self._last_big_change:
            self._last_big_change = idx
            return True
        return False

    def get_image_scale(self) -> float:
        """System::GetImageScale: resize factor applied to inputs."""
        return float(self._scale_x)

    def get_tracked_map_points(self) -> np.ndarray:
        """Landmark indices bound to the current frame's features, -1 where
        unbound (System::GetTrackedMapPoints)."""
        f = self.tracker.last
        if f is None:
            return np.zeros(0, np.int32)
        return f.lm_idx.copy()

    def get_tracked_keypoints_un(self) -> np.ndarray:
        """Undistorted keypoints of the current frame (N,2)
        (System::GetTrackedKeyPointsUn)."""
        f = self.tracker.last
        if f is None:
            return np.zeros((0, 2), np.float32)
        return f.xy.copy()

    # ------------------------------------------------------------------
    # Trajectory export (SaveTrajectoryTUM / KITTI)
    # ------------------------------------------------------------------

    def save_trajectory_tum(self, path: str):
        ts, Twc = self.tracker.export_trajectory()
        write_tum(path, ts, Twc)

    def save_keyframe_trajectory_tum(self, path: str):
        self.tracker.flush_mapping()
        m = self.tracker.map
        ks = np.nonzero(m.kf_valid)[0]
        ks = ks[np.argsort(m.kf_timestamp[ks])]
        Twc = np.tile(np.eye(4), (len(ks), 1, 1))
        for i, k in enumerate(ks):
            Twc[i, :3, :3] = m.kf_R[k].T
            Twc[i, :3, 3] = -m.kf_R[k].T @ m.kf_t[k]
        write_tum(path, m.kf_timestamp[ks], Twc)

    def save_trajectory_kitti(self, path: str):
        _, Twc = self.tracker.export_trajectory()
        write_kitti(path, Twc)

    def save_atlas(self, path: str):
        raise _not_ported("Atlas save/load", "A12")

    # ------------------------------------------------------------------
    # Shutdown
    # ------------------------------------------------------------------

    def shutdown(self) -> dict:
        """System::Shutdown: retire the frames in flight, flush and stop the
        mapping worker, then the loop worker, then join the global BA (a
        failure of any of their threads is re-raised here, after every thread
        has been stopped), log and return the timing stats."""
        tr = self.tracker
        try:
            tr._drain_pipeline()
        finally:
            try:
                if tr.worker is not None:
                    worker, tr.worker = tr.worker, None
                    worker.stop()
            finally:
                try:
                    if tr.loop_worker is not None:
                        loop_worker, tr.loop_worker = tr.loop_worker, None
                        loop_worker.stop()
                finally:
                    tr._join_global_ba()
        stats = {**self.timers.summary(), **tr.timers.summary()}
        for name, s in stats.items():
            log.info("%-16s mean %.2f ms  p95 %.2f ms  (%d calls)", name, s["mean_ms"], s["p95_ms"], s["count"])
        self._shutdown = True
        return stats
