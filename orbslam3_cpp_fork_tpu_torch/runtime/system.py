"""System facade: the library's top-level entry point (port of
runtime/system.py).

Owns the tracker; exposes the per-frame `track_monocular`, `track_stereo`
and `track_rgbd` calls, each with the IMU rows of an inertial sensor
(`imu=`), with input pre-processing (RGB -> gray, resize with the camera
scaled to match; for an unrectified pinhole stereo rig, rectification by
`remap_bilinear` on the tracker's device with maps computed once on the
host, the IMU extrinsic following the rectifying rotation), state queries,
trajectory export in TUM/KITTI/EuRoC formats (EuRoC in the body frame for an
inertial sensor), Atlas checkpoints (`save_atlas`, `load_atlas=`, and the
settings' System.LoadAtlasFromFile / SaveAtlasToFile), sequence changes and
resets, and `shutdown`, which flushes and stops the mapping and loop-closing
workers and joins a global BA in flight. Loop closing is on by default, as
in the reference. The viewers are the reference's: `use_viewer` writes frame
snapshots and the map's PLY and HTML exports under viewer_out/
(utils/viewer.py), `live_viewer` serves the frame and the map over HTTP on
localhost (utils/live_viewer.py). Both read host copies the tracker already
holds: a frame whose features were never fetched from the device is drawn
without its keypoints rather than fetched.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..ops.camera import Camera
from ..ops.image import remap_bilinear, resize_bilinear
from ..ops.orb import OrbParams
from ..utils import timers as timers_mod
from ..utils.settings import Settings, load_settings
from ..utils.trajectory import write_kitti, write_tum
from . import checkpoint
from .tracker import ImuSettings, Sensor, Tracker, TrackerConfig, TrackState

log = logging.getLogger("orbslam3_torch.system")


def _K(c: Camera) -> np.ndarray:
    return np.array([[c.fx, 0.0, c.cx], [0.0, c.fy, c.cy], [0.0, 0.0, 1.0]])


class System:
    """System(settings, sensor) -> track_monocular / track_stereo /
    track_rgbd(...) -> shutdown().

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
        live_viewer_port: int = 0,
        enable_loop_closing: bool = True,
        device: str | torch.device = "cuda",
    ):
        if isinstance(settings, str):
            settings = load_settings(settings)
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
        cam2 = None
        if s.camera2 is not None:
            cam2 = s.camera2.scaled(self._scale_x, self._scale_y) if self._resize else s.camera2
        # An unrectified pinhole stereo rig: rectification maps computed once
        # and the rectified linear intrinsics (Settings::
        # precomputeRectificationMaps); images are remapped per frame in
        # track_stereo.
        self._rect = None
        self._rect_maps = None
        stereo_sensor = sensor in (Sensor.STEREO, Sensor.IMU_STEREO)
        imu_Tbc = s.imu.Tbc if s.imu is not None else None
        if stereo_sensor and s.left_rect is not None and s.right_rect is not None:
            # The legacy blocks: Tbc is already given in the rectified camera.
            self._rect = self._legacy_rectification(width, height)
        elif stereo_sensor and cam2 is not None and s.camera_type == "PinHole":
            from ..utils.rectify import stereo_rectify

            self._rect = stereo_rectify(
                _K(cam), np.asarray(cam.dist, np.float64), _K(cam2), np.asarray(cam2.dist, np.float64),
                np.asarray(s.Tlr, np.float64), (height, width),
            )
            K_new = self._rect.K_new
            cam = Camera.pinhole(K_new[0, 0], K_new[1, 1], K_new[0, 2], K_new[1, 2])
            # Rectification rotates camera 1 by R1: the body-from-camera
            # extrinsic follows (Tbc = Tbc * T_r1_u1^-1, src/Settings.cc:524-530).
            if imu_Tbc is not None:
                T_u1_r1 = np.eye(4)
                T_u1_r1[:3, :3] = np.asarray(self._rect.R1).T
                imu_Tbc = np.asarray(imu_Tbc, np.float64) @ T_u1_r1
        imu_cfg = None
        if sensor in (Sensor.IMU_MONOCULAR, Sensor.IMU_STEREO, Sensor.IMU_RGBD):
            if s.imu is None:
                raise ValueError("inertial sensor requires IMU settings")
            imu_cfg = ImuSettings(
                noise_gyro=s.imu.noise_gyro, noise_acc=s.imu.noise_acc, walk_gyro=s.imu.walk_gyro,
                walk_acc=s.imu.walk_acc, freq=s.imu.frequency, Tbc=np.asarray(imu_Tbc, np.float32),
            )
        bf = (s.bf or 0.0) * self._scale_x
        if self._rect is not None:
            bf = self._rect.bf
        # An unrectified fisheye rig (TUM-VI): Camera2 + Stereo.T_c1_c2
        # (left-from-right). The tracker takes T_rl, its inverse, and bf from
        # the baseline when the settings give none.
        fisheye_kw = {}
        if stereo_sensor and cam2 is not None and s.camera_type == "KannalaBrandt8":
            T12 = np.asarray(s.Tlr, np.float64)  # x_l = R12 x_r + t12
            R_rl = T12[:3, :3].T
            t_rl = -R_rl @ T12[:3, 3]
            if not bf:
                bf = float(np.linalg.norm(T12[:3, 3])) * cam.fx
            fisheye_kw = dict(
                camera2=cam2, R_rl=R_rl.astype(np.float32), t_rl=t_rl.astype(np.float32),
                lapping_l=tuple(s.lapping1 or (0.0, 1e9)), lapping_r=tuple(s.lapping2 or (0.0, 1e9)),
            )
        # mThDepth = bf * ThDepth / fx.
        th_depth = bf * s.stereo_th_depth / cam.fx if s.stereo_th_depth and bf else 0.0
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
            bf=bf,
            th_depth=th_depth,
            depth_factor=1.0 / s.depth_map_factor if s.depth_map_factor else 1.0,
            imu=imu_cfg,
            kf_max_interval=int(round(s.fps)) if s.fps else 30,
            async_mapping=async_mapping,
            enable_loop_closing=enable_loop_closing,
            **fisheye_kw,
        )
        self.tracker = Tracker(cfg, device)
        # Rendering is offline: snapshots and map exports under viewer_out/,
        # the headless counterpart of the Pangolin viewer thread
        # (src/System.cc:259).
        self.use_viewer = use_viewer
        self.viewer = None
        if use_viewer:
            from ..utils.viewer import Viewer

            self.viewer = Viewer("viewer_out", frame_every=30)
        # Live viewer: the same over HTTP on localhost (utils/live_viewer.py).
        self.live_viewer = None
        if live_viewer:
            from ..utils.live_viewer import LiveViewer

            self.live_viewer = LiveViewer(port=live_viewer_port)
            self.live_viewer.state_provider = self._live_state
        self.timers = timers_mod.StageTimers()
        self._shutdown = False
        self._last_big_change = 0
        if load_atlas or s.load_atlas:
            self._load_atlas(load_atlas or s.load_atlas)

    def _legacy_rectification(self, width: int, height: int):
        """The pre-1.0 LEFT./RIGHT. K, D, R, P blocks: Camera.* already holds
        the rectified intrinsics; the maps come from the blocks."""
        from ..utils.rectify import StereoRectification, init_undistort_rectify_map

        s = self.settings
        S = np.diag([self._scale_x, self._scale_y, 1.0])
        lr, rr = s.left_rect, s.right_rect
        P1 = S @ np.asarray(lr["P"], np.float64)
        P2 = S @ np.asarray(rr["P"], np.float64)
        m1 = init_undistort_rectify_map(S @ np.asarray(lr["K"], np.float64), lr["D"], np.asarray(lr["R"], np.float64),
                                        P1[:3, :3], (height, width))
        m2 = init_undistort_rectify_map(S @ np.asarray(rr["K"], np.float64), rr["D"], np.asarray(rr["R"], np.float64),
                                        P2[:3, :3], (height, width))
        bf = (s.bf or 0.0) * self._scale_x or -float(P2[0, 3])
        return StereoRectification(
            R1=np.asarray(lr["R"], np.float64), R2=np.asarray(rr["R"], np.float64), K_new=P1[:3, :3],
            baseline=bf / float(P1[0, 0]), bf=bf, map1_x=m1[0], map1_y=m1[1], map2_x=m2[0], map2_y=m2[1],
        )

    # ------------------------------------------------------------------
    # Per-frame entry points (System::TrackMonocular / Stereo / RGBD)
    # ------------------------------------------------------------------

    def _preprocess(self, img: np.ndarray) -> np.ndarray:
        if img.ndim == 3:  # RGB/BGR -> gray (cvtColor in Track*)
            img = img @ np.array([0.299, 0.587, 0.114], img.dtype)
        if self._resize is not None and img.shape != self._resize:
            dev = self.tracker.device
            img = resize_bilinear(torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(dev), self._resize)
            img = img.cpu().numpy()
        return np.ascontiguousarray(img, np.float32)

    def track_monocular(self, img: np.ndarray, timestamp: float, imu: np.ndarray | None = None) -> np.ndarray | None:
        """A frame of a monocular sensor; `imu` (M,7) rows [t, acc, gyro]
        since the previous frame for IMU_MONOCULAR."""
        self._check_sensor(Sensor.MONOCULAR)
        t0 = time.perf_counter()
        img = self._preprocess(img)
        T = self.tracker.track(img, timestamp, imu=imu)
        self.timers.add("track_total", time.perf_counter() - t0)
        self._viewer_update(img)
        return T

    def _check_sensor(self, sensor: Sensor) -> None:
        """`sensor` is the visual kind of the frame; its inertial variant is
        accepted too."""
        if self._shutdown:
            raise RuntimeError("System was shut down")
        if self.sensor not in (sensor, Sensor[f"IMU_{sensor.name}"]):
            raise ValueError(f"a {self.sensor.name} System takes no {sensor.name} frames")

    def _remap_pair(self, img_l: np.ndarray, img_r: np.ndarray):
        """Stereo rectification on the tracker's device (the cv::remap calls
        of System::TrackStereo); the maps are uploaded once."""
        dev = self.tracker.device
        if self._rect_maps is None:
            r = self._rect
            self._rect_maps = tuple(
                torch.from_numpy(np.ascontiguousarray(m, np.float32)).to(dev)
                for m in (r.map1_x, r.map1_y, r.map2_x, r.map2_y)
            )
        m1x, m1y, m2x, m2y = self._rect_maps
        out_l = remap_bilinear(torch.from_numpy(img_l).to(dev), m1x, m1y)
        out_r = remap_bilinear(torch.from_numpy(img_r).to(dev), m2x, m2y)
        return out_l.cpu().numpy(), out_r.cpu().numpy()

    def track_stereo(self, img_left: np.ndarray, img_right: np.ndarray, timestamp: float,
                     imu: np.ndarray | None = None) -> np.ndarray | None:
        self._check_sensor(Sensor.STEREO)
        t0 = time.perf_counter()
        img_l, img_r = self._preprocess(img_left), self._preprocess(img_right)
        if self._rect is not None:
            img_l, img_r = self._remap_pair(img_l, img_r)
        T = self.tracker.track_stereo(img_l, img_r, timestamp, imu=imu)
        self.timers.add("track_total", time.perf_counter() - t0)
        self._viewer_update(img_l)
        return T

    def track_rgbd(self, img: np.ndarray, depth: np.ndarray, timestamp: float,
                   imu: np.ndarray | None = None) -> np.ndarray | None:
        self._check_sensor(Sensor.RGBD)
        t0 = time.perf_counter()
        depth = np.asarray(depth, np.float32)
        if self._resize is not None and depth.shape != self._resize:
            dev = self.tracker.device
            depth = resize_bilinear(torch.from_numpy(np.ascontiguousarray(depth)).to(dev), self._resize).cpu().numpy()
        img = self._preprocess(img)
        T = self.tracker.track_rgbd(img, depth, timestamp, imu=imu)
        self.timers.add("track_total", time.perf_counter() - t0)
        self._viewer_update(img)
        return T

    def _viewer_update(self, img: np.ndarray):
        """Hand the frame to the viewers: the image, the current frame's
        keypoints where their host copies exist (none are fetched for the
        viewer) and its bindings."""
        if self.viewer is None and self.live_viewer is None:
            return
        f = self.tracker.last
        if f is None:
            return
        xy, valid = f.host_keypoints()
        tracked = f.lm_idx[: len(valid)] >= 0
        state = self.tracker.state.name
        if self.viewer is not None:
            self.viewer.update(img, xy, valid, tracked, state=state)
        if self.live_viewer is not None:
            self.live_viewer.push_frame(img, xy, valid, tracked, state, f.frame_id)

    def _live_state(self) -> dict:
        """Map snapshot for the live viewer (called on its HTTP thread: a
        short hold of the map lock, numpy copies only)."""
        tr = self.tracker
        with tr.map_lock:
            m = tr.map
            kf = np.nonzero(m.kf_valid)[0]
            kf = kf[np.argsort(m.kf_timestamp[kf])]
            centers = -np.einsum("kji,kj->ki", m.kf_R[kf], m.kf_t[kf])
            pts = m.lm_pos[m.lm_valid].copy()
            n_loops = tr.loop_closer.n_loops_closed if tr.loop_closer else 0
        return {
            "points": pts, "traj": centers,
            "n_keyframes": len(kf), "n_landmarks": len(pts),
            "n_loops": int(n_loops),
        }

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

    def change_dataset(self):
        """System::ChangeDataset: call between the sequences of a
        multi-sequence run."""
        self.tracker.new_dataset()

    def reset(self):
        """System::Reset: stop the workers, drop everything and start over
        with a fresh tracker of the same configuration and device."""
        tr = self.tracker
        self._stop_workers()
        self.tracker = Tracker(tr.cfg, tr.device)
        self._last_big_change = 0

    def reset_active_map(self):
        """System::ResetActiveMap: rebuild a small active map, or keep an
        established one and start a fresh map."""
        self.tracker._spawn_or_reset_map()

    @property
    def atlas(self):
        return self.tracker.atlas

    def is_lost(self) -> bool:
        return self.tracker.state in (TrackState.LOST, TrackState.RECENTLY_LOST)

    def is_shutdown(self) -> bool:
        return self._shutdown

    @property
    def n_merges(self) -> int:
        lc = self.tracker.loop_closer
        return lc.n_merges if lc is not None else 0

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

    def get_time_from_imu_init(self) -> float:
        """Seconds since the active map's IMU clock started, once its IMU is
        initialized (System::GetTimeFromIMUInit); 0.0 before."""
        tr = self.tracker
        m = tr.map
        if not tr.inertial or m.imu_stage < 1 or m.imu_t0 < 0 or tr.last is None:
            return 0.0
        return float(tr.last.timestamp - m.imu_t0)

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

    def _to_body(self, Twc: np.ndarray) -> np.ndarray:
        """Camera-to-world poses -> body-to-world for an inertial sensor."""
        if not self.tracker.inertial:
            return Twc
        Tbc = np.eye(4, dtype=np.float64)
        Tbc[:3, :3] = self.tracker.Rbc
        Tbc[:3, 3] = self.tracker.tbc
        return Twc @ np.linalg.inv(Tbc)[None]

    def save_keyframe_trajectory_euroc(self, path: str):
        """System::SaveKeyFrameTrajectoryEuRoC: keyframe poses, in the body
        frame for an inertial sensor."""
        self.tracker.flush_mapping()
        m = self.tracker.map
        ks = np.nonzero(m.kf_valid)[0]
        ks = ks[np.argsort(m.kf_timestamp[ks])]
        Twc = np.tile(np.eye(4), (len(ks), 1, 1))
        for i, k in enumerate(ks):
            Twc[i, :3, :3] = m.kf_R[k].T
            Twc[i, :3, 3] = -m.kf_R[k].T @ m.kf_t[k]
        write_tum(path, m.kf_timestamp[ks], self._to_body(Twc))

    def save_trajectory_euroc(self, path: str):
        """System::SaveTrajectoryEuRoC: every frame's pose in TUM line
        format, in the body frame for an inertial sensor."""
        ts, Twc = self.tracker.export_trajectory()
        write_tum(path, ts, self._to_body(Twc))

    def save_trajectory_kitti(self, path: str):
        _, Twc = self.tracker.export_trajectory()
        write_kitti(path, Twc)

    # ------------------------------------------------------------------
    # Atlas persistence (SaveAtlas / LoadAtlas)
    # ------------------------------------------------------------------

    def save_atlas(self, path: str):
        """Write every map of the Atlas to one .npz (runtime/checkpoint.py),
        bound to the retrieval codebook's seed and size."""
        self.tracker.flush_mapping()
        kfdb = self.tracker.kfdb
        extra = {"sensor": self.sensor.name, "kfdb_seed": kfdb._seed, "kfdb_n_words": kfdb.n_words}
        with self.tracker.map_lock:
            checkpoint.save_atlas(self.tracker.atlas, path, extra=extra)
        log.info("atlas saved to %s", path)

    def _load_atlas(self, path: str):
        """Resume from a checkpoint: the Atlas replaces the tracker's, the
        keyframe database is rebuilt from the stored descriptors by (map,
        slot), the device keyframe store forgets its rows (the loaded maps
        reuse ids and keyframe generations: ROADMAP R13), and tracking
        resumes LOST, by relocalization."""
        tr = self.tracker
        atlas, extra = checkpoint.load_atlas(path, imu_calib=tr.imu_calib)
        if extra.get("kfdb_seed") is not None and (
            extra["kfdb_seed"] != tr.kfdb._seed or extra["kfdb_n_words"] != tr.kfdb.n_words
        ):
            # The reference refuses an atlas bound to another vocabulary.
            raise ValueError("atlas was built with a different retrieval codebook")
        tr.flush_mapping()
        with tr.map_lock:
            tr.atlas = atlas
            if tr.loop_closer is not None:
                tr.loop_closer.atlas = atlas
            tr._kf_store.invalidate()
            tr._dev_local = None
            tr.kfdb.clear()
            for m in atlas.maps:
                for k in np.nonzero(m.kf_valid)[0]:
                    bits = np.unpackbits(m.kf_desc[k].view(np.uint8), axis=-1, bitorder="little").astype(np.int8)
                    tr.kfdb.add(tr._gid(int(k), m.map_id), bits, m.kf_feat_valid[k])
        tr.state = TrackState.LOST
        tr.last = None
        tr.init_ref = None
        log.info("atlas loaded from %s: %d maps, active map %d (%d KFs)",
                 path, atlas.n_maps(), atlas.active.map_id, atlas.active.n_keyframes())

    # ------------------------------------------------------------------
    # Shutdown
    # ------------------------------------------------------------------

    def shutdown(self, save_atlas_path: str | None = None) -> dict:
        """System::Shutdown: retire the frames in flight, flush and stop the
        mapping worker, then the loop worker, then join the global BA (a
        failure of any of their threads is re-raised here, after every thread
        has been stopped), stop the live viewer, write the offline viewer's
        map exports, write the Atlas if asked (`save_atlas_path` or the
        settings' System.SaveAtlasToFile), log and return the timing stats."""
        try:
            self._stop_workers()
        finally:
            if self.live_viewer is not None:
                self.live_viewer.stop()
                self.live_viewer = None
        if self.viewer is not None:
            m = self.tracker.map
            kf = m.kf_valid  # camera centres c = -R^T t
            centers = -np.einsum("kji,kj->ki", m.kf_R[kf], m.kf_t[kf])
            self.viewer.finalize(m.lm_pos, centers, point_mask=m.lm_valid)
        if save_atlas_path or self.settings.save_atlas:
            self.save_atlas(save_atlas_path or self.settings.save_atlas)
        tr = self.tracker
        stats = {**self.timers.summary(), **tr.timers.summary()}
        for name, s in stats.items():
            log.info("%-16s mean %.2f ms  p95 %.2f ms  (%d calls)", name, s["mean_ms"], s["p95_ms"], s["count"])
        self._shutdown = True
        return stats

    def _stop_workers(self):
        """Retire the frames in flight, stop the mapping and loop workers and
        join the global BA, re-raising the first failure of their threads
        after every one has been stopped."""
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
