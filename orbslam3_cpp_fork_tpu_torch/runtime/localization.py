"""Localization-only tracking against a fixed local-map snapshot.

Counterpart of the reference's pipelined per-frame path
(Tracker._track_frame_pipelined) in localization-only mode
(System.activate_localization_mode): each frame runs the fused frame
program once, and the predicted pose, the previous pose and the bound
mask of one frame feed the next as device tensors, so frames chain on the
device with no host round trip. The snapshot never changes, so the slot
remap is the identity. Two-view initialisation, keyframe insertion,
mapping and relocalization are not part of this mode: the caller gives
the first frame's pose.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import get_device
from ..ops.camera import Camera
from ..ops.orb import OrbParams
from .device_step import fused_frame_program

# Reference thresholds (TrackerConfig): min_track_matches, and
# min_localmap_inliers, the acceptance floor `_min_accept_inliers`
# returns when no mapping worker is busy.
MIN_STAGE1 = 20
MIN_OK = 30


@dataclasses.dataclass(frozen=True)
class LocalMap:
    """Device-resident local-map snapshot (padded to capacity L).

    pos (L,3) f32, normal (L,3) f32, mind (L,) f32, maxd (L,) f32,
    desc (L,8) int64 (each a uint32 word), valid (L,) bool.
    """

    pos: torch.Tensor
    normal: torch.Tensor
    mind: torch.Tensor
    maxd: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]


class LocalizationTracker:
    """Track raw frames against a fixed `LocalMap` on `device`.

    `initial_pose` is the first frame's Tcw as (R (3,3), t (3,)) numpy
    arrays (identity by default); the constant-velocity model starts at
    zero velocity.
    """

    def __init__(
        self,
        camera: Camera,
        orb_params: OrbParams,
        local_map: LocalMap,
        device: torch.device,
        initial_pose: tuple[np.ndarray, np.ndarray] | None = None,
        min_stage1: int = MIN_STAGE1,
        min_ok: int = MIN_OK,
    ):
        self.camera = camera
        self.orb_params = orb_params
        self.map = local_map
        self.device = get_device(device)
        if local_map.pos.device != self.device:
            raise ValueError(f"local map on {local_map.pos.device}, tracker on {self.device}")
        self.min_stage1 = min_stage1
        self.min_ok = min_ok
        if initial_pose is None:
            initial_pose = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        R0 = torch.as_tensor(np.asarray(initial_pose[0], np.float32), device=self.device)
        t0 = torch.as_tensor(np.asarray(initial_pose[1], np.float32), device=self.device)
        L = local_map.capacity
        self._chain = dict(
            R_pred=R0, t_pred=t0, R_prev=R0, t_prev=t0,
            bound=torch.zeros(L, dtype=torch.bool, device=self.device),
        )
        self._remap = torch.arange(L, dtype=torch.int64, device=self.device)
        self.last: dict | None = None  # the last frame program's outputs
        self.stamps: list[float] = []
        self.poses: list[torch.Tensor] = []  # (4,4) Tcw per frame, on device
        self.oks: list[torch.Tensor] = []

    def _upload(self, img) -> torch.Tensor:
        if isinstance(img, torch.Tensor):
            return img.to(self.device)
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        host = torch.from_numpy(np.ascontiguousarray(img))
        if self.device.type == "cuda":
            # Pinned source + non-blocking copy: the upload does not wait
            # for the previous frame's work.
            return host.pin_memory().to(self.device, non_blocking=True)
        return host

    def track(self, img_u8, ts: float) -> torch.Tensor:
        """Track one raw (H,W) frame; returns its Tcw (4,4) on the device.

        A frame with fewer than `min_ok` inliers keeps the predicted pose
        (its `ok` output is False).
        """
        img = self._upload(img_u8)
        h, w = img.shape
        ch, m, cam = self._chain, self.map, self.camera
        out = fused_frame_program(
            img, cam,
            ch["R_pred"], ch["t_pred"], ch["R_prev"], ch["t_prev"],
            m.pos, m.normal, m.mind, m.maxd, m.desc, m.valid,
            ch["bound"], self._remap,
            self.min_stage1, self.min_ok,
            cam.fx, cam.fy, cam.cx, cam.cy, float(w), float(h),
            orb_params=self.orb_params,
        )
        self._chain = dict(
            R_pred=out["R_pred_next"], t_pred=out["t_pred_next"],
            R_prev=out["R"], t_prev=out["t"], bound=out["bound"],
        )
        self.last = out
        T = torch.eye(4, dtype=torch.float32, device=self.device)
        T[:3, :3] = out["R"]
        T[:3, 3] = out["t"]
        self.stamps.append(float(ts))
        self.poses.append(T)
        self.oks.append(out["ok"])
        return T

    def trajectory(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(stamps (T,), Tcw (T,4,4), ok (T,)) as numpy (one host sync)."""
        if not self.poses:
            return np.zeros(0), np.zeros((0, 4, 4), np.float32), np.zeros(0, bool)
        return (
            np.asarray(self.stamps),
            torch.stack(self.poses).cpu().numpy(),
            torch.stack(self.oks).cpu().numpy(),
        )
