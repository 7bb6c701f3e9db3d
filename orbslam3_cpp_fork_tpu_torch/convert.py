"""The state carried across from the reference runtime: camera and
local-map snapshot.

The system has no weights. Its tracking state is the camera and the
local-map snapshot the reference uploads in Tracker._refresh_dev_local:
numpy pos (L,3) f32, normal (L,3) f32, mind (L,) f32, maxd (L,) f32,
desc (L,8) uint32 and valid (L,) bool. Descriptor words stay uint32 at
this numpy boundary and become int64 inside the port, where shifts and
masks behave on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import get_device
from .ops.camera import Camera
from .runtime.localization import LocalMap

SNAPSHOT_KEYS = ("pos", "normal", "mind", "maxd", "desc", "valid")


def local_map_from_numpy(d: dict, device) -> LocalMap:
    """Snapshot dict of numpy arrays -> the port's `LocalMap` on `device`."""
    missing = [k for k in SNAPSHOT_KEYS if k not in d]
    if missing:
        raise KeyError(f"local-map snapshot lacks {missing}")
    desc = np.asarray(d["desc"])
    if desc.dtype != np.uint32 or desc.ndim != 2 or desc.shape[1] != 8:
        raise ValueError(f"desc must be (L,8) uint32, got {desc.dtype} {desc.shape}")
    dev = get_device(device)

    def f32(k):
        return torch.from_numpy(np.ascontiguousarray(d[k], np.float32)).to(dev)

    return LocalMap(
        pos=f32("pos"),
        normal=f32("normal"),
        mind=f32("mind"),
        maxd=f32("maxd"),
        desc=torch.from_numpy(desc.astype(np.int64)).to(dev),
        valid=torch.from_numpy(np.asarray(d["valid"], bool)).to(dev),
    )


def camera_from_numpy(fx, fy, cx, cy, dist=(0.0, 0.0, 0.0, 0.0, 0.0)) -> Camera:
    """Pinhole + radial-tangential camera from plain numbers."""
    return Camera.pinhole(fx, fy, cx, cy, tuple(np.asarray(dist, np.float64).ravel()))
