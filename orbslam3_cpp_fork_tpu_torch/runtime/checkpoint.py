"""Atlas checkpoint/resume (port of runtime/checkpoint.py; the same format
and version, so either package loads the other's files).

Replaces the Boost-serialization Atlas persistence (System::SaveAtlas /
LoadAtlas, Atlas::PreSave / PostLoad) with one .npz archive:

- every MapState array field is dumped verbatim (the SoA layout is the
  serialization format: no pointer swizzling);
- per-map scalars (map_id, imu_stage, imu_t0) and the Atlas metadata ride in
  a JSON header;
- the vocabulary binding becomes a retrieval-codebook fingerprint (seed and
  word count in `extra`, checked by `System`): a checkpoint loads only into
  a keyframe database built from the same codebook seed and shape.

The keyframe database itself is not stored: it is rebuilt from the stored
keyframe descriptors on load, as the reference re-attaches its database.

The two packages' MapState array fields are the same 45 names, shapes and
types (tests/test_torch_atlas.py holds this), so no field is converted. A
file that lacks a field of this package's MapState, or holds one of another
shape or type, is refused with the field's name.
"""

from __future__ import annotations

import json

import numpy as np

from ..models.atlas import Atlas
from ..models.map_state import MapConfig, MapState

FORMAT_VERSION = 1


def save_atlas(atlas: Atlas, path: str, extra: dict | None = None):
    """Serialize all maps of the Atlas to one .npz file."""
    arrays: dict[str, np.ndarray] = {}
    maps_meta = []
    for i, m in enumerate(atlas.maps):
        fields = {k: v for k, v in vars(m).items() if isinstance(v, np.ndarray)}
        for k, v in fields.items():
            arrays[f"m{i}.{k}"] = v
        maps_meta.append({
            "map_id": m.map_id,
            "imu_stage": m.imu_stage,
            "imu_t0": m.imu_t0,
            "array_fields": sorted(fields.keys()),
        })
    header = {
        "version": FORMAT_VERSION,
        "n_maps": len(atlas.maps),
        "active_idx": atlas.active_idx,
        "next_map_id": atlas._next_map_id,
        "cfg": {
            "max_keyframes": atlas.cfg.max_keyframes,
            "max_landmarks": atlas.cfg.max_landmarks,
            "n_features": atlas.cfg.n_features,
            "imu_cap": atlas.cfg.imu_cap,
        },
        "maps": maps_meta,
        "extra": extra or {},
    }
    arrays["__header__"] = np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_atlas(path: str, imu_calib=None) -> tuple[Atlas, dict]:
    """Rebuild an Atlas from a checkpoint. Returns (atlas, extra)."""
    with np.load(path) as z:
        header = json.loads(bytes(z["__header__"]).decode())
        if header["version"] != FORMAT_VERSION:
            raise ValueError(f"unsupported atlas format {header['version']}")
        cfg = MapConfig(**header["cfg"])
        atlas = Atlas(cfg, imu_calib=imu_calib)
        atlas.maps = []
        for i, meta in enumerate(header["maps"]):
            m = MapState(cfg, map_id=meta["map_id"])
            m._imu_calib = imu_calib
            m.imu_stage = meta["imu_stage"]
            m.imu_t0 = meta["imu_t0"]
            absent = sorted(k for k, v in vars(m).items() if isinstance(v, np.ndarray) and k not in meta["array_fields"])
            if absent:
                raise ValueError(f"checkpoint lacks fields {absent} of map {meta['map_id']}")
            for k in meta["array_fields"]:
                key = f"m{i}.{k}"
                if key not in z.files:
                    raise ValueError(f"checkpoint lacks field {k} of map {meta['map_id']}")
                cur = getattr(m, k, None)
                if not isinstance(cur, np.ndarray):
                    raise ValueError(f"checkpoint field {k} is not a MapState array of this package")
                arr = z[key]
                if cur.shape != arr.shape or cur.dtype != arr.dtype:
                    raise ValueError(
                        f"checkpoint field {k} mismatch: {arr.shape}/{arr.dtype} vs {cur.shape}/{cur.dtype}"
                    )
                setattr(m, k, arr.copy())
            m.mark_obs_dirty()  # the restored obs bypassed the native graph mirror
            atlas.maps.append(m)
    atlas.active_idx = header["active_idx"]
    atlas._next_map_id = header["next_map_id"]
    return atlas, header.get("extra", {})
