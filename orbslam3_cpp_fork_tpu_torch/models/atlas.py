"""Atlas: the multi-map container (port of models/atlas.py, the single-map
part).

The SLAM session owns a list of maps and tracks in the active one. This port
keeps one map: a second one (`create_new_map`) and welding two maps together
(`merge_into`, the merge of LoopClosing::MergeLocal) are ROADMAP A12.
"""

from __future__ import annotations

from .map_state import MapConfig, MapState


class Atlas:
    def __init__(self, cfg: MapConfig):
        self.cfg = cfg
        self.maps: list[MapState] = [MapState(cfg, map_id=0)]
        self.active_idx = 0

    @property
    def active(self) -> MapState:
        return self.maps[self.active_idx]

    def create_new_map(self) -> MapState:
        """CreateNewMap: keep the old map, activate a fresh one. A second map
        needs the keyframe database's rows per map, keyframe aliases and the
        merge: ROADMAP A12."""
        raise NotImplementedError("a second Atlas map is not ported yet (ROADMAP A12)")

    def n_maps(self) -> int:
        return len(self.maps)

    def merge_into(self, dst_idx: int, src_idx: int, M):
        raise NotImplementedError("merging Atlas maps is not ported yet (ROADMAP A12)")
