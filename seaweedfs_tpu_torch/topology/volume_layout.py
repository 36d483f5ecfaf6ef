"""VolumeLayout: writable/readonly tracking per (collection, rp, ttl)
(ref: weed/topology/volume_layout.go)."""

from __future__ import annotations

import random
import threading
from typing import Dict, Optional

from .node import DataNode


class VolumeLayout:
    def __init__(self, replica_placement, ttl, volume_size_limit: int):
        self.replica_placement = replica_placement
        self.ttl = ttl
        self.volume_size_limit = volume_size_limit
        self.vid_to_locations: Dict[int, list[DataNode]] = {}
        self.writables: list[int] = []
        self.oversized: set[int] = set()
        self.readonly: set[int] = set()
        self._lock = threading.RLock()

    def register_volume(self, info: dict, dn: DataNode) -> None:
        vid = int(info["id"])
        with self._lock:
            locs = self.vid_to_locations.setdefault(vid, [])
            if dn not in locs:
                locs.append(dn)
            if info.get("read_only"):
                self.readonly.add(vid)
            else:
                self.readonly.discard(vid)
            if self._is_oversized(info):
                self.oversized.add(vid)
            self._remember_writable(vid, info)

    def unregister_volume(self, info: dict, dn: DataNode) -> None:
        vid = int(info["id"])
        with self._lock:
            locs = self.vid_to_locations.get(vid, [])
            if dn in locs:
                locs.remove(dn)
            if not locs:
                self.vid_to_locations.pop(vid, None)
                self._set_unwritable(vid)
            elif len(locs) < self.replica_placement.copy_count():
                # under-replicated volumes stop taking writes
                self._set_unwritable(vid)

    def _is_oversized(self, info: dict) -> bool:
        return int(info.get("size", 0)) >= self.volume_size_limit

    def _remember_writable(self, vid: int, info: dict) -> None:
        locs = self.vid_to_locations.get(vid, [])
        writable = (
            not info.get("read_only")
            and vid not in self.oversized
            and len(locs) >= self.replica_placement.copy_count()
        )
        if writable:
            if vid not in self.writables:
                self.writables.append(vid)
        else:
            self._set_unwritable(vid)

    def _set_unwritable(self, vid: int) -> None:
        if vid in self.writables:
            self.writables.remove(vid)

    def set_volume_unavailable(self, vid: int, dn: DataNode) -> None:
        with self._lock:
            locs = self.vid_to_locations.get(vid, [])
            if dn in locs:
                locs.remove(dn)
            if len(locs) < self.replica_placement.copy_count():
                self._set_unwritable(vid)
            if not locs:
                self.vid_to_locations.pop(vid, None)

    def set_volume_capacity_full(self, vid: int) -> None:
        with self._lock:
            self.oversized.add(vid)
            self._set_unwritable(vid)

    def lookup(self, vid: int) -> Optional[list[DataNode]]:
        with self._lock:
            locs = self.vid_to_locations.get(vid)
            return list(locs) if locs else None

    def has_writable_volume(self) -> bool:
        with self._lock:
            return len(self.writables) > 0

    def active_volume_count(self) -> int:
        with self._lock:
            return len(self.writables)

    def pick_for_write(self) -> tuple[int, list[DataNode]]:
        """Random writable volume + its replica locations
        (ref volume_layout.go PickForWrite)."""
        with self._lock:
            if not self.writables:
                raise LookupError("no writable volumes")
            vid = random.choice(self.writables)
            return vid, list(self.vid_to_locations[vid])

    def to_info(self) -> dict:
        with self._lock:
            return {
                "replication": str(self.replica_placement),
                "ttl": str(self.ttl),
                "writables": list(self.writables),
            }
