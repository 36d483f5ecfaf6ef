"""MemDb: sortable scratch needle map used by the EC encode path to turn a
.idx log into a sorted .ecx (ref: weed/storage/needle_map/memdb.go).

Unlike CompactMap, delete *removes* the entry (the reference deletes the
leveldb key, memdb.go:57-62).
"""

from __future__ import annotations

from typing import Callable, Optional

from ...types import TOMBSTONE_FILE_SIZE
from ..idx import iter_index
from .needle_value import NeedleValue


class MemDb:
    __slots__ = ("_map",)

    def __init__(self):
        self._map: dict[int, tuple[int, int]] = {}

    def set(self, key: int, offset_units: int, size: int) -> None:
        self._map[key] = (offset_units, size)

    def delete(self, key: int) -> None:
        self._map.pop(key, None)

    def get(self, key: int) -> Optional[NeedleValue]:
        v = self._map.get(key)
        if v is None:
            return None
        return NeedleValue(key=key, offset_units=v[0], size=v[1])

    def __len__(self) -> int:
        return len(self._map)

    def ascending_visit(self, visit: Callable[[NeedleValue], None]) -> None:
        for key in sorted(self._map):
            offset_units, size = self._map[key]
            visit(NeedleValue(key=key, offset_units=offset_units, size=size))

    def save_to_idx(self, path: str) -> None:
        with open(path, "wb") as f:
            for key in sorted(self._map):
                offset_units, size = self._map[key]
                f.write(NeedleValue(key, offset_units, size).to_bytes())

    def load_from_idx(self, path: str) -> None:
        """Replays a .idx log: live entries set, tombstones/zero-offset deleted
        (ref: ec_encoder.go:289-306 readNeedleMap)."""
        with open(path, "rb") as f:
            for key, offset_units, size in iter_index(f):
                if offset_units != 0 and size != TOMBSTONE_FILE_SIZE:
                    self.set(key, offset_units, size)
                else:
                    self.delete(key)
