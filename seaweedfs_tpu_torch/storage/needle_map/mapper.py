"""NeedleMap: CompactMap + append-only .idx log file.

Put/Delete mutate the in-memory map and append an entry to the .idx file;
Delete appends (key, offset, TOMBSTONE_FILE_SIZE)
(ref: weed/storage/needle_map.go:51-66, needle_map_memory.go).
"""

from __future__ import annotations

from typing import Optional

from ...types import TOMBSTONE_FILE_SIZE
from ..backend import DiskFile
from ..idx import entry_to_bytes, iter_index
from .compact_map import CompactMap
from .metric import MapMetric
from .needle_value import NeedleValue


class NeedleMap:
    def __init__(self, idx_path: str):
        self.m = CompactMap()
        self.metric = MapMetric()
        self.idx_path = idx_path
        self._idx = DiskFile(idx_path, create=True)

    def put(self, key: int, offset_units: int, size: int) -> None:
        _, old_size = self.m.set(key, offset_units, size)
        self.metric.log_put(key, old_size, size)
        self._idx.append(entry_to_bytes(key, offset_units, size))

    def put_batch(self, entries) -> None:
        """Apply many (key, offset_units, size) puts with ONE .idx
        append — the multi-needle batch append's map half."""
        blob = bytearray()
        for key, offset_units, size in entries:
            _, old_size = self.m.set(key, offset_units, size)
            self.metric.log_put(key, old_size, size)
            blob += entry_to_bytes(key, offset_units, size)
        if blob:
            self._idx.append(bytes(blob))

    def get(self, key: int) -> Optional[NeedleValue]:
        return self.m.get(key)

    def delete(self, key: int, offset_units: int) -> None:
        deleted_bytes = self.m.delete(key)
        self.metric.log_delete(deleted_bytes)
        self._idx.append(entry_to_bytes(key, offset_units, TOMBSTONE_FILE_SIZE))

    def ascending_visit(self, visit) -> None:
        self.m.ascending_visit(visit)

    def snapshot(self):
        return self.m.snapshot()

    def snapshot_token(self) -> int:
        return self.m.snapshot_token()

    def index_file_size(self) -> int:
        return self._idx.size()

    def sync(self) -> None:
        self._idx.sync()

    def close(self) -> None:
        self._idx.close()

    # metrics accessors mirroring the reference mapper
    @property
    def file_count(self) -> int:
        return self.metric.file_count

    @property
    def deleted_count(self) -> int:
        return self.metric.deletion_count

    @property
    def content_size(self) -> int:
        return self.metric.content_size

    @property
    def deleted_size(self) -> int:
        return self.metric.deleted_size

    @property
    def max_file_key(self) -> int:
        return self.metric.maximum_file_key


def new_needle_map(idx_path: str) -> NeedleMap:
    """Fresh map with a truncated idx file."""
    nm = NeedleMap(idx_path)
    nm._idx.truncate(0)
    return nm


def load_needle_map(idx_path: str) -> NeedleMap:
    """Rebuild the in-memory map by replaying the .idx log
    (ref: needle_map_memory.go LoadCompactNeedleMap/doLoading)."""
    nm = NeedleMap(idx_path)
    with open(idx_path, "rb") as f:
        for key, offset_units, size in iter_index(f):
            nm.metric.maybe_set_max_file_key(key)
            if offset_units > 0 and size != TOMBSTONE_FILE_SIZE:
                _, old_size = nm.m.set(key, offset_units, size)
                nm.metric.log_put(key, old_size, size)
            else:
                old_size = nm.m.delete(key)
                nm.metric.log_delete(old_size)
    return nm
