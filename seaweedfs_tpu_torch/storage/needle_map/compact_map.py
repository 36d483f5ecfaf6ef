"""CompactMap: the hot in-memory needle index.

Observable semantics match the reference's sectioned sorted-array map
(ref: weed/storage/needle_map/compact_map.go): set returns the previous
(offset, size); delete tombstones the entry (size = TOMBSTONE_FILE_SIZE) and
returns the freed size; ascending_visit walks keys in order, including
tombstones.

The implementation is device-first rather than a translation: a Python dict
is the mutable write path, and a compacted sorted-column snapshot (numpy
u64/u32 arrays) is maintained lazily for bulk probes — the same columns the
CUDA lookup kernel (ops/csrc/index_search.cu) consumes. This replaces the reference's 100k-entry sections +
overflow lists; dict insertion keeps the amortized O(1) append property the
sections were built for.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional

import numpy as np

from ...types import TOMBSTONE_FILE_SIZE
from .needle_value import NeedleValue


class CompactMap:
    __slots__ = ("_map", "_snapshot", "_dirty", "_mutations")

    def __init__(self):
        self._map: dict[int, tuple[int, int]] = {}
        self._snapshot: Optional[tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        self._dirty = True
        self._mutations = 0

    def set(self, key: int, offset_units: int, size: int) -> tuple[int, int]:
        """Insert/overwrite; returns (old_offset_units, old_size) — (0, 0) if new."""
        old = self._map.get(key)
        self._map[key] = (offset_units, size)
        self._dirty = True
        self._mutations += 1
        return old if old is not None else (0, 0)

    def delete(self, key: int) -> int:
        """Tombstone the key; returns the freed size (0 if absent/already dead)."""
        old = self._map.get(key)
        if old is None:
            return 0
        offset_units, size = old
        self._map[key] = (offset_units, TOMBSTONE_FILE_SIZE)
        self._dirty = True
        self._mutations += 1
        if size == TOMBSTONE_FILE_SIZE:
            return 0
        return size

    def snapshot_token(self) -> int:
        """Monotonic mutation counter: equal tokens mean snapshot() would
        return identical columns — the device-side cache key."""
        return self._mutations

    def get(self, key: int) -> Optional[NeedleValue]:
        v = self._map.get(key)
        if v is None:
            return None
        return NeedleValue(key=key, offset_units=v[0], size=v[1])

    def __len__(self) -> int:
        return len(self._map)

    def __contains__(self, key: int) -> bool:
        return key in self._map

    def ascending_visit(self, visit: Callable[[NeedleValue], None]) -> None:
        for key in sorted(self._map):
            offset_units, size = self._map[key]
            visit(NeedleValue(key=key, offset_units=offset_units, size=size))

    def items_ascending(self) -> Iterator[NeedleValue]:
        for key in sorted(self._map):
            offset_units, size = self._map[key]
            yield NeedleValue(key=key, offset_units=offset_units, size=size)

    # --- device snapshot path ---
    def snapshot(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Sorted live entries as (keys u64[n], offset_units u32[n], sizes u32[n]).

        Tombstoned entries are excluded — this is the probe table for the
        bulk-lookup kernel; a miss there means not-found-or-deleted.
        """
        if self._dirty or self._snapshot is None:
            items = [
                (k, v[0], v[1])
                for k, v in self._map.items()
                if v[1] != TOMBSTONE_FILE_SIZE
            ]
            items.sort()
            if items:
                from ...types import OFFSET_SIZE

                arr = np.asarray(items, dtype=np.uint64)
                keys = arr[:, 0].astype(np.uint64)
                # u64 under the 5-byte-offset variant (units exceed u32)
                offsets = arr[:, 1].astype(
                    np.uint64 if OFFSET_SIZE == 5 else np.uint32
                )
                sizes = arr[:, 2].astype(np.uint32)
            else:
                keys = np.empty(0, dtype=np.uint64)
                offsets = np.empty(0, dtype=np.uint32)
                sizes = np.empty(0, dtype=np.uint32)
            self._snapshot = (keys, offsets, sizes)
            self._dirty = False
        return self._snapshot
