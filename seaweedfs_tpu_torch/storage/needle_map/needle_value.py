"""NeedleValue: one index entry (ref: weed/storage/needle_map/needle_value.go)."""

from __future__ import annotations

from dataclasses import dataclass

from ...storage.idx import entry_to_bytes


@dataclass(frozen=True)
class NeedleValue:
    key: int
    offset_units: int  # actual offset // 8, as stored on disk
    size: int

    def to_bytes(self) -> bytes:
        return entry_to_bytes(self.key, self.offset_units, self.size)
