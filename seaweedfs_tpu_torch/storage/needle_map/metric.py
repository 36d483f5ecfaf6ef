"""Map metrics (ref: weed/storage/needle_map_metric.go:13)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class MapMetric:
    maximum_file_key: int = 0
    file_count: int = 0
    deletion_count: int = 0
    file_byte_count: int = 0
    deletion_byte_count: int = 0

    def maybe_set_max_file_key(self, key: int) -> None:
        if key > self.maximum_file_key:
            self.maximum_file_key = key

    def log_put(self, key: int, old_size: int, new_size: int) -> None:
        self.maybe_set_max_file_key(key)
        self.file_count += 1
        self.file_byte_count += new_size
        if old_size > 0 and old_size != 0xFFFFFFFF:
            self.deletion_count += 1
            self.deletion_byte_count += old_size

    def log_delete(self, deleted_bytes: int) -> None:
        if deleted_bytes > 0:
            self.deletion_byte_count += deleted_bytes
            self.deletion_count += 1

    @property
    def content_size(self) -> int:
        return self.file_byte_count

    @property
    def deleted_size(self) -> int:
        return self.deletion_byte_count
