"""Store: per-server facade over disk locations
(ref: weed/storage/store.go, store_ec.go).

Ported from the JAX package's storage/store.py without the heartbeat
collectors and their delta queues (store.py:160-380 there), which wait
for the master. One `device` is passed down to every location, volume
and EC volume: the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import threading
from typing import Optional

from .disk_location import DiskLocation
from .needle import Needle
from .super_block import ReplicaPlacement
from .ttl import TTL
from .volume import Volume


class Store:
    def __init__(
        self,
        directories: list[str],
        max_volume_counts: list[int],
        needle_map_kind: str = "memory",
        device=None,
    ):
        self.needle_map_kind = needle_map_kind
        self.device = device
        self.locations = [
            DiskLocation(d, m, needle_map_kind=needle_map_kind, device=device)
            for d, m in zip(directories, max_volume_counts)
        ]
        self._lock = threading.RLock()

    # --- lifecycle ---
    def load(self) -> None:
        for loc in self.locations:
            loc.load_existing_volumes()
            loc.load_all_ec_shards()

    def close(self) -> None:
        for loc in self.locations:
            loc.close()

    # --- volumes ---
    def find_volume(self, vid: int) -> Optional[Volume]:
        for loc in self.locations:
            v = loc.find_volume(vid)
            if v is not None:
                return v
        return None

    def has_volume(self, vid: int) -> bool:
        return self.find_volume(vid) is not None

    def add_volume(
        self,
        vid: int,
        collection: str,
        replication: str = "000",
        ttl_string: str = "",
        preallocate: int = 0,
    ) -> Volume:
        with self._lock:
            if self.find_volume(vid) is not None:
                raise ValueError(f"volume id {vid} already exists")
            location = max(
                self.locations, key=lambda l: l.max_volume_count - len(l.volumes)
            )
            v = Volume(
                location.directory,
                collection,
                vid,
                replica_placement=ReplicaPlacement.parse(replication),
                ttl=TTL.read(ttl_string),
                needle_map_kind=self.needle_map_kind,
                device=self.device,
            )
            location.add_volume(v)
        return v

    def delete_volume(self, vid: int, keep_ec_files: bool = False) -> bool:
        for loc in self.locations:
            if loc.delete_volume(vid, keep_ec_files=keep_ec_files):
                return True
        return False

    def unmount_volume(self, vid: int) -> bool:
        for loc in self.locations:
            if loc.unmount_volume(vid):
                return True
        return False

    def mount_volume(self, vid: int) -> bool:
        for loc in self.locations:
            loc.load_existing_volumes()
            if loc.find_volume(vid) is not None:
                return True
        return False

    def mark_volume_readonly(self, vid: int) -> bool:
        v = self.find_volume(vid)
        if v is None:
            return False
        v.no_write_or_delete = True
        return True

    # --- data path ---
    def write_volume_needle(self, vid: int, n: Needle, sync: bool = False):
        v = self.find_volume(vid)
        if v is None:
            raise LookupError(f"volume {vid} not found")
        if v.is_read_only():
            raise PermissionError(f"volume {vid} is read only")
        return v.write_needle(n, sync=sync)

    def read_volume_needle(self, vid: int, n: Needle) -> int:
        v = self.find_volume(vid)
        if v is None:
            raise LookupError(f"volume {vid} not found")
        return v.read_needle(n)

    def delete_volume_needle(self, vid: int, n: Needle) -> int:
        v = self.find_volume(vid)
        if v is None:
            return 0
        return v.delete_needle(n)

    def _volume_message(self, v: Volume) -> dict:
        """One volume's status fields, as the JAX package's heartbeat and
        VolumeServerStatus carry them (without the anti-entropy digest,
        scrub and garbage fields, which the port's Volume lacks)."""
        return {
            "id": v.id,
            "size": v.data_file_size(),
            "collection": v.collection,
            "file_count": v.file_count(),
            "delete_count": v.deleted_count(),
            "deleted_byte_count": v.deleted_size(),
            "read_only": v.is_read_only(),
            "replica_placement": v.super_block.replica_placement.to_byte(),
            "version": v.version,
            "ttl": v.super_block.ttl.to_u32(),
            "compact_revision": v.super_block.compaction_revision,
            "modified_at_second": int(v.last_modified_ts_seconds),
            "append_at_ns": v.last_append_at_ns,
        }

    # --- EC volume access (ref store_ec.go) ---
    def find_ec_volume(self, vid: int):
        for loc in self.locations:
            ev = loc.find_ec_volume(vid)
            if ev is not None:
                return ev
        return None

    def find_ec_shard(self, vid: int, shard_id: int):
        ev = self.find_ec_volume(vid)
        if ev is None:
            return None
        return ev.find_shard(shard_id)
