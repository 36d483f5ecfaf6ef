"""Store: per-server facade over disk locations
(ref: weed/storage/store.go, store_ec.go).

Ported from the JAX package's storage/store.py with its heartbeat
collectors and delta queues (`collect_heartbeat`, `collect_ec_heartbeat`,
`collect_volume_digests` with the anti-entropy plane's content digest and
append frontier and the vacuum plane's garbage ratio, `drain_deltas`,
`note_ec_shards_changed`, `note_volume_changed`); the lifecycle plane's
heat and the cold-tier collectors wait with their master planes. One `device` is
passed down to every location, volume and EC volume: the card unless the
caller asks for the CPU.
"""

from __future__ import annotations

import threading
from typing import Optional

from .disk_location import DiskLocation
from .erasure_coding.ec_volume import ShardBits
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
        ip: str = "127.0.0.1",
        port: int = 0,
        public_url: str = "",
    ):
        self.ip = ip
        self.port = port
        self.public_url = public_url
        self.needle_map_kind = needle_map_kind
        self.device = device
        self.locations = [
            DiskLocation(d, m, needle_map_kind=needle_map_kind, device=device)
            for d, m in zip(directories, max_volume_counts)
        ]
        self._lock = threading.RLock()
        # delta queues drained into heartbeats (ref store.go:41-44)
        self.new_volumes: list[dict] = []
        self.deleted_volumes: list[dict] = []
        self.new_ec_shards: list[dict] = []
        self.deleted_ec_shards: list[dict] = []

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
            self.new_volumes.append(self._volume_message(v))
        return v

    def delete_volume(self, vid: int, keep_ec_files: bool = False) -> bool:
        v = self.find_volume(vid)
        if v is None:
            return False
        msg = self._volume_message(v)
        for loc in self.locations:
            if loc.delete_volume(vid, keep_ec_files=keep_ec_files):
                with self._lock:
                    self.deleted_volumes.append(msg)
                return True
        return False

    def unmount_volume(self, vid: int) -> bool:
        v = self.find_volume(vid)
        if v is None:
            return False
        msg = self._volume_message(v)
        for loc in self.locations:
            if loc.unmount_volume(vid):
                with self._lock:
                    self.deleted_volumes.append(msg)
                return True
        return False

    def mount_volume(self, vid: int) -> bool:
        for loc in self.locations:
            loc.load_existing_volumes()
            v = loc.find_volume(vid)
            if v is not None:
                with self._lock:
                    self.new_volumes.append(self._volume_message(v))
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
        VolumeServerStatus carry them (without the anti-entropy content
        digest and the lifecycle heat, whose planes the port lacks)."""
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
            # anti-entropy fields: order-independent live-content digest +
            # append frontier let the master spot diverged/stale replicas
            # from heartbeats alone; scrub_corrupt marks a quarantined copy
            "content_digest": v.content_digest(),
            "append_at_ns": v.last_append_at_ns,
            "scrub_corrupt": v.scrub_corrupt,
            # vacuum plane: the garbage ratio rides every heartbeat so the
            # master's vacuum scheduler can rank candidates without an RPC
            # sweep (the per-dispatch VacuumVolumeCheck stays the
            # authoritative re-check)
            "garbage_ratio": round(v.garbage_level(), 4),
        }

    def collect_volume_digests(self) -> list[dict]:
        """Lightweight per-pulse digest refresh: full volume messages only
        travel at stream connect and on add/remove deltas, so steady-state
        writes would leave the master comparing stale digests and ranking
        vacuum candidates off stale garbage ratios. This slim message (id
        + digest + frontier + corrupt flag + garbage ratio + size) rides
        every few heartbeat ticks instead (the JAX package's also carries
        the heat its lifecycle planner reads)."""
        out = []
        for loc in self.locations:
            for v in list(loc.volumes.values()):
                out.append(
                    {
                        "id": v.id,
                        "content_digest": v.content_digest(),
                        "append_at_ns": v.last_append_at_ns,
                        "read_only": v.is_read_only(),
                        "scrub_corrupt": v.scrub_corrupt,
                        "garbage_ratio": round(v.garbage_level(), 4),
                        "size": v.data_file_size(),
                    }
                )
        return out

    # --- heartbeat assembly (ref store.go:194-254) ---
    def collect_heartbeat(self) -> dict:
        volume_messages = []
        max_volume_count = 0
        max_file_key = 0
        for loc in self.locations:
            max_volume_count += loc.max_volume_count
            for v in list(loc.volumes.values()):
                if v.max_file_key() > max_file_key:
                    max_file_key = v.max_file_key()
                volume_messages.append(self._volume_message(v))
        return {
            "ip": self.ip,
            "port": self.port,
            "public_url": self.public_url,
            "max_volume_count": max_volume_count,
            "max_file_key": max_file_key,
            "volumes": volume_messages,
            "has_no_volumes": len(volume_messages) == 0,
        }

    def collect_ec_heartbeat(self) -> dict:
        shard_messages = []
        for loc in self.locations:
            for vid, ev in list(loc.ec_volumes.items()):
                bits = ev.shard_bits().bits
                shard_messages.append(
                    {
                        "id": vid,
                        "collection": ev.collection,
                        "ec_index_bits": bits,
                        "ec_local_bits": bits,
                        "ec_offloaded_bits": 0,
                    }
                )
        return {
            "ec_shards": shard_messages,
            "has_no_ec_shards": len(shard_messages) == 0,
        }

    def note_volume_changed(self, old_msg: dict, new_msg: dict) -> None:
        """Queue an in-place change (a vacuum commit's new volume) as a
        deleted(old)+new(new) delta pair for the next pulse."""
        with self._lock:
            self.deleted_volumes.append(old_msg)
            self.new_volumes.append(new_msg)

    def drain_deltas(self) -> dict:
        with self._lock:
            # collapse same-vid churn within one pulse so the master's
            # delete-then-add processing can't resurrect ghosts: a volume
            # no longer held is not new; keep the FIRST deleted message
            # (the layout the master registered) and the LAST new one
            held = {vid for loc in self.locations for vid in loc.volumes}
            new_by_vid: dict = {}
            for msg in self.new_volumes:
                if int(msg["id"]) in held:
                    new_by_vid[int(msg["id"])] = msg
            deleted_by_vid: dict = {}
            for msg in self.deleted_volumes:
                deleted_by_vid.setdefault(int(msg["id"]), msg)
            out = {
                "new_volumes": list(new_by_vid.values()),
                "deleted_volumes": list(deleted_by_vid.values()),
                "new_ec_shards": self.new_ec_shards,
                "deleted_ec_shards": self.deleted_ec_shards,
            }
            self.new_volumes = []
            self.deleted_volumes = []
            self.new_ec_shards = []
            self.deleted_ec_shards = []
            return out

    def note_ec_shards_changed(
        self, vid: int, collection: str, added: ShardBits, removed: ShardBits
    ) -> None:
        with self._lock:
            if added.bits:
                self.new_ec_shards.append(
                    {"id": vid, "collection": collection,
                     "ec_index_bits": added.bits}
                )
            if removed.bits:
                self.deleted_ec_shards.append(
                    {"id": vid, "collection": collection,
                     "ec_index_bits": removed.bits}
                )

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
