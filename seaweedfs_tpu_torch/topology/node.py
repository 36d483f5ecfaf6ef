"""Topology tree nodes with capacity accounting rolled up the tree.

DataNode -> Rack -> DataCenter -> Topology (ref: weed/topology/node.go,
data_node.go, rack.go, data_center.go). Volume/EC-shard inventories live on
DataNodes; ancestors track aggregate slot counts for the placement solver.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, Optional

from ..storage.erasure_coding import TOTAL_SHARDS_COUNT
from ..storage.erasure_coding.ec_volume import ShardBits


class Node:
    def __init__(self, node_id: str):
        self.id = node_id
        self.parent: Optional[Node] = None
        self.children: Dict[str, Node] = {}
        self.volume_count = 0
        self.ec_shard_count = 0
        self.max_volume_count = 0
        self.max_volume_id = 0
        self._lock = threading.RLock()

    # --- capacity accounting (ref node.go UpAdjust*) ---
    def free_space(self) -> int:
        """Free volume slots; EC shards consume fractional slots
        (ref node.go FreeSpace: ecShardCount/TotalShards rounded up)."""
        free = self.max_volume_count - self.volume_count
        if self.ec_shard_count > 0:
            free -= (self.ec_shard_count + TOTAL_SHARDS_COUNT - 1) // TOTAL_SHARDS_COUNT
        return free

    def adjust_volume_count(self, delta: int) -> None:
        node: Optional[Node] = self
        while node is not None:
            node.volume_count += delta
            node = node.parent

    def adjust_ec_shard_count(self, delta: int) -> None:
        node: Optional[Node] = self
        while node is not None:
            node.ec_shard_count += delta
            node = node.parent

    def adjust_max_volume_count(self, delta: int) -> None:
        node: Optional[Node] = self
        while node is not None:
            node.max_volume_count += delta
            node = node.parent

    def adjust_max_volume_id(self, vid: int) -> None:
        node: Optional[Node] = self
        while node is not None:
            if vid > node.max_volume_id:
                node.max_volume_id = vid
            node = node.parent

    def link_child(self, child: "Node") -> None:
        with self._lock:
            if child.id not in self.children:
                self.children[child.id] = child
                child.parent = self
                self.adjust_max_volume_count(child.max_volume_count)
                self.adjust_volume_count(child.volume_count)
                self.adjust_ec_shard_count(child.ec_shard_count)
                self.adjust_max_volume_id(child.max_volume_id)

    def unlink_child(self, child_id: str) -> None:
        with self._lock:
            child = self.children.pop(child_id, None)
            if child is not None:
                self.adjust_max_volume_count(-child.max_volume_count)
                self.adjust_volume_count(-child.volume_count)
                self.adjust_ec_shard_count(-child.ec_shard_count)
                child.parent = None

    def descend_data_nodes(self) -> Iterable["DataNode"]:
        if isinstance(self, DataNode):
            yield self
            return
        for child in list(self.children.values()):
            yield from child.descend_data_nodes()


class DataNode(Node):
    """One volume server (ref: weed/topology/data_node.go)."""

    def __init__(self, node_id: str, url: str, public_url: str, max_volumes: int):
        super().__init__(node_id)
        self.url = url  # host:port of the HTTP data plane
        self.public_url = public_url or url
        self.max_volume_count = max_volumes
        self.volumes: Dict[int, dict] = {}  # vid -> volume info message
        self.ec_shards: Dict[int, ShardBits] = {}  # vid -> shard bits
        self.last_seen = time.time()

    @property
    def rack(self) -> Optional["Rack"]:
        return self.parent  # type: ignore

    @property
    def data_center(self) -> Optional["DataCenter"]:
        return self.parent.parent if self.parent else None  # type: ignore

    def update_volumes(
        self, volume_infos: list[dict]
    ) -> tuple[list[dict], list[dict], list[tuple[dict, dict]]]:
        """Full-state sync; returns (new, deleted, changed) volume infos —
        changed as (old, new) pairs whose layout key (replication/ttl/
        collection) moved, e.g. after volume.configure.replication
        (ref data_node.go UpdateVolumes)."""
        incoming = {int(v["id"]): v for v in volume_infos}
        new, deleted, changed = [], [], []
        layout_key = lambda v: (
            v.get("collection", ""),
            v.get("replica_placement", 0),
            v.get("ttl", 0),
        )
        with self._lock:
            for vid in list(self.volumes):
                if vid not in incoming:
                    deleted.append(self.volumes.pop(vid))
                    self.adjust_volume_count(-1)
            for vid, info in incoming.items():
                if vid not in self.volumes:
                    new.append(info)
                    self.adjust_volume_count(1)
                    self.adjust_max_volume_id(vid)
                elif layout_key(self.volumes[vid]) != layout_key(info):
                    changed.append((self.volumes[vid], info))
                self.volumes[vid] = info
        return new, deleted, changed

    def delta_update_volumes(
        self, new_volumes: list[dict], deleted_volumes: list[dict]
    ) -> None:
        with self._lock:
            for info in deleted_volumes:
                if int(info["id"]) in self.volumes:
                    del self.volumes[int(info["id"])]
                    self.adjust_volume_count(-1)
            for info in new_volumes:
                vid = int(info["id"])
                if vid not in self.volumes:
                    self.adjust_volume_count(1)
                    self.adjust_max_volume_id(vid)
                self.volumes[vid] = info

    def update_ec_shards(
        self, shard_infos: list[dict]
    ) -> tuple[list[tuple[int, str, ShardBits]], list[tuple[int, str, ShardBits]]]:
        """Full-state EC sync; returns (new, deleted) (vid, collection, bits)."""
        incoming: Dict[int, tuple[str, ShardBits]] = {}
        for m in shard_infos:
            incoming[int(m["id"])] = (
                m.get("collection", ""),
                ShardBits(int(m["ec_index_bits"])),
            )
        new, deleted = [], []
        with self._lock:
            for vid in list(self.ec_shards):
                if vid not in incoming:
                    bits = self.ec_shards.pop(vid)
                    self.adjust_ec_shard_count(-bits.count())
                    deleted.append((vid, "", bits))
            for vid, (collection, bits) in incoming.items():
                old = self.ec_shards.get(vid, ShardBits())
                added = bits.minus(old)
                removed = old.minus(bits)
                if added.bits:
                    new.append((vid, collection, added))
                if removed.bits:
                    deleted.append((vid, collection, removed))
                self.adjust_ec_shard_count(bits.count() - old.count())
                if bits.bits:
                    self.ec_shards[vid] = bits
                else:
                    self.ec_shards.pop(vid, None)
        return new, deleted

    def delta_update_ec_shards(
        self,
        new_shards: list[tuple[int, str, ShardBits]],
        deleted_shards: list[tuple[int, str, ShardBits]],
    ) -> None:
        with self._lock:
            for vid, _c, bits in new_shards:
                old = self.ec_shards.get(vid, ShardBits())
                merged = old.plus(bits)
                self.adjust_ec_shard_count(merged.count() - old.count())
                self.ec_shards[vid] = merged
            for vid, _c, bits in deleted_shards:
                old = self.ec_shards.get(vid, ShardBits())
                remaining = old.minus(bits)
                self.adjust_ec_shard_count(remaining.count() - old.count())
                if remaining.bits:
                    self.ec_shards[vid] = remaining
                else:
                    self.ec_shards.pop(vid, None)

    def to_info(self) -> dict:
        return {
            "id": self.id,
            "url": self.url,
            "public_url": self.public_url,
            "volume_count": self.volume_count,
            "max_volume_count": self.max_volume_count,
            "ec_shard_count": self.ec_shard_count,
            "free_space": self.free_space(),
            "volumes": list(self.volumes.values()),
            "ec_shards": [
                {"id": vid, "ec_index_bits": bits.bits}
                for vid, bits in self.ec_shards.items()
            ],
        }


class Rack(Node):
    def get_or_create_data_node(
        self, node_id: str, url: str, public_url: str, max_volumes: int
    ) -> DataNode:
        with self._lock:
            dn = self.children.get(node_id)
            if isinstance(dn, DataNode):
                dn.last_seen = time.time()
                return dn
            dn = DataNode(node_id, url, public_url, max_volumes)
            self.link_child(dn)
            return dn


class DataCenter(Node):
    def get_or_create_rack(self, rack_id: str) -> Rack:
        with self._lock:
            r = self.children.get(rack_id)
            if isinstance(r, Rack):
                return r
            r = Rack(rack_id)
            self.link_child(r)
            return r
