"""Topology root: collections, volume layouts, EC shard registry, vid/fid
assignment (ref: weed/topology/topology.go, topology_ec.go)."""

from __future__ import annotations

import secrets as _secrets
import threading
import time
from typing import Dict, Optional

from ..sequence import MemorySequencer
from ..storage.erasure_coding.ec_volume import ShardBits
from ..storage.file_id import format_needle_id_cookie
from ..storage.super_block import ReplicaPlacement
from ..storage.ttl import TTL
from .node import DataCenter, DataNode, Node
from .volume_layout import VolumeLayout


class Collection:
    def __init__(self, name: str, volume_size_limit: int):
        self.name = name
        self.volume_size_limit = volume_size_limit
        self._layouts: Dict[tuple[int, int], VolumeLayout] = {}
        self._lock = threading.RLock()

    def get_or_create_layout(
        self, rp: ReplicaPlacement, ttl: TTL
    ) -> VolumeLayout:
        key = (rp.to_byte(), ttl.to_u32())
        with self._lock:
            layout = self._layouts.get(key)
            if layout is None:
                layout = VolumeLayout(rp, ttl, self.volume_size_limit)
                self._layouts[key] = layout
            return layout

    def layouts(self) -> list[VolumeLayout]:
        with self._lock:
            return list(self._layouts.values())

    def lookup(self, vid: int) -> Optional[list[DataNode]]:
        for layout in self.layouts():
            locs = layout.lookup(vid)
            if locs:
                return locs
        return None


class EcShardLocations:
    """vid -> per-shard DataNode lists (ref: topology_ec.go:10-124)."""

    def __init__(self, collection: str = ""):
        self.collection = collection
        # 32 slots (the ShardBits width) so alternate geometries with more
        # than 14 shards (e.g. 12.4) register cleanly
        self.locations: list[list[DataNode]] = [[] for _ in range(32)]
        # highest shard id ever registered + 1: the repair scheduler's
        # expectation of how many shards this volume SHOULD have, so a
        # shard whose every holder died still counts as missing
        self.expected_total = 0

    def add_shard(self, shard_id: int, dn: DataNode) -> bool:
        if shard_id + 1 > self.expected_total:
            self.expected_total = shard_id + 1
        if dn in self.locations[shard_id]:
            return False
        self.locations[shard_id].append(dn)
        return True

    def delete_shard(self, shard_id: int, dn: DataNode) -> bool:
        if dn in self.locations[shard_id]:
            self.locations[shard_id].remove(dn)
            return True
        return False


class Topology(Node):
    def __init__(
        self,
        volume_size_limit: int = 30_000 * 1024 * 1024,
        sequencer: Optional[MemorySequencer] = None,
    ):
        super().__init__("topo")
        self.volume_size_limit = volume_size_limit
        self.sequence = sequencer or MemorySequencer()
        self.collections: Dict[str, Collection] = {}
        self.ec_shard_map: Dict[tuple[str, int], EcShardLocations] = {}
        self._ec_lock = threading.RLock()
        self._vid_lock = threading.Lock()
        self._max_volume_id_assigned = 0

    # --- tree ---
    def get_or_create_data_center(self, dc_id: str) -> DataCenter:
        with self._lock:
            dc = self.children.get(dc_id)
            if isinstance(dc, DataCenter):
                return dc
            dc = DataCenter(dc_id)
            self.link_child(dc)
            return dc

    # --- id assignment ---
    def next_volume_id(self) -> int:
        """Monotonic cluster-wide volume id (raft-backed in the reference,
        ref topology.go:115-122; single-master lease here)."""
        with self._vid_lock:
            vid = max(self.max_volume_id, self._max_volume_id_assigned) + 1
            self._max_volume_id_assigned = vid
            return vid

    def pick_for_write(
        self, count: int, collection: str, rp: ReplicaPlacement, ttl: TTL
    ) -> tuple[str, int, list[DataNode]]:
        """-> (fid, count, locations) (ref topology.go:129-139)."""
        layout = self.get_volume_layout(collection, rp, ttl)
        vid, locations = layout.pick_for_write()
        file_id = self.sequence.next_file_id(count)
        cookie = _secrets.randbits(32)
        fid = f"{vid},{format_needle_id_cookie(file_id, cookie)}"
        return fid, count, locations

    # --- collections / layouts ---
    def get_collection(self, name: str) -> Collection:
        with self._lock:
            col = self.collections.get(name)
            if col is None:
                col = Collection(name, self.volume_size_limit)
                self.collections[name] = col
            return col

    def get_volume_layout(
        self, collection: str, rp: ReplicaPlacement, ttl: TTL
    ) -> VolumeLayout:
        return self.get_collection(collection).get_or_create_layout(rp, ttl)

    def delete_collection(self, name: str) -> None:
        with self._lock:
            self.collections.pop(name, None)

    # --- volume registration from heartbeats ---
    def _layout_for_info(self, info: dict) -> VolumeLayout:
        rp = ReplicaPlacement.from_byte(int(info.get("replica_placement", 0)))
        ttl = TTL.from_u32(int(info.get("ttl", 0)))
        return self.get_volume_layout(info.get("collection", ""), rp, ttl)

    def register_volume(self, info: dict, dn: DataNode) -> None:
        self._layout_for_info(info).register_volume(info, dn)
        self.adjust_max_volume_id(int(info["id"]))

    def unregister_volume(self, info: dict, dn: DataNode) -> None:
        self._layout_for_info(info).unregister_volume(info, dn)

    def lookup(self, collection: str, vid: int) -> Optional[list[DataNode]]:
        """(ref topology.go:91-108)"""
        if collection:
            col = self.collections.get(collection)
            return col.lookup(vid) if col else None
        for col in list(self.collections.values()):
            locs = col.lookup(vid)
            if locs:
                return locs
        return None

    # --- EC shards (ref topology_ec.go) ---
    def register_ec_shards(
        self, vid: int, collection: str, bits: ShardBits, dn: DataNode
    ) -> None:
        with self._ec_lock:
            key = (collection, vid)
            locs = self.ec_shard_map.get(key)
            if locs is None:
                locs = EcShardLocations(collection)
                self.ec_shard_map[key] = locs
            for shard_id in bits.shard_ids():
                locs.add_shard(shard_id, dn)

    def unregister_ec_shards(
        self, vid: int, collection: str, bits: ShardBits, dn: DataNode
    ) -> None:
        with self._ec_lock:
            locs = self.ec_shard_map.get((collection, vid))
            if locs is None:
                return
            for shard_id in bits.shard_ids():
                locs.delete_shard(shard_id, dn)

    def forget_ec_volume_if_empty(self, vid: int) -> bool:
        """Drop an EC volume's registration once EXPLICIT shard deletes
        (ec.decode, lifecycle re-inflation) emptied every location list.
        Only delta/full-state delete processing calls this — a node going
        silent must NOT forget the volume, or wholly-lost shards would
        stop looking missing to the repair planner."""
        with self._ec_lock:
            for (collection, v), locs in list(self.ec_shard_map.items()):
                if v == vid and not any(
                    locs.locations[s] for s in range(32)
                ):
                    del self.ec_shard_map[(collection, v)]
                    return True
        return False

    def lookup_ec_shards(self, vid: int) -> Optional[EcShardLocations]:
        with self._ec_lock:
            for (collection, v), locs in self.ec_shard_map.items():
                if v == vid:
                    return locs
            return None

    def data_nodes(self) -> list[DataNode]:
        return list(self.descend_data_nodes())

    def to_info(self) -> dict:
        return {
            "max_volume_id": self.max_volume_id,
            "volume_count": self.volume_count,
            "max_volume_count": self.max_volume_count,
            "ec_shard_count": self.ec_shard_count,
            "data_centers": [
                {
                    "id": dc.id,
                    "racks": [
                        {
                            "id": rack.id,
                            "data_nodes": [
                                dn.to_info() for dn in rack.children.values()
                            ],
                        }
                        for rack in dc.children.values()
                    ],
                }
                for dc in self.children.values()
            ],
        }

    # --- anti-entropy state snapshots (topology/repair.py, placement.py,
    # vacuum_plan.py) ---
    def live_data_nodes(self, grace_seconds: float) -> list[DataNode]:
        """Nodes whose heartbeats are fresh. A node silent past the grace
        period stops counting as a holder — the heartbeat-driven failure
        detector feeding the repair scheduler (a broken stream already
        unregisters the node; this also catches a hung one that keeps the
        stream open without pulsing)."""
        now = time.time()
        return [
            dn
            for dn in self.data_nodes()
            if now - dn.last_seen <= grace_seconds
        ]

    def ec_states(self, live_urls: Optional[set] = None) -> list[dict]:
        """Per-EC-volume holder map restricted to live nodes, in the shape
        `repair.plan_ec_repairs` consumes."""
        out = []
        with self._ec_lock:
            for (collection, vid), locs in self.ec_shard_map.items():
                if locs.expected_total == 0:
                    continue
                holders: Dict[int, list[str]] = {}
                for sid in range(locs.expected_total):
                    urls = [
                        dn.url
                        for dn in locs.locations[sid]
                        if live_urls is None or dn.url in live_urls
                    ]
                    if urls:
                        holders[sid] = urls
                out.append(
                    {
                        "vid": vid,
                        "collection": collection,
                        "total_shards": locs.expected_total,
                        "holders": holders,
                    }
                )
        return out

    def replica_states(self, live_urls: Optional[set] = None) -> dict:
        """{vid: [per-live-replica digest/frontier/corrupt/garbage
        records]} for `repair.plan_replica_repairs` and
        `vacuum_plan.plan_vacuums`, read straight off the volume infos
        heartbeats delivered (the JAX package's records also carry the
        heat its lifecycle planner reads)."""
        states: Dict[int, list[dict]] = {}
        for dn in self.data_nodes():
            if live_urls is not None and dn.url not in live_urls:
                continue
            for vid, info in list(dn.volumes.items()):
                states.setdefault(int(vid), []).append(
                    {
                        "url": dn.url,
                        "collection": info.get("collection", ""),
                        "content_digest": int(info.get("content_digest", 0)),
                        "append_at_ns": int(info.get("append_at_ns", 0)),
                        "scrub_corrupt": bool(info.get("scrub_corrupt")),
                        "read_only": bool(info.get("read_only")),
                        "garbage_ratio": float(info.get("garbage_ratio", 0.0)),
                        "size": int(info.get("size", 0)),
                    }
                )
        return states

    def placement_states(self, live_urls: Optional[set] = None) -> list[dict]:
        """Per-volume replica placement snapshot — each volume's layout
        `ReplicaPlacement` plus its live holders' (dc, rack) domains, in
        the shape `placement.plan_replica_spread` consumes."""
        out = []
        with self._lock:
            collections = list(self.collections.items())
        for cname, col in collections:
            for layout in col.layouts():
                rp_byte = layout.replica_placement.to_byte()
                with layout._lock:
                    vid_locs = {
                        vid: list(locs)
                        for vid, locs in layout.vid_to_locations.items()
                    }
                for vid, locs in vid_locs.items():
                    holders = [
                        {
                            "url": dn.url,
                            "dc": dn.data_center.id if dn.data_center else "",
                            "rack": dn.rack.id if dn.rack else "",
                        }
                        for dn in locs
                        if live_urls is None or dn.url in live_urls
                    ]
                    if holders:
                        out.append(
                            {
                                "vid": int(vid),
                                "collection": cname,
                                "replica_placement": rp_byte,
                                "holders": holders,
                            }
                        )
        return out

    def placement_candidates(
        self, live_urls: Optional[set] = None
    ) -> list[dict]:
        """Every live node with its failure domains and free slots — the
        move-target pool for placement repair planning."""
        return [
            {
                "url": dn.url,
                "dc": dn.data_center.id if dn.data_center else "",
                "rack": dn.rack.id if dn.rack else "",
                "free": dn.free_space(),
            }
            for dn in self.data_nodes()
            if live_urls is None or dn.url in live_urls
        ]
