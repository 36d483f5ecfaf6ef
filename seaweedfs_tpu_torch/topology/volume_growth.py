"""Replica placement solver + volume growth.

Finds (1 + x + y + z) empty slots honoring the xyz ReplicaPlacement: pick a
main data center / rack / server weighted by free slots, then the other-DC,
other-rack and same-rack copies (ref: weed/topology/volume_growth.go:70-130).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Optional

from ..storage.super_block import ReplicaPlacement
from ..storage.ttl import EMPTY_TTL, TTL
from .node import DataCenter, DataNode, Node, Rack


@dataclass
class GrowOption:
    collection: str = ""
    replica_placement: ReplicaPlacement = field(default_factory=ReplicaPlacement)
    ttl: TTL = EMPTY_TTL
    preallocate: int = 0
    data_center: str = ""
    rack: str = ""
    data_node: str = ""
    memory_map_max_size_mb: int = 0


def grow_count_for_copy_level(copy_count: int) -> int:
    """How many volumes to grow per request (ref volume_growth.go:51-68)."""
    return {1: 7, 2: 6, 3: 3}.get(copy_count, 1)


def _weighted_pick(candidates: list[Node]) -> Optional[Node]:
    """Random pick weighted by free slots."""
    weights = [max(c.free_space(), 0) for c in candidates]
    total = sum(weights)
    if total <= 0:
        return None
    r = random.randrange(total)
    for c, w in zip(candidates, weights):
        if r < w:
            return c
        r -= w
    return candidates[-1]


class NoFreeSpaceError(Exception):
    pass


class VolumeGrowth:
    def find_empty_slots(
        self, topo, option: GrowOption
    ) -> list[DataNode]:
        """Servers (first = main) able to host one new volume's replicas."""
        rp = option.replica_placement

        # main DC: needs >= diff_dc_count other DCs and enough local capacity
        dcs = [
            dc
            for dc in topo.children.values()
            if isinstance(dc, DataCenter)
            and (not option.data_center or dc.id == option.data_center)
            and dc.free_space() >= rp.diff_rack_count + rp.same_rack_count + 1
            and len(dc.children) > rp.diff_rack_count
        ]
        other_dcs_needed = rp.diff_data_center_count
        dcs = [
            dc
            for dc in dcs
            if sum(
                1
                for other in topo.children.values()
                if other is not dc and other.free_space() > 0
            )
            >= other_dcs_needed
        ]
        main_dc = _weighted_pick(dcs)  # type: ignore[arg-type]
        if main_dc is None:
            raise NoFreeSpaceError("no data center with enough free slots")

        # main rack
        racks = [
            r
            for r in main_dc.children.values()
            if isinstance(r, Rack)
            and (not option.rack or r.id == option.rack)
            and r.free_space() >= rp.same_rack_count + 1
            and len(r.children) > rp.same_rack_count
        ]
        racks = [
            r
            for r in racks
            if sum(
                1
                for other in main_dc.children.values()
                if other is not r and other.free_space() > 0
            )
            >= rp.diff_rack_count
        ]
        main_rack = _weighted_pick(racks)  # type: ignore[arg-type]
        if main_rack is None:
            raise NoFreeSpaceError("no rack with enough free slots")

        # main server + same-rack copies
        servers = [
            dn
            for dn in main_rack.children.values()
            if isinstance(dn, DataNode)
            and (not option.data_node or dn.id == option.data_node)
            and dn.free_space() > 0
        ]
        if len(servers) < rp.same_rack_count + 1:
            raise NoFreeSpaceError("not enough servers in rack")
        main_server = _weighted_pick(servers)  # type: ignore[arg-type]
        if main_server is None:
            raise NoFreeSpaceError("no server with free slots")
        chosen = [main_server]
        rest = [s for s in servers if s is not main_server]
        random.shuffle(rest)
        chosen.extend(rest[: rp.same_rack_count])
        if len(chosen) < rp.same_rack_count + 1:
            raise NoFreeSpaceError("not enough same-rack replicas")

        # other racks in the main DC
        other_racks = [
            r
            for r in main_dc.children.values()
            if r is not main_rack and r.free_space() > 0
        ]
        random.shuffle(other_racks)
        for r in other_racks[: rp.diff_rack_count]:
            dn = _weighted_pick(
                [s for s in r.descend_data_nodes() if s.free_space() > 0]
            )
            if dn is None:
                raise NoFreeSpaceError("no server in other rack")
            chosen.append(dn)
        if len(chosen) < rp.same_rack_count + 1 + rp.diff_rack_count:
            raise NoFreeSpaceError("not enough diff-rack replicas")

        # other data centers
        other_dcs = [
            dc for dc in topo.children.values() if dc is not main_dc and dc.free_space() > 0
        ]
        random.shuffle(other_dcs)
        for dc in other_dcs[: rp.diff_data_center_count]:
            dn = _weighted_pick(
                [s for s in dc.descend_data_nodes() if s.free_space() > 0]
            )
            if dn is None:
                raise NoFreeSpaceError("no server in other data center")
            chosen.append(dn)
        if len(chosen) < rp.copy_count():
            raise NoFreeSpaceError("not enough replicas")
        return chosen

    async def grow_by_count(
        self, count: int, topo, option: GrowOption, allocate_fn
    ) -> int:
        """Grow up to `count` volumes; allocate_fn(vid, option, servers) is an
        async callback that performs the AllocateVolume RPCs. Returns how many
        volumes were created."""
        grown = 0
        for _ in range(count):
            try:
                servers = self.find_empty_slots(topo, option)
            except NoFreeSpaceError:
                break
            vid = topo.next_volume_id()
            ok = await allocate_fn(vid, option, servers)
            if not ok:
                break
            for dn in servers:
                topo.register_volume(
                    {
                        "id": vid,
                        "size": 0,
                        "collection": option.collection,
                        "replica_placement": option.replica_placement.to_byte(),
                        "ttl": option.ttl.to_u32(),
                        "read_only": False,
                        "version": 3,
                    },
                    dn,
                )
            grown += 1
        return grown
