"""Shared EC orchestration helpers (ref: weed/shell/command_ec_common.go).

Copied from the JAX package's shell/ec_common.py: `EcNode`,
`nodes_from_topology`, the pure planners `plan_balanced_spread`
(ec.encode), `plan_rack_balance` and `plan_dedupe` (ec.balance), which
take nodes and give moves, and `execute_shard_move`, which carries one
move out over the volume servers' RPCs."""

from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass, field

from ..storage.erasure_coding import TOTAL_SHARDS_COUNT
from ..storage.erasure_coding.ec_volume import ShardBits


@dataclass
class EcNode:
    url: str
    data_center: str = ""
    rack: str = ""
    free_slots: int = 0
    # vid -> ShardBits
    shards: dict = field(default_factory=dict)

    def shard_count(self) -> int:
        return sum(bits.count() for bits in self.shards.values())


def nodes_from_topology(data_nodes: list[dict]) -> list[EcNode]:
    nodes = []
    for dn in data_nodes:
        n = EcNode(
            url=dn["url"],
            data_center=dn.get("data_center", ""),
            rack=dn.get("rack", ""),
            free_slots=int(dn.get("free_space", 0)) * TOTAL_SHARDS_COUNT,
        )
        for m in dn.get("ec_shards", []):
            n.shards[int(m["id"])] = ShardBits(int(m["ec_index_bits"]))
        nodes.append(n)
    return nodes


@dataclass(frozen=True)
class ShardMove:
    vid: int
    shard_id: int
    source: str
    target: str


def plan_balanced_spread(
    nodes: list[EcNode], vid: int, shard_ids: list[int], source_url: str
) -> dict[str, list[int]]:
    """Spread freshly-generated shards across nodes, most-free-first
    (ref balancedEcDistribution, command_ec_encode.go:209-264): 14 shards
    over four servers go 4/4/3/3, so losing any one server leaves at least
    10 survivors."""
    if not nodes:
        return {source_url: list(shard_ids)}
    picked = sorted(nodes, key=lambda n: -n.free_slots)
    assignment: dict[str, list[int]] = defaultdict(list)
    counts = {n.url: n.shard_count() for n in picked}
    for shard_id in shard_ids:
        target = min(picked, key=lambda n: counts[n.url] + len(assignment[n.url]))
        assignment[target.url].append(shard_id)
    return dict(assignment)


def plan_rack_balance(nodes: list[EcNode], vid: int) -> list[ShardMove]:
    """Even out one volume's shards across racks, then across the nodes
    of each rack (ref command_ec_balance.go:29-95, doEcBalance's phases)."""
    holders: dict[int, str] = {}
    for n in nodes:
        bits = n.shards.get(vid)
        if bits:
            for shard_id in bits.shard_ids():
                holders[shard_id] = n.url
    if not holders:
        return []
    by_url = {n.url: n for n in nodes}
    racks = defaultdict(list)
    for n in nodes:
        racks[n.rack].append(n)
    total = len(holders)
    rack_names = sorted(racks)
    average_per_rack = math.ceil(total / max(len(rack_names), 1))

    moves: list[ShardMove] = []

    def rack_load(rack: str) -> list[int]:
        return [sid for sid, url in holders.items() if by_url[url].rack == rack]

    # phase 1: across racks
    for rack in rack_names:
        load = rack_load(rack)
        while len(load) > average_per_rack:
            sid = load.pop()
            under = [
                r for r in rack_names
                if r != rack and len(rack_load(r)) < average_per_rack
            ]
            if not under:
                break
            dest_rack = min(under, key=lambda r: len(rack_load(r)))
            dest = max(racks[dest_rack], key=lambda n: n.free_slots)
            moves.append(ShardMove(vid, sid, holders[sid], dest.url))
            holders[sid] = dest.url

    # phase 2: within each rack, even out across nodes
    for rack in rack_names:
        rack_nodes = racks[rack]
        load = rack_load(rack)
        if not load or len(rack_nodes) <= 1:
            continue
        per_node = math.ceil(len(load) / len(rack_nodes))
        node_loads = defaultdict(list)
        for sid in load:
            node_loads[holders[sid]].append(sid)
        for n in rack_nodes:
            while len(node_loads[n.url]) > per_node:
                sid = node_loads[n.url].pop()
                under = [
                    m for m in rack_nodes
                    if m.url != n.url and len(node_loads[m.url]) < per_node
                ]
                if not under:
                    break
                dest = min(under, key=lambda m: len(node_loads[m.url]))
                moves.append(ShardMove(vid, sid, n.url, dest.url))
                holders[sid] = dest.url
                node_loads[dest.url].append(sid)
    return moves


def plan_dedupe(nodes: list[EcNode], vid: int) -> list[tuple[int, str]]:
    """(shard_id, url) deletions of duplicate shard copies, keeping the
    copy on the node with the most free slots (ref deduplicateEcShards)."""
    seen: dict[int, str] = {}
    deletions = []
    for n in sorted(nodes, key=lambda n: -n.free_slots):
        bits = n.shards.get(vid)
        if not bits:
            continue
        for sid in bits.shard_ids():
            if sid in seen:
                deletions.append((sid, n.url))
            else:
                seen[sid] = n.url
    return deletions


async def execute_shard_move(env, move: ShardMove, collection: str = "") -> None:
    """Copy, then mount on the target; unmount, then delete on the source
    (ref command_ec_balance.go moveMountedShardToEcNode)."""
    tstub = env.volume_stub(move.target)
    r = await tstub.call(
        "VolumeEcShardsCopy",
        {
            "volume_id": move.vid,
            "collection": collection,
            "shard_ids": [move.shard_id],
            "copy_ecx_file": True,
            "source_data_node": move.source,
        },
        timeout=300,
    )
    if r.get("error"):
        raise RuntimeError(f"copy shard {move}: {r['error']}")
    r = await tstub.call(
        "VolumeEcShardsMount",
        {"volume_id": move.vid, "collection": collection,
         "shard_ids": [move.shard_id]},
    )
    if r.get("error"):
        raise RuntimeError(f"mount shard {move}: {r['error']}")
    sstub = env.volume_stub(move.source)
    await sstub.call(
        "VolumeEcShardsUnmount",
        {"volume_id": move.vid, "shard_ids": [move.shard_id]},
    )
    await sstub.call(
        "VolumeEcShardsDelete",
        {"volume_id": move.vid, "collection": collection,
         "shard_ids": [move.shard_id]},
    )
