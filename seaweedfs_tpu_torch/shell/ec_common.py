"""Shared EC orchestration helpers (ref: weed/shell/command_ec_common.go).

Copied from the JAX package's shell/ec_common.py: `EcNode`,
`nodes_from_topology` and the pure planner `plan_balanced_spread` that
ec.encode uses. The rack-balance and dedupe planners and the shard move
belong to ec.balance, which the port does not serve yet."""

from __future__ import annotations

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
