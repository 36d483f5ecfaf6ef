"""Cluster topology: DataCenter/Rack/DataNode tree, volume layouts,
replica placement, EC shard registry (ref: weed/topology/).

Copied from the JAX package's topology/ (node, volume_layout,
volume_growth, topology, vacuum_plan, repair with its task queue and
planners, placement) with the state snapshots the vacuum and
anti-entropy schedulers read (Topology.live_data_nodes, ec_states,
replica_states, placement_states, placement_candidates), without those
of the lifecycle plane the port does not serve yet (ec_heat_states,
DataNode.ec_heat; lifecycle's planners)."""

from .node import DataCenter, DataNode, Rack
from .topology import Topology
from .volume_layout import VolumeLayout
from .volume_growth import VolumeGrowth, GrowOption

__all__ = [
    "DataCenter",
    "DataNode",
    "Rack",
    "Topology",
    "VolumeLayout",
    "VolumeGrowth",
    "GrowOption",
]
