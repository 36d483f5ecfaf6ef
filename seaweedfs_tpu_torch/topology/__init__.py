"""Cluster topology: DataCenter/Rack/DataNode tree, volume layouts,
replica placement, EC shard registry (ref: weed/topology/).

Copied from the JAX package's topology/ (node, volume_layout,
volume_growth, topology, vacuum_plan, and repair's task queue) with the
state snapshots the vacuum scheduler reads (Topology.live_data_nodes,
replica_states), without those of the planes the port does not serve yet
(ec_states, placement_states, placement_candidates, ec_heat_states,
DataNode.ec_heat; the placement, lifecycle and repair planners)."""

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
