"""Cluster topology: DataCenter/Rack/DataNode tree, volume layouts,
replica placement, EC shard registry (ref: weed/topology/).

Copied from the JAX package's topology/ (node, volume_layout,
volume_growth, topology) without the state snapshots its planners read
(Topology.live_data_nodes, ec_states, replica_states, placement_states,
placement_candidates, ec_heat_states and DataNode.ec_heat): the planners
(placement, repair, vacuum_plan, lifecycle) belong to master planes the
port does not serve yet."""

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
