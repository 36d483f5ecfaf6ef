"""Needle maps: fid -> (offset, size) indexes.

The mapper contract follows the reference's NeedleMapper interface
(ref: weed/storage/needle_map.go:21-34): Put/Get/Delete/AscendingVisit plus
metrics. Every map can emit a sorted-array snapshot (numpy u64/u32 columns)
consumed by the bulk-lookup kernel in ops/index_kernel.py, and the LSM map
hands its sealed runs to the ragged arena (ops/ragged_lookup.py).

Every map kind of the JAX package is here: the in-memory CompactMap/
NeedleMap, the LSM map, the sqlite ("leveldb") and sorted-file maps
(disk_maps.py), and MemDb, the scratch map of EC encodes and vacuum.
"""

from .needle_value import NeedleValue
from .compact_map import CompactMap
from .memdb import MemDb
from .metric import MapMetric
from .mapper import NeedleMap, new_needle_map, load_needle_map
from .lsm_map import (
    LsmNeedleMap,
    load_lsm_needle_map,
    new_lsm_needle_map,
)

__all__ = [
    "NeedleValue",
    "CompactMap",
    "MemDb",
    "MapMetric",
    "NeedleMap",
    "new_needle_map",
    "load_needle_map",
    "LsmNeedleMap",
    "load_lsm_needle_map",
    "new_lsm_needle_map",
]
