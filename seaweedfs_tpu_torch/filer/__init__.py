"""Filer: a directory/file namespace over the object store
(ref: weed/filer2/). Entries carry chunk lists pointing at needle fids;
stores are pluggable (memory, sqlite standing in for the reference's
leveldb/sql family, an append-only log, the LSM store whose path lookups
the meta gate answers on the card's ragged_lookup kernel, and the
prefix-sharded store over any of them). The scale-out beside the stores:
the range-owning fleet (fleet.py), the meta-log-fed read replica
(meta_follower.py) and the peer aggregator (meta_aggregator.py).

Ported from the JAX package's filer/."""

from .entry import Attr, Entry, FileChunk, new_directory_entry
from .filechunks import (
    VisibleInterval,
    etag,
    non_overlapping_visible_intervals,
    read_from_visible_intervals,
    total_size,
    view_from_visibles,
)
from .filer import Filer
from .filer_store import (
    FilerStore,
    LogFilerStore,
    MemoryFilerStore,
    SqliteFilerStore,
    scan_subtree,
)
from .lsm_store import LsmFilerStore, path_hash64
from .meta_gate import MetaLookupGate, MetaWriteGate
from .meta_log import DurableMetaLog, MetaLog, MetaLogTrimmed
from .sharded_store import ShardedFilerStore

__all__ = [
    "Attr",
    "Entry",
    "FileChunk",
    "new_directory_entry",
    "VisibleInterval",
    "etag",
    "non_overlapping_visible_intervals",
    "read_from_visible_intervals",
    "total_size",
    "view_from_visibles",
    "Filer",
    "FilerStore",
    "LogFilerStore",
    "MemoryFilerStore",
    "SqliteFilerStore",
    "scan_subtree",
    "LsmFilerStore",
    "path_hash64",
    "MetaLookupGate",
    "MetaWriteGate",
    "DurableMetaLog",
    "MetaLog",
    "MetaLogTrimmed",
    "ShardedFilerStore",
]
