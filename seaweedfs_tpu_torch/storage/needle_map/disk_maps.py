"""Disk-backed needle maps for low-memory volume servers.

Two variants mirroring the reference's non-memory mappers:

- `SqliteNeedleMap` — the LevelDB-class map (ref:
  weed/storage/needle_map_leveldb.go:27): key→(offset,size) lives in an
  on-disk B-tree (sqlite, stdlib — goleveldb's role) regenerated from the
  .idx log when stale; writes append to .idx first, then update the db.
- `SortedFileNeedleMap` — read-only binary-searchable sorted index (ref:
  weed/storage/needle_map_sorted_file.go:19): probes an .sdx file produced
  by sorting the .idx; Put is invalid, Delete tombstones in place.

Both recompute `MapMetric` by replaying the .idx
(ref: needle_map_metric.go newNeedleMapMetricFromIndexFile).

Ported from the JAX package's storage/needle_map/disk_maps.py with the
same `.ldb` schema, so either package opens the other's file. Keys of
2^63 and above do not fit sqlite's signed INTEGER: `put` raises
OverflowError, as the JAX map does. Both maps trust a derived file
(`.ldb`, `.sdx`) whose mtime is newer than its `.idx`; a vacuum commit,
which replaces the `.idx` wholesale, removes them (storage/vacuum.py).
"""

from __future__ import annotations

import os
import sqlite3
import threading
from typing import Optional

import numpy as np

from ...types import TOMBSTONE_FILE_SIZE
from ..backend import DiskFile
from ..idx import entry_to_bytes, iter_index
from .metric import MapMetric
from .needle_value import NeedleValue


def metric_from_index_file(idx_path: str) -> MapMetric:
    """Replay the .idx log into counters (ref needle_map_metric.go:88-118)."""
    m = MapMetric()
    seen: dict[int, int] = {}
    if os.path.exists(idx_path):
        with open(idx_path, "rb") as f:
            for key, offset_units, size in iter_index(f):
                m.maybe_set_max_file_key(key)
                if offset_units > 0 and size != TOMBSTONE_FILE_SIZE:
                    m.log_put(key, seen.get(key, 0), size)
                    seen[key] = size
                else:
                    m.log_delete(seen.pop(key, 0))
    return m


class _MetricProperties:
    metric: MapMetric

    @property
    def file_count(self) -> int:
        return self.metric.file_count

    @property
    def deleted_count(self) -> int:
        return self.metric.deletion_count

    @property
    def content_size(self) -> int:
        return self.metric.content_size

    @property
    def deleted_size(self) -> int:
        return self.metric.deleted_size

    @property
    def max_file_key(self) -> int:
        return self.metric.maximum_file_key

    def snapshot(self):
        """Sorted (keys, offsets, sizes) columns for bulk probes on the card
        (K1, ops/index_kernel.py) — same contract as CompactMap.snapshot."""
        keys, offs, sizes = [], [], []

        def visit(nv: NeedleValue) -> None:
            if nv.size != TOMBSTONE_FILE_SIZE:
                keys.append(nv.key)
                offs.append(nv.offset_units)
                sizes.append(nv.size)

        self.ascending_visit(visit)
        return (
            np.asarray(keys, dtype=np.uint64),
            np.asarray(offs, dtype=np.uint64),
            np.asarray(sizes, dtype=np.uint32),
        )


class SqliteNeedleMap(_MetricProperties):
    """LevelDB-class disk-backed mapper. The db file is `<base>.ldb`;
    freshness = db mtime newer than idx mtime (ref isLevelDbFresh)."""

    def __init__(self, idx_path: str):
        self.idx_path = idx_path
        self.db_path = idx_path[: -len(".idx")] + ".ldb"
        fresh = (
            os.path.exists(self.db_path)
            and os.path.exists(idx_path)
            and os.path.getmtime(self.db_path) > os.path.getmtime(idx_path)
        )
        self._idx = DiskFile(idx_path, create=True)
        # executor threads (group-commit fsync batches, vacuum) share this
        # connection; serialize access ourselves
        self._db_lock = threading.RLock()
        self.db = sqlite3.connect(self.db_path, check_same_thread=False)
        self.db.execute(
            "CREATE TABLE IF NOT EXISTS needles"
            " (key INTEGER PRIMARY KEY, offset INTEGER, size INTEGER)"
        )
        if not fresh:
            self._generate_db_from_idx()
        self.metric = metric_from_index_file(idx_path)
        self._mutations = 0

    def _generate_db_from_idx(self) -> None:
        self.db.execute("DELETE FROM needles")
        if os.path.exists(self.idx_path):
            with open(self.idx_path, "rb") as f:
                rows = []
                for key, offset_units, size in iter_index(f):
                    if offset_units > 0 and size != TOMBSTONE_FILE_SIZE:
                        rows.append((key, offset_units, size))
                    else:
                        # idx entries must apply strictly in order: flush
                        # buffered puts before the delete, or a
                        # put-then-delete of the same key inside one batch
                        # would resurrect the deleted needle
                        self._put_rows(rows)
                        rows = []
                        self.db.execute(
                            "DELETE FROM needles WHERE key=?", (key,)
                        )
                    if len(rows) >= 10000:
                        self._put_rows(rows)
                        rows = []
                self._put_rows(rows)
        self.db.commit()

    def _put_rows(self, rows) -> None:
        self.db.executemany(
            "INSERT OR REPLACE INTO needles VALUES (?,?,?)", rows
        )

    def put(self, key: int, offset_units: int, size: int) -> None:
        # idx first (ref LevelDbNeedleMap.Put: appendToIndexFile then db)
        with self._db_lock:
            old = self.db.execute(
                "SELECT size FROM needles WHERE key=?", (key,)
            ).fetchone()
            self._idx.append(entry_to_bytes(key, offset_units, size))
            self._put_rows([(key, offset_units, size)])
            self.metric.log_put(key, old[0] if old else 0, size)
            self._mutations += 1

    def put_batch(self, entries) -> None:
        """Many puts, one .idx append + one executemany (the batch
        append's map half for the leveldb-class mapper). A `pending`
        overlay keeps intra-batch duplicate keys honest: the deferred
        executemany means the SELECT alone would miss an earlier entry
        of the same batch and under-count the superseded copy's
        deletion bytes (the metric vacuum's garbage ratio feeds on)."""
        with self._db_lock:
            blob = bytearray()
            rows = []
            pending: dict = {}
            for key, offset_units, size in entries:
                old_size = pending.get(key)
                if old_size is None:
                    row = self.db.execute(
                        "SELECT size FROM needles WHERE key=?", (key,)
                    ).fetchone()
                    old_size = row[0] if row else 0
                blob += entry_to_bytes(key, offset_units, size)
                rows.append((key, offset_units, size))
                self.metric.log_put(key, old_size, size)
                pending[key] = size
                self._mutations += 1
            if blob:
                self._idx.append(bytes(blob))
                self._put_rows(rows)

    def get(self, key: int) -> Optional[NeedleValue]:
        with self._db_lock:
            row = self.db.execute(
                "SELECT offset, size FROM needles WHERE key=?", (key,)
            ).fetchone()
        if row is None:
            return None
        return NeedleValue(key=key, offset_units=row[0], size=row[1])

    def delete(self, key: int, offset_units: int) -> None:
        with self._db_lock:
            row = self.db.execute(
                "SELECT size FROM needles WHERE key=?", (key,)
            ).fetchone()
            self._idx.append(
                entry_to_bytes(key, offset_units, TOMBSTONE_FILE_SIZE)
            )
            self.db.execute("DELETE FROM needles WHERE key=?", (key,))
            self.metric.log_delete(row[0] if row else 0)
            self._mutations += 1

    def ascending_visit(self, visit) -> None:
        with self._db_lock:
            rows = list(
                self.db.execute(
                    "SELECT key, offset, size FROM needles ORDER BY key"
                )
            )
        for key, offset_units, size in rows:
            visit(NeedleValue(key=key, offset_units=offset_units, size=size))

    def snapshot_token(self) -> int:
        return self._mutations

    def index_file_size(self) -> int:
        return self._idx.size()

    def sync(self) -> None:
        with self._db_lock:
            self._idx.sync()
            self.db.commit()

    def close(self) -> None:
        with self._db_lock:
            self.db.commit()
            self.db.close()
        # mark the db fresh relative to the idx for the next open
        os.utime(self.db_path)
        self._idx.close()

    def destroy(self) -> None:
        self.close()
        for p in (self.idx_path, self.db_path):
            if os.path.exists(p):
                os.remove(p)


class SortedFileNeedleMap(_MetricProperties):
    """Read-only sorted-file mapper over `<base>.sdx`
    (ref: weed/storage/needle_map_sorted_file.go:19-108)."""

    def __init__(self, idx_path: str):
        from ..erasure_coding.ec_volume import NeedleNotFound  # noqa: F401
        from ..erasure_coding.encoder import write_sorted_file_from_idx

        self.idx_path = idx_path
        base = idx_path[: -len(".idx")]
        self.sdx_path = base + ".sdx"
        fresh = (
            os.path.exists(self.sdx_path)
            and os.path.exists(idx_path)
            and os.path.getmtime(self.sdx_path) > os.path.getmtime(idx_path)
        )
        if not fresh:
            write_sorted_file_from_idx(base, ".sdx")
        self._idx = DiskFile(idx_path, create=True)
        self._sdx = open(self.sdx_path, "r+b")
        self._sdx_size = os.path.getsize(self.sdx_path)
        self.metric = metric_from_index_file(idx_path)

    def _search(self, key: int, process_fn=None) -> Optional[tuple[int, int]]:
        from ..erasure_coding.ec_volume import (
            NeedleNotFound,
            search_needle_from_sorted_index,
        )

        try:
            return search_needle_from_sorted_index(
                self._sdx, self._sdx_size, key, process_fn
            )
        except NeedleNotFound:
            return None

    def put(self, key: int, offset_units: int, size: int) -> None:
        raise OSError("sorted-file needle map is read-only")

    def get(self, key: int) -> Optional[NeedleValue]:
        found = self._search(key)
        if found is None or found[1] == TOMBSTONE_FILE_SIZE:
            return None
        return NeedleValue(key=key, offset_units=found[0], size=found[1])

    def delete(self, key: int, offset_units: int) -> None:
        from ..erasure_coding.ec_volume import mark_needle_deleted

        found = self._search(key)
        if found is None or found[1] == TOMBSTONE_FILE_SIZE:
            return
        # idx first, then tombstone the .sdx entry in place
        self._idx.append(
            entry_to_bytes(key, offset_units, TOMBSTONE_FILE_SIZE)
        )
        self._search(key, mark_needle_deleted)
        self.metric.log_delete(found[1])
        self._mutations = getattr(self, "_mutations", 0) + 1

    def ascending_visit(self, visit) -> None:
        with open(self.sdx_path, "rb") as f:
            for key, offset_units, size in iter_index(f):
                visit(
                    NeedleValue(key=key, offset_units=offset_units, size=size)
                )

    def snapshot_token(self) -> int:
        return getattr(self, "_mutations", 0)

    def index_file_size(self) -> int:
        return self._idx.size()

    def sync(self) -> None:
        self._idx.sync()
        self._sdx.flush()
        os.fsync(self._sdx.fileno())

    def close(self) -> None:
        self._sdx.close()
        self._idx.close()

    def destroy(self) -> None:
        self.close()
        for p in (self.idx_path, self.sdx_path):
            if os.path.exists(p):
                os.remove(p)
