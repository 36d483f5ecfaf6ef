"""LsmNeedleMap: memory-bounded out-of-core needle map + instant mount.

The billion-needle problem (PAPER.md layer map): the reference ships
LevelDB and sorted-file needle maps precisely because a pure in-memory
map's resident bytes and its O(needles) mount replay are what cap
needles-per-server — lookup latency never was the limit. Our `memory`
kind (CompactMap) rebuilds a Python dict from the whole `.idx` at every
mount, and the seed-era `SqliteNeedleMap` regenerates its B-tree when
stale; both pay O(needles) wall before the first read.

This module is the LSM answer, built from parts the repo already
proves out:

- a SMALL in-memory memtable (dict) takes the write path, byte-bounded
  by MEMTABLE_BYTES (4 MiB) unless the map is given a budget;
- full memtables flush to immutable SORTED RUNS: flat columnar files
  (keys u64 | offsets u32/u64 | sizes u32, native little-endian) probed
  zero-copy through ``np.memmap`` + binary search — the `.ecx`
  machinery's shape, laid out as the flat device-friendly columns the
  ragged arena (ops/ragged_lookup.py) uploads for the lookup gate's
  batch probes;
- runs merge TIERED, smallest-adjacent-pair first, newest rank wins,
  tombstones dropped only when the merge includes rank 0;
- a crash-safe SNAPSHOT manifest (`<base>.nmm`, shadow-write + rename,
  torn shadows swept at load like the vacuum `.cpd/.cpx` sweep) records
  which `.idx` byte prefix the runs fold, so mount = mmap the runs +
  replay only the `.idx` TAIL past that frontier — O(tail), not
  O(needles). The `.idx` log stays the single durability authority:
  every put/delete appends there first, and a lost/garbage/stale
  snapshot only ever costs a (vectorized) full rebuild, never data.

Staleness binding: a manifest is honored only when (a) the `.idx` is at
least `idx_covered` bytes long, aligned, AND (b) the last index entry of
the covered prefix byte-matches the manifest's recorded copy. Paths that
REWRITE the `.idx` wholesale (vacuum commit, repair recopy, `weed fix`)
additionally call :func:`invalidate_snapshot` explicitly — the binding
is the belt-and-braces for a crash between the rewrite and the
invalidation.

Run files, bloom sidecars and the manifest are byte-compatible with the
JAX package's: the manifest is MessagePack, encoded and decoded by the
port's own util/mpack.py.
"""

from __future__ import annotations

import os
import struct
import threading
import time
from typing import Optional

import numpy as np

from ...types import (
    NEEDLE_CHECKSUM_SIZE,
    NEEDLE_HEADER_SIZE,
    NEEDLE_MAP_ENTRY_SIZE,
    NEEDLE_PADDING_SIZE,
    OFFSET_SIZE,
    TIMESTAMP_SIZE,
    TOMBSTONE_FILE_SIZE,
    VERSION3,
)
from ...util import mpack
from ..backend import DiskFile
from ..idx import entry_to_bytes, fold_live_columns, parse_index_bytes
from .metric import MapMetric
from .needle_value import NeedleValue

# run file header: magic | version | offset width | pad | count | tombs
_RUN_MAGIC = b"SWNR"
_RUN_HEADER = struct.Struct("<4sBBHII")
assert _RUN_HEADER.size == 16

_OFF_DTYPE = np.dtype("<u4") if OFFSET_SIZE == 4 else np.dtype("<u8")
_TOMB = np.uint32(TOMBSTONE_FILE_SIZE)

MANIFEST_EXT = ".nmm"
RUN_EXT_PREFIX = ".nmr-"
BLOOM_EXT = ".bf"

# per-run bloom filters: built at seal from the
# run's key column, mmap'd at mount, consulted before the binary search
# so multi-run volumes skip searchsorted on absent keys. Purely an
# optimization sidecar: a missing/torn/mismatched .bf just means no
# filter for that run (and is swept with its run).
BLOOM_ENABLED = True
BLOOM_BITS_PER_KEY = 10
# minimum run count before lookups consult the filters at all: below it
# one searchsorted happens either way and the filter is pure overhead
BLOOM_MIN_RUNS = 2
_BLOOM_MAGIC = b"SWBF"
_BLOOM_HEADER = struct.Struct("<4sBBHQI")  # magic|ver|k|pad|mbits|count
_BLOOM_BASE = _BLOOM_HEADER.size  # bitmap offset in the sidecar file
_M64 = (1 << 64) - 1


def _bloom_geometry(count: int) -> tuple[int, int]:
    """(mbits power-of-two, k hashes) for a run of `count` keys.

    k is pinned LOW (2) on purpose: the probe runs in scalar Python on
    the read path, so its cost scales with k while the saved work (one
    searchsorted page walk) is fixed — at >=10 bits/key, k=2 gives a
    ~3% false-positive rate, i.e. ~97% of absent probes skip the
    binary search for ~2 byte reads, which nets out far ahead of the
    information-theoretic-optimal k that would LOSE wall time here."""
    want = max(64, count * BLOOM_BITS_PER_KEY)
    mbits = 1 << (want - 1).bit_length()
    return mbits, 2


def _mix64_scalar(x: int) -> int:
    """murmur3 finalizer — the scalar twin of the vectorized build (the
    two MUST agree bit-for-bit or probes would miss live keys)."""
    x &= _M64
    x ^= x >> 33
    x = (x * 0xFF51AFD7ED558CCD) & _M64
    x ^= x >> 33
    x = (x * 0xC4CEB9FE1A85EC53) & _M64
    x ^= x >> 33
    return x


def mix64_batch(keys: np.ndarray) -> np.ndarray:
    """Vectorized murmur3 finalizer — MUST agree bit-for-bit with
    `_mix64_scalar` (shared by the sidecar build, the ragged device
    kernel's host-side bloom addressing, and the scalar probe path)."""
    h = np.asarray(keys, dtype=np.uint64).copy()
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xFF51AFD7ED558CCD)
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xC4CEB9FE1A85EC53)
    h ^= h >> np.uint64(33)
    return h


def _write_bloom(run_path: str, keys: np.ndarray) -> None:
    """Sidecar `<run>.bf` built from the sealed run's key column
    (vectorized double hashing; tmp + rename so a torn write is never
    loaded)."""
    count = len(keys)
    mbits, k = _bloom_geometry(count)
    h = mix64_batch(keys)
    mask = np.uint64(mbits - 1)
    h1 = h & mask
    h2 = (h >> np.uint64(32)) | np.uint64(1)
    bits = np.zeros(mbits >> 3, dtype=np.uint8)
    for i in range(k):
        pos = (h1 + np.uint64(i) * h2) & mask
        np.bitwise_or.at(
            bits, (pos >> np.uint64(3)).astype(np.int64),
            (np.uint8(1) << (pos & np.uint64(7)).astype(np.uint8)),
        )
    tmp = run_path + BLOOM_EXT + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_BLOOM_HEADER.pack(_BLOOM_MAGIC, 1, k, 0, mbits, count))
        f.write(bits.tobytes())
    os.replace(tmp, run_path + BLOOM_EXT)

# resident-memory budget per volume map (the memtable bound); a dict
# entry (key int + 2-tuple of ints + table slot) measures ~120 bytes on
# CPython 3.10-3.12, so the default 4MB holds ~35k entries per volume
MEMTABLE_BYTES = 4 << 20
_ENTRY_COST = 120
MAX_RUNS = 6


# ---------------------------------------------------------------- metrics --
# module-level aggregates: per-map contributions keyed by id(map), summed
# into the needle_map_* gauges at flush/load/close events (never per-op)
_AGG_LOCK = threading.Lock()
_RESIDENT: dict[int, int] = {}
_RUN_COUNTS: dict[int, int] = {}


def _publish_aggregates() -> None:
    from ...util.metrics import NEEDLE_MAP_RESIDENT_BYTES, NEEDLE_MAP_RUN_COUNT

    with _AGG_LOCK:
        resident = sum(_RESIDENT.values())
        runs = sum(_RUN_COUNTS.values())
    NEEDLE_MAP_RESIDENT_BYTES.set(resident, kind="lsm")
    NEEDLE_MAP_RUN_COUNT.set(runs, kind="lsm")


def _drop_aggregates(map_id: int) -> None:
    with _AGG_LOCK:
        _RESIDENT.pop(map_id, None)
        _RUN_COUNTS.pop(map_id, None)
    _publish_aggregates()


# ------------------------------------------------------------ shared fold --


def metric_from_columns(
    keys: np.ndarray, offsets: np.ndarray, sizes: np.ndarray
) -> MapMetric:
    """Exact vectorized equivalent of replaying the log through
    MapMetric (disk_maps.metric_from_index_file): every put counts into
    file_count/bytes; a put superseded by ANY later entry of its key is
    a deletion of its size (zero-size puts never count deletions, and
    tombstone appends count nothing of their own)."""
    m = MapMetric()
    n = len(keys)
    if n == 0:
        return m
    m.maximum_file_key = int(keys.max())
    put = (offsets != 0) & (sizes != _TOMB)
    m.file_count = int(put.sum())
    m.file_byte_count = int(sizes[put].astype(np.int64).sum())
    _uniq, rev_first = np.unique(keys[::-1], return_index=True)
    newest = np.zeros(n, dtype=bool)
    newest[n - 1 - rev_first] = True
    superseded = put & ~newest & (sizes > 0)
    m.deletion_count = int(superseded.sum())
    m.deletion_byte_count = int(sizes[superseded].astype(np.int64).sum())
    return m


def _record_ends(
    offsets: np.ndarray, sizes: np.ndarray, version: int
) -> np.ndarray:
    """Vectorized on-disk end offset of each entry's record (same
    arithmetic as volume.expected_dat_frontier)."""
    body = np.where(sizes == _TOMB, 0, sizes).astype(np.int64)
    base = (
        NEEDLE_HEADER_SIZE
        + body
        + NEEDLE_CHECKSUM_SIZE
        + (TIMESTAMP_SIZE if version == VERSION3 else 0)
    )
    return offsets.astype(np.int64) * NEEDLE_PADDING_SIZE + base + (
        8 - base % 8
    )


# ------------------------------------------------------------------- runs --


class _Run:
    """One immutable sorted run, mmap'd columnar: binary-searchable keys
    plus parallel offset/size columns. Tombstone entries (size ==
    TOMBSTONE_FILE_SIZE) shadow older runs until a rank-0 merge drops
    them; `tombs` in the header makes "pure live run" checkable without
    a scan (the zero-copy snapshot fast path)."""

    __slots__ = (
        "path", "count", "tombs", "keys", "offs", "sizes",
        "bloom", "bloom_k", "bloom_mbits", "bloom_probes", "bloom_neg",
        "_arena_seg",
    )

    def __init__(self, path: str):
        self.path = path
        self._arena_seg = None  # lazily-built DeviceColumnArena descriptor
        self.bloom = None
        self.bloom_k = 0
        self.bloom_mbits = 0
        self.bloom_probes = 0  # get() calls that consulted the filter
        self.bloom_neg = 0  # probes the filter short-circuited
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(_RUN_HEADER.size)
        magic, ver, offw, _pad, count, tombs = _RUN_HEADER.unpack(head)
        if magic != _RUN_MAGIC or ver != 1 or offw != _OFF_DTYPE.itemsize:
            raise ValueError(f"bad run header in {path}")
        expect = _RUN_HEADER.size + count * (8 + offw + 4)
        if size != expect:
            raise ValueError(f"run {path}: size {size} != expected {expect}")
        self.count = count
        self.tombs = tombs
        off = _RUN_HEADER.size
        self.keys = np.memmap(
            path, dtype="<u8", mode="r", offset=off, shape=(count,)
        )
        off += count * 8
        self.offs = np.memmap(
            path, dtype=_OFF_DTYPE, mode="r", offset=off, shape=(count,)
        )
        off += count * offw
        self.sizes = np.memmap(
            path, dtype="<u4", mode="r", offset=off, shape=(count,)
        )
        if BLOOM_ENABLED:
            self._load_bloom()

    def _load_bloom(self) -> None:
        path = self.path + BLOOM_EXT
        try:
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                head = f.read(_BLOOM_HEADER.size)
            magic, ver, k, _pad, mbits, count = _BLOOM_HEADER.unpack(head)
        except (OSError, struct.error):
            return
        if (
            magic != _BLOOM_MAGIC
            or ver != 1
            or k != 2  # get()'s probe is unrolled for exactly k=2: a
            # foreign/other-k sidecar would yield FALSE NEGATIVES
            # (live needles reported absent) — run unfiltered instead
            or count != self.count
            or mbits & (mbits - 1)
            or size != _BLOOM_HEADER.size + (mbits >> 3)
        ):
            return  # stale/torn/incompatible sidecar: no filter
        import mmap as _mmap

        with open(path, "rb") as f:
            # raw mmap, not np.memmap: the probe is SCALAR byte
            # indexing on the hot path, and numpy's per-index overhead
            # (~µs) would cost more than the searchsorted it skips —
            # mmap subscripting is tens of ns and still page-cache
            # backed, zero-copy
            self.bloom = _mmap.mmap(
                f.fileno(), 0, access=_mmap.ACCESS_READ
            )
        self.bloom_k = k
        self.bloom_mbits = mbits

    def _bloom_test(self, h: int) -> bool:
        """Filter membership from the PRE-MIXED hash (the caller mixes
        once per probe, however many runs consult it): k byte reads off
        the raw mmap plus a handful of int ops — cheaper than the
        searchsorted page walk it saves on absent keys."""
        mask = self.bloom_mbits - 1
        h1 = h & mask
        h2 = (h >> 32) | 1
        bits = self.bloom
        base = _BLOOM_HEADER.size
        for i in range(self.bloom_k):
            pos = (h1 + i * h2) & mask
            if not (bits[base + (pos >> 3)] & (1 << (pos & 7))):
                return False
        return True

    def get(
        self, key: int, bloom_hash: Optional[int] = None
    ) -> Optional[tuple[int, int]]:
        """(offset_units, size) — size may be the tombstone sentinel —
        or None when the key is not in this run. The filter is
        consulted only when the caller supplies the pre-mixed
        `bloom_hash` — a single-run map skips it entirely (nothing to
        shortcut: one search happens either way) and a multi-run probe
        mixes once for all runs. The k=2 test is INLINED and unrolled:
        a separate call per run would cost more than the searchsorted
        it skips."""
        bits = self.bloom
        if bits is not None and bloom_hash is not None:
            self.bloom_probes += 1
            mask = self.bloom_mbits - 1
            pos = bloom_hash & mask
            if not (bits[_BLOOM_BASE + (pos >> 3)] & (1 << (pos & 7))):
                self.bloom_neg += 1
                return None
            pos = (pos + ((bloom_hash >> 32) | 1)) & mask
            if not (bits[_BLOOM_BASE + (pos >> 3)] & (1 << (pos & 7))):
                self.bloom_neg += 1
                return None
        if self.count == 0:
            return None
        # the probe value MUST be np.uint64: a Python int against a u64
        # column has no safe common integer type, so numpy silently
        # promotes the WHOLE column to float64 — an O(n) copy per probe
        # (1.3ms at 2M entries) instead of an O(log n) binary search
        i = int(self.keys.searchsorted(np.uint64(key)))
        if i >= self.count or int(self.keys[i]) != key:
            return None
        return int(self.offs[i]), int(self.sizes[i])

    def columns(self):
        return self.keys, self.offs, self.sizes

    def arena_segment(self):
        """Immutable DeviceColumnArena descriptor for this run, built
        once and cached (runs never change content, so residency keyed
        by the descriptor's handle can never go stale). The bloom
        sidecar's bitmap rides along as a u32 word view over the same
        mmap — the device-side pre-filter for multi-run probes."""
        seg = self._arena_seg
        if seg is None:
            from ...ops.ragged_lookup import ArenaSegment

            bloom_words = None
            mbits = 0
            if self.bloom is not None and self.bloom_k == 2:
                bloom_words = np.frombuffer(
                    memoryview(self.bloom)[_BLOOM_BASE:], dtype="<u4"
                )
                mbits = self.bloom_mbits
            seg = self._arena_seg = ArenaSegment(
                keys=self.keys,
                offs=self.offs,
                sizes=self.sizes,
                bloom_words=bloom_words,
                bloom_mbits=mbits,
                source=self,
                # compaction closes superseded runs; the arena prunes
                # them at its next refresh instead of re-pinning forever
                alive=lambda run=self: run.keys is not None,
            )
        return seg

    def close(self) -> None:
        # np.memmap holds the mapping via ._mmap; dropping the views is
        # enough for the refcount, but close explicitly so a destroy()
        # on platforms with strict unlink semantics can proceed
        for col in (self.keys, self.offs, self.sizes):
            mm = getattr(col, "_mmap", None)
            if mm is not None:
                try:
                    mm.close()
                except (BufferError, ValueError):
                    pass  # another live view pins the mapping; gc owns it
        if self.bloom is not None:
            try:
                self.bloom.close()
            except (BufferError, ValueError):
                pass
        self.keys = self.offs = self.sizes = self.bloom = None


def _write_run(
    path: str, keys: np.ndarray, offs: np.ndarray, sizes: np.ndarray
) -> None:
    """Write one sorted run atomically (tmp + fsync + rename): a torn
    run can never carry a valid header+size pair, and an unreferenced
    `.tmp` is swept at load."""
    keys = np.ascontiguousarray(keys, dtype="<u8")
    offs = np.ascontiguousarray(offs, dtype=_OFF_DTYPE)
    sizes = np.ascontiguousarray(sizes, dtype="<u4")
    tombs = int((sizes == _TOMB).sum())
    head = _RUN_HEADER.pack(
        _RUN_MAGIC, 1, _OFF_DTYPE.itemsize, 0, len(keys), tombs
    )
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(head)
        f.write(keys.tobytes())
        f.write(offs.tobytes())
        f.write(sizes.tobytes())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    if BLOOM_ENABLED and len(keys):
        # sidecar AFTER the run is live: a crash between the two just
        # leaves a filterless run (correct, merely slower on absents)
        _write_bloom(path, keys)


# -------------------------------------------------------------- snapshots --


def _manifest_path(base: str) -> str:
    return base + MANIFEST_EXT


def _run_path(base: str, seq: int) -> str:
    return f"{base}{RUN_EXT_PREFIX}{seq}"


def sweep_snapshot_files(base: str, keep_seqs=()) -> int:
    """Remove run files (and manifest shadows) not named by `keep_seqs`
    — leftovers of an interrupted flush/merge, swept at load exactly
    like the vacuum compaction shadows. Returns how many were removed."""
    directory = os.path.dirname(base) or "."
    prefix = os.path.basename(base) + RUN_EXT_PREFIX
    keep = {f"{prefix}{seq}" for seq in keep_seqs} | {
        f"{prefix}{seq}{BLOOM_EXT}" for seq in keep_seqs
    }
    removed = 0
    try:
        names = os.listdir(directory)
    except OSError:
        return 0
    for fn in names:
        doomed = (
            (fn.startswith(prefix) and fn not in keep)
            or fn == os.path.basename(base) + MANIFEST_EXT + ".tmp"
        )
        if doomed:
            try:
                os.remove(os.path.join(directory, fn))
                removed += 1
            except OSError:
                pass
    return removed


def invalidate_snapshot(base: str) -> None:
    """Drop the persisted snapshot (manifest + every run) for a volume
    base. MUST be called by any path that rewrites the `.idx` wholesale
    — vacuum commit, repair recopy, `weed fix` — because the snapshot
    folds a byte prefix of the OLD log. Removing the manifest first
    makes the operation crash-safe: runs without a manifest are ignored
    and swept at the next load."""
    try:
        os.remove(_manifest_path(base))
    except FileNotFoundError:
        pass
    sweep_snapshot_files(base)


def _load_manifest(base: str) -> Optional[dict]:
    path = _manifest_path(base)
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            mf = mpack.unpackb(f.read())
    except Exception:
        return None
    if not isinstance(mf, dict) or mf.get("version") != 1:
        return None
    if mf.get("offset_size") != OFFSET_SIZE:
        return None  # 4/5-byte offset variant flip: rebuild
    return mf


def _save_manifest(base: str, mf: dict) -> None:
    path = _manifest_path(base)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(mpack.packb(mf))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


# ------------------------------------------------------------------- map --


class LsmNeedleMap:
    """Memory-bounded needle map: memtable + mmap'd sorted runs.

    Same observable contract as the other mappers (put/get/delete,
    ascending_visit, snapshot columns, MapMetric accessors); `get` of a
    deleted key returns a tombstone NeedleValue while the tombstone
    still shadows older runs and None once a rank-0 merge dropped it —
    callers already treat both as dead (the SqliteNeedleMap precedent).
    """

    def __init__(
        self,
        idx_path: str,
        version: int = VERSION3,
        memtable_bytes: int = 0,
        max_runs: int = 0,
    ):
        self.idx_path = idx_path
        self.base = idx_path[: -len(".idx")]
        self.version = version
        self.memtable_limit = max(
            1024, (memtable_bytes or MEMTABLE_BYTES) // _ENTRY_COST
        )
        self.max_runs = max_runs or MAX_RUNS
        self._lock = threading.RLock()
        self._mem: dict[int, tuple[int, int]] = {}
        self._runs: list[_Run] = []  # oldest .. newest
        self._seqs: list[int] = []
        self._next_seq = 1
        self._mutations = 0
        self._snapshot_cache: Optional[tuple] = None
        self._snapshot_token_at: int = -1
        # bytes of .idx the runs fold (the tail-replay frontier) and the
        # running max record end (the .dat frontier, monotone so it
        # survives tombstone-dropping merges)
        self._idx_covered = 0
        self._dat_frontier = 0
        self.metric = MapMetric()
        self._idx = DiskFile(idx_path, create=True)
        # load-time disclosure (the mount bench + metrics read these)
        self.loaded_from_snapshot = False
        self.tail_entries_replayed = 0
        self.snapshot_age_s = 0.0
        self._load()

    # ---------------- load / rebuild ----------------
    def _load(self) -> None:
        mf = _load_manifest(self.base)
        if mf is not None and self._try_load_snapshot(mf):
            self.loaded_from_snapshot = True
        else:
            invalidate_snapshot(self.base)
            self._rebuild_from_idx()
        self._note_resident()

    def _try_load_snapshot(self, mf: dict) -> bool:
        covered = int(mf.get("idx_covered", -1))
        idx_size = self._idx.size()
        if (
            covered < 0
            or covered % NEEDLE_MAP_ENTRY_SIZE != 0
            or covered > idx_size
        ):
            return False
        # last-entry binding: the covered prefix must be the SAME log
        # this manifest folded — a wholesale .idx rewrite (vacuum/fix/
        # repair) that dodged explicit invalidation fails here
        tail16 = mf.get("idx_tail16", b"") or b""
        if covered == 0:
            if tail16 != b"":
                return False
        else:
            got = self._idx.read_at(
                NEEDLE_MAP_ENTRY_SIZE, covered - NEEDLE_MAP_ENTRY_SIZE
            )
            if got != tail16:
                return False
        runs: list[_Run] = []
        try:
            for seq in mf.get("runs", []):
                runs.append(_Run(_run_path(self.base, int(seq))))
        except (OSError, ValueError):
            for r in runs:
                r.close()
            return False
        self._runs = runs
        self._seqs = [int(s) for s in mf.get("runs", [])]
        self._next_seq = (max(self._seqs) + 1) if self._seqs else 1
        self._idx_covered = covered
        self._dat_frontier = int(mf.get("dat_frontier", 0))
        met = mf.get("metric", {})
        self.metric = MapMetric(
            maximum_file_key=int(met.get("maximum_file_key", 0)),
            file_count=int(met.get("file_count", 0)),
            deletion_count=int(met.get("deletion_count", 0)),
            file_byte_count=int(met.get("file_byte_count", 0)),
            deletion_byte_count=int(met.get("deletion_byte_count", 0)),
        )
        self.snapshot_age_s = max(
            0.0, time.time() - float(mf.get("saved_at", 0.0))
        )
        sweep_snapshot_files(self.base, keep_seqs=self._seqs)
        # O(tail): replay only the entries past the fold frontier
        self._replay_tail(covered, idx_size)
        from ...util.metrics import NEEDLE_MAP_SNAPSHOT_AGE, NEEDLE_MAP_TAIL_REPLAY

        NEEDLE_MAP_SNAPSHOT_AGE.set(round(self.snapshot_age_s, 3), kind="lsm")
        if self.tail_entries_replayed:
            NEEDLE_MAP_TAIL_REPLAY.inc(self.tail_entries_replayed)
        return True

    def _replay_tail(self, start: int, idx_size: int) -> None:
        usable = idx_size - ((idx_size - start) % NEEDLE_MAP_ENTRY_SIZE)
        if usable <= start:
            return
        data = self._idx.read_at(usable - start, start)
        keys, offs, sizes = parse_index_bytes(data)
        ends = _record_ends(offs, sizes, self.version)
        positional = offs != 0
        if positional.any():
            self._dat_frontier = max(
                self._dat_frontier, int(ends[positional].max())
            )
        for key, off, size in zip(
            keys.tolist(), offs.tolist(), sizes.tolist()
        ):
            if off != 0 and size != TOMBSTONE_FILE_SIZE:
                old = self._probe(key)
                self._mem[key] = (off, size)
                self.metric.log_put(
                    key, old[1] if old is not None else 0, size
                )
            else:
                self.metric.maybe_set_max_file_key(key)
                old = self._probe(key)
                if old is not None and old[1] != TOMBSTONE_FILE_SIZE:
                    self.metric.log_delete(old[1])
                self._mem[key] = (off, TOMBSTONE_FILE_SIZE)
        self._mutations += 1
        self.tail_entries_replayed = len(keys)
        # re-assert the resident bound: a mount whose snapshot trailed
        # by more than a memtable's worth of entries would otherwise
        # park the whole tail in memory until the next put (which, on a
        # now-read-only volume, never comes). One flush AFTER the full
        # replay — a mid-replay flush would stamp idx_covered past
        # entries not yet applied.
        if len(self._mem) >= self.memtable_limit:
            self._flush_memtable()

    def _rebuild_from_idx(self) -> None:
        """Full vectorized rebuild: one sequential read of the log, one
        newest-wins fold, one live-only run — the no-snapshot mount path
        (still far cheaper than a per-entry dict replay, and it leaves
        the persisted snapshot behind so the NEXT mount is O(tail))."""
        idx_size = self._idx.size()
        usable = idx_size - (idx_size % NEEDLE_MAP_ENTRY_SIZE)
        self._runs = []
        self._seqs = []
        self._next_seq = 1
        self._mem = {}
        if usable:
            data = self._idx.read_at(usable, 0)
            keys, offs, sizes = parse_index_bytes(data)
            self.metric = metric_from_columns(keys, offs, sizes)
            ends = _record_ends(offs, sizes, self.version)
            positional = offs != 0
            self._dat_frontier = (
                int(ends[positional].max()) if positional.any() else 0
            )
            lk, lo, ls = fold_live_columns(keys, offs, sizes)
            if len(lk):
                seq = self._next_seq
                _write_run(_run_path(self.base, seq), lk, lo, ls)
                self._runs = [_Run(_run_path(self.base, seq))]
                self._seqs = [seq]
                self._next_seq = seq + 1
        else:
            self.metric = MapMetric()
            self._dat_frontier = 0
        self._idx_covered = usable
        self._mutations += 1
        self._persist_manifest()

    # ---------------- persistence ----------------
    def _persist_manifest(self) -> None:
        # the .idx prefix the manifest claims must be DURABLE before the
        # manifest names it (flushes are rare; this is not the write path)
        self._idx.sync()
        covered = self._idx_covered
        tail16 = (
            self._idx.read_at(
                NEEDLE_MAP_ENTRY_SIZE, covered - NEEDLE_MAP_ENTRY_SIZE
            )
            if covered
            else b""
        )
        _save_manifest(
            self.base,
            {
                "version": 1,
                "offset_size": OFFSET_SIZE,
                "runs": list(self._seqs),
                "idx_covered": covered,
                "idx_tail16": bytes(tail16),
                "dat_frontier": self._dat_frontier,
                "frontier_ns": 0,
                "metric": {
                    "maximum_file_key": self.metric.maximum_file_key,
                    "file_count": self.metric.file_count,
                    "deletion_count": self.metric.deletion_count,
                    "file_byte_count": self.metric.file_byte_count,
                    "deletion_byte_count": self.metric.deletion_byte_count,
                },
                "saved_at": time.time(),
            },
        )
        sweep_snapshot_files(self.base, keep_seqs=self._seqs)

    def _flush_memtable(self) -> None:
        """Memtable -> one sorted run (tombstones KEPT: they must shadow
        older runs) + manifest; then tiered merges until the run count
        fits. The manifest's fold frontier advances to the current .idx
        size — everything in the memtable came from entries before it."""
        if not self._mem:
            return
        items = sorted(self._mem.items())
        keys = np.fromiter(
            (k for k, _ in items), dtype=np.uint64, count=len(items)
        )
        offs = np.fromiter(
            (v[0] for _, v in items), dtype=_OFF_DTYPE, count=len(items)
        )
        sizes = np.fromiter(
            (v[1] for _, v in items), dtype=np.uint32, count=len(items)
        )
        seq = self._next_seq
        _write_run(_run_path(self.base, seq), keys, offs, sizes)
        self._runs.append(_Run(_run_path(self.base, seq)))
        self._seqs.append(seq)
        self._next_seq = seq + 1
        self._mem = {}
        self._idx_covered = self._idx.size()
        while len(self._runs) > self.max_runs:
            self._merge_smallest_adjacent()
        self._persist_manifest()
        self._note_resident()

    def _merge_smallest_adjacent(self) -> None:
        sizes = [r.count for r in self._runs]
        lo = min(range(len(sizes) - 1), key=lambda j: sizes[j] + sizes[j + 1])
        a, b = self._runs[lo], self._runs[lo + 1]
        keys = np.concatenate([np.asarray(a.keys), np.asarray(b.keys)])
        offs = np.concatenate([np.asarray(a.offs), np.asarray(b.offs)])
        szs = np.concatenate([np.asarray(a.sizes), np.asarray(b.sizes)])
        # newer rank (b) wins on key collision: b's entries come later in
        # the concatenation, so the reversed-unique fold picks them
        uniq, rev_first = np.unique(keys[::-1], return_index=True)
        last = len(keys) - 1 - rev_first
        mo, ms = offs[last], szs[last]
        if lo == 0:
            # nothing older left to shadow: tombstones drop here — and
            # ONLY here (a mid-stack tombstone must keep shadowing)
            alive = (mo != 0) & (ms != _TOMB)
            uniq, mo, ms = uniq[alive], mo[alive], ms[alive]
        seq = self._next_seq
        if len(uniq):
            _write_run(_run_path(self.base, seq), uniq, mo, ms)
            merged = [_Run(_run_path(self.base, seq))]
            merged_seqs = [seq]
            self._next_seq = seq + 1
        else:
            merged, merged_seqs = [], []
        old = self._runs[lo : lo + 2]
        self._runs[lo : lo + 2] = merged
        self._seqs[lo : lo + 2] = merged_seqs
        for r in old:
            r.close()
        # old run files are removed by the manifest-save sweep

    def _note_resident(self) -> None:
        with _AGG_LOCK:
            _RESIDENT[id(self)] = len(self._mem) * _ENTRY_COST
            _RUN_COUNTS[id(self)] = len(self._runs)
        _publish_aggregates()

    # ---------------- mapper contract ----------------
    def _probe(self, key: int) -> Optional[tuple[int, int]]:
        """(offset_units, size) from memtable else runs newest-first;
        tombstones included. None = absent everywhere. The bloom hash
        mixes ONCE here and every filtered run reuses it."""
        v = self._mem.get(key)
        if v is not None:
            return v
        runs = self._runs
        bh = None
        # below the (env-tunable) threshold maps skip filters outright
        multi = len(runs) >= BLOOM_MIN_RUNS
        for r in reversed(runs):
            if multi and bh is None and r.bloom is not None:
                bh = _mix64_scalar(key)
            hit = r.get(key, bh)
            if hit is not None:
                return hit
        return None

    def put(self, key: int, offset_units: int, size: int) -> None:
        with self._lock:
            old = self._probe(key)
            self._idx.append(entry_to_bytes(key, offset_units, size))
            self._set_mem(key, offset_units, size)
            self.metric.log_put(key, old[1] if old is not None else 0, size)

    def put_batch(self, entries) -> None:
        """Append MANY (key, offset_units, size) index entries in ONE
        .idx write — the multi-needle append satellite's map half (a
        batch frame costs one idx pwrite, not one per needle).

        No flush may fire MID-batch: a flush persists a manifest whose
        `idx_covered` is the current .idx size, so memtable state and
        the appended log must move in lock-step — the batch applies to
        the memtable WITHOUT the per-put flush trigger, the whole blob
        appends once, and the flush check runs at the end (either
        ordering of a mid-batch flush would otherwise let a crash strand
        a snapshot that disagrees with the durability-authority log)."""
        with self._lock:
            blob = bytearray()
            for key, offset_units, size in entries:
                old = self._probe(key)
                blob += entry_to_bytes(key, offset_units, size)
                self._set_mem_noflush(key, offset_units, size)
                self.metric.log_put(
                    key, old[1] if old is not None else 0, size
                )
            if blob:
                self._idx.append(bytes(blob))
            if len(self._mem) >= self.memtable_limit:
                self._flush_memtable()

    def _set_mem_noflush(
        self, key: int, offset_units: int, size: int
    ) -> None:
        self._mem[key] = (offset_units, size)
        self._mutations += 1
        # scalar twin of _record_ends: this runs per put at write QPS
        body = 0 if size == TOMBSTONE_FILE_SIZE else size
        rec = (
            NEEDLE_HEADER_SIZE
            + body
            + NEEDLE_CHECKSUM_SIZE
            + (TIMESTAMP_SIZE if self.version == VERSION3 else 0)
        )
        end = offset_units * NEEDLE_PADDING_SIZE + rec + (8 - rec % 8)
        if end > self._dat_frontier:
            self._dat_frontier = end

    def _set_mem(self, key: int, offset_units: int, size: int) -> None:
        self._set_mem_noflush(key, offset_units, size)
        if len(self._mem) >= self.memtable_limit:
            self._flush_memtable()

    def get(self, key: int) -> Optional[NeedleValue]:
        with self._lock:
            hit = self._probe(key)
        if hit is None:
            return None
        return NeedleValue(key=key, offset_units=hit[0], size=hit[1])

    def delete(self, key: int, offset_units: int) -> None:
        with self._lock:
            old = self._probe(key)
            self._idx.append(
                entry_to_bytes(key, offset_units, TOMBSTONE_FILE_SIZE)
            )
            self.metric.maybe_set_max_file_key(key)
            if old is not None and old[1] != TOMBSTONE_FILE_SIZE:
                self.metric.log_delete(old[1])
            self._set_mem(key, offset_units, TOMBSTONE_FILE_SIZE)

    # ---------------- snapshots / visits ----------------
    def _merged_columns(self, drop_tombstones: bool):
        """Key-sorted newest-wins fold of runs + memtable."""
        cols_k, cols_o, cols_s = [], [], []
        for r in self._runs:  # oldest .. newest
            cols_k.append(np.asarray(r.keys))
            cols_o.append(np.asarray(r.offs))
            cols_s.append(np.asarray(r.sizes))
        if self._mem:
            items = sorted(self._mem.items())
            cols_k.append(np.fromiter((k for k, _ in items), np.uint64))
            cols_o.append(np.fromiter((v[0] for _, v in items), _OFF_DTYPE))
            cols_s.append(np.fromiter((v[1] for _, v in items), np.uint32))
        if not cols_k:
            return (
                np.empty(0, np.uint64),
                np.empty(0, _OFF_DTYPE),
                np.empty(0, np.uint32),
            )
        keys = np.concatenate(cols_k)
        offs = np.concatenate(cols_o)
        sizes = np.concatenate(cols_s)
        uniq, rev_first = np.unique(keys[::-1], return_index=True)
        last = len(keys) - 1 - rev_first
        mo, ms = offs[last], sizes[last]
        if drop_tombstones:
            alive = (mo != 0) & (ms != _TOMB)
            return uniq[alive], mo[alive], ms[alive]
        return uniq, mo, ms

    def snapshot(self):
        """Sorted live (keys, offset_units, sizes) columns — the bulk-
        probe contract every mapper shares. A sealed map (one pure-live
        run, empty memtable) hands back the run's mmap'd columns
        ZERO-COPY: the lookup_gate's device snapshot and the EC path
        consume the on-disk pages directly, no dict and no copy."""
        with self._lock:
            if (
                self._snapshot_cache is not None
                and self._snapshot_token_at == self._mutations
            ):
                return self._snapshot_cache
            if (
                not self._mem
                and len(self._runs) == 1
                and self._runs[0].tombs == 0
            ):
                snap = self._runs[0].columns()
            else:
                snap = self._merged_columns(drop_tombstones=True)
            self._snapshot_cache = snap
            self._snapshot_token_at = self._mutations
            return snap

    def snapshot_token(self) -> int:
        return self._mutations

    def arena_view(self, keys):
        """One consistent view for a ragged device dispatch: under the
        map lock, probe the MEMTABLE host-side for every key (cheap dict
        hits; includes tombstones, which must shadow the runs) and hand
        back the current run set as newest-first arena descriptors. The
        two move together under the lock on purpose: a memtable flush
        between them would seal keys into a run the device batch never
        probes. Returns (mem_hits {key: (offset_units, size)}, segments
        newest-first) — segments is None when this map can't feed the
        arena (5-byte offsets exceed the kernel's u32 columns)."""
        if OFFSET_SIZE != 4:
            return {}, None
        with self._lock:
            mem = self._mem
            mem_hits = {}
            for k in keys:
                v = mem.get(int(k))
                if v is not None:
                    mem_hits[int(k)] = v
            segments = [r.arena_segment() for r in reversed(self._runs)]
        return mem_hits, segments

    def ascending_visit(self, visit) -> None:
        keys, offs, sizes = self._merged_columns(drop_tombstones=False)
        for key, off, size in zip(
            keys.tolist(), offs.tolist(), sizes.tolist()
        ):
            visit(NeedleValue(key=key, offset_units=off, size=size))

    # ---------------- frontiers ----------------
    def expected_dat_frontier(self, data_start: int) -> Optional[int]:
        """Where the .dat should end according to the log — computed
        from the running max the map already tracks (monotone across
        merges and tail replays), so the lsm mount path never re-reads
        the whole .idx the way volume.expected_dat_frontier must."""
        if self._dat_frontier == 0:
            return data_start if self.metric.file_count == 0 else None
        return self._dat_frontier

    # ---------------- admin ----------------
    def index_file_size(self) -> int:
        return self._idx.size()

    def sync(self) -> None:
        self._idx.sync()

    def save_snapshot(self) -> None:
        """Flush + persist now (clean close path): the next mount pays
        tail replay only for entries appended after this point."""
        with self._lock:
            if self._mem:
                self._flush_memtable()
            else:
                self._idx_covered = self._idx.size()
                self._persist_manifest()

    def close(self) -> None:
        with self._lock:
            try:
                self.save_snapshot()
            except OSError:
                pass  # worst case: next mount pays a full rebuild
            for r in self._runs:
                r.close()
            self._runs = []
            self._snapshot_cache = None
            self._idx.close()
        _drop_aggregates(id(self))

    def destroy(self) -> None:
        self.close()
        invalidate_snapshot(self.base)
        try:
            os.remove(self.idx_path)
        except FileNotFoundError:
            pass

    def bloom_stats(self) -> dict:
        """Aggregate per-run filter economics (the needle_map.lookup
        bench leg's disclosure): probes that consulted a filter, probes
        a filter short-circuited, how many runs carry one, the active
        consultation threshold, and the per-run consult/hit counts
        (newest run last, matching probe order reversed)."""
        with self._lock:
            probes = sum(r.bloom_probes for r in self._runs)
            neg = sum(r.bloom_neg for r in self._runs)
            filtered = sum(1 for r in self._runs if r.bloom is not None)
            per_run = [
                {
                    "probes": r.bloom_probes,
                    "negatives": r.bloom_neg,
                    "has_filter": r.bloom is not None,
                }
                for r in self._runs
            ]
        return {
            "runs": len(self._runs),
            "runs_with_filter": filtered,
            "min_runs": BLOOM_MIN_RUNS,
            "probes": probes,
            "negatives": neg,
            "filter_hit_rate": round(neg / probes, 4) if probes else 0.0,
            "per_run": per_run,
        }

    # metrics accessors mirroring the reference mapper
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


def new_lsm_needle_map(idx_path: str, version: int = VERSION3) -> LsmNeedleMap:
    """Fresh LSM map with a truncated idx and no snapshot."""
    base = idx_path[: -len(".idx")]
    invalidate_snapshot(base)
    f = DiskFile(idx_path, create=True)
    f.truncate(0)
    f.close()
    return LsmNeedleMap(idx_path, version=version)


def load_lsm_needle_map(
    idx_path: str, version: int = VERSION3
) -> LsmNeedleMap:
    """Open an existing volume's LSM map: snapshot + tail replay when
    the manifest binds to the current log, vectorized full rebuild
    otherwise."""
    return LsmNeedleMap(idx_path, version=version)
