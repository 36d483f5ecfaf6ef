"""Volume engine: one append-only .dat + .idx pair.

Semantics follow the reference volume (ref: weed/storage/volume.go:21-47,
volume_read_write.go, volume_loading.go, volume_checking.go):

- writes append a v3 needle record and log (key, offset, size) to the .idx;
- deletes append a zero-data tombstone needle and log TOMBSTONE_FILE_SIZE;
- reads look up the in-memory map and pread one record, verifying cookie at a
  higher layer and TTL expiry here;
- load replays the .idx and verifies the last entry against the .dat (CRC),
  repairing a torn tail (the reference marks the volume read-only).

`bulk_lookup` answers a batch of keys in one search on the card
(ops/index_kernel.py) over a snapshot cached per volume.

Ported from the JAX package's storage/volume.py: every needle map kind
(`memory`, `lsm`, the sqlite-backed `leveldb` and the read-only
`sorted`), the vacuum's compaction state and its shadow sweep at load,
torn-tail recovery, writes, deletes, reads, scans, the scrub quarantine
flag, the garbage level, the replicas' content digest (`digest_fold`,
`Volume.content_digest`) and bulk lookups. Not ported yet: tiered
(remote) .dat files.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Optional

from ..types import (
    MAX_POSSIBLE_VOLUME_SIZE,
    NEEDLE_HEADER_SIZE,
    NEEDLE_MAP_ENTRY_SIZE,
    NEEDLE_PADDING_SIZE,
    TOMBSTONE_FILE_SIZE,
    to_actual_offset,
    to_offset_units,
)
from .backend import BackendStorageFile, DiskFile
from .needle import (
    Needle,
    get_actual_size,
    read_needle_data,
    read_needle_header,
)
from .needle_map import NeedleMap, load_needle_map, new_needle_map
from .super_block import SUPER_BLOCK_SIZE, SuperBlock, read_super_block
from .ttl import EMPTY_TTL

_LOG = logging.getLogger(__name__)

# kinds of needle map (ref NeedleMapKind, weed/storage/needle_map.go:14-19)
NEEDLE_MAP_KINDS = ("memory", "lsm", "leveldb", "sorted")


class NotFound(Exception):
    pass


class AlreadyDeleted(Exception):
    pass


class VolumeSizeExceeded(Exception):
    pass


class CookieMismatch(Exception):
    pass


def volume_base_name(directory: str, collection: str, vid: int) -> str:
    """Ref: weed/storage/volume.go FileName() — dir/[collection_]vid."""
    if collection:
        return os.path.join(directory, f"{collection}_{vid}")
    return os.path.join(directory, str(vid))


def check_volume_data_integrity(
    dat: BackendStorageFile, version: int, idx_path: str
) -> int:
    """Verify idx size alignment and the last entry's needle CRC; returns
    last_append_at_ns (ref: weed/storage/volume_checking.go:15-46)."""
    idx_size = os.path.getsize(idx_path)
    if idx_size % NEEDLE_MAP_ENTRY_SIZE != 0:
        raise ValueError(f"index file size {idx_size} not a multiple of 16")
    if idx_size == 0:
        return 0
    from .idx import parse_entry

    with open(idx_path, "rb") as f:
        f.seek(idx_size - NEEDLE_MAP_ENTRY_SIZE)
        key, offset_units, size = parse_entry(f.read(NEEDLE_MAP_ENTRY_SIZE))
    if offset_units == 0:
        return 0
    if size == TOMBSTONE_FILE_SIZE:
        size = 0
    n = read_needle_data(dat, to_actual_offset(offset_units), size, version)
    if n.id != key:
        raise ValueError(f"index key {key:#x} does not match needle id {n.id:#x}")
    return n.append_at_ns


class UnrecoverableCorruption(Exception):
    """A COMPLETE record failed verification: bit rot, not a torn tail.
    Truncating would destroy an acked, durable write — the volume must go
    read-only with the evidence intact instead."""


def _idx_entry_status(
    dat: BackendStorageFile, version: int, key: int, offset_units: int,
    size: int, dat_size: int,
) -> tuple[str, Optional[int]]:
    """Classify the record one .idx entry references:
    ("ok", end)      — complete and CRC-valid;
    ("ok-weak", None) — delete-of-absent-key entry (offset 0): valid but
                        names no position;
    ("torn", None)   — the record extends past EOF: a crash artifact,
                        safe to drop (its write was never acked);
    ("corrupt", None) — complete on disk but fails id/size/CRC checks:
                        bit rot, NOT recoverable by truncation."""
    if offset_units == 0:
        return ("ok-weak", None)
    body_size = 0 if size == TOMBSTONE_FILE_SIZE else size
    offset = to_actual_offset(offset_units)
    end = offset + get_actual_size(body_size, version)
    if end > dat_size:
        return ("torn", None)
    try:
        n = read_needle_data(dat, offset, body_size, version)
    except Exception:
        return ("corrupt", None)
    if n.id != key:
        return ("corrupt", None)
    return ("ok", end)


def expected_dat_frontier(
    version: int, idx_path: str, data_start: int
) -> Optional[int]:
    """Where the .dat should end according to the .idx: the MAX record end
    over every entry (every append logs exactly one entry after its record
    lands). Order-independent on purpose — `weed-tpu fix` and vacuum
    rebuild key-SORTED index files, where the last entry is the largest
    key, not the latest append. None when the frontier cannot be derived
    (torn idx, no positional entries). Vectorized: this runs on every
    memory-kind volume load."""
    idx_size = os.path.getsize(idx_path)
    if idx_size % NEEDLE_MAP_ENTRY_SIZE != 0:
        return None
    if idx_size == 0:
        return data_start
    import numpy as np

    from ..types import VERSION3
    from .idx import parse_index_bytes

    with open(idx_path, "rb") as f:
        _keys, offsets, sizes = parse_index_bytes(f.read())
    live = offsets > 0
    if not live.any():
        return None
    body = np.where(
        sizes == np.uint32(TOMBSTONE_FILE_SIZE), 0, sizes
    ).astype(np.int64)
    # get_actual_size, vectorized: header+body+crc(+ts), padded to 8 with
    # 1..8 bytes (8 - base%8 is already in 1..8, matching padding_length)
    base = NEEDLE_HEADER_SIZE + body + 4 + (8 if version == VERSION3 else 0)
    ends = offsets.astype(np.int64) * NEEDLE_PADDING_SIZE + base + (
        8 - base % 8
    )
    return int(ends[live].max())


def recover_torn_tail(
    dat: BackendStorageFile, version: int, idx_path: str,
    data_start: int = SUPER_BLOCK_SIZE,
) -> dict:
    """Bring a volume whose process died mid-append back to a consistent
    prefix (the reference instead marks the volume read-only,
    volume_loading.go:100-116 — we repair).

    Verifies every .idx entry against its record (complete + CRC-valid).
    Torn entries — records running past EOF, the shape a crash or a
    power-loss-reordered flush leaves — must form a contiguous tail,
    which is truncated away (their writes were never acked). The .dat is
    then scanned FORWARD from the highest verified record end (order-
    independent: fix/vacuum write key-sorted index files) to re-index
    fully-written records whose index entry was lost (crash between the
    .dat append and the .idx append), and truncated at the first
    incomplete record. Any COMPLETE record failing verification is bit
    rot, not a crash artifact: UnrecoverableCorruption, volume goes
    read-only. Returns counts for the degraded-mode metrics:
    {records_recovered, dat_bytes_dropped, idx_entries_dropped,
    idx_bytes_torn}.
    """
    from .idx import entry_to_bytes, iter_index

    stats = {
        "records_recovered": 0,
        "dat_bytes_dropped": 0,
        "idx_entries_dropped": 0,
        "idx_bytes_torn": 0,
    }
    idx_size = os.path.getsize(idx_path)
    torn = idx_size % NEEDLE_MAP_ENTRY_SIZE
    if torn:
        idx_size -= torn
        os.truncate(idx_path, idx_size)
        stats["idx_bytes_torn"] = torn
    dat_size = dat.size()
    n_entries = idx_size // NEEDLE_MAP_ENTRY_SIZE
    max_valid_end = min(data_start, dat_size)
    first_torn: Optional[int] = None
    with open(idx_path, "rb") as f:
        for i, (key, offset_units, size) in enumerate(iter_index(f)):
            status, end = _idx_entry_status(
                dat, version, key, offset_units, size, dat_size
            )
            if status == "corrupt":
                raise UnrecoverableCorruption(
                    f"record for key {key:#x} is complete but invalid "
                    f"(bit rot); refusing to truncate acked data"
                )
            if status == "torn":
                if first_torn is None:
                    first_torn = i
                continue
            if first_torn is not None:
                # a verified entry AFTER a torn one is not the contiguous
                # tail a crash leaves — too strange to repair blindly
                raise UnrecoverableCorruption(
                    "valid index entry follows a torn one; "
                    "not a crash-shaped tail"
                )
            if end is not None:  # positional entry ("ok-weak" has no end)
                max_valid_end = max(max_valid_end, end)
    if first_torn is not None:
        os.truncate(idx_path, first_torn * NEEDLE_MAP_ENTRY_SIZE)
        stats["idx_entries_dropped"] = n_entries - first_torn
    pos = max_valid_end
    recovered: list[bytes] = []
    while pos + NEEDLE_HEADER_SIZE <= dat_size:
        try:
            header, body_len = read_needle_header(dat, version, pos)
        except Exception:
            break
        if header.id == 0 and header.size == 0:
            break  # zero-fill, never a real record
        total = NEEDLE_HEADER_SIZE + body_len
        if pos + total > dat_size:
            break  # torn mid-record: never acked, drop it
        try:
            n = Needle()
            n.read_bytes(dat.read_at(total, pos), pos, header.size, version)
        except Exception:
            break
        size_for_index = (
            n.size if len(n.data) else TOMBSTONE_FILE_SIZE
        )  # empty record == tombstone append (volume_read_write.go:186)
        recovered.append(
            entry_to_bytes(n.id, to_offset_units(pos), size_for_index)
        )
        pos += total
    if recovered:
        with open(idx_path, "ab") as f:
            f.write(b"".join(recovered))
        stats["records_recovered"] = len(recovered)
    if pos < dat_size:
        dat.truncate(pos)
        stats["dat_bytes_dropped"] = dat_size - pos
    return stats


def digest_fold(keys, sizes) -> int:
    """XOR-fold of splitmix64-mixed (key, size) terms over live index
    columns — the commutative content digest replicas compare. Pure
    integer arithmetic (never Python hash(): that is salted per process,
    and replicas live in different processes). numpy, not torch: torch
    on the CPU has no uint64 shifts."""
    import numpy as np

    if len(keys) == 0:
        return 0
    x = np.asarray(keys, dtype=np.uint64) ^ (
        np.asarray(sizes, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    )
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return int(np.bitwise_xor.reduce(x))


class Volume:
    def __init__(
        self,
        directory: str,
        collection: str,
        vid: int,
        replica_placement=None,
        ttl=None,
        create: bool = True,
        needle_map_kind: str = "memory",
        device=None,
    ):
        """`device` is where bulk_lookup's snapshot lives: the card unless
        the caller asks for the CPU (which runs the plain version)."""
        if needle_map_kind not in NEEDLE_MAP_KINDS:
            raise ValueError(
                f"unknown needle map kind {needle_map_kind!r} "
                f"(the kinds are {', '.join(NEEDLE_MAP_KINDS)})"
            )
        self.dir = directory
        self.collection = collection
        self.id = vid
        self.no_write_or_delete = False
        self.is_compacting = False
        self.last_append_at_ns = 0
        self.last_modified_ts_seconds = 0
        self.last_compact_index_offset = 0
        self.last_compact_revision = 0
        self._lock = threading.RLock()
        # the scrub quarantine flag heartbeats carry
        self.scrub_corrupt = False
        # (needle-map snapshot token, digest): content_digest's memo
        self._digest_cache: Optional[tuple] = None
        # lifecycle plane: decayed read/write heat, restored from the
        # sidecar so a clean restart keeps the volume's temperature
        from .heat import HeatTracker

        self.heat = HeatTracker.load(
            volume_base_name(directory, collection, vid) + ".heat"
        )
        # device-resident index snapshot for bulk probes, keyed by the
        # map's mutation token (see bulk_lookup)
        from ..ops.snapshot_cache import SnapshotCache

        self.device = device
        self._index_cache = SnapshotCache(device=device)

        base = self.file_name()
        # a dead compaction's shadow files must be repaired BEFORE anything
        # opens the .dat/.idx: sweep .cpd/.cpx leftovers, or complete a
        # commit that crashed between its two renames (vacuum.py)
        try:
            from .vacuum import sweep_compaction_shadows

            swept = sweep_compaction_shadows(base)
            if swept:
                _LOG.warning(
                    "volume %d: %s stale compaction shadows at load",
                    vid, swept,
                )
        except OSError:
            pass  # unreadable shadows: the load below decides read-only
        dat_exists = os.path.exists(base + ".dat")
        from .volume_info import load_volume_info

        info = load_volume_info(base + ".vif")
        if info is not None and info.files:
            raise NotImplementedError(
                f"volume {vid} has a remote .dat ({base}.vif): tiered "
                "volumes are not ported"
            )
        if not dat_exists and not create:
            raise FileNotFoundError(f"Volume data file {base}.dat does not exist")

        self.data_backend: BackendStorageFile = DiskFile(base + ".dat", create=True)
        if dat_exists and self.data_backend.size() >= SUPER_BLOCK_SIZE:
            self.super_block = read_super_block(self.data_backend)
        else:
            from .super_block import ReplicaPlacement

            self.super_block = SuperBlock(
                replica_placement=replica_placement or ReplicaPlacement(),
                ttl=ttl or EMPTY_TTL,
            )
            self.data_backend.write_at(self.super_block.to_bytes(), 0)

        self.needle_map_kind = needle_map_kind
        self.recovery_stats: Optional[dict] = None
        self.nm: NeedleMap
        if os.path.exists(base + ".idx") and dat_exists:
            try:
                self.last_append_at_ns = check_volume_data_integrity(
                    self.data_backend, self.version, base + ".idx"
                )
                if needle_map_kind == "memory":
                    # the last idx entry can verify while the dat still
                    # carries a torn record PAST it (crash mid-append,
                    # before the idx entry landed) — check the frontier
                    expected = expected_dat_frontier(
                        self.version, base + ".idx",
                        self.super_block.block_size(),
                    )
                    if expected is not None and expected != self.data_backend.size():
                        self._recover_torn_tail(base)
            except Exception:
                # the tail is torn (crash mid-append). The reference mounts
                # read-only; we repair to the last CRC-valid needle
                # boundary — but only for the log-format .idx the memory
                # and lsm maps replay (sqlite/sorted have other formats)
                if needle_map_kind in ("memory", "lsm"):
                    self._recover_torn_tail(base)
                else:
                    self.no_write_or_delete = True
            self.nm = self._open_needle_map(base, needle_map_kind)
            if needle_map_kind == "lsm":
                # same torn-record-past-the-frontier check as "memory",
                # but from the map's own running maximum — the whole
                # point of the snapshot mount is NOT re-reading the .idx
                expected = self.nm.expected_dat_frontier(
                    self.super_block.block_size()
                )
                if expected is not None and expected != self.data_backend.size():
                    self.nm.close()
                    self._recover_torn_tail(base)
                    # recovery may have truncated/appended the log; the
                    # reopen revalidates the snapshot binding against it
                    self.nm = self._open_needle_map(base, needle_map_kind)
            if needle_map_kind == "sorted":
                # sorted-file maps can't Put; the reference only uses them
                # on read-only volume loads (ref volume_loading.go:68-95)
                self.no_write_or_delete = True
        elif needle_map_kind == "leveldb":
            from .needle_map.disk_maps import SqliteNeedleMap

            if os.path.exists(base + ".idx"):
                os.truncate(base + ".idx", 0)
            self.nm = SqliteNeedleMap(base + ".idx")
        elif needle_map_kind == "lsm":
            from .needle_map.lsm_map import new_lsm_needle_map

            self.nm = new_lsm_needle_map(base + ".idx", version=self.version)
        else:
            # "sorted" can't index a fresh writable volume; fall back
            # to the in-memory map until a read-only reload
            self.nm = new_needle_map(base + ".idx")

    def _open_needle_map(self, base: str, kind: str):
        """Mapper selection (ref NeedleMapKind, weed/storage/needle_map.go:14-19):
        memory=CompactMap replay, leveldb=disk B-tree, sorted=read-only
        .sdx, lsm=memory-bounded out-of-core map with snapshot mount."""
        if kind == "leveldb":
            from .needle_map.disk_maps import SqliteNeedleMap

            return SqliteNeedleMap(base + ".idx")
        if kind == "sorted":
            from .needle_map.disk_maps import SortedFileNeedleMap

            return SortedFileNeedleMap(base + ".idx")
        if kind == "lsm":
            from .needle_map.lsm_map import load_lsm_needle_map

            return load_lsm_needle_map(base + ".idx", version=self.version)
        return load_needle_map(base + ".idx")

    def _recover_torn_tail(self, base: str) -> None:
        """Repair a torn .dat/.idx tail on load; read-only fallback when
        even the repaired prefix fails verification."""
        from ..util.metrics import TORN_TAIL_COUNTER

        try:
            stats = recover_torn_tail(
                self.data_backend, self.version, base + ".idx",
                data_start=self.super_block.block_size(),
            )
            self.last_append_at_ns = check_volume_data_integrity(
                self.data_backend, self.version, base + ".idx"
            )
        except Exception:
            self.no_write_or_delete = True
            return
        self.recovery_stats = stats
        TORN_TAIL_COUNTER.inc(item="volumes")
        for item, key in (
            ("records_recovered", "records_recovered"),
            ("dat_bytes_dropped", "dat_bytes_dropped"),
            ("idx_entries_dropped", "idx_entries_dropped"),
        ):
            if stats[key]:
                TORN_TAIL_COUNTER.inc(stats[key], item=item)
        _LOG.warning(
            "volume %d: torn tail recovered (%d records re-indexed, "
            "%d dat bytes dropped, %d idx entries dropped)",
            self.id, stats["records_recovered"], stats["dat_bytes_dropped"],
            stats["idx_entries_dropped"],
        )

    # --- basic accessors ---
    def file_name(self) -> str:
        return volume_base_name(self.dir, self.collection, self.id)

    @property
    def version(self) -> int:
        return self.super_block.version

    @property
    def ttl(self):
        return self.super_block.ttl

    def content_size(self) -> int:
        return self.nm.content_size

    def deleted_size(self) -> int:
        return self.nm.deleted_size

    def file_count(self) -> int:
        return self.nm.file_count

    def deleted_count(self) -> int:
        return self.nm.deleted_count

    def max_file_key(self) -> int:
        return self.nm.max_file_key

    def index_file_size(self) -> int:
        return self.nm.index_file_size()

    def data_file_size(self) -> int:
        return self.data_backend.size()

    def is_read_only(self) -> bool:
        return self.no_write_or_delete

    def content_digest(self) -> int:
        """Order-independent 64-bit digest of the LIVE content set — the
        XOR-fold of a mixed (key, size) term per non-deleted needle. Two
        replicas holding the same needles report the same digest no matter
        how their appends interleaved on disk, so the master can compare
        digests straight off heartbeats to catch diverged/stale replicas
        (the anti-entropy plane's cheap invariant). Memoized on the needle
        map's mutation token: steady state costs a token compare."""
        with self._lock:
            try:
                token = self.nm.snapshot_token()
            except Exception:
                token = None
            cached = self._digest_cache
            if token is not None and cached is not None and cached[0] == token:
                return cached[1]
            try:
                keys, _offsets, sizes = self.nm.snapshot()
            except Exception:
                return 0
            d = digest_fold(keys, sizes)
            if token is not None:
                self._digest_cache = (token, d)
            return d

    def quarantine(self, reason: str) -> None:
        """Scrub (or a verified vacuum) found latent damage: freeze writes
        and flag the volume for the master's repair scheduler. NEVER
        deletes anything — the evidence stays on disk for repair."""
        self.no_write_or_delete = True
        self.scrub_corrupt = True
        _LOG.warning("volume %d quarantined: %s", self.id, reason)

    def garbage_level(self) -> float:
        """Ref: volume_vacuum.go:20-34."""
        if self.content_size() == 0:
            return 0.0
        return self.deleted_size() / self.content_size()

    # --- data path ---
    def _is_file_unchanged(self, n: Needle) -> bool:
        """Dedup identical rewrite (ref: volume_read_write.go:22-41)."""
        if str(self.ttl):
            return False
        nv = self.nm.get(n.id)
        if nv is None or nv.offset_units == 0 or nv.size == TOMBSTONE_FILE_SIZE:
            return False
        try:
            old = read_needle_data(
                self.data_backend, to_actual_offset(nv.offset_units), nv.size, self.version
            )
        except Exception:
            return False
        return old.cookie == n.cookie and old.data == n.data

    def can_accept(self, data_len: int) -> bool:
        """Deterministic append preconditions (writable + under the
        offset-addressable size ceiling) — callers that pipeline side
        effects (replica fan-out) check these BEFORE launching them, so a
        write that is guaranteed to fail locally never lands data
        elsewhere. Advisory: the append itself re-checks under the lock."""
        if self.no_write_or_delete:
            return False
        return (
            self.content_size() + get_actual_size(data_len, self.version)
            <= MAX_POSSIBLE_VOLUME_SIZE
        )

    def write_needle(self, n: Needle, sync: bool = False) -> tuple[int, int, bool]:
        """Append a needle; returns (offset, size, is_unchanged)
        (ref: volume_read_write.go:71-142)."""
        if self.no_write_or_delete:
            raise PermissionError(f"volume {self.id} is read only")
        if n.ttl is None or n.ttl == EMPTY_TTL:
            if self.ttl != EMPTY_TTL:
                n.set_ttl(self.ttl)
        with self._lock:
            actual_size = get_actual_size(len(n.data), self.version)
            if MAX_POSSIBLE_VOLUME_SIZE < self.content_size() + actual_size:
                raise VolumeSizeExceeded(
                    f"volume size limit {MAX_POSSIBLE_VOLUME_SIZE} exceeded! "
                    f"current size is {self.content_size()}"
                )
            if self._is_file_unchanged(n):
                return 0, len(n.data), True

            nv = self.nm.get(n.id)
            if nv is not None and nv.offset_units != 0:
                existing, _ = read_needle_header(
                    self.data_backend, self.version, to_actual_offset(nv.offset_units)
                )
                if existing.cookie != n.cookie:
                    raise CookieMismatch(f"mismatching cookie {n.cookie:x}")

            self.heat.note_write()
            n.append_at_ns = time.time_ns()
            end = self.data_backend.size()
            blob, size_for_index, _ = n.to_bytes(self.version)
            try:
                self.data_backend.write_at(blob, end)
                if sync:
                    self.data_backend.sync()
            except Exception:
                self.data_backend.truncate(end)
                raise
            self.last_append_at_ns = n.append_at_ns
            offset = end

            if nv is None or to_actual_offset(nv.offset_units) < offset:
                self.nm.put(n.id, to_offset_units(offset), n.size)
            if self.last_modified_ts_seconds < n.last_modified:
                self.last_modified_ts_seconds = n.last_modified
            return offset, size_for_index, False

    def write_needle_batch(self, needles: list) -> list:
        """Append MANY needles as ONE coalesced .dat extent + ONE .idx
        extent (the multi-needle append satellite): a `!batch/put` frame
        of N needles costs two pwrites total instead of 2N — the ~265µs
        two-syscall floor per needle was the 1M-key soak's write cap.

        Per-needle semantics match write_needle exactly (TTL inherit,
        size ceiling, unchanged-dedup, cookie check); a needle failing
        its OWN precondition reports an Exception in its result slot
        while the rest of the batch proceeds. The coalesced extent write
        is all-or-nothing: on failure the .dat truncates back and every
        pending slot fails. Returns one (offset, size_for_index,
        is_unchanged) tuple or Exception per input needle, in order."""
        if self.no_write_or_delete:
            raise PermissionError(f"volume {self.id} is read only")
        results: list = [None] * len(needles)
        with self._lock:
            start = self.data_backend.size()
            parts: list = []
            entries: list = []  # (key, offset_units, size) for put_batch
            pending: list = []  # (i, needle, offset, size_for_index)
            accrued = 0
            for i, n in enumerate(needles):
                try:
                    if n.ttl is None or n.ttl == EMPTY_TTL:
                        if self.ttl != EMPTY_TTL:
                            n.set_ttl(self.ttl)
                    actual_size = get_actual_size(len(n.data), self.version)
                    if (
                        MAX_POSSIBLE_VOLUME_SIZE
                        < self.content_size() + accrued + actual_size
                    ):
                        raise VolumeSizeExceeded(
                            f"volume size limit {MAX_POSSIBLE_VOLUME_SIZE} "
                            f"exceeded! current size is {self.content_size()}"
                        )
                    if self._is_file_unchanged(n):
                        results[i] = (0, len(n.data), True)
                        continue
                    nv = self.nm.get(n.id)
                    if nv is not None and nv.offset_units != 0:
                        existing, _ = read_needle_header(
                            self.data_backend, self.version,
                            to_actual_offset(nv.offset_units),
                        )
                        if existing.cookie != n.cookie:
                            raise CookieMismatch(
                                f"mismatching cookie {n.cookie:x}"
                            )
                    n.append_at_ns = time.time_ns()
                    offset = start + accrued
                    blob, size_for_index, _ = n.to_bytes(self.version)
                    parts.append(blob)
                    entries.append(
                        (n.id, to_offset_units(offset), n.size)
                    )
                    pending.append((i, n, offset, size_for_index))
                    accrued += len(blob)
                except Exception as e:
                    results[i] = e
            if not pending:
                return results
            self.heat.note_write(len(pending))
            try:
                self.data_backend.write_at(b"".join(parts), start)
            except Exception as e:
                try:
                    self.data_backend.truncate(start)
                except Exception:
                    pass
                for i, _n, _off, _sfi in pending:
                    results[i] = e
                return results
            put_batch = getattr(self.nm, "put_batch", None)
            if put_batch is not None:
                put_batch(entries)
            else:  # sorted-file maps can't batch; mirror the loop
                for key, off_units, size in entries:
                    self.nm.put(key, off_units, size)
            for i, n, offset, size_for_index in pending:
                self.last_append_at_ns = n.append_at_ns
                if self.last_modified_ts_seconds < n.last_modified:
                    self.last_modified_ts_seconds = n.last_modified
                results[i] = (offset, size_for_index, False)
            return results

    def delete_needle(self, n: Needle) -> int:
        """Append tombstone + mark map; returns freed size
        (ref: volume_read_write.go:186-231)."""
        if self.no_write_or_delete:
            raise PermissionError(f"volume {self.id} is read only")
        with self._lock:
            nv = self.nm.get(n.id)
            if nv is None or nv.size == TOMBSTONE_FILE_SIZE:
                return 0
            self.heat.note_write()
            size = nv.size
            n.data = b""
            n.append_at_ns = time.time_ns()
            end = self.data_backend.size()
            blob, _, _ = n.to_bytes(self.version)
            self.data_backend.write_at(blob, end)
            self.last_append_at_ns = n.append_at_ns
            self.nm.delete(n.id, to_offset_units(end))
            return size

    def read_needle(self, n: Needle) -> int:
        """Fill in needle content by map lookup; returns bytes read
        (ref: volume_read_write.go:255-288)."""
        got = self.read_needle_by_key(n.id)
        if got is not n:
            n.__dict__.update(got.__dict__)
        return len(n.data)

    def read_needle_by_key(self, key: int) -> Needle:
        """Serving fast-path read: map lookup + pread + parse in one step,
        returning the hydrated needle directly. Same semantics as
        read_needle without the caller-allocated shell needle and the
        per-field dict merge (both measurable at read-QPS rates)."""
        return self.read_needle_by_key_located(key)[0]

    def read_needle_by_key_located(self, key: int) -> tuple[Needle, int, int]:
        """read_needle_by_key plus the (offset_units, size) the record was
        served from. The location is the hot-needle cache's validity
        token: a later hit is legal only while the live map still points
        the key at the same location (append-only .dat ⇒ same location,
        same bytes; any overwrite/delete moves or tombstones the entry)."""
        self.heat.note_read()
        with self._lock:
            nv = self.nm.get(key)
            if nv is None or nv.offset_units == 0:
                raise NotFound(f"needle {key} not found")
            if nv.size == TOMBSTONE_FILE_SIZE:
                raise AlreadyDeleted(f"needle {key} already deleted")
            if nv.size == 0:
                return Needle(id=key), nv.offset_units, 0
            n = read_needle_data(
                self.data_backend, to_actual_offset(nv.offset_units), nv.size, self.version
            )
        if n.has_ttl() and n.ttl is not None and n.ttl.minutes:
            if n.has_last_modified_date() and time.time() >= n.last_modified + n.ttl.minutes * 60:
                raise NotFound(f"needle {key} expired")
        return n, nv.offset_units, nv.size

    def locate_live(self, key: int):
        """(offset_units, size) of the key's live record, or None when the
        key is absent/deleted. One locked map probe — the hot-needle
        cache's per-hit freshness check. Cache hits are real reads: they
        count into the lifecycle heat here (the only per-hit volume
        touchpoint), or a perfectly-cached volume would look COLD to the
        lifecycle planner and get erasure-coded out from under its
        traffic."""
        self.heat.note_read()
        with self._lock:
            nv = self.nm.get(key)
        if (
            nv is None
            or nv.offset_units == 0
            or nv.size == TOMBSTONE_FILE_SIZE
        ):
            return None
        return nv.offset_units, nv.size

    def bulk_lookup(self, keys, use_device: Optional[bool] = None):
        """Batched fid -> (offset, size) index probes.

        Instead of one binary search per request (ref: weed/storage/
        needle_map/compact_map.go:145-172), bulk probes run as one search
        on the card over the volume's IndexSnapshot (ops/index_kernel.py,
        kernel csrc/index_search.cu). The snapshot is cached per volume
        and invalidated by the map's mutation token, so steady-state
        serving moves only the probes and the answers.

        use_device None applies the JAX package's policy: batches of 64
        keys or more go to the snapshot, smaller ones (and the 5-byte
        offset build, whose offset units exceed the kernel's u32 columns)
        to the host map. The snapshot lives on this volume's `device`;
        with no CUDA and no device="cpu" it raises.

        Returns (offset_units u32[P], sizes u32[P], found bool[P]); a probe
        of a deleted or absent needle reports found=False.
        """
        import numpy as _np

        from ..types import OFFSET_SIZE

        keys = _np.asarray(keys, dtype=_np.uint64)
        snap_fn = getattr(self.nm, "snapshot", None)
        if use_device is None:
            use_device = snap_fn is not None and OFFSET_SIZE == 4 and len(keys) >= 64
        if not use_device or snap_fn is None:
            # u64 offsets under the 5-byte variant (units exceed u32)
            off_dtype = _np.uint64 if OFFSET_SIZE == 5 else _np.uint32
            offsets = _np.zeros(len(keys), dtype=off_dtype)
            sizes = _np.zeros(len(keys), dtype=_np.uint32)
            found = _np.zeros(len(keys), dtype=bool)
            for i, k in enumerate(keys.tolist()):
                nv = self.nm.get(k)
                if (
                    nv is not None
                    and nv.offset_units != 0
                    and nv.size != TOMBSTONE_FILE_SIZE
                ):
                    offsets[i] = nv.offset_units
                    sizes[i] = nv.size
                    found[i] = True
            return offsets, sizes, found

        def locked_cols():
            with self._lock:  # map mutations happen under the volume lock
                return self.nm.snapshot()

        accel = self._index_cache.get(self.nm.snapshot_token, locked_cols)
        return accel.lookup(keys)

    def read_needle_at(self, offset_units: int, size: int) -> Needle:
        """pread one record at a known index location, under the volume lock
        and with the same TTL-expiry visibility as read_needle."""
        self.heat.note_read()
        with self._lock:
            n = read_needle_data(
                self.data_backend, to_actual_offset(offset_units), size, self.version
            )
        if n.has_ttl() and n.ttl is not None and n.ttl.minutes:
            if (
                n.has_last_modified_date()
                and time.time() >= n.last_modified + n.ttl.minutes * 60
            ):
                raise NotFound(f"needle {n.id} expired")
        return n

    def destroy(self, keep_ec_files: bool = False) -> None:
        """Remove the volume's files (ref: volume_read_write.go:44-65).
        keep_ec_files spares the .vif and .heat sidecars that an EC volume
        generated from this one at the same base name still needs, while
        the .dat and .idx go either way."""
        self.close()
        base = self.file_name()
        exts = (".dat", ".idx", ".sdx", ".cpd", ".cpx", ".scrub")
        if not keep_ec_files:
            exts += (".vif", ".heat")
        for ext in exts:
            try:
                os.remove(base + ext)
            except FileNotFoundError:
                pass
        # lsm sidecars (manifest and run files), whatever the current map
        from .needle_map.lsm_map import invalidate_snapshot

        invalidate_snapshot(base)

    def sync(self) -> None:
        self.nm.sync()
        self.data_backend.sync()

    def close(self) -> None:
        # persist the temperature: a clean restart must not look like a
        # cold start to the lifecycle planner
        try:
            self.heat.save(self.file_name() + ".heat")
        except Exception:
            pass
        with self._lock:
            self.nm.close()
            self.data_backend.close()

    # --- scanning ---
    def scan(
        self,
        visit: Callable[[Needle, int, bytes], None],
        read_body: bool = True,
    ) -> None:
        """Visit every record in the .dat in file order
        (ref: volume_read_write.go:371-428)."""
        dat = self.data_backend
        version = self.version
        offset = self.super_block.block_size()
        end = dat.size()
        while offset + NEEDLE_HEADER_SIZE <= end:
            try:
                n, body_len = read_needle_header(dat, version, offset)
            except EOFError:
                return
            body = b""
            if read_body and body_len > 0:
                body = dat.read_at(body_len, offset + NEEDLE_HEADER_SIZE)
                n.read_needle_body_bytes(body, version)
            visit(n, offset, body)
            offset += NEEDLE_HEADER_SIZE + body_len
