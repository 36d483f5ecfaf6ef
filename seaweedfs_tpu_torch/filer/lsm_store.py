"""LSM-tree filer store: WAL + memtable + sorted segment files + compaction.

Fills the reference's embedded-database store role (leveldb/leveldb2,
ref weed/filer2/filerstore.go:12-31, weed/filer2/leveldb2/) with the same
architecture LevelDB itself uses, built natively: acknowledged mutations
land in a fsynced write-ahead log and an in-memory memtable; when the
memtable fills it flushes to an immutable sorted segment file (keys
in memory, values read from disk on demand); lookups consult memtable
then segments newest-first; deletes are tombstones; when segments pile
up they merge into one (newest wins, tombstones dropped). Directory
listings are range scans over the (dir, name) key order.

Ported from the JAX package's filer/lsm_store.py. The WAL, the segment
frames and the MANIFEST are byte for byte the JAX package's, written and
read through the port's util/mpack.py, so a store directory either package
wrote opens in the other. Two changes:

- Each value is packed once: the WAL record is built around its bytes and
  the flush writes them again; a merge copies each surviving record's
  packed bytes instead of decoding and re-packing its value (msgpack
  re-packs a decoded value to the same bytes, so the segment is the one
  the JAX merge writes), and a segment the store just wrote takes its
  keys and value offsets from the writer instead of parsing the file
  again. With the pure-Python codec, packing would otherwise be a third
  of a filer PUT's host time, and compaction, which rewrites each entry
  about log2(n / memtable) times, would decide how large a namespace the
  store can afford.
- The flush-path prefetch hint (`_arena_prefetch_hint`) hands an
  exception from building the run's columns, or from the arena's
  `prefetch`, to that arena (`note_error(..., defer="prefetch")`), which
  raises it at its next probe; the JAX hint swallows it. "No arena live"
  stays a counted skip, and the store's write never fails for the hint:
  the segment and the MANIFEST are durable before it runs. The hint goes
  to the arena the store's owner names (`prefetch_arena`, which the filer
  server sets from its meta gate), else to the process's default arena
  if one exists.
"""

from __future__ import annotations

import bisect
import hashlib
import heapq
import os
import struct
import threading
from typing import Dict, List, Optional, Tuple

from ..util import mpack
from .entry import Entry
from .filer_store import _split as _key  # same (dir, name) rule as every store

_FRAME = struct.Struct("<II")  # key-bytes length, value-bytes length
_TOMBSTONE = b"\xc0"  # msgpack nil: a deleted key's packed value


def path_hash64(d: str, n: str) -> int:
    """Stable 64-bit key for one (dir, name) — how string path keys ride
    the u64-keyed ragged device kernel. blake2b is keyed-collision-free
    enough that a collision is a per-probe host re-check, not a design
    concern; '\\x00' can't appear in either component so the pairing is
    injective."""
    return int.from_bytes(
        hashlib.blake2b(
            (d + "\x00" + n).encode("utf-8"), digest_size=8
        ).digest(),
        "little",
    )


def _group_sorted(it):
    """Group a key-sorted (key, payload) iterator into (key, [payloads])."""
    cur_key = None
    group: list = []
    for key, payload in it:
        if key != cur_key:
            if group:
                yield cur_key, group
            cur_key, group = key, [payload]
        else:
            group.append(payload)
    if group:
        yield cur_key, group


def _fsync_dir(path: str) -> None:
    """Persist directory entries (a rename is only durable once the dir is
    fsynced — without this a crash can lose a just-written segment)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _frames(data: bytes):
    """(key-bytes start, klen, vlen) of every frame of a segment file."""
    pos, end = 0, len(data)
    while pos + _FRAME.size <= end:
        klen, vlen = _FRAME.unpack_from(data, pos)
        pos += _FRAME.size
        yield pos, klen, vlen
        pos += klen + vlen


class _Segment:
    """One immutable sorted file: keys + value offsets in memory, values on
    disk. Records are [klen][vlen][key-msgpack][value-msgpack]. `known`
    is the (keys, offsets) the writer just laid out, which spares parsing
    the file it wrote."""

    def __init__(self, path: str, known=None):
        self.path = path
        if known is not None:
            self.keys, self._offsets = known
        else:
            self.keys: List[Tuple[str, str]] = []
            self._offsets: List[Tuple[int, int]] = []  # (value offset, vlen)
            # ONE sequential read, frames parsed from the buffer: per-frame
            # read()/tell()/seek() syscalls dominated segment-open cost at
            # metadata QPS rates (every flush and merge reopens a segment)
            with open(path, "rb") as f:
                data = f.read()
            for pos, klen, vlen in _frames(data):
                key = mpack.unpackb(data[pos : pos + klen])
                self.keys.append((key[0], key[1]))
                self._offsets.append((pos + klen, vlen))
        self._f = open(path, "rb")
        self._arena_seg = None

    def get(self, key: Tuple[str, str]) -> Optional[Tuple[bool, Optional[dict]]]:
        """-> (found, entry_dict_or_None-for-tombstone) or None if absent."""
        i = bisect.bisect_left(self.keys, key)
        if i >= len(self.keys) or self.keys[i] != key:
            return None
        return True, self._value(i)

    def _value(self, i: int) -> Optional[dict]:
        off, vlen = self._offsets[i]
        self._f.seek(off)
        raw = self._f.read(vlen)
        return mpack.unpackb(raw)  # None == tombstone

    def scan(self, lo: Tuple[str, str], hi: Tuple[str, str]):
        """Yield (key, entry_dict_or_None) for lo <= key < hi."""
        i = bisect.bisect_left(self.keys, lo)
        while i < len(self.keys) and self.keys[i] < hi:
            yield self.keys[i], self._value(i)
            i += 1

    def items(self) -> list:
        """Every (key, value) pair via ONE sequential file read — the
        bulk accessor of iter_all."""
        with open(self.path, "rb") as f:
            data = f.read()
        return [
            (key, mpack.unpackb(data[off : off + vlen]))
            for key, (off, vlen) in zip(self.keys, self._offsets)
        ]

    def raw_items(self) -> list:
        """Every (key, packed key, packed value) via ONE sequential file
        read — the merge's accessor, which copies records without
        decoding their values."""
        with open(self.path, "rb") as f:
            data = f.read()
        return [
            (key, data[pos : pos + klen], data[pos + klen : pos + klen + vlen])
            for key, (pos, klen, vlen) in zip(self.keys, _frames(data))
        ]

    def arena_segment(self):
        """Immutable DeviceColumnArena descriptor: the segment's keys as
        a SORTED u64 hash column, offs carrying the permutation back to
        the original row (so a device hit decodes to `keys[off]` /
        `_value(off)` host-side), sizes all-ones (unused; the kernel's
        column layout wants one). Built once and cached — segments never
        change content. No bloom: filer stores cap at max_segments=4, so
        the pre-filter buys little here."""
        seg = self._arena_seg
        if seg is None:
            import numpy as np

            from ..ops.ragged_lookup import ArenaSegment

            h = np.fromiter(
                (path_hash64(d, n) for d, n in self.keys),
                dtype=np.uint64,
                count=len(self.keys),
            )
            perm = np.argsort(h, kind="stable").astype(np.uint32)
            seg = self._arena_seg = ArenaSegment(
                keys=np.ascontiguousarray(h[perm]),
                offs=perm,
                sizes=np.ones(len(perm), dtype=np.uint32),
                source=self,
                # compaction closes merged-away segments; the arena
                # prunes them at its next refresh
                alive=lambda s=self: not s._f.closed,
            )
        return seg

    def close(self) -> None:
        self._f.close()


def _arena_prefetch_hint(seg: "_Segment", arena=None) -> str:
    """Offer a newly sealed run to a device column arena: `arena`, else
    the process's default one if it exists (an arena is never CREATED
    here). No arena is a counted skip and builds no columns. An exception
    from building the columns or from `prefetch` is handed to the arena,
    which raises it at its next probe (never to the store's writer).
    Every outcome lands in arena_prefetch_total{result}."""
    from ..ops.ragged_lookup import peek_default_arena
    from ..util.metrics import ARENA_PREFETCH

    if arena is None:
        arena = peek_default_arena()
    if arena is None:
        result = "no_arena"
    else:
        try:
            result = arena.prefetch(seg.arena_segment())
        except Exception as e:
            arena.note_error(e, defer="prefetch")
            result = "error"
    ARENA_PREFETCH.inc(result=result)
    return result


def _write_segment_raw(path: str, rows) -> tuple:
    """Write (key, packed key, packed value) rows; -> (keys, offsets) of
    the file, as _Segment would parse them."""
    keys: List[Tuple[str, str]] = []
    offsets: List[Tuple[int, int]] = []
    parts = []
    pos = 0
    for key, kb, vb in rows:
        parts.append(_FRAME.pack(len(kb), len(vb)))
        parts.append(kb)
        parts.append(vb)
        pos += _FRAME.size + len(kb)
        keys.append(key)
        offsets.append((pos, len(vb)))
        pos += len(vb)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(b"".join(parts))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return keys, offsets


def _wal_record(key: Tuple[str, str], vb: bytes) -> bytes:
    """The WAL record {"d": dir, "n": name, "e": value} around the value's
    packed bytes: the bytes mpack.packb of that dict gives."""
    return b"".join((b"\x83\xa1d", mpack.packb(key[0]), b"\xa1n", mpack.packb(key[1]),
                     b"\xa1e", vb))


class LsmFilerStore:
    """FilerStore over a directory of WAL + segment files."""

    def __init__(
        self,
        directory: str,
        memtable_limit: int = 512,
        max_segments: int = 4,
        fsync: bool = True,
    ):
        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        # exclusive directory lock: two processes appending the same
        # wal.log / racing MANIFEST rewrites would corrupt the store (the
        # sqlite-backed stores get this from their engine; LevelDB itself
        # uses a LOCK file) — fail fast instead
        self._lock_fd = os.open(
            os.path.join(directory, "LOCK"), os.O_CREAT | os.O_RDWR, 0o644
        )
        try:
            import fcntl

            fcntl.flock(self._lock_fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except (ImportError, AttributeError):
            pass  # non-POSIX: no advisory locking available
        except OSError:
            os.close(self._lock_fd)
            raise RuntimeError(
                f"lsm store directory {directory!r} is locked by another "
                "process"
            )
        self.memtable_limit = memtable_limit
        self.max_segments = max_segments
        self.fsync = fsync
        self.write_rounds = 0  # see MemoryFilerStore.write_rounds
        # the arena the flush path offers sealed runs to (None: the
        # process's default arena, if one exists)
        self.prefetch_arena = None
        self._lock = threading.RLock()
        self._mem: Dict[Tuple[str, str], Optional[dict]] = {}
        # the packed value of each memtable entry written in this process
        # (the WAL record carries the same bytes): the flush writes them
        # instead of packing the value again
        self._mem_packed: Dict[Tuple[str, str], bytes] = {}

        # the MANIFEST names the live segments; files it doesn't list are
        # leftovers from an interrupted compaction and are ignored + swept
        # (so a failed old-segment delete can never resurrect entries)
        self._manifest_path = os.path.join(directory, "MANIFEST")
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                seqs = [int(x) for x in f.read().split() if x]
        else:
            seqs = sorted(
                int(fn[4:-4])
                for fn in os.listdir(directory)
                if fn.startswith("seg-") and fn.endswith(".sst")
            )
        self._segments: List[_Segment] = [  # oldest .. newest
            _Segment(os.path.join(directory, f"seg-{seq}.sst"))
            for seq in seqs
        ]
        self._seqs = list(seqs)
        self._next_seq = (max(seqs) + 1) if seqs else 1
        self._sweep_unlisted()

        # WAL replay: mutations acknowledged but not yet flushed
        self._wal_path = os.path.join(directory, "wal.log")
        if os.path.exists(self._wal_path):
            with open(self._wal_path, "rb") as f:
                for rec in mpack.Unpacker(f):
                    self._mem[(rec["d"], rec["n"])] = rec["e"]
        self._wal = open(self._wal_path, "ab")

    # ---------------- write path ----------------
    def _log(self, key: Tuple[str, str], value: Optional[dict]) -> None:
        vb = mpack.packb(value)
        self._wal.write(_wal_record(key, vb))
        self._wal.flush()
        if self.fsync:
            os.fsync(self._wal.fileno())
        self._mem[key] = value
        self._mem_packed[key] = vb
        if len(self._mem) >= self.memtable_limit:
            self._flush_memtable()

    def _write_manifest(self) -> None:
        tmp = self._manifest_path + ".tmp"
        with open(tmp, "w") as f:
            f.write("\n".join(str(s) for s in self._seqs))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path)
        _fsync_dir(self.dir)

    def _sweep_unlisted(self) -> None:
        listed = {f"seg-{s}.sst" for s in self._seqs}
        for fn in os.listdir(self.dir):
            if fn.startswith("seg-") and fn not in listed:
                try:
                    os.remove(os.path.join(self.dir, fn))
                except OSError:
                    pass

    def _flush_memtable(self) -> None:
        if not self._mem:
            return
        seq = self._next_seq
        path = os.path.join(self.dir, f"seg-{seq}.sst")
        packed = self._mem_packed
        known = _write_segment_raw(path, (
            (key, mpack.packb(list(key)), packed.get(key) or mpack.packb(value))
            for key, value in sorted(self._mem.items())
        ))
        _fsync_dir(self.dir)  # the segment must survive before the WAL goes
        seg = _Segment(path, known)
        self._segments.append(seg)
        self._seqs.append(seq)
        self._next_seq += 1
        self._write_manifest()
        self._mem = {}
        self._mem_packed = {}
        self._wal.close()
        self._wal = open(self._wal_path, "wb")  # truncate: flushed == durable
        if len(self._segments) > self.max_segments:
            self._compact()
        else:
            # the device arena learns the sealed run NOW, from the flush
            # path, instead of paying a first-miss ensure+refresh on the
            # next probe batch. Compaction skips the hint — its merged run
            # replaces segments the arena prunes at refresh anyway.
            _arena_prefetch_hint(seg, self.prefetch_arena)

    def _compact(self) -> None:
        """Tiered compaction: merge the ADJACENT segment pair with the
        smallest combined key count, repeating until the count fits
        max_segments. Merging the smallest adjacent pair keeps segments
        geometrically sized so each entry is rewritten O(log n) times.
        Adjacency preserves the rank (newest-wins) order; tombstones drop
        only when a merge includes the OLDEST segment (a mid-stack
        tombstone must keep shadowing older copies). Crash-safe via the
        MANIFEST: the merged segment becomes live only when the manifest
        points at it, and unlisted leftovers are swept."""
        while len(self._segments) > self.max_segments:
            sizes = [len(s.keys) for s in self._segments]
            lo = min(
                range(len(sizes) - 1), key=lambda j: sizes[j] + sizes[j + 1]
            )
            self._merge_adjacent(lo, lo + 2)

    def _merge_adjacent(self, lo: int, hi: int) -> None:
        merged: Dict[Tuple[str, str], tuple] = {}
        for seg in self._segments[lo:hi]:  # oldest -> newest overwrites
            for key, kb, vb in seg.raw_items():
                merged[key] = (key, kb, vb)
        rows = [merged[k] for k in sorted(merged)]
        if lo == 0:  # nothing older left to shadow: tombstones drop
            rows = [r for r in rows if r[2] != _TOMBSTONE]
        old = self._segments[lo:hi]
        new_seg = None
        if rows:
            seq = self._next_seq
            path = os.path.join(self.dir, f"seg-{seq}.sst")
            known = _write_segment_raw(path, rows)
            _fsync_dir(self.dir)
            new_seg = _Segment(path, known)
            self._segments[lo:hi] = [new_seg]
            self._seqs[lo:hi] = [seq]
            self._next_seq += 1
        else:
            self._segments[lo:hi] = []
            self._seqs[lo:hi] = []
        self._write_manifest()
        for seg in old:
            seg.close()
        self._sweep_unlisted()
        if new_seg is not None and len(self._segments) <= self.max_segments:
            # the compacted run is sealed too
            _arena_prefetch_hint(new_seg, self.prefetch_arena)

    # ---------------- FilerStore interface ----------------
    def insert_entry(self, entry: Entry) -> None:
        with self._lock:
            self.write_rounds += 1
            self._log(_key(entry.full_path), entry.to_dict())

    update_entry = insert_entry

    def insert_many(self, entries: List[Entry]) -> None:
        """Batched upsert: the whole batch's WAL records go out in ONE
        buffered write + flush/fsync (the per-entry path pays a fsync
        each), then land in the memtable together."""
        if not entries:
            return
        with self._lock:
            self.write_rounds += 1
            recs = []
            rows = []
            for entry in entries:
                key = _key(entry.full_path)
                value = entry.to_dict()
                vb = mpack.packb(value)
                recs.append(_wal_record(key, vb))
                rows.append((key, value, vb))
            self._wal.write(b"".join(recs))
            self._wal.flush()
            if self.fsync:
                os.fsync(self._wal.fileno())
            for key, value, vb in rows:
                self._mem[key] = value
                self._mem_packed[key] = vb
            if len(self._mem) >= self.memtable_limit:
                self._flush_memtable()

    def find_entry(self, full_path: str) -> Optional[Entry]:
        with self._lock:
            v = self._current(_key(full_path))
        return Entry.from_dict(v) if v is not None else None

    def find_many(self, paths: List[str]) -> Dict[str, Entry]:
        """Batched probe: many keys under ONE lock acquisition (each
        probe is a memtable hit or a few segment bisects) — the
        gate-batched lookup seam."""
        out: Dict[str, Entry] = {}
        with self._lock:
            for p in paths:
                v = self._current(_key(p))
                if v is not None:
                    out[p] = Entry.from_dict(v)
        return out

    def iter_all(self):
        """Every live (directory, name, Entry) in key order (newest-wins
        fold of memtable + segments, tombstones dropped)."""
        with self._lock:
            merged: Dict[Tuple[str, str], Optional[dict]] = {}
            for seg in self._segments:  # oldest -> newest overwrites
                merged.update(seg.items())
            merged.update(self._mem)
            snap = [
                (k[0], k[1], Entry.from_dict(v))
                for k, v in sorted(merged.items())
                if v is not None
            ]
        return iter(snap)

    def delete_entry(self, full_path: str) -> None:
        with self._lock:
            self._log(_key(full_path), None)

    def delete_folder_children(self, full_path: str) -> None:
        prefix = full_path.rstrip("/")
        with self._lock:
            for d, name in self._subtree_keys(prefix):
                self._log((d, name), None)

    def _subtree_keys(self, prefix: str) -> List[Tuple[str, str]]:
        """Every live key whose directory is prefix or below it."""
        out = set()
        deep = prefix + "/"

        def in_scope(d: str) -> bool:
            return d == prefix or d.startswith(deep)

        for key, v in self._mem.items():
            if v is not None and in_scope(key[0]):
                out.add(key)
        for seg in self._segments:
            for key in seg.keys:
                if in_scope(key[0]):
                    out.add(key)
        # drop keys already dead at the current view
        return [
            k
            for k in sorted(out)
            if self._current(k) is not None
        ]

    def arena_view(self, paths: List[str]):
        """One consistent view for a ragged device dispatch (the
        needle map's `arena_view` twin): memtable hits host-side —
        tombstones included, they must shadow the segments — plus the
        current segment set newest-first as arena descriptors, both
        taken under one lock acquisition."""
        with self._lock:
            mem_hits = {}
            for p in paths:
                k = _key(p)
                if k in self._mem:
                    mem_hits[p] = self._mem[k]
            segments = [
                s.arena_segment() for s in reversed(self._segments)
            ]
        return mem_hits, segments

    def arena_decode(self, seg, row: int, path: str):
        """Verify-and-decode one device hit against the segment the
        arena answered from. Returns (ok, value) — ok False on a hash
        collision or a segment compacted away underneath (caller
        re-probes authoritatively); value None == tombstone."""
        src = seg.source
        key = _key(path)
        try:
            with self._lock:
                if src.keys[row] != key:
                    return False, None
                return True, src._value(row)
        except Exception:
            return False, None

    def _current(self, key: Tuple[str, str]) -> Optional[dict]:
        if key in self._mem:
            return self._mem[key]
        for seg in reversed(self._segments):
            hit = seg.get(key)
            if hit is not None:
                return hit[1]
        return None

    def list_directory_entries(
        self, dir_path: str, start_file_name: str, inclusive: bool, limit: int
    ) -> List[Entry]:
        d = dir_path.rstrip("/") or "/"
        # resume the scan AT the pagination cursor (every source bisects to
        # it) and stop as soon as `limit` live names have merged — a page
        # costs O(page), not O(directory)
        lo = (d, start_file_name or "")
        hi = (d + "\x00", "")  # first key of any later directory
        with self._lock:

            def tagged(seg, rank):  # bind rank NOW, not at generation time
                return ((key, (rank, v)) for key, v in seg.scan(lo, hi))

            sources = [
                tagged(seg, rank)
                for rank, seg in enumerate(self._segments)
            ]
            mem_rank = len(self._segments)  # memtable is newest
            sources.append(
                (
                    (key, (mem_rank, self._mem[key]))
                    # range-filter BEFORE sorting: the memtable source
                    # costs O(in-range), not O(memtable log memtable),
                    # per page
                    for key in sorted(
                        k for k in self._mem if lo <= k < hi
                    )
                )
            )
            out: List[Entry] = []
            for key, group in _group_sorted(heapq.merge(*sources)):
                name = key[1]
                if start_file_name:
                    if inclusive and name < start_file_name:
                        continue
                    if not inclusive and name <= start_file_name:
                        continue
                v = max(group)[1]  # highest rank = newest version
                if v is None:
                    continue
                out.append(Entry.from_dict(v))
                if len(out) >= limit:
                    break
            return out

    def close(self) -> None:
        with self._lock:
            self._flush_memtable()
            self._wal.close()
            for seg in self._segments:
                seg.close()
            if self._lock_fd is not None:
                os.close(self._lock_fd)  # releases the flock
                self._lock_fd = None
