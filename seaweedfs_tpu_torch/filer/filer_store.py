"""Pluggable filer stores (ref: weed/filer2/filerstore.go:12-31).

Interface: insert/update/find/delete/delete_children/list by (directory,
name). Three implementations: in-memory dict (ref memdb store), sqlite
(standing in for the reference's leveldb/mysql/postgres family — same
abstract-sql shape, ref weed/filer2/abstract_sql/), and an append-only
log store (WAL + memory index, standing in for the leveldb2 family —
durable writes without a database dependency).

Ported whole from the JAX package's filer/filer_store.py; the log store
writes and replays its records through the port's util/mpack.py, so a
`*.flog` either package wrote opens in the other."""

from __future__ import annotations

import json
import sqlite3
import threading
from typing import Optional, Protocol

from ..util import mpack
from .entry import Entry


class FilerStore(Protocol):
    def insert_entry(self, entry: Entry) -> None: ...
    def insert_many(self, entries: list[Entry]) -> None: ...
    def update_entry(self, entry: Entry) -> None: ...
    def find_entry(self, full_path: str) -> Optional[Entry]: ...
    def delete_entry(self, full_path: str) -> None: ...
    def delete_folder_children(self, full_path: str) -> None: ...
    def list_directory_entries(
        self, dir_path: str, start_file_name: str, inclusive: bool, limit: int
    ) -> list[Entry]: ...


def _split(full_path: str) -> tuple[str, str]:
    if full_path == "/":
        return "", "/"
    d, _, name = full_path.rstrip("/").rpartition("/")
    return d or "/", name


class MemoryFilerStore:
    def __init__(self):
        # directory -> {name -> Entry}
        self._dirs: dict[str, dict[str, Entry]] = {}
        self._lock = threading.RLock()
        # store round-trips taken by the write path: one per
        # insert_entry call, one per insert_many FLUSH (regardless of
        # batch width). The write-gate bench's "counted, not projected"
        # coalescing evidence — every store kind maintains it.
        self.write_rounds = 0

    def insert_entry(self, entry: Entry) -> None:
        d, name = _split(entry.full_path)
        with self._lock:
            self.write_rounds += 1
            self._dirs.setdefault(d, {})[name] = entry

    update_entry = insert_entry

    def insert_many(self, entries: list[Entry]) -> None:
        """Batched upsert: many entries under ONE lock acquisition —
        the write-side twin of find_many (gate-batched write seam)."""
        with self._lock:
            self.write_rounds += 1
            for entry in entries:
                d, name = _split(entry.full_path)
                self._dirs.setdefault(d, {})[name] = entry

    def find_entry(self, full_path: str) -> Optional[Entry]:
        d, name = _split(full_path)
        with self._lock:
            return self._dirs.get(d, {}).get(name)

    def find_many(self, paths: list[str]) -> dict[str, Entry]:
        """Batched probe: many paths under ONE lock acquisition — the
        gate-batched lookup seam every store kind offers."""
        out: dict[str, Entry] = {}
        with self._lock:
            for p in paths:
                d, name = _split(p)
                e = self._dirs.get(d, {}).get(name)
                if e is not None:
                    out[p] = e
        return out

    def iter_all(self):
        """Every (directory, name, Entry), per-directory sorted — the
        sharded store's rebalance/cleanup bulk accessor."""
        with self._lock:
            snap = [
                (d, name, self._dirs[d][name])
                for d in sorted(self._dirs)
                for name in sorted(self._dirs[d])
            ]
        return iter(snap)

    def delete_entry(self, full_path: str) -> None:
        d, name = _split(full_path)
        with self._lock:
            self._dirs.get(d, {}).pop(name, None)

    def delete_folder_children(self, full_path: str) -> None:
        prefix = full_path.rstrip("/")
        with self._lock:
            self._dirs.pop(prefix, None)
            for d in [k for k in self._dirs if k.startswith(prefix + "/")]:
                self._dirs.pop(d, None)

    def list_directory_entries(
        self, dir_path: str, start_file_name: str, inclusive: bool, limit: int
    ) -> list[Entry]:
        with self._lock:
            names = sorted(self._dirs.get(dir_path.rstrip("/") or "/", {}))
            out = []
            for name in names:
                if start_file_name:
                    if inclusive and name < start_file_name:
                        continue
                    if not inclusive and name <= start_file_name:
                        continue
                out.append(self._dirs[dir_path.rstrip("/") or "/"][name])
                if len(out) >= limit:
                    break
            return out


class SqliteFilerStore:
    """Durable store with the abstract-sql schema shape
    (dirhash+name keyed rows, ref weed/filer2/abstract_sql)."""

    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.RLock()
        self.write_rounds = 0  # see MemoryFilerStore.write_rounds
        self._conn.execute(
            """CREATE TABLE IF NOT EXISTS filemeta (
                directory TEXT NOT NULL,
                name TEXT NOT NULL,
                meta TEXT NOT NULL,
                PRIMARY KEY (directory, name)
            )"""
        )
        self._conn.commit()

    def insert_entry(self, entry: Entry) -> None:
        d, name = _split(entry.full_path)
        with self._lock:
            self.write_rounds += 1
            self._conn.execute(
                "REPLACE INTO filemeta (directory, name, meta) VALUES (?,?,?)",
                (d, name, json.dumps(entry.to_dict())),
            )
            self._conn.commit()

    update_entry = insert_entry

    def insert_many(self, entries: list[Entry]) -> None:
        """Batched upsert: ONE executemany + ONE commit for the whole
        batch — this is where gate coalescing buys real durability
        round-trips back (per-entry insert pays a commit each)."""
        if not entries:
            return
        rows = []
        for entry in entries:
            d, name = _split(entry.full_path)
            rows.append((d, name, json.dumps(entry.to_dict())))
        with self._lock:
            self.write_rounds += 1
            self._conn.executemany(
                "REPLACE INTO filemeta (directory, name, meta) VALUES (?,?,?)",
                rows,
            )
            self._conn.commit()

    def find_entry(self, full_path: str) -> Optional[Entry]:
        d, name = _split(full_path)
        with self._lock:
            row = self._conn.execute(
                "SELECT meta FROM filemeta WHERE directory=? AND name=?",
                (d, name),
            ).fetchone()
        return Entry.from_dict(json.loads(row[0])) if row else None

    def find_many(self, paths: list[str]) -> dict[str, Entry]:
        """ONE row-value IN query for many paths: the per-query
        prepare/step overhead amortizes over the batch, and sqlite
        releases the GIL inside the C probe — the property the sharded
        store's parallel fan-out rides."""
        out: dict[str, Entry] = {}
        if not paths:
            return out
        keys = [_split(p) for p in paths]
        by_key = {k: p for k, p in zip(keys, paths)}
        uniq = list(by_key)
        with self._lock:
            for i in range(0, len(uniq), 200):
                chunk = uniq[i : i + 200]
                placeholders = ",".join(["(?,?)"] * len(chunk))
                rows = self._conn.execute(
                    "SELECT directory, name, meta FROM filemeta "
                    f"WHERE (directory, name) IN (VALUES {placeholders})",
                    [x for pair in chunk for x in pair],
                ).fetchall()
                for d, name, meta in rows:
                    out[by_key[(d, name)]] = Entry.from_dict(
                        json.loads(meta)
                    )
        return out

    def iter_all(self):
        with self._lock:
            rows = self._conn.execute(
                "SELECT directory, name, meta FROM filemeta "
                "ORDER BY directory, name"
            ).fetchall()
        return (
            (d, name, Entry.from_dict(json.loads(meta)))
            for d, name, meta in rows
        )

    def delete_entry(self, full_path: str) -> None:
        d, name = _split(full_path)
        with self._lock:
            self._conn.execute(
                "DELETE FROM filemeta WHERE directory=? AND name=?", (d, name)
            )
            self._conn.commit()

    def delete_folder_children(self, full_path: str) -> None:
        prefix = full_path.rstrip("/")
        with self._lock:
            self._conn.execute(
                "DELETE FROM filemeta WHERE directory=? OR directory LIKE ?",
                (prefix, prefix + "/%"),
            )
            self._conn.commit()

    def list_directory_entries(
        self, dir_path: str, start_file_name: str, inclusive: bool, limit: int
    ) -> list[Entry]:
        op = ">=" if inclusive else ">"
        with self._lock:
            rows = self._conn.execute(
                f"SELECT meta FROM filemeta WHERE directory=? AND name {op} ? "
                "ORDER BY name LIMIT ?",
                (dir_path.rstrip("/") or "/", start_file_name, limit),
            ).fetchall()
        return [Entry.from_dict(json.loads(r[0])) for r in rows]

    def scan_directory_entries(
        self,
        dir_path: str,
        start_file_name: str,
        inclusive: bool,
        limit: int,
        upper_bound: str = "",
    ) -> list[Entry]:
        """list_directory_entries with the scan's UPPER bound pushed into
        the indexed range predicate: a prefix-bounded
        LIST page over this store pulls only rows inside
        [start, upper_bound), never a full generic page it then discards
        — scanned-rows-per-page matches the in-memory stores'
        O(max-keys) bound. The (directory, name) primary key makes both
        bounds one index range."""
        if not upper_bound:
            return self.list_directory_entries(
                dir_path, start_file_name, inclusive, limit
            )
        op = ">=" if inclusive else ">"
        with self._lock:
            rows = self._conn.execute(
                f"SELECT meta FROM filemeta WHERE directory=? AND name {op} ?"
                " AND name < ? ORDER BY name LIMIT ?",
                (
                    dir_path.rstrip("/") or "/",
                    start_file_name,
                    upper_bound,
                    limit,
                ),
            ).fetchall()
        return [Entry.from_dict(json.loads(r[0])) for r in rows]


# ------------- S3-key-order subtree range scan (the LIST path) -------------
#
# An S3 LIST over a filer-backed bucket must produce keys in full-path
# order while the stores key entries by (directory, name). The old
# gateway walked the WHOLE bucket subtree per request and sorted; this
# scanner streams the subtree lazily in exact S3 key order — a
# directory d's subtree is contiguous at sort position d+"/" — pulling
# bounded pages per directory level, so one LIST page costs O(page),
# not O(bucket). `ScanStats.scanned` discloses the actual entries
# pulled (the bench's scanned-entries-per-request number).

_MAX_CHAR = chr(0x10FFFF)


def prefix_successor(prefix: str) -> str:
    """Smallest string greater than EVERY string with this prefix
    ('' when none exists) — the seek-past-a-delimiter-group cursor."""
    p = prefix.rstrip(_MAX_CHAR)
    if not p:
        return ""
    return p[:-1] + chr(ord(p[-1]) + 1)


class ScanStats:
    """Entries pulled from the store by a scan — the disclosed work
    bound of a LIST page."""

    __slots__ = ("scanned",)

    def __init__(self):
        self.scanned = 0


def _iter_dir_entries(
    store, dir_path: str, floor: str, stats, page: int, upper: str = ""
):
    """Entries of one directory in name order starting at `floor`
    (inclusive), streamed in `page`-sized rounds through the store's
    bounded range scan (`list_directory_entries` resumes AT the cursor
    on every store family, so each round costs O(page) regardless of
    directory size — the LSM store additionally range-filters its
    memtable source before sorting). When the caller knows the scan's
    UPPER bound (a prefix's successor) and the store can push it into
    its query (`scan_directory_entries`, the sqlite store's indexed
    range predicate), the final page pulls only in-range rows instead
    of a generic page the consumer would discard. Every PULLED entry
    counts into `stats`, whether or not the consumer keeps it: the
    disclosed scanned-entries number is store work done, not results
    returned."""
    scan = getattr(store, "scan_directory_entries", None) if upper else None
    cursor, inclusive = floor, True
    while True:
        if scan is not None:
            batch = scan(dir_path, cursor, inclusive, page, upper)
        else:
            batch = store.list_directory_entries(
                dir_path, cursor, inclusive, page
            )
        if stats is not None:
            stats.scanned += len(batch)
        for e in batch:
            yield e
        if len(batch) < page:
            return
        cursor, inclusive = batch[-1].name, False


def scan_subtree(
    store,
    root: str,
    start_at: str = "",
    prefix: str = "",
    stats: Optional[ScanStats] = None,
    page: int = 64,
    descend=None,
):
    """Yield (key, Entry) for file entries under `root` in S3 key order.

    - `key` is the "/"-joined path relative to root;
    - keys satisfy key >= start_at (inclusive lower bound) and
      key.startswith(prefix) — both pushed down into per-directory page
      cursors, so skipped ranges are never enumerated;
    - `descend(dir_key)` (dir_key ends with "/") may return False to
      SKIP a whole subtree; the scanner then yields one (dir_key, None)
      group marker at its sort position instead — the delimiter="/"
      CommonPrefixes path, which pays O(1) per group rather than
      enumerating it. The marker's key may sort below start_at when
      start_at points inside the group (S3 lists a group that still has
      keys past the marker).

    Name order within one directory is NOT key order (a directory d
    sorts at d+"/", after files like d"!"): a small look-ahead heap
    reorders entries, safe because an unread entry's sort key is always
    greater than the last name pulled.
    """
    yield from _scan_dir(
        store, root.rstrip("/"), "", start_at, prefix, stats, page, descend
    )


def _name_floor(start_at: str) -> str:
    """Lowest directory-entry NAME that can still contribute a key
    >= start_at: start_at truncated before its first char <= "/". Names
    below this can neither be files >= start_at nor directories whose
    subtree (keys name+"/"+...) reaches start_at — a dir named "0" can
    hold keys above start_at "0-x/y" because "/" outsorts "-", so naive
    first-path-component truncation would skip live subtrees."""
    for i, c in enumerate(start_at):
        if c <= "/":
            return start_at[:i]
    return start_at


def _scan_dir(store, dir_path, rel, start_at, prefix, stats, page, descend):
    import heapq

    floor = _name_floor(start_at) if start_at else ""
    stop_at = ""
    if prefix:
        pc = prefix.partition("/")[0]
        if "/" in prefix:
            # only the directory named exactly `pc` can contribute
            floor = max(floor, pc)
            stop_at = pc + "\x00"
        else:
            floor = max(floor, prefix)
            stop_at = prefix_successor(prefix)

    def emit(e):
        if e.is_directory:
            sub = e.name + "/"
            if start_at and not start_at.startswith(sub) and start_at > sub:
                return  # whole subtree sorts below start_at
            if prefix:
                if prefix.startswith(sub):
                    child_prefix = prefix[len(sub):]
                elif sub.startswith(prefix):
                    child_prefix = ""
                else:
                    return
            else:
                child_prefix = ""
            child_start = (
                start_at[len(sub):] if start_at.startswith(sub) else ""
            )
            key_prefix = rel + sub
            if descend is not None and not descend(key_prefix):
                yield (key_prefix, None)  # group marker; subtree skipped
                return
            yield from _scan_dir(
                store, e.full_path, key_prefix, child_start, child_prefix,
                stats, page, descend,
            )
        else:
            name = e.name
            if start_at and name < start_at:
                return
            if prefix and ("/" in prefix or not name.startswith(prefix)):
                return
            yield (rel + name, e)

    it = _iter_dir_entries(store, dir_path, floor, stats, page, upper=stop_at)
    heap: list = []
    seq = 0
    last = ""
    done = False
    while True:
        # pull until the heap head is provably next in sort order: any
        # unread entry's sort key exceeds the last NAME pulled
        while not done and (not heap or heap[0][0] > last):
            e = next(it, None)
            if e is None:
                done = True
                break
            name = e.name
            if stop_at and name >= stop_at:
                done = True
                break
            last = name
            heapq.heappush(
                heap, ((name + "/") if e.is_directory else name, seq, e)
            )
            seq += 1
        if not heap:
            return
        yield from emit(heapq.heappop(heap)[2])


class LogFilerStore(MemoryFilerStore):
    """Append-only log store: every mutation appends a msgpack record to a
    WAL; reads serve from the in-memory index. Open replays the log, then
    compacts it to just the live entries (the leveldb2-class durability
    role, ref weed/filer2/leveldb2, without a database dependency)."""

    def __init__(self, path: str):
        super().__init__()
        self._path = path
        # replay
        import os

        if os.path.exists(path):
            with open(path, "rb") as f:
                for rec in mpack.Unpacker(f):
                    op = rec.get("op")
                    if op == "put":
                        super().insert_entry(Entry.from_dict(rec["entry"]))
                    elif op == "del":
                        super().delete_entry(rec["path"])
                    elif op == "delchildren":
                        super().delete_folder_children(rec["path"])
        self._compact()
        self._f = open(path, "ab")

    def _compact(self) -> None:
        """Rewrite the log with only live entries (atomic replace)."""
        import os

        tmp = self._path + ".tmp"
        with open(tmp, "wb") as f:
            with self._lock:
                for d in sorted(self._dirs):
                    for name in sorted(self._dirs[d]):
                        f.write(
                            mpack.packb(
                                {
                                    "op": "put",
                                    "entry": self._dirs[d][name].to_dict(),
                                }
                            )
                        )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path)

    def _append(self, rec: dict) -> None:
        import os

        self._f.write(mpack.packb(rec))
        self._f.flush()
        os.fsync(self._f.fileno())  # acknowledged mutations survive a crash

    def insert_entry(self, entry: Entry) -> None:
        with self._lock:
            super().insert_entry(entry)
            self._append({"op": "put", "entry": entry.to_dict()})

    update_entry = insert_entry

    def insert_many(self, entries: list[Entry]) -> None:
        """Batched upsert: one buffered write + ONE flush/fsync for the
        whole batch (the per-entry path fsyncs each record)."""
        if not entries:
            return
        with self._lock:
            self.write_rounds += 1
            for entry in entries:
                d, name = _split(entry.full_path)
                self._dirs.setdefault(d, {})[name] = entry
                self._f.write(
                    mpack.packb(
                        {"op": "put", "entry": entry.to_dict()}
                    )
                )
            import os

            self._f.flush()
            os.fsync(self._f.fileno())

    def delete_entry(self, full_path: str) -> None:
        with self._lock:
            super().delete_entry(full_path)
            self._append({"op": "del", "path": full_path})

    def delete_folder_children(self, full_path: str) -> None:
        with self._lock:
            super().delete_folder_children(full_path)
            self._append({"op": "delchildren", "path": full_path})

    def close(self) -> None:
        self._f.close()
