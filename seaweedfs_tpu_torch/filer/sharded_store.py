"""Prefix-sharded filer store: metadata QPS that scales with cores.

One filer store serializes ALL metadata traffic behind a single lock
(and, for the sqlite/LSM kinds, a single B-tree/WAL). `ShardedFilerStore`
partitions the namespace by DIRECTORY-prefix ranges across N underlying
stores of any existing kind (memory / sqlite / LSM / log):

- **routing is by directory**: every entry of one directory lives in
  exactly ONE shard, so `list_directory_entries` hits a single shard per
  directory and stitches across shard boundaries in exact key order with
  no merge pass;
- **the shard map is crash-safe**: an ordered list of split points over
  directory paths, committed shadow-first (`SHARDMAP.shadow` -> fsync ->
  atomic rename). Routing consults ONLY the committed map, so no path
  ever resolves to two shards — mid-rebalance copies in the destination
  store are invisible until the commit points at them;
- **rebalance is heat-driven**: one `storage/heat.HeatTracker` per shard
  accumulates op heat; when one shard's heat exceeds `rebalance_factor`
  x the mean (and an absolute floor, and a holddown interval), half of
  its directories move to the cooler adjacent shard;
- **moves are crash-safe by step order** (`REBALANCE_STEPS`): intent ->
  purge -> copy -> delta -> commit -> cleanup. A kill before commit
  leaves the source authoritative (copies inert, re-purged on retry); a
  kill after commit leaves the destination authoritative (the recorded
  obligation re-runs cleanup at the next open);
- **moves never lose live traffic**: store ops take a shared (reader)
  slot on a writer-preferring RW lock; a move holds the exclusive
  (writer) slot only for the intent and the delta+commit. During the
  unlocked purge+copy, mutators landing in the moving range record their
  paths in a dirty window the mover replays before the commit.

`find_many` is the gate-batched lookup seam (`filer/meta_gate.py`):
paths group by shard and the per-shard batches run in parallel worker
threads above `_PARALLEL_THRESHOLD` paths.

Ported from the JAX package's filer/sharded_store.py, the same SHARDMAP
bytes and the same moves. Like the JAX store it has no `arena_view`: a
meta gate over it serves every flush from the host `find_many`, counted
in its `host_fallbacks` under reason `no_arena_view`.
"""

from __future__ import annotations

import bisect
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from typing import Callable, Optional

from ..storage.heat import HeatTracker
from ..util.metrics import (
    META_SHARD_COUNT,
    META_SHARD_MOVED,
    META_SHARD_OPS,
    META_SHARD_REBALANCES,
)
from .entry import Entry
from .filer_store import _split, prefix_successor

MAP_NAME = "SHARDMAP"
SHADOW_SUFFIX = ".shadow"

# rebalance hysteresis knobs
REBALANCE_FACTOR = float(
    os.environ.get("SEAWEEDFS_TPU_META_REBALANCE_FACTOR", "4") or 4.0
)
REBALANCE_MIN_HEAT = float(
    os.environ.get("SEAWEEDFS_TPU_META_REBALANCE_MIN_HEAT", "32") or 32.0
)
REBALANCE_MIN_INTERVAL_S = float(
    os.environ.get("SEAWEEDFS_TPU_META_REBALANCE_INTERVAL", "60") or 60.0
)

# rebalance step names in execution order — the kill-point grid of the
# tests enumerates exactly these. "intent" is the
# write-ahead record of the move range: without it, a crash between
# copy and commit would strand copies in the destination that a LATER
# retry (possibly choosing a different split) would never purge.
# "delta" marks the end of the unlocked copy window: mutations recorded
# during purge/copy are replayed under the exclusive lock right after.
REBALANCE_STEPS = ("intent", "purge", "copy", "delta", "commit", "cleanup")

# find_many batches below this run their per-shard probes inline:
# worker-thread dispatch + GIL ping-pong costs more than a
# gate-tick-sized per-shard query saves — only bulk resolutions (cold
# scans, rebalance-scale probes) clear the bar
_PARALLEL_THRESHOLD = int(
    os.environ.get("SEAWEEDFS_TPU_META_PARALLEL_BATCH", "2048") or 2048
)

_BOUND_CHARSET = "0123456789abcdefghijklmnopqrstuvwxyz"


def default_bounds(n_shards: int) -> list[str]:
    """N-1 split points spreading top-level names over [0-9a-z] — the
    data-free initial partition; rebalance corrects real skew."""
    if n_shards <= 1:
        return []
    step = len(_BOUND_CHARSET) / n_shards
    return [
        "/" + _BOUND_CHARSET[min(int(round((i + 1) * step)),
                                 len(_BOUND_CHARSET) - 1)]
        for i in range(n_shards - 1)
    ]


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class _RWLock:
    """Writer-preferring readers-writer lock for shard topology.

    Store ops are readers: they may run concurrently (each sub-store
    serializes its own state) but must observe a stable bounds/route
    and must never land inside a move's copy->cleanup window. A
    rebalance move is the writer: exclusive, so no concurrent mutator
    can be swept by cleanup or resurrected from a stale copy. Writer
    preference (new readers queue once a writer waits) keeps a steady
    read load from starving the rebalance forever.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    @contextmanager
    def read(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if self._readers == 0:
                    self._cond.notify_all()

    @contextmanager
    def write(self):
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = True
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()


def _count_shard_op(op: str) -> None:
    META_SHARD_OPS.inc(op=op)


class ShardedFilerStore:
    """FilerStore over N sub-stores partitioned by directory-path range.

    `factory(name)` builds one underlying store per shard (any kind);
    `directory` holds the crash-safe shard map. An existing SHARDMAP
    wins over `n_shards`/`initial_bounds` (the map is the authority,
    constructor args only seed a fresh store).
    """

    def __init__(
        self,
        directory: str,
        factory: Callable[[str], object],
        n_shards: int = 4,
        initial_bounds: Optional[list[str]] = None,
        heat_half_life_s: Optional[float] = None,
        rebalance_factor: float = 0.0,
        rebalance_min_heat: float = 0.0,
        rebalance_min_interval_s: Optional[float] = None,
        clock: Callable[[], float] = time.time,
        step_hook: Optional[Callable[[str], None]] = None,
    ):
        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        self._factory = factory
        self._clock = clock
        self.step_hook = step_hook
        self.rebalance_factor = rebalance_factor or REBALANCE_FACTOR
        self.rebalance_min_heat = rebalance_min_heat or REBALANCE_MIN_HEAT
        self.rebalance_min_interval_s = (
            rebalance_min_interval_s
            if rebalance_min_interval_s is not None
            else REBALANCE_MIN_INTERVAL_S
        )
        # _rw: topology lock — ops shared, move delta/commit exclusive
        # (see _RWLock); _lock: small mutex for lazy-init + dirty state
        self._rw = _RWLock()
        self._lock = threading.Lock()
        self._pool: Optional[ThreadPoolExecutor] = None
        # in-flight move dirty window: (move_lo, move_hi) while the
        # unlocked copy pass runs; mutators landing in the range record
        # their paths for the pre-commit delta replay. _move_mutex
        # serializes whole moves against each other (bounds + the
        # pending-cleanup obligation are single-writer) without
        # touching the reader path.
        self._move_prep: Optional[tuple[str, str]] = None
        self._move_dirty: set = set()
        self._move_dirty_full = False
        self._move_mutex = threading.Lock()
        self._last_rebalance = 0.0
        self.stats = {
            "ops": 0,
            "batched_lookups": 0,
            "batches": 0,
            "rebalances": 0,
            "moved_entries": 0,
        }

        mf = self._load_map()
        if mf is None:
            names = [f"shard-{i}" for i in range(max(1, n_shards))]
            bounds = (
                list(initial_bounds)
                if initial_bounds is not None
                else default_bounds(len(names))
            )
            if len(bounds) != len(names) - 1:
                raise ValueError(
                    f"{len(names)} shards need {len(names) - 1} bounds, "
                    f"got {len(bounds)}"
                )
            if bounds != sorted(bounds):
                raise ValueError("initial_bounds must be sorted")
            self._names = names
            self._bounds = bounds
            self._pending_cleanup = None
            self._pending_move = None
            self._commit_map()
        else:
            self._names = [str(n) for n in mf["names"]]
            self._bounds = [str(b) for b in mf["bounds"]]
            self._pending_cleanup = mf.get("pending_cleanup")
            self._pending_move = mf.get("pending_move")
        self._stores = [factory(name) for name in self._names]
        self._heat = [
            HeatTracker(half_life_s=heat_half_life_s, clock=clock)
            for _ in self._names
        ]
        # crash recovery, in intent order: an aborted move (intent
        # recorded, bounds never committed) is rolled back by purging
        # the destination of the attempted copies; a committed move
        # missing only its cleanup finishes it
        if self._pending_move:
            self._abort_pending_move()
        if self._pending_cleanup:
            self._run_cleanup()
        self._publish_gauges()

    # ---------------- shard map persistence ----------------
    def _map_path(self) -> str:
        return os.path.join(self.dir, MAP_NAME)

    def _load_map(self) -> Optional[dict]:
        shadow = self._map_path() + SHADOW_SUFFIX
        if os.path.exists(shadow):
            # a torn shadow is never read as authority (the .ctm sweep)
            try:
                os.remove(shadow)
            except OSError:
                pass
        path = self._map_path()
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                mf = json.load(f)
        except (OSError, ValueError):
            raise RuntimeError(f"unreadable shard map {path!r}")
        if (
            not isinstance(mf, dict)
            or mf.get("version") != 1
            or len(mf.get("bounds", [])) != len(mf.get("names", [])) - 1
        ):
            raise RuntimeError(f"malformed shard map {path!r}")
        return mf

    def _commit_map(self) -> None:
        """Shadow-write + fsync + atomic rename: the committed map IS
        shard ownership — a reader never sees a torn or partial map."""
        path = self._map_path()
        shadow = path + SHADOW_SUFFIX
        payload = json.dumps(
            {
                "version": 1,
                "names": self._names,
                "bounds": self._bounds,
                "pending_cleanup": self._pending_cleanup,
                "pending_move": self._pending_move,
            },
            sort_keys=True,
        )
        with open(shadow, "w") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(shadow, path)
        _fsync_dir(self.dir)

    def _publish_gauges(self) -> None:
        META_SHARD_COUNT.set(len(self._stores))

    # ---------------- routing ----------------
    def _index_for_dir(self, d: str) -> int:
        return bisect.bisect_right(self._bounds, d)

    def _shard_for(self, full_path: str):
        d, _name = _split(full_path)
        return self._stores[self._index_for_dir(d)]

    def _indices_for_range(self, lo: str, hi: str) -> range:
        """Shard indices whose directory range can intersect [lo, hi)."""
        first = bisect.bisect_right(self._bounds, lo)
        last = bisect.bisect_left(self._bounds, hi)
        return range(first, last + 1)

    def shard_of(self, full_path: str) -> int:
        """Index of the one shard owning this path (test visibility)."""
        d, _ = _split(full_path)
        return self._index_for_dir(d)

    # ---------------- FilerStore interface ----------------
    def _note_move_dirty(self, d: str, full_path: str) -> None:
        """Record a mutation landing inside an in-flight move's range.
        The copy pass runs without the exclusive lock (so it cannot see
        this write); the mover replays the dirty set under the lock
        before committing the bounds — no write is ever swept by
        cleanup, no delete ever resurrects from a stale copy. Called
        with the read lock held, so the window flags cannot flip
        mid-op."""
        mp = self._move_prep
        if mp is not None and mp[0] <= d < mp[1]:
            with self._lock:
                self._move_dirty.add(full_path)

    def insert_entry(self, entry: Entry) -> None:
        with self._rw.read():
            d, _ = _split(entry.full_path)
            i = self._index_for_dir(d)
            self._heat[i].note_write()
            self.stats["ops"] += 1
            _count_shard_op("insert")
            self._note_move_dirty(d, entry.full_path)
            self._stores[i].insert_entry(entry)

    update_entry = insert_entry

    def insert_many(self, entries: list[Entry]) -> None:
        """Batched upsert (the write-gate seam): group by owning shard
        and hand each shard its whole group in ONE insert_many round —
        a gate flush costs O(shards-touched) store round-trips, not
        O(entries). Dirty-window discipline matches insert_entry: every
        path landing in an in-flight move's range is recorded under the
        same read lock."""
        if not entries:
            return
        with self._rw.read():
            self.stats["ops"] += 1
            _count_shard_op("insert_many")
            by_shard: dict[int, list[Entry]] = {}
            for entry in entries:
                d, _ = _split(entry.full_path)
                i = self._index_for_dir(d)
                self._note_move_dirty(d, entry.full_path)
                by_shard.setdefault(i, []).append(entry)
            for i, group in by_shard.items():
                self._heat[i].note_write(len(group))
                im = getattr(self._stores[i], "insert_many", None)
                if im is not None:
                    im(group)
                else:
                    for entry in group:
                        self._stores[i].insert_entry(entry)

    @property
    def write_rounds(self) -> int:
        """Sum of the sub-stores' write round-trips (see
        MemoryFilerStore.write_rounds) — what the coalescing bench
        counts."""
        return sum(
            getattr(s, "write_rounds", 0) for s in self._stores
        )

    def find_entry(self, full_path: str) -> Optional[Entry]:
        with self._rw.read():
            d, _ = _split(full_path)
            i = self._index_for_dir(d)
            self._heat[i].note_read()
            self.stats["ops"] += 1
            _count_shard_op("find")
            return self._stores[i].find_entry(full_path)

    def delete_entry(self, full_path: str) -> None:
        with self._rw.read():
            d, _ = _split(full_path)
            i = self._index_for_dir(d)
            self._heat[i].note_write()
            self.stats["ops"] += 1
            _count_shard_op("delete")
            self._note_move_dirty(d, full_path)
            self._stores[i].delete_entry(full_path)

    def delete_folder_children(self, full_path: str) -> None:
        """A subtree spans shards: its directories occupy the string
        range [prefix, successor(prefix + "/")) — fan the delete to
        every shard that range can touch (the op is a no-op on shards
        holding none of it)."""
        prefix = full_path.rstrip("/")
        hi = prefix_successor(prefix + "/") or "\U0010ffff"
        with self._rw.read():
            self.stats["ops"] += 1
            _count_shard_op("delete_children")
            mp = self._move_prep
            if mp is not None and mp[0] < hi and prefix < mp[1]:
                # a range op intersecting the moving range: per-path
                # dirty tracking cannot name its victims — mark the
                # whole move dirty so the delta replay recopies exactly
                with self._lock:
                    self._move_dirty_full = True
            for i in self._indices_for_range(prefix, hi):
                self._heat[i].note_write()
                self._stores[i].delete_folder_children(full_path)

    def list_directory_entries(
        self, dir_path: str, start_file_name: str, inclusive: bool, limit: int
    ) -> list[Entry]:
        with self._rw.read():
            d = dir_path.rstrip("/") or "/"
            i = self._index_for_dir(d)
            self._heat[i].note_read()
            self.stats["ops"] += 1
            _count_shard_op("list")
            return self._stores[i].list_directory_entries(
                dir_path, start_file_name, inclusive, limit
            )

    def scan_directory_entries(
        self,
        dir_path: str,
        start_file_name: str,
        inclusive: bool,
        limit: int,
        upper_bound: str = "",
    ) -> list[Entry]:
        """Upper-bound pushdown passthrough: the owning shard's indexed
        range scan when it has one (sqlite), its plain page otherwise."""
        with self._rw.read():
            d = dir_path.rstrip("/") or "/"
            i = self._index_for_dir(d)
            self._heat[i].note_read()
            store = self._stores[i]
            scan = getattr(store, "scan_directory_entries", None)
            if scan is not None:
                return scan(dir_path, start_file_name, inclusive, limit,
                            upper_bound)
            return store.list_directory_entries(
                dir_path, start_file_name, inclusive, limit
            )

    # ---------------- batched lookups (the gate seam) ----------------
    def find_many(self, paths: list[str]) -> dict[str, Entry]:
        """One columnar probe for MANY paths: group by owning shard,
        run the per-shard batches in parallel worker threads (sqlite /
        LSM release the GIL inside the probe), merge. The gate
        (`filer/meta_gate.py`) feeds whole event-loop wakeups of
        concurrent probes through here."""
        if not paths:
            return {}
        with self._rw.read():
            self.stats["batched_lookups"] += len(paths)
            self.stats["batches"] += 1
            _count_shard_op("find_many")
            by_shard: dict[int, list[str]] = {}
            for p in paths:
                d, _ = _split(p)
                by_shard.setdefault(self._index_for_dir(d), []).append(p)
            for i in by_shard:
                self._heat[i].note_read(len(by_shard[i]))
            # thread fan-out only pays once the per-shard batches
            # amortize the dispatch/wakeup cost; a gate-tick-sized batch
            # runs the per-shard probes inline (each is one lock + one
            # C query)
            if len(by_shard) == 1 or len(paths) < _PARALLEL_THRESHOLD:
                out: dict[str, Entry] = {}
                for i, group in by_shard.items():
                    out.update(
                        self._shard_find_many(self._stores[i], group)
                    )
                return out
            pool = self._pool
            if pool is None:
                # double-checked: find_many runs concurrently from many
                # gate executor threads (readers share _rw) — exactly
                # one of them may create the pool
                with self._lock:
                    pool = self._pool
                    if pool is None:
                        pool = self._pool = ThreadPoolExecutor(
                            max_workers=len(self._stores),
                            thread_name_prefix="meta-shard",
                        )
            futs = [
                pool.submit(self._shard_find_many, self._stores[i], group)
                for i, group in by_shard.items()
            ]
            out = {}
            for f in futs:
                out.update(f.result())
            return out

    @staticmethod
    def _shard_find_many(store, paths: list[str]) -> dict[str, Entry]:
        fm = getattr(store, "find_many", None)
        if fm is not None:
            return fm(paths)
        out = {}
        for p in paths:
            e = store.find_entry(p)
            if e is not None:
                out[p] = e
        return out

    # ---------------- heat + rebalance ----------------
    def shard_heats(self, now: Optional[float] = None) -> list[float]:
        return [
            h.read_heat(now) + h.write_heat(now) for h in self._heat
        ]

    def maybe_rebalance(self, now: Optional[float] = None) -> Optional[dict]:
        """Hysteresis gate in front of `rebalance_once`: fire only when
        one shard's decayed heat exceeds `rebalance_factor` x the mean
        AND an absolute floor, and not within the holddown interval of
        the previous move — idle clusters and mild skew never churn
        metadata (the lifecycle planner's anti-flap discipline)."""
        t = self._clock() if now is None else now
        if t - self._last_rebalance < self.rebalance_min_interval_s:
            return None
        heats = self.shard_heats(now)
        hottest = max(range(len(heats)), key=heats.__getitem__)
        mean = sum(heats) / len(heats)
        if heats[hottest] < self.rebalance_min_heat:
            return None
        if heats[hottest] < self.rebalance_factor * max(mean, 1e-9):
            return None
        return self.rebalance_once(hottest, now=now)

    def rebalance_once(
        self, src: Optional[int] = None, now: Optional[float] = None
    ) -> Optional[dict]:
        """Move half of one shard's directories to its cooler adjacent
        neighbor (intent -> purge -> copy -> delta -> commit -> cleanup;
        see module doc for the crash analysis). The exclusive writer
        slot is held only for the intent and the delta+commit — every
        O(range) pass (candidate enumeration, purge, copy, cleanup)
        runs with concurrent ops flowing: routing still points the
        range at its committed owner throughout, and `_move_mutex`
        serializes whole moves against each other. A failed move rolls
        back in place (destination purged, intent cleared) so a retry
        starts clean without waiting for a process restart. Returns a
        move report or None when the shard cannot shed (single
        directory, no neighbor, or another move in flight)."""
        hook = self.step_hook or (lambda step: None)
        if not self._move_mutex.acquire(blocking=False):
            return None  # another move is mid-flight
        try:
            if self._pending_move:
                # a previous in-process attempt failed to roll back
                # (e.g. the abort's own map write failed): finish that
                # rollback before starting a new move, or its strays
                # would be orphaned by our intent overwrite
                self._abort_pending_move()
            if self._pending_cleanup:
                # likewise a cleanup that failed mid-delete: finish it
                # before commit durably overwrites the obligation with
                # our own (idempotent, same as the at-open recovery)
                self._run_cleanup()
            # candidate selection reads bounds + enumerates the shard
            # WITHOUT any topology lock: only moves mutate bounds, and
            # the move mutex is ours
            heats = self.shard_heats(now)
            if src is None:
                src = max(range(len(heats)), key=heats.__getitem__)
            if len(self._stores) < 2:
                return None
            neighbors = [
                j for j in (src - 1, src + 1) if 0 <= j < len(self._stores)
            ]
            dst = min(neighbors, key=heats.__getitem__)
            lo, hi = self._shard_range(src)
            dirs = sorted(
                {d for d, _n, _e in self._iter_store(src, lo, hi)}
            )
            if len(dirs) < 2:
                return None  # a single directory cannot split
            if dst < src:
                # raise the lower bound: dirs below the median move left
                split = dirs[len(dirs) // 2]
                move_lo, move_hi = lo, split
                new_bounds = list(self._bounds)
                new_bounds[dst] = split
            else:
                # lower the upper bound: dirs at/after the median move right
                split = dirs[len(dirs) // 2]
                move_lo, move_hi = split, hi
                new_bounds = list(self._bounds)
                new_bounds[src] = split

            with self._rw.write():
                # (intent) write-ahead record of the move range: a crash
                # anywhere before commit rolls back by purging exactly
                # this range from the destination at the next open — a
                # retry is free to choose a different split
                hook("intent")
                self._pending_move = {
                    "src": src, "dst": dst, "lo": move_lo, "hi": move_hi,
                }
                self._commit_map()
                # open the dirty window before surrendering exclusivity
                self._move_prep = (move_lo, move_hi)
                self._move_dirty = set()
                self._move_dirty_full = False

            try:
                # (purge)+(copy) run WITHOUT the exclusive lock: the
                # committed map still routes the range to the source, so
                # the destination copies stay invisible; concurrent
                # mutators proceed and are delta-recorded
                # (purge) clear stale copies an earlier same-range
                # attempt may have left in the destination — an entry
                # deleted at the source since then must not resurrect
                hook("purge")
                for _d, _n, e in list(
                    self._iter_store(dst, move_lo, move_hi)
                ):
                    self._stores[dst].delete_entry(e.full_path)

                hook("copy")
                moved = 0
                for _d, _n, e in list(
                    self._iter_store(src, move_lo, move_hi)
                ):
                    self._stores[dst].insert_entry(e)
                    moved += 1
                # (delta-point) mutations recorded up to here live only
                # in the source + the dirty set; the replay below is
                # what carries them across
                hook("delta")

                with self._rw.write():
                    try:
                        # (delta) replay what changed during the
                        # unlocked copy: the source is still
                        # authoritative for the range, so re-reading
                        # each dirty path gives the final word
                        if self._move_dirty_full:
                            # a subtree delete crossed the range —
                            # recopy exactly
                            for _d, _n, e in list(
                                self._iter_store(dst, move_lo, move_hi)
                            ):
                                self._stores[dst].delete_entry(e.full_path)
                            moved = 0
                            for _d, _n, e in list(
                                self._iter_store(src, move_lo, move_hi)
                            ):
                                self._stores[dst].insert_entry(e)
                                moved += 1
                        else:
                            for p in self._move_dirty:
                                e = self._stores[src].find_entry(p)
                                if e is None:
                                    self._stores[dst].delete_entry(p)
                                else:
                                    self._stores[dst].insert_entry(e)

                        hook("commit")
                        old_state = (
                            self._bounds,
                            self._pending_move,
                            self._pending_cleanup,
                        )
                        self._bounds = new_bounds
                        self._pending_move = None
                        self._pending_cleanup = {
                            "shard": src, "lo": move_lo, "hi": move_hi,
                        }
                        try:
                            self._commit_map()
                        except BaseException:
                            # the durable map still holds the OLD bounds
                            # + intent: memory must agree, or writes
                            # routed by the new bounds would be purged
                            # as intent strays at the next open
                            (
                                self._bounds,
                                self._pending_move,
                                self._pending_cleanup,
                            ) = old_state
                            raise
                    finally:
                        self._move_prep = None
                        self._move_dirty = set()
                        self._move_dirty_full = False
            except BaseException:
                # roll back IN PLACE (the at-open recovery shape, minus
                # the restart): close the dirty window, purge the
                # attempted copies, clear the intent — a later move
                # with a different split must not inherit strays
                with self._rw.write():
                    self._move_prep = None
                    self._move_dirty = set()
                    self._move_dirty_full = False
                self._abort_pending_move()
                raise

            # (cleanup) runs WITHOUT the exclusive lock too: the
            # committed bounds no longer route the moved range to the
            # source, so live traffic cannot touch what it deletes; the
            # move mutex keeps it ordered before any next move
            hook("cleanup")
            self._run_cleanup()

            # the moved range's heat follows the data (seed, like
            # re-inflation hands EC heat to the fresh volume)
            share = 0.5
            t = self._clock() if now is None else now
            src_r = self._heat[src].read_heat(t)
            src_w = self._heat[src].write_heat(t)
            self._heat[src].seed(src_r * (1 - share), src_w * (1 - share))
            dst_r = self._heat[dst].read_heat(t)
            dst_w = self._heat[dst].write_heat(t)
            self._heat[dst].seed(dst_r + src_r * share,
                                 dst_w + src_w * share)

            self._last_rebalance = t
            self.stats["rebalances"] += 1
            self.stats["moved_entries"] += moved
            META_SHARD_REBALANCES.inc()
            if moved:
                META_SHARD_MOVED.inc(moved)
            return {
                "src": src, "dst": dst, "split": split, "moved": moved,
            }
        finally:
            self._move_mutex.release()

    def _shard_range(self, i: int) -> tuple[str, str]:
        lo = self._bounds[i - 1] if i > 0 else ""
        hi = self._bounds[i] if i < len(self._bounds) else "\U0010ffff"
        return lo, hi

    def _iter_store(self, i: int, lo: str, hi: str):
        """(directory, name, Entry) of shard i with lo <= directory < hi,
        via the store's `iter_all` bulk accessor."""
        for d, name, e in self._stores[i].iter_all():
            if lo <= d < hi:
                yield d, name, e

    def _abort_pending_move(self) -> None:
        """Roll back a move whose bounds were never committed: the
        committed map still routes the range to the source, so any
        copies in the destination are inert duplicates — purge exactly
        the recorded range, then clear the intent (idempotent)."""
        mv = self._pending_move
        if not mv:
            return
        dst = int(mv["dst"])
        lo, hi = str(mv["lo"]), str(mv["hi"])
        own_lo, own_hi = self._shard_range(dst)
        for d, _n, e in list(self._iter_store(dst, lo, hi)):
            if not (own_lo <= d < own_hi):
                self._stores[dst].delete_entry(e.full_path)
        self._pending_move = None
        self._commit_map()

    def _run_cleanup(self) -> None:
        """Finish a committed move: delete the moved range from the old
        owner, then clear the obligation (idempotent — re-run at open
        after a crash)."""
        ob = self._pending_cleanup
        if not ob:
            return
        i = int(ob["shard"])
        lo, hi = str(ob["lo"]), str(ob["hi"])
        own_lo, own_hi = self._shard_range(i)
        for d, _n, e in list(self._iter_store(i, lo, hi)):
            # only sweep what the committed map no longer routes here
            if not (own_lo <= d < own_hi):
                self._stores[i].delete_entry(e.full_path)
        self._pending_cleanup = None
        self._commit_map()

    # ---------------- admin ----------------
    def iter_all(self):
        """Every (directory, name, Entry) across shards — NOT in global
        key order (per-shard order only); callers needing order sort."""
        for i in range(len(self._stores)):
            yield from self._stores[i].iter_all()

    def describe(self) -> dict:
        return {
            "shards": len(self._stores),
            "bounds": list(self._bounds),
            "heats": [round(h, 3) for h in self.shard_heats()],
            "stats": dict(self.stats),
        }

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        for s in self._stores:
            closer = getattr(s, "close", None)
            if closer is not None:
                closer()
