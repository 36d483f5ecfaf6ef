"""Cross-request micro-batching of filer metadata probes.

The `BatchLookupGate` pattern (`server/lookup_gate.py`) applied one
layer up: concurrent filer requests each pay a per-request
`find_entry` — a store lock acquisition, a B-tree/segment probe, an
Entry decode — even when one event-loop wakeup delivered dozens of
them. `MetaLookupGate` pools the paths of one wakeup and flushes them
as ONE columnar `find_many` against the store (which groups by shard
and probes shards in parallel when the store is a
`ShardedFilerStore`), so concurrent metadata probes become batched
data-parallel work instead of per-request dict chasing — the same
batched-ragged formulation as Ragged Paged Attention (arxiv
2604.15464): requests contribute ragged path lists (a GET contributes
one path, an `_ensure_parents` chain contributes its whole ancestor
spine), the flush flattens them into one dense batch, and each caller
gets its slice back.

Batch formation is adaptive, not timed (the lookup gate's measured
lesson): the first probe of a tick schedules the flush with
`call_soon`, so a lone request flushes immediately with zero added
latency and batches grow on their own under load. Duplicate paths in a
flush are single-flighted — N concurrent probes of one hot path cost
one store hit.

Ported from the JAX package's filer/meta_gate.py, on the port's
DeviceColumnArena (ops/ragged_lookup.py), whose dispatch is the kernel K2
for an arena on the card and its plain version for one on the CPU. The
change, as in the port's server/lookup_gate.py: a device failure is never
served around from the host store. A `probe_groups` that raises (a failed
launch, or a failed refresh or flush-path prefetch it raises again) and
an identity-check disagreement (`IdentityMismatch`, counted) reach the
flush's waiters as their error. The host store answers only what the JAX
policy keeps on the host, each counted by reason: a cold or killed arena
(`ensure` gives None: `host_fallbacks`, reason `arena_cold`), a store
without `arena_view` (`host_fallbacks`, reason `no_arena_view`), memtable
hits and tombstones (`memtable_hits`, per path), and the per-path
re-probe after a hash collision or a segment compacted away underneath
(`collision_reprobes`).
"""

from __future__ import annotations

import asyncio
import contextlib
import os
from typing import Optional

from ..server.lookup_gate import IdentityMismatch

# below this many distinct paths the inline find_many is a few µs —
# cheaper than a worker-thread round trip
_EXECUTOR_THRESHOLD = 64


class MetaLookupGate:
    """Coalesces concurrent path probes per event-loop wakeup and
    flushes them through `store.find_many` (falling back to per-path
    `find_entry` on stores without the batched seam).

    arena: a DeviceColumnArena routes each flush's distinct paths —
    hashed to u64 via `lsm_store.path_hash64` — through ONE ragged
    device dispatch over the store's resident segment hash columns
    (the filer's path-spine leg); values decode host-side with a
    collision/compaction verify. A cold or killed arena and a store
    without `arena_view` serve the host `find_many` (counted in
    host_fallbacks by reason); a dispatch that raises fails the flush's
    waiters. identity_check (default: env SEAWEEDFS_TPU_ARENA_IDENTITY,
    on) re-answers from the host, under the store's lock held across
    both answers, and fails the flush's waiters with IdentityMismatch on
    any disagreement, counting the paths."""

    def __init__(
        self,
        store,
        max_batch: int = 4096,
        arena=None,
        identity_check: Optional[bool] = None,
    ):
        self.store = store
        self.max_batch = max_batch
        self.arena = arena
        if identity_check is None:
            identity_check = (
                os.environ.get("SEAWEEDFS_TPU_ARENA_IDENTITY", "1") != "0"
            )
        self.identity_check = identity_check
        self._pending: list[tuple] = []  # (paths tuple, future)
        self._count = 0
        self._flush_scheduled = False
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._tasks: set = set()
        self.stats = {
            "probes": 0,
            "batches": 0,
            "largest_batch": 0,
            "dedup_hits": 0,
            "chains": 0,
            "device_batches": 0,
            "host_fallbacks": 0,
            "identity_mismatches": 0,
            "memtable_hits": 0,
            "collision_reprobes": 0,
        }
        # host_fallbacks by reason (arena_cold, no_arena_view)
        self.fallback_reasons: dict = {}

    def lookup(self, path: str):
        """Awaitable -> Entry | None."""
        fut = self._enqueue((path,))
        return _first(fut)

    def lookup_many(self, paths: list[str]):
        """Ragged batch: one caller's whole path list (an
        `_ensure_parents` ancestor spine, a multi-component resolve)
        rides the flush as one contribution. Awaitable ->
        [Entry | None] aligned with `paths`."""
        self.stats["chains"] += 1
        return self._enqueue(tuple(paths))

    def _enqueue(self, paths: tuple):
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = asyncio.get_event_loop()
        if self._loop is not loop:
            # a different (fresh) event loop: the server was restarted /
            # the gate is being reused (tests, embedded). Rebind cleanly
            # instead of scheduling call_soon on a closed loop forever;
            # futures parked on the previous loop are failed best-effort
            # (usually their awaiters died with that loop, but if it is
            # somehow still alive they must not hang)
            stale, self._pending = self._pending, []
            for _p, fut in stale:
                try:
                    if not fut.done():
                        fut.set_exception(
                            LookupError("meta gate rebound to a new loop")
                        )
                except RuntimeError:
                    pass  # future's loop already closed
            self._count = 0
            self._flush_scheduled = False
            self._loop = loop
        fut = loop.create_future()
        self._pending.append((paths, fut))
        self._count += len(paths)
        if self._count >= self.max_batch:
            self._flush()
        elif not self._flush_scheduled:
            self._flush_scheduled = True
            loop.call_soon(self._flush)
        return fut

    def _flush(self) -> None:
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None  # direct synchronous flush (no loop running)
        if running is not None and running is not self._loop:
            # a flush scheduled on a since-replaced loop must not touch
            # (and resolve cross-thread) the NEW loop's pending futures
            return
        self._flush_scheduled = False
        if not self._pending:
            return
        pending, self._pending, self._count = self._pending, [], 0
        distinct: list[str] = []
        seen: set = set()
        total = 0
        for paths, _fut in pending:
            for p in paths:
                total += 1
                if p not in seen:
                    seen.add(p)
                    distinct.append(p)
        self.stats["probes"] += total
        self.stats["batches"] += 1
        self.stats["dedup_hits"] += total - len(distinct)
        if total > self.stats["largest_batch"]:
            self.stats["largest_batch"] = total
        if len(distinct) < _EXECUTOR_THRESHOLD:
            try:
                found = self._find_many(distinct)
            except Exception as e:
                self._resolve_all(pending, None, e)
                return
            self._resolve_all(pending, found, None)
        else:
            t = asyncio.ensure_future(self._run_batch(pending, distinct))
            self._tasks.add(t)
            t.add_done_callback(self._tasks.discard)

    async def _run_batch(self, pending: list, distinct: list[str]) -> None:
        loop = asyncio.get_event_loop()
        try:
            # worker thread: the sharded store fans sub-batches across
            # shards there (sqlite/LSM release the GIL in the probe), and
            # the event loop keeps serving while the batch runs
            found = await loop.run_in_executor(
                None, self._find_many, distinct
            )
        except Exception as e:
            self._resolve_all(pending, None, e)
            return
        self._resolve_all(pending, found, None)

    def _find_many(self, distinct: list[str]) -> dict:
        if self.arena is not None and distinct:
            # with the identity check, the device answer and the host
            # re-read must see one store state: a write landing between
            # them (an executor-thread insert_many, a delete on the loop
            # thread) is not a disagreement. The LSM store's lock is
            # re-entrant, so its view, decode and find_many take it again.
            lock = (
                getattr(self.store, "_lock", None)
                if self.identity_check else None
            )
            with lock if lock is not None else contextlib.nullcontext():
                found = self._find_many_arena(distinct)
                if found is not None:
                    if self.identity_check:
                        self._check_identity(distinct, found)
                    return found
        return self._find_many_host(distinct)

    def _check_identity(self, distinct: list[str], found: dict) -> None:
        host = self._find_many_host(distinct)
        if host == found:
            return
        bad = [p for p in distinct if host.get(p) != found.get(p)]
        self.stats["identity_mismatches"] += len(bad)
        from ..util.metrics import NEEDLE_MAP_DEVICE_IDENTITY_MISMATCH

        NEEDLE_MAP_DEVICE_IDENTITY_MISMATCH.inc(len(bad))
        raise IdentityMismatch(
            f"the arena's answers for {len(bad)} of {len(distinct)} paths "
            f"disagree with the store (first {bad[0]!r})"
        )

    def _find_many_host(self, distinct: list[str]) -> dict:
        fm = getattr(self.store, "find_many", None)
        if fm is not None:
            return fm(distinct)
        out = {}
        for p in distinct:
            e = self.store.find_entry(p)
            if e is not None:
                out[p] = e
        return out

    def _find_many_arena(self, distinct: list[str]):
        """One ragged device dispatch for the whole flush; None means
        'host-serve this flush' (a cold or killed arena, a store without
        arena_view). An error of the dispatch propagates."""
        view = getattr(self.store, "arena_view", None)
        decode = getattr(self.store, "arena_decode", None)
        if view is None or decode is None:
            self._note_fallback("no_arena_view")
            return None
        import numpy as np

        from .entry import Entry
        from .filer_store import _split
        from .lsm_store import path_hash64

        mem_hits, segments = view(distinct)
        if segments is None:
            self._note_fallback("no_segments")
            return None
        keys = np.fromiter(
            (path_hash64(*_split(p)) for p in distinct),
            dtype=np.uint64,
            count=len(distinct),
        )
        res = self.arena.probe_groups([(segments, keys)])[0]
        if res is None:
            self._note_fallback("arena_cold")
            return None
        out: dict = {}
        for i, p in enumerate(distinct):
            if p in mem_hits:
                v = mem_hits[p]  # includes tombstones (None)
                self.stats["memtable_hits"] += 1
            elif res["found"][i]:
                ok, v = decode(
                    segments[int(res["rank"][i])],
                    int(res["off"][i]),
                    p,
                )
                if not ok:
                    # hash collision or segment compacted underneath:
                    # authoritative host re-probe for this one path
                    self.stats["collision_reprobes"] += 1
                    e = self.store.find_entry(p)
                    if e is not None:
                        out[p] = e
                    continue
            else:
                continue  # absent on device == absent (no false negatives)
            if v is not None:
                out[p] = Entry.from_dict(v)
        self.stats["device_batches"] += 1
        return out

    def _note_fallback(self, reason: str) -> None:
        from ..util.metrics import NEEDLE_MAP_DEVICE_FALLBACKS

        self.stats["host_fallbacks"] += 1
        self.fallback_reasons[reason] = self.fallback_reasons.get(reason, 0) + 1
        NEEDLE_MAP_DEVICE_FALLBACKS.inc(reason=reason)

    @staticmethod
    def _resolve_all(pending: list, found, exc) -> None:
        for paths, fut in pending:
            if fut.done():
                continue
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result([found.get(p) for p in paths])

    def close(self) -> None:
        for _paths, fut in self._pending:
            try:
                if not fut.done():
                    fut.set_exception(LookupError("meta gate closed"))
            except RuntimeError:
                pass  # future parked on an already-closed loop
        self._pending = []
        self._count = 0
        self._loop = None


class MetaWriteGate:
    """`MetaLookupGate`'s same-tick coalescing applied to the WRITE
    side: concurrent entry upserts of one event-loop wakeup
    pool into ONE `store.insert_many` round — a burst of S3 PUTs costs
    O(wakeups) store round-trips (lock acquisitions, sqlite commits,
    WAL fsyncs) instead of O(objects).

    Batch formation starts like the lookup gate's (first enqueue of a
    tick schedules the flush with `call_soon`, so a lone write flushes
    immediately with zero added latency) and adds an ADAPTIVE
    group-commit linger: when a flush coalesced more than one
    concurrent contribution — the signature of a burst, where gRPC
    delivers roughly one request per loop tick and same-tick
    coalescing alone would degrade to batches of ~1 — the NEXT flush
    is scheduled with `call_later(linger_s)` so in-flight arrivals
    accumulate into one store round (classic WAL group commit).
    Single-caller traffic never sees the linger (a one-contribution
    flush drops straight back to `call_soon`), so the added latency is
    paid exactly when it buys round-trip amortization. Within a flush
    the LAST write to a path wins (same-tick create-then-update
    collapses to its final state) while first-enqueue ORDER is kept,
    so a contribution's parent-spine entries stay ahead of its leaf.

    Per-item error isolation (the ChunkUploadGate discipline): when the
    batched round fails, every contribution retries alone through
    per-entry `insert_entry` — one bad entry fails only its own caller,
    never the whole flush (counted in stats["item_retries"])."""

    def __init__(
        self,
        store,
        max_batch: int = 4096,
        linger_s: Optional[float] = None,
    ):
        self.store = store
        self.max_batch = max_batch
        if linger_s is None:
            linger_s = float(
                os.environ.get(
                    "SEAWEEDFS_TPU_META_WRITE_GATE_LINGER_MS", "5"
                )
            ) / 1000.0
        self.linger_s = linger_s
        self._pending: list[tuple] = []  # (entries tuple, future)
        self._count = 0
        self._flush_scheduled = False
        # contributions in the last flush: >1 means concurrent callers
        # are in flight, so the next flush lingers to group-commit them
        self._last_contribs = 0
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._tasks: set = set()
        self.stats = {
            "writes": 0,
            "batches": 0,
            "largest_batch": 0,
            "coalesced": 0,
            "item_retries": 0,
            "lingered_batches": 0,
        }

    def insert(self, entry):
        """Awaitable -> None once the entry is durably in the store."""
        return self._enqueue((entry,))

    def insert_many(self, entries: list):
        """One caller's ordered entry group (an `_ensure_parents` spine
        + its leaf, a rename's subtree page) rides the flush as one
        contribution. Awaitable -> None."""
        return self._enqueue(tuple(entries))

    def _enqueue(self, entries: tuple):
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = asyncio.get_event_loop()
        if self._loop is not loop:
            # fresh event loop (restart / embedded reuse): rebind, fail
            # futures parked on the replaced loop best-effort — see
            # MetaLookupGate._enqueue
            stale, self._pending = self._pending, []
            for _e, fut in stale:
                try:
                    if not fut.done():
                        fut.set_exception(
                            LookupError("meta gate rebound to a new loop")
                        )
                except RuntimeError:
                    pass
            self._count = 0
            self._flush_scheduled = False
            self._last_contribs = 0
            self._loop = loop
        fut = loop.create_future()
        self._pending.append((entries, fut))
        self._count += len(entries)
        if self._count >= self.max_batch:
            self._flush()
        elif not self._flush_scheduled:
            self._flush_scheduled = True
            if self.linger_s > 0.0 and self._last_contribs > 1:
                self.stats["lingered_batches"] += 1
                loop.call_later(self.linger_s, self._flush)
            else:
                loop.call_soon(self._flush)
        return fut

    def _flush(self) -> None:
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is not None and running is not self._loop:
            return  # flush scheduled on a since-replaced loop
        self._flush_scheduled = False
        if not self._pending:
            return
        pending, self._pending, self._count = self._pending, [], 0
        self._last_contribs = len(pending)
        # last-write-wins per path, first-enqueue order kept (parents
        # enqueue ahead of their leaf within a contribution)
        merged: dict = {}
        total = 0
        for entries, _fut in pending:
            for e in entries:
                total += 1
                merged[e.full_path] = e
        batch = list(merged.values())
        self.stats["writes"] += total
        self.stats["batches"] += 1
        self.stats["coalesced"] += total - len(batch)
        if total > self.stats["largest_batch"]:
            self.stats["largest_batch"] = total
        from ..util.metrics import (
            META_WRITE_GATE_BATCHES,
            META_WRITE_GATE_WRITES,
        )

        META_WRITE_GATE_BATCHES.inc()
        META_WRITE_GATE_WRITES.inc(total)
        if len(batch) < _EXECUTOR_THRESHOLD:
            errs = self._apply(pending, batch)
            self._resolve(pending, errs)
        else:
            t = asyncio.ensure_future(self._run_batch(pending, batch))
            self._tasks.add(t)
            t.add_done_callback(self._tasks.discard)

    async def _run_batch(self, pending: list, batch: list) -> None:
        loop = asyncio.get_event_loop()
        # worker thread: the batched round fsyncs / commits — the event
        # loop keeps serving while durability happens off-loop; futures
        # resolve back here, on their own loop
        errs = await loop.run_in_executor(None, self._apply, pending, batch)
        self._resolve(pending, errs)

    def _apply(self, pending: list, batch: list):
        """Store rounds only (loop-thread or executor safe). Returns
        None on batched success, else per-contribution exceptions (None
        where the per-item retry succeeded)."""
        try:
            im = getattr(self.store, "insert_many", None)
            if im is not None:
                im(batch)
            else:
                for e in batch:
                    self.store.insert_entry(e)
            return None
        except Exception:
            # isolate: the batch round failed as a unit — retry every
            # contribution alone so one poisoned entry fails only its
            # own caller
            errs = []
            for entries, _fut in pending:
                exc = None
                for e in entries:
                    self.stats["item_retries"] += 1
                    try:
                        self.store.insert_entry(e)
                    except Exception as item_exc:
                        exc = item_exc
                errs.append(exc)
            return errs

    @staticmethod
    def _resolve(pending: list, errs) -> None:
        for i, (_entries, fut) in enumerate(pending):
            if fut.done():
                continue
            exc = errs[i] if errs is not None else None
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(None)

    def close(self) -> None:
        for _entries, fut in self._pending:
            try:
                if not fut.done():
                    fut.set_exception(LookupError("meta gate closed"))
            except RuntimeError:
                pass
        self._pending = []
        self._count = 0
        self._last_contribs = 0
        self._loop = None


async def _first(fut):
    return (await fut)[0]
