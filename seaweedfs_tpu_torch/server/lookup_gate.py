"""Cross-request micro-batching of needle-index probes.

The reference serves every read with its own CompactMap binary search inside
the request handler (ref: weed/server/volume_server_handlers_read.go:28-39 →
weed/storage/needle_map/compact_map.go:145-172). The device-first shape is
the opposite: concurrent GETs pool their (vid, key) probes, one vectorized
`Volume.bulk_lookup` serves the whole batch — riding the IndexSnapshot
kernel on the card — and each waiting request resumes with its
(offset, size). With an arena, one ragged dispatch (ops/ragged_lookup.py)
answers a whole wakeup across volumes.

Batch formation is adaptive, not timed: the first probe of a batch
schedules the flush with `call_soon`, so the batch is exactly the set of
requests the event loop's current wakeup delivered (one epoll round of
concurrent GETs) and NO artificial latency is ever added — a lone request
flushes immediately. Under sustained load batches grow on their own:
while one bulk_lookup runs, the next wakeup's probes accumulate behind it.

Ported from the JAX package's server/lookup_gate.py with its host,
per-volume device and arena backends. The change: a device failure is
never served around from the host maps. A `probe_groups` that raises (a
failed launch, or a failed refresh it raises again; the arena counts
both) and an identity-check disagreement reach the wakeup's waiters as
their error. The host maps answer only what the arena holds no upload
for (cold, killed) and what the JAX package's policy keeps on the host
(small wakeups, 5-byte offsets, maps without arena segments).
"""

from __future__ import annotations

import asyncio
from typing import Optional

import numpy as np

from ..util import trace

# below this many probes a host searchsorted is a few µs — cheaper to run
# inline on the loop than to round-trip a worker thread
_EXECUTOR_THRESHOLD = 512

# a wakeup smaller than this serves from the host maps even when the
# arena backend is on: a ragged dispatch pays fixed per-dispatch cost
# (pack + upload + program launch), so micro-wakeups are cheaper on the
# host dict path — the same policy Volume.bulk_lookup applies with its
# >=64-key device cut, one level up
_ARENA_MIN_WAKEUP = 128

# hard cap on one batch: the 4097th probe of a wakeup flushes the first
# 4096 at once
_MAX_BATCH = 4096


class IdentityMismatch(RuntimeError):
    """The arena's answers for a volume disagree with its host map."""


class BatchLookupGate:
    """Coalesces concurrent fid probes per event-loop wakeup (hard cap
    _MAX_BATCH), flushing them per-volume through Volume.bulk_lookup.

    use_device: None = Volume.bulk_lookup's own policy (device when attached
    and the batch is worth a dispatch), True/False force it.

    arena: a DeviceColumnArena makes the gate the ragged one-dispatch
    backend: the ENTIRE wakeup — every volume's probes —
    becomes one device dispatch over resident LSM columns, memtable hits
    folded in host-side. A group the arena holds no upload for (cold,
    killed) or that keeps 5-byte offsets is served from the host map and
    counted in host_fallbacks; a group whose dispatch fails gets the
    error. identity_check (tests and smoke runs; off in serving)
    re-answers every probe from the host map and fails the volume's
    waiters with IdentityMismatch on any disagreement, counting it.
    """

    def __init__(
        self,
        store,
        use_device: Optional[bool] = None,
        arena=None,
        identity_check: bool = False,
    ):
        self.store = store
        self.use_device = use_device
        self.arena = arena
        self.identity_check = identity_check
        self._pending: dict = {}  # vid -> list[(key, future)]
        # sampled member trace contexts per vid: the flush records ONE
        # span linked to every member trace, so the amortized probe work
        # is visible from each rider's timeline
        self._pending_traces: dict = {}
        self._count = 0
        self._flush_scheduled = False
        self._loop = None
        # the event loop keeps only weak refs to tasks — hold strong refs
        # so a GC'd batch task can't strand its waiters
        self._tasks: set = set()
        self.stats = {
            "probes": 0,
            "batches": 0,
            "largest_batch": 0,
            "device_batches": 0,
            "device_probes": 0,
            "host_fallbacks": 0,
            "small_wakeups": 0,
            "identity_mismatches": 0,
        }
        # pow2-bucketed flush sizes: the batch-size distribution this
        # gate ACTUALLY produces
        self.batch_hist: dict = {}

    def lookup(self, vid: int, key: int):
        """Awaitable -> (offset_units, size) or None when absent/deleted.

        Returns the batch future directly (no coroutine frame): the caller
        pays one suspension, the flush callback resolves it."""
        loop = self._loop
        if loop is None:
            loop = self._loop = asyncio.get_event_loop()
        fut = loop.create_future()
        self._enqueue(vid, key, fut)
        return fut

    def lookup_cb(self, vid: int, key: int, cb) -> None:
        """Callback form: cb(result, exc) runs INSIDE the flush — the whole
        batch (probe -> pread -> respond, when the caller's cb goes that
        far) completes in one event-loop callback with zero per-request
        task resumes. This is the serving fast path's shape."""
        if self._loop is None:
            self._loop = asyncio.get_event_loop()
        self._enqueue(vid, key, cb)

    def _enqueue(self, vid: int, key: int, sink) -> None:
        items = self._pending.get(vid)
        if items is None:
            items = self._pending[vid] = []
        items.append((key, sink))
        ctx = trace.current_sampled()
        if ctx is not None:
            self._pending_traces.setdefault(vid, []).append(ctx)
        self._count += 1
        if self._count >= _MAX_BATCH:
            self._flush()
        elif not self._flush_scheduled:
            self._flush_scheduled = True
            # same-tick coalescing: the batch is whatever this event-loop
            # wakeup delivered, flushed with zero added latency
            self._loop.call_soon(self._flush)

    def _flush(self) -> None:
        self._flush_scheduled = False
        if not self._count:
            return
        pending, self._pending, count = self._pending, {}, self._count
        self._count = 0
        traces, self._pending_traces = self._pending_traces, {}
        bucket = 1 << max(0, (count - 1).bit_length())
        self.batch_hist[bucket] = self.batch_hist.get(bucket, 0) + 1
        if self.arena is not None and count >= _ARENA_MIN_WAKEUP:
            self._flush_arena(pending, traces, count)
            return
        if self.arena is not None:
            self.stats["small_wakeups"] += 1
        for vid, items in pending.items():
            self.stats["probes"] += len(items)
            self.stats["batches"] += 1
            if len(items) > self.stats["largest_batch"]:
                self.stats["largest_batch"] = len(items)
            members = traces.get(vid)
            if (
                len(items) < _EXECUTOR_THRESHOLD
                and self.use_device is not True
            ):
                # small host batch: one synchronous vectorized probe right
                # here — no task, no executor, waiters resume on the very
                # next loop pass. When any member is sampled, the flush
                # records one linked span (trace.batch_span is a shared
                # no-op otherwise).
                with trace.batch_span(
                    "gate.lookup", members or (), vid=vid, batch=len(items)
                ):
                    self._run_batch_sync(vid, items)
            else:
                t = asyncio.ensure_future(
                    self._run_batch(vid, items, members)
                )
                self._tasks.add(t)
                t.add_done_callback(self._tasks.discard)

    # ---------------- ragged arena backend ----------------
    def _flush_arena(self, pending: dict, traces: dict, count: int) -> None:
        """Route the WHOLE wakeup (all volumes) through one ragged arena
        dispatch. Small wakeups compute inline on the loop; large ones
        move the numpy/device work to an executor and resolve back on
        the loop (futures must not be resolved off-thread)."""
        members = [m for ms in traces.values() for m in ms]
        for vid, items in pending.items():
            self.stats["probes"] += len(items)
            self.stats["batches"] += 1
            if len(items) > self.stats["largest_batch"]:
                self.stats["largest_batch"] = len(items)
        if count < _EXECUTOR_THRESHOLD:
            with trace.batch_span(
                "gate.lookup", members or (), vid=-1, batch=count
            ):
                computed = self._arena_compute(pending)
            self._arena_resolve(pending, computed)
            return

        async def run():
            cm = trace.batch_span(
                "gate.lookup", members or (), vid=-1, batch=count
            )
            cm.__enter__()
            try:
                loop = asyncio.get_event_loop()
                computed = await loop.run_in_executor(
                    None, self._arena_compute, pending
                )
            except Exception as e:
                computed = {vid: e for vid in pending}
            finally:
                cm.__exit__(None, None, None)
            self._arena_resolve(pending, computed)

        t = asyncio.ensure_future(run())
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)

    def _arena_compute(self, pending: dict) -> dict:
        """Pure compute, safe off-loop: vid -> list of per-item results
        (same (offset_units, size) | None contract as the host path) or
        an Exception for that vid. Never resolves sinks."""
        from ..types import TOMBSTONE_FILE_SIZE

        out: dict = {}
        groups = []
        meta = []  # (vid, keys, mem_hits, volume)
        for vid, items in pending.items():
            keys = np.array([k for k, _ in items], dtype=np.uint64)
            try:
                v = self.store.find_volume(vid)
                if v is None:
                    raise LookupError(f"volume {vid} not found")
                view = getattr(v.nm, "arena_view", None)
                if view is None:
                    out[vid] = self._host_results(v, keys)
                    self._note_fallback("no_arena_view")
                    continue
                mem_hits, segments = view(keys)
                if segments is None:
                    out[vid] = self._host_results(v, keys)
                    self._note_fallback("oversize_offsets")
                    continue
                groups.append((segments, keys))
                meta.append((vid, keys, mem_hits, v))
            except Exception as e:
                out[vid] = e
        answers = []
        if groups:
            try:
                answers = self.arena.probe_groups(groups)
            except Exception as e:
                # the arena has counted it; these waiters get the error,
                # never a host answer in place of the device's
                for vid, *_rest in meta:
                    out[vid] = e
                return out
        for (vid, keys, mem_hits, v), res in zip(meta, answers):
            try:
                if res is None:
                    out[vid] = self._host_results(v, keys)
                    self._note_fallback("arena_cold")
                    continue
                found, offs, sizes = res["found"], res["off"], res["size"]
                results = []
                for i, k in enumerate(keys.tolist()):
                    hit = mem_hits.get(k)
                    if hit is None and found[i]:
                        hit = (int(offs[i]), int(sizes[i]))
                    results.append(
                        hit
                        if hit is not None
                        and hit[0] != 0
                        and hit[1] != TOMBSTONE_FILE_SIZE
                        else None
                    )
                self.stats["device_batches"] += 1
                self.stats["device_probes"] += len(keys)
                if self.identity_check:
                    results = self._identity_check(v, keys, results)
                out[vid] = results
            except Exception as e:
                out[vid] = e
        return out

    def _host_results(self, v, keys: np.ndarray) -> list:
        from ..types import TOMBSTONE_FILE_SIZE

        get = v.nm.get
        results = []
        for k in keys.tolist():
            nv = get(int(k))
            results.append(
                (nv.offset_units, nv.size)
                if nv is not None
                and nv.offset_units != 0
                and nv.size != TOMBSTONE_FILE_SIZE
                else None
            )
        return results

    def _note_fallback(self, reason: str) -> None:
        from ..util.metrics import NEEDLE_MAP_DEVICE_FALLBACKS

        self.stats["host_fallbacks"] += 1
        NEEDLE_MAP_DEVICE_FALLBACKS.inc(reason=reason)

    def _identity_check(self, v, keys: np.ndarray, results: list) -> list:
        """Test/smoke-mode check: every device answer re-derived from the
        host map. A disagreement is counted and raised, so the volume's
        waiters get IdentityMismatch instead of either answer."""
        host = self._host_results(v, keys)
        if host == results:
            return results
        from ..util.metrics import NEEDLE_MAP_DEVICE_IDENTITY_MISMATCH

        bad = sum(1 for a, b in zip(host, results) if a != b)
        self.stats["identity_mismatches"] += bad
        NEEDLE_MAP_DEVICE_IDENTITY_MISMATCH.inc(bad)
        raise IdentityMismatch(
            f"{bad} of {len(keys)} arena answers differ from the host map"
        )

    def _arena_resolve(self, pending: dict, computed: dict) -> None:
        for vid, items in pending.items():
            got = computed.get(
                vid, LookupError(f"volume {vid} not found")
            )
            if isinstance(got, Exception):
                for _k, sink in items:
                    self._resolve(sink, None, got)
            else:
                for (_k, sink), result in zip(items, got):
                    self._resolve(sink, result, None)

    @staticmethod
    def _resolve(sink, result, exc) -> None:
        """A sink is either a lookup() future or a lookup_cb() callable."""
        if callable(sink):
            try:
                sink(result, exc)
            except Exception:
                pass
        elif not sink.done():
            if exc is not None:
                sink.set_exception(exc)
            else:
                sink.set_result(result)

    def _run_batch_sync(self, vid: int, items: list) -> None:
        # `done` tracks how many sinks are already resolved so a mid-batch
        # exception never re-resolves them — callback sinks (DETACHED
        # continuations that write straight to sockets) must fire at most
        # once
        done = 0
        try:
            v = self.store.find_volume(vid)
            if v is None:
                raise LookupError(f"volume {vid} not found")
            if len(items) < 64:
                # numpy array assembly costs more than it buys at this
                # size — probe the hot map directly (same records the
                # vectorized path reads)
                from ..types import TOMBSTONE_FILE_SIZE

                get = v.nm.get
                for k, sink in items:
                    nv = get(int(k))
                    result = (
                        (nv.offset_units, nv.size)
                        if nv is not None
                        and nv.offset_units != 0
                        and nv.size != TOMBSTONE_FILE_SIZE
                        else None
                    )
                    done += 1
                    self._resolve(sink, result, None)
                return
            keys = np.array([k for k, _ in items], dtype=np.uint64)
            offsets, sizes, found = v.bulk_lookup(keys, False)
            for i, (_k, sink) in enumerate(items):
                result = (
                    (int(offsets[i]), int(sizes[i])) if found[i] else None
                )
                done += 1
                self._resolve(sink, result, None)
        except Exception as e:
            for _k, sink in items[done:]:
                self._resolve(sink, None, e)

    async def _run_batch(
        self, vid: int, items: list, members=None
    ) -> None:
        done = 0
        cm = trace.batch_span(
            "gate.lookup", members or (), vid=vid, batch=len(items)
        )
        cm.__enter__()
        try:
            v = self.store.find_volume(vid)
            if v is None:
                raise LookupError(f"volume {vid} not found")
            keys = np.array([k for k, _ in items], dtype=np.uint64)
            loop = asyncio.get_event_loop()
            offsets, sizes, found = await loop.run_in_executor(
                None, v.bulk_lookup, keys, self.use_device
            )
            for i, (_k, sink) in enumerate(items):
                result = (
                    (int(offsets[i]), int(sizes[i])) if found[i] else None
                )
                done += 1
                self._resolve(sink, result, None)
        except Exception as e:
            # surface the original error to every still-unresolved waiter
            # (a LookupError maps to 404 in the handler; anything else
            # becomes a 500 there); already-resolved sinks must not re-fire
            for _k, sink in items[done:]:
                self._resolve(sink, None, e)
        finally:
            cm.__exit__(None, None, None)

    def close(self) -> None:
        self._flush_scheduled = False
        for _vid, items in self._pending.items():
            for _k, sink in items:
                self._resolve(sink, None, LookupError("gate closed"))
        self._pending = {}
        self._pending_traces = {}
        self._count = 0
        # in-flight batch tasks are left to finish (they're short and their
        # waiters are still listening); cancelling them would strand those
        # futures with a CancelledError that never propagates
