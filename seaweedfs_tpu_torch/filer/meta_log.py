"""Filer metadata change log + subscriptions.

Host-side equivalent of the reference's in-memory meta log
(ref: weed/util/log_buffer/log_buffer.go, weed/filer2/filer_notify.go,
served by the filer's SubscribeMetadata stream, filer.proto:49-53):
every namespace mutation appends an event; subscribers replay from a
starting timestamp and then follow live, filtered by path prefix.

The buffer is a bounded ring — subscribers that fall further behind than
the ring capacity miss events (the reference's LogBuffer similarly only
keeps a time window in memory; durable history rides the notification
sinks / filer log files, not this buffer).

Ported whole from the JAX package's filer/meta_log.py. The durable log's
`seg-*.mlog` streams are written and scanned through the port's
util/mpack.py (its streaming `Unpacker` keeps a torn tail's valid prefix
as msgpack's does), so a meta-log directory either package wrote opens in
the other.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import AsyncIterator, Optional

from ..util import mpack


class MetaLogTrimmed(RuntimeError):
    """Events in (since_ns, trimmed_through] can never be delivered —
    either the subscriber's resume cursor is older than retention, or a
    sealed segment in that range is unreadable (corruption). Raised
    instead of silently resuming past the hole; the subscriber decides
    (rebuild its derived state, re-anchor past `trimmed_through`,
    alert)."""

    def __init__(self, since_ns: int, trimmed_through: int):
        super().__init__(
            f"meta-log history unavailable through {trimmed_through}; "
            f"cannot resume exactly from {since_ns}"
        )
        self.since_ns = since_ns
        self.trimmed_through = trimmed_through


class MetaLogEvent:
    __slots__ = ("ts_ns", "directory", "event_type", "old_entry", "new_entry")

    def __init__(self, ts_ns, directory, event_type, old_entry, new_entry):
        self.ts_ns = ts_ns
        self.directory = directory
        self.event_type = event_type
        self.old_entry = old_entry  # dict | None
        self.new_entry = new_entry  # dict | None

    def to_dict(self) -> dict:
        return {
            "ts_ns": self.ts_ns,
            "directory": self.directory,
            "event_notification": {
                "event_type": self.event_type,
                "old_entry": self.old_entry,
                "new_entry": self.new_entry,
            },
        }


class MetaLog:
    def __init__(self, capacity: int = 10000):
        # ts-ordered parallel lists; bisect on _ts makes read_since
        # O(log n + matches) instead of a full scan per subscriber poll
        self._events: list[MetaLogEvent] = []
        self._ts: list[int] = []
        self._capacity = capacity
        self._lock = threading.Lock()
        self._last_ts_ns = 0

    @property
    def last_ts_ns(self) -> int:
        return self._last_ts_ns

    def append(
        self,
        directory: str,
        event_type: str,
        old_entry: Optional[dict],
        new_entry: Optional[dict],
    ) -> MetaLogEvent:
        with self._lock:
            # strictly monotonic so since_ns resumption never duplicates
            ts = max(time.time_ns(), self._last_ts_ns + 1)
            self._last_ts_ns = ts
            ev = MetaLogEvent(ts, directory, event_type, old_entry, new_entry)
            self._events.append(ev)
            self._ts.append(ts)
            if len(self._events) > self._capacity * 2:
                del self._events[: -self._capacity]
                del self._ts[: -self._capacity]
            return ev

    def read_since(
        self, since_ns: int, path_prefix: str = "/"
    ) -> list[MetaLogEvent]:
        return self.read_since_with_watermark(since_ns, path_prefix)[0]

    def read_since_with_watermark(
        self, since_ns: int, path_prefix: str = "/"
    ) -> tuple[list[MetaLogEvent], int]:
        """-> (matching events, ts scanned through). The watermark is taken
        under the same lock as the slice, so resuming from it never skips
        events appended concurrently."""
        with self._lock:
            lo = bisect.bisect_right(self._ts, since_ns)
            tail = self._events[max(lo, len(self._events) - self._capacity):]
            watermark = self._last_ts_ns
        return [ev for ev in tail if _match_prefix(ev, path_prefix)], watermark

    async def subscribe(
        self,
        since_ns: int = 0,
        path_prefix: str = "/",
        poll_interval: float = 0.05,
        stopped=None,
    ) -> AsyncIterator[MetaLogEvent]:
        """Replay history after since_ns, then follow live
        (ref filer_grpc_server_sub_meta.go SubscribeMetadata loop)."""
        import asyncio

        cursor = since_ns
        while stopped is None or not stopped():
            # O(1) idle check: nothing appended since our cursor
            if self._last_ts_ns <= cursor:
                await asyncio.sleep(poll_interval)
                continue
            batch, watermark = self.read_since_with_watermark(
                cursor, path_prefix
            )
            cursor = max(cursor, watermark)
            for ev in batch:
                yield ev
            if not batch:
                await asyncio.sleep(poll_interval)


class DurableMetaLog(MetaLog):
    """MetaLog promoted from a bounded in-memory ring to a segmented
    on-disk log with resumable per-subscriber cursors.

    Layout: a directory of ``seg-<seq>.mlog`` files (msgpack record
    stream, `segment_events` records each), plus ``cursors.json``
    holding per-subscriber resume timestamps (shadow-write + atomic
    rename, the shard-map discipline). Appends go to disk FIRST (write
    + flush; fsync behind ``SEAWEEDFS_TPU_META_FEED_FSYNC`` — the
    store, not the feed, is the namespace durability authority), then
    into the inherited in-memory ring, which stays the fast tail for
    caught-up subscribers; a subscriber that fell behind the ring —
    or resumes in a fresh process — replays from the segments with the
    SAME exact-resumption guarantee the ring gives (strictly monotonic
    ts, watermark taken at the scan frontier), in bounded chunks.

    Retention is ``max_segments`` sealed segments; trimming records
    ``trimmed_through``, and a read whose resume cursor falls below it
    raises :class:`MetaLogTrimmed` — a subscriber older than retention
    is an ERROR, never silently incomplete (cursor 0 is exempt: it is
    the explicit "replay whatever history is retained" request of a
    fresh subscriber, not a resume point). Torn tails (crash mid-
    append) are truncated at open — a partial record can never be
    replayed as an event.
    """

    def __init__(
        self,
        directory: str,
        capacity: int = 10000,
        segment_events: int = 4096,
        max_segments: int = 64,
        fsync: Optional[bool] = None,
    ):
        import os

        super().__init__(capacity=capacity)
        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        self.segment_events = max(16, segment_events)
        self.max_segments = max(2, max_segments)
        if fsync is None:
            fsync = (
                os.environ.get("SEAWEEDFS_TPU_META_FEED_FSYNC", "0") or "0"
            ) != "0"
        self.fsync = fsync
        self.trimmed_through = 0  # ts through which history was dropped
        # cursors are independent of ring/segment state: their own lock
        # keeps the synchronous cursors.json rewrite in cursor_ack from
        # blocking every append (= every namespace mutation) behind
        # file-system I/O
        self._cursor_lock = threading.Lock()
        self._cursors: Optional[dict] = None
        # events at ts <= _mem_floor may be missing from the in-memory
        # ring — reads from at/below it go to the segments
        self._segments: list[dict] = []  # {seq, path, first, last, count}
        self._scan_segments()
        self._mem_floor = self._last_ts_ns
        if self._segments:
            active = self._segments[-1]
            self._active_f = open(active["path"], "ab")
        else:
            self._open_segment(1)
        self._publish_segment_gauge()

    # ---------------- segment plumbing ----------------
    def _seg_path(self, seq: int) -> str:
        import os

        return os.path.join(self.dir, f"seg-{seq}.mlog")

    def _scan_segments(self) -> None:
        import os

        seqs = sorted(
            int(fn[4:-5])
            for fn in os.listdir(self.dir)
            if fn.startswith("seg-") and fn.endswith(".mlog")
        )
        # the trim frontier survives restarts: the TRIM marker (written
        # at each trim) is exact; without one, a seq gap at the FRONT
        # still proves retention trimmed history in a previous process
        # life (sealed segments are never empty, so only trimming
        # removes the oldest) and we reconstruct an upper bound
        marker = self._load_trim_marker()
        if marker is not None:
            self.trimmed_through = marker
        elif seqs and seqs[0] > 1:
            self.trimmed_through = -1  # fixed up after the scan below
        last_ts = 0
        for seq in seqs:
            path = self._seg_path(seq)
            first, last, count, good = self._scan_one(path)
            if count == 0 and seq != seqs[-1]:
                # empty mid-stack segment: drop it
                try:
                    os.remove(path)
                except OSError:
                    pass
                continue
            # torn tail (crash mid-append): truncate to the valid prefix
            if good < os.path.getsize(path):
                with open(path, "ab") as f:
                    f.truncate(good)
            self._segments.append(
                {"seq": seq, "path": path, "first": first, "last": last,
                 "count": count}
            )
            last_ts = max(last_ts, last)
        self._last_ts_ns = last_ts
        if self.trimmed_through < 0:
            # no marker (legacy dir, or the marker file was removed):
            # bound the gap by the first retained event. This may
            # over-claim by up to one inter-segment gap (a cursor
            # between the true trim frontier and first_ts-1 raises
            # spuriously — recovery is a harmless cache drop / resume,
            # never data loss). With nothing retained at all there is
            # no bound: degrade to 0 (fresh-log behavior) rather than
            # a sentinel no follower could ever resume past.
            first_ts = next(
                (s["first"] for s in self._segments if s["count"]), 0
            )
            self.trimmed_through = max(0, first_ts - 1)

    @staticmethod
    def _scan_one(path: str) -> tuple[int, int, int, int]:
        """-> (first_ts, last_ts, count, good_bytes)."""
        first = last = count = 0
        good = 0
        with open(path, "rb") as f:
            unpacker = mpack.Unpacker(f)
            while True:
                try:
                    rec = unpacker.unpack()
                except mpack.OutOfData:
                    break
                except Exception:
                    break  # torn/garbage tail: keep the valid prefix
                if not isinstance(rec, dict) or "t" not in rec:
                    break
                ts = int(rec["t"])
                if count == 0:
                    first = ts
                last = ts
                count += 1
                good = unpacker.tell()  # bytes consumed by valid records
        return first, last, count, good

    def _open_segment(self, seq: int) -> None:
        self._segments.append(
            {"seq": seq, "path": self._seg_path(seq), "first": 0,
             "last": 0, "count": 0}
        )
        self._active_f = open(self._seg_path(seq), "ab")

    def _trim_marker_path(self) -> str:
        import os

        return os.path.join(self.dir, "TRIM")

    def _load_trim_marker(self) -> Optional[int]:
        import json

        try:
            with open(self._trim_marker_path()) as f:
                return int(json.load(f)["trimmed_through"])
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def _save_trim_marker(self, value: int) -> bool:
        """Persist the exact trim frontier (tmp + atomic rename).
        Returns False on failure — the caller then SKIPS the trim, so
        the marker can over-claim (crash between save and removal:
        segments still readable) but never under-claim (a stale marker
        silently skipping trimmed events after restart)."""
        import json
        import os

        try:
            tmp = self._trim_marker_path() + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"trimmed_through": value}, f)
            os.replace(tmp, self._trim_marker_path())
            return True
        except OSError:
            return False

    def _rotate_locked(self) -> None:
        import os

        self._active_f.flush()
        os.fsync(self._active_f.fileno())  # sealed segments are durable
        self._active_f.close()
        self._open_segment(self._segments[-1]["seq"] + 1)
        if len(self._segments) > self.max_segments:
            doomed = self._segments[: len(self._segments) - self.max_segments]
            new_tt = max(
                [self.trimmed_through] + [s["last"] for s in doomed]
            )
            # marker BEFORE removal: if the frontier cannot be made
            # durable, keep the segments (retention overruns a little;
            # data kept is always safe, data silently lost never is)
            if self._save_trim_marker(new_tt):
                self.trimmed_through = new_tt
                del self._segments[: len(doomed)]
                for s in doomed:
                    try:
                        os.remove(s["path"])
                    except OSError:
                        pass
        self._publish_segment_gauge()

    def _publish_segment_gauge(self) -> None:
        from ..util.metrics import META_FEED_SEGMENTS

        META_FEED_SEGMENTS.set(len(self._segments))

    # ---------------- append ----------------
    def append(self, directory, event_type, old_entry, new_entry):
        import os

        with self._lock:
            ts = max(time.time_ns(), self._last_ts_ns + 1)
            self._last_ts_ns = ts
            ev = MetaLogEvent(ts, directory, event_type, old_entry, new_entry)
            self._active_f.write(
                mpack.packb(
                    {"t": ts, "d": directory, "e": event_type,
                     "o": old_entry, "n": new_entry}
                )
            )
            self._active_f.flush()
            if self.fsync:
                os.fsync(self._active_f.fileno())
            seg = self._segments[-1]
            if seg["count"] == 0:
                seg["first"] = ts
            seg["last"] = ts
            seg["count"] += 1
            self._events.append(ev)
            self._ts.append(ts)
            if len(self._events) > self._capacity * 2:
                # ring truncation: everything at/below the last dropped
                # event's ts now lives only in the segments
                self._mem_floor = self._ts[-self._capacity - 1]
                del self._events[: -self._capacity]
                del self._ts[: -self._capacity]
            if seg["count"] >= self.segment_events:
                self._rotate_locked()
        from ..util.metrics import META_FEED_EVENTS

        META_FEED_EVENTS.inc()
        return ev

    # ---------------- reads ----------------
    def read_since_with_watermark(
        self,
        since_ns: int,
        path_prefix: str = "/",
        limit: Optional[int] = None,
    ) -> tuple[list[MetaLogEvent], int]:
        """Exact resumption across the ring/segment boundary: when the
        cursor still falls inside the in-memory tail, this is the base
        ring read; otherwise events come off the segments in ts order.
        With `limit`, the returned watermark is the ts scanned THROUGH
        (the last examined event), so resuming from it never skips —
        a far-behind subscriber catches up in bounded chunks.

        Raises :class:`MetaLogTrimmed` when a non-zero cursor is older
        than retention (see class doc)."""
        with self._lock:
            if 0 < since_ns < self.trimmed_through:
                raise MetaLogTrimmed(since_ns, self.trimmed_through)
            # the ring SERVES only its last `capacity` events (storage
            # runs to 2x between truncations) — the served floor is the
            # newest event the ring cannot produce
            if len(self._ts) > self._capacity:
                floor = self._ts[-self._capacity - 1]
            else:
                floor = self._mem_floor
            if since_ns >= floor:
                events, wm = self._ring_read(since_ns, path_prefix)
                if limit is not None and len(events) > limit:
                    events = events[:limit]
                    wm = events[-1].ts_ns
                return events, wm
            segs = [
                dict(s) for s in self._segments if s["last"] > since_ns
            ]
            watermark = self._last_ts_ns
        out: list[MetaLogEvent] = []
        scanned_through = since_ns
        for seg in segs:
            seg_scanned = 0  # highest ts actually read from this file
            try:
                for ev in self._read_segment(seg["path"]):
                    seg_scanned = ev.ts_ns
                    if ev.ts_ns <= since_ns:
                        continue
                    scanned_through = ev.ts_ns
                    if _match_prefix(ev, path_prefix):
                        out.append(ev)
                        if limit is not None and len(out) >= limit:
                            return out, scanned_through
            except FileNotFoundError:
                # vanished segment: a retention trim raced this unlocked
                # scan — TRANSIENT. Events in the hole were not
                # delivered, so the head watermark must not become the
                # cursor; resume authority is the last ts actually
                # scanned, and the retry (now seeing the trim in
                # trimmed_through) surfaces MetaLogTrimmed
                return out, scanned_through
            if seg_scanned < seg["last"]:
                # the file EXISTS but decodes short of what was durably
                # written: corruption, which no retry will heal. Deliver
                # the healthy prefix first (a follower must not lose the
                # readable history BEFORE the hole); once the cursor sits
                # at the wall and no progress is possible, surface the
                # undeliverable range instead of re-scanning forever
                if scanned_through > since_ns:
                    return out, scanned_through
                raise MetaLogTrimmed(since_ns, seg["last"])
        # the unlocked file scan may have read events appended AFTER the
        # watermark was captured — returning the stale watermark would
        # rewind the cursor below an already-delivered event (duplicate
        # delivery); the scan frontier is the resume authority
        return out, max(watermark, scanned_through)

    def _ring_read(self, since_ns, path_prefix):
        import bisect as _bisect

        lo = _bisect.bisect_right(self._ts, since_ns)
        tail = self._events[max(lo, len(self._events) - self._capacity):]
        return (
            [ev for ev in tail if _match_prefix(ev, path_prefix)],
            self._last_ts_ns,
        )

    @staticmethod
    def _read_segment(path: str):
        """Yield the valid prefix of one segment file. A missing file
        raises FileNotFoundError (the caller distinguishes a trim race
        from corruption); any decode trouble ends the stream early —
        the caller detects the shortfall against the segment's durable
        last-ts."""
        with open(path, "rb") as f:  # FileNotFoundError propagates
            try:
                for rec in mpack.Unpacker(f):
                    if not isinstance(rec, dict) or "t" not in rec:
                        break
                    yield MetaLogEvent(
                        int(rec["t"]), rec.get("d", ""), rec.get("e", ""),
                        rec.get("o"), rec.get("n"),
                    )
            except Exception:
                return  # torn tail: the valid prefix was already yielded

    async def subscribe(
        self,
        since_ns: int = 0,
        path_prefix: str = "/",
        poll_interval: float = 0.05,
        stopped=None,
    ) -> AsyncIterator[MetaLogEvent]:
        """Replay durable history after since_ns in bounded chunks,
        then follow live (the base loop with a chunked disk read)."""
        import asyncio

        cursor = since_ns
        while stopped is None or not stopped():
            if self._last_ts_ns <= cursor:
                await asyncio.sleep(poll_interval)
                continue
            batch, watermark = self.read_since_with_watermark(
                cursor, path_prefix, limit=1024
            )
            cursor = max(cursor, watermark)
            for ev in batch:
                yield ev
            if not batch:
                await asyncio.sleep(poll_interval)

    # ---------------- per-subscriber cursors ----------------
    def _cursor_path(self) -> str:
        import os

        return os.path.join(self.dir, "cursors.json")

    def _load_cursors(self) -> dict:
        import json

        if self._cursors is None:
            try:
                with open(self._cursor_path()) as f:
                    self._cursors = {
                        str(k): int(v) for k, v in json.load(f).items()
                    }
            except (OSError, ValueError):
                self._cursors = {}
        return self._cursors

    def cursor_load(self, name: str) -> Optional[int]:
        """Resume point for a named subscriber, or None when unknown."""
        with self._cursor_lock:
            return self._load_cursors().get(name)

    def cursor_ack(self, name: str, ts_ns: int) -> None:
        """Record that `name` has processed through ts_ns (monotonic:
        an older ack never rewinds the cursor). Shadow-write + atomic
        rename — a crash mid-ack leaves the previous cursor, and
        resuming from it re-delivers only events whose effects are
        idempotent for a correctly written subscriber."""
        import json
        import os

        with self._cursor_lock:
            cur = self._load_cursors()
            if cur.get(name, -1) >= ts_ns:
                return
            cur[name] = int(ts_ns)
            tmp = self._cursor_path() + ".tmp"
            try:
                with open(tmp, "w") as f:
                    json.dump(cur, f)
                os.replace(tmp, self._cursor_path())
            except OSError:
                pass  # cursor persistence is best-effort per ack

    def close(self) -> None:
        import os

        with self._lock:
            try:
                self._active_f.flush()
                os.fsync(self._active_f.fileno())
                self._active_f.close()
            except OSError:
                pass


def _match_prefix(ev: MetaLogEvent, path_prefix: str) -> bool:
    if not path_prefix or path_prefix == "/":
        return True
    for entry in (ev.new_entry, ev.old_entry):
        if entry:
            full = entry.get("full_path") or (
                f"{ev.directory.rstrip('/')}/{entry.get('name', '')}"
            )
            if full.startswith(path_prefix):
                return True
    return ev.directory.startswith(path_prefix)
