"""Meta-log-fed read replicas.

A follower filer (`filer -followSource <primary>`) tails the primary's
``SubscribeMetadata`` stream from a locally-durable cursor and applies
every namespace event STRAIGHT to its own store — same-cluster
semantics: it never ships chunk bytes and NEVER frees chunks on delete:
the primary owns the data plane, the follower only mirrors metadata.
GET/LIST served from the follower are eventually consistent with a
DISCLOSED staleness bound:

    bound = now - head_checked_at          if cursor >= head_ts
          = now - cursor / 1e9             otherwise

where ``head_ts`` is the primary's ``last_ts_ns`` observed at
``head_checked_at`` (a periodic GetFilerConfiguration probe). Both arms
are over-estimates of any divergent answer's age: an event the follower
is missing either existed at the last head check (so its ts is above the
cursor, making it younger than ``now - cursor``) or was appended after
the check (younger than ``now - head_checked_at``).

Read-your-writes rides a counted redirect: a client that just wrote to
the primary holds the write's ``ts_ns`` watermark and sends it as
``min_ts_ns`` on follower reads; a follower whose cursor is behind the
watermark answers ``{"error": "redirect", "primary": ...}`` instead of a
stale entry (``meta_follower_redirects_total``).

A cursor that falls behind the primary's meta-log retention
(MetaLogTrimmed under ``strict_resume``) halts the tail LOUDLY with
``resync_required`` — silently skipping the hole would serve a namespace
missing arbitrary mutations forever.

Ported from the JAX package's filer/meta_follower.py on the port's RPC
tier. Events land through the store's own `insert_entry` and
`delete_entry` from the serving loop's thread; on an LSM store under the
meta gate they take the store's lock, which the gate's identity check
holds across its device answer and host re-read, so an applied event
falls wholly before or after a flush's two answers.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import random
import time
from typing import Callable, Optional

from ..pb import grpc_address
from ..pb.rpc import Stub
from ..util.backoff import BackoffPolicy
from ..util.metrics import FOLLOWER_EVENTS, FOLLOWER_REDIRECTS
from .entry import Entry
from .meta_log import MetaLogTrimmed

_LOG = logging.getLogger(__name__)


class MetaFollower:
    """Tails a primary filer's metadata stream into a local store.

    `source` is the primary's HTTP address (gRPC derived); tests may
    instead pass `source_log` — an in-process (Durable)MetaLog — which
    skips the wire entirely (the crash/resume property test drives the
    cursor discipline through this seam). `state_path` holds the durable
    resume cursor (shadow-write + rename); "" keeps it memory-only,
    which is only sound when the local store is memory-backed too (both
    reset together on restart)."""

    RECONNECT_POLICY = BackoffPolicy(base=0.2, cap=5.0, attempts=1 << 30)

    def __init__(
        self,
        source: str,
        filer,
        state_path: str,
        client_name: str = "",
        source_log=None,
        head_check_s: float = 0.25,
        clock: Callable[[], float] = time.time,
    ):
        self.source = source
        self.filer = filer
        self.state_path = state_path
        self.client_name = client_name or f"follower:{os.getpid()}"
        self.source_log = source_log
        self.head_check_s = head_check_s
        self._clock = clock
        self.cursor_ns = self._load_cursor()
        self.head_ts_ns = 0
        self.head_checked_at = 0.0  # clock() of the last head probe
        self.connected = False
        self.resync_required = False
        self.trimmed_through = 0
        self.applied = 0
        self.skipped = 0
        self.redirects = 0
        self._stopped = False
        self._stop_event: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._head_task: Optional[asyncio.Task] = None

    # ---------------- durable cursor ----------------
    def _load_cursor(self) -> int:
        if not self.state_path:
            return 0
        try:
            with open(self.state_path) as f:
                st = json.load(f)
            if st.get("source") not in ("", None, self.source):
                _LOG.warning(
                    "follower cursor %s was for source %r, now %r: "
                    "resetting", self.state_path, st.get("source"),
                    self.source,
                )
                return 0
            return int(st.get("since_ns", 0))
        except (OSError, ValueError):
            return 0

    def _ack_cursor(self, ts_ns: int) -> None:
        self.cursor_ns = ts_ns
        if not self.state_path:
            return
        tmp = self.state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"since_ns": ts_ns, "source": self.source}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.state_path)

    # ---------------- lifecycle ----------------
    async def start(self) -> None:
        self._stopped = False
        self._stop_event = asyncio.Event()
        self._task = asyncio.ensure_future(self._run())
        self._head_task = asyncio.ensure_future(self._head_loop())

    async def stop(self) -> None:
        self._stopped = True
        if self._stop_event is not None:
            self._stop_event.set()
        for t in (self._task, self._head_task):
            if t is not None:
                t.cancel()
                try:
                    await t
                except (asyncio.CancelledError, Exception):
                    pass
        self._task = self._head_task = None

    # ---------------- staleness disclosure ----------------
    def staleness_bound_s(self) -> float:
        """Upper bound on how stale any answer served RIGHT NOW can be
        (see the module docstring for the two-arm argument)."""
        now = self._clock()
        if self.head_checked_at > 0 and self.cursor_ns >= self.head_ts_ns:
            return max(0.0, now - self.head_checked_at)
        return max(0.0, now - self.cursor_ns / 1e9)

    def gate_read(self, req: dict) -> Optional[dict]:
        """Read-your-writes seam for the serving handlers: a request
        carrying min_ts_ns ahead of the tail cursor gets a counted
        redirect to the primary instead of a possibly-stale answer."""
        min_ts = int(req.get("min_ts_ns", 0))
        if min_ts > self.cursor_ns:
            self.redirects += 1
            FOLLOWER_REDIRECTS.inc()
            return {
                "error": "redirect",
                "primary": self.source,
                "cursor_ns": self.cursor_ns,
                "min_ts_ns": min_ts,
            }
        return None

    def status(self) -> dict:
        return {
            "source": self.source,
            "connected": self.connected,
            "cursor_ns": self.cursor_ns,
            "head_ts_ns": self.head_ts_ns,
            "staleness_bound_s": round(self.staleness_bound_s(), 4),
            "applied": self.applied,
            "skipped": self.skipped,
            "redirects": self.redirects,
            "resync_required": self.resync_required,
            "trimmed_through": self.trimmed_through,
        }

    # ---------------- the head probe ----------------
    async def _head_loop(self) -> None:
        while not self._stopped:
            try:
                await self._check_head()
            except asyncio.CancelledError:
                return
            except Exception:
                pass  # next tick retries; the bound degrades honestly
            await asyncio.sleep(self.head_check_s)

    async def _check_head(self) -> None:
        if self.source_log is not None:
            head = self.source_log.last_ts_ns
        else:
            stub = Stub(grpc_address(self.source), "filer")
            conf = await stub.call(
                "GetFilerConfiguration", {}, timeout=5.0
            )
            head = int(conf.get("last_ts_ns", 0))
        # order matters: stamp the probe time BEFORE publishing the new
        # head — a reader between the two sees an older check time with
        # a newer head, which only WIDENS the disclosed bound
        self.head_checked_at = self._clock()
        self.head_ts_ns = head

    # ---------------- the tail loop ----------------
    async def _run(self) -> None:
        failures = 0
        while not self._stopped and not self.resync_required:
            try:
                await self._tail_once()
                failures = 0
            except asyncio.CancelledError:
                return
            except MetaLogTrimmed as e:
                self._trimmed(e.trimmed_through)
                return
            except Exception as e:
                _LOG.warning(
                    "meta follower tail of %s: %s (%s)", self.source,
                    e, type(e).__name__,
                )
            self.connected = False
            if self._stopped or self.resync_required:
                return
            delay = self.RECONNECT_POLICY.delay(failures, random)
            failures = min(failures + 1, 16)
            await asyncio.sleep(delay)

    def _trimmed(self, through: int) -> None:
        self.trimmed_through = int(through)
        self.resync_required = True
        _LOG.error(
            "meta follower of %s REQUIRES RESYNC: cursor %d is behind "
            "primary retention (trimmed through %d)",
            self.source, self.cursor_ns, self.trimmed_through,
        )

    async def _tail_once(self) -> None:
        if self.source_log is not None:
            async for ev in self.source_log.subscribe(
                since_ns=self.cursor_ns,
                stopped=self._stop_event.is_set,
            ):
                self.connected = True
                self._apply(ev.to_dict())
            return
        stub = Stub(grpc_address(self.source), "filer")
        stream = stub.server_stream(
            "SubscribeMetadata",
            {
                "client_name": self.client_name,
                "path_prefix": "/",
                "since_ns": self.cursor_ns,
                "strict_resume": True,
            },
        )
        async for msg in stream:
            if msg.get("error") == "trimmed":
                self._trimmed(msg.get("trimmed_through", 0))
                return
            self.connected = True
            self._apply(msg)

    # ---------------- applying one event ----------------
    def _apply(self, msg: dict) -> None:
        """Direct store application — metadata only, chunks untouched.
        Idempotent per event (upserts overwrite, deletes tolerate
        absence), so the apply-then-ack order makes crash replays
        harmless."""
        ts = int(msg.get("ts_ns", 0))
        if ts <= self.cursor_ns:
            self.skipped += 1
            return
        notif = msg.get("event_notification") or {}
        etype = notif.get("event_type", "")
        old = notif.get("old_entry")
        new = notif.get("new_entry")
        store = self.filer.store
        if etype in ("create", "update") and new:
            store.insert_entry(Entry.from_dict(new))
            FOLLOWER_EVENTS.inc(type="upsert")
            self.applied += 1
        elif etype == "rename" and new:
            store.insert_entry(Entry.from_dict(new))
            if old and old.get("full_path") != new.get("full_path"):
                store.delete_entry(old["full_path"])
            FOLLOWER_EVENTS.inc(type="rename")
            self.applied += 1
        elif etype == "delete" and (old or new):
            path = (old or new).get("full_path", "")
            if path:
                # NEVER delete_chunks: the primary owns the data plane;
                # this mirror only forgets the metadata
                store.delete_folder_children(path)
                store.delete_entry(path)
                FOLLOWER_EVENTS.inc(type="delete")
                self.applied += 1
            else:
                self.skipped += 1
        else:
            self.skipped += 1
        self._ack_cursor(ts)
