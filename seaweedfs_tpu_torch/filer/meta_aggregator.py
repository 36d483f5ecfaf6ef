"""Multi-filer metadata aggregation.

The reference runs several filers against shared or separate stores and
keeps them convergent by having every filer follow every peer's LOCAL
metadata stream, merging the events into an aggregate log that the public
SubscribeMetadata stream serves (ref: weed/filer2/meta_aggregator.go:19-80,
meta_replay.go; wiring in weed/server/filer_grpc_server_sub_meta.go).

Shape here: each FilerServer with `-peers` starts one follower task per
peer. Peer events are (a) appended to the aggregate MetaLog — so a watcher
of ANY filer sees the cluster-wide event stream — and (b) replayed into
the local store when the store is filer-local (separate per filer), which
is what keeps two filers over separate embedded stores convergent. Replay
writes go straight to the store, never through Filer.create_entry, so a
replayed event is not re-logged (no echo loops). Per-peer resume offsets
persist in a JSON sidecar, checkpointed every 100 changes or 60 s like the
reference (meta_aggregator.go:52-76).

Ported from the JAX package's filer/meta_aggregator.py on the port's RPC
tier (`pb/rpc.py`): a port filer follows port peers only.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time

from ..pb import grpc_address
from ..pb.rpc import Stub
from .entry import Attr, Entry
from .meta_log import MetaLog, MetaLogTrimmed

_LOG = logging.getLogger(__name__)


class MetaAggregator:
    def __init__(
        self,
        filer,
        self_address: str,
        peers: list[str],
        replay_into_store: bool = True,
        offsets_path: str = "",
        capacity: int = 10000,
    ):
        self.filer = filer
        self.self_address = self_address
        self.peers = [p for p in peers if p and p != self_address]
        self.replay_into_store = replay_into_store
        self.log = MetaLog(capacity=capacity)
        self._offsets_path = offsets_path
        self._offsets: dict = {}
        self._changes_since_persist = 0
        self._last_persist = time.monotonic()
        self._tasks: list = []
        self._stopped = False
        if offsets_path and os.path.exists(offsets_path):
            try:
                with open(offsets_path) as f:
                    self._offsets = {
                        k: int(v) for k, v in json.load(f).items()
                    }
            except (OSError, ValueError):
                self._offsets = {}

    # ---------------- lifecycle ----------------
    def start(self) -> None:
        # local events feed the aggregate stream too (reference: the local
        # log buffer IS one of the aggregated inputs)
        self._tasks.append(asyncio.ensure_future(self._follow_local()))
        for peer in self.peers:
            self._tasks.append(
                asyncio.ensure_future(self._follow_peer(peer))
            )

    async def stop(self) -> None:
        self._stopped = True
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._persist_offsets(force=True)

    # ---------------- followers ----------------
    async def _follow_local(self) -> None:
        since = 0
        while not self._stopped:
            try:
                async for ev in self.filer.meta_log.subscribe(
                    since, "/", stopped=lambda: self._stopped
                ):
                    since = ev.ts_ns
                    self.log.append(
                        ev.directory, ev.event_type, ev.old_entry,
                        ev.new_entry,
                    )
                return
            except MetaLogTrimmed as e:
                # the local durable log lost a range (retention outran
                # this follower, or a corrupt segment): the aggregate
                # ring is lossy by design — log the gap and resume past
                # it instead of dying silently
                _LOG.warning(
                    "local meta feed gap (%d, %d]: resuming past it",
                    e.since_ns, e.trimmed_through,
                )
                since = max(since, e.trimmed_through)

    async def _follow_peer(self, peer: str) -> None:
        """Follow one peer's SubscribeLocalMetadata stream forever,
        redialing with backoff (ref meta_aggregator.go:98-128; the 1733 ms
        retry sleep is the reference's)."""
        since = self._offsets.get(peer, 0)
        while not self._stopped:
            try:
                stub = Stub(grpc_address(peer), "filer")
                async for msg in stub.server_stream(
                    "SubscribeLocalMetadata",
                    {
                        "client_name": f"filer:{self.self_address}",
                        "path_prefix": "/",
                        "since_ns": since,
                    },
                ):
                    notif = msg.get("event_notification") or {}
                    self.log.append(
                        msg.get("directory", ""),
                        notif.get("event_type", ""),
                        notif.get("old_entry"),
                        notif.get("new_entry"),
                    )
                    if self.replay_into_store:
                        try:
                            self._replay(notif)
                        except Exception as e:
                            _LOG.warning(
                                "meta replay from %s failed: %s", peer, e
                            )
                    since = int(msg.get("ts_ns", since)) or since
                    self._offsets[peer] = since
                    self._changes_since_persist += 1
                    self._maybe_persist()
            except asyncio.CancelledError:
                return
            except Exception as e:
                _LOG.warning("subscribing %s meta change: %s", peer, e)
            if not self._stopped:
                await asyncio.sleep(1.733)

    # ---------------- replay (ref meta_replay.go) ----------------
    def _replay(self, notif: dict) -> None:
        """Apply one peer event to the LOCAL store directly — not through
        Filer.create_entry — so it is not re-logged locally."""
        store = self.filer.store
        old, new = notif.get("old_entry"), notif.get("new_entry")
        if old and (
            not new or old.get("full_path") != new.get("full_path")
        ):
            store.delete_entry(old["full_path"])
        if new:
            entry = Entry.from_dict(new)
            self._ensure_parents(entry.full_path)
            store.insert_entry(entry)

    def _ensure_parents(self, full_path: str) -> None:
        store = self.filer.store
        parts = full_path.strip("/").split("/")[:-1]
        path = ""
        for part in parts:
            path += "/" + part
            if store.find_entry(path) is None:
                store.insert_entry(
                    Entry(
                        full_path=path,
                        attr=Attr(mtime=time.time(), mode=0o40755),
                    )
                )

    # ---------------- offset checkpointing ----------------
    def _maybe_persist(self) -> None:
        if self._changes_since_persist >= 100 or (
            time.monotonic() - self._last_persist > 60
        ):
            self._persist_offsets()

    def _persist_offsets(self, force: bool = False) -> None:
        if not self._offsets_path:
            return
        if not force and not self._offsets:
            return
        try:
            tmp = self._offsets_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self._offsets, f)
            os.replace(tmp, self._offsets_path)
            self._changes_since_persist = 0
            self._last_persist = time.monotonic()
        except OSError:
            pass
