"""Filer server: HTTP file namespace + RPC metadata API.

HTTP (ref: weed/server/filer_server_handlers_{read,write}*.go):
  GET    /path        file content (chunk-assembled) or directory JSON
                      (`limit`, `lastFileName` page it)
  HEAD   /path        the file's size
  PUT/POST /path      upload with auto-chunking to volume servers (a raw
                      body, or the first file part of a multipart form)
  DELETE /path[?recursive=true]

RPC "filer" (ref: weed/server/filer_grpc_server.go): LookupDirectoryEntry,
ListEntries, CreateEntry, UpdateEntry, DeleteEntry, AtomicRenameEntry,
AssignVolume, Statistics, GetFilerConfiguration, FleetStatus, FleetIngest,
FleetMoveRange and the SubscribeMetadata and SubscribeLocalMetadata
streams.

Ported from the JAX package's server/filer.py on the port's one HTTP tier
(util/fasthttp.py) and RPC tier (pb/rpc.py). Where the JAX filer's
byte-level fast tier answers a shape (a plain file GET or HEAD, a raw-body
PUT or POST: no query, no %-encoding), the port answers with that tier's
statuses, bodies and `application/json`; every other shape (directory
JSON, multipart forms, query strings, encoded paths, DELETE, other
methods) gets the JAX aiohttp application's answers (`application/json;
charset=utf-8`, the `{"error": "not found"}` 404, the 405, aiohttp's 500
page for an unexpected exception). Chunk uploads lease fids in count=128
batches (client/operation.AssignLease) and ride `ChunkUploadGate` into
the volume servers' `/!batch/put`; chunk reads ride the replica read
fan-out (client/read_fanout.py); deleted and overwritten chunks drain
through the batched GC loop (BatchDelete per holder).

Path lookups ride `MetaLookupGate`, and creates' ancestor spines too. The
gate's mode is `SEAWEEDFS_TPU_META_GATE` (or the `meta_gate` argument):
`0` no gate, `1` the host gate, `device` (the default) the gate over a
DeviceColumnArena: the `arena` argument, else the process's default arena
on the card, whose dispatch is the kernel K2 (ops/csrc/ragged_lookup.cu).
Without a card the default raises at construction: run with `1`, or give
an arena on the CPU (its dispatch is K2's plain version). The JAX filer
defaults to `1`. A lookup the gate fails (a device error, an identity
mismatch) answers 500 and is counted in `device_errors`; it is never
served around from the host store (the JAX fast tier hands it to its
aiohttp application, which reads the store).

The scale-out: `shards > 1` puts a `ShardedFilerStore` of LSM (`.lsm`)
or sqlite sub-stores under the filer; it has no `arena_view`, so its
meta gate serves every flush from the host (`host_fallbacks`, reason
`no_arena_view`), as the JAX filer's does. `fleet_map_path` makes this
filer a `FleetMember` (filer/fleet.py): each RPC on a path first passes
the member's ownership check and fence, and is forwarded to the owner
when another member holds the path's directory; HTTP requests for a path
it does not own answer 307 to the owner. `follow_source` makes it a
read-only `MetaFollower` of that primary (writes answer
`read_only_follower`), and `peers` a `MetaAggregator` over those filers'
SubscribeLocalMetadata streams, whose aggregate log SubscribeMetadata
serves.

Not ported: geo replication, notification sinks and chunk encryption; the
GeoStatus and GeoResync RPCs are not registered, so they answer RPC 501.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from typing import Optional
from urllib.parse import parse_qsl, unquote

from ..client.master_client import MasterClient
from ..client.operation import AssignLease, assign
from ..client.read_fanout import ReplicaReader
from ..filer import (
    Attr,
    Entry,
    FileChunk,
    Filer,
    MemoryFilerStore,
    SqliteFilerStore,
    non_overlapping_visible_intervals,
    read_from_visible_intervals,
)
from ..pb import grpc_address
from ..pb.rpc import Service, Stub, serve
from ..util import tenancy, trace
from ..util.fasthttp import (
    JSON_FAST,
    JSON_FULL,
    TEXT_FULL,
    FastHTTPClient,
    parse_multipart,
    render_response,
)
from .serving_core import ServingCore, json_body

_LOG = logging.getLogger(__name__)

META_GATE_MODES = ("0", "1", "device")

# aiohttp's answer to a handler that raised
_AIOHTTP_500 = b"500 Internal Server Error\n\nServer got itself in trouble"


def _json(status: int, obj, content_type: bytes = JSON_FULL,
          head_only: bool = False) -> bytes:
    return render_response(status, json_body(obj), content_type,
                           head_only=head_only)


class ChunkUploadGate:
    """Same-tick coalescing of chunk uploads per volume host — the
    write-side sibling of server/lookup_gate.BatchLookupGate, feeding
    the volume fast tier's POST /!batch/put. Concurrent filer PUTs'
    chunks to one host share ONE HTTP request (one wire build, one
    response parse, one connection turn) instead of a full hop each.

    Batch formation is adaptive, not timed: the first submit of a tick
    schedules the flush with call_soon, so a lone upload flushes
    immediately with zero added latency and batches grow on their own
    under load. Items the volume server declines item-wise (replicated
    placement, missing volume) retry through the plain single-needle
    path, so semantics never diverge from the unbatched tier.

    Batches are MIXED-TENANT: the coalescing key is the HOST alone, and
    every item carries its OWN principal inside the frame (the
    tenant-tagged `!batch/put` layout); item-wise retries re-enter the
    member's tenant context. No quota is charged (the admission gate is
    not ported)."""

    def __init__(self, http, max_batch: int = 64, max_bytes: int = 32 << 20):
        self.http = http
        self.max_batch = max_batch
        self.max_bytes = max_bytes
        # host -> [(fid, payload, fut, trace ctx, tenant)]
        self._pending: dict[str, list] = {}
        self._bytes: dict[str, int] = {}
        self._count = 0
        self._scheduled = False
        self._loop = None
        self._tasks: set = set()
        self.stats = {"uploads": 0, "batches": 0, "largest_batch": 0,
                      "item_retries": 0, "mixed_batches": 0}

    def submit(self, host: str, fid: str, payload):
        """Awaitable -> etag str (raises IOError on upload failure)."""
        loop = self._loop
        if loop is None:
            loop = self._loop = asyncio.get_event_loop()
        fut = loop.create_future()
        self._pending.setdefault(host, []).append(
            (fid, payload, fut, trace.current_sampled(), tenancy.current())
        )
        nbytes = self._bytes.get(host, 0) + len(payload)
        self._bytes[host] = nbytes
        self._count += 1
        if self._count >= self.max_batch or nbytes >= self.max_bytes:
            self._flush()
        elif not self._scheduled:
            self._scheduled = True
            loop.call_soon(self._flush)
        return fut

    def _flush(self) -> None:
        self._scheduled = False
        if not self._count:
            return
        pending, self._pending = self._pending, {}
        self._bytes = {}
        self._count = 0
        for host, items in pending.items():
            self.stats["uploads"] += len(items)
            self.stats["batches"] += 1
            if len(items) > self.stats["largest_batch"]:
                self.stats["largest_batch"] = len(items)
            if len({t for _f, _p, _fut, _c, t in items}) > 1:
                self.stats["mixed_batches"] += 1
            t = asyncio.ensure_future(self._send(host, items))
            self._tasks.add(t)
            t.add_done_callback(self._tasks.discard)

    async def _single(self, host: str, fid: str, payload, tenant=None) -> str:
        # item-wise sends/retries run under the ITEM's own principal
        tok = tenancy.set_current(tenant)
        try:
            st, body = await self.http.request(
                "POST", host, "/" + fid, body=payload,
                content_type="application/octet-stream",
            )
        finally:
            tenancy.reset_current(tok)
        if st >= 300:
            raise IOError(
                f"chunk upload {fid}: status {st} {bytes(body)[:160]!r}"
            )
        try:
            return json.loads(body).get("eTag", "")
        except Exception:
            return ""

    async def _send(self, host: str, items: list) -> None:
        # the carrier tenant context is reset: every member's principal
        # rides inside the mixed-tenant frame
        members = [c for _f, _p, _fut, c, _t in items if c is not None]
        cm = trace.batch_span(
            "gate.chunk_put", members, host=host, batch=len(items)
        )
        tok = tenancy.set_current(None)
        try:
            with cm:
                await self._send_inner(host, items)
        finally:
            tenancy.reset_current(tok)

    async def _send_inner(self, host: str, items: list) -> None:
        try:
            if len(items) == 1:
                fid, payload, fut, _ctx, tenant = items[0]
                etag = await self._single(host, fid, payload, tenant)
                if not fut.done():
                    fut.set_result(etag)
                return
            import struct as _struct

            # tenant-tagged frame (high bit of the count word): per item
            # [u16 fid_len][u16 tenant_len][u32 body_len][fid][tenant]
            # [body]
            parts = [_struct.pack("<I", len(items) | 0x80000000)]
            for fid, payload, _fut, _ctx, tenant in items:
                fb = fid.encode("latin1")
                tb = (tenant or "").encode("utf-8")
                parts.append(
                    _struct.pack("<HHI", len(fb), len(tb), len(payload))
                )
                parts.append(fb)
                parts.append(tb)
                parts.append(payload)
            st, resp = await self.http.request(
                "POST", host, "/!batch/put", body=b"".join(parts),
                content_type="application/octet-stream",
            )
            if st != 200:
                raise IOError(f"batch put: status {st} {resp[:160]!r}")
            by_fid = {r.get("f"): r for r in json.loads(resp)}
            for fid, payload, fut, _ctx, tenant in items:
                if fut.done():
                    continue
                r = by_fid.get(fid)
                if r is not None and "err" not in r:
                    fut.set_result(r.get("e", ""))
                    continue
                # item-wise decline (replicated volume, jwt, missing):
                # the plain single path under the item's own principal
                # is authoritative
                self.stats["item_retries"] += 1

                def resolve(t, fut=fut):
                    if fut.done():
                        return
                    exc = t.exception()
                    if exc is not None:
                        fut.set_exception(exc)
                    else:
                        fut.set_result(t.result())

                rt = asyncio.ensure_future(
                    self._single(host, fid, payload, tenant)
                )
                self._tasks.add(rt)
                rt.add_done_callback(self._tasks.discard)
                rt.add_done_callback(resolve)
        except Exception as e:
            # resolve every still-pending waiter; a future whose item-wise
            # retry is in flight checks done() before resolving, so the
            # two paths can't double-resolve
            for _fid, _payload, fut, _ctx, _tenant in items:
                if not fut.done():
                    fut.set_exception(IOError(str(e)))


def _open_store(store_path: str, shards: int = 0):
    if shards > 1:
        # prefix-sharded metadata plane: store_path names a directory
        # holding the crash-safe shard map + per-shard sub-stores (sqlite
        # by default, LSM when it ends in .lsm)
        from ..filer import ShardedFilerStore

        if not store_path:
            raise ValueError("sharded filer store needs a store_path")
        if store_path.endswith(".lsm"):
            def _factory(name: str):
                from ..filer.lsm_store import LsmFilerStore

                return LsmFilerStore(os.path.join(store_path, name + ".lsm"))
        else:
            def _factory(name: str):
                return SqliteFilerStore(os.path.join(store_path, name + ".db"))
        return ShardedFilerStore(store_path, _factory, n_shards=shards)
    if not store_path:
        return MemoryFilerStore()
    if store_path.endswith(".flog"):
        from ..filer.filer_store import LogFilerStore

        return LogFilerStore(store_path)
    if store_path.endswith(".lsm"):
        from ..filer.lsm_store import LsmFilerStore

        return LsmFilerStore(store_path)
    return SqliteFilerStore(store_path)


def resolve_meta_gate(meta_gate: Optional[str], arena):
    """(mode, arena) of a filer server: `meta_gate`, else
    SEAWEEDFS_TPU_META_GATE, else `device`; in device mode `arena`, else
    the process's default arena on the card (raises without one)."""
    mode = meta_gate
    if mode is None:
        mode = os.environ.get("SEAWEEDFS_TPU_META_GATE", "device") or "device"
    if mode not in META_GATE_MODES:
        raise ValueError(
            f"SEAWEEDFS_TPU_META_GATE={mode!r}: expected one of "
            f"{', '.join(META_GATE_MODES)}"
        )
    if mode != "device":
        return mode, None
    if arena is None:
        from ..ops.ragged_lookup import get_default_arena

        try:
            arena = get_default_arena()
        except RuntimeError as e:
            raise RuntimeError(
                "the filer's meta gate runs its lookups on the card "
                "(SEAWEEDFS_TPU_META_GATE=device, the default) and CUDA is "
                "not available: set SEAWEEDFS_TPU_META_GATE=1 for the host "
                f"gate ({e})"
            ) from e
    return mode, arena


class FilerServer:
    def __init__(
        self,
        master: str,
        host: str = "127.0.0.1",
        port: int = 8888,
        store_path: str = "",  # "" = in-memory, else by suffix (_open_store)
        chunk_size: int = 4 * 1024 * 1024,
        collection: str = "",
        replication: str = "",
        jwt_signing_key: str = "",
        notifier=None,
        meta_log_path: str = "",
        data_center: str = "",
        meta_gate: Optional[str] = None,
        arena=None,
        peers: tuple = (),
        shards: int = 0,
        fleet_map_path: str = "",
        fleet_self: str = "",
        follow_source: str = "",
    ):
        self.master = master
        self.host = host
        self.port = port
        self.address = f"{host}:{port}"
        self.chunk_size = chunk_size
        self.collection = collection
        self.replication = replication
        # shared cluster key: chunk uploads carry the master-issued token
        self.jwt_signing_key = jwt_signing_key
        # resolved before the store opens: a refusal must not leave the
        # store's directory lock held
        self.meta_gate_mode, arena = resolve_meta_gate(meta_gate, arena)
        store = _open_store(store_path, shards)
        meta_log = None
        if meta_log_path:
            from ..filer.meta_log import DurableMetaLog

            meta_log = DurableMetaLog(meta_log_path)
        self.filer = Filer(
            store,
            on_delete_chunks=self._queue_chunk_deletion,
            notifier=notifier,
            meta_log=meta_log,
        )
        # gate-batched metadata lookups: concurrent read-path probes and
        # create spines coalesce per event-loop wakeup into one find_many,
        # or in device mode one ragged dispatch over the store's runs
        self.meta_gate = None
        if self.meta_gate_mode != "0":
            from ..filer.meta_gate import MetaLookupGate

            self.meta_gate = MetaLookupGate(self.filer.store, arena=arena)
            if arena is not None and hasattr(store, "prefetch_arena"):
                store.prefetch_arena = arena
        # gate-batched WRITE seam: concurrent creates of one event-loop
        # tick coalesce into ONE insert_many store round. Default on;
        # =0 keeps per-entry writes.
        self.write_gate = None
        if (os.environ.get("SEAWEEDFS_TPU_META_WRITE_GATE", "1") or "1") != "0":
            from ..filer.meta_gate import MetaWriteGate

            self.write_gate = MetaWriteGate(self.filer.store)
        # metadata serving fleet: when fleet_map_path names the shared
        # crash-safe fleet map, this filer owns one prefix-range of the
        # namespace, forwards everything else to the owning member, and
        # can move ranges to a neighbor under traffic
        self._fleet = None
        if fleet_map_path:
            from ..filer.fleet import FleetMember

            self._fleet = FleetMember(
                fleet_map_path, fleet_self or self.address, self.filer
            )
        # meta-log-fed read replica: follow_source makes this filer an
        # eventually-consistent GET/LIST mirror of the named primary, with
        # a disclosed staleness bound and a counted redirect path for
        # read-your-writes
        self._follower = None
        if follow_source:
            from ..filer.meta_follower import MetaFollower

            self._follower = MetaFollower(
                follow_source,
                self.filer,
                (store_path + ".follower.json") if store_path else "",
                client_name=f"follower@{self.address}",
            )
        # peer filers: follow their local meta streams and merge into the
        # aggregate log served by SubscribeMetadata
        # (ref weed/filer2/meta_aggregator.go)
        self.meta_aggregator = None
        if peers:
            from ..filer.meta_aggregator import MetaAggregator

            self.meta_aggregator = MetaAggregator(
                self.filer,
                self.address,
                list(peers),
                offsets_path=(store_path + ".peers.json") if store_path else "",
            )
        # the filer's own DC label: read affinity (the shared vid map
        # orders same-DC replicas first)
        self.data_center = data_center
        self.master_client = MasterClient(f"filer@{self.address}", [master])
        self.master_client.vid_map.local_dc = data_center
        # requests answered 500 because a gated lookup raised, by operation
        self.device_errors: dict = {}
        # chunk GC state: pending (fid, attempts, host) triples ("" host =
        # resolve holders at drain time) + the drain condition the batched
        # deletion loop sleeps on (no polling interval)
        self._deletion_pending: list[tuple[str, int, str]] = []
        self._deletion_wakeup = asyncio.Event()
        self._deletion_task: Optional[asyncio.Task] = None
        self._rebalance_task: Optional[asyncio.Task] = None
        self.chunk_delete_rounds = 0  # drained batches (test visibility)
        self.chunk_delete_inflight = False  # a drain round is running
        self._core: Optional[ServingCore] = None
        self._rpc_server = None
        self._chunk_http: Optional[FastHTTPClient] = None
        self._chunk_reader: Optional[ReplicaReader] = None
        self._upload_gate: Optional[ChunkUploadGate] = None
        self._leases: dict[str, AssignLease] = {}
        self.upload_concurrency = 8
        self.fetch_concurrency = 8

    # ---------------- lifecycle ----------------
    async def start(self) -> None:
        # the JAX filer keeps 64 connections a volume server; the port keeps
        # enough for a c=256 GET burst to reuse them instead of opening and
        # closing one for each chunk read past the 64th
        self._chunk_http = FastHTTPClient(pool_per_host=512)
        await self.master_client.start()
        self._chunk_reader = ReplicaReader(
            self._chunk_http, self.master_client.vid_map
        )
        if (os.environ.get("SEAWEEDFS_TPU_CHUNK_BATCH", "1") or "1") != "0":
            self._upload_gate = ChunkUploadGate(self._chunk_http)
        self._deletion_task = asyncio.ensure_future(self._deletion_loop())
        self._core = ServingCore(
            "filer", self._dispatch, self.host, self.port,
            debug_handlers={"/debug/meta_gate": self._debug_meta_gate},
        )
        await self._core.start()
        svc = Service("filer")
        svc.unary("LookupDirectoryEntry")(self._grpc_lookup_entry)
        svc.unary("ListEntries")(self._grpc_list_entries)
        svc.unary("CreateEntry")(self._grpc_create_entry)
        svc.unary("UpdateEntry")(self._grpc_update_entry)
        svc.unary("DeleteEntry")(self._grpc_delete_entry)
        svc.unary("AtomicRenameEntry")(self._grpc_rename)
        svc.unary("AssignVolume")(self._grpc_assign_volume)
        svc.unary("Statistics")(self._grpc_statistics)
        svc.unary("GetFilerConfiguration")(self._grpc_configuration)
        svc.unary("FleetStatus")(self._grpc_fleet_status)
        svc.unary("FleetIngest")(self._grpc_fleet_ingest)
        svc.unary("FleetMoveRange")(self._grpc_fleet_move_range)
        svc.server_stream("SubscribeMetadata")(self._grpc_subscribe_metadata)
        svc.server_stream("SubscribeLocalMetadata")(
            self._grpc_subscribe_local_metadata
        )
        self._rpc_server = await serve(grpc_address(self.address), svc)
        if self._fleet is not None:
            # finish/roll back whatever a crash left mid-move BEFORE
            # serving: the map's intent/cleanup records are authoritative
            rec = self._fleet.recover()
            if rec["purged"] or rec["cleaned"] or rec["intent_cleared"]:
                _LOG.info(
                    "fleet recovery at %s: purged %d strays, cleaned %d, "
                    "intent_cleared=%s", self.address, rec["purged"],
                    rec["cleaned"], rec["intent_cleared"],
                )
        if self._follower is not None:
            await self._follower.start()
        if self.meta_aggregator is not None:
            self.meta_aggregator.start()
        if hasattr(self.filer.store, "maybe_rebalance"):
            self._rebalance_task = asyncio.ensure_future(
                self._rebalance_loop()
            )

    async def _rebalance_loop(self) -> None:
        """Heat-driven shard rebalance driver: periodically offer the
        sharded store a rebalance check — the store's own hysteresis
        (factor x mean, absolute floor, holddown interval) decides; a move
        runs in the executor (it is store I/O)."""
        store = self.filer.store
        interval = max(5.0, store.rebalance_min_interval_s / 4)
        loop = asyncio.get_event_loop()
        while True:
            await asyncio.sleep(interval)
            try:
                moved = await loop.run_in_executor(
                    None, store.maybe_rebalance
                )
                if moved:
                    _LOG.info(
                        "meta shard rebalance: moved %s entries "
                        "(shard %s -> %s at %r)",
                        moved["moved"], moved["src"], moved["dst"],
                        moved["split"],
                    )
            except asyncio.CancelledError:
                return
            except Exception:
                pass  # next tick retries; hysteresis bounds churn

    async def stop(self) -> None:
        if self._follower is not None:
            await self._follower.stop()
        if self.meta_aggregator is not None:
            await self.meta_aggregator.stop()
        if self._rpc_server is not None:
            await self._rpc_server.stop()
        if self._core is not None:
            await self._core.stop()
        for task in (self._deletion_task, self._rebalance_task):
            if task is None:
                continue
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
        await self.master_client.stop()
        if self._chunk_http is not None:
            await self._chunk_http.close()
        if self.meta_gate is not None:
            self.meta_gate.close()
        if self.write_gate is not None:
            self.write_gate.close()
        closer = getattr(self.filer.meta_log, "close", None)
        if closer is not None:
            closer()
        store_closer = getattr(self.filer.store, "close", None)
        if store_closer is not None and not isinstance(
            self.filer.store, MemoryFilerStore
        ):
            store_closer()

    async def _debug_meta_gate(self, req):
        """The gates' counters, the arena's and the store's segments."""
        body: dict = {"mode": self.meta_gate_mode,
                      "device_errors": dict(self.device_errors)}
        g = self.meta_gate
        if g is not None:
            body["gate"] = dict(g.stats)
            body["fallback_reasons"] = dict(g.fallback_reasons)
            if g.arena is not None:
                from ..ops import ragged_lookup

                body["arena"] = g.arena.stats()
                # K2 launches of this process (the gate's flushes on the
                # card; 0 for an arena on the CPU)
                body["ragged_lookup_launches"] = ragged_lookup.KERNEL_LAUNCHES
                if g.arena.device.type == "cuda":
                    import torch

                    # this process's tensors on the card (its CUDA context
                    # aside)
                    body["device_memory"] = {
                        "allocated": torch.cuda.memory_allocated(g.arena.device),
                        "reserved": torch.cuda.memory_reserved(g.arena.device),
                    }
        if self.write_gate is not None:
            body["write_gate"] = dict(self.write_gate.stats)
        if self._upload_gate is not None:
            body["upload_gate"] = dict(self._upload_gate.stats)
        segs = getattr(self.filer.store, "_segments", None)
        if segs is not None:
            body["segments"] = [len(s.keys) for s in segs]
            body["memtable"] = len(self.filer.store._mem)
        body["chunk_delete_rounds"] = self.chunk_delete_rounds
        body["chunk_delete_pending"] = len(self._deletion_pending)
        body["chunk_delete_inflight"] = self.chunk_delete_inflight
        if self._fleet is not None:
            body["fleet"] = dict(self._fleet.counters)
        if self._follower is not None:
            body["follower"] = self._follower.status()
        describe = getattr(self.filer.store, "describe", None)
        if describe is not None:
            body["shards"] = describe()
        return _json(200, body, JSON_FAST, head_only=req.method == "HEAD")

    # ---------------- async chunk GC (ref filer2/filer_deletion.go) ----------------
    def _queue_chunk_deletion(self, fids: list[str]) -> None:
        """Queue chunk fids for deletion and wake the drain loop NOW —
        a PUT-over-existing or DELETE storm is drained as one batched
        RPC round per holder instead of leaking into a linger window."""
        if not fids:
            return
        self._deletion_pending.extend((fid, 0, "") for fid in fids)
        self._deletion_wakeup.set()

    async def _deletion_loop(self) -> None:
        """Batched chunk GC: sleep on the drain condition, collect every
        queued fid, group by holder host (replicated chunks go to EVERY
        holder) and issue one volume BatchDelete RPC per host. Failed
        (fid, host) pairs requeue with full-jitter backoff
        (util/backoff.py) and a bounded attempt count, so a transiently
        unreachable volume server delays the GC instead of leaking
        chunks."""
        import random as _random

        from ..util.backoff import BackoffPolicy, shared_retry_budget
        from ..util.metrics import FILER_CHUNK_DELETE_BATCHES

        policy = BackoffPolicy(base=0.1, cap=5.0, attempts=1 << 30)
        rng = _random.Random(0x6047C)
        budget = shared_retry_budget()
        failures = 0
        while True:
            await self._deletion_wakeup.wait()
            self._deletion_wakeup.clear()
            batch, self._deletion_pending = self._deletion_pending, []
            if not batch:
                continue
            self.chunk_delete_inflight = True
            try:
                retry = await self._delete_chunk_batch(batch)
            finally:
                self.chunk_delete_inflight = False
            self.chunk_delete_rounds += 1
            FILER_CHUNK_DELETE_BATCHES.inc(
                result="retry" if retry else "ok"
            )
            if retry:
                failures += 1
                budget.on_failure()
                self._deletion_pending.extend(retry)
                # re-arm, then back off: new arrivals merge into the
                # retry round, and the jittered sleep IS the pacing. GC
                # retries forever (dropped fids leak bytes), so a drained
                # shared RetryBudget pins the pacing at the cap instead
                # of suppressing the round
                self._deletion_wakeup.set()
                delay = policy.delay(min(failures, 6), rng)
                if not budget.allow("filer_chunk_delete"):
                    delay = policy.cap
                await asyncio.sleep(delay)
            else:
                failures = 0
                budget.on_success()

    async def _delete_chunk_batch(
        self, batch: list[tuple[str, int, str]]
    ) -> list[tuple[str, int, str]]:
        """One drain round -> the (fid, attempts, host) entries to retry.
        Unresolved entries fan out to every current holder of the fid's
        volume; a volume the master no longer knows is dropped (nothing
        left to delete)."""
        by_host: dict[str, list[tuple[str, int]]] = {}
        for fid, attempts, host in batch:
            if attempts >= 6:
                continue  # bounded: a dead holder can't pin the queue
            if host:
                by_host.setdefault(host, []).append((fid, attempts))
                continue
            try:
                vid = int(fid.split(",")[0])
            except ValueError:
                continue
            locs = self.master_client.vid_map.lookup(vid)
            if not locs:
                try:
                    await self.master_client.lookup_file_id_async(
                        fid, timeout=2.0
                    )
                    locs = self.master_client.vid_map.lookup(vid)
                except LookupError:
                    continue  # volume gone from the cluster: nothing to do
                except Exception:
                    # master unreachable: retry the whole entry later
                    by_host.setdefault("", []).append((fid, attempts))
                    continue
            for loc in locs:
                by_host.setdefault(loc, []).append((fid, attempts))

        retry: list[tuple[str, int, str]] = []
        unresolved = by_host.pop("", [])
        retry.extend((fid, attempts + 1, "") for fid, attempts in unresolved)

        async def one_host(host: str, entries: list[tuple[str, int]]):
            fids = [fid for fid, _ in entries]
            try:
                stub = Stub(grpc_address(host), "volume")
                resp = await stub.call(
                    "BatchDelete", {"file_ids": fids}, timeout=10.0
                )
            except Exception:
                # whole host unreachable: requeue every pair against it
                retry.extend(
                    (fid, attempts + 1, host) for fid, attempts in entries
                )
                return
            failed = {
                r.get("file_id")
                for r in resp.get("results", [])
                if int(r.get("status", 500)) >= 500
                # an already-gone needle is success, not a retry loop
                and "not found" not in str(r.get("error", "")).lower()
                and "deleted" not in str(r.get("error", "")).lower()
            }
            retry.extend(
                (fid, attempts + 1, host)
                for fid, attempts in entries
                if fid in failed
            )

        if by_host:
            await asyncio.gather(
                *(one_host(h, entries) for h, entries in by_host.items())
            )
        return retry

    # ---------------- chunk IO ----------------
    async def _fetch_chunk(self, fid: str, cipher_key: bytes = b"") -> bytes:
        """Chunk GET through the replica read fan-out: round-robin across
        holders, hedge-on-p99, dead-replica failover. Vids the
        KeepConnected stream hasn't delivered yet fall back to one master
        lookup RPC (which fills the shared vid map)."""
        if cipher_key:
            raise IOError(f"chunk {fid} is encrypted: util/cipher.py is not ported")
        try:
            st, data = await self._chunk_reader.read_nowait(fid)
        except LookupError:
            await self.master_client.lookup_file_id_async(fid)
            st, data = await self._chunk_reader.read_nowait(fid)
        if st != 200:
            raise IOError(f"chunk {fid}: status {st}")
        return data

    async def _entry_body(self, entry, size: int) -> bytes:
        """Whole-file body for an entry. Single-chunk files — the dominant
        object shape — return the volume response body DIRECTLY (one
        fan-out GET, no interval sweep, no stitch copy); everything else
        goes through the span reader."""
        ch = entry.chunks
        if len(ch) == 1 and ch[0].offset == 0 and not ch[0].cipher_key:
            body = await self._fetch_chunk(ch[0].fid)
            if len(body) == size:
                return body
            # size disagreement (truncated read, stale entry): stitch
            # through the interval machinery like any other shape
        visibles = non_overlapping_visible_intervals(entry.chunks)
        return await self._read_span(visibles, 0, size)

    async def _read_span(self, visibles, offset: int, length: int) -> bytes:
        """Assemble [offset, offset+length): fetch exactly the chunks the
        span covers, DISTINCT fids concurrently (bounded), then stitch."""
        from ..filer.filechunks import view_from_visibles

        wanted: dict[str, bytes] = {}
        for view in view_from_visibles(visibles, offset, length):
            wanted.setdefault(view.fid, view.cipher_key)
        if not wanted:
            return bytes(length)
        items = list(wanted.items())
        if len(items) == 1:
            fid, ck = items[0]
            blobs = {fid: await self._fetch_chunk(fid, ck)}
        else:
            sem = asyncio.Semaphore(self.fetch_concurrency)

            async def get(fid: str, ck: bytes):
                async with sem:
                    return fid, await self._fetch_chunk(fid, ck)

            blobs = dict(
                await asyncio.gather(*(get(f, c) for f, c in items))
            )
        return read_from_visible_intervals(
            visibles, blobs.__getitem__, offset, length
        )

    def _lease_for(self, ttl: str) -> AssignLease:
        """Per-ttl fid lease (collection/replication are fixed per
        server). Refills are single-flight count=128 assigns — the
        per-chunk master round-trip is amortized to 1/128."""
        lease = self._leases.get(ttl)
        if lease is None:

            async def fetch(count: int, _ttl: str = ttl):
                return await assign(
                    self.master,
                    count=count,
                    collection=self.collection,
                    replication=self.replication,
                    ttl=_ttl,
                )

            lease = self._leases[ttl] = AssignLease(fetch=fetch, batch=128)
        return lease

    async def _upload_chunk(
        self, piece, ttl: str, lease: AssignLease, stages: Optional[dict]
    ) -> tuple[str, str, bytes]:
        """One chunk into the volume fast write tier -> (fid, etag, key).
        `piece` is a memoryview into the request body: the POST hands it
        to the wire join without an intermediate copy."""
        t0 = time.perf_counter()
        with trace.span("filer.lease"):
            ar = await lease.take()
        t1 = time.perf_counter()
        gate = self._upload_gate
        if gate is not None and not ar.auth and not ttl:
            # batched path: concurrent chunks to one host share a single
            # /!batch/put request (signed uploads and ttl'd chunks keep
            # the single path — per-item tokens/query can't ride a batch)
            etag = await gate.submit(ar.url, ar.fid, piece)
        else:
            target = "/" + ar.fid + (f"?ttl={ttl}" if ttl else "")
            headers = (
                {"Authorization": f"Bearer {ar.auth}"} if ar.auth else None
            )
            st, body = await self._chunk_http.request(
                "POST",
                ar.url,
                target,
                body=piece,
                content_type="application/octet-stream",
                headers=headers,
            )
            if st >= 300:
                raise IOError(
                    f"chunk upload {ar.fid}: status {st} "
                    f"{bytes(body)[:160]!r}"
                )
            try:
                etag = json.loads(body).get("eTag", "")
            except Exception:
                etag = ""
        if stages is not None:
            t2 = time.perf_counter()
            stages["lease"] = stages.get("lease", 0.0) + (t1 - t0)
            stages["upload"] = stages.get("upload", 0.0) + (t2 - t1)
        return ar.fid, etag, b""

    async def _write_chunks(
        self,
        data,
        ttl: str = "",
        base_offset: int = 0,
        stages: Optional[dict] = None,
    ) -> list[FileChunk]:
        """Store data as chunk needles; base_offset shifts the logical
        chunk offsets. Fids come from a count=128 AssignLease, the body
        is sliced into chunk-size MEMORYVIEWS streamed straight into the
        volume fast write tier, and multi-chunk bodies upload with
        bounded concurrency. `stages` (optional) accumulates
        'lease'/'upload' wall seconds."""
        mv = memoryview(data)
        now = time.time_ns()
        offsets = list(range(0, len(mv), self.chunk_size))
        if not offsets:
            return []
        lease = self._lease_for(ttl)
        with trace.span(
            "filer.write_chunks", bytes=len(mv), chunks=len(offsets)
        ):
            if len(offsets) == 1:
                results = [await self._upload_chunk(mv, ttl, lease, stages)]
            else:
                sem = asyncio.Semaphore(self.upload_concurrency)

                async def one(off: int):
                    async with sem:
                        return await self._upload_chunk(
                            mv[off : off + self.chunk_size], ttl, lease,
                            stages,
                        )

                results = await asyncio.gather(
                    *(one(off) for off in offsets), return_exceptions=True
                )
                errs = [r for r in results if isinstance(r, BaseException)]
                if errs:
                    # GC the chunks that DID land before surfacing the error
                    self._queue_chunk_deletion(
                        [
                            r[0]
                            for r in results
                            if not isinstance(r, BaseException)
                        ]
                    )
                    raise errs[0]
        return [
            FileChunk(
                fid=fid,
                offset=base_offset + off,
                size=min(self.chunk_size, len(mv) - off),
                mtime_ns=now,
                etag=etag,
                cipher_key=key,
            )
            for off, (fid, etag, key) in zip(offsets, results)
        ]

    # ---------------- HTTP ----------------
    @staticmethod
    def _fast_path(req) -> Optional[str]:
        """The path as the JAX fast tier takes it; None for the shapes it
        hands to its aiohttp application."""
        if req.query or "%" in req.path or "/../" in req.path:
            return None
        return req.path.rstrip("/") or "/"

    @staticmethod
    def _full_path(req) -> str:
        """The path as the JAX aiohttp application's route takes it
        (decoded, trailing slashes dropped)."""
        return "/" + unquote(req.path)[1:].rstrip("/")

    @staticmethod
    def _query(req) -> dict:
        out: dict = {}
        for k, v in parse_qsl(req.query, keep_blank_values=True):
            out.setdefault(k, v)
        return out

    async def _find_entry_gated(self, path: str):
        """Read-path entry probe through the metadata lookup gate when
        enabled (concurrent probes of one wakeup share one flush); the
        plain store probe otherwise."""
        if self.meta_gate is not None:
            return await self.meta_gate.lookup(path)
        return self.filer.find_entry(path)

    def _fleet_owns(self, path: str) -> bool:
        """True when no fleet is configured or this member owns the
        path's directory band (HTTP handlers redirect otherwise)."""
        if self._fleet is None:
            return True
        from ..filer.fleet import dir_of

        return self._fleet.owner_for_dir(dir_of(path)) == self._fleet.self_addr

    def _fleet_redirect(self, path: str, head: bool = False) -> bytes:
        from ..filer.fleet import dir_of

        owner = self._fleet.owner_for_dir(dir_of(path))
        return render_response(
            307, b"", b"application/octet-stream",
            extra=b"Location: http://%s%s\r\n" % (owner.encode(), path.encode()),
            head_only=head,
        )

    def _follower_redirect(self, path: str) -> bytes:
        """A follower's answer to a write: 307 to its primary."""
        src = self._follower.source
        return render_response(
            307,
            json_body({"error": "read_only_follower", "primary": src}),
            JSON_FULL,
            extra=b"Location: http://%s%s\r\n" % (src.encode(), path.encode()),
        )

    def _note_device_error(self, op: str, e: BaseException) -> None:
        self.device_errors[op] = self.device_errors.get(op, 0) + 1
        _LOG.warning("filer %s: gated lookup failed: %r", op, e)

    async def _dispatch(self, req) -> bytes:
        method = req.method
        fast = self._fast_path(req)
        try:
            if method in ("GET", "HEAD"):
                return await self._handle_get(req, fast)
            if method in ("PUT", "POST"):
                return await self._handle_put(req, fast)
            if method == "DELETE":
                return await self._handle_delete(req, self._full_path(req))
        except FileNotFoundError:
            return _json(404, {"error": "not found"},
                         head_only=method == "HEAD")
        except Exception as e:
            _LOG.warning("filer %s %s: %r", method, req.path, e)
            return render_response(500, _AIOHTTP_500, TEXT_FULL,
                                   head_only=method == "HEAD")
        return _json(405, {"error": "method not allowed"})

    async def _handle_get(self, req, fast: Optional[str]) -> bytes:
        head = req.method == "HEAD"
        tiered = fast is not None and fast != "/"
        path = fast if tiered else self._full_path(req)
        if path != "/" and not self._fleet_owns(path):
            return self._fleet_redirect(path, head)
        try:
            entry = await self._find_entry_gated(path)
        except Exception as e:
            self._note_device_error("lookup", e)
            return _json(500, {"error": f"{type(e).__name__}: {e}"},
                         JSON_FAST, head_only=head)
        if entry is None:
            return _json(404, {"error": "not found"},
                         JSON_FAST if tiered else JSON_FULL, head_only=head)
        if entry.is_directory:
            q = self._query(req)
            limit = int(q.get("limit", 1000))
            last = q.get("lastFileName", "")
            entries = self.filer.list_entries(path, last, not last, limit)
            return _json(200, {
                "Path": path,
                "Entries": [
                    {
                        "FullPath": e.full_path,
                        "IsDirectory": e.is_directory,
                        "Size": e.size(),
                        "Mtime": e.attr.mtime,
                        "Mime": e.attr.mime,
                    }
                    for e in entries
                ],
            }, head_only=head)
        size = entry.size()
        if head:
            return (
                b"HTTP/1.1 200 OK\r\n"
                b"Content-Type: application/octet-stream\r\n"
                b"Content-Length: %d\r\n"
                b"Connection: keep-alive\r\n\r\n" % size
            )
        ctype = (entry.attr.mime or "application/octet-stream").encode()
        if tiered:
            try:
                body = await self._entry_body(entry, size) if size else b""
            except Exception as e:
                return _json(500, {"error": str(e)}, JSON_FAST)
            return render_response(200, body, ctype)
        visibles = non_overlapping_visible_intervals(entry.chunks)
        # distinct chunks fetched concurrently through the fan-out
        body = await self._read_span(visibles, 0, size) if size else b""
        return render_response(200, body, ctype)

    def _is_dir(self, path: str) -> bool:
        e = self.filer.find_entry(path)
        return e is not None and e.is_directory

    async def _touch(self, path: str, mime: str, chunks: list) -> Entry:
        if self.write_gate is not None:
            # the write seam: a burst of PUTs coalesces into one
            # insert_many per event-loop wakeup, their spines into one
            # meta-gate flush
            return await self.filer.touch_gated(
                path,
                mime,
                chunks,
                self.write_gate,
                lookup_gate=self.meta_gate,
                replication=self.replication,
                collection=self.collection,
            )
        return self.filer.touch(
            path,
            mime,
            chunks,
            replication=self.replication,
            collection=self.collection,
        )

    async def _handle_put(self, req, fast: Optional[str]) -> bytes:
        ct = req.headers.get(b"content-type", b"")
        multipart = ct.startswith(b"multipart/form-data")
        # fleet routing/fencing and follower redirects live in the full
        # handler (the JAX fast tier hands these requests to its aiohttp
        # application)
        scaled = self._fleet is not None or self._follower is not None
        if (fast is not None and fast != "/" and not multipart and not scaled
                and not self._is_dir(fast)):
            # the JAX fast tier's raw-body upload
            try:
                chunks = await self._write_chunks(req.body)
            except Exception as e:
                return _json(500, {"error": str(e)}, JSON_FAST)
            try:
                entry = await self._touch(fast, ct.decode("latin1"), chunks)
            except Exception as e:
                self._queue_chunk_deletion([c.fid for c in chunks])
                if not isinstance(e, OSError):
                    self._note_device_error("create", e)
                return _json(500, {"error": str(e)}, JSON_FAST)
            return _json(201, {"name": entry.name, "size": len(req.body)},
                         JSON_FAST)
        path = self._full_path(req)
        mime = ""
        if multipart:
            data = b""
            part = parse_multipart(req.body, ct)
            if part is not None:
                data, filename, mime = bytes(part[0]), part[1], part[2]
                if path.endswith("/") or self._is_dir(path):
                    path = path.rstrip("/") + "/" + (filename or "file")
        else:
            data = req.body
            mime = ct.decode("latin1")
        if self._follower is not None:
            return self._follower_redirect(path)
        chunks = await self._write_chunks(
            data, ttl=self._query(req).get("ttl", "")
        )
        if self._fleet is not None:
            # chunks are cluster-global (already written); the ENTRY
            # routes through the same fleet path as RPC creates —
            # ownership check, fence admission, spine broadcast and all
            now = time.time()
            entry = Entry(
                full_path=path,
                attr=Attr(
                    mtime=now, crtime=now, mime=mime,
                    replication=self.replication,
                    collection=self.collection,
                ),
                chunks=chunks,
            )
            resp = await self._grpc_create_entry({"entry": entry.to_dict()}, None)
            if resp.get("error"):
                self._queue_chunk_deletion([c.fid for c in chunks])
                return _json(500, {"error": resp["error"]})
            return _json(201, {"name": entry.name, "size": len(data)})
        entry = await self._touch(path, mime, chunks)
        return _json(201, {"name": entry.name, "size": len(data)})

    async def _handle_delete(self, req, path: str) -> bytes:
        recursive = self._query(req).get("recursive") == "true"
        if self._follower is not None:
            return self._follower_redirect(path)
        if self._fleet is not None:
            d = path.rsplit("/", 1)[0] or "/"
            name = path.rsplit("/", 1)[-1]
            resp = await self._grpc_delete_entry(
                {"directory": d, "name": name, "is_recursive": recursive}, None
            )
            if resp.get("error"):
                return _json(409, {"error": resp["error"]})
            return render_response(204, b"", None)
        try:
            self.filer.delete_entry(path, recursive=recursive)
        except OSError as e:
            return _json(409, {"error": str(e)})
        return render_response(204, b"", None)

    # ---------------- RPC ----------------
    async def _grpc_lookup_entry(self, req, context) -> dict:
        path = req["directory"].rstrip("/") + "/" + req["name"]
        if self._follower is not None:
            # read-your-writes seam: a caller holding a primary write
            # watermark ahead of our tail cursor gets a counted redirect
            r = self._follower.gate_read(req)
            if r is not None:
                return r
        if self._fleet is not None:
            from ..filer.fleet import dir_of

            routed = await self._fleet.admit(
                "LookupDirectoryEntry", req, dir_of(path)
            )
            if routed is not None:
                return routed
        try:
            entry = await self._find_entry_gated(path)
        except Exception as e:
            self._note_device_error("rpc_lookup", e)
            raise
        if entry is None:
            return {"error": "not found"}
        return {"entry": entry.to_dict()}

    async def _grpc_list_entries(self, req, context) -> dict:
        d = req["directory"].rstrip("/") or "/"
        if self._follower is not None:
            r = self._follower.gate_read(req)
            if r is not None:
                return r
        if self._fleet is not None:
            # children of d carry directory == d, so the lister IS the
            # owner of d's band; subdirectory placeholders are present
            # everywhere via the spine broadcast
            routed = await self._fleet.admit("ListEntries", req, d)
            if routed is not None:
                return routed
        entries = self.filer.list_entries(
            d,
            req.get("start_from_file_name", ""),
            bool(req.get("inclusive_start_from", True)),
            int(req.get("limit", 1024)),
        )
        return {"entries": [e.to_dict() for e in entries]}

    def _read_only(self) -> dict:
        return {"error": "read_only_follower", "primary": self._follower.source}

    async def _create_local(self, entry: Entry, exclusive: bool) -> None:
        """One create through the gate-batched write seam (O_EXCL keeps
        the synchronous probe-insert path: its atomicity cannot ride a
        coalesced flush)."""
        if self.write_gate is not None and not exclusive:
            await self.filer.create_entry_gated(
                entry, self.write_gate, lookup_gate=self.meta_gate
            )
        else:
            self.filer.create_entry(entry, exclusive=exclusive)

    async def _grpc_create_entry(self, req, context) -> dict:
        if self._follower is not None:
            return self._read_only()
        entry_dict = req["entry"]
        path = entry_dict["full_path"]
        if self._fleet is None:
            try:
                await self._create_local(
                    Entry.from_dict(entry_dict),
                    bool(req.get("o_excl", False)),
                )
            except OSError as e:
                return {"error": str(e)}
            # safe watermark: last_ts_ns is taken AFTER the awaited insert
            # landed, so it is >= this mutation's event ts
            return {"ts_ns": self.filer.meta_log.last_ts_ns}
        from ..filer.fleet import ancestor_dirs, dir_of

        routed = await self._fleet.admit(
            "CreateEntry", req, dir_of(path), mutation=True
        )
        if routed is not None:
            return routed
        try:
            chain = ancestor_dirs(path)
            present = self.filer.store.find_many(chain) if chain else {}
            missing = [p for p in chain if p not in present]
            try:
                await self._create_local(
                    Entry.from_dict(entry_dict),
                    bool(req.get("o_excl", False)),
                )
            except OSError as e:
                return {"error": str(e)}
            ts = self.filer.meta_log.last_ts_ns
            if missing:
                # replicate freshly minted directory placeholders to
                # every member BEFORE answering: a successful create
                # implies a fleet-wide visible spine
                created = self.filer.store.find_many(missing)
                await self._fleet.broadcast_spine(
                    [created[p] for p in missing if p in created]
                )
            return {"ts_ns": ts}
        finally:
            self._fleet.finish_mutation()

    async def _grpc_update_entry(self, req, context) -> dict:
        if self._follower is not None:
            return self._read_only()
        if self._fleet is not None:
            from ..filer.fleet import dir_of

            routed = await self._fleet.admit(
                "UpdateEntry", req, dir_of(req["entry"]["full_path"]),
                mutation=True,
            )
            if routed is not None:
                return routed
            try:
                self.filer.update_entry(Entry.from_dict(req["entry"]))
            except OSError as e:
                return {"error": str(e)}
            finally:
                self._fleet.finish_mutation()
            return {}
        try:
            self.filer.update_entry(Entry.from_dict(req["entry"]))
        except OSError as e:
            return {"error": str(e)}
        return {}

    async def _grpc_delete_entry(self, req, context) -> dict:
        path = req["directory"].rstrip("/") + "/" + req["name"]
        if self._follower is not None:
            return self._read_only()
        if self._fleet is None:
            return await self._delete_local(req, path)
        from ..filer.fleet import dir_of

        routed = await self._fleet.admit(
            "DeleteEntry", req, dir_of(path), mutation=True
        )
        if routed is not None:
            return routed
        try:
            if bool(req.get("is_recursive", False)) and not req.get(
                "fleet_local"
            ):
                e = self.filer.find_entry(path)
                if e is not None and e.is_directory:
                    # a subtree spans owners: every member deletes its
                    # local slice (placeholders included); chunk frees
                    # stay member-local, so nothing double-frees
                    await self._fleet.broadcast("DeleteEntry", req)
            return await self._delete_local(req, path)
        finally:
            self._fleet.finish_mutation()

    async def _delete_local(self, req: dict, path: str) -> dict:
        try:
            self.filer.delete_entry(
                path,
                recursive=bool(req.get("is_recursive", False)),
                delete_chunks=bool(req.get("is_delete_data", True)),
            )
        except OSError as e:
            return {"error": str(e)}
        return {"ts_ns": self.filer.meta_log.last_ts_ns}

    async def _grpc_rename(self, req, context) -> dict:
        old = req["old_directory"].rstrip("/") + "/" + req["old_name"]
        new = req["new_directory"].rstrip("/") + "/" + req["new_name"]
        if self._follower is not None:
            return self._read_only()
        if self._fleet is None:
            try:
                self.filer.rename(old, new)
            except OSError as e:  # incl. FileNotFound/NotADirectory/self-move
                return {"error": str(e)}
            return {"ts_ns": self.filer.meta_log.last_ts_ns}
        from ..filer.fleet import dir_of

        routed = await self._fleet.admit(
            "AtomicRenameEntry", req, dir_of(old), mutation=True
        )
        if routed is not None:
            return routed
        try:
            same_owner = self._fleet.owner_for_dir(
                dir_of(new)
            ) == self._fleet.self_addr
            entry = self.filer.find_entry(old)
            if entry is None:
                return {"error": f"rename: {old} not found"}
            if entry.is_directory and not same_owner:
                # a subtree rename re-homes every child across range
                # owners at once — out of scope for the fleet plane;
                # files move via routed create + delete
                return {
                    "error": "fleet: cross-range directory rename "
                    "unsupported"
                }
            if same_owner:
                try:
                    self.filer.rename(old, new)
                except OSError as e:
                    return {"error": str(e)}
                return {"ts_ns": self.filer.meta_log.last_ts_ns}
            moved = Entry(
                full_path=new,
                attr=entry.attr,
                chunks=entry.chunks,
                extended=entry.extended,
            )
            resp = await self._fleet.forward(
                "CreateEntry",
                {"entry": moved.to_dict()},
                self._fleet.owner_for_dir(dir_of(new)),
            )
            if resp.get("error"):
                return resp
            # the chunks now belong to the new entry on the new owner
            self.filer.delete_entry(old, delete_chunks=False)
            return {"ts_ns": self.filer.meta_log.last_ts_ns}
        finally:
            self._fleet.finish_mutation()

    async def _grpc_assign_volume(self, req, context) -> dict:
        try:
            ar = await assign(
                self.master,
                count=int(req.get("count", 1)),
                collection=req.get("collection", self.collection),
                replication=req.get("replication", self.replication),
                ttl=req.get("ttl", ""),
                data_center=req.get("data_center", ""),
            )
            return {
                "file_id": ar.fid,
                "url": ar.url,
                "public_url": ar.public_url,
                "count": ar.count,
                "auth": ar.auth,  # ref AssignVolumeResponse.Auth
            }
        except Exception as e:
            return {"error": str(e)}

    async def _grpc_statistics(self, req, context) -> dict:
        return {"used_size": 0, "file_count": 0}

    async def _grpc_fleet_status(self, req, context) -> dict:
        """Fleet-plane state of THIS filer: map/epoch/range, forward and
        ingest counters, write-gate coalescing stats, and (when
        following) the replica tail — `meta.fleet.status` surfaces it."""
        out: dict = {
            "configured": self._fleet is not None,
            "address": self.address,
            "write_rounds": getattr(self.filer.store, "write_rounds", 0),
        }
        if self.write_gate is not None:
            out["write_gate"] = dict(self.write_gate.stats)
        if self._fleet is not None:
            out["fleet"] = self._fleet.status()
            out["map"] = out["fleet"]["map"]  # router convenience
        if self._follower is not None:
            out["follower"] = self._follower.status()
        return out

    async def _grpc_fleet_ingest(self, req, context) -> dict:
        if self._fleet is None:
            return {"error": "not a fleet member"}
        loop = asyncio.get_event_loop()
        try:
            # store work (range purge scans, batched inserts) off the
            # event loop: ingest pages arrive mid-move while this member
            # keeps serving its own range
            return await loop.run_in_executor(None, self._fleet.ingest, req)
        except Exception as e:
            return {"error": f"{type(e).__name__}: {e}"}

    async def _grpc_fleet_move_range(self, req, context) -> dict:
        if self._fleet is None:
            return {"error": "not a fleet member"}
        try:
            return await self._fleet.move_range(req["dst"], req["lo"], req["hi"])
        except (ValueError, TimeoutError) as e:
            return {"error": str(e)}
        except Exception as e:
            return {"error": f"{type(e).__name__}: {e}"}

    async def _grpc_subscribe_metadata(self, req, context):
        """Stream namespace change events from since_ns onward — the
        AGGREGATE stream (this filer + followed peers) when peers are
        configured (ref filer.proto:49-53 SubscribeMetadata,
        filer_grpc_server_sub_meta.go serving the MetaAggregator buffer)."""
        log = (
            self.meta_aggregator.log
            if self.meta_aggregator is not None
            else self.filer.meta_log
        )
        async for out in self._subscribe(log, req):
            yield out

    async def _grpc_subscribe_local_metadata(self, req, context):
        """Stream only THIS filer's own changes (ref
        SubscribeLocalMetadata)."""
        async for out in self._subscribe(self.filer.meta_log, req):
            yield out

    async def _subscribe(self, log, req):
        from ..filer.meta_log import MetaLogTrimmed

        since_ns = int(req.get("since_ns", 0))
        if since_ns < 0:
            # "from now" anchored to the server-side event sequence
            since_ns = log.last_ts_ns
        prefix = req.get("path_prefix", "/") or "/"
        strict = bool(req.get("strict_resume", False))
        while True:
            try:
                async for ev in log.subscribe(since_ns, prefix):
                    since_ns = ev.ts_ns
                    yield ev.to_dict()
                return
            except MetaLogTrimmed as e:
                if strict:
                    # exactly-resuming subscribers must NEVER be silently
                    # skipped past a hole: report the gap and end the
                    # stream
                    _LOG.warning(
                        "meta subscriber %r behind retention under "
                        "strict_resume: events in (%d, %d] are gone; "
                        "ending stream",
                        req.get("client_name", ""), e.since_ns,
                        e.trimmed_through,
                    )
                    yield {
                        "error": "trimmed",
                        "trimmed_through": e.trimmed_through,
                        "since_ns": e.since_ns,
                    }
                    return
                # a follower older than retention: resume past the
                # undeliverable range, loudly
                _LOG.warning(
                    "meta subscriber %r behind retention: events in "
                    "(%d, %d] are gone; resuming from there",
                    req.get("client_name", ""), e.since_ns,
                    e.trimmed_through,
                )
                since_ns = max(since_ns, e.trimmed_through)

    async def _grpc_configuration(self, req, context) -> dict:
        return {
            "masters": [self.master],
            "collection": self.collection,
            "replication": self.replication,
            "max_mb": self.chunk_size // (1024 * 1024),
            "cipher": False,
            "last_ts_ns": self.filer.meta_log.last_ts_ns,
        }
