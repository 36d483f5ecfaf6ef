"""Volume server: HTTP data plane + unary RPC admin.

HTTP (ref: weed/server/volume_server_handlers_{read,write}.go):
  GET/HEAD /{vid},{fid}[/name][.ext]  read (EC volumes with shards
                                      missing decode on the card; a
                                      chunk manifest reads as its file)
  POST/PUT /{vid},{fid}               write (`?cm=true` stores a chunk
                                      manifest, `?fsync=true` goes
                                      through the group-commit worker)
  POST     /!batch/put                many needles in one frame
  DELETE   /{vid},{fid}               delete (a manifest's chunks too)
  GET      /status, /metrics, /debug/needle_map

RPC "volume" service (pb/rpc.py; ref: weed/server/volume_grpc_*.go):
AllocateVolume, VolumeMount, VolumeUnmount, VolumeDelete,
VolumeMarkReadonly, VolumeMarkWritable, DeleteCollection, the four
Vacuum calls (VacuumVolumeCheck, Compact, Commit, Cleanup), BatchDelete,
BulkLookup, VolumeServerStatus, the CopyFile and BatchRead streams, the
EC calls of volume_ec.py, and the anti-entropy plane's VolumeScrub,
VolumeTailSync, VolumeRepairCopy, VolumeCopy, VolumeSyncStatus and the
VolumeIncrementalCopy stream.

Anti-entropy (storage/scrub.py): a forced VolumeScrub, or the
background pass every SEAWEEDFS_TPU_SCRUB_INTERVAL seconds when
SEAWEEDFS_TPU_SCRUB_MBPS is set, verifies needle CRCs and index extents
and recomputes EC parity with the server's codec (on the card, one
gf256_matmul launch a 1 MiB chunk); findings quarantine the volume
(read-only, `scrub_corrupt`) or move the shard aside to `.ecNN.bad`,
and ride the next heartbeat to the master's repair scheduler.

Heartbeat loop (ref: weed/server/volume_grpc_client_to_master.go): with
a master (`master`, the `-mserver` flag) the server keeps a bidi
SendHeartbeat stream open, carrying its full inventory at connect,
deltas each pulse and a slim refresh of each volume's garbage ratio every
five, and follows the master's leader hints. The master
then serves the shapes that need the cluster: replicated writes and
deletes fan out to the replicas it names, a read of a volume that is
not local answers 301 to its holder, and EC deletes and degraded reads
reach the other shard holders (volume_ec.py).

Ported from the JAX package's server/volume.py. One device serves the
whole server (`device`: the card unless the caller asks for the CPU): the
codec of the EC calls (kernel gf256.cu), every volume's index snapshot
for BulkLookup and `-batchLookup device` (index_search.cu) and the
arena of `-batchLookup arena` (ragged_lookup.cu). A device failure
reaches the client as a 500 (an `{"error": ...}` reply over RPC) and is
counted in `device_errors` and `seaweedfs_tpu_device_errors_total`; it
is never served around from the host.

One HTTP server answers every request (util/fasthttp.py): where the JAX
package's fast tier hands a shape to its aiohttp application, the port
serves it here, with the same status codes, bodies, Etags and
Content-Range. A chunked file's GET is assembled whole (the port's HTTP
tier writes each response as one piece) from the chunks its range
covers, local ones through the lookup gate when the server has one.
`/ui` answers 501 `{"error": "not ported: ..."}`. Not ported either:
tiering and the lifecycle RPCs, the Query and tier-move streams, and the
overload admission gate and tenancy: `/!batch/put` reads a tenant-tagged
frame but charges no quota. The fault plane's seams (util/faults.py) are
the JAX package's: the disk (storage/backend.py), the RPC and HTTP
clients and the HTTP server (server/serving_core.py).
"""

from __future__ import annotations

import asyncio
import functools as _functools
import gzip
import json
import logging
import os
import struct
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional
from urllib.parse import parse_qsl

from ..pb import grpc_address
from ..pb.rpc import EOF, Service, Stub, serve
from ..storage import vacuum as vacuum_mod
from ..storage.file_id import FileId
from ..storage.group_commit import GroupCommitWorker
from ..storage.needle import Needle, NotFoundError
from ..storage.store import Store
from ..storage.volume import AlreadyDeleted, CookieMismatch, NotFound, Volume
from ..util import metrics
from ..util.fasthttp import (
    DETACHED,
    JSON_FULL,
    FastHTTPClient,
    build_multipart,
    fast_tier_json,
    finish_detached,
    parse_multipart,
    render_response,
)
from ..util.http_range import parse_range
from .serving_core import ServingCore, json_body, not_ported
from .volume_ec import EcHandlers

_LOG = logging.getLogger(__name__)

_NEEDS_FULL_PATH = object()  # needle shape the byte-level read path defers

# pre-assembled response head for the common read shape (no
# Last-Modified). %08x of the u32 checksum == u32_to_bytes(checksum).hex().
_HEAD_200 = (
    b"HTTP/1.1 200 OK\r\n"
    b"Content-Type: %b\r\n"
    b"Content-Length: %d\r\n"
    b'Etag: "%08x"\r\n'
    b"Accept-Ranges: bytes\r\n"
    b"Connection: keep-alive\r\n\r\n"
)

_NOT_FOUND = b'{"error": "not found"}'

# hot-needle cache sizing: 64 MiB (the reference's default), entry bodies
# capped so one large blob cannot monopolize the LRU
READ_CACHE_BYTES_CAP = 64 << 20
READ_CACHE_MAX_ENTRY = 128 * 1024

BATCH_LOOKUP_MODES = ("off", "auto", "host", "device", "arena")
CODEC_BACKENDS = ("cuda", "cpu", "numpy")


class HotNeedleCache:
    """Byte-bounded LRU of whole small needle responses keyed by
    (vid, key), ported from the JAX package (server/volume.py:81). A hit
    is served only while the SAME Volume object is mounted and its live
    map still points the key at the same (offset_units, size): the .dat is
    append-only, so an unchanged location means unchanged bytes, and hits
    are byte-identical to uncached reads. TTL'd needles are never
    cached."""

    def __init__(self, capacity_bytes: int = READ_CACHE_BYTES_CAP,
                 max_entry: int = READ_CACHE_MAX_ENTRY):
        import threading
        import weakref
        from collections import OrderedDict

        self.capacity = capacity_bytes
        self.max_entry = max_entry
        # (vid, key) -> (vol_ref, cookie, offset_units, size, resp, head_len)
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self._weakref = weakref.ref

    def get(self, v, vid: int, key: int, cookie: int, head_only: bool):
        """The response bytes for a cached needle, or None. `v` is the
        currently mounted Volume the caller resolved for vid."""
        k = (vid, key)
        with self._lock:
            e = self._entries.get(k)
            if e is not None:
                self._entries.move_to_end(k)
        if e is None or e[1] != cookie:
            # a wrong cookie is the request's, not staleness: the
            # uncached path owns the 404 and the entry stays
            return None
        vol_ref, _cookie, offset_units, size, resp, head_len = e
        if vol_ref() is not v or v.locate_live(key) != (offset_units, size):
            with self._lock:
                if self._entries.get(k) is e:
                    del self._entries[k]
                    self._bytes -= len(resp)
            return None
        return resp[:head_len] if head_only else resp

    def put(self, v, vid: int, n, offset_units: int, size: int, resp: bytes,
            head_len: int) -> None:
        """Admit one rendered simple-shape GET response."""
        if len(resp) > self.max_entry or n.has_ttl():
            return
        k = (vid, n.id)
        entry = (self._weakref(v), n.cookie, offset_units, size, bytes(resp),
                 head_len)
        with self._lock:
            old = self._entries.pop(k, None)
            if old is not None:
                self._bytes -= len(old[4])
            self._entries[k] = entry
            self._bytes += len(resp)
            while self._bytes > self.capacity and self._entries:
                _k, e = self._entries.popitem(last=False)
                self._bytes -= len(e[4])

    def invalidate_key(self, vid: int, key: int) -> None:
        with self._lock:
            e = self._entries.pop((vid, key), None)
            if e is not None:
                self._bytes -= len(e[4])

    def invalidate_volume(self, vid: int) -> None:
        with self._lock:
            for k in [k for k in self._entries if k[0] == vid]:
                self._bytes -= len(self._entries.pop(k)[4])


def _parse_fid_path_cached(path: str):
    """Pure fid-path parse, memoized for the hot path (FileId is frozen).
    Long paths bypass the cache: keys are client-controlled."""
    if len(path) > 96:
        return _parse_fid_path_impl(path)
    return _parse_fid_path_lru(path)


@_functools.lru_cache(maxsize=131072)
def _parse_fid_path_lru(path: str):
    return _parse_fid_path_impl(path)


def _parse_fid_path_impl(path: str):
    parts = path.lstrip("/").split("/")
    fid_part = parts[0]
    if "," not in fid_part and len(parts) > 1:
        # /vid/fid[/filename] form
        fid_part = parts[0] + "," + parts[1]
        filename = parts[2] if len(parts) > 2 else ""
    else:
        filename = parts[1] if len(parts) > 1 else ""
    ext = ""
    if "." in fid_part:
        fid_part, _, tail = fid_part.rpartition(".")
        ext = "." + tail
    if not ext and "." in filename:
        ext = "." + filename.rsplit(".", 1)[1]
    return FileId.parse(fid_part), filename, ext


def _decode_keys(req: dict):
    """BulkLookup probe keys: <u8-LE bytes or list[int] -> u64[P]."""
    import numpy as np

    raw = req.get("keys", b"")
    if isinstance(raw, (bytes, bytearray)):
        return np.frombuffer(raw, dtype="<u8").astype(np.uint64)
    return np.asarray(raw, dtype=np.uint64)


def _query(req) -> dict:
    """The first value of each query parameter, as aiohttp's
    `request.query.get` reads it."""
    out: dict = {}
    for k, v in parse_qsl(req.query, keep_blank_values=True):
        out.setdefault(k, v)
    return out


def _header(req, name: bytes) -> str:
    return req.headers.get(name, b"").decode("latin1")


def _json(
    status: int, obj, head_only: bool = False, content_type: bytes = JSON_FULL
) -> bytes:
    """A JSON answer, by default with the Content-Type of the JAX server's
    aiohttp application, which serves every request shape its fast tier
    hands on (a query, a Range, a bad file id, DELETE, the errors); the
    fast tier's own answers pass JSON_FAST."""
    return render_response(status, json_body(obj), head_only=head_only,
                           content_type=content_type)


def _head_response(length: int, content_type: bytes, extra: bytes) -> bytes:
    """A 200 answer to HEAD whose Content-Length is what a GET would send
    (a chunked file's size, not fetched for a HEAD)."""
    return b"".join((
        b"HTTP/1.1 200 OK\r\nContent-Type: ", content_type,
        b"\r\nContent-Length: %d\r\n" % length, extra,
        b"Connection: keep-alive\r\n\r\n",
    ))


class _ChunkReadFailed(Exception):
    """A local chunk's lookup answered 404 or 500 (a failed device
    probe): the chunked file's GET answers with that response."""

    def __init__(self, response: bytes):
        super().__init__("chunk lookup failed")
        self.response = response


def _make_needle_map_debug(store, arena=None, gate=None, errors=None):
    """/debug/needle_map: per-volume and aggregate bloom-filter economics
    of every LSM map, the arena's residency and dispatch counters, the
    gate's device-versus-host counters and the device errors (a closure
    over leaf state, as in the JAX package)."""

    async def handler(req):
        per_volume = {}
        agg = {"runs": 0, "runs_with_filter": 0, "probes": 0,
               "negatives": 0}
        for loc in store.locations:
            for vid, v in list(loc.volumes.items()):
                stats_fn = getattr(v.nm, "bloom_stats", None)
                if stats_fn is None:
                    continue
                st = stats_fn()
                per_volume[str(vid)] = st
                for k in agg:
                    agg[k] += st.get(k, 0)
        agg["filter_hit_rate"] = (
            round(agg["negatives"] / agg["probes"], 4)
            if agg["probes"] else 0.0
        )
        body = {
            "kind": store.needle_map_kind,
            "aggregate": agg,
            "volumes": per_volume,
        }
        if arena is not None:
            body["device"] = arena.stats()
        if gate is not None:
            body["gate"] = dict(gate.stats)
            body["gate_batch_hist"] = {
                str(k): v for k, v in sorted(gate.batch_hist.items())
            }
        if errors is not None:
            body["device_errors"] = dict(errors)
        return _json(200, body, head_only=req.method == "HEAD")

    return handler


class VolumeServer(EcHandlers):
    def __init__(
        self,
        directories: list[str],
        host: str = "127.0.0.1",
        port: int = 8080,
        max_volume_counts: Optional[list[int]] = None,
        codec_backend: str = "cuda",
        device=None,
        jwt_signing_key: str = "",
        needle_map_kind: str = "memory",
        white_list: tuple = (),
        batch_lookup: str = "off",
        master="",
        public_url: str = "",
        pulse_seconds: float = 1.0,
        data_center: str = "",
        rack: str = "",
    ):
        """`device` None follows `codec_backend`: the card for "cuda",
        the CPU (the plain versions) for "cpu" and "numpy". The card is
        never optional once asked for: without CUDA this raises.
        `master` (a host:port or a list of them, the seed masters) starts
        the heartbeat; "" runs the server alone, as a volume server whose
        volumes load from its directories."""
        from ..ops.gf256 import resolve_device
        from ..util.security import Guard

        if codec_backend == "adaptive":
            raise NotImplementedError(
                "not ported: storage backend 'adaptive' (the native host "
                "codec and its selection come with a later slice)"
            )
        if codec_backend not in CODEC_BACKENDS:
            raise ValueError(
                f"unknown storage backend {codec_backend!r} "
                f"(want one of {', '.join(CODEC_BACKENDS)})"
            )
        batch_lookup = batch_lookup or "off"
        if batch_lookup not in BATCH_LOOKUP_MODES:
            raise ValueError(
                f"unknown batch lookup mode {batch_lookup!r} "
                f"(want one of {', '.join(BATCH_LOOKUP_MODES)})"
            )
        if device is None:
            device = "cuda" if codec_backend == "cuda" else "cpu"
        self.device = resolve_device(device)
        self.jwt_signing_key = jwt_signing_key
        self.guard = Guard(
            white_list=tuple(white_list), signing_key=jwt_signing_key
        )
        self.host = host
        self.port = port
        self.address = f"{host}:{port}"
        self.public_url = public_url or self.address
        # seed master list with failover + leader-hint following
        # (ref volume_grpc_client_to_master.go:35-57)
        self.masters = [master] if isinstance(master, str) else list(master)
        self.masters = [m for m in self.masters if m]
        self.master = self.masters[0] if self.masters else ""
        self.pulse_seconds = pulse_seconds
        self.data_center = data_center
        self.rack = rack
        self.codec_backend = codec_backend
        self.store = Store(
            directories,
            max_volume_counts or [7] * len(directories),
            needle_map_kind=needle_map_kind,
            device=self.device,
            ip=host,
            port=port,
            public_url=self.public_url,
        )
        self.store.load()
        self._core: Optional[ServingCore] = None
        self._rpc_server = None
        self._heartbeat_task: Optional[asyncio.Task] = None
        self._http_client: Optional[FastHTTPClient] = None
        self._shutdown = False
        self._replica_loc_cache: dict[int, tuple[float, list]] = {}
        self._codec = None
        # anti-entropy plane: background scrubber (rate-shaped by
        # SEAWEEDFS_TPU_SCRUB_MBPS; 0 = no background pass, scrubs run
        # only when forced via VolumeScrub / the volume.scrub command)
        self.scrub_mbps = float(
            os.environ.get("SEAWEEDFS_TPU_SCRUB_MBPS", "0") or 0
        )
        self.scrub_interval_seconds = float(
            os.environ.get("SEAWEEDFS_TPU_SCRUB_INTERVAL", "300") or 300
        )
        self._scrubber = None
        self._scrub_task: Optional[asyncio.Task] = None
        # DETACHED reads finished through the full path (the loop keeps
        # tasks only weakly)
        self._tasks: set = set()
        # blocking device work (EC generate and rebuild, BulkLookup,
        # degraded-read decodes) runs here, off the event loop; the
        # codec keeps one CUDA stream per worker thread
        self._executor = ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="volume-device"
        )
        # requests answered 500 because device work raised, by operation
        self.device_errors: dict = {}
        self.lookup_gate = None
        self.lookup_arena = None
        if batch_lookup == "arena":
            from ..ops.ragged_lookup import DeviceColumnArena
            from .lookup_gate import BatchLookupGate

            # the server's own arena on its device (closed by stop())
            self.lookup_arena = DeviceColumnArena(device=self.device)
            self.lookup_gate = BatchLookupGate(
                self.store, arena=self.lookup_arena
            )
        elif batch_lookup != "off":
            from .lookup_gate import BatchLookupGate

            self.lookup_gate = BatchLookupGate(
                self.store,
                use_device={"auto": None, "host": False, "device": True}[
                    batch_lookup
                ],
            )
        self.read_cache = HotNeedleCache()
        # vid -> the group-commit worker of its ?fsync=true writes and
        # /!batch/put frames, started on first use
        self._group_committers: dict[int, GroupCommitWorker] = {}
        # vid -> set when its vacuum commit has swapped the new volume in:
        # the commit closes the old volume before the new one opens, so a
        # read of it waits (the reference's reads wait on the volume's
        # lock the same way, volume_vacuum.go CommitCompact)
        self._commits: dict[int, asyncio.Event] = {}

    def make_codec(self, data_shards: int = 10, parity_shards: int = 4):
        """A codec of this server's backend and device."""
        if self.codec_backend == "cuda":
            from ..ops.rs_kernel import CudaRSCodec

            return CudaRSCodec(data_shards, parity_shards, device=self.device)
        from ..gpu.coder import get_codec

        return get_codec(self.codec_backend, data_shards, parity_shards)

    @property
    def codec(self):
        if self._codec is None:
            self._codec = self.make_codec()
        return self._codec

    async def _group_committer(self, vid: int) -> GroupCommitWorker:
        """vid's worker on the volume the store holds once no vacuum
        commit is in flight. A worker pinned to a volume the store no
        longer holds is retired and replaced, so no write or delete goes
        to a volume a commit closed."""
        while True:
            await self._wait_commit(vid)
            v = self.store.find_volume(vid)
            if v is None:
                raise LookupError(f"volume {vid} not found")
            gc = self._group_committers.get(vid)
            if gc is None:
                gc = GroupCommitWorker(v)
                gc.start()
                self._group_committers[vid] = gc
            if gc.volume is v:
                return gc
            await self._retire_group_committer(vid)

    async def _retire_group_committer(self, vid: int) -> None:
        """Stop vid's worker: it is pinned to the volume object a swap
        closes (the next write starts a worker on the new one)."""
        gc = self._group_committers.pop(vid, None)
        if gc is not None:
            await gc.stop()

    def note_device_error(self, op: str, exc: BaseException) -> None:
        """Count a request that failed because device work raised."""
        self.device_errors[op] = self.device_errors.get(op, 0) + 1
        metrics.DEVICE_ERRORS.inc(operation=op)
        _LOG.warning("volume server %s: device work failed: %s: %s",
                     op, type(exc).__name__, exc)

    async def run_blocking(self, fn, *args):
        """Run blocking (device or disk) work on the server's executor."""
        return await asyncio.get_running_loop().run_in_executor(
            self._executor, fn, *args
        )

    # ---------------- lifecycle ----------------
    async def start(self) -> None:
        self._core = ServingCore(
            "volume", self._dispatch, self.host, self.port,
            debug_handlers={
                "/debug/needle_map": _make_needle_map_debug(
                    self.store,
                    arena=self.lookup_arena,
                    gate=self.lookup_gate,
                    errors=self.device_errors,
                )
            },
        )
        await self._core.start()
        svc = Service("volume")
        svc.unary("AllocateVolume")(self._grpc_allocate_volume)
        svc.unary("VolumeMount")(self._grpc_volume_mount)
        svc.unary("VolumeUnmount")(self._grpc_volume_unmount)
        svc.unary("VolumeDelete")(self._grpc_volume_delete)
        svc.unary("VolumeMarkReadonly")(self._grpc_volume_mark_readonly)
        svc.unary("VolumeMarkWritable")(self._grpc_volume_mark_writable)
        svc.unary("DeleteCollection")(self._grpc_delete_collection)
        svc.unary("VacuumVolumeCheck")(self._grpc_vacuum_check)
        svc.unary("VacuumVolumeCompact")(self._grpc_vacuum_compact)
        svc.unary("VacuumVolumeCommit")(self._grpc_vacuum_commit)
        svc.unary("VacuumVolumeCleanup")(self._grpc_vacuum_cleanup)
        svc.unary("BatchDelete")(self._grpc_batch_delete)
        svc.unary("BulkLookup")(self._grpc_bulk_lookup)
        svc.unary("VolumeServerStatus")(self._grpc_status)
        svc.server_stream("CopyFile")(self._grpc_copy_file)
        svc.server_stream("BatchRead")(self._grpc_batch_read)
        svc.unary("VolumeCopy")(self._grpc_volume_copy)
        svc.server_stream("VolumeIncrementalCopy")(self._grpc_incremental_copy)
        svc.unary("VolumeSyncStatus")(self._grpc_sync_status)
        svc.unary("VolumeScrub")(self._grpc_volume_scrub)
        svc.unary("VolumeTailSync")(self._grpc_volume_tail_sync)
        svc.unary("VolumeRepairCopy")(self._grpc_volume_repair_copy)
        self.register_ec_rpcs(svc)
        self._rpc_server = await serve(grpc_address(self.address), svc)
        self._http_client = FastHTTPClient()
        if self.master:
            self._heartbeat_task = asyncio.ensure_future(
                self._heartbeat_loop()
            )
        if self.scrub_mbps > 0:
            self._scrub_task = asyncio.ensure_future(self._scrub_loop())

    async def stop(self) -> None:
        """End the scrub loop and the heartbeat (the master unregisters
        this server), close the gate (its waiters get an error), the RPC and HTTP sockets with
        their connections, the executor, the arena and the store."""
        self._shutdown = True
        for task in (self._scrub_task, self._heartbeat_task):
            if task is None:
                continue
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
        if self.lookup_gate is not None:
            self.lookup_gate.close()
        for vid in list(self._group_committers):
            await self._retire_group_committer(vid)
        if self._rpc_server is not None:
            await self._rpc_server.stop()
        if self._core is not None:
            await self._core.stop()
        if self._http_client is not None:
            await self._http_client.close()
        await asyncio.to_thread(self._executor.shutdown, True)
        if self.lookup_arena is not None:
            self.lookup_arena.close()
        self.store.close()

    # ---------------- heartbeat (ref volume_grpc_client_to_master.go) ----------------
    def _rotate_master(self) -> None:
        if self.master in self.masters:
            i = self.masters.index(self.master)
            self.master = self.masters[(i + 1) % len(self.masters)]
        else:
            self.master = self.masters[0]

    async def _heartbeat_loop(self) -> None:
        while not self._shutdown:
            try:
                await self._heartbeat_once()
                # stream ended cleanly (e.g. a leader hint switched
                # self.master): redial after half a pulse
                await asyncio.sleep(self.pulse_seconds / 2)
            except asyncio.CancelledError:
                return
            except Exception:
                # current master unreachable: rotate through the seeds
                self._rotate_master()
                await asyncio.sleep(self.pulse_seconds)

    async def _heartbeat_once(self) -> None:
        stub = Stub(grpc_address(self.master), "master")
        call = stub.bidi_stream("SendHeartbeat")

        # replies are drained by their own task: a read bounded by a
        # timeout would end the stream on every quiet pulse
        async def reader() -> None:
            while True:
                resp = await call.read()
                if resp is EOF:
                    return
                if not isinstance(resp, dict):
                    continue
                if "leader" in resp:
                    leader = resp.get("leader")
                    if leader and leader != self.master:
                        # follow the leader hint; the redial targets it
                        if leader not in self.masters:
                            self.masters.append(leader)
                        self.master = leader
                        return
                    if not leader:
                        # no known leader (deposed or mid-election)
                        self._rotate_master()
                        return

        reader_task = asyncio.ensure_future(reader())
        try:
            hb = self.store.collect_heartbeat()
            hb["data_center"] = self.data_center
            hb["rack"] = self.rack
            hb.update(self.store.collect_ec_heartbeat())
            await call.write(hb)
            tick = 0
            while not self._shutdown:
                await asyncio.sleep(self.pulse_seconds)
                if reader_task.done():
                    break  # master closed the stream; reconnect
                tick += 1
                deltas = self.store.drain_deltas()
                hb = {"ip": self.host, "port": self.port}
                if any(deltas.values()):
                    hb.update({k: v for k, v in deltas.items() if v})
                if tick % 17 == 0:
                    # periodic full EC state (ref :121, EC tick = 17 pulses)
                    hb.update(self.store.collect_ec_heartbeat())
                if tick % 5 == 0:
                    # slim refresh of the digest, frontier, garbage ratio
                    # and quarantine flag, so the master's repair and
                    # vacuum planners compare CURRENT values, not the ones
                    # frozen at stream connect
                    hb["volume_digests"] = self.store.collect_volume_digests()
                await call.write(hb)
        finally:
            reader_task.cancel()
            call.cancel()

    # ---------------- HTTP dispatch ----------------
    async def _dispatch(self, req):
        method = req.method
        path = req.path
        head_only = method == "HEAD"
        if path == "/status":
            return _json(200, {"Version": "seaweedfs-tpu", "Volumes": []},
                         head_only=head_only)
        if path in ("/ui", "/ui/"):
            return not_ported("the /ui status page", head_only=head_only)
        if method in ("GET", "HEAD"):
            return await self._answer(self._read(req), head_only)
        if method in ("POST", "PUT"):
            if path == "/!batch/put":
                return await self._batch_put(req)
            return await self._answer(self._write(req))
        if method == "DELETE":
            return await self._answer(self._delete(req))
        return _json(405, {"error": "method not allowed"})

    @staticmethod
    async def _answer(handler, head_only: bool = False):
        """Await a handler, answering the errors it raises as the JAX
        package's `_dispatch_inner` does."""
        try:
            return await handler
        except (NotFound, NotFoundError, AlreadyDeleted, LookupError) as e:
            return _json(404, {"error": str(e)}, head_only)
        except ValueError as e:
            # unparsable file id (ref volume_server_handlers_read.go:35-39)
            return _json(400, {"error": str(e)}, head_only)
        except CookieMismatch as e:
            return _json(403, {"error": str(e)}, head_only)

    def _parse_fid_path(self, path: str) -> tuple[FileId, str, str]:
        return _parse_fid_path_cached(path)

    # ---------------- read (ref volume_server_handlers_read.go) ----------------
    async def _read(self, req):
        """The byte-level path for the plain shape (no query, no Range, a
        local volume), the full path for every other one."""
        h = req.headers
        if (
            not req.query
            and req.path
            and req.path != "/"
            and "debug" not in req.path
            and b"range" not in h
            and b"if-range" not in h
        ):
            try:
                fid, _filename, _ext = self._parse_fid_path(req.path)
            except Exception:
                fid = None
            if fid is not None:
                await self._wait_commit(fid.volume_id)
                v = self.store.find_volume(fid.volume_id)
                if v is not None:
                    out = self._fast_read(req, v, fid)
                    if out is not _NEEDS_FULL_PATH:
                        return out
        return await self._handle_read(req)

    async def _wait_commit(self, vid: int) -> None:
        ev = self._commits.get(vid)
        if ev is not None:
            await ev.wait()

    def _vacuum_swapping(self, vid: int, v) -> bool:
        """True while `v` is a volume a vacuum commit closes or closed: a
        read of it that failed must wait for the commit and read the new
        volume instead of answering 404 or 500."""
        return vid in self._commits or self.store.find_volume(vid) is not v

    def _fast_read(self, req, v, fid):
        head_only = req.method == "HEAD"
        vid = fid.volume_id
        cache = self.read_cache
        out = cache.get(v, vid, fid.key, fid.cookie, head_only)
        if out is not None:
            return out
        if self.lookup_gate is not None:
            # batched serving path: the index probe joins the gate's
            # wakeup, and the whole continuation (pread -> render ->
            # socket write) runs inside the flush callback
            def done(loc, exc) -> None:
                out = self._render_gated(v, vid, fid, head_only, loc, exc)
                if out is None:  # compressed or manifest: the full path
                    self._detach_full_read(req)
                else:
                    self._core.count(req.method)
                    finish_detached(req, out)

            self.lookup_gate.lookup_cb(vid, fid.key, done)
            return DETACHED
        try:
            n, off_units, size = v.read_needle_by_key_located(fid.key)
        except (NotFound, NotFoundError, AlreadyDeleted, LookupError):
            if self._vacuum_swapping(vid, v):
                return _NEEDS_FULL_PATH
            return render_response(404, _NOT_FOUND, head_only=head_only)
        except Exception:
            return _NEEDS_FULL_PATH
        out = self._render_needle(n, fid, head_only)
        if out is _NEEDS_FULL_PATH:
            return out
        self._maybe_cache_fill(cache, v, vid, fid, n, off_units, size, out,
                               head_only)
        return out

    def _detach_full_read(self, req) -> None:
        """Finish a DETACHED read through the full path."""

        async def run() -> None:
            try:
                out = await self._answer(self._handle_read(req),
                                         req.method == "HEAD")
            except Exception:
                out = _json(500, {"error": "internal error"})
            self._core.count(req.method)
            finish_detached(req, out)

        t = asyncio.ensure_future(run())
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)

    def _maybe_cache_fill(self, cache, v, vid, fid, n, off_units, size, out,
                          head_only) -> None:
        if (
            head_only
            or n.last_modified
            or n.cookie != fid.cookie
            or n.is_chunked_manifest()
            or n.is_compressed()
        ):
            return
        cache.put(v, vid, n, off_units, size, out, len(out) - len(n.data))

    def _render_gated(self, v, vid, fid, head_only, loc, exc):
        """Response bytes for a gated read, run inside the gate's flush;
        None for a shape the full path renders."""
        try:
            if exc is not None:
                if self._vacuum_swapping(vid, v):
                    return None  # the full path waits for the commit
                if isinstance(exc, LookupError):
                    return render_response(404, _NOT_FOUND,
                                           head_only=head_only)
                self.note_device_error("read", exc)
                return render_response(
                    500, b'{"error": "lookup failed"}', head_only=head_only
                )
            if loc is None:
                return render_response(404, _NOT_FOUND, head_only=head_only)
            offset_units, size = loc
            n = Needle(id=fid.key)
            stale = False
            try:
                if size > 0:
                    n = v.read_needle_at(offset_units, size)
                stale = size > 0 and (n.cookie != fid.cookie
                                      or n.id != fid.key)
            except Exception:
                stale = True
            if stale:
                if self._vacuum_swapping(vid, v):
                    return None  # the full path waits for the commit
                # the .dat may have changed between probe and pread; the
                # locked per-request path is atomic
                n = Needle(id=fid.key)
                self.store.read_volume_needle(vid, n)
            out = self._render_needle(n, fid, head_only)
            if out is _NEEDS_FULL_PATH:
                return None
            if not stale:
                self._maybe_cache_fill(self.read_cache, v, vid, fid, n,
                                       offset_units, size, out, head_only)
            return out
        except (NotFound, NotFoundError, AlreadyDeleted, LookupError):
            if self._vacuum_swapping(vid, v):
                return None
            return render_response(404, _NOT_FOUND, head_only=head_only)
        except Exception:
            if self._vacuum_swapping(vid, v):
                return None
            return render_response(
                500, b'{"error": "internal error"}', head_only=head_only
            )

    def _render_needle(self, n, fid, head_only):
        if n.cookie != fid.cookie:
            return render_response(
                404, b'{"error": "cookie mismatch"}', head_only=head_only,
            )
        if n.is_chunked_manifest() or n.is_compressed():
            return _NEEDS_FULL_PATH
        ctype = bytes(n.mime) if n.mime else b"application/octet-stream"
        if not n.last_modified:
            head = _HEAD_200 % (ctype, len(n.data), n.checksum & 0xFFFFFFFF)
            return head if head_only else b"".join((head, n.data))
        extra = b'Etag: "%s"\r\nAccept-Ranges: bytes\r\n' % n.etag().encode()
        extra += b"Last-Modified-Ts: %d\r\n" % n.last_modified
        return render_response(
            200, n.data, content_type=ctype, extra=extra,
            head_only=head_only,
        )

    async def _handle_read(self, req):
        head_only = req.method == "HEAD"
        fid, _filename, ext = self._parse_fid_path(req.path)
        vid = fid.volume_id
        q = _query(req)
        if self.store.has_volume(vid):
            n = await self._read_mounted(vid, fid, head_only)
            if isinstance(n, bytes):
                return n  # the gate's 404, or a device error's 500
            if n.cookie != fid.cookie:
                return _json(404, {"error": "cookie mismatch"}, head_only)
            if n.is_chunked_manifest() and q.get("cm") != "false":
                return await self._chunked_manifest_response(req, q, n, ext)
            return self._needle_response(req, q, n, ext)

        ev = self.store.find_ec_volume(vid)
        if ev is not None:
            try:
                n = await self.read_ec_needle(ev, fid.key)
            except Exception as e:
                self.note_device_error("ec_read", e)
                return _json(500, {"error": f"{type(e).__name__}: {e}"},
                             head_only)
            if n is None:
                return _json(404, {"error": "not found"}, head_only)
            if n.cookie != fid.cookie:
                return _json(404, {"error": "cookie mismatch"}, head_only)
            if n.is_chunked_manifest() and q.get("cm") != "false":
                return await self._chunked_manifest_response(req, q, n, ext)
            return self._needle_response(req, q, n, ext)
        # not local: redirect via a master lookup (ref :41-53)
        result = await self._lookup_volume(vid)
        if result:
            url = result[0]
            if url != self.address and url != self.public_url:
                return render_response(
                    301, b"", content_type=b"text/plain",
                    extra=f"Location: http://{url}{req.target}\r\n".encode(),
                    head_only=head_only,
                )
        return _json(404, {"error": "volume not found"}, head_only)

    async def _read_mounted(self, vid: int, fid: FileId, head_only: bool):
        """`_read_local` of a mounted volume, across a vacuum commit that
        swaps the volume mid-read."""
        await self._wait_commit(vid)
        v = self.store.find_volume(vid)
        try:
            return await self._read_local(v, vid, fid, head_only)
        except Exception:
            if not self._vacuum_swapping(vid, v):
                raise
            # a commit closed this volume mid-read: read the new one
            await self._wait_commit(vid)
            n = Needle(id=fid.key)
            self.store.read_volume_needle(vid, n)
            return n

    async def _read_local(self, v, vid: int, fid: FileId, head_only: bool):
        """The needle of a local volume, or the response bytes of a gate
        lookup that found nothing or failed."""
        n = Needle(id=fid.key)
        if self.lookup_gate is None or v is None:
            self.store.read_volume_needle(vid, n)
            return n
        try:
            loc = await self.lookup_gate.lookup(vid, fid.key)
        except LookupError:
            raise
        except Exception as e:
            if self._vacuum_swapping(vid, v):
                raise
            self.note_device_error("read", e)
            return _json(500, {"error": "lookup failed"}, head_only)
        if loc is None:
            if self._vacuum_swapping(vid, v):
                raise NotFound(f"needle {fid.key} not found")
            return _json(404, {"error": "not found"}, head_only)
        offset_units, size = loc
        try:
            if size > 0:
                n = v.read_needle_at(offset_units, size)
            stale = size > 0 and (n.cookie != fid.cookie or n.id != fid.key)
        except Exception:
            stale = True
        if stale:
            n = Needle(id=fid.key)
            self.store.read_volume_needle(vid, n)
        return n

    def _needle_response(self, req, q: dict, n: Needle, ext: str = "") -> bytes:
        from .. import images

        head_only = req.method == "HEAD"
        etag = f'"{n.etag()}"'
        extra = [f"Etag: {etag}", "Accept-Ranges: bytes"]
        if n.last_modified:
            extra.append(f"Last-Modified-Ts: {n.last_modified}")
        width, height, mode, do_resize = images.should_resize(ext, q)
        body = bytes(n.data)
        encoded = False
        if n.is_compressed():
            # resize requires plaintext regardless of what the client
            # accepts (ref volume_server_handlers_read.go:210-238)
            if "gzip" in _header(req, b"accept-encoding") and not do_resize:
                extra.append("Content-Encoding: gzip")
                encoded = True
            else:
                body = gzip.decompress(body)
        ctype = bytes(n.mime) if n.mime else b"application/octet-stream"
        if do_resize:
            body, _, _ = images.resized(ext, body, width, height, mode)

        def respond(status: int, payload: bytes, lines: list) -> bytes:
            hdrs = "".join(f"{ln}\r\n" for ln in lines).encode("latin1")
            return render_response(status, payload, content_type=ctype,
                                   extra=hdrs, head_only=head_only)

        if head_only:
            return respond(200, body, extra)
        # single-range requests (ref http.ServeContent); an unparsable
        # Range header is ignored per RFC 9110. The gzip representation is
        # never sliced: its ETag is shared with the identity variant.
        if encoded:
            return respond(200, body, extra)
        if_range = _header(req, b"if-range")
        if if_range and if_range != etag:
            return respond(200, body, extra)
        from ..util.http_range import parse_range

        span = parse_range(_header(req, b"range"), len(body))
        if span == "invalid-range":
            return render_response(
                416, b"", content_type=None,
                extra=b"Content-Range: bytes */%d\r\n" % len(body),
            )
        if span is not None:
            start, end = span
            return respond(
                206, body[start:end + 1],
                extra + [f"Content-Range: bytes {start}-{end}/{len(body)}"],
            )
        return respond(200, body, extra)

    # ---------------- chunked-file manifests ----------------
    @staticmethod
    def _load_manifest(n: Needle) -> dict:
        """Manifest JSON from a cm-flagged needle
        (ref: operation/chunked_file.go LoadChunkManifest)."""
        body = bytes(n.data)
        if n.is_compressed():
            body = gzip.decompress(body)
        m = json.loads(body)
        m["chunks"] = sorted(m.get("chunks", []), key=lambda c: c["offset"])
        return m

    async def _fetch_chunk(
        self, fid: str, start: int = 0, end: Optional[int] = None
    ) -> bytes:
        """Bytes [start, end] (inclusive; None = to the end) of one chunk
        needle: the local store first (through the lookup gate when the
        server has one), else via a master lookup with the range
        forwarded so only the needed slice crosses the network."""
        f = FileId.parse(fid)
        vid = f.volume_id
        if self.store.has_volume(vid):
            n = await self._read_mounted(vid, f, False)
            if isinstance(n, bytes):
                raise _ChunkReadFailed(n)  # the gate's 404 or 500
            if n.cookie != f.cookie:
                raise LookupError(f"chunk {fid}: cookie mismatch")
            body = bytes(n.data)
            if n.is_compressed():
                body = gzip.decompress(body)
            return body[start : None if end is None else end + 1]
        locs = await self._lookup_volume(vid)
        if not locs:
            raise LookupError(f"chunk {fid}: volume not found")
        headers = None
        if start != 0 or end is not None:
            headers = {
                "Range": f"bytes={start}-{'' if end is None else end}"
            }
        status, body, _head = await self._http_client.request_full(
            "GET", locs[0], "/" + fid, headers=headers
        )
        if status not in (200, 206):
            raise LookupError(f"chunk {fid}: status {status}")
        if status == 200 and headers:
            # the server ignored the range: slice locally
            body = body[start : None if end is None else end + 1]
        return body

    async def _chunked_manifest_response(
        self, req, q: dict, n: Needle, ext: str = ""
    ) -> bytes:
        """Resolve a chunk manifest into file bytes, honoring single ranges
        by fetching only the chunks they cover
        (ref: volume_server_handlers_read.go:170-207 tryHandleChunkedFile)."""
        try:
            manifest = self._load_manifest(n)
        except (ValueError, KeyError, TypeError, OSError):
            # unreadable manifest: serve the raw needle (ref
            # tryHandleChunkedFile returns false on a load error)
            return self._needle_response(req, q, n, ext)
        total = int(manifest.get("size", 0))
        ctype = (manifest.get("mime") or "application/octet-stream").encode(
            "latin1"
        )
        extra = (b"Accept-Ranges: bytes\r\nX-File-Store: chunked\r\n"
                 b'Etag: "%s"\r\n' % n.etag().encode())
        if req.method == "HEAD":
            return _head_response(total, ctype, extra)
        span = parse_range(_header(req, b"range"), total)
        if span == "invalid-range":
            return render_response(
                416, b"", content_type=None,
                extra=b"Content-Range: bytes */%d\r\n" % total,
            )
        start, end = span if span is not None else (0, total - 1)
        parts = []
        try:
            for c in manifest["chunks"]:
                c_start, c_size = int(c["offset"]), int(c["size"])
                c_end = c_start + c_size - 1
                if c_end < start or c_start > end:
                    continue
                lo = max(start, c_start) - c_start
                hi = min(end, c_end) - c_start
                parts.append(await self._fetch_chunk(c["fid"], lo, hi))
        except _ChunkReadFailed as e:
            return e.response
        if span is not None:
            extra += b"Content-Range: bytes %d-%d/%d\r\n" % (start, end, total)
        return render_response(206 if span is not None else 200,
                               b"".join(parts), content_type=ctype,
                               extra=extra)

    async def _delete_manifest_chunks(self, n: Needle) -> None:
        """Fan out deletes of a manifest's chunk needles
        (ref: volume_server_handlers_write.go DeleteHandler + DeleteChunks)."""
        try:
            manifest = self._load_manifest(n)
        except (ValueError, KeyError, TypeError, OSError):
            return
        for c in manifest.get("chunks", []):
            try:
                f = FileId.parse(c["fid"])
                # always through an HTTP DELETE, so the owning server's
                # replication fan-out runs (a direct store delete would
                # leave other replicas serving the chunk)
                locs = await self._lookup_volume(f.volume_id)
                if self.address in locs or self.public_url in locs:
                    target = self.address
                elif locs:
                    target = locs[0]
                elif self.store.has_volume(f.volume_id):
                    target = self.address
                else:
                    continue
                headers = None
                if self.jwt_signing_key:
                    # the cascade is server-initiated: sign its own token
                    from ..util.security import gen_jwt

                    headers = {"Authorization": "Bearer " + gen_jwt(
                        self.jwt_signing_key, 10, c["fid"]
                    )}
                await self._http_client.request(
                    "DELETE", target, "/" + c["fid"], headers=headers
                )
            except Exception as e:
                # best-effort, matching the reference's async delete
                _LOG.debug("chunk delete %s failed: %s", c.get("fid"), e)

    # ---------------- write (ref volume_server_handlers_write.go) ----------------
    async def _check_write_auth(
        self, req, fid: FileId, q: dict, ctype: bytes = JSON_FULL
    ):
        """Whitelist + JWT gate shared by writes and deletes; replicate
        traffic from registered cluster peers bypasses the whitelist but
        never the JWT check (the primary forwards the client's token)."""
        if not self.guard.check_whitelist(req.peer):
            if not (q.get("type") == "replicate"
                    and await self._is_cluster_member(req.peer)):
                return _json(403, {"error": "forbidden"})
        if self.jwt_signing_key and not self.guard.check_jwt(
            _header(req, b"authorization"), str(fid)
        ):
            return _json(401, {"error": "unauthorized"}, content_type=ctype)
        return None

    async def _write(self, req):
        fid, _, _ = self._parse_fid_path(req.path)
        q = _query(req)
        vid = fid.volume_id
        await self._wait_commit(vid)
        v = self.store.find_volume(vid)
        # the JAX server's fast tier hands a replicated write to its aiohttp
        # application (server/volume.py::_fast_write there)
        replicated = v is not None and v.super_block.replica_placement.copy_count() > 1
        ctype = JSON_FULL if replicated else fast_tier_json(req.query, frozenset())
        denied = await self._check_write_auth(req, fid, q, ctype)
        if denied is not None:
            return denied
        if v is None:
            return _json(404, {"error": f"volume {vid} not found"},
                         content_type=ctype)
        ct = req.headers.get(b"content-type", b"")
        if ct.startswith(b"multipart/form-data"):
            parsed = parse_multipart(req.body, ct)
            if parsed is None:
                return _json(400, {"error": "unparsable multipart body"})
            data, filename, mime = parsed
        else:
            # the raw request body IS the payload, handed over uncopied
            data, filename, mime = req.body, "", ct.decode("latin1")
        n = Needle(cookie=fid.cookie, id=fid.key, data=data)
        if filename:
            n.set_name(filename.encode())
        if mime and mime != "application/octet-stream":
            n.set_mime(mime.encode())
        if q.get("ts"):
            n.set_last_modified(int(q["ts"]))
        if q.get("ttl"):
            from ..storage.ttl import TTL

            n.set_ttl(TTL.read(q["ttl"]))
        if q.get("cm") == "true":
            # chunk manifest upload (ref needle_parse_upload.go:177)
            n.set_is_chunk_manifest()
        needs_fanout = (
            q.get("type") != "replicate"
            and v.super_block.replica_placement.copy_count() > 1
        )
        rep_task = None
        # the replica POSTs are launched before the local append so they
        # overlap it; the 201 still needs the local write and every
        # replica. A write certain to fail locally (read-only, size
        # ceiling) never lands on the replicas.
        if needs_fanout and v.can_accept(len(n.data)):
            rep_task = asyncio.ensure_future(
                self._replicate(req, q, vid, "POST", bytes(n.data))
            )
        t0 = time.perf_counter()
        try:
            if q.get("fsync") == "true":
                # group-commit path: one fsync amortized over concurrent
                # writers
                gc = await self._group_committer(vid)
                _off, size, _unchanged = await gc.write(n)
            elif rep_task is not None:
                # off the loop, so the replica POSTs progress meanwhile
                _off, size, _unchanged = await self.run_blocking(
                    self.store.write_volume_needle, vid, n
                )
            else:
                _off, size, _unchanged = self.store.write_volume_needle(
                    vid, n
                )
        except Exception as e:
            # the append may or may not have landed: report, never retry
            if rep_task is not None:
                rep_task.cancel()
            return _json(500, {"error": str(e)}, content_type=ctype)
        metrics.WRITE_STAGE_SECONDS.observe(
            time.perf_counter() - t0, stage="local_append"
        )
        self.read_cache.invalidate_key(vid, fid.key)
        if rep_task is not None:
            t1 = time.perf_counter()
            err = await rep_task
            metrics.WRITE_STAGE_SECONDS.observe(
                time.perf_counter() - t1, stage="replicate_wait"
            )
            if err:
                return _json(500, {"error": err})
        if q or (filename and (
            '"' in filename or "\\" in filename or not filename.isprintable()
        )):
            body = json_body({"name": filename, "size": size,
                              "eTag": n.etag()})
        else:
            body = (
                '{"name": "%s", "size": %d, "eTag": "%s"}'
                % (filename, size, n.etag())
            ).encode()
        return render_response(201, body, content_type=ctype)

    async def _batch_put(self, req):
        """Batched multipart-free chunk PUT (POST /!batch/put): one
        request appends N needles — the write-side sibling of
        BatchLookupGate/BatchDelete, fed by the filer's chunk-upload
        gate so concurrent gateway PUTs amortize the per-request HTTP
        machinery instead of paying a full hop per chunk.

        Plain frame: [u32 count] then per item [u16 fid_len]
        [u32 body_len][fid][body]. Tenant-tagged frame (high bit of the
        count word): per item [u16 fid_len][u16 tenant_len]
        [u32 body_len][fid][tenant][body]. The port has no admission
        gate, so a member's tenant is read (and must be UTF-8, as the
        JAX server requires) but no quota is charged to it. Bodies are
        handed to the needle append as memoryviews into the request
        body (zero-copy).

        The per-volume groups append through the group-commit worker as
        whole frames: each frame lands as ONE coalesced .dat extent +
        ONE .idx extent (Volume.write_needle_batch) inside a shared
        fsync batch.

        Response: JSON list of {"f": fid, "s": size, "e": etag} or
        {"f": fid, "err": reason} — items this server can't serve on
        the fast path (missing volume, replicated placement, read-only
        volume) report per-item errors and the CLIENT retries them
        through the single-needle path, so semantics never diverge."""
        if not self.guard.check_whitelist(req.peer):
            return render_response(403, b'{"error": "forbidden"}')
        if self.jwt_signing_key:
            # per-item tokens can't ride one batch request: a batch
            # against a signing server must not bypass auth
            return render_response(401, b'{"error": "unauthorized"}')
        body = req.body
        mv = memoryview(body)
        out: list = []
        # vid -> [(out slot, fid, needle)] for its group committer
        groups: dict[int, list] = {}
        try:
            (word,) = struct.unpack_from("<I", body, 0)
            tagged = bool(word & 0x80000000)
            count = word & 0x7FFFFFFF
            pos = 4
            if count > 4096:
                raise ValueError("batch too large")
            for _ in range(count):
                if tagged:
                    fl, tl, bl = struct.unpack_from("<HHI", body, pos)
                    pos += 8
                else:
                    fl, bl = struct.unpack_from("<HI", body, pos)
                    tl = 0
                    pos += 6
                fid_s = bytes(mv[pos : pos + fl]).decode("latin1")
                pos += fl
                if tl:
                    bytes(mv[pos : pos + tl]).decode("utf-8")
                pos += tl
                if pos + bl > len(body):
                    raise ValueError("truncated batch frame")
                payload = mv[pos : pos + bl]
                pos += bl
                slot = len(out)
                out.append({"f": fid_s, "err": "unprocessed"})
                try:
                    fid = FileId.parse(fid_s)
                except ValueError as e:
                    out[slot]["err"] = str(e)
                    continue
                vid = fid.volume_id
                v = self.store.find_volume(vid)
                if v is None:
                    out[slot]["err"] = "no volume"
                    continue
                if v.super_block.replica_placement.copy_count() > 1:
                    # the replication fan-out is the single-needle
                    # path's job; the client retries item-wise
                    out[slot]["err"] = "replicated"
                    continue
                if v.is_read_only():
                    out[slot]["err"] = "read only"
                    continue
                n = Needle(cookie=fid.cookie, id=fid.key, data=payload)
                groups.setdefault(vid, []).append((slot, fid, n))
        except (struct.error, ValueError):
            return render_response(400, b'{"error": "bad batch frame"}')

        async def write_group(vid: int, members: list) -> None:
            try:
                gc = await self._group_committer(vid)
                results = await gc.write_many([n for _s, _f, n in members])
            except Exception as e:
                for slot, _fid, _n in members:
                    out[slot] = {"f": out[slot]["f"], "err": str(e)}
                return
            for (slot, fid, n), res in zip(members, results):
                if isinstance(res, Exception):
                    out[slot] = {"f": out[slot]["f"], "err": str(res)}
                    continue
                _off, size, _unchanged = res
                self.read_cache.invalidate_key(vid, fid.key)
                out[slot] = {"f": out[slot]["f"], "s": size, "e": n.etag()}

        if groups:
            await asyncio.gather(
                *(write_group(vid, m) for vid, m in groups.items())
            )
        metrics.CHUNK_BATCH_PUT_SIZE.observe(count)
        return render_response(200, json.dumps(out).encode())

    async def _delete(self, req):
        fid, _, _ = self._parse_fid_path(req.path)
        q = _query(req)
        is_replicate = q.get("type") == "replicate"
        denied = await self._check_write_auth(req, fid, q)
        if denied is not None:
            return denied
        vid = fid.volume_id
        await self._wait_commit(vid)
        v = self.store.find_volume(vid)
        if v is not None:
            check = Needle(id=fid.key)
            try:
                self.store.read_volume_needle(vid, check)
            except (NotFound, AlreadyDeleted):
                return _json(404, {"size": 0})
            if check.cookie != fid.cookie:
                return _json(403, {"error": "cookie mismatch"})
            if check.is_chunked_manifest() and not is_replicate:
                # deleting a manifest also deletes its chunk needles; only
                # the primary fans out, or every replica would re-issue the
                # whole cascade (ref volume_server_handlers_write.go)
                await self._delete_manifest_chunks(check)
                # a vacuum commit may have begun during the cascade's
                # round trips: the tombstone goes to the volume it swaps in
                await self._wait_commit(vid)
                if self.store.find_volume(vid) is None:
                    return _json(404, {"error": "volume not found"})
            tomb = Needle(id=fid.key, cookie=fid.cookie)
            if q.get("fsync") == "true":
                # the tombstone rides the group commit's fsync, as a
                # ?fsync=true write does
                gc = await self._group_committer(vid)
                size = await gc.delete(tomb)
            else:
                size = self.store.delete_volume_needle(vid, tomb)
            self.read_cache.invalidate_key(vid, fid.key)
            if not is_replicate:
                # as in the JAX package, a replica that fails the delete
                # does not fail the primary's answer
                await self._replicate(req, q, vid, "DELETE", b"")
            return _json(202, {"size": size})
        ev = self.store.find_ec_volume(vid)
        if ev is not None:
            try:
                check = await self.read_ec_needle(ev, fid.key)
            except Exception as e:
                self.note_device_error("ec_read", e)
                return _json(500, {"error": f"{type(e).__name__}: {e}"})
            if check is not None and check.cookie != fid.cookie:
                return _json(403, {"error": "cookie mismatch"})
            if (
                check is not None
                and check.is_chunked_manifest()
                and not is_replicate
            ):
                # a manifest on an EC volume still owns its chunk needles
                await self._delete_manifest_chunks(check)
            size = await self.delete_ec_needle(ev, fid.key)
            return _json(202, {"size": size})
        return _json(404, {"error": "volume not found"})

    # ---------------- replication (ref store_replicate.go:20-121) ----------------
    async def _is_cluster_member(self, ip: str) -> bool:
        """True when ip belongs to a registered volume server: replicate
        traffic is exempt from the whitelist only for cluster peers."""
        now = time.monotonic()
        cache = getattr(self, "_member_ips", None)
        if cache is None or now - cache[0] > 10.0:
            if not self.master:
                return False
            hosts: set[str] = set()
            try:
                stub = Stub(grpc_address(self.master), "master")
                resp = await stub.call("VolumeList", {})
                for dc in resp.get("topology_info", {}).get("data_centers", []):
                    for rack in dc.get("racks", []):
                        for dn in rack.get("data_nodes", []):
                            hosts.add(dn.get("url", "").rsplit(":", 1)[0])
            except Exception:
                if cache is not None:
                    return ip in cache[1]
                return False
            # registered hosts may be names: resolve them, bounded
            ips: set[str] = set(hosts)
            loop = asyncio.get_running_loop()

            async def resolve(host: str) -> None:
                try:
                    infos = await asyncio.wait_for(
                        loop.getaddrinfo(host, None), timeout=2.0
                    )
                    for info in infos:
                        ips.add(info[4][0])
                except (OSError, asyncio.TimeoutError):
                    pass

            await asyncio.gather(*(resolve(h) for h in hosts))
            cache = (now, ips)
            self._member_ips = cache
        return ip in cache[1]

    async def _lookup_volume(self, vid: int) -> list[str]:
        """Replica locations for vid from the master, cached for 2 s (a
        master RPC per replicated write would put the master on every
        write's path); a stale entry serves for 30 s while the master is
        unreachable."""
        if not self.master:
            return []
        cached = self._replica_loc_cache.get(vid)
        now = time.monotonic()
        if cached is not None and now - cached[0] < 2.0:
            return cached[1]
        locations: list[str] = []
        try:
            stub = Stub(grpc_address(self.master), "master")
            resp = await stub.call("LookupVolume", {"volume_ids": [str(vid)]})
            for r in resp.get("volume_id_locations", []):
                if int(r.get("volumeId", "0").split(",")[0]) == vid and r.get(
                    "locations"
                ):
                    locations = [loc["url"] for loc in r["locations"]]
                    break
        except Exception:
            if cached is not None and now - cached[0] < 30.0:
                return cached[1]
            return []
        if not locations:
            # a transient empty answer must cost one request, and bogus
            # client vids must not fill the cache
            self._replica_loc_cache.pop(vid, None)
            return []
        if len(self._replica_loc_cache) > 4096:  # runaway-vid backstop
            self._replica_loc_cache.clear()
        self._replica_loc_cache[vid] = (now, locations)
        return locations

    async def _replicate(self, req, q: dict, vid: int, method: str,
                         body: bytes) -> str:
        """Send a write or delete to the volume's other replicas;
        "" when every one acknowledged, else the errors."""
        v = self.store.find_volume(vid)
        if v is None or v.super_block.replica_placement.copy_count() <= 1:
            return ""
        locations = await self._lookup_volume(vid)
        others = [u for u in locations
                  if u not in (self.address, self.public_url)]
        if len(others) + 1 < v.super_block.replica_placement.copy_count():
            return f"replicating to {len(others)} replicas, need more"
        errs = []
        # forward the client's JWT so replicas run the same auth check
        headers = {}
        auth = _header(req, b"authorization")
        if auth:
            headers["Authorization"] = auth
        target = req.path + "?type=replicate"
        rest = {k: val for k, val in q.items() if k != "type"}
        if rest:
            target += "&" + "&".join(f"{k}={val}" for k, val in rest.items())

        async def one(url: str) -> None:
            try:
                if method == "POST":
                    payload, ctype = build_multipart(
                        "file", body, filename="replica"
                    )
                    status, _ = await self._http_client.request(
                        "POST", url, target, payload, ctype, headers
                    )
                    if status >= 300:
                        errs.append(f"{url}: status {status}")
                else:
                    status, _ = await self._http_client.request(
                        "DELETE", url, target, headers=headers
                    )
                    if status >= 400 and status != 404:
                        errs.append(f"{url}: status {status}")
            except Exception as e:
                errs.append(f"{url}: {e}")

        await asyncio.gather(*(one(u) for u in others))
        return "; ".join(errs)

    # ---------------- RPC admin ----------------
    async def _grpc_allocate_volume(self, req, context) -> dict:
        try:
            self.store.add_volume(
                int(req["volume_id"]),
                req.get("collection", ""),
                req.get("replication", "000") or "000",
                req.get("ttl", "") or "",
                int(req.get("preallocate", 0)),
            )
            return {}
        except Exception as e:
            return {"error": str(e)}

    async def _grpc_volume_mount(self, req, context) -> dict:
        if req.get("seed_read_heat") is not None:
            raise NotImplementedError(
                "not ported: seed_read_heat (the lifecycle plane)"
            )
        self.store.mount_volume(int(req["volume_id"]))
        return {}

    async def _grpc_volume_unmount(self, req, context) -> dict:
        vid = int(req["volume_id"])
        await self._retire_group_committer(vid)
        self.store.unmount_volume(vid)
        self.read_cache.invalidate_volume(vid)
        return {}

    async def _grpc_volume_delete(self, req, context) -> dict:
        vid = int(req["volume_id"])
        await self._retire_group_committer(vid)
        # keep_ec_files: EC conversion retires the source volume but the
        # shards at the same base name still need the .vif
        self.store.delete_volume(
            vid, keep_ec_files=bool(req.get("keep_ec_files"))
        )
        self.read_cache.invalidate_volume(vid)
        return {}

    async def _grpc_volume_mark_readonly(self, req, context) -> dict:
        self.store.mark_volume_readonly(int(req["volume_id"]))
        return {}

    async def _grpc_volume_mark_writable(self, req, context) -> dict:
        """Undo VolumeMarkReadonly (ref volume_grpc_admin.go
        VolumeMarkWritable)."""
        vid = int(req["volume_id"])
        v = self.store.find_volume(vid)
        if v is None:
            return {"error": f"volume {vid} not found"}
        v.no_write_or_delete = False
        return {}

    async def _grpc_delete_collection(self, req, context) -> dict:
        collection = req.get("collection", "")
        for loc in self.store.locations:
            for vid, v in list(loc.volumes.items()):
                if v.collection == collection:
                    loc.delete_volume(vid)
        return {}

    # ---------------- RPC: vacuum (ref volume_grpc_vacuum.go) ----------------
    async def _grpc_vacuum_check(self, req, context) -> dict:
        v = self.store.find_volume(int(req["volume_id"]))
        if v is None:
            return {"error": "volume not found"}
        return {"garbage_ratio": v.garbage_level()}

    async def _grpc_vacuum_compact(self, req, context) -> dict:
        v = self.store.find_volume(int(req["volume_id"]))
        if v is None:
            return {"error": "volume not found"}
        try:
            # the per-run report, NOT the module-global "last" snapshot:
            # concurrent compactions each get their own numbers
            report = await self.run_blocking(
                lambda: vacuum_mod.compact2(
                    v,
                    route=req.get("route") or None,
                    verify=req.get("verify"),
                )
            )
            return {
                "stages": report.get("stages", {}),
                "route": {
                    k: report[k]
                    for k in ("route", "extents", "records")
                    if k in report
                },
            }
        except Exception as e:
            return {"error": str(e)}

    def _swap_volume(self, vid: int, new_v) -> None:
        for loc in self.store.locations:
            if loc.find_volume(vid) is not None:
                loc.volumes[vid] = new_v

    async def _grpc_vacuum_commit(self, req, context) -> dict:
        vid = int(req["volume_id"])
        v = self.store.find_volume(vid)
        if v is None:
            return {"error": "volume not found"}
        old_msg = self.store._volume_message(v)
        swapped = self._commits[vid] = asyncio.Event()
        try:
            # a group committer pinned to the old volume object would
            # fsync a closed fd after the swap: retire it first (writes
            # arriving now wait for the swap, then start a new one)
            await self._retire_group_committer(vid)
            new_v = await self.run_blocking(vacuum_mod.commit_compact, v)
            self._swap_volume(vid, new_v)
            # the swap rewrote the .dat: cached responses must not outlive
            # it (the per-hit volume-identity check would catch any that
            # did, but the LRU should shed them now, not at eviction)
            self.read_cache.invalidate_volume(vid)
            # the garbage ratio just changed: ride the next heartbeat
            # pulse so the master's vacuum queue prunes this volume
            # instead of re-dispatching off stale state
            self.store.note_volume_changed(
                old_msg, self.store._volume_message(new_v)
            )
            return {}
        except Exception as e:
            # commit_compact closed the volume before it failed (shadows
            # swept, old .dat/.idx intact): reload so the volume keeps
            # serving and a later vacuum retry can start clean
            try:
                reloaded = await self.run_blocking(
                    lambda: Volume(
                        v.dir, v.collection, vid, create=False,
                        needle_map_kind=v.needle_map_kind, device=v.device,
                    )
                )
                self._swap_volume(vid, reloaded)
            except Exception:
                pass  # original error is the one worth reporting
            return {"error": str(e)}
        finally:
            self._commits.pop(vid, None)
            swapped.set()

    async def _grpc_vacuum_cleanup(self, req, context) -> dict:
        v = self.store.find_volume(int(req["volume_id"]))
        if v is not None:
            if v.is_compacting:
                # a cleanup racing an in-flight compact2 would unlink the
                # shadow mid-write and leave .cpx-without-.cpd on disk —
                # the state the load-time sweep treats as half-committed
                return {"error": "compaction in flight; not cleaning"}
            vacuum_mod.cleanup_compact(v)
        return {}

    async def _grpc_batch_delete(self, req, context) -> dict:
        results = []
        for fid_str in req.get("file_ids", []):
            try:
                fid = FileId.parse(fid_str)
                n = Needle(id=fid.key, cookie=fid.cookie)
                size = self.store.delete_volume_needle(fid.volume_id, n)
                self.read_cache.invalidate_key(fid.volume_id, fid.key)
                results.append({"file_id": fid_str, "status": 202, "size": size})
            except Exception as e:
                results.append({"file_id": fid_str, "status": 500, "error": str(e)})
        return {"results": results}

    async def _grpc_bulk_lookup(self, req, context) -> dict:
        """Batched fid -> (offset, size) probes served from the volume's
        index snapshot on the server's device (kernel index_search.cu).

        req:  {volume_id, keys: <u8-LE bytes | list[int]}
        resp: {offsets: <u4-LE bytes, sizes: <u4-LE bytes, found: u8 bytes}
        columns aligned with the probe order.
        """
        import numpy as np

        vid = int(req["volume_id"])
        keys = _decode_keys(req)
        v = self.store.find_volume(vid)
        if v is not None:
            fn = v.bulk_lookup
        else:
            ev = self.store.find_ec_volume(vid)
            if ev is None:
                return {"error": f"volume {vid} not found"}
            fn = ev.bulk_locate
        try:
            offsets, sizes, found = await self.run_blocking(fn, keys)
        except Exception as e:
            self.note_device_error("bulk_lookup", e)
            raise
        # 5-byte-offset volumes need u64 columns on the wire
        off_dtype = "<u8" if offsets.dtype.itemsize > 4 else "<u4"
        return {
            "offsets": np.ascontiguousarray(offsets, dtype=off_dtype).tobytes(),
            "offset_dtype": off_dtype,
            "sizes": np.ascontiguousarray(sizes, dtype="<u4").tobytes(),
            "found": np.ascontiguousarray(found, dtype=np.uint8).tobytes(),
        }

    async def _grpc_batch_read(self, req, context):
        """Bulk needle reads: one batched index probe (on the card for 64
        keys or more, kernel index_search.cu; a failed probe ends the
        stream with its error, never answered from the host map), then
        record preads. Yields {key, found[, cookie, data, size]} per
        probe in order.

        req: {volume_id, keys: <u8-LE bytes | list[int]}
        """
        vid = int(req["volume_id"])
        keys = _decode_keys(req)
        v = self.store.find_volume(vid)
        if v is not None:
            try:
                offsets, sizes, found = await self.run_blocking(
                    v.bulk_lookup, keys
                )
            except Exception as e:
                self.note_device_error("batch_read", e)
                raise

            def read_slice(idxs: list[int]) -> list:
                # one executor hop per slice of preads, not per needle; a
                # vacuum commit racing the stream surfaces as a per-key
                # miss, not a dead stream
                out = []
                for i in idxs:
                    try:
                        out.append(
                            v.read_needle_at(int(offsets[i]), int(sizes[i]))
                        )
                    except Exception as e:
                        out.append(e)
                return out

            # slices are capped by accumulated payload bytes AND key count
            # so neither large needles nor huge key lists can pile up
            # unbounded work before the first yield
            max_slice_bytes = 8 << 20
            max_slice_keys = 256
            lo = 0
            while lo < len(keys):
                hi = lo
                span_bytes = 0
                while (
                    hi < len(keys)
                    and hi - lo < max_slice_keys
                    and (
                        hi == lo
                        or span_bytes + int(sizes[hi]) <= max_slice_bytes
                    )
                ):
                    if found[hi]:
                        span_bytes += int(sizes[hi])
                    hi += 1
                idxs = [i for i in range(lo, hi) if found[i]]
                results = (
                    await self.run_blocking(read_slice, idxs) if idxs else []
                )
                by_idx = dict(zip(idxs, results))
                for i in range(lo, hi):
                    key = int(keys[i])
                    n = by_idx.get(i)
                    if n is None:
                        yield {"key": key, "found": False}
                    elif isinstance(n, Exception):
                        yield {"key": key, "found": False, "error": str(n)}
                    else:
                        yield {
                            "key": key,
                            "found": True,
                            "cookie": n.cookie,
                            "size": int(sizes[i]),
                            "data": bytes(n.data),
                        }
                lo = hi
            return
        ev = self.store.find_ec_volume(vid)
        if ev is None:
            yield {"error": f"volume {vid} not found"}
            return
        try:
            offsets, sizes, found = await self.run_blocking(
                ev.bulk_locate, keys
            )
        except Exception as e:
            self.note_device_error("batch_read", e)
            raise
        for i, key in enumerate(keys):
            if not found[i]:
                yield {"key": int(key), "found": False}
                continue
            try:
                n = await self.read_ec_needle_at(
                    ev, int(key), int(offsets[i]), int(sizes[i])
                )
            except Exception as e:
                # one corrupt needle must not kill the whole stream
                yield {"key": int(key), "found": False, "error": str(e)}
                continue
            if n is None:
                yield {"key": int(key), "found": False}
                continue
            yield {
                "key": int(key),
                "found": True,
                "cookie": n.cookie,
                "size": len(n.data),
                "data": bytes(n.data),
            }

    async def _grpc_copy_file(self, req, context):
        """Stream a volume file's bytes (ref volume_grpc_copy.go doCopyFile).

        req: {volume_id, collection, ext, compaction_revision,
              stop_offset, is_ec_volume}
        """
        from ..storage.volume import volume_base_name

        vid = int(req["volume_id"])
        collection = req.get("collection", "")
        ext = req["ext"]
        for loc in self.store.locations:
            path = volume_base_name(loc.directory, collection, vid) + ext
            if os.path.exists(path):
                with open(path, "rb") as f:
                    while True:
                        chunk = f.read(1 << 20)
                        if not chunk:
                            return
                        yield {"file_content": chunk}
        yield {"error": f"{vid}{ext} not found"}

    async def _grpc_incremental_copy(self, req, context):
        """Stream records appended after since_ns
        (ref volume_grpc_copy_incremental.go + volume_backup.go). The
        resume offset's search scans the .dat on the executor."""
        from ..storage.volume_backup import binary_search_append_at_ns

        vid = int(req["volume_id"])
        since_ns = int(req.get("since_ns", 0))
        v = self.store.find_volume(vid)
        if v is None:
            yield {"error": f"volume {vid} not found"}
            return
        offset = await self.run_blocking(binary_search_append_at_ns, v, since_ns)
        end = v.data_file_size()
        while offset < end:
            data = v.data_backend.read_at(min(1 << 20, end - offset), offset)
            if not data:
                return
            yield {"file_content": data}
            offset += len(data)

    async def _grpc_sync_status(self, req, context) -> dict:
        vid = int(req["volume_id"])
        v = self.store.find_volume(vid)
        if v is None:
            return {"error": f"volume {vid} not found"}
        return {
            "volume_id": vid,
            "tail_offset": v.data_file_size(),
            "compact_revision": v.super_block.compaction_revision,
            "idx_file_size": v.index_file_size(),
            "last_append_at_ns": v.last_append_at_ns,
        }

    async def _charge_maintenance(self, n: int, plane: str = "repair") -> None:
        """Charge n bytes to the shared maintenance budget (no-op when
        SEAWEEDFS_TPU_MAINT_MBPS is unset). The blocking token wait runs in
        the executor so a throttled repair pull never stalls serving."""
        from ..storage.maintenance import plane_bucket

        bucket = plane_bucket(plane)
        if bucket is not None and n:
            await asyncio.get_running_loop().run_in_executor(
                None, bucket.consume, n
            )

    async def _pull_volume_files(
        self, vid: int, collection: str, source: str, base: str
    ) -> None:
        """Stream .dat/.idx/.vif from a source server into base.* (atomic
        per-file via .tmp+rename); shared by VolumeCopy and the repair
        re-copy path. Pull traffic is charged to the shared maintenance
        budget: a repair storm and a scrub pass together stay under the
        one configured background-I/O cap."""
        from ..storage.needle_map.lsm_map import invalidate_snapshot

        stub = Stub(grpc_address(source), "volume")
        for ext in (".dat", ".idx", ".vif"):
            tmp = base + ext + ".tmp"
            got_any = False
            with open(tmp, "wb") as f:
                async for msg in stub.server_stream(
                    "CopyFile",
                    {"volume_id": vid, "collection": collection, "ext": ext},
                    timeout=3600,
                ):
                    if msg.get("error"):
                        if ext == ".vif":
                            break
                        raise IOError(msg["error"])
                    chunk = msg.get("file_content", b"")
                    await self._charge_maintenance(len(chunk))
                    f.write(chunk)
                    got_any = True
            if got_any or ext != ".vif":
                os.replace(tmp, base + ext)
            else:
                os.remove(tmp)
        # the pulled .idx is a different log: a stale lsm needle-map
        # snapshot at this base (repair recopy over a previously mounted
        # volume) must not be consulted by the remount
        invalidate_snapshot(base)

    async def _grpc_volume_copy(self, req, context) -> dict:
        """Pull a whole volume (.dat/.idx/.vif) from a source server and
        mount it (ref volume_grpc_copy.go:23-116)."""
        from ..storage.volume import volume_base_name

        vid = int(req["volume_id"])
        collection = req.get("collection", "")
        source = req["source_data_node"]
        if self.store.has_volume(vid):
            return {"error": f"volume {vid} already exists"}
        loc = max(
            self.store.locations,
            key=lambda l: l.max_volume_count - len(l.volumes),
        )
        base = volume_base_name(loc.directory, collection, vid)
        try:
            await self._pull_volume_files(vid, collection, source, base)
            await self.run_blocking(self.store.mount_volume, vid)
            return {}
        except Exception as e:
            return {"error": str(e)}

    # ---------------- anti-entropy plane ----------------
    @property
    def scrubber(self):
        if self._scrubber is None:
            from ..storage.scrub import Scrubber

            self._scrubber = Scrubber(
                self.store,
                rate_mbps=self.scrub_mbps,
                codec_for=self.codec_for,
            )
        return self._scrubber

    async def _scrub_loop(self) -> None:
        """Background scrub: one rate-shaped pass per interval. The token
        bucket bounds the I/O so verification coexists with serving load;
        the per-volume cursor makes restarts resume, not restart."""
        while not self._shutdown:
            try:
                await asyncio.sleep(self.scrub_interval_seconds)
                if self._shutdown:
                    return
                await self.run_blocking(self.scrubber.run_pass)
            except asyncio.CancelledError:
                return
            except Exception as e:
                # a broken volume must not kill the loop; findings (and
                # quarantines) from the partial pass already counted
                _LOG.warning("volume server %s: scrub pass failed: %s",
                             self.address, e)
                continue

    async def _grpc_volume_scrub(self, req, context) -> dict:
        """Forced scrub pass (shell `volume.scrub` / tests): walk the
        requested volume (or everything local), verify CRCs, extents and
        EC parity (the server's codec: on the card, gf256_matmul), apply
        the quarantine policy, return the full report."""
        volume_id = int(req.get("volume_id", 0) or 0)
        include_ec = bool(req.get("include_ec", True))
        scrubber = self.scrubber
        rate = req.get("rate_mbps")
        if rate:
            from ..storage.scrub import Scrubber

            scrubber = Scrubber(
                self.store, rate_mbps=float(rate), codec_for=self.codec_for
            )
        try:
            return await self.run_blocking(
                lambda: scrubber.run_pass(
                    volume_id=volume_id or None, include_ec=include_ec
                )
            )
        except Exception as e:
            return {"error": str(e)}

    async def _grpc_volume_tail_sync(self, req, context) -> dict:
        """Catch-up resync of a stale replica: pull every record appended
        on the source after our local frontier through the incremental
        tail path (volume_backup.py) and replay it into the local volume.
        Dispatched by the master when replica digests diverge and our
        append frontier trails."""
        from ..storage.volume_backup import apply_incremental

        vid = int(req["volume_id"])
        source = req["source_data_node"]
        v = self.store.find_volume(vid)
        if v is None:
            return {"error": f"volume {vid} not found"}
        since_ns = v.last_append_at_ns
        stub = Stub(grpc_address(source), "volume")
        chunks = []
        async for msg in stub.server_stream(
            "VolumeIncrementalCopy",
            {"volume_id": vid, "since_ns": since_ns},
            timeout=3600,
        ):
            if msg.get("error"):
                return {"error": msg["error"]}
            chunks.append(msg.get("file_content", b""))
        data = b"".join(chunks)
        if not data:
            return {"applied_records": 0, "applied_bytes": 0}
        old_msg = self.store._volume_message(v)
        try:
            applied = await self.run_blocking(apply_incremental, v, data)
        except Exception as e:
            return {"error": f"apply incremental: {e}"}
        # replayed records may overwrite cached keys
        self.read_cache.invalidate_volume(vid)
        metrics.ANTIENTROPY_RESYNCS.inc(kind="tail_sync")
        # the digest changed: let the master see the converged state on
        # the next pulse instead of the next full reconnect
        self.store.note_volume_changed(old_msg, self.store._volume_message(v))
        return {"applied_records": applied, "applied_bytes": len(data)}

    async def _grpc_volume_repair_copy(self, req, context) -> dict:
        """Replace a scrub-quarantined replica with a fresh copy from a
        healthy peer: quarantine the damaged files aside as `.bad` (never
        deleted), pull .dat/.idx/.vif from the source, remount. The
        master dispatches this when a volume heartbeats `scrub_corrupt`
        while a clean replica exists. Reads of the volume wait for the
        swap, as they wait for a vacuum commit's."""
        vid = int(req["volume_id"])
        collection = req.get("collection", "")
        source = req["source_data_node"]
        v = self.store.find_volume(vid)
        if v is None:
            return {"error": f"volume {vid} not found"}
        if not v.scrub_corrupt and not req.get("force"):
            # idempotent skip: the master may re-dispatch while the healed
            # state is still riding a heartbeat back to it
            return {"repaired": False, "skipped": "not quarantined"}
        base = v.file_name()
        target_loc = None
        for loc in self.store.locations:
            if loc.find_volume(vid) is not None:
                target_loc = loc
                break
        old_msg = self.store._volume_message(v)
        swapped = self._commits[vid] = asyncio.Event()
        try:
            # a group committer pinned to the old volume object would
            # fsync a closed fd after the swap — retire it first
            await self._retire_group_committer(vid)
            # unmount WITHOUT a deleted-delta: repair is an in-place swap,
            # the note_volume_changed below reports the healthy state
            with target_loc._lock:
                target_loc.volumes.pop(vid, None)
            v.close()
            for ext in (".dat", ".idx", ".vif"):
                try:
                    os.replace(base + ext, base + ext + ".bad")
                except FileNotFoundError:
                    pass
            try:
                await self._pull_volume_files(vid, collection, source, base)
            except Exception as e:
                # rollback: a transient copy failure must not convert a
                # corrupt-but-present replica into a missing one — put the
                # quarantined files back, remount, re-flag, retry later
                for ext in (".dat", ".idx", ".vif"):
                    for leftover in (base + ext + ".tmp", base + ext):
                        try:
                            os.remove(leftover)  # partial pull artifacts
                        except FileNotFoundError:
                            pass
                    try:
                        os.replace(base + ext + ".bad", base + ext)
                    except FileNotFoundError:
                        pass
                await self.run_blocking(target_loc.load_existing_volumes)
                restored = self.store.find_volume(vid)
                if restored is not None:
                    restored.quarantine("restored after failed repair pull")
                return {"error": f"pull from {source}: {e}"}
            await self.run_blocking(target_loc.load_existing_volumes)
            new_v = self.store.find_volume(vid)
            if new_v is None:
                return {"error": f"volume {vid} did not remount after repair"}
            self.read_cache.invalidate_volume(vid)
            metrics.ANTIENTROPY_RESYNCS.inc(kind="recopy")
            self.store.note_volume_changed(
                old_msg, self.store._volume_message(new_v)
            )
            return {"repaired": True}
        finally:
            self._commits.pop(vid, None)
            swapped.set()

    async def _grpc_status(self, req, context) -> dict:
        return {
            "volumes": [
                self.store._volume_message(v)
                for loc in self.store.locations
                for v in loc.volumes.values()
            ],
        }
