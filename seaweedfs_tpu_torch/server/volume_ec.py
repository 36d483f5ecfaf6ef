"""Volume-server EC handlers: the EC RPCs and the EC read path.

Ported from the JAX package's server/volume_ec.py (ref: weed/server/
volume_grpc_erasure_coding.go:39-391, weed/storage/store_ec.go:119-373).
RPCs: VolumeEcShardsGenerate, VolumeEcShardsGenerateBatch,
VolumeEcShardsRebuild, VolumeEcShardsRebuildBatch (many volumes through
rebuild_ec_files_multi's shared decode batches), VolumeEcShardsCopy,
VolumeEcShardsMount, VolumeEcShardsUnmount, VolumeEcShardsDelete,
VolumeEcShardRead (a server stream), VolumeEcBlobDelete,
VolumeEcShardsInfo and VolumeEcShardsToVolume (decoding the data shards
back into a normal volume's .dat and .idx). The codec is the server's
(`make_codec`: CudaRSCodec on the card, kernel gf256.cu, for the volume's
geometry); encode, rebuild and every decode run on the server's executor,
off the event loop.

Read path (ref store_ec.go:119-373): locate the needle in the local
sorted .ecx, map it to shard intervals, read each interval from its local
shard, else from a remote holder (the VolumeEcShardRead stream; holders
come from the master's LookupEcVolume, cached for SHARD_LOCATION_TTL),
else reconstruct it on the card from any k survivors, local and remote
(missing row only), keeping the readahead-widened span in the
`DegradedIntervalCache`. A decode that raises reaches the reader as a
counted 500 (server/volume.py); no host stand-in decodes in its place.
A batched rebuild group that raises is counted in `device_errors`
("ec_rebuild_batch") and retried volume by volume on the same codec.
Not ported yet: the cold tier's offload and recall, and the maintenance
budget of the `plane` requests (answered `not ported: plane`).
"""

from __future__ import annotations

import asyncio
import os
import random
import time
from typing import Optional

from ..pb import grpc_address
from ..pb.rpc import Stub
from ..storage.erasure_coding import (
    DATA_SHARDS_COUNT,
    TOTAL_SHARDS_COUNT,
    find_dat_file_size,
    rebuild_ec_files,
    rebuild_ec_files_multi,
    to_ext,
    write_dat_file,
    write_ec_files,
    write_ec_files_multi,
    write_idx_file_from_ec_index,
    write_sorted_file_from_idx,
)
from ..storage.erasure_coding.ec_volume import (
    EcVolume,
    NeedleNotFound,
    ShardBits,
)
from ..util.backoff import (
    BackoffPolicy,
    deadline_after,
    remaining,
    shared_retry_budget,
)
from ..storage.volume import volume_base_name
from ..storage.volume_info import VolumeInfo, load_volume_info, save_volume_info
from ..types import TOMBSTONE_FILE_SIZE, to_actual_offset
from ..storage.needle import Needle
from ..util.metrics import EC_RECONSTRUCTIONS, RETRY_COUNTER

SHARD_LOCATION_TTL = 10.0  # seconds between LookupEcVolume refreshes
# total wall-clock budget for one EC needle read, across every interval,
# remote attempt, location refresh and reconstruction; each remote RPC gets
# the remainder of this budget as its timeout (the JAX package's default)
EC_READ_DEADLINE_SECONDS = 15.0
# per-url remote-read retry: quick second chance for transient resets; the
# deadline, not the attempt count, is the real bound
EC_REMOTE_READ_POLICY = BackoffPolicy(base=0.02, cap=0.25, attempts=2)
# rounds of (force-refresh locations, re-attempt remote reads) before
# falling back to reconstruction
EC_REFRESH_ROUNDS = 2

# degraded-read interval cache: reconstructed spans kept per server so
# repeated reads of a dead shard stop re-paying the survivor fetch + decode
# (16 MiB, the reference's default)
EC_DEGRADED_CACHE_BYTES = 16 << 20
# reconstruction granularity: intervals are widened to this alignment
# (readahead: neighbouring needles on the same dead shard land in one span)
EC_DEGRADED_SPAN = 128 * 1024


class DegradedIntervalCache:
    """Byte-bounded LRU of reconstructed shard spans, keyed by
    (volume_id, shard_id, span_start) (the JAX package's
    server/volume_ec.py:86). A degraded read widens its interval to
    EC_DEGRADED_SPAN alignment before reconstructing, caches the whole
    span, and serves any later interval inside a cached span."""

    def __init__(self, capacity_bytes: int = EC_DEGRADED_CACHE_BYTES):
        import threading
        from collections import OrderedDict

        self.capacity = capacity_bytes
        self._spans: "OrderedDict[tuple, bytes]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    @staticmethod
    def span_for(
        offset: int, size: int, shard_size: Optional[int]
    ) -> tuple[int, int]:
        """Aligned (span_start, span_size) covering [offset, offset+size);
        no readahead when the shard size is unknown."""
        if not shard_size or offset + size > shard_size:
            return offset, size
        start = offset - (offset % EC_DEGRADED_SPAN)
        end = offset + size
        end += (-end) % EC_DEGRADED_SPAN
        return start, min(end, shard_size) - start

    def get(
        self, vid: int, shard_id: int, offset: int, size: int
    ) -> Optional[bytes]:
        start = offset - (offset % EC_DEGRADED_SPAN)
        with self._lock:
            for key in ((vid, shard_id, start), (vid, shard_id, offset)):
                span = self._spans.get(key)
                if span is not None and key[2] + len(span) >= offset + size:
                    self._spans.move_to_end(key)
                    return span[offset - key[2] : offset - key[2] + size]
        return None

    def put(self, vid: int, shard_id: int, span_start: int, data: bytes) -> None:
        key = (vid, shard_id, span_start)
        with self._lock:
            old = self._spans.pop(key, None)
            if old is not None:
                self._bytes -= len(old)
            self._spans[key] = data
            self._bytes += len(data)
            while self._bytes > self.capacity and self._spans:
                _k, v = self._spans.popitem(last=False)
                self._bytes -= len(v)

    def invalidate(self, vid: int) -> None:
        """Drop every cached span of a volume."""
        with self._lock:
            for k in [k for k in self._spans if k[0] == vid]:
                self._bytes -= len(self._spans.pop(k))


class _Deleted(Exception):
    """Needle tombstoned on a remote holder: a definitive answer, not a
    failure; it short-circuits retries and reconstruction."""


class EcHandlers:
    """Mixin for VolumeServer (expects .store, .codec, .make_codec,
    .run_blocking, .note_device_error, .master, .address and
    .public_url)."""

    def register_ec_rpcs(self, svc) -> None:
        svc.unary("VolumeEcShardsGenerate")(self._grpc_ec_generate)
        svc.unary("VolumeEcShardsGenerateBatch")(self._grpc_ec_generate_batch)
        svc.unary("VolumeEcShardsRebuild")(self._grpc_ec_rebuild)
        svc.unary("VolumeEcShardsRebuildBatch")(self._grpc_ec_rebuild_batch)
        svc.unary("VolumeEcShardsToVolume")(self._grpc_ec_shards_to_volume)
        svc.unary("VolumeEcShardsCopy")(self._grpc_ec_copy)
        svc.unary("VolumeEcShardsDelete")(self._grpc_ec_delete)
        svc.unary("VolumeEcShardsMount")(self._grpc_ec_mount)
        svc.unary("VolumeEcShardsUnmount")(self._grpc_ec_unmount)
        svc.server_stream("VolumeEcShardRead")(self._grpc_ec_shard_read)
        svc.unary("VolumeEcBlobDelete")(self._grpc_ec_blob_delete)
        svc.unary("VolumeEcShardsInfo")(self._grpc_ec_info)

    def _base_name(self, collection: str, vid: int) -> Optional[str]:
        v = self.store.find_volume(vid)
        if v is not None:
            return v.file_name()
        for loc in self.store.locations:
            base = volume_base_name(loc.directory, collection, vid)
            if any(
                os.path.exists(base + ext) for ext in (".ecx", ".dat", ".ec00")
            ):
                return base
        return None

    # ---------------- RPCs ----------------
    async def _grpc_ec_generate(self, req, context) -> dict:
        """.dat/.idx -> .ecNN + .ecx + .vif (ref :39-75). Optional
        data_shards/parity_shards select another RS geometry (6.3, 12.4),
        kept in the .vif."""
        if req.get("plane"):
            return {"error": "not ported: maintenance-plane budgets"}
        vid = int(req["volume_id"])
        collection = req.get("collection", "")
        data_shards = int(req.get("data_shards", 0))
        parity_shards = int(req.get("parity_shards", 0))
        base = self._base_name(collection, vid)
        if base is None:
            return {"error": f"volume {vid} not found"}
        try:
            codec = (
                self.codec_for(data_shards, parity_shards)
                if data_shards
                else self.codec
            )
            await self.run_blocking(lambda: write_ec_files(base, codec=codec))
        except Exception as e:
            self.note_device_error("ec_generate", e)
            return {"error": str(e)}
        try:
            await self.run_blocking(write_sorted_file_from_idx, base)
            v = self.store.find_volume(vid)
            save_volume_info(
                base + ".vif",
                VolumeInfo(
                    version=v.version if v else 3,
                    data_shards=data_shards,
                    parity_shards=parity_shards,
                ),
            )
            return {}
        except Exception as e:
            return {"error": str(e)}

    async def _grpc_ec_generate_batch(self, req, context) -> dict:
        """Batched multi-volume encode: every requested local volume
        streams through shared encode batches (write_ec_files_multi), so
        one kernel launch serves every volume in a round. Returns
        per-volume errors keyed by id; volumes absent from `errors`
        succeeded."""
        if req.get("plane"):
            return {"error": "not ported: maintenance-plane budgets"}
        vids = [int(v) for v in req.get("volume_ids", [])]
        collection = req.get("collection", "")
        data_shards = int(req.get("data_shards", 0))
        parity_shards = int(req.get("parity_shards", 0))
        errors: dict = {}
        bases = []
        for vid in vids:
            base = self._base_name(collection, vid)
            if base is None:
                errors[str(vid)] = f"volume {vid} not found"
            else:
                bases.append((vid, base))
        if not bases:
            return {"errors": errors}
        codec = (
            self.codec_for(data_shards, parity_shards)
            if data_shards
            else self.codec
        )
        try:
            await self.run_blocking(
                lambda: write_ec_files_multi(
                    [b for _vid, b in bases], codec=codec
                )
            )
        except Exception as e:
            self.note_device_error("ec_generate", e)
            # one broken volume must not sink its co-batched neighbours:
            # retry each alone so only the faulty ones report errors
            healthy = []
            for vid, base in bases:
                try:
                    await self.run_blocking(
                        lambda b=base: write_ec_files(b, codec=codec)
                    )
                    healthy.append((vid, base))
                except Exception as e:
                    errors[str(vid)] = str(e)
            bases = healthy
        for vid, base in bases:
            try:
                await self.run_blocking(write_sorted_file_from_idx, base)
                v = self.store.find_volume(vid)
                save_volume_info(
                    base + ".vif",
                    VolumeInfo(
                        version=v.version if v else 3,
                        data_shards=data_shards,
                        parity_shards=parity_shards,
                    ),
                )
            except Exception as e:
                errors[str(vid)] = str(e)
        return {"errors": errors}

    async def _grpc_ec_rebuild(self, req, context) -> dict:
        """Rebuild missing local shards from the survivors (ref :77-106)."""
        vid = int(req["volume_id"])
        collection = req.get("collection", "")
        base = self._base_name(collection, vid)
        if base is None:
            return {"error": f"volume {vid} not found"}
        try:
            codec = self._codec_from_vif(base)
            pre_missing = [
                i
                for i in range(codec.total_shards)
                if not os.path.exists(base + to_ext(i))
            ]
            await self.run_blocking(lambda: rebuild_ec_files(base, codec=codec))
        except Exception as e:
            self.note_device_error("ec_rebuild", e)
            return {"error": str(e)}
        rebuilt = [i for i in pre_missing if os.path.exists(base + to_ext(i))]
        return {"rebuilt_shard_ids": rebuilt}

    async def _grpc_ec_rebuild_batch(self, req, context) -> dict:
        """Rebuild the missing shards of MANY local EC volumes in one call:
        volumes of one RS geometry stream through rebuild_ec_files_multi,
        whose device codec decodes same-matrix chunks of every volume in
        one launch. Returns {"results": {vid: {"rebuilt_shard_ids"}},
        "errors": {vid: message}}. A group that raises is counted in
        device_errors and retried volume by volume on the same codec, so
        one broken survivor set cannot sink its neighbours."""
        vids = [int(v) for v in req.get("volume_ids", [])]
        collection = req.get("collection", "")
        results: dict = {}
        errors: dict = {}
        by_codec: dict = {}
        for vid in vids:
            base = self._base_name(collection, vid)
            if base is None:
                errors[str(vid)] = f"volume {vid} not found"
                continue
            try:
                codec = self._codec_from_vif(base)
            except Exception as e:
                errors[str(vid)] = str(e)
                continue
            by_codec.setdefault(id(codec), (codec, []))[1].append((vid, base))
        for codec, group in by_codec.values():
            # survey BEFORE rebuilding: a retried volume the batch already
            # committed would otherwise report [] and never get mounted
            pre_missing = {
                vid: [
                    i for i in range(codec.total_shards)
                    if not os.path.exists(base + to_ext(i))
                ]
                for vid, base in group
            }
            try:
                await self.run_blocking(
                    lambda c=codec, g=group: rebuild_ec_files_multi(
                        [b for _vid, b in g], codec=c
                    )
                )
                for vid, _base in group:
                    results[str(vid)] = {"rebuilt_shard_ids": pre_missing[vid]}
            except Exception as e:
                self.note_device_error("ec_rebuild_batch", e)
                for vid, base in group:
                    try:
                        await self.run_blocking(
                            lambda b=base, c=codec: rebuild_ec_files(b, codec=c)
                        )
                        results[str(vid)] = {
                            "rebuilt_shard_ids": pre_missing[vid]
                        }
                    except Exception as e2:
                        self.note_device_error("ec_rebuild", e2)
                        errors[str(vid)] = str(e2)
        return {"results": results, "errors": errors}

    async def _grpc_ec_shards_to_volume(self, req, context) -> dict:
        """Decode the local data shards back into a normal volume (ref
        volume_grpc_erasure_coding.go:354-391): .dat from the data shards
        up to the original size the live .ecx entries give, .idx from the
        .ecx plus a tombstone per .ecj entry. Refuses unless all k data
        shards are local."""
        if req.get("plane"):
            return {"error": "not ported: plane"}
        vid = int(req["volume_id"])
        collection = req.get("collection", "")
        base = self._base_name(collection, vid)
        if base is None or not os.path.exists(base + ".ecx"):
            return {"error": f"ec volume {vid} not found"}
        # the vid returns to (and may later leave again) the normal-volume
        # world: its cached spans must not outlive this generation
        self._ec_degraded_cache().invalidate(vid)
        try:
            codec = self._codec_from_vif(base)
        except Exception as e:
            return {"error": str(e)}
        missing = [
            i for i in range(codec.data_shards)
            if not os.path.exists(base + to_ext(i))
        ]
        if missing:
            return {
                "error": f"need all data shards locally to decode, missing {missing}"
            }
        try:
            dat_size = await self.run_blocking(find_dat_file_size, base)
            await self.run_blocking(write_dat_file, base, dat_size,
                                    codec.data_shards)
            await self.run_blocking(write_idx_file_from_ec_index, base)
            return {}
        except Exception as e:
            return {"error": str(e)}

    async def _grpc_ec_info(self, req, context) -> dict:
        """RS geometry of a local EC volume from its .vif."""
        vid = int(req["volume_id"])
        collection = req.get("collection", "")
        base = self._base_name(collection, vid)
        if base is None:
            return {"error": f"volume {vid} not found"}
        info = load_volume_info(base + ".vif")
        k = info.data_shards if info and info.data_shards else DATA_SHARDS_COUNT
        m = (
            info.parity_shards
            if info and info.data_shards
            else TOTAL_SHARDS_COUNT - DATA_SHARDS_COUNT
        )
        return {"data_shards": k, "parity_shards": m}

    def _codec_from_vif(self, base: str):
        """Codec matching the geometry in the .vif (10.4 default)."""
        info = load_volume_info(base + ".vif")
        if info is not None and info.data_shards:
            return self.codec_for(info.data_shards, info.parity_shards)
        return self.codec

    async def _grpc_ec_copy(self, req, context) -> dict:
        """Pull shards (+ index files) from a source server via its
        CopyFile stream (ref :108-164)."""
        vid = int(req["volume_id"])
        collection = req.get("collection", "")
        shard_ids = [int(s) for s in req.get("shard_ids", [])]
        source = req["source_data_node"]
        loc = max(
            self.store.locations,
            key=lambda l: l.max_volume_count - len(l.volumes),
        )
        base = volume_base_name(loc.directory, collection, vid)
        stub = Stub(grpc_address(source), "volume")

        async def pull(ext: str) -> None:
            tmp = base + ext + ".tmp"
            try:
                with open(tmp, "wb") as f:
                    async for msg in stub.server_stream(
                        "CopyFile",
                        {"volume_id": vid, "collection": collection,
                         "ext": ext, "is_ec_volume": True},
                    ):
                        if msg.get("error"):
                            raise IOError(msg["error"])
                        f.write(msg.get("file_content", b""))
            except BaseException:
                try:
                    os.remove(tmp)
                except FileNotFoundError:
                    pass
                raise
            os.replace(tmp, base + ext)

        try:
            for shard_id in shard_ids:
                await pull(to_ext(shard_id))
            if req.get("copy_ecx_file", True):
                await pull(".ecx")
                try:
                    await pull(".ecj")
                except Exception:
                    with open(base + ".ecj", "wb"):
                        pass
                try:
                    await pull(".vif")
                except Exception:
                    save_volume_info(base + ".vif", VolumeInfo(version=3))
            return {}
        except Exception as e:
            return {"error": str(e)}

    async def _grpc_ec_delete(self, req, context) -> dict:
        """Remove local shard files; drop the index files with the last
        shard (ref :166-216)."""
        vid = int(req["volume_id"])
        collection = req.get("collection", "")
        shard_ids = [int(s) for s in req.get("shard_ids", [])]
        base = self._base_name(collection, vid)
        if base is None:
            return {}
        self._ec_degraded_cache().invalidate(vid)
        for shard_id in shard_ids:
            try:
                os.remove(base + to_ext(shard_id))
            except FileNotFoundError:
                pass
        if not any(os.path.exists(base + to_ext(i)) for i in range(32)):
            for ext in (".ecx", ".ecj", ".vif"):
                try:
                    os.remove(base + ext)
                except FileNotFoundError:
                    pass
        return {}

    async def _grpc_ec_mount(self, req, context) -> dict:
        """(ref :218-244)"""
        vid = int(req["volume_id"])
        collection = req.get("collection", "")
        shard_ids = [int(s) for s in req.get("shard_ids", [])]
        added = ShardBits()
        try:
            for shard_id in shard_ids:
                for loc in self.store.locations:
                    base = volume_base_name(loc.directory, collection, vid)
                    if os.path.exists(base + to_ext(shard_id)):
                        loc.load_ec_shard(collection, vid, shard_id)
                        added = added.add(shard_id)
                        break
            if added.bits:
                self.store.note_ec_shards_changed(
                    vid, collection, added, ShardBits()
                )
            return {}
        except Exception as e:
            return {"error": str(e)}

    async def _grpc_ec_unmount(self, req, context) -> dict:
        """(ref :246-268)"""
        vid = int(req["volume_id"])
        shard_ids = [int(s) for s in req.get("shard_ids", [])]
        self._ec_degraded_cache().invalidate(vid)
        removed = ShardBits()
        for shard_id in shard_ids:
            for loc in self.store.locations:
                if loc.unload_ec_shard(vid, shard_id):
                    removed = removed.add(shard_id)
                    break
        if removed.bits:
            self.store.note_ec_shards_changed(vid, "", ShardBits(), removed)
        return {}

    async def _grpc_ec_shard_read(self, req, context):
        """Stream bytes of one local shard (ref :270-325)."""
        vid = int(req["volume_id"])
        shard_id = int(req["shard_id"])
        offset = int(req.get("offset", 0))
        size = int(req.get("size", 0))
        shard = self.store.find_ec_shard(vid, shard_id)
        if shard is None:
            yield {"error": f"ec shard {vid}.{shard_id} not found"}
            return
        # optional liveness check of the whole needle (ref :283-298)
        if req.get("file_key"):
            ev = self.store.find_ec_volume(vid)
            if ev is not None:
                try:
                    _, nsize = ev.find_needle_from_ecx(int(req["file_key"]))
                    if nsize == TOMBSTONE_FILE_SIZE:
                        yield {"is_deleted": True}
                        return
                except NeedleNotFound:
                    pass
        left = size
        pos = offset
        while left > 0:
            chunk = shard.read_at(min(1 << 20, left), pos)
            if not chunk:
                break
            yield {"data": chunk}
            pos += len(chunk)
            left -= len(chunk)

    async def _grpc_ec_blob_delete(self, req, context) -> dict:
        """Tombstone a needle in the local .ecx/.ecj (ref :327-352)."""
        vid = int(req["volume_id"])
        ev = self.store.find_ec_volume(vid)
        if ev is None:
            return {}
        await self.run_blocking(ev.delete_needle_from_ecx, int(req["file_key"]))
        self._ec_degraded_cache().invalidate(ev.volume_id)
        return {}

    def codec_for(self, data_shards: int, parity_shards: int):
        """Geometry-specific codec on the server's backend and device,
        cached per (k, m); self.codec stays the 10.4 instance."""
        if (
            data_shards == self.codec.data_shards
            and parity_shards == self.codec.parity_shards
        ):
            return self.codec
        cache = getattr(self, "_geometry_codecs", None)
        if cache is None:
            cache = self._geometry_codecs = {}
        key = (data_shards, parity_shards)
        if key not in cache:
            cache[key] = self.make_codec(data_shards, parity_shards)
        return cache[key]

    def _ec_degraded_cache(self) -> DegradedIntervalCache:
        cache = getattr(self, "_degraded_cache", None)
        if cache is None:
            cache = self._degraded_cache = DegradedIntervalCache()
        return cache

    # ---------------- EC read path (ref store_ec.go:119-373) ----------------
    async def _refresh_shard_locations(
        self, ev: EcVolume, force: bool = False
    ) -> None:
        now = time.time()
        if not self.master or (
            not force
            and now - ev.shard_locations_refresh_time < SHARD_LOCATION_TTL
        ):
            return
        stub = Stub(grpc_address(self.master), "master")
        try:
            resp = await stub.call("LookupEcVolume",
                                   {"volume_id": ev.volume_id})
        except Exception:
            return
        if resp.get("error"):
            return
        with ev.shard_locations_lock:
            ev.shard_locations.clear()
            for entry in resp.get("shard_id_locations", []):
                ev.shard_locations[int(entry["shard_id"])] = [
                    loc["url"] for loc in entry["locations"]
                ]
            ev.shard_locations_refresh_time = now

    async def _read_remote_shard_once(
        self, ev: EcVolume, url: str, shard_id: int, offset: int, size: int,
        file_key: int, deadline: Optional[float],
    ) -> bytes:
        stub = Stub(grpc_address(url), "volume")
        buf = bytearray()
        async for msg in stub.server_stream(
            "VolumeEcShardRead",
            {
                "volume_id": ev.volume_id,
                "shard_id": shard_id,
                "offset": offset,
                "size": size,
                "file_key": file_key,
            },
            timeout=remaining(deadline, 30.0),
        ):
            if msg.get("error"):
                raise IOError(msg["error"])
            if msg.get("is_deleted"):
                raise _Deleted()
            buf.extend(msg.get("data", b""))
        return bytes(buf)

    async def _read_remote_shard_interval(
        self,
        ev: EcVolume,
        shard_id: int,
        offset: int,
        size: int,
        file_key: int,
        deadline: Optional[float] = None,
    ) -> Optional[bytes]:
        """Try each known holder of the shard; per-url transient failures
        get one jittered retry, and every RPC's timeout is the remaining
        read deadline. Raises _Deleted on a tombstone answer."""
        with ev.shard_locations_lock:
            urls = list(ev.shard_locations.get(shard_id, []))
        budget = shared_retry_budget()
        for url in urls:
            if url in (self.address, self.public_url):
                continue
            for attempt in range(EC_REMOTE_READ_POLICY.attempts):
                if deadline is not None and time.monotonic() >= deadline:
                    return None
                try:
                    result = await self._read_remote_shard_once(
                        ev, url, shard_id, offset, size, file_key, deadline
                    )
                except _Deleted:
                    raise
                except Exception:
                    budget.on_failure()
                    if attempt == EC_REMOTE_READ_POLICY.attempts - 1:
                        break  # next url
                    if not budget.allow("ec_remote_read"):
                        break  # budget dry: no second chance, next url
                    RETRY_COUNTER.inc(op="ec_remote_read")
                    d = EC_REMOTE_READ_POLICY.delay(attempt, random)
                    if deadline is not None:
                        d = min(d, max(0.0, deadline - time.monotonic()))
                    await asyncio.sleep(d)
                else:
                    budget.on_success()
                    return result
        return None

    async def _read_one_ec_interval(
        self,
        ev: EcVolume,
        shard_id: int,
        offset: int,
        size: int,
        file_key: int,
        deadline: Optional[float] = None,
    ) -> Optional[bytes]:
        shard = ev.find_shard(shard_id)
        if shard is not None:
            return shard.read_at(size, offset)
        if deadline is None:
            deadline = deadline_after(EC_READ_DEADLINE_SECONDS)
        await self._refresh_shard_locations(ev)
        try:
            data = await self._read_remote_shard_interval(
                ev, shard_id, offset, size, file_key, deadline
            )
            if data is not None:
                return data
            # the cached locations may be stale (ref store_ec.go:211):
            # force-refresh and retry in bounded rounds within the deadline
            if self.master:
                for _ in range(EC_REFRESH_ROUNDS):
                    if time.monotonic() >= deadline:
                        break
                    RETRY_COUNTER.inc(op="ec_location_refresh")
                    await self._refresh_shard_locations(ev, force=True)
                    data = await self._read_remote_shard_interval(
                        ev, shard_id, offset, size, file_key, deadline
                    )
                    if data is not None:
                        return data
        except _Deleted:
            return None
        # degraded: reconstruct from any k other shards
        # (ref store_ec.go:319-373)
        return await self._recover_one_interval(
            ev, shard_id, offset, size, file_key, deadline
        )

    async def _recover_one_interval(
        self, ev: EcVolume, missing_shard: int, offset: int, size: int,
        file_key: int = 0, deadline: Optional[float] = None,
    ) -> Optional[bytes]:
        """Reconstruct [offset, offset+size) of a shard nobody can serve:
        the survivor intervals (local preads and remote streams) are
        fetched concurrently, decoded missing-row-only on the server's
        codec, and the whole readahead-widened span is kept in the
        degraded-read cache."""
        import numpy as np

        cache = self._ec_degraded_cache()
        hit = cache.get(ev.volume_id, missing_shard, offset, size)
        if hit is not None:
            EC_RECONSTRUCTIONS.inc(kind="cache_hit")
            return hit
        span_start, span_size = cache.span_for(
            offset, size, ev.shard_size() or None
        )
        total = ev.total_shards
        bufs: list = [None] * total

        async def fetch(shard_id: int) -> None:
            shard = ev.find_shard(shard_id)
            if shard is not None:
                b = shard.read_at(span_size, span_start)
            else:
                try:
                    b = await self._read_remote_shard_interval(
                        ev, shard_id, span_start, span_size, file_key,
                        deadline,
                    )
                except _Deleted:
                    b = None
            if b is not None and len(b) == span_size:
                bufs[shard_id] = np.frombuffer(b, dtype=np.uint8)

        candidates = [i for i in range(total) if i != missing_shard]
        local = [i for i in candidates if ev.find_shard(i) is not None]
        remote = [i for i in candidates if ev.find_shard(i) is None]
        # local survivors are preads, take them all; remote survivors cost
        # span_size network bytes each, so ask only as many holders as the
        # decode needs plus one spare, widening on a shortfall
        needed = max(0, ev.data_shards - len(local))
        first = remote[: needed + 1] if needed else []
        await asyncio.gather(*(fetch(i) for i in local + first))
        if sum(1 for b in bufs if b is not None) < ev.data_shards:
            rest = [i for i in remote if i not in first]
            if rest:
                await asyncio.gather(*(fetch(i) for i in rest))
        present = [i for i in range(total) if bufs[i] is not None]
        if len(present) < ev.data_shards:
            return None
        keep = present[: ev.data_shards]
        trimmed: list = [bufs[i] if i in keep else None for i in range(total)]
        codec = self.codec_for(ev.data_shards, ev.parity_shards)
        rows = await self.run_blocking(
            lambda: codec.reconstruct_rows(trimmed, [missing_shard])
        )
        out = rows[0]
        if out is None:
            return None
        span = np.ascontiguousarray(out).tobytes()
        cache.put(ev.volume_id, missing_shard, span_start, span)
        EC_RECONSTRUCTIONS.inc(kind="cold")
        return span[offset - span_start : offset - span_start + size]

    async def read_ec_needle(self, ev: EcVolume, key: int) -> Optional[Needle]:
        try:
            offset_units, size = ev.find_needle_from_ecx(key)
        except NeedleNotFound:
            return None
        if size == TOMBSTONE_FILE_SIZE:
            return None
        return await self.read_ec_needle_at(ev, key, offset_units, size)

    async def read_ec_needle_at(
        self, ev: EcVolume, key: int, offset_units: int, size: int
    ) -> Optional[Needle]:
        """Interval reads for an already-located needle; None when an
        interval can be neither read nor reconstructed. One deadline
        covers the whole needle."""
        deadline = deadline_after(EC_READ_DEADLINE_SECONDS)
        chunks = []
        for iv in ev.intervals_for(offset_units, size):
            shard_id, shard_offset = iv.to_shard_id_and_offset(
                ev.large_block_size, ev.small_block_size
            )
            data = await self._read_one_ec_interval(
                ev, shard_id, shard_offset, iv.size, key, deadline
            )
            if data is None or len(data) != iv.size:
                return None
            chunks.append(data)
        n = Needle()
        n.read_bytes(b"".join(chunks), to_actual_offset(offset_units), size,
                     ev.version)
        return n

    async def delete_ec_needle(self, ev: EcVolume, key: int) -> int:
        """Tombstone locally + fan out to every shard holder
        (ref store_ec_delete.go:15-110)."""
        try:
            _, size = ev.find_needle_from_ecx(key)
        except NeedleNotFound:
            return 0
        if size == TOMBSTONE_FILE_SIZE:
            return 0
        await self.run_blocking(ev.delete_needle_from_ecx, key)
        self._ec_degraded_cache().invalidate(ev.volume_id)
        await self._refresh_shard_locations(ev)
        urls = set()
        with ev.shard_locations_lock:
            for shard_urls in ev.shard_locations.values():
                urls.update(shard_urls)
        urls.discard(self.address)
        urls.discard(self.public_url)

        async def one(url: str) -> None:
            stub = Stub(grpc_address(url), "volume")
            try:
                await stub.call(
                    "VolumeEcBlobDelete",
                    {
                        "volume_id": ev.volume_id,
                        "collection": ev.collection,
                        "file_key": key,
                        "version": ev.version,
                    },
                )
            except Exception:
                pass

        await asyncio.gather(*(one(u) for u in urls))
        return size
