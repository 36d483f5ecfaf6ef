"""Volume-server EC handlers: the EC RPCs and the EC read path.

Ported from the JAX package's server/volume_ec.py (ref: weed/server/
volume_grpc_erasure_coding.go:39-391, weed/storage/store_ec.go:119-373).
RPCs: VolumeEcShardsGenerate, VolumeEcShardsRebuild, VolumeEcShardsMount,
VolumeEcShardsUnmount, VolumeEcShardsDelete and VolumeEcShardsInfo. The
codec is the server's (`make_codec`: CudaRSCodec on the card, kernel
gf256.cu, for the volume's geometry); encode, rebuild and every decode
run on the server's executor, off the event loop.

Read path: locate the needle in the local sorted .ecx, map it to shard
intervals, read each interval from its local shard, else reconstruct it
from the local survivors on the card (missing row only), keeping the
readahead-widened span in the `DegradedIntervalCache`. Not ported yet:
the batched generate and rebuild calls, shard copies and reads between
servers (the `VolumeEcShardRead` and `CopyFile` streams) and the remote
shard reads of a degraded read that need them, needle deletes on EC
volumes, decoding back to a volume, and the cold tier.
"""

from __future__ import annotations

import os
from typing import Optional

from ..storage.erasure_coding import (
    DATA_SHARDS_COUNT,
    TOTAL_SHARDS_COUNT,
    rebuild_ec_files,
    to_ext,
    write_ec_files,
    write_sorted_file_from_idx,
)
from ..storage.erasure_coding.ec_volume import EcVolume, NeedleNotFound
from ..storage.volume import volume_base_name
from ..storage.volume_info import VolumeInfo, load_volume_info, save_volume_info
from ..types import TOMBSTONE_FILE_SIZE, to_actual_offset
from ..storage.needle import Needle
from ..util.metrics import EC_RECONSTRUCTIONS

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


class EcHandlers:
    """Mixin for VolumeServer (expects .store, .codec, .make_codec,
    .run_blocking and .note_device_error)."""

    def register_ec_rpcs(self, svc) -> None:
        svc.unary("VolumeEcShardsGenerate")(self._grpc_ec_generate)
        svc.unary("VolumeEcShardsRebuild")(self._grpc_ec_rebuild)
        svc.unary("VolumeEcShardsDelete")(self._grpc_ec_delete)
        svc.unary("VolumeEcShardsMount")(self._grpc_ec_mount)
        svc.unary("VolumeEcShardsUnmount")(self._grpc_ec_unmount)
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
        try:
            for shard_id in shard_ids:
                for loc in self.store.locations:
                    base = volume_base_name(loc.directory, collection, vid)
                    if os.path.exists(base + to_ext(shard_id)):
                        loc.load_ec_shard(collection, vid, shard_id)
                        break
            return {}
        except Exception as e:
            return {"error": str(e)}

    async def _grpc_ec_unmount(self, req, context) -> dict:
        """(ref :246-268)"""
        vid = int(req["volume_id"])
        shard_ids = [int(s) for s in req.get("shard_ids", [])]
        self._ec_degraded_cache().invalidate(vid)
        for shard_id in shard_ids:
            for loc in self.store.locations:
                if loc.unload_ec_shard(vid, shard_id):
                    break
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
    async def _read_one_ec_interval(
        self, ev: EcVolume, shard_id: int, offset: int, size: int
    ) -> Optional[bytes]:
        shard = ev.find_shard(shard_id)
        if shard is not None:
            return shard.read_at(size, offset)
        # degraded: reconstruct from the local survivors (the remote shard
        # holders of the JAX package's path wait for VolumeEcShardRead)
        return await self._recover_one_interval(ev, shard_id, offset, size)

    async def _recover_one_interval(
        self, ev: EcVolume, missing_shard: int, offset: int, size: int
    ) -> Optional[bytes]:
        """Reconstruct [offset, offset+size) of a shard this server lacks
        from k local survivors, missing row only, and keep the whole
        readahead-widened span in the degraded-read cache."""
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
        have = 0
        for i in range(total):
            shard = ev.find_shard(i) if i != missing_shard else None
            if shard is None or have == ev.data_shards:
                continue
            b = shard.read_at(span_size, span_start)
            if len(b) == span_size:
                bufs[i] = np.frombuffer(b, dtype=np.uint8)
                have += 1
        if have < ev.data_shards:
            return None
        codec = self.codec_for(ev.data_shards, ev.parity_shards)
        rows = await self.run_blocking(
            lambda: codec.reconstruct_rows(bufs, [missing_shard])
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
        interval can be neither read nor reconstructed here."""
        chunks = []
        for iv in ev.intervals_for(offset_units, size):
            shard_id, shard_offset = iv.to_shard_id_and_offset(
                ev.large_block_size, ev.small_block_size
            )
            data = await self._read_one_ec_interval(
                ev, shard_id, shard_offset, iv.size
            )
            if data is None or len(data) != iv.size:
                return None
            chunks.append(data)
        n = Needle()
        n.read_bytes(b"".join(chunks), to_actual_offset(offset_units), size,
                     ev.version)
        return n
