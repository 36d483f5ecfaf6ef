"""EcVolume: serving reads from erasure-coded shards on this host.

Holds the sorted .ecx index (binary-searched on disk) and whichever local
.ecNN shard files exist (ref: weed/storage/erasure_coding/ec_volume.go,
ec_shard.go). read_needle serves a needle from its shard intervals and
decodes an interval whose shard is missing from k local survivors through
the codec (the local-shard part of the JAX package's volume server
degraded read, server/volume_ec.py _recover_one_interval /
read_ec_needle_at).

bulk_locate answers a batch of needle ids from a snapshot of the live .ecx
entries kept on the card (ops/index_kernel.py), the bulk analogue of
find_needle_from_ecx.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Optional

import numpy as np

from . import (
    DATA_SHARDS_COUNT,
    EC_LARGE_BLOCK_SIZE,
    EC_SMALL_BLOCK_SIZE,
    TOTAL_SHARDS_COUNT,
    to_ext,
)
from ...types import (
    NEEDLE_ID_SIZE,
    NEEDLE_MAP_ENTRY_SIZE,
    OFFSET_SIZE,
    TOMBSTONE_FILE_SIZE,
    VERSION3,
    needle_id_to_bytes,
    to_actual_offset,
    u32_to_bytes,
)
from ..idx import parse_entry
from ..needle import Needle, get_actual_size
from .locate import Interval, locate_data


class NeedleNotFound(Exception):
    pass


def ec_shard_file_name(collection: str, directory: str, vid: int) -> str:
    if collection:
        return os.path.join(directory, f"{collection}_{vid}")
    return os.path.join(directory, str(vid))


class ShardBits:
    """uint32 bitmask of present shard ids (ref: ec_volume_info.go:61-110);
    iteration spans the full 32 bits so alternate geometries with more than
    14 shards (e.g. 12.4) are representable. Copied from the JAX package's
    storage/erasure_coding/ec_volume.py."""

    def __init__(self, bits: int = 0):
        self.bits = bits & 0xFFFFFFFF

    def add(self, shard_id: int) -> "ShardBits":
        return ShardBits(self.bits | (1 << shard_id))

    def remove(self, shard_id: int) -> "ShardBits":
        return ShardBits(self.bits & ~(1 << shard_id))

    def has(self, shard_id: int) -> bool:
        return bool(self.bits & (1 << shard_id))

    def shard_ids(self) -> list[int]:
        return [i for i in range(32) if self.has(i)]

    def count(self) -> int:
        return bin(self.bits).count("1")

    def minus(self, other: "ShardBits") -> "ShardBits":
        return ShardBits(self.bits & ~other.bits)

    def plus(self, other: "ShardBits") -> "ShardBits":
        return ShardBits(self.bits | other.bits)

    def minus_parity_shards(
        self, data_shards: int = DATA_SHARDS_COUNT
    ) -> "ShardBits":
        b = self
        for i in range(data_shards, 32):
            b = b.remove(i)
        return b

    def __eq__(self, other) -> bool:
        return isinstance(other, ShardBits) and self.bits == other.bits

    def __repr__(self) -> str:
        return f"ShardBits({self.shard_ids()})"


class EcVolumeShard:
    """One local .ecNN file (ref: ec_shard.go:16-110)."""

    def __init__(self, directory: str, collection: str, vid: int, shard_id: int):
        self.dir = directory
        self.collection = collection
        self.volume_id = vid
        self.shard_id = shard_id
        path = self.file_name() + to_ext(shard_id)
        self._f = open(path, "rb")
        self.size = os.path.getsize(path)

    def file_name(self) -> str:
        return ec_shard_file_name(self.collection, self.dir, self.volume_id)

    def read_at(self, size: int, offset: int) -> bytes:
        return os.pread(self._f.fileno(), size, offset)

    def close(self) -> None:
        self._f.close()


def search_needle_from_sorted_index(
    ecx_f,
    ecx_file_size: int,
    needle_id: int,
    process_fn: Optional[Callable[[object, int], None]] = None,
) -> tuple[int, int]:
    """Binary search the on-disk sorted .ecx; returns (offset_units, size).
    process_fn(file, entry_offset) runs on the matched entry while positioned
    (ref SearchNeedleFromSortedIndex, ec_volume.go:210-235)."""
    lo, hi = 0, ecx_file_size // NEEDLE_MAP_ENTRY_SIZE
    while lo < hi:
        mid = (lo + hi) // 2
        entry = os.pread(
            ecx_f.fileno(), NEEDLE_MAP_ENTRY_SIZE, mid * NEEDLE_MAP_ENTRY_SIZE
        )
        if len(entry) != NEEDLE_MAP_ENTRY_SIZE:
            raise IOError(f"ecx short read at {mid * NEEDLE_MAP_ENTRY_SIZE}")
        key, offset_units, size = parse_entry(entry)
        if key == needle_id:
            if process_fn is not None:
                process_fn(ecx_f, mid * NEEDLE_MAP_ENTRY_SIZE)
            return offset_units, size
        if key < needle_id:
            lo = mid + 1
        else:
            hi = mid
    raise NeedleNotFound(f"needle {needle_id} not found in ecx")


def mark_needle_deleted(f, entry_offset: int) -> None:
    """Tombstone the size field of an .ecx entry in place
    (ref MarkNeedleDeleted, ec_volume_delete.go:13-25)."""
    os.pwrite(
        f.fileno(),
        u32_to_bytes(TOMBSTONE_FILE_SIZE),
        entry_offset + NEEDLE_ID_SIZE + OFFSET_SIZE,  # key + offset come first
    )


class EcVolume:
    """An EC volume's .ecx, .vif and the shard files present in
    `directory`. Block sizes default to the reference's 1GB/1MB; they are
    parameters so shrunk test geometries read back what they wrote.
    `device` is where bulk_locate's .ecx snapshot lives: the card unless
    the caller asks for the CPU. `shard_ids` names the shard files to
    mount (None: every one present; the volume server mounts them one by
    one, as VolumeEcShardsMount asks)."""

    def __init__(
        self,
        directory: str,
        collection: str,
        vid: int,
        large_block_size: int = EC_LARGE_BLOCK_SIZE,
        small_block_size: int = EC_SMALL_BLOCK_SIZE,
        device=None,
        shard_ids=None,
    ):
        self.dir = directory
        self.collection = collection
        self.volume_id = vid
        self.large_block_size = large_block_size
        self.small_block_size = small_block_size
        base = self.file_name()
        if not os.path.exists(base + ".ecx"):
            raise FileNotFoundError(f"cannot open ec volume index {base}.ecx")
        self._ecx = open(base + ".ecx", "r+b")
        self.ecx_file_size = os.path.getsize(base + ".ecx")
        self.version = VERSION3
        # RS geometry: default 10.4, overridable per volume via .vif
        self.data_shards = DATA_SHARDS_COUNT
        self.parity_shards = TOTAL_SHARDS_COUNT - DATA_SHARDS_COUNT
        from ..volume_info import load_volume_info

        info = load_volume_info(base + ".vif")
        if info is not None and info.version:
            self.version = info.version
        if info is not None and info.data_shards:
            self.data_shards = info.data_shards
            self.parity_shards = info.parity_shards
        self.shards: list[EcVolumeShard] = []
        for sid in range(self.total_shards) if shard_ids is None else shard_ids:
            if os.path.exists(base + to_ext(sid)):
                self.shards.append(EcVolumeShard(directory, collection, vid, sid))
        # shard_id -> holder addresses, refreshed from the master by the
        # volume server's remote reads (server/volume_ec.py)
        self.shard_locations: dict[int, list[str]] = {}
        self.shard_locations_lock = threading.RLock()
        self.shard_locations_refresh_time = 0.0
        # the .ecj deletion journal (ref ec_volume_delete.go)
        self._ecj = None
        self._ecj_lock = threading.Lock()
        # device-resident .ecx snapshot for bulk probes; rebuilt after
        # tombstone writes (see bulk_locate)
        from ...ops.snapshot_cache import SnapshotCache

        self.device = device
        self._ecx_cache = SnapshotCache(device=device)
        self._ecx_mutations = 0

    def file_name(self) -> str:
        return ec_shard_file_name(self.collection, self.dir, self.volume_id)

    @property
    def total_shards(self) -> int:
        return self.data_shards + self.parity_shards

    def add_shard(self, shard: EcVolumeShard) -> bool:
        """Mount one more local shard file (ref: ec_volume.go AddEcVolumeShard)."""
        if any(s.shard_id == shard.shard_id for s in self.shards):
            return False
        self.shards.append(shard)
        self.shards.sort(key=lambda s: s.shard_id)
        return True

    def delete_shard(self, shard_id: int) -> Optional[EcVolumeShard]:
        """Unmount a shard; the caller closes it."""
        for i, s in enumerate(self.shards):
            if s.shard_id == shard_id:
                return self.shards.pop(i)
        return None

    def find_shard(self, shard_id: int) -> Optional[EcVolumeShard]:
        for s in self.shards:
            if s.shard_id == shard_id:
                return s
        return None

    def shard_ids(self) -> list[int]:
        return [s.shard_id for s in self.shards]

    def shard_bits(self) -> ShardBits:
        b = ShardBits()
        for s in self.shards:
            b = b.add(s.shard_id)
        return b

    def shard_size(self) -> int:
        return self.shards[0].size if self.shards else 0

    # --- lookup ---
    def find_needle_from_ecx(self, needle_id: int) -> tuple[int, int]:
        return search_needle_from_sorted_index(
            self._ecx, self.ecx_file_size, needle_id
        )

    def ecx_snapshot(self):
        """Live .ecx entries as sorted numpy columns
        (keys u64[n], offset_units u32[n], sizes u32[n]) — the probe table
        for the bulk-lookup kernel. Tombstoned entries are excluded."""
        from ..idx import parse_index_bytes

        keys, offsets, sizes = parse_index_bytes(
            os.pread(self._ecx.fileno(), self.ecx_file_size, 0)
        )
        live = sizes != TOMBSTONE_FILE_SIZE
        return keys[live], offsets[live], sizes[live]

    def bulk_locate(self, needle_ids, use_device: Optional[bool] = None):
        """Batched .ecx probes -> (offset_units u32[P], sizes u32[P],
        found bool[P]).

        One search on the card over a cached snapshot instead of P
        on-disk searches (ref SearchNeedleFromSortedIndex,
        ec_volume.go:210-235). use_device None: batches of 64 ids or more
        go to the snapshot, smaller ones (and the 5-byte offset build) to
        the on-disk search, as in the JAX package."""
        from ...types import OFFSET_SIZE

        needle_ids = np.asarray(needle_ids, dtype=np.uint64)
        if use_device is None:
            use_device = OFFSET_SIZE == 4 and len(needle_ids) >= 64
        if not use_device:
            off_dtype = np.uint64 if OFFSET_SIZE == 5 else np.uint32
            offsets = np.zeros(len(needle_ids), dtype=off_dtype)
            sizes = np.zeros(len(needle_ids), dtype=np.uint32)
            found = np.zeros(len(needle_ids), dtype=bool)
            for i, k in enumerate(needle_ids.tolist()):
                try:
                    o, s = self.find_needle_from_ecx(k)
                except NeedleNotFound:
                    continue
                if s != TOMBSTONE_FILE_SIZE:
                    offsets[i], sizes[i], found[i] = o, s, True
            return offsets, sizes, found

        accel = self._ecx_cache.get(
            lambda: self._ecx_mutations, self.ecx_snapshot
        )
        return accel.lookup(needle_ids)

    def intervals_for(self, offset_units: int, size: int) -> list[Interval]:
        """Shard intervals for an already-located needle."""
        return locate_data(
            self.large_block_size,
            self.small_block_size,
            self.data_shards * self.shard_size(),
            to_actual_offset(offset_units),
            get_actual_size(size, self.version),
            data_shards=self.data_shards,
        )

    def locate_needle(self, needle_id: int) -> tuple[int, int, list[Interval]]:
        """-> (offset_units, size, intervals)
        (ref LocateEcShardNeedle, ec_volume.go:190-206)."""
        offset_units, size = self.find_needle_from_ecx(needle_id)
        return offset_units, size, self.intervals_for(offset_units, size)

    # --- delete ---
    def delete_needle_from_ecx(self, needle_id: int) -> None:
        """Tombstone in .ecx + journal to .ecj
        (ref DeleteNeedleFromEcx, ec_volume_delete.go:27-49)."""
        try:
            search_needle_from_sorted_index(
                self._ecx, self.ecx_file_size, needle_id, mark_needle_deleted
            )
        except NeedleNotFound:
            return
        self._ecx_mutations += 1
        with self._ecj_lock:
            if self._ecj is None:
                self._ecj = open(self.file_name() + ".ecj", "a+b")
            self._ecj.seek(0, 2)
            self._ecj.write(needle_id_to_bytes(needle_id))
            self._ecj.flush()

    # --- read ---
    def _recover_interval(
        self, missing_shard: int, offset: int, size: int, codec
    ) -> bytes:
        """[offset, offset+size) of a shard this host lacks, decoded from
        the same range of k local survivors (missing row only)."""
        total = self.total_shards
        bufs: list[Optional[np.ndarray]] = [None] * total
        have = 0
        for s in self.shards:
            if s.shard_id == missing_shard or have == self.data_shards:
                continue
            b = s.read_at(size, offset)
            if len(b) != size:
                raise IOError(
                    f"shard {s.shard_id} short read at {offset}: "
                    f"{len(b)} != {size}"
                )
            bufs[s.shard_id] = np.frombuffer(b, dtype=np.uint8)
            have += 1
        if have < self.data_shards:
            raise IOError(
                f"volume {self.volume_id}: {have} local shards, "
                f"{self.data_shards} needed to decode shard {missing_shard}"
            )
        out = codec.reconstruct_rows(bufs, [missing_shard])[0]
        return np.ascontiguousarray(out).tobytes()

    def read_needle(self, needle_id: int, codec) -> Needle:
        """Read a needle from the local shards; an interval on a missing
        shard is decoded through `codec`. Raises NeedleNotFound for an
        absent or deleted needle and CrcError on corrupt data."""
        offset_units, size = self.find_needle_from_ecx(needle_id)
        if size == TOMBSTONE_FILE_SIZE:
            raise NeedleNotFound(f"needle {needle_id} is deleted")
        chunks = []
        for iv in self.intervals_for(offset_units, size):
            shard_id, shard_offset = iv.to_shard_id_and_offset(
                self.large_block_size, self.small_block_size
            )
            shard = self.find_shard(shard_id)
            if shard is not None:
                data = shard.read_at(iv.size, shard_offset)
                if len(data) != iv.size:
                    raise IOError(
                        f"shard {shard_id} short read at {shard_offset}"
                    )
            else:
                data = self._recover_interval(
                    shard_id, shard_offset, iv.size, codec
                )
            chunks.append(data)
        n = Needle()
        n.read_bytes(
            b"".join(chunks), to_actual_offset(offset_units), size, self.version
        )
        return n

    def close(self) -> None:
        for s in self.shards:
            s.close()
        with self._ecj_lock:
            if self._ecj is not None:
                self._ecj.close()
        self._ecx.close()

    def __enter__(self) -> "EcVolume":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
