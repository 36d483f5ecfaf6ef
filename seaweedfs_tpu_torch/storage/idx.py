"""Needle-map index (.idx/.ecx) entry codec.

16-byte entries: key u64 BE | offset u32 BE (in 8-byte units) | size u32 BE
(ref: weed/storage/idx/walk.go:13-53, weed/storage/types/needle_types.go:27).

Also provides vectorized numpy parse/serialize of a whole index file and the
newest-wins fold that turns an .idx log into the sorted .ecx.
"""

from __future__ import annotations

from typing import BinaryIO, Iterator

import numpy as np

from ..types import (
    NEEDLE_MAP_ENTRY_SIZE,
    OFFSET_SIZE,
    TOMBSTONE_FILE_SIZE,
    bytes_to_offset,
    bytes_to_u32,
    bytes_to_u64,
    offset_to_bytes,
    u32_to_bytes,
    u64_to_bytes,
)

ROW_BATCH = 1024 * 1024  # entries per read batch when walking


def entry_to_bytes(key: int, offset_units: int, size: int) -> bytes:
    return u64_to_bytes(key) + offset_to_bytes(offset_units) + u32_to_bytes(size)


def parse_entry(b: bytes) -> tuple[int, int, int]:
    """-> (key, offset_units, size)"""
    return (
        bytes_to_u64(b[0:8]),
        bytes_to_offset(b[8 : 8 + OFFSET_SIZE]),
        bytes_to_u32(b[8 + OFFSET_SIZE : NEEDLE_MAP_ENTRY_SIZE]),
    )


def iter_index(f: BinaryIO) -> Iterator[tuple[int, int, int]]:
    """Iterate (key, offset_units, size) over an open .idx stream."""
    while True:
        chunk = f.read(NEEDLE_MAP_ENTRY_SIZE * ROW_BATCH)
        if not chunk:
            return
        usable = len(chunk) - (len(chunk) % NEEDLE_MAP_ENTRY_SIZE)
        for i in range(0, usable, NEEDLE_MAP_ENTRY_SIZE):
            yield parse_entry(chunk[i : i + NEEDLE_MAP_ENTRY_SIZE])
        if usable != len(chunk):
            return


def parse_index_bytes(data: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized parse: -> (keys u64[n], offset_units u32|u64[n], sizes
    u32[n]); offsets widen to u64 under the 5-byte variant."""
    n = len(data) // NEEDLE_MAP_ENTRY_SIZE
    arr = np.frombuffer(data[: n * NEEDLE_MAP_ENTRY_SIZE], dtype=np.uint8).reshape(
        n, NEEDLE_MAP_ENTRY_SIZE
    )
    keys = arr[:, 0:8].copy().view(">u8").reshape(n).astype(np.uint64)
    low = arr[:, 8:12].copy().view(">u4").reshape(n)
    if OFFSET_SIZE == 5:
        offsets = low.astype(np.uint64) | (
            arr[:, 12].astype(np.uint64) << np.uint64(32)
        )
    else:
        offsets = low.astype(np.uint32)
    sizes = (
        arr[:, 8 + OFFSET_SIZE : NEEDLE_MAP_ENTRY_SIZE]
        .copy()
        .view(">u4")
        .reshape(n)
        .astype(np.uint32)
    )
    return keys, offsets, sizes


def entries_to_bytes(
    keys: np.ndarray, offset_units: np.ndarray, sizes: np.ndarray
) -> bytes:
    """Vectorized serialize of index entries (inverse of parse_index_bytes)."""
    n = len(keys)
    arr = np.empty((n, NEEDLE_MAP_ENTRY_SIZE), dtype=np.uint8)
    arr[:, 0:8] = np.ascontiguousarray(keys, dtype=">u8").view(np.uint8).reshape(n, 8)
    units = np.ascontiguousarray(offset_units, dtype=np.uint64)
    arr[:, 8:12] = (
        np.ascontiguousarray(units & np.uint64(0xFFFFFFFF), dtype=">u4")
        .view(np.uint8)
        .reshape(n, 4)
    )
    if OFFSET_SIZE == 5:
        arr[:, 12] = (units >> np.uint64(32)).astype(np.uint8)
    arr[:, 8 + OFFSET_SIZE : NEEDLE_MAP_ENTRY_SIZE] = (
        np.ascontiguousarray(sizes, dtype=">u4").view(np.uint8).reshape(n, 4)
    )
    return arr.tobytes()


def fold_live_columns(
    keys: np.ndarray, offsets: np.ndarray, sizes: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Replay an .idx entry stream to its LIVE set, vectorized: each
    key's newest entry wins (np.unique over the reversed key column),
    keys whose newest entry is a tombstone drop out. Returns key-sorted
    (keys u64, offset_units, sizes u32)."""
    n = len(keys)
    if n == 0:
        return (
            np.empty(0, dtype=np.uint64),
            np.empty(0, dtype=offsets.dtype),
            np.empty(0, dtype=np.uint32),
        )
    uniq_keys, rev_first = np.unique(keys[::-1], return_index=True)
    last = n - 1 - rev_first  # each key's newest entry
    off = offsets[last]
    sz = sizes[last]
    alive = (off != 0) & (sz != TOMBSTONE_FILE_SIZE)
    return uniq_keys[alive], off[alive], sz[alive]
