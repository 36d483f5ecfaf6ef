"""Core storage types and on-disk codec constants.

Byte-compatible with the reference formats:
- needle ids are uint64, cookies uint32 (ref: weed/storage/types/needle_id_type.go:9)
- all multi-byte integers on disk are big-endian (ref: weed/util/bytes.go:26)
- offsets are stored divided by NEEDLE_PADDING_SIZE (8) in 4 bytes, giving a
  32GB max volume size (ref: weed/storage/types/offset_4bytes.go:13-15); a
  5-byte variant extends that (ref: weed/storage/types/offset_5bytes.go)
- a needle-map index entry is key(8B) + offset(4B) + size(4B) = 16 bytes
  (ref: weed/storage/types/needle_types.go:27)
"""

from __future__ import annotations

import os
import struct

# --- sizes / limits (ref: weed/storage/types/needle_types.go:24-32) ---
SIZE_SIZE = 4
COOKIE_SIZE = 4
NEEDLE_ID_SIZE = 8
NEEDLE_HEADER_SIZE = COOKIE_SIZE + NEEDLE_ID_SIZE + SIZE_SIZE  # 16
# the reference's `5BytesOffset` build tag becomes an env switch here
# (ref: weed/storage/types/offset_5bytes.go, Makefile:20): 5-byte offsets
# extend the max volume from 32GB to 8TB with 17-byte idx entries
OFFSET_SIZE = 5 if os.environ.get("WEED_5BYTES_OFFSET", "") in ("1", "true") else 4
NEEDLE_MAP_ENTRY_SIZE = NEEDLE_ID_SIZE + OFFSET_SIZE + SIZE_SIZE  # 16 or 17
TIMESTAMP_SIZE = 8
NEEDLE_PADDING_SIZE = 8
NEEDLE_CHECKSUM_SIZE = 4
TOMBSTONE_FILE_SIZE = 0xFFFFFFFF

# offset bytes * 8-byte alignment => 32GB (4B) / 8TB (5B) max volume
# (ref: weed/storage/types/offset_4bytes.go:14, offset_5bytes.go:15)
MAX_POSSIBLE_VOLUME_SIZE = (1 << (8 * OFFSET_SIZE)) * NEEDLE_PADDING_SIZE

_U64 = struct.Struct(">Q")
_U32 = struct.Struct(">I")
_U16 = struct.Struct(">H")


# --- big-endian integer codecs (ref: weed/util/bytes.go) ---
def u64_to_bytes(v: int) -> bytes:
    return _U64.pack(v & 0xFFFFFFFFFFFFFFFF)


def bytes_to_u64(b: bytes) -> int:
    return _U64.unpack_from(b)[0]


def u32_to_bytes(v: int) -> bytes:
    return _U32.pack(v & 0xFFFFFFFF)


def bytes_to_u32(b: bytes) -> int:
    return _U32.unpack_from(b)[0]


def u16_to_bytes(v: int) -> bytes:
    return _U16.pack(v & 0xFFFF)


def bytes_to_u16(b: bytes) -> int:
    return _U16.unpack_from(b)[0]


# --- offsets ---
# We carry offsets as "units" (actual byte offset // NEEDLE_PADDING_SIZE),
# exactly as the reference packs them on disk (ref: weed/storage/types/offset_4bytes.go:50-58).
def to_offset_units(actual_offset: int) -> int:
    """Actual byte offset -> stored offset units (ref ToOffset)."""
    return actual_offset // NEEDLE_PADDING_SIZE


def to_actual_offset(offset_units: int) -> int:
    """Stored offset units -> actual byte offset (ref ToAcutalOffset)."""
    return offset_units * NEEDLE_PADDING_SIZE


def offset_to_bytes(offset_units: int) -> bytes:
    """On-disk offset: lower 32 bits big-endian, then (5-byte variant) the
    high byte last (ref: offset_4bytes.go OffsetToBytes, offset_5bytes.go:18
    — bytes[4] carries bits 32-39)."""
    low = _U32.pack(offset_units & 0xFFFFFFFF)
    if OFFSET_SIZE == 4:
        return low
    return low + bytes([(offset_units >> 32) & 0xFF])


def bytes_to_offset(b: bytes) -> int:
    v = _U32.unpack_from(b)[0]
    if OFFSET_SIZE == 5:
        v |= b[4] << 32
    return v



# --- needle id / cookie codecs (file ids, storage/file_id.py) ---
def needle_id_to_bytes(nid: int) -> bytes:
    return u64_to_bytes(nid)


def cookie_to_bytes(cookie: int) -> bytes:
    return u32_to_bytes(cookie)


# --- needle versions (ref: weed/storage/needle/volume_version.go) ---
VERSION1 = 1
VERSION2 = 2
VERSION3 = 3
CURRENT_VERSION = VERSION3
