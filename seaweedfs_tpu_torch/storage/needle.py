"""Needle (stored-file record) format, versions 1-3.

Byte-compatible with the reference (ref: weed/storage/needle/needle.go:24-44,
needle_read_write.go):

header (16B): cookie u32 | id u64 | size u32          (all big-endian)
v1 body:      data[size] | crc u32 | padding
v2 body (when data_size>0):
    data_size u32 | data | flags u8
    [name_size u8 | name]   if FLAG_HAS_NAME
    [mime_size u8 | mime]   if FLAG_HAS_MIME
    [last_modified 5B]      if FLAG_HAS_LAST_MODIFIED_DATE
    [ttl 2B]                if FLAG_HAS_TTL
    [pairs_size u16 | pairs] if FLAG_HAS_PAIRS
  then: crc u32 | padding
v3 body:      v2 body with AppendAtNs u64 between crc and padding

``size`` counts the v2 body fields only (4 + data_size + 1 + optionals,
ref needle_read_write.go:61-79); the record is padded so the total length is a
multiple of 8 — note the reference pads 1..8 bytes (never 0)
(ref needle_read_write.go:291-297).
"""

from __future__ import annotations

import io
from dataclasses import dataclass

from ..types import (
    NEEDLE_CHECKSUM_SIZE,
    NEEDLE_HEADER_SIZE,
    NEEDLE_PADDING_SIZE,
    TIMESTAMP_SIZE,
    VERSION1,
    VERSION2,
    VERSION3,
    bytes_to_u16,
    bytes_to_u32,
    bytes_to_u64,
    u32_to_bytes,
    u64_to_bytes,
)
from ..util.crc import masked_crc
from .ttl import TTL

FLAG_IS_COMPRESSED = 0x01
FLAG_HAS_NAME = 0x02
FLAG_HAS_MIME = 0x04
FLAG_HAS_LAST_MODIFIED_DATE = 0x08
FLAG_HAS_TTL = 0x10
FLAG_HAS_PAIRS = 0x20
FLAG_IS_CHUNK_MANIFEST = 0x80

LAST_MODIFIED_BYTES_LENGTH = 5
TTL_BYTES_LENGTH = 2

PAIR_NAME_PREFIX = "Seaweed-"

# hot-path packers (to_bytes): bound struct.Struct methods beat
# int.to_bytes-per-field by several us per needle
import struct as _struct

_pack_header = _struct.Struct(">IQI").pack_into  # cookie, id, size
_pack_u16 = _struct.Struct(">H").pack_into
_pack_u32 = _struct.Struct(">I").pack_into
_pack_u64 = _struct.Struct(">Q").pack_into


class CrcError(Exception):
    """Data on disk corrupted (CRC mismatch)."""


class NotFoundError(Exception):
    """Entry not found / size mismatch."""


def padding_length(needle_size: int, version: int) -> int:
    """Ref needle_read_write.go:291-297 — pads 1..8, never 0."""
    if version == VERSION3:
        return NEEDLE_PADDING_SIZE - (
            (NEEDLE_HEADER_SIZE + needle_size + NEEDLE_CHECKSUM_SIZE + TIMESTAMP_SIZE)
            % NEEDLE_PADDING_SIZE
        )
    return NEEDLE_PADDING_SIZE - (
        (NEEDLE_HEADER_SIZE + needle_size + NEEDLE_CHECKSUM_SIZE) % NEEDLE_PADDING_SIZE
    )


def needle_body_length(needle_size: int, version: int) -> int:
    if version == VERSION3:
        return (
            needle_size
            + NEEDLE_CHECKSUM_SIZE
            + TIMESTAMP_SIZE
            + padding_length(needle_size, version)
        )
    return needle_size + NEEDLE_CHECKSUM_SIZE + padding_length(needle_size, version)


def get_actual_size(size: int, version: int) -> int:
    """Total bytes the record occupies on disk."""
    return NEEDLE_HEADER_SIZE + needle_body_length(size, version)


@dataclass
class Needle:
    cookie: int = 0
    id: int = 0
    size: int = 0

    data: bytes = b""
    flags: int = 0
    name: bytes = b""
    mime: bytes = b""
    pairs: bytes = b""
    last_modified: int = 0  # seconds; 5 bytes on disk
    ttl: TTL | None = None

    checksum: int = 0  # masked crc as stored
    append_at_ns: int = 0  # version3

    # --- flags ---
    def is_compressed(self) -> bool:
        return bool(self.flags & FLAG_IS_COMPRESSED)

    def set_is_compressed(self) -> None:
        self.flags |= FLAG_IS_COMPRESSED

    def has_name(self) -> bool:
        return bool(self.flags & FLAG_HAS_NAME)

    def set_name(self, name: bytes) -> None:
        self.name = name[:255]
        if name:
            self.flags |= FLAG_HAS_NAME

    def has_mime(self) -> bool:
        return bool(self.flags & FLAG_HAS_MIME)

    def set_mime(self, mime: bytes) -> None:
        self.mime = mime[:255]
        if mime:
            self.flags |= FLAG_HAS_MIME

    def has_last_modified_date(self) -> bool:
        return bool(self.flags & FLAG_HAS_LAST_MODIFIED_DATE)

    def set_last_modified(self, ts: int) -> None:
        self.last_modified = ts
        self.flags |= FLAG_HAS_LAST_MODIFIED_DATE

    def has_ttl(self) -> bool:
        return bool(self.flags & FLAG_HAS_TTL)

    def set_ttl(self, ttl: TTL) -> None:
        self.ttl = ttl
        if ttl.count:
            self.flags |= FLAG_HAS_TTL

    def has_pairs(self) -> bool:
        return bool(self.flags & FLAG_HAS_PAIRS)

    def set_pairs(self, pairs: bytes) -> None:
        self.pairs = pairs
        if pairs:
            self.flags |= FLAG_HAS_PAIRS

    def is_chunked_manifest(self) -> bool:
        return bool(self.flags & FLAG_IS_CHUNK_MANIFEST)

    def set_is_chunk_manifest(self) -> None:
        """Mark this needle as a chunk manifest (ref: needle.go SetIsChunkManifest,
        set from the upload's cm=true form value, needle_parse_upload.go:177)."""
        self.flags |= FLAG_IS_CHUNK_MANIFEST

    def etag(self) -> str:
        return u32_to_bytes(self.checksum).hex()

    # --- serialization ---
    def _computed_size_v2(self) -> int:
        """Ref needle_read_write.go:60-79."""
        if len(self.data) == 0:
            return 0
        size = 4 + len(self.data) + 1
        if self.has_name():
            size += 1 + min(len(self.name), 255)
        if self.has_mime():
            size += 1 + min(len(self.mime), 255)
        if self.has_last_modified_date():
            size += LAST_MODIFIED_BYTES_LENGTH
        if self.has_ttl():
            size += TTL_BYTES_LENGTH
        if self.has_pairs():
            size += 2 + len(self.pairs)
        return size

    def to_bytes(self, version: int) -> tuple[bytes, int, int]:
        """Serialize; returns (record_bytes, size_for_index, actual_size).

        size_for_index is what goes into the needle map: len(data) for v1,
        data_size for v2/v3 — matching the reference's Append() return
        (ref needle_read_write.go:31-126).
        """
        self.checksum = masked_crc(self.data)
        if version == VERSION1:
            buf = io.BytesIO()
            self.size = len(self.data)
            buf.write(u32_to_bytes(self.cookie))
            buf.write(u64_to_bytes(self.id))
            buf.write(u32_to_bytes(self.size))
            buf.write(self.data)
            buf.write(u32_to_bytes(self.checksum))
            buf.write(b"\x00" * padding_length(self.size, version))
            return buf.getvalue(), self.size, NEEDLE_HEADER_SIZE + needle_body_length(
                self.size, version
            )
        if version not in (VERSION2, VERSION3):
            raise ValueError(f"unsupported version {version}")

        # single preallocated buffer + pack_into: this serializer sits on
        # the per-request write path and the BytesIO/many-small-writes
        # formulation was ~40us/needle at serving QPS rates
        self.size = self._computed_size_v2()
        dlen = len(self.data)
        actual = get_actual_size(self.size, version)
        out = bytearray(actual)  # padding arrives pre-zeroed
        _pack_header(out, 0, self.cookie, self.id, self.size)
        pos = NEEDLE_HEADER_SIZE
        if dlen > 0:
            _pack_u32(out, pos, dlen)
            pos += 4
            out[pos: pos + dlen] = self.data
            pos += dlen
            out[pos] = self.flags & 0xFF
            pos += 1
            if self.has_name():
                name = self.name[:255]
                out[pos] = len(name)
                out[pos + 1: pos + 1 + len(name)] = name
                pos += 1 + len(name)
            if self.has_mime():
                mime = self.mime[:255]
                out[pos] = len(mime)
                out[pos + 1: pos + 1 + len(mime)] = mime
                pos += 1 + len(mime)
            if self.has_last_modified_date():
                out[pos: pos + LAST_MODIFIED_BYTES_LENGTH] = u64_to_bytes(
                    self.last_modified
                )[8 - LAST_MODIFIED_BYTES_LENGTH:]
                pos += LAST_MODIFIED_BYTES_LENGTH
            if self.has_ttl() and self.ttl is not None:
                out[pos: pos + TTL_BYTES_LENGTH] = self.ttl.to_bytes()
                pos += TTL_BYTES_LENGTH
            if self.has_pairs():
                _pack_u16(out, pos, len(self.pairs))
                pos += 2
                out[pos: pos + len(self.pairs)] = self.pairs
                pos += len(self.pairs)
        _pack_u32(out, pos, self.checksum)
        pos += 4
        if version == VERSION3:
            _pack_u64(out, pos, self.append_at_ns)
        return bytes(out), dlen, actual

    # --- parsing ---
    def parse_header(self, b: bytes) -> None:
        self.cookie = bytes_to_u32(b[0:4])
        self.id = bytes_to_u64(b[4:12])
        self.size = bytes_to_u32(b[12:16])

    def _read_data_v2(self, b) -> None:
        """Ref needle_read_write.go:212-271.

        `b` may be a memoryview over the pread blob: `data` is kept as a
        zero-copy slice of it (serving renders straight from the buffer —
        copying every body was measurable at read-QPS rates), while the
        small optional fields are materialized as bytes so downstream
        `.decode()`-style consumers keep working."""
        index, n = 0, len(b)
        if index < n:
            data_size = bytes_to_u32(b[index : index + 4])
            index += 4
            if data_size + index > n:
                raise ValueError("index out of range 1")
            self.data = b[index : index + data_size]
            index += data_size
            self.flags = b[index]
            index += 1
        if index < n and self.has_name():
            name_size = b[index]
            index += 1
            if name_size + index > n:
                raise ValueError("index out of range 2")
            self.name = bytes(b[index : index + name_size])
            index += name_size
        if index < n and self.has_mime():
            mime_size = b[index]
            index += 1
            if mime_size + index > n:
                raise ValueError("index out of range 3")
            self.mime = bytes(b[index : index + mime_size])
            index += mime_size
        if index < n and self.has_last_modified_date():
            if LAST_MODIFIED_BYTES_LENGTH + index > n:
                raise ValueError("index out of range 4")
            self.last_modified = int.from_bytes(
                b[index : index + LAST_MODIFIED_BYTES_LENGTH], "big"
            )
            index += LAST_MODIFIED_BYTES_LENGTH
        if index < n and self.has_ttl():
            if TTL_BYTES_LENGTH + index > n:
                raise ValueError("index out of range 5")
            self.ttl = TTL.from_bytes(b[index : index + TTL_BYTES_LENGTH])
            index += TTL_BYTES_LENGTH
        if index < n and self.has_pairs():
            if 2 + index > n:
                raise ValueError("index out of range 6")
            pairs_size = bytes_to_u16(b[index : index + 2])
            index += 2
            if pairs_size + index > n:
                raise ValueError("index out of range 7")
            self.pairs = bytes(b[index : index + pairs_size])
            index += pairs_size

    def read_bytes(self, b: bytes, offset: int, size: int, version: int) -> None:
        """Hydrate from a full record blob; verifies size and CRC
        (ref needle_read_write.go:168-195)."""
        self.parse_header(b)
        if self.size != size:
            raise NotFoundError(
                f"entry not found: offset {offset} found id {self.id} "
                f"size {self.size}, expected size {size}"
            )
        mv = memoryview(b)  # body fields slice the blob zero-copy
        if version == VERSION1:
            self.data = mv[NEEDLE_HEADER_SIZE : NEEDLE_HEADER_SIZE + size]
        elif version in (VERSION2, VERSION3):
            self._read_data_v2(mv[NEEDLE_HEADER_SIZE : NEEDLE_HEADER_SIZE + self.size])
        else:
            raise ValueError(f"unsupported version {version}")
        if size > 0:
            stored = bytes_to_u32(
                b[NEEDLE_HEADER_SIZE + size : NEEDLE_HEADER_SIZE + size + NEEDLE_CHECKSUM_SIZE]
            )
            computed = masked_crc(self.data)
            if stored != computed:
                raise CrcError("CRC error! Data On Disk Corrupted")
            self.checksum = computed
        if version == VERSION3:
            ts = NEEDLE_HEADER_SIZE + size + NEEDLE_CHECKSUM_SIZE
            self.append_at_ns = bytes_to_u64(b[ts : ts + TIMESTAMP_SIZE])

    def read_needle_body_bytes(self, body: bytes, version: int) -> None:
        """Hydrate from body bytes after the header was parsed separately
        (ref needle_read_write.go:323-344). Does NOT verify CRC; recomputes it."""
        if not body:
            return
        if version == VERSION1:
            self.data = body[: self.size]
            self.checksum = masked_crc(self.data)
        elif version in (VERSION2, VERSION3):
            self._read_data_v2(body[: self.size])
            self.checksum = masked_crc(self.data)
            if version == VERSION3:
                ts = self.size + NEEDLE_CHECKSUM_SIZE
                self.append_at_ns = bytes_to_u64(body[ts : ts + TIMESTAMP_SIZE])
        else:
            raise ValueError(f"unsupported version {version}")


def read_needle_blob(backend_file, offset: int, size: int, version: int) -> bytes:
    return backend_file.read_at(get_actual_size(size, version), offset)


def read_needle_data(backend_file, offset: int, size: int, version: int) -> Needle:
    n = Needle()
    blob = read_needle_blob(backend_file, offset, size, version)
    n.read_bytes(blob, offset, size, version)
    return n


def read_needle_header(backend_file, version: int, offset: int) -> tuple[Needle, int]:
    """Returns (needle_with_header, body_length)."""
    b = backend_file.read_at(NEEDLE_HEADER_SIZE, offset)
    if len(b) < NEEDLE_HEADER_SIZE:
        raise EOFError("short read at needle header")
    n = Needle()
    n.parse_header(b)
    return n, needle_body_length(n.size, version)
