"""Incremental volume backup/tail by AppendAtNs.

Every v3 needle carries its append timestamp; since the .dat is append-only
the timestamps are monotonic, so a binary search over record boundaries
finds the resume offset for an incremental pull
(ref: weed/storage/volume_backup.go:65-170 BinarySearchForAppendAtNs).

Copied from the JAX package's storage/volume_backup.py: the tail the
master's anti-entropy plane replays into a stale replica (VolumeTailSync
over the VolumeIncrementalCopy stream).
"""

from __future__ import annotations

from typing import Iterator

from ..types import NEEDLE_HEADER_SIZE, VERSION3
from .needle import read_needle_header
from .volume import Volume


def _record_bounds(v: Volume) -> list[tuple[int, int]]:
    """(offset, append_at_ns) for every record, in file order."""
    bounds = []

    def visit(n, offset, body):
        bounds.append((offset, n.append_at_ns))

    v.scan(visit, read_body=True)
    return bounds


def binary_search_append_at_ns(v: Volume, since_ns: int) -> int:
    """Smallest file offset whose record has append_at_ns > since_ns;
    volume end when everything is older."""
    if v.version != VERSION3:
        # no timestamps before v3: restart from the superblock
        return v.super_block.block_size() if since_ns == 0 else v.data_file_size()
    bounds = _record_bounds(v)
    lo, hi = 0, len(bounds)
    while lo < hi:
        mid = (lo + hi) // 2
        if bounds[mid][1] <= since_ns:
            lo = mid + 1
        else:
            hi = mid
    if lo == len(bounds):
        return v.data_file_size()
    return bounds[lo][0]


def incremental_changes(
    v: Volume, since_ns: int, chunk: int = 1 << 20
) -> Iterator[bytes]:
    """Raw .dat bytes of all records appended after since_ns."""
    offset = binary_search_append_at_ns(v, since_ns)
    end = v.data_file_size()
    while offset < end:
        data = v.data_backend.read_at(min(chunk, end - offset), offset)
        if not data:
            return
        yield data
        offset += len(data)


def apply_incremental(v: Volume, data: bytes) -> int:
    """Append pulled records and replay them into the needle map; returns the
    number of records applied (ref volume_backup.go IncrementalBackup's
    write-back path)."""
    from ..types import TOMBSTONE_FILE_SIZE, to_offset_units
    from .needle import needle_body_length

    start = v.data_backend.size()
    v.data_backend.write_at(data, start)
    applied = 0
    offset = start
    end = v.data_backend.size()
    while offset + NEEDLE_HEADER_SIZE <= end:
        n, body_len = read_needle_header(v.data_backend, v.version, offset)
        body = v.data_backend.read_at(body_len, offset + NEEDLE_HEADER_SIZE)
        n.read_needle_body_bytes(body, v.version)
        if n.size > 0:
            v.nm.put(n.id, to_offset_units(offset), n.size)
        else:
            v.nm.delete(n.id, to_offset_units(offset))
        v.last_append_at_ns = n.append_at_ns
        offset += NEEDLE_HEADER_SIZE + body_len
        applied += 1
    return applied
