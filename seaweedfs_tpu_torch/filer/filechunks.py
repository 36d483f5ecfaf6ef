"""Chunk visibility: which byte ranges of which chunks are readable.

A file is a list of chunks that may overlap; for overlapping ranges the
chunk with the newest mtime wins (ref: weed/filer2/filechunks.go —
NonOverlappingVisibleIntervals / ReadFromChunks). Implemented as an
event-sweep over chunk boundaries rather than the reference's incremental
merge loop.

Ported whole from the JAX package's filer/filechunks.py.
"""

from __future__ import annotations

from dataclasses import dataclass

from .entry import FileChunk


def total_size(chunks: list[FileChunk]) -> int:
    return max((c.offset + c.size for c in chunks), default=0)


def etag(chunks: list[FileChunk]) -> str:
    if len(chunks) == 1:
        return chunks[0].etag
    import hashlib

    h = hashlib.md5()
    for c in chunks:
        h.update(c.etag.encode())
    return h.hexdigest()


@dataclass(frozen=True)
class VisibleInterval:
    start: int
    stop: int
    fid: str
    mtime_ns: int
    chunk_offset: int  # start of the owning chunk in the file
    cipher_key: bytes = b""  # owning chunk's content key ('' = plaintext)


def non_overlapping_visible_intervals(
    chunks: list[FileChunk],
) -> list[VisibleInterval]:
    """Newest-wins interval resolution, sorted by start."""
    if not chunks:
        return []
    bounds = sorted(
        {c.offset for c in chunks} | {c.offset + c.size for c in chunks}
    )
    # resolve each elementary segment to its newest covering chunk
    ordered = sorted(chunks, key=lambda c: (c.mtime_ns, c.fid))
    segments: list[VisibleInterval] = []
    for lo, hi in zip(bounds, bounds[1:]):
        winner = None
        for c in reversed(ordered):  # newest first
            if c.offset <= lo and hi <= c.offset + c.size:
                winner = c
                break
        if winner is None:
            continue
        segments.append(
            VisibleInterval(
                lo, hi, winner.fid, winner.mtime_ns, winner.offset,
                winner.cipher_key,
            )
        )
    # merge adjacent segments owned by the same chunk
    merged: list[VisibleInterval] = []
    for seg in segments:
        if (
            merged
            and merged[-1].fid == seg.fid
            and merged[-1].stop == seg.start
            and merged[-1].chunk_offset == seg.chunk_offset
        ):
            merged[-1] = VisibleInterval(
                merged[-1].start,
                seg.stop,
                seg.fid,
                seg.mtime_ns,
                seg.chunk_offset,
                seg.cipher_key,
            )
        else:
            merged.append(seg)
    return merged


@dataclass(frozen=True)
class ChunkView:
    fid: str
    offset_in_chunk: int  # where to start reading inside the chunk blob
    size: int
    logical_offset: int  # position in the file
    cipher_key: bytes = b""


def view_from_visibles(
    visibles: list[VisibleInterval], offset: int, size: int
) -> list[ChunkView]:
    """Chunk reads covering [offset, offset+size) (ref ViewFromVisibleIntervals)."""
    stop = offset + size
    views = []
    for v in visibles:
        if v.stop <= offset or v.start >= stop:
            continue
        lo = max(v.start, offset)
        hi = min(v.stop, stop)
        views.append(
            ChunkView(
                fid=v.fid,
                offset_in_chunk=lo - v.chunk_offset,
                size=hi - lo,
                logical_offset=lo,
                cipher_key=v.cipher_key,
            )
        )
    return views


def read_from_visible_intervals(
    visibles: list[VisibleInterval],
    fetch,  # fetch(fid) -> bytes (whole chunk blob)
    offset: int,
    size: int,
) -> bytes:
    """Assemble [offset, offset+size) from chunk blobs, zero-filling holes."""
    out = bytearray(size)
    for view in view_from_visibles(visibles, offset, size):
        blob = fetch(view.fid)
        piece = blob[view.offset_in_chunk : view.offset_in_chunk + view.size]
        pos = view.logical_offset - offset
        out[pos : pos + len(piece)] = piece
    return bytes(out)
