"""Backend storage-file abstraction.

Mirrors the reference's BackendStorageFile interface (read_at/write_at/
truncate/sync/size; ref: weed/storage/backend/backend.go:15-23) with a
positional-IO disk implementation (os.pread/os.pwrite, safe for concurrent
readers) and an in-memory implementation for tests.

DiskFile is the disk seam of the fault plane (util/faults.py): under an
installed plan, read_at, write_at, truncate and sync consult it (read-side
bit flips, persistent write-side bit flips, torn and crash writes, EIO);
with none, each call pays one module-attribute load and an `is None`
check.
"""

from __future__ import annotations

import os
import threading
from typing import Protocol

from ..util import faults


class BackendStorageFile(Protocol):
    def read_at(self, size: int, offset: int) -> bytes: ...
    def write_at(self, data: bytes, offset: int) -> int: ...
    def truncate(self, size: int) -> None: ...
    def sync(self) -> None: ...
    def size(self) -> int: ...
    def close(self) -> None: ...
    @property
    def name(self) -> str: ...


class DiskFile:
    """Positional-IO file; append position is size() (no shared cursor).

    The size is tracked in-process (updated by write_at/truncate) instead
    of fstat-ing per call: the serving write path asks for it ~3x per
    request. This object is the file's single writer within the process;
    anything that replaces the file on disk reopens the backend."""

    def __init__(self, path: str, create: bool = True, read_only: bool = False):
        self._path = path
        self._read_only = read_only
        if read_only:
            flags = os.O_RDONLY
        else:
            flags = os.O_RDWR | (os.O_CREAT if create else 0)
        self._fd = os.open(path, flags, 0o644)
        self._closed = False
        self._size = os.fstat(self._fd).st_size

    @property
    def name(self) -> str:
        return self._path

    def read_at(self, size: int, offset: int) -> bytes:
        flip = None
        if faults._PLAN is not None:
            flip = faults.sync_fault(
                faults._PLAN, "read_at", self._path, corruptable=True
            )
        chunks = []
        remaining, pos = size, offset
        while remaining > 0:
            b = os.pread(self._fd, remaining, pos)
            if not b:
                break
            chunks.append(b)
            remaining -= len(b)
            pos += len(b)
        out = b"".join(chunks)
        if flip is not None and flip.kind == "bitflip":
            # transient read-side corruption (bad cable / lying controller):
            # the bytes on disk stay intact, this read sees flipped bits
            out = faults.apply_bitflip(flip, out, offset)
        return out

    def write_at(self, data: bytes, offset: int) -> int:
        if faults._PLAN is not None:
            data = self._faulted_write(faults._PLAN, data, offset)
        view = memoryview(data)
        pos = offset
        while view:
            n = os.pwrite(self._fd, view, pos)
            view = view[n:]
            pos += n
        if pos > self._size:
            self._size = pos
        return pos - offset

    def _faulted_write(self, plan, data: bytes, offset: int) -> bytes:
        """Consult the fault plan for this write. Latency/EIO are applied
        by sync_fault; torn/crash writes are applied here: the kept prefix
        is persisted and the fault raised, leaving a short record on disk
        exactly as an interrupted pwrite chain would."""
        ev = faults.sync_fault(
            plan, "write_at", self._path, allow_partial=True, corruptable=True
        )
        if ev is None:
            return data
        if ev.kind == "bitflip":
            # silent write-path corruption: the flipped bytes are what
            # lands on disk (and what any verify-after-write would see) —
            # the canonical seed for scrub-detection tests
            return faults.apply_bitflip(ev, data, offset)
        if ev.kind in ("torn", "crash"):
            rule = ev.rule
            if rule.at_offset is not None:
                keep = max(0, min(len(data), rule.at_offset - offset))
            elif rule.keep is not None:
                keep = min(rule.keep, len(data))
            else:
                keep = ev.rng.randrange(len(data) + 1)
            view = memoryview(data)[:keep]
            pos = offset
            while view:
                n = os.pwrite(self._fd, view, pos)
                view = view[n:]
                pos += n
            if pos > self._size:
                self._size = pos
            if ev.kind == "crash":
                plan.mark_dead()
                raise faults.SimulatedCrash(
                    f"crash after {keep}/{len(data)} bytes at "
                    f"{self._path}:{offset}"
                )
            raise faults.injected_eio(self._path)
        return data

    def append(self, data: bytes) -> int:
        """Append at current end; returns the offset written at."""
        end = self.size()
        self.write_at(data, end)
        return end

    def truncate(self, size: int) -> None:
        if faults._PLAN is not None:
            faults.sync_fault(faults._PLAN, "truncate", self._path)
        os.ftruncate(self._fd, size)
        self._size = size

    def sync(self) -> None:
        if faults._PLAN is not None:
            faults.sync_fault(faults._PLAN, "sync", self._path)
        os.fsync(self._fd)

    def size(self) -> int:
        if self._read_only:
            # a read-only open may watch a file another writer appends
            # to; the in-process cache is valid only for the single writer
            return os.fstat(self._fd).st_size
        return self._size

    def close(self) -> None:
        if not self._closed:
            os.close(self._fd)
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MemoryFile:
    """In-memory BackendStorageFile for tests."""

    def __init__(self, name: str = "<memory>", data: bytes = b""):
        self._name = name
        self._buf = bytearray(data)
        self._lock = threading.Lock()

    @property
    def name(self) -> str:
        return self._name

    def read_at(self, size: int, offset: int) -> bytes:
        with self._lock:
            return bytes(self._buf[offset : offset + size])

    def write_at(self, data: bytes, offset: int) -> int:
        with self._lock:
            end = offset + len(data)
            if end > len(self._buf):
                self._buf.extend(b"\x00" * (end - len(self._buf)))
            self._buf[offset:end] = data
            return len(data)

    def append(self, data: bytes) -> int:
        with self._lock:
            end = len(self._buf)
            self._buf.extend(data)
            return end

    def truncate(self, size: int) -> None:
        with self._lock:
            del self._buf[size:]

    def sync(self) -> None:
        pass

    def size(self) -> int:
        return len(self._buf)

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
