"""Backend storage-file abstraction.

Mirrors the reference's BackendStorageFile interface (read_at/write_at/
truncate/sync/size; ref: weed/storage/backend/backend.go:15-23) with a
positional-IO disk implementation (os.pread/os.pwrite, safe for concurrent
readers) and an in-memory implementation for tests.

The JAX package's DiskFile also consults a fault-injection plan
(util/faults: torn writes, bit flips, EIO) on every call; the port has no
fault plane yet, so its DiskFile is the plain positional-IO file.
"""

from __future__ import annotations

import os
import threading
from typing import Protocol


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
        chunks = []
        remaining, pos = size, offset
        while remaining > 0:
            b = os.pread(self._fd, remaining, pos)
            if not b:
                break
            chunks.append(b)
            remaining -= len(b)
            pos += len(b)
        return b"".join(chunks)

    def write_at(self, data: bytes, offset: int) -> int:
        view = memoryview(data)
        pos = offset
        while view:
            n = os.pwrite(self._fd, view, pos)
            view = view[n:]
            pos += n
        if pos > self._size:
            self._size = pos
        return pos - offset

    def append(self, data: bytes) -> int:
        """Append at current end; returns the offset written at."""
        end = self.size()
        self.write_at(data, end)
        return end

    def truncate(self, size: int) -> None:
        os.ftruncate(self._fd, size)
        self._size = size

    def sync(self) -> None:
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
