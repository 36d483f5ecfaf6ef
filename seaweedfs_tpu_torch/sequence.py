"""Monotonic file-id sequencers (ref: weed/sequence/).

MemorySequencer mirrors memory_sequencer.go; FileSequencer fills the
durable-sequencer role of etcd_sequencer.go without an etcd dependency:
the counter persists in batched leases so a master restart can never
re-issue an id (heartbeat max_file_key sync remains the recovery path for
the memory variant, topology.go:115-122).

Copied from the JAX package's sequence.py.
"""

from __future__ import annotations

import os
import threading


class MemorySequencer:
    def __init__(self, start: int = 1):
        self._counter = start
        self._lock = threading.Lock()

    def next_file_id(self, count: int) -> int:
        """Reserve `count` ids; returns the first."""
        with self._lock:
            start = self._counter
            self._counter += count
            return start

    def set_max(self, seen_value: int) -> None:
        with self._lock:
            if self._counter <= seen_value:
                self._counter = seen_value + 1

    def peek(self) -> int:
        with self._lock:
            return self._counter


class FileSequencer(MemorySequencer):
    """Durable sequencer: the upper bound of a leased id window is fsynced
    to a small state file BEFORE any id from the window is handed out, so a
    crash skips at most one window but never repeats an id (the same
    lease-ahead contract as the reference's etcd sequencer,
    ref: weed/sequence/etcd_sequencer.go)."""

    LEASE = 10_000  # ids persisted ahead per write

    def __init__(self, path: str):
        self.path = path
        start = 1
        if os.path.exists(path):
            with open(path) as f:
                content = f.read().strip()
                if content:
                    start = int(content)
        super().__init__(start=start)
        self._leased_upto = 0
        self._persist(self._counter)  # crash before first lease is harmless

    def _persist(self, upto: int) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(upto))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._leased_upto = upto

    def next_file_id(self, count: int) -> int:
        with self._lock:
            start = self._counter
            self._counter += count
            if self._counter > self._leased_upto:
                self._persist(self._counter + self.LEASE)
            return start

    def set_max(self, seen_value: int) -> None:
        with self._lock:
            if self._counter <= seen_value:
                self._counter = seen_value + 1
                if self._counter > self._leased_upto:
                    self._persist(self._counter + self.LEASE)
