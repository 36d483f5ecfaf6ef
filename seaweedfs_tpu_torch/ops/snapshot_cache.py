"""Token-keyed IndexSnapshot cache shared by Volume.bulk_lookup and
EcVolume.bulk_locate.

Storage constructors build a cache eagerly; the snapshot itself (and its
upload to the card) is built on first use inside get().
"""

from __future__ import annotations

import threading


class SnapshotCache:
    """The token is captured BEFORE the columns are read, so a mutation
    racing the read leaves token != current and forces a rebuild on the next
    call — the cache can over-invalidate but never serve stale entries as
    current. The device build (upload + bucket table) runs outside the guard
    lock so concurrent probers and mutators aren't stalled behind it.

    `device` is where its snapshots live: the card unless the caller asks
    for the CPU (resolved when the first snapshot is built).
    """

    def __init__(self, device=None):
        self.device = device
        self._lock = threading.Lock()
        self._accel = None
        self._token = None

    def get(self, token_fn, cols_fn):
        """token_fn() -> monotonic mutation counter; cols_fn() -> sorted
        (keys, offsets, sizes) columns consistent at-or-after the token.
        Returns an IndexSnapshot."""
        from .index_kernel import IndexSnapshot

        with self._lock:
            token = token_fn()
            if self._accel is not None and self._token == token:
                return self._accel
            cols = cols_fn()
        accel = IndexSnapshot(*cols, device=self.device)
        with self._lock:
            if self._accel is None or self._token is None or self._token < token:
                self._accel = accel
                self._token = token
        return accel
