"""Per-volume access heat: exponentially-decayed read/write op counters.

The lifecycle plane needs to know which volumes are COLD enough to
erasure-code into the warm tier and which EC volumes turned HOT enough to
re-inflate — the Haystack→f4 arc of the reference paper, driven by
observed access instead of operator commands.

The sensor is one `HeatTracker` per volume / EC volume: each read or
write op adds one unit of heat, and heat decays continuously in wall
time with a half-life (HALF_LIFE_S, 600s, unless the tracker is given
one). Folding happens at op time and at sample time, so the
value a heartbeat samples is

    H(t) = Σ_ops 0.5 ** ((t - t_op) / half_life)

— a function of the op timestamps ONLY. Heartbeat cadence, batching and
flush boundaries cannot change it (the order-independence property
test), which is what makes heat numbers comparable across servers with
different pulse phases: every server reports the same math over its own
op stream.

Persistence: `save()` writes a tiny JSON sidecar (`<base>.heat`) with the
decayed values anchored to wall-clock time; `load()` decays them forward
to now. A missing/corrupt sidecar means cold start (heat 0) — a restart
is never WORSE than cold start, and with a clean shutdown it is no worse
than no restart at all.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Optional


HALF_LIFE_S = 600.0  # the default decay half-life


class HeatTracker:
    """Exponentially-decayed read/write op counters (one per volume).

    note_read/note_write fold the decay to `now` under a small dedicated
    lock (the serving hot path must not contend with the volume lock any
    longer than it already does), then add the op count. read_heat /
    write_heat sample without mutating history beyond the same fold.
    """

    __slots__ = (
        "half_life_s", "_clock", "_lock", "_read", "_write", "_at",
    )

    def __init__(
        self,
        half_life_s: Optional[float] = None,
        clock: Callable[[], float] = time.time,
    ):
        self.half_life_s = (
            half_life_s if half_life_s is not None else HALF_LIFE_S
        )
        self._clock = clock
        self._lock = threading.Lock()
        self._read = 0.0
        self._write = 0.0
        self._at = self._clock()

    # --- internals ---
    def _fold(self, now: float) -> None:
        dt = now - self._at
        if dt <= 0.0:
            return
        decay = 0.5 ** (dt / self.half_life_s)
        self._read *= decay
        self._write *= decay
        self._at = now

    # --- op accounting ---
    def note_read(self, n: float = 1.0, now: Optional[float] = None) -> None:
        with self._lock:
            self._fold(self._clock() if now is None else now)
            self._read += n

    def note_write(self, n: float = 1.0, now: Optional[float] = None) -> None:
        with self._lock:
            self._fold(self._clock() if now is None else now)
            self._write += n

    # --- sampling ---
    def read_heat(self, now: Optional[float] = None) -> float:
        with self._lock:
            self._fold(self._clock() if now is None else now)
            return self._read

    def write_heat(self, now: Optional[float] = None) -> float:
        with self._lock:
            self._fold(self._clock() if now is None else now)
            return self._write

    def seed(self, read: float, write: float = 0.0) -> None:
        """Overwrite the current heat (re-inflation hands the observed EC
        heat to the fresh volume so hysteresis survives the conversion)."""
        with self._lock:
            self._fold(self._clock())
            self._read = float(read)
            self._write = float(write)

    # --- persistence (sidecar <base>.heat) ---
    def save(self, path: str) -> None:
        now = self._clock()
        with self._lock:
            self._fold(now)
            blob = json.dumps(
                {
                    "read": self._read,
                    "write": self._write,
                    "at": now,
                    "half_life_s": self.half_life_s,
                }
            )
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                f.write(blob)
            os.replace(tmp, path)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass

    @classmethod
    def load(
        cls,
        path: str,
        half_life_s: Optional[float] = None,
        clock: Callable[[], float] = time.time,
    ) -> "HeatTracker":
        """Tracker restored from a sidecar, decayed forward from the save
        timestamp; cold start on a missing/unreadable/garbage sidecar."""
        t = cls(half_life_s=half_life_s, clock=clock)
        try:
            with open(path) as f:
                d = json.load(f)
            read, write = float(d["read"]), float(d["write"])
            at = float(d["at"])
        except (OSError, ValueError, KeyError, TypeError):
            return t
        now = clock()
        if at > now:  # clock skew / bad sidecar: never inflate history
            at = now
        decay = 0.5 ** ((now - at) / t.half_life_s)
        with t._lock:
            t._read = max(read, 0.0) * decay
            t._write = max(write, 0.0) * decay
            t._at = now
        return t
