"""Shared maintenance I/O budget: one byte/s cap over every background
plane.

Online-EC studies show background maintenance traffic is the dominant
interference source for foreground reads on warm stores (arxiv
1709.05365): each plane being individually rate-shaped is not enough when
scrub, vacuum and repair pulls run concurrently — their SUM is what the
foreground p50 sees. `MaintenanceBudget` generalizes the scrubber's token
bucket into a single bucket shared by every plane, with per-plane byte
accounting so operators can see who spent the budget.

Activation: `SEAWEEDFS_TPU_MAINT_MBPS` (MB/s across all planes) arms the
process-wide budget returned by `shared_budget()`; unset/0 means no shared
cap and each plane falls back to its own shaping (e.g. the scrubber's
`SEAWEEDFS_TPU_SCRUB_MBPS`). Planes take a `plane("scrub")` handle whose
`consume(n)` blocks until the shared bucket holds n tokens — the handle
satisfies the same duck-type as a `TokenBucket`, so every existing
`bucket.consume(...)` call site works unchanged.

**Pressure coupling:** a static MB/s cap is the right ceiling for the
steady state, but the wrong one during an overload — when the admission
gates are shedding foreground requests, ANY maintenance I/O is stolen
goodput. Every `consume()` (shared budget AND per-plane explicit buckets
routed through `plane_bucket`) therefore consults the foreground pressure
and sleeps extra time proportional to it: at p≥~1 (a gate shed within
the last second) each consume pays up to `SEAWEEDFS_TPU_MAINT_YIELD_MAX_S`
(default 0.5s) — an effective pause that drains the moment shedding
stops, never a deadlock. Yields are counted per plane
(`maintenance_pressure_yields_total`).

Ported from the JAX package's storage/maintenance.py. The JAX package
reads the pressure from util/overload.global_pressure, which the port
does not have yet (no admission gates): `_global_pressure` answers 0.0,
which is also the JAX package's answer with no foreground load.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

from ..util.metrics import MAINTENANCE_BYTES, MAINTENANCE_YIELDS


class TokenBucket:
    """Byte/s rate shaping for maintenance I/O. `consume(n)` blocks until
    the bucket holds n tokens; capacity (burst) defaults to one second of
    rate, so sustained throughput converges on `rate` while a tiny pass
    still finishes in one gulp. Injectable clock/sleep for tests."""

    def __init__(
        self,
        rate_bytes_per_s: float,
        capacity: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if rate_bytes_per_s <= 0:
            raise ValueError("token bucket needs a positive rate")
        self.rate = float(rate_bytes_per_s)
        self.capacity = float(capacity if capacity is not None else rate_bytes_per_s)
        self._clock = clock
        self._sleep = sleep
        self._tokens = self.capacity
        self._last = clock()
        self._lock = threading.Lock()

    def consume(self, n: int) -> float:
        """Take n tokens, sleeping as needed; returns seconds slept.
        Requests larger than the burst capacity are paid in capacity-sized
        installments (they must not deadlock, just take proportionally
        longer)."""
        slept = 0.0
        need = float(n)
        while need > 0:
            with self._lock:
                now = self._clock()
                self._tokens = min(
                    self.capacity, self._tokens + (now - self._last) * self.rate
                )
                self._last = now
                chunk = min(need, self.capacity)
                if self._tokens >= chunk:
                    self._tokens -= chunk
                    need -= chunk
                    continue
                wait = max((chunk - self._tokens) / self.rate, 0.001)
            self._sleep(wait)
            slept += wait
        return slept


def _yield_max_s() -> float:
    try:
        return float(
            os.environ.get("SEAWEEDFS_TPU_MAINT_YIELD_MAX_S", "") or 0.5
        )
    except ValueError:
        return 0.5


def yield_for_pressure(
    plane: str,
    base_s: float,
    sleep: Callable[[float], None] = time.sleep,
    pressure: Optional[Callable[[], float]] = None,
) -> float:
    """Sleep extra time proportional to foreground pressure; returns the
    seconds yielded (0.0 — one float compare — in the common no-pressure
    case). `base_s` is the uncontended wall this consume would take at
    the configured rate: under pressure p the plane's effective rate
    drops to rate*(1-p), i.e. extra = base * p/(1-p), clamped to the
    per-consume cap so p→1 means "pause", never "hang forever"."""
    if pressure is None:
        pressure = _global_pressure
    p = pressure()
    if p < 0.05:
        return 0.0
    p = min(p, 0.999)
    extra = min(base_s * (p / (1.0 - p)), _yield_max_s())
    if extra <= 0.0:
        return 0.0
    MAINTENANCE_YIELDS.inc(plane=plane)
    sleep(extra)
    return extra


def _global_pressure() -> float:
    """Foreground pressure in [0, 1]: the port has no admission gates
    (the JAX package's util/overload.py is not ported), so none is ever
    shedding."""
    return 0.0


class _PlaneHandle:
    """One plane's view of the shared budget: a TokenBucket-shaped object
    whose consumption is charged to the common bucket and attributed to
    the plane in the budget's accounting (and the maintenance_bytes_total
    metric)."""

    __slots__ = ("_budget", "plane")

    def __init__(self, budget: "MaintenanceBudget", plane: str):
        self._budget = budget
        self.plane = plane

    def consume(self, n: int) -> float:
        return self._budget.consume(n, self.plane)


class MaintenanceBudget:
    """One token bucket shared by every background plane (scrub, vacuum,
    repair), so their COMBINED read+write traffic stays under a single
    MB/s cap no matter how many planes happen to run at once."""

    def __init__(
        self,
        rate_mbps: float,
        capacity_bytes: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.rate_mbps = float(rate_mbps)
        self.bucket = TokenBucket(
            rate_mbps * 1e6, capacity=capacity_bytes, clock=clock, sleep=sleep
        )
        self._sleep = sleep
        self._lock = threading.Lock()
        self._spent: dict[str, int] = {}
        self._slept: dict[str, float] = {}
        self._yielded: dict[str, float] = {}

    def plane(self, name: str) -> _PlaneHandle:
        return _PlaneHandle(self, name)

    def consume(self, n: int, plane: str = "other") -> float:
        slept = self.bucket.consume(n)
        # pressure coupling: yield to foreground traffic being shed by
        # the admission gates — the static cap is the ceiling, this makes
        # it dynamic (arxiv 1709.05365's interference result)
        yielded = yield_for_pressure(
            plane, float(n) / self.bucket.rate, sleep=self._sleep
        )
        slept += yielded
        with self._lock:
            self._spent[plane] = self._spent.get(plane, 0) + int(n)
            self._slept[plane] = self._slept.get(plane, 0.0) + slept
            if yielded:
                self._yielded[plane] = (
                    self._yielded.get(plane, 0.0) + yielded
                )
        MAINTENANCE_BYTES.inc(n, plane=plane)
        return slept

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "rate_mbps": self.rate_mbps,
                "spent_bytes": dict(self._spent),
                "throttle_seconds": {
                    k: round(v, 3) for k, v in self._slept.items()
                },
                "pressure_yield_seconds": {
                    k: round(v, 3) for k, v in self._yielded.items()
                },
            }


_SHARED: Optional[MaintenanceBudget] = None
_SHARED_LOCK = threading.Lock()


def shared_budget() -> Optional[MaintenanceBudget]:
    """The process-wide budget armed by SEAWEEDFS_TPU_MAINT_MBPS, or None
    when no shared cap is configured (each plane shapes itself)."""
    global _SHARED
    if _SHARED is not None:
        return _SHARED
    rate = float(os.environ.get("SEAWEEDFS_TPU_MAINT_MBPS", "0") or 0)
    if rate <= 0:
        return None
    with _SHARED_LOCK:
        if _SHARED is None:
            _SHARED = MaintenanceBudget(rate)
        return _SHARED


def configure_shared(budget: Optional[MaintenanceBudget]) -> None:
    """Install (or clear) the process-wide budget — tests and embedders."""
    global _SHARED
    with _SHARED_LOCK:
        _SHARED = budget


class _PressureShapedBucket:
    """A plane's explicitly configured bucket, with the foreground
    pressure yield layered on top — the plane's own MB/s knob still sets
    its ceiling, but an overloaded gate makes it back off exactly like
    the shared budget's planes do. Same consume() duck-type."""

    __slots__ = ("_bucket", "plane")

    def __init__(self, bucket, plane: str):
        self._bucket = bucket
        self.plane = plane

    def consume(self, n: int) -> float:
        slept = self._bucket.consume(n)
        rate = getattr(self._bucket, "rate", 0.0)
        base_s = float(n) / rate if rate > 0 else 0.01
        return slept + yield_for_pressure(
            self.plane, base_s, sleep=getattr(self._bucket, "_sleep", time.sleep)
        )


def plane_bucket(plane: str, explicit=None):
    """The rate shaper a plane should use: an explicitly configured bucket
    wins (the plane's own knob, pressure-wrapped), else the shared
    budget's plane handle, else None (unshaped)."""
    if explicit is not None:
        return _PressureShapedBucket(explicit, plane)
    budget = shared_budget()
    if budget is not None:
        return budget.plane(plane)
    return None
