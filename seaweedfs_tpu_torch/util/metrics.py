"""Counters and gauges of the needle-index plane.

A small copy of the JAX package's metrics registry (util/metrics.py):
labelled counters and gauges with the same metric names, kept in-process.
Only the families the ported modules update are here; `render()` gives
the Prometheus text exposition the volume server serves at /metrics.
"""

from __future__ import annotations

import threading
from collections import defaultdict


class _Labeled:
    def __init__(self, name: str, help_text: str, kind: str):
        self.name = name
        self.help = help_text
        self.kind = kind
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = defaultdict(float)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(tuple(sorted(labels.items())), 0.0)


class Counter(_Labeled):
    def __init__(self, name: str, help_text: str = ""):
        super().__init__(name, help_text, "counter")

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] += amount


class Gauge(_Labeled):
    def __init__(self, name: str, help_text: str = ""):
        super().__init__(name, help_text, "gauge")

    def set(self, value: float, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = value


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self.metrics: dict[str, _Labeled] = {}

    def _add(self, m: _Labeled) -> _Labeled:
        with self._lock:
            return self.metrics.setdefault(m.name, m)

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._add(Counter(name, help_text))

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._add(Gauge(name, help_text))


REGISTRY = Registry()

TORN_TAIL_COUNTER = REGISTRY.counter(
    "seaweedfs_tpu_torn_tail_total",
    "torn-tail recovery on volume load, by item "
    "(volumes/records_recovered/dat_bytes_dropped/idx_entries_dropped)",
)

# needle index at scale: the LSM needle map's resident memtable bytes,
# run counts, snapshot age at mount and tail entries replayed
NEEDLE_MAP_RESIDENT_BYTES = REGISTRY.gauge(
    "seaweedfs_tpu_needle_map_resident_bytes",
    "estimated resident memory held by needle-map memtables, by map kind",
)
NEEDLE_MAP_RUN_COUNT = REGISTRY.gauge(
    "seaweedfs_tpu_needle_map_run_count",
    "immutable sorted runs currently backing needle maps, by map kind",
)
NEEDLE_MAP_SNAPSHOT_AGE = REGISTRY.gauge(
    "seaweedfs_tpu_needle_map_snapshot_age_seconds",
    "age of the persisted needle-map snapshot the most recent mount "
    "loaded, by map kind",
)
NEEDLE_MAP_TAIL_REPLAY = REGISTRY.counter(
    "seaweedfs_tpu_needle_map_tail_replay_entries_total",
    "index entries replayed past the snapshot fold frontier at mount",
)

# the ragged lookup arena: what is resident on the card, how many gate
# wakeups it answered, how often the gate served from the host maps
# instead, and the identity-check verdicts
NEEDLE_MAP_DEVICE_RESIDENT = REGISTRY.gauge(
    "seaweedfs_tpu_needle_map_device_resident_bytes",
    "bytes of sealed-run index columns resident in the current "
    "DeviceColumnArena generation",
)
NEEDLE_MAP_DEVICE_SEGMENTS = REGISTRY.gauge(
    "seaweedfs_tpu_needle_map_device_segments",
    "sealed segments resident in the current DeviceColumnArena generation",
)
NEEDLE_MAP_DEVICE_DISPATCHES = REGISTRY.counter(
    "seaweedfs_tpu_needle_map_device_dispatches_total",
    "ragged-batch lookup dispatches answered on the device",
)
NEEDLE_MAP_DEVICE_PROBES = REGISTRY.counter(
    "seaweedfs_tpu_needle_map_device_probes_total",
    "(key, segment) probe slots answered by ragged device dispatches",
)
NEEDLE_MAP_DEVICE_FALLBACKS = REGISTRY.counter(
    "seaweedfs_tpu_needle_map_device_fallbacks_total",
    "gate flushes served by the host maps instead of the arena, by reason",
)
NEEDLE_MAP_DEVICE_UPLOADS = REGISTRY.counter(
    "seaweedfs_tpu_needle_map_device_uploads_total",
    "arena generation uploads completed",
)
NEEDLE_MAP_DEVICE_IDENTITY_MISMATCH = REGISTRY.counter(
    "seaweedfs_tpu_needle_map_device_identity_mismatch_total",
    "device answers that disagreed with the host map under the identity "
    "check (the host answer is served; any non-zero value is a kernel bug)",
)
NEEDLE_MAP_DEVICE_ERRORS = REGISTRY.counter(
    "seaweedfs_tpu_needle_map_device_errors_total",
    "arena refreshes and dispatches that raised (a CUDA or kernel error); "
    "the affected probes are served by the host maps",
)

# the volume server (server/): requests served per server and method,
# requests failed by device work, and EC degraded-read reconstructions
REQUEST_COUNTER = REGISTRY.counter(
    "seaweedfs_tpu_request_total", "number of requests by server/operation"
)
DEVICE_ERRORS = REGISTRY.counter(
    "seaweedfs_tpu_device_errors_total",
    "requests answered 500 because device work (a kernel build or launch, "
    "a snapshot or arena upload) raised, by operation",
)
EC_RECONSTRUCTIONS = REGISTRY.counter(
    "seaweedfs_tpu_ec_reconstructions_total",
    "EC degraded-read interval reconstructions by kind (cold/cache_hit)",
)

# retries (util/backoff.py): attempts by operation, and the retries the
# shared RetryBudget withheld
RETRY_COUNTER = REGISTRY.counter(
    "seaweedfs_tpu_retries_total", "retry attempts by operation"
)
RETRIES_SUPPRESSED = REGISTRY.counter(
    "seaweedfs_tpu_retries_suppressed_total",
    "retries/hedges withheld by the shared RetryBudget (token bucket "
    "refilled by successes — no retry storms), by op",
)


def render() -> str:
    """Every family in the Prometheus text exposition format (the
    /metrics body)."""
    lines = []
    with REGISTRY._lock:
        families = list(REGISTRY.metrics.values())
    for m in families:
        lines.append(f"# HELP {m.name} {m.help}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        with m._lock:
            items = sorted(m._values.items())
        for labels, v in items:
            lab = ",".join(f'{k}="{val}"' for k, val in labels)
            lines.append(f"{m.name}{{{lab}}} {v:g}" if lab else f"{m.name} {v:g}")
    return "\n".join(lines) + "\n"
