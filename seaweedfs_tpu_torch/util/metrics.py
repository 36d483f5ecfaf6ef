"""Counters, gauges and histograms of the ported planes.

A small copy of the JAX package's metrics registry (util/metrics.py):
labelled counters, gauges and histograms with the same metric names,
kept in-process. Only the families the ported modules update are here;
`render()` gives the Prometheus text exposition the volume server serves
at /metrics.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from collections import defaultdict

_DEFAULT_BUCKETS = [
    0.0001, 0.0003, 0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1, 3, 10,
]


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


class Histogram(_Labeled):
    def __init__(self, name: str, help_text: str = "", buckets=None):
        super().__init__(name, help_text, "histogram")
        self.buckets = list(buckets or _DEFAULT_BUCKETS)
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = defaultdict(float)
        self._totals: dict[tuple, int] = defaultdict(int)

    def observe(self, value: float, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            # Prometheus le bounds are inclusive: bisect_left
            idx = bisect_left(self.buckets, value)
            if idx < len(counts):
                counts[idx] += 1  # cumulative sums computed at render time
            self._sums[key] += value
            self._totals[key] += 1

    def count(self, **labels) -> int:
        with self._lock:
            return self._totals.get(tuple(sorted(labels.items())), 0)

    def render_lines(self) -> list[str]:
        out = []
        with self._lock:
            for key, counts in sorted(self._counts.items()):
                cumulative = 0
                for b, c in zip(self.buckets, counts):
                    cumulative += c
                    out.append(
                        f"{self.name}_bucket{_labels(key, le=str(b))} "
                        f"{cumulative}"
                    )
                out.append(f'{self.name}_bucket{_labels(key, le="+Inf")} '
                           f"{self._totals[key]}")
                out.append(f"{self.name}_sum{_labels(key)} {self._sums[key]}")
                out.append(
                    f"{self.name}_count{_labels(key)} {self._totals[key]}"
                )
        return out


def _labels(key: tuple, **extra) -> str:
    items = list(key) + list(extra.items())
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in items) + "}"


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

    def histogram(self, name: str, help_text: str = "",
                  buckets=None) -> Histogram:
        return self._add(Histogram(name, help_text, buckets))


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

# the write path (storage/group_commit.py, server/volume.py): per-stage
# walls and the group-commit worker's batches
WRITE_STAGE_SECONDS = REGISTRY.histogram(
    "seaweedfs_tpu_write_stage_seconds",
    "volume write path stage wall time, by stage",
)
GROUP_COMMIT_BATCH_SIZE = REGISTRY.histogram(
    "seaweedfs_tpu_group_commit_batch_size",
    "requests per group-commit fsync batch",
    buckets=[1, 2, 4, 8, 16, 32, 64, 128],
)
GROUP_COMMIT_FSYNCS = REGISTRY.counter(
    "seaweedfs_tpu_group_commit_fsyncs_total",
    "group-commit batches flushed (one fsync each)",
)
CHUNK_BATCH_PUT_SIZE = REGISTRY.histogram(
    "seaweedfs_tpu_chunk_batch_put_size",
    "needles per batched fast-tier chunk PUT (POST /!batch/put — the "
    "filer upload gate's same-tick coalescing width)",
    buckets=[1, 2, 4, 8, 16, 32, 64],
)

# per-peer circuit breakers (util/overload.py)
CIRCUIT_TRANSITIONS = REGISTRY.counter(
    "seaweedfs_tpu_circuit_transitions_total",
    "circuit-breaker state transitions, by peer and target state",
)
CIRCUIT_OPEN = REGISTRY.gauge(
    "seaweedfs_tpu_circuit_open",
    "1 while a peer's circuit breaker is open (calls fail fast)",
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

# the vacuum plane (storage/vacuum.py, storage/maintenance.py, the
# master's scheduler): per-stage copy walls, the master's queue, bytes a
# verified vacuum re-parsed, and the maintenance budget's accounting
VACUUM_STAGE_SECONDS = REGISTRY.histogram(
    "seaweedfs_tpu_vacuum_stage_seconds",
    "compaction copy per-stage wall seconds, by stage (plan/read/write/"
    "verify/idx/total; pipelined stages overlap)",
)
VACUUM_QUEUE_DEPTH = REGISTRY.gauge(
    "seaweedfs_tpu_vacuum_queue_depth",
    "vacuum tasks currently queued on the master (highest-garbage-first)",
)
SCRUB_BYTES = REGISTRY.counter(
    "seaweedfs_tpu_scrub_bytes_total",
    "bytes read and verified by the scrubber, by kind (dat/idx/ec)",
)
SCRUB_CORRUPTIONS = REGISTRY.counter(
    "seaweedfs_tpu_scrub_corruptions_found_total",
    "latent damage found by scrub, by kind (needle_crc/needle_id/"
    "idx_extent/ec_data/ec_parity/ec_shard_size/ec_unidentified)",
)
SCRUB_PASSES = REGISTRY.counter(
    "seaweedfs_tpu_scrub_passes_total",
    "completed scrub passes, by plane (volume/ec)",
)
MAINTENANCE_BYTES = REGISTRY.counter(
    "seaweedfs_tpu_maintenance_bytes_total",
    "bytes charged to the shared maintenance I/O budget, by plane "
    "(scrub/vacuum/repair)",
)
MAINTENANCE_YIELDS = REGISTRY.counter(
    "seaweedfs_tpu_maintenance_pressure_yields_total",
    "maintenance budget consumes that yielded extra time to foreground "
    "pressure (admission gates shedding/queueing), by plane",
)
ANTIENTROPY_RESYNCS = REGISTRY.counter(
    "seaweedfs_tpu_antientropy_resyncs_total",
    "replica repairs dispatched by digest/scrub anti-entropy, by kind "
    "(tail_sync = catch-up append replay, recopy = full re-pull of a "
    "quarantined replica)",
)
REPAIR_QUEUE_DEPTH = REGISTRY.gauge(
    "seaweedfs_tpu_repair_queue_depth",
    "repair tasks currently queued on the master (fewest-survivors-first)",
)
ANTIENTROPY_DIVERGED = REGISTRY.gauge(
    "seaweedfs_tpu_antientropy_diverged_volumes",
    "volumes whose healthy replicas disagree on content digest with EQUAL "
    "append frontiers — divergence the tail path cannot fix (operator "
    "action: volume.fsck / re-replicate); refreshed every scheduler scan",
)
REPAIR_SECONDS = REGISTRY.histogram(
    "seaweedfs_tpu_repair_seconds",
    "wall seconds per dispatched repair, by kind (ec_rebuild/replica_"
    "recopy/tail_sync/vacuum) and result (ok/error/skipped)",
)
PLACEMENT_VIOLATIONS = REGISTRY.gauge(
    "seaweedfs_tpu_placement_violations",
    "volumes/EC volumes whose current holders violate placement policy, "
    "by kind (replica_spread = replicas packed below the ReplicaPlacement "
    "rack/DC spread, ec_domain = one failure domain holds more EC shards "
    "than the volume can lose); refreshed every anti-entropy scan",
)

# the fault plane (util/faults.py)
FAULTS_INJECTED = REGISTRY.counter(
    "seaweedfs_tpu_faults_injected_total",
    "faults fired by the active injection plan, by op/kind",
)


# the filer (filer/, server/filer.py): the durable meta-log, the write
# gate, the LSM store's arena prefetch hints and the chunk GC's rounds
META_FEED_EVENTS = REGISTRY.counter(
    "seaweedfs_tpu_meta_feed_events_total",
    "namespace change events appended to the durable meta-log "
    "change feed (segmented on-disk log)",
)
META_FEED_SEGMENTS = REGISTRY.gauge(
    "seaweedfs_tpu_meta_feed_segment_count",
    "on-disk segments currently retained by the durable meta log",
)
META_WRITE_GATE_BATCHES = REGISTRY.counter(
    "seaweedfs_tpu_meta_write_gate_batches_total",
    "write-gate flushes: each one is ONE store round (insert_many) "
    "carrying every create/update enqueued in the same event-loop tick",
)
META_WRITE_GATE_WRITES = REGISTRY.counter(
    "seaweedfs_tpu_meta_write_gate_writes_total",
    "individual entry writes that rode a write-gate flush (writes / "
    "batches = the measured coalescing factor)",
)
ARENA_PREFETCH = REGISTRY.counter(
    "seaweedfs_tpu_arena_prefetch_total",
    "LSM flush-path arena residency hints, by result (queued = this "
    "hint scheduled the refresh, piggybacked = one was already queued, "
    "resident = already uploaded, no_arena = no arena live, "
    "unavailable = arena killed, error = the hint raised: handed to the "
    "arena, which raises it at its next probe; never the flush itself)",
)
FILER_CHUNK_DELETE_BATCHES = REGISTRY.counter(
    "seaweedfs_tpu_filer_chunk_delete_batches_total",
    "batched per-host chunk-delete RPC rounds drained by the filer GC, "
    "by result (ok/retry)",
)

# the filer's scale-out: the prefix-sharded store (filer/sharded_store.py),
# the range-owning fleet (filer/fleet.py) and the meta-log-fed read
# replicas (filer/meta_follower.py)
META_SHARD_OPS = REGISTRY.counter(
    "seaweedfs_tpu_meta_shard_ops_total",
    "filer-store operations routed through the prefix-sharded store, "
    "by op kind (find/find_many/list/insert/delete/delete_children)",
)
META_SHARD_COUNT = REGISTRY.gauge(
    "seaweedfs_tpu_meta_shard_count",
    "shards in the prefix-sharded filer store's committed shard map",
)
META_SHARD_REBALANCES = REGISTRY.counter(
    "seaweedfs_tpu_meta_shard_rebalances_total",
    "heat-driven shard-map rebalances committed (purge/copy/commit/"
    "cleanup moves of a directory band to the cooler neighbor)",
)
META_SHARD_MOVED = REGISTRY.counter(
    "seaweedfs_tpu_meta_shard_moved_entries_total",
    "filer entries copied between shards by rebalance moves",
)
FLEET_FORWARDED = REGISTRY.counter(
    "seaweedfs_tpu_fleet_forwarded_total",
    "filer requests forwarded to the owning fleet member because the "
    "fleet map routes the path elsewhere, by op",
)
FLEET_INGESTED = REGISTRY.counter(
    "seaweedfs_tpu_fleet_ingested_entries_total",
    "entries applied straight to the local store by FleetIngest "
    "(range-move copy/delta pages and directory-spine broadcasts)",
)
FLEET_MOVES = REGISTRY.counter(
    "seaweedfs_tpu_fleet_range_moves_total",
    "fleet range moves by outcome (committed/failed)",
)
FOLLOWER_EVENTS = REGISTRY.counter(
    "seaweedfs_tpu_meta_follower_events_total",
    "meta-log events a read replica applied to its local store, by "
    "type (upsert/delete/rename)",
)
FOLLOWER_REDIRECTS = REGISTRY.counter(
    "seaweedfs_tpu_meta_follower_redirects_total",
    "follower reads redirected to the primary because the caller's "
    "read-your-writes watermark (min_ts_ns) was ahead of the tail "
    "cursor",
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
        if isinstance(m, Histogram):
            lines.extend(m.render_lines())
            continue
        with m._lock:
            items = sorted(m._values.items())
        for labels, v in items:
            lab = ",".join(f'{k}="{val}"' for k, val in labels)
            lines.append(f"{m.name}{{{lab}}} {v:g}" if lab else f"{m.name} {v:g}")
    return "\n".join(lines) + "\n"
