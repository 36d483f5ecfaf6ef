"""Master-side repair scheduling: the decision half of the anti-entropy
plane (planning is pure and unit-testable; dispatch lives in
`server/master.py`).

Heartbeats are the sensor: a node silent past the grace period no longer
counts as a holder, so its EC shards show up as missing; a scrub
quarantine arrives as `scrub_corrupt` on a volume message; a stale
replica shows a digest that disagrees while its append frontier trails.
Each finding becomes a `RepairTask` in a prioritized queue — EC volumes
closest to unrecoverable first (fewest surviving shards), then replica
repairs — dispatched under a concurrency cap with full-jitter backoff on
repeated failures so a broken target cannot hot-loop the scheduler.

Ported from the JAX package's topology/repair.py: `RepairTask`,
`RepairQueue` (which the master's vacuum scheduler drives too,
topology/vacuum_plan.py) and the planners `plan_ec_repairs`,
`find_unresolved_divergence` and `plan_replica_repairs`.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Optional

from ..util.backoff import BackoffPolicy
from ..util.metrics import REPAIR_QUEUE_DEPTH

# backoff between attempts of a failing repair: starts at ~2s, caps at 60s
REPAIR_BACKOFF = BackoffPolicy(base=2.0, cap=60.0, multiplier=2.0, attempts=1 << 30)


@dataclass
class RepairTask:
    kind: str  # ec_rebuild | replica_recopy | tail_sync
    vid: int
    collection: str = ""
    priority: int = 1 << 30  # surviving copies/shards: fewest first
    missing: list = field(default_factory=list)  # ec_rebuild: shard ids
    survivors: int = 0
    target: str = ""  # replica repairs: the node being fixed
    source: str = ""  # replica repairs: the healthy donor
    attempts: int = 0
    not_before: float = 0.0

    @property
    def key(self) -> tuple:
        return (self.kind, self.vid, self.target)

    def to_info(self) -> dict:
        return {
            "kind": self.kind,
            "volume_id": self.vid,
            "collection": self.collection,
            "priority": self.priority,
            "missing": list(self.missing),
            "survivors": self.survivors,
            "target": self.target,
            "source": self.source,
            "attempts": self.attempts,
            "not_before": self.not_before,
        }


class RepairQueue:
    """Priority queue of repair tasks, deduped by (kind, vid, target).

    `offer` keeps the retry state (attempts/not_before) of a task the
    planner re-discovers every scan — re-planning must not reset backoff.
    `pop_ready` returns up to `limit` tasks whose backoff window has
    passed, fewest-survivors-first; `reschedule_failure` requeues with a
    full-jitter delay. The live depth is mirrored into
    `repair_queue_depth` so draining to zero is externally observable."""

    def __init__(
        self,
        policy: BackoffPolicy = REPAIR_BACKOFF,
        rng: Optional[random.Random] = None,
        depth_gauge=REPAIR_QUEUE_DEPTH,
    ):
        self.policy = policy
        self.rng = rng or random.Random()
        self._tasks: dict[tuple, RepairTask] = {}
        # the vacuum scheduler reuses this queue with its own depth gauge
        self._depth_gauge = depth_gauge

    def _publish_depth(self) -> None:
        self._depth_gauge.set(len(self._tasks))

    def offer(self, task: RepairTask) -> bool:
        existing = self._tasks.get(task.key)
        if existing is not None:
            # refresh the plan facts, keep the retry state
            task.attempts = existing.attempts
            task.not_before = existing.not_before
        self._tasks[task.key] = task
        self._publish_depth()
        return existing is None

    def discard(self, key: tuple) -> None:
        self._tasks.pop(key, None)
        self._publish_depth()

    def prune(self, valid_keys: set) -> None:
        """Drop tasks the latest scan no longer justifies (the node came
        back, the shard re-registered) — self-healing must also self-calm."""
        for key in [k for k in self._tasks if k not in valid_keys]:
            self._tasks.pop(key)
        self._publish_depth()

    def retry_keys(self) -> set:
        """Keys of tasks that have already failed at least once (they sit
        in a backoff window). The vacuum scheduler exempts these from
        pruning: a forced sweep's failed task must survive background
        scans whose (stale or higher-threshold) plan wouldn't re-justify
        it — the caller was promised a retry."""
        return {k for k, t in self._tasks.items() if t.attempts > 0}

    def pop_ready(self, now: float, limit: int) -> list[RepairTask]:
        ready = sorted(
            (t for t in self._tasks.values() if t.not_before <= now),
            key=lambda t: (t.priority, t.vid, t.kind),
        )[:limit]
        for t in ready:
            self._tasks.pop(t.key, None)
        self._publish_depth()
        return ready

    def reschedule_failure(self, task: RepairTask, now: float) -> None:
        task.attempts += 1
        task.not_before = now + self.policy.delay(task.attempts - 1, self.rng)
        self._tasks[task.key] = task
        self._publish_depth()

    def depth(self) -> int:
        return len(self._tasks)

    def snapshot(self) -> list[dict]:
        return [
            t.to_info()
            for t in sorted(
                self._tasks.values(), key=lambda t: (t.priority, t.vid)
            )
        ]


# ---------------------------------------------------------------- planners --


def plan_ec_repairs(ec_states: list[dict]) -> list[RepairTask]:
    """EC repair planning over heartbeat-derived state.

    ec_states: [{vid, collection, total_shards, data_shards?, holders:
    {shard_id: [live urls]}}] where `holders` already excludes nodes
    silent past the grace period. A volume missing shards becomes one
    task whose priority is its surviving-shard count — the queue then
    repairs the volumes closest to data loss first."""
    tasks = []
    for st in ec_states:
        total = int(st["total_shards"])
        holders = st["holders"]
        present = [s for s in range(total) if holders.get(s)]
        missing = [s for s in range(total) if not holders.get(s)]
        if not missing:
            continue
        tasks.append(
            RepairTask(
                kind="ec_rebuild",
                vid=int(st["vid"]),
                collection=st.get("collection", ""),
                priority=len(present),
                missing=missing,
                survivors=len(present),
            )
        )
    tasks.sort(key=lambda t: (t.priority, t.vid))
    return tasks


def find_unresolved_divergence(volume_states: dict) -> list[int]:
    """Volumes whose healthy replicas disagree on digest while their
    append frontiers are EQUAL — content diverged in the middle (e.g. a
    torn-tail truncation later papered over by new appends), which the
    tail path cannot fix and no automatic repair can arbitrate. These
    must be VISIBLE (gauge + log) rather than silently skipped."""
    out = []
    for vid, replicas in volume_states.items():
        healthy = [r for r in replicas if not r.get("scrub_corrupt")]
        if len(healthy) < 2:
            continue
        top = max(int(r.get("append_at_ns", 0)) for r in healthy)
        at_top = [
            int(r.get("content_digest", 0))
            for r in healthy
            if int(r.get("append_at_ns", 0)) == top
        ]
        if len(at_top) > 1 and len(set(at_top)) > 1:
            out.append(vid)
    return sorted(out)


def plan_replica_repairs(volume_states: dict) -> list[RepairTask]:
    """Replica anti-entropy planning.

    volume_states: {vid: [{url, collection, content_digest, append_at_ns,
    scrub_corrupt, read_only}, ...]} — one entry per live replica holder.

    Two findings, in repair order:
    - a scrub-quarantined replica with at least one healthy peer is
      re-copied whole from that peer (`replica_recopy`): bit rot cannot be
      fixed by appending;
    - replicas whose digests disagree while their append frontier trails
      the freshest copy are caught up through the incremental tail path
      (`tail_sync`) — the cheap fix for a replica that missed writes.
    """
    tasks = []
    for vid, replicas in volume_states.items():
        if len(replicas) < 2:
            continue
        healthy = [r for r in replicas if not r.get("scrub_corrupt")]
        if not healthy:
            continue  # nothing trustworthy to copy from
        freshest = max(healthy, key=lambda r: int(r.get("append_at_ns", 0)))
        for r in replicas:
            if r.get("scrub_corrupt"):
                tasks.append(
                    RepairTask(
                        kind="replica_recopy",
                        vid=vid,
                        collection=r.get("collection", ""),
                        priority=len(healthy),
                        survivors=len(healthy),
                        target=r["url"],
                        source=freshest["url"],
                    )
                )
                continue
            if (
                int(r.get("content_digest", 0))
                != int(freshest.get("content_digest", 0))
                and int(r.get("append_at_ns", 0))
                < int(freshest.get("append_at_ns", 0))
            ):
                tasks.append(
                    RepairTask(
                        kind="tail_sync",
                        vid=vid,
                        collection=r.get("collection", ""),
                        priority=len(healthy),
                        survivors=len(healthy),
                        target=r["url"],
                        source=freshest["url"],
                    )
                )
    tasks.sort(key=lambda t: (t.priority, t.vid))
    return tasks
