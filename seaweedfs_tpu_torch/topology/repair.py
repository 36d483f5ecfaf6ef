"""Master-side repair scheduling: the decision half of the anti-entropy
plane (planning is pure and unit-testable; dispatch lives in
`server/master.py`).

Each finding becomes a `RepairTask` in a prioritized queue, dispatched
under a concurrency cap with full-jitter backoff on repeated failures so
a broken target cannot hot-loop the scheduler.

Ported from the JAX package's topology/repair.py: `RepairTask` and
`RepairQueue`, which the master's vacuum scheduler drives
(topology/vacuum_plan.py). The repair planners (EC rebuilds, replica
recopies, tail syncs) come with the anti-entropy plane, not ported yet.
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
