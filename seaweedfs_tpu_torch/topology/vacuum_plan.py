"""Master-side vacuum planning: the decision half of the vacuum plane
(pure and unit-testable, like `topology/repair.py`; dispatch lives in
`server/master.py`).

Heartbeats are the sensor here too: every volume message (and the slim
per-few-ticks digest refresh) carries the replica's live garbage ratio, so
the scheduler ranks candidates without sweeping the cluster with RPCs.
A volume qualifies when EVERY live replica reports at least the threshold
— compaction must run on all replicas to commit, and the RPC dispatcher
re-checks each one authoritatively (`VacuumVolumeCheck`) before spending
I/O, so a stale heartbeat ratio costs one cheap probe, never a wasted
compaction. The queue drains highest-garbage-first: the volume wasting
the most bytes is reclaimed first.

Ported whole from the JAX package's topology/vacuum_plan.py.
"""

from __future__ import annotations

from .repair import RepairTask

# priority is an ascending sort key (fewest-first in the shared queue);
# garbage ratio in [0,1] maps to [1000..0] so MORE garbage sorts FIRST
_PRIORITY_SCALE = 1000


def garbage_priority(ratio: float) -> int:
    return int(round((1.0 - min(max(ratio, 0.0), 1.0)) * _PRIORITY_SCALE))


def priority_to_ratio(priority: int) -> float:
    return 1.0 - priority / _PRIORITY_SCALE


def plan_vacuums(
    volume_states: dict, threshold: float, include_all: bool = False
) -> list[RepairTask]:
    """Vacuum planning over heartbeat-derived state.

    volume_states: {vid: [{url, collection, garbage_ratio, read_only,
    scrub_corrupt}, ...]} — one entry per live replica holder (the shape
    `Topology.replica_states` returns).

    One task per qualifying volume, kind="vacuum", highest garbage first.
    A volume qualifies when its LOWEST replica ratio clears the threshold
    (compaction commits on every replica or not at all) and no replica is
    read-only/quarantined (a read-only copy cannot replay the makeup
    diff; a quarantined one belongs to the repair plane, not vacuum).
    include_all skips the threshold gate (forced sweeps: the dispatcher's
    authoritative per-replica check still applies the threshold).
    """
    tasks = []
    for vid, replicas in volume_states.items():
        if not replicas:
            continue
        if any(r.get("read_only") or r.get("scrub_corrupt") for r in replicas):
            continue
        min_ratio = min(float(r.get("garbage_ratio", 0.0)) for r in replicas)
        if not include_all and min_ratio < threshold:
            continue
        tasks.append(
            RepairTask(
                kind="vacuum",
                vid=int(vid),
                collection=replicas[0].get("collection", ""),
                priority=garbage_priority(min_ratio),
                survivors=len(replicas),
            )
        )
    tasks.sort(key=lambda t: (t.priority, t.vid))
    return tasks
