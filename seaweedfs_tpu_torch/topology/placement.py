"""DC/rack-aware placement policy: violation detection + repair planning.

The volume-growth solver (`volume_growth.find_empty_slots`) places NEW
volumes according to the xyz `ReplicaPlacement` semantics (ref
weed/topology/volume_growth.go): one main rack holding 1+z copies, y
more racks in the main DC with one copy each, x other DCs with one copy
each. Nothing re-checked EXISTING placements: a volume grown before a
rack label changed, re-replicated by anti-entropy onto whatever node was
free, or EC-encoded with every shard on one rack silently violates the
spread the policy promises — and a single rack loss then takes out more
copies/shards than the redundancy budget allows.

This module is the pure planning half (the master's anti-entropy round
dispatches, mirroring `topology/repair.py`):

- `plan_replica_spread` checks each volume's live holders against its
  layout's `ReplicaPlacement` and, when the spread is violated, proposes
  ONE move per volume per scan (copy to a better-placed node, then drop
  the source copy) — repeated scans converge, and single-step moves keep
  every intermediate state at full copy count.
- `plan_ec_domain_spread` flags EC volumes where one failure domain
  (rack) holds more shards than the volume can lose (> parity): losing
  that rack would be unrecoverable. The proposed move rides the same
  shard-move RPCs as `ec.balance`.

Both planners emit `RepairTask`s into the existing `RepairQueue` with
LOWER priority than data-loss repairs (placement is about the NEXT
failure; missing shards are about the current one), plus a violation
report for `geo.status` / `PlacementStatus -run`.

Copied from the JAX package's topology/placement.py.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Optional

from ..storage.erasure_coding import DATA_SHARDS_COUNT
from ..storage.super_block import ReplicaPlacement
from .repair import RepairTask

# placement tasks sort after data-loss repairs no matter how many
# survivors those report: priority is "surviving copies, fewest first"
# and real clusters never exceed a few replicas/shards
PLACEMENT_PRIORITY = 1 << 20


def replica_spread_ok(
    rp: ReplicaPlacement, domains: list[tuple[str, str]]
) -> bool:
    """Whether (dc, rack) holder domains satisfy the xyz placement: some
    DC holds 1+z+y copies (one rack 1+z, y other racks 1 each) and x
    other DCs hold exactly one copy each. Judged only at full copy
    count — under/over-replication is the replica planner's concern."""
    x, y, z = (
        rp.diff_data_center_count,
        rp.diff_rack_count,
        rp.same_rack_count,
    )
    if len(domains) != rp.copy_count():
        return True
    dc_racks: dict[str, Counter] = defaultdict(Counter)
    for dc, rack in domains:
        dc_racks[dc][rack] += 1
    if len(dc_racks) != x + 1:
        return False
    for main_dc, racks in dc_racks.items():
        if sum(racks.values()) != 1 + z + y:
            continue
        others_ok = all(
            sum(r.values()) == 1
            for dc, r in dc_racks.items()
            if dc != main_dc
        )
        main_ok = (
            len(racks) == y + 1
            and sorted(racks.values()) == [1] * y + [1 + z]
        )
        if others_ok and main_ok:
            return True
    return False


def _pick_target(
    candidates: list[dict],
    exclude_urls: set,
    want_dc: Optional[set] = None,
    want_rack_not: Optional[set] = None,
    same_dc: Optional[str] = None,
) -> Optional[dict]:
    """Most-free candidate node matching the domain constraints: in one
    of `want_dc` (when given), NOT in `want_rack_not` racks, in `same_dc`
    (when given), and not already a holder."""
    best = None
    for c in candidates:
        if c["url"] in exclude_urls or c.get("free", 0) <= 0:
            continue
        if want_dc is not None and c["dc"] not in want_dc:
            continue
        if same_dc is not None and c["dc"] != same_dc:
            continue
        if want_rack_not is not None and (c["dc"], c["rack"]) in want_rack_not:
            continue
        if best is None or c.get("free", 0) > best.get("free", 0):
            best = c
    return best


def plan_replica_spread(
    placement_states: list[dict], candidates: list[dict]
) -> tuple[list[dict], list[RepairTask]]:
    """-> (violations, placement-move tasks).

    placement_states: [{vid, collection, replica_placement (byte),
    holders: [{url, dc, rack}]}] restricted to live holders;
    candidates: [{url, dc, rack, free}] — every live node.
    """
    violations: list[dict] = []
    tasks: list[RepairTask] = []
    for st in placement_states:
        rp = ReplicaPlacement.from_byte(int(st["replica_placement"]))
        holders = st["holders"]
        domains = [(h["dc"], h["rack"]) for h in holders]
        if replica_spread_ok(rp, domains):
            continue
        violation = {
            "kind": "replica_spread",
            "volume_id": int(st["vid"]),
            "collection": st.get("collection", ""),
            "replication": str(rp),
            "holders": [
                f"{h['url']}({h['dc']}/{h['rack']})" for h in holders
            ],
        }
        violations.append(violation)
        move = _plan_one_replica_move(rp, holders, candidates)
        if move is None:
            violation["repair"] = "no candidate node restores the spread"
            continue
        source, target = move
        violation["repair"] = f"move {source} -> {target}"
        tasks.append(
            RepairTask(
                kind="placement_move",
                vid=int(st["vid"]),
                collection=st.get("collection", ""),
                priority=PLACEMENT_PRIORITY,
                survivors=len(holders),
                target=target,
                source=source,
            )
        )
    return violations, tasks


def _plan_one_replica_move(
    rp: ReplicaPlacement, holders: list[dict], candidates: list[dict]
) -> Optional[tuple[str, str]]:
    """One (source_url, target_url) move toward a valid spread, or None.

    Greedy: fix DC spread first (move a copy out of the most-loaded DC
    into a DC holding none), then rack spread inside the main DC (move a
    copy out of the most-loaded rack into a main-DC rack holding none).
    One move per scan: every intermediate state keeps full copy count,
    and the next scan re-plans from observed (not predicted) state.
    """
    x, y = rp.diff_data_center_count, rp.diff_rack_count
    holder_urls = {h["url"] for h in holders}
    by_dc: dict[str, list[dict]] = defaultdict(list)
    for h in holders:
        by_dc[h["dc"]].append(h)
    if len(by_dc) < x + 1:
        # too few DCs: source = a copy from the DC with the most copies
        # (tie-broken toward its most-loaded rack), target = any node in
        # a DC currently holding nothing
        src_dc = max(by_dc, key=lambda d: len(by_dc[d]))
        racks = Counter((h["dc"], h["rack"]) for h in by_dc[src_dc])
        src = max(
            by_dc[src_dc], key=lambda h: racks[(h["dc"], h["rack"])]
        )
        target = _pick_target(
            candidates,
            holder_urls,
            want_dc={
                c["dc"] for c in candidates if c["dc"] not in by_dc
            },
        )
        return (src["url"], target["url"]) if target else None
    # enough DCs (or too many — then rack logic below still finds the
    # overloaded group): fix rack spread inside the main (largest) DC
    main_dc = max(by_dc, key=lambda d: len(by_dc[d]))
    rack_counts = Counter(h["rack"] for h in by_dc[main_dc])
    if len(rack_counts) >= y + 1 and len(by_dc) == x + 1:
        # spread is wrong in a shape one greedy move can't name (e.g.
        # two racks both above 1+z with no free rack) — still try:
        # move from the most-loaded rack to an unused main-DC rack
        pass
    src_rack = max(rack_counts, key=lambda r: rack_counts[r])
    src = next(h for h in by_dc[main_dc] if h["rack"] == src_rack)
    used_racks = {(main_dc, r) for r in rack_counts}
    target = _pick_target(
        candidates, holder_urls, same_dc=main_dc, want_rack_not=used_racks
    )
    if target is None and len(by_dc) > x + 1:
        # too MANY DCs: consolidate one stray copy into the main DC
        stray_dc = min(by_dc, key=lambda d: len(by_dc[d]))
        src = by_dc[stray_dc][0]
        target = _pick_target(
            candidates, holder_urls, same_dc=main_dc
        )
    return (src["url"], target["url"]) if target else None


def plan_ec_domain_spread(
    ec_states: list[dict], candidates: list[dict]
) -> tuple[list[dict], list[RepairTask]]:
    """-> (violations, ec placement-move tasks).

    ec_states: the repair planner's shape ({vid, collection,
    total_shards, holders: {shard_id: [urls]}}, optionally
    parity_shards); candidates: [{url, dc, rack, free}]. A failure
    domain (rack) holding more than `parity` shards is a data-loss
    domain: losing it loses more shards than decode can tolerate."""
    domain_of = {c["url"]: (c["dc"], c["rack"]) for c in candidates}
    violations: list[dict] = []
    tasks: list[RepairTask] = []
    for st in ec_states:
        total = int(st["total_shards"])
        parity = int(
            st.get("parity_shards")
            or max(total - DATA_SHARDS_COUNT, 1)
        )
        holders = st["holders"]
        shard_domains: dict[tuple, list[int]] = defaultdict(list)
        shard_home: dict[int, str] = {}
        for sid, urls in holders.items():
            if not urls:
                continue
            url = urls[0]
            shard_home[int(sid)] = url
            dom = domain_of.get(url)
            if dom is not None:
                shard_domains[dom].append(int(sid))
        if len({d for d in shard_domains}) <= 1 and len(candidates) <= 1:
            continue  # single-domain cluster: nowhere to spread to
        overloaded = {
            dom: sids
            for dom, sids in shard_domains.items()
            if len(sids) > parity
        }
        if not overloaded or len(shard_domains) == 0:
            continue
        if len({(c["dc"], c["rack"]) for c in candidates}) <= 1:
            continue  # policy unsatisfiable on this topology: report-only
        dom, sids = max(overloaded.items(), key=lambda kv: len(kv[1]))
        violation = {
            "kind": "ec_domain",
            "volume_id": int(st["vid"]),
            "collection": st.get("collection", ""),
            "domain": f"{dom[0]}/{dom[1]}",
            "shards_in_domain": len(sids),
            "parity_shards": parity,
        }
        violations.append(violation)
        sid = max(sids)
        source = shard_home[sid]
        # only move INTO a domain that stays within the loss budget after
        # the move — with every other domain already at parity the policy
        # is unsatisfiable on this topology and shuffling shards between
        # overloaded racks would just oscillate scan over scan
        room = [
            c
            for c in candidates
            if len(shard_domains.get((c["dc"], c["rack"]), [])) < parity
        ]
        target = _pick_target(room, {source}, want_rack_not={dom})
        if target is None:
            violation["repair"] = (
                "no candidate domain has shard room below parity"
            )
            continue
        violation["repair"] = (
            f"move shard {sid} {source} -> {target['url']}"
        )
        tasks.append(
            RepairTask(
                kind="ec_placement",
                vid=int(st["vid"]),
                collection=st.get("collection", ""),
                priority=PLACEMENT_PRIORITY,
                missing=[sid],  # the shard to move
                survivors=total,
                target=target["url"],
                source=source,
            )
        )
    return violations, tasks
