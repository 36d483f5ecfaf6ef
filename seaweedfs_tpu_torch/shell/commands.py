"""Shell command registry (ref: weed/shell/commands.go + command files).

Each command: async fn(env, argv) -> output string. Ported from the JAX
package's shell/commands.py: help, lock, unlock, volume.list,
volume.mark.readonly, volume.delete, volume.mount, volume.unmount,
ec.encode (with VolumeEcShardsGenerateBatch for co-located volumes),
ec.rebuild (one VolumeEcShardsRebuildBatch per rebuilder node, with a
per-volume fallback), ec.decode (back to a normal volume through
VolumeEcShardsToVolume), ec.balance (dedupe and rack-aware moves),
volume.vacuum (the master's /vol/vacuum sweep, its VacuumStatus queue and
a forced scheduler round), meta.fleet.status (a filer's FleetStatus, in
the JAX formatter's text), and the anti-entropy plane's volume.scrub (a
forced VolumeScrub on every targeted server), ec.repair.status (the
master's RepairStatus, `-run` for one scheduler round),
volume.fix.replication, volume.copy and volume.move. Every other command
of the JAX shell (volume.configure.replication, volume.tier.*, the fs.*
and operator commands) answers "not ported".
"""

from __future__ import annotations

import time
from collections import defaultdict

from ..pb import grpc_address
from ..pb.rpc import Stub
from ..storage.erasure_coding import DATA_SHARDS_COUNT, TOTAL_SHARDS_COUNT
from ..storage.erasure_coding.ec_volume import ShardBits
from ..storage.super_block import ReplicaPlacement
from .command_env import CommandEnv
from .ec_common import (
    EcNode,
    execute_shard_move,
    nodes_from_topology,
    plan_balanced_spread,
    plan_dedupe,
    plan_rack_balance,
)

COMMANDS: dict[str, callable] = {}

# commands of the JAX shell a later slice ports
NOT_PORTED = (
    "collection.list", "collection.delete",
    "volume.configure.replication", "volume.tier.upload",
    "volume.tier.download", "volume.lifecycle",
    "volume.tier.sweep", "volume.balance",
    "volume.fsck", "geo.status",
    "geo.resync", "trace.status", "trace.dump",
    "overload.status",
)


def command(name: str):
    def deco(fn):
        COMMANDS[name] = fn
        return fn

    return deco

def _parse_flags(argv: list[str]) -> dict[str, str]:
    flags = {}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg.startswith("-"):
            key = arg.lstrip("-")
            if "=" in key:
                key, _, val = key.partition("=")
                flags[key] = val
            elif i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                flags[key] = argv[i + 1]
                i += 1
            else:
                flags[key] = "true"
        i += 1
    return flags


def _positional_args(argv: list[str], value_flags=()) -> tuple[dict, list]:
    """Flags and positional arguments: only `value_flags` consume a value
    (the JAX shell's operator_commands._fs_args)."""
    flags: dict[str, str] = {}
    positional: list[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("-"):
            key = a.lstrip("-")
            if "=" in key:
                key, _, val = key.partition("=")
                flags[key] = val
            elif key in value_flags and i + 1 < len(argv):
                flags[key] = argv[i + 1]
                i += 1
            else:
                flags[key] = "true"
        else:
            positional.append(a)
        i += 1
    return flags, positional


async def run_command(env: CommandEnv, line: str) -> str:
    parts = line.strip().split()
    if not parts:
        return ""
    name, argv = parts[0], parts[1:]
    fn = COMMANDS.get(name)
    if fn is None:
        if name in NOT_PORTED or name.startswith(("fs.", "bucket.")):
            return f"not ported: {name}"
        return f"unknown command: {name} (try `help`)"
    return await fn(env, argv)


# ---------------- basic ----------------
@command("help")
async def cmd_help(env, argv) -> str:
    return "commands:\n  " + "\n  ".join(sorted(COMMANDS))


@command("lock")
async def cmd_lock(env, argv) -> str:
    await env.acquire_lock()
    return "locked"


@command("unlock")
async def cmd_unlock(env, argv) -> str:
    await env.release_lock()
    return "unlocked"


@command("volume.list")
async def cmd_volume_list(env, argv) -> str:
    nodes = await env.collect_data_nodes()
    lines = []
    for dn in nodes:
        lines.append(
            f"node {dn['url']} dc:{dn['data_center']} rack:{dn['rack']} "
            f"volumes:{len(dn.get('volumes', []))} free:{dn.get('free_space', 0)}"
        )
        for v in dn.get("volumes", []):
            lines.append(
                f"  volume id:{v['id']} size:{v.get('size', 0)} "
                f"collection:{v.get('collection', '')!r} "
                f"file_count:{v.get('file_count', 0)} "
                f"deleted:{v.get('delete_count', 0)} "
                f"read_only:{v.get('read_only', False)}"
            )
        for m in dn.get("ec_shards", []):
            bits = ShardBits(int(m["ec_index_bits"]))
            lines.append(f"  ec volume id:{m['id']} shards:{bits.shard_ids()}")
    return "\n".join(lines) or "no volume servers"


# ---------------- volume management ----------------
@command("volume.mark.readonly")
async def cmd_volume_mark_readonly(env, argv) -> str:
    env.confirm_is_locked()
    flags = _parse_flags(argv)
    vid = int(flags["volumeId"])
    for dn in await env.collect_data_nodes():
        if any(int(v["id"]) == vid for v in dn.get("volumes", [])):
            await env.volume_stub(dn["url"]).call(
                "VolumeMarkReadonly", {"volume_id": vid}
            )
    return f"volume {vid} marked readonly"


@command("volume.delete")
async def cmd_volume_delete(env, argv) -> str:
    env.confirm_is_locked()
    flags = _parse_flags(argv)
    vid = int(flags["volumeId"])
    node = flags.get("node", "")
    for dn in await env.collect_data_nodes():
        if node and dn["url"] != node:
            continue
        if any(int(v["id"]) == vid for v in dn.get("volumes", [])):
            await env.volume_stub(dn["url"]).call("VolumeDelete", {"volume_id": vid})
    return f"volume {vid} deleted"


@command("volume.unmount")
async def cmd_volume_unmount(env, argv) -> str:
    env.confirm_is_locked()
    flags = _parse_flags(argv)
    vid = int(flags["volumeId"])
    node = flags["node"]
    await env.volume_stub(node).call("VolumeUnmount", {"volume_id": vid})
    return f"volume {vid} unmounted from {node}"


@command("volume.mount")
async def cmd_volume_mount(env, argv) -> str:
    env.confirm_is_locked()
    flags = _parse_flags(argv)
    vid = int(flags["volumeId"])
    node = flags["node"]
    await env.volume_stub(node).call("VolumeMount", {"volume_id": vid})
    return f"volume {vid} mounted on {node}"


async def move_volume(
    env, vid: int, collection: str, source: str, target: str, timeout: float = 600
) -> str:
    """Copy a volume to the target node, then delete the source copy;
    returns '' on success (ref command_volume_move.go)."""
    r = await env.volume_stub(target).call(
        "VolumeCopy",
        {"volume_id": vid, "collection": collection, "source_data_node": source},
        timeout=timeout,
    )
    if r.get("error"):
        return r["error"]
    await env.volume_stub(source).call("VolumeDelete", {"volume_id": vid})
    return ""


@command("volume.move")
async def cmd_volume_move(env, argv) -> str:
    """Copy a volume to a target node, then delete the source copy
    (ref command_volume_move.go)."""
    env.confirm_is_locked()
    flags = _parse_flags(argv)
    vid = int(flags["volumeId"])
    source, target = flags["source"], flags["target"]
    err = await move_volume(env, vid, flags.get("collection", ""), source, target)
    if err:
        return f"move failed: {err}"
    return f"volume {vid} moved {source} -> {target}"


@command("volume.copy")
async def cmd_volume_copy(env, argv) -> str:
    """volume.copy <source host:port> <target host:port> <volume id> —
    copy a volume between volume servers (ref command_volume_copy.go;
    usually unmount it first)."""
    env.confirm_is_locked()
    flags, args = _positional_args(argv, value_flags=("collection",))
    if len(args) != 3:
        return (
            "usage: volume.copy <source host:port> <target host:port> "
            "<volume id>"
        )
    source, target, vid_s = args
    try:
        vid = int(vid_s)
    except ValueError:
        return f"wrong volume id format {vid_s!r}"
    if source == target:
        return "source and target volume servers are the same!"
    r = await env.volume_stub(target).call(
        "VolumeCopy",
        {
            "volume_id": vid,
            "collection": flags.get("collection", ""),
            "source_data_node": source,
        },
        timeout=3600,
    )
    if r.get("error"):
        return f"copy failed: {r['error']}"
    return f"volume {vid} copied {source} -> {target}"


@command("volume.fix.replication")
async def cmd_volume_fix_replication(env, argv) -> str:
    """Re-replicate under-replicated volumes (ref
    command_volume_fix_replication.go)."""
    env.confirm_is_locked()
    nodes = await env.collect_data_nodes()
    fixes = plan_replication_fixes(nodes)
    done = []
    for vid, source, target, collection in fixes:
        r = await env.volume_stub(target).call(
            "VolumeCopy",
            {"volume_id": vid, "collection": collection,
             "source_data_node": source},
            timeout=600,
        )
        if not r.get("error"):
            done.append(f"volume {vid}: copied {source} -> {target}")
    return "\n".join(done) or "no under-replicated volumes"


def plan_replication_fixes(
    nodes: list[dict],
) -> list[tuple[int, str, str, str]]:
    """Pure planner: -> [(vid, source_url, target_url, collection)]."""
    locations = defaultdict(list)
    info_by_vid = {}
    for dn in nodes:
        for v in dn.get("volumes", []):
            locations[int(v["id"])].append(dn["url"])
            info_by_vid[int(v["id"])] = v
    fixes = []
    for vid, urls in locations.items():
        info = info_by_vid[vid]
        rp = ReplicaPlacement.from_byte(int(info.get("replica_placement", 0)))
        want = rp.copy_count()
        if len(urls) >= want:
            continue
        candidates = [
            dn["url"]
            for dn in nodes
            if dn["url"] not in urls and int(dn.get("free_space", 0)) > 0
        ]
        for target in candidates[: want - len(urls)]:
            fixes.append((vid, urls[0], target, info.get("collection", "")))
    return fixes


# ---------------- EC suite ----------------
async def _collect_ec_nodes(env) -> list[EcNode]:
    return nodes_from_topology(await env.collect_data_nodes())


async def _ec_geometry(env, vid: int, collection: str, holders) -> tuple[int, int]:
    """(data_shards, parity_shards) of an EC volume, asked from a shard
    holder's .vif (VolumeEcShardsInfo); falls back to the standard 10.4."""
    for url in holders:
        try:
            r = await env.volume_stub(url).call(
                "VolumeEcShardsInfo", {"volume_id": vid, "collection": collection}
            )
            if not r.get("error"):
                return (
                    int(r.get("data_shards") or DATA_SHARDS_COUNT),
                    int(
                        r.get("parity_shards")
                        or TOTAL_SHARDS_COUNT - DATA_SHARDS_COUNT
                    ),
                )
        except Exception:
            continue
    return DATA_SHARDS_COUNT, TOTAL_SHARDS_COUNT - DATA_SHARDS_COUNT


@command("volume.vacuum")
async def cmd_volume_vacuum(env, argv) -> str:
    """Vacuum plane: `volume.vacuum [-garbageThreshold=0.3]` forces a
    cluster sweep; `-status` shows the master's highest-garbage-first
    queue and recent outcomes; `-run` forces one scheduler scan+dispatch
    round off heartbeat garbage ratios."""
    flags = _parse_flags(argv)
    if "status" in flags or "run" in flags:
        req: dict = {}
        if "run" in flags:
            req["run"] = True
            if "garbageThreshold" in flags:
                req["garbage_threshold"] = float(flags["garbageThreshold"])
        r = await env.master_stub.call("VacuumStatus", req, timeout=3600)
        if r.get("error"):
            return f"vacuum status failed: {r['error']}"
        lines = [
            f"auto_vacuum: {'on' if r.get('auto_vacuum') else 'off'} "
            f"(threshold {r.get('garbage_threshold')}) · "
            f"queue depth: {r.get('queue_depth', 0)}"
        ]
        from ..topology.vacuum_plan import priority_to_ratio

        for t in r.get("queue", []):
            lines.append(
                f"  queued volume {t['volume_id']} (garbage ~"
                f"{priority_to_ratio(int(t['priority'])):.2f}, "
                f"attempts {t['attempts']})"
            )
        for t in r.get("recent", []):
            if t.get("error"):
                outcome = f"ERROR: {t['error']}"
            elif t.get("skipped"):
                outcome = f"skipped ({t['skipped']})"
            else:
                outcome = "compacted"
            lines.append(f"  recent volume {t['volume_id']}: {outcome}")
        if "ran" in r:
            ran = r["ran"]
            lines.append(
                f"ran one round: dispatched {len(ran.get('dispatched', []))},"
                f" queue depth now {ran.get('queue_depth', 0)}"
            )
        return "\n".join(lines)
    threshold = float(flags.get("garbageThreshold", 0.3))
    import json

    from ..util.fasthttp import FastHTTPClient

    http = FastHTTPClient()
    try:
        # a sweep answers when every compaction has committed
        _status, body = await http.request(
            "GET", env.master, f"/vol/vacuum?garbageThreshold={threshold}",
            timeout=3600,
        )
    finally:
        await http.close()
    return f"vacuum: {json.loads(body)}"


@command("ec.encode")
async def cmd_ec_encode(env, argv) -> str:
    """Erasure-code volumes and spread shards
    (ref command_ec_encode.go:55-264).

    -shards k.m selects an alternate RS geometry (e.g. 6.3, 12.4); the
    default is the reference's 10.4 (ec_encoder.go:17-23).
    """
    env.confirm_is_locked()
    flags = _parse_flags(argv)
    collection = flags.get("collection", "")
    data_shards = parity_shards = 0
    if "shards" in flags:
        try:
            k, _, m = flags["shards"].partition(".")
            data_shards, parity_shards = int(k), int(m)
        except ValueError:
            data_shards = parity_shards = 0
        if data_shards < 1 or parity_shards < 1:
            return f"bad -shards {flags['shards']!r}; want e.g. 10.4 or 6.3"
    vids: list[int] = []
    if "volumeId" in flags:
        # comma-separated ids allowed: co-located ones encode as one batch
        vids = [int(x) for x in str(flags["volumeId"]).split(",") if x]
    else:
        full_pct = float(flags.get("fullPercent", 95))
        nodes = await env.collect_data_nodes()
        resp = await env.master_stub.call("VolumeList", {})
        limit_mb = int(resp.get("volume_size_limit_mb", 30000))
        seen = set()
        for dn in nodes:
            for v in dn.get("volumes", []):
                vid = int(v["id"])
                if vid in seen or v.get("collection", "") != collection:
                    continue
                if int(v.get("size", 0)) >= limit_mb * 1024 * 1024 * full_pct / 100:
                    seen.add(vid)
                    vids.append(vid)
    results = []
    # volumes co-located on one node encode as a single shared batch
    # (VolumeEcShardsGenerateBatch -> write_ec_files_multi): one device
    # dispatch per round serves every volume instead of encoding serially
    nodes = await env.collect_data_nodes()
    by_source: dict = {}
    for vid in vids:
        source = None
        for dn in nodes:
            if any(int(v["id"]) == vid for v in dn.get("volumes", [])):
                source = dn["url"]
                break
        by_source.setdefault(source, []).append(vid)
    for source, group in by_source.items():
        if source is None:
            results.extend(f"volume {v}: not found" for v in group)
        elif len(group) == 1:
            results.append(
                await _do_ec_encode(
                    env, group[0], collection, data_shards, parity_shards,
                    source=source,
                )
            )
        else:
            sstub = env.volume_stub(source)
            for v in group:
                await sstub.call("VolumeMarkReadonly", {"volume_id": v})
            gen_req = {"volume_ids": group, "collection": collection}
            if data_shards:
                gen_req["data_shards"] = data_shards
                gen_req["parity_shards"] = parity_shards
            t0 = time.perf_counter()
            r = await sstub.call(
                "VolumeEcShardsGenerateBatch", gen_req, timeout=3600
            )
            generate_s = time.perf_counter() - t0
            errs = (
                {str(v): r["error"] for v in group}
                if r.get("error")
                else r.get("errors", {})
            )
            for v in group:
                if str(v) in errs:
                    results.append(
                        f"volume {v}: generate failed: {errs[str(v)]}"
                    )
                else:
                    results.append(
                        await _ec_spread(
                            env, v, collection, data_shards,
                            parity_shards, source, generate_s,
                        )
                    )
    return "\n".join(results) or "no volumes to encode"


async def _do_ec_encode(
    env,
    vid: int,
    collection: str,
    data_shards: int = 0,
    parity_shards: int = 0,
    source: str = "",
) -> str:
    if not source:
        nodes = await env.collect_data_nodes()
        for dn in nodes:
            if any(int(v["id"]) == vid for v in dn.get("volumes", [])):
                source = dn["url"]
                break
        if not source:
            return f"volume {vid}: not found"
    sstub = env.volume_stub(source)
    await sstub.call("VolumeMarkReadonly", {"volume_id": vid})
    gen_req = {"volume_id": vid, "collection": collection}
    if data_shards:
        gen_req["data_shards"] = data_shards
        gen_req["parity_shards"] = parity_shards
    t0 = time.perf_counter()
    r = await sstub.call("VolumeEcShardsGenerate", gen_req, timeout=3600)
    if r.get("error"):
        return f"volume {vid}: generate failed: {r['error']}"
    return await _ec_spread(
        env, vid, collection, data_shards, parity_shards, source,
        time.perf_counter() - t0,
    )


async def _ec_spread(
    env,
    vid: int,
    collection: str,
    data_shards: int,
    parity_shards: int,
    source: str,
    generate_s: float,
) -> str:
    """Spread freshly-generated shards, mount them, drop the source volume
    (the tail of ref command_ec_encode.go:110-135). The answer ends with
    the generate call's wall (`generate_s`, shared by a batch) and this
    spread's: the copies, mounts and the source's deletes."""
    t0 = time.perf_counter()
    sstub = env.volume_stub(source)
    total = (data_shards + parity_shards) or TOTAL_SHARDS_COUNT
    ec_nodes = await _collect_ec_nodes(env)
    assignment = plan_balanced_spread(
        ec_nodes, vid, list(range(total)), source
    )
    for target, shard_ids in assignment.items():
        tstub = env.volume_stub(target)
        if target != source:
            r = await tstub.call(
                "VolumeEcShardsCopy",
                {
                    "volume_id": vid,
                    "collection": collection,
                    "shard_ids": shard_ids,
                    "copy_ecx_file": True,
                    "source_data_node": source,
                },
                timeout=3600,
            )
            if r.get("error"):
                return f"volume {vid}: copy to {target} failed: {r['error']}"
        r = await tstub.call(
            "VolumeEcShardsMount",
            {"volume_id": vid, "collection": collection, "shard_ids": shard_ids},
        )
        if r.get("error"):
            return f"volume {vid}: mount on {target} failed: {r['error']}"

    # drop the source volume + its non-assigned shard files. Delete WHILE
    # mounted (keep_ec_files spares the .vif/.heat the EC volume needs):
    # the old unmount-then-delete sequence no-op'd the delete, leaving a
    # stale .dat a later mount scan could resurrect as a writable twin
    await sstub.call(
        "VolumeDelete", {"volume_id": vid, "keep_ec_files": True}
    )
    own = assignment.get(source, [])
    await sstub.call(
        "VolumeEcShardsDelete",
        {
            "volume_id": vid,
            "collection": collection,
            "shard_ids": [i for i in range(total) if i not in own],
        },
    )
    spread = {t: s for t, s in assignment.items()}
    return (
        f"volume {vid}: encoded, spread {spread}; generate_s={generate_s:.6f}"
        f" spread_s={time.perf_counter() - t0:.6f}"
    )


@command("ec.decode")
async def cmd_ec_decode(env, argv) -> str:
    """Collect all data shards on one node and turn the EC volume back
    into a normal volume (ref command_ec_decode.go:75-148)."""
    env.confirm_is_locked()
    flags = _parse_flags(argv)
    vid = int(flags["volumeId"])
    collection = flags.get("collection", "")
    ec_nodes = [n for n in await _collect_ec_nodes(env) if vid in n.shards]
    if not ec_nodes:
        return f"ec volume {vid} not found"
    k, m = await _ec_geometry(env, vid, collection, [n.url for n in ec_nodes])
    target = max(ec_nodes, key=lambda n: n.shards[vid].count())
    have = set(target.shards[vid].shard_ids())
    tstub = env.volume_stub(target.url)
    for n in ec_nodes:
        if n.url == target.url:
            continue
        missing_here = [s for s in n.shards[vid].shard_ids() if s not in have]
        if not missing_here:
            continue
        r = await tstub.call(
            "VolumeEcShardsCopy",
            {
                "volume_id": vid,
                "collection": collection,
                "shard_ids": missing_here,
                "copy_ecx_file": False,
                "source_data_node": n.url,
            },
            timeout=3600,
        )
        if r.get("error"):
            return f"copy shards {missing_here} from {n.url}: {r['error']}"
        have.update(missing_here)
    if len([s for s in have if s < k]) < k:
        # rebuild the missing data shards locally from parity
        r = await tstub.call(
            "VolumeEcShardsRebuild",
            {"volume_id": vid, "collection": collection},
            timeout=3600,
        )
        if r.get("error"):
            return f"rebuild for decode failed: {r['error']}"
    r = await tstub.call(
        "VolumeEcShardsToVolume",
        {"volume_id": vid, "collection": collection},
        timeout=3600,
    )
    if r.get("error"):
        return f"decode failed: {r['error']}"
    # unmount the shards everywhere and delete them, then mount the volume
    for n in ec_nodes:
        nstub = env.volume_stub(n.url)
        await nstub.call(
            "VolumeEcShardsUnmount",
            {"volume_id": vid, "shard_ids": n.shards[vid].shard_ids()},
        )
        await nstub.call(
            "VolumeEcShardsDelete",
            {"volume_id": vid, "collection": collection,
             "shard_ids": list(range(k + m))},
        )
    await tstub.call("VolumeMount", {"volume_id": vid})
    return f"ec volume {vid} decoded back to a normal volume on {target.url}"


@command("ec.rebuild")
async def cmd_ec_rebuild(env, argv) -> str:
    """Rebuild missing shards of damaged EC volumes
    (ref command_ec_rebuild.go:97-244): the rebuilder (the node with the
    most free slots) pulls every survivor it lacks, per volume as in the
    reference; then each rebuilder gets ONE VolumeEcShardsRebuildBatch
    for all its volumes, so volumes that lost the same shards decode in
    shared wide batches (the JAX package's extension; a server without
    the batch RPC gets one VolumeEcShardsRebuild per volume). It mounts
    the rebuilt shards and drops the extra survivor copies."""
    env.confirm_is_locked()
    flags = _parse_flags(argv)
    collection = flags.get("collection", "")
    ec_nodes = await _collect_ec_nodes(env)
    by_vid: dict[int, ShardBits] = defaultdict(ShardBits)
    for n in ec_nodes:
        for vid, bits in n.shards.items():
            by_vid[vid] = by_vid[vid].plus(bits)
    results = []
    plans = []  # (vid, rebuilder, local bits after pulls)
    for vid, bits in sorted(by_vid.items()):
        holders = [n.url for n in ec_nodes if vid in n.shards]
        k, m = await _ec_geometry(env, vid, collection, holders)
        missing = [i for i in range(k + m) if not bits.has(i)]
        if not missing:
            continue
        if bits.count() < k:
            results.append(f"volume {vid}: unrepairable ({bits.count()} shards)")
            continue
        rebuilder = max(ec_nodes, key=lambda n: n.free_slots)
        rstub = env.volume_stub(rebuilder.url)
        local = rebuilder.shards.get(vid, ShardBits())
        # pull every survivor shard the rebuilder lacks; a copy failure
        # skips THIS volume only — the other damaged volumes still rebuild
        copy_error = None
        for n in ec_nodes:
            if n.url == rebuilder.url:
                continue
            pull = [
                s
                for s in n.shards.get(vid, ShardBits()).shard_ids()
                if not local.has(s)
            ]
            if not pull:
                continue
            r = await rstub.call(
                "VolumeEcShardsCopy",
                {
                    "volume_id": vid,
                    "collection": collection,
                    "shard_ids": pull,
                    "copy_ecx_file": True,
                    "source_data_node": n.url,
                },
                timeout=3600,
            )
            if r.get("error"):
                copy_error = r["error"]
                break
            for s in pull:
                local = local.add(s)
        if copy_error is not None:
            results.append(f"volume {vid}: copy for rebuild: {copy_error}")
            continue
        plans.append((vid, rebuilder, local))

    # one batched rebuild RPC per rebuilder node
    by_rebuilder: dict[str, list] = defaultdict(list)
    for plan in plans:
        by_rebuilder[plan[1].url].append(plan)
    for url, group in by_rebuilder.items():
        rstub = env.volume_stub(url)
        vids = [vid for vid, _n, _l in group]
        per_vid: dict[int, dict] = {}
        try:
            r = await rstub.call(
                "VolumeEcShardsRebuildBatch",
                {"volume_ids": vids, "collection": collection},
                timeout=3600,
            )
        except Exception as e:  # a server without the batch RPC
            r = {"error": str(e)}
        if r.get("error"):
            for vid, _n, _l in group:
                per_vid[vid] = await rstub.call(
                    "VolumeEcShardsRebuild",
                    {"volume_id": vid, "collection": collection},
                    timeout=3600,
                )
        else:
            for vid in vids:
                res = r.get("results", {}).get(str(vid))
                err = r.get("errors", {}).get(str(vid))
                per_vid[vid] = res if res is not None else {
                    "error": err or "missing batch result"
                }
        for vid, rebuilder, local in group:
            rr = per_vid[vid]
            if rr.get("error"):
                results.append(f"volume {vid}: rebuild failed: {rr['error']}")
                continue
            rebuilt = rr.get("rebuilt_shard_ids", [])
            await rstub.call(
                "VolumeEcShardsMount",
                {"volume_id": vid, "collection": collection,
                 "shard_ids": rebuilt},
            )
            # drop the extra survivor copies the rebuilder pulled
            extra = [
                s for s in local.shard_ids()
                if s not in rebuilt
                and not rebuilder.shards.get(vid, ShardBits()).has(s)
            ]
            if extra:
                await rstub.call(
                    "VolumeEcShardsDelete",
                    {"volume_id": vid, "collection": collection,
                     "shard_ids": extra},
                )
            results.append(
                f"volume {vid}: rebuilt shards {rebuilt} on {rebuilder.url}"
            )
    return "\n".join(results) or "no damaged ec volumes"


@command("volume.scrub")
async def cmd_volume_scrub(env, argv) -> str:
    """Force a scrub pass: volume.scrub [-volumeId N] [-node host:port].
    Every targeted server re-verifies needle CRCs, index extents and EC
    parity (rate-shaped by its SEAWEEDFS_TPU_SCRUB_MBPS), applies the
    quarantine policy, and reports findings (an extension of the
    reference's shell)."""
    flags = _parse_flags(argv)
    vid = int(flags.get("volumeId", 0) or 0)
    node = flags.get("node", "")
    lines = []
    for dn in await env.collect_data_nodes():
        if node and dn["url"] != node:
            continue
        if vid and not (
            any(int(v["id"]) == vid for v in dn.get("volumes", []))
            or any(int(m["id"]) == vid for m in dn.get("ec_shards", []))
        ):
            continue
        try:
            r = await env.volume_stub(dn["url"]).call(
                "VolumeScrub",
                {"volume_id": vid, "include_ec": True},
                timeout=3600,
            )
        except Exception as e:
            lines.append(f"{dn['url']}: scrub failed: {e}")
            continue
        if r.get("error"):
            lines.append(f"{dn['url']}: scrub failed: {r['error']}")
            continue
        for vr in r.get("volumes", []):
            lines.append(
                f"{dn['url']} volume {vr['volume_id']}: "
                f"{vr['scanned']} records / {vr['bytes']} bytes verified, "
                f"{len(vr['corruptions'])} corruption(s)"
                + ("" if vr.get("completed", True) else " (partial pass)")
            )
            for key, kind, detail in vr["corruptions"]:
                lines.append(f"  CORRUPT key {int(key):#x}: {kind} ({detail})")
        for er in r.get("ec_volumes", []):
            if er.get("skipped"):
                lines.append(
                    f"{dn['url']} ec volume {er['volume_id']}: "
                    f"skipped ({er['skipped']})"
                )
                continue
            lines.append(
                f"{dn['url']} ec volume {er['volume_id']}: "
                f"{er['bytes']} bytes parity-verified, "
                f"corrupt shards {er['corrupt_shards']}"
            )
        for q in r.get("quarantined", []):
            what = (
                f"shard {q['shard_id']}" if "shard_id" in q else "volume"
            )
            lines.append(
                f"{dn['url']}: QUARANTINED {what} of volume "
                f"{q['volume_id']} (repair scheduler will pick it up)"
            )
    return "\n".join(lines) or "nothing to scrub"


@command("ec.repair.status")
async def cmd_ec_repair_status(env, argv) -> str:
    """Repair-plane status: ec.repair.status [-run]. Shows the master's
    prioritized repair queue (fewest-survivors-first), silent nodes, and
    recent dispatch outcomes; -run forces one scan+dispatch round."""
    flags = _parse_flags(argv)
    req = {"run": True} if "run" in flags else {}
    r = await env.master_stub.call("RepairStatus", req, timeout=3600)
    if r.get("error"):
        return f"repair status failed: {r['error']}"
    lines = [
        f"auto_repair: {'on' if r.get('auto_repair') else 'off'} "
        f"(grace {r.get('grace_seconds')}s) · "
        f"queue depth: {r.get('queue_depth', 0)} · "
        f"live nodes: {len(r.get('live_nodes', []))}"
    ]
    if r.get("silent_nodes"):
        lines.append("silent nodes: " + ", ".join(r["silent_nodes"]))
    for t in r.get("queue", []):
        lines.append(
            f"  queued {t['kind']} volume {t['volume_id']} "
            f"(survivors {t['survivors']}, attempts {t['attempts']})"
        )
    for t in r.get("recent", []):
        outcome = (
            f"ERROR: {t['error']}" if t.get("error") else "repaired"
        )
        lines.append(f"  recent {t['kind']} volume {t['volume_id']}: {outcome}")
    if "ran" in r:
        ran = r["ran"]
        lines.append(
            f"ran one round: dispatched {len(ran.get('dispatched', []))}, "
            f"queue depth now {ran.get('queue_depth', 0)}"
        )
    return "\n".join(lines)


@command("meta.fleet.status")
async def cmd_meta_fleet_status(env, argv) -> str:
    """Metadata fleet status: meta.fleet.status [-filer host:port].
    Shows the queried member's FLEETMAP view (epoch, every member's
    directory range, pending move/cleanup), its write-gate coalescing
    stats + store write rounds, and — when the member is a follower —
    the tail cursor and disclosed staleness bound."""
    flags = _parse_flags(argv)
    filer = flags.get("filer", "")
    if not filer:  # the JAX text: its fs.* commands keep a sticky filer, the port has none
        return "meta.fleet.status needs -filer host:port (or a sticky filer)"
    r = await Stub(grpc_address(filer), "filer").call(
        "FleetStatus", {}, timeout=10.0
    )
    if r.get("error"):
        return f"meta.fleet.status on {filer} failed: {r['error']}"
    lines = [f"filer {r.get('address', filer)}:"]
    fleet = r.get("fleet")
    if not r.get("configured"):
        lines.append("  fleet: not a fleet member")
    elif fleet:
        m = fleet.get("map", {})
        lines.append(
            f"  fleet epoch {fleet.get('epoch')} · "
            f"{fleet.get('members')} member(s) · self range "
            f"[{fleet['range'][0] or '-inf'}, {fleet['range'][1] or '+inf'})"
        )
        bounds = m.get("bounds", [])
        for i, addr in enumerate(m.get("addresses", [])):
            lo = bounds[i - 1] if i > 0 else ""
            hi = bounds[i] if i < len(bounds) else ""
            marker = " (self)" if addr == fleet.get("self") else ""
            lines.append(
                f"    {addr}: [{lo or '-inf'}, {hi or '+inf'}){marker}"
            )
        if m.get("pending_move"):
            pm = m["pending_move"]
            lines.append(
                f"  PENDING MOVE [{pm['lo']}, {pm['hi']}) "
                f"{pm['src']} -> {pm['dst']}"
            )
        if m.get("pending_cleanup"):
            pc = m["pending_cleanup"]
            lines.append(
                f"  pending cleanup [{pc['lo']}, {pc['hi']}) on {pc['src']}"
            )
        c = fleet.get("counters", {})
        lines.append(
            f"  forwarded {c.get('forwarded')} · ingested "
            f"{c.get('ingested')} · moves {c.get('moves_committed')} ok / "
            f"{c.get('moves_failed')} failed · fence waits "
            f"{c.get('fence_waits')}"
        )
    wg = r.get("write_gate")
    if wg:
        lines.append(
            f"  write gate: {wg.get('writes')} writes in "
            f"{wg.get('batches')} round(s) · coalesced "
            f"{wg.get('coalesced')} · largest batch "
            f"{wg.get('largest_batch')} · item retries "
            f"{wg.get('item_retries')}"
        )
    if "write_rounds" in r:
        lines.append(f"  store write rounds: {r['write_rounds']}")
    fo = r.get("follower")
    if fo:
        lines.append(
            f"  follower of {fo.get('source')}: "
            + ("connected" if fo.get("connected") else "DISCONNECTED")
            + f" · cursor {fo.get('cursor_ns')} · staleness bound "
            f"{fo.get('staleness_bound_s')}s · applied {fo.get('applied')}"
            f" · redirects {fo.get('redirects')}"
        )
        if fo.get("resync_required"):
            lines.append(
                "  RESYNC REQUIRED: cursor behind primary retention "
                f"(trimmed through {fo.get('trimmed_through')})"
            )
    return "\n".join(lines)


@command("ec.balance")
async def cmd_ec_balance(env, argv) -> str:
    """Drop duplicate shard copies, then even every EC volume's shards
    out across racks and across the nodes of each rack
    (ref command_ec_balance.go:29-95)."""
    env.confirm_is_locked()
    flags = _parse_flags(argv)
    collection = flags.get("collection", "")
    ec_nodes = await _collect_ec_nodes(env)
    vids = sorted({vid for n in ec_nodes for vid in n.shards})
    log = []
    for vid in vids:
        for shard_id, url in plan_dedupe(ec_nodes, vid):
            stub = env.volume_stub(url)
            await stub.call(
                "VolumeEcShardsUnmount", {"volume_id": vid, "shard_ids": [shard_id]}
            )
            await stub.call(
                "VolumeEcShardsDelete",
                {"volume_id": vid, "collection": collection,
                 "shard_ids": [shard_id]},
            )
            log.append(f"volume {vid}: dropped duplicate shard {shard_id} on {url}")
        for move in plan_rack_balance(ec_nodes, vid):
            await execute_shard_move(env, move, collection)
            log.append(
                f"volume {vid}: moved shard {move.shard_id} "
                f"{move.source} -> {move.target}"
            )
    return "\n".join(log) or "balanced: no moves needed"


