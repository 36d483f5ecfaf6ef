"""Master server: volume -> location mapping and file-id assignment.

HTTP (data-plane control, ref: weed/server/master_server.go:112-130):
  /dir/assign /dir/lookup /dir/status /vol/grow /vol/vacuum /col/delete
  /cluster/status /{fileId} redirect
RPC "master" service (pb/rpc.py; ref: weed/server/master_grpc_server*.go):
  SendHeartbeat (bidi; full + delta volume/EC inventories),
  KeepConnected (vid-location push to clients), Assign, Statistics,
  LookupVolume, LookupEcVolume, CollectionList/Delete, VolumeList,
  LeaseAdminToken/ReleaseAdminToken, GetMasterConfiguration,
  VacuumStatus, RepairStatus, PlacementStatus and the two Raft RPCs.

Multi-master: RaftLite (server/raft.py) elects one leader; followers
proxy Assign/lookups to it, redirect heartbeat + KeepConnected streams,
and freshly assigned volume ids are majority-committed before use
(ref: weed/server/raft_server.go, weed/topology/topology.go:115-122).

Ported from the JAX package's server/master.py. One HTTP server
(util/fasthttp.py through server/serving_core.py) serves every route
where the JAX master runs an aiohttp application behind a fast tier;
the answers (status, JSON bodies, redirects) are the JAX handlers'.
The vacuum plane is the JAX master's: heartbeat garbage ratios feed a
highest-garbage-first queue (topology/vacuum_plan.py) that dispatches
check, compact, commit or cleanup to every replica under a concurrency
cap, from `/vol/vacuum`, the VacuumStatus RPC and the opt-in background
loop (`auto_vacuum`, SEAWEEDFS_TPU_AUTO_VACUUM). The anti-entropy plane
is the JAX master's too: heartbeats carry each replica's content digest,
append frontier and scrub quarantine, and EC shard inventories; a scan
(`run_anti_entropy_once`, from RepairStatus `run`, PlacementStatus `run`
or the opt-in loop `auto_repair`, SEAWEEDFS_TPU_AUTO_REPAIR) plans EC
rebuilds of shards missing on live nodes (a node silent past
`repair_grace_seconds` no longer counts), re-copies of quarantined
replicas, tail syncs of stale ones and placement moves, and dispatches
them fewest-survivors-first under `repair_concurrency`: one
VolumeEcShardsRebuildBatch per rebuilder node (B1 on its card),
VolumeRepairCopy, VolumeTailSync, VolumeCopy + VolumeDelete. Unlike
the JAX master, it deletes the survivor shards a rebuild pulled to the
rebuilder once the rebuild is done: left there unmounted, they would
stop a later rebuild of those ids after their holder is lost. Not
ported, each answering an explicit error: the lifecycle and tier-sweep
planes (their RPCs LifecycleStatus and TierOrphanSweep answer the RPC
tier's 501 `not ported`), the maintenance scripts, and the `/ui` page
(HTTP 501).
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import time
from typing import Optional
from urllib.parse import parse_qsl

from ..pb import grpc_address
from ..pb.rpc import Service, Stub, serve
from ..sequence import MemorySequencer
from ..storage.erasure_coding import DATA_SHARDS_COUNT, TOTAL_SHARDS_COUNT
from ..storage.erasure_coding.ec_volume import ShardBits
from ..storage.super_block import ReplicaPlacement
from ..storage.ttl import TTL
from ..topology import GrowOption, Topology, VolumeGrowth
from ..topology.placement import plan_ec_domain_spread, plan_replica_spread
from ..topology.repair import (
    RepairQueue,
    find_unresolved_divergence,
    plan_ec_repairs,
    plan_replica_repairs,
)
from ..topology.vacuum_plan import plan_vacuums
from ..topology.volume_growth import NoFreeSpaceError, grow_count_for_copy_level
from ..util.fasthttp import (
    JSON_FULL,
    fast_tier_json,
    render_http_exception,
    render_response,
)
from ..util.metrics import (
    ANTIENTROPY_DIVERGED,
    PLACEMENT_VIOLATIONS,
    REPAIR_SECONDS,
    VACUUM_QUEUE_DEPTH,
)
from .serving_core import ServingCore, json_body, not_ported

_LOG = logging.getLogger(__name__)

# the vacuum scheduler's scan interval and the silence after which a node
# stops counting as a replica holder: the JAX master's at its default
# 5 s pulse (max(4 pulses, 2 s) and max(15 s, 4 pulses))
VACUUM_SCAN_SECONDS = 20.0
LIVE_GRACE_SECONDS = 20.0
# the anti-entropy scan interval: the JAX master's max(2 pulses, 1 s) at
# its default 5 s pulse; its repair grace defaults to LIVE_GRACE_SECONDS
REPAIR_SCAN_SECONDS = 10.0

# /dir/assign parameters the JAX master's fast tier serves itself
_FAST_ASSIGN_PARAMS = frozenset(
    ("count", "collection", "replication", "ttl", "dataCenter")
)


def _json(
    status: int, obj, head_only: bool = False, content_type: bytes = JSON_FULL
) -> bytes:
    """A JSON answer, by default with the Content-Type of the JAX master's
    aiohttp application, which serves every route but its fast tier's."""
    return render_response(status, json_body(obj), head_only=head_only,
                           content_type=content_type)


def _params(req) -> dict:
    """Query parameters plus an urlencoded form body, first value of each
    (what the JAX handlers read from `request.query` and
    `request.post()`)."""
    out: dict = {}
    for k, v in parse_qsl(req.query, keep_blank_values=True):
        out.setdefault(k, v)
    ct = req.headers.get(b"content-type", b"")
    if req.method == "POST" and req.body and ct.startswith(
        b"application/x-www-form-urlencoded"
    ):
        for k, v in parse_qsl(req.body.decode("latin1"),
                              keep_blank_values=True):
            out[k] = v
    return out



async def _drop_pulled(rstub, task, shard_ids: list[int]) -> None:
    """Delete the survivor shards an EC rebuild pulled to its rebuilder
    (unmounted copies of shards their holders still serve)."""
    await rstub.call(
        "VolumeEcShardsDelete",
        {
            "volume_id": task.vid,
            "collection": task.collection,
            "shard_ids": sorted(shard_ids),
        },
        timeout=600,
    )

class MasterServer:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 9333,
        volume_size_limit_mb: int = 30_000,
        default_replication: str = "000",
        garbage_threshold: float = 0.3,
        jwt_signing_key: str = "",
        jwt_expires_seconds: int = 10,
        peers: Optional[list[str]] = None,
        admin_lease_seconds: float = 10.0,
        sequencer_file: str = "",
        raft_state_file: str = "",
        auto_vacuum: Optional[bool] = None,
        vacuum_concurrency: int = 2,
        auto_repair: Optional[bool] = None,
        repair_grace_seconds: Optional[float] = None,
        repair_concurrency: int = 2,
    ):
        self.jwt_signing_key = jwt_signing_key
        self.jwt_expires_seconds = jwt_expires_seconds
        self.admin_lease_seconds = admin_lease_seconds
        self.host = host
        self.port = port
        self.address = f"{host}:{port}"
        self.default_replication = default_replication
        self.garbage_threshold = garbage_threshold
        if sequencer_file:
            from ..sequence import FileSequencer

            sequencer = FileSequencer(sequencer_file)
        else:
            sequencer = MemorySequencer()
        self.topo = Topology(
            volume_size_limit=volume_size_limit_mb * 1024 * 1024,
            sequencer=sequencer,
        )
        self.growth = VolumeGrowth()
        from .raft import RaftLite

        self.raft = RaftLite(
            self.address,
            peers,
            get_max_volume_id=lambda: self.topo.max_volume_id,
            adjust_max_volume_id=self.topo.adjust_max_volume_id,
            state_file=raft_state_file,
        )
        # anti-entropy repair plane: heartbeat-driven failure detection ->
        # prioritized queue -> batched-rebuild dispatch. The background
        # loop is opt-in (SEAWEEDFS_TPU_AUTO_REPAIR / auto_repair=True);
        # run_anti_entropy_once() is always callable (shell, tests).
        if auto_repair is None:
            auto_repair = os.environ.get(
                "SEAWEEDFS_TPU_AUTO_REPAIR", ""
            ).lower() in ("1", "true", "on", "yes")
        self.auto_repair = auto_repair
        self.repair_grace_seconds = (
            repair_grace_seconds
            if repair_grace_seconds is not None
            else LIVE_GRACE_SECONDS
        )
        self.repair_concurrency = repair_concurrency
        self.repair_queue = RepairQueue(rng=random.Random())
        self.repair_log: list[dict] = []  # last dispatch outcomes
        # latest anti-entropy scan's placement-policy findings (served
        # by PlacementStatus)
        self.placement_violations: list[dict] = []
        # vid -> k+m from a holder's .vif (VolumeEcShardsInfo)
        self._ec_geom_cache: dict[int, int] = {}
        self._repair_task: Optional[asyncio.Task] = None
        # vacuum plane: garbage ratios ride heartbeats; findings feed a
        # highest-garbage-first queue dispatched under a concurrency cap
        # with full-jitter backoff. Background loop opt-in
        # (SEAWEEDFS_TPU_AUTO_VACUUM / auto_vacuum=True); run_vacuum_once()
        # is always callable (/vol/vacuum, VacuumStatus -run, tests).
        if auto_vacuum is None:
            auto_vacuum = os.environ.get(
                "SEAWEEDFS_TPU_AUTO_VACUUM", ""
            ).lower() in ("1", "true", "on", "yes")
        self.auto_vacuum = auto_vacuum
        self.vacuum_concurrency = vacuum_concurrency
        self.vacuum_queue = RepairQueue(
            rng=random.Random(), depth_gauge=VACUUM_QUEUE_DEPTH
        )
        self.vacuum_log: list[dict] = []
        self._vacuum_task: Optional[asyncio.Task] = None
        self._vacuum_inflight: set[int] = set()
        self._clients: dict[str, asyncio.Queue] = {}
        self._option_cache: dict[tuple, GrowOption] = {}
        self._admin_token: Optional[tuple[int, float]] = None  # (token, ts)
        self._core: Optional[ServingCore] = None
        self._grpc_server = None
        self._shutdown = False

    @property
    def leader(self) -> str:
        return self.raft.leader_address or self.address

    @property
    def known_leader(self) -> str:
        """The elected leader, or "" while none is known — a deposed or
        mid-election master must not hint clients back to itself."""
        if self.raft.is_leader:
            return self.address
        return self.raft.leader_address or ""

    @property
    def is_leader(self) -> bool:
        return self.raft.is_leader

    # ---------------- lifecycle ----------------
    async def start(self) -> None:
        self._core = ServingCore("master", self._dispatch, self.host,
                                 self.port)
        await self._core.start()
        svc = Service("master")
        svc.bidi_stream("SendHeartbeat")(self._send_heartbeat)
        svc.bidi_stream("KeepConnected")(self._keep_connected)
        svc.unary("Assign")(self._grpc_assign)
        svc.unary("LookupVolume")(self._grpc_lookup_volume)
        svc.unary("LookupEcVolume")(self._grpc_lookup_ec_volume)
        svc.unary("Statistics")(self._grpc_statistics)
        svc.unary("CollectionList")(self._grpc_collection_list)
        svc.unary("CollectionDelete")(self._grpc_collection_delete)
        svc.unary("VolumeList")(self._grpc_volume_list)
        svc.unary("LeaseAdminToken")(self._grpc_lease_admin_token)
        svc.unary("ReleaseAdminToken")(self._grpc_release_admin_token)
        svc.unary("GetMasterConfiguration")(self._grpc_get_configuration)
        svc.unary("VacuumStatus")(self._grpc_vacuum_status)
        svc.unary("RepairStatus")(self._grpc_repair_status)
        svc.unary("PlacementStatus")(self._grpc_placement_status)
        svc.unary("RaftRequestVote")(self._grpc_raft_request_vote)
        svc.unary("RaftAppendEntries")(self._grpc_raft_append_entries)
        self._grpc_server = await serve(grpc_address(self.address), svc)
        self.raft.start()
        if self.auto_vacuum:
            self._vacuum_task = asyncio.ensure_future(self._auto_vacuum_loop())
        if self.auto_repair:
            self._repair_task = asyncio.ensure_future(self._anti_entropy_loop())

    async def stop(self) -> None:
        self._shutdown = True
        for task in (self._vacuum_task, self._repair_task):
            if task is None:
                continue
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
        await self.raft.stop()
        if self._grpc_server is not None:
            await self._grpc_server.stop()
        if self._core is not None:
            await self._core.stop()

    # ---------------- HTTP dispatch ----------------
    async def _dispatch(self, req):
        path = req.path
        head_only = req.method == "HEAD"
        if path == "/dir/assign":
            # a form body goes to the JAX master's aiohttp application
            ctype = (JSON_FULL if req.body
                     else fast_tier_json(req.query, _FAST_ASSIGN_PARAMS))
            return _json(200, await self._do_assign(_params(req)),
                         content_type=ctype)
        if path == "/dir/lookup":
            return self._dir_lookup(req)
        if path in ("/dir/status", "/cluster/status", "/", "/ui") and \
                req.method not in ("GET", "HEAD"):
            return render_http_exception(405)
        if path == "/dir/status":
            return _json(200, {"Topology": self.topo.to_info(),
                               "Version": "seaweedfs-tpu 0.1"}, head_only)
        if path == "/vol/grow":
            return await self._vol_grow(req)
        if path == "/vol/vacuum":
            return await self._vol_vacuum(req)
        if path == "/col/delete":
            return await self._col_delete(req)
        if path == "/cluster/status":
            return _json(200, {"IsLeader": self.is_leader,
                               "Leader": self.leader,
                               "Peers": self.raft.others()}, head_only)
        if path in ("/", "/ui"):
            return not_ported("the /ui status page", head_only)
        fid = path.lstrip("/")
        head, sep, tail = fid.partition(",")
        if req.method in ("GET", "HEAD") and sep and head.isdigit() and tail:
            return self._redirect(req, fid)
        return render_http_exception(404, head_only=head_only)

    def _leader_gate_http(self, req) -> Optional[bytes]:
        """None when this master may serve the request; otherwise a 503
        (no leader yet) or a redirect to the leader
        (ref master_server.go:159-189 proxyToLeader)."""
        if self.is_leader:
            return None
        leader = self.raft.leader_address
        if not leader or leader == self.address:
            return _json(503, {"error": "no leader elected yet"})
        return render_http_exception(
            307, extra=f"Location: http://{leader}{req.target}\r\n".encode(),
        )

    def _dir_lookup(self, req) -> bytes:
        gate = self._leader_gate_http(req)
        if gate is not None:
            return gate
        params = _params(req)
        return _json(200, self._do_lookup(params.get("volumeId", ""),
                                          params.get("collection", "")),
                     content_type=fast_tier_json(req.query))

    async def _vol_grow(self, req) -> bytes:
        gate = self._leader_gate_http(req)
        if gate is not None:
            return gate
        params = _params(req)
        try:
            option = self._parse_option(params)
            # force the representability check (parse accepts any digits,
            # e.g. "300", but the byte encoding can't store them)
            option.replica_placement.to_byte()
            count = int(params.get("count", 1) or 1)
        except ValueError as e:
            return _json(400, {"error": str(e)})
        grown = await self.growth.grow_by_count(
            count, self.topo, option, self._allocate_volume
        )
        if grown == 0:
            return _json(404, {"error": "no free volumes left"})
        return _json(200, {"count": grown})

    async def _vol_vacuum(self, req) -> bytes:
        gate = self._leader_gate_http(req)
        if gate is not None:
            return gate
        # the query alone, as the JAX handler reads request.query
        query = dict(parse_qsl(req.query, keep_blank_values=True))
        threshold = float(query.get("garbageThreshold", self.garbage_threshold))
        return _json(200, {"Result": await self.vacuum(threshold)})

    async def _col_delete(self, req) -> bytes:
        gate = self._leader_gate_http(req)
        if gate is not None:
            return gate
        await self._delete_collection(_params(req).get("collection", ""))
        return _json(200, {})

    def _redirect(self, req, file_id: str) -> bytes:
        gate = self._leader_gate_http(req)
        if gate is not None:
            return gate
        result = self._do_lookup(file_id.split(",")[0])
        if "error" in result:
            return _json(404, result)
        url = result["locations"][0]["publicUrl"]
        return render_http_exception(
            301, extra=f"Location: http://{url}/{file_id}\r\n".encode(),
        )

    # ---------------- assignment core ----------------
    def _parse_option(self, params) -> GrowOption:
        # memoized: assigns repeat the same handful of option tuples
        key = (
            params.get("collection", ""),
            params.get("replication", ""),
            params.get("ttl", ""),
            params.get("dataCenter", ""),
            params.get("rack", ""),
        )
        opt = self._option_cache.get(key)
        if opt is None:
            opt = GrowOption(
                collection=key[0],
                replica_placement=ReplicaPlacement.parse(
                    key[1] or self.default_replication
                ),
                ttl=TTL.read(key[2]),
                data_center=key[3],
                rack=key[4],
            )
            if len(self._option_cache) > 256:  # runaway-key backstop
                self._option_cache.clear()
            self._option_cache[key] = opt
        return opt

    async def _allocate_volume(self, vid: int, option: GrowOption, servers) -> bool:
        """AllocateVolume RPC to each chosen server (ref
        topology/allocate_volume.go)."""
        # the vid must reach a raft majority before any server uses it
        if not await self.raft.commit_max_volume_id(vid):
            return False
        ok = True
        for dn in servers:
            stub = Stub(grpc_address(dn.url), "volume")
            try:
                resp = await stub.call(
                    "AllocateVolume",
                    {
                        "volume_id": vid,
                        "collection": option.collection,
                        "replication": str(option.replica_placement),
                        "ttl": str(option.ttl),
                        "preallocate": option.preallocate,
                    },
                )
                ok = ok and not resp.get("error")
            except Exception:
                ok = False
        return ok

    async def _ensure_writable(self, option: GrowOption) -> None:
        layout = self.topo.get_volume_layout(
            option.collection, option.replica_placement, option.ttl
        )
        if layout.has_writable_volume():
            return
        count = grow_count_for_copy_level(option.replica_placement.copy_count())
        grown = await self.growth.grow_by_count(
            count, self.topo, option, self._allocate_volume
        )
        if grown == 0:
            raise NoFreeSpaceError("no free volumes left")
        # push the fresh vid locations to KeepConnected clients right away
        for vid, locs in list(layout.vid_to_locations.items()):
            for dn in locs:
                self._broadcast_location(dn, new_vids=[vid], deleted_vids=[])

    async def _do_assign(self, params) -> dict:
        # only the raft leader may assign/grow: followers proxy to it
        # (ref master_server.go:159-189)
        proxied = await self._proxy_to_leader("Assign", dict(params))
        if proxied is not None:
            return proxied
        try:
            # clamp the lease width: count=N reserves N sequential ids
            count = min(max(int(params.get("count", 1) or 1), 1), 100_000)
            option = self._parse_option(params)
            await self._ensure_writable(option)
            fid, cnt, locations = self.topo.pick_for_write(
                count, option.collection, option.replica_placement, option.ttl
            )
        except (NoFreeSpaceError, LookupError, ValueError) as e:
            return {"error": str(e)}
        dn = locations[0]
        result = {
            "fid": fid,
            "url": dn.url,
            "publicUrl": dn.public_url,
            "count": cnt,
        }
        if self.jwt_signing_key:
            from ..util.security import gen_jwt

            result["auth"] = gen_jwt(
                self.jwt_signing_key, self.jwt_expires_seconds, fid
            )
        return result

    def _do_lookup(self, vid_str: str, collection: str = "") -> dict:
        try:
            vid = int(vid_str.split(",")[0])
        except ValueError:
            return {"volumeId": vid_str, "error": "unknown volumeId format"}
        locations = self.topo.lookup(collection, vid)
        if not locations:
            ec = self.topo.lookup_ec_shards(vid)
            if ec is not None:
                by_url = {}
                for locs in ec.locations:
                    for dn in locs:
                        by_url.setdefault(dn.url, dn)
                if by_url:
                    return {
                        "volumeId": vid_str,
                        "locations": [
                            {
                                "url": u,
                                "publicUrl": u,
                                "dataCenter": self._dc_of(by_url[u]),
                            }
                            for u in sorted(by_url)
                        ],
                    }
            return {"volumeId": vid_str, "error": "volume id not found"}
        return {
            "volumeId": vid_str,
            "locations": [
                {
                    "url": dn.url,
                    "publicUrl": dn.public_url,
                    "dataCenter": self._dc_of(dn),
                }
                for dn in locations
            ],
        }

    @staticmethod
    def _dc_of(dn) -> str:
        dc = getattr(dn, "data_center", None)
        return dc.id if dc is not None else ""

    async def _delete_collection(self, name: str) -> None:
        for dn in self.topo.data_nodes():
            stub = Stub(grpc_address(dn.url), "volume")
            try:
                await stub.call("DeleteCollection", {"collection": name})
            except Exception:
                pass
        self.topo.delete_collection(name)

    # ---------------- RPC: heartbeats ----------------
    async def _send_heartbeat(self, request_iterator, context):
        """Bidi heartbeat stream from one volume server
        (ref: master_grpc_server.go:20-178). The stream's end (the volume
        server stopped, died or lost its connection) unregisters the
        node."""
        # followers don't own topology state: hand the volume server the
        # leader's address and end the stream so it redials
        if not self.is_leader:
            yield {"leader": self.known_leader}
            return
        dn = None
        try:
            async for hb in request_iterator:
                if not self.is_leader:
                    yield {"leader": self.known_leader}
                    return
                if dn is None and hb.get("ip"):
                    dc = self.topo.get_or_create_data_center(
                        hb.get("data_center") or "DefaultDataCenter"
                    )
                    rack = dc.get_or_create_rack(hb.get("rack") or "DefaultRack")
                    dn = rack.get_or_create_data_node(
                        f"{hb['ip']}:{hb['port']}",
                        f"{hb['ip']}:{hb['port']}",
                        hb.get("public_url", ""),
                        int(hb.get("max_volume_count", 7)),
                    )
                if dn is None:
                    continue
                dn.last_seen = time.time()
                if hb.get("max_file_key"):
                    self.topo.sequence.set_max(int(hb["max_file_key"]))
                new_vids, deleted_vids = self._apply_heartbeat(dn, hb)
                if new_vids or deleted_vids:
                    self._broadcast_location(
                        dn, new_vids=new_vids, deleted_vids=deleted_vids
                    )
                yield {
                    "volume_size_limit": self.topo.volume_size_limit,
                    "leader": self.leader,
                    "metrics_interval_seconds": 15,
                }
        finally:
            if dn is not None:
                self._unregister_data_node(dn)

    def _apply_heartbeat(self, dn, hb: dict) -> tuple[list, list]:
        """Fold one heartbeat's full and delta inventories into the
        topology; -> (new vids, deleted vids)."""
        new_vids, deleted_vids = [], []
        if hb.get("volumes") is not None or hb.get("has_no_volumes"):
            new_infos, deleted_infos, changed_infos = dn.update_volumes(
                hb.get("volumes") or []
            )
            # an in-place layout change must move the volume between
            # VolumeLayouts, or assigns keep serving the old placement
            for old_info, _new_info in changed_infos:
                self.topo.unregister_volume(old_info, dn)
            for info in hb.get("volumes") or []:
                self.topo.register_volume(info, dn)
            for info in deleted_infos:
                self.topo.unregister_volume(info, dn)
            new_vids += [int(i["id"]) for i in new_infos]
            deleted_vids += [int(i["id"]) for i in deleted_infos]
        # deletions first: a changed volume arrives as a
        # (deleted=old-info, new=new-info) pair
        if hb.get("deleted_volumes"):
            dn.delta_update_volumes([], hb["deleted_volumes"])
            for info in hb["deleted_volumes"]:
                self.topo.unregister_volume(info, dn)
                deleted_vids.append(int(info["id"]))
        if hb.get("new_volumes"):
            dn.delta_update_volumes(hb["new_volumes"], [])
            for info in hb["new_volumes"]:
                self.topo.register_volume(info, dn)
                new_vids.append(int(info["id"]))

        if hb.get("ec_shards") is not None or hb.get("has_no_ec_shards"):
            new_ec, deleted_ec = dn.update_ec_shards(hb.get("ec_shards") or [])
            for vid, collection, bits in new_ec:
                self.topo.register_ec_shards(vid, collection, bits, dn)
                new_vids.append(vid)
            for vid, collection, bits in deleted_ec:
                self.topo.unregister_ec_shards(vid, collection, bits, dn)
                self.topo.forget_ec_volume_if_empty(vid)
        for m in hb.get("new_ec_shards") or []:
            bits = ShardBits(int(m["ec_index_bits"]))
            dn.delta_update_ec_shards(
                [(int(m["id"]), m.get("collection", ""), bits)], []
            )
            self.topo.register_ec_shards(
                int(m["id"]), m.get("collection", ""), bits, dn
            )
            new_vids.append(int(m["id"]))
        for m in hb.get("deleted_ec_shards") or []:
            bits = ShardBits(int(m["ec_index_bits"]))
            dn.delta_update_ec_shards(
                [], [(int(m["id"]), m.get("collection", ""), bits)]
            )
            self.topo.unregister_ec_shards(
                int(m["id"]), m.get("collection", ""), bits, dn
            )
            # an explicitly emptied EC volume is retired, not silent
            self.topo.forget_ec_volume_if_empty(int(m["id"]))
            if not dn.ec_shards.get(int(m["id"])):
                deleted_vids.append(int(m["id"]))
        # anti-entropy tick: refresh digest/frontier/quarantine/garbage
        # fields in place — layouts don't change, but replica comparison
        # and the vacuum planner must see current values
        for m in hb.get("volume_digests") or []:
            info = dn.volumes.get(int(m["id"]))
            if info is None:
                continue
            for k in (
                "content_digest",
                "append_at_ns",
                "read_only",
                "scrub_corrupt",
                "garbage_ratio",
                "size",
            ):
                if k in m:
                    info[k] = m[k]
        return new_vids, deleted_vids

    def _unregister_data_node(self, dn) -> None:
        """Heartbeat stream broke: drop all its volumes/EC shards
        (ref master_grpc_server.go:24-52)."""
        deleted = []
        for info in list(dn.volumes.values()):
            self.topo.unregister_volume(info, dn)
            deleted.append(int(info["id"]))
        for vid, bits in list(dn.ec_shards.items()):
            self.topo.unregister_ec_shards(vid, "", bits, dn)
            deleted.append(vid)
        dn.update_volumes([])
        dn.update_ec_shards([])
        if dn.parent:
            dn.parent.unlink_child(dn.id)
        if deleted:
            self._broadcast_location(dn, new_vids=[], deleted_vids=deleted)

    def _broadcast_location(self, dn, new_vids, deleted_vids) -> None:
        msg = {
            "url": dn.url,
            "public_url": dn.public_url,
            "data_center": self._dc_of(dn),
            "new_vids": sorted(set(new_vids)),
            "deleted_vids": sorted(set(deleted_vids)),
            "leader": self.leader,
        }
        for q in list(self._clients.values()):
            try:
                q.put_nowait(msg)
            except asyncio.QueueFull:
                pass

    # ---------------- RPC: client push ----------------
    async def _keep_connected(self, request_iterator, context):
        """vid-location push stream (ref master_grpc_server.go:182-235)."""
        if not self.is_leader:
            yield {"leader": self.known_leader}
            return
        first = await request_iterator.__anext__()
        client_name = f"{first.get('name', 'client')}@{id(context)}"
        queue: asyncio.Queue = asyncio.Queue(maxsize=10_000)
        self._clients[client_name] = queue
        try:
            # initial full state
            for dn in self.topo.data_nodes():
                vids = sorted(set(dn.volumes) | set(dn.ec_shards))
                if vids:
                    yield {
                        "url": dn.url,
                        "public_url": dn.public_url,
                        "data_center": self._dc_of(dn),
                        "new_vids": vids,
                        "deleted_vids": [],
                        "leader": self.leader,
                    }
            while not self._shutdown:
                if not self.is_leader:
                    yield {"leader": self.known_leader}  # demoted: hand over
                    return
                try:
                    msg = await asyncio.wait_for(queue.get(), timeout=1.0)
                    yield msg
                except asyncio.TimeoutError:
                    yield {"leader": self.leader}  # keepalive tick
        finally:
            self._clients.pop(client_name, None)

    # ---------------- RPC: unary ----------------
    async def _grpc_assign(self, req, context) -> dict:
        return await self._do_assign(req)

    async def _proxy_to_leader(self, method: str, req) -> Optional[dict]:
        """Forward a unary call to the leader when this master is a
        follower; None means serve locally."""
        if self.is_leader:
            return None
        leader = self.raft.leader_address
        if not leader or leader == self.address:
            return {"error": "no leader elected yet"}
        try:
            return await Stub(grpc_address(leader), "master").call(
                method, dict(req), timeout=5.0
            )
        except Exception as e:
            return {"error": f"proxy to leader {leader} failed: {e}"}

    async def _grpc_lookup_volume(self, req, context) -> dict:
        proxied = await self._proxy_to_leader("LookupVolume", req)
        if proxied is not None:
            return proxied
        results = []
        for vid in req.get("volume_ids", []):
            results.append(self._do_lookup(str(vid), req.get("collection", "")))
        return {"volume_id_locations": results}

    async def _grpc_lookup_ec_volume(self, req, context) -> dict:
        """(ref master_grpc_server_volume.go LookupEcVolume)"""
        proxied = await self._proxy_to_leader("LookupEcVolume", req)
        if proxied is not None:
            return proxied
        vid = int(req["volume_id"])
        locs = self.topo.lookup_ec_shards(vid)
        if locs is None:
            return {"error": f"ec volume {vid} not found"}
        shard_locations = []
        for shard_id, nodes in enumerate(locs.locations):
            if nodes:
                shard_locations.append(
                    {
                        "shard_id": shard_id,
                        "locations": [
                            {"url": dn.url, "public_url": dn.public_url}
                            for dn in nodes
                        ],
                    }
                )
        return {"volume_id": vid, "shard_id_locations": shard_locations}

    async def _grpc_statistics(self, req, context) -> dict:
        proxied = await self._proxy_to_leader("Statistics", req)
        if proxied is not None:
            return proxied
        return {
            "used_size": sum(
                int(v.get("size", 0))
                for dn in self.topo.data_nodes()
                for v in dn.volumes.values()
            ),
        }

    async def _grpc_collection_list(self, req, context) -> dict:
        proxied = await self._proxy_to_leader("CollectionList", req)
        if proxied is not None:
            return proxied
        return {"collections": [{"name": c} for c in self.topo.collections]}

    async def _grpc_collection_delete(self, req, context) -> dict:
        proxied = await self._proxy_to_leader("CollectionDelete", req)
        if proxied is not None:
            return proxied
        await self._delete_collection(req.get("name", ""))
        return {}

    async def _grpc_volume_list(self, req, context) -> dict:
        proxied = await self._proxy_to_leader("VolumeList", req)
        if proxied is not None:
            return proxied
        return {
            "topology_info": self.topo.to_info(),
            "volume_size_limit_mb": self.topo.volume_size_limit // (1024 * 1024),
        }

    async def _grpc_lease_admin_token(self, req, context) -> dict:
        """Cluster-wide exclusive admin lock
        (ref master_grpc_server_admin.go:113-131)."""
        now = time.time()
        prev = int(req.get("previous_token", 0))
        if self._admin_token is not None:
            token, ts = self._admin_token
            if now - ts < self.admin_lease_seconds and token != prev:
                return {"error": "already locked"}
        token = int(now * 1e9) & 0x7FFFFFFFFFFFFFFF
        self._admin_token = (token, now)
        return {"token": token, "lock_ts_ns": int(now * 1e9)}

    async def _grpc_release_admin_token(self, req, context) -> dict:
        if self._admin_token and self._admin_token[0] == int(
            req.get("previous_token", 0)
        ):
            self._admin_token = None
        return {}

    async def _grpc_get_configuration(self, req, context) -> dict:
        return {
            "metrics_address": "",
            "metrics_interval_seconds": 15,
        }

    # ---------------- anti-entropy repair scheduler ----------------
    async def _anti_entropy_loop(self) -> None:
        """Leader-only background repair: scan heartbeat state every few
        pulses, queue findings, dispatch under the concurrency cap."""
        while not self._shutdown:
            try:
                await asyncio.sleep(REPAIR_SCAN_SECONDS)
                if not self.is_leader or self._shutdown:
                    continue
                await self.run_anti_entropy_once()
            except asyncio.CancelledError:
                return
            except Exception:
                continue  # scheduler errors must never kill the master

    async def run_anti_entropy_once(self, max_dispatch: Optional[int] = None) -> dict:
        """One scan+dispatch round: detect (silent nodes, missing EC
        shards, quarantined/diverged replicas), merge findings into the
        prioritized queue (fewest-survivors-first), dispatch up to the
        concurrency cap, full-jitter backoff on failures. Returns a
        status dict; also the engine behind `ec.repair.status -run`."""
        if not self.is_leader:
            return {"error": "not leader"}
        live = {
            dn.url
            for dn in self.topo.live_data_nodes(self.repair_grace_seconds)
        }
        ec_states = self.topo.ec_states(live)
        for st in ec_states:
            # expected_total is heartbeat-history and resets with the
            # master: a shard whose EVERY holder died before this leader's
            # first scan would stay invisible. The .vif geometry (cached
            # per vid once a holder answers) is the source of truth.
            total = await self._ec_expected_total(st)
            if total:
                st["total_shards"] = max(int(st["total_shards"]), total)
        replica_states = self.topo.replica_states(live)
        tasks = plan_ec_repairs(ec_states)
        tasks += plan_replica_repairs(replica_states)
        # placement policy: existing volumes/EC shards are
        # re-checked against the spread the growth solver promises; the
        # proposed moves queue BEHIND data-loss repairs (PLACEMENT_PRIORITY)
        candidates = self.topo.placement_candidates(live)
        spread_violations, spread_tasks = plan_replica_spread(
            self.topo.placement_states(live), candidates
        )
        ec_violations, ec_spread_tasks = plan_ec_domain_spread(
            ec_states, candidates
        )
        PLACEMENT_VIOLATIONS.set(
            len(spread_violations), kind="replica_spread"
        )
        PLACEMENT_VIOLATIONS.set(len(ec_violations), kind="ec_domain")
        self.placement_violations = spread_violations + ec_violations
        if self.placement_violations:
            _LOG.info(
                "anti-entropy: %d placement-policy violation(s), "
                "%d repair move(s) planned",
                len(self.placement_violations),
                len(spread_tasks) + len(ec_spread_tasks),
            )
        tasks += spread_tasks + ec_spread_tasks
        diverged = find_unresolved_divergence(replica_states)
        ANTIENTROPY_DIVERGED.set(len(diverged))
        if diverged:
            _LOG.warning(
                "anti-entropy: volumes %s have healthy replicas that "
                "disagree at EQUAL append frontiers — not auto-repairable "
                "(run volume.fsck / re-replicate)", diverged,
            )
        valid_keys = set()
        for t in tasks:
            valid_keys.add(t.key)
            self.repair_queue.offer(t)
        self.repair_queue.prune(valid_keys)
        now = time.monotonic()
        ready = self.repair_queue.pop_ready(
            now, max_dispatch or self.repair_concurrency
        )
        results: list[dict] = []
        ec_ready = [t for t in ready if t.kind == "ec_rebuild"]
        placement = [
            t for t in ready if t.kind in ("placement_move", "ec_placement")
        ]
        other = [
            t
            for t in ready
            if t.kind not in ("ec_rebuild", "placement_move", "ec_placement")
        ]

        # EC: survivor pulls run CONCURRENTLY per task (the cap is how
        # many we popped), then ONE batched rebuild RPC per rebuilder
        # node (VolumeEcShardsRebuildBatch — same-loss-pattern volumes
        # share wide dispatches of B1 on the rebuilder's card)
        t0s = {t.key: time.perf_counter() for t in ec_ready}
        prep = await asyncio.gather(
            *(self._prepare_ec_rebuild(t, live) for t in ec_ready),
            return_exceptions=True,
        )
        prepared: dict[tuple, list] = {}
        for t, outcome in zip(ec_ready, prep):
            if isinstance(outcome, BaseException):
                REPAIR_SECONDS.observe(
                    time.perf_counter() - t0s[t.key],
                    kind="ec_rebuild", result="error",
                )
                self.repair_queue.reschedule_failure(t, time.monotonic())
                results.append({**t.to_info(), "error": str(outcome)})
            else:
                rebuilder, pulled = outcome
                prepared.setdefault((rebuilder, t.collection), []).append(
                    (t, t0s[t.key], pulled)
                )
        # group rebuilds and replica repairs all dispatch concurrently —
        # one slow rebuild must not stall an unrelated critical repair
        await asyncio.gather(
            *(
                self._dispatch_ec_group(
                    rebuilder, collection, group, results
                )
                for (rebuilder, collection), group in prepared.items()
            ),
            *(self._dispatch_replica_task(t, results) for t in other),
            *(self._dispatch_placement_task(t, results) for t in placement),
        )

        self.repair_log = (self.repair_log + results)[-50:]
        return {
            "dispatched": results,
            "queue_depth": self.repair_queue.depth(),
            "live_nodes": sorted(live),
            "diverged_volumes": diverged,
            "placement_violations": self.placement_violations,
        }

    async def _ec_expected_total(self, st: dict) -> int:
        """Authoritative shard count (k+m) for one EC volume from a
        holder's .vif, cached per vid; 0 when no holder answers."""
        vid = int(st["vid"])
        cache = self._ec_geom_cache
        if vid in cache:
            return cache[vid]
        holders = sorted({u for urls in st["holders"].values() for u in urls})
        for url in holders:
            try:
                r = await Stub(grpc_address(url), "volume").call(
                    "VolumeEcShardsInfo",
                    {"volume_id": vid, "collection": st.get("collection", "")},
                    timeout=10,
                )
            except Exception:
                continue
            if not r.get("error") and r.get("data_shards"):
                total = int(r["data_shards"]) + int(r.get("parity_shards", 0))
                if len(cache) > 65536:  # runaway-vid backstop
                    cache.clear()
                cache[vid] = total
                return total
        return 0

    async def _dispatch_ec_group(
        self, rebuilder: str, collection: str, group: list, results: list
    ) -> None:
        rstub = Stub(grpc_address(rebuilder), "volume")
        vids = [t.vid for t, _t0, _pulled in group]
        try:
            r = await rstub.call(
                "VolumeEcShardsRebuildBatch",
                {"volume_ids": vids, "collection": collection},
                timeout=3600,
            )
        except Exception as e:
            r = {"error": str(e)}
        for t, t0, pulled in group:
            err = r.get("error") or r.get("errors", {}).get(str(t.vid))
            res = r.get("results", {}).get(str(t.vid)) or {}
            rebuilt = res.get("rebuilt_shard_ids", [])
            if not err:
                try:
                    await rstub.call(
                        "VolumeEcShardsMount",
                        {
                            "volume_id": t.vid,
                            "collection": t.collection,
                            "shard_ids": rebuilt,
                        },
                    )
                except Exception as e:
                    err = f"mount rebuilt shards: {e}"
            # the survivors pulled for the rebuild are copies of shards
            # their holders still serve: left on disk unmounted, they
            # would make a later rebuild of those ids find the files,
            # rebuild nothing and never converge after their holder is
            # lost
            if pulled:
                try:
                    await _drop_pulled(rstub, t, pulled)
                except Exception as e:
                    err = err or f"drop pulled survivors: {e}"
            dt = time.perf_counter() - t0
            if err:
                REPAIR_SECONDS.observe(dt, kind="ec_rebuild", result="error")
                self.repair_queue.reschedule_failure(t, time.monotonic())
                results.append({**t.to_info(), "error": err})
            else:
                REPAIR_SECONDS.observe(dt, kind="ec_rebuild", result="ok")
                results.append(
                    {**t.to_info(), "rebuilder": rebuilder, "rebuilt": rebuilt}
                )

    async def _dispatch_replica_task(self, t, results: list) -> None:
        t0 = time.perf_counter()
        method = (
            "VolumeRepairCopy"
            if t.kind == "replica_recopy"
            else "VolumeTailSync"
        )
        try:
            r = await Stub(grpc_address(t.target), "volume").call(
                method,
                {
                    "volume_id": t.vid,
                    "collection": t.collection,
                    "source_data_node": t.source,
                },
                timeout=3600,
            )
            err = r.get("error")
        except Exception as e:
            err = str(e)
        dt = time.perf_counter() - t0
        if err:
            REPAIR_SECONDS.observe(dt, kind=t.kind, result="error")
            self.repair_queue.reschedule_failure(t, time.monotonic())
            results.append({**t.to_info(), "error": err})
        else:
            REPAIR_SECONDS.observe(dt, kind=t.kind, result="ok")
            results.append({**t.to_info(), "repaired": True})

    async def _dispatch_placement_task(self, t, results: list) -> None:
        """Execute one placement-policy move: replica volumes ride the
        volume.move RPC pair (copy to the better-placed node, then drop
        the source copy — full copy count at every intermediate state);
        EC shards ride the ec.balance move sequence (copy+mount on the
        target, unmount+delete on the source)."""
        t0 = time.perf_counter()
        try:
            if t.kind == "placement_move":
                r = await Stub(grpc_address(t.target), "volume").call(
                    "VolumeCopy",
                    {
                        "volume_id": t.vid,
                        "collection": t.collection,
                        "source_data_node": t.source,
                    },
                    timeout=3600,
                )
                err = r.get("error")
                if not err:
                    r2 = await Stub(grpc_address(t.source), "volume").call(
                        "VolumeDelete", {"volume_id": t.vid}, timeout=600
                    )
                    err = r2.get("error")
            else:  # ec_placement: move one shard out of the hot domain
                sid = int(t.missing[0])
                tstub = Stub(grpc_address(t.target), "volume")
                r = await tstub.call(
                    "VolumeEcShardsCopy",
                    {
                        "volume_id": t.vid,
                        "collection": t.collection,
                        "shard_ids": [sid],
                        "copy_ecx_file": True,
                        "source_data_node": t.source,
                    },
                    timeout=3600,
                )
                err = r.get("error")
                if not err:
                    r = await tstub.call(
                        "VolumeEcShardsMount",
                        {
                            "volume_id": t.vid,
                            "collection": t.collection,
                            "shard_ids": [sid],
                        },
                        timeout=600,
                    )
                    err = r.get("error")
                if not err:
                    sstub = Stub(grpc_address(t.source), "volume")
                    await sstub.call(
                        "VolumeEcShardsUnmount",
                        {"volume_id": t.vid, "shard_ids": [sid]},
                        timeout=600,
                    )
                    await sstub.call(
                        "VolumeEcShardsDelete",
                        {
                            "volume_id": t.vid,
                            "collection": t.collection,
                            "shard_ids": [sid],
                        },
                        timeout=600,
                    )
        except Exception as e:
            err = str(e)
        dt = time.perf_counter() - t0
        if err:
            REPAIR_SECONDS.observe(dt, kind=t.kind, result="error")
            self.repair_queue.reschedule_failure(t, time.monotonic())
            results.append({**t.to_info(), "error": err})
        else:
            REPAIR_SECONDS.observe(dt, kind=t.kind, result="ok")
            results.append({**t.to_info(), "repaired": True})

    async def _master_ec_geometry(
        self, vid: int, collection: str, holders: list[str]
    ) -> tuple[int, int]:
        """(data_shards, parity_shards) from a shard holder's .vif;
        standard 10.4 when nobody answers."""
        for url in holders:
            try:
                r = await Stub(grpc_address(url), "volume").call(
                    "VolumeEcShardsInfo",
                    {"volume_id": vid, "collection": collection},
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

    async def _prepare_ec_rebuild(
        self, task, live: set
    ) -> tuple[str, list[int]]:
        """Stage one EC rebuild: verify repairability, choose the live
        rebuilder holding the most shards (fewest pulls), and copy it the
        survivors it lacks. Returns the rebuilder url and the shard ids it
        pulled (dropped again after the rebuild); raises on any blocker
        (the caller reschedules with backoff)."""
        locs = self.topo.lookup_ec_shards(task.vid)
        if locs is None:
            raise LookupError(f"ec volume {task.vid} no longer registered")
        holders: dict[int, list[str]] = {}
        for sid in range(locs.expected_total):
            urls = [dn.url for dn in locs.locations[sid] if dn.url in live]
            if urls:
                holders[sid] = urls
        all_urls = sorted({u for urls in holders.values() for u in urls})
        if not all_urls:
            raise LookupError(f"ec volume {task.vid}: no live holders")
        k, _m = await self._master_ec_geometry(
            task.vid, task.collection, all_urls
        )
        if len(holders) < k:
            raise RuntimeError(
                f"ec volume {task.vid} unrepairable: "
                f"{len(holders)} survivors < {k} data shards"
            )
        by_url: dict[str, set[int]] = {u: set() for u in all_urls}
        for sid, urls in holders.items():
            for u in urls:
                by_url[u].add(sid)
        rebuilder = max(all_urls, key=lambda u: len(by_url[u]))
        rstub = Stub(grpc_address(rebuilder), "volume")
        local = set(by_url[rebuilder])
        pulled: list[int] = []
        for url in all_urls:
            if url == rebuilder:
                continue
            pull = sorted(by_url[url] - local)
            if not pull:
                continue
            try:
                r = await rstub.call(
                    "VolumeEcShardsCopy",
                    {
                        "volume_id": task.vid,
                        "collection": task.collection,
                        "shard_ids": pull,
                        "copy_ecx_file": True,
                        "source_data_node": url,
                    },
                    timeout=3600,
                )
                if r.get("error"):
                    raise IOError(
                        f"pull shards {pull} from {url}: {r['error']}"
                    )
            except BaseException:
                try:
                    await _drop_pulled(rstub, task, pulled + pull)
                except Exception:
                    pass  # the pull's own error is the one to report
                raise
            local.update(pull)
            pulled += pull
        return rebuilder, sorted(pulled)

    async def _grpc_repair_status(self, req, context) -> dict:
        """Repair-plane introspection for `ec.repair.status` (+ `-run` to
        force a scan/dispatch round)."""
        proxied = await self._proxy_to_leader("RepairStatus", req)
        if proxied is not None:
            return proxied
        ran = None
        if req.get("run"):
            ran = await self.run_anti_entropy_once(
                max_dispatch=int(req.get("max_dispatch", 0) or 0) or None
            )
        live = {
            dn.url
            for dn in self.topo.live_data_nodes(self.repair_grace_seconds)
        }
        all_nodes = {dn.url for dn in self.topo.data_nodes()}
        return {
            "auto_repair": self.auto_repair,
            "grace_seconds": self.repair_grace_seconds,
            "queue_depth": self.repair_queue.depth(),
            "queue": self.repair_queue.snapshot(),
            "live_nodes": sorted(live),
            "silent_nodes": sorted(all_nodes - live),
            "recent": self.repair_log[-10:],
            **({"ran": ran} if ran is not None else {}),
        }

    async def _grpc_placement_status(self, req, context) -> dict:
        """Placement-policy introspection (+ `run` to
        force a fresh anti-entropy scan, which re-plans placement)."""
        proxied = await self._proxy_to_leader("PlacementStatus", req)
        if proxied is not None:
            return proxied
        if req.get("run"):
            await self.run_anti_entropy_once(
                max_dispatch=int(req.get("max_dispatch", 0) or 0) or None
            )
        live = {
            dn.url
            for dn in self.topo.live_data_nodes(self.repair_grace_seconds)
        }
        return {
            "violations": self.placement_violations,
            "nodes": self.topo.placement_candidates(live),
            "queued_moves": [
                t
                for t in self.repair_queue.snapshot()
                if t["kind"] in ("placement_move", "ec_placement")
            ],
        }

    # ---------------- vacuum scheduler (ref topology_vacuum.go, rebuilt in
    # the repair scheduler's shape: heartbeat-ranked queue, concurrency
    # cap, full-jitter backoff, opt-in background loop) ----------------
    async def _auto_vacuum_loop(self) -> None:
        """Leader-only background vacuum: rank candidates off heartbeat
        garbage ratios every few pulses, dispatch under the cap."""
        while not self._shutdown:
            try:
                await asyncio.sleep(VACUUM_SCAN_SECONDS)
                if not self.is_leader or self._shutdown:
                    continue
                await self.run_vacuum_once()
            except asyncio.CancelledError:
                return
            except Exception:
                continue  # scheduler errors must never kill the master

    async def run_vacuum_once(
        self,
        garbage_threshold: Optional[float] = None,
        max_dispatch: Optional[int] = None,
        probe_all: bool = False,
    ) -> dict:
        """One scan+dispatch round: candidates from heartbeat-carried
        garbage ratios merge into the highest-garbage-first queue, up to
        the concurrency cap dispatch concurrently (authoritative
        VacuumVolumeCheck -> compact every replica -> commit or cleanup),
        failures back off with full jitter. probe_all enqueues every
        registered volume regardless of heartbeat ratio (forced sweeps:
        the per-replica check still gates the actual compaction)."""
        if not self.is_leader:
            return {"error": "not leader"}
        threshold = (
            self.garbage_threshold
            if garbage_threshold is None
            else garbage_threshold
        )
        if probe_all:
            # forced sweeps enumerate the LAYOUTS (registered at volume
            # allocation), not heartbeat-fed dn.volumes — a volume grown
            # moments ago must still be sweepable
            states = self._layout_vacuum_states()
        else:
            live = {
                dn.url
                for dn in self.topo.live_data_nodes(LIVE_GRACE_SECONDS)
            }
            states = self.topo.replica_states(live)
        tasks = plan_vacuums(states, threshold, include_all=probe_all)
        valid_keys = set()
        for t in tasks:
            valid_keys.add(t.key)
            self.vacuum_queue.offer(t)
        # tasks mid-retry (a forced sweep's failure in backoff) survive
        # scans whose plan wouldn't re-justify them — the promised retry
        # must happen; a success or terminal skip removes them normally
        self.vacuum_queue.prune(valid_keys | self.vacuum_queue.retry_keys())
        ready = self.vacuum_queue.pop_ready(
            time.monotonic(), max_dispatch or self.vacuum_concurrency
        )
        results: list[dict] = []
        await asyncio.gather(
            *(self._dispatch_vacuum_task(t, threshold, results) for t in ready)
        )
        self.vacuum_log = (self.vacuum_log + results)[-50:]
        return {
            "dispatched": results,
            "queue_depth": self.vacuum_queue.depth(),
            "threshold": threshold,
        }

    def _layout_vacuum_states(self) -> dict:
        """Every registered volume from the layout maps, in the
        `plan_vacuums` shape; garbage ratio pinned to 1.0 so include_all
        ordering is stable — the dispatcher's authoritative
        VacuumVolumeCheck supplies the real number. read_only /
        scrub_corrupt are carried over from the heartbeat-fed volume
        infos when known, so forced sweeps honor the planner's
        quarantine gate too (the volume server also refuses to compact a
        quarantined volume — defense in depth)."""
        states: dict = {}
        for collection in list(self.topo.collections.values()):
            for layout in collection.layouts():
                for vid, nodes in list(layout.vid_to_locations.items()):
                    replicas = []
                    for dn in nodes:
                        info = dn.volumes.get(int(vid), {})
                        replicas.append(
                            {
                                "url": dn.url,
                                "collection": collection.name,
                                "garbage_ratio": 1.0,
                                "read_only": bool(info.get("read_only")),
                                "scrub_corrupt": bool(
                                    info.get("scrub_corrupt")
                                ),
                            }
                        )
                    states[int(vid)] = replicas
        return states

    async def _dispatch_vacuum_task(
        self, t, threshold: float, results: list
    ) -> None:
        """check -> compact (all replicas, concurrently) -> commit/cleanup
        for one queued volume (ref topology_vacuum.go per-volume flow).
        An in-flight set spans all three dispatch paths (auto loop,
        /vol/vacuum, -run) so one master never double-dispatches a
        volume; the volume server's own is_compacting gate covers the
        rest (a refused compact/cleanup errors into backoff here)."""
        inflight = self._vacuum_inflight
        if t.vid in inflight:
            results.append(
                {**t.to_info(), "skipped": "already dispatching"}
            )
            return
        inflight.add(t.vid)
        try:
            await self._dispatch_vacuum_task_inner(t, threshold, results)
        finally:
            inflight.discard(t.vid)

    async def _dispatch_vacuum_task_inner(
        self, t, threshold: float, results: list
    ) -> None:
        t0 = time.perf_counter()
        nodes = self.topo.lookup(t.collection, t.vid)
        if not nodes:
            results.append({**t.to_info(), "error": "volume not registered"})
            return  # prune/offer re-discovers it if it reappears
        urls = sorted({dn.url for dn in nodes})

        async def rpc(url: str, method: str, timeout: float = 600):
            r = await Stub(grpc_address(url), "volume").call(
                method, {"volume_id": t.vid}, timeout=timeout
            )
            if r.get("error"):
                raise IOError(f"{method} on {url}: {r['error']}")
            return r

        async def cleanup_all() -> None:
            # idempotent shadow sweep; a server with a compact still in
            # flight refuses (it must not lose its own shadow mid-write)
            await asyncio.gather(
                *(
                    Stub(grpc_address(u), "volume").call(
                        "VacuumVolumeCleanup", {"volume_id": t.vid}
                    )
                    for u in urls
                ),
                return_exceptions=True,
            )

        try:
            checks = await asyncio.gather(
                *(rpc(u, "VacuumVolumeCheck", 30) for u in urls)
            )
            ratio = min(float(c.get("garbage_ratio", 0)) for c in checks)
            if ratio < threshold:
                REPAIR_SECONDS.observe(
                    time.perf_counter() - t0, kind="vacuum", result="skipped"
                )
                results.append(
                    {
                        **t.to_info(),
                        "skipped": f"garbage {ratio:.3f} < {threshold}",
                    }
                )
                # a prior PARTIAL failure may have stranded shadows on the
                # replica that kept its garbage — sweep them on the way out
                await cleanup_all()
                return
            # settle EVERY compact before deciding: gather's first-error
            # fast path would fire cleanup while other replicas are still
            # mid-copy, unlinking their shadows under the writer
            compacts = await asyncio.gather(
                *(rpc(u, "VacuumVolumeCompact") for u in urls),
                return_exceptions=True,
            )
            failed = [e for e in compacts if isinstance(e, BaseException)]
            if failed:
                raise IOError("; ".join(str(e) for e in failed[:3]))
        except Exception as e:
            # compaction is all-or-nothing per volume: sweep the shadows
            # everywhere (now that every compact RPC has settled), back
            # off, retry later
            await cleanup_all()
            REPAIR_SECONDS.observe(
                time.perf_counter() - t0, kind="vacuum", result="error"
            )
            self.vacuum_queue.reschedule_failure(t, time.monotonic())
            results.append({**t.to_info(), "error": str(e)})
            return
        commit = await asyncio.gather(
            *(rpc(u, "VacuumVolumeCommit") for u in urls),
            return_exceptions=True,
        )
        errs = [str(e) for e in commit if isinstance(e, BaseException)]
        dt = time.perf_counter() - t0
        if errs:
            REPAIR_SECONDS.observe(dt, kind="vacuum", result="error")
            self.vacuum_queue.reschedule_failure(t, time.monotonic())
            results.append({**t.to_info(), "error": "; ".join(errs[:3])})
        else:
            REPAIR_SECONDS.observe(dt, kind="vacuum", result="ok")
            results.append(
                {
                    **t.to_info(),
                    "compacted": True,
                    "garbage_ratio": round(ratio, 4),
                    "nodes": urls,
                }
            )

    async def vacuum(self, garbage_threshold: float) -> list[dict]:
        """Forced cluster sweep through the scheduler (the /vol/vacuum
        entry point): every registered volume is enqueued, the
        authoritative per-replica check applies `garbage_threshold`, and
        the queue drains in vacuum_concurrency-sized waves. Tasks a
        failure pushed into backoff are left queued for the background
        loop / a later call. Plan once, pop until empty: re-planning each
        wave would re-offer the tasks the previous wave already popped
        and skipped."""
        if not self.is_leader:
            return []
        states = self._layout_vacuum_states()
        tasks = plan_vacuums(states, garbage_threshold, include_all=True)
        for t in tasks:
            self.vacuum_queue.offer(t)
        dispatched: list[dict] = []
        while True:
            ready = self.vacuum_queue.pop_ready(
                time.monotonic(), self.vacuum_concurrency
            )
            if not ready:
                break
            await asyncio.gather(
                *(
                    self._dispatch_vacuum_task(t, garbage_threshold, dispatched)
                    for t in ready
                )
            )
        self.vacuum_log = (self.vacuum_log + dispatched)[-50:]
        return [
            {
                "volume_id": d["volume_id"],
                "compacted": bool(d.get("compacted")),
            }
            for d in dispatched
            if "skipped" not in d
        ]

    async def _grpc_vacuum_status(self, req, context) -> dict:
        """Vacuum-plane introspection for `volume.vacuum -status` (+ `-run`
        to force a scan/dispatch round)."""
        proxied = await self._proxy_to_leader("VacuumStatus", req)
        if proxied is not None:
            return proxied
        ran = None
        if req.get("run"):
            ran = await self.run_vacuum_once(
                garbage_threshold=(
                    float(req["garbage_threshold"])
                    if req.get("garbage_threshold") is not None
                    else None
                ),
                max_dispatch=int(req.get("max_dispatch", 0) or 0) or None,
                probe_all=bool(req.get("probe_all")),
            )
        return {
            "auto_vacuum": self.auto_vacuum,
            "garbage_threshold": self.garbage_threshold,
            "queue_depth": self.vacuum_queue.depth(),
            "queue": self.vacuum_queue.snapshot(),
            "recent": self.vacuum_log[-10:],
            **({"ran": ran} if ran is not None else {}),
        }

    async def _grpc_raft_request_vote(self, req, context) -> dict:
        return await self.raft.handle_request_vote(req)

    async def _grpc_raft_append_entries(self, req, context) -> dict:
        return await self.raft.handle_append_entries(req)
