"""Master server: volume -> location mapping and file-id assignment.

HTTP (data-plane control, ref: weed/server/master_server.go:112-130):
  /dir/assign /dir/lookup /dir/status /vol/grow /col/delete
  /cluster/status /{fileId} redirect
RPC "master" service (pb/rpc.py; ref: weed/server/master_grpc_server*.go):
  SendHeartbeat (bidi; full + delta volume/EC inventories),
  KeepConnected (vid-location push to clients), Assign, Statistics,
  LookupVolume, LookupEcVolume, CollectionList/Delete, VolumeList,
  LeaseAdminToken/ReleaseAdminToken, GetMasterConfiguration and the two
  Raft RPCs.

Multi-master: RaftLite (server/raft.py) elects one leader; followers
proxy Assign/lookups to it, redirect heartbeat + KeepConnected streams,
and freshly assigned volume ids are majority-committed before use
(ref: weed/server/raft_server.go, weed/topology/topology.go:115-122).

Ported from the JAX package's server/master.py. One HTTP server
(util/fasthttp.py through server/serving_core.py) serves every route
where the JAX master runs an aiohttp application behind a fast tier;
the answers (status, JSON bodies, redirects) are the JAX handlers'.
Not ported, each answering an explicit error: the anti-entropy repair,
placement, vacuum, lifecycle and tier-sweep planes (their RPCs
RepairStatus, PlacementStatus, VacuumStatus, LifecycleStatus and
TierOrphanSweep answer the RPC tier's 501 `not ported`, `/vol/vacuum`
an HTTP 501), the maintenance scripts, and the `/ui` page (HTTP 501).
The constructor's `garbage_threshold` and `pulse_seconds` served those
planes only and are not taken.
"""

from __future__ import annotations

import asyncio
import time
from typing import Optional
from urllib.parse import parse_qsl

from ..pb import grpc_address
from ..pb.rpc import Service, Stub, serve
from ..sequence import MemorySequencer
from ..storage.erasure_coding.ec_volume import ShardBits
from ..storage.super_block import ReplicaPlacement
from ..storage.ttl import TTL
from ..topology import GrowOption, Topology, VolumeGrowth
from ..topology.volume_growth import NoFreeSpaceError, grow_count_for_copy_level
from ..util.fasthttp import (
    JSON_FULL,
    fast_tier_json,
    render_http_exception,
    render_response,
)
from .serving_core import ServingCore, json_body, not_ported

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


class MasterServer:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 9333,
        volume_size_limit_mb: int = 30_000,
        default_replication: str = "000",
        jwt_signing_key: str = "",
        jwt_expires_seconds: int = 10,
        peers: Optional[list[str]] = None,
        admin_lease_seconds: float = 10.0,
        sequencer_file: str = "",
        raft_state_file: str = "",
    ):
        self.jwt_signing_key = jwt_signing_key
        self.jwt_expires_seconds = jwt_expires_seconds
        self.admin_lease_seconds = admin_lease_seconds
        self.host = host
        self.port = port
        self.address = f"{host}:{port}"
        self.default_replication = default_replication
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
        svc.unary("RaftRequestVote")(self._grpc_raft_request_vote)
        svc.unary("RaftAppendEntries")(self._grpc_raft_append_entries)
        self._grpc_server = await serve(grpc_address(self.address), svc)
        self.raft.start()

    async def stop(self) -> None:
        self._shutdown = True
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
            return not_ported("/vol/vacuum (the vacuum plane)")
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

    async def _grpc_raft_request_vote(self, req, context) -> dict:
        return await self.raft.handle_request_vote(req)

    async def _grpc_raft_append_entries(self, req, context) -> dict:
        return await self.raft.handle_append_entries(req)
