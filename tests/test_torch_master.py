"""The port's master (server/master.py with topology/, sequence.py,
server/raft.py) and the multi-volume encode against the JAX package's.

- ShardBits and the sequencers give the same answers on seeded inputs;
  FileSequencer survives a restart.
- One seeded sequence of full and delta heartbeats fed to a JAX master's
  SendHeartbeat handler and to the port's leaves equal topologies after
  every step: VolumeList's topology, /dir/lookup answers, EC shard
  locations, writable layouts and max_volume_id; a stream's end
  unregisters its node in both.
- A JAX cluster and a port cluster (a master and two volume servers
  each, the same volumes, writes and EC spread) answer /dir/lookup,
  LookupEcVolume, /dir/status, VolumeList and /dir/assign alike, with
  locations mapped by server index.
- Three port masters with -peers elect one leader through RaftLite.
- write_ec_files_multi writes .ec00-.ec13 and .ecx byte-identical to the
  JAX package's, through both of its routes.

Tolerance: exact. Every cluster runs under asyncio.wait_for and stops in
a `finally`; every wait has a deadline."""

import asyncio
import os
import random
import shutil
import socket
import time

import numpy as np
import pytest

from seaweedfs_tpu.sequence import FileSequencer as JaxFileSequencer
from seaweedfs_tpu.sequence import MemorySequencer as JaxMemorySequencer
from seaweedfs_tpu.server.master import MasterServer as JaxMaster
from seaweedfs_tpu.storage.erasure_coding.ec_volume import ShardBits as JaxShardBits
from seaweedfs_tpu_torch.sequence import FileSequencer, MemorySequencer
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.storage.erasure_coding.ec_volume import ShardBits

BOUND_S = 30


def _port_pair() -> int:
    """A port whose +10000 is free too, clear of the JAX tests' ranges
    (18200-20800, 21000-22000 and the ephemeral 32768-)."""
    rng = random.Random()
    for _ in range(200):
        p = rng.randrange(12000, 18000)
        try:
            with socket.socket() as s1, socket.socket() as s2:
                s1.bind(("127.0.0.1", p))
                s2.bind(("127.0.0.1", p + 10000))
            return p
        except OSError:
            continue
    raise RuntimeError("no free port pair")


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, BOUND_S))


async def _until(cond, deadline_s: float = 10.0, step: float = 0.05):
    t0 = time.monotonic()
    while True:
        got = await cond()
        if got:
            return got
        assert time.monotonic() - t0 < deadline_s, "condition not met in time"
        await asyncio.sleep(step)


@pytest.mark.parametrize("seed", [0, 1])
def test_shard_bits_equal_jax(seed):
    rng = random.Random(seed)
    for _ in range(200):
        a, b = rng.getrandbits(33), rng.getrandbits(32)
        mine, ref = ShardBits(a), JaxShardBits(a)
        assert mine.bits == ref.bits
        assert mine.shard_ids() == ref.shard_ids()
        assert mine.count() == ref.count()
        assert [mine.has(i) for i in range(32)] == [ref.has(i) for i in range(32)]
        i = rng.randrange(32)
        assert mine.add(i).bits == ref.add(i).bits
        assert mine.remove(i).bits == ref.remove(i).bits
        assert mine.plus(ShardBits(b)).bits == ref.plus(JaxShardBits(b)).bits
        assert mine.minus(ShardBits(b)).bits == ref.minus(JaxShardBits(b)).bits
        k = rng.choice([6, 10, 12])
        assert mine.minus_parity_shards(k).bits == ref.minus_parity_shards(k).bits
        assert repr(mine) == repr(ref)


def test_sequencers_equal_jax(tmp_path):
    rng = random.Random(3)
    mine, ref = MemorySequencer(), JaxMemorySequencer()
    for _ in range(100):
        if rng.random() < 0.3:
            v = rng.randrange(1 << 40)
            mine.set_max(v)
            ref.set_max(v)
        else:
            n = rng.randrange(1, 1000)
            assert mine.next_file_id(n) == ref.next_file_id(n)
        assert mine.peek() == ref.peek()
    # the same lease file, written by one and read by the other
    f1, f2 = FileSequencer(str(tmp_path / "a")), JaxFileSequencer(str(tmp_path / "b"))
    for n in (5, 3, 20_000, 1):
        assert f1.next_file_id(n) == f2.next_file_id(n)
    assert (tmp_path / "a").read_text() == (tmp_path / "b").read_text()
    assert FileSequencer(str(tmp_path / "b")).peek() == \
        JaxFileSequencer(str(tmp_path / "a")).peek()


def test_file_sequencer_survives_restart(tmp_path):
    """Mirror of test_lease_heartbeat::test_file_sequencer_survives_restart:
    a restarted master never re-issues a file id."""
    path = str(tmp_path / "seq.dat")
    s1 = FileSequencer(path)
    first = s1.next_file_id(5)
    second = s1.next_file_id(3)
    assert second == first + 5
    s2 = FileSequencer(path)
    assert s2.next_file_id(1) > second + 2
    s2.set_max(10_000_000)
    s3 = FileSequencer(path)
    assert s3.next_file_id(1) > 10_000_000


# ------------------------------------------------------------- heartbeats --
def _volume_info(rng, vid: int) -> dict:
    return {
        "id": vid,
        "size": rng.randrange(0, 3 << 20),
        "collection": rng.choice(["", "", "pics"]),
        "file_count": rng.randrange(100),
        "delete_count": 0,
        "deleted_byte_count": 0,
        "read_only": rng.random() < 0.2,
        "replica_placement": rng.choice([0, 0, 1]),
        "version": 3,
        "ttl": 0,
        "compact_revision": 0,
        "modified_at_second": 0,
    }


def _heartbeats(seed: int, nodes: int = 3, steps: int = 40):
    """[(node index, heartbeat)]: a full heartbeat per node, then seeded
    deltas: new and deleted volumes, new and deleted EC shards, a full
    resend with changed fields, max_file_key."""
    rng = random.Random(seed)
    held = [dict() for _ in range(nodes)]  # vid -> info
    ec = [dict() for _ in range(nodes)]  # vid -> bits
    next_vid = [1]
    out = []

    def new_vid():
        next_vid[0] += 1
        return next_vid[0]

    for n in range(nodes):
        for _ in range(rng.randrange(1, 4)):
            v = new_vid()
            held[n][v] = _volume_info(rng, v)
        ecv = 100 + n
        ec[n][ecv] = rng.getrandbits(14) | 1
        out.append((n, {
            "ip": "10.0.0.%d" % (n + 1), "port": 8080, "public_url": "",
            "max_volume_count": 7, "max_file_key": rng.randrange(1 << 20),
            "data_center": "", "rack": "",
            "volumes": list(held[n].values()), "has_no_volumes": not held[n],
            "ec_shards": [{"id": v, "collection": "", "ec_index_bits": b}
                          for v, b in ec[n].items()],
            "has_no_ec_shards": not ec[n],
        }))
    for _ in range(steps):
        n = rng.randrange(nodes)
        hb = {"ip": "10.0.0.%d" % (n + 1), "port": 8080}
        kind = rng.random()
        if kind < 0.25:
            v = new_vid() if rng.random() < 0.7 or not held[(n + 1) % nodes] \
                else rng.choice(list(held[(n + 1) % nodes]))  # a replica
            info = _volume_info(rng, v)
            held[n][v] = info
            hb["new_volumes"] = [info]
        elif kind < 0.4 and held[n]:
            v = rng.choice(list(held[n]))
            hb["deleted_volumes"] = [held[n].pop(v)]
        elif kind < 0.55:
            v = rng.choice([100, 101, 102, 200])
            bits = rng.getrandbits(14) or 1
            ec[n][v] = ec[n].get(v, 0) | bits
            hb["new_ec_shards"] = [{"id": v, "collection": "", "ec_index_bits": bits}]
        elif kind < 0.7 and ec[n]:
            v = rng.choice(list(ec[n]))
            bits = ec[n][v] & rng.getrandbits(14)
            ec[n][v] &= ~bits
            if not ec[n][v]:
                del ec[n][v]
            hb["deleted_ec_shards"] = [{"id": v, "collection": "", "ec_index_bits": bits}]
        elif kind < 0.85:
            for info in held[n].values():
                if rng.random() < 0.5:
                    info["read_only"] = not info["read_only"]
                    info["size"] = rng.randrange(0, 3 << 20)
            hb["volumes"] = [dict(i) for i in held[n].values()]
            hb["has_no_volumes"] = not held[n]
        else:
            hb["max_file_key"] = rng.randrange(1 << 24)
            hb["ec_shards"] = [{"id": v, "collection": "", "ec_index_bits": b}
                               for v, b in ec[n].items()]
            hb["has_no_ec_shards"] = not ec[n]
        out.append((n, hb))
    return out


def _topology_view(ms, vids) -> dict:
    topo = ms.topo
    layouts = {}
    for name, coll in topo.collections.items():
        for layout in coll.layouts():
            key = (name, str(layout.replica_placement), str(layout.ttl))
            layouts[key] = (sorted(layout.writables), sorted(layout.readonly),
                            sorted(layout.oversized))
    ec = {}
    for v in vids:
        locs = topo.lookup_ec_shards(v)
        ec[v] = None if locs is None else [[dn.url for dn in l] for l in locs.locations]
    return {
        "info": topo.to_info(),
        "lookup": {v: ms._do_lookup(str(v)) for v in vids},
        "ec": ec,
        "layouts": layouts,
        "max_volume_id": topo.max_volume_id,
        "sequence": topo.sequence.peek(),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topology_equal_jax_under_heartbeats(seed):
    async def body():
        masters = [JaxMaster(volume_size_limit_mb=2), MasterServer(volume_size_limit_mb=2)]
        hbs = _heartbeats(seed)
        vids = sorted({int(i["id"]) for _n, hb in hbs
                       for k in ("volumes", "new_volumes", "deleted_volumes", "ec_shards",
                                 "new_ec_shards", "deleted_ec_shards")
                       for i in hb.get(k) or []})
        streams = []  # per master: node -> (queue, handler)
        for ms in masters:
            per = {}
            for n in range(3):
                q: asyncio.Queue = asyncio.Queue()

                async def requests(q=q):
                    while True:
                        hb = await q.get()
                        if hb is None:
                            return
                        yield hb

                per[n] = (q, ms._send_heartbeat(requests(), None))
            streams.append(per)
        views = []
        for n, hb in hbs:
            for per in streams:
                q, handler = per[n]
                q.put_nowait(dict(hb))
                reply = await handler.__anext__()
                assert set(reply) >= {"volume_size_limit", "leader"}
            views.append([_topology_view(ms, vids) for ms in masters])
        # node 1's stream ends: the master unregisters it
        for per in streams:
            q, handler = per[1]
            q.put_nowait(None)
            with pytest.raises(StopAsyncIteration):
                await handler.__anext__()
        views.append([_topology_view(ms, vids) for ms in masters])
        for per in streams:
            for n in (0, 2):
                await per[n][1].aclose()
        return views

    views = _run(body())
    for step, (jax_view, port_view) in enumerate(views):
        assert port_view == jax_view, f"step {step}"
    urls = {dn["url"] for dc in views[-1][1]["info"]["data_centers"]
            for r in dc["racks"] for dn in r["data_nodes"]}
    assert urls == {"10.0.0.1:8080", "10.0.0.3:8080"}


# -------------------------------------------------------------- clusters --
class _Pair:
    """A master and two volume servers of one package over the same
    directories' contents: volume 1 on server 0, volume 2 on server 1."""

    def __init__(self, kind: str, root, seed_dirs):
        self.kind = kind
        self.root = root
        self.seed_dirs = seed_dirs

    async def start(self):
        if self.kind == "jax":
            from seaweedfs_tpu.server.master import MasterServer as M
            from seaweedfs_tpu.server.volume import VolumeServer as V

            extra = {"pulse_seconds": 0.2}
        else:
            M = MasterServer
            from seaweedfs_tpu_torch.server.volume import VolumeServer as V

            extra = {}
        self.master = M(port=_port_pair(), volume_size_limit_mb=64, **extra)
        await self.master.start()
        self.vs = []
        for i, src in enumerate(self.seed_dirs):
            d = self.root / f"{self.kind}{i}"
            shutil.copytree(src, d)
            vs = V(master=self.master.address, directories=[str(d)],
                   port=_port_pair(), pulse_seconds=0.2, codec_backend="cpu",
                   max_volume_counts=[4])
            await vs.start()
            self.vs.append(vs)

        async def registered():
            return len(self.master.topo.data_nodes()) == len(self.vs)

        await _until(registered)

    def index(self, url: str) -> int:
        return [v.address for v in self.vs].index(url)

    async def stop(self):
        for vs in self.vs:
            await vs.stop()
        await self.master.stop()
        if self.kind == "jax":
            from seaweedfs_tpu.pb.rpc import close_all_channels

            await close_all_channels()


def _seed_volumes(root) -> list:
    """Two directories: volume 1 (40 needles) in the first, volume 2 (20)
    in the second, written by the port's Volume; -> (dirs, needles)."""
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.volume import Volume

    rng = random.Random(11)
    dirs, needles = [], {}
    for i, (vid, count) in enumerate(((1, 40), (2, 20))):
        d = root / f"seed{i}"
        d.mkdir()
        v = Volume(str(d), "", vid)
        for k in range(1, count + 1):
            data = rng.randbytes(rng.randrange(1, 30_000))
            v.write_needle(Needle(cookie=0x77, id=k, data=data))
            needles[(vid, k)] = data
        v.close()
        dirs.append(d)
    return dirs, needles


def _http_get(hostport: str, target: str):
    import http.client

    host, _, port = hostport.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=10)
    try:
        conn.request("GET", target)
        resp = conn.getresponse()
        return resp.status, resp.read(), resp.getheader("Location")
    finally:
        conn.close()


def _http_view(hostport: str, method: str, target: str, body=None, headers=None):
    """(status, Content-Type, body) of one request."""
    import http.client

    host, _, port = hostport.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=10)
    try:
        conn.request(method, target, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


# requests whose Content-Type (and, but for a 200, body) both masters
# answer alike: the JAX master's fast tier and its aiohttp application
_TYPED_REQUESTS = (
    ("GET", "/dir/assign", None, {}),
    ("POST", "/dir/assign", b"count=2",
     {"Content-Type": "application/x-www-form-urlencoded"}),
    ("GET", "/dir/assign?count=2", None, {}),
    ("GET", "/dir/assign?foo=1", None, {}),
    ("GET", "/dir/lookup?volumeId=2", None, {}),
    ("GET", "/dir/lookup?volumeId=9", None, {}),
    ("GET", "/dir/lookup?volumeId=%32", None, {}),
    ("GET", "/dir/status", None, {}),
    ("POST", "/dir/status", None, {}),
    ("GET", "/vol/grow?replication=9x", None, {}),
    ("GET", "/cluster/status", None, {}),
    ("GET", "/col/delete?collection=x", None, {}),
    ("GET", "/nosuch", None, {}),
    ("HEAD", "/nosuch", None, {}),
    ("GET", "/2", None, {}),
    ("GET", "/2,500000077", None, {}),
    ("GET", "/9,500000077", None, {}),
)


def test_master_answers_equal_jax(tmp_path):
    import json

    dirs, _needles = _seed_volumes(tmp_path)

    async def body():
        out = {}
        for kind in ("jax", "port"):
            pair = _Pair(kind, tmp_path, dirs)
            await pair.start()
            try:
                if kind == "jax":
                    from seaweedfs_tpu.pb import grpc_address as ga
                    from seaweedfs_tpu.pb.rpc import Stub as S
                else:
                    from seaweedfs_tpu_torch.pb import grpc_address as ga
                    from seaweedfs_tpu_torch.pb.rpc import Stub as S
                maddr = pair.master.address
                # volume 1 to EC: generate on server 0, shards 0-6 stay,
                # 7-13 go to server 1
                src = S(ga(pair.vs[0].address), "volume")
                dst = S(ga(pair.vs[1].address), "volume")
                assert (await src.call("VolumeMarkReadonly", {"volume_id": 1})) == {}
                assert not (await src.call("VolumeEcShardsGenerate", {"volume_id": 1}))
                assert not (await dst.call("VolumeEcShardsCopy", {
                    "volume_id": 1, "shard_ids": list(range(7, 14)),
                    "copy_ecx_file": True, "source_data_node": pair.vs[0].address}))
                assert not (await dst.call("VolumeEcShardsMount", {
                    "volume_id": 1, "shard_ids": list(range(7, 14))}))
                assert not (await src.call("VolumeEcShardsMount", {
                    "volume_id": 1, "shard_ids": list(range(7))}))
                await src.call("VolumeDelete", {"volume_id": 1, "keep_ec_files": True})
                await src.call("VolumeEcShardsDelete", {
                    "volume_id": 1, "shard_ids": list(range(7, 14))})
                mstub = S(ga(maddr), "master")

                async def ec_known():
                    r = await mstub.call("LookupEcVolume", {"volume_id": 1})
                    return (not r.get("error") and len(r["shard_id_locations"]) == 14
                            and not pair.master.topo.lookup("", 1))

                await _until(ec_known)
                ec = await mstub.call("LookupEcVolume", {"volume_id": 1})
                ec_map = {e["shard_id"]: sorted(pair.index(l["url"]) for l in e["locations"])
                          for e in ec["shard_id_locations"]}
                lookups = {}
                for vid in ("1", "2", "9", "x"):
                    st, raw, _ = await asyncio.to_thread(
                        _http_get, maddr, f"/dir/lookup?volumeId={vid}")
                    r = json.loads(raw)
                    r["locations"] = sorted(pair.index(l["url"]) for l in r.get("locations", []))
                    lookups[vid] = (st, r)
                rpc_lookup = await mstub.call("LookupVolume", {"volume_ids": ["2", "7"]})
                for r in rpc_lookup["volume_id_locations"]:
                    r["locations"] = [pair.index(l["url"]) for l in r.get("locations", [])]
                st, raw, _ = await asyncio.to_thread(_http_get, maddr, "/dir/status")
                status = json.loads(raw)
                vl = await mstub.call("VolumeList", {})
                st_a, raw_a, _ = await asyncio.to_thread(_http_get, maddr, "/dir/assign")
                assigned = json.loads(raw_a)
                vid = int(assigned["fid"].split(",")[0])
                writable = sorted(
                    v for c in pair.master.topo.collections.values()
                    for layout in c.layouts() for v in layout.writables)
                st_r, _, location = await asyncio.to_thread(
                    _http_get, maddr, "/2," + "%x" % 5 + "00000077")
                typed = []
                for method, target, data, headers in _TYPED_REQUESTS:
                    st, ctype, raw = await asyncio.to_thread(
                        _http_view, maddr, method, target, data, headers)
                    typed.append((method, target, st, ctype, raw if st != 200 else None))

                def shape(info):
                    """Keys and volume sets of a topology, nodes by index."""
                    nodes = {}
                    for dc in info["data_centers"]:
                        for rack in dc["racks"]:
                            for dn in rack["data_nodes"]:
                                nodes[pair.index(dn["url"])] = (
                                    sorted(dn), sorted(int(v["id"]) for v in dn["volumes"]),
                                    sorted((m["id"], m["ec_index_bits"])
                                           for m in dn["ec_shards"]))
                    return sorted(info), nodes

                out[kind] = {
                    "ec": ec_map,
                    "lookups": lookups,
                    "rpc_lookup": rpc_lookup,
                    "status": (st, sorted(status), shape(status["Topology"])),
                    "volume_list": (sorted(vl), shape(vl["topology_info"]),
                                    vl["volume_size_limit_mb"]),
                    "assign": (st_a, sorted(assigned), vid in writable,
                               pair.index(assigned["url"]) >= 0),
                    "redirect": (st_r, location.replace(pair.vs[1].address, "vs1")),
                    "typed": typed,
                }
            finally:
                await pair.stop()
        return out

    out = asyncio.run(asyncio.wait_for(body(), 60))
    assert out["port"] == out["jax"]
    assert out["port"]["assign"] == (200, ["count", "fid", "publicUrl", "url"], True, True)
    assert out["port"]["ec"] == {i: [0 if i < 7 else 1] for i in range(14)}
    typed = {(m, t): (st, ct, raw) for m, t, st, ct, raw in out["port"]["typed"]}
    assert typed[("GET", "/nosuch")] == (404, "text/plain; charset=utf-8", b"404: Not Found")
    assert typed[("GET", "/2,500000077")] == (
        301, "text/plain; charset=utf-8", b"301: Moved Permanently")


def test_raft_elects_one_leader_among_three_masters():
    """Three port masters with -peers: one leader within the deadline; a
    follower redirects /dir/lookup to it and proxies Assign to it."""
    from seaweedfs_tpu_torch.pb import grpc_address
    from seaweedfs_tpu_torch.pb.rpc import Stub

    async def body():
        ports = [_port_pair() for _ in range(3)]
        peers = [f"127.0.0.1:{p}" for p in ports]
        masters = [MasterServer(port=p, peers=peers) for p in ports]
        for ms in masters:
            await ms.start()
        try:
            async def one_leader():
                leaders = [ms for ms in masters if ms.is_leader]
                known = {ms.raft.leader_address for ms in masters}
                return leaders[0] if len(leaders) == 1 and len(known) == 1 else None

            leader = await _until(one_leader, 10.0)
            follower = next(ms for ms in masters if ms is not leader)
            st, _, location = await asyncio.to_thread(
                _http_get, follower.address, "/dir/lookup?volumeId=3")
            reply = await Stub(grpc_address(follower.address), "master").call(
                "Assign", {})
            return st, location, leader.address, reply
        finally:
            for ms in masters:
                await ms.stop()

    st, location, leader, reply = _run(body())
    assert st == 307 and location == f"http://{leader}/dir/lookup?volumeId=3"
    # the leader has no volume servers: the proxied assign answers its error
    assert reply == {"error": "no free volumes left"}


# ---------------------------------------------------------- multi encode --
LARGE, SMALL = 8192, 1024


def _mk_dat(path: str, size: int) -> None:
    data = np.random.default_rng(size + 7).integers(0, 256, size, dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(data.tobytes())


@pytest.mark.parametrize("route", ["host", "device"])
def test_write_ec_files_multi_equals_jax(tmp_path, route):
    """Mirror of test_multi_encode::test_multi_matches_per_volume_oracle:
    the port's write_ec_files_multi (the host codec's per-volume route, or
    the device codec's shared batches on the plain version) and the JAX
    package's, on the same seeded .dat files, write byte-identical
    .ec00-.ec13; the .ecx of two written volumes is byte-identical too."""
    from seaweedfs_tpu.storage.erasure_coding import write_ec_files_multi as jax_multi
    from seaweedfs_tpu.storage.erasure_coding import write_sorted_file_from_idx as jax_ecx
    from seaweedfs_tpu.storage.erasure_coding.coder_cpu import CpuRSCodec as JaxCpu
    from seaweedfs_tpu_torch.ops.rs_kernel import CudaRSCodec
    from seaweedfs_tpu_torch.storage.erasure_coding import (
        write_ec_files_multi,
        write_sorted_file_from_idx,
    )
    from seaweedfs_tpu_torch.storage.erasure_coding.coder_cpu import CpuRSCodec

    sizes = [LARGE * 10 * 2 + SMALL * 10 * 2 + 333, SMALL * 10 * 5, SMALL * 3 + 17,
             0, LARGE * 10 + 1]
    bases = {"port": [], "jax": []}
    for j, size in enumerate(sizes):
        for kind in bases:
            d = tmp_path / f"{kind}{j}"
            d.mkdir()
            _mk_dat(str(d / "1.dat"), size)
            bases[kind].append(str(d / "1"))
    # two real volumes with an .idx for the .ecx
    dirs, _ = _seed_volumes(tmp_path)
    for kind in bases:
        for i, d in enumerate(dirs):
            vid = i + 1
            dst = tmp_path / f"{kind}v{vid}"
            dst.mkdir()
            for ext in (".dat", ".idx"):
                shutil.copy(d / f"{vid}{ext}", dst / f"{vid}{ext}")
            bases[kind].append(str(dst / str(vid)))
    codec = CpuRSCodec() if route == "host" else CudaRSCodec(device="cpu")
    assert getattr(codec, "is_device", False) == (route == "device")
    write_ec_files_multi(bases["port"], codec=codec,
                         large_block_size=LARGE, small_block_size=SMALL)
    jax_multi(bases["jax"], codec=JaxCpu(),
              large_block_size=LARGE, small_block_size=SMALL)
    for b in bases["port"][-2:]:
        write_sorted_file_from_idx(b)
    for b in bases["jax"][-2:]:
        jax_ecx(b)
    for mine, ref in zip(bases["port"], bases["jax"]):
        exts = [f".ec{i:02d}" for i in range(14)]
        if os.path.exists(ref + ".ecx"):
            exts.append(".ecx")
        for ext in exts:
            with open(mine + ext, "rb") as f1, open(ref + ext, "rb") as f2:
                assert f1.read() == f2.read(), (mine, ext)


def test_mesh_encode_equals_jax(tmp_path):
    """write_ec_files_multi(mesh=...) over a port mesh of 4 repeated CPU
    devices and the JAX package's over 4 of its virtual CPU devices, on
    the same seeded .dat files (large and small rows, a ragged tail), write
    byte-identical .ec00-.ec13, and both equal the port's encode without a
    mesh."""
    import jax
    import torch

    from seaweedfs_tpu.ops.rs_kernel import TpuRSCodec
    from seaweedfs_tpu.parallel.sharded_ec import make_mesh as jax_make_mesh
    from seaweedfs_tpu.storage.erasure_coding import write_ec_files_multi as jax_multi
    from seaweedfs_tpu_torch.ops.rs_kernel import CudaRSCodec
    from seaweedfs_tpu_torch.parallel import make_mesh
    from seaweedfs_tpu_torch.storage.erasure_coding import write_ec_files_multi

    bases = {"mesh": [], "plain": [], "jax": []}
    for j, size in enumerate((LARGE * 10 + 12_345, SMALL * 3 + 7)):
        for kind in bases:
            d = tmp_path / f"{kind}{j}"
            d.mkdir()
            _mk_dat(str(d / "1.dat"), size)
            bases[kind].append(str(d / "1"))
    codec = CudaRSCodec(device="cpu")
    mesh = make_mesh(devices=[torch.device("cpu")] * 4)
    write_ec_files_multi(bases["mesh"], codec=codec, large_block_size=LARGE,
                         small_block_size=SMALL, mesh=mesh)
    write_ec_files_multi(bases["plain"], codec=codec, large_block_size=LARGE,
                         small_block_size=SMALL)
    jax_multi(bases["jax"], codec=TpuRSCodec(), large_block_size=LARGE,
              small_block_size=SMALL,
              mesh=jax_make_mesh(devices=jax.devices("cpu")[:4]))
    for mine, plain, ref in zip(bases["mesh"], bases["plain"], bases["jax"]):
        for i in range(14):
            ext = f".ec{i:02d}"
            with open(mine + ext, "rb") as f1, open(ref + ext, "rb") as f2, \
                    open(plain + ext, "rb") as f3:
                got = f1.read()
                assert got == f2.read(), (mine, i)
                assert got == f3.read(), (mine, i)
