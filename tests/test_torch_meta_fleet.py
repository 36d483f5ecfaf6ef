"""The port's metadata fleet, follower and peer aggregator against the
JAX package's, on the CPU.

Units: `dir_of`, `ancestor_dirs`, `in_range` and `default_bounds` on
seeded paths; FLEETMAP files written by one package and read by the
other; the `meta.fleet.status` text for the same FleetStatus answers.

The fleet: each package runs, on one event loop in a thread of this
module, a master, two filers of a fleet (FLEETMAP bounds ["/m"], LSM
stores and durable meta-logs), a follower of member 0 and two plain
filers with `-peers` of each other. The port's filers run their meta
gate in its default kind, `device`, each over an arena on the CPU (K2's
plain version), the identity check on; the JAX filers run their default
host gate. The same script goes to both: creates through both members
(the non-owner forwards), a range move of [/g, /m) from member 0 to
member 1 under concurrent creates, then every path and directory read
back through both members, forwarded updates, deletes and renames, the
307 of a GET at the non-owner, FleetStatus, the follower's answers
(its reads, the read-your-writes redirect, `read_only_follower`) and
the aggregated stream of the peers. Every answer is equal once
addresses, times and the move's timing-dependent counts are normalised.
Servers listen on free ports in 12000-18000."""

import asyncio
import json
import os
import random
import socket
import threading

import numpy as np
import pytest

from seaweedfs_tpu_torch.filer import fleet as port_fleet
from seaweedfs_tpu_torch.filer import sharded_store as port_sharded
from seaweedfs_tpu.filer import fleet as jax_fleet
from seaweedfs_tpu.filer import sharded_store as jax_sharded

BOUND_S = 60


class _Ports:
    """Free ports in 12000-18000 whose RPC port (+10000) is free too, each
    held bound until its server is about to bind it: other test files pick
    from the same band, and a port left free between the pick and the bind
    could be taken."""

    def __init__(self):
        self._rng = random.Random()
        self._held: dict = {}

    def take(self) -> int:
        for _ in range(200):
            p = self._rng.randrange(12000, 18000)
            socks = [socket.socket(), socket.socket()]
            try:
                socks[0].bind(("127.0.0.1", p))
                socks[1].bind(("127.0.0.1", p + 10000))
            except OSError:
                for s in socks:
                    s.close()
                continue
            self._held[p] = socks
            return p
        raise RuntimeError("no free port pair")

    def release(self, port: int) -> int:
        for s in self._held.pop(port, ()):
            s.close()
        return port

    def release_all(self) -> None:
        for p in list(self._held):
            self.release(p)


def _seeded_paths(seed: int, n: int = 300) -> list:
    rng = np.random.default_rng(seed)
    alphabet = "abgmz09/"
    out = ["/", "/a", "/a/", "//x", "/m", "/m/n/o/p"]
    for _ in range(n):
        depth = int(rng.integers(1, 5))
        parts = ["".join(rng.choice(list(alphabet[:-1]), int(rng.integers(1, 4))))
                 for _ in range(depth)]
        out.append("/" + "/".join(parts) + ("/" if rng.random() < 0.1 else ""))
    return out


# ---------------- units ----------------


@pytest.mark.parametrize("seed", [0, 1])
def test_routing_helpers_equal_jax(seed):
    paths = _seeded_paths(seed)
    for p in paths:
        assert port_fleet.dir_of(p) == jax_fleet.dir_of(p), p
        assert port_fleet.ancestor_dirs(p) == jax_fleet.ancestor_dirs(p), p
    bounds = ["", "/a", "/g", "/m", "/m/n", "/z"]
    for d in [port_fleet.dir_of(p) for p in paths]:
        for lo in bounds:
            for hi in bounds:
                assert port_fleet.in_range(d, lo, hi) == jax_fleet.in_range(d, lo, hi)
    for n in range(0, 40):
        assert port_sharded.default_bounds(n) == jax_sharded.default_bounds(n)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_fleet_map_files_cross_read(tmp_path, writer):
    mods = {"port": port_fleet, "jax": jax_fleet}
    w, r = mods[writer], mods["jax" if writer == "port" else "port"]
    maps = [
        w.FleetMap(["127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3"]),
        w.FleetMap(["a:1", "b:2"], ["/m"], epoch=7,
                   pending_move={"src": "a:1", "dst": "b:2", "lo": "/g", "hi": "/m"}),
        w.FleetMap(["a:1", "b:2"], ["/g"], epoch=8,
                   pending_cleanup={"src": "a:1", "lo": "/g", "hi": "/m"}),
    ]
    for i, fmap in enumerate(maps):
        path = str(tmp_path / f"FLEETMAP{i}")
        w.write_fleet_map(path, fmap)
        got = r.read_fleet_map(path)
        assert got.to_dict() == fmap.to_dict()
        # rewritten by the reader's package: the same bytes
        again = str(tmp_path / f"again{i}")
        r.write_fleet_map(again, got)
        with open(path, "rb") as a, open(again, "rb") as b:
            assert a.read() == b.read()
        for d in ("/", "/a", "/g/x", "/m", "/zz"):
            assert got.owner_for_dir(d) == fmap.owner_for_dir(d)
    with pytest.raises(ValueError):
        r.FleetMap(["a:1", "b:2"], ["/a", "/b"])


_STATUS_ANSWERS = [
    {"configured": False, "address": "127.0.0.1:8888", "write_rounds": 12,
     "write_gate": {"writes": 40, "batches": 3, "coalesced": 2, "largest_batch": 30,
                    "item_retries": 0}},
    {"configured": True, "address": "a:1", "write_rounds": 3,
     "fleet": {"self": "a:1", "epoch": 4, "members": 3,
               "map": {"version": 1, "epoch": 4, "addresses": ["a:1", "b:2", "c:3"],
                       "bounds": ["/g", "/t"],
                       "pending_move": {"src": "a:1", "dst": "b:2", "lo": "/d", "hi": "/g"},
                       "pending_cleanup": {"src": "a:1", "lo": "/x", "hi": "/y"}},
               "range": ["", "/g"], "fence": None, "inflight_mutations": 0,
               "counters": {"forwarded": 5, "ingested": 6, "moves_committed": 1,
                            "moves_failed": 0, "fence_waits": 2}}},
    {"configured": False, "address": "f:9", "write_rounds": 0,
     "follower": {"source": "a:1", "connected": False, "cursor_ns": 17,
                  "staleness_bound_s": 1.25, "applied": 9, "redirects": 1,
                  "resync_required": True, "trimmed_through": 99}},
]


@pytest.mark.parametrize("answer", range(len(_STATUS_ANSWERS)))
def test_meta_fleet_status_text_equal_jax(monkeypatch, answer):
    import seaweedfs_tpu.pb.rpc as jax_rpc
    from seaweedfs_tpu.shell import commands as jax_cmds
    from seaweedfs_tpu_torch.shell import commands as port_cmds

    reply = _STATUS_ANSWERS[answer]

    class _Stub:
        def __init__(self, address, service, **kw):
            pass

        async def call(self, method, req, timeout=None):
            assert method == "FleetStatus"
            return reply

    monkeypatch.setattr(jax_rpc, "Stub", _Stub)
    monkeypatch.setattr(port_cmds, "Stub", _Stub)

    class _Env:
        filer = ""

    argv = ["-filer", "a:1"]
    want = asyncio.run(jax_cmds.cmd_meta_fleet_status(_Env(), argv))
    got = asyncio.run(port_cmds.run_command(_Env(), "meta.fleet.status -filer a:1"))
    assert got == want
    assert asyncio.run(port_cmds.run_command(_Env(), "meta.fleet.status")) == \
        asyncio.run(jax_cmds.cmd_meta_fleet_status(_Env(), []))


# ---------------- the fleet, the follower and the peers ----------------


class _Side:
    """One package's fleet: servers by role, and the names its addresses
    normalise to."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.servers = {}
        self.ms = None
        self.names = {}

    def addr(self, role):
        return self.servers[role].address

    async def call(self, role, method, req, timeout=30):
        if self.pkg == "port":
            from seaweedfs_tpu_torch.pb import grpc_address
            from seaweedfs_tpu_torch.pb.rpc import Stub
        else:
            from seaweedfs_tpu.pb import grpc_address
            from seaweedfs_tpu.pb.rpc import Stub
        return await Stub(grpc_address(self.addr(role)), "filer").call(
            method, req, timeout=timeout)


async def _start(pkg, tmp, arenas, held, started):
    if pkg == "port":
        from seaweedfs_tpu_torch.server.filer import FilerServer
        from seaweedfs_tpu_torch.server.master import MasterServer

        ms = MasterServer(port=held.release(held.take()))
    else:
        from seaweedfs_tpu.server.filer import FilerServer
        from seaweedfs_tpu.server.master import MasterServer

        ms = MasterServer(port=held.release(held.take()), pulse_seconds=0.2)
    await ms.start()
    side = _Side(pkg)
    side.ms = ms
    started.append(side)  # stopped by the fixture even if a later start fails
    ports = {r: held.take() for r in ("m0", "m1", "fol", "p0", "p1")}
    side.names = {f"127.0.0.1:{p}": r for r, p in ports.items()}
    fmap = os.path.join(str(tmp), "FLEETMAP")
    mod = port_fleet if pkg == "port" else jax_fleet
    mod.write_fleet_map(fmap, mod.FleetMap(
        [f"127.0.0.1:{ports['m0']}", f"127.0.0.1:{ports['m1']}"], ["/m"]))

    def kw(role):
        if pkg != "port":
            return {}
        from seaweedfs_tpu_torch.ops.ragged_lookup import DeviceColumnArena

        arenas[(pkg, role)] = DeviceColumnArena(device="cpu")
        return {"meta_gate": "device", "arena": arenas[(pkg, role)]}

    specs = {
        "m0": {"fleet_map_path": fmap},
        "m1": {"fleet_map_path": fmap},
        "fol": {"follow_source": f"127.0.0.1:{ports['m0']}"},
        "p0": {"peers": (f"127.0.0.1:{ports['p1']}",)},
        "p1": {"peers": (f"127.0.0.1:{ports['p0']}",)},
    }
    for role, extra in specs.items():
        fs = FilerServer(ms.address, port=ports[role],
                         store_path=str(tmp / f"{role}.lsm"),
                         meta_log_path=str(tmp / f"{role}-mlog"), **extra, **kw(role))
        held.release(ports[role])
        await fs.start()
        side.servers[role] = fs
    return side


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("SEAWEEDFS_TPU_META_GATE", "1")  # the JAX default
    loop = asyncio.new_event_loop()
    th = threading.Thread(target=loop.run_forever, daemon=True)
    th.start()

    def run(coro):
        return asyncio.run_coroutine_threadsafe(
            asyncio.wait_for(coro, BOUND_S), loop).result()

    arenas = {}
    started = []
    held = _Ports()
    try:
        for pkg in ("jax", "port"):
            run(_start(pkg, tmp_path_factory.mktemp(pkg), arenas, held, started))
        yield run, {s.pkg: s for s in started}
    finally:
        held.release_all()
        async def stop_all():
            # together: each JAX filer's RPC server stops with a grace
            await asyncio.gather(*(fs.stop() for s in started
                                   for fs in s.servers.values()))
            for s in started:
                await s.ms.stop()
            from seaweedfs_tpu.pb.rpc import close_all_channels

            await close_all_channels()

        run(stop_all())
        for a in arenas.values():
            a.close()
        loop.call_soon_threadsafe(loop.stop)
        th.join(10)
        mp.undo()


def _norm(obj, names):
    """Addresses replaced by their roles, times and cursors by 0."""
    if isinstance(obj, dict):
        return {k: (0 if k in ("mtime", "crtime", "ts_ns", "cursor_ns", "last_ts_ns",
                               "min_ts_ns", "head_ts_ns", "staleness_bound_s", "wall_s")
                    else _norm(v, names)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_norm(v, names) for v in obj]
    if isinstance(obj, str):
        for a, r in names.items():
            obj = obj.replace(a, r)
    return obj


def _entry(p, tag=None):
    return {"full_path": p, "attr": {"mtime": 1.0, "crtime": 1.0},
            "extended": {"etag": tag or p[-9:]}}


async def _fleet_script(side):
    side.scripted = True
    out = []

    async def call(role, method, req, keep=None):
        got = await side.call(role, method, req)
        if keep is not None:
            got = {k: got.get(k) for k in keep}
        out.append((role, method, _norm(got, side.names)))
        return got

    members = ("m0", "m1")
    # creates through both members: the owner serves, the other forwards
    paths = [f"/g/d{i % 4}/f{i:04d}" for i in range(64)] + \
            [f"/p/d{i % 2}/f{i:04d}" for i in range(64, 96)]
    for i, p in enumerate(paths):
        await call(members[i % 2], "CreateEntry", {"entry": _entry(p)})
    # the move of [/g, /m) from member 0 to member 1, under creates
    # through both members
    during = [f"/g/d{i % 4}/late{i:04d}" for i in range(48)]

    async def creates():
        got = []
        for i, p in enumerate(during):
            got.append(await side.call(members[i % 2], "CreateEntry",
                                       {"entry": _entry(p)}))
        return got

    moving = asyncio.ensure_future(creates())
    await asyncio.sleep(0.01)
    mv = await side.call("m0", "FleetMoveRange",
                         {"dst": side.addr("m1"), "lo": "/g", "hi": "/m"}, timeout=60)
    got = await moving
    out.append(("m0", "FleetMoveRange", {"error": mv.get("error"), "epoch": mv.get("epoch"),
                                         "copied_at_least": mv.get("copied", 0) >= 64}))
    out.append(("both", "CreateEntry during the move", _norm(got, side.names)))
    bad = await call("m1", "FleetMoveRange", {"dst": side.addr("m0"), "lo": "/a", "hi": "/b"})
    assert bad.get("error")
    # every path and directory through both members
    for p in paths + during + ["/g/d0/absent", "/q/absent"]:
        d, name = p.rsplit("/", 1)
        for m in members:
            await call(m, "LookupDirectoryEntry", {"directory": d, "name": name})
    for d in ("/", "/g", "/g/d0", "/g/d3", "/p", "/p/d1"):
        for m in members:
            await call(m, "ListEntries", {"directory": d, "limit": 1000})
    # the source's own store, past the map: the moved range is gone (its
    # cleanup's tombstones over the older runs answer, never the moved rows)
    for p in paths[:8] + during[:8]:
        d, name = p.rsplit("/", 1)
        got = await call("m0", "LookupDirectoryEntry", {"directory": d, "name": name,
                                                        "fleet_local": True})
        assert got == {"error": "not found"}, (side.pkg, p, got)
    # mutations after the move, through the member that no longer owns
    await call("m0", "UpdateEntry", {"entry": _entry("/g/d1/f0001", "updated")})
    await call("m0", "DeleteEntry", {"directory": "/g/d2", "name": "f0002"})
    await call("m1", "AtomicRenameEntry", {"old_directory": "/g/d3", "old_name": "f0003",
                                           "new_directory": "/g/d3", "new_name": "r0003"})
    await call("m1", "AtomicRenameEntry", {"old_directory": "/p/d1", "old_name": "f0065",
                                           "new_directory": "/g/d0", "new_name": "moved"})
    await call("m0", "AtomicRenameEntry", {"old_directory": "/", "old_name": "g",
                                           "new_directory": "/", "new_name": "a"})
    await call("m1", "DeleteEntry", {"directory": "/p", "name": "d0", "is_recursive": True})
    for p in ("/g/d1/f0001", "/g/d2/f0002", "/g/d3/r0003", "/g/d0/moved",
              "/p/d1/f0065", "/p/d0/f0064"):
        d, name = p.rsplit("/", 1)
        for m in members:
            await call(m, "LookupDirectoryEntry", {"directory": d, "name": name})
    for m in members:
        await call(m, "ListEntries", {"directory": "/p", "limit": 1000})
        st = await side.call(m, "FleetStatus", {})
        out.append((m, "FleetStatus", _norm({
            "configured": st["configured"], "map": st["map"], "range": st["fleet"]["range"],
            "moves_committed": st["fleet"]["counters"]["moves_committed"],
            "moves_failed": st["fleet"]["counters"]["moves_failed"]}, side.names)))
    # the HTTP tier at a member that does not own the path: 307 to the owner
    port = side.servers["m0"].port
    r, w = await asyncio.open_connection("127.0.0.1", port)
    w.write(f"GET /g/d0/f0000 HTTP/1.1\r\nHost: x\r\nContent-Length: 0\r\n\r\n".encode())
    await w.drain()
    head = (await r.readuntil(b"\r\n\r\n")).decode("latin1").split("\r\n")
    w.close()
    loc = [h.split(":", 1)[1].strip() for h in head if h.lower().startswith("location:")]
    out.append(("m0", "GET", head[0], _norm(loc, side.names)))
    return out, paths + during


def test_fleet_move_under_creates_equals_jax(sides):
    run, ss = sides
    jax_out, written = run(_fleet_script(ss["jax"]))
    port_out, _ = run(_fleet_script(ss["port"]))
    for j, p in zip(jax_out, port_out, strict=True):
        assert p == j
    # 0 lost: every written path answered with its etag by both members
    found = {(o[0], o[2]["entry"]["full_path"]) for o in port_out
             if o[1] == "LookupDirectoryEntry" and "entry" in o[2]}
    for p in written:
        assert ("m0", p) in found and ("m1", p) in found, p
    for role in ("m0", "m1"):
        fs = ss["port"].servers[role]
        g = fs.meta_gate.stats
        assert g["device_batches"] > 0 and g["identity_mismatches"] == 0, (role, g)
        assert not fs.meta_gate.fallback_reasons.get("no_arena_view"), role
        assert not fs.device_errors, (role, fs.device_errors)


async def _follower_script(side):
    out = []
    fol = side.servers["fol"]._follower
    head = (await side.call("m0", "GetFilerConfiguration", {}))["last_ts_ns"]
    for _ in range(400):
        if fol.cursor_ns >= head:
            break
        await asyncio.sleep(0.02)
    assert fol.cursor_ns >= head
    for d, name in (("/g/d0", "f0000"), ("/p/d1", "f0065"), ("/p/d1", "f0067"),
                    ("/g/d0", "nope")):
        out.append(await side.call("fol", "LookupDirectoryEntry",
                                   {"directory": d, "name": name}))
    out.append(await side.call("fol", "ListEntries", {"directory": "/p/d1", "limit": 1000}))
    out.append(await side.call("fol", "LookupDirectoryEntry",
                               {"directory": "/p/d1", "name": "f0067", "min_ts_ns": 2 ** 62}))
    out.append(await side.call("fol", "CreateEntry", {"entry": _entry("/p/d1/new")}))
    out.append(await side.call("fol", "DeleteEntry", {"directory": "/p/d1", "name": "f0067"}))
    st = await side.call("fol", "FleetStatus", {})
    out.append({k: st["follower"][k] for k in ("source", "connected", "redirects",
                                               "resync_required")})
    return [_norm(o, side.names) for o in out]


def test_follower_serves_the_primary_equals_jax(sides):
    run, ss = sides
    run(_fleet_script_once(sides))
    jax_out = run(_follower_script(ss["jax"]))
    port_out = run(_follower_script(ss["port"]))
    assert port_out == jax_out
    assert port_out[0]["entry"]["full_path"] == "/g/d0/f0000"
    assert port_out[5]["error"] == "redirect"
    assert port_out[6] == {"error": "read_only_follower", "primary": "m0"}
    g = ss["port"].servers["fol"].meta_gate.stats
    assert g["device_batches"] > 0 and g["identity_mismatches"] == 0


async def _fleet_script_once(sides):
    """The follower test reads what the fleet script wrote: run it once
    for each package if the fleet test has not."""
    _run, ss = sides
    for s in ss.values():
        if not getattr(s, "scripted", False):
            s.scripted = True
            await _fleet_script(s)


async def _peers_script(side):
    await side.call("p0", "CreateEntry", {"entry": _entry("/peer/d/one")})
    await side.call("p1", "CreateEntry", {"entry": _entry("/peer/d/two")})
    out = []
    for role, other in (("p1", "p0"), ("p0", "p1")):
        for _ in range(400):
            r = await side.call(role, "ListEntries", {"directory": "/peer/d"})
            if len(r["entries"]) == 2:
                break
            await asyncio.sleep(0.02)
        out.append(r)
        out.append(await side.call(role, "LookupDirectoryEntry",
                                   {"directory": "/peer/d", "name": "one"}))
    seen = {}
    for role in ("p0", "p1"):
        agg = side.servers[role].meta_aggregator.log
        for _ in range(400):
            seen[role] = sorted((ev.event_type, (ev.new_entry or {}).get("full_path"))
                                for ev in agg.read_since(0))
            if len(seen[role]) >= 2:
                break
            await asyncio.sleep(0.02)
    out.append(seen)
    return [_norm(o, side.names) for o in out]


def test_peers_aggregate_and_replay_equals_jax(sides):
    run, ss = sides
    jax_out = run(_peers_script(ss["jax"]))
    port_out = run(_peers_script(ss["port"]))
    assert port_out == jax_out
    assert [e["full_path"] for e in port_out[0]["entries"]] == ["/peer/d/one", "/peer/d/two"]
    assert ("create", "/peer/d/one") in port_out[-1]["p1"]


def test_port_filer_cli_takes_the_scale_out_flags(tmp_path, monkeypatch):
    """`filer` with -shards, -fleetMap/-fleetSelf, -followSource and
    -peers through the CLI's entry function on threads of this test."""
    from seaweedfs_tpu_torch.command import cli
    from seaweedfs_tpu_torch.pb import grpc_address
    from seaweedfs_tpu_torch.pb.rpc import Stub

    monkeypatch.setenv("SEAWEEDFS_TPU_META_GATE", "1")
    reserved = _Ports()
    ports = [reserved.take() for _ in range(3)]
    addrs = [f"127.0.0.1:{p}" for p in ports]
    fmap = str(tmp_path / "FLEETMAP")
    port_fleet.write_fleet_map(fmap, port_fleet.FleetMap([addrs[0]], []))
    argvs = [
        ["-port", str(ports[0]), "-master", "127.0.0.1:1", "-store",
         str(tmp_path / "s.lsm"), "-shards", "3", "-fleetMap", fmap,
         "-fleetSelf", addrs[0], "-peers", addrs[2]],
        ["-port", str(ports[1]), "-master", "127.0.0.1:1", "-followSource", addrs[0]],
        ["-port", str(ports[2]), "-master", "127.0.0.1:1", "-peers", addrs[0]],
    ]
    held = []
    try:
        for argv, port in zip(argvs, ports):
            reserved.release(port)
            h = {"ready": threading.Event()}

            def started(loop, stop, servers, h=h):
                h.update(loop=loop, stop=stop, servers=servers)
                h["ready"].set()

            h["thread"] = threading.Thread(
                target=lambda a=argv, s=started, h=h: h.update(
                    rc=cli.cmd_filer(a, started=s)), daemon=True)
            h["thread"].start()
            held.append(h)
        for h in held:
            assert h["ready"].wait(30)

        async def go():
            st = [await Stub(grpc_address(a), "filer").call("FleetStatus", {})
                  for a in addrs]
            r = await Stub(grpc_address(addrs[0]), "filer").call(
                "CreateEntry", {"entry": _entry("/x/y")})
            return st, r

        st, r = asyncio.run(go())
        assert st[0]["configured"] and st[0]["fleet"]["members"] == 1
        assert st[1]["follower"]["source"] == addrs[0]
        assert not st[2]["configured"]
        assert "ts_ns" in r
        fs0 = held[0]["servers"][0]
        assert fs0.filer.store.describe()["shards"] == 3
        assert fs0.meta_aggregator.peers == [addrs[2]]
    finally:
        reserved.release_all()
        for h in held:
            if "loop" in h:
                h["loop"].call_soon_threadsafe(h["stop"].set)
            h["thread"].join(15)
    assert [h.get("rc") for h in held] == [0, 0, 0]
