"""The port's filer server against the JAX package's, on the CPU.

Each package runs a master, a volume server (`-index lsm`, the plain
versions) and a filer over an LSM store and a durable meta-log, all on
one event loop in a thread of this module, started once and stopped in a
`finally`. The JAX filer runs its default host gate; the port's runs its
default gate kind, `device`, over an arena on the CPU (the plain version
of K2). Small chunks (1,000 bytes) make the larger files multi-chunk.
The same HTTP and RPC sequence goes to both: raw PUTs, multipart POSTs,
a chunked file, GETs, HEADs, Range and encoded paths, directory JSON with
paging, the 404 and the 405, ListEntries paging, LookupDirectoryEntry,
CreateEntry with O_EXCL, UpdateEntry, AtomicRenameEntry of a directory
and into itself, DeleteEntry and recursive DELETE, and SubscribeMetadata
from 0. Statuses and bodies are equal once fids and timestamps are
normalised; the port's RPCs go over its own wire (pb/rpc.py), the JAX
filer's handlers are called in-process. Servers listen on free ports in
12000-18000."""

import asyncio
import json
import random
import re
import socket
import threading

import pytest

from seaweedfs_tpu_torch.pb import grpc_address
from seaweedfs_tpu_torch.pb.rpc import RpcError, Stub
from seaweedfs_tpu_torch.util.fasthttp import build_multipart

CHUNK = 1000
BOUND_S = 60


def _free_port() -> int:
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


async def _http(port, method, path, body=b"", headers=None):
    r, w = await asyncio.open_connection("127.0.0.1", port)
    try:
        h = {"Host": f"127.0.0.1:{port}", "Content-Length": str(len(body))}
        h.update(headers or {})
        w.write(f"{method} {path} HTTP/1.1\r\n".encode()
                + "".join(f"{k}: {v}\r\n" for k, v in h.items()).encode()
                + b"\r\n" + body)
        await w.drain()
        head = await r.readuntil(b"\r\n\r\n")
        lines = head.decode("latin1").split("\r\n")
        hd = {}
        for ln in lines[1:]:
            if ":" in ln:
                k, v = ln.split(":", 1)
                hd[k.strip().lower()] = v.strip()
        n = int(hd.get("content-length", 0))
        status = int(lines[0].split()[1])
        data = b"" if method == "HEAD" or status == 204 else await r.readexactly(n)
        return status, hd, data
    finally:
        w.close()


class _Cluster:
    def __init__(self, pkg, ms, vs, fs):
        self.pkg, self.ms, self.vs, self.fs = pkg, ms, vs, fs

    async def rpc(self, method, req):
        if self.pkg == "port":
            return await Stub(grpc_address(self.fs.address), "filer").call(method, req)
        fn = {
            "LookupDirectoryEntry": self.fs._grpc_lookup_entry,
            "ListEntries": self.fs._grpc_list_entries,
            "CreateEntry": self.fs._grpc_create_entry,
            "UpdateEntry": self.fs._grpc_update_entry,
            "DeleteEntry": self.fs._grpc_delete_entry,
            "AtomicRenameEntry": self.fs._grpc_rename,
            "GetFilerConfiguration": self.fs._grpc_configuration,
            "Statistics": self.fs._grpc_statistics,
        }[method]
        return await fn(req, None)

    async def subscribe(self, until_ts):
        out = []
        if self.pkg == "port":
            it = Stub(grpc_address(self.fs.address), "filer").server_stream(
                "SubscribeMetadata", {"since_ns": 0})
        else:
            it = self.fs._grpc_subscribe_metadata({"since_ns": 0}, None)
        async for ev in it:
            out.append(ev)
            if ev["ts_ns"] >= until_ts:
                break
        if self.pkg != "port":
            await it.aclose()
        return out


async def _start(pkg, tmp, arena):
    if pkg == "port":
        from seaweedfs_tpu_torch.server.filer import FilerServer
        from seaweedfs_tpu_torch.server.master import MasterServer
        from seaweedfs_tpu_torch.server.volume import VolumeServer

        ms = MasterServer(port=_free_port())
        vs = VolumeServer([str(tmp / "v")], master=ms.address, port=_free_port(),
                          pulse_seconds=0.2, codec_backend="cpu", needle_map_kind="lsm",
                          batch_lookup="arena")
        fs_kw = {"meta_gate": "device", "arena": arena}
    else:
        from seaweedfs_tpu.server.filer import FilerServer
        from seaweedfs_tpu.server.master import MasterServer
        from seaweedfs_tpu.server.volume import VolumeServer

        ms = MasterServer(port=_free_port(), pulse_seconds=0.2)
        vs = VolumeServer(master=ms.address, directories=[str(tmp / "v")], port=_free_port(),
                          pulse_seconds=0.2, codec_backend="cpu", needle_map_kind="lsm")
        fs_kw = {}
    await ms.start()
    await vs.start()
    fs = FilerServer(ms.address, port=_free_port(), store_path=str(tmp / "f.lsm"),
                     meta_log_path=str(tmp / "mlog"), chunk_size=CHUNK, **fs_kw)
    await fs.start()
    for _ in range(200):
        if ms.topo.data_nodes():
            break
        await asyncio.sleep(0.05)
    return _Cluster(pkg, ms, vs, fs)


@pytest.fixture(scope="module")
def clusters(tmp_path_factory, monkeypatch_module):
    from seaweedfs_tpu_torch.ops.ragged_lookup import DeviceColumnArena

    monkeypatch_module.setenv("SEAWEEDFS_TPU_META_GATE", "1")  # the JAX default
    loop = asyncio.new_event_loop()
    th = threading.Thread(target=loop.run_forever, daemon=True)
    th.start()

    def run(coro):
        return asyncio.run_coroutine_threadsafe(
            asyncio.wait_for(coro, BOUND_S), loop).result()

    arena = DeviceColumnArena(device="cpu")
    started = []
    try:
        for pkg in ("jax", "port"):
            started.append(run(_start(pkg, tmp_path_factory.mktemp(pkg), arena)))
        yield run, {c.pkg: c for c in started}
    finally:
        async def stop_all():
            for c in started:
                await c.fs.stop()
                await c.vs.stop()
                await c.ms.stop()
            from seaweedfs_tpu.pb.rpc import close_all_channels

            await close_all_channels()

        run(stop_all())
        arena.close()
        loop.call_soon_threadsafe(loop.stop)
        th.join(10)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


_FID = re.compile(r"\d+,[0-9a-f]+(_\d+)?")


def _norm(obj, fids):
    """Fids replaced by their order of appearance, times by 0."""
    if isinstance(obj, dict):
        return {k: (0 if k in ("mtime", "crtime", "Mtime", "ts_ns", "mtime_ns", "last_ts_ns")
                    else _norm(v, fids)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_norm(v, fids) for v in obj]
    if isinstance(obj, str) and _FID.fullmatch(obj):
        return fids.setdefault(obj, f"fid{len(fids)}")
    return obj


def _body(st, data):
    try:
        return st, json.loads(data)
    except ValueError:
        return st, data


async def _http_sequence(c):
    port = c.fs.port
    fids: dict = {}
    out = []

    async def req(method, path, body=b"", headers=None, keep=("content-type",)):
        st, hd, data = await _http(port, method, path, body, headers)
        st, b = _body(st, data)
        out.append((method, path, st, _norm(b, fids),
                    {k: hd.get(k) for k in keep}))
        return st, b

    small = bytes(range(256)) * 2
    big = bytes((i * 7) % 251 for i in range(3 * CHUNK + 123))
    await req("PUT", "/s/a.txt", small, {"Content-Type": "text/plain"})
    await req("PUT", "/s/b.bin", big)
    await req("PUT", "/s/sub/deep/c.bin", b"c" * 10)
    body, ct = build_multipart("file", b"multipart body", "m.txt", "text/markdown")
    await req("POST", "/s/", body, {"Content-Type": ct})
    await req("POST", "/s/named.txt", body, {"Content-Type": ct})
    await req("POST", "/s/q.bin?ttl=", b"with a query")
    await req("PUT", "/s/a.txt", small[::-1], {"Content-Type": "text/plain"})  # overwrite
    for p in ("/s/a.txt", "/s/b.bin", "/s/m.txt", "/s/named.txt", "/s/q.bin",
              "/s/sub/deep/c.bin", "/s/%61.txt", "/s/a.txt?x=1", "/nope", "/s/nope"):
        await req("GET", p)
    for p in ("/s/a.txt", "/s/b.bin", "/nope"):
        await req("HEAD", p, keep=("content-length",))
    await req("GET", "/s/b.bin", headers={"Range": "bytes=900-2100"})
    await req("GET", "/s")
    await req("GET", "/s/")
    await req("GET", "/s?limit=2")
    await req("GET", "/s?limit=2&lastFileName=b.bin")
    await req("GET", "/")
    await req("PATCH", "/s/a.txt")
    await req("PUT", "/s", b"onto a directory")
    await req("DELETE", "/s/sub")
    await req("DELETE", "/s/sub?recursive=true")
    await req("GET", "/s/sub/deep/c.bin")
    await req("DELETE", "/s/never-there")
    return out


async def _rpc_sequence(c):
    fids: dict = {}
    out = []

    async def call(method, r):
        try:
            got = await c.rpc(method, r)
        except RpcError as e:
            got = {"rpc_error": e.status}
        out.append((method, _norm(got, fids)))
        return got

    await call("LookupDirectoryEntry", {"directory": "/s", "name": "a.txt"})
    await call("LookupDirectoryEntry", {"directory": "/s", "name": "zz"})
    for start, incl in (("", True), ("b.bin", True), ("b.bin", False)):
        await call("ListEntries", {"directory": "/s", "start_from_file_name": start,
                                   "inclusive_start_from": incl, "limit": 2})
    entry = {"full_path": "/r/x/one", "attr": {"mtime": 5.0, "mime": "a/b", "mode": 0o640},
             "chunks": [], "extended": {"k": "v"}}
    await call("CreateEntry", {"entry": entry})
    await call("CreateEntry", {"entry": entry, "o_excl": True})
    await call("CreateEntry", {"entry": dict(entry, full_path="/r/x/two"), "o_excl": True})
    await call("UpdateEntry", {"entry": dict(entry, extended={"k": "w"})})
    await call("LookupDirectoryEntry", {"directory": "/r/x", "name": "one"})
    await call("AtomicRenameEntry", {"old_directory": "/r", "old_name": "x",
                                     "new_directory": "/r", "new_name": "y"})
    await call("AtomicRenameEntry", {"old_directory": "/r", "old_name": "y",
                                     "new_directory": "/r/y", "new_name": "z"})
    await call("AtomicRenameEntry", {"old_directory": "/r", "old_name": "gone",
                                     "new_directory": "/r", "new_name": "z"})
    await call("ListEntries", {"directory": "/r/y"})
    await call("DeleteEntry", {"directory": "/r", "name": "y"})
    await call("DeleteEntry", {"directory": "/r", "name": "y", "is_recursive": True})
    await call("LookupDirectoryEntry", {"directory": "/r/y", "name": "one"})
    await call("Statistics", {})
    cfg = await c.rpc("GetFilerConfiguration", {})
    out.append(("GetFilerConfiguration", _norm(
        {k: v for k, v in cfg.items() if k != "masters"}, fids)))
    events = await c.subscribe(cfg["last_ts_ns"])
    out.append(("SubscribeMetadata", _norm(events, {})))
    return out


def test_filer_http_sequence_equals_jax(clusters):
    run, cs = clusters
    jax_out = run(_http_sequence(cs["jax"]))
    port_out = run(_http_sequence(cs["port"]))
    for j, p in zip(jax_out, port_out, strict=True):
        assert p == j
    gate = cs["port"].fs.meta_gate
    assert gate.stats["device_batches"] > 0 and gate.stats["identity_mismatches"] == 0


def test_filer_rpc_sequence_equals_jax(clusters):
    run, cs = clusters
    jax_out = run(_rpc_sequence(cs["jax"]))
    port_out = run(_rpc_sequence(cs["port"]))
    for j, p in zip(jax_out, port_out, strict=True):
        assert p == j


def test_filer_rpcs_left_out_answer_501(clusters):
    run, cs = clusters

    async def go():
        stub = Stub(grpc_address(cs["port"].fs.address), "filer")
        codes = []
        for m in ("GeoStatus", "GeoResync"):
            try:
                await stub.call(m, {})
                codes.append(200)
            except RpcError as e:
                codes.append(e.status)
        return codes

    assert run(go()) == [501] * 2
