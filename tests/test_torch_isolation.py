"""The port stands alone: no module of seaweedfs_tpu_torch, and not
chip_smoke.py, imports jax, jaxlib, msgpack, aiohttp, grpc (grpcio) or
the JAX package seaweedfs_tpu (exact module names: seaweedfs_tpu_torch
itself merely starts with the same letters), and a process that refuses
those imports (and triton, with no nvcc on its PATH) runs an encode, a
rebuild, a degraded read, a Volume.bulk_lookup, an EcVolume.bulk_locate,
one gate flush through the arena of the port, a bucketed sharded lookup
on a mesh of CPU devices, and the port's master
(with topology, sequence and raft) and a volume server heartbeating to
it on the CPU answering an assign, a POST and a GET, with the client and
shell modules imported, and the filer's scale-out modules (the sharded
store, the fleet, the follower, the aggregator and the fleet's load
driver) imported and a sharded store and a fleet map used, building no
kernel. The plain versions of the
server's transport: a unary RPC round trip through pb/rpc.py, and
util/mpack.py against msgpack on the RPC messages."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "seaweedfs_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "msgpack", "seaweedfs_tpu", "aiohttp", "grpc")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _sources() -> list:
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_forbidden_matches_exact_names_only():
    assert _forbidden("jax") and _forbidden("jax.numpy") and _forbidden("jaxlib")
    assert _forbidden("seaweedfs_tpu") and _forbidden("seaweedfs_tpu.ops.gf256")
    assert _forbidden("msgpack") and not _forbidden("msgpack_lite")
    assert not _forbidden("seaweedfs_tpu_torch")
    assert not _forbidden("seaweedfs_tpu_torch.ops.gf256")
    assert not _forbidden("jaxtyping")
    assert _forbidden("aiohttp") and _forbidden("aiohttp.web")
    assert _forbidden("grpc") and _forbidden("grpc.aio")
    assert not _forbidden("grpc_free")


@pytest.mark.parametrize(
    "path", _sources(), ids=lambda p: os.path.relpath(p, REPO)
)
def test_no_forbidden_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # relative: stays inside the port
                continue
            names = [node.module or ""]
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", ""))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            names = [str(node.args[0].value)]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{os.path.relpath(path, REPO)}:{node.lineno} imports {bad}"


_SCRIPT = textwrap.dedent(
    """
    import importlib.abc, os, sys, tempfile

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == f or name.startswith(f + ".")
                   for f in ("jax", "jaxlib", "msgpack", "seaweedfs_tpu",
                             "triton", "aiohttp", "grpc")):
                raise ImportError("refused: " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    import numpy as np
    from seaweedfs_tpu_torch.ops.rs_kernel import CudaRSCodec
    from seaweedfs_tpu_torch.storage import idx
    from seaweedfs_tpu_torch.storage.erasure_coding import (
        EcVolume, rebuild_ec_files, to_ext, write_ec_files,
        write_sorted_file_from_idx)
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.super_block import SuperBlock
    from seaweedfs_tpu_torch.types import to_offset_units

    d = tempfile.mkdtemp(dir=sys.argv[1])
    base = os.path.join(d, "5")
    rng = np.random.default_rng(5)
    want = {}
    with open(base + ".dat", "wb") as dat, open(base + ".idx", "wb") as ix:
        dat.write(SuperBlock().to_bytes())
        # 74 needles: 8 large rows + 5 small, clear of the reference's
        # row-count window (locate.py: locate_data)
        for nid in range(1, 75):
            n = Needle(cookie=nid, id=nid,
                       data=rng.integers(0, 256, int(rng.integers(1, 9000)),
                                         dtype=np.uint8).tobytes())
            blob, _, _ = n.to_bytes(3)
            ix.write(idx.entry_to_bytes(nid, to_offset_units(dat.tell()), n.size))
            dat.write(blob)
            want[nid] = (n.data, n.checksum)
    codec = CudaRSCodec(device="cpu")
    write_ec_files(base, codec=codec, large_block_size=4096,
                   small_block_size=512, chunk=1000)
    write_sorted_file_from_idx(base)
    shards = [open(base + to_ext(i), "rb").read() for i in range(14)]
    for i in (0, 4, 10, 13):
        os.remove(base + to_ext(i))
    with EcVolume(d, "", 5, 4096, 512) as ev:
        for nid, (data, crc) in want.items():
            n = ev.read_needle(nid, codec)
            assert (bytes(n.data), n.checksum) == (data, crc), nid
    assert rebuild_ec_files(base, codec=codec, chunk=700) == [0, 4, 10, 13]
    assert [open(base + to_ext(i), "rb").read() for i in range(14)] == shards

    # the needle-index slice: bulk_locate, a volume's bulk_lookup over
    # both maps, and one gate flush answered by the arena
    import asyncio
    from seaweedfs_tpu_torch.ops import index_kernel, ragged_lookup
    from seaweedfs_tpu_torch.server.lookup_gate import BatchLookupGate
    from seaweedfs_tpu_torch.storage.volume import Volume
    ids = np.asarray(sorted(want) + [999], dtype=np.uint64)
    with EcVolume(d, "", 5, 4096, 512, device="cpu") as ev:
        assert ev.bulk_locate(ids)[2].tolist() == [True] * 74 + [False]
    vols = {}
    for vid, kind in ((6, "memory"), (7, "lsm")):
        v = vols[vid] = Volume(d, "", vid, needle_map_kind=kind, device="cpu")
        for nid in range(1, 300):
            v.write_needle(Needle(cookie=1, id=nid, data=b"x" * (nid % 7)))
        v.delete_needle(Needle(cookie=1, id=3))
        found = v.bulk_lookup(np.arange(1, 400, dtype=np.uint64))[2]
        assert found.sum() == 298 and not found[2], kind
    vols[7].nm.save_snapshot()  # seal the memtable into a run
    class Store:
        def find_volume(self, vid):
            return vols.get(vid)
    arena = ragged_lookup.DeviceColumnArena(device="cpu")
    arena.ensure(vols[7].nm.arena_view([])[1])
    arena.refresh_sync()
    gate = BatchLookupGate(Store(), arena=arena, identity_check=True)
    async def flush():
        return await asyncio.gather(*(gate.lookup(7, k) for k in range(1, 301)))
    res = asyncio.run(flush())
    assert sum(r is not None for r in res) == 298 and res[2] is None
    assert gate.stats["device_probes"] == 300, gate.stats
    assert gate.stats["identity_mismatches"] == 0
    assert index_kernel._LIB is None and ragged_lookup._LIB is None

    # the mesh lookup on a CPU mesh: the bucket table's plain version
    from seaweedfs_tpu_torch.ops import bucket_search
    from seaweedfs_tpu_torch.parallel import make_mesh, sharded_bulk_lookup
    keys = np.arange(1, 8193, dtype=np.uint64) * np.uint64(3)
    cols = np.arange(8192, dtype=np.uint32)
    probes = keys[::7].copy()
    probes[1::2] += np.uint64(1)  # absent: every key is a multiple of 3
    got = sharded_bulk_lookup(keys, cols, cols, probes, make_mesh(devices=["cpu"] * 4))
    assert got[2].tolist() == [i % 2 == 0 for i in range(len(probes))]
    assert got[0][::2].tolist() == cols[::7][::2].tolist()
    assert bucket_search._LIB is None
    arena.close()
    for v in vols.values():
        v.close()

    # the master and a volume server on the CPU: an assign, a POST, a GET
    import json, time
    from seaweedfs_tpu_torch import client, sequence, shell, topology
    from seaweedfs_tpu_torch.server import raft
    from seaweedfs_tpu_torch.server.master import MasterServer
    from seaweedfs_tpu_torch.server.volume import VolumeServer
    mport, port = int(sys.argv[2]), int(sys.argv[3])
    async def http(p, req):
        r, w = await asyncio.open_connection("127.0.0.1", p)
        w.write(req)
        head = await r.readuntil(b"\\r\\n\\r\\n")
        n = int(head.lower().split(b"content-length:")[1].split(b"\\r\\n")[0])
        body = await r.readexactly(n)
        w.close()
        return head.split(b" ")[1], body
    async def serve():
        ms = MasterServer(port=mport)
        await ms.start()
        vs = VolumeServer([os.path.join(d, "srv")], port=port,
                          codec_backend="cpu", batch_lookup="arena",
                          needle_map_kind="lsm", pulse_seconds=0.2,
                          master=ms.address)
        await vs.start()
        try:
            t0 = time.monotonic()
            while not ms.topo.data_nodes():
                assert time.monotonic() - t0 < 10, "no heartbeat"
                await asyncio.sleep(0.05)
            st, body = await http(mport, b"GET /dir/assign HTTP/1.1\\r\\n\\r\\n")
            ar = json.loads(body)
            assert st == b"200" and ar["url"] == vs.address, (st, body)
            fid = ar["fid"].encode()
            st, body = await http(port, b"POST /" + fid + b" HTTP/1.1\\r\\n"
                                  b"Content-Length: 5\\r\\n\\r\\nhello")
            assert st == b"201", (st, body)
            st, body = await http(port, b"GET /" + fid + b" HTTP/1.1\\r\\n\\r\\n")
            assert (st, body) == (b"200", b"hello"), (st, body)
        finally:
            await vs.stop()
            await ms.stop()
    asyncio.run(asyncio.wait_for(serve(), 30))

    # the filer's scale-out: a sharded store, a fleet map, the follower,
    # the aggregator and the fleet's load driver
    from seaweedfs_tpu_torch.filer import Entry, MemoryFilerStore
    from seaweedfs_tpu_torch.filer import fleet, meta_aggregator, meta_follower
    from seaweedfs_tpu_torch.filer import sharded_store
    from seaweedfs_tpu_torch.ops import meta_fleet_driver
    ss = sharded_store.ShardedFilerStore(os.path.join(d, "shards"),
                                         lambda name: MemoryFilerStore(), 4)
    ss.insert_entry(Entry(full_path="/q/x"))
    assert ss.find_entry("/q/x").full_path == "/q/x"
    fmap = os.path.join(d, "FLEETMAP")
    fleet.write_fleet_map(fmap, fleet.FleetMap(["a:1", "b:2"]))
    assert fleet.read_fleet_map(fmap).owner_for_dir("/zz") == "b:2"
    assert meta_follower.MetaFollower and meta_aggregator.MetaAggregator
    assert meta_fleet_driver.drive
    loaded = [m for m in sys.modules
              if any(m == f or m.startswith(f + ".")
                     for f in ("jax", "jaxlib", "msgpack", "seaweedfs_tpu",
                               "triton", "aiohttp", "grpc"))]
    assert not loaded, loaded
    print("ISOLATED-OK")
    """
)


def _free_port() -> int:
    """A port whose RPC port (+10000) is free too, both under the
    ephemeral range (32768-) and clear of the JAX tests' 18200-20800
    (bench and process-cluster bands) and 21000-22000."""
    import random
    import socket

    for _ in range(200):
        p = random.randrange(12000, 18000)
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", p))
            with socket.socket() as s:
                s.bind(("127.0.0.1", p + 10000))
            return p
        except OSError:
            continue
    raise RuntimeError("no free port pair")


def test_port_runs_with_jax_imports_refused(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "CUDA_HOME")}
    env["PYTHONPATH"] = REPO
    env["PATH"] = "/usr/bin:/bin"  # no nvcc
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(tmp_path), str(_free_port()),
         str(_free_port())],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ISOLATED-OK" in proc.stdout


# RPC messages as the volume server's calls carry them
RPC_MESSAGES = [
    {},
    {"error": "volume 7 not found"},
    {"volume_id": 3, "collection": "", "replication": "000", "ttl": "",
     "preallocate": 0},
    {"volume_id": 1, "keys": bytes(range(256)) * 300},
    {"offsets": b"\x01\x00\x00\x00" * 70_000, "offset_dtype": "<u4",
     "sizes": b"", "found": b"\x01"},
    {"rebuilt_shard_ids": [0, 3, 10, 13], "data_shards": 10,
     "parity_shards": 4},
    {"results": [{"file_id": "3,01637037d6", "status": 202, "size": 1024},
                 {"file_id": "x", "status": 500, "error": "wrong fid"}]},
    {"volumes": [{"id": 1, "size": 1 << 33, "read_only": True,
                  "append_at_ns": 1_700_000_000_123_456_789, "ttl": 0,
                  "modified_at_second": -1, "heat": 0.25, "none": None}]},
    {"keys": list(range(-40, 40)) + [1 << 63, -(1 << 63), 255, 65_536],
     "s": "é" * 40, "long": "x" * 70_000, "nested": [[[]], {"a": {}}]},
    {7: "int key", "shard_ids": list(range(20))},
]


@pytest.mark.parametrize("i", range(len(RPC_MESSAGES)))
def test_mpack_equals_msgpack_on_rpc_messages(i):
    import msgpack

    from seaweedfs_tpu_torch.util import mpack

    msg = RPC_MESSAGES[i]
    packed = mpack.packb(msg)
    assert packed == msgpack.packb(msg, use_bin_type=True)
    assert mpack.unpackb(packed) == msgpack.unpackb(
        packed, raw=False, strict_map_key=False) == msg


def test_rpc_round_trip():
    """A unary call through pb/rpc.py: the reply, the {"error": ...}
    convention, a handler that raises (500) and a method the server does
    not have (501)."""
    import asyncio

    from seaweedfs_tpu_torch.pb import grpc_address, http_address
    from seaweedfs_tpu_torch.pb.rpc import RpcError, Service, Stub, serve

    svc = Service("volume")

    @svc.unary("Echo")
    async def echo(req, context):
        return {"got": req, "peer": context.peer}

    @svc.unary("Refuse")
    async def refuse(req, context):
        return {"error": "refused"}

    @svc.unary("Boom")
    async def boom(req, context):
        raise ValueError("boom")

    async def body():
        port = _free_port()
        addr = grpc_address(f"127.0.0.1:{port}")
        assert addr == f"127.0.0.1:{port + 10000}"
        assert http_address(addr) == f"127.0.0.1:{port}"
        server = await serve(addr, svc)
        try:
            stub = Stub(addr, "volume")
            msg = RPC_MESSAGES[3]
            out = [await stub.call("Echo", msg),
                   await stub.call("Refuse", {})]
            for method, status in (("Boom", 500), ("Nope", 501)):
                try:
                    await stub.call(method, {})
                except RpcError as e:
                    out.append((e.status, e.message))
            return out
        finally:
            await server.stop()

    echo_reply, refused, boomed, missing = asyncio.run(
        asyncio.wait_for(body(), 30))
    assert echo_reply == {"got": RPC_MESSAGES[3], "peer": "127.0.0.1"}
    assert refused == {"error": "refused"}
    assert boomed == (500, "ValueError: boom")
    assert missing == (501, "not ported: rpc volume/Nope")
