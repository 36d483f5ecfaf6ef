"""The port's volume tier under the filer against the JAX package's, on
the plain versions (device="cpu", codec_backend="cpu"): `/!batch/put`
frames, plain and tenant-tagged, give equal JSON replies and equal
needles read back; the BatchRead stream gives equal answers for live,
deleted and absent keys; a chunked `submit_file` reads back with equal
bytes and Content-Range and its delete removes the chunks, as does the
cleanup of a failed upload; `GroupCommitWorker` (ported from the JAX
tests/test_group_commit.py) writes concurrent needles to equal offsets
and rolls a batch back when its sync fails; `AssignLease` hands out the
same fid sequence from the same fetch function; `LogHistogram` gives the
same percentiles; `CircuitBreaker` (scenarios of the JAX
tests/test_overload.py), `FastHTTPClient`'s breaker and Retry-After,
`VidMap.pick_ordered` and `ReplicaReader` follow the same states and
targets under a scripted clock and scripted replies. Tolerance: exact,
except where a test says otherwise. Servers listen on free ports in
12000-18000 and every server stops in a `finally`."""

import asyncio
import json
import random
import socket
import struct
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from seaweedfs_tpu_torch.client import operation as port_op
from seaweedfs_tpu_torch.client.master_client import VidMap
from seaweedfs_tpu_torch.client.read_fanout import ReplicaReader
from seaweedfs_tpu_torch.ops.loadgen import LogHistogram
from seaweedfs_tpu_torch.pb import grpc_address
from seaweedfs_tpu_torch.pb.rpc import Stub
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.storage.group_commit import GroupCommitWorker
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.util import overload
from seaweedfs_tpu_torch.util.fasthttp import FastHTTPClient

BOUND_S = 30


def _free_port() -> int:
    """A port whose RPC port (+10000) is free too, in 12000-18000: clear of
    the ephemeral range and of the JAX tests' bands."""
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


async def _http(port, method, path, body=b"", headers=None):
    """(status, lower-cased headers, body) of one request."""
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
        data = b"" if method == "HEAD" else await r.readexactly(n)
        return int(lines[0].split()[1]), hd, data
    finally:
        w.close()


async def _close_jax_channels():
    from seaweedfs_tpu.pb.rpc import close_all_channels

    await close_all_channels()


# ---------------------------------------------------------------- servers --


async def _server_pair(tmp_path, body):
    """A port and a JAX volume server (no master) over empty directories,
    each with volume 3 (no replication) and volume 4 (001) allocated."""
    from seaweedfs_tpu.server.volume import VolumeServer as JaxVolumeServer

    pvs = VolumeServer([str(tmp_path / "port")], port=_free_port(),
                       codec_backend="cpu", needle_map_kind="lsm",
                       batch_lookup="arena")
    jvs = JaxVolumeServer(master="127.0.0.1:1", directories=[str(tmp_path / "jax")],
                          port=_free_port(), codec_backend="cpu",
                          needle_map_kind="lsm", batch_lookup="arena")
    await pvs.start()
    await jvs.start()
    try:
        stub = Stub(grpc_address(pvs.address), "volume")
        for req in ({"volume_id": 3}, {"volume_id": 4, "replication": "001"}):
            assert await stub.call("AllocateVolume", req) == {}
            assert await jvs._grpc_allocate_volume(req, None) == {}
        return await body(pvs, jvs)
    finally:
        await pvs.stop()
        await jvs.stop()
        await _close_jax_channels()


def _keys(rng, n: int) -> np.ndarray:
    """n distinct needle keys below 2^40, in seeded order."""
    return rng.permutation(np.unique(rng.integers(1, 1 << 40, 2 * n))[:n])


def _frame(items, tagged: bool) -> bytes:
    """A /!batch/put frame of (fid, tenant, body) items."""
    out = [struct.pack("<I", len(items) | (0x80000000 if tagged else 0))]
    for fid, tenant, data in items:
        f, t = fid.encode("latin1"), tenant.encode()
        if tagged:
            out.append(struct.pack("<HHI", len(f), len(t), len(data)) + f + t)
        else:
            out.append(struct.pack("<HI", len(f), len(data)) + f)
        out.append(data)
    return b"".join(out)


@pytest.mark.parametrize("tagged", [False, True], ids=["plain", "tagged"])
def test_batch_put_equals_jax(tmp_path, tagged):
    rng = np.random.default_rng(11 + tagged)
    keys = _keys(rng, 24).tolist()
    cookies = rng.integers(1, 1 << 32, 24).tolist()
    tenants = ["alice", "", "default", "bob"]
    items = [(str(FileId(3, k, c)), tenants[i % 4],
              rng.bytes(int(rng.integers(0, 700))))
             for i, (k, c) in enumerate(zip(keys, cookies))]
    items += [
        (str(FileId(3, keys[0], cookies[0])), "alice", b"overwritten"),
        # a cookie the same frame's earlier item does not check
        (str(FileId(3, keys[1], cookies[1] ^ 1)), "", b"other cookie"),
        (str(FileId(4, 77, 5)), "", b"replicated volume"),
        (str(FileId(99, 1, 1)), "", b"no such volume"),
        ("not-a-fid", "", b"x"),
    ]
    frame = _frame(items, tagged)

    async def body(pvs, jvs):
        out = []
        for port in (pvs.port, jvs.port):
            st, hd, got = await _http(port, "POST", "/!batch/put", frame)
            out.append((st, hd.get("content-type"), json.loads(got)))
            # a truncated frame is refused whole
            st, _, got = await _http(port, "POST", "/!batch/put", frame[:-3])
            out[-1] += (st, got)
        assert out[0] == out[1]
        replies = out[0][2]
        assert [r["f"] for r in replies] == [i[0] for i in items]
        assert sum("s" in r for r in replies) == 26
        for fid, _t, _d in items[:-4]:
            got = await _http(pvs.port, "GET", "/" + fid)
            want = await _http(jvs.port, "GET", "/" + fid)
            assert (got[0], got[2], got[1].get("etag")) == (
                want[0], want[2], want[1].get("etag")), fid
        return replies

    replies = _run(_server_pair(tmp_path, body))
    assert replies[0]["s"] == len(items[0][2])
    assert [r.get("err") for r in replies[-3:-1]] == ["replicated", "no volume"]
    assert "err" in replies[-1]


def test_batch_read_equals_jax(tmp_path):
    from seaweedfs_tpu.client.operation import batch_read as jax_batch_read

    rng = np.random.default_rng(5)
    keys = _keys(rng, 150)
    cookie = 0x51
    items = [(str(FileId(3, int(k), cookie)), "", rng.bytes(int(rng.integers(1, 300))))
             for k in keys]
    deleted = keys[10:40:3]
    absent = rng.integers(1 << 41, 1 << 42, 20, dtype=np.uint64)

    async def body(pvs, jvs):
        for port in (pvs.port, jvs.port):
            st, _, _ = await _http(port, "POST", "/!batch/put", _frame(items, False))
            assert st == 200
            for k in deleted.tolist():
                st, _, _ = await _http(port, "DELETE", "/" + str(FileId(3, k, cookie)))
                assert st == 202
        probes = rng.permutation(np.concatenate([keys, absent]))
        out = []
        # 170 keys take the batched snapshot; 30 the host map
        for ks in (probes, probes[:30]):
            got = await port_op.batch_read(pvs.address, 3, ks)
            want = await jax_batch_read(jvs.address, 3, ks)
            assert got == want
            out.append(got)
        # a volume neither server has: both streams end in an error
        for fn, addr in ((port_op.batch_read, pvs.address),
                         (jax_batch_read, jvs.address)):
            with pytest.raises(RuntimeError, match="volume 8 not found"):
                await fn(addr, 8, keys[:3])
        return probes, out[0]

    probes, got = _run(_server_pair(tmp_path, body))
    data = {int(k): d for (_f, _t, d), k in zip(items, keys)}
    for k, d in zip(probes.tolist(), got):
        if k in data and k not in set(deleted.tolist()):
            assert d == data[k]
        else:
            assert d is None


# ---------------------------------------------------------------- chunked --


async def _port_cluster(tmp_path, mode: str, n: int = 2):
    ms = MasterServer(port=_free_port())
    await ms.start()
    servers = []
    for i in range(n):
        vs = VolumeServer([str(tmp_path / f"p{i}")], master=ms.address,
                          port=_free_port(), pulse_seconds=0.2,
                          max_volume_counts=[8], codec_backend="cpu",
                          needle_map_kind="lsm", batch_lookup=mode)
        await vs.start()
        servers.append(vs)
    return ms, servers


async def _jax_cluster(tmp_path, mode: str, n: int = 2):
    from seaweedfs_tpu.server.master import MasterServer as JaxMaster
    from seaweedfs_tpu.server.volume import VolumeServer as JaxVolumeServer

    ms = JaxMaster(port=_free_port(), pulse_seconds=0.2)
    await ms.start()
    servers = []
    for i in range(n):
        vs = JaxVolumeServer(master=ms.address, directories=[str(tmp_path / f"j{i}")],
                             port=_free_port(), pulse_seconds=0.2,
                             max_volume_counts=[8], codec_backend="cpu",
                             needle_map_kind="lsm", batch_lookup=mode)
        await vs.start()
        servers.append(vs)
    return ms, servers


async def _until_registered(ms, n: int) -> None:
    t0 = time.monotonic()
    while len(ms.topo.data_nodes()) < n:
        assert time.monotonic() - t0 < 10, "volume servers did not register"
        await asyncio.sleep(0.05)


def _port_of(servers, url: str) -> int:
    return next(vs.port for vs in servers if url in (vs.address, vs.public_url))


async def _assign_ready(op, master: str) -> None:
    """The first assign races volume growth: retry until one succeeds."""
    for _ in range(60):
        try:
            await op.assign(master)
            return
        except Exception:
            await asyncio.sleep(0.1)
    raise AssertionError("no assign succeeded")


@pytest.mark.parametrize("mode", ["off", "arena"])
def test_chunked_submit_file_equals_jax(tmp_path, monkeypatch, mode):
    import aiohttp

    from seaweedfs_tpu.client import operation as jax_op

    rng = np.random.default_rng(9)
    data = rng.bytes(4500)
    ranges = ["bytes=0-99", "bytes=950-2100", "bytes=3999-", "bytes=-700",
              "bytes=4400-4600", "bytes=5000-6000"]

    async def one(pkg_op, ms, servers, http):
        await _until_registered(ms, 2)
        await _assign_ready(pkg_op, ms.address)
        fid, result = await pkg_op.submit_file(
            http, ms.address, data, filename="f.bin", mime="text/plain",
            chunk_size=1000)
        url = (await pkg_op.lookup(ms.address, int(fid.split(",")[0])))[0]
        port = _port_of(servers, url)
        seen = [result["size"]]
        for rg in [None] + ranges:
            st, hd, got = await _http(port, "GET", "/" + fid,
                                      headers={"Range": rg} if rg else None)
            seen.append((st, got, hd.get("content-range"), hd.get("content-type"),
                         hd.get("x-file-store"), hd.get("accept-ranges")))
        st, hd, _ = await _http(port, "HEAD", "/" + fid)
        seen.append((st, hd.get("content-length"), hd.get("x-file-store")))
        st, _, raw = await _http(port, "GET", "/" + fid + "?cm=false")
        chunks = json.loads(raw)["chunks"]
        seen.append((st, [(c["offset"], c["size"]) for c in chunks]))
        st, _, _ = await _http(port, "DELETE", "/" + fid)
        seen.append(st)
        gone = []
        for c in chunks:
            curl = (await pkg_op.lookup(ms.address, int(c["fid"].split(",")[0])))[0]
            gone.append((await _http(_port_of(servers, curl), "GET", "/" + c["fid"]))[0])
        seen.append(gone)

        # an upload whose manifest fails: the uploaded chunks are deleted
        uploaded = []
        real = pkg_op.upload_data

        async def failing(session, url, fid, payload, **kw):
            if (kw.get("params") or {}).get("cm") == "true":
                raise RuntimeError("manifest upload failed")
            out = await real(session, url, fid, payload, **kw)
            uploaded.append((url, fid))
            return out

        monkeypatch.setattr(pkg_op, "upload_data", failing)
        with pytest.raises(RuntimeError, match="manifest upload failed"):
            await pkg_op.submit_file(http, ms.address, data[:2500], chunk_size=1000)
        monkeypatch.setattr(pkg_op, "upload_data", real)
        seen.append([(await _http(_port_of(servers, u), "GET", "/" + f))[0]
                     for u, f in uploaded])
        return seen

    async def port_side():
        ms, servers = await _port_cluster(tmp_path, mode)
        http = FastHTTPClient()
        try:
            return await one(port_op, ms, servers, http)
        finally:
            await http.close()
            for vs in servers:
                await vs.stop()
            await ms.stop()

    async def jax_side():
        ms, servers = await _jax_cluster(tmp_path, mode)
        try:
            async with aiohttp.ClientSession() as session:
                return await one(jax_op, ms, servers, session)
        finally:
            for vs in servers:
                await vs.stop()
            await ms.stop()
            await _close_jax_channels()

    got = _run(port_side())
    want = _run(jax_side())
    assert got == want
    assert got[1][:2] == (200, data)
    assert got[3][:3] == (206, data[950:2101], "bytes 950-2100/4500")
    assert got[-3] == 202 and got[-2] == [404] * 5 and got[-1] == [404] * 3


def test_failed_chunk_probe_answers_500(tmp_path):
    """A chunk whose gate probe raises fails the file's GET with the gated
    reads' 500, counted as a device error; the host map never answers."""

    async def body():
        vs = VolumeServer([str(tmp_path)], port=_free_port(), codec_backend="cpu",
                          needle_map_kind="lsm", batch_lookup="arena")
        await vs.start()
        try:
            stub = Stub(grpc_address(vs.address), "volume")
            assert await stub.call("AllocateVolume", {"volume_id": 7}) == {}
            chunks = []
            for i in range(3):
                fid = str(FileId(7, 100 + i, 9))
                assert (await _http(vs.port, "POST", "/" + fid, b"c%d" % i * 50))[0] == 201
                chunks.append({"fid": fid, "offset": 100 * i, "size": 100})
            manifest = json.dumps({"name": "m", "size": 300, "chunks": chunks}).encode()
            mfid = "/" + str(FileId(7, 99, 9))
            assert (await _http(vs.port, "POST", mfid + "?cm=true", manifest))[0] == 201
            whole = await _http(vs.port, "GET", mfid)
            real = vs.lookup_gate.lookup

            def lookup(vid, key):
                if key == 101:
                    raise RuntimeError("device probe failed")
                return real(vid, key)

            vs.lookup_gate.lookup = lookup
            failed = await _http(vs.port, "GET", mfid)
            return whole[0], whole[2], failed[0], failed[2], dict(vs.device_errors)
        finally:
            await vs.stop()

    st, got, st2, err, errors = _run(body())
    assert (st, got) == (200, b"c0" * 50 + b"c1" * 50 + b"c2" * 50)
    assert (st2, err, errors) == (500, b'{"error": "lookup failed"}', {"read": 1})


def test_failed_batch_read_probe_ends_the_stream(tmp_path, monkeypatch):
    """A BatchRead whose batched probe raises ends the stream with its
    error (counted); no key is answered from the host map."""

    def broken(self, keys, use_device=None):
        raise RuntimeError("index_search launch failed")

    async def body():
        vs = VolumeServer([str(tmp_path)], port=_free_port(), codec_backend="cpu")
        await vs.start()
        try:
            stub = Stub(grpc_address(vs.address), "volume")
            assert await stub.call("AllocateVolume", {"volume_id": 5}) == {}
            assert (await _http(vs.port, "POST", "/" + str(FileId(5, 1, 2)), b"x"))[0] == 201
            monkeypatch.setattr(Volume, "bulk_lookup", broken)
            got = []
            with pytest.raises(Exception, match="index_search launch failed"):
                async for msg in stub.server_stream(
                        "BatchRead", {"volume_id": 5, "keys": [1] * 70}):
                    got.append(msg)
            return got, dict(vs.device_errors)
        finally:
            await vs.stop()

    assert _run(body()) == ([], {"batch_read": 1})


# ----------------------------------------------------------- group commit --


def _volumes(tmp_path, vid):
    from seaweedfs_tpu.storage.needle import Needle as JaxNeedle
    from seaweedfs_tpu.storage.volume import Volume as JaxVolume

    (tmp_path / "p").mkdir(exist_ok=True)
    (tmp_path / "j").mkdir(exist_ok=True)
    return ((Volume(str(tmp_path / "p"), "", vid, device="cpu"), Needle),
            (JaxVolume(str(tmp_path / "j"), "", vid), JaxNeedle))


def _jax_worker():
    from seaweedfs_tpu.storage.group_commit import GroupCommitWorker as JaxWorker

    return JaxWorker


def test_group_commit_concurrent_writes_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    payloads = {i: rng.bytes(500) for i in range(1, 60)}
    frame = [(1000 + i, rng.bytes(int(rng.integers(0, 300)))) for i in range(12)]

    async def body(v, needle_cls, worker_cls):
        worker = worker_cls(v)
        worker.start()
        try:
            async def one(nid):
                return await worker.write(needle_cls(cookie=9, id=nid, data=payloads[nid]))

            results = await asyncio.gather(*(one(nid) for nid in payloads))
            many = await worker.write_many(
                [needle_cls(cookie=3, id=k, data=d) for k, d in frame])
            freed = await worker.delete(needle_cls(id=1, cookie=9))
            back = []
            for nid in list(payloads) + [k for k, _ in frame]:
                got = needle_cls(id=nid)
                try:
                    v.read_needle(got)
                    back.append(bytes(got.data))
                except Exception:
                    back.append(None)
            return results, many, freed, back, worker.stats["requests"]
        finally:
            await worker.stop()
            v.close()

    (pv, pn), (jv, jn) = _volumes(tmp_path, 1)
    got = _run(body(pv, pn, GroupCommitWorker))
    want = _run(body(jv, jn, _jax_worker()))
    assert got == want
    assert got[3][0] is None and got[3][1:59] == list(payloads.values())[1:]
    assert got[3][59:] == [d for _, d in frame] and got[4] == 61


def test_group_commit_adaptive_batching(tmp_path):
    """Concurrent writers coalesce into shared fsync batches while a lone
    writer flushes at once, on both packages (the JAX test's bounds)."""

    async def body(v, needle_cls, worker_cls):
        worker = worker_cls(v)
        worker.start()
        try:
            await worker.write(needle_cls(cookie=1, id=1, data=b"solo"))
            solo = dict(worker.stats)
            await asyncio.gather(*(
                worker.write(needle_cls(cookie=1, id=i, data=b"x" * 400))
                for i in range(2, 162)))
            return solo, dict(worker.stats)
        finally:
            await worker.stop()
            v.close()

    (pv, pn), (jv, jn) = _volumes(tmp_path, 3)
    for got in (_run(body(pv, pn, GroupCommitWorker)),
                _run(body(jv, jn, _jax_worker()))):
        solo, stats = got
        assert solo == {"batches": 1, "requests": 1, "largest_batch": 1}
        assert stats["requests"] == 161
        assert stats["batches"] < 80 and stats["largest_batch"] > 1


def test_group_commit_rollback_on_sync_failure(tmp_path):
    async def body(v, needle_cls, worker_cls):
        v.write_needle(needle_cls(cookie=1, id=100, data=b"pre-existing"))
        good_end = v.data_backend.size()
        real_sync = v.data_backend.sync

        def broken():
            raise OSError("disk gone")

        v.data_backend.sync = broken
        worker = worker_cls(v)
        worker.start()
        try:
            outcomes = await asyncio.gather(
                worker.write(needle_cls(cookie=1, id=101, data=b"doomed")),
                worker.write_many([needle_cls(cookie=1, id=102, data=b"also")]),
                return_exceptions=True)
            return [type(o).__name__ for o in outcomes], v.data_backend.size() == good_end
        finally:
            await worker.stop()
            v.data_backend.sync = real_sync
            v.close()

    (pv, pn), (jv, jn) = _volumes(tmp_path, 2)
    got = _run(body(pv, pn, GroupCommitWorker))
    assert got == _run(body(jv, jn, _jax_worker()))
    assert got == (["OSError", "OSError"], True)


def test_fsync_write_and_delete_through_the_group_commit(tmp_path):
    async def body():
        vs = VolumeServer([str(tmp_path)], port=_free_port(), codec_backend="cpu")
        await vs.start()
        try:
            stub = Stub(grpc_address(vs.address), "volume")
            assert await stub.call("AllocateVolume", {"volume_id": 6}) == {}
            fid = "/" + str(FileId(6, 42, 7))
            st, _, _ = await _http(vs.port, "POST", fid + "?fsync=true", b"fsync-payload")
            got = (await _http(vs.port, "GET", fid))[2]
            st2, _, _ = await _http(vs.port, "DELETE", fid + "?fsync=true")
            gone = (await _http(vs.port, "GET", fid))[0]
            return st, got, st2, gone, dict(vs._group_committers[6].stats)
        finally:
            await vs.stop()

    st, got, st2, gone, stats = _run(body())
    assert (st, got, st2, gone) == (201, b"fsync-payload", 202, 404)
    assert stats["requests"] == 2


def test_group_commit_stop_during_the_widening_yield_fails_the_request(tmp_path):
    """A worker stopped while it yields to widen a batch fails the request
    it already took off the queue instead of stranding its writer."""

    async def body():
        v = Volume(str(tmp_path), "", 7, device="cpu")
        worker = GroupCommitWorker(v)
        try:
            writer = asyncio.ensure_future(worker.write(Needle(cookie=1, id=1, data=b"x")))
            await asyncio.sleep(0)  # the request is queued
            worker._concurrent = True  # the previous flush saw concurrency
            worker.start()
            await asyncio.sleep(0)  # the worker took it and yields to widen
            assert worker.queue.empty() and not writer.done()
            await worker.stop()
            with pytest.raises(RuntimeError, match="group-commit worker stopped"):
                await asyncio.wait_for(writer, 5)
        finally:
            v.close()

    _run(body())


def test_manifest_delete_racing_a_vacuum_commit(tmp_path, monkeypatch):
    """A ?fsync=true manifest delete whose chunk cascade overlaps a vacuum
    commit writes its tombstone to the volume the commit swaps in, and
    the worker it starts stays on that volume for later fsync writes."""
    from seaweedfs_tpu_torch.storage import vacuum

    real = vacuum._makeup_diff

    def slow(*a):
        time.sleep(0.3)  # the old volume stays closed for this long
        return real(*a)

    async def body():
        vs = VolumeServer([str(tmp_path)], port=_free_port(), codec_backend="cpu")
        await vs.start()
        try:
            stub = Stub(grpc_address(vs.address), "volume")
            assert await stub.call("AllocateVolume", {"volume_id": 6}) == {}
            chunks = [(str(FileId(6, 100 + i, 5)), bytes([i]) * 300) for i in range(3)]
            for fid, data in chunks:
                assert (await _http(vs.port, "POST", f"/{fid}?fsync=true", data))[0] == 201
            manifest = json.dumps({"name": "m.bin", "size": 900, "chunks": [
                {"fid": fid, "offset": 300 * i, "size": 300}
                for i, (fid, _) in enumerate(chunks)]}).encode()
            mfid = "/" + str(FileId(6, 99, 5))
            assert (await _http(vs.port, "POST", mfid + "?cm=true", manifest))[0] == 201
            assert (await _http(vs.port, "GET", mfid))[2] == b"".join(d for _, d in chunks)
            assert "error" not in await stub.call("VacuumVolumeCompact", {"volume_id": 6})
            monkeypatch.setattr(vacuum, "_makeup_diff", slow)
            cascade = vs._delete_manifest_chunks
            commit = []

            async def cascade_then_commit(n):
                await cascade(n)
                commit.append(asyncio.ensure_future(
                    stub.call("VacuumVolumeCommit", {"volume_id": 6})))
                while 6 not in vs._commits:  # the commit has begun
                    await asyncio.sleep(0.005)

            vs._delete_manifest_chunks = cascade_then_commit
            st = (await _http(vs.port, "DELETE", mfid + "?fsync=true"))[0]
            assert await commit[0] == {}
            same = vs._group_committers[6].volume is vs.store.find_volume(6)
            after = str(FileId(6, 200, 5))
            st_after = (await _http(vs.port, "POST", f"/{after}?fsync=true", b"after"))[0]
            got = [(await _http(vs.port, "GET", "/" + f))[:3:2]
                   for f in [mfid[1:], after] + [fid for fid, _ in chunks]]
            return st, same, st_after, got
        finally:
            await vs.stop()

    st, same, st_after, got = _run(body())
    assert (st, same, st_after) == (202, True, 201)
    assert got == [(404, got[0][1]), (200, b"after")] + [(404, got[2][1])] * 3


def test_host_crc32c_equals_jax(tmp_path, monkeypatch):
    """ops/csrc/host_crc32c.cu holds no device code: built here by the
    host C++ compiler, and dispatched to by util/crc.py where
    google-crc32c is missing, it gives the JAX package's CRC32C of every
    size and alignment, and so does the port's table loop."""
    import ctypes
    import importlib.util
    import shutil
    import subprocess

    from seaweedfs_tpu.util.crc import crc32c as jax_crc32c

    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src = Path(port_op.__file__).parents[1] / "ops" / "csrc" / "host_crc32c.cu"
    lib = tmp_path / "libhost_crc32c.so"
    subprocess.run([cxx, "-x", "c++", "-O2", "-shared", "-fPIC", "-o", str(lib), str(src)],
                   check=True)
    fn = ctypes.CDLL(str(lib)).crc32c_extend
    fn.restype = ctypes.c_uint32
    fn.argtypes = [ctypes.c_uint32, ctypes.c_void_p, ctypes.c_size_t]
    # util/crc.py as it loads on a host without google-crc32c
    monkeypatch.setitem(sys.modules, "google_crc32c", None)
    spec = importlib.util.find_spec("seaweedfs_tpu_torch.util.crc")
    crc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(crc)
    crc._NATIVE = fn
    assert crc.route() == "native"
    rng = np.random.default_rng(21)
    buf = rng.bytes(70_016)
    for n in [0, 1, 7, 8, 9, 15, 1023, 1024, 1025, 16_384, 70_001]:
        for off in (0, 1, 5):
            d, init = buf[off:off + n], int(rng.integers(0, 1 << 32))
            want = jax_crc32c(d, init)
            got = [fn(init, d, len(d)), crc.crc32c(d, init), crc.crc32c(memoryview(d), init),
                   crc.crc32c(bytearray(d), init)]
            if n <= 1025:
                got.append(crc._crc32c_loop(d, init))
            assert got == [want] * len(got), (n, off)


# --------------------------------------------------------- client pieces --


def _scripted_fetch(result_cls, widths, auth=""):
    """`fetch(count)` answering from a scripted list of granted widths."""
    calls = []

    async def fetch(count):
        calls.append(count)
        await asyncio.sleep(0)
        n = len(calls)
        return result_cls(fid=f"{n},{n:x}0000abcd", url=f"h{n}:1",
                          public_url=f"h{n}:1",
                          count=min(count, widths[(n - 1) % len(widths)]),
                          auth=auth)

    return fetch, calls


@pytest.mark.parametrize("auth", ["", "tok"], ids=["unsigned", "signed"])
def test_assign_lease_equals_jax(auth):
    from seaweedfs_tpu.client import operation as jax_op

    async def body(op):
        fetch, calls = _scripted_fetch(op.AssignResult, [128, 100, 7], auth)
        lease = op.AssignLease(fetch=fetch, batch=128)
        got = await asyncio.gather(*(lease.take() for _ in range(300)))
        got += [await lease.take() for _ in range(20)]
        return ([(a.fid, a.url, a.count, a.auth) for a in got],
                calls, lease.assign_rpcs)

    got = _run(body(port_op))
    assert got == _run(body(jax_op))
    fids = [g[0] for g in got[0]]
    assert len(set(fids)) == 320
    assert got[2] == (320 if auth else 4)


def test_log_histogram_equals_jax():
    from seaweedfs_tpu.ops.loadgen import LogHistogram as JaxHist

    rng = np.random.default_rng(3)
    samples = np.concatenate([rng.lognormal(-7, 1.2, 5000), [0.0, 5e-7, 3000.0]])
    out = []
    for cls in (LogHistogram, JaxHist):
        h, h2 = cls(), cls()
        for x in samples[:4000].tolist():
            h.record(x)
        for x in samples[4000:].tolist():
            h2.record(x)
        h.merge(h2)
        out.append(([h.percentile(p) for p in (0, 1, 50, 90, 99, 99.9, 100)],
                    h.counts, h.count, h.mean, h.summary_ms()))
    assert out[0] == out[1]


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _breaker_scenarios():
    """The JAX tests/test_overload.py breaker scenarios (:295-394), each
    as (constructor kwargs, steps); a step is a method name or
    ("advance", s) / ("shed", retry_after_s)."""
    return {
        "consecutive_failures_then_probe": (
            {"fail_threshold": 3, "open_s": 0.5},
            ["record_failure", "record_failure", "allow", "record_failure",
             "allow", "blocked", ("advance", 0.6), "allow", "allow",
             "record_success", "allow"]),
        "failed_probe_reopens": (
            {"fail_threshold": 2, "open_s": 0.5},
            ["record_failure", "record_failure", ("advance", 0.6), "allow",
             "record_failure", "allow"]),
        "shed_rate_and_retry_after": (
            {"shed_window": 10, "shed_trip": 0.5},
            ["record_success"] * 6 + [("shed", None)] * 4
            + [("shed", 3.0), ("advance", 1.0), "allow", ("advance", 2.5),
               "allow", "shedding"]),
        "cancelled_probe_returns_slot": (
            {"fail_threshold": 2, "open_s": 0.5},
            ["record_failure", "record_failure", ("advance", 0.6), "allow",
             "allow", "blocked", "record_cancelled", "blocked", "allow",
             "record_success", "record_cancelled", "allow"]),
        "probe_lease_reclaims_leaked_slot": (
            {"fail_threshold": 2, "open_s": 0.5, "probe_timeout_s": 5.0},
            ["record_failure", "record_failure", ("advance", 0.6), "allow",
             "allow", "blocked", ("advance", 5.1), "blocked", "allow",
             "allow", "record_success"]),
        "shedding_window": (
            {}, ["shedding", ("shed", None), "shedding", ("advance", 1.5),
                 "shedding"]),
    }


def _run_breaker(mod, kw, steps):
    clk = FakeClock()
    br = mod.CircuitBreaker("p:1", clock=clk, **kw)
    trace = []
    for step in steps:
        if isinstance(step, tuple):
            if step[0] == "advance":
                clk.advance(step[1])
            else:
                br.record_shed(step[1]) if step[1] else br.record_shed()
            out = None
        else:
            out = getattr(br, step)()
        trace.append((out, br.state, br.opens))
    return trace


@pytest.mark.parametrize("name", list(_breaker_scenarios()))
def test_circuit_breaker_equals_jax(name):
    from seaweedfs_tpu.util import overload as jax_overload

    kw, steps = _breaker_scenarios()[name]
    got = _run_breaker(overload, kw, steps)
    assert got == _run_breaker(jax_overload, kw, steps)
    assert any(state != "closed" for _o, state, _n in got) or name == "shedding_window"


def test_circuit_breaker_random_walk_equals_jax():
    from seaweedfs_tpu.util import overload as jax_overload

    rng = random.Random(17)
    ops = ["record_success", "record_failure", "record_cancelled", "allow",
           "blocked", "shedding"]
    steps = []
    for _ in range(600):
        r = rng.random()
        if r < 0.1:
            steps.append(("advance", rng.choice([0.05, 0.3, 1.2, 6.0])))
        elif r < 0.25:
            steps.append(("shed", rng.choice([None, 0.5, 2.0])))
        else:
            steps.append(rng.choice(ops))
    kw = {"fail_threshold": 3, "shed_window": 8, "open_s": 0.25}
    got = _run_breaker(overload, kw, steps)
    assert got == _run_breaker(jax_overload, kw, steps)
    assert len({s for _o, s, _n in got}) == 3


def test_registry_and_env_gate_equal_jax(monkeypatch):
    from seaweedfs_tpu.util import overload as jax_overload

    for mod in (overload, jax_overload):
        monkeypatch.setenv("SEAWEEDFS_TPU_BREAKER", "0")
        assert mod.peer_breaker("x:1") is None
        monkeypatch.setenv("SEAWEEDFS_TPU_BREAKER", "1")
        br = mod.peer_breaker("x:1")
        assert br is mod.peer_breaker("x:1") and mod.BREAKERS.peek("x:1") is br
        assert mod.BREAKERS.peek("never-seen:2") is None
        mod.BREAKERS.reset()


def test_parse_retry_after_equals_jax():
    from seaweedfs_tpu.util.fasthttp import parse_retry_after as jax_parse

    from seaweedfs_tpu_torch.util.fasthttp import parse_retry_after

    for raw in (b"2", b"0.5", b"soon", b"", b"Wed, 21 Oct 2015 07:28:00 GMT"):
        assert parse_retry_after(raw) == jax_parse(raw)


def test_client_retry_after_and_breaker_equal_jax(monkeypatch):
    """One server shedding 503 + Retry-After: 2; each package's client
    notes the hint, trips its breaker after the same number of sheds and
    then fails fast without a round trip."""
    from seaweedfs_tpu.util import overload as jax_overload
    from seaweedfs_tpu.util.fasthttp import FastHTTPClient as JaxClient

    from seaweedfs_tpu_torch.util.fasthttp import FastHTTPServer, render_response

    monkeypatch.setenv("SEAWEEDFS_TPU_BREAKER", "1")
    shed = render_response(503, b'{"error":"overloaded"}', extra=b"Retry-After: 2\r\n")

    async def handler(req):
        return shed

    async def body(client_cls, open_error):
        srv = FastHTTPServer(handler)
        port = _free_port()
        await srv.start("127.0.0.1", port)
        hostport = f"127.0.0.1:{port}"
        http = client_cls()
        try:
            st, _ = await http.request("GET", hostport, "/x")
            hint = 1.5 < http.retry_after_remaining(hostport) <= 2.0
            sheds = 1
            while True:
                try:
                    await http.request("GET", hostport, "/x")
                    sheds += 1
                except open_error:
                    break
                assert sheds < 30
            t0 = time.perf_counter()
            with pytest.raises(open_error):
                await http.request("GET", hostport, "/x")
            return st, hint, sheds, time.perf_counter() - t0 < 0.05
        finally:
            await http.close()
            await srv.stop()

    got = _run(body(FastHTTPClient, overload.CircuitOpenError))
    assert got == _run(body(JaxClient, jax_overload.CircuitOpenError))
    assert got == (503, True, 10, True)
    overload.BREAKERS.reset()
    jax_overload.BREAKERS.reset()


def test_pick_ordered_equals_jax():
    from seaweedfs_tpu.client.master_client import VidMap as JaxVidMap

    out = []
    for cls in (VidMap, JaxVidMap):
        vm = cls(local_dc="dc1")
        for vid, url, dc in ((1, "a:1", "dc1"), (1, "b:1", "dc2"), (1, "c:1", "dc1"),
                             (2, "d:1", ""), (2, "e:1", "dc2"), (3, "f:1", "dc1")):
            vm.add(vid, url, dc)
        seq = [vm.pick_ordered(v) for v in (1, 1, 1, 2, 2, 3, 4) * 2]
        out.append((seq, vm.location_dc("b:1"), vm.location_dc("zz")))
    assert out[0] == out[1]


class _ScriptedHTTP:
    """request() answers from a script keyed by (hostport, nth call):
    (delay_s, status) or (delay_s, exception); records every call."""

    def __init__(self, script):
        self.script = script
        self.calls = []

    async def request(self, method, hostport, target, *a, **kw):
        n = sum(1 for h, _t in self.calls if h == hostport)
        self.calls.append((hostport, target))
        delay, out = self.script.get((hostport, n), self.script[(hostport, "*")])
        await asyncio.sleep(delay)
        if isinstance(out, Exception):
            raise out
        return out, f"{hostport}{target}".encode()


def test_replica_reader_equals_jax():
    from seaweedfs_tpu.client.master_client import VidMap as JaxVidMap
    from seaweedfs_tpu.client.read_fanout import ReplicaReader as JaxReader
    from seaweedfs_tpu.util import overload as jax_overload

    # vid 1's reads rotate their primary a, b, c, a, ...
    script = {
        ("a:1", "*"): (0.0, 200),
        ("b:1", "*"): (0.0, 200),
        ("c:1", "*"): (0.0, 200),
        ("b:1", 0): (0.3, 200),  # read 2: a slow primary, the hedge on c wins
        ("c:1", 1): (0.0, ConnectionResetError("reset")),  # read 3: fail over to a
        ("a:1", 2): (0.0, 404),  # read 4: an error answer, cross-checked on b
        ("b:1", 2): (0.0, 404),  # read 5: b's 404 ...
        ("c:1", 2): (0.0, 404),  # ... and c agrees: the 404 stands
    }
    fids = ["1,0a01", "1,0b02", "1,0c03", "1,0d04", "1,0e05", "1,0f06",
            "2,0a07", "1,0a08", "3,0109"]

    async def body(vm_cls, reader_cls, mod):
        mod.BREAKERS.reset()
        vm = vm_cls()
        for url in ("a:1", "b:1", "c:1"):
            vm.add(1, url)
        vm.add(2, "c:1")
        http = _ScriptedHTTP(script)
        reader = reader_cls(http, vm, hedge_cap_s=0.05, min_samples=10**6)
        out = []
        for fid in fids:
            try:
                out.append(await reader.read(fid))
            except LookupError as e:
                out.append(("LookupError", str(e)))
        # a breaker-blocked holder is skipped
        br = mod.BREAKERS.get("a:1")
        for _ in range(10):
            br.record_failure()
        out.append(await reader.read("1,0a10"))
        stats = reader.stats()
        mod.BREAKERS.reset()
        return out, http.calls, stats

    got = _run(body(VidMap, ReplicaReader, overload))
    want = _run(body(JaxVidMap, JaxReader, jax_overload))
    assert got == want
    out, calls, stats = got
    assert [o[0] for o in out] == [200, 200, 200, 200, 404, 200, 200, 200,
                                   "LookupError", 200]
    assert out[1][1] == b"c:1/1,0b02" and out[3][1] == b"b:1/1,0d04"
    assert calls[-1] == ("b:1", "/1,0a10")  # a:1's breaker is open
    assert (stats["hedges"], stats["hedge_wins"]) == (4, 3)
