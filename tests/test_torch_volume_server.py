"""The port's volume server against the JAX package's (server/volume.py,
server/volume_ec.py), on the plain versions (device="cpu", the numpy
codec): the same HTTP requests give equal status codes, bodies, Etags,
Content-Range and Content-Type under every `-batchLookup` mode; directories written by
either package read back equal in the other; BulkLookup answers equal the
JAX handler's; VolumeEcShardsGenerate writes byte-identical shards, .ecx
and .vif; degraded GETs return the written bytes and VolumeEcShardsRebuild
restores the shards byte for byte. Tolerance: exact. Every server runs
under asyncio.wait_for and every subprocess under a timeout of at most
30 s."""

import asyncio
import os
import random
import shutil
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from seaweedfs_tpu_torch.pb import grpc_address
from seaweedfs_tpu_torch.pb.rpc import RpcError, Stub
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.util.fasthttp import build_multipart

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND_S = 30  # every server's and subprocess's bound


def _free_port() -> int:
    """A port whose RPC port (+10000) is free too, both under the
    ephemeral range (32768-) and clear of the JAX tests' 18200-20800
    (bench and process-cluster bands) and 21000-22000."""
    rng = random.Random()
    for _ in range(200):
        p = rng.randrange(12000, 18000)
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", p))
            with socket.socket() as s:
                s.bind(("127.0.0.1", p + 10000))
            return p
        except OSError:
            continue
    raise RuntimeError("no free port pair")


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, BOUND_S))


async def _http(port, method, path, body=b"", headers=None):
    """(status, headers, body) of one request on its own connection."""
    r, w = await asyncio.open_connection("127.0.0.1", port)
    try:
        h = {"Host": f"127.0.0.1:{port}", "Content-Length": str(len(body))}
        h.update(headers or {})
        w.write(
            f"{method} {path} HTTP/1.1\r\n".encode()
            + "".join(f"{k}: {v}\r\n" for k, v in h.items()).encode()
            + b"\r\n" + body
        )
        await w.drain()
        head = await r.readuntil(b"\r\n\r\n")
        lines = head.decode("latin1").split("\r\n")
        status = int(lines[0].split()[1])
        hd = {}
        for ln in lines[1:]:
            if ":" in ln:
                k, v = ln.split(":", 1)
                hd[k.strip().lower()] = v.strip()
        n = int(hd.get("content-length", 0))
        data = b"" if method == "HEAD" else await r.readexactly(n)
        return status, hd, data
    finally:
        w.close()


def _png(rng) -> bytes:
    """A 24x16 RGB PNG of seeded noise."""
    import io

    from PIL import Image

    img = Image.frombytes("RGB", (24, 16), rng.randbytes(24 * 16 * 3))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def _view(resp):
    status, hd, body = resp
    return (status, body, hd.get("etag"), hd.get("content-range"),
            hd.get("content-type"))


def _requests(vid, rng):
    """The request sequence both servers get, in order."""
    seq = []
    fids = []
    for i in range(1, 41):
        fid = str(FileId(vid, i * 7919, 0x1000 + i))
        fids.append(fid)
        data = rng.randbytes(rng.randint(0, 600))
        if i % 4 == 0:
            body, ct = build_multipart(
                "file", data, filename=f"f{i}.txt", mime="text/plain"
            )
            seq.append(("POST", "/" + fid, body, {"Content-Type": ct}))
        elif i % 4 == 1:
            seq.append(("PUT", "/" + fid, data, {}))
        else:
            seq.append(("POST", "/" + fid, data,
                        {"Content-Type": "application/x-test"}))
    seq.append(("POST", "/" + str(FileId(vid, 99991, 7)) + "?ts=1234567",
                b"with a timestamp", {}))
    png = _png(rng)
    png_fid = "/" + str(FileId(vid, 5555, 9))
    seq.append(("POST", png_fid, png, {"Content-Type": "image/png"}))
    for q in ("?width=8&height=8", "?width=6&mode=fit", "?height=5&mode=fill",
              "?width=100"):
        seq.append(("GET", png_fid + ".png" + q, b"", {}))
    for fid in fids:
        seq.append(("GET", "/" + fid, b"", {}))
    for fid in fids[::5]:
        seq.append(("HEAD", "/" + fid, b"", {}))
    f0 = fids[5]
    for rng_h in ("bytes=0-9", "bytes=-5", "bytes=5-", "bytes=100000-",
                  "bytes=a-b", "bytes=0-1,3-4", "bytes=-0", "items=0-3"):
        seq.append(("GET", "/" + f0, b"", {"Range": rng_h}))
    seq.append(("GET", "/" + f0, b"", {"Range": "bytes=0-3",
                                       "If-Range": '"00000000"'}))
    seq.append(("HEAD", "/" + f0, b"", {"Range": "bytes=0-3"}))
    seq.append(("GET", "/" + str(FileId(vid, 99991, 7)), b"", {}))
    seq.append(("GET", "/" + str(FileId(vid, 99991, 7)) + "?x=1", b"", {}))
    seq.append(("GET", f"/{vid}/{f0.split(',')[1]}/name.bin", b"", {}))
    seq.append(("GET", "/" + f0 + ".jpg", b"", {}))
    wrong = FileId.parse(f0)
    seq.append(("GET", "/" + str(FileId(vid, wrong.key, 0xBAD)), b"", {}))
    seq.append(("GET", "/" + str(FileId(vid, 424242, 1)), b"", {}))
    seq.append(("GET", "/" + str(FileId(vid, 424242, 1)) + "?a=b", b"", {}))
    seq.append(("GET", f"/{vid},zz", b"", {}))
    seq.append(("POST", "/" + str(FileId(vid + 50, 1, 1)), b"x", {}))
    seq.append(("DELETE", "/" + fids[2], b"", {}))
    seq.append(("GET", "/" + fids[2], b"", {}))
    seq.append(("DELETE", "/" + fids[2], b"", {}))
    seq.append(("DELETE", "/" + str(FileId(vid, wrong.key, 0xBAD)), b"", {}))
    seq.append(("PATCH", "/" + fids[3], b"", {}))
    return seq, fids


async def _serve_pair(tmp_path, mode, kind, body):
    """A port server and a JAX server (with its in-process master) over
    two empty directories, each with volume 3 allocated."""
    from seaweedfs_tpu.server.master import MasterServer
    from seaweedfs_tpu.server.volume import VolumeServer as JaxVolumeServer

    pd, jd = tmp_path / "port", tmp_path / "jax"
    ms = MasterServer(port=_free_port(), pulse_seconds=0.2)
    await ms.start()
    jvs = JaxVolumeServer(
        master=ms.address, directories=[str(jd)], port=_free_port(),
        pulse_seconds=0.2, max_volume_counts=[10], batch_lookup=mode,
        needle_map_kind=kind, codec_backend="cpu",
    )
    pvs = VolumeServer(
        [str(pd)], port=_free_port(), codec_backend="cpu",
        needle_map_kind=kind, batch_lookup=mode,
    )
    await jvs.start()
    await pvs.start()
    try:
        assert await jvs._grpc_allocate_volume({"volume_id": 3}, None) == {}
        stub = Stub(grpc_address(pvs.address), "volume")
        assert await stub.call("AllocateVolume", {"volume_id": 3}) == {}
        return await body(pvs, jvs)
    finally:
        await pvs.stop()
        await jvs.stop()
        await ms.stop()
        from seaweedfs_tpu.pb.rpc import close_all_channels

        await close_all_channels()


@pytest.mark.parametrize(
    "mode,kind",
    [("off", "memory"), ("host", "memory"), ("device", "lsm"),
     ("arena", "lsm"), ("device", "leveldb")],
)
def test_http_responses_equal_jax(tmp_path, mode, kind):
    seq, fids = _requests(3, random.Random(3))

    async def body(pvs, jvs):
        for method, path, data, headers in seq:
            got = _view(await _http(pvs.port, method, path, data, headers))
            want = _view(await _http(jvs.port, method, path, data, headers))
            assert got == want, (method, path, headers)
        # a burst of 160 concurrent GETs: one gate wakeup at or above
        # the arena cut (`lookup_gate._ARENA_MIN_WAKEUP`) on both servers
        burst = [f for f in fids for _ in range(4)]
        got = await asyncio.gather(
            *(_http(pvs.port, "GET", "/" + f) for f in burst))
        want = await asyncio.gather(
            *(_http(jvs.port, "GET", "/" + f) for f in burst))
        assert [_view(r) for r in got] == [_view(r) for r in want]
        return pvs.lookup_gate.stats if pvs.lookup_gate else None

    stats = _run(_serve_pair(tmp_path, mode, kind, body))
    if mode != "off":
        assert stats["probes"] > 0 and stats["largest_batch"] > 1


def _write_dir(pkg_volume, needle_cls, d, kind, seed):
    """Volume 5 in `d` through one package's Volume: writes, overwrites
    and deletes; returns {key: (cookie, data) or None}."""
    rng = random.Random(seed)
    v = pkg_volume(str(d), "", 5, needle_map_kind=kind)
    want = {}
    keys = rng.sample(range(1, 1 << 40), 120)
    for k in keys + keys[:15]:  # the last 15 overwritten
        data = rng.randbytes(rng.randint(1, 400))
        c = want[k][0] if k in want else rng.randrange(1, 1 << 32)
        v.write_needle(needle_cls(cookie=c, id=k, data=data))
        want[k] = (c, data)
    for k in keys[20:50:4]:
        v.delete_needle(needle_cls(cookie=want[k][0], id=k))
        want[k] = None
    v.close()
    return want


def _read_all(pkg_volume, needle_cls, d, kind, want):
    v = pkg_volume(str(d), "", 5, create=False, needle_map_kind=kind)
    try:
        for k, cd in want.items():
            n = needle_cls(id=k)
            if cd is None:
                with pytest.raises(Exception):
                    v.read_needle(n)
                continue
            v.read_needle(n)
            assert (n.cookie, bytes(n.data)) == cd, k
    finally:
        v.close()


@pytest.mark.parametrize("kind", ["memory", "lsm", "leveldb", "sorted"])
def test_directories_read_back_in_the_other_package(tmp_path, kind):
    from seaweedfs_tpu.storage.needle import Needle as JaxNeedle
    from seaweedfs_tpu.storage.volume import Volume as JaxVolume

    def port_volume(*a, **kw):
        return Volume(*a, device="cpu", **kw)

    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    want = _write_dir(port_volume, Needle, a, kind, 1)
    _read_all(JaxVolume, JaxNeedle, a, kind, want)
    want = _write_dir(JaxVolume, JaxNeedle, b, kind, 2)
    _read_all(port_volume, Needle, b, kind, want)


def _seed_dir(d, kind="memory"):
    """Volume 5 written by the port's Volume; returns {key: (cookie, data)}
    of the live needles."""
    want = _write_dir(lambda *a, **kw: Volume(*a, device="cpu", **kw),
                      Needle, d, kind, 7)
    return {k: cd for k, cd in want.items() if cd is not None}


def _jax_server(d):
    from seaweedfs_tpu.server.volume import VolumeServer as JaxVolumeServer

    return JaxVolumeServer(
        master="127.0.0.1:1", directories=[str(d)], port=_free_port(),
        codec_backend="cpu",
    )


def test_bulk_lookup_equals_jax_handler(tmp_path):
    a = tmp_path / "a"
    a.mkdir()
    live = _seed_dir(a)
    shutil.copytree(a, tmp_path / "b")
    keys = np.array(sorted(live) + [1, 2, 3, 1 << 41], dtype=np.uint64)
    keys = np.concatenate([keys, keys[:70]])  # >= 64: the snapshot path
    req = {"volume_id": 5, "keys": keys.astype("<u8").tobytes()}

    async def body():
        pvs = VolumeServer([str(a)], port=_free_port(), codec_backend="cpu")
        await pvs.start()
        try:
            stub = Stub(grpc_address(pvs.address), "volume")
            got = await stub.call("BulkLookup", req)
            small = await stub.call("BulkLookup", {"volume_id": 5,
                                                   "keys": keys[:5].tolist()})
            missing = await stub.call("BulkLookup", {"volume_id": 77,
                                                     "keys": b""})
        finally:
            await pvs.stop()
        jvs = _jax_server(tmp_path / "b")
        try:
            want = await jvs._grpc_bulk_lookup(req, None)
            want_small = await jvs._grpc_bulk_lookup(
                {"volume_id": 5, "keys": keys[:5].tolist()}, None)
            want_missing = await jvs._grpc_bulk_lookup(
                {"volume_id": 77, "keys": b""}, None)
        finally:
            jvs.store.close()
        return got, want, small, want_small, missing, want_missing

    got, want, small, want_small, missing, want_missing = _run(body())
    assert got == want
    assert small == want_small
    assert missing == want_missing
    assert np.frombuffer(got["found"], np.uint8).sum() == len(live) + 70 - sum(
        1 for k in keys[:70].tolist() if k not in live)


EC_FILES = [f".ec{i:02d}" for i in range(14)] + [".ecx", ".vif"]


def _files(d, vid, exts):
    out = {}
    for ext in exts:
        p = os.path.join(d, f"{vid}{ext}")
        out[ext] = None
        if os.path.exists(p):
            with open(p, "rb") as f:
                out[ext] = f.read()
    return out


@pytest.mark.parametrize("geometry", [(10, 4), (6, 3)])
def test_ec_generate_equals_jax(tmp_path, geometry):
    k, m = geometry
    a = tmp_path / "a"
    a.mkdir()
    _seed_dir(a)
    shutil.copytree(a, tmp_path / "b")
    req = {"volume_id": 5}
    if (k, m) != (10, 4):
        req.update(data_shards=k, parity_shards=m)

    async def body():
        pvs = VolumeServer([str(a)], port=_free_port(), codec_backend="cpu")
        await pvs.start()
        try:
            stub = Stub(grpc_address(pvs.address), "volume")
            got = await stub.call("VolumeEcShardsGenerate", req)
            info = await stub.call("VolumeEcShardsInfo", {"volume_id": 5})
        finally:
            await pvs.stop()
        jvs = _jax_server(tmp_path / "b")
        try:
            want = await jvs._grpc_ec_generate(req, None)
            want_info = await jvs._grpc_ec_info({"volume_id": 5}, None)
        finally:
            jvs.store.close()
        return got, want, info, want_info

    got, want, info, want_info = _run(body())
    assert got == want == {}
    assert info == want_info == {"data_shards": k, "parity_shards": m}
    exts = [f".ec{i:02d}" for i in range(k + m)] + [".ecx", ".vif"]
    pf, jf = _files(a, 5, exts), _files(tmp_path / "b", 5, exts)
    assert all(v is not None for v in pf.values())
    assert pf == jf


def test_degraded_get_and_rebuild(tmp_path):
    """Generate, mount the shards, delete the normal volume (its EC files
    kept), lose four shards: every GET decodes the written bytes, a DELETE
    tombstones one needle in the .ecx (202, then 404), then
    VolumeEcShardsRebuild restores the shards byte for byte (and the JAX
    package's degraded read of the same shards agrees)."""
    a = tmp_path / "a"
    a.mkdir()
    live = _seed_dir(a)
    lost = (0, 3, 10, 13)

    async def body():
        pvs = VolumeServer([str(a)], port=_free_port(), codec_backend="cpu")
        await pvs.start()
        try:
            stub = Stub(grpc_address(pvs.address), "volume")
            assert await stub.call("VolumeMarkReadonly", {"volume_id": 5}) == {}
            assert await stub.call("VolumeEcShardsGenerate",
                                   {"volume_id": 5}) == {}
            shards = _files(a, 5, EC_FILES)
            assert await stub.call("VolumeEcShardsMount", {
                "volume_id": 5, "shard_ids": list(range(14))}) == {}
            assert await stub.call("VolumeDelete", {
                "volume_id": 5, "keep_ec_files": True}) == {}
            assert not os.path.exists(a / "5.dat")
            assert await stub.call("VolumeEcShardsUnmount", {
                "volume_id": 5, "shard_ids": list(lost)}) == {}
            for s in lost:
                os.remove(a / f"5.ec{s:02d}")
            ev = pvs.store.find_ec_volume(5)
            assert ev.shard_ids() == [i for i in range(14) if i not in lost]
            for key, (cookie, data) in live.items():
                st, hd, got = await _http(
                    pvs.port, "GET", "/" + str(FileId(5, key, cookie)))
                assert (st, got) == (200, data), key
            st, _, got = await _http(
                pvs.port, "GET", "/" + str(FileId(5, 1 << 41, 1)))
            assert st == 404
            st, _, got = await _http(
                pvs.port, "DELETE", "/" + str(FileId(5, key, cookie)))
            assert st == 202 and b'"size": ' in got
            st, _, _ = await _http(pvs.port, "GET", "/" + str(FileId(5, key, cookie)))
            assert st == 404
            deleted = key
            reply = await stub.call("VolumeEcShardsRebuild", {"volume_id": 5})
            assert reply == {"rebuilt_shard_ids": list(lost)}
            now = _files(a, 5, EC_FILES)
            assert {e: now[e] for e in EC_FILES if e != ".ecx"} == {
                e: shards[e] for e in EC_FILES if e != ".ecx"}
            assert now[".ecx"] != shards[".ecx"]  # the tombstone
            return deleted
        finally:
            await pvs.stop()

    async def jax_reads(deleted):
        # the JAX server over the rebuilt directory, four shards lost
        for s in lost:
            os.remove(a / f"5.ec{s:02d}")
        jvs = _jax_server(a)
        try:
            ev = jvs.store.find_ec_volume(5)
            assert await jvs.read_ec_needle(ev, deleted) is None
            for key, (cookie, data) in list(live.items())[:25]:
                if key != deleted:
                    n = await jvs.read_ec_needle(ev, key)
                    assert bytes(n.data) == data
        finally:
            jvs.store.close()

    _run(jax_reads(_run(body())))


def test_not_ported_shapes_answer_501(tmp_path):
    async def body():
        pvs = VolumeServer([str(tmp_path)], port=_free_port(),
                           codec_backend="cpu")
        await pvs.start()
        try:
            stub = Stub(grpc_address(pvs.address), "volume")
            assert await stub.call("AllocateVolume", {"volume_id": 9}) == {}
            out = []
            for method, path, data, q in (
                ("GET", "/ui", b"", ""),
                ("GET", "/debug/pprof/profile", b"", ""),
                ("GET", "/debug/traces", b"", ""),
                ("GET", "/debug/overload", b"", ""),
            ):
                st, _, got = await _http(pvs.port, method, path + q, data)
                out.append((st, got.startswith(b'{"error": "not ported')))
            with pytest.raises(RpcError) as e:
                await stub.call("VolumeConfigure", {"volume_id": 9})
            assert e.value.status == 501
            st, _, got = await _http(pvs.port, "GET", "/metrics")
            assert st == 200 and b"seaweedfs_tpu_request_total" in got
            return out
        finally:
            await pvs.stop()

    assert _run(body()) == [(501, True)] * 4


def test_device_failure_is_a_counted_500(tmp_path, monkeypatch):
    """A lookup whose device work raises reaches the client as a 500 and
    is counted; the host map never answers in its place."""
    from seaweedfs_tpu_torch.server import lookup_gate

    # every wakeup goes to the arena, however few GETs it holds
    monkeypatch.setattr(lookup_gate, "_ARENA_MIN_WAKEUP", 1)

    async def body():
        pvs = VolumeServer([str(tmp_path)], port=_free_port(),
                           codec_backend="cpu", needle_map_kind="lsm",
                           batch_lookup="arena")
        await pvs.start()
        try:
            stub = Stub(grpc_address(pvs.address), "volume")
            await stub.call("AllocateVolume", {"volume_id": 4})
            fids = [str(FileId(4, k, 9)) for k in range(1, 201)]
            for f in fids:
                assert (await _http(pvs.port, "POST", "/" + f, b"abc"))[0] == 201
            pvs.store.find_volume(4).nm.save_snapshot()  # seal into a run

            def broken(groups, timings=None):
                raise RuntimeError("injected launch failure")

            pvs.lookup_arena.probe_groups = broken
            got = await asyncio.gather(
                *(_http(pvs.port, "GET", "/" + f) for f in fids))

            def lookup_fails(keys, use_device=None):
                raise RuntimeError("injected snapshot failure")

            pvs.store.find_volume(4).bulk_lookup = lookup_fails
            with pytest.raises(RpcError) as e:
                await stub.call("BulkLookup", {"volume_id": 4, "keys": b""})
            assert e.value.status == 500
            return [r[0] for r in got], dict(pvs.device_errors)
        finally:
            await pvs.stop()

    statuses, errors = _run(body())
    assert statuses == [500] * len(statuses)
    assert errors["read"] == len(statuses)
    assert errors["bulk_lookup"] == 1


def test_cuda_backend_without_a_card_raises(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VolumeServer([str(tmp_path)], port=_free_port())
    with pytest.raises(NotImplementedError, match="not ported"):
        VolumeServer([str(tmp_path)], codec_backend="adaptive")
    with pytest.raises(ValueError, match="unknown needle map kind"):
        VolumeServer([str(tmp_path)], codec_backend="cpu",
                     needle_map_kind="btree")


@pytest.mark.parametrize("flags", [["-config", "volume.toml"],
                                   ["-tierConfig", "tier.toml"], ["-pprof"]])
def test_cli_refuses_flags_not_ported(tmp_path, capsys, flags):
    """Flags of parts still to port are not declared: argparse refuses
    them before a server is built."""
    from seaweedfs_tpu_torch.command import cli

    with pytest.raises(SystemExit) as e:
        cli.main(["volume", "-storageBackend", "cpu", "-dir", str(tmp_path),
                  *flags])
    assert e.value.code == 2
    assert "unrecognized arguments: " + flags[0] in capsys.readouterr().err
    assert os.listdir(tmp_path) == []


def test_cli_serves_status_and_exits_on_sigint(tmp_path):
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "volume",
         "-storageBackend", "cpu", "-dir", str(tmp_path), "-port", str(port)],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
    )
    try:
        deadline = time.monotonic() + BOUND_S
        status = None
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                status = asyncio.run(asyncio.wait_for(
                    _http(port, "GET", "/status"), 5))
                break
            except OSError:
                time.sleep(0.1)
        assert status is not None, proc.stderr.read().decode()
        assert status[0] == 200 and b'"Version"' in status[2]
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=BOUND_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=BOUND_S)
