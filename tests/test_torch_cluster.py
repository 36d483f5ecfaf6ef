"""The port's cluster on the CPU (plain versions, `codec_backend="cpu"`):
an in-process master and volume servers (`Cluster`, the port's
counterpart of tests/test_cluster.py::Cluster), mirroring the JAX
package's cluster tests: writes, reads and deletes through assign and
lookup; the master's HTTP endpoints and its redirect; a replicated write
and delete (-replication 001); the not-local redirect between volume
servers; EC generate, spread, remote-shard reads, degraded reads and EC
deletes (test_cluster.py); shell ec.encode through
VolumeEcShardsGenerateBatch (test_multi_encode.py); random-offset reads
under shard failures (test_ec_read_failure.py); shell ec.encode spread
4/4/3/3 over four servers, a lost server and shell ec.rebuild; the
benchmark (test_shell.py); and the CLI's `server`, `volume -mserver`,
`shell` and `benchmark` as processes. Tolerance: exact. Pulses are
0.2 s, every wait has a deadline and every cluster stops in a
`finally`."""

import asyncio
import os
import random
import signal
import socket
import subprocess
import sys
import time

import pytest

from seaweedfs_tpu_torch.client import assign, lookup
from seaweedfs_tpu_torch.client.operation import delete_file, read_url, upload_data
from seaweedfs_tpu_torch.pb import grpc_address
from seaweedfs_tpu_torch.pb.rpc import Stub
from seaweedfs_tpu_torch.server.master import MasterServer
from seaweedfs_tpu_torch.server.volume import VolumeServer
from seaweedfs_tpu_torch.storage.file_id import format_needle_id_cookie
from seaweedfs_tpu_torch.util.fasthttp import FastHTTPClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND_S = 40


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


async def _until(cond, deadline_s: float = 10.0, step: float = 0.05):
    t0 = time.monotonic()
    while True:
        got = await cond()
        if got:
            return got
        assert time.monotonic() - t0 < deadline_s, "condition not met in time"
        await asyncio.sleep(step)


async def assign_retry(master: str, attempts: int = 40, **kw):
    """assign() with retries: the first assign races volume growth."""
    last: Exception = RuntimeError("no attempts")
    for _ in range(attempts):
        try:
            return await assign(master, **kw)
        except Exception as e:
            last = e
            await asyncio.sleep(0.1)
    raise last


class Cluster:
    """A port master and `n` port volume servers in this process."""

    def __init__(self, tmp_path, n_volume_servers: int = 3, **vs_kw):
        self.tmp_path = tmp_path
        self.n = n_volume_servers
        self.vs_kw = vs_kw
        self.master: MasterServer = None
        self.volume_servers: list[VolumeServer] = []

    async def start(self) -> None:
        self.master = MasterServer(port=_port_pair())
        await self.master.start()
        for i in range(self.n):
            d = self.tmp_path / f"vol{i}"
            d.mkdir(exist_ok=True)
            vs = VolumeServer(
                [str(d)], master=self.master.address, port=_port_pair(),
                pulse_seconds=0.2, max_volume_counts=[20],
                codec_backend="cpu", **self.vs_kw,
            )
            await vs.start()
            self.volume_servers.append(vs)
        await self.wait_nodes(self.n)

    async def wait_nodes(self, n: int) -> None:
        async def registered():
            return len(self.master.topo.data_nodes()) == n

        await _until(registered)

    async def wait_ec(self, vid: int, shards: int = 14) -> None:
        async def known():
            locs = self.master.topo.lookup_ec_shards(vid)
            return locs is not None and sum(1 for loc in locs.locations if loc) == shards

        await _until(known)

    async def stop(self) -> None:
        for vs in self.volume_servers:
            await vs.stop()
        await self.master.stop()

    def server_for(self, address: str) -> VolumeServer:
        for vs in self.volume_servers:
            if vs.address == address:
                return vs
        raise LookupError(address)


def _run(body, n: int = 3, bound: float = BOUND_S, **vs_kw):
    """Run `body(cluster, http)` against a started cluster; always stop."""
    async def main(tmp_path):
        cluster = Cluster(tmp_path, n_volume_servers=n, **vs_kw)
        http = FastHTTPClient()
        try:
            await cluster.start()
            return await body(cluster, http)
        finally:
            await http.close()
            await cluster.stop()

    return lambda tmp_path: asyncio.run(asyncio.wait_for(main(tmp_path), bound))


async def _get(http, url: str, fid: str, headers=None):
    return await http.request("GET", url, "/" + fid, headers=headers)


def test_cluster_write_read_delete(tmp_path):
    """Mirror of test_cluster.py::test_cluster_write_read_delete on port
    servers running the LSM map and the arena lookup backend."""
    async def body(cluster, http):
        master = cluster.master.address
        payloads = {}
        rng = random.Random(1)
        for i in range(24):
            ar = await assign_retry(master)
            data = rng.randbytes(1000 + i)
            await upload_data(http, ar.url, ar.fid, data)
            payloads[ar.fid] = data
        for fid, data in payloads.items():
            locs = await lookup(master, int(fid.split(",")[0]))
            assert locs
            assert await read_url(http, f"http://{locs[0]}/{fid}") == data
        fid = next(iter(payloads))
        locs = await lookup(master, int(fid.split(",")[0]))
        assert (await delete_file(http, locs[0], fid))["size"] > 0
        st, _ = await _get(http, locs[0], fid)
        return st

    assert _run(body, n=2, needle_map_kind="lsm", batch_lookup="arena")(tmp_path) == 404


def test_cluster_master_http_endpoints(tmp_path):
    """Mirror of test_cluster.py::test_cluster_master_http_endpoints."""
    import json

    async def body(cluster, http):
        maddr = cluster.master.address
        st, raw = await http.request("GET", maddr, "/dir/assign")
        ar = json.loads(raw)
        assert st == 200 and "fid" in ar, ar
        fid = ar["fid"]
        await upload_data(http, ar["url"], fid, b"hello-http")
        vid = fid.split(",")[0]
        st, raw = await http.request("GET", maddr, f"/dir/lookup?volumeId={vid}")
        assert json.loads(raw).get("locations")
        st, raw = await http.request("GET", maddr, "/dir/status")
        assert json.loads(raw)["Topology"]["max_volume_id"] >= 1
        st, raw = await http.request("POST", maddr, "/dir/assign", b"count=3",
                                     "application/x-www-form-urlencoded")
        assert json.loads(raw)["count"] == 3
        st, raw = await http.request("GET", maddr, "/vol/grow?count=2")
        assert (st, json.loads(raw)) == (200, {"count": 2})
        st, raw = await http.request("GET", maddr, "/cluster/status")
        assert json.loads(raw)["IsLeader"] is True
        # a forced sweep finds no garbage: every volume's check skips it
        st, raw = await http.request("GET", maddr, "/vol/vacuum")
        assert (st, json.loads(raw)) == (200, {"Result": []})
        st, raw = await http.request("GET", maddr, "/ui")
        assert st == 501 and b"not ported" in raw
        # the master's redirect to the volume server
        return await read_url(http, f"http://{maddr}/{fid}")

    assert _run(body, n=1)(tmp_path) == b"hello-http"


def test_cluster_replicated_write(tmp_path):
    """Mirror of test_cluster.py::test_cluster_replicated_write: a
    -replication 001 write lands on both servers; a delete reaches both.
    The write answers the Content-Type of the JAX server's aiohttp
    application, which its fast tier hands a replicated write to."""
    from seaweedfs_tpu_torch.util.fasthttp import response_header

    async def body(cluster, http):
        master = cluster.master.address
        ar = await assign_retry(master, replication="001")
        data = random.Random(5).randbytes(5000)
        st, _, head = await http.request_full("POST", ar.url, "/" + ar.fid, data,
                                              "application/octet-stream")
        assert (st, response_header(head, b"content-type")) == (
            201, "application/json; charset=utf-8")
        vid = int(ar.fid.split(",")[0])
        locs = await lookup(master, vid)
        assert len(locs) == 2, locs
        got = [await read_url(http, f"http://{url}/{ar.fid}") for url in locs]
        await delete_file(http, ar.url, ar.fid)
        after = [(await _get(http, url, ar.fid))[0] for url in locs]
        return got == [data, data], after

    assert _run(body, n=2)(tmp_path) == (True, [404, 404])


def test_not_local_read_redirects_to_the_holder(tmp_path):
    """A GET to a server that lacks the volume answers 301 to the
    master-located holder, and read_url follows it."""
    from seaweedfs_tpu_torch.util.fasthttp import response_header

    async def body(cluster, http):
        ar = await assign_retry(cluster.master.address)
        await upload_data(http, ar.url, ar.fid, b"elsewhere")
        other = next(vs.address for vs in cluster.volume_servers if vs.address != ar.url)
        st, _, head = await http.request_full("GET", other, "/" + ar.fid + "?x=1")
        got = await read_url(http, f"http://{other}/{ar.fid}")
        missing, _ = await http.request("GET", other, "/999,0100000001")
        return st, response_header(head, b"location"), got, missing, ar

    st, location, got, missing, ar = _run(body, n=2)(tmp_path)
    assert (st, location) == (301, f"http://{ar.url}/{ar.fid}?x=1")
    assert got == b"elsewhere" and missing == 404


async def _fill_volume(cluster, http, n: int, size_fn, tag: int, rng):
    """n needles crafted into one assigned volume -> (vid, source, payloads)."""
    ar0 = await assign_retry(cluster.master.address)
    vid = int(ar0.fid.split(",")[0])
    payloads = {}
    for i in range(1, n + 1):
        fid = f"{vid},{format_needle_id_cookie(i, tag + i)}"
        data = rng.randbytes(size_fn(i))
        await upload_data(http, ar0.url, fid, data)
        payloads[fid] = data
    return vid, ar0.url, payloads


async def _spread(cluster, vid: int, source: str, shard_map: dict) -> None:
    """Generate on `source`, copy and mount `shard_map`, drop the volume
    and the shards the source does not keep (as the JAX tests do)."""
    src = Stub(grpc_address(source), "volume")
    await src.call("VolumeMarkReadonly", {"volume_id": vid})
    r = await src.call("VolumeEcShardsGenerate", {"volume_id": vid}, timeout=120)
    assert not r.get("error"), r
    for target, shard_ids in shard_map.items():
        tstub = Stub(grpc_address(target), "volume")
        if target != source:
            r = await tstub.call("VolumeEcShardsCopy", {
                "volume_id": vid, "shard_ids": shard_ids, "copy_ecx_file": True,
                "source_data_node": source}, timeout=120)
            assert not r.get("error"), r
        r = await tstub.call("VolumeEcShardsMount", {"volume_id": vid,
                                                     "shard_ids": shard_ids})
        assert not r.get("error"), r
    await src.call("VolumeUnmount", {"volume_id": vid})
    await src.call("VolumeEcShardsDelete", {
        "volume_id": vid,
        "shard_ids": [i for i in range(14) if i not in shard_map.get(source, [])]})
    await cluster.wait_ec(vid)


def test_cluster_ec_encode_spread_read_degraded(tmp_path):
    """Mirror of test_cluster.py::test_cluster_ec_encode_spread_read_degraded:
    spread over 3 servers; every needle read from every server through
    remote shards; reads after unmounting the 4-shard server; an EC delete
    then 404 from every server."""
    async def body(cluster, http):
        rng = random.Random(2)
        vid, source, payloads = await _fill_volume(
            cluster, http, 24, lambda i: 2000 + 13 * i, 0xAB0000, rng)
        servers = [vs.address for vs in cluster.volume_servers]
        shard_map = {s: [i for i in range(14) if i % 3 == k] for k, s in enumerate(servers)}
        await _spread(cluster, vid, source, shard_map)
        for fid, data in payloads.items():
            for url in servers:
                assert await read_url(http, f"http://{url}/{fid}") == data, (fid, url)
        victim = servers[2]
        await Stub(grpc_address(victim), "volume").call(
            "VolumeEcShardsUnmount", {"volume_id": vid, "shard_ids": shard_map[victim]})
        await cluster.wait_ec(vid, 14 - len(shard_map[victim]))
        for fid, data in payloads.items():
            for url in servers[:2]:
                assert await read_url(http, f"http://{url}/{fid}") == data, (fid, url)
        del_fid = next(iter(payloads))
        st, _ = await http.request("DELETE", servers[0], "/" + del_fid)
        assert st == 202
        # the server whose shards are gone redirects to a holder
        return [(await _get(http, url, del_fid))[0] for url in servers]

    assert _run(body, n=3)(tmp_path) == [404, 404, 301]


def test_shell_ec_encode_batches_colocated_volumes(tmp_path):
    """Mirror of test_multi_encode.py::test_shell_ec_encode_batches_colocated_volumes:
    `ec.encode -volumeId a,b` with both volumes on one node goes through
    VolumeEcShardsGenerateBatch, then spreads and serves reads."""
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command

    async def body(cluster, http):
        ar0 = await assign_retry(cluster.master.address)
        url = ar0.url
        vid0 = int(ar0.fid.split(",")[0])
        vids = [vid0, vid0 - 1 if vid0 > 1 else vid0 + 1]
        payloads = {}
        rng = random.Random(3)
        for vid in vids:
            for i in range(1, 6):
                fid = f"{vid},{format_needle_id_cookie(i, 0xEE00 + i)}"
                data = rng.randbytes(1200 + 17 * i)
                await upload_data(http, url, fid, data)
                payloads[fid] = data
        env = CommandEnv(cluster.master.address)
        calls = []
        vs = cluster.server_for(url)
        real = vs._grpc_ec_generate_batch

        async def counted(req, context):
            calls.append(sorted(req["volume_ids"]))
            return await real(req, context)

        vs._grpc_ec_generate_batch = counted
        # the RPC table holds the bound method: re-register the wrapper
        vs._rpc_server._routes["/volume/VolumeEcShardsGenerateBatch"] = (
            "unary_unary", counted)

        async def both_known():
            nodes = await env.collect_data_nodes()
            have = {int(v["id"]) for dn in nodes for v in dn.get("volumes", [])}
            return set(vids) <= have

        await _until(both_known)
        try:
            assert await run_command(env, "lock") == "locked"
            out = await run_command(env, f"ec.encode -volumeId {vids[0]},{vids[1]}")
        finally:
            await env.release_lock()
        assert out.count("encoded") == 2, out
        for fid, want in payloads.items():
            assert await read_url(http, f"http://{url}/{fid}") == want, fid
        return calls, sorted(vids)

    calls, vids = _run(body, n=1)(tmp_path)
    assert calls == [vids]


N_FAIL_SERVERS = 7


def test_ec_read_random_offsets_under_failures(tmp_path):
    """Mirror of test_ec_read_failure.py::test_ec_read_random_offsets_under_failures
    with fewer needles: payloads of about 1 MB cross the 1 MB small
    blocks, so needles span several data shards; per example 0-2 of 7
    servers (2 shards each) lose their shards and seeded Range reads must
    equal the written bytes; the last example forces reconstruction."""
    from seaweedfs_tpu_torch.util.metrics import EC_RECONSTRUCTIONS

    def reconstructions() -> float:
        with EC_RECONSTRUCTIONS._lock:
            return sum(EC_RECONSTRUCTIONS._values.values())

    async def body(cluster, http):
        rng = random.Random(0xEC5EED)
        vid, source, payloads = await _fill_volume(
            cluster, http, 6, lambda i: 900_000 + 17_001 * i, 0xEC0000, rng)
        fids = list(payloads)
        servers = [vs.address for vs in cluster.volume_servers]
        shard_map = {s: [i, i + N_FAIL_SERVERS] for i, s in enumerate(servers)}
        await _spread(cluster, vid, source, shard_map)

        async def read_range(url, fid, start, end):
            st, body = await _get(http, url, fid, {"Range": f"bytes={start}-{end}"})
            assert st in (200, 206), (st, url, fid)
            return body[start:end + 1] if st == 200 else body

        async def run_example(kills, reads, check_all):
            for s in kills:
                await Stub(grpc_address(s), "volume").call(
                    "VolumeEcShardsUnmount", {"volume_id": vid, "shard_ids": shard_map[s]})
            # the master learns of the kills (the JAX test sleeps 0.5 s)
            await cluster.wait_ec(vid, 14 - 2 * len(kills))
            alive = [s for s in servers if s not in kills]
            try:
                for pick, frac, span in reads:
                    fid = fids[pick % len(fids)]
                    data = payloads[fid]
                    start = int(frac * (len(data) - 1))
                    end = min(start + span, len(data) - 1)
                    url = alive[pick % len(alive)]
                    got = await read_range(url, fid, start, end)
                    assert got == data[start:end + 1], (fid, start, end, url, kills)
                if check_all:
                    fid = fids[reads[0][0] % len(fids)]
                    for url in alive:
                        st, got = await _get(http, url, fid)
                        assert (st, got == payloads[fid]) == (200, True), (url, fid)
            finally:
                for s in kills:
                    await Stub(grpc_address(s), "volume").call(
                        "VolumeEcShardsMount", {"volume_id": vid, "shard_ids": shard_map[s]})
                await cluster.wait_ec(vid)

        for ex in range(10):
            kills = rng.sample(servers, rng.choice([0, 1, 1, 2, 2]))
            reads = [(rng.randrange(10_000), rng.random(), rng.randrange(1, 4000))
                     for _ in range(3)]
            await run_example(kills, reads, check_all=ex % 5 == 0)
        before = reconstructions()
        await run_example([servers[0], servers[1]],
                          [(0, 0.0, 3000), (1, 0.01, 2000), (2, 0.02, 1000)], True)
        return reconstructions() > before

    assert _run(body, n=N_FAIL_SERVERS)(tmp_path)


def test_shell_ec_encode_spread_outage_and_rebuild(tmp_path):
    """Shell ec.encode spreads 4/4/3/3 over four servers; with a 4-shard
    server stopped every needle still reads (degraded, decoded from the
    remote survivors); shell ec.rebuild restores the lost shards byte for
    byte on a survivor."""
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command

    async def body(cluster, http):
        rng = random.Random(4)
        vid, source, payloads = await _fill_volume(
            cluster, http, 30, lambda i: rng.randrange(1, 60_000), 0x5500, rng)
        env = CommandEnv(cluster.master.address)

        async def heartbeated():
            nodes = await env.collect_data_nodes()
            return any(int(v["id"]) == vid for dn in nodes for v in dn.get("volumes", []))

        await _until(heartbeated)
        try:
            assert await run_command(env, "lock") == "locked"
            out = await run_command(env, f"ec.encode -volumeId {vid}")
            assert f"volume {vid}: encoded" in out, out
            await cluster.wait_ec(vid)
            locs = cluster.master.topo.lookup_ec_shards(vid)
            held = {}
            for sid in range(14):
                for dn in locs.locations[sid]:
                    held.setdefault(dn.url, []).append(sid)
            assert sorted(len(v) for v in held.values()) == [3, 3, 4, 4], held
            victim_url = next(u for u, s in held.items() if len(s) == 4)
            victim = cluster.server_for(victim_url)
            vdir = victim.store.locations[0].directory
            lost = {sid: open(os.path.join(vdir, f"{vid}.ec{sid:02d}"), "rb").read()
                    for sid in held[victim_url]}
            await victim.stop()
            cluster.volume_servers.remove(victim)
            await cluster.wait_nodes(3)
            for fid, data in payloads.items():
                for vs in cluster.volume_servers:
                    assert await read_url(http, f"http://{vs.address}/{fid}") == data
            out = await run_command(env, "ec.rebuild")
        finally:
            await env.release_lock()
        line = next(ln for ln in out.splitlines() if ln.startswith(f"volume {vid}: rebuilt"))
        rebuilder = cluster.server_for(line.rsplit(" on ", 1)[1])
        rdir = rebuilder.store.locations[0].directory
        for sid, want in lost.items():
            with open(os.path.join(rdir, f"{vid}.ec{sid:02d}"), "rb") as f:
                assert f.read() == want, sid
        await cluster.wait_ec(vid)
        return True

    assert _run(body, n=4)(tmp_path)


def test_benchmark_smoke(tmp_path):
    """Mirror of test_shell.py::test_benchmark_smoke at -n 2000 -c 4."""
    from seaweedfs_tpu_torch.command.benchmark import fake_payload, run_benchmark

    assert fake_payload(7, 16) == (7).to_bytes(8, "big") * 2
    assert len(fake_payload(3, 100)) == 100

    async def body(cluster, http):
        stats = {}
        report = await run_benchmark(cluster.master.address, num_files=2000,
                                     file_size=512, concurrency=4, stats_out=stats)
        return report, stats

    report, stats = _run(body, n=1)(tmp_path)
    assert "Writing Benchmark" in report and "Randomly Reading Benchmark" in report
    assert "Requests per second" in report
    assert report.count("Failed requests:        0") == 2
    assert stats["write_failed"] == stats["read_failed"] == 0


def test_cli_server_volume_shell_and_benchmark(tmp_path):
    """`server` (master + volume in one process) and `volume -mserver` as
    processes on the CPU; `shell` runs one-shot commands and `benchmark`
    writes and reads through them; SIGTERM stops both with exit 0."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    mport, vport0, vport1 = _port_pair(), _port_pair(), _port_pair()
    maddr = f"127.0.0.1:{mport}"
    (tmp_path / "d0").mkdir()
    (tmp_path / "d1").mkdir()
    cmd = [sys.executable, "-m", "seaweedfs_tpu_torch"]
    procs = [
        subprocess.Popen(cmd + ["server", "-port", str(mport), "-volumePort", str(vport0),
                                "-dir", str(tmp_path / "d0"), "-storageBackend", "cpu",
                                "-pulseSeconds", "0.2"],
                         env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE),
        subprocess.Popen(cmd + ["volume", "-port", str(vport1), "-dir", str(tmp_path / "d1"),
                                "-mserver", maddr, "-storageBackend", "cpu",
                                "-pulseSeconds", "0.2"],
                         env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE),
    ]
    try:
        deadline = time.monotonic() + 30
        while True:
            try:
                out = subprocess.run(cmd + ["shell", "-master", maddr, "volume.list"],
                                     env=env, capture_output=True, text=True, timeout=30)
                if out.stdout.count("node 127.0.0.1:") == 2:
                    break
            except subprocess.TimeoutExpired:
                pass
            assert time.monotonic() < deadline, "the cluster did not come up"
            assert all(p.poll() is None for p in procs)
            time.sleep(0.2)
        bench = subprocess.run(cmd + ["benchmark", "-master", maddr, "-n", "300",
                                      "-size", "256", "-c", "4"],
                               env=env, capture_output=True, text=True, timeout=60)
        assert bench.returncode == 0, bench.stderr[-2000:]
        assert bench.stdout.count("Failed requests:        0") == 2, bench.stdout
        shell = subprocess.run(cmd + ["shell", "-master", maddr,
                                      "lock; volume.list; ec.decode -volumeId 1; "
                                      "volume.vacuum; unlock"],
                               env=env, capture_output=True, text=True, timeout=30)
        assert shell.returncode == 0
        # the benchmark deletes nothing: the sweep compacts no volume
        assert "locked" in shell.stdout and "vacuum: {'Result': []}" in shell.stdout
        # ec.decode is served: volume 1 is a normal volume, not an EC one
        assert "ec volume 1 not found" in shell.stdout
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        codes = [p.wait(timeout=30) for p in procs]
    assert codes == [0, 0]


def test_server_on_cuda_without_a_card_raises(tmp_path):
    """`server` defaults to -storageBackend cuda: with no card it raises
    before serving, and no host codec stands in."""
    import torch

    from seaweedfs_tpu_torch.command import cli

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["server", "-dir", str(tmp_path), "-port", str(_port_pair()),
                  "-volumePort", str(_port_pair())])
