"""The EC round trip in the port on the CPU, against the JAX package:
decode (write_dat_file, write_idx_file_from_ec_index, find_dat_file_size,
iterate_ecj_file, read_ec_volume_version), the batched rebuild
(rebuild_ec_files_multi: host, device and mesh routes), and in-process
clusters running ec.decode, a batched ec.rebuild, ec.balance over two
racks and VolumeEcShardsToVolume's refusals. Mirrors
test_erasure_coding.py (test_write_dat_file_full_scale_layout,
test_rebuild_and_decode_roundtrip) and test_repair_plane.py
(test_rebuild_multi_volume_batches, test_rebuild_multi_volume_mesh_leg).
Block sizes are shrunk (64 KiB large, 4 KiB small) where the decode
constants are patched in both packages alike; the full-scale test keeps
the real 1 GiB / 1 MiB geometry. Tolerance: exact equality."""

import asyncio
import os
import random
import shutil

import jax
import numpy as np
import pytest
import torch

from seaweedfs_tpu.parallel.sharded_ec import make_mesh as jax_make_mesh
from seaweedfs_tpu.shell import ec_common as jax_ec_common
from seaweedfs_tpu.storage.erasure_coding import encoder as jax_enc
from seaweedfs_tpu.storage.erasure_coding.coder_cpu import CpuRSCodec as JaxCpuRSCodec
from seaweedfs_tpu_torch.ops.rs_kernel import CudaRSCodec
from seaweedfs_tpu_torch.parallel import make_mesh
from seaweedfs_tpu_torch.pb import grpc_address
from seaweedfs_tpu_torch.pb.rpc import Stub
from seaweedfs_tpu_torch.storage.erasure_coding import EcVolume, to_ext
from seaweedfs_tpu_torch.storage.erasure_coding import encoder as enc
from seaweedfs_tpu_torch.storage.erasure_coding.coder_cpu import CpuRSCodec
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.storage.volume_info import VolumeInfo, save_volume_info
from test_torch_cluster import Cluster, _fill_volume, _run, _until

LARGE = 1 << 16
SMALL = 1 << 12
VID = 1


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _write_volume(d, n_needles: int, seed: int) -> dict:
    """Volume VID in `d` through the port's Volume -> {id: (cookie, data)}."""
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    v = Volume(str(d), "", VID, device="cpu")
    want = {}
    for i in range(1, n_needles + 1):
        data = rng.integers(0, 256, int(rng.integers(1, 12_000)), dtype=np.uint8).tobytes()
        cookie = int(rng.integers(1 << 32))
        v.write_needle(Needle(cookie=cookie, id=i, data=data))
        want[i] = (cookie, data)
    v.close()
    return want


def _encode(d, codec, **geometry) -> str:
    base = os.path.join(str(d), str(VID))
    enc.write_ec_files(base, codec=codec, **geometry)
    enc.write_sorted_file_from_idx(base)
    save_volume_info(base + ".vif", VolumeInfo(version=3))
    return base


@pytest.fixture
def shrunk(monkeypatch):
    """The decode's block constants shrunk in both packages alike."""
    for mod in (enc, jax_enc):
        monkeypatch.setattr(mod, "EC_LARGE_BLOCK_SIZE", LARGE)
        monkeypatch.setattr(mod, "EC_SMALL_BLOCK_SIZE", SMALL)
    return {"large_block_size": LARGE, "small_block_size": SMALL}


def test_write_dat_file_full_scale_layout(tmp_path):
    """A 3.5 MB payload through the real 1 GiB / 1 MiB layout (small
    blocks only at this size): encode, then write_dat_file in both
    packages gives the payload back."""
    base = str(tmp_path / "5")
    payload = np.random.default_rng(7).integers(0, 256, 3_500_000, dtype=np.uint8).tobytes()
    with open(base + ".dat", "wb") as f:
        f.write(payload)
    enc.write_ec_files(base, codec=CpuRSCodec())
    os.rename(base + ".dat", base + ".dat.orig")
    enc.write_dat_file(base, len(payload))
    assert _read(base + ".dat") == payload
    os.remove(base + ".dat")
    jax_enc.write_dat_file(base, len(payload))
    assert _read(base + ".dat") == payload


def test_rebuild_and_decode_roundtrip(tmp_path, shrunk):
    """Both block levels (2 large rows, then small ones): lose 4 shards,
    rebuild them on the plain kernel version, delete needles while EC
    (the last one written among them), decode; .dat and .idx equal the
    JAX decode's, the .dat is the original's first find_dat_file_size
    bytes, and the decoded volume reads back."""
    want = _write_volume(tmp_path / "p", 300, seed=2024)
    base = _encode(tmp_path / "p", CudaRSCodec(device="cpu"), **shrunk)
    original = _read(base + ".dat")
    assert len(original) > 2 * 10 * LARGE
    shards = {i: _read(base + to_ext(i)) for i in range(14)}
    for i in (0, 7, 10, 13):
        os.remove(base + to_ext(i))
    assert enc.rebuild_ec_files(base, codec=CudaRSCodec(device="cpu")) == [0, 7, 10, 13]
    for i in range(14):
        assert _read(base + to_ext(i)) == shards[i], i

    deleted = (5, 150, 300)  # 300: the needle at the end of the .dat
    with EcVolume(str(tmp_path / "p"), "", VID, device="cpu",
                  large_block_size=LARGE, small_block_size=SMALL) as ev:
        for nid in deleted:
            ev.delete_needle_from_ecx(nid)
    assert list(enc.iterate_ecj_file(base)) == list(jax_enc.iterate_ecj_file(base))
    assert list(enc.iterate_ecj_file(base)) == list(deleted)
    assert enc.read_ec_volume_version(base) == jax_enc.read_ec_volume_version(base) == 3
    dat_size = enc.find_dat_file_size(base)
    assert dat_size == jax_enc.find_dat_file_size(base)
    assert dat_size < len(original)  # the last needle is gone

    jdir = tmp_path / "j"
    shutil.copytree(tmp_path / "p", jdir)
    jbase = os.path.join(str(jdir), str(VID))
    for b in (base, jbase):
        os.remove(b + ".dat")
        os.remove(b + ".idx")
    enc.write_dat_file(base, dat_size)
    enc.write_idx_file_from_ec_index(base)
    jax_enc.write_dat_file(jbase, dat_size)
    jax_enc.write_idx_file_from_ec_index(jbase)
    assert _read(base + ".dat") == _read(jbase + ".dat") == original[:dat_size]
    assert _read(base + ".idx") == _read(jbase + ".idx")

    for ext in [to_ext(i) for i in range(14)] + [".ecx", ".ecj", ".vif"]:
        os.remove(base + ext)
    v = Volume(str(tmp_path / "p"), "", VID, create=False, device="cpu")
    try:
        for nid, (cookie, data) in want.items():
            if nid in deleted:
                with pytest.raises(Exception):
                    v.read_needle_by_key(nid)
                continue
            n = v.read_needle_by_key(nid)
            assert (n.cookie, bytes(n.data)) == (cookie, data), nid
    finally:
        v.close()


def test_idx_from_ec_index_appends_tombstones(tmp_path):
    want = _write_volume(tmp_path, 40, seed=5)
    base = _encode(tmp_path, CpuRSCodec(), large_block_size=LARGE, small_block_size=SMALL)
    with EcVolume(str(tmp_path), "", VID, device="cpu",
                  large_block_size=LARGE, small_block_size=SMALL) as ev:
        for nid in (3, 17, 40, 17):
            ev.delete_needle_from_ecx(nid)
    enc.write_idx_file_from_ec_index(base)
    mine = _read(base + ".idx")
    jax_enc.write_idx_file_from_ec_index(base)
    assert mine == _read(base + ".idx")
    assert len(mine) == 16 * (len(want) + 4)
    assert mine[:-64] == _read(base + ".ecx")


def _make_volume(d, size: int, seed: int):
    d.mkdir()
    base = str(d / "1")
    rng = np.random.default_rng(seed)
    with open(base + ".dat", "wb") as f:
        f.write(rng.integers(0, 256, size=size, dtype=np.uint8).tobytes())
    enc.write_ec_files(base, codec=CpuRSCodec(), large_block_size=LARGE,
                       small_block_size=SMALL)
    return base, {i: _read(base + to_ext(i)) for i in range(14)}


class _CountingCodec(CudaRSCodec):
    """The device codec's plain version, counting apply_matrix calls."""

    def __init__(self):
        super().__init__(device="cpu")
        self.calls = 0

    def apply_matrix(self, m, data):
        self.calls += 1
        return super().apply_matrix(m, data)


@pytest.mark.parametrize("route", ["device", "host"])
def test_rebuild_multi_volume_batches(tmp_path, route):
    """Three volumes, mixed loss patterns; the device route shares one
    dispatch per round between the two volumes that lost the same shards
    at the same width; every rebuilt shard equals the original and the
    JAX package's rebuild of the same files."""
    vols = [_make_volume(tmp_path / str(v), 300_000 + v * 4097, seed=v) for v in range(3)]
    losses = [[0, 13], [0, 13], [1, 2, 10, 11]]
    for (base, _o), missing in zip(vols, losses):
        for i in missing:
            os.remove(base + to_ext(i))
    jax_bases = []
    for base, _o in vols:
        jd = os.path.dirname(base) + "-jax"
        shutil.copytree(os.path.dirname(base), jd)
        jax_bases.append(os.path.join(jd, "1"))
    codec = _CountingCodec() if route == "device" else CpuRSCodec()
    res = enc.rebuild_ec_files_multi([b for b, _o in vols], codec=codec, chunk=32 * 1024)
    jres = jax_enc.rebuild_ec_files_multi(jax_bases, codec=JaxCpuRSCodec())
    for (base, originals), jbase, missing in zip(vols, jax_bases, losses):
        assert res[base] == missing == jres[jbase]
        for i in range(14):
            assert _read(base + to_ext(i)) == originals[i] == _read(jbase + to_ext(i))
        assert not any(f.endswith(".tmp") for f in os.listdir(os.path.dirname(base)))
    if route == "device":
        rounds = [-(-os.path.getsize(b + ".ec05") // (32 * 1024)) for b, _o in vols]
        # volumes 0 and 1 share each round they both reach; volume 2 alone
        assert codec.calls < sum(rounds)


def test_rebuild_multi_failure_leaves_no_outputs(tmp_path):
    base, _o = _make_volume(tmp_path / "0", 100_000, seed=3)
    for i in (0, 1, 2, 3, 4):
        os.remove(base + to_ext(i))
    with pytest.raises(ValueError, match="need at least 10 shards"):
        enc.rebuild_ec_files_multi([base], codec=CudaRSCodec(device="cpu"))
    assert sorted(os.listdir(tmp_path / "0")) == sorted(
        ["1.dat"] + [f"1{to_ext(i)}" for i in range(5, 14)])


def test_rebuild_multi_volume_mesh_leg(tmp_path):
    """rebuild_ec_files_multi(mesh=...) over 8 repeated CPU devices, its
    batches through sharded_reconstruct_padded, against the JAX package's
    mesh leg on its 8 virtual CPU devices."""
    vols = [_make_volume(tmp_path / str(v), 200_000 + 321 + v, seed=10 + v) for v in range(2)]
    jax_bases = []
    for base, _o in vols:
        for i in (1, 12):
            os.remove(base + to_ext(i))
        jd = os.path.dirname(base) + "-jax"
        shutil.copytree(os.path.dirname(base), jd)
        jax_bases.append(os.path.join(jd, "1"))
    mesh = make_mesh(devices=[torch.device("cpu")] * 8)
    res = enc.rebuild_ec_files_multi([b for b, _o in vols], codec=CpuRSCodec(),
                                     chunk=64 * 1024, mesh=mesh)
    jres = jax_enc.rebuild_ec_files_multi(
        jax_bases, codec=JaxCpuRSCodec(), chunk=64 * 1024,
        mesh=jax_make_mesh(devices=jax.devices("cpu")[:8]))
    for (base, originals), jbase in zip(vols, jax_bases):
        assert res[base] == [1, 12] == jres[jbase]
        for i in range(14):
            assert _read(base + to_ext(i)) == originals[i] == _read(jbase + to_ext(i))


# ---------------------------------------------------------------- clusters --
def _route(vs, method: str, calls: list):
    """Count the calls of one of a server's RPCs (its table holds the
    bound method, so the wrapper is registered in its place)."""
    key = f"/volume/{method}"
    kind, real = vs._rpc_server._routes[key]

    async def counted(req, context):
        calls.append((vs.address, sorted(req.get("volume_ids", [req.get("volume_id")]))))
        return await real(req, context)

    vs._rpc_server._routes[key] = (kind, counted)


async def _heartbeated(env, vids) -> None:
    async def known():
        nodes = await env.collect_data_nodes()
        have = {int(v["id"]) for dn in nodes for v in dn.get("volumes", [])}
        return set(vids) <= have

    await _until(known)


def test_shell_ec_decode_back_to_a_readable_volume(tmp_path):
    """ec.encode spreads a volume over three servers, 6 needles are
    deleted while it is EC, ec.decode turns it back into a normal volume
    on one server: every live needle reads through the normal path, the
    deleted ones answer 404, no server keeps a shard and the master
    forgets the EC volume."""
    from seaweedfs_tpu_torch.client import lookup
    from seaweedfs_tpu_torch.client.operation import read_url
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command

    async def body(cluster, http):
        rng = random.Random(6)
        vid, _source, payloads = await _fill_volume(
            cluster, http, 30, lambda i: rng.randrange(1, 40_000), 0xDEC000, rng)
        env = CommandEnv(cluster.master.address)
        await _heartbeated(env, [vid])
        try:
            assert await run_command(env, "lock") == "locked"
            out = await run_command(env, f"ec.encode -volumeId {vid}")
            assert f"volume {vid}: encoded" in out, out
            await cluster.wait_ec(vid)
            doomed = list(payloads)[::5]
            for fid in doomed:
                st, _ = await http.request("DELETE", cluster.volume_servers[0].address,
                                           "/" + fid)
                assert st == 202, fid
            out = await run_command(env, f"ec.decode -volumeId {vid}")
        finally:
            await env.release_lock()
        assert f"ec volume {vid} decoded back to a normal volume on" in out, out

        async def decoded():
            locs = await lookup(cluster.master.address, vid)
            return locs if locs and cluster.master.topo.lookup_ec_shards(vid) is None \
                else None

        locs = await _until(decoded)
        assert len(locs) == 1
        for fid, data in payloads.items():
            if fid in doomed:
                st, _ = await http.request("GET", locs[0], "/" + fid)
                assert st == 404, fid
            else:
                assert await read_url(http, f"http://{locs[0]}/{fid}") == data, fid
        for vs in cluster.volume_servers:
            d = vs.store.locations[0].directory
            assert not [f for f in os.listdir(d) if ".ec" in f], (vs.address, os.listdir(d))
            assert vs.store.find_ec_volume(vid) is None
        return True

    assert _run(body, n=3)(tmp_path)


def test_shell_ec_rebuild_batches_two_volumes_in_one_rpc(tmp_path):
    """Two volumes spread 4/4/3/3 alike over four servers; the server
    holding four shards of both stops; ec.rebuild sends the rebuilder ONE
    VolumeEcShardsRebuildBatch for both volumes and no per-volume
    VolumeEcShardsRebuild, and the lost shards come back byte for byte."""
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command

    async def body(cluster, http):
        rng = random.Random(7)
        servers = [vs.address for vs in cluster.volume_servers]
        shard_map = {s: list(range(4 * k, min(4 * k + 4, 14)))
                     for k, s in enumerate(servers)}
        shard_map[servers[3]] = [12, 13]
        shard_map[servers[2]] = [8, 9, 10, 11]
        vids, lost = [], {}
        from test_torch_cluster import _spread

        for tag in (0xB1000, 0xB2000):
            vid, source, _p = await _fill_volume(
                cluster, http, 12, lambda i: rng.randrange(1, 30_000), tag, rng)
            await _spread(cluster, vid, source, shard_map)
            vids.append(vid)
        victim = cluster.server_for(servers[0])
        vdir = victim.store.locations[0].directory
        for vid in vids:
            lost[vid] = {sid: _read(os.path.join(vdir, f"{vid}.ec{sid:02d}"))
                         for sid in shard_map[servers[0]]}
        await victim.stop()
        cluster.volume_servers.remove(victim)
        await cluster.wait_nodes(3)
        batch, single = [], []
        for vs in cluster.volume_servers:
            _route(vs, "VolumeEcShardsRebuildBatch", batch)
            _route(vs, "VolumeEcShardsRebuild", single)
        env = CommandEnv(cluster.master.address)
        try:
            assert await run_command(env, "lock") == "locked"
            out = await run_command(env, "ec.rebuild")
        finally:
            await env.release_lock()
        assert len(batch) == 1 and batch[0][1] == sorted(vids), (batch, out)
        assert single == [], single
        rebuilder = cluster.server_for(batch[0][0])
        rdir = rebuilder.store.locations[0].directory
        for vid in vids:
            assert f"volume {vid}: rebuilt shards" in out, out
            for sid, want in lost[vid].items():
                assert _read(os.path.join(rdir, f"{vid}.ec{sid:02d}")) == want
            await cluster.wait_ec(vid)
        assert not any(vs.device_errors for vs in cluster.volume_servers)
        return True

    assert _run(body, n=4)(tmp_path)


def test_shell_lock_release_waits_for_an_inflight_renewal():
    """A shell whose lease renewal is in flight when it releases the lock
    (the master has granted a new token, its answer is still on the way)
    releases the new token: the lock is free at once, not a lease later."""
    from seaweedfs_tpu_torch.shell import CommandEnv

    class Master:
        """The master's lease logic; a renewal's answer arrives late."""

        def __init__(self):
            self.token = None
            self.in_flight = asyncio.Event()

        async def call(self, method, req, **kw):
            prev = int(req.get("previous_token", 0))
            if method == "ReleaseAdminToken":
                if self.token == prev:
                    self.token = None
                return {}
            if self.token is not None and self.token != prev:
                return {"error": "already locked"}
            self.token = (self.token or 0) + 1
            if prev:  # a renewal: granted now, answered later
                self.in_flight.set()
                await asyncio.sleep(0.2)
            return {"token": self.token}

    async def main():
        env = CommandEnv("127.0.0.1:1", renew_interval=0.01)
        env.master_stub = master = Master()
        await env.acquire_lock()
        await asyncio.wait_for(master.in_flight.wait(), 5)
        await env.release_lock()
        return master.token

    assert asyncio.run(main()) is None


class _RackCluster(Cluster):
    """Volume servers on racks "r0", "r0", "r1", "r1"."""

    async def start(self) -> None:
        from seaweedfs_tpu_torch.server.master import MasterServer
        from seaweedfs_tpu_torch.server.volume import VolumeServer
        from test_torch_cluster import _port_pair

        self.master = MasterServer(port=_port_pair())
        await self.master.start()
        for i in range(self.n):
            d = self.tmp_path / f"vol{i}"
            d.mkdir(exist_ok=True)
            vs = VolumeServer(
                [str(d)], master=self.master.address, port=_port_pair(),
                pulse_seconds=0.2, max_volume_counts=[20], codec_backend="cpu",
                rack=f"r{i // 2}",
            )
            await vs.start()
            self.volume_servers.append(vs)
        await self.wait_nodes(self.n)


def test_shell_ec_balance_over_two_racks_matches_jax_plans(tmp_path):
    """A volume's 14 shards held 9 on rack r0 (shard 4 on both of its
    servers) and 5 on rack r1: the port's plan_dedupe and
    plan_rack_balance equal the JAX package's on the same topology,
    ec.balance carries the plan out, and the shards end up 7/7 across the
    racks with no duplicate."""
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command
    from seaweedfs_tpu_torch.shell.ec_common import (
        nodes_from_topology,
        plan_dedupe,
        plan_rack_balance,
    )
    from test_torch_cluster import _spread

    async def body(cluster, http):
        rng = random.Random(8)
        servers = [vs.address for vs in cluster.volume_servers]
        shard_map = {servers[0]: [0, 1, 2, 3, 4], servers[1]: [5, 6, 7, 8, 4],
                     servers[2]: [9, 10, 11], servers[3]: [12, 13]}
        vid, source, payloads = await _fill_volume(
            cluster, http, 10, lambda i: rng.randrange(1, 20_000), 0xBA1000, rng)
        await _spread(cluster, vid, source, shard_map)
        env = CommandEnv(cluster.master.address)

        async def known():
            nodes = nodes_from_topology(await env.collect_data_nodes())
            return sum(n.shards[vid].count() for n in nodes if vid in n.shards) == 15

        await _until(known)
        dns = await env.collect_data_nodes()
        mine = nodes_from_topology(dns)
        ref = jax_ec_common.nodes_from_topology(dns)
        dedupe = plan_dedupe(mine, vid)
        assert dedupe == jax_ec_common.plan_dedupe(ref, vid)
        moves = plan_rack_balance(mine, vid)
        assert [tuple(vars(m).values()) for m in moves] == [
            (m.vid, m.shard_id, m.source, m.target)
            for m in jax_ec_common.plan_rack_balance(ref, vid)]
        assert moves, "the plan moves nothing"
        try:
            assert await run_command(env, "lock") == "locked"
            out = await run_command(env, "ec.balance")
        finally:
            await env.release_lock()
        assert out.count("moved shard") == len(moves), out
        assert out.count("dropped duplicate") == len(dedupe) == 1, out

        async def balanced():
            nodes = nodes_from_topology(await env.collect_data_nodes())
            per_rack = {}
            for n in nodes:
                if vid in n.shards:
                    per_rack[n.rack] = per_rack.get(n.rack, 0) + n.shards[vid].count()
            return per_rack if sum(per_rack.values()) == 14 else None

        per_rack = await _until(balanced)
        assert per_rack == {"r0": 7, "r1": 7}, per_rack
        http_reads = 0
        for fid, data in payloads.items():
            st, got = await http.request("GET", servers[2], "/" + fid)
            http_reads += (st, got) == (200, data)
        return http_reads == len(payloads)

    async def main(tmp_path):
        from seaweedfs_tpu_torch.util.fasthttp import FastHTTPClient

        cluster = _RackCluster(tmp_path, n_volume_servers=4)
        http = FastHTTPClient()
        try:
            await cluster.start()
            return await body(cluster, http)
        finally:
            await http.close()
            await cluster.stop()

    assert asyncio.run(asyncio.wait_for(main(tmp_path), 40))


def test_shards_to_volume_refuses_without_every_data_shard(tmp_path):
    """VolumeEcShardsToVolume answers an error, and writes no .dat, while
    a data shard is not local; `plane` requests answer not ported; with
    every data shard back it decodes."""
    async def body(cluster, http):
        rng = random.Random(9)
        vid, source, _p = await _fill_volume(
            cluster, http, 8, lambda i: rng.randrange(1, 9_000), 0x70000, rng)
        stub = Stub(grpc_address(source), "volume")
        await stub.call("VolumeMarkReadonly", {"volume_id": vid})
        assert not (await stub.call("VolumeEcShardsGenerate", {"volume_id": vid}))
        await stub.call("VolumeUnmount", {"volume_id": vid})
        d = cluster.volume_servers[0].store.locations[0].directory
        base = os.path.join(d, str(vid))
        os.remove(base + ".dat")
        os.rename(base + to_ext(3), base + ".ec03.aside")
        r1 = await stub.call("VolumeEcShardsToVolume", {"volume_id": vid})
        no_dat = not os.path.exists(base + ".dat")
        r2 = await stub.call("VolumeEcShardsToVolume", {"volume_id": vid, "plane": "lifecycle"})
        r3 = await stub.call("VolumeEcShardsToVolume", {"volume_id": vid + 99})
        os.rename(base + ".ec03.aside", base + to_ext(3))
        r4 = await stub.call("VolumeEcShardsToVolume", {"volume_id": vid})
        return r1, no_dat, r2, r3, r4, os.path.exists(base + ".dat"), vid

    r1, no_dat, r2, r3, r4, dat_back, vid = _run(body, n=1)(tmp_path)
    assert r1 == {"error": "need all data shards locally to decode, missing [3]"}
    assert no_dat
    assert r2 == {"error": "not ported: plane"}
    assert r3 == {"error": f"ec volume {vid + 99} not found"}
    assert r4 == {} and dat_back
