"""The port's anti-entropy plane against the JAX package's, on the CPU:

- `digest_fold` (an empty set, keys at 2^64 - 1) and `content_digest` on
  the same volume files; digests equal iff live contents are equal over
  a seeded history of appends and deletes on two replicas;
- `scrub_volume` on a needle bitflipped through each package's write
  seam: the same reports, quarantine and `.scrub` cursor files, each
  package resuming from the other's cursor;
- `scrub_ec_volume` over the same seeded shards (the port's codec is
  B1's plain version, `CudaRSCodec(device="cpu")`) with a data byte and
  then a parity byte flipped, all parity local and two parity shards
  local: the same `corrupt_shards`;
- the planners `plan_ec_repairs`, `plan_replica_repairs`,
  `find_unresolved_divergence`, `plan_replica_spread`,
  `plan_ec_domain_spread` and the shell's `plan_replication_fixes` on 200
  seeded topologies;
- `incremental_changes` and `apply_incremental`: byte-identical tails and
  replayed files;
- self-healing on the port's in-process cluster
  (tests/test_scrub_repair.py::test_cluster_self_healing_end_to_end),
  driven by the shell's `volume.scrub` and `ec.repair.status -run`: a
  needle bitflipped on one holder of a replicated volume is re-copied,
  a flipped EC shard is quarantined and rebuilt through
  VolumeEcShardsRebuildBatch, then a stopped shard holder's shards are
  rebuilt on a survivor, every shard byte-identical to before, the
  queue drains to 0 and a second scrub is clean; with the background
  scrub and the master's repair loop on, the same heal without the
  shell; VolumeRepairCopy's rollback, volume.copy, volume.move and
  volume.fix.replication.

Inputs come from numpy seeds; tolerance: exact."""

import asyncio
import os
import random
import shutil
import time

import numpy as np
import pytest

from seaweedfs_tpu.storage import scrub as jax_scrub
from seaweedfs_tpu.storage.needle import Needle as JaxNeedle
from seaweedfs_tpu.storage.volume import Volume as JaxVolume
from seaweedfs_tpu.storage.volume import digest_fold as jax_digest_fold
from seaweedfs_tpu.types import NEEDLE_HEADER_SIZE
from seaweedfs_tpu.util import faults as jf
from seaweedfs_tpu_torch.storage import scrub
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume, digest_fold
from seaweedfs_tpu_torch.util import faults as pf

U64_MAX = (1 << 64) - 1


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    jf.clear_plan()
    pf.clear_plan()
    yield
    jf.clear_plan()
    pf.clear_plan()


# ------------------------------------------------------------- digests --


def test_digest_fold_equals_jax():
    rng = np.random.default_rng(1)
    cases = [
        (np.array([], dtype=np.uint64), np.array([], dtype=np.uint64)),
        (np.array([U64_MAX], dtype=np.uint64), np.array([U64_MAX >> 32], dtype=np.uint64)),
        (np.array([0, 1, U64_MAX, U64_MAX - 1], dtype=np.uint64),
         np.array([0, 7, 1, 2], dtype=np.uint64)),
    ]
    for n in (1, 5, 1000):
        cases.append((rng.integers(0, U64_MAX, n, dtype=np.uint64, endpoint=True),
                      rng.integers(0, 1 << 32, n, dtype=np.uint64)))
    for keys, sizes in cases:
        got = digest_fold(keys, sizes)
        assert got == jax_digest_fold(keys, sizes)
        perm = rng.permutation(len(keys))
        assert digest_fold(keys[perm], sizes[perm]) == got
    assert digest_fold([], []) == 0


def test_content_digest_equals_jax_and_tracks_live_content(tmp_path):
    """Seeded interleaved appends/deletes on two replicas: after every
    round the digests are equal iff the live content sets are, and the
    JAX package's digest of the same files is the port's."""
    rng = np.random.default_rng(0xD16E57)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    va, vb = Volume(str(tmp_path / "a"), "", 1), Volume(str(tmp_path / "b"), "", 1)
    live_a, live_b = {}, {}
    for _round in range(60):
        op, key, size = rng.random(), int(rng.integers(1, 20)), int(rng.integers(1, 400))
        targets = [(va, live_a), (vb, live_b)]
        if rng.random() >= 0.7:
            targets = [targets[int(rng.integers(0, 2))]]
        for v, live in targets:
            if op < 0.75:
                v.write_needle(Needle(cookie=key, id=key, data=bytes([key]) * size))
                live[key] = size
            elif key in live:
                v.delete_needle(Needle(id=key, cookie=key))
                live.pop(key)
        assert (live_a == live_b) == (va.content_digest() == vb.content_digest())
    digests = (va.content_digest(), vb.content_digest())
    va.close()
    vb.close()
    for sub, want in zip("ab", digests):
        jv = JaxVolume(str(tmp_path / sub), "", 1, create=False)
        assert jv.content_digest() == want
        jv.close()


# --------------------------------------------------------------- scrub --


def _write_with_flip(mod, vcls, ncls, d: str, n: int, seed: int) -> int:
    """n needles, then one more whose data region gets 3 bits flipped by
    the package's own write seam; returns the victim's key."""
    v = vcls(d, "", 1)
    rng = np.random.default_rng(seed)
    for i in range(1, n + 1):
        v.write_needle(ncls(cookie=i, id=i,
                            data=rng.integers(0, 256, 300 + i, dtype=np.uint8).tobytes()))
    at = v.data_file_size() + NEEDLE_HEADER_SIZE + 7
    mod.install_plan(mod.FaultPlan(seed=11, rules=[mod.FaultRule(
        op="write_at", target="*.dat", nth=1, fault="bitflip", at_offset=at, bits=3)]))
    v.write_needle(ncls(cookie=5, id=n // 2 * 2 + 1000, data=b"victim" * 50))
    mod.clear_plan()
    v.close()
    return n // 2 * 2 + 1000


def _report(r: dict) -> dict:
    return {**r, "corruptions": [(k, kind) for k, kind, _d in r["corruptions"]]}


def test_scrub_volume_reports_and_cursors_equal_jax(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    _write_with_flip(jf, JaxVolume, JaxNeedle, str(tmp_path / "j"), 9, 4)
    victim = _write_with_flip(pf, Volume, Needle, str(tmp_path / "p"), 9, 4)
    jv = JaxVolume(str(tmp_path / "j"), "", 1, create=False)
    pv = Volume(str(tmp_path / "p"), "", 1, create=False)
    # a time-sliced first pass: the same partial reports and cursor files
    rj = jax_scrub.scrub_volume(jv, max_entries=4)
    rp = scrub.scrub_volume(pv, max_entries=4)
    assert _report(rp) == _report(rj) and not rp["completed"]
    cj, cp = jv.file_name() + ".scrub", pv.file_name() + ".scrub"
    with open(cj) as f1, open(cp) as f2:
        assert f1.read() == f2.read()
    # each package resumes from the other's cursor
    os.replace(cj, cj + ".mine")
    shutil.copy(cp, cj)
    shutil.copy(cj + ".mine", cp)
    rj = jax_scrub.scrub_volume(jv)
    rp = scrub.scrub_volume(pv)
    assert _report(rp) == _report(rj)
    assert rp["completed"] and [(k, kind) for k, kind, _ in rp["corruptions"]] == [
        (victim, "needle_crc")]
    assert pv.scrub_corrupt and pv.is_read_only() and jv.scrub_corrupt
    assert scrub.load_cursor(pv.file_name()) == jax_scrub.load_cursor(jv.file_name())
    jv.close()
    pv.close()


def _ec_pair(tmp_path, n: int = 40):
    """The same EC volume (JAX-encoded) in two directories."""
    from seaweedfs_tpu.storage.erasure_coding import write_ec_files
    from seaweedfs_tpu.tpu.coder import get_codec

    d = tmp_path / "j"
    d.mkdir()
    v = JaxVolume(str(d), "", 2)
    rng = np.random.default_rng(7)
    for i in range(1, n):
        v.write_needle(JaxNeedle(cookie=i, id=i, data=rng.integers(
            0, 256, int(rng.integers(500, 3000)), dtype=np.uint8).tobytes()))
    v.close()
    jcodec = get_codec("cpu")
    write_ec_files(os.path.join(str(d), "2"), codec=jcodec)
    shutil.copytree(d, tmp_path / "p")
    return os.path.join(str(d), "2"), os.path.join(str(tmp_path / "p"), "2"), jcodec


def _flip(path: str, offset: int, mask: int = 0x40) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ mask]))


@pytest.mark.parametrize("parity_local", [4, 2])
def test_scrub_ec_volume_names_the_same_shards_as_jax(tmp_path, parity_local):
    from seaweedfs_tpu_torch.ops.rs_kernel import CudaRSCodec
    from seaweedfs_tpu_torch.storage.erasure_coding import to_ext

    jbase, pbase, jcodec = _ec_pair(tmp_path)
    for base in (jbase, pbase):
        for s in range(10 + parity_local, 14):
            os.remove(base + to_ext(s))
    codec = CudaRSCodec(device="cpu")  # B1's plain version
    chunk = 1 << 16
    size = os.path.getsize(pbase + to_ext(0))
    rng = np.random.default_rng(parity_local)

    def both():
        want = jax_scrub.scrub_ec_volume(jbase, jcodec, chunk=chunk)
        got = scrub.scrub_ec_volume(pbase, codec, chunk=chunk)
        assert {k: v for k, v in got.items() if k != "base"} == {
            k: v for k, v in want.items() if k != "base"}
        return got

    assert both()["corrupt_shards"] == []
    for shard in (int(rng.integers(0, 10)), 10 + int(rng.integers(0, parity_local))):
        off = int(rng.integers(chunk, size))  # past the first chunk
        for base in (jbase, pbase):
            _flip(base + to_ext(shard), off)
        r = both()
        assert r["corrupt_shards"] == [shard] and not r["unidentified"]
        for base in (jbase, pbase):
            _flip(base + to_ext(shard), off)  # restore


# ------------------------------------------------------------ planners --

NODES = [f"10.0.0.{i}:8080" for i in range(8)]


def _topology(rng) -> dict:
    ec = []
    for vid in range(int(rng.integers(0, 5))):
        total = 14
        holders = {}
        for sid in range(total):
            if rng.random() < 0.85:
                holders[sid] = [NODES[int(i)] for i in
                                rng.choice(len(NODES), int(rng.integers(1, 3)), replace=False)]
        st = {"vid": vid + 1, "collection": ["", "c"][int(rng.integers(0, 2))],
              "total_shards": total, "holders": holders}
        if rng.random() < 0.3:
            st["parity_shards"] = int(rng.integers(1, 5))
        ec.append(st)
    replicas = {}
    for vid in range(10, 10 + int(rng.integers(0, 6))):
        n = int(rng.integers(1, 4))
        replicas[vid] = [{
            "url": NODES[int(i)], "collection": "",
            "content_digest": int(rng.integers(0, 3)),
            "append_at_ns": int(rng.integers(0, 3)),
            "scrub_corrupt": bool(rng.random() < 0.25),
            "read_only": bool(rng.random() < 0.2),
        } for i in rng.choice(len(NODES), n, replace=False)]
    dcs = ["dc1", "dc2"][: int(rng.integers(1, 3))]
    domain = {u: (dcs[int(rng.integers(0, len(dcs)))], f"r{int(rng.integers(0, 3))}")
              for u in NODES}
    candidates = [{"url": u, "dc": domain[u][0], "rack": domain[u][1],
                   "free": int(rng.integers(0, 4))} for u in NODES]
    placement = []
    for vid in range(20, 20 + int(rng.integers(0, 5))):
        rp = ["000", "001", "010", "100", "011", "110", "200"][int(rng.integers(0, 7))]
        placement.append({
            "vid": vid, "collection": "", "replica_placement": int(rp),
            "holders": [{"url": NODES[int(i)], "dc": domain[NODES[int(i)]][0],
                         "rack": domain[NODES[int(i)]][1]}
                        for i in rng.choice(len(NODES), int(rng.integers(1, 4)),
                                            replace=False)],
        })
    nodes = [{"url": u, "free_space": c["free"], "volumes": [
        {"id": vid, "replica_placement": int(["001", "010", "000"][vid % 3]),
         "collection": ""}
        for vid in range(30, 36) if rng.random() < 0.4]} for u, c in zip(NODES, candidates)]
    return {"ec": ec, "replicas": replicas, "candidates": candidates,
            "placement": placement, "nodes": nodes}


def _tasks(tasks) -> list:
    return [t.to_info() for t in tasks]


def test_planners_equal_jax_on_seeded_topologies():
    from seaweedfs_tpu.shell.commands import plan_replication_fixes as jax_fixes
    from seaweedfs_tpu.topology import placement as jpl
    from seaweedfs_tpu.topology import repair as jrep
    from seaweedfs_tpu_torch.shell.commands import plan_replication_fixes
    from seaweedfs_tpu_torch.topology import placement as ppl
    from seaweedfs_tpu_torch.topology import repair as prep

    rng = np.random.default_rng(200)
    seen = set()
    for _ in range(200):
        t = _topology(rng)
        got = _tasks(prep.plan_ec_repairs(t["ec"]))
        assert got == _tasks(jrep.plan_ec_repairs(t["ec"]))
        got += _tasks(prep.plan_replica_repairs(t["replicas"]))
        assert got[len(got) - len(_tasks(jrep.plan_replica_repairs(t["replicas"]))):] == \
            _tasks(jrep.plan_replica_repairs(t["replicas"]))
        assert prep.find_unresolved_divergence(t["replicas"]) == \
            jrep.find_unresolved_divergence(t["replicas"])
        v1, t1 = ppl.plan_replica_spread(t["placement"], t["candidates"])
        v2, t2 = jpl.plan_replica_spread(t["placement"], t["candidates"])
        assert (v1, _tasks(t1)) == (v2, _tasks(t2))
        v1, t1 = ppl.plan_ec_domain_spread(t["ec"], t["candidates"])
        v2, t2 = jpl.plan_ec_domain_spread(t["ec"], t["candidates"])
        assert (v1, _tasks(t1)) == (v2, _tasks(t2))
        assert plan_replication_fixes(t["nodes"]) == jax_fixes(t["nodes"])
        seen.update(x["kind"] for x in got + _tasks(t1))
    assert seen >= {"ec_rebuild", "replica_recopy", "tail_sync", "ec_placement"}


# ---------------------------------------------------- incremental copy --


def test_incremental_copy_equals_jax(tmp_path):
    from seaweedfs_tpu.storage import volume_backup as jvb
    from seaweedfs_tpu_torch.storage import volume_backup as pvb

    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    va, vb = JaxVolume(str(tmp_path / "a"), "", 1), JaxVolume(str(tmp_path / "b"), "", 1)
    rng = np.random.default_rng(5)
    for i in range(1, 6):
        data = rng.integers(0, 256, 120 + i, dtype=np.uint8).tobytes()
        for v in (va, vb):
            v.write_needle(JaxNeedle(cookie=i, id=i, data=data))
    for i in range(6, 10):  # b goes dark; a keeps writing and deletes one
        va.write_needle(JaxNeedle(cookie=i, id=i, data=bytes([i]) * 120))
    va.delete_needle(JaxNeedle(id=2, cookie=2))
    va.close()
    vb.close()
    for sub in "ab":
        shutil.copytree(tmp_path / sub, tmp_path / f"{sub}2")
    ja, jb = JaxVolume(str(tmp_path / "a"), "", 1, create=False), \
        JaxVolume(str(tmp_path / "b"), "", 1, create=False)
    pa, pb = Volume(str(tmp_path / "a2"), "", 1, create=False), \
        Volume(str(tmp_path / "b2"), "", 1, create=False)
    assert pvb.binary_search_append_at_ns(pa, pb.last_append_at_ns) == \
        jvb.binary_search_append_at_ns(ja, jb.last_append_at_ns)
    blob = b"".join(pvb.incremental_changes(pa, pb.last_append_at_ns, chunk=64))
    assert blob == b"".join(jvb.incremental_changes(ja, jb.last_append_at_ns))
    assert pvb.apply_incremental(pb, blob) == jvb.apply_incremental(jb, blob) == 5
    assert pa.content_digest() == pb.content_digest() == jb.content_digest()
    for v in (ja, jb, pa, pb):
        v.close()
    for ext in (".dat", ".idx"):
        with open(tmp_path / "b" / f"1{ext}", "rb") as f1, \
                open(tmp_path / "b2" / f"1{ext}", "rb") as f2:
            assert f1.read() == f2.read()


# ---------------------------------------------------------- the cluster --


async def _wait_for(predicate, what: str, timeout: float = 15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        await asyncio.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


async def _heal(master, done, what: str, env=None, rounds: int = 60) -> list:
    """`ec.repair.status -run` rounds until `done()`; every round's
    output must be free of errors. Returns the outputs."""
    from seaweedfs_tpu_torch.shell.commands import run_command

    outs = []
    for _ in range(rounds):
        out = await run_command(env, "ec.repair.status -run")
        assert "ERROR" not in out, out
        outs.append(out)
        if done() and "queue depth: 0" in out.splitlines()[0]:
            return outs
        await asyncio.sleep(0.2)
    raise AssertionError(f"repair never converged: {what}: {outs[-1]} {master.repair_log[-2:]}")


def test_cluster_self_healing_end_to_end(tmp_path):
    from test_torch_cluster import Cluster, assign_retry

    from seaweedfs_tpu_torch.client.operation import read_url, upload_data
    from seaweedfs_tpu_torch.pb import grpc_address
    from seaweedfs_tpu_torch.pb.rpc import Stub
    from seaweedfs_tpu_torch.shell import CommandEnv
    from seaweedfs_tpu_torch.shell.commands import run_command
    from seaweedfs_tpu_torch.storage.erasure_coding import to_ext
    from seaweedfs_tpu_torch.storage.file_id import format_needle_id_cookie
    from seaweedfs_tpu_torch.util.fasthttp import FastHTTPClient
    from seaweedfs_tpu_torch.util.metrics import REPAIR_QUEUE_DEPTH

    async def body():
        cluster = Cluster(tmp_path, n_volume_servers=4)
        http = FastHTTPClient()
        await cluster.start()
        master = cluster.master
        env = CommandEnv(master.address)
        try:
            # ---- a replicated volume, one holder's copy bitflipped ----
            ar = await assign_retry(master.address, replication="001")
            vid = int(ar.fid.split(",")[0])
            good = random.Random(1).randbytes(900)
            await upload_data(http, ar.url, ar.fid, good)
            await _wait_for(lambda: len(master.topo.replica_states().get(vid, [])) == 2,
                            "2 replicas registered")
            holders = [r["url"] for r in master.topo.replica_states()[vid]]
            target_url = holders[0]
            tv = cluster.server_for(target_url).store.find_volume(vid)
            at = tv.data_file_size() + NEEDLE_HEADER_SIZE + 16
            pf.install_plan(pf.FaultPlan(seed=0x5CAB, rules=[pf.FaultRule(
                op="write_at", target=tv.file_name() + ".dat", nth=1,
                fault="bitflip", at_offset=at, bits=3)]))
            victim = random.Random(2).randbytes(800)
            vfid = f"{vid},{format_needle_id_cookie(0x77, 0xC0FFEE)}"
            await upload_data(http, ar.url, vfid, victim)
            assert pf.current_plan().fired() == 1
            pf.clear_plan()

            # ---- an EC volume on one server: 12 shards, 12/13 elsewhere ----
            ar3 = await assign_retry(master.address)
            evid = int(ar3.fid.split(",")[0])
            while evid == vid:
                ar3 = await assign_retry(master.address)
                evid = int(ar3.fid.split(",")[0])
            ec_payloads = {}
            for i in range(1, 25):
                fid = f"{evid},{format_needle_id_cookie(i, 0xAB00 + i)}"
                data = random.Random(i).randbytes(1500 + 13 * i)
                await upload_data(http, ar3.url, fid, data)
                ec_payloads[fid] = data
            src = Stub(grpc_address(ar3.url), "volume")
            await src.call("VolumeMarkReadonly", {"volume_id": evid})
            assert not (await src.call("VolumeEcShardsGenerate", {"volume_id": evid},
                                       timeout=60)).get("error")
            assert not (await src.call("VolumeEcShardsMount", {
                "volume_id": evid, "shard_ids": list(range(14))})).get("error")
            await src.call("VolumeUnmount", {"volume_id": evid})
            await src.call("VolumeDelete", {"volume_id": evid})
            outpost = next(vs.address for vs in cluster.volume_servers
                           if vs.address not in holders + [ar3.url])
            ostub = Stub(grpc_address(outpost), "volume")
            assert not (await ostub.call("VolumeEcShardsCopy", {
                "volume_id": evid, "shard_ids": [12, 13], "copy_ecx_file": True,
                "source_data_node": ar3.url}, timeout=60)).get("error")
            await ostub.call("VolumeEcShardsMount", {"volume_id": evid,
                                                     "shard_ids": [12, 13]})
            await src.call("VolumeEcShardsUnmount", {"volume_id": evid,
                                                     "shard_ids": [12, 13]})
            await src.call("VolumeEcShardsDelete", {"volume_id": evid,
                                                    "shard_ids": [12, 13]})

            def ec_locs():
                locs = master.topo.lookup_ec_shards(evid)
                return [] if locs is None else [
                    sorted(dn.url for dn in locs.locations[s]) for s in range(14)]

            await _wait_for(lambda: ec_locs() == [[ar3.url]] * 12 + [[outpost]] * 2,
                            "the EC layout registered")

            # ---- the shell's scrub finds the bitflipped needle; the
            # scheduler re-copies the replica ----
            out = await run_command(env, f"volume.scrub -volumeId {vid}")
            assert out.count("CORRUPT key") == 1 and "needle_crc" in out, out
            assert f"{target_url}: QUARANTINED volume of volume {vid}" in out, out
            await _wait_for(lambda: any(
                r["scrub_corrupt"] for r in master.topo.replica_states().get(vid, [])),
                "scrub_corrupt at the master")
            outs = await _heal(master, lambda: not any(
                r["scrub_corrupt"] for r in master.topo.replica_states().get(vid, [])),
                "recopy", env)
            assert f"recent replica_recopy volume {vid}: repaired" in "\n".join(outs)
            assert await read_url(http, f"http://{target_url}/{vfid}") == victim
            assert await read_url(http, f"http://{target_url}/{ar.fid}") == good

            # ---- a flipped shard: quarantined, rebuilt byte-identical;
            # the survivors pulled for it (12, 13) leave the rebuilder ----
            ec_base = cluster.server_for(ar3.url).store.find_ec_volume(evid).file_name()
            pristine = {}
            for sid, base in [(s, ec_base) for s in range(12)] + [
                    (s, cluster.server_for(outpost).store.find_ec_volume(evid).file_name())
                    for s in (12, 13)]:
                with open(base + to_ext(sid), "rb") as f:
                    pristine[sid] = f.read()
            shard_path = ec_base + to_ext(4)
            _flip(shard_path, random.Random(0xEC5EED).randrange(len(pristine[4])))
            out = await run_command(env, f"volume.scrub -volumeId {evid}")
            assert f"{ar3.url} ec volume {evid}:" in out and "corrupt shards [4]" in out, out
            assert f"QUARANTINED shard 4 of volume {evid}" in out, out
            assert os.path.exists(shard_path + ".bad")
            await _wait_for(lambda: ec_locs()[4] == [], "shard 4 unregistered")
            await _heal(master, lambda: ec_locs() == [[ar3.url]] * 12 + [[outpost]] * 2,
                        "rebuild", env)
            with open(shard_path, "rb") as f:
                assert f.read() == pristine[4]
            assert not any(os.path.exists(ec_base + to_ext(s)) for s in (12, 13))

            # ---- then a lost shard holder: its shards rebuilt on a survivor ----
            master.repair_grace_seconds = 1.0
            lost = cluster.server_for(outpost)
            await lost.stop()
            cluster.volume_servers.remove(lost)
            await _wait_for(lambda: ec_locs()[12] == [] and ec_locs()[13] == [],
                            "the lost holder's shards unregistered")
            outs = await _heal(master, lambda: ec_locs() == [[ar3.url]] * 14,
                               "node loss", env)
            assert f"recent ec_rebuild volume {evid}: repaired" in "\n".join(outs)
            for sid, data in pristine.items():
                with open(ec_base + to_ext(sid), "rb") as f:
                    assert f.read() == data, sid
            for fid, data in ec_payloads.items():
                assert await read_url(http, f"http://{ar3.url}/{fid}") == data
            assert REPAIR_QUEUE_DEPTH.value() == 0.0

            # ---- second scrubs are clean ----
            out = await run_command(env, f"volume.scrub -volumeId {vid}")
            assert "CORRUPT" not in out and out.count(" 0 corruption(s)") == 2, out
            out = await run_command(env, f"volume.scrub -volumeId {evid}")
            assert "corrupt shards []" in out and "QUARANTINED" not in out, out
        finally:
            pf.clear_plan()
            await http.close()
            await cluster.stop()

    asyncio.run(asyncio.wait_for(body(), 90))


def test_background_scrub_and_repair_loop_heal_without_the_shell(tmp_path, monkeypatch):
    """SEAWEEDFS_TPU_SCRUB_MBPS / SEAWEEDFS_TPU_SCRUB_INTERVAL start each
    volume server's background scrub and SEAWEEDFS_TPU_AUTO_REPAIR the
    master's repair loop: a needle bitflipped on one holder of a
    replicated volume is found, quarantined and re-copied with no shell
    command, and the passes after the recopy stay clean."""
    from test_torch_cluster import Cluster, assign_retry

    from seaweedfs_tpu_torch.client.operation import read_url, upload_data
    from seaweedfs_tpu_torch.server import master as master_mod
    from seaweedfs_tpu_torch.storage.file_id import format_needle_id_cookie
    from seaweedfs_tpu_torch.util.fasthttp import FastHTTPClient

    monkeypatch.setenv("SEAWEEDFS_TPU_SCRUB_MBPS", "50")
    monkeypatch.setenv("SEAWEEDFS_TPU_SCRUB_INTERVAL", "0.2")
    monkeypatch.setenv("SEAWEEDFS_TPU_AUTO_REPAIR", "1")
    monkeypatch.setattr(master_mod, "REPAIR_SCAN_SECONDS", 0.2)

    async def body():
        cluster = Cluster(tmp_path, n_volume_servers=2)
        http = FastHTTPClient()
        await cluster.start()
        master = cluster.master
        try:
            assert master.auto_repair
            assert all(vs.scrub_mbps == 50 for vs in cluster.volume_servers)
            ar = await assign_retry(master.address, replication="001")
            vid = int(ar.fid.split(",")[0])
            good = random.Random(4).randbytes(700)
            await upload_data(http, ar.url, ar.fid, good)
            await _wait_for(lambda: len(master.topo.replica_states().get(vid, [])) == 2,
                            "2 replicas registered")
            target_url = master.topo.replica_states()[vid][0]["url"]
            tv = cluster.server_for(target_url).store.find_volume(vid)
            pf.install_plan(pf.FaultPlan(seed=0x100B, rules=[pf.FaultRule(
                op="write_at", target=tv.file_name() + ".dat", nth=1,
                fault="bitflip", at_offset=tv.data_file_size() + NEEDLE_HEADER_SIZE + 8,
                bits=2)]))
            victim = random.Random(5).randbytes(500)
            vfid = f"{vid},{format_needle_id_cookie(0x55, 0xBEEF)}"
            await upload_data(http, ar.url, vfid, victim)
            assert pf.current_plan().fired() == 1
            pf.clear_plan()

            def recopied():
                return any(t.get("kind") == "replica_recopy" and t.get("repaired")
                           and t.get("volume_id") == vid for t in master.repair_log)

            await _wait_for(recopied, "the loop's recopy")
            await _wait_for(lambda: not any(
                r["scrub_corrupt"] for r in master.topo.replica_states().get(vid, [])),
                "the healed heartbeat")
            assert not [t for t in master.repair_log if t.get("error")], master.repair_log
            assert await read_url(http, f"http://{target_url}/{vfid}") == victim
            assert await read_url(http, f"http://{target_url}/{ar.fid}") == good
            # the passes after the recopy find nothing
            healed = cluster.server_for(target_url).store.find_volume(vid)
            await asyncio.sleep(0.6)
            assert not healed.scrub_corrupt
            assert master.repair_queue.depth() == 0
        finally:
            pf.clear_plan()
            await http.close()
            await cluster.stop()

    asyncio.run(asyncio.wait_for(body(), 60))


def test_repair_copy_rollback_and_the_copy_commands(tmp_path):
    """A failed re-copy pull puts the quarantined files back (the volume
    still serves, still flagged); volume.copy, volume.move and
    volume.fix.replication move whole volumes between servers."""
    from test_torch_cluster import Cluster, assign_retry

    from seaweedfs_tpu_torch.client.operation import read_url, upload_data
    from seaweedfs_tpu_torch.pb import grpc_address
    from seaweedfs_tpu_torch.pb.rpc import Stub
    from seaweedfs_tpu_torch.shell import CommandEnv
    from seaweedfs_tpu_torch.shell.commands import run_command
    from seaweedfs_tpu_torch.util.fasthttp import FastHTTPClient

    async def body():
        cluster = Cluster(tmp_path, n_volume_servers=3)
        http = FastHTTPClient()
        await cluster.start()
        env = CommandEnv(cluster.master.address)
        try:
            ar = await assign_retry(cluster.master.address)
            vid = int(ar.fid.split(",")[0])
            data = random.Random(3).randbytes(600)
            await upload_data(http, ar.url, ar.fid, data)
            vs = cluster.server_for(ar.url)
            vs.store.find_volume(vid).quarantine("test")
            r = await Stub(grpc_address(ar.url), "volume").call(
                "VolumeRepairCopy", {"volume_id": vid, "source_data_node": "127.0.0.1:1"},
                timeout=30)
            assert r.get("error"), r
            assert vs.store.find_volume(vid).scrub_corrupt
            assert await read_url(http, f"http://{ar.url}/{ar.fid}") == data
            others = [s.address for s in cluster.volume_servers if s.address != ar.url]
            assert "need to run `lock`" in (await _try(run_command(env, f"volume.copy {ar.url} "
                                                               f"{others[0]} {vid}")))
            await run_command(env, "lock")
            out = await run_command(env, f"volume.copy {ar.url} {others[0]} {vid}")
            assert out == f"volume {vid} copied {ar.url} -> {others[0]}", out
            assert await read_url(http, f"http://{others[0]}/{ar.fid}") == data
            out = await run_command(
                env, f"volume.move -volumeId {vid} -source {others[0]} -target {others[1]}")
            assert out == f"volume {vid} moved {others[0]} -> {others[1]}", out
            assert await read_url(http, f"http://{others[1]}/{ar.fid}") == data
            assert cluster.server_for(others[0]).store.find_volume(vid) is None
            out = await run_command(env, "volume.fix.replication")
            assert out == "no under-replicated volumes", out
            await run_command(env, "unlock")
        finally:
            await http.close()
            await cluster.stop()

    asyncio.run(asyncio.wait_for(body(), 60))


async def _try(coro) -> str:
    try:
        return await coro
    except Exception as e:  # noqa: BLE001 - the shell raises NotLockedError
        return str(e)
