"""The port's vacuum plane against the JAX package's, on the CPU:

- compactions of one volume, cloned: `compact` (the .dat scan),
  `compact2` on both host routes and `_copy_naive` on a TTL volume give
  byte-identical .dat and .idx; writes racing a compaction give equal
  live sets (keys, sizes, offsets, payloads); `python -m
  seaweedfs_tpu_torch compact` equals the JAX command;
- the three states of the shadow sweep, each at volume load; verify on
  bit rot (CorruptLiveRecord, the quarantine, no shadow left); a second
  compaction and a quarantined volume refused;
- under a fault plan (util/faults.py) the copy goes through each
  package's DiskFile seams: a simulated crash mid-.cpd write leaves the
  same torn shadow, which the reload sweeps; bit rot planted by the write
  seam is caught by the verified vacuum reading extent by extent
  (tests/test_vacuum_plane.py);
- `plan_vacuums`, `RepairQueue` and the maintenance budget on seeded
  inputs;
- `bulk_lookup` (K1's plain version) before and after a commit on the
  memory, lsm and leveldb kinds and a sorted load, against the JAX
  lookups and the host map; the lsm snapshot across a commit;
- the volume server: the gate's stale-offset re-read on the port's arena
  across a commit, and GETs racing a commit's close-to-swap window;
- an in-process cluster: `/vol/vacuum`, VacuumStatus and `volume.vacuum`
  answer as the JAX cluster's; a scheduler round off heartbeat garbage
  ratios (tests/test_vacuum_plane.py, tests/test_cluster.py).

Inputs come from a numpy seed; tolerance: exact. Volumes hold at most a
few hundred needles."""

import asyncio
import os
import random
import re
import shutil
import time

import numpy as np
import pytest

from seaweedfs_tpu.storage import vacuum as jax_vacuum
from seaweedfs_tpu.storage.needle import Needle as JaxNeedle
from seaweedfs_tpu.storage.ttl import TTL as JaxTTL
from seaweedfs_tpu.storage.volume import Volume as JaxVolume
from seaweedfs_tpu.util import faults as jax_faults
from seaweedfs_tpu_torch.storage import vacuum
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.types import to_actual_offset
from seaweedfs_tpu_torch.util import faults


def _port_volume(*a, **kw):
    return Volume(*a, device="cpu", **kw)


def _history(v, needle_cls, seed: int, n: int = 160, ttl_split: bool = False):
    """Seeded writes, overwrites and deletes; returns {key: data} live.
    ttl_split stamps odd keys now and even keys two hours ago, so a 1h
    TTL expires the even ones."""
    rng = np.random.default_rng(seed)
    live = {}
    now = int(time.time())

    def write(i, data):
        nd = needle_cls(id=i, cookie=1000 + i, data=data)
        if ttl_split:
            nd.set_last_modified(now if i % 2 else now - 7200)
        v.write_needle(nd)
        live[i] = data

    for i in range(1, n + 1):
        write(i, rng.integers(0, 256, size=int(rng.integers(1, 600)),
                              dtype=np.uint8).tobytes())
    for i in rng.choice(np.arange(1, n + 1), size=n // 4, replace=False).tolist():
        write(i, bytes([i % 256]) * int(rng.integers(1, 300)))
    for i in rng.choice(np.arange(1, n + 1), size=n // 3, replace=False).tolist():
        v.delete_needle(needle_cls(id=i, cookie=1000 + i))
        live.pop(i, None)
    return live


def _jax_volume_dir(tmp_path, seed=1, **kw):
    """Volume 1 written by the JAX package in tmp_path/src."""
    src = tmp_path / "src"
    src.mkdir()
    ttl_split = "ttl" in kw
    if ttl_split:
        kw["ttl"] = JaxTTL.read(kw["ttl"])
    v = JaxVolume(str(src), "", 1, **kw)
    live = _history(v, JaxNeedle, seed, ttl_split=ttl_split)
    v.close()
    return src, live


def _clone(src, dst):
    shutil.copytree(src, dst)
    return dst


def _files(d, exts=(".dat", ".idx")):
    return [(d / f"1{e}").read_bytes() for e in exts]


@pytest.mark.parametrize("flavor", ["pread", "mmap", "scan", "naive_ttl"])
def test_compaction_byte_identical_to_jax(tmp_path, flavor):
    """One volume cloned: each package compacts and commits its clone;
    the .dat and .idx are byte for byte the same, every live needle
    reads back and the commit leaves no garbage."""
    kw = {"ttl": "1h"} if flavor == "naive_ttl" else {}
    src, live = _jax_volume_dir(tmp_path, **kw)
    out = {}
    for name, vol, vac in (("jax", JaxVolume, jax_vacuum),
                           ("port", _port_volume, vacuum)):
        d = _clone(src, tmp_path / name)
        v = vol(str(d), "", 1, create=False)
        if flavor == "scan":
            vac.compact(v)
        else:
            report = vac.compact2(v, route=None if flavor == "naive_ttl" else flavor)
            out[name + "_report"] = {k: report[k] for k in ("route", "records")}
        v2 = vac.commit_compact(v)
        if flavor == "naive_ttl":
            live = {k: d_ for k, d_ in live.items() if k % 2}
        for k, data in live.items():
            assert bytes(v2.read_needle_by_key(k).data) == data, (name, k)
        assert v2.deleted_size() == 0 and v2.file_count() == len(live)
        assert v2.super_block.compaction_revision == 1
        v2.close()
        out[name] = _files(d)
    assert out["port"] == out["jax"]
    if flavor != "scan":
        assert out["port_report"] == out["jax_report"]
    if flavor in ("pread", "mmap"):
        assert vacuum.LAST_VACUUM_ROUTE["route"] == flavor
        assert vacuum.LAST_VACUUM_ROUTE["extents"] > 1
        assert vacuum.LAST_VACUUM_STAGES["total_s"] > 0


def test_racing_writes_give_equal_live_sets(tmp_path):
    """Writes between compact2 and commit (an overwrite, a delete, a new
    key) are replayed by the makeup diff in both packages; their own
    timestamps differ, so compare keys, sizes, offsets and payloads."""
    src, live = _jax_volume_dir(tmp_path, seed=2)
    keys = sorted(live)
    out = {}
    for name, vol, needle, vac in (
        ("jax", JaxVolume, JaxNeedle, jax_vacuum),
        ("port", _port_volume, Needle, vacuum),
    ):
        v = vol(str(_clone(src, tmp_path / name)), "", 1, create=False)
        vac.compact2(v, route="pread")
        v.write_needle(needle(id=keys[0], cookie=1000 + keys[0], data=b"RACED" * 9))
        v.delete_needle(needle(id=keys[-1], cookie=1000 + keys[-1]))
        v.write_needle(needle(id=999, cookie=42, data=b"NEW" * 21))
        v2 = vac.commit_compact(v)
        cols = [c.tolist() for c in v2.nm.snapshot()]
        payloads = {k: bytes(v2.read_needle_by_key(k).data) for k in cols[0]}
        with pytest.raises(Exception):
            v2.read_needle_by_key(keys[-1])
        v2.close()
        out[name] = (cols, payloads)
    assert out["port"] == out["jax"]
    assert out["port"][1][keys[0]] == b"RACED" * 9


def test_compact_command_equals_jax(tmp_path, capsys):
    from seaweedfs_tpu.command import cli as jax_cli
    from seaweedfs_tpu_torch.command import cli

    src, _live = _jax_volume_dir(tmp_path, seed=3)
    printed = []
    for name, main in (("jax", jax_cli.cmd_compact),
                       ("port", lambda a: cli.main(["compact", *a]))):
        d = _clone(src, tmp_path / name)
        assert main(["-dir", str(d), "-volumeId", "1"]) == 0
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] and "compacted volume 1" in printed[0]
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


@pytest.mark.parametrize("state", ["pair", "cpd", "cpx_alone"])
def test_shadow_sweep_at_load_equals_jax(tmp_path, state):
    """A compaction interrupted before the commit (both shadows, or the
    .cpd alone) is swept at load; one interrupted between the commit's
    two renames (the .cpx alone) is completed. Both packages leave the
    same files and serve the same needles."""
    src, live = _jax_volume_dir(tmp_path, seed=4)
    v = JaxVolume(str(src), "", 1, create=False)
    jax_vacuum.compact2(v, route="pread")
    v.close()
    if state == "cpd":
        os.remove(src / "1.cpx")
    elif state == "cpx_alone":
        os.rename(src / "1.cpd", src / "1.dat")
    out = {}
    for name, vol in (("jax", JaxVolume), ("port", _port_volume)):
        d = _clone(src, tmp_path / name)
        v = vol(str(d), "", 1, create=False)
        reads = {k: bytes(v.read_needle_by_key(k).data) for k in live}
        v.close()
        out[name] = (sorted(os.listdir(d)), _files(d), reads, v.is_read_only())
    assert out["port"] == out["jax"]
    names, _files_, reads, read_only = out["port"]
    assert "1.cpd" not in names and "1.cpx" not in names and not read_only
    assert reads == live


def test_verify_catches_bitrot_and_quarantines_as_jax(tmp_path):
    src, _live = _jax_volume_dir(tmp_path, seed=5)
    v = JaxVolume(str(src), "", 1, create=False)
    key = next(iter(sorted(_live)))
    off = to_actual_offset(v.nm.get(key).offset_units) + 20
    v.close()
    with open(src / "1.dat", "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))
    out = {}
    for name, vol, vac in (("jax", JaxVolume, jax_vacuum),
                           ("port", _port_volume, vacuum)):
        d = _clone(src, tmp_path / name)
        v = vol(str(d), "", 1, create=False)
        with pytest.raises(vac.CorruptLiveRecord) as e:
            vac.compact2(v, verify=True)
        out[name] = (str(e.value), v.scrub_corrupt, v.is_read_only(),
                     v.is_compacting, sorted(os.listdir(d)))
        v.close()
    assert out["port"] == out["jax"]
    assert out["port"][1:4] == (True, True, False)


PLANES = (("jax", JaxVolume, JaxNeedle, jax_vacuum, jax_faults),
          ("port", _port_volume, Needle, vacuum, faults))


def _seam_events(fm) -> list:
    return [(op, os.path.basename(t), k) for op, t, k in fm.current_plan().events]


def test_kill_point_mid_cpd_write_recovers_as_jax(tmp_path):
    """A simulated crash mid-.cpd write (the write seam's `crash`, keep
    100 bytes) leaves the same torn shadow in both packages; the reload
    sweeps it and serves the full pre-vacuum content."""
    src, live = _jax_volume_dir(tmp_path, seed=6)
    out = {}
    for name, vol, _needle, vac, fm in PLANES:
        d = _clone(src, tmp_path / name)
        v = vol(str(d), "", 1, create=False)
        fm.install_plan(fm.FaultPlan(seed=5, rules=[fm.FaultRule(
            op="write_at", target="*.cpd", nth=2, fault="crash", keep=100)]))
        try:
            with pytest.raises(fm.SimulatedCrash):
                vac.compact2(v)
            torn = (_seam_events(fm), (d / "1.cpd").read_bytes())
        finally:
            fm.clear_plan()
        v.close()
        v2 = vol(str(d), "", 1, create=False)
        reads = {k: bytes(v2.read_needle_by_key(k).data) for k in live}
        out[name] = (torn, sorted(os.listdir(d)), v2.is_read_only(), reads)
        v2.close()
    assert out["port"] == out["jax"]
    (events, cpd), names, read_only, reads = out["port"]
    assert events[-1] == ("write_at", "1.cpd", "crash") and len(cpd) > 8
    assert "1.cpd" not in names and "1.cpx" not in names and not read_only
    assert reads == live


def test_verified_vacuum_under_a_plan_catches_seam_bitrot_as_jax(tmp_path):
    """Bit rot planted by the write seam's `bitflip` in a live record; the
    verified vacuum then runs under a plan whose read rule fires on every
    .dat read (a zero-delay latency), so the copy reads extent by extent
    through the seam, and both packages abort with the same finding."""
    out = {}
    for name, vol, needle, vac, fm in PLANES:
        d = tmp_path / name
        d.mkdir()
        v = vol(str(d), "", 1)
        _history(v, needle, 8, n=40)
        at = v.data_file_size() + 16 + 20  # inside the next record's data
        fm.install_plan(fm.FaultPlan(seed=3, rules=[fm.FaultRule(
            op="write_at", target="*.dat", nth=1, fault="bitflip",
            at_offset=at, bits=2)]))
        v.write_needle(needle(id=500, cookie=1500, data=b"rot" * 100))
        fm.install_plan(fm.FaultPlan(seed=3, rules=[fm.FaultRule(
            op="read_at", target="*.dat", fault="latency", probability=1.0)]))
        try:
            with pytest.raises(vac.CorruptLiveRecord) as e:
                vac.compact2(v, verify=True)
            reads = len(_seam_events(fm))
        finally:
            fm.clear_plan()
        out[name] = (str(e.value), reads, v.scrub_corrupt, v.is_read_only(),
                     sorted(os.listdir(d)))
        v.close()
    assert out["port"] == out["jax"]
    assert out["port"][1] > 1 and out["port"][2:4] == (True, True)
    assert "1.cpd" not in out["port"][4]


def test_second_compaction_and_quarantine_refused_as_jax(tmp_path):
    for vol, needle, vac in ((JaxVolume, JaxNeedle, jax_vacuum),
                             (_port_volume, Needle, vacuum)):
        d = tmp_path / vac.__name__
        d.mkdir()
        v = vol(str(d), "", 1)
        v.write_needle(needle(id=1, cookie=1, data=b"evidence"))
        v.is_compacting = True  # an in-flight compaction elsewhere
        with pytest.raises(RuntimeError, match="already compacting"):
            vac.compact2(v)
        v.is_compacting = False
        v.quarantine("scrub found bit rot")
        with pytest.raises(PermissionError, match="quarantined"):
            vac.compact2(v)
        assert not os.path.exists(v.file_name() + ".cpd")
        v.close()


def _seeded_states(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    states = {}
    for vid in range(1, 40):
        states[vid] = [
            {
                "url": f"n{j}",
                "collection": "c" if vid % 3 else "",
                "garbage_ratio": float(rng.random()),
                "read_only": bool(rng.random() < 0.1),
                "scrub_corrupt": bool(rng.random() < 0.05),
            }
            for j in range(int(rng.integers(1, 4)))
        ]
    return states


def test_plan_vacuums_and_repair_queue_equal_jax():
    from seaweedfs_tpu.topology import repair as jax_repair
    from seaweedfs_tpu.topology import vacuum_plan as jax_plan
    from seaweedfs_tpu_torch.topology import repair, vacuum_plan

    for seed in range(4):
        states = _seeded_states(seed)
        for threshold, include_all in ((0.3, False), (0.7, False), (0.3, True)):
            got = vacuum_plan.plan_vacuums(states, threshold, include_all)
            want = jax_plan.plan_vacuums(states, threshold, include_all)
            assert [t.to_info() for t in got] == [t.to_info() for t in want]
    assert vacuum_plan.priority_to_ratio(vacuum_plan.garbage_priority(0.42)) == \
        jax_plan.priority_to_ratio(jax_plan.garbage_priority(0.42))

    def drive(mod, plan_mod) -> list:
        q = mod.RepairQueue(rng=random.Random(7))
        trace = []
        now = 1000.0
        for step in range(6):
            tasks = plan_mod.plan_vacuums(_seeded_states(step), 0.4)
            for t in tasks:
                q.offer(t)
            q.prune({t.key for t in tasks} | q.retry_keys())
            ready = q.pop_ready(now, 3)
            for t in ready[:1]:
                q.reschedule_failure(t, now)
            trace.append((q.depth(), q.snapshot(), sorted(q.retry_keys())))
            now += 5.0
        return trace

    assert drive(repair, vacuum_plan) == drive(jax_repair, jax_plan)


def test_maintenance_budget_equals_jax():
    """One budget shared by two planes over a fake clock: the same
    consumes sleep the same and account the same; the pressure yield is
    zero in both (no foreground pressure)."""
    from seaweedfs_tpu.storage import maintenance as jax_maint
    from seaweedfs_tpu_torch.storage import maintenance

    def drive(mod):
        clock = {"now": 0.0}

        def sleep(dt):
            clock["now"] += dt

        budget = mod.MaintenanceBudget(0.5, capacity_bytes=50_000,
                                       clock=lambda: clock["now"], sleep=sleep)
        slept = [budget.plane(p).consume(n)
                 for p, n in (("scrub", 40_000), ("vacuum", 90_000),
                              ("vacuum", 10), ("scrub", 120_000))]
        bucket = mod.TokenBucket(1e5, clock=lambda: clock["now"], sleep=sleep)
        slept.append(bucket.consume(250_000))
        shaped = mod.plane_bucket("vacuum", bucket)
        return slept, budget.snapshot(), clock["now"], type(shaped).__name__

    assert drive(maintenance) == drive(jax_maint)
    maintenance.configure_shared(None)
    assert maintenance.plane_bucket("vacuum") is None
    maintenance.configure_shared(maintenance.MaintenanceBudget(1.0))
    try:
        assert maintenance.plane_bucket("vacuum").plane == "vacuum"
    finally:
        maintenance.configure_shared(None)


@pytest.mark.parametrize("kind", ["memory", "lsm", "leveldb"])
def test_bulk_lookup_across_a_commit_equals_jax(tmp_path, kind):
    """bulk_lookup of every key plus absent ones, before and after a
    commit, in batches under and over the 64-key cut: the port's plain K1
    equals the JAX lookups and the new volume's host map; then a
    read-only `sorted` load of the compacted volume answers the same."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    vols = {"jax": JaxVolume(str(tmp_path / "jax"), "", 1, needle_map_kind=kind),
            "port": _port_volume(str(tmp_path / "port"), "", 1,
                                 needle_map_kind=kind)}
    live = _history(vols["jax"], JaxNeedle, 6)
    assert _history(vols["port"], Needle, 6) == live
    probes = np.arange(1, 190, dtype=np.uint64)

    def answers(v, use_device=None):
        return [np.concatenate(cols) for cols in zip(
            *(v.bulk_lookup(probes[i:i + n], use_device)
              for i, n in ((0, 64), (64, 20), (84, 105))))]

    before = answers(vols["port"])
    for a, b in zip(answers(vols["jax"]), before):
        assert np.array_equal(a, b)
    jax_vacuum.compact2(vols["jax"], route="pread")
    vacuum.compact2(vols["port"], route="mmap")
    new = {"jax": jax_vacuum.commit_compact(vols["jax"]),
           "port": vacuum.commit_compact(vols["port"])}
    try:
        after = answers(new["port"])
        assert after[2].sum() == len(live) and not np.array_equal(after[0], before[0])
        for a, b in zip(after, answers(new["port"], False)):
            assert np.array_equal(a, b)  # K1 equals the host map
        if kind != "leveldb":  # the JAX leveldb reload keeps stale offsets
            for use_device in (None, False):
                for a, b in zip(answers(new["jax"], use_device), after):
                    assert np.array_equal(a, b)
    finally:
        for v in new.values():
            v.close()
    sv = _port_volume(str(tmp_path / "port"), "", 1, create=False,
                      needle_map_kind="sorted")
    try:
        assert sv.is_read_only()
        for a, b in zip(answers(sv), after):
            assert np.array_equal(a, b)
    finally:
        sv.close()


def test_lsm_commit_swap_and_stale_snapshot(tmp_path):
    """Mirror of test_lsm_needle_map::test_volume_lsm_vacuum_commit_swap_
    and_stale_snapshot on the port: the commit invalidates the persisted
    snapshot, the next mount folds a fresh one, and the pre-vacuum
    snapshot restored over the new .idx is rejected at load."""
    from seaweedfs_tpu_torch.storage.needle_map.lsm_map import MANIFEST_EXT

    d = tmp_path / "vol"
    d.mkdir()
    v = _port_volume(str(d), "", 9, needle_map_kind="lsm")
    blobs = _history(v, Needle, 9)
    v.nm.save_snapshot()
    side = [fn for fn in os.listdir(d) if ".nmr-" in fn or fn.endswith(MANIFEST_EXT)]
    stash = tmp_path / "stash"
    stash.mkdir()
    for fn in side:
        shutil.copy2(d / fn, stash / fn)
    keys = np.arange(1, 170, dtype=np.uint64)
    old = v.bulk_lookup(keys, use_device=True)
    vacuum.compact2(v)
    v2 = vacuum.commit_compact(v)
    assert v2.needle_map_kind == "lsm" and v2.device == v.device
    got = v2.bulk_lookup(keys, use_device=True)
    assert np.array_equal(got[2], old[2]) and not np.array_equal(got[0], old[0])
    for k, data in blobs.items():
        assert bytes(v2.read_needle_by_key(k).data) == data
    v2.close()
    v3 = _port_volume(str(d), "", 9, create=False, needle_map_kind="lsm")
    assert v3.nm.loaded_from_snapshot and v3.file_count() == len(blobs)
    v3.close()
    for fn in os.listdir(d):
        if ".nmr-" in fn or fn.endswith(MANIFEST_EXT):
            os.remove(d / fn)
    for fn in side:
        shutil.copy2(stash / fn, d / fn)
    v4 = _port_volume(str(d), "", 9, create=False, needle_map_kind="lsm")
    for k, data in blobs.items():
        assert bytes(v4.read_needle_by_key(k).data) == data
    for a, b in zip(v4.bulk_lookup(keys, use_device=True), got):
        assert np.array_equal(a, b)
    v4.destroy()


# ------------------------------------------------------------ the server --


def _free_port() -> int:
    """A port whose RPC port (+10000) is free too, under the ephemeral
    range and clear of the JAX tests' 18200-20800 (bench and process-cluster
    bands) and 21000-22000, as the other port tests pick theirs."""
    import socket

    for _ in range(200):
        p = random.randrange(12000, 18000)
        try:
            with socket.socket() as s1, socket.socket() as s2:
                s1.bind(("127.0.0.1", p))
                s2.bind(("127.0.0.1", p + 10000))
            return p
        except OSError:
            continue
    raise RuntimeError("no free port pair")


def _serve(tmp_path, body, **kw):
    from seaweedfs_tpu_torch.pb.rpc import Stub
    from seaweedfs_tpu_torch.server.volume import VolumeServer
    from seaweedfs_tpu_torch.util.fasthttp import FastHTTPClient

    async def main():
        vs = VolumeServer([str(tmp_path)], port=_free_port(),
                          codec_backend="cpu", needle_map_kind="lsm", **kw)
        await vs.start()
        http = FastHTTPClient(pool_per_host=256)
        try:
            stub = Stub(f"127.0.0.1:{vs.port + 10000}", "volume")
            assert await stub.call("AllocateVolume", {"volume_id": 3}) == {}
            return await body(vs, stub, http)
        finally:
            await http.close()
            await vs.stop()

    return asyncio.run(asyncio.wait_for(main(), 60))


async def _fill(http, port, n=300, seed=10):
    from seaweedfs_tpu_torch.client.operation import upload_data
    from seaweedfs_tpu_torch.storage.file_id import format_needle_id_cookie

    rng = np.random.default_rng(seed)
    fids = {}
    for i in range(1, n + 1):
        fid = f"3,{format_needle_id_cookie(i, 0x5000 + i)}"
        data = rng.integers(0, 256, size=int(rng.integers(10, 500)),
                            dtype=np.uint8).tobytes()
        await upload_data(http, f"127.0.0.1:{port}", fid, data)
        fids[fid] = data
    return fids


async def _get_all(http, port, fids, expect):
    """Concurrent GETs of every fid; -> the count of answers that are
    neither the written bytes (live) nor a 404 (deleted)."""
    async def one(fid):
        st, body = await http.request("GET", f"127.0.0.1:{port}", "/" + fid)
        return (st == 200 and body == expect[fid]) or (st == 404 and expect[fid] is None)

    ok = await asyncio.gather(*(one(f) for f in fids))
    return ok.count(False)


def test_gate_stale_offset_after_a_commit_on_the_arena(tmp_path):
    """Mirror of test_lookup_gate::test_gate_stale_offset_falls_back_to_
    locked_read on the port's arena gate (identity check on): a poisoned
    offset read falls back to the locked path, and after compaction and
    commit through the Vacuum RPCs every GET burst (one wakeup over the
    arena cut) answers the new volume's bytes, deleted needles 404."""
    from seaweedfs_tpu_torch.storage.file_id import FileId

    async def body(vs, stub, http):
        vs.lookup_gate.identity_check = True
        fids = await _fill(http, vs.port)
        expect = dict(fids)
        for fid in list(fids)[::3]:
            st, _ = await http.request("DELETE", f"127.0.0.1:{vs.port}", "/" + fid)
            assert st == 202
            expect[fid] = None
        burst = list(fids) * 2
        assert await _get_all(http, vs.port, burst, expect) == 0
        check = await stub.call("VacuumVolumeCheck", {"volume_id": 3})
        assert check["garbage_ratio"] > 0.3
        r = await stub.call("VacuumVolumeCompact", {"volume_id": 3, "route": "pread"})
        assert r["route"]["route"] == "pread" and r["route"]["records"] == 200
        old = vs.store.find_volume(3)
        assert await stub.call("VacuumVolumeCommit", {"volume_id": 3}) == {}
        new = vs.store.find_volume(3)
        assert new is not old and new.device == old.device
        assert await _get_all(http, vs.port, burst, expect) == 0
        # poison the offset read once, as a stale post-commit offset would
        real, calls = new.read_needle_at, {"n": 0}

        def poisoned(offset_units, size):
            calls["n"] += 1
            if calls["n"] == 1:
                raise IOError("stale offset after vacuum commit")
            return real(offset_units, size)

        new.read_needle_at = poisoned
        vs.read_cache.invalidate_volume(3)  # every GET reaches the gate
        assert await _get_all(http, vs.port, burst, expect) == 0
        assert calls["n"] > 1
        assert (await stub.call("VacuumVolumeCheck", {"volume_id": 3}))["garbage_ratio"] == 0
        assert await stub.call("VacuumVolumeCleanup", {"volume_id": 3}) == {}
        live = [FileId.parse(f).key for f, d in expect.items() if d is not None]
        return vs.lookup_gate.stats, vs.device_errors, len(live)

    stats, errors, n_live = _serve(tmp_path, body, batch_lookup="arena")
    assert stats["device_batches"] > 0 and stats["identity_mismatches"] == 0
    assert errors == {} and n_live == 200


def test_gets_racing_a_commit_wait_for_the_swap(tmp_path):
    """GETs that reach the server while a commit holds the old volume
    closed (stretched here by a slow makeup diff) wait for the swap: every
    answer is the written bytes or a 404 for a deleted needle, none a
    500, and a cleanup during a compaction is refused."""
    async def body(vs, stub, http):
        fids = await _fill(http, vs.port, n=200, seed=11)
        expect = dict(fids)
        for fid in list(fids)[1::3]:
            await http.request("DELETE", f"127.0.0.1:{vs.port}", "/" + fid)
            expect[fid] = None
        await stub.call("VacuumVolumeCompact", {"volume_id": 3})
        real = vacuum._makeup_diff

        def slow(*a):
            time.sleep(0.4)  # the old volume is closed for this long
            return real(*a)

        vacuum._makeup_diff = slow
        try:
            commit = asyncio.ensure_future(
                stub.call("VacuumVolumeCommit", {"volume_id": 3}))
            await asyncio.sleep(0.1)
            bad = 0
            while not commit.done():
                bad += await _get_all(http, vs.port, list(fids)[:60], expect)
            assert await commit == {}
        finally:
            vacuum._makeup_diff = real
        v = vs.store.find_volume(3)
        v.is_compacting = True
        refused = await stub.call("VacuumVolumeCleanup", {"volume_id": 3})
        v.is_compacting = False
        return bad, refused, await _get_all(http, vs.port, list(fids), expect)

    bad, refused, after = _serve(tmp_path, body, batch_lookup="off")
    assert (bad, after) == (0, 0)
    assert refused == {"error": "compaction in flight; not cleaning"}


# ----------------------------------------------------------- the cluster --


def test_cluster_vacuum_equals_jax(tmp_path):
    """A master and one volume server per package: the same 13 needles,
    12 deleted, then `/vol/vacuum?garbageThreshold=0.3`, VacuumStatus and
    the shell's `volume.vacuum -status` and `volume.vacuum` answer alike,
    and the surviving needle reads back from both."""
    import aiohttp

    from seaweedfs_tpu.client.operation import delete_file as jax_delete
    from seaweedfs_tpu.client.operation import read_url as jax_read
    from seaweedfs_tpu.client.operation import upload_data as jax_upload
    from seaweedfs_tpu.pb import grpc_address as jax_grpc_address
    from seaweedfs_tpu.pb.rpc import Stub as JaxStub
    from seaweedfs_tpu.shell import CommandEnv as JaxEnv
    from seaweedfs_tpu.shell import run_command as jax_run
    from seaweedfs_tpu_torch.client.operation import delete_file, read_url, upload_data
    from seaweedfs_tpu_torch.pb import grpc_address
    from seaweedfs_tpu_torch.pb.rpc import Stub
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command
    from seaweedfs_tpu_torch.storage.file_id import format_needle_id_cookie
    from seaweedfs_tpu_torch.util.fasthttp import FastHTTPClient
    from tests.test_cluster import Cluster as JaxCluster
    from tests.test_cluster import assign_retry as jax_assign
    from tests.test_torch_cluster import Cluster, assign_retry

    def scrub(status, vid):
        """The compacted volume (each master assigns its own) without the
        volume servers' addresses, and the skip reasons of the others."""
        recent = status.pop("recent")
        for d in recent:
            d.pop("nodes", None)
        status["compacted"] = [{**d, "volume_id": 0} for d in recent
                               if d["volume_id"] == vid]
        status["skipped"] = sorted(d.get("skipped") for d in recent
                                   if d["volume_id"] != vid)
        return status

    async def run(cluster, assign, upload, delete, read, env_cls, run_cmd,
                  client, stub_cls, grpc_address):
        await cluster.start()
        try:
            ar = await assign(cluster.master.address)
            vid = int(ar.fid.split(",")[0])
            fids = [f"{vid},{format_needle_id_cookie(i, 0xAB00 + i)}"
                    for i in range(1, 14)]
            for fid in fids:
                await upload(client, ar.url, fid, b"y" * 2000)
            for fid in fids[:-1]:
                await delete(client, ar.url, fid)
            http = FastHTTPClient()
            try:
                st, body = await http.request(
                    "GET", cluster.master.address,
                    "/vol/vacuum?garbageThreshold=0.3", timeout=60)
            finally:
                await http.close()
            status = await stub_cls(grpc_address(cluster.master.address),
                                    "master").call("VacuumStatus", {})
            env = env_cls(cluster.master.address)
            shell = [await run_cmd(env, "volume.vacuum -status"),
                     await run_cmd(env, "volume.vacuum")]
            await env.release_lock()
            got = await read(client, f"http://{ar.url}/{fids[-1]}")
            body = body.replace(b'"volume_id": %d,' % vid, b'"volume_id": 0,')
            shell[0] = sorted(re.sub(r"recent volume \d+:", "recent volume _:",
                                     shell[0]).splitlines())
            return st, body, scrub(status, vid), shell, got
        finally:
            await cluster.stop()

    async def main():
        # no keep-alive: an idle pooled connection holds the JAX server's
        # shutdown for its whole grace period
        async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(force_close=True)
        ) as session:
            jax = await run(JaxCluster(tmp_path / "j", n_volume_servers=1),
                            jax_assign, jax_upload, jax_delete, jax_read,
                            JaxEnv, jax_run, session, JaxStub, jax_grpc_address)
        http = FastHTTPClient()
        try:
            port = await run(Cluster(tmp_path / "p", n_volume_servers=1),
                             assign_retry, upload_data, delete_file, read_url,
                             CommandEnv, run_command, http, Stub, grpc_address)
        finally:
            await http.close()
        return jax, port

    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    jax, port = asyncio.run(asyncio.wait_for(main(), 90))
    assert port == jax
    st, body, status, shell, got = port
    assert st == 200 and got == b"y" * 2000
    assert body == b'{"Result": [{"volume_id": 0, "compacted": true}]}'
    assert status["compacted"][0]["compacted"] and len(status["skipped"]) >= 6
    assert "  recent volume _: compacted" in shell[0]
    assert shell[1] == "vacuum: {'Result': []}"


def test_cluster_scheduler_round_off_heartbeat_ratios(tmp_path):
    """Mirror of test_vacuum_plane::test_cluster_vacuum_status_and_
    scheduler_run on the port: the deletes' garbage ratio reaches the
    master through the heartbeats' slim refresh, a scheduler round
    compacts the volume, `volume.vacuum -run` and `-status` report it."""
    from seaweedfs_tpu_torch.client.operation import delete_file, read_url, upload_data
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command
    from seaweedfs_tpu_torch.storage.file_id import format_needle_id_cookie
    from seaweedfs_tpu_torch.util.fasthttp import FastHTTPClient
    from tests.test_torch_cluster import Cluster, assign_retry

    async def main():
        cluster = Cluster(tmp_path, n_volume_servers=1)
        http = FastHTTPClient()
        await cluster.start()
        try:
            ar = await assign_retry(cluster.master.address)
            vid = int(ar.fid.split(",")[0])
            fids = [f"{vid},{format_needle_id_cookie(i, 0xAB00 + i)}"
                    for i in range(1, 14)]
            for fid in fids:
                await upload_data(http, ar.url, fid, b"y" * 2000)
            for fid in fids[:-1]:
                await delete_file(http, ar.url, fid)
            env = CommandEnv(cluster.master.address)
            assert "auto_vacuum: off" in await run_command(env, "volume.vacuum -status")
            deadline = time.monotonic() + 20
            compacted = []
            while not compacted and time.monotonic() < deadline:
                r = await cluster.master.run_vacuum_once(
                    garbage_threshold=0.05, max_dispatch=10)
                compacted = [d for d in r["dispatched"] if d.get("compacted")]
                await asyncio.sleep(0.3)
            assert [d["volume_id"] for d in compacted] == [vid]
            assert await read_url(http, f"http://{ar.url}/{fids[-1]}") == b"y" * 2000
            out = await run_command(env, "volume.vacuum -run -garbageThreshold 0.05")
            assert "ran one round" in out
            out = await run_command(env, "volume.vacuum -status")
            await env.release_lock()
            return out
        finally:
            await http.close()
            await cluster.stop()

    out = asyncio.run(asyncio.wait_for(main(), 60))
    assert "queue depth: 0" in out and "compacted" in out
