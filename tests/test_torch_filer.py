"""The port's filer modules against the JAX package's, on the CPU, exact.

Same seeded inputs (numpy) through both packages: visible intervals and
chunk views; CRUD, paging and scan_subtree on every store kind (memory,
sqlite, the append log, LSM); the LSM store's segment, WAL and MANIFEST
bytes after one insert, delete and compaction sequence, and a store
either package wrote opened by the other; DurableMetaLog segments read
across the packages, a torn tail included; path_hash64 and the arena
columns of a sealed run; the streaming msgpack reader against msgpack's.
MetaLookupGate over the port's arena on the CPU (the plain version of K2)
answers as the JAX gate over its arena does (the JAX
tests/test_ragged_lookup.py scenarios: spines, memtable tombstones,
misses, cold then warm then killed). Then the port's own device rules: a
probe_groups that raises fails the flush's waiters, an identity mismatch
raises while writes in flight on another thread do not read as one, a flush-path prefetch error is raised by the next probe, the
default gate raises without a card, `server -filer` hands the volume
server's arena to the filer, and the flags still to port are refused."""

import asyncio
import os
import shutil

import msgpack
import numpy as np
import pytest

from seaweedfs_tpu.filer import filechunks as jax_fc
from seaweedfs_tpu.filer import filer_store as jax_fs
from seaweedfs_tpu.filer import lsm_store as jax_lsm
from seaweedfs_tpu.filer import meta_log as jax_ml
from seaweedfs_tpu.filer.entry import Attr as JAttr
from seaweedfs_tpu.filer.entry import Entry as JEntry
from seaweedfs_tpu.filer.entry import FileChunk as JChunk
from seaweedfs_tpu_torch.filer import filechunks as port_fc
from seaweedfs_tpu_torch.filer import filer_store as port_fs
from seaweedfs_tpu_torch.filer import lsm_store as port_lsm
from seaweedfs_tpu_torch.filer import meta_log as port_ml
from seaweedfs_tpu_torch.filer.entry import Attr as PAttr
from seaweedfs_tpu_torch.filer.entry import Entry as PEntry
from seaweedfs_tpu_torch.filer.entry import FileChunk as PChunk
from seaweedfs_tpu_torch.util import mpack

# --------------------------------------------------------------- chunks --


def _chunks(rng, n):
    out = []
    for i in range(n):
        off = int(rng.integers(0, 5000))
        out.append((f"{int(rng.integers(1, 9))},{i:x}{int(rng.integers(1 << 20)):08x}",
                    off, int(rng.integers(1, 3000)), int(rng.integers(0, 50)),
                    f"e{i}"))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_visible_intervals_and_views_equal_jax(seed):
    rng = np.random.default_rng(seed)
    raw = _chunks(rng, int(rng.integers(0, 12)))
    jc = [JChunk(f, o, s, m, e) for f, o, s, m, e in raw]
    pc = [PChunk(f, o, s, m, e) for f, o, s, m, e in raw]
    jv = jax_fc.non_overlapping_visible_intervals(jc)
    pv = port_fc.non_overlapping_visible_intervals(pc)
    assert repr(pv) == repr(jv)
    assert port_fc.total_size(pc) == jax_fc.total_size(jc)
    assert port_fc.etag(pc) == jax_fc.etag(jc) if pc else True
    for _ in range(8):
        off = int(rng.integers(0, 8000))
        size = int(rng.integers(0, 4000))
        assert repr(port_fc.view_from_visibles(pv, off, size)) == \
            repr(jax_fc.view_from_visibles(jv, off, size))
        blobs = {f: rng.bytes(s + 10) for f, _o, s, _m, _e in raw}
        assert port_fc.read_from_visible_intervals(pv, blobs.__getitem__, off, size) == \
            jax_fc.read_from_visible_intervals(jv, blobs.__getitem__, off, size)


# --------------------------------------------------------------- stores --


def _entry(E, A, C, path, i, directory=False):
    mode = (0o770 | 0o40000) if directory else 0o660
    return E(full_path=path, attr=A(mtime=1000.0 + i, crtime=1000.0 + i, mode=mode,
                                    mime="text/plain", ttl_seconds=i % 3),
             chunks=[] if directory else [C(f"3,{i:x}aa", 0, 100 + i, i, f"t{i}")],
             extended={"k": str(i)} if i % 5 == 0 else {})


def _ops(seed, n=120):
    """A seeded mutation sequence over a small tree."""
    rng = np.random.default_rng(seed)
    dirs = ["/a", "/a/b", "/a/b/c", "/z"]
    ops = [("put", d, -1, True) for d in dirs]
    for i in range(n):
        r = rng.random()
        d = dirs[int(rng.integers(0, len(dirs)))]
        if r < 0.75:
            ops.append(("put", f"{d}/f{int(rng.integers(0, n // 2))}", i, False))
        elif r < 0.93:
            ops.append(("del", f"{d}/f{int(rng.integers(0, n // 2))}", i, False))
        else:
            ops.append(("many", d, i, False))
    ops.append(("delchildren", "/a/b/c", 0, False))
    return ops


def _apply(store, ops, E, A, C):
    for op, path, i, is_dir in ops:
        if op == "put":
            store.insert_entry(_entry(E, A, C, path, i, is_dir))
        elif op == "del":
            store.delete_entry(path)
        elif op == "many":
            store.insert_many([_entry(E, A, C, f"{path}/m{i}-{k}", i + k) for k in range(3)])
        else:
            store.delete_folder_children(path)


def _store_view(store):
    out = []
    for d in ("/", "/a", "/a/b", "/a/b/c", "/z"):
        for start, incl, lim in (("", True, 1000), ("f1", True, 3), ("f1", False, 4),
                                 ("m", True, 2)):
            out.append([e.to_dict() for e in store.list_directory_entries(d, start, incl, lim)])
    probe = [f"{d}/f{k}" for d in ("/a", "/a/b", "/z") for k in range(0, 60, 7)]
    out.append({p: e.to_dict() for p, e in store.find_many(probe).items()})
    out.append([None if (e := store.find_entry(p)) is None else e.to_dict() for p in probe])
    return out


def _make(kind, pkg, tmp_path):
    fs, lsm = (jax_fs, jax_lsm) if pkg == "jax" else (port_fs, port_lsm)
    d = tmp_path / pkg
    d.mkdir(exist_ok=True)
    if kind == "memory":
        return fs.MemoryFilerStore()
    if kind == "sqlite":
        return fs.SqliteFilerStore(str(d / "f.db"))
    if kind == "flog":
        return fs.LogFilerStore(str(d / "f.flog"))
    return lsm.LsmFilerStore(str(d / "f.lsm"), memtable_limit=16, fsync=False)


@pytest.mark.parametrize("kind", ["memory", "sqlite", "flog", "lsm"])
def test_store_crud_paging_and_scan_equal_jax(tmp_path, kind):
    ops = _ops(7)
    js, ps = _make(kind, "jax", tmp_path), _make(kind, "port", tmp_path)
    try:
        _apply(js, ops, JEntry, JAttr, JChunk)
        _apply(ps, ops, PEntry, PAttr, PChunk)
        assert _store_view(ps) == _store_view(js)
        for root, start, prefix in (("/a", "", ""), ("/a", "b/", ""), ("/a", "", "b/c"),
                                    ("/", "a/b/f3", "a"), ("/a", "f2", "f")):
            jst, pst = jax_fs.ScanStats(), port_fs.ScanStats()
            jk = [(k, None if e is None else e.to_dict())
                  for k, e in jax_fs.scan_subtree(js, root, start, prefix, jst, page=3)]
            pk = [(k, None if e is None else e.to_dict())
                  for k, e in port_fs.scan_subtree(ps, root, start, prefix, pst, page=3)]
            assert pk == jk and pst.scanned == jst.scanned
        if hasattr(js, "iter_all"):
            assert [(d, n, e.to_dict()) for d, n, e in ps.iter_all()] == \
                [(d, n, e.to_dict()) for d, n, e in js.iter_all()]
    finally:
        for s in (js, ps):
            if hasattr(s, "close"):
                s.close()
    if kind == "flog":
        # the log either package wrote (and compacted at reopen) opens in the other
        a = port_fs.LogFilerStore(str(tmp_path / "jax" / "f.flog"))
        b = jax_fs.LogFilerStore(str(tmp_path / "port" / "f.flog"))
        try:
            assert _store_view(a) == _store_view(b)
        finally:
            a.close()
            b.close()
        assert (tmp_path / "jax" / "f.flog").read_bytes() == \
            (tmp_path / "port" / "f.flog").read_bytes()


def _files(d):
    return {fn: (d / fn).read_bytes() for fn in sorted(os.listdir(d)) if fn != "LOCK"}


def test_lsm_bytes_equal_jax_and_cross_open(tmp_path):
    """Flushes, tiered compactions (tombstones dropped at the oldest run)
    and a WAL tail: every file byte-equal; each package opens the other's
    directory and answers alike."""
    ops = _ops(3, n=400)
    js = jax_lsm.LsmFilerStore(str(tmp_path / "j.lsm"), memtable_limit=24, fsync=False)
    ps = port_lsm.LsmFilerStore(str(tmp_path / "p.lsm"), memtable_limit=24, fsync=False)
    _apply(js, ops, JEntry, JAttr, JChunk)
    _apply(ps, ops, PEntry, PAttr, PChunk)
    assert len(ps._segments) == len(js._segments) == 4 and ps._mem
    jf, pf = _files(tmp_path / "j.lsm"), _files(tmp_path / "p.lsm")
    assert pf == jf and pf["wal.log"]
    # crash images (no close): each package replays the other's WAL
    shutil.copytree(tmp_path / "j.lsm", tmp_path / "j2.lsm", ignore=shutil.ignore_patterns("LOCK"))
    shutil.copytree(tmp_path / "p.lsm", tmp_path / "p2.lsm", ignore=shutil.ignore_patterns("LOCK"))
    want = _store_view(js)
    js.close()
    ps.close()
    assert _files(tmp_path / "p.lsm") == _files(tmp_path / "j.lsm")
    a = port_lsm.LsmFilerStore(str(tmp_path / "j2.lsm"), fsync=False)
    b = jax_lsm.LsmFilerStore(str(tmp_path / "p2.lsm"), fsync=False)
    try:
        assert len(a._mem) == len(b._mem) > 0
        assert _store_view(a) == _store_view(b) == want
    finally:
        a.close()
        b.close()


def test_lsm_lock_refuses_a_second_open(tmp_path):
    s = port_lsm.LsmFilerStore(str(tmp_path / "x.lsm"), fsync=False)
    try:
        with pytest.raises(RuntimeError, match="locked"):
            port_lsm.LsmFilerStore(str(tmp_path / "x.lsm"))
    finally:
        s.close()
    port_lsm.LsmFilerStore(str(tmp_path / "x.lsm")).close()  # released by close


def test_path_hash_and_arena_columns_equal_jax(tmp_path):
    rng = np.random.default_rng(11)
    names = [(f"/d{int(rng.integers(0, 40))}", f"n{int(rng.integers(0, 1 << 30))}é")
             for _ in range(300)]
    assert [port_lsm.path_hash64(d, n) for d, n in names] == \
        [jax_lsm.path_hash64(d, n) for d, n in names]
    js = jax_lsm.LsmFilerStore(str(tmp_path / "j.lsm"), memtable_limit=64, fsync=False)
    ps = port_lsm.LsmFilerStore(str(tmp_path / "p.lsm"), memtable_limit=64, fsync=False)
    try:
        for i, (d, n) in enumerate(names):
            js.insert_entry(JEntry(full_path=f"{d}/{n}", attr=JAttr(mtime=float(i))))
            ps.insert_entry(PEntry(full_path=f"{d}/{n}", attr=PAttr(mtime=float(i))))
        for jseg, pseg in zip(js._segments, ps._segments, strict=True):
            ja, pa = jseg.arena_segment(), pseg.arena_segment()
            for col in ("keys", "offs", "sizes"):
                assert np.array_equal(np.asarray(getattr(pa, col)), np.asarray(getattr(ja, col)))
    finally:
        js.close()
        ps.close()


# ------------------------------------------------------------- meta log --


def _log_events(log, seed, n):
    rng = np.random.default_rng(seed)
    for i in range(n):
        e = {"full_path": f"/x/f{i}", "attr": {"mtime": float(i)}, "chunks": []}
        t = ("create", "update", "delete", "rename")[int(rng.integers(0, 4))]
        log.append("/x", t, e if t != "create" else None, e if t != "delete" else None)


def _norm_events(evs):
    return [(e.directory, e.event_type, e.old_entry, e.new_entry) for e in evs]


def test_meta_log_segments_cross_read_with_torn_tail(tmp_path):
    """Each package's DurableMetaLog segments (rotated and trimmed) read by
    the other, every record equal but the timestamps' source; a torn
    last record is cut at open to the same valid prefix."""
    for pkg in ("j", "p"):
        ml = (jax_ml if pkg == "j" else port_ml).DurableMetaLog(
            str(tmp_path / pkg), segment_events=16, max_segments=3)
        _log_events(ml, 5, 70)
        ml.close()
    # the same events, timestamps aside: read each directory by both
    reads = {}
    for pkg in ("j", "p"):
        for reader in (jax_ml, port_ml):
            ml = reader.DurableMetaLog(str(tmp_path / pkg), segment_events=16, max_segments=3)
            evs, _wm = ml.read_since_with_watermark(0)
            reads[(pkg, reader.__name__)] = (evs, ml.trimmed_through)
            ml.close()
    for pkg in ("j", "p"):
        (a, ta), (b, tb) = (reads[(pkg, m.__name__)] for m in (jax_ml, port_ml))
        assert [e.to_dict() for e in a] == [e.to_dict() for e in b] and ta == tb
    assert _norm_events(reads[("j", jax_ml.__name__)][0]) == \
        _norm_events(reads[("p", port_ml.__name__)][0])
    # a torn tail: the last segment cut inside its last record, then garbage
    for pkg in ("j", "p"):
        segs = sorted(os.listdir(tmp_path / pkg), key=lambda f: (len(f), f))
        last = tmp_path / pkg / [f for f in segs if f.endswith(".mlog")][-1]
        raw = last.read_bytes()
        last.write_bytes(raw[:-7])
    for pkg in ("j", "p"):
        sizes = []
        for reader in (jax_ml, port_ml):
            src = tmp_path / pkg
            copy = tmp_path / f"{pkg}-{reader.__name__}"
            shutil.copytree(src, copy)
            ml = reader.DurableMetaLog(str(copy), segment_events=16, max_segments=3)
            evs, _ = ml.read_since_with_watermark(0)
            ml.close()
            sizes.append(([e.to_dict() for e in evs],
                          {f: (copy / f).stat().st_size for f in os.listdir(copy)}))
        assert sizes[0] == sizes[1]


def test_mpack_unpacker_matches_msgpack_stream():
    rng = np.random.default_rng(2)
    objs = [{"t": int(rng.integers(0, 1 << 62)), "d": "/x", "e": "create",
             "o": None, "n": {"a": [1.5, -3, b"\x00\x01", "é" * int(rng.integers(0, 40))]}}
            for _ in range(40)]
    data = b"".join(mpack.packb(o) for o in objs)
    assert data == b"".join(msgpack.packb(o, use_bin_type=True) for o in objs)
    for cut in (len(data), len(data) - 1, len(data) - 9, 3, 0):
        u = mpack.Unpacker(data[:cut])
        got = list(u)
        ref = msgpack.Unpacker(raw=False)
        ref.feed(data[:cut])
        want = list(ref)
        assert got == want
        assert u.tell() == sum(len(mpack.packb(o)) for o in want)
    with pytest.raises(ValueError):  # an invalid byte is no torn tail
        list(mpack.Unpacker(mpack.packb([1, 2]) + b"\xc1"))


# ------------------------------------------------------------ meta gate --


def _gate_store(pkg, tmp_path, limit):
    lsm, E = (jax_lsm, JEntry) if pkg == "jax" else (port_lsm, PEntry)
    store = lsm.LsmFilerStore(str(tmp_path / f"{pkg}.lsm"), memtable_limit=limit, fsync=False)
    return store, E


def _jax_arena():
    from seaweedfs_tpu.ops.ragged_lookup import DeviceColumnArena

    return DeviceColumnArena()


def _port_arena():
    from seaweedfs_tpu_torch.ops.ragged_lookup import DeviceColumnArena

    return DeviceColumnArena(device="cpu")


def _gates(pkg, store, arena, identity):
    if pkg == "jax":
        from seaweedfs_tpu.filer.meta_gate import MetaLookupGate
    else:
        from seaweedfs_tpu_torch.filer.meta_gate import MetaLookupGate
    return MetaLookupGate(store, arena=arena, identity_check=identity)


def _spine_scenario(pkg, tmp_path):
    """JAX tests/test_ragged_lookup.py::test_meta_gate_arena_kill_degrades_to_host:
    spine chains, tombstones, misses; cold, then warm, then killed."""
    store, E = _gate_store(pkg, tmp_path, 40)
    arena = _jax_arena() if pkg == "jax" else _port_arena()
    gate = _gates(pkg, store, arena, True)
    paths = []
    rounds = []
    try:
        for i in range(300):
            p = f"/b/dir{i % 9}/f-{i}"
            store.insert_entry(E(full_path=p))
            paths.append(p)
        for p in paths[:8]:
            store.delete_entry(p)

        async def spine_round():
            futs = [gate.lookup_many([p, "/b", f"/b/dir{i % 9}", f"/miss-{i}"])
                    for i, p in enumerate(paths[5:90])]
            rs = await asyncio.gather(*futs)
            rounds.append([[None if e is None else e.to_dict() for e in r] for r in rs])

        async def main():
            await spine_round()  # cold
            arena.refresh_sync()
            await spine_round()  # warm
            dev = gate.stats["device_batches"]
            arena.kill()
            await spine_round()  # killed
            return dev

        dev = asyncio.run(main())
        return rounds, dev, dict(gate.stats)
    finally:
        gate.close()
        arena.close()
        store.close()


def test_meta_gate_spines_cold_warm_killed_equal_jax(tmp_path):
    jr, jdev, jst = _spine_scenario("jax", tmp_path)
    pr, pdev, pst = _spine_scenario("port", tmp_path)
    assert pr == jr
    assert pdev > 0 and jdev > 0
    assert pst["identity_mismatches"] == jst["identity_mismatches"] == 0
    assert pst["host_fallbacks"] == jst["host_fallbacks"] > 0
    assert pst["probes"] == jst["probes"]


def _tombstone_scenario(pkg, tmp_path):
    """JAX test_filer_tombstone_and_memtable_shadowing."""
    store, E = _gate_store(pkg, tmp_path, 20)
    arena = _jax_arena() if pkg == "jax" else _port_arena()
    gate = _gates(pkg, store, arena, False)
    try:
        paths = [f"/d/f-{i}" for i in range(60)]
        for p in paths:
            store.insert_entry(E(full_path=p))
        store.delete_entry(paths[0])
        store.insert_entry(E(full_path=paths[1], extended={"v": "new"}))
        arena.ensure(store.arena_view(paths)[1])
        arena.refresh_sync()

        async def main():
            r = await gate.lookup_many([paths[0], paths[1], paths[2], "/d/none"])
            return [None if e is None else e.to_dict() for e in r]

        got = asyncio.run(main())
        return got, gate.stats["device_batches"]
    finally:
        gate.close()
        arena.close()
        store.close()


def test_meta_gate_memtable_shadowing_equal_jax(tmp_path):
    jr, jdev = _tombstone_scenario("jax", tmp_path)
    pr, pdev = _tombstone_scenario("port", tmp_path)
    assert pr == jr and pr[0] is None and pr[1]["extended"] == {"v": "new"}
    assert pr[3] is None and pdev == jdev > 0


# ------------------------------------------------- the port's own rules --


def _warm_port_gate(tmp_path, identity=False):
    from seaweedfs_tpu_torch.filer.meta_gate import MetaLookupGate

    store = port_lsm.LsmFilerStore(str(tmp_path / "r.lsm"), memtable_limit=16, fsync=False)
    for i in range(64):
        store.insert_entry(PEntry(full_path=f"/r/f{i}"))
    arena = _port_arena()
    arena.ensure(store.arena_view([])[1])
    arena.refresh_sync()
    return store, arena, MetaLookupGate(store, arena=arena, identity_check=identity)


def test_port_gate_dispatch_error_fails_the_waiters(tmp_path):
    store, arena, gate = _warm_port_gate(tmp_path)

    def boom(groups, timings=None):
        raise RuntimeError("launch failed")

    arena.probe_groups = boom
    try:
        async def main():
            return await asyncio.gather(gate.lookup("/r/f1"), gate.lookup_many(["/r", "/r/f2"]),
                                        return_exceptions=True)

        got = asyncio.run(main())
        assert all(isinstance(r, RuntimeError) and "launch failed" in str(r) for r in got)
        assert gate.stats["host_fallbacks"] == 0
    finally:
        gate.close()
        arena.close()
        store.close()


def test_port_gate_identity_mismatch_raises(tmp_path):
    from seaweedfs_tpu_torch.server.lookup_gate import IdentityMismatch

    store, arena, gate = _warm_port_gate(tmp_path, identity=True)
    real = store.arena_decode
    store.arena_decode = lambda seg, row, path: (True, dict(real(seg, row, path)[1],
                                                            extended={"x": "wrong"}))
    try:
        async def main():
            return await asyncio.gather(gate.lookup("/r/f3"), return_exceptions=True)

        (got,) = asyncio.run(main())
        assert isinstance(got, IdentityMismatch)
        assert gate.stats["identity_mismatches"] == 1
    finally:
        gate.close()
        arena.close()
        store.close()


def test_port_gate_identity_check_holds_under_concurrent_writes(tmp_path):
    """Flushes of 80 distinct paths (each on an executor thread) while
    another thread overwrites, deletes and re-creates those paths: the
    identity check sees one store state, so no write in flight reads as a
    mismatch, and every answer is one the writer wrote."""
    import threading

    store, arena, gate = _warm_port_gate(tmp_path, identity=True)
    store.prefetch_arena = arena
    paths = [f"/r/f{i}" for i in range(80)]
    stop = threading.Event()
    rounds = []

    def writer():
        k = 0
        while not stop.is_set():
            k += 1
            store.insert_many([PEntry(full_path=p, extended={"v": str(k)}) for p in paths])
            for p in paths[k % 7::7]:
                store.delete_entry(p)

    async def main():
        for _ in range(40):
            got = await gate.lookup_many(paths)
            rounds.append(got)
            await asyncio.sleep(0)

    t = threading.Thread(target=writer)
    t.start()
    try:
        asyncio.run(main())
    finally:
        stop.set()
        t.join()
    try:
        assert gate.stats["identity_mismatches"] == 0
        assert gate.stats["device_batches"] > 0
        for got in rounds:
            assert all(e is None or e.full_path == p for p, e in zip(paths, got))

        async def last():
            return await gate.lookup_many(paths)

        final = asyncio.run(last())
        want = store.find_many(paths)
        assert [None if e is None else e.to_dict() for e in final] == [
            None if p not in want else want[p].to_dict() for p in paths]
    finally:
        store.prefetch_arena = None
        gate.close()
        arena.close()
        store.close()


def test_port_prefetch_error_is_raised_by_the_next_probe(tmp_path):
    store, arena, gate = _warm_port_gate(tmp_path)
    store.prefetch_arena = arena

    def bad_prefetch(seg):
        raise ValueError("columns broke")

    arena.prefetch = bad_prefetch
    try:
        for i in range(16):  # seals a run: the hint fails, the write does not
            store.insert_entry(PEntry(full_path=f"/r/g{i}"))
        assert store.find_entry("/r/g3") is not None
        assert arena.counters["errors"] == 1

        async def main():
            return await asyncio.gather(gate.lookup("/r/f1"), return_exceptions=True)

        (got,) = asyncio.run(main())
        assert isinstance(got, RuntimeError) and "prefetch failed" in str(got)
        assert "columns broke" in str(got.__cause__)
    finally:
        gate.close()
        arena.close()
        store.close()


def test_port_prefetch_without_an_arena_is_a_counted_skip(tmp_path):
    store = port_lsm.LsmFilerStore(str(tmp_path / "s.lsm"), memtable_limit=8, fsync=False)
    try:
        seen = []
        real = port_lsm._arena_prefetch_hint
        port_lsm._arena_prefetch_hint = lambda seg, arena=None: seen.append(real(seg, arena))
        for i in range(8):
            store.insert_entry(PEntry(full_path=f"/s/f{i}"))
        assert seen == ["no_arena"]
    finally:
        port_lsm._arena_prefetch_hint = real
        store.close()


def test_port_default_gate_raises_without_a_card(tmp_path, monkeypatch):
    import torch

    from seaweedfs_tpu_torch.ops import ragged_lookup as rl
    from seaweedfs_tpu_torch.server.filer import FilerServer

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default gate runs on it")
    monkeypatch.delenv("SEAWEEDFS_TPU_META_GATE", raising=False)
    monkeypatch.setattr(rl, "_DEFAULT", None)
    with pytest.raises(RuntimeError, match="SEAWEEDFS_TPU_META_GATE"):
        FilerServer("127.0.0.1:1", store_path=str(tmp_path / "f.lsm"))
    # the store's lock was never taken: the host gate opens it
    monkeypatch.setenv("SEAWEEDFS_TPU_META_GATE", "1")
    fs = FilerServer("127.0.0.1:1", store_path=str(tmp_path / "f.lsm"))
    assert fs.meta_gate is not None and fs.meta_gate.arena is None
    fs.filer.store.close()
    monkeypatch.setenv("SEAWEEDFS_TPU_META_GATE", "bogus")
    with pytest.raises(ValueError):
        FilerServer("127.0.0.1:1")


def test_port_server_filer_shares_the_volume_arena(monkeypatch, tmp_path):
    from seaweedfs_tpu_torch.command import cli

    got = {}

    async def fake_run(*servers, started=None):
        got["servers"] = servers

    monkeypatch.setattr(cli, "_run_forever", fake_run)
    monkeypatch.delenv("SEAWEEDFS_TPU_META_GATE", raising=False)
    assert cli.cmd_server(["-dir", str(tmp_path), "-port", "1", "-volumePort", "2",
                           "-storageBackend", "cpu", "-batchLookup", "arena", "-index", "lsm",
                           "-filer", "-filerPort", "3"]) == 0
    ms, vs, fs = got["servers"]
    assert fs.meta_gate_mode == "device"
    assert fs.meta_gate.arena is vs.lookup_arena and vs.lookup_arena.device.type == "cpu"
    vs.store.close()


def test_port_arena_generation_holds_filer_and_needle_runs(tmp_path):
    """One arena, one generation: a filer store's sealed runs beside an LSM
    needle map's; each probe group answers from its own rows only."""
    from seaweedfs_tpu_torch.storage.needle_map.lsm_map import LsmNeedleMap

    store = port_lsm.LsmFilerStore(str(tmp_path / "f.lsm"), memtable_limit=32, fsync=False)
    nm = LsmNeedleMap(str(tmp_path / "n.idx"), memtable_bytes=1)
    arena = _port_arena()
    try:
        paths = [f"/p/f{i}" for i in range(100)]
        for p in paths:
            store.insert_entry(PEntry(full_path=p))
        hashes = [port_lsm.path_hash64(*port_fs._split(p)) for p in paths]
        # the needle map holds the same u64 keys: only the group bound
        # keeps each probe on its own rows
        more = np.random.default_rng(4).integers(1, 1 << 62, 2100).tolist()
        nkeys = hashes + more
        for lo in range(0, len(nkeys), 1100):  # sealed runs (the memtable holds 1,024)
            nm.put_batch((k, 7 + j, 100 + j) for j, k in enumerate(nkeys[lo:lo + 1100], lo))
        fsegs = store.arena_view([])[1]
        nsegs = nm.arena_view([])[1]
        assert fsegs and nsegs
        arena.ensure(fsegs + nsegs)
        arena.refresh_sync()
        gen = arena.ensure(fsegs + nsegs)
        assert gen is not None and len(gen.seg) == len(fsegs) + len(nsegs)
        keys = np.array(hashes[:96] + [12345], dtype=np.uint64)
        rf, rn = arena.probe_groups([(fsegs, keys), (nsegs, keys)])
        for j, k in enumerate(keys.tolist()):
            if j < 96:
                seg = fsegs[int(rf["rank"][j])]
                assert rf["found"][j] and seg.source.keys[int(rf["off"][j])] == \
                    port_fs._split(paths[j])
                assert rn["found"][j] and int(rn["size"][j]) == 100 + j
                assert int(rn["off"][j]) == nm.get(k).offset_units
            else:
                assert not rf["found"][j] and not rn["found"][j]
    finally:
        arena.close()
        nm.close()
        store.close()


@pytest.mark.parametrize("flag", [
    ["-geoSource", "a:1"], ["-geoState", "s"], ["-notifySink", "log"],
    ["-notifyUrl", "u"], ["-notifyBroker", "b:1"], ["-notifyTopic", "t"],
    ["-notifyEndpoint", "e:1"], ["-notifyBucket", "k"], ["-notifyAccessKey", "a"],
    ["-notifySecretKey", "s"], ["-encryptVolumeData"],
])
def test_port_filer_refuses_flags_still_to_port(flag):
    from seaweedfs_tpu_torch.command import cli

    with pytest.raises(SystemExit) as ei:
        cli.cmd_filer(flag)
    assert ei.value.code == 2


def test_port_server_refuses_s3():
    from seaweedfs_tpu_torch.command import cli

    with pytest.raises(SystemExit) as ei:
        cli.cmd_server(["-s3"])
    assert ei.value.code == 2
