"""The port's ragged-batch lookup plane (seaweedfs_tpu_torch.ops.ragged_lookup,
the LSM needle map and the lookup gate) against the JAX package's:

- the host packing of a wakeup's probe planes equals the JAX arena's, and
  `_ragged_dispatch_torch` equals the `_ragged_dispatch` jit program on
  the same generation and planes;
- `probe_groups` answers equal across packages on LSM runs the JAX map
  wrote, and LSM run, bloom and manifest files read across packages both
  ways (the manifest bytes are msgpack's);
- the segment-end bound, a refresh racing probes, LRU eviction, and the
  gate over the arena answering as the JAX gate does, degrading to host
  answers when the arena is killed; a failed dispatch, a failed refresh
  and an identity-check disagreement reach the waiters as errors
  (counted), never as host answers.
Tolerance: exact equality."""

import asyncio
import os
import threading

import msgpack
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import ragged_lookup as jax_rl
from seaweedfs_tpu.server import lookup_gate as jax_lg
from seaweedfs_tpu.storage.needle_map import lsm_map as jax_lsm
from seaweedfs_tpu_torch.ops import ragged_lookup as rl
from seaweedfs_tpu_torch.server import lookup_gate as lg
from seaweedfs_tpu_torch.storage.needle_map import lsm_map
from seaweedfs_tpu_torch.types import TOMBSTONE_FILE_SIZE
from seaweedfs_tpu_torch.util import metrics, mpack


def _segment_specs(rng, counts=(0, 1, 3, 97, 800, 5000)):
    """Sorted segments of the given sizes; the larger ones carry a bloom
    bitmap built as the LSM map builds its sidecar."""
    specs = []
    for c in counts:
        keys = (np.sort(rng.choice(np.arange(1, 1_000_000, dtype=np.uint64), c, replace=False))
                if c else np.zeros(0, dtype=np.uint64))
        offs = rng.integers(1, 1 << 30, size=c).astype(np.uint32)
        sizes = rng.integers(1, 1 << 20, size=c).astype(np.uint32)
        words, mbits = None, 0
        if c >= 97:
            mbits, _k = lsm_map._bloom_geometry(c)
            h = lsm_map.mix64_batch(keys)
            bits = np.zeros(mbits >> 3, dtype=np.uint8)
            mask = np.uint64(mbits - 1)
            h1, h2 = h & mask, (h >> np.uint64(32)) | np.uint64(1)
            for i in range(2):
                pos = (h1 + np.uint64(i) * h2) & mask
                np.bitwise_or.at(bits, (pos >> np.uint64(3)).astype(np.int64),
                                 np.uint8(1) << (pos & np.uint64(7)).astype(np.uint8))
            words = bits.view("<u4")
        specs.append((keys, offs, sizes, words, mbits))
    return specs


def _groups(mod, specs, rng):
    segs = [mod.ArenaSegment(k, o, s, bloom_words=w, bloom_mbits=m) for k, o, s, w, m in specs]
    known = np.concatenate([s.keys[rng.integers(0, s.count, 5)] for s in segs if s.count])
    probes = np.concatenate([known, rng.integers(1, 2_000_000, 40, dtype=np.uint64),
                             np.asarray([0, (1 << 63) + 1], dtype=np.uint64)])
    return segs, [(segs[::-1], probes), (segs[1:4], probes[:7]), (segs[2:3], probes[:1])]


def test_packing_and_dispatch_equal_jax(monkeypatch):
    """One wakeup over ragged segments (empty, one-row, bloom-filtered):
    the port's pack_members packs the planes the JAX arena dispatches, its
    plain plane dispatch equals the jit program on the JAX generation, and
    the answers of both arenas' probe_groups are equal."""
    specs = _segment_specs(np.random.default_rng(0))
    seen = {}
    orig = jax_rl._ragged_dispatch

    def spy(steps, khi, klo, offs, sizes, bloom, u32p, i32p):
        seen["jax"] = (steps, khi, klo, offs, sizes, bloom, np.asarray(u32p), np.asarray(i32p))
        return orig(steps, khi, klo, offs, sizes, bloom, u32p, i32p)

    monkeypatch.setattr(jax_rl, "_ragged_dispatch", spy)
    answers = {}
    for name, mod, kw in (("jax", jax_rl, {}), ("port", rl, {"device": "cpu"})):
        segs, groups = _groups(mod, specs, np.random.default_rng(1))
        arena = mod.DeviceColumnArena(**kw)
        try:
            arena.ensure([s for s in segs])
            arena.refresh_sync()
            answers[name] = arena.probe_groups(groups)
            if name == "port":
                gen = arena._gen
                members = [(gi, s, np.asarray(k, dtype=np.uint64))
                           for gi, (s, k) in enumerate(groups)]
        finally:
            arena.close()
    steps, khi, klo, offs, sizes, bloom, ju32, ji32 = seen["jax"]
    total = sum(len(k) * len(s) for _gi, s, k in members)
    pu32 = np.zeros((4, total), dtype=np.uint32)
    pi32 = np.zeros((5, total), dtype=np.int32)
    rl.pack_members(gen, members, pu32, pi32)
    assert np.array_equal(ju32[:, :total], pu32)
    assert np.array_equal(ji32[:, :total], pi32)
    assert not ju32[:, total:].any() and not ji32[:, total:].any()  # JAX pad
    # the plain version on the JAX generation's columns and planes
    keys = (np.asarray(khi).astype(np.uint64) << np.uint64(32)) | np.asarray(klo)
    assert gen.steps == steps and np.array_equal(gen.keys.numpy().view(np.uint64), keys)
    want = orig(steps, khi, klo, offs, sizes, bloom, ju32, ji32)
    got = rl._ragged_dispatch_torch(
        steps, torch.from_numpy(keys.view(np.int64)),
        torch.from_numpy(np.array(offs).view(np.int32)),
        torch.from_numpy(np.array(sizes).view(np.int32)),
        torch.from_numpy(np.array(bloom).view(np.int32)),
        torch.from_numpy(ju32.view(np.int32)), torch.from_numpy(ji32))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy().view(np.asarray(w).dtype))
    for a, b in zip(answers["jax"], answers["port"]):
        for k in ("found", "rank", "off", "size"):
            assert np.array_equal(a[k], b[k]), k
    assert answers["port"][0]["found"].sum() > 10


def _jax_lsm(tmp_path, rng, vid, n=3000, deletes=25):
    nm = jax_lsm.LsmNeedleMap(os.path.join(str(tmp_path), f"v{vid}.idx"), memtable_bytes=1)
    keys = rng.choice(np.arange(1, 400_000, dtype=np.uint64), size=n, replace=False)
    for i, k in enumerate(keys.tolist()):
        nm.put(int(k), i + 1, 100 + (i % 50))
    for k in keys[:deletes].tolist():
        nm.delete(int(k), 0)
    return nm, keys


def _nv(v):
    return None if v is None else (v.key, v.offset_units, v.size)


def _files(base):
    d, b = os.path.split(base)
    return sorted(f for f in os.listdir(d) if f.startswith(b + ".nm") or f == b + ".idx")


def test_lsm_files_cross_read_and_manifest_bytes(tmp_path):
    """The same puts and deletes through each package's LSM map give the
    same .idx, run and bloom files, manifests equal but for `saved_at`,
    whose bytes are msgpack's; each package mounts the other's snapshot
    and answers alike."""
    rng = np.random.default_rng(4)
    keys = rng.choice(np.arange(1, 400_000, dtype=np.uint64), size=2500, replace=False)
    bases = {}
    for name, mod in (("jax", jax_lsm), ("port", lsm_map)):
        d = tmp_path / name
        d.mkdir()
        nm = mod.LsmNeedleMap(str(d / "7.idx"), memtable_bytes=1)
        nm.put_batch((int(k), i + 1, 100 + i % 9) for i, k in enumerate(keys[:1500].tolist()))
        for i, k in enumerate(keys[1500:].tolist()):
            nm.put(int(k), 5000 + i, 7)
        for k in keys[::40].tolist():
            nm.delete(int(k), 0)
        nm.close()
        bases[name] = str(d / "7")
    names = _files(bases["jax"])
    assert names == _files(bases["port"]) and any(".nmr-" in n for n in names)
    manifests = {}
    for fn in names:
        blobs = [open(os.path.join(os.path.dirname(b), fn), "rb").read() for b in bases.values()]
        if fn.endswith(".nmm"):
            manifests = [msgpack.unpackb(b, raw=False) for b in blobs]
            for b, mf in zip(blobs, manifests):
                assert mpack.unpackb(b) == mf
                assert mpack.packb(mf) == b == msgpack.packb(mf, use_bin_type=True)
            for mf in manifests:
                mf.pop("saved_at")
            assert manifests[0] == manifests[1]
        else:
            assert blobs[0] == blobs[1], fn
    # each mounts the other's files from the snapshot, and they agree
    probes = np.concatenate([keys, np.asarray([3, 400_001], dtype=np.uint64)]).tolist()
    for base, mod in ((bases["jax"], lsm_map), (bases["port"], jax_lsm)):
        nm = mod.LsmNeedleMap(base + ".idx")
        try:
            assert nm.loaded_from_snapshot
            other = (jax_lsm if mod is lsm_map else lsm_map).LsmNeedleMap(base + ".idx")
            try:
                for k in probes:
                    assert _nv(nm.get(k)) == _nv(other.get(k))
                for a, b in zip(nm.snapshot(), other.snapshot()):
                    assert np.array_equal(a, b)
            finally:
                other.close()
        finally:
            nm.close()


def test_probe_groups_equal_on_jax_written_runs(tmp_path):
    """LSM runs written by the JAX map, mounted by each package: both
    arenas' probe_groups give the same answers, and each answer is the
    host map's."""
    rng = np.random.default_rng(11)
    nm, keys = _jax_lsm(tmp_path, rng, 1)
    nm.close()
    probes = np.concatenate([keys[:400], rng.integers(1, 400_000, 100, dtype=np.uint64)])
    res = {}
    for name, mod, arena_mod, kw in (("jax", jax_lsm, jax_rl, {}),
                                     ("port", lsm_map, rl, {"device": "cpu"})):
        m = mod.LsmNeedleMap(os.path.join(str(tmp_path), "v1.idx"))
        arena = arena_mod.DeviceColumnArena(**kw)
        try:
            mem_hits, segs = m.arena_view(probes)
            assert len(segs) >= 2
            arena.ensure(segs)
            arena.refresh_sync()
            res[name] = (mem_hits, arena.probe_groups([(segs, probes)])[0])
            if name == "port":
                for i, k in enumerate(probes.tolist()):
                    hit = mem_hits.get(k) or (
                        (int(res[name][1]["off"][i]), int(res[name][1]["size"][i]))
                        if res[name][1]["found"][i] else None)
                    nv = m.get(k)
                    assert hit == (None if nv is None else (nv.offset_units, nv.size))
        finally:
            arena.close()
            m.close()
    assert res["jax"][0] == res["port"][0]
    for k in ("found", "rank", "off", "size"):
        assert np.array_equal(res["jax"][1][k], res["port"][1][k]), k


def test_segment_end_bound_blocks_cross_segment_match():
    """A probe whose own segment lacks the key must NOT match an equal
    key in the NEXT segment's rows; through both segments it is found in
    the second (rank 1)."""
    shared = np.asarray([500_000], dtype=np.uint64)
    a = rl.ArenaSegment(keys=np.asarray([1, 2], dtype=np.uint64),
                        offs=np.asarray([11, 12], dtype=np.uint32),
                        sizes=np.asarray([1, 1], dtype=np.uint32))
    b = rl.ArenaSegment(keys=shared, offs=np.asarray([99], dtype=np.uint32),
                        sizes=np.asarray([7], dtype=np.uint32))
    arena = rl.DeviceColumnArena(device="cpu")
    try:
        arena.ensure([a, b])
        arena.refresh_sync()
        res = arena.probe_groups([([a], shared), ([a], np.asarray([0], dtype=np.uint64))])
        assert not res[0]["found"][0] and not res[1]["found"][0]
        res2 = arena.probe_groups([([a, b], shared)])[0]
        assert res2["found"][0] and int(res2["rank"][0]) == 1
        assert int(res2["off"][0]) == 99
    finally:
        arena.close()


def test_refresh_race_probe_stays_identical():
    """Probes racing generation swaps keep returning identical answers:
    in-flight dispatches hold their (immutable) generation."""
    rng = np.random.default_rng(3)
    specs = _segment_specs(rng, counts=(3000, 900))
    segs = [rl.ArenaSegment(k, o, s) for k, o, s, _w, _m in specs]
    probes = np.concatenate([segs[0].keys[rng.integers(0, 3000, size=40)],
                             rng.integers(2_000_000, 3_000_000, size=8, dtype=np.uint64)])
    arena = rl.DeviceColumnArena(device="cpu")
    try:
        arena.ensure(segs)
        arena.refresh_sync()
        baseline = arena.probe_groups([(segs, probes)])[0]
        errs = []
        stop = threading.Event()

        def prober():
            while not stop.is_set():
                res = arena.probe_groups([(segs, probes)])[0]
                if res is None or any(
                    not np.array_equal(res[k], baseline[k]) for k in baseline
                ):
                    errs.append("diverged or went cold during refresh")
                    return

        t = threading.Thread(target=prober)
        t.start()
        try:
            for k, o, s, _w, _m in _segment_specs(rng, counts=(1200,) * 4):
                arena.ensure(segs + [rl.ArenaSegment(k, o, s)])
                arena.refresh_sync()
        finally:
            stop.set()
            t.join(10)
        assert not t.is_alive()
        assert not errs and arena.counters["errors"] == 0
    finally:
        arena.close()


def test_lru_eviction_under_byte_budget():
    rng = np.random.default_rng(5)
    (ka, oa, sa, _, _), (kb, ob, sb, _, _) = _segment_specs(rng, counts=(4000, 4000))
    seg_a, seg_b = rl.ArenaSegment(ka, oa, sa), rl.ArenaSegment(kb, ob, sb)
    budget = seg_a.nbytes + seg_b.nbytes // 2  # fits one, not both
    arena = rl.DeviceColumnArena(budget_bytes=budget, device="cpu")
    try:
        arena.ensure([seg_a])
        arena.refresh_sync()
        assert arena.probe_groups([([seg_a], seg_a.keys[:5])])[0] is not None
        arena.ensure([seg_b])
        arena.refresh_sync()
        assert arena.counters["evictions"] > 0
        assert arena.probe_groups([([seg_b], seg_b.keys[:5])])[0] is not None
        assert arena.probe_groups([([seg_a], seg_a.keys[:5])])[0] is None
        assert arena.stats()["resident_bytes"] <= budget
    finally:
        arena.close()


class _Vol:
    def __init__(self, nm):
        self.nm = nm


class _Store:
    def __init__(self, vols):
        self.vols = vols

    def find_volume(self, vid):
        return self.vols.get(vid)


def test_gate_over_arena_equals_jax_gate_and_degrades(tmp_path, monkeypatch):
    """Both gates over LSM maps the JAX package wrote: cold (host), warm
    (one dispatch per wakeup), then (port) a dispatch that raises: every
    waiter gets the error and the arena counts it; then a killed arena —
    every answer equal to the JAX gate's and to the host map's, no
    identity mismatch."""
    monkeypatch.setattr(lg, "_ARENA_MIN_WAKEUP", 8)
    monkeypatch.setattr(jax_lg, "_ARENA_MIN_WAKEUP", 8)
    rng = np.random.default_rng(12)
    plan = []
    for vid in (1, 2):
        nm, keys = _jax_lsm(tmp_path, rng, vid)
        nm.close()
        plan += [(vid, int(k)) for k in keys[rng.integers(0, len(keys), 120)]]
        plan += [(vid, int(k)) for k in rng.integers(1, 400_000, 30)]

    def run(gate_mod, lsm_mod, arena):
        store = _Store({vid: _Vol(lsm_mod.LsmNeedleMap(
            os.path.join(str(tmp_path), f"v{vid}.idx"))) for vid in (1, 2)})
        gate = gate_mod.BatchLookupGate(store, arena=arena, identity_check=True)
        rounds = []

        async def probe_round(expect_error=None):
            res = await asyncio.gather(*(gate.lookup(v, k) for v, k in plan),
                                       return_exceptions=expect_error is not None)
            if expect_error is not None:
                assert all(isinstance(r, expect_error) for r in res)
                return
            for (v, k), r in zip(plan, res):
                nv = store.vols[v].nm.get(k)
                want = (None if nv is None or nv.size == TOMBSTONE_FILE_SIZE
                        else (nv.offset_units, nv.size))
                assert r == want
            rounds.append(res)

        async def main():
            await probe_round()  # cold -> host
            arena.refresh_sync()
            await probe_round()  # warm -> device
            assert gate.stats["device_batches"] > 0
            if gate_mod is lg:
                counted = metrics.NEEDLE_MAP_DEVICE_ERRORS.value()
                fallbacks = gate.stats["host_fallbacks"]
                with monkeypatch.context() as mp:
                    mp.setattr(rl, "ragged_dispatch", lambda *a, **k: 1 / 0)
                    await probe_round(ZeroDivisionError)  # raises -> waiters
                assert arena.counters["errors"] >= 1
                assert "ZeroDivisionError" in arena.last_error
                assert metrics.NEEDLE_MAP_DEVICE_ERRORS.value() == (
                    counted + arena.counters["errors"])
                assert gate.stats["host_fallbacks"] == fallbacks
                await probe_round()  # the next wakeups are served again
            arena.kill()
            await probe_round()  # killed -> host
            assert gate.stats["identity_mismatches"] == 0
            assert gate.stats["host_fallbacks"] > 0

        try:
            asyncio.run(main())
        finally:
            gate.close()
            arena.close()
            for v in store.vols.values():
                v.nm.close()
        return rounds

    jax_rounds = run(jax_lg, jax_lsm, jax_rl.DeviceColumnArena())
    port_rounds = run(lg, lsm_map, rl.DeviceColumnArena(device="cpu"))
    assert port_rounds[0] == port_rounds[-1] == jax_rounds[0] == jax_rounds[-1]


def test_default_arena_needs_a_card(monkeypatch):
    """get_default_arena() is on the card: without CUDA it raises rather
    than quietly becoming a CPU arena."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(rl, "_DEFAULT", None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rl.get_default_arena()
    assert rl.peek_default_arena() is None


def test_failed_refresh_raises_on_next_probe(monkeypatch):
    """A refresh that raises is counted and raised again by the next
    probe_groups (and by refresh_sync) instead of leaving the arena to
    answer None for good; once the upload works, probes are answered."""
    rng = np.random.default_rng(21)
    segs = [rl.ArenaSegment(k, o, s) for k, o, s, _w, _m in _segment_specs(rng, (900,))]
    arena = rl.DeviceColumnArena(device="cpu")
    try:
        real = rl._Generation
        monkeypatch.setattr(rl, "_Generation", lambda *a: 1 / 0)
        assert arena.ensure(segs) is None  # queues the failing refresh
        arena._pool.submit(lambda: None).result()  # let it run
        assert arena.counters["errors"] == 1
        with pytest.raises(RuntimeError, match="refresh failed") as ei:
            arena.probe_groups([(segs, segs[0].keys[:4])])
        assert isinstance(ei.value.__cause__, ZeroDivisionError)
        with pytest.raises(RuntimeError, match="refresh failed"):
            arena.refresh_sync()
        assert arena.counters["errors"] == 2
        monkeypatch.setattr(rl, "_Generation", real)
        arena.refresh_sync()
        res = arena.probe_groups([(segs, segs[0].keys[:4])])[0]
        assert res is not None and res["found"].all()
    finally:
        arena.close()


def test_gate_identity_mismatch_fails_the_waiters(monkeypatch):
    """With identity_check on, an arena answer that differs from the host
    map is counted and reaches the volume's waiters as IdentityMismatch,
    never as either answer."""
    monkeypatch.setattr(lg, "_ARENA_MIN_WAKEUP", 8)

    class _Nm:
        def __init__(self, seg, table):
            self.seg, self.table = seg, table

        def arena_view(self, keys):
            return {}, [self.seg]

        def get(self, k):
            hit = self.table.get(k)
            return None if hit is None else _Nv(*hit)

    class _Nv:
        def __init__(self, offset_units, size):
            self.offset_units, self.size = offset_units, size

    keys = np.arange(1, 41, dtype=np.uint64) * 7
    offs = np.arange(1, 41, dtype=np.uint32)
    sizes = np.full(40, 100, dtype=np.uint32)
    seg = rl.ArenaSegment(keys, offs, sizes)
    table = {int(k): (int(o), int(s)) for k, o, s in zip(keys, offs, sizes)}
    arena = rl.DeviceColumnArena(device="cpu")
    arena.ensure([seg])
    arena.refresh_sync()
    real = arena.probe_groups

    def off_by_one(groups):
        res = real(groups)
        for r in res:
            r["off"] = r["off"] + np.uint32(1)
        return res

    arena.probe_groups = off_by_one
    gate = lg.BatchLookupGate(_Store({1: _Vol(_Nm(seg, table))}), arena=arena,
                              identity_check=True)
    assert not lg.BatchLookupGate(_Store({}), arena=arena).identity_check

    async def main():
        return await asyncio.gather(*(gate.lookup(1, int(k)) for k in keys[:20]),
                                    return_exceptions=True)

    try:
        res = asyncio.run(main())
    finally:
        gate.close()
        arena.close()
    assert all(isinstance(r, lg.IdentityMismatch) for r in res)
    assert gate.stats["identity_mismatches"] == 20
    assert gate.stats["host_fallbacks"] == 0
