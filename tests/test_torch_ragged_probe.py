"""K2's probe over the arena (seaweedfs_tpu_torch.ops.ragged_lookup: the
generation's 16-byte rows, bucket tables and run descriptors, LaunchPlan,
and _ragged_probe_torch, the kernel's plain version, which a generation on
the CPU runs) against the JAX arena's probe_groups and against the port's
plane form (pack_members, _ragged_dispatch_torch and the host's
newest-wins fold): key 0 against the padding rows, a key equal to the next
segment's first row, segments left unbucketed (under 4,096 rows, keys
near 2^64) and bucketed over a span of 2^62 or more, duplicates across runs, bloom false positives, R = 1, 7 and 33, empty groups and
keys at 2^64 - 1. Tolerance: exact equality."""

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import ragged_lookup as jax_rl
from seaweedfs_tpu_torch.ops import ragged_lookup as rl
from seaweedfs_tpu_torch.storage.needle_map import lsm_map

TOP = (1 << 64) - 1


def _bloom(keys):
    """The LSM sidecar's bitmap of `keys` as LE u32 words, and its bits."""
    mbits, _k = lsm_map._bloom_geometry(len(keys))
    h = lsm_map.mix64_batch(keys)
    bits = np.zeros(mbits >> 3, dtype=np.uint8)
    mask = np.uint64(mbits - 1)
    h1, h2 = h & mask, (h >> np.uint64(32)) | np.uint64(1)
    for i in range(2):
        pos = (h1 + np.uint64(i) * h2) & mask
        np.bitwise_or.at(bits, (pos >> np.uint64(3)).astype(np.int64),
                         np.uint8(1) << (pos & np.uint64(7)).astype(np.uint8))
    return bits.view("<u4"), mbits


def _keys(rng, n, hi):
    """n distinct sorted u64 keys in [1, hi)."""
    u = np.unique(rng.integers(1, hi, n + n // 4 + 16, dtype=np.uint64))
    return u[np.sort(rng.choice(len(u), n, replace=False))]


def _spec(keys, rng, bloom):
    keys = np.asarray(keys, dtype=np.uint64)
    offs = rng.integers(1, 1 << 32, size=len(keys), dtype=np.uint64).astype(np.uint32)
    sizes = rng.integers(1, 1 << 32, size=len(keys), dtype=np.uint64).astype(np.uint32)
    words, mbits = _bloom(keys) if bloom and len(keys) else (None, 0)
    return keys, offs, sizes, words, mbits


def _mix(rng):
    """The segment mix of test_torch_ragged_lookup.py (sizes 0 to 5,000,
    bloom filters on the larger ones)."""
    out = []
    for c in (0, 1, 3, 97, 800, 5000):
        keys = np.sort(rng.choice(np.arange(1, 1_000_000, dtype=np.uint64), c, replace=False))
        out.append(_spec(keys, rng, c >= 97))
    return out


def _edge_specs(rng):
    """Named segments for the edge cases, in generation order."""
    mix = _mix(rng)
    # a full page of rows (unbucketed) and 2 pages (bucketed), each
    # followed straight by a segment whose first key is above all of theirs
    page = _keys(rng, rl.PAGE, 1 << 40)
    two = _keys(rng, 2 * rl.PAGE, 1 << 40)
    after = np.asarray([(1 << 40) + 5, (1 << 40) + 9], dtype=np.uint64)
    # a span of 2^62 or more holding 2^64 - 1 (unbucketed: its keys reach
    # 2^64), and one over the whole u64 range as a filer's path hashes
    # (bucketed)
    hashes = _keys(rng, 6000, (1 << 64) - (1 << 30))
    wide = np.unique(np.concatenate([
        rng.integers(1, 1 << 63, 4500, dtype=np.uint64) * np.uint64(2),
        np.asarray([TOP, TOP - 1], dtype=np.uint64)]))
    # an older run of the 5,000-row segment's keys, and one that shares
    # half of them: duplicates across runs
    dup_keys = np.sort(np.concatenate([mix[5][0][::2], np.arange(2_000_001, 2_000_400,
                                                                 dtype=np.uint64)]))
    specs = {f"m{i}": s for i, s in enumerate(mix)}
    specs.update({
        "page": _spec(page, rng, False), "after_page": _spec(after, rng, False),
        "two": _spec(two, rng, False), "after_two": _spec(after + np.uint64(1), rng, True),
        "wide": _spec(wide, rng, True), "hashes": _spec(hashes, rng, False),
        "dup": _spec(dup_keys, rng, True),
        "dup_all": _spec(mix[5][0], rng, False),
    })
    for i in range(33):  # R = 33: more runs than a warp has lanes
        specs[f"r{i}"] = _spec(np.sort(rng.choice(np.arange(1, 3000, dtype=np.uint64), 3,
                                                  replace=False)), rng, False)
    return specs


def _edge_groups(segs, specs, rng):
    """(segments newest first, keys) groups covering the edge cases."""
    known = np.concatenate([specs[n][0][rng.integers(0, len(specs[n][0]), 20)]
                            for n in specs if len(specs[n][0])])
    absent = rng.integers(1, 3_000_000, 300, dtype=np.uint64)
    edge = np.asarray([0, TOP, TOP - 1, TOP - 2, 1 << 63, (1 << 40) + 5, (1 << 40) + 6,
                       (1 << 40) + 9, (1 << 40) + 10], dtype=np.uint64)
    probes = np.concatenate([known, absent, edge])
    mix = [segs[f"m{i}"] for i in range(6)]
    runs33 = [segs[f"r{i}"] for i in range(33)]
    return [
        (mix[::-1] + [segs["wide"]], probes),  # R = 7
        ([segs["page"]], edge),  # R = 1: the next segment's first key, key 0
        ([segs["two"]], edge),
        ([segs["page"], segs["after_page"]], edge),
        ([segs["two"], segs["after_two"], segs["wide"]], probes[-40:]),
        ([segs["hashes"], segs["wide"]], probes),
        ([segs["dup"], segs["dup_all"], segs["m5"]], probes),  # duplicates: newest wins
        (mix, np.zeros(0, dtype=np.uint64)),  # an empty group
        ([], probes[:5]),  # a group with no runs
        (runs33, np.concatenate([specs[f"r{i}"][0] for i in range(33)] + [probes[:20]])),
        ([segs["m4"]], probes[:1]),
    ]


def _arena(mod, specs, kw):
    segs = {n: mod.ArenaSegment(k, o, s, bloom_words=w, bloom_mbits=m)
            for n, (k, o, s, w, m) in specs.items()}
    arena = mod.DeviceColumnArena(**kw)
    arena.ensure(list(segs.values()))
    arena.refresh_sync()
    return arena, segs


def _plane_answers(gen, groups):
    """The port's plane form: pack_members, _ragged_dispatch_torch and the
    host's newest-wins fold (the JAX arena's _dispatch_members)."""
    members = [(gi, s, np.asarray(k, dtype=np.uint64))
               for gi, (s, k) in enumerate(groups) if len(s) and len(k)]
    total = sum(len(k) * len(s) for _gi, s, k in members)
    u32 = np.zeros((4, total), dtype=np.uint32)
    i32 = np.zeros((5, total), dtype=np.int32)
    blocks = rl.pack_members(gen, members, u32, i32)
    off, size, found = rl._ragged_dispatch_torch(
        gen.steps, gen.keys, gen.offs, gen.sizes, gen.bloom,
        torch.from_numpy(u32.view(np.int32)), torch.from_numpy(i32))
    return dict(rl.fold_newest(found.numpy(), off.numpy().view(np.uint32),
                               size.numpy().view(np.uint32), blocks))


def _assert_equal(a, b, what):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (what, k)


def test_probe_equals_jax_and_plane_form_on_edge_cases():
    """The edge cases through the port's probe_groups, the JAX arena's and
    the port's plane form: equal everywhere, with each case seen."""
    specs = _edge_specs(np.random.default_rng(7))
    got = {}
    for name, mod, kw in (("jax", jax_rl, {}), ("port", rl, {"device": "cpu"})):
        arena, segs = _arena(mod, specs, kw)
        try:
            groups = _edge_groups(segs, specs, np.random.default_rng(8))
            got[name] = arena.probe_groups(groups)
            if name == "port":
                gen = arena._gen
                plane = _plane_answers(gen, groups)
        finally:
            arena.close()
    port = got["port"]
    for gi, (a, b) in enumerate(zip(got["jax"], port)):
        _assert_equal(a, b, f"jax, group {gi}")
        if gi in plane:
            _assert_equal(plane[gi], b, f"plane form, group {gi}")
    # the layout the cases need: the next segment right after the last row
    for first, nxt in (("page", "after_page"), ("two", "after_two")):
        s, base = gen.seg[segs[first].handle][:2]
        assert gen.seg[segs[nxt].handle][1] == base + s.count
    assert segs["page"].probe_geometry is None and segs["two"].probe_geometry is not None
    assert segs["wide"].probe_geometry is None and segs["m5"].probe_geometry is not None
    kmin, bstep, nb = segs["hashes"].probe_geometry
    assert bstep * nb >= 1 << 62  # bucketed over a span of 2^62 or more
    # the cases, seen in the answers
    edge = [int(k) for k in _edge_groups(segs, specs, np.random.default_rng(8))[1][1]]
    for gi in (1, 2):  # alone, neither finds the next segment's first key nor key 0
        assert not port[gi]["found"].any()
    g3 = dict(zip(edge, zip(port[3]["found"], port[3]["rank"])))
    assert g3[(1 << 40) + 5] == (True, 1) and g3[(1 << 40) + 9] == (True, 1)
    assert not g3[0][0] and not g3[(1 << 40) + 6][0]
    g0 = port[0]
    keys0 = _edge_groups(segs, specs, np.random.default_rng(8))[0][1]
    top = np.flatnonzero(keys0 == np.uint64(TOP))
    assert g0["found"][top].all() and (g0["rank"][top] == 6).all()  # 2^64 - 1, the wide run
    assert not g0["found"][keys0 == 0].any()
    assert port[5]["found"].sum() > 20  # the hashes' run
    dup = port[6]
    assert set(np.unique(dup["rank"][dup["found"]]).tolist()) == {0, 1}
    assert dup["found"].sum() > 30
    assert len(port[7]["found"]) == 0 and not port[8]["found"].any()
    assert port[9]["found"][:99].all() and port[9]["rank"].max() >= 32  # R = 33


def test_bloom_false_positives_are_not_found():
    """Absent keys that pass a run's bloom filter are searched and not
    found, as in the plane form; present keys pass every filter."""
    rng = np.random.default_rng(3)
    specs = {f"m{i}": s for i, s in enumerate(_mix(rng))}
    arena, segs = _arena(rl, specs, {"device": "cpu"})
    try:
        gen = arena._gen
        filtered = [segs[f"m{i}"] for i in (3, 4, 5)]
        keys = np.concatenate([segs["m5"].keys[:50],
                               rng.integers(2_000_000, 3_000_000, 4000, dtype=np.uint64)])
        members = [(0, filtered, keys)]
        plan = rl.LaunchPlan(members)
        found, rank, off, size, slot = rl._ragged_probe_torch(
            gen.rows, gen.tables, gen.bloom, *plan.tensors(gen), with_index=True)
        passed = slot["present"] & ~slot["found"]
        assert int(passed.sum()) > 0  # false positives, searched
        assert bool(slot["present"][slot["found"]].all())
        assert found[:50].all() and not found[50:].any()
        res = arena.probe_groups([(filtered, keys)])[0]
        _assert_equal(_plane_answers(gen, [(filtered, keys)])[0], res, "plane form")
    finally:
        arena.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_probe_equals_plane_form_on_random_groups(seed):
    """Random groups over the segment mix (any order, R of 1 to 6, repeated
    keys): the probe's answers equal the plane form's."""
    rng = np.random.default_rng(seed)
    specs = {f"m{i}": s for i, s in enumerate(_mix(rng))}
    arena, segs = _arena(rl, specs, {"device": "cpu"})
    try:
        pool = list(segs.values())
        known = np.concatenate([s.keys for s in pool if s.count])
        groups = []
        for _ in range(6):
            r = int(rng.integers(1, 7))
            runs = [pool[i] for i in rng.choice(len(pool), r, replace=False)]
            k = int(rng.integers(1, 300))
            keys = np.where(rng.random(k) < 0.6, known[rng.integers(0, len(known), k)],
                            rng.integers(0, 1_500_000, k, dtype=np.uint64))
            groups.append((runs, keys.astype(np.uint64)))
        res = arena.probe_groups(groups)
        plane = _plane_answers(arena._gen, groups)
        for gi, r in enumerate(res):
            _assert_equal(plane[gi], r, f"group {gi}")
        assert sum(int(r["found"].sum()) for r in res) > 50
    finally:
        arena.close()


@pytest.mark.parametrize("runs", [1, 2, 3, 4, 7, 32, 33])
def test_launch_plan_records(runs):
    """LaunchPlan's words: each group's run descriptors newest first, block
    records that cover every key once at BLOCK_THREADS // lanes keys a
    block, and the keys."""
    rng = np.random.default_rng(runs)
    specs = {f"r{i}": _spec(np.sort(rng.choice(np.arange(1, 500, dtype=np.uint64), 5,
                                               replace=False)), rng, i % 2 == 0)
             for i in range(runs + 1)}
    arena, segs = _arena(rl, specs, {"device": "cpu"})
    try:
        gen = arena._gen
        pool = list(segs.values())
        members = [(0, pool[:runs], rng.integers(0, 500, 300, dtype=np.uint64)),
                   (3, pool[::-1][:1], np.asarray([7], dtype=np.uint64)),
                   (5, pool[1:runs + 1][::-1], rng.integers(0, 500, 129, dtype=np.uint64))]
        plan = rl.LaunchPlan(members)
        keys, blocks, descs = plan.tensors(gen)
        assert plan.n_keys == 430 and plan.slots == 300 * runs + 1 + 129 * runs
        want = [gen.desc[gen.seg[s.handle][3]] for _g, ss, _k in members for s in ss]
        assert np.array_equal(descs.numpy(), np.stack(want))
        assert np.array_equal(keys.numpy().view(np.uint64),
                              np.concatenate([k for _g, _s, k in members]))
        lanes = min(1 << (runs - 1).bit_length(), 32)
        covered = np.zeros(plan.n_keys, dtype=np.int64)
        for key0, n, run0, r in blocks.numpy().tolist():
            assert r in (runs, 1) and 1 <= n <= rl.BLOCK_THREADS // (lanes if r == runs else 1)
            assert run0 == {0: 0, 300: runs, 301: runs + 1}[
                key0 if key0 in (300, 301) else (0 if key0 < 300 else 301)]
            covered[key0 : key0 + n] += 1
        assert (covered == 1).all()
        assert [(gi, a, k) for gi, a, k in plan.spans] == [(0, 0, 300), (3, 300, 1), (5, 301, 129)]
    finally:
        arena.close()


def test_generation_counts_bucket_tables():
    """The generation's bytes count its rows, bucket tables, bloom words and
    descriptors; a bucketed segment's table takes at most 2 bytes a row and
    is counted in the segment's bytes, which the LRU budget reads."""
    rng = np.random.default_rng(5)
    specs = {}
    for c in (4096, 4097, 5000, 70_001, 4095, 10):
        keys = _keys(rng, c, 1 << 34)
        specs[str(c)] = _spec(keys, rng, c == 5000)
    arena, segs = _arena(rl, specs, {"device": "cpu"})
    try:
        gen = arena._gen
        rows = 0
        for name, s in segs.items():
            c = int(name)
            bloom = len(s.bloom_words) * 4 if s.bloom_words is not None else 0
            assert s.nbytes == 16 * c + bloom + s.table_bytes
            if c >= rl.ArenaSegment.MIN_BUCKETED:
                starts = s.probe_starts()
                assert s.table_bytes == 4 * len(starts) <= 2 * c
                assert starts[0] == 0 and starts[-1] == c and (np.diff(starts) >= 0).all()
                # a bucket holds about two rows
                assert np.diff(starts).mean() <= 2.01
            else:
                assert s.table_bytes == 0 and s.probe_starts() is None
            rows += c
        tables = sum(s.table_bytes for s in segs.values())
        assert 0 < tables <= 2 * rows
        assert gen.tables.numel() * 4 == tables
        assert gen.nbytes == (gen.rows.numel() * 8 + tables + gen.bloom.numel() * 4
                              + gen.desc.nbytes)
        assert arena.stats()["resident_bytes"] == gen.nbytes
    finally:
        arena.close()
    # the LRU budget counts the tables: a budget for the rows of both but
    # one table evicts
    a, b = segs["70001"], segs["5000"]
    small = rl.DeviceColumnArena(budget_bytes=a.nbytes + b.nbytes - 1, device="cpu")
    try:
        small.ensure([a, b])
        small.refresh_sync()
        assert small.counters["evictions"] >= 1
        assert small.stats()["resident_segments"] == 1
    finally:
        small.close()


def test_mix64_torch_equals_the_lsm_hash():
    """The plain version's murmur3 finalizer equals the LSM sidecar's, bit
    for bit, across the u64 range."""
    rng = np.random.default_rng(9)
    keys = np.concatenate([rng.integers(0, TOP, 5000, dtype=np.uint64, endpoint=True),
                           np.asarray([0, 1, TOP, 1 << 63, (1 << 63) - 1], dtype=np.uint64)])
    got = rl._mix64_torch(torch.from_numpy(keys.view(np.int64))).numpy().view(np.uint64)
    assert np.array_equal(got, lsm_map.mix64_batch(keys))


def test_probe_path_packs_no_planes_and_the_kernel_takes_only_the_card(monkeypatch):
    """probe_groups never packs planes or folds per-slot answers, and the
    kernel's wrapper refuses CPU tensors instead of running anything else."""
    rng = np.random.default_rng(11)
    specs = {f"m{i}": s for i, s in enumerate(_mix(rng))}
    arena, segs = _arena(rl, specs, {"device": "cpu"})
    try:
        gen = arena._gen
        for name in ("pack_members", "_ragged_dispatch_torch", "fold_newest"):
            monkeypatch.setattr(rl, name, lambda *a, **k: 1 / 0)
        pool = list(segs.values())
        res = arena.probe_groups([(pool, pool[5].keys[:100])])[0]
        assert res["found"].all()
        plan = rl.LaunchPlan([(0, pool, pool[5].keys[:100])])
        with pytest.raises(ValueError, match="CUDA"):
            rl._ragged_probe_cuda(gen.rows, gen.tables, gen.bloom, *plan.tensors(gen))
        assert rl._LIB is None
    finally:
        arena.close()
