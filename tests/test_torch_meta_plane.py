"""The port's prefix-sharded filer store and follower against the JAX
package's, on the CPU, store against store.

`ShardedFilerStore` under one op sequence (memory and LSM sub-stores):
the same lookups, the same listings in the same order, the same SHARDMAP
bytes, and the same `rebalance_once` split and moved count under a fixed
clock; the rebalance killed at every step of `REBALANCE_STEPS`, the store
reopened, then retried: the same entries and SHARDMAP as the JAX store
after each. `MetaFollower._apply` over one event list: the same store,
the same counters. A meta gate over the sharded store on an arena on the
CPU: the JAX gate's answers, every flush a counted host lookup with
reason `no_arena_view`."""

import asyncio
import json
import os

import numpy as np
import pytest

from seaweedfs_tpu.filer import entry as jax_entry
from seaweedfs_tpu.filer import filer_store as jax_stores
from seaweedfs_tpu.filer import sharded_store as jax_sharded
from seaweedfs_tpu_torch.filer import entry as port_entry
from seaweedfs_tpu_torch.filer import filer_store as port_stores
from seaweedfs_tpu_torch.filer import sharded_store as port_sharded

PKGS = {
    "jax": (jax_entry, jax_stores, jax_sharded),
    "port": (port_entry, port_stores, port_sharded),
}


def _factory(pkg, d, kind):
    _e, stores, _s = PKGS[pkg]
    if kind == "memory":
        return lambda name: stores.MemoryFilerStore()
    if pkg == "port":
        from seaweedfs_tpu_torch.filer.lsm_store import LsmFilerStore
    else:
        from seaweedfs_tpu.filer.lsm_store import LsmFilerStore
    # a small memtable: the sub-stores seal runs and compact
    return lambda name: LsmFilerStore(os.path.join(d, name + ".lsm"),
                                      memtable_limit=32, fsync=False)


def _open(pkg, d, kind, **kw):
    _e, _st, sh = PKGS[pkg]
    return sh.ShardedFilerStore(d, _factory(pkg, d, kind), 4, heat_half_life_s=600.0,
                                clock=lambda: 1000.0, **kw)


def _ops(pkg, seed: int):
    """A seeded op sequence: directories under each default shard band,
    files, overwrites, deletes and a subtree delete."""
    ent, _st, _sh = PKGS[pkg]
    rng = np.random.default_rng(seed)
    tops = ["/0a", "/4b", "/9c", "/hh", "/mm", "/rr", "/zz"]

    def mkdir(p):
        return ent.Entry(full_path=p, attr=ent.Attr(mtime=1.0, crtime=1.0, mode=0o40755))

    ops = [("insert", mkdir("/"))]
    for t in tops:
        ops.append(("insert", mkdir(t)))
        for j in range(int(rng.integers(2, 5))):
            d = f"{t}/d{j}"
            ops.append(("insert", mkdir(d)))
            for k in range(int(rng.integers(3, 9))):
                p = f"{d}/f{k:02d}"
                ops.append(("insert", ent.Entry(full_path=p, attr=ent.Attr(mtime=1.0),
                                                extended={"k": p})))
    for t in tops:
        ops.append(("update", ent.Entry(full_path=f"{t}/d0/f00", attr=ent.Attr(mtime=2.0),
                                        extended={"k": "updated"})))
        ops.append(("delete", f"{t}/d0/f01"))
    ops.append(("delete_children", "/mm/d1"))
    ops.append(("insert_many", [ent.Entry(full_path=f"/hh/d9/g{k}", attr=ent.Attr(mtime=3.0))
                                for k in range(12)]))
    return ops


def _apply(store, ops):
    for op, arg in ops:
        if op == "insert":
            store.insert_entry(arg)
        elif op == "update":
            store.update_entry(arg)
        elif op == "delete":
            store.delete_entry(arg)
        elif op == "delete_children":
            store.delete_folder_children(arg)
        else:
            store.insert_many(arg)


def _view(store, paths):
    """Lookups, every directory's paged listing, and the SHARDMAP bytes."""
    dirs = sorted({p.rsplit("/", 1)[0] or "/" for p in paths} | {"/"})
    out = {"find": {p: (e.to_dict() if e else None)
                    for p in paths for e in [store.find_entry(p)]},
           "find_many": {p: e.to_dict() for p, e in store.find_many(paths).items()}}
    for d in dirs:
        pages, start, incl = [], "", True
        while True:
            page = store.list_directory_entries(d, start, incl, 3)
            pages.append([e.full_path for e in page])
            if len(page) < 3:
                break
            start, incl = page[-1].name, False
        out["list " + d] = pages
    out["iter_all"] = sorted((d, n) for d, n, _e in store.iter_all())
    with open(os.path.join(store.dir, port_sharded.MAP_NAME), "rb") as f:
        out["SHARDMAP"] = f.read()
    return out


def _paths(ops):
    out = []
    for op, arg in ops:
        if op in ("insert", "update"):
            out.append(arg.full_path)
        elif op == "insert_many":
            out += [e.full_path for e in arg]
        else:
            out.append(arg)
    return out + ["/nope", "/0a/d0/nope"]


@pytest.mark.parametrize("kind", ["memory", "lsm"])
def test_sharded_store_ops_and_rebalance_equal_jax(tmp_path, kind):
    views, moves = {}, {}
    for pkg in ("jax", "port"):
        d = str(tmp_path / pkg)
        s = _open(pkg, d, kind, rebalance_factor=1.5, rebalance_min_heat=10.0,
                  rebalance_min_interval_s=60.0)
        ops = _ops(pkg, seed=3)
        _apply(s, ops)
        paths = _paths(ops)
        v = [_view(s, paths)]
        for _ in range(400):
            s.find_entry("/hh/d0/f00")
        v.append(s.shard_heats(1000.0))
        moves[pkg] = [s.maybe_rebalance(1000.0), s.maybe_rebalance(1000.0),
                      s.rebalance_once(0, now=1000.0)]
        v.append(_view(s, paths))
        v.append(s.describe())
        s.close()
        s = _open(pkg, d, kind)
        v.append(_view(s, paths))
        s.close()
        views[pkg] = v
    assert moves["port"] == moves["jax"]
    assert moves["port"][0] is not None and moves["port"][0]["moved"] > 0
    assert moves["port"][1] is None  # the holddown
    assert views["port"] == views["jax"]


class _Kill(Exception):
    pass


def _killed_and_recovered(pkg, d, step):
    ops = _ops(pkg, seed=5)
    s = _open(pkg, d, "lsm")
    _apply(s, ops)
    for _ in range(100):
        s.find_entry("/0a/d0/f00")

    def hook(at):
        if at == step:
            raise _Kill(at)

    s.step_hook = hook
    with pytest.raises(_Kill):
        s.rebalance_once(now=1000.0)
    # the crash: the instance is abandoned with what it wrote (every
    # WAL record is flushed as it is written), its directory locks
    # released, and the store reopened from disk
    for sub in s._stores:
        sub._wal.close()
        for seg in sub._segments:
            seg.close()
        os.close(sub._lock_fd)
        sub._lock_fd = None
    paths = _paths(ops)
    s2 = _open(pkg, d, "lsm")
    after = _view(s2, paths)
    for _ in range(100):
        s2.find_entry("/0a/d0/f00")
    retried = s2.rebalance_once(now=1000.0)
    done = _view(s2, paths)
    s2.close()
    return after, retried, done


@pytest.mark.parametrize("step", port_sharded.REBALANCE_STEPS)
def test_rebalance_kill_point_grid_equals_jax(tmp_path, step):
    assert port_sharded.REBALANCE_STEPS == jax_sharded.REBALANCE_STEPS
    got = _killed_and_recovered("port", str(tmp_path / "port"), step)
    want = _killed_and_recovered("jax", str(tmp_path / "jax"), step)
    assert got == want
    after, retried, done = got
    # no path resolves to two shards, nothing lost, exactly-once storage
    assert retried is not None
    assert len(done["iter_all"]) == len(set(done["iter_all"]))
    assert done["find"] == after["find"]


def _events(ent):
    e = lambda p, v: ent.Entry(full_path=p, attr=ent.Attr(mtime=1.0),
                               extended={"v": v}).to_dict()
    evs = [
        ("create", None, e("/a/f1", "1")), ("create", None, e("/a/f2", "1")),
        ("create", None, e("/a/sub/x", "1")), ("update", e("/a/f1", "1"), e("/a/f1", "2")),
        ("rename", e("/a/f2", "1"), e("/a/f3", "1")), ("delete", e("/a/f1", "2"), None),
        ("delete", e("/a/sub", ""), None), ("mkdir", None, e("/a/odd", "1")),
        ("delete", None, None), ("rename", e("/b/same", "1"), e("/b/same", "2")),
    ]
    out = [{"ts_ns": 100 + i, "directory": "/a",
            "event_notification": {"event_type": t, "old_entry": o, "new_entry": n}}
           for i, (t, o, n) in enumerate(evs)]
    return out + [dict(out[2], ts_ns=50)]  # at or below the cursor: skipped


def test_follower_apply_equals_jax(tmp_path):
    from seaweedfs_tpu.filer.filer import Filer as JaxFiler
    from seaweedfs_tpu.filer.meta_follower import MetaFollower as JaxFollower
    from seaweedfs_tpu_torch.filer.filer import Filer as PortFiler
    from seaweedfs_tpu_torch.filer.meta_follower import MetaFollower as PortFollower

    got = {}
    for pkg, F, MF in (("jax", JaxFiler, JaxFollower), ("port", PortFiler, PortFollower)):
        ent, stores, _sh = PKGS[pkg]
        f = F(stores.MemoryFilerStore())
        cursor = str(tmp_path / f"{pkg}.json")
        fol = MF("primary:1", f, cursor)
        for msg in _events(ent):
            fol._apply(msg)
        with open(cursor) as fh:
            saved = json.load(fh)
        again = MF("primary:1", F(stores.MemoryFilerStore()), cursor)
        other = MF("other:2", F(stores.MemoryFilerStore()), cursor)
        # the root the filer made at construction aside (its time is now)
        got[pkg] = ([(d, n, e.to_dict()) for d, n, e in f.store.iter_all() if d],
                    fol.applied, fol.skipped, fol.cursor_ns, saved,
                    again.cursor_ns, other.cursor_ns,
                    fol.gate_read({"min_ts_ns": fol.cursor_ns + 1}),
                    fol.gate_read({"min_ts_ns": fol.cursor_ns}), fol.redirects)
    assert got["port"] == got["jax"]
    assert got["port"][1] == 8 and got["port"][2] == 3


def test_follower_trimmed_cursor_requires_resync():
    from seaweedfs_tpu_torch.filer.filer import Filer
    from seaweedfs_tpu_torch.filer.meta_follower import MetaFollower
    from seaweedfs_tpu_torch.filer.meta_log import MetaLogTrimmed

    class _Trimmed:
        last_ts_ns = 900

        async def subscribe(self, since_ns=0, stopped=None):
            raise MetaLogTrimmed(since_ns, 777)
            yield  # an async generator

    fol = MetaFollower("", Filer(port_stores.MemoryFilerStore()), "",
                       source_log=_Trimmed(), head_check_s=0.01)

    async def go():
        await fol.start()
        for _ in range(200):
            if fol.resync_required and fol.head_ts_ns == 900:
                break
            await asyncio.sleep(0.005)
        await fol.stop()

    asyncio.run(go())
    st = fol.status()
    assert st["resync_required"] and st["trimmed_through"] == 777
    assert st["head_ts_ns"] == 900 and not st["connected"]


def test_meta_gate_over_sharded_store_is_counted_host(tmp_path):
    from seaweedfs_tpu.filer.meta_gate import MetaLookupGate as JaxGate
    from seaweedfs_tpu_torch.filer.meta_gate import MetaLookupGate as PortGate
    from seaweedfs_tpu_torch.ops.ragged_lookup import DeviceColumnArena

    arena = DeviceColumnArena(device="cpu")
    try:
        answers = {}
        for pkg, Gate, kw in (("jax", JaxGate, {}), ("port", PortGate, {"arena": arena})):
            s = _open(pkg, str(tmp_path / pkg), "lsm")
            ops = _ops(pkg, seed=7)
            _apply(s, ops)
            paths = _paths(ops)
            gate = Gate(s, **kw)

            async def go(gate=gate, paths=paths):
                one = await asyncio.gather(*(gate.lookup(p) for p in paths[:40]))
                many = await gate.lookup_many(paths)
                return [e.to_dict() if e else None for e in one + many]

            answers[pkg] = asyncio.run(go())
            if pkg == "port":
                stats, reasons = dict(gate.stats), dict(gate.fallback_reasons)
            s.close()
        assert answers["port"] == answers["jax"]
        assert stats["device_batches"] == 0
        assert stats["host_fallbacks"] == stats["batches"] == reasons["no_arena_view"] >= 1
    finally:
        arena.close()
