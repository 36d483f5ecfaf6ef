"""The port's disk-backed needle maps and MemDb against the JAX package's
(storage/needle_map/disk_maps.py, memdb.py) on the same files:
`SqliteNeedleMap` (the `leveldb` kind, `<base>.ldb`) and
`SortedFileNeedleMap` (the `sorted` kind, `<base>.sdx`) — `get`,
`ascending_visit`, metrics and `snapshot` — `.ldb` files read across
the two packages, keys at 2^63, and the `.ldb` freshness across a vacuum
commit (the JAX package's reload keeps the old offsets when nothing was
written between compaction and commit; the port's drops the `.ldb`).
Inputs come from a numpy seed; tolerance: exact."""

import os
import shutil

import numpy as np
import pytest

from seaweedfs_tpu.storage import vacuum as jax_vacuum
from seaweedfs_tpu.storage.needle import Needle as JaxNeedle
from seaweedfs_tpu.storage.needle_map import MemDb as JaxMemDb
from seaweedfs_tpu.storage.needle_map import disk_maps as jax_maps
from seaweedfs_tpu.storage.volume import Volume as JaxVolume
from seaweedfs_tpu_torch.storage import vacuum
from seaweedfs_tpu_torch.storage.idx import entry_to_bytes
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.needle_map import MemDb
from seaweedfs_tpu_torch.storage.needle_map import disk_maps
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.types import TOMBSTONE_FILE_SIZE

MAPS = {
    "leveldb": (jax_maps.SqliteNeedleMap, disk_maps.SqliteNeedleMap),
    "sorted": (jax_maps.SortedFileNeedleMap, disk_maps.SortedFileNeedleMap),
}


def _write_idx(path, seed: int, n: int = 400) -> np.ndarray:
    """A .idx log of puts, overwrites and deletes; returns the keys."""
    rng = np.random.default_rng(seed)
    keys = rng.choice(1 << 40, size=n, replace=False).astype(np.uint64) + 1
    rows = []
    for i, k in enumerate(keys.tolist()):
        rows.append(entry_to_bytes(k, 1 + 3 * i, int(rng.integers(1, 5000))))
    for k in keys[: n // 8].tolist():  # overwritten
        rows.append(entry_to_bytes(k, 5000 + k % 997, int(rng.integers(1, 90))))
    for k in keys[n // 8 : n // 3 : 3].tolist():  # deleted
        rows.append(entry_to_bytes(k, 0, TOMBSTONE_FILE_SIZE))
    with open(path, "wb") as f:
        f.write(b"".join(rows))
    return keys


def _view(m, probes) -> tuple:
    got = []
    for k in probes.tolist():
        nv = m.get(k)
        got.append(None if nv is None else (nv.offset_units, nv.size))
    visited = []
    m.ascending_visit(lambda nv: visited.append((nv.key, nv.offset_units, nv.size)))
    metrics = (m.file_count, m.deleted_count, m.content_size, m.deleted_size,
               m.max_file_key)
    snap = [c.tolist() for c in m.snapshot()]
    return got, visited, metrics, snap


@pytest.mark.parametrize("kind", ["leveldb", "sorted"])
def test_disk_map_equals_jax(tmp_path, kind):
    """Each package opens its own copy of one .idx: get on every key and
    absent ones, ascending_visit, the metrics and the snapshot columns
    (K1's input) agree entry by entry, and so do the files they derive."""
    jax_cls, port_cls = MAPS[kind]
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    keys = _write_idx(tmp_path / "j" / "1.idx", seed=11)
    shutil.copyfile(tmp_path / "j" / "1.idx", tmp_path / "p" / "1.idx")
    probes = np.concatenate([keys, keys[:20] + np.uint64(1 << 41)])
    jm = jax_cls(str(tmp_path / "j" / "1.idx"))
    pm = port_cls(str(tmp_path / "p" / "1.idx"))
    try:
        want = _view(jm, probes)
        assert _view(pm, probes) == want
        assert want[2][0] > 300 and len(want[1]) > 250
        # deletes tombstone both maps alike
        for k in keys[200:210].tolist():
            jm.delete(k, 7)
            pm.delete(k, 7)
        assert _view(pm, probes) == _view(jm, probes)
    finally:
        jm.close()
        pm.close()
    ext = ".sdx" if kind == "sorted" else ".idx"
    assert (tmp_path / "p" / f"1{ext}").read_bytes() == \
        (tmp_path / "j" / f"1{ext}").read_bytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ldb_read_across_packages(tmp_path, writer):
    """A `.ldb` written through one package's puts and deletes is fresh
    for the other, which opens it without regenerating and reads every
    entry the writer holds."""
    jax_cls, port_cls = MAPS["leveldb"]
    w_cls, r_cls = (jax_cls, port_cls) if writer == "jax" else (port_cls, jax_cls)
    rng = np.random.default_rng(3)
    keys = rng.choice(1 << 50, size=300, replace=False).astype(np.uint64) + 1
    w = w_cls(str(tmp_path / "2.idx"))
    w.put_batch([(k, 2 + i, 100 + i) for i, k in enumerate(keys.tolist())])
    for k in keys[::7].tolist():
        w.delete(k, 9)
    w.put(int(keys[3]), 999, 12)
    want = _view(w, keys)
    w.close()
    mtime = os.path.getmtime(tmp_path / "2.ldb")
    r = r_cls(str(tmp_path / "2.idx"))
    try:
        assert os.path.getmtime(tmp_path / "2.ldb") == mtime  # not regenerated
        assert _view(r, keys) == want
    finally:
        r.close()


def test_sqlite_key_at_2_63_raises_as_jax(tmp_path):
    """sqlite's INTEGER is signed: a key of 2^63 or more raises
    OverflowError in both packages before the .idx is touched; 2^63 - 1
    round-trips in both."""
    for d, cls in (("j", MAPS["leveldb"][0]), ("p", MAPS["leveldb"][1])):
        (tmp_path / d).mkdir()
        m = cls(str(tmp_path / d / "3.idx"))
        try:
            with pytest.raises(OverflowError):
                m.put(1 << 63, 5, 10)
            assert os.path.getsize(tmp_path / d / "3.idx") == 0
            m.put((1 << 63) - 1, 5, 10)
            assert m.get((1 << 63) - 1).size == 10
        finally:
            m.close()


def test_sorted_map_is_read_only_as_jax(tmp_path):
    for d, cls in (("j", MAPS["sorted"][0]), ("p", MAPS["sorted"][1])):
        (tmp_path / d).mkdir()
        _write_idx(tmp_path / d / "4.idx", seed=5, n=50)
        m = cls(str(tmp_path / d / "4.idx"))
        try:
            with pytest.raises(OSError, match="read-only"):
                m.put(1, 2, 3)
        finally:
            m.close()


def test_memdb_equals_jax(tmp_path):
    """MemDb replays a .idx (deletes remove), sorts and saves alike."""
    _write_idx(tmp_path / "5.idx", seed=8)
    jm, pm = JaxMemDb(), MemDb()
    jm.load_from_idx(str(tmp_path / "5.idx"))
    pm.load_from_idx(str(tmp_path / "5.idx"))
    for m in (jm, pm):
        m.set(7, 8, 9)
        m.delete(7)
        m.set(1 << 62, 3, 4)
    seen = ([], [])
    jm.ascending_visit(lambda nv: seen[0].append((nv.key, nv.offset_units, nv.size)))
    pm.ascending_visit(lambda nv: seen[1].append((nv.key, nv.offset_units, nv.size)))
    assert seen[0] == seen[1] and len(jm) == len(pm) > 300
    jm.save_to_idx(str(tmp_path / "j.idx"))
    pm.save_to_idx(str(tmp_path / "p.idx"))
    assert (tmp_path / "j.idx").read_bytes() == (tmp_path / "p.idx").read_bytes()


def _leveldb_volume(vol_cls, needle_cls, d, **kw):
    v = vol_cls(str(d), "", 6, needle_map_kind="leveldb", **kw)
    rng = np.random.default_rng(6)
    sizes = rng.integers(20, 400, size=120).tolist()
    for i, size in enumerate(sizes, start=1):
        v.write_needle(needle_cls(id=i, cookie=i, data=bytes([i]) * size))
    for i in range(1, 121, 3):
        v.delete_needle(needle_cls(id=i, cookie=i))
    return v, {i: bytes([i]) * size for i, size in enumerate(sizes, start=1)
               if i % 3 != 1}


def _wrong_reads(v, want) -> int:
    bad = 0
    for k, data in want.items():
        try:
            bad += bytes(v.read_needle_by_key(k).data) != data
        except Exception:
            bad += 1
    return bad


@pytest.mark.parametrize("race", [False, True])
def test_leveldb_commit_never_serves_stale_offsets(tmp_path, race):
    """After compact2 and commit on a `leveldb` volume the port's map
    holds the new offsets. The JAX package's does only when a write
    raced the compaction (the makeup diff touches the .cpx after the
    close touched the .ldb); with no such write its reload trusts the
    old .ldb and every live read fails (ROADMAP Queue C)."""
    out = {}
    for name, vol_cls, needle_cls, vac, kw in (
        ("jax", JaxVolume, JaxNeedle, jax_vacuum, {}),
        ("port", Volume, Needle, vacuum, {"device": "cpu"}),
    ):
        (tmp_path / name).mkdir()
        v, want = _leveldb_volume(vol_cls, needle_cls, tmp_path / name, **kw)
        vac.compact2(v, route="pread")
        if race:
            v.write_needle(needle_cls(id=500, cookie=5, data=b"raced" * 30))
            want[500] = b"raced" * 30
        v2 = vac.commit_compact(v)
        try:
            out[name] = _wrong_reads(v2, want)
            if name == "port":
                keys = np.arange(1, 600, dtype=np.uint64)
                got = v2.bulk_lookup(keys, use_device=True)
                host = v2.bulk_lookup(keys, use_device=False)
                for a, b in zip(got, host):
                    assert np.array_equal(a, b)
                assert int(got[2].sum()) == len(want)
        finally:
            v2.close()
    assert out == {"jax": 0 if race else 80, "port": 0}
