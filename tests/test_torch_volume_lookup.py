"""The port's Volume and EcVolume lookups against the JAX package's
(mirrors tests/test_bulk_lookup.py): volumes written by either package
are byte-identical for the same needle sequence and open in the other;
`Volume.bulk_lookup` (use_device True, False and None; memory and LSM
maps) and `EcVolume.bulk_locate` give exactly the JAX answers; the
snapshot cache follows writes and deletes; a torn tail is repaired alike.
The port runs on device="cpu" (its plain version). Tolerance: exact."""

import os
import random
import shutil

import numpy as np
import pytest
import torch

from seaweedfs_tpu.storage import volume as jax_volume
from seaweedfs_tpu.storage.erasure_coding.ec_volume import EcVolume as JaxEcVolume
from seaweedfs_tpu.storage.needle import Needle as JaxNeedle
from seaweedfs_tpu_torch.ops.rs_kernel import CudaRSCodec
from seaweedfs_tpu_torch.storage import volume
from seaweedfs_tpu_torch.storage.erasure_coding import (
    EcVolume,
    write_ec_files,
    write_sorted_file_from_idx,
)
from seaweedfs_tpu_torch.storage.needle import Needle

LARGE, SMALL = 1 << 14, 1 << 10


class _Clock:
    """Deterministic append timestamps, so two packages write equal bytes."""

    def __init__(self):
        self.ns = 1_700_000_000_000_000_000

    def time_ns(self):
        self.ns += 1000
        return self.ns

    def time(self):
        return 1_700_000_000.0


def _sequence(seed, n=160):
    """(op, key, cookie, payload) in order: writes, overwrites, deletes."""
    rng = random.Random(seed)
    keys = rng.sample(range(1, 1 << 40), n)
    ops = [("w", k, 0x42, rng.randbytes(rng.randint(0, 300))) for k in keys]
    ops += [("w", k, 0x42, rng.randbytes(50)) for k in keys[:10]]
    ops += [("d", k, 0x42, b"") for k in keys[10:40:3]]
    ops += [("w", k, 0x42, rng.randbytes(9)) for k in keys[10:13]]  # re-create
    return keys, ops


def _apply(v, needle_cls, ops, batch=False):
    todo = []
    for op, k, cookie, data in ops:
        if op == "w" and batch:
            todo.append(needle_cls(cookie=cookie, id=k, data=data))
            continue
        if todo:
            v.write_needle_batch(todo)
            todo = []
        if op == "w":
            v.write_needle(needle_cls(cookie=cookie, id=k, data=data))
        else:
            v.delete_needle(needle_cls(cookie=cookie, id=k))
    if todo:
        v.write_needle_batch(todo)


@pytest.mark.parametrize("batch", [False, True])
def test_volumes_byte_identical_and_open_across(tmp_path, monkeypatch, batch):
    monkeypatch.setattr(jax_volume, "time", _Clock())
    monkeypatch.setattr(volume, "time", _Clock())
    keys, ops = _sequence(1)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jv = jax_volume.Volume(str(tmp_path / "jax"), "", 3)
    pv = volume.Volume(str(tmp_path / "port"), "", 3, device="cpu")
    _apply(jv, JaxNeedle, ops, batch)
    _apply(pv, Needle, ops, batch)
    jv.close()
    pv.close()
    for ext in (".dat", ".idx"):
        a = (tmp_path / "jax" / f"3{ext}").read_bytes()
        assert a == (tmp_path / "port" / f"3{ext}").read_bytes(), ext
    # each package opens the other's volume and reads what the other wrote
    jv = jax_volume.Volume(str(tmp_path / "port"), "", 3)
    pv = volume.Volume(str(tmp_path / "jax"), "", 3, device="cpu")
    try:
        for k in keys + [7]:
            got = [None, None]
            for i, v in enumerate((jv, pv)):
                try:
                    n = v.read_needle_by_key(k)
                    got[i] = (n.id, n.cookie, bytes(n.data), n.checksum)
                except Exception as e:  # NotFound / AlreadyDeleted
                    got[i] = type(e).__name__
            assert got[0] == got[1], k
        probes = np.asarray(keys + [7, 1 << 41], dtype=np.uint64)
        for a, b in zip(jv.bulk_lookup(probes), pv.bulk_lookup(probes)):
            assert np.array_equal(a, b)
    finally:
        jv.close()
        pv.close()


@pytest.mark.parametrize("kind", ["memory", "lsm", "leveldb", "sorted"])
def test_bulk_lookup_matches_jax(tmp_path, kind):
    """Same volume on disk, opened by both: every use_device setting, and
    batches under and over the 64-key cut, give the JAX answers."""
    keys, ops = _sequence(2)
    jv = jax_volume.Volume(str(tmp_path), "", 4, needle_map_kind=kind)
    _apply(jv, JaxNeedle, ops)
    jv.close()
    jv = jax_volume.Volume(str(tmp_path), "", 4, needle_map_kind=kind)
    pv = volume.Volume(str(tmp_path), "", 4, needle_map_kind=kind, device="cpu")
    try:
        probes = np.asarray(keys + [3, 5, (1 << 41) + 3], dtype=np.uint64)
        want = jv.bulk_lookup(probes, use_device=False)
        assert want[2].sum() > 100
        for p in (probes, probes[:63]):
            for use_device in (True, False, None):
                got = pv.bulk_lookup(p, use_device=use_device)
                ref = jv.bulk_lookup(p, use_device=use_device)
                for a, b, w in zip(ref, got, want):
                    assert a.dtype == b.dtype and np.array_equal(a, b)
                    assert np.array_equal(b, w[: len(p)])
    finally:
        jv.close()
        pv.close()


def test_bulk_lookup_cache_follows_writes_and_deletes(tmp_path):
    v = volume.Volume(str(tmp_path), "", 2, device="cpu")
    try:
        v.write_needle(Needle(cookie=0x42, id=10, data=b"x" * 10))
        probes = np.asarray([10, 11], dtype=np.uint64)
        assert v.bulk_lookup(probes, use_device=True)[2].tolist() == [True, False]
        v.write_needle(Needle(cookie=0x42, id=11, data=b"y"))
        assert v.bulk_lookup(probes, use_device=True)[2].tolist() == [True, True]
        v.delete_needle(Needle(cookie=0x42, id=10))
        assert v.bulk_lookup(probes, use_device=True)[2].tolist() == [False, True]
    finally:
        v.close()


def test_ec_bulk_locate_matches_jax(tmp_path):
    random.seed(23)
    keys, ops = _sequence(3, n=120)
    pv = volume.Volume(str(tmp_path), "", 5, device="cpu")
    _apply(pv, Needle, [o for o in ops if o[0] == "w"])
    pv.close()
    base = os.path.join(str(tmp_path), "5")
    write_ec_files(base, codec=CudaRSCodec(device="cpu"),
                   large_block_size=LARGE, small_block_size=SMALL)
    write_sorted_file_from_idx(base)
    jev = JaxEcVolume(str(tmp_path), "", 5)
    pev = EcVolume(str(tmp_path), "", 5, LARGE, SMALL, device="cpu")
    try:
        probes = np.asarray(keys + [3, 5], dtype=np.uint64)
        want = jev.bulk_locate(probes)
        assert want[2][: len(keys)].all() and not want[2][len(keys):].any()
        for use_device in (True, False, None):
            for a, b in zip(want, pev.bulk_locate(probes, use_device=use_device)):
                assert a.dtype == b.dtype and np.array_equal(a, b)
        for k in keys[:5]:
            assert pev.find_needle_from_ecx(k) == jev.find_needle_from_ecx(k)
    finally:
        jev.close()
        pev.close()


def test_torn_tail_repaired_alike(tmp_path):
    """A record torn mid-append: both packages truncate it away, re-index
    nothing else, and then answer alike."""
    keys, ops = _sequence(4, n=40)
    src = tmp_path / "src"
    src.mkdir()
    v = volume.Volume(str(src), "", 6, device="cpu")
    _apply(v, Needle, ops)
    v.close()
    blob, _, _ = Needle(cookie=1, id=99, data=b"z" * 500).to_bytes(3)
    with open(src / "6.dat", "ab") as f:
        f.write(blob[:300])
    shutil.copytree(src, tmp_path / "jax")
    jv = jax_volume.Volume(str(tmp_path / "jax"), "", 6)
    pv = volume.Volume(str(src), "", 6, device="cpu")
    try:
        assert pv.recovery_stats == jv.recovery_stats
        assert pv.recovery_stats["dat_bytes_dropped"] == 300
        assert (src / "6.dat").read_bytes() == (tmp_path / "jax" / "6.dat").read_bytes()
        probes = np.asarray(keys + [99], dtype=np.uint64)
        for a, b in zip(jv.bulk_lookup(probes), pv.bulk_lookup(probes)):
            assert np.array_equal(a, b)
    finally:
        jv.close()
        pv.close()


def test_device_lookup_raises_without_a_card(tmp_path):
    """A volume left on its default device (the card) raises for a
    device-sized batch rather than serving it from the host loop; the
    host path the caller asks for still answers."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    v = volume.Volume(str(tmp_path), "", 8)
    try:
        v.write_needle(Needle(cookie=1, id=5, data=b"abc"))
        probes = np.arange(1, 100, dtype=np.uint64)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            v.bulk_lookup(probes)
        assert v.bulk_lookup(probes, use_device=False)[2].sum() == 1
        assert v.bulk_lookup(probes[:10])[2].sum() == 1  # under 64: host
    finally:
        v.close()
    # a leveldb volume opens as the JAX package's does and answers alike
    (tmp_path / "jax").mkdir()
    jv = jax_volume.Volume(str(tmp_path / "jax"), "", 9, needle_map_kind="leveldb")
    pv = volume.Volume(str(tmp_path), "", 9, needle_map_kind="leveldb")
    try:
        for v, n in ((jv, JaxNeedle), (pv, Needle)):
            v.write_needle(n(cookie=1, id=5, data=b"abc"))
        for a, b in zip(jv.bulk_lookup(probes, use_device=False),
                        pv.bulk_lookup(probes, use_device=False)):
            assert np.array_equal(a, b)
    finally:
        jv.close()
        pv.close()
    with pytest.raises(ValueError, match="unknown needle map kind"):
        volume.Volume(str(tmp_path), "", 10, needle_map_kind="btree")
