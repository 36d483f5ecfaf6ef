"""The port's bulk needle-index search (seaweedfs_tpu_torch.ops.index_kernel)
against the JAX package's: the plain torch versions of `_bulk_lookup` and
`_bulk_lookup_bucketed` must give exactly the jit programs' outputs on the
same columns and probes, and the port's IndexSnapshot exactly the JAX
IndexSnapshot's answers and bucket tables, at the edges where a search
that stops on `lo < hi` instead of a fixed step count could differ.
Tolerance: exact equality (lookups are integer answers)."""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import index_kernel as jax_ik
from seaweedfs_tpu_torch.ops import index_kernel as ik

U64_MAX = (1 << 64) - 1


def _cols(keys, seed):
    rng = np.random.default_rng(seed)
    keys = np.asarray(keys, dtype=np.uint64)
    offs = rng.integers(1, 1 << 32, size=len(keys), dtype=np.uint64).astype(np.uint32)
    sizes = rng.integers(1, 1 << 32, size=len(keys), dtype=np.uint64).astype(np.uint32)
    return keys, offs, sizes


def _around(keys, extra=()):
    """Every key, its neighbours, and the extreme keys."""
    k = np.asarray(keys, dtype=np.uint64)
    probes = [k, k + np.uint64(1), k - np.uint64(1)]  # wraps at 0 and 2^64-1
    probes.append(np.asarray([0, 1, 1 << 63, (1 << 63) - 1, U64_MAX, *extra], dtype=np.uint64))
    return np.concatenate(probes)


def _pow2_bucket_table():
    """4096+ keys, one per interpolation bucket (ranges of length 0 and
    1), plus a cluster of exactly 64 keys filling one bucket (a power-of-
    two occupancy), whose first and last keys are probed."""
    keys = np.arange(4096, dtype=np.uint64) * np.uint64(1000) + np.uint64(7)
    base = keys[-1] + np.uint64(5000)
    cluster = base + np.arange(64, dtype=np.uint64)
    return np.concatenate([keys, cluster])


TABLES = {
    "pow2_bucket": _pow2_bucket_table(),
    "top_bits_unbucketed": np.asarray(
        [0, 1, (1 << 32) - 1, 1 << 32, 1 << 40, (1 << 63) - 1, 1 << 63,
         (1 << 63) + 5, U64_MAX - 1, U64_MAX], dtype=np.uint64),
    "under_min_bucketed": np.unique(
        np.random.default_rng(3).integers(1, 1 << 45, size=4095, dtype=np.uint64)
    ),
    "wide_span_unbucketed": np.concatenate([
        np.arange(1, 4097, dtype=np.uint64),
        np.asarray([(1 << 63) + 11], dtype=np.uint64),
    ]),
    "one_row": np.asarray([12345], dtype=np.uint64),
}


@pytest.mark.parametrize("name", list(TABLES))
def test_index_snapshot_matches_jax(name):
    """Same table, same probes: the port's IndexSnapshot (plain version)
    returns exactly the JAX IndexSnapshot's three outputs and builds the
    same bucket table, steps and bucket parameters."""
    keys, offs, sizes = _cols(TABLES[name], seed=len(name))
    probes = _around(keys)
    ref = jax_ik.IndexSnapshot(keys, offs, sizes)
    snap = ik.IndexSnapshot(keys, offs, sizes, device="cpu")
    assert (snap.n, snap.steps) == (ref.n, ref.steps)
    assert (snap.starts is None) == (ref.starts is None)
    if ref.starts is not None:
        assert (snap.kmin, snap.bstep, snap.nb, snap.bsteps) == (
            ref.kmin, ref.bstep, ref.nb, ref.bsteps)
        assert np.array_equal(snap.starts.numpy(), np.asarray(ref.starts))
    want = ref.lookup(probes)
    got = snap.lookup(probes)
    for w, g, dt in zip(want, got, (np.uint32, np.uint32, bool)):
        assert g.dtype == dt and np.array_equal(w, g)
    # and against a dict: every stored key found with its own row
    oracle = dict(zip(keys.tolist(), zip(offs.tolist(), sizes.tolist())))
    for i, k in enumerate(probes.tolist()):
        hit = oracle.get(k)
        assert bool(got[2][i]) == (hit is not None)
        assert (int(got[0][i]), int(got[1][i])) == (hit or (0, 0))


def test_pow2_bucket_shape():
    """The edge table really has a bucket of exactly 64 rows, and empty
    and one-row buckets."""
    keys, offs, sizes = _cols(TABLES["pow2_bucket"], 0)
    snap = ik.IndexSnapshot(keys, offs, sizes, device="cpu")
    occ = np.diff(snap.starts.numpy())
    assert occ.max() == 64 and snap.bsteps == 7
    assert (occ == 0).any() and (occ == 1).any()


def test_plain_versions_equal_jit_programs():
    """_bulk_lookup_torch / _bulk_lookup_bucketed_torch against the jit
    programs themselves, with the JAX package's own host bucket pass, at
    step counts that converge and at step counts that do not (both must
    agree even then: the plain version is the JAX program)."""
    keys, offs, sizes = _cols(TABLES["pow2_bucket"], 1)
    probes = _around(keys[::3])
    ref = jax_ik.IndexSnapshot(keys, offs, sizes)
    phi, plo = jax_ik._split_u64(probes)
    bucket = ref._bucket_of(probes)
    t = ik.column_tensor
    cols = (t(keys, torch.int64, torch.device("cpu")),
            t(offs, torch.int32, torch.device("cpu")),
            t(sizes, torch.int32, torch.device("cpu")))
    pk = torch.from_numpy(probes.view(np.int64).copy())
    starts = torch.from_numpy(np.array(ref.starts))
    for steps in (ref.bsteps, 2):
        want = jax_ik._bulk_lookup_bucketed(
            steps, ref.khi, ref.klo, ref.offsets, ref.sizes, ref.starts,
            phi, plo, bucket)
        got = ik._bulk_lookup_bucketed_torch(
            steps, *cols, starts, pk, torch.from_numpy(bucket.astype(np.int64)))
        _assert_same(want, got)
    for steps in (ref.steps, 5):
        want = jax_ik._bulk_lookup(
            steps, ref.khi, ref.klo, ref.offsets, ref.sizes, phi, plo)
        got = ik._bulk_lookup_torch(steps, *cols, pk)
        _assert_same(want, got)


@pytest.mark.parametrize("name", list(TABLES))
def test_plain_versions_over_row_views_equal_jit_programs(name):
    """The plain versions read the snapshot's strided row views as columns
    and still give exactly the jit programs' outputs, on every edge table,
    at converging step counts and at step counts too small to converge."""
    keys, offs, sizes = _cols(TABLES[name], 11)
    probes = _around(keys)
    ref = jax_ik.IndexSnapshot(keys, offs, sizes)
    snap = ik.IndexSnapshot(keys, offs, sizes, device="cpu")
    views = (snap.keys, snap.offsets, snap.sizes)
    phi, plo = jax_ik._split_u64(probes)
    pk = torch.from_numpy(probes.view(np.int64).copy())
    for steps in (ref.steps, 2):
        want = jax_ik._bulk_lookup(
            steps, ref.khi, ref.klo, ref.offsets, ref.sizes, phi, plo)
        _assert_same(want, ik._bulk_lookup_torch(steps, *views, pk))
    if ref.starts is not None:
        bucket = ref._bucket_of(probes)
        for steps in (ref.bsteps, 1):
            want = jax_ik._bulk_lookup_bucketed(
                steps, ref.khi, ref.klo, ref.offsets, ref.sizes, ref.starts,
                phi, plo, bucket)
            got = ik._bulk_lookup_bucketed_torch(
                steps, *views, snap.starts, pk, torch.from_numpy(bucket.astype(np.int64)))
            _assert_same(want, got)


def _assert_same(want, got):
    w_off, w_size, w_found = (np.asarray(a) for a in want)
    g_off, g_size, g_found = got
    assert np.array_equal(w_off, g_off.numpy().view(np.uint32))
    assert np.array_equal(w_size, g_size.numpy().view(np.uint32))
    assert np.array_equal(w_found, g_found.numpy())


def test_empty_table_and_empty_batch():
    e = np.zeros(0, dtype=np.uint64)
    snap = ik.IndexSnapshot(e, e.astype(np.uint32), e.astype(np.uint32), device="cpu")
    off, size, found = snap.lookup(np.asarray([0, 1, U64_MAX], dtype=np.uint64))
    assert not found.any() and not off.any() and not size.any()
    keys, offs, sizes = _cols(TABLES["one_row"], 2)
    got = ik.IndexSnapshot(keys, offs, sizes, device="cpu").lookup(e)
    assert [len(a) for a in got] == [0, 0, 0]


def test_snapshot_from_reference():
    """The port's snapshot built from a JAX snapshot's device columns and
    bucket parameters answers as the JAX one does, bucketed or not."""
    for name in ("pow2_bucket", "top_bits_unbucketed"):
        keys, offs, sizes = _cols(TABLES[name], 4)
        ref = jax_ik.IndexSnapshot(keys, offs, sizes)
        snap = ik.snapshot_from_reference(ref, device="cpu")
        assert snap.bsteps == ref.bsteps if ref.starts is not None else snap.starts is None
        probes = _around(keys[::7])
        for w, g in zip(ref.lookup(probes), snap.lookup(probes)):
            assert np.array_equal(w, g)


def test_packed_rows_round_trip():
    """One 16-byte row per entry: word 0 the key's u64 bits, word 1 the
    offset in its low and the size in its high 32 bits, and the keys,
    offsets and sizes views give the columns back, top bits included."""
    keys = np.asarray([0, 1, (1 << 31) + 3, (1 << 63) - 1, 1 << 63,
                       (1 << 63) + 9, U64_MAX - 1, U64_MAX], dtype=np.uint64)
    offs = np.asarray([0, 1, (1 << 31) - 1, 1 << 31, (1 << 31) + 5,
                       (1 << 32) - 2, 7, (1 << 32) - 1], dtype=np.uint32)
    sizes = offs[::-1].copy()
    snap = ik.IndexSnapshot(keys, offs, sizes, device="cpu")
    rows = snap.rows
    assert rows.dtype == torch.int64 and rows.shape == (len(keys), 2)
    assert rows.is_contiguous() and rows.data_ptr() % 16 == 0
    words = rows.numpy().view(np.uint64)
    assert np.array_equal(words[:, 0], keys)
    assert np.array_equal(words[:, 1], offs.astype(np.uint64) | (sizes.astype(np.uint64) << np.uint64(32)))
    assert np.array_equal(snap.keys.numpy().view(np.uint64), keys)
    assert np.array_equal(snap.offsets.numpy().view(np.uint32), offs)
    assert np.array_equal(snap.sizes.numpy().view(np.uint32), sizes)
    # the views share the rows' memory: 16 bytes per entry, no columns beside
    for view in (snap.keys, snap.offsets, snap.sizes):
        assert view.untyped_storage().data_ptr() == rows.untyped_storage().data_ptr()
    off, size, found = snap.lookup(keys)
    assert found.all() and np.array_equal(off, offs) and np.array_equal(size, sizes)


def _row_search_model(snap, probes):
    """The kernel's search, step for step, in numpy: lower bound over the
    rows of [lo, hi) (the probe's bucket, or the whole table), answering
    from the last row compared >= the probe, with no load after the
    search."""
    rows = snap.rows.numpy().view(np.uint64)
    p = np.asarray(probes, dtype=np.uint64)
    if snap.starts is not None:
        b = snap._bucket_of(p).astype(np.int64)
        starts = snap.starts.numpy().astype(np.int64)
        lo, hi = starts[b], starts[b + 1]
    else:
        lo, hi = np.zeros(len(p), np.int64), np.full(len(p), snap.n, np.int64)
    last_key = ~p  # never equals the probe
    last_word = np.zeros(len(p), np.uint64)
    while (lo < hi).any():
        act = lo < hi
        mid = (lo + hi) // 2
        row = rows[np.where(act, mid, 0)]
        less = act & (row[:, 0] < p)
        left = act & ~less
        lo = np.where(less, mid + 1, lo)
        hi = np.where(left, mid, hi)
        last_key = np.where(left, row[:, 0], last_key)
        last_word = np.where(left, row[:, 1], last_word)
    found = last_key == p
    return (np.where(found, last_word & np.uint64(0xFFFFFFFF), 0).astype(np.uint32),
            np.where(found, last_word >> np.uint64(32), 0).astype(np.uint32), found)


@pytest.mark.parametrize("name", list(TABLES))
def test_row_search_answers_equal_jax(name):
    """The kernel's design, that a probe whose search never compares a row
    >= it is absent (the range ends at a bucket boundary above it, or at
    n), gives exactly the JAX IndexSnapshot's answers on every edge table."""
    keys, offs, sizes = _cols(TABLES[name], 12)
    probes = _around(keys)
    ref = jax_ik.IndexSnapshot(keys, offs, sizes)
    snap = ik.IndexSnapshot(keys, offs, sizes, device="cpu")
    for w, g in zip(ref.lookup(probes), _row_search_model(snap, probes)):
        assert np.array_equal(w, g)


def test_snapshot_from_reference_table_equals_jax():
    """snapshot_from_reference lays the JAX snapshot's columns into rows:
    the keys, offsets, sizes, bucket table and parameters equal the JAX
    snapshot's, bucketed or not."""
    for name in ("pow2_bucket", "top_bits_unbucketed", "under_min_bucketed"):
        keys, offs, sizes = _cols(TABLES[name], 13)
        ref = jax_ik.IndexSnapshot(keys, offs, sizes)
        snap = ik.snapshot_from_reference(ref, device="cpu")
        khi = np.asarray(ref.khi, dtype=np.uint64)
        klo = np.asarray(ref.klo, dtype=np.uint64)
        assert np.array_equal(snap.keys.numpy().view(np.uint64), (khi << np.uint64(32)) | klo)
        assert np.array_equal(snap.offsets.numpy().view(np.uint32), np.asarray(ref.offsets))
        assert np.array_equal(snap.sizes.numpy().view(np.uint32), np.asarray(ref.sizes))
        assert (snap.starts is None) == (ref.starts is None)
        if ref.starts is not None:
            assert np.array_equal(snap.starts.numpy(), np.asarray(ref.starts))
            assert (snap.kmin, snap.bstep, snap.nb, snap.bsteps) == (
                ref.kmin, ref.bstep, ref.nb, ref.bsteps)


def test_index_search_cuda_refuses_cpu_rows():
    """The kernel wrapper takes a snapshot's rows only on a CUDA device: a
    CPU snapshot's rows and probes raise, bucketed or not; it never runs
    the plain version."""
    keys, offs, sizes = _cols(TABLES["pow2_bucket"], 14)
    snap = ik.IndexSnapshot(keys, offs, sizes, device="cpu")
    pk = torch.from_numpy(keys[:8].view(np.int64).copy())
    before = ik.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        ik._index_search_cuda(snap.rows, snap.starts, snap.kmin, snap.bstep, snap.nb, pk)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ik._index_search_cuda(snap.rows, None, 0, 1, 0, pk)
    assert ik.KERNEL_LAUNCHES == before


def test_concurrent_lookups_share_staging_safely():
    """More threads than cores look up at once with a short switch
    interval (the try-lock loser allocates its own buffers): every thread
    gets its own exact answers."""
    keys, offs, sizes = _cols(TABLES["pow2_bucket"], 5)
    snap = ik.IndexSnapshot(keys, offs, sizes, device="cpu")
    oracle = dict(zip(keys.tolist(), offs.tolist()))
    errors = []

    def worker(seed):
        r = np.random.default_rng(seed)
        for _ in range(10):
            probes = keys[r.integers(0, len(keys), size=int(r.integers(1, 300)))]
            off, _size, found = snap.lookup(probes)
            if not found.all() or [oracle[k] for k in probes.tolist()] != off.tolist():
                errors.append(seed)
                return

    threads = [threading.Thread(target=worker, args=(s,))
               for s in range((os.cpu_count() or 1) + 4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors


def test_cuda_entry_points_raise_without_a_card():
    """No CUDA here: the default device raises instead of serving from the
    plain version, and the kernel wrapper refuses CPU tensors."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    keys, offs, sizes = _cols(TABLES["one_row"], 7)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ik.IndexSnapshot(keys, offs, sizes)
    t = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ik._index_search_cuda(t.view(2, 2), None, 0, 1, 0, t)
