"""The mesh lookup's bucket table and search (ops/bucket_search.py) on the
CPU: the plain versions of index_buckets and bucket_search against numpy's
searchsorted and K1's whole-table search, and the port's
sharded_bulk_lookup, on both its routes, against the JAX package's over 8
virtual CPU devices (tests/conftest.py). Tolerance: exact equality."""

import jax
import numpy as np
import pytest
import torch

from seaweedfs_tpu.parallel import make_mesh as jax_make_mesh
from seaweedfs_tpu.parallel import sharded_bulk_lookup as jax_lookup
from seaweedfs_tpu_torch.ops import bucket_search as bs
from seaweedfs_tpu_torch.ops.index_kernel import _SIGN, IndexSnapshot, _bulk_lookup_torch
from seaweedfs_tpu_torch.parallel import make_mesh, sharded_bulk_lookup
from seaweedfs_tpu_torch.parallel.sharded_lookup import replicate_index

CPU = torch.device("cpu")
TOP = (1 << 64) - 1


def _tables() -> dict:
    """chip_smoke.py's edge tables (one-row, empty and 64-row buckets, keys 0
    and 2^64 - 1, top-bit keys, just under the bucketed size, a span too
    wide to bucket, one row), a run of duplicates, a skewed table whose
    widest bucket holds 300 rows, and sequential keys (one bucket a row,
    the table's upper buckets all empty)."""
    spread = np.arange(4096, dtype=np.uint64) * np.uint64(1000) + np.uint64(7)
    dup = np.cumsum(np.random.default_rng(1).integers(1, 9, size=6000, dtype=np.uint64))
    dup[2000:2400] = dup[2000]
    return {
        "pow2_bucket": np.concatenate([
            spread, spread[-1] + np.uint64(5000) + np.arange(64, dtype=np.uint64)]),
        "top_bits": np.asarray([0, 1, (1 << 32) - 1, 1 << 32, (1 << 63) - 1, 1 << 63,
                                (1 << 63) + 5, TOP - 1, TOP], dtype=np.uint64),
        "under_min_bucketed": np.unique(np.random.default_rng(3).integers(
            1, 1 << 45, size=4095, dtype=np.uint64)),
        "wide_span": np.concatenate([np.arange(1, 4097, dtype=np.uint64),
                                     np.asarray([(1 << 63) + 11], dtype=np.uint64)]),
        "one_row": np.asarray([12345], dtype=np.uint64),
        "duplicates": np.sort(dup).astype(np.uint64),
        "skewed": np.concatenate([
            np.arange(4096, dtype=np.uint64) * np.uint64(1 << 20),
            np.uint64(1 << 33) + np.arange(300, dtype=np.uint64)]),
        "sequential": np.uint64(1 << 20) + np.arange(5000, dtype=np.uint64),
    }


TABLES = _tables()
# the tables sharded_bulk_lookup buckets, and two it searches whole
ROUTES = {"duplicates": True, "skewed": True, "sequential": True,
          "under_min_bucketed": False, "wide_span": False}


def _geometry(keys):
    nb = bs.table_buckets(len(keys), CPU)
    kmin, kmax = int(keys[0]), int(keys[-1])
    bstep = bs.bucket_step(kmin, kmax, nb)
    assert kmin + (nb - 1) * bstep < 1 << 64
    return kmin, bstep, nb


def _probes(keys, rng, count):
    """Present keys, their neighbours, 0, 2^63 and 2^64 - 1, and keys
    below kmin and above kmax."""
    edges = np.concatenate([keys, keys + np.uint64(1), keys - np.uint64(1), np.asarray(
        [0, 1 << 63, TOP, max(int(keys[0]) - 1, 0), min(int(keys[-1]) + 1, TOP)],
        dtype=np.uint64)])
    return rng.permutation(np.concatenate([edges, rng.choice(keys, size=count)]))


@pytest.mark.parametrize("name", list(TABLES))
def test_index_buckets_plain_equals_searchsorted(name):
    keys = TABLES[name]
    kmin, bstep, nb = _geometry(keys)
    boundaries = np.uint64(kmin) + np.arange(nb, dtype=np.uint64) * np.uint64(bstep)
    want = np.append(np.searchsorted(keys, boundaries), len(keys))
    starts, max_rows = bs._index_buckets_torch(
        torch.from_numpy(keys.view(np.int64)) ^ _SIGN, kmin, bstep, nb)
    assert starts.dtype == torch.int32 and starts.shape == (nb + 1,)
    assert np.array_equal(starts.numpy(), want)
    assert max_rows == int(np.diff(want).max())
    if name == "skewed":
        assert max_rows == 300
    if name == "duplicates":
        assert max_rows >= 400
    if name == "sequential":
        assert bstep == 1 and max_rows == 1 and nb > 1.5 * len(keys)


@pytest.mark.parametrize("name", list(TABLES))
def test_bucket_search_plain_equals_whole_table_search(name):
    keys = TABLES[name]
    rng = np.random.default_rng(len(keys))
    n = len(keys)
    offs = torch.from_numpy(rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
                            .astype(np.uint32).view(np.int32))
    sizes = torch.from_numpy(rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
                             .astype(np.uint32).view(np.int32))
    tk = torch.from_numpy(keys.view(np.int64))
    probes = torch.from_numpy(_probes(keys, rng, 500).view(np.int64))
    kmin, bstep, nb = _geometry(keys)
    starts, max_rows = bs._index_buckets_torch(tk ^ _SIGN, kmin, bstep, nb)
    got = bs._bucket_search_torch(bs.search_steps(max_rows), tk, offs, sizes, starts,
                                  kmin, bstep, nb, probes)
    steps = max(1, int(np.ceil(np.log2(n))) + 1)
    want = _bulk_lookup_torch(steps, tk, offs, sizes, probes)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[2].any())


@pytest.fixture(scope="module")
def meshes():
    return make_mesh(devices=[CPU] * 8), jax_make_mesh(devices=jax.devices("cpu")[:8])


@pytest.mark.parametrize("name", list(ROUTES))
def test_sharded_bulk_lookup_matches_jax_on_both_routes(meshes, name):
    mine, ref = meshes
    keys = TABLES[name]
    rng = np.random.default_rng(7)
    offs = rng.integers(1, 1 << 32, size=len(keys), dtype=np.uint64).astype(np.uint32)
    sizes = rng.integers(1, 1 << 32, size=len(keys), dtype=np.uint64).astype(np.uint32)
    probes = _probes(keys, rng, 3001)
    assert len(probes) % 8  # uneven over 8 places: zero padding
    (snap,) = replicate_index(keys, offs, sizes, mine).values()
    assert (snap.starts is not None) == ROUTES[name]
    assert IndexSnapshot.bucketable(len(keys), int(keys[0]), int(keys[-1])) == ROUTES[name]
    got = sharded_bulk_lookup(keys, offs, sizes, probes, mine)
    want = jax_lookup(keys, offs, sizes, probes, ref)
    for g, w in zip(got, want):
        assert g.shape == (len(probes),) and np.array_equal(g, np.asarray(w))
    assert got[2].sum() >= 3001


def test_kernel_wrappers_refuse_cpu_tensors_without_building():
    rows = torch.zeros((4096, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bs._index_buckets_cuda(rows, 0, 1, 4096)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bs._bucket_search_cuda(rows, torch.zeros(4097, dtype=torch.int32), 0, 1, 4096,
                               torch.zeros(8, dtype=torch.int64))
    assert bs._LIB is None
