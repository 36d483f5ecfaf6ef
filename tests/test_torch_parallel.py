"""The port's mesh plane (parallel/sharded_ec.py, parallel/sharded_lookup.py,
entry.py, gf_verify) on the CPU against the JAX package's parallel/ over
its 8 virtual CPU devices (tests/conftest.py): the port's mesh is 8
repeated CPU devices, each block running the kernels' plain versions.
Mirrors tests/test_parallel.py and __graft_entry__.py's entry and dryrun
sequence. Tolerance: exact equality (sharded outputs byte for byte,
verify's count word for word)."""

import jax
import numpy as np
import pytest
import torch

from seaweedfs_tpu.parallel import make_mesh as jax_make_mesh
from seaweedfs_tpu.parallel import sharded_bulk_lookup as jax_lookup
from seaweedfs_tpu.parallel import sharded_encode as jax_encode
from seaweedfs_tpu.parallel import sharded_reconstruct_step as jax_reconstruct
from seaweedfs_tpu.parallel import sharded_verify as jax_verify
from seaweedfs_tpu.parallel.sharded_ec import (
    sharded_reconstruct_padded as jax_reconstruct_padded,
)
from seaweedfs_tpu_torch.ops.gf256 import gf_verify_count
from seaweedfs_tpu_torch.parallel import (
    make_mesh,
    sharded_bulk_lookup,
    sharded_encode,
    sharded_reconstruct_padded,
    sharded_reconstruct_step,
    sharded_verify,
)
from seaweedfs_tpu_torch.storage.erasure_coding.coder_cpu import CpuRSCodec
from seaweedfs_tpu_torch.storage.erasure_coding.galois import (
    mat_mul,
    reconstruction_matrix,
)

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def meshes():
    return make_mesh(devices=CPU8), jax_make_mesh(devices=jax.devices("cpu")[:8])


@pytest.fixture(scope="module")
def codec():
    return CpuRSCodec()


def test_mesh_shape_matches_jax(meshes):
    mine, ref = meshes
    assert len(jax.devices("cpu")) >= 8, "expected 8 virtual CPU devices"
    assert mine.shape == {"vol": ref.shape["vol"], "blk": ref.shape["blk"]}
    assert mine.shape == {"vol": 4, "blk": 2}
    assert mine.devices.size == 8
    assert make_mesh(devices=CPU8[:6]).shape == {"vol": 3, "blk": 2}
    assert make_mesh(devices=CPU8[:7]).shape == {"vol": 7, "blk": 1}


def test_make_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()


@pytest.mark.parametrize("v", [4, 5])
def test_sharded_encode_matches_jax(meshes, codec, v):
    mine, ref = meshes
    rng = np.random.default_rng(v)
    data = rng.integers(0, 256, size=(v, 10, 8192), dtype=np.uint8)
    got = sharded_encode(codec.parity_matrix, data, mine)
    want = np.asarray(jax_encode(codec.parity_matrix, data, ref))
    assert got.shape == (v, 4, 8192)
    assert np.array_equal(got, want)
    assert np.array_equal(got[1], codec.encode(data[1]))
    with pytest.raises(AssertionError):
        sharded_encode(codec.parity_matrix, data[:, :, :8190], mine)


def test_sharded_encode_keeps_torch_tensors_in_place(meshes, codec):
    mine, _ref = meshes
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, size=(3, 10, 4096), dtype=np.uint8)
    got = sharded_encode(codec.parity_matrix, torch.from_numpy(data), mine)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), sharded_encode(codec.parity_matrix, data, mine))


def _word_mismatches(codec, shards) -> int:
    """The reference count: recomputed parity != stored parity on uint32
    words, over every volume."""
    n = 0
    for vol in shards:
        par = codec.encode(vol[:10]).view(np.uint32)
        n += int(np.sum(par != np.ascontiguousarray(vol[10:]).view(np.uint32)))
    return n


def test_sharded_verify_counts_words_like_jax(meshes, codec):
    mine, ref = meshes
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, size=(5, 10, 4096), dtype=np.uint8)
    parity = sharded_encode(codec.parity_matrix, data, mine)
    shards = np.concatenate([data, parity], axis=1)
    assert sharded_verify(codec.parity_matrix, shards, mine) == 0
    assert int(jax_verify(codec.parity_matrix, shards, ref)) == 0
    # seeded flips: two bytes of one word (one word), a parity byte, a
    # data byte (every parity row's word at that column)
    shards[3, 12, 76] ^= 0xFF
    shards[3, 12, 77] ^= 0x0F
    shards[0, 13, 4095] ^= 0x01
    shards[4, 2, 1000] ^= 0x80
    want = _word_mismatches(codec, shards)
    assert want == 1 + 1 + 4
    assert sharded_verify(codec.parity_matrix, shards, mine) == want
    assert int(jax_verify(codec.parity_matrix, shards, ref)) == want


def test_gf_verify_plain_counts_words(codec):
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, size=(10, 1000), dtype=np.uint8)
    parity = codec.encode(data)
    flips = rng.choice(4 * 1000, size=37, replace=False)
    bad = parity.copy().reshape(-1)
    bad[flips] ^= 0x5A
    bad = bad.reshape(parity.shape)
    words = lambda a: np.ascontiguousarray(a).view(np.uint32)  # noqa: E731
    want = int(np.sum(words(bad) != words(parity)))
    got = gf_verify_count(codec.parity_matrix, words(data), words(bad), device="cpu")
    assert got == want
    t = gf_verify_count(codec.parity_matrix, torch.from_numpy(words(data).view(np.int32)),
                        torch.from_numpy(words(bad).view(np.int32)))
    assert t.dtype == torch.int64 and int(t) == want


def test_gf_verify_kernel_refuses_cpu_tensors(codec):
    from seaweedfs_tpu_torch.ops.gf256 import _gf_verify_cuda

    words = torch.zeros((10, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _gf_verify_cuda(codec.parity_matrix, words, words[:4])


def test_sharded_reconstruct_matches_jax(meshes, codec):
    mine, ref = meshes
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, size=(4, 10, 4096), dtype=np.uint8)
    parity = sharded_encode(codec.parity_matrix, data, mine)
    shards = np.concatenate([data, parity], axis=1)
    survivors_idx = [1, 2, 4, 5, 6, 7, 8, 9, 10, 11]
    dec = reconstruction_matrix(codec.matrix, survivors_idx)
    rows = dec[np.asarray([0, 3])]
    surv = shards[:, survivors_idx, :]
    got = sharded_reconstruct_step(rows, surv, mine)
    assert np.array_equal(got, np.asarray(jax_reconstruct(rows, surv, ref)))
    assert np.array_equal(got[:, 0], data[:, 0]) and np.array_equal(got[:, 1], data[:, 3])


def test_sharded_reconstruct_padded_matches_jax(meshes, codec):
    mine, ref = meshes
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, size=(3, 10, 5003), dtype=np.uint8)
    shards = np.concatenate(
        [data, np.stack([codec.encode(d) for d in data])], axis=1)
    lost = [2, 12]
    survivors = [i for i in range(14) if i not in lost][:10]
    rows = mat_mul(codec.matrix[np.asarray(lost)],
                   reconstruction_matrix(codec.matrix, survivors))
    got = sharded_reconstruct_padded(rows, shards[:, survivors], mine)
    want = jax_reconstruct_padded(rows, shards[:, survivors], ref)
    assert got.shape == (3, 2, 5003)
    assert np.array_equal(got, want)
    assert np.array_equal(got[:, 0], data[:, 2])
    assert np.array_equal(got[:, 1], shards[:, 12])


def test_sharded_bulk_lookup_matches_jax(meshes):
    mine, ref = meshes
    rng = np.random.default_rng(3)
    m = 5000
    keys = np.cumsum(rng.integers(0, 9, size=m, dtype=np.uint64)).astype(np.uint64)
    keys[100:104] = keys[100]  # duplicate keys in the table
    keys = np.sort(keys)
    offsets = rng.integers(1, 1 << 30, size=m, dtype=np.uint64).astype(np.uint32)
    sizes = rng.integers(1, 1 << 20, size=m, dtype=np.uint64).astype(np.uint32)
    p = 65_536 - 5  # uneven over 8 places
    idx = rng.integers(0, m, size=p)
    probes = keys[idx].copy()
    probes[:50] = rng.integers(int(keys[-1]) + 1, 1 << 62, size=50, dtype=np.uint64)
    probes[50:60] = probes[60]  # duplicate probes
    probes[60:70] = keys[100]
    got = sharded_bulk_lookup(keys, offsets, sizes, probes, mine)
    want = jax_lookup(keys, offsets, sizes, probes, ref)
    for g, w in zip(got, want):
        assert g.shape == (p,) and np.array_equal(g, np.asarray(w))
    assert not got[2][:50].any() and got[2][50:].all()


def test_entry_matches_jax_entry():
    import __graft_entry__ as graft

    from seaweedfs_tpu_torch import entry

    fn, (example,) = entry.entry(device="cpu")
    jfn, (jexample,) = graft.entry()
    assert np.array_equal(example.numpy(), jexample)
    got = fn(example)
    assert got.shape == (2, 4, 1024) and got.dtype == torch.uint32
    assert np.array_equal(got.numpy(), np.asarray(jax.jit(jfn)(jexample)))


def test_dryrun_sequence_on_a_cpu_mesh():
    from seaweedfs_tpu_torch import entry

    entry.dryrun(CPU8)
    entry.dryrun(CPU8[:1])
