"""CudaRSCodec (the port's codec) run on the CPU through the plain torch
version, against the JAX package's TpuRSCodec (jnp path) and the numpy
CpuRSCodec of both packages: every method, three geometries, losses of 1
through m shards of data and parity. Tolerance: exact equality."""

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops.rs_kernel import TpuRSCodec
from seaweedfs_tpu.storage.erasure_coding.coder_cpu import CpuRSCodec as JaxCpuRSCodec
from seaweedfs_tpu_torch.gpu import coder
from seaweedfs_tpu_torch.ops import gf256
from seaweedfs_tpu_torch.ops.rs_kernel import CudaRSCodec, codec_from_reference
from seaweedfs_tpu_torch.storage.erasure_coding.coder_cpu import CpuRSCodec
from seaweedfs_tpu_torch.storage.erasure_coding.galois import DECODE_ROWS_CACHE

GEOMETRIES = [(10, 4), (6, 3), (12, 4)]
WIDTH = 3001  # ragged: not a whole number of words


def _shards(k, m, seed=7):
    data = np.random.default_rng(seed).integers(0, 256, (k, WIDTH), dtype=np.uint8)
    return data, JaxCpuRSCodec(k, m).encode_all(data)


def _loss_patterns(k, m):
    """Per loss count 1..m: a data-only, a parity-only (where it fits) and
    a mixed pattern, seeded."""
    rng = np.random.default_rng(k * 100 + m)
    out = []
    for n in range(1, m + 1):
        out.append(sorted(rng.choice(k, n, replace=False).tolist()))
        if n <= m:
            out.append(sorted((k + rng.choice(m, n, replace=False)).tolist()))
        if n >= 2:
            mixed = rng.choice(k, n - 1, replace=False).tolist() + [
                int(k + rng.integers(m))
            ]
            out.append(sorted(mixed))
    return out


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_encode_verify_match_cpu_codecs(k, m):
    data, shards = _shards(k, m)
    port = CudaRSCodec(k, m, device="cpu")
    assert port.pipeline_dispatch_kind == "cpu"
    parity = port.encode(data)
    assert np.array_equal(parity, CpuRSCodec(k, m).encode(data))
    assert np.array_equal(port.encode_all(data), shards)
    assert np.array_equal(port.pipeline_encode(data), parity)
    assert port.verify(shards)
    bad = shards.copy()
    bad[k, 17] ^= 1
    assert not port.verify(bad)
    # strided read-only rows (the streamed mmap route hands these in)
    backing = np.zeros((k, 2 * WIDTH), dtype=np.uint8)
    backing[:, :WIDTH] = data
    view = np.lib.stride_tricks.as_strided(
        backing, shape=(k, WIDTH), strides=(2 * WIDTH, 1), writeable=False
    )
    assert np.array_equal(port.encode(view), parity)
    m_apply = np.random.default_rng(3).integers(0, 256, (5, k), dtype=np.uint8)
    assert np.array_equal(
        port.apply_matrix(m_apply, data), CpuRSCodec(k, m).apply_matrix(m_apply, data)
    )


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_reconstruct_every_loss_count(k, m):
    _, shards = _shards(k, m)
    port = CudaRSCodec(k, m, device="cpu")
    cpu = CpuRSCodec(k, m)
    for lost in _loss_patterns(k, m):
        partial = [None if i in lost else shards[i] for i in range(k + m)]
        full = port.reconstruct(partial)
        ref = cpu.reconstruct(partial)
        for i in range(k + m):
            assert np.array_equal(full[i], shards[i]), (lost, i)
            assert np.array_equal(ref[i], shards[i]), (lost, i)
        data_only = port.reconstruct(partial, data_only=True)
        for i in range(k + m):
            if i < k:
                assert np.array_equal(data_only[i], shards[i]), (lost, i)
            elif i in lost:
                assert data_only[i] is None
        rows = port.reconstruct_rows(partial, lost)
        for r, i in enumerate(lost):
            assert np.array_equal(rows[r], shards[i]), (lost, i)
        out = np.full((len(lost), WIDTH), 0xAA, dtype=np.uint8)
        got = port.reconstruct_rows(partial, lost, out=out)
        assert np.array_equal(out, shards[lost])  # landed in the caller's buffer
        assert all(np.shares_memory(g, out) for g in got)


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_matches_tpu_codec(k, m):
    """The JAX codec (jnp path): encode, verify, and the widest loss
    pattern (m shards lost across data and parity) through reconstruct and
    reconstruct_rows; a data-only reconstruct on 10.4, as
    test_ops::test_tpu_codec_data_only_reconstruct has it. Every loss count
    is held to the numpy codecs above (one compile per matrix keeps the
    JAX side cheap)."""
    data, shards = _shards(k, m)
    port = CudaRSCodec(k, m, device="cpu")
    tpu = TpuRSCodec(k, m)
    assert np.array_equal(port.encode(data), np.asarray(tpu.encode(data)))
    assert port.verify(shards) and tpu.verify(shards)
    for lost in (_loss_patterns(k, m)[-1],):
        partial = [None if i in lost else shards[i] for i in range(k + m)]
        want = tpu.reconstruct(partial)
        got = port.reconstruct(partial)
        for i in range(k + m):
            assert np.array_equal(got[i], np.asarray(want[i])), (lost, i)
        want_rows = tpu.reconstruct_rows(partial, lost)
        got_rows = port.reconstruct_rows(partial, lost)
        for w, g in zip(want_rows, got_rows):
            assert np.array_equal(g, np.asarray(w))
    if (k, m) != (10, 4):
        return
    partial = [None if i in (0, k + 1) else shards[i] for i in range(k + m)]
    want = tpu.reconstruct(partial, data_only=True)
    got = port.reconstruct(partial, data_only=True)
    assert np.array_equal(got[0], np.asarray(want[0]))
    assert got[k + 1] is None and want[k + 1] is None


def test_reconstruct_rejects_bad_input():
    _, shards = _shards(10, 4)
    port = CudaRSCodec(device="cpu")
    with pytest.raises(ValueError, match="expected 14"):
        port.reconstruct(list(shards[:13]))
    partial = [None] * 5 + list(shards[5:])
    with pytest.raises(ValueError, match="too few shards"):
        port.reconstruct(partial)
    with pytest.raises(ValueError, match="too few shards"):
        port.reconstruct_rows(partial, [0])
    rows = list(shards)
    whole = port.reconstruct(rows)
    assert all(a is b for a, b in zip(whole, rows))


def test_decode_rows_cache_hits_on_repeat():
    _, shards = _shards(10, 4)
    port = CudaRSCodec(device="cpu")
    partial = [None if i in (3, 12) else shards[i] for i in range(14)]
    port.reconstruct_rows(partial, [3, 12])
    hits = DECODE_ROWS_CACHE.hits
    port.reconstruct_rows(partial, [3, 12])
    assert DECODE_ROWS_CACHE.hits == hits + 1


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_codec_from_reference_carries_the_jax_matrix(k, m):
    data, shards = _shards(k, m)
    ref = TpuRSCodec(k, m)
    port = codec_from_reference(ref.matrix, k, device="cpu")
    assert np.array_equal(port.matrix, ref.matrix)
    assert np.array_equal(port.matrix, CudaRSCodec(k, m, device="cpu").matrix)
    assert np.array_equal(port.encode_all(data), shards)
    bad = ref.matrix.copy()
    bad[0, 1] = 1
    with pytest.raises(ValueError, match="identity"):
        codec_from_reference(bad, k, device="cpu")


def test_default_entry_points_take_the_card(monkeypatch):
    """Without CUDA the default entry points raise instead of running on
    the CPU; the CPU is taken only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CudaRSCodec()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        coder.get_codec()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        coder.get_codec("cuda", 6, 3)
    assert coder.detect_backend() == "cpu"
    assert isinstance(coder.get_codec("cpu"), CpuRSCodec)
    assert isinstance(coder.get_codec("numpy", 6, 3), CpuRSCodec)
    with pytest.raises(ValueError, match="unknown storage backend"):
        coder.get_codec("tpu")
    before = gf256.KERNEL_LAUNCHES
    assert coder.probe_roundtrip_seconds(CudaRSCodec(device="cpu"), 4096, 1) > 0
    assert gf256.KERNEL_LAUNCHES == before


def test_codec_threads_share_nothing():
    """Worker threads call encode concurrently (the streamed pipeline's
    pool); results stay per call."""
    import concurrent.futures as cf

    port = CudaRSCodec(device="cpu")
    inputs = [_shards(10, 4, seed=s) for s in range(8)]
    with cf.ThreadPoolExecutor(4) as pool:
        outs = list(pool.map(lambda ds: port.encode(ds[0]), inputs))
    for (data, shards), parity in zip(inputs, outs):
        assert np.array_equal(parity, shards[10:])
