"""The port's GF(2^8) product (seaweedfs_tpu_torch.ops.gf256) against the
JAX package's: the plain torch version must be byte-equal to the Pallas
kernel (interpret mode), to the jnp path and to the numpy CpuRSCodec, for
every matrix shape the EC path uses, ragged widths and every byte value;
the kernel's bit-plane arithmetic repeated in torch and the bit-sliced form
(B3) must be byte-equal to the JAX package's routes too.
Tolerance: exact equality (integer arithmetic)."""

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import gf256 as jax_gf
from seaweedfs_tpu.storage.erasure_coding.coder_cpu import CpuRSCodec as JaxCpuRSCodec
from seaweedfs_tpu_torch.ops import _build
from seaweedfs_tpu_torch.ops import gf256 as G
from seaweedfs_tpu_torch.storage.erasure_coding.coder_cpu import CpuRSCodec
from seaweedfs_tpu_torch.storage.erasure_coding.galois import (
    build_matrix,
    compose_decode_rows,
)

WIDTHS = (1, 3, 4, 4097, 70_001)
MAX_W = max(WIDTHS)


def _matrices():
    rng = np.random.default_rng(20)
    return {
        "10.4": build_matrix(10, 14)[10:],
        "6.3": build_matrix(6, 9)[6:],
        "12.4": build_matrix(12, 16)[12:],
        # 2 data + 2 parity lost, rebuilt from the first 10 survivors
        "decode4": compose_decode_rows(
            build_matrix(10, 14), [2, 3, 4, 5, 6, 7, 8, 9, 10, 12], [0, 1, 11, 13]
        ),
        "rand7x11": rng.integers(0, 256, (7, 11), dtype=np.uint8),
    }


MATRICES = _matrices()


def _data(c: int, seed: int) -> np.ndarray:
    """Seeded rows whose first 384 bytes hold every byte value once and
    then all of 0x80-0xFF again (the bytes whose xtime carries)."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (c, MAX_W), dtype=np.uint8)
    for j in range(c):
        data[j, :256] = rng.permutation(256)
        data[j, 256:384] = 0x80 + rng.permutation(128)
    return data


@pytest.fixture(scope="module")
def jax_reference():
    """Per matrix: (data, Pallas-interpret result, jnp result) at the
    widest width. All matrices go through each JAX route in ONE call, as
    the diagonal blocks of one block-diagonal matrix (one compile per
    route); a narrower width's product is the prefix of the wide one (GF
    columns are independent)."""
    r_tot = sum(m.shape[0] for m in MATRICES.values())
    c_tot = sum(m.shape[1] for m in MATRICES.values())
    big = np.zeros((r_tot, c_tot), dtype=np.uint8)
    data = _data(c_tot, 0)
    spans = {}
    r = c = 0
    for name, m in MATRICES.items():
        big[r : r + m.shape[0], c : c + m.shape[1]] = m
        spans[name] = (slice(r, r + m.shape[0]), slice(c, c + m.shape[1]))
        r += m.shape[0]
        c += m.shape[1]
    pallas = np.asarray(
        jax_gf.gf_matmul_bytes(big, data, force_pallas=True, interpret=True)
    )
    jnp_path = np.asarray(jax_gf.gf_matmul_bytes(big, data, force_pallas=False))
    return {
        name: (data[cs], pallas[rs], jnp_path[rs])
        for name, (rs, cs) in spans.items()
    }


@pytest.mark.parametrize("xtime_mode", ["mul", "shift"])
@pytest.mark.parametrize("name", list(MATRICES))
def test_plain_matches_jax_routes_and_cpu_codec(jax_reference, name, xtime_mode):
    m = MATRICES[name]
    data, pallas, jnp_path = jax_reference[name]
    assert np.array_equal(pallas, jnp_path)
    cpu = CpuRSCodec(10, 4)
    for w in WIDTHS:
        got = G.gf_matmul_bytes(m, data[:, :w], xtime_mode=xtime_mode, device="cpu")
        assert got.dtype == np.uint8 and got.shape == (m.shape[0], w)
        assert np.array_equal(got, pallas[:, :w]), (name, w)
        assert np.array_equal(got, cpu.apply_matrix(m, data[:, :w])), (name, w)


@pytest.mark.parametrize("name", list(MATRICES))
def test_plain_packed_matches_jax_packed(jax_reference, name):
    """Packed-word entry point: uint32 numpy and CPU tensors (int32 and
    uint32 views) give the JAX routes' words."""
    m = MATRICES[name]
    data, pallas, _ = jax_reference[name]
    packed = G.pack_bytes_host(data[:, :4097])
    want = G.pack_bytes_host(pallas[:, :4097])
    got_np = G.gf_matmul_packed(m, packed, device="cpu")
    assert got_np.dtype == np.uint32 and np.array_equal(got_np, want)
    t = torch.from_numpy(packed.view(np.int32).copy())
    assert np.array_equal(G.gf_matmul_packed(m, t).numpy().view(np.uint32), want)
    got_u32 = G.gf_matmul_packed(m, t.view(torch.uint32))
    assert got_u32.dtype == torch.uint32
    assert np.array_equal(got_u32.view(torch.int32).numpy().view(np.uint32), want)


# widths in words for the bit-plane and bit-sliced forms: one word, a
# ragged piece, one lane's 32 bytes, a ragged lane, several warp tiles
# with a ragged last one
PLANE_WIDTHS = (1, 7, 8, 33, 1027)
# a 32 x 32 matrix (the kernel's largest) beside the EC shapes; its JAX
# reference is the JAX package's bit-sliced route, since the jnp route
# compiles a 32 x 32 xtime program for about 12 s on the CPU
WIDE = np.random.default_rng(32).integers(0, 256, (32, 32), dtype=np.uint8)


@pytest.fixture(scope="module")
def wide_reference():
    data = _data(32, 7)[:, : 4 * max(PLANE_WIDTHS)]
    packed = G.pack_bytes_host(data)
    return packed, np.asarray(jax_gf.gf_matmul_bitsliced(WIDE, packed))


def _plane_case(name, jax_reference, wide_reference):
    """(matrix, packed words, the JAX package's product) at the widest width."""
    if name == "wide32x32":
        return (WIDE, *wide_reference)
    data, pallas, _ = jax_reference[name]
    w = 4 * max(PLANE_WIDTHS)
    return (MATRICES[name], G.pack_bytes_host(data[:, :w]),
            G.pack_bytes_host(pallas[:, :w]))


@pytest.mark.parametrize("name", [*MATRICES, "wide32x32"])
def test_bitplanes_match_jax_and_plain(jax_reference, wide_reference, name):
    """The kernel's arithmetic step by step (lane layout, plane transpose,
    plane xtime, accumulate, transpose back) equals the JAX package's
    product and the plain version at every width, ragged tiles included."""
    m, packed, want = _plane_case(name, jax_reference, wide_reference)
    for w in PLANE_WIDTHS:
        t = torch.from_numpy(packed[:, :w].view(np.int32).copy())
        got = G._gf_matmul_bitplanes_torch(m, t)
        assert got.shape == (m.shape[0], w)
        assert np.array_equal(got.numpy().view(np.uint32), want[:, :w]), (name, w)
        assert torch.equal(got, G._gf_matmul_torch_packed(m, t)), (name, w)


@pytest.mark.parametrize("name", [*MATRICES, "wide32x32"])
def test_bitsliced_matches_jax(jax_reference, wide_reference, name):
    """B3 ported: the int8 GF(2) product (torch._int_mm) gives the JAX
    package's words, from numpy and from int32 and uint32 CPU tensors;
    its matrix is the JAX package's _bitslice_matrix."""
    m, packed, want = _plane_case(name, jax_reference, wide_reference)
    key = tuple(map(tuple, m))
    assert np.array_equal(G._bitslice_matrix(key), jax_gf._bitslice_matrix(key))
    for w in PLANE_WIDTHS:
        got = G.gf_matmul_bitsliced(m, packed[:, :w], device="cpu")
        assert got.dtype == np.uint32 and np.array_equal(got, want[:, :w]), (name, w)
    t = torch.from_numpy(packed.view(np.int32).copy())
    assert np.array_equal(G.gf_matmul_bitsliced(m, t).numpy().view(np.uint32), want)
    got_u32 = G.gf_matmul_bitsliced(m, t.view(torch.uint32))
    assert got_u32.dtype == torch.uint32
    assert np.array_equal(got_u32.view(torch.int32).numpy().view(np.uint32), want)


def test_plane_transpose_is_its_own_inverse():
    """Plane k holds bit k of every byte: bit 8b + w of it is bit k of byte
    b of word w, and the network undoes itself."""
    words = np.random.default_rng(8).integers(0, 1 << 32, (3, 8), dtype=np.uint64)
    x = torch.from_numpy(words.astype(np.uint32).view(np.int32))
    planes = G._transpose8(x)
    assert torch.equal(G._transpose8(planes), x)
    got = planes.numpy().view(np.uint32).astype(np.uint64)
    by = words.astype(np.uint32).view(np.uint8).reshape(3, 8, 4)
    for k in range(8):
        for w in range(8):
            for b in range(4):
                assert np.array_equal((got[:, k] >> (8 * b + w)) & 1, (by[:, w, b] >> k) & 1)


@pytest.mark.parametrize("xtime_mode", ["mul", "shift"])
def test_count_expr_ops_matches_jax(xtime_mode):
    for name, m in MATRICES.items():
        assert G.count_expr_ops(m, xtime_mode) == jax_gf.count_expr_ops(
            m, xtime_mode
        ), name
    # the bound's figure for the 10.4 encode: 12.8 i32 ops per input byte
    assert G.count_expr_ops(MATRICES["10.4"], "mul") / (10 * 4) == 12.8


def test_xtime_sign_bits():
    """int32 >> is arithmetic in torch: the carry mask must hold for every
    byte with its top bit set, in both forms."""
    words = np.arange(256, dtype=np.uint32) * np.uint32(0x01010101)
    t = torch.from_numpy(words.view(np.int32).copy())
    b = words.view(np.uint8).astype(np.int32)
    want = (((b << 1) & 0xFF) ^ np.where(b & 0x80, 0x1D, 0)).astype(np.uint8)
    for mode in ("mul", "shift"):
        got = G._xtime(t, mode).numpy().view(np.uint8)
        assert np.array_equal(got, want), mode


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 4097])
def test_pack_unpack_roundtrip(n):
    data = np.random.default_rng(n).integers(0, 256, (3, n), dtype=np.uint8)
    packed = G.pack_bytes_host(data)
    assert packed.dtype == np.uint32 and packed.shape == (3, (n + 3) // 4)
    assert np.array_equal(G.unpack_bytes_host(packed, n), data)
    assert np.array_equal(
        packed, jax_gf.pack_bytes_host(data)
    )


def test_cpu_codec_oracles_agree():
    m = MATRICES["10.4"]
    data = _data(10, 5)[:, :4097]
    assert np.array_equal(
        CpuRSCodec().encode(data), JaxCpuRSCodec().encode(data)
    )
    assert np.array_equal(G.gf_matmul_bytes(m, data, device="cpu"), CpuRSCodec().encode(data))


def test_build_module_imports_without_nvcc(monkeypatch, tmp_path):
    """Importing _build needs nothing; asking for nvcc where there is none
    raises instead of running something else."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "NVCC_DEFAULT", str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    assert _build.library_path("gf256").startswith(_build.BUILD_DIR)


def test_kernel_wrapper_refuses_cpu_tensors_and_absent_cuda(monkeypatch):
    m = MATRICES["10.4"]
    t = torch.zeros((10, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        G._gf_matmul_cuda(m, t)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        G.gf_matmul_bytes(m, np.zeros((10, 8), dtype=np.uint8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        G.gf_matmul_packed(m, np.zeros((10, 2), dtype=np.uint32))
    before = G.KERNEL_LAUNCHES
    G.gf_matmul_packed(m, t)  # a CPU tensor runs the plain version
    assert G.KERNEL_LAUNCHES == before
