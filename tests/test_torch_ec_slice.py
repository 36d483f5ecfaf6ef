"""The port's erasure-coding slice end to end on the CPU, against the JAX
package: a volume written by the JAX Volume is encoded by the port
(.ec00-.ec13 and .ecx byte-identical to the JAX pipeline), rebuilt after
shard losses, and read back with 4 shards missing; shards cross between the
two packages in both directions. Block sizes are shrunk (64 KiB large,
4 KiB small) with a .dat above 10 large blocks, so both block levels and
the boundary between them run. Tolerance: exact equality."""

import os
import shutil
from dataclasses import astuple

import numpy as np
import pytest

from seaweedfs_tpu.storage.erasure_coding import ec_volume as jax_ec_volume
from seaweedfs_tpu.storage.erasure_coding import encoder as jax_encoder
from seaweedfs_tpu.storage.erasure_coding.coder_cpu import CpuRSCodec as JaxCpuRSCodec
from seaweedfs_tpu.storage.needle import Needle as JaxNeedle
from seaweedfs_tpu.storage.volume import Volume as JaxVolume
from seaweedfs_tpu_torch.ops.rs_kernel import CudaRSCodec
from seaweedfs_tpu_torch.storage.erasure_coding import (
    EcVolume,
    NeedleNotFound,
    to_ext,
)
from seaweedfs_tpu_torch.storage.erasure_coding import encoder as enc
from seaweedfs_tpu_torch.storage.erasure_coding.coder_cpu import CpuRSCodec
from seaweedfs_tpu_torch.storage.volume_info import VolumeInfo, save_volume_info

LARGE = 1 << 16
SMALL = 1 << 12
VID = 1
N_NEEDLES = 300
DELETED = (7, 150)


@pytest.fixture(scope="module")
def jax_volume(tmp_path_factory):
    """(directory, {needle id: (data, checksum)}) of a sealed JAX volume:
    mixed needle sizes (1 B - 12 KB, some with name/mime), one rewritten
    needle and two deleted ones; the expected reads come from the JAX
    Volume itself."""
    d = tmp_path_factory.mktemp("jaxvol")
    v = JaxVolume(str(d), "", VID)
    rng = np.random.default_rng(2024)
    for i in range(N_NEEDLES):
        n = JaxNeedle(
            cookie=int(rng.integers(1 << 32)),
            id=i + 1,
            data=rng.integers(0, 256, int(rng.integers(1, 12_000)), dtype=np.uint8).tobytes(),
        )
        if i % 3 == 0:
            n.set_name(b"f%d.bin" % i)
            n.set_mime(b"application/octet-stream")
        v.write_needle(n)
    again = JaxNeedle(cookie=v.read_needle_by_key(42).cookie, id=42, data=b"rewritten" * 100)
    v.write_needle(again)
    for nid in DELETED:
        v.delete_needle(JaxNeedle(cookie=v.read_needle_by_key(nid).cookie, id=nid))
    expected = {}
    for nid in range(1, N_NEEDLES + 1):
        if nid in DELETED:
            continue
        n = v.read_needle_by_key(nid)
        expected[nid] = (bytes(n.data), n.checksum)
    v.close()
    assert os.path.getsize(d / f"{VID}.dat") > 2 * 10 * LARGE  # 2 large rows
    return d, expected


def _copy_volume(src, dst) -> str:
    os.makedirs(dst, exist_ok=True)
    for ext in (".dat", ".idx"):
        shutil.copy(os.path.join(src, f"{VID}{ext}"), os.path.join(dst, f"{VID}{ext}"))
    return os.path.join(str(dst), str(VID))


def _read_all(base: str, total: int = 14) -> list:
    out = []
    for i in range(total):
        with open(base + to_ext(i), "rb") as f:
            out.append(f.read())
    return out


def _jax_encode(base: str, k: int = 10, m: int = 4) -> None:
    jax_encoder.write_ec_files(
        base, codec=JaxCpuRSCodec(k, m), large_block_size=LARGE,
        small_block_size=SMALL, pipeline=False, splice_data=False,
        mmap_input=False, onepass=False,
    )
    jax_encoder.write_sorted_file_from_idx(base)


@pytest.fixture(scope="module")
def jax_shards(jax_volume, tmp_path_factory):
    """The JAX pipeline's .ecNN and .ecx for the fixture volume."""
    src, _ = jax_volume
    base = _copy_volume(src, tmp_path_factory.mktemp("jaxec"))
    _jax_encode(base)
    with open(base + ".ecx", "rb") as f:
        return base, _read_all(base), f.read()


def _port_encode(base: str, codec, **kw) -> None:
    enc.write_ec_files(
        base, codec=codec, large_block_size=LARGE, small_block_size=SMALL, **kw
    )
    enc.write_sorted_file_from_idx(base)
    save_volume_info(base + ".vif", VolumeInfo(version=3))


@pytest.mark.parametrize(
    "codec_name,kw,route",
    [
        ("cuda-on-cpu", {"chunk": 3000}, ("pipeline", "mmap")),
        ("cuda-on-cpu", {"chunk": 50_000, "mmap_input": False}, ("pipeline", "pread")),
        ("numpy", {"chunk": 1000}, ("pread", None)),
        ("numpy", {"pipeline": True, "chunk": 5000}, ("pipeline", "mmap")),
    ],
)
def test_encode_matches_jax_pipeline(jax_volume, jax_shards, tmp_path, codec_name, kw, route):
    src, _ = jax_volume
    _, want_shards, want_ecx = jax_shards
    base = _copy_volume(src, tmp_path)
    codec = CudaRSCodec(device="cpu") if codec_name == "cuda-on-cpu" else CpuRSCodec()
    _port_encode(base, codec, **kw)
    assert enc.LAST_ROUTE["route"] == route[0]
    assert enc.LAST_ROUTE.get("input") == route[1]
    assert enc.LAST_STAGES["total_s"] > 0
    got = _read_all(base)
    for i in range(14):
        assert got[i] == want_shards[i], f"shard {to_ext(i)} diverged"
    with open(base + ".ecx", "rb") as f:
        assert f.read() == want_ecx
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


def test_encode_6_3_geometry_matches_jax(jax_volume, tmp_path):
    src, _ = jax_volume
    ref = _copy_volume(src, tmp_path / "ref")
    _jax_encode(ref, 6, 3)
    base = _copy_volume(src, tmp_path / "port")
    enc.write_ec_files(
        base, codec=CudaRSCodec(6, 3, device="cpu"), large_block_size=LARGE,
        small_block_size=SMALL, chunk=7000,
    )
    assert _read_all(base, 9) == _read_all(ref, 9)


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("lost", [[3], [0, 12], [1, 5, 11, 12]])
def test_rebuild_restores_identical_shards(jax_shards, tmp_path, lost, pipeline):
    src_base, want, _ = jax_shards
    base = str(tmp_path / str(VID))
    for i in range(14):
        shutil.copy(src_base + to_ext(i), base + to_ext(i))
    for i in lost:
        os.remove(base + to_ext(i))
    rebuilt = enc.rebuild_ec_files(
        base, codec=CudaRSCodec(device="cpu"), chunk=20_000, pipeline=pipeline
    )
    assert rebuilt == lost
    assert enc.LAST_REBUILD_ROUTE["pipeline"] is pipeline
    assert _read_all(base) == want
    assert enc.rebuild_ec_files(base, codec=CudaRSCodec(device="cpu")) == []


def test_rebuild_refuses_too_few_or_truncated_survivors(jax_shards, tmp_path):
    src_base, _, _ = jax_shards
    base = str(tmp_path / str(VID))
    for i in range(14):
        shutil.copy(src_base + to_ext(i), base + to_ext(i))
    with open(base + to_ext(2), "r+b") as f:
        f.truncate(100)
    os.remove(base + to_ext(0))
    with pytest.raises(IOError, match="disagree on size"):
        enc.rebuild_ec_files(base, codec=CpuRSCodec())
    for i in (1, 2, 3, 4):
        os.remove(base + to_ext(i))
    with pytest.raises(ValueError, match="need at least 10"):
        enc.rebuild_ec_files(base, codec=CpuRSCodec())


def _degraded_dir(jax_volume, tmp_path, codec, lost=(1, 5, 11, 12)) -> str:
    src, _ = jax_volume
    base = _copy_volume(src, tmp_path)
    _port_encode(base, codec, chunk=9000)
    for i in lost:
        os.remove(base + to_ext(i))
    return base


def test_degraded_read_matches_jax_volume(jax_volume, tmp_path):
    """4 shards gone: every needle reads back with the JAX Volume's data and
    checksum, including the ones that straddle block boundaries."""
    _, expected = jax_volume
    codec = CudaRSCodec(device="cpu")
    _degraded_dir(jax_volume, tmp_path, codec)
    straddling = 0
    with EcVolume(str(tmp_path), "", VID, LARGE, SMALL) as ev:
        assert ev.shard_ids() == [0, 2, 3, 4, 6, 7, 8, 9, 10, 13]
        for nid, (data, checksum) in expected.items():
            n = ev.read_needle(nid, codec)
            assert n.id == nid
            assert bytes(n.data) == data, nid
            assert n.checksum == checksum, nid
            straddling += len(ev.locate_needle(nid)[2]) > 1
        for nid in DELETED + (N_NEEDLES + 1,):
            with pytest.raises(NeedleNotFound):
                ev.read_needle(nid, codec)
    assert straddling > 10


def test_port_shards_cross_into_jax(jax_volume, tmp_path, monkeypatch):
    """The JAX rebuild and EcVolume accept shards the port wrote."""
    _, expected = jax_volume
    base = _degraded_dir(jax_volume, tmp_path, CudaRSCodec(device="cpu"), lost=(0, 13))
    assert jax_encoder.rebuild_ec_files(
        base, codec=JaxCpuRSCodec(), route="pread"
    ) == [0, 13]
    monkeypatch.setattr(jax_ec_volume, "EC_LARGE_BLOCK_SIZE", LARGE)
    monkeypatch.setattr(jax_ec_volume, "EC_SMALL_BLOCK_SIZE", SMALL)
    jev = jax_ec_volume.EcVolume(str(tmp_path), "", VID)
    for sid in range(14):
        jev.add_shard(jax_ec_volume.EcVolumeShard(str(tmp_path), "", VID, sid))
    try:
        with EcVolume(str(tmp_path), "", VID, LARGE, SMALL) as ev:
            for nid in list(expected)[::7]:
                offset_units, size, intervals = jev.locate_needle(nid)
                port_units, port_size, port_intervals = ev.locate_needle(nid)
                assert (offset_units, size) == (port_units, port_size)
                assert [astuple(iv) for iv in intervals] == [
                    astuple(iv) for iv in port_intervals
                ]
                blob = b"".join(
                    jev.find_shard(sid).read_at(iv.size, off)
                    for iv in intervals
                    for sid, off in [iv.to_shard_id_and_offset(LARGE, SMALL)]
                )
                n = JaxNeedle()
                n.read_bytes(blob, offset_units * 8, size, 3)
                assert (bytes(n.data), n.checksum) == expected[nid]
    finally:
        jev.close()


def test_jax_shards_cross_into_port(jax_volume, jax_shards, tmp_path):
    """The port rebuilds and serves degraded reads from shards the JAX
    package wrote."""
    _, expected = jax_volume
    src_base, want, _ = jax_shards
    base = str(tmp_path / str(VID))
    for ext in [to_ext(i) for i in range(14)] + [".ecx"]:
        shutil.copy(src_base + ext, base + ext)
    for i in (2, 9, 10, 13):
        os.remove(base + to_ext(i))
    codec = CudaRSCodec(device="cpu")
    with EcVolume(str(tmp_path), "", VID, LARGE, SMALL) as ev:
        for nid in list(expected)[::5]:
            n = ev.read_needle(nid, codec)
            assert (bytes(n.data), n.checksum) == expected[nid]
    assert enc.rebuild_ec_files(base, codec=codec, chunk=30_000) == [2, 9, 10, 13]
    assert _read_all(base) == want


def test_default_codec_is_the_card(jax_volume, tmp_path, monkeypatch):
    import torch

    src, _ = jax_volume
    base = _copy_volume(src, tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        enc.write_ec_files(base, large_block_size=LARGE, small_block_size=SMALL)
    assert not [p for p in os.listdir(tmp_path) if ".ec" in p]


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 16_383, 16_384, 70_001, 1 << 20])
def test_crc32c_fallbacks_match_native(n):
    """Without google_crc32c (as on the card's machine) the port checks
    needles with a table loop or, from 16 KiB, the lane-parallel numpy
    form; both must give google_crc32c's CRC for any length and seed, and
    the masked value must be the JAX package's."""
    import google_crc32c

    from seaweedfs_tpu.util.crc import masked_crc as jax_masked_crc
    from seaweedfs_tpu_torch.util import crc

    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    for init in (0, 0x12345678):
        want = google_crc32c.extend(init, data)
        if n:
            assert crc._crc32c_lanes(data, init) == want
        if n <= 70_001:
            assert crc._crc32c_loop(data, init) == want
    assert crc.masked_crc(data) == jax_masked_crc(data)
