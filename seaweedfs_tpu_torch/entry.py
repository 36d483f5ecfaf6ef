"""Entry points of the port's EC step, mirroring the JAX package's
`__graft_entry__.py`: `entry()` (the single-device forward step) and
`dryrun(devices)` (the multi-device sequence of `_dryrun_body`).

    python -c "from seaweedfs_tpu_torch import entry; fn, a = entry.entry(); print(fn(*a).shape)"
    python -c "import torch; from seaweedfs_tpu_torch import entry; entry.dryrun([torch.device('cpu')] * 8)"

Both run on the card unless the caller asks for the CPU (`device="cpu"`,
or a list of CPU devices), where the kernels' plain versions run.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.gf256 import _gf_matmul_cuda, gf_matmul_packed, resolve_device
from .storage.erasure_coding.galois import build_matrix


def entry(device=None):
    """(fn, example_args): fn maps a packed uint32[V, 10, W] stripe batch
    (4 bytes per word) to its uint32[V, 4, W] parity words through the
    gf_matmul kernel (B1), one launch per volume; the example batch is
    V=2, W=1024, on `device` (the card unless the caller asks for the
    CPU)."""
    dev = resolve_device(device)
    parity_matrix = build_matrix(10, 14)[10:]

    def encode_step(packed: torch.Tensor) -> torch.Tensor:
        v, c, w = packed.shape
        if c != parity_matrix.shape[1]:
            raise ValueError(f"expected 10 data rows, got {c}")
        if packed.device.type != "cuda":
            return torch.stack([gf_matmul_packed(parity_matrix, packed[i])
                                for i in range(v)])
        out = torch.empty((v, parity_matrix.shape[0], w), dtype=packed.dtype,
                          device=packed.device)
        for i in range(v):
            _gf_matmul_cuda(parity_matrix, packed[i], out=out[i])
        return out

    rng = np.random.default_rng(0)
    example = rng.integers(0, 2**32, size=(2, 10, 1024), dtype=np.uint64).astype(
        np.uint32
    )
    return encode_step, (torch.from_numpy(example).to(dev),)


def dryrun(devices=None) -> None:
    """The JAX package's `_dryrun_body` over a mesh of `devices` (every
    CUDA device by default): a sharded encode of an UNEVEN volume batch,
    its verify (0 mismatches), a reconstruct of a double loss (data shard
    2 and parity shard 12) in one sharded step, and a sharded bulk lookup
    of an uneven probe count. Raises AssertionError on a wrong answer."""
    from .parallel import (
        make_mesh,
        sharded_bulk_lookup,
        sharded_encode,
        sharded_reconstruct_step,
        sharded_verify,
    )
    from .storage.erasure_coding.coder_cpu import CpuRSCodec
    from .storage.erasure_coding.galois import mat_mul, reconstruction_matrix

    mesh = make_mesh(devices=devices)
    n_devices = mesh.devices.size
    vol, blk = mesh.shape["vol"], mesh.shape["blk"]
    codec = CpuRSCodec()

    # uneven volume batch: not divisible by the vol axis (padded inside)
    v = vol * 2 + 1
    n = 4 * blk * 128
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=(v, 10, n), dtype=np.uint8)

    parity = np.asarray(sharded_encode(codec.parity_matrix, data, mesh))
    assert parity.shape == (v, 4, n), parity.shape
    shards = np.concatenate([data, parity], axis=1)

    mismatches = int(sharded_verify(codec.parity_matrix, shards, mesh))
    assert mismatches == 0, f"sharded verify found {mismatches} mismatches"

    # one data shard (2) and one parity shard (12) lost, rebuilt in one
    # sharded step: full_matrix[lost] @ inv(survivor submatrix)
    lost = [2, 12]
    survivors = [i for i in range(14) if i not in lost][:10]
    dec = reconstruction_matrix(codec.matrix, survivors)
    dec_rows = mat_mul(codec.matrix[np.asarray(lost)], dec)
    rec = np.asarray(sharded_reconstruct_step(dec_rows, shards[:, survivors, :], mesh))
    assert np.array_equal(rec[:, 0, :], data[:, 2, :]), "data shard rebuild"
    assert np.array_equal(rec[:, 1, :], parity[:, 2, :]), "parity shard rebuild"

    # probe-parallel bulk lookup, an uneven probe count (padded inside)
    m = 65536
    keys = np.cumsum(rng.integers(1, 9, size=m, dtype=np.uint64)).astype(np.uint64)
    offsets = rng.integers(1, 1 << 30, size=m, dtype=np.uint64).astype(np.uint32)
    sizes = rng.integers(1, 1 << 20, size=m, dtype=np.uint64).astype(np.uint32)
    p_count = n_devices * 1024 + 3
    probe_idx = rng.integers(0, m, size=p_count)
    probes = keys[probe_idx].copy()
    probes[:3] = np.uint64(int(keys[-1]) + 17)  # guaranteed misses
    off, size, found = sharded_bulk_lookup(keys, offsets, sizes, probes, mesh)
    assert len(found) == p_count, "padded probes leaked into the result"
    assert not found[:3].any(), "missing probes reported found"
    assert found[3:].all(), "present probes reported missing"
    assert np.array_equal(off[3:], offsets[probe_idx[3:]]), "sharded lookup offsets"
    assert np.array_equal(size[3:], sizes[probe_idx[3:]]), "sharded lookup sizes"
