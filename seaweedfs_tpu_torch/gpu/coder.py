"""Codec selection: the storage backend switch.

The reference hard-codes klauspost/reedsolomon (ref: ec_encoder.go:198);
here the codec is an injected dependency of the EC file pipeline, selected
by name:

    cuda    the hand-written CUDA kernel (ops/rs_kernel.py, CudaRSCodec);
            the default, and it raises when CUDA is absent
    cpu     numpy tables on the host (CpuRSCodec)
    numpy   the same numpy codec, by its own name

Both implementations expose the same interface (encode / encode_all /
verify / reconstruct / reconstruct_rows / apply_matrix over
uint8[shards, N]) and produce byte-identical output.
"""

from __future__ import annotations

import time


def get_codec(
    backend: str = "cuda",
    data_shards: int = 10,
    parity_shards: int = 4,
):
    if backend == "cuda":
        from ..ops.rs_kernel import CudaRSCodec

        return CudaRSCodec(data_shards, parity_shards)
    if backend in ("cpu", "numpy"):
        from ..storage.erasure_coding.coder_cpu import CpuRSCodec

        return CpuRSCodec(data_shards, parity_shards)
    raise ValueError(
        f"unknown storage backend {backend!r} (want 'cuda', 'cpu' or 'numpy')"
    )


def detect_backend() -> str:
    """'cuda' when a CUDA device is attached, else 'cpu'."""
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


def probe_roundtrip_seconds(codec, width: int = 1 << 20, reps: int = 2) -> float:
    """Best-of-reps wall time of one full encode round trip (host buffer in,
    parity bytes back on host) at `width` bytes per shard. For a device codec
    this includes staging + upload + kernel + download — exactly the cost
    the file pipeline pays per chunk."""
    import numpy as np

    data = np.zeros((codec.data_shards, width), dtype=np.uint8)
    out = codec.encode(data)  # build / warm outside the timed reps
    _ = bytes(memoryview(np.ascontiguousarray(out[0]))[:8])
    best = float("inf")
    for _i in range(reps):
        t0 = time.perf_counter()
        out = codec.encode(data)
        _ = bytes(memoryview(np.ascontiguousarray(out[0]))[:8])  # force host
        best = min(best, time.perf_counter() - t0)
    return best
