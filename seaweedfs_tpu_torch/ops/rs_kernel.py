"""CUDA Reed-Solomon codec: same interface as CpuRSCodec, compute on the card.

Encode, reconstruct and rebuild are all one primitive, a GF(2^8)
constant-matrix multiply (gf256), applied with the parity matrix, a
survivor-inverse matrix, or selected rows of either. Decode matrices are
tiny (k x k), computed host-side in numpy per missing-shard pattern and
cached in galois.DECODE_ROWS_CACHE; the kernel takes any matrix at run
time, so a new pattern costs no build.

Host data reaches the card through per-thread staging: the EC file
pipeline calls encode() from a pool of worker threads at once, so each
thread owns a CUDA stream, pinned host buffers (in and out) and device
buffers, reused across chunks and grown when a wider chunk arrives. A call
copies its rows into the pinned buffer, uploads, launches, downloads and
synchronises its own stream before it hands numpy back.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np
import torch

from ..storage.erasure_coding.galois import (
    DECODE_ROWS_CACHE,
    build_matrix,
    mat_mul,
    reconstruction_matrix,
)
from .gf256 import _gf_matmul_cuda, gf_matmul_bytes, resolve_device


class _Staging:
    """One worker thread's stream and buffers, sized to the widest call."""

    def __init__(self, device: torch.device, cap_in: int, cap_out: int):
        self.stream = torch.cuda.Stream(device)
        self.cap_in = cap_in
        self.cap_out = cap_out
        self.host_in = torch.empty(cap_in, dtype=torch.uint8, pin_memory=True)
        self.host_out = torch.empty(cap_out, dtype=torch.uint8, pin_memory=True)
        self.host_in_np = self.host_in.numpy()
        self.host_out_np = self.host_out.numpy()
        self.dev_in = torch.empty(cap_in, dtype=torch.uint8, device=device)
        self.dev_out = torch.empty(cap_out, dtype=torch.uint8, device=device)


class CudaRSCodec:
    """Drop-in for CpuRSCodec with the hand-written CUDA kernel.

    Accepts numpy uint8 arrays of shape [shards, N] (or sequences of 1-D
    rows, including read-only strided views of a mapped file); returns
    numpy arrays (the storage pipeline writes them straight to shard
    files). device=None takes the card and raises when CUDA is absent;
    device="cpu" runs the plain PyTorch version instead.
    """

    # the EC file pipeline overlaps disk IO with device encode for this
    # codec (stage + upload + kernel + download per chunk run on a pool of
    # workers); large chunks amortize per-dispatch latency
    prefers_pipeline = True
    preferred_chunk = 16 * 1024 * 1024
    is_device = True

    def __init__(
        self,
        data_shards: int = 10,
        parity_shards: int = 4,
        device=None,
    ):
        if data_shards <= 0 or parity_shards <= 0:
            raise ValueError("shard counts must be positive")
        self.device = resolve_device(device)
        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.total_shards = data_shards + parity_shards
        self.matrix = build_matrix(data_shards, self.total_shards)
        self.parity_matrix = self.matrix[data_shards:]
        self.pipeline_workers = 4 if self.device.type == "cuda" else 2
        self._local = threading.local()

    @property
    def pipeline_dispatch_kind(self) -> str:
        """What the streamed pipeline's kernel stage runs: "device" (stage
        + upload + CUDA kernel + download) or "cpu" (the plain version)."""
        return "device" if self.device.type == "cuda" else "cpu"

    def pipeline_encode(self, data) -> np.ndarray:
        """Per-chunk encode for the streamed file pipeline."""
        return self.encode(data)

    # --- the one primitive ---
    def _staging(self, cap_in: int, cap_out: int) -> _Staging:
        st = getattr(self._local, "staging", None)
        if st is None or st.cap_in < cap_in or st.cap_out < cap_out:
            if st is not None:
                cap_in = max(cap_in, st.cap_in)
                cap_out = max(cap_out, st.cap_out)
            st = _Staging(self.device, cap_in, cap_out)
            self._local.staging = st
        return st

    def _apply(
        self, matrix: np.ndarray, rows, out: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """uint8 rows [C][N] -> uint8[R, N] = matrix (x) rows over GF(2^8).
        With `out` given ([R, N] uint8), the result lands there."""
        matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
        rows = [np.asarray(r, dtype=np.uint8) for r in rows]
        r_cnt, c_cnt = matrix.shape
        if len(rows) != c_cnt:
            raise ValueError(f"{len(rows)} rows for a matrix of {c_cnt} columns")
        n = rows[0].shape[0] if rows else 0
        if any(r.shape != (n,) for r in rows):
            raise ValueError("input rows must be 1-D and of equal length")
        if self.device.type == "cpu" or n == 0:
            res = gf_matmul_bytes(matrix, np.stack(rows), device="cpu")
        else:
            res = self._apply_cuda(matrix, rows, n, out)
            if out is not None:
                return out
        if out is None:
            return res
        out[:] = res
        return out

    def _apply_cuda(
        self, matrix: np.ndarray, rows: list, n: int, out: Optional[np.ndarray]
    ) -> np.ndarray:
        r_cnt, c_cnt = matrix.shape
        words = (n + 3) // 4
        pitch_w = (words + 3) // 4 * 4  # 16-byte rows: whole uint4 columns
        pitch_b = pitch_w * 4
        st = self._staging(c_cnt * pitch_b, r_cnt * pitch_b)
        host_in = st.host_in_np[: c_cnt * pitch_b].reshape(c_cnt, pitch_b)
        for i, row in enumerate(rows):
            np.copyto(host_in[i, :n], row)
            host_in[i, n : words * 4] = 0  # the packed tail word's pad bytes
        with torch.cuda.stream(st.stream):
            dev_in = st.dev_in[: c_cnt * pitch_b]
            dev_in.copy_(st.host_in[: c_cnt * pitch_b], non_blocking=True)
            dev_out = st.dev_out[: r_cnt * pitch_b]
            _gf_matmul_cuda(
                matrix,
                dev_in.view(torch.int32).view(c_cnt, pitch_w)[:, :words],
                out=dev_out.view(torch.int32).view(r_cnt, pitch_w)[:, :words],
            )
            st.host_out[: r_cnt * pitch_b].copy_(dev_out, non_blocking=True)
        st.stream.synchronize()
        res = st.host_out_np[: r_cnt * pitch_b].reshape(r_cnt, pitch_b)[:, :n]
        if out is not None:
            out[:] = res
            return out
        # the pinned buffer is reused by this thread's next call
        return res.copy()

    # --- codec interface ---
    def encode(self, data) -> np.ndarray:
        """uint8[k, N] -> parity uint8[m, N]."""
        if len(data) != self.data_shards:
            raise ValueError(f"expected {self.data_shards} data rows")
        return self._apply(self.parity_matrix, data)

    def encode_all(self, data) -> np.ndarray:
        data_np = np.asarray(data, dtype=np.uint8)
        return np.concatenate([data_np, self.encode(data_np)], axis=0)

    def verify(self, shards) -> bool:
        shards = np.asarray(shards, dtype=np.uint8)
        return bool(
            np.array_equal(self.encode(shards[: self.data_shards]),
                           shards[self.data_shards :])
        )

    def reconstruct(
        self, shards: Sequence[Optional[np.ndarray]], data_only: bool = False
    ) -> list:
        shards = list(shards)
        if len(shards) != self.total_shards:
            raise ValueError(f"expected {self.total_shards} shard slots")
        present = [i for i, s in enumerate(shards) if s is not None]
        if len(present) < self.data_shards:
            raise ValueError(f"too few shards: {len(present)} < {self.data_shards}")
        missing_data = [i for i in range(self.data_shards) if shards[i] is None]
        missing_parity = [
            i for i in range(self.data_shards, self.total_shards) if shards[i] is None
        ]
        if not missing_data and not missing_parity:
            return shards

        survivors = present[: self.data_shards]
        if missing_data or (missing_parity and not data_only):
            dec = reconstruction_matrix(self.matrix, survivors)
            # one launch: [missing_data rows; missing_parity rows] where
            # parity rows are (parity_matrix . dec) applied to the survivors
            rows = []
            if missing_data:
                rows.append(dec[np.asarray(missing_data)])
            if missing_parity and not data_only:
                par_rows = self.matrix[np.asarray(missing_parity)]
                rows.append(mat_mul(par_rows, dec))
            m = np.concatenate(rows, axis=0)
            recovered = self._apply(m, [shards[i] for i in survivors])
            targets = missing_data + (missing_parity if not data_only else [])
            for out_row, i in enumerate(targets):
                shards[i] = recovered[out_row]
        return shards

    def apply_matrix(self, m: np.ndarray, data) -> np.ndarray:
        """Public bulk GF(2^8) matmul on this codec's device."""
        return self._apply(np.asarray(m, dtype=np.uint8), data)

    def reconstruct_rows(
        self,
        shards: Sequence[Optional[np.ndarray]],
        wanted: Sequence[int],
        out: Optional[np.ndarray] = None,
    ) -> list:
        """Reconstruct ONLY the `wanted` shard ids from any k survivors:
        one launch with the composed decode rows (data rows from the
        survivor inverse, parity rows pre-multiplied host-side), cached per
        (survivor set, wanted rows) in the shared DECODE_ROWS_CACHE. With
        `out` ([len(wanted), N]) and every wanted id missing, the result
        lands in the caller's recycled buffer."""
        shards = list(shards)
        if len(shards) != self.total_shards:
            raise ValueError(f"expected {self.total_shards} shard slots")
        present = [i for i, s in enumerate(shards) if s is not None]
        if len(present) < self.data_shards:
            raise ValueError(
                f"too few shards: {len(present)} < {self.data_shards}"
            )
        need = [i for i in wanted if shards[i] is None]
        recovered_by_id = {}
        if need:
            survivors = present[: self.data_shards]
            rows = DECODE_ROWS_CACHE.rows_for(self.matrix, survivors, need)
            recovered = self._apply(
                rows,
                [shards[i] for i in survivors],
                out=out if out is not None and len(need) == len(wanted) else None,
            )
            for out_row, i in enumerate(need):
                recovered_by_id[i] = recovered[out_row]
        return [
            shards[i] if shards[i] is not None else recovered_by_id[i]
            for i in wanted
        ]


def codec_from_reference(
    matrix: np.ndarray, data_shards: int, device=None
) -> CudaRSCodec:
    """The port's codec for an encode matrix taken from the JAX package's
    codec (TpuRSCodec.matrix: numpy uint8 [k+m, k], identity on top). Every
    other piece of a deployment's state (.dat, .idx, .ecNN, .ecx, .vif) is
    on disk in formats both packages share."""
    matrix = np.asarray(matrix, dtype=np.uint8)
    if matrix.ndim != 2 or matrix.shape[1] != data_shards:
        raise ValueError(
            f"matrix {matrix.shape} does not have {data_shards} columns"
        )
    if matrix.shape[0] <= data_shards:
        raise ValueError("matrix has no parity rows")
    if not np.array_equal(
        matrix[:data_shards], np.eye(data_shards, dtype=np.uint8)
    ):
        raise ValueError("the top k rows of an encode matrix must be the identity")
    codec = CudaRSCodec(data_shards, matrix.shape[0] - data_shards, device=device)
    codec.matrix = matrix.copy()
    codec.parity_matrix = codec.matrix[data_shards:]
    return codec
