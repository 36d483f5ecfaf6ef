"""CPU (numpy) Reed-Solomon codec — the byte-parity oracle.

Encode: parity[m, N] = M_parity . data[k, N] over GF(2^8), computed with
256-entry table gathers per matrix constant. Reconstruct mirrors
klauspost/reedsolomon's Reconstruct: invert the survivor submatrix to recover
data shards, then re-encode any missing parity.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .galois import (
    DECODE_ROWS_CACHE,
    MUL_TABLE,
    build_matrix,
    reconstruction_matrix,
)


class CpuRSCodec:
    def __init__(self, data_shards: int = 10, parity_shards: int = 4):
        if data_shards <= 0 or parity_shards <= 0:
            raise ValueError("shard counts must be positive")
        if data_shards + parity_shards > 256:
            raise ValueError("too many shards for GF(2^8)")
        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.total_shards = data_shards + parity_shards
        # (n x k) systematic matrix: identity rows then parity rows
        self.matrix = build_matrix(data_shards, self.total_shards)
        self.parity_matrix = self.matrix[data_shards:]

    def _mat_apply(self, m: np.ndarray, data: np.ndarray) -> np.ndarray:
        """rows_out[i] = XOR_j MUL[m[i,j]] gathered over data[j]."""
        out = np.zeros((m.shape[0], data.shape[1]), dtype=np.uint8)
        for i in range(m.shape[0]):
            acc = out[i]
            for j in range(m.shape[1]):
                c = int(m[i, j])
                if c == 0:
                    continue
                if c == 1:
                    acc ^= data[j]
                else:
                    acc ^= MUL_TABLE[c][data[j]]
        return out

    def _apply_rows(
        self,
        m: np.ndarray,
        rows: "Sequence[np.ndarray]",
        out: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """_mat_apply over separately-allocated 1-D rows; subclasses that can
        consume row pointers (native) override to skip the stack copy and
        write straight into a caller-recycled `out`."""
        res = self._mat_apply(m, np.stack(rows))
        if out is None:
            return res
        out[:] = res
        return out

    def apply_matrix(self, m: np.ndarray, data: np.ndarray) -> np.ndarray:
        """Public bulk GF(2^8) matmul: uint8[R, C] x uint8[C, N] -> uint8[R, N]
        on this codec's compute path (the primitive batched multi-volume
        rebuild dispatches through)."""
        return self._mat_apply(np.asarray(m, dtype=np.uint8), data)

    def encode(self, data: np.ndarray) -> np.ndarray:
        """data: uint8[k, N] -> parity uint8[m, N]."""
        assert data.shape[0] == self.data_shards, data.shape
        return self._mat_apply(self.parity_matrix, data)

    def encode_rows(self, rows: Sequence[np.ndarray]) -> np.ndarray:
        """encode() over k separately-allocated 1-D rows (e.g. views into an
        mmapped .dat) — the native codec consumes the row pointers without a
        gather copy; this oracle stacks."""
        assert len(rows) == self.data_shards
        return self._mat_apply(self.parity_matrix, np.stack(rows))

    def encode_all(self, data: np.ndarray) -> np.ndarray:
        """data: uint8[k, N] -> all shards uint8[k+m, N] (data passthrough)."""
        return np.concatenate([data, self.encode(data)], axis=0)

    def verify(self, shards: np.ndarray) -> bool:
        """shards: uint8[k+m, N]; True iff parity matches data."""
        expected = self.encode(shards[: self.data_shards])
        return bool(np.array_equal(expected, shards[self.data_shards :]))

    def reconstruct(
        self, shards: Sequence[Optional[np.ndarray]], data_only: bool = False
    ) -> list[np.ndarray]:
        """Fill in missing (None) shards from any k survivors.

        Returns the complete shard list; raises if fewer than k survive
        (ref: klauspost Reconstruct semantics used at ec_encoder.go:270).
        """
        shards = list(shards)
        if len(shards) != self.total_shards:
            raise ValueError(f"expected {self.total_shards} shard slots")
        present = [i for i, s in enumerate(shards) if s is not None]
        if len(present) < self.data_shards:
            raise ValueError(
                f"too few shards: {len(present)} < {self.data_shards}"
            )
        missing_data = [
            i for i in range(self.data_shards) if shards[i] is None
        ]
        missing_parity = [
            i
            for i in range(self.data_shards, self.total_shards)
            if shards[i] is None
        ]
        if not missing_data and not missing_parity:
            return shards  # nothing to do

        if missing_data:
            survivors = present[: self.data_shards]
            dec = reconstruction_matrix(self.matrix, survivors)
            sub_shards = np.stack([shards[i] for i in survivors])
            rows = dec[np.asarray(missing_data)]
            recovered = self._mat_apply(rows, sub_shards)
            for out_row, i in enumerate(missing_data):
                shards[i] = recovered[out_row]

        if missing_parity and not data_only:
            data = np.stack([shards[i] for i in range(self.data_shards)])
            rows = self.matrix[np.asarray(missing_parity)]
            recovered = self._mat_apply(rows, data)
            for out_row, i in enumerate(missing_parity):
                shards[i] = recovered[out_row]
        return shards

    def reconstruct_rows(
        self,
        shards: Sequence[Optional[np.ndarray]],
        wanted: Sequence[int],
        out: Optional[np.ndarray] = None,
    ) -> list[np.ndarray]:
        """Reconstruct ONLY the `wanted` shard ids from any k survivors.

        Returns arrays aligned with `wanted` (already-present wanted shards
        pass through untouched), byte-identical to full reconstruct() on the
        same ids — but the decode matrix is sliced to the wanted rows (one
        fused matmul, parity rows composed with the survivor inverse) and
        cached in the shared DECODE_ROWS_CACHE LRU, so the per-chunk cost is
        the matmul alone. This is the repair-plane hot primitive: rebuild
        pays for 4 output rows instead of 14, a single-dead-shard degraded
        read for 1.
        """
        shards = list(shards)
        if len(shards) != self.total_shards:
            raise ValueError(f"expected {self.total_shards} shard slots")
        present = [i for i, s in enumerate(shards) if s is not None]
        if len(present) < self.data_shards:
            raise ValueError(
                f"too few shards: {len(present)} < {self.data_shards}"
            )
        need = [i for i in wanted if shards[i] is None]
        recovered_by_id: dict[int, np.ndarray] = {}
        if need:
            survivors = present[: self.data_shards]
            rows = DECODE_ROWS_CACHE.rows_for(self.matrix, survivors, need)
            recovered = self._apply_rows(
                rows,
                [shards[i] for i in survivors],
                # `out` (shape [len(need), N]) only fits when every wanted
                # id actually needs recovering — hot callers guarantee that
                out=out if out is not None and len(need) == len(wanted) else None,
            )
            for out_row, i in enumerate(need):
                recovered_by_id[i] = recovered[out_row]
        return [
            shards[i] if shards[i] is not None else recovered_by_id[i]
            for i in wanted
        ]
