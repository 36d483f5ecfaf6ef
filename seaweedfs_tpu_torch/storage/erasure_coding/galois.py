"""GF(2^8) arithmetic and Reed-Solomon matrix construction.

Field: polynomial x^8 + x^4 + x^3 + x^2 + 1 (0x11D), generator 2 — the same
field klauspost/reedsolomon (and Backblaze's JavaReedSolomon) uses, so the
systematic encode matrix built here is element-identical to the one the
reference's `reedsolomon.New(10, 4)` produces and the parity shards are
byte-identical (ref: ec_encoder.go:198).

Construction: vm[r][c] = r^c in GF (a Vandermonde matrix), then
matrix = vm * inverse(vm[:k]) so the top k rows are the identity and the
remaining m rows generate parity.
"""

from __future__ import annotations

import numpy as np

FIELD_POLY = 0x11D
GENERATOR = 2

# --- exp/log tables ---
EXP_TABLE = np.zeros(512, dtype=np.uint8)  # doubled to skip the mod in hot paths
LOG_TABLE = np.zeros(256, dtype=np.int32)


def _build_tables() -> None:
    x = 1
    for i in range(255):
        EXP_TABLE[i] = x
        LOG_TABLE[x] = i
        x <<= 1
        if x & 0x100:
            x ^= FIELD_POLY
    for i in range(255, 512):
        EXP_TABLE[i] = EXP_TABLE[i - 255]


_build_tables()

# Full 256x256 multiplication table: MUL_TABLE[a][b] = a*b in GF(2^8).
# 64KB; the row MUL_TABLE[c] is the byte-level lookup used by the vectorized
# numpy encoder and by table-based kernels.
_a = np.arange(256, dtype=np.int32)
_log_sum = LOG_TABLE[:, None] + LOG_TABLE[None, :]
MUL_TABLE = EXP_TABLE[_log_sum % 255].astype(np.uint8)
MUL_TABLE[0, :] = 0
MUL_TABLE[:, 0] = 0
del _a, _log_sum


def gf_mul(a: int, b: int) -> int:
    return int(MUL_TABLE[a, b])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("division by zero in GF(2^8)")
    if a == 0:
        return 0
    return int(EXP_TABLE[(LOG_TABLE[a] - LOG_TABLE[b]) % 255])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("zero has no inverse in GF(2^8)")
    return int(EXP_TABLE[(255 - LOG_TABLE[a]) % 255])


def gf_exp(a: int, n: int) -> int:
    """a^n in GF(2^8) (ref: klauspost galois.go galExp semantics)."""
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(EXP_TABLE[(LOG_TABLE[a] * n) % 255])


def gf_mul_row(c: int, data: np.ndarray) -> np.ndarray:
    """Multiply every byte of `data` by constant c (table gather)."""
    return MUL_TABLE[c][data]


# --- matrix algebra over GF(2^8) ---
def mat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF matrix product of small uint8 matrices."""
    rows, inner = a.shape
    inner2, cols = b.shape
    assert inner == inner2
    out = np.zeros((rows, cols), dtype=np.uint8)
    for r in range(rows):
        acc = np.zeros(cols, dtype=np.uint8)
        for k in range(inner):
            acc ^= MUL_TABLE[a[r, k]][b[k]]
        out[r] = acc
    return out


def mat_inv(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inversion over GF(2^8)."""
    n = m.shape[0]
    assert m.shape == (n, n)
    aug = np.zeros((n, 2 * n), dtype=np.uint8)
    aug[:, :n] = m
    aug[:, n:] = np.eye(n, dtype=np.uint8)
    for col in range(n):
        # find pivot
        pivot = -1
        for r in range(col, n):
            if aug[r, col] != 0:
                pivot = r
                break
        if pivot < 0:
            raise ValueError("singular matrix in GF(2^8) inversion")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        # scale pivot row to 1
        inv = gf_inv(int(aug[col, col]))
        aug[col] = MUL_TABLE[inv][aug[col]]
        # eliminate other rows
        for r in range(n):
            if r != col and aug[r, col] != 0:
                aug[r] ^= MUL_TABLE[int(aug[r, col])][aug[col]]
    return aug[:, n:].copy()


def vandermonde(rows: int, cols: int) -> np.ndarray:
    """vm[r][c] = r^c in GF (ref: klauspost matrix.go vandermonde)."""
    vm = np.zeros((rows, cols), dtype=np.uint8)
    for r in range(rows):
        for c in range(cols):
            vm[r, c] = gf_exp(r, c)
    return vm


def build_matrix(data_shards: int, total_shards: int) -> np.ndarray:
    """Systematic encode matrix, identical to klauspost's buildMatrix:
    identity on top, parity generator rows below."""
    vm = vandermonde(total_shards, data_shards)
    top = vm[:data_shards]
    return mat_mul(vm, mat_inv(top))


def sub_matrix_for_survivors(
    full_matrix: np.ndarray, survivor_rows: list[int]
) -> np.ndarray:
    """Rows of the full (n x k) matrix for the given surviving shard ids."""
    return full_matrix[np.asarray(survivor_rows)]


def reconstruction_matrix(
    full_matrix: np.ndarray, survivor_rows: list[int]
) -> np.ndarray:
    """Inverse of the survivor submatrix: maps k survivor shards back to the
    k data shards. survivor_rows must have exactly k entries."""
    k = full_matrix.shape[1]
    if len(survivor_rows) != k:
        raise ValueError(f"need exactly {k} survivors, got {len(survivor_rows)}")
    return mat_inv(sub_matrix_for_survivors(full_matrix, survivor_rows))


def compose_decode_rows(
    full_matrix: np.ndarray, survivors: list[int], wanted: list[int]
) -> np.ndarray:
    """The (len(wanted) x k) matrix that maps k survivor shards DIRECTLY to
    the wanted shard ids — data rows come from the survivor inverse, parity
    rows are the parity generator composed with that inverse (exact GF
    algebra, so the output is byte-identical to reconstructing all data and
    re-encoding the parity)."""
    k = full_matrix.shape[1]
    dec = reconstruction_matrix(full_matrix, survivors)
    rows = np.empty((len(wanted), k), dtype=np.uint8)
    for r, i in enumerate(wanted):
        if i < k:
            rows[r] = dec[i]
        else:
            rows[r] = mat_mul(full_matrix[i : i + 1], dec)[0]
    return rows


class DecodeRowsCache:
    """Bounded LRU of composed decode matrices keyed by (geometry, matrix,
    survivor set, wanted rows) — shared by rebuild_ec_files and the
    degraded-read path so a steady repair workload pays the Gauss-Jordan
    inversion once per missing-shard pattern, not once per chunk/interval.
    `hits` and `misses` count lookups."""

    def __init__(self, maxsize: int = 256):
        import threading
        from collections import OrderedDict

        self.maxsize = maxsize
        self._entries: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def rows_for(
        self, full_matrix: np.ndarray, survivors: list[int], wanted: list[int]
    ) -> np.ndarray:
        # the matrix bytes are part of the key: a codec built from another
        # package's matrix (codec_from_reference) must never be served
        # rows composed from a different one of the same geometry
        key = (
            full_matrix.shape[0],
            full_matrix.shape[1],
            np.ascontiguousarray(full_matrix).tobytes(),
            tuple(survivors),
            tuple(wanted),
        )
        with self._lock:
            rows = self._entries.get(key)
            if rows is not None:
                self._entries.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
        if rows is not None:
            return rows
        rows = compose_decode_rows(full_matrix, survivors, wanted)
        with self._lock:
            self._entries[key] = rows
            self._entries.move_to_end(key)
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
        return rows

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


# process-wide instance (all geometries share it; keys carry the geometry)
DECODE_ROWS_CACHE = DecodeRowsCache()
