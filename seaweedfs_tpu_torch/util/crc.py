"""Masked CRC32-Castagnoli needle checksum.

The reference computes CRC32C over the needle data and stores a *masked* value:
``value = rotr15(crc) + 0xa282ead8 (mod 2^32)``
(ref: weed/storage/needle/crc.go:12-25 — klauspost/crc32 Castagnoli table,
Value() = (c>>15 | c<<17) + 0xa282ead8).

Uses the C-accelerated google-crc32c when present. Without it, the port's
own host library (ops/csrc/host_crc32c.cu, slicing-by-8, built by nvcc on
first use like the kernels' libraries) computes it; where that cannot be
built (no nvcc), short inputs take a pure-Python table loop and long ones
a lane-parallel numpy form of the same table CRC (see _crc32c_lanes), so
reading back megabyte needles stays in milliseconds. `route()` says which
of the three this process uses.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_POLY = 0x82F63B78  # reversed Castagnoli
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)
_TABLE_NP = np.array(_TABLE, dtype=np.uint32)

_LANE = 256  # bytes each numpy lane walks; lanes are combined pairwise
_LANES_MIN_BYTES = 16 * 1024  # below this the Python loop is cheaper


def _crc32c_loop(data, init: int = 0) -> int:
    c = init ^ 0xFFFFFFFF
    for b in bytes(data):
        c = _TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


# --- lane-parallel form ---
# The register update r' = T[(r ^ b) & 0xFF] ^ (r >> 8) is linear over GF(2)
# in (r, b) jointly, so crc_reg(A || B, r0) = Z_|B|(crc_reg(A, r0)) ^
# crc_reg(B, 0), where Z_n is the 32x32 bit matrix "feed n zero bytes".
# The data (front-padded with zeros, which leave a zero register at zero)
# splits into 2^L lanes of _LANE bytes walked together by numpy, then a
# pairwise tree folds the lane registers with Z_{_LANE * 2^level}. The
# initial register enters as Z_len(init) at the end.

_ZPOW: list = []  # _ZPOW[i]: byte tables of Z_{2^i}, built on first use
_ZPOW_LOCK = threading.Lock()


def _zero_byte_images() -> np.ndarray:
    """Columns of Z_1: the register after one zero byte, per input bit."""
    regs = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32))
    return _TABLE_NP[regs & 0xFF] ^ (regs >> np.uint32(8))


def _apply_cols(cols: np.ndarray, regs: np.ndarray) -> np.ndarray:
    """Apply the bit matrix with column images `cols` to every register."""
    out = np.zeros_like(regs)
    for b in range(32):
        out ^= cols[b] * ((regs >> np.uint32(b)) & np.uint32(1))
    return out


def _byte_tables(cols: np.ndarray) -> np.ndarray:
    """(4, 256) tables so that Z(r) = XOR_k T[k][(r >> 8k) & 0xFF]."""
    x = np.arange(256, dtype=np.uint32)
    tabs = np.zeros((4, 256), dtype=np.uint32)
    for k in range(4):
        for j in range(8):
            tabs[k] ^= cols[8 * k + j] * ((x >> np.uint32(j)) & np.uint32(1))
    return tabs


def _zpow(i: int) -> np.ndarray:
    with _ZPOW_LOCK:
        if not _ZPOW:
            cols = _zero_byte_images()
            _ZPOW.append((cols, _byte_tables(cols)))
        while len(_ZPOW) <= i:
            cols = _ZPOW[-1][0]
            sq = _apply_cols(cols, cols.copy())  # Z_{2s} = Z_s . Z_s
            _ZPOW.append((sq, _byte_tables(sq)))
        return _ZPOW[i][1]


def _apply_tables(tabs: np.ndarray, regs: np.ndarray) -> np.ndarray:
    return (
        tabs[0][regs & 0xFF]
        ^ tabs[1][(regs >> np.uint32(8)) & 0xFF]
        ^ tabs[2][(regs >> np.uint32(16)) & 0xFF]
        ^ tabs[3][regs >> np.uint32(24)]
    )


def _crc32c_lanes(data, init: int = 0) -> int:
    buf = np.frombuffer(data, dtype=np.uint8)
    n = buf.size
    lanes = 1 << max(0, (-(-n // _LANE) - 1).bit_length())
    padded = np.zeros(lanes * _LANE, dtype=np.uint8)
    padded[lanes * _LANE - n:] = buf
    cols = padded.reshape(lanes, _LANE).T.copy()  # (LANE, lanes)
    regs = np.zeros(lanes, dtype=np.uint32)
    for j in range(_LANE):
        regs = _TABLE_NP[(regs ^ cols[j]) & 0xFF] ^ (regs >> np.uint32(8))
    level = _LANE.bit_length() - 1  # each lane is 2^level bytes long
    while regs.size > 1:
        regs = _apply_tables(_zpow(level), regs[0::2]) ^ regs[1::2]
        level += 1
    reg = int(regs[0])
    start = np.array([init ^ 0xFFFFFFFF], dtype=np.uint32)
    for i in range(n.bit_length()):
        if (n >> i) & 1:
            start = _apply_tables(_zpow(i), start)
    return (reg ^ int(start[0])) ^ 0xFFFFFFFF


def _crc32c_python(data, init: int = 0) -> int:
    if len(data) < _LANES_MIN_BYTES:
        return _crc32c_loop(data, init)
    return _crc32c_lanes(data, init)


_NATIVE = None  # crc32c_extend once loaded; False where it cannot be built
_NATIVE_LOCK = threading.Lock()


def _native():
    """The host library's crc32c_extend, built on first use; False when
    it cannot be built here (no nvcc), which leaves the Python forms."""
    global _NATIVE
    with _NATIVE_LOCK:
        if _NATIVE is None:
            try:
                from ..ops import _build

                fn = _build.load_library("host_crc32c").crc32c_extend
                fn.restype = ctypes.c_uint32
                fn.argtypes = [ctypes.c_uint32, ctypes.c_void_p, ctypes.c_size_t]
                _NATIVE = fn
            except Exception:
                _NATIVE = False
        return _NATIVE


try:
    import google_crc32c as _gcrc

    def crc32c(data, init: int = 0) -> int:
        if type(data) is not bytes:
            # google-crc32c's C binding accepts only bytes and objects
            # exposing __array_interface__; a numpy view keeps memoryviews
            # zero-copy
            data = np.frombuffer(data, np.uint8)
        return _gcrc.extend(init, data)

    def route() -> str:
        return "google_crc32c"

except ImportError:

    def crc32c(data, init: int = 0) -> int:
        fn = _NATIVE if _NATIVE is not None else _native()
        if not fn:
            return _crc32c_python(data, init)
        if type(data) is bytes:
            return fn(init, data, len(data))
        view = np.frombuffer(data, np.uint8)  # zero-copy for any buffer
        return fn(init, view.ctypes.data, view.size)

    def route() -> str:
        return "native" if (_NATIVE if _NATIVE is not None else _native()) else "python"


class CRC:
    """Incremental CRC mirroring the reference's needle.CRC type."""

    __slots__ = ("raw",)

    def __init__(self, raw: int = 0):
        self.raw = raw & 0xFFFFFFFF

    def update(self, data: bytes) -> "CRC":
        return CRC(crc32c(data, self.raw))

    def value(self) -> int:
        """Masked checksum as stored on disk (ref: crc.go:23-25)."""
        c = self.raw
        return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def new_crc(data: bytes) -> CRC:
    return CRC(0).update(data)


def masked_crc(data: bytes) -> int:
    return new_crc(data).value()
