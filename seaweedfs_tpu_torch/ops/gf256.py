"""GF(2^8) constant-matrix multiply over byte rows: CUDA kernel + plain torch.

Math (as in the JAX package's ops/gf256.py): multiplication by each matrix
constant unrolls into xtime (multiply-by-2) chains shared across output
rows: for input row j we compute t_k = 2^k * data[j], and each output row
XOR-accumulates the t_k selected by the bits of its matrix entry. Bytes are
packed 4 per 32-bit word and xtime runs byte-parallel inside each word:

    doubled = (x << 1) & 0xFEFEFEFE          # per-byte shift, bit0 cleared
    r       = (x >> 7) & 0x01010101          # 0x01 per overflowing byte
    xtime   = doubled ^ r * 0x1D             # ("mul" form)
            = doubled ^ r<<4 ^ r<<3 ^ r<<2 ^ r   # ("shift" form)

The same function has these implementations here:

- the kernel (csrc/gf256.cu, built by _build.py): launched for a tensor on
  a CUDA device, through _gf_matmul_cuda, which counts its launches in
  KERNEL_LAUNCHES. It computes on bit-planes: 32 bytes of a row
  transposed into 8 words, word k holding bit k of each byte, where xtime
  is three XORs (_gf_matmul_bitplanes_torch repeats its steps);
- the plain version (_gf_matmul_torch_packed): gf_matmul_expr on torch
  int32 tensors, taken only for a tensor that lies on the CPU. The tests
  run it, and chip_smoke.py holds the kernel against it on the card;
- _gf_matmul_bitplanes_torch: the kernel's arithmetic step by step in
  torch (the lane layout, the plane transpose, plane xtime, accumulate,
  the transpose back), for the CPU tests; nothing on the path calls it;
- gf_matmul_bitsliced: the JAX package's bit-sliced form (B3), the product
  as one int8 GF(2) matrix product (torch._int_mm) of the unpacked bits by
  _bitslice_matrix, then `& 1` and a repack. chip_smoke.py times it on the
  card as the yardstick of a composition of torch calls; the port's paths
  never call it.

gf_verify_count is the parity check of parallel/sharded_ec.py's
sharded_verify: the same product compared with stored parity, counting
the 32-bit words that differ. Its kernel is gf256.cu's second entry
(_gf_verify_cuda, launches in VERIFY_LAUNCHES), which keeps the
recomputed parity in registers; its plain version (_gf_verify_torch) is
the plain product, `!=` on int32 words and a sum.

Torch's int32 `>>` is arithmetic and uint32 shifts are not implemented on
the CPU, so packed words are viewed as int32 and every right shift is
masked: 0x80808080 >> 7 gives 0xff010101 before the 0x01010101 mask.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import numpy as np
import torch

_MASK_LOW7 = 0xFEFEFEFE - (1 << 32)  # as int32
_MASK_ONES = 0x01010101
_POLY = 0x1D

# launches of the CUDA kernel since the process started (or the caller
# last reset it); the plain version never touches it
KERNEL_LAUNCHES = 0
VERIFY_LAUNCHES = 0  # the same for the gf_verify kernel
_LAUNCH_LOCK = threading.Lock()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. Raises when CUDA was asked for (or defaulted to) and is
    absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the plain "
            "PyTorch version"
        )
    return dev


def _xtime(x: torch.Tensor, mode: Optional[str] = None) -> torch.Tensor:
    """Byte-parallel multiply-by-2 in GF(2^8) on packed int32 words."""
    doubled = (x << 1) & _MASK_LOW7
    r = (x >> 7) & _MASK_ONES
    if (mode or "mul") == "mul":
        return doubled ^ (r * _POLY)
    return doubled ^ (r << 4) ^ (r << 3) ^ (r << 2) ^ r


def gf_matmul_expr(
    matrix: np.ndarray, rows: list, xtime_mode: Optional[str] = None
) -> list:
    """out[i] = XOR_j matrix[i,j] * rows[j] in GF(2^8), on packed int32.

    matrix is a numpy uint8 [R, C]; rows is a list of C equal-shaped packed
    int32 tensors. Returns R tensors. Work is shared: one xtime chain per
    input row, reused by every output."""
    r_cnt, c_cnt = matrix.shape
    if len(rows) != c_cnt:
        raise ValueError(f"{len(rows)} rows for a matrix of {c_cnt} columns")
    acc: list = [None] * r_cnt
    for j in range(c_cnt):
        col = [int(matrix[i, j]) for i in range(r_cnt)]
        max_bits = max((c.bit_length() for c in col), default=0)
        if max_bits == 0:
            continue
        t = rows[j]
        for k in range(max_bits):
            for i in range(r_cnt):
                if (col[i] >> k) & 1:
                    acc[i] = t if acc[i] is None else acc[i] ^ t
            if k + 1 < max_bits:
                t = _xtime(t, xtime_mode)
    zero = torch.zeros_like(rows[0])
    return [a if a is not None else zero for a in acc]


def count_expr_ops(matrix: np.ndarray, xtime_mode: Optional[str] = None) -> int:
    """Static i32-op count of gf_matmul_expr per packed input WORD COLUMN
    (i.e. per 4 bytes of every input row together): the operation count
    of the kernel's bound."""
    per_xtime = 6 if (xtime_mode or "mul") == "mul" else 11
    matrix = np.asarray(matrix, dtype=np.uint8)
    r_cnt, c_cnt = matrix.shape
    ops = 0
    # acc is shared across COLUMNS: only each row's very first
    # contribution overall is free, not its first per column
    first = [True] * r_cnt
    for j in range(c_cnt):
        col = [int(matrix[i, j]) for i in range(r_cnt)]
        max_bits = max((c.bit_length() for c in col), default=0)
        if max_bits == 0:
            continue
        ops += (max_bits - 1) * per_xtime  # the shared chain
        for k in range(max_bits):
            for i in range(r_cnt):
                if (col[i] >> k) & 1:
                    if not first[i]:
                        ops += 1  # XOR-accumulate
                    first[i] = False
    return ops


def _gf_matmul_torch_packed(
    matrix: np.ndarray, packed_int32: torch.Tensor, xtime_mode: Optional[str] = None
) -> torch.Tensor:
    """The plain version: int32[C, W] -> int32[R, W] with torch ops."""
    matrix = np.asarray(matrix, dtype=np.uint8)
    rows = [packed_int32[j] for j in range(matrix.shape[1])]
    return torch.stack(gf_matmul_expr(matrix, rows, xtime_mode))


# --- the kernel's arithmetic, step by step (bit-planes) ---
# the kernel's layout: each lane of a warp holds two 4-word pieces of a row,
# at words 4 * lane and 128 + 4 * lane of its warp's 256-word tile
_TILE_WORDS = 256
# (shift, mask) of the three delta-swap stages, which pair word i with word
# i + shift; every mask clears the top `shift` bits, so the sign bits of
# int32 `>>` drop out
_SWAP_STAGES = ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F))


def _transpose8(x: torch.Tensor) -> torch.Tensor:
    """The kernel's transpose8 on the last dimension (8 int32 words): word
    k of the result holds bit k of every byte, bit 8b + w of it bit k of
    byte b of word w. Its own inverse."""
    x = x.clone()
    for s, m in _SWAP_STAGES:
        lo = [i for i in range(8) if not i & s]
        hi = [i + s for i in lo]
        a, b = x[..., lo], x[..., hi]
        t = ((a >> s) ^ b) & m
        x[..., lo] = a ^ (t << s)
        x[..., hi] = b ^ t
    return x


def _plane_xtime(t: torch.Tensor) -> torch.Tensor:
    """Multiply by 2 on 8 planes (last dimension): plane k becomes plane
    k + 1, and the old plane 7 becomes plane 0 and is XORed into planes 2,
    3 and 4 (0x1D)."""
    hi = t[..., 7]
    return torch.stack([hi, t[..., 0], t[..., 1] ^ hi, t[..., 2] ^ hi,
                        t[..., 3] ^ hi, t[..., 4], t[..., 5], t[..., 6]], dim=-1)


def _gf_matmul_bitplanes_torch(matrix: np.ndarray, packed_int32: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in torch: int32[C, W] -> int32[R, W].

    As in csrc/gf256.cu: each lane of a warp takes two 4-word pieces 128
    words apart in its warp's 256-word tile (zeros past the width), the 8
    words go into planes, t_k = 2^k * row by plane xtime, each output row
    XORs in the t_k its coefficient's bits select, and the planes go back
    to words and to their places."""
    matrix = np.asarray(matrix, dtype=np.uint8)
    r_cnt, c_cnt = matrix.shape
    w = packed_int32.shape[1]
    tiles = -(-w // _TILE_WORDS)
    x = torch.zeros((c_cnt, tiles * _TILE_WORDS), dtype=torch.int32,
                    device=packed_int32.device)
    x[:, :w] = packed_int32
    # [C, tile, piece, lane, word] -> [C, tile, lane, piece * 4 + word]
    lanes = x.view(c_cnt, tiles, 2, 32, 4).permute(0, 1, 3, 2, 4)
    planes = _transpose8(lanes.reshape(c_cnt, tiles, 32, 8))
    acc = torch.zeros((r_cnt, tiles, 32, 8), dtype=torch.int32, device=x.device)
    for c in range(c_cnt):
        t = planes[c]
        for k in range(8):
            for r in range(r_cnt):
                if (int(matrix[r, c]) >> k) & 1:
                    acc[r] ^= t
            t = _plane_xtime(t)
    out = _transpose8(acc).view(r_cnt, tiles, 32, 2, 4).permute(0, 1, 3, 2, 4)
    return out.reshape(r_cnt, tiles * _TILE_WORDS)[:, :w]


# --- B3: the bit-sliced form, an int8 GF(2) matrix product ---
@functools.lru_cache(maxsize=None)
def _bitslice_matrix(matrix_key) -> np.ndarray:
    """B[C*8, R*8] over GF(2): column block r, bit b gets the b-th bit of
    matrix[r, c] * 2^k for input bit k of input byte c."""
    from ..storage.erasure_coding.galois import MUL_TABLE

    matrix = np.asarray(matrix_key, dtype=np.uint8)
    r_cnt, c_cnt = matrix.shape
    b = np.zeros((c_cnt * 8, r_cnt * 8), dtype=np.int8)
    for c in range(c_cnt):
        for k in range(8):
            for r in range(r_cnt):
                prod = int(MUL_TABLE[matrix[r, c], 1 << k])
                for bit in range(8):
                    b[c * 8 + k, r * 8 + bit] = (prod >> bit) & 1
    return b


# torch._int_mm on CUDA takes more than 16 rows of its first operand
_INT_MM_MIN_ROWS = 17


def gf_matmul_bitsliced(matrix: np.ndarray, packed, device=None):
    """The bit-sliced route: words [C, W] -> [R, W], byte-identical to
    gf_matmul_packed. The bytes unpack to bits int8[N, C*8], multiply
    _bitslice_matrix with int32 sums (torch._int_mm), and the sums' low
    bits repack into bytes and words. A torch tensor (int32 or uint32)
    computes on its own device and keeps its dtype; numpy input (uint32
    words) goes to `device` (the card unless the caller asks for the CPU)
    and comes back as numpy uint32."""
    matrix = np.asarray(matrix, dtype=np.uint8)
    if isinstance(packed, np.ndarray):
        dev = resolve_device(device)
        words = np.ascontiguousarray(packed, dtype=np.uint32).view(np.int32)
        res = gf_matmul_bitsliced(matrix, torch.from_numpy(words.copy()).to(dev))
        return res.cpu().numpy().view(np.uint32)
    r_cnt, c_cnt = matrix.shape
    if packed.dim() != 2 or packed.shape[0] != c_cnt:
        raise ValueError(f"shape {tuple(packed.shape)} vs matrix {matrix.shape}")
    dev = packed.device
    key = tuple(map(tuple, matrix))
    # column-major: cuBLASLt's int8 product takes its second operand so
    bmat = torch.from_numpy(_bitslice_matrix(key)).to(dev).t().contiguous().t()
    w = packed.shape[1]
    n = w * 4
    data = packed.contiguous().view(torch.uint8).reshape(c_cnt, n)
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    bits = ((data.t()[:, :, None] >> shifts) & 1).to(torch.int8).reshape(n, c_cnt * 8)
    if n < _INT_MM_MIN_ROWS:
        bits = torch.cat([bits, bits.new_zeros((_INT_MM_MIN_ROWS - n, c_cnt * 8))])
    sums = torch._int_mm(bits, bmat)[:n]
    out_bits = (sums & 1).to(torch.uint8).view(n, r_cnt, 8)
    out_bytes = (out_bits << shifts).sum(dim=2, dtype=torch.uint8)
    return out_bytes.t().contiguous().view(packed.dtype)


# --- the CUDA kernel ---
_LIB = None
_LIMITS: tuple = ()
_LIB_LOCK = threading.Lock()


def _kernel_lib():
    global _LIB, _LIMITS
    with _LIB_LOCK:
        if _LIB is None:
            from ._build import load_library

            lib = load_library("gf256")
            lib.gf256_matmul.restype = ctypes.c_int
            lib.gf256_matmul.argtypes = [
                ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_char_p, ctypes.c_void_p,
            ]
            lib.gf256_verify.restype = ctypes.c_int
            lib.gf256_verify.argtypes = [
                ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            for fn in ("gf256_max_rows", "gf256_max_cols",
                       "gf256_rows_per_launch"):
                getattr(lib, fn).restype = ctypes.c_int
                getattr(lib, fn).argtypes = []
            _LIMITS = (
                lib.gf256_max_rows(), lib.gf256_max_cols(),
                lib.gf256_rows_per_launch(),
            )
            _LIB = lib
        return _LIB


def kernel_limits() -> tuple[int, int, int]:
    """(max rows, max columns, rows per launch) the built kernel takes."""
    _kernel_lib()
    return _LIMITS


def _gf_matmul_cuda(
    matrix: np.ndarray, packed: torch.Tensor, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Launch the kernel: int32/uint32[C, W] on a CUDA device -> [R, W].

    `packed` and `out` may be row-strided views (unit stride inside a row);
    when both start 16-byte aligned with pitches a multiple of 4 words the
    kernel moves whole uint4 columns. A fresh `out` gets such a pitch. The
    launch goes on the current stream and is not synchronised."""
    global KERNEL_LAUNCHES
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    if packed.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {packed.device}")
    if packed.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"packed words must be int32/uint32, got {packed.dtype}")
    r_cnt, c_cnt = matrix.shape
    max_rows, max_cols, per_launch = kernel_limits()
    if not (1 <= r_cnt <= max_rows and 1 <= c_cnt <= max_cols):
        raise ValueError(
            f"matrix {r_cnt}x{c_cnt} exceeds the kernel's "
            f"{max_rows}x{max_cols}"
        )
    if packed.dim() != 2 or packed.shape[0] != c_cnt or packed.stride(1) != 1:
        raise ValueError(
            f"packed must be [C={c_cnt}, W] with unit stride inside a row, "
            f"got shape {tuple(packed.shape)} strides {packed.stride()}"
        )
    w = packed.shape[1]
    if out is None:
        pitch = max(4, (w + 3) // 4 * 4)
        out = torch.empty(
            (r_cnt, pitch), dtype=packed.dtype, device=packed.device
        )[:, :w]
    elif (
        out.shape != (r_cnt, w) or out.stride(1) != 1
        or out.dtype != packed.dtype or out.device != packed.device
    ):
        raise ValueError(
            f"out must be [{r_cnt}, {w}] {packed.dtype} on {packed.device} "
            "with unit stride inside a row"
        )
    if w == 0:
        return out
    lib = _kernel_lib()
    # a single row's pitch is never stepped over: report a whole-uint4 one
    lone = (w + 3) // 4 * 4
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        rc = lib.gf256_matmul(
            packed.data_ptr(), packed.stride(0) if c_cnt > 1 else lone,
            out.data_ptr(), out.stride(0) if r_cnt > 1 else lone,
            w, r_cnt, c_cnt, matrix.tobytes(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"gf256 kernel launch failed: CUDA error {rc}")
    with _LAUNCH_LOCK:
        KERNEL_LAUNCHES += -(-r_cnt // per_launch)
    return out


def _gf_verify_torch(
    matrix: np.ndarray, data: torch.Tensor, parity: torch.Tensor
) -> torch.Tensor:
    """The plain version of gf_verify: int32[C, W] data, int32[R, W]
    stored parity -> the int64 count of words where the recomputed
    parity differs."""
    recomputed = _gf_matmul_torch_packed(matrix, data)
    return (recomputed != parity).sum(dtype=torch.int64)


def _check_rows(name: str, t: torch.Tensor, rows: int) -> None:
    if t.dim() != 2 or t.shape[0] != rows or t.stride(1) != 1:
        raise ValueError(
            f"{name} must be [{rows}, W] with unit stride inside a row, got "
            f"shape {tuple(t.shape)} strides {t.stride()}"
        )


def _gf_verify_cuda(
    matrix: np.ndarray,
    data: torch.Tensor,
    parity: torch.Tensor,
    count: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the gf_verify kernel on the current stream: int32/uint32
    data [C, W] and stored parity [R, W] on one CUDA device (row-strided
    views with unit stride inside a row) -> a 0-dim int64 count of the
    differing words, on the device. With `count` (an int64 [1] tensor on
    the device) the kernel adds into it, and the result is a view of it.
    Not synchronised."""
    global VERIFY_LAUNCHES
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {dev}")
    if data.dtype not in (torch.int32, torch.uint32) or parity.dtype != data.dtype:
        raise TypeError(f"words must be int32/uint32, got {data.dtype}, {parity.dtype}")
    if parity.device != dev:
        raise ValueError(f"parity on {parity.device}, data on {dev}")
    r_cnt, c_cnt = matrix.shape
    max_rows, max_cols, per_launch = kernel_limits()
    if not (1 <= r_cnt <= max_rows and 1 <= c_cnt <= max_cols):
        raise ValueError(
            f"matrix {r_cnt}x{c_cnt} exceeds the kernel's {max_rows}x{max_cols}"
        )
    _check_rows("data", data, c_cnt)
    _check_rows("parity", parity, r_cnt)
    w = data.shape[1]
    if parity.shape[1] != w:
        raise ValueError(f"parity width {parity.shape[1]} != data width {w}")
    if count is None:
        count = torch.zeros(1, dtype=torch.int64, device=dev)
    elif count.device != dev or count.dtype != torch.int64 or count.numel() != 1:
        raise ValueError("count must be one int64 on the data's device")
    if w == 0:
        return count.view(())
    lib = _kernel_lib()
    lone = (w + 3) // 4 * 4
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gf256_verify(
            data.data_ptr(), data.stride(0) if c_cnt > 1 else lone,
            parity.data_ptr(), parity.stride(0) if r_cnt > 1 else lone,
            w, r_cnt, c_cnt, matrix.tobytes(), count.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"gf_verify kernel launch failed: CUDA error {rc}")
    with _LAUNCH_LOCK:
        VERIFY_LAUNCHES += -(-r_cnt // per_launch)
    return count.view(())


def gf_verify_count(matrix: np.ndarray, data, parity, device=None):
    """Words of `parity` [R, W] that differ from matrix (x) data [C, W]
    over GF(2^8), both packed 4 bytes a word.

    CUDA tensors launch the kernel (or raise) and give a 0-dim int64
    tensor on the card; CPU tensors run the plain version. Numpy input
    (uint32 words) goes to `device` (the card unless the caller asks for
    the CPU) and gives a Python int."""
    matrix = np.asarray(matrix, dtype=np.uint8)
    if isinstance(data, np.ndarray):
        dev = resolve_device(device)
        ts = [
            torch.from_numpy(
                np.ascontiguousarray(a, dtype=np.uint32).view(np.int32).copy()
            ).to(dev)
            for a in (data, parity)
        ]
        return int(gf_verify_count(matrix, *ts))
    if data.device.type == "cuda":
        return _gf_verify_cuda(matrix, data, parity)
    if data.device.type != "cpu":
        raise ValueError(f"unsupported device {data.device}")
    as_int = [
        t.view(torch.int32) if t.dtype == torch.uint32 else t for t in (data, parity)
    ]
    return _gf_verify_torch(matrix, *as_int)


# --- host packing ---
def pack_bytes_host(data: np.ndarray, granule: int = 4) -> np.ndarray:
    """Host-side free packing: numpy uint8[C, n] -> uint32[C, padded_n/4]."""
    c, n = data.shape
    padded_n = ((n + granule - 1) // granule) * granule
    if padded_n != n:
        padded = np.zeros((c, padded_n), dtype=np.uint8)
        padded[:, :n] = data
        data = padded
    return np.ascontiguousarray(data).view(np.uint32)


def unpack_bytes_host(packed: np.ndarray, n: int) -> np.ndarray:
    """Host-side free unpacking: uint32[R, m] -> uint8[R, n]."""
    return np.ascontiguousarray(packed).view(np.uint8)[:, :n]


# --- public entry points ---
def gf_matmul_packed(
    matrix: np.ndarray,
    packed,
    xtime_mode: Optional[str] = None,
    device=None,
):
    """GF(2^8) matmul on packed words: [C, W] -> [R, W].

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version. Numpy input (uint32 words) goes to `device` (the card
    unless the caller asks for the CPU) and comes back as numpy uint32.
    xtime_mode picks the plain version's xtime form; the kernel computes
    the same bytes with the `mul` form."""
    matrix = np.asarray(matrix, dtype=np.uint8)
    if isinstance(packed, np.ndarray):
        dev = resolve_device(device)
        words = np.ascontiguousarray(packed, dtype=np.uint32).view(np.int32)
        t = torch.from_numpy(words.copy() if not words.flags.writeable else words)
        res = gf_matmul_packed(matrix, t.to(dev), xtime_mode)
        return res.cpu().numpy().view(np.uint32)
    if packed.shape[0] != matrix.shape[1]:
        raise ValueError(f"shape {tuple(packed.shape)} vs matrix {matrix.shape}")
    if packed.device.type == "cuda":
        return _gf_matmul_cuda(matrix, packed)
    if packed.device.type != "cpu":
        raise ValueError(f"unsupported device {packed.device}")
    as_int = packed.view(torch.int32) if packed.dtype == torch.uint32 else packed
    out = _gf_matmul_torch_packed(matrix, as_int, xtime_mode)
    return out.view(torch.uint32) if packed.dtype == torch.uint32 else out


def gf_matmul_bytes(
    matrix: np.ndarray,
    data,
    xtime_mode: Optional[str] = None,
    device=None,
) -> np.ndarray:
    """GF(2^8) matmul over flat byte rows: uint8[C, N] -> uint8[R, N].

    Zero padding to a whole word is exact (zero bytes yield zero output
    columns, truncated on return). Host numpy input is packed with a free
    view and runs on `device` (the card unless the caller asks for the
    CPU); the result comes back as numpy."""
    matrix = np.asarray(matrix, dtype=np.uint8)
    data = np.asarray(data, dtype=np.uint8)
    if data.ndim != 2 or data.shape[0] != matrix.shape[1]:
        raise ValueError(f"shape {data.shape} vs matrix {matrix.shape}")
    n = data.shape[1]
    packed = pack_bytes_host(data)
    out = gf_matmul_packed(matrix, packed, xtime_mode, device=device)
    return unpack_bytes_host(out, n)
