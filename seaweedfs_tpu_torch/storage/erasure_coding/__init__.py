"""Reed-Solomon erasure coding — RS(10,4) over a two-level block layout.

Geometry and file formats match the reference (ref: weed/storage/
erasure_coding/ec_encoder.go:17-23): 10 data + 4 parity shards, 1GB large
blocks striped row-major until <10GB remains, then 1MB small blocks; shard
files .ec00-.ec13, sorted index .ecx.

The GF(2^8) arithmetic (galois.py) reproduces klauspost/reedsolomon's
Vandermonde-derived systematic matrix so shards are byte-identical to ones
produced by the reference. The compute path is pluggable: the hand-written
CUDA kernel (ops/rs_kernel.py, CudaRSCodec) or numpy on the host
(coder_cpu.py) behind the same codec interface.
"""

DATA_SHARDS_COUNT = 10
PARITY_SHARDS_COUNT = 4
TOTAL_SHARDS_COUNT = DATA_SHARDS_COUNT + PARITY_SHARDS_COUNT
EC_LARGE_BLOCK_SIZE = 1024 * 1024 * 1024  # 1GB
EC_SMALL_BLOCK_SIZE = 1024 * 1024  # 1MB


def to_ext(ec_index: int) -> str:
    return f".ec{ec_index:02d}"


from .locate import Interval, locate_data  # noqa: E402
from .coder_cpu import CpuRSCodec  # noqa: E402
from .encoder import (  # noqa: E402
    find_dat_file_size,
    rebuild_ec_files,
    rebuild_ec_files_multi,
    write_dat_file,
    write_ec_files,
    write_ec_files_multi,
    write_idx_file_from_ec_index,
    write_sorted_file_from_idx,
)
from .ec_volume import (  # noqa: E402
    EcVolume,
    EcVolumeShard,
    NeedleNotFound,
    search_needle_from_sorted_index,
)

__all__ = [
    "DATA_SHARDS_COUNT",
    "PARITY_SHARDS_COUNT",
    "TOTAL_SHARDS_COUNT",
    "EC_LARGE_BLOCK_SIZE",
    "EC_SMALL_BLOCK_SIZE",
    "to_ext",
    "Interval",
    "locate_data",
    "CpuRSCodec",
    "write_ec_files",
    "write_ec_files_multi",
    "rebuild_ec_files",
    "rebuild_ec_files_multi",
    "write_sorted_file_from_idx",
    "write_dat_file",
    "write_idx_file_from_ec_index",
    "find_dat_file_size",
    "EcVolume",
    "EcVolumeShard",
    "NeedleNotFound",
    "search_needle_from_sorted_index",
]
