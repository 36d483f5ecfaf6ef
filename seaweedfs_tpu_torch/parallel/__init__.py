"""Multi-device parallelism for the EC compute plane.

Ported from the JAX package's parallel/: volumes are the batch dimension
(the mesh's "vol" axis), the byte stream inside a stripe is the sequence
dimension ("blk"). The JAX package rides `jax.sharding.Mesh` and
`shard_map`; here a `Mesh` is a 2-D grid of torch devices, and each
(vol, blk) block runs on its device, on its own CUDA stream, through the
hand-written kernels: gf_matmul (B1) for encode and reconstruct, gf_verify
for the parity check, index_buckets and bucket_search for the sharded
lookup (index_search, K1, for a table too small or too wide in key span to
bucket). Encode and reconstruct need no communication; verify's `psum`
becomes a sum of the per-block counts.
"""

from .sharded_ec import (
    Mesh,
    make_mesh,
    sharded_encode,
    sharded_reconstruct_padded,
    sharded_reconstruct_step,
    sharded_verify,
)
from .sharded_lookup import sharded_bulk_lookup

__all__ = [
    "Mesh",
    "make_mesh",
    "sharded_encode",
    "sharded_verify",
    "sharded_reconstruct_step",
    "sharded_reconstruct_padded",
    "sharded_bulk_lookup",
]
