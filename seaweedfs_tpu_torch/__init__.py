"""seaweedfs-tpu ported to PyTorch and CUDA (NVIDIA H100).

This package stands beside the JAX package `seaweedfs_tpu`, which remains
the reference, and imports nothing of it. The slice ported so far is the
warm-storage erasure-coding path: a sealed .dat becomes .ec00-.ec13 through
RS(10,4) over GF(2^8) on a hand-written CUDA kernel, missing shards are
rebuilt, and needles are read back with shards missing.

Entry points run on the card unless the caller asks for the CPU:
`get_codec()` (backend "cuda"), `CudaRSCodec()` and
`write_ec_files(base)` with no codec raise RuntimeError when CUDA is absent.
"""
