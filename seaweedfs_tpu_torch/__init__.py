"""seaweedfs-tpu ported to PyTorch and CUDA (NVIDIA H100).

This package stands beside the JAX package `seaweedfs_tpu`, which remains
the reference, and imports nothing of it. Ported so far: warm-storage
erasure coding (a sealed .dat becomes .ec00-.ec13 through RS(10,4) over
GF(2^8) on a hand-written CUDA kernel; missing shards are rebuilt and
needles read back with shards missing), the needle-index lookup on two
hand-written search kernels over every needle-map kind (memory, lsm,
sqlite "leveldb", sorted), the volume server, the master with the
cluster's EC path, the EC round trip and mesh plane, the vacuum plane,
and the volume tier under the filer (batched chunk writes through the
group-commit worker, the BatchRead stream, chunked files, count=N assign
leases and the replica read fan-out with per-peer circuit breakers),
and the filer with its scale-out (the prefix-sharded store, a fleet of
range-owning filer processes, read replicas that follow the meta-log,
the peer aggregator), its path lookups on the card through the meta gate,
and the fault plane with the self-healing loop (seeded fault injection at
the disk, RPC and HTTP seams; the scrub, whose EC parity check runs on
the GF(2^8) kernel; the master's repair scheduler: shard rebuilds,
replica re-copies and tail syncs)
(`python -m seaweedfs_tpu_torch master|server|volume|filer|shell|
benchmark|upload|download|compact`).

Entry points run on the card unless the caller asks for the CPU:
`get_codec()` (backend "cuda"), `CudaRSCodec()`,
`write_ec_files(base)` with no codec, and the servers' default
`-storageBackend cuda` raise RuntimeError when CUDA is absent.
"""
