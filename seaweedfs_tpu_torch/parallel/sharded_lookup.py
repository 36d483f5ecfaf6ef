"""Sharded bulk needle-index lookup over a device mesh.

Ported from the JAX package's parallel/sharded_lookup.py. Probe-parallel
layout: the sorted index is replicated (a volume's index fits one
device) and the probe batch is cut across EVERY place of the mesh (both
axes flattened), so P probes run as independent searches with no
communication. Each answer is the lower bound of the probe over the whole
table, as the JAX program's unbucketed search finds it.

Each distinct device gets one replica: the table packed into K1's 16-byte
rows (ops/index_kernel.py::IndexSnapshot), then a bucket table built there
by the kernel index_buckets, sized to the card's persisting L2
(ops/bucket_search.py). Each place runs the kernel bucket_search over its
slice on its own CUDA stream: its bucket's bounds from L2, then the
group of 4 rows that the probe's place in its bucket points at, one
round trip to HBM (a second only when the answer lies outside it). A
table too small or too wide in key span to bucket
(IndexSnapshot.bucketable) is searched whole by K1
(ops/csrc/index_search.cu), as before. A place on the CPU runs the plain
versions. A build or a block that fails to launch raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.bucket_search import _bucket_search_cuda, _bucket_search_torch, build_buckets, release_l2
from ..ops.index_kernel import IndexSnapshot, _bulk_lookup_torch, _index_search_cuda
from .sharded_ec import Mesh, block_stream


def replicate_index(keys: np.ndarray, offsets: np.ndarray, sizes: np.ndarray,
                    mesh: Mesh) -> dict:
    """{device: IndexSnapshot} over the sorted columns, one per distinct
    device of the mesh, each with a bucket table built on its device when
    the table is bucketable, else unbucketed."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    n = len(keys)
    kmin, kmax = (int(keys[0]), int(keys[-1])) if n else (0, 0)
    bucketed = IndexSnapshot.bucketable(n, kmin, kmax)
    replicas: dict = {}
    for dev in mesh.devices.flat:
        if dev not in replicas:
            snap = replicas[dev] = IndexSnapshot.from_columns(
                keys, offsets, sizes, None, 0, 1, 0, 0, device=dev
            )
            if bucketed:
                build_buckets(snap, kmin, kmax)
    return replicas


def _search(snap: IndexSnapshot, probes: torch.Tensor, out=None):
    """One place's search of `probes` on the snapshot's CUDA device: B over
    its bucket table, or K1 over the whole table when it has none."""
    if snap.starts is None:
        return _index_search_cuda(snap.rows, None, 0, 1, 0, probes, out=out)
    return _bucket_search_cuda(snap.rows, snap.starts, snap.kmin, snap.bstep, snap.nb,
                               probes, out=out)


def search_blocks(replicas: dict, probes: torch.Tensor, mesh: Mesh):
    """probes int64[P] (u64 bits; P a multiple of the mesh's size) on one
    device -> (offset int32[P], size int32[P], found uint8[P]) there, each
    place of the mesh searching its contiguous slice of the probes. The
    bucketed searches hold their devices' tables in persisting L2: call
    release_l2 on each such device once the results have been read."""
    n_dev = mesh.devices.size
    p = probes.shape[0]
    if p % n_dev:
        raise ValueError(f"{p} probes do not split over {n_dev} places")
    loc = p // n_dev
    home = probes.device
    out = (torch.empty(p, dtype=torch.int32, device=home),
           torch.empty(p, dtype=torch.int32, device=home),
           torch.empty(p, dtype=torch.uint8, device=home))
    src = torch.cuda.current_stream(home) if home.type == "cuda" else None
    pending = []
    for b, dev in enumerate(mesh.devices.flat):
        sl = slice(b * loc, (b + 1) * loc)
        snap = replicas[dev]
        if dev.type == "cpu":
            cols = (snap.keys, snap.offsets, snap.sizes)
            if snap.starts is None:
                res = _bulk_lookup_torch(snap.steps, *cols, probes[sl].to(dev))
            else:
                res = _bucket_search_torch(snap.bsteps, *cols, snap.starts, snap.kmin,
                                           snap.bstep, snap.nb, probes[sl].to(dev))
            off, size, found = res
            for o, r in zip(out, (off, size, found.to(torch.uint8))):
                o[sl].copy_(r)
            continue
        s = block_stream(dev, b)
        if src is not None:
            s.wait_stream(src)
        with torch.cuda.stream(s):
            if dev == home:
                _search(snap, probes[sl], out=tuple(o[sl] for o in out))
                if src is not None:
                    src.wait_stream(s)
            else:
                res = _search(snap, probes[sl].to(dev, non_blocking=True))
                pending.append((s, sl, res))
    for s, sl, res in pending:
        with torch.cuda.stream(s):
            for o, r in zip(out, res):
                o[sl].copy_(r)
        if src is not None:
            src.wait_stream(s)
    return out


def sharded_bulk_lookup(
    keys: np.ndarray,
    offsets: np.ndarray,
    sizes: np.ndarray,
    probes: np.ndarray,
    mesh: Mesh,
):
    """(sorted keys u64[M], offsets u32[M], sizes u32[M], probes u64[P])
    -> (offset_units u32[P], sizes u32[P], found bool[P]).

    Probe batches that do not divide the mesh's size are zero-padded and
    the extras stripped from the result."""
    n_dev = mesh.devices.size
    probes = np.ascontiguousarray(probes, dtype=np.uint64)
    p = len(probes)
    pad = (-p) % n_dev
    if pad:
        probes = np.concatenate([probes, np.zeros(pad, dtype=np.uint64)])
    replicas = replicate_index(keys, offsets, sizes, mesh)
    home = mesh.devices.flat[0]
    dev_probes = torch.from_numpy(probes.view(np.int64)).to(home)
    try:
        off, size, found = search_blocks(replicas, dev_probes, mesh)
        return (off.cpu().numpy().view(np.uint32)[:p],
                size.cpu().numpy().view(np.uint32)[:p],
                found.cpu().numpy().astype(bool)[:p])
    finally:
        # after the readback, which waited for every place's stream, or a
        # failure: either way the set-aside goes back to the card's L2
        for dev, snap in replicas.items():
            if dev.type == "cuda" and snap.starts is not None:
                release_l2(dev)
