"""Sharded bulk needle-index lookup over a device mesh.

Ported from the JAX package's parallel/sharded_lookup.py. Probe-parallel
layout: the sorted index is replicated (a volume's index fits one
device) and the probe batch is cut across EVERY place of the mesh (both
axes flattened), so P probes run as independent searches with no
communication. Each place runs the hand-written kernel
K1 (ops/csrc/index_search.cu) over its slice, unbucketed as the JAX
program searches (`_bulk_lookup`'s whole-table range), on its own CUDA
stream; the table is packed once per distinct device into K1's 16-byte
rows (ops/index_kernel.py::IndexSnapshot). A place on the CPU runs K1's
plain version. A block that fails to launch raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.index_kernel import IndexSnapshot, _bulk_lookup_torch, _index_search_cuda
from .sharded_ec import Mesh, block_stream


def replicate_index(keys: np.ndarray, offsets: np.ndarray, sizes: np.ndarray,
                    mesh: Mesh) -> dict:
    """{device: unbucketed IndexSnapshot} over the sorted columns, one per
    distinct device of the mesh."""
    replicas: dict = {}
    for dev in mesh.devices.flat:
        if dev not in replicas:
            replicas[dev] = IndexSnapshot.from_columns(
                keys, offsets, sizes, None, 0, 1, 0, 0, device=dev
            )
    return replicas


def search_blocks(replicas: dict, probes: torch.Tensor, mesh: Mesh):
    """probes int64[P] (u64 bits; P a multiple of the mesh's size) on one
    device -> (offset int32[P], size int32[P], found uint8[P]) there, each
    place of the mesh searching its contiguous slice of the probes."""
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
            off, size, found = _bulk_lookup_torch(
                snap.steps, snap.keys, snap.offsets, snap.sizes, probes[sl].to(dev))
            for o, r in zip(out, (off, size, found.to(torch.uint8))):
                o[sl].copy_(r)
            continue
        s = block_stream(dev, b)
        if src is not None:
            s.wait_stream(src)
        with torch.cuda.stream(s):
            if dev == home:
                _index_search_cuda(snap.rows, None, 0, 1, 0, probes[sl],
                                   out=tuple(o[sl] for o in out))
                if src is not None:
                    src.wait_stream(s)
            else:
                res = _index_search_cuda(snap.rows, None, 0, 1, 0,
                                         probes[sl].to(dev, non_blocking=True))
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
    off, size, found = search_blocks(replicas, dev_probes, mesh)
    return (off.cpu().numpy().view(np.uint32)[:p],
            size.cpu().numpy().view(np.uint32)[:p],
            found.cpu().numpy().astype(bool)[:p])
