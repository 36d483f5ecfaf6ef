"""Sharded erasure coding over a (vol, blk) grid of devices.

Ported from the JAX package's parallel/sharded_ec.py. Mesh axes:

- "vol": data parallel over volumes (the batch of stripes);
- "blk": sequence parallel over the byte stream inside each stripe.

Encode and reconstruct are byte-local, so both axes shard without
communication. Where the JAX package runs a `shard_map` body per block,
here each block (a slice of volumes, a slice of bytes) runs on its device,
on its own CUDA stream, through the hand-written kernels: gf_matmul
(ops/csrc/gf256.cu, B1) for encode and reconstruct, gf_verify (the same
file's second entry) for verify, whose `psum` over both axes becomes a sum
of the per-block counts. A block on the CPU runs the kernels' plain
versions (the tests' mesh of repeated CPU devices). A block that fails to
launch raises; nothing falls back to another device or to the host.

Inputs are numpy arrays (results come back as numpy) or uint8 torch
tensors (results on the input's device). A block whose device holds the
input reads it in place and writes its answer in place; a block on
another device gets a copy.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from ..ops.gf256 import _gf_matmul_cuda, _gf_verify_cuda, gf_matmul_packed, gf_verify_count


class Mesh:
    """A 2-D ("vol", "blk") grid of torch devices: `devices` is a numpy
    object array of shape (vol, blk), `shape` maps each axis name to its
    size (as `jax.sharding.Mesh.shape` does). One device may fill several
    places: a single card split into blocks."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh is a non-empty 2-D grid, got {devices.shape}")
        self.devices = devices
        self.shape = {"vol": devices.shape[0], "blk": devices.shape[1]}

    def __repr__(self) -> str:
        return f"Mesh(vol={self.shape['vol']}, blk={self.shape['blk']}, " \
               f"devices={[str(d) for d in self.devices.flat]})"


def make_mesh(
    n_devices: Optional[int] = None,
    vol_axis: Optional[int] = None,
    devices=None,
) -> Mesh:
    """2-D (vol, blk) mesh: every CUDA device unless `devices` is given
    (raises when there is no card); the most-square factorization with
    vol >= blk unless `vol_axis` is given."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass devices=[torch.device('cpu'), "
                "...] for a mesh of the plain versions"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if vol_axis is None:
        vol_axis = 1
        for f in range(int(np.sqrt(n)), 0, -1):
            if n % f == 0:
                vol_axis = n // f
                break
    if n % vol_axis:
        raise ValueError(f"{n} devices do not fill a vol axis of {vol_axis}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(vol_axis, n // vol_axis))


# one CUDA stream per (device, block): the blocks of a call run at once
_STREAMS: dict = {}
_STREAMS_LOCK = threading.Lock()


def block_stream(device: torch.device, block: int) -> torch.cuda.Stream:
    """The CUDA stream of block `block` on `device` (made on first use)."""
    key = (device.index, block)
    with _STREAMS_LOCK:
        s = _STREAMS.get(key)
        if s is None:
            s = _STREAMS[key] = torch.cuda.Stream(device)
        return s


def _as_tensor(x) -> tuple[torch.Tensor, bool]:
    """(a contiguous uint8 tensor, whether x came as numpy)."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8)), True
    if x.dtype != torch.uint8:
        raise TypeError(f"shards must be uint8, got {x.dtype}")
    return x.contiguous(), False


def _pad_vol(data: torch.Tensor, vol: int) -> tuple[torch.Tensor, int]:
    """Zero-pad the volume axis up to a multiple of the mesh's vol axis so
    uneven batches shard; GF(2^8) is linear, so zero stripes encode and
    verify to zero and are stripped from the result."""
    v = data.shape[0]
    pad = (-v) % vol
    if pad:
        data = torch.cat(
            [data, torch.zeros((pad,) + tuple(data.shape[1:]), dtype=data.dtype,
                               device=data.device)]
        )
    return data, v


def _blocks(mesh: Mesh, v_pad: int, n: int):
    """(device, block index, volume slice, byte slice) of every block."""
    vol, blk = mesh.shape["vol"], mesh.shape["blk"]
    v_loc, n_loc = v_pad // vol, n // blk
    for i in range(vol):
        for j in range(blk):
            yield (mesh.devices[i, j], i * blk + j,
                   slice(i * v_loc, (i + 1) * v_loc),
                   slice(j * n_loc, (j + 1) * n_loc))


def _words(t: torch.Tensor) -> torch.Tensor:
    """uint8 [rows, n] (unit stride in a row) -> its int32 words [rows, n/4]."""
    return t.view(torch.int32)


def _check_width(n: int, blk: int) -> None:
    assert n % (4 * blk) == 0, f"N={n} not divisible by {4 * blk}"


def _matmul_blocks(matrix: np.ndarray, x, mesh: Mesh):
    """matrix (x) x per block: x uint8 [V, C, N] -> [V, R, N] (vol padding
    stripped), each block through gf_matmul on its device."""
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    x, from_numpy = _as_tensor(x)
    _, c, n = x.shape
    if c != matrix.shape[1]:
        raise ValueError(f"{c} shards for a matrix of {matrix.shape[1]} columns")
    _check_width(n, mesh.shape["blk"])
    x, v = _pad_vol(x, mesh.shape["vol"])
    r = matrix.shape[0]
    out = torch.empty((x.shape[0], r, n), dtype=torch.uint8, device=x.device)
    src = torch.cuda.current_stream(x.device) if x.device.type == "cuda" else None
    pending = []  # (stream, device result, out slice) to copy back
    for dev, b, vs, bs in _blocks(mesh, x.shape[0], n):
        if dev.type == "cpu":
            inp = x[vs, :, bs].to(dev)
            for t in range(inp.shape[0]):
                res = gf_matmul_packed(matrix, _words(inp[t]))
                _words(out[vs, :, bs][t]).copy_(res.to(out.device))
            continue
        s = block_stream(dev, b)
        if src is not None:
            s.wait_stream(src)
        with torch.cuda.stream(s):
            local = dev == x.device
            inp = x[vs, :, bs] if local else x[vs, :, bs].to(dev, non_blocking=True)
            res = out[vs, :, bs] if local else torch.empty(
                (inp.shape[0], r, inp.shape[2]), dtype=torch.uint8, device=dev)
            for t in range(inp.shape[0]):
                _gf_matmul_cuda(matrix, _words(inp[t]), out=_words(res[t]))
            if not local:
                pending.append((s, res, out[vs, :, bs]))
            elif src is not None:
                src.wait_stream(s)
    for s, res, dst in pending:
        with torch.cuda.stream(s):
            dst.copy_(res)
        if src is not None:
            src.wait_stream(s)
    out = out[:v]
    return out.numpy() if from_numpy else out


def sharded_encode(matrix: np.ndarray, data, mesh: Mesh):
    """data uint8[V, C, N] -> parity uint8[V, R, N], sharded (vol, -, blk).

    N must be divisible by 4 * mesh.shape['blk'] (whole 32-bit words per
    block)."""
    return _matmul_blocks(matrix, data, mesh)


def sharded_verify(matrix: np.ndarray, shards, mesh: Mesh) -> int:
    """shards uint8[V, C+R, N] -> the number of 32-bit parity words that
    differ from the parity recomputed from the data rows, summed over
    every block (the JAX package's psum over both axes). Each block runs
    the gf_verify kernel per volume into one device counter."""
    matrix = np.ascontiguousarray(matrix, dtype=np.uint8)
    k = matrix.shape[1]
    x, _ = _as_tensor(shards)
    if x.shape[1] != k + matrix.shape[0]:
        raise ValueError(f"{x.shape[1]} shards for {k} + {matrix.shape[0]}")
    n = x.shape[2]
    _check_width(n, mesh.shape["blk"])
    x, _v = _pad_vol(x, mesh.shape["vol"])
    src = torch.cuda.current_stream(x.device) if x.device.type == "cuda" else None
    total = 0
    counts = []  # (stream, device counter)
    for dev, b, vs, bs in _blocks(mesh, x.shape[0], n):
        if dev.type == "cpu":
            inp = x[vs, :, bs].to(dev)
            for t in range(inp.shape[0]):
                total += int(gf_verify_count(
                    matrix, _words(inp[t][:k]), _words(inp[t][k:])))
            continue
        s = block_stream(dev, b)
        if src is not None:
            s.wait_stream(src)
        with torch.cuda.stream(s):
            inp = x[vs, :, bs] if dev == x.device else x[vs, :, bs].to(dev, non_blocking=True)
            count = torch.zeros(1, dtype=torch.int64, device=dev)
            for t in range(inp.shape[0]):
                _gf_verify_cuda(matrix, _words(inp[t][:k]), _words(inp[t][k:]),
                                count=count)
            counts.append((s, count))
    for s, count in counts:
        with torch.cuda.stream(s):
            total += int(count.item())
        if src is not None:
            src.wait_stream(s)
    return total


def sharded_reconstruct_step(dec_rows: np.ndarray, survivors, mesh: Mesh):
    """Degraded-read analogue: survivors uint8[V, k, N] -> the rows
    dec_rows (x) survivors, uint8[V, len(dec_rows), N], each block on its
    device; the vol axis batches volumes, the blk axis cuts the bytes."""
    return _matmul_blocks(dec_rows, survivors, mesh)


def sharded_reconstruct_padded(
    dec_rows: np.ndarray, survivors: np.ndarray, mesh: Mesh
) -> np.ndarray:
    """sharded_reconstruct_step for any byte width: pads the column axis
    up to the mesh's packing unit (4 bytes x blk; zero columns decode to
    zero) and slices the pad back off. rebuild_ec_files_multi(mesh=...)
    sends its survivor batches through here."""
    survivors = np.ascontiguousarray(survivors, dtype=np.uint8)
    v, k, n = survivors.shape
    unit = 4 * mesh.shape["blk"]
    pad = (-n) % unit
    if pad:
        survivors = np.concatenate(
            [survivors, np.zeros((v, k, pad), dtype=np.uint8)], axis=2
        )
    out = np.asarray(sharded_reconstruct_step(dec_rows, survivors, mesh))
    return out[:, :, :n] if pad else out
