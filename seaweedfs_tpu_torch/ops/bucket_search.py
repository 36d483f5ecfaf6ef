"""The mesh lookup's bucket table and search: CUDA kernels + plain torch.

The sharded lookup (parallel/sharded_lookup.py) answers each probe with the
lower bound of its key over one replica's sorted table. The JAX program
bisects the whole table for every probe; here each replica gets a bucket
table, built on the card from its 16-byte rows, and each probe searches
only its bucket. The answers are the same: the lower bound over the table
always lies in the probe's bucket [starts[b], starts[b + 1]).

The table: the key range from kmin is cut into nb buckets of bstep keys,
and starts[b] is the first row whose key is >= kmin + b * bstep (starts[nb]
= n). On the card nb is sized to the persisting L2 the card reports
(table_buckets), so the search's two reads of `starts` are L2 hits; a
probe then loads the group of 4 rows its key's place in the bucket points
at, one round trip to HBM, and bisects a side of the bucket only when the
answer lies outside that group.

Two implementations of each function live here:

- the kernels (csrc/bucket_search.cu, built by _build.py): index_buckets
  ("A") and bucket_search ("B"), launched for tensors on a CUDA device
  through _index_buckets_cuda and _bucket_search_cuda, which count their
  launches in BUCKETS_LAUNCHES and SEARCH_LAUNCHES;
- the plain versions (_index_buckets_torch, _bucket_search_torch), taken
  only for tensors on the CPU; the tests run them against numpy and the JAX
  program, and chip_smoke.py holds the kernels against them on the card.

Keys are u64 bits in int64 tensors; the plain versions compare them
sign-biased (`x ^ (1 << 63)` orders as the unsigned value), since torch on
the CPU has no unsigned 64-bit comparison.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from .index_kernel import (
    _SIGN,
    IndexSnapshot,
    _bulk_lookup_bucketed_torch,
    _check_cuda,
    _check_rows,
    bucket_step,
    search_steps,
)

MIN_BUCKETS = 1 << 10  # the bucket count's floor, as IndexSnapshot's host build

# launches of each kernel since the process started (or the caller last
# reset them); the plain versions never touch them
BUCKETS_LAUNCHES = 0
SEARCH_LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()


# --- the table's geometry ---
def table_buckets(n: int, device: torch.device) -> int:
    """nb for a table of n rows on `device`: the largest power of two with
    at most 2 buckets a row whose (nb + 1) int32 entries fit the card's
    persisting L2 (off the card, IndexSnapshot.MAX_BUCKETS: a 128 MiB
    table); at least MIN_BUCKETS."""
    nb = 1 << max(n, 1).bit_length()  # in (n, 2n]
    if device.type == "cuda":
        budget = l2_limits(device)[0]
        while nb > MIN_BUCKETS and (nb + 1) * 4 > budget:
            nb >>= 1
    return max(MIN_BUCKETS, min(nb, IndexSnapshot.MAX_BUCKETS))


def _bucket_torch(keys: torch.Tensor, kmin: int, bstep: int, nb: int) -> torch.Tensor:
    """Each u64 key's bucket, min((max(key, kmin) - kmin) / bstep, nb - 1),
    as int64 (K1's and B's arithmetic). The u64 offset d is halved to a
    non-negative int64 for the division, and the quotient capped at nb
    before it is doubled back, so nothing overflows."""
    q = torch.clamp(keys ^ _SIGN, min=kmin - (1 << 63)) ^ _SIGN
    d = q - (kmin - (1 << 64) if kmin >= 1 << 63 else kmin)  # u64 bits, wraps
    if bstep >= 1 << 63:
        b = ((d ^ _SIGN) >= bstep - (1 << 63)).to(torch.int64)
    else:
        half = (d >> 1) & ((1 << 63) - 1)
        # d = 2 * half + (d & 1); the remainder's double reaches bstep when
        # half % bstep >= ceil((bstep - (d & 1)) / 2)
        b = 2 * torch.clamp(half // bstep, max=nb) + (
            half % bstep >= (bstep + 1 - (d & 1)) // 2).to(torch.int64)
    return torch.clamp(b, max=nb - 1)


# --- the plain versions ---
def _index_buckets_torch(biased_keys: torch.Tensor, kmin: int, bstep: int, nb: int):
    """Plain version of A: sorted sign-biased int64 keys -> (starts int32[nb
    + 1], the largest bucket's rows). starts[b] counts the rows of buckets
    below b, which for sorted keys is the first row of bucket >= b."""
    b = _bucket_torch(biased_keys ^ _SIGN, kmin, bstep, nb)
    counts = torch.bincount(b, minlength=nb)
    starts = torch.zeros(nb + 1, dtype=torch.int64, device=b.device)
    torch.cumsum(counts, 0, out=starts[1:])
    return starts.to(torch.int32), int(counts.max())


def _bucket_search_torch(bsteps: int, keys, offsets, sizes, starts, kmin: int,
                         bstep: int, nb: int, probes):
    """Plain version of B: each probe's bucket from its u64 bits, then
    K1's bounded search of [starts[b], starts[b + 1]) in `bsteps` rounds."""
    bucket = _bucket_torch(probes, kmin, bstep, nb)
    return _bulk_lookup_bucketed_torch(bsteps, keys, offsets, sizes, starts, probes, bucket)


# --- the CUDA kernels ---
_LIB = None
_LIB_LOCK = threading.Lock()
_L2: dict = {}


def _kernel_lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from ._build import load_library

            lib = load_library("bucket_search")
            vp, ull, ll = ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_longlong
            lib.index_buckets.restype = ctypes.c_int
            lib.index_buckets.argtypes = [vp, ctypes.c_int, ull, ull, ull, vp, vp, vp]
            lib.bucket_search.restype = ctypes.c_int
            lib.bucket_search.argtypes = [
                vp, ctypes.c_int, vp, ull, ull, ull, vp, ll, vp, vp, vp, ll, ll, vp,
            ]
            lib.l2_persist_limits.restype = ctypes.c_int
            lib.l2_persist_limits.argtypes = [
                ctypes.c_int, ctypes.POINTER(ll), ctypes.POINTER(ll)]
            lib.l2_persist_release.restype = ctypes.c_int
            lib.l2_persist_release.argtypes = []
            lib.bucket_kernels_registers.restype = ctypes.c_int
            lib.bucket_kernels_registers.argtypes = [ctypes.c_int]
            _LIB = lib
        return _LIB


def l2_limits(device: torch.device) -> tuple:
    """(the largest persisting L2 set-aside, the largest access policy
    window) of a CUDA device, in bytes, as the card reports them."""
    index = torch.device(device).index or 0
    with _LIB_LOCK:
        got = _L2.get(index)
    if got is None:
        persist, window = ctypes.c_longlong(), ctypes.c_longlong()
        rc = _kernel_lib().l2_persist_limits(index, ctypes.byref(persist), ctypes.byref(window))
        if rc != 0:
            raise RuntimeError(f"reading the persisting L2 limits failed: CUDA error {rc}")
        got = (persist.value, window.value)
        with _LIB_LOCK:
            _L2[index] = got
    return got


def release_l2(device: torch.device) -> None:
    """Demote the device's persisting L2 lines and set its set-aside back
    to 0, once the searches that used it are done."""
    with torch.cuda.device(device):
        rc = _kernel_lib().l2_persist_release()
    if rc != 0:
        raise RuntimeError(f"releasing the persisting L2 failed: CUDA error {rc}")


def _check_geometry(kmin: int, bstep: int, nb: int) -> None:
    if not (0 <= kmin < 1 << 64 and 1 <= bstep < 1 << 64 and 1 <= nb < 1 << 31
            and kmin + (nb - 1) * bstep < 1 << 64):
        raise ValueError(f"bucket geometry kmin={kmin} bstep={bstep} nb={nb} "
                         "leaves a boundary outside u64")


def _index_buckets_cuda(rows: torch.Tensor, kmin: int, bstep: int, nb: int):
    """Launch A on the current stream: a key-sorted IndexSnapshot's int64[n,
    2] rows on a CUDA device -> (starts int32[nb + 1], the largest bucket's
    rows as an int32[1] there). Not synchronised."""
    global BUCKETS_LAUNCHES
    n = _check_rows(rows)
    _check_geometry(kmin, bstep, nb)
    dev = rows.device
    starts = torch.empty(nb + 1, dtype=torch.int32, device=dev)
    max_rows = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.index_buckets(rows.data_ptr(), n, kmin, bstep, nb,
                               starts.data_ptr(), max_rows.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"index_buckets kernel launch failed: CUDA error {rc}")
    with _LAUNCH_LOCK:
        BUCKETS_LAUNCHES += 1
    return starts, max_rows


def _bucket_search_cuda(rows: torch.Tensor, starts: torch.Tensor, kmin: int, bstep: int,
                        nb: int, probes: torch.Tensor, out: Optional[tuple] = None,
                        l2_window: bool = True):
    """Launch B on the current stream: probes int64[P] (u64 bits) on the
    rows' CUDA device -> (offset int32[P], size int32[P], found uint8[P]).
    `starts` is A's table for these rows and geometry; with `l2_window` the
    launch holds it in persisting L2 (release_l2 gives the set-aside back).
    Not synchronised."""
    global SEARCH_LAUNCHES
    n = _check_rows(rows)
    _check_geometry(kmin, bstep, nb)
    dev = rows.device
    _check_cuda("starts", starts, torch.int32, dev)
    if starts.shape != (nb + 1,):
        raise ValueError(f"starts must hold nb + 1 = {nb + 1} entries")
    _check_cuda("probes", probes, torch.int64, dev)
    if probes.dim() != 1:
        raise ValueError("probes must be 1-D")
    p = probes.shape[0]
    if out is None:
        out = (
            torch.empty(p, dtype=torch.int32, device=dev),
            torch.empty(p, dtype=torch.int32, device=dev),
            torch.empty(p, dtype=torch.uint8, device=dev),
        )
    for name, t, dt in zip(("off", "size", "found"), out,
                           (torch.int32, torch.int32, torch.uint8)):
        _check_cuda(name, t, dt, dev)
        if t.shape != (p,):
            raise ValueError(f"out {name} must hold {p} entries")
    if p == 0:
        return out
    max_persist, max_window = l2_limits(dev) if l2_window else (0, 0)
    window = min((nb + 1) * 4, max_window) if max_persist > 0 else 0
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bucket_search(
            rows.data_ptr(), n, starts.data_ptr(), kmin, bstep, nb, probes.data_ptr(), p,
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), window, max_persist,
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"bucket_search kernel launch failed: CUDA error {rc}")
    with _LAUNCH_LOCK:
        SEARCH_LAUNCHES += 1
    return out


# --- a snapshot's table ---
def build_buckets(snap, kmin: int, kmax: int) -> None:
    """Give an unbucketed, key-sorted IndexSnapshot (kmin, kmax its first
    and last keys) a bucket table sized for its device: A on the card, the
    plain version on the CPU. Sets its starts, kmin, bstep, nb and bsteps;
    the caller decides that the table is worth bucketing
    (IndexSnapshot.bucketable)."""
    nb = table_buckets(snap.n, snap.device)
    bstep = bucket_step(kmin, kmax, nb)
    if snap.device.type == "cuda":
        starts, max_rows = _index_buckets_cuda(snap.rows, kmin, bstep, nb)
        max_rows = int(max_rows)  # waits for A
    else:
        starts, max_rows = _index_buckets_torch(snap.keys ^ _SIGN, kmin, bstep, nb)
    snap.starts, snap.kmin, snap.bstep, snap.nb = starts, kmin, bstep, nb
    snap.bsteps = search_steps(max_rows)
