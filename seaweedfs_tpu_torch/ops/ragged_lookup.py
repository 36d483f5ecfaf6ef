"""Ragged-batch lookups over a paged, device-resident row arena.

One lookup-gate wakeup delivers a RAGGED probe batch: needle-map probes
spanning many volumes' LSM runs (or a filer's path hashes over its store's
runs). Instead of one IndexSnapshot.lookup per volume (per run), the whole
wakeup runs as ONE launch of the kernel K2 (csrc/ragged_lookup.cu) over an
arena that stays resident on the card across launches.

Layout (one immutable _Generation per refresh, one allocation on the card):

    rows    : int64[N, 2]  the sealed runs' 16-byte rows, concatenated:
                           word 0 the key's u64 bits, word 1 the offset in
                           its low and the size in its high 32 bits; each
                           run's base aligned to PAGE rows, N a power of two
                           >= MIN_ROWS (zero rows pad the pages and the
                           tail). `keys`, `offs` and `sizes` are strided
                           views of it.
    tables  : int32        per run of MIN_BUCKETED rows or more, its bucket
                           table (ArenaSegment.probe_starts): nb + 1 starts
                           relative to the run's base, nb = rows // 2 - 1,
                           at most 2 bytes a row (probe_geometry)
    bloom   : int32        bloom-sidecar bitmaps, concatenated as LE words;
                           word 0 is a sentinel (the plane path's filterless
                           probes address it)
    desc    : int64[S, 8]  (host) one descriptor a run: kmin, bstep, nb,
                           base row, end row, table base, bloom base, bloom
                           mask (-1 bases: not bucketed, no filter)

One flush is one launch (LaunchPlan): the descriptors of each group's runs
newest first, one record a kernel block, and the keys, once each, in one
host-to-device copy; the kernel answers every key from the newest run that
holds it (found, rank, offset, size), and one copy brings the answers back.

Two implementations of the probe live here: the kernel K2 (launched for a
generation on the card through _ragged_probe_cuda, which counts its
launches in KERNEL_LAUNCHES) and its plain version _ragged_probe_torch,
taken only for a generation on the CPU. Beside them stay the JAX package's
per-slot plane form (pack_members, the host packing of its
_dispatch_members, and _ragged_dispatch_torch, its `_ragged_dispatch`
(seaweedfs_tpu/ops/ragged_lookup.py:181-203) in torch ops), which the
tests hold the probe to, and the plane kernel K2 replaced
(_ragged_lookup_cuda, counted in PLANE_LAUNCHES), which chip_smoke.py
times beside it. Nothing on the serving path packs planes.

`DeviceColumnArena` pins sealed segments resident with LRU eviction
(budget ARENA_BYTES unless the caller gives one; a segment's bytes count
its rows, bloom words and bucket table) and double-buffered
uploads: a refresh builds the next generation on a background thread, on
that thread's own
CUDA stream, and synchronises it before the swap, while in-flight
dispatches keep their reference to the old one (generations are
immutable; the swap is one pointer under a lock). A dispatch holds its
generation until its own stream has synchronised, so the caching
allocator never hands the old rows' memory to anyone under a running
kernel. Every caller treats `ensure()` returning None (segments never
uploaded: arena cold or killed) as an instruction to serve from the host
maps. A failure is never turned into host answers: a refresh that raises
is counted in `counters["errors"]` (message in `last_error`) and raised
again by the next `probe_groups` or `refresh_sync`, and a dispatch that
raises reaches its caller.
"""

from __future__ import annotations

import ctypes
import itertools
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from .gf256 import resolve_device
from .index_kernel import (
    _SIGN, _check_cuda, _check_rows, _search_range_bounded_torch, column_tensor, search_steps,
    thread_stream,
)

PAGE = 2048  # rows; segment bases are page-aligned in the arena
MIN_ROWS = 4096  # generations pad to pow2 row counts >= this

ARENA_BYTES = 256 << 20  # the default device-memory budget

BLOCK_THREADS = 128  # the probe kernel's block (csrc/ragged_lookup.cu kThreads)
_DESC_WORDS = 8  # a run descriptor: kmin, bstep, nb, base, end, tbase, bbase, bmask

_HANDLES = itertools.count(1)
_LOG = logging.getLogger(__name__)

# launches of K2 since the process started (or the caller last reset it),
# and of the plane kernel it replaced, which only chip_smoke.py launches
KERNEL_LAUNCHES = 0
PLANE_LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()


def _metrics():
    from ..util import metrics

    return metrics


class ArenaSegment:
    """One immutable sorted segment offered to the arena: columnar
    (keys u64, offs u32, sizes u32) views — typically straight off a
    sealed run's mmap — plus an optional bloom bitmap as LE u32 words.
    Content-immutable by contract: the handle is the identity the arena
    caches residency under, so a mutated segment MUST be a new handle
    (LSM runs satisfy this by construction)."""

    __slots__ = (
        "handle", "keys", "offs", "sizes", "bloom_words", "bloom_mbits",
        "count", "nbytes", "source", "alive",
        "_starts", "kmin", "bstep", "nb", "steps", "_buckets_built",
        "probe_geometry", "_probe_starts",
    )

    MIN_BUCKETED = 4096
    MAX_BUCKETS = 1 << 25

    def __init__(
        self,
        keys: np.ndarray,
        offs: np.ndarray,
        sizes: np.ndarray,
        bloom_words: Optional[np.ndarray] = None,
        bloom_mbits: int = 0,
        source=None,
        alive=None,
    ):
        self.handle = next(_HANDLES)
        self.keys = keys
        self.offs = offs
        self.sizes = sizes
        self.bloom_words = bloom_words
        self.bloom_mbits = int(bloom_mbits)
        self.count = len(keys)
        self.probe_geometry = (
            probe_geometry(self.count, int(keys[0]), int(keys[-1])) if self.count else None
        )
        self._probe_starts = None
        self.nbytes = self.count * 16 + (
            len(bloom_words) * 4 if bloom_words is not None else 0
        ) + self.table_bytes
        self.source = source
        self.alive = alive if alive is not None else (lambda: True)
        self._starts = None
        self._buckets_built = False
        self.kmin = 0
        self.bstep = 1
        self.nb = 0
        # search steps must cover the worst row range a probe can get;
        # refined to bucket occupancy when the bucket table is built
        self.steps = max(1, int(np.ceil(np.log2(max(self.count, 1)))) + 1)

    @property
    def table_bytes(self) -> int:
        """Bytes of K2's bucket table for this segment (0 when unbucketed)."""
        return 0 if self.probe_geometry is None else (self.probe_geometry[2] + 1) * 4

    def probe_starts(self) -> Optional[np.ndarray]:
        """K2's bucket table (probe_geometry): starts int32[nb + 1], the
        first row whose key is >= kmin + b * bstep, relative to the
        segment's first row; built once on the host and cached (a refresh
        uploads it, never rebuilds it). None when probe_geometry leaves
        the segment unbucketed."""
        if self.probe_geometry is None:
            return None
        if self._probe_starts is None:
            kmin, bstep, nb = self.probe_geometry
            keys = np.asarray(self.keys, dtype=np.uint64)
            bounds = np.uint64(kmin) + np.arange(nb, dtype=np.uint64) * np.uint64(bstep)
            starts = np.empty(nb + 1, dtype=np.int32)
            starts[:nb] = np.searchsorted(keys, bounds)
            starts[nb] = self.count
            self._probe_starts = starts
        return self._probe_starts

    def buckets(self):
        """Host-side interpolation-bucket table (IndexSnapshot's exact
        construction, the JAX arena's), built once per segment and cached;
        only the plane form (pack_members) reads it."""
        if self._buckets_built:
            return self._starts
        self._buckets_built = True
        n = self.count
        if n < self.MIN_BUCKETED:
            return None
        keys = np.asarray(self.keys, dtype=np.uint64)
        kmin = int(keys[0])
        kmax = int(keys[-1])
        span = kmax - kmin + 1
        if not (0 < span < 1 << 62) or kmax + 1 + self.MAX_BUCKETS >= 1 << 64:
            return None
        nb = 1 << max(10, int(np.ceil(np.log2(n))) + 1)
        nb = min(nb, self.MAX_BUCKETS)
        self.kmin = kmin
        self.nb = nb
        self.bstep = max(1, -(-span // nb))
        boundaries = np.uint64(kmin) + np.arange(
            nb, dtype=np.uint64
        ) * np.uint64(self.bstep)
        starts = np.searchsorted(keys, boundaries).astype(np.int32)
        starts = np.append(starts, np.int32(n))
        max_occ = int(np.max(np.diff(starts))) if nb else n
        self.steps = max(1, int(np.ceil(np.log2(max(max_occ, 1)))) + 1)
        self._starts = starts
        return starts


def probe_geometry(n: int, kmin: int, kmax: int) -> Optional[tuple]:
    """K2's bucket geometry for a sorted segment of n keys from kmin to kmax
    -> (kmin, bstep, nb), or None when it is too small to bucket (under
    MIN_BUCKETED rows) or its keys come within MAX_BUCKETS of 2^64, where
    the host's bucket boundaries would leave u64 (the JAX arena's rules,
    seaweedfs_tpu/ops/ragged_lookup.py:149-178). Unlike the JAX arena the
    port buckets a span of 2^62 or more: the kernel never computes a
    boundary, only (key - kmin) / bstep, and the boundaries below nb stay
    under kmax + 1 (a filer's path hashes span the whole u64 range). nb =
    n // 2 - 1 (at most MAX_BUCKETS): about two rows a bucket, so a bucket
    usually fits the kernel's 4-row window, and the table's nb + 1 starts
    take at most 2 bytes a row."""
    if n < ArenaSegment.MIN_BUCKETED or kmax + 1 + ArenaSegment.MAX_BUCKETS >= 1 << 64:
        return None
    nb = min(n // 2 - 1, ArenaSegment.MAX_BUCKETS)
    return kmin, max(1, -(-(kmax - kmin + 1) // nb)), nb


# --- the plain versions ---
def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 tensors holding u64 bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix64_torch(x: torch.Tensor) -> torch.Tensor:
    """The murmur3 finalizer of storage/needle_map/lsm_map.py::mix64_batch
    on int64 tensors holding u64 bits (the products wrap as u64's do)."""
    x = x ^ _srl(x, 33)
    x = x * (0xFF51AFD7ED558CCD - (1 << 64))
    x = x ^ _srl(x, 33)
    x = x * (0xC4CEB9FE1A85EC53 - (1 << 64))
    return x ^ _srl(x, 33)


def _ragged_probe_torch(rows, tables, bloom, keys, blocks, descs, with_index=False):
    """Plain version of K2, on the kernel's inputs: every (key, run) slot of
    every block record searched with the JAX package's bounded search (the
    bucket from the key, the bloom test first), then each key answered from
    its newest run that holds it. rows int64[N, 2]; tables, bloom int32;
    keys int64[K] (u64 bits); blocks int32[B, 4] (first key, keys, first
    run, runs); descs int64[S, 8] (LaunchPlan). -> (found uint8[K], rank
    int32[K], off int32[K], size int32[K]); with_index adds each slot's
    key, rank, table entry (-1: none), bloom words (-1: none), search range,
    final row and bloom verdict (for byte counts)."""
    dev = keys.device
    k_all = keys.shape[0]
    blocks = blocks.to(torch.int64)
    key0, nk, run0, nr = blocks.unbind(1)
    per = nk * nr
    blk = torch.repeat_interleave(torch.arange(len(blocks), device=dev), per)
    within = torch.arange(blk.numel(), device=dev) - torch.repeat_interleave(
        torch.cumsum(per, 0) - per, per)
    nk_s = nk[blk]
    rank = within // nk_s
    kidx = key0[blk] + within % nk_s
    kmin, bstep, nb, base, end, tbase, bbase, bmask = descs[run0[blk] + rank].unbind(1)
    probe = keys[kidx]
    # the bloom test: two bits of the run's bitmap, k = 2 double hashing
    h = _mix64_torch(probe)
    p0 = h & bmask
    p1 = (p0 + (_srl(h, 32) | 1)) & bmask
    filt = bbase >= 0
    bw0 = torch.where(filt, bbase + (p0 >> 5), -1)
    bw1 = torch.where(filt, bbase + (p1 >> 5), -1)
    present = ~filt | (((bloom[bw0.clamp(min=0)] >> (p0 & 31))
                        & (bloom[bw1.clamp(min=0)] >> (p1 & 31)) & 1) != 0)
    # the bucket, (max(k, kmin) - kmin) / bstep clamped to nb - 1, on u64
    # bits: the difference d halved to a non-negative int64 for the division
    # (d = 2 * half + (d & 1)), as bucket_search._bucket_torch does
    bucketed = tbase >= 0
    q = torch.where((probe ^ _SIGN) > (kmin ^ _SIGN), probe, kmin)
    d = q - kmin
    half, step = _srl(d, 1), bstep.clamp(min=1)
    b = 2 * torch.minimum(half // step, nb) + (
        half % step >= (step + 1 - (d & 1)) // 2).to(torch.int64)
    tix = torch.where(bucketed, tbase + torch.minimum(b, nb - 1).clamp(min=0), -1)
    t0 = tables[tix.clamp(min=0)].to(torch.int64)
    t1 = tables[tix.clamp(min=0) + 1].to(torch.int64)
    lo = torch.where(bucketed, base + t0, base)
    hi = torch.where(bucketed, base + t1, end)
    hi = torch.where(present, hi, lo)
    steps = search_steps(int((hi - lo).max())) if hi.numel() else 1
    r32 = rows.view(torch.int32)
    off, size, found, idx = _search_range_bounded_torch(
        steps, rows[:, 0], r32[:, 2], r32[:, 3], probe, lo, hi, end, with_index=True)
    # newest wins: each key's smallest rank among the slots that hold it
    none = 1 << 62
    best = torch.full((k_all,), none, dtype=torch.int64, device=dev).scatter_reduce(
        0, kidx, torch.where(found, rank, none), reduce="amin")
    win = found & (rank == best[kidx])
    hit = best < none
    out_off = torch.zeros(k_all, dtype=torch.int32, device=dev)
    out_size = torch.zeros(k_all, dtype=torch.int32, device=dev)
    out_off[kidx[win]] = off[win]
    out_size[kidx[win]] = size[win]
    out = (hit.to(torch.uint8), torch.where(hit, best, 0).to(torch.int32), out_off, out_size)
    if with_index:
        return out + ({
            "key": kidx, "rank": rank, "table": tix, "bloom0": bw0, "bloom1": bw1,
            "lo": lo, "hi": hi, "row": idx, "present": present, "found": found,
        },)
    return out


def _ragged_dispatch_torch(steps, keys, offs, sizes, bloom, u32p, i32p, with_index=False):
    """The plane form's plain version, _ragged_dispatch in torch ops: bloom
    pre-filter (2 word gathers + bit tests per probe) collapses filtered
    probes' ranges to empty, then the shared bounded search answers every
    probe against its own segment's rows. keys int64[N] (u64 bits); offs,
    sizes, bloom int32 (u32 bits); u32p int32[4, P] and i32p int32[5, P]
    as pack_members packs them. with_index adds each probe's final row and
    its bloom verdict (for byte counts)."""
    # (hi, lo) words -> u64 bits: [lo, hi] int32 pairs read as one LE int64
    probes = torch.stack((u32p[1], u32p[0]), dim=-1).contiguous().view(torch.int64)[:, 0]
    bm0, bm1 = u32p[2], u32p[3]
    lo, hi, end, bw0, bw1 = i32p[0], i32p[1], i32p[2], i32p[3], i32p[4]
    present = ((bloom[bw0.long()] & bm0) == bm0) & ((bloom[bw1.long()] & bm1) == bm1)
    hi = torch.where(present, hi, lo)  # filtered-out: empty range
    off, size, found, idx = _search_range_bounded_torch(
        steps, keys, offs, sizes, probes, lo, hi, end, with_index=True
    )
    if with_index:
        return off, size, found & present, idx, present
    return off, size, found & present


# --- the CUDA kernels ---
_LIB = None
_LIB_LOCK = threading.Lock()


def _kernel_lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from ._build import load_library

            lib = load_library("ragged_lookup")
            vp = ctypes.c_void_p
            lib.ragged_probe.restype = ctypes.c_int
            lib.ragged_probe.argtypes = [
                vp, vp, vp, vp, vp, ctypes.c_int, vp, vp, vp, vp, vp, vp,
            ]
            lib.ragged_lookup.restype = ctypes.c_int
            lib.ragged_lookup.argtypes = [
                vp, vp, vp, ctypes.c_int, vp, vp, vp, ctypes.c_int, vp, vp, vp, vp,
            ]
            lib.ragged_probe_registers.restype = ctypes.c_int
            lib.ragged_probe_registers.argtypes = []
            _LIB = lib
        return _LIB


def _ragged_probe_cuda(rows, tables, bloom, keys, blocks, descs, out=None):
    """Launch K2 on the current stream: one block a record of `blocks`
    (LaunchPlan), over a generation's rows, tables and bloom words on the
    card -> (found uint8[K], rank int32[K], off int32[K], size int32[K]).
    Not synchronised."""
    global KERNEL_LAUNCHES
    _check_rows(rows)
    dev = rows.device
    for name, t, dt in (("tables", tables, torch.int32), ("bloom", bloom, torch.int32),
                        ("keys", keys, torch.int64), ("blocks", blocks, torch.int32),
                        ("descs", descs, torch.int64)):
        _check_cuda(name, t, dt, dev)
    if (keys.dim() != 1 or blocks.dim() != 2 or blocks.shape[1] != 4 or blocks.data_ptr() % 16
            or descs.dim() != 2 or descs.shape[1] != _DESC_WORDS):
        raise ValueError("keys must be 1-D, blocks a 16-byte aligned [B, 4] table and "
                         f"descs [S, {_DESC_WORDS}]")
    k = keys.shape[0]
    if out is None:
        out = (torch.empty(k, dtype=torch.uint8, device=dev),
               *(torch.empty(k, dtype=torch.int32, device=dev) for _ in range(3)))
    for name, t, dt in zip(("found", "rank", "off", "size"), out,
                           (torch.uint8, torch.int32, torch.int32, torch.int32)):
        _check_cuda(name, t, dt, dev)
        if t.shape != (k,):
            raise ValueError(f"out {name} must hold {k} entries")
    nblocks = blocks.shape[0]
    if nblocks == 0:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ragged_probe(
            rows.data_ptr(), tables.data_ptr(), bloom.data_ptr(), keys.data_ptr(),
            blocks.data_ptr(), nblocks, descs.data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(), out[3].data_ptr(), out[0].data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"ragged_probe kernel launch failed: CUDA error {rc}")
    with _LAUNCH_LOCK:
        KERNEL_LAUNCHES += 1
    return out


def _ragged_lookup_cuda(keys, offs, sizes, bloom, u32p, i32p, out=None):
    """Launch the plane kernel K2 replaced (chip_smoke.py times it beside
    K2; nothing else calls it) on the current stream, over contiguous key,
    offset and size columns and pack_members' planes -> (offset int32[P],
    size int32[P], found uint8[P]). Not synchronised."""
    global PLANE_LAUNCHES
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {dev}")
    n = keys.shape[0]
    if not 1 <= n < 1 << 31:
        raise ValueError(f"the kernel takes 1 to 2^31-1 rows, got {n}")
    _check_cuda("keys", keys, torch.int64, dev)
    for name, t in (("offs", offs), ("sizes", sizes), ("bloom", bloom),
                    ("u32p", u32p), ("i32p", i32p)):
        _check_cuda(name, t, torch.int32, dev)
    p = u32p.shape[1] if u32p.dim() == 2 else -1
    if (offs.shape != (n,) or sizes.shape != (n,) or bloom.dim() != 1
            or u32p.shape != (4, p) or i32p.shape != (5, p) or p >= 1 << 31):
        raise ValueError(
            "columns must be 1-D of one length, planes [4, P] and [5, P]"
        )
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
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ragged_lookup(
            keys.data_ptr(), offs.data_ptr(), sizes.data_ptr(), n,
            bloom.data_ptr(), u32p.data_ptr(), i32p.data_ptr(), p,
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"ragged_lookup kernel launch failed: CUDA error {rc}")
    with _LAUNCH_LOCK:
        PLANE_LAUNCHES += 1
    return out


def ragged_dispatch(gen: "_Generation", keys, blocks, descs, out=None):
    """One launch over `gen`: K2 for a generation on the card (or a
    raise), the plain version for one on the CPU -> (found, rank, off,
    size) per key."""
    if gen.rows.device.type == "cuda":
        return _ragged_probe_cuda(gen.rows, gen.tables, gen.bloom, keys, blocks, descs, out=out)
    return _ragged_probe_torch(gen.rows, gen.tables, gen.bloom, keys, blocks, descs)


def _i64(x: int) -> int:
    """A u64 as the int64 holding its bits."""
    return x - (1 << 64) if x >= 1 << 63 else x


class _Generation:
    """One immutable device-resident arena build. Dispatches capture a
    reference and keep using it even if the arena swaps underneath."""

    __slots__ = (
        "gen_id", "rows", "keys", "offs", "sizes", "tables", "bloom", "desc",
        "seg", "used_rows", "nbytes", "built_s", "_steps",
    )

    def __init__(self, gen_id, segments, device: torch.device):
        t0 = time.perf_counter()
        self.gen_id = gen_id
        # handle -> (ArenaSegment, base_row, bloom_base_word, descriptor row)
        self.seg = {}
        rows = 0
        bloom_words = 1  # word 0 = sentinel for filterless plane probes
        table_words = 0
        layout = []
        for i, s in enumerate(segments):
            bbase = -1
            if s.bloom_words is not None and s.bloom_mbits:
                bbase = bloom_words
                bloom_words += len(s.bloom_words)
            starts = s.probe_starts()
            tbase = -1
            if starts is not None:
                tbase = table_words
                table_words += len(starts)
            self.seg[s.handle] = (s, rows, bbase, i)
            layout.append((s, rows, bbase, tbase, starts))
            rows += -(-max(s.count, 1) // PAGE) * PAGE  # page-aligned
        self.used_rows = rows
        n = max(MIN_ROWS, 1 << max(0, (rows - 1)).bit_length())
        w = 1 << max(0, (bloom_words - 1)).bit_length()
        t = max(2, table_words)  # the plain version reads entries 0 and 1 unmasked
        # one allocation, uploaded in one copy: rows, tables, bloom words,
        # each a whole number of int64 words
        tw, bw = -(-t // 2), -(-w // 2)
        blob = np.zeros(2 * n + tw + bw, dtype=np.int64)
        row_words = blob[: 2 * n].reshape(n, 2)
        row_halves = blob[: 2 * n].view(np.uint32).reshape(n, 4)
        tables = blob[2 * n : 2 * n + tw].view(np.int32)
        bloom = blob[2 * n + tw :].view(np.uint32)
        desc = np.zeros((len(layout), _DESC_WORDS), dtype=np.int64)
        for i, (s, base, bbase, tbase, starts) in enumerate(layout):
            end = base + s.count
            row_words[base:end, 0] = np.asarray(s.keys, dtype=np.uint64).view(np.int64)
            row_halves[base:end, 2] = np.asarray(s.offs, dtype=np.uint32)
            row_halves[base:end, 3] = np.asarray(s.sizes, dtype=np.uint32)
            if bbase >= 0:
                bloom[bbase : bbase + len(s.bloom_words)] = s.bloom_words
            if tbase >= 0:
                tables[tbase : tbase + len(starts)] = starts
            kmin, bstep, nb = s.probe_geometry or (0, 1, 0)
            desc[i] = (_i64(kmin), _i64(bstep), nb, base, end, tbase, bbase,
                       s.bloom_mbits - 1 if bbase >= 0 else 0)
        if device.type == "cuda":
            # built on this thread's own stream and complete before the
            # caller swaps it in (the JAX package's block_until_ready)
            stream = thread_stream(device)
            with torch.cuda.stream(stream):
                blob_t = column_tensor(blob, torch.int64, device)
            stream.synchronize()
        else:
            blob_t = column_tensor(blob, torch.int64, device)
        self.rows = blob_t[: 2 * n].view(n, 2)
        halves = self.rows.view(torch.int32)
        self.keys, self.offs, self.sizes = self.rows[:, 0], halves[:, 2], halves[:, 3]
        self.tables = blob_t[2 * n : 2 * n + tw].view(torch.int32)[:t]
        self.bloom = blob_t[2 * n + tw :].view(torch.int32)[:w]
        self.desc = desc
        self.nbytes = 16 * n + 4 * t + 4 * w + desc.nbytes
        self._steps = None
        self.built_s = time.perf_counter() - t0

    @property
    def steps(self) -> int:
        """The plane form's search rounds (the JAX generation's `steps`),
        from the segments' host bucket tables, built on first use: the
        probe path never reads it."""
        if self._steps is None:
            steps = 1
            for s, *_ in self.seg.values():
                s.buckets()
                steps = max(steps, s.steps)
            self._steps = steps
        return self._steps


def pack_members(gen: _Generation, members, u32p: np.ndarray, i32p: np.ndarray) -> list:
    """Pack a dispatch's probe planes on the host, as the JAX package's
    _dispatch_members does: slot block per (group, segment), rank-major.
    members: [(group index, segments newest-first, keys u64)]; u32p
    uint32[4, total] and i32p int32[5, total] (total = sum of K * R), every
    entry written. Returns [(group index, base slot, K, R)]. The plane form
    K2 replaced: the tests and chip_smoke.py hold the probe to it."""
    from ..storage.needle_map.lsm_map import mix64_batch

    blocks = []
    base_slot = 0
    phi, plo, bm0, bm1 = u32p[0], u32p[1], u32p[2], u32p[3]
    lo, hi, end, bw0, bw1 = i32p[0], i32p[1], i32p[2], i32p[3], i32p[4]
    for gi, segments, keys in members:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        K, R = len(keys), len(segments)
        blocks.append((gi, base_slot, K, R))
        g_hi = (keys >> np.uint64(32)).astype(np.uint32)
        g_lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        mixed = None
        for rj, s in enumerate(segments):
            sl = slice(base_slot + rj * K, base_slot + (rj + 1) * K)
            seg, base, bbase, _d = gen.seg[s.handle]
            phi[sl] = g_hi
            plo[sl] = g_lo
            end[sl] = base + seg.count
            starts = seg.buckets()
            if starts is None:
                lo[sl] = base
                hi[sl] = base + seg.count
            else:
                b = np.maximum(keys, np.uint64(seg.kmin))
                b = (b - np.uint64(seg.kmin)) // np.uint64(seg.bstep)
                b = np.minimum(b, np.uint64(seg.nb - 1)).astype(np.int64)
                lo[sl] = base + starts[b]
                hi[sl] = base + starts[b + 1]
            if bbase < 0:
                bw0[sl] = bw1[sl] = 0
                bm0[sl] = bm1[sl] = 0
                continue
            if mixed is None:
                mixed = mix64_batch(keys)
            mask = np.uint64(seg.bloom_mbits - 1)
            pos0 = mixed & mask
            pos1 = (pos0 + ((mixed >> np.uint64(32)) | np.uint64(1))) & mask
            bw0[sl] = bbase + (pos0 >> np.uint64(5)).astype(np.int64)
            bm0[sl] = np.uint32(1) << (pos0 & np.uint64(31)).astype(np.uint32)
            bw1[sl] = bbase + (pos1 >> np.uint64(5)).astype(np.int64)
            bm1[sl] = np.uint32(1) << (pos1 & np.uint64(31)).astype(np.uint32)
        base_slot += K * R
    return blocks


def fold_newest(found, off, size, blocks) -> list:
    """The plane form's newest-wins reduction, as the JAX package's
    _dispatch_members does it on the host: per pack_members block, each
    key's first (newest) run that found it -> [(group index, {found, rank,
    off, size})]."""
    out = []
    for gi, base_slot, K, R in blocks:
        fm = found[base_slot : base_slot + K * R].reshape(R, K)
        om = off[base_slot : base_slot + K * R].reshape(R, K)
        sm = size[base_slot : base_slot + K * R].reshape(R, K)
        rank = np.argmax(fm, axis=0)
        cols = np.arange(K)
        out.append((gi, {"found": fm.any(axis=0), "rank": rank.astype(np.int32),
                         "off": om[rank, cols], "size": sm[rank, cols]}))
    return out


class LaunchPlan:
    """One flush over a generation laid out as K2's inputs, in int64 words:
    the descriptors of each group's runs, newest first, group after group
    (_DESC_WORDS each); one record a kernel block (int32 first key, keys,
    first run, runs: a block holds keys of one group, BLOCK_THREADS // L of
    them at L = min(next power of two >= R, 32) lanes a key); the keys, once
    each (u64 bits). members: [(group index, segments newest-first, keys
    u64)], every group with keys and segments resident in the generation."""

    __slots__ = ("members", "spans", "n_runs", "n_blocks", "n_keys", "slots", "words",
                 "_groups")

    def __init__(self, members):
        self.members = members
        self.spans = []  # (group index, first key, K)
        groups = []  # (first key, K, first run, R, keys a block, blocks)
        kbase = rbase = nblk = slots = 0
        for gi, segments, keys in members:
            k, r = len(keys), len(segments)
            kpb = BLOCK_THREADS // min(1 << (r - 1).bit_length(), 32)
            groups.append((kbase, k, rbase, r, kpb, -(-k // kpb)))
            self.spans.append((gi, kbase, k))
            nblk += groups[-1][5]
            kbase += k
            rbase += r
            slots += k * r
        self._groups = groups
        self.n_runs, self.n_blocks, self.n_keys, self.slots = rbase, nblk, kbase, slots
        self.words = _DESC_WORDS * rbase + 2 * nblk + kbase

    def write(self, gen: _Generation, buf: np.ndarray) -> None:
        """Write the launch's words into buf (int64, at least `words`)."""
        rw, bw = _DESC_WORDS * self.n_runs, 2 * self.n_blocks
        rows = [gen.seg[s.handle][3] for _gi, segments, _k in self.members for s in segments]
        buf[:rw] = gen.desc[rows].reshape(-1)
        rec = buf[rw : rw + bw].view(np.int32).reshape(-1, 4)
        kv = buf[rw + bw : rw + bw + self.n_keys].view(np.uint64)
        b = 0
        for (_gi, _s, keys), (kb, k, rb, r, kpb, n) in zip(self.members, self._groups):
            g = rec[b : b + n]
            g[:, 0] = np.arange(kb, kb + k, kpb)
            g[:, 1:] = (kpb, rb, r)
            g[-1, 1] = k - (n - 1) * kpb
            kv[kb : kb + k] = keys
            b += n

    def views(self, t: torch.Tensor) -> tuple:
        """(keys int64[K], blocks int32[B, 4], descs int64[S, 8]): the
        regions of a flat int64 tensor that holds the written words."""
        rw, bw = _DESC_WORDS * self.n_runs, 2 * self.n_blocks
        descs = t[:rw].view(self.n_runs, _DESC_WORDS)
        blocks = t[rw : rw + bw].view(torch.int32).view(self.n_blocks, 4)
        return t[rw + bw : rw + bw + self.n_keys], blocks, descs

    def tensors(self, gen: _Generation) -> tuple:
        """The launch's inputs as tensors on gen's device (for comparisons
        and timings; the flush path writes them into its pinned staging)."""
        buf = np.empty(self.words, dtype=np.int64)
        self.write(gen, buf)
        return self.views(torch.from_numpy(buf).to(gen.rows.device))


def _answer_words(k: int) -> int:
    return 3 * k + (k + 3) // 4


def _answer_views(t: torch.Tensor, k: int) -> tuple:
    """(found uint8[k], rank, off, size int32[k]) in a flat int32 tensor of
    _answer_words(k): rank, off, size, then the found bytes."""
    found = t[3 * k : 3 * k + (k + 3) // 4].view(torch.uint8)[:k]
    return found, t[:k], t[k : 2 * k], t[2 * k : 3 * k]


class _FlushStaging:
    """One thread's flush buffers on the card: the launch's input words and
    the answers, pinned on the host, with device twins."""

    def __init__(self, device: torch.device, words: int, keys: int):
        self.words, self.keys = words, keys
        self.host_in = torch.empty(words, dtype=torch.int64, pin_memory=True)
        self.dev_in = torch.empty(words, dtype=torch.int64, device=device)
        self.host_out = torch.empty(_answer_words(keys), dtype=torch.int32, pin_memory=True)
        self.dev_out = torch.empty(_answer_words(keys), dtype=torch.int32, device=device)


class DeviceColumnArena:
    """Pins sealed segments resident on `device`; LRU-evicts past the byte
    budget; refreshes double-buffered on a background thread. All public
    methods are thread-safe; `ensure`/`probe_groups` never block on an
    upload — a cold arena answers None and the caller serves host-side
    while the refresh runs. `device` is the card unless the caller asks
    for the CPU (which runs the plain version); it raises when CUDA is
    asked for and absent."""

    def __init__(self, budget_bytes: int = 0, device=None):
        self.budget = budget_bytes or ARENA_BYTES
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._gen: Optional[_Generation] = None
        self._gen_seq = 0
        self._sources: dict[int, ArenaSegment] = {}
        self._last_used: dict[int, int] = {}
        self._tick = 0
        self._dead = False
        self._refresh_queued = False
        self._local = threading.local()
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="arena-refresh"
        )
        self.counters = {
            "dispatches": 0,
            "probes": 0,
            "uploads": 0,
            "evictions": 0,
            "cold_misses": 0,
            "dead_refusals": 0,
            "errors": 0,
        }
        self.last_error: Optional[str] = None
        # a refresh (or a flush-path prefetch) that raised, waiting to be
        # raised again by the next probe_groups or refresh_sync
        self._refresh_error: Optional[BaseException] = None
        self._error_what = "refresh"

    def note_error(self, exc: BaseException, defer: str = "") -> None:
        """Count a refresh, prefetch or dispatch that raised. With `defer`
        (what failed: "refresh", "prefetch"), also hold the error for the
        next probe_groups or refresh_sync to raise, unless one is held
        already."""
        with self._lock:
            self.counters["errors"] += 1
            self.last_error = f"{type(exc).__name__}: {exc}"
            if defer and self._refresh_error is None:
                self._refresh_error = exc
                self._error_what = defer
        _metrics().NEEDLE_MAP_DEVICE_ERRORS.inc()
        _LOG.warning("lookup arena error: %s", self.last_error, exc_info=exc)

    def _raise_refresh_error(self) -> None:
        """Raise (once) the error of a refresh or prefetch that failed
        since the last call; the next ensure() queues a fresh attempt."""
        with self._lock:
            err, self._refresh_error = self._refresh_error, None
            what = self._error_what
        if err is not None:
            raise RuntimeError(f"lookup arena {what} failed: {err}") from err

    # ---------------- residency ----------------
    def ensure(self, segments) -> Optional[_Generation]:
        """All `segments` resident in the CURRENT generation -> that
        generation (LRU bumped). Otherwise registers them, queues one
        background refresh, and returns None (caller: host fallback)."""
        if self._dead:
            self.counters["dead_refusals"] += 1
            return None
        with self._lock:
            self._tick += 1
            tick = self._tick
            gen = self._gen
            missing = False
            for s in segments:
                self._last_used[s.handle] = tick
                if s.handle not in self._sources:
                    self._sources[s.handle] = s
                if gen is None or s.handle not in gen.seg:
                    missing = True
            if not missing:
                return gen
            self.counters["cold_misses"] += 1
            queue = not self._refresh_queued
            if queue:
                self._refresh_queued = True
        if queue:
            self._pool.submit(self._refresh)
        return None

    def _refresh(self) -> None:
        """Build generation N+1 while N keeps serving; swap is one
        pointer. LRU eviction happens here: most-recently-ensured
        segments win the byte budget."""
        try:
            with self._lock:
                self._refresh_queued = False
                live = [s for s in self._sources.values() if s.alive()]
                dead_handles = [
                    h for h, s in self._sources.items() if not s.alive()
                ]
                for h in dead_handles:
                    del self._sources[h]
                    self._last_used.pop(h, None)
                order = sorted(
                    live,
                    key=lambda s: self._last_used.get(s.handle, 0),
                    reverse=True,
                )
                chosen = []
                total = 0
                for s in order:
                    if chosen and total + s.nbytes > self.budget:
                        self.counters["evictions"] += 1
                        continue
                    chosen.append(s)
                    total += s.nbytes
                self._gen_seq += 1
                gen_id = self._gen_seq
            gen = _Generation(gen_id, chosen, self.device)
            with self._lock:
                if self._gen is None or self._gen.gen_id < gen_id:
                    self._gen = gen
                self.counters["uploads"] += 1
            m = _metrics()
            m.NEEDLE_MAP_DEVICE_RESIDENT.set(gen.nbytes)
            m.NEEDLE_MAP_DEVICE_SEGMENTS.set(len(gen.seg))
            m.NEEDLE_MAP_DEVICE_UPLOADS.inc()
        except Exception as e:
            # counted here, raised to the next prober: a failed upload is
            # never served around from the host maps
            with self._lock:
                self._refresh_queued = False
            self.note_error(e, defer="refresh")

    def prefetch(self, segment: ArenaSegment) -> str:
        """Flush-path residency hint: an LSM store offers a NEWLY SEALED
        run right when it seals, so the background refresh uploads it
        before the first probe would cold-miss on it. Never blocks, never
        counts as a probe-path cold miss. Returns the outcome."""
        if self._dead:
            return "unavailable"
        with self._lock:
            self._tick += 1
            self._last_used[segment.handle] = self._tick
            if segment.handle not in self._sources:
                self._sources[segment.handle] = segment
            gen = self._gen
            if gen is not None and segment.handle in gen.seg:
                return "resident"
            queue = not self._refresh_queued
            if queue:
                self._refresh_queued = True
        if queue:
            self._pool.submit(self._refresh)
            return "queued"
        return "piggybacked"

    def refresh_sync(self) -> None:
        """Block until a refresh including everything registered so far
        has landed (tests and warm-up; serving paths never call it); raises
        if it failed."""
        self._pool.submit(self._refresh).result()
        self._raise_refresh_error()

    def kill(self) -> None:
        """Fault hook: drop dead. Every subsequent ensure/probe answers
        None and the gates degrade to host lookups."""
        self._dead = True

    def revive(self) -> None:
        self._dead = False

    def stats(self) -> dict:
        with self._lock:
            gen = self._gen
            out = {
                "generation": gen.gen_id if gen else 0,
                "resident_segments": len(gen.seg) if gen else 0,
                "resident_bytes": gen.nbytes if gen else 0,
                "resident_rows": gen.used_rows if gen else 0,
                "registered_segments": len(self._sources),
                "budget_bytes": self.budget,
                "dead": self._dead,
                "device": str(self.device),
                "last_error": self.last_error,
            }
            out.update(self.counters)
        return out

    # ---------------- the one-dispatch probe ----------------
    def probe_groups(self, groups, timings: Optional[dict] = None):
        """groups: [(segments_newest_first, keys_u64)] — one entry per
        volume contributing to the wakeup. Returns a list aligned with
        groups: None where this group must be host-served (cold/dead),
        else {found, rank, off, size} numpy arrays aligned with the
        group's keys; `rank` indexes the group's newest-first segment list
        (the caller applies its own newest-wins + tombstone semantics).
        Raises the error of a refresh that failed since the last call, and
        any error of the dispatch itself."""
        t0 = time.perf_counter()
        results: list = [None] * len(groups)
        plan = []  # (group index, segments, keys, gen)
        if self._dead:
            self.counters["dead_refusals"] += 1
            return results
        self._raise_refresh_error()
        for gi, (segments, keys) in enumerate(groups):
            if len(keys) == 0:
                results[gi] = _empty_result()
                continue
            if len(segments) == 0:
                results[gi] = _empty_result(len(keys))
                continue
            gen = self.ensure(segments)
            if gen is None:
                continue
            plan.append((gi, segments, keys, gen))
        if not plan:
            if timings is not None:
                timings["pack_s"] = timings.get("pack_s", 0.0) + (
                    time.perf_counter() - t0
                )
            return results
        # dispatch groups sharing a generation together (normal case:
        # everything is on the current one)
        by_gen: dict[int, list] = {}
        gens: dict[int, _Generation] = {}
        for gi, segments, keys, gen in plan:
            by_gen.setdefault(gen.gen_id, []).append((gi, segments, keys))
            gens[gen.gen_id] = gen
        if timings is not None:
            timings["pack_s"] = timings.get("pack_s", 0.0) + (
                time.perf_counter() - t0
            )
        for gen_id, members in by_gen.items():
            try:
                self._dispatch_members(gens[gen_id], members, results, timings)
            except Exception as e:
                self.note_error(e)
                raise
        return results

    def _staging(self, words: int, keys: int) -> _FlushStaging:
        st = getattr(self._local, "staging", None)
        if st is None or st.words < words or st.keys < keys:
            st = self._local.staging = _FlushStaging(
                self.device, max(words, 64, st.words if st else 0),
                max(keys, 64, st.keys if st else 0))
        return st

    def _dispatch_members(self, gen, members, results, timings) -> None:
        t0 = time.perf_counter()
        plan = LaunchPlan(members)
        k = plan.n_keys
        if self.device.type == "cuda":
            st = self._staging(plan.words, k)
            plan.write(gen, st.host_in.numpy())
            t1 = time.perf_counter()
            stream = thread_stream(self.device)
            with torch.cuda.stream(stream):
                dev_in = st.dev_in[: plan.words]
                dev_in.copy_(st.host_in[: plan.words], non_blocking=True)
                if timings is not None:
                    # barrier only when stage walls are being measured
                    stream.synchronize()
                t2 = time.perf_counter()
                ragged_dispatch(gen, *plan.views(dev_in), out=_answer_views(st.dev_out, k))
                if timings is not None:
                    stream.synchronize()
                t3 = time.perf_counter()
                host_out = st.host_out[: _answer_words(k)]
                host_out.copy_(st.dev_out[: _answer_words(k)], non_blocking=True)
            # `gen` stays referenced until this stream has finished with
            # its rows
            stream.synchronize()
            found, rank, off, size = (t.numpy() for t in _answer_views(host_out, k))
        else:
            buf = np.empty(plan.words, dtype=np.int64)
            plan.write(gen, buf)
            t1 = t2 = time.perf_counter()
            found, rank, off, size = (
                t.numpy() for t in ragged_dispatch(gen, *plan.views(torch.from_numpy(buf))))
            t3 = time.perf_counter()
        for gi, a, n in plan.spans:
            results[gi] = {
                "found": found[a : a + n].astype(bool),
                "rank": rank[a : a + n].copy(),
                "off": off[a : a + n].view(np.uint32).copy(),
                "size": size[a : a + n].view(np.uint32).copy(),
            }
        t4 = time.perf_counter()
        with self._lock:
            self.counters["dispatches"] += 1
            self.counters["probes"] += plan.slots
        m = _metrics()
        m.NEEDLE_MAP_DEVICE_DISPATCHES.inc()
        m.NEEDLE_MAP_DEVICE_PROBES.inc(plan.slots)
        if timings is not None:
            timings["pack_s"] = timings.get("pack_s", 0.0) + (t1 - t0)
            timings["upload_s"] = timings.get("upload_s", 0.0) + (t2 - t1)
            timings["dispatch_s"] = timings.get("dispatch_s", 0.0) + (t3 - t2)
            timings["readback_s"] = timings.get("readback_s", 0.0) + (t4 - t3)

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        with self._lock:
            self._gen = None
            self._sources = {}
            self._last_used = {}


def _empty_result(k: int = 0) -> dict:
    return {
        "found": np.zeros(k, dtype=bool),
        "rank": np.zeros(k, dtype=np.int32),
        "off": np.zeros(k, dtype=np.uint32),
        "size": np.zeros(k, dtype=np.uint32),
    }


_DEFAULT: Optional[DeviceColumnArena] = None
_DEFAULT_LOCK = threading.Lock()


def get_default_arena() -> DeviceColumnArena:
    """Process-wide arena shared by every gate backend (one device-memory
    budget, one residency plane), on the card; raises without CUDA."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = DeviceColumnArena()
        return _DEFAULT


def peek_default_arena() -> Optional[DeviceColumnArena]:
    """The process-wide arena IF one has been created, else None. A
    flush-path prefetch hint rides this instead of get_default_arena(): a
    hint must never be what first allocates the device budget."""
    return _DEFAULT
