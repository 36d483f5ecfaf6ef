"""Ragged-batch lookups over a paged, device-resident column arena.

One lookup-gate wakeup delivers a RAGGED probe batch: needle-map probes
spanning many volumes' LSM runs. Instead of one IndexSnapshot.lookup per
volume (per run), the whole wakeup runs as ONE launch of the kernel K2
(csrc/ragged_lookup.cu) over a column arena that stays resident on the
card across launches: flat probe keys plus per-probe (row range, segment
end, bloom word) coordinates into the arena's pages.

Layout (one immutable _Generation per refresh):

    keys               : u64[N]  sealed-run key columns, concatenated,
    offs/sizes         : u32[N]  each segment base aligned to PAGE rows,
                                 N a power of two >= MIN_ROWS (zero rows
                                 pad the pages and the tail)
    bloom              : u32[W]  bloom-sidecar bitmaps, concatenated as
                                 LE words; word 0 is a sentinel so
                                 filterless probes can address it
    per probe (host-packed into two planes, as the JAX package packs them):
        u32p [4, P]  key hi, key lo, bloom mask 0, bloom mask 1
        i32p [5, P]  row lo, row hi (the segment's interpolation bucket,
                     absolute), end (the segment's exclusive end row),
                     bloom word 0, bloom word 1 (k=2, the same premixed
                     murmur3 hash as the host probe path; mask 0 = no
                     filter = always present)

Two implementations of the dispatch live here: the kernel K2 (launched for
a generation on the card through _ragged_lookup_cuda, which counts its
launches in KERNEL_LAUNCHES) and its plain version _ragged_dispatch_torch,
the JAX program `_ragged_dispatch` (seaweedfs_tpu/ops/ragged_lookup.py:
181-203) in torch ops, taken only for a generation on the CPU.

`DeviceColumnArena` pins sealed segments resident with LRU eviction
(budget ARENA_BYTES unless the caller gives one) and double-buffered
uploads: a refresh builds the next generation on a background thread, on
that thread's own
CUDA stream, and synchronises it before the swap, while in-flight
dispatches keep their reference to the old one (generations are
immutable; the swap is one pointer under a lock). A dispatch holds its
generation until its own stream has synchronised, so the caching
allocator never hands the old columns' memory to anyone under a running
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
    Staging, _check_cuda, _search_range_bounded_torch, column_tensor, thread_stream,
)

PAGE = 2048  # rows; segment bases are page-aligned in the arena
MIN_ROWS = 4096  # generations pad to pow2 row counts >= this

ARENA_BYTES = 256 << 20  # the default device-memory budget

_HANDLES = itertools.count(1)
_LOG = logging.getLogger(__name__)

# launches of K2 since the process started (or the caller last reset it)
KERNEL_LAUNCHES = 0
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
        self.nbytes = self.count * 16 + (
            len(bloom_words) * 4 if bloom_words is not None else 0
        )
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

    def buckets(self):
        """Host-side interpolation-bucket table (IndexSnapshot's exact
        construction), built once per segment and cached — refreshes
        re-upload columns but never redo this searchsorted."""
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


# --- the plain version ---
def _ragged_dispatch_torch(steps, keys, offs, sizes, bloom, u32p, i32p, with_index=False):
    """_ragged_dispatch in torch ops: bloom pre-filter (2 word gathers +
    bit tests per probe) collapses filtered probes' ranges to empty, then
    the shared bounded search answers every probe against its own
    segment's rows. keys int64[N] (u64 bits); offs, sizes, bloom int32 (u32
    bits); u32p int32[4, P] and i32p int32[5, P] as packed. with_index
    adds each probe's final row and its bloom verdict (for byte counts)."""
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


# --- the CUDA kernel ---
_LIB = None
_LIB_LOCK = threading.Lock()


def _kernel_lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from ._build import load_library

            lib = load_library("ragged_lookup")
            lib.ragged_lookup.restype = ctypes.c_int
            lib.ragged_lookup.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p,
            ]
            _LIB = lib
        return _LIB


def _ragged_lookup_cuda(keys, offs, sizes, bloom, u32p, i32p, out=None):
    """Launch K2 on the current stream over a generation's columns on the
    card -> (offset int32[P], size int32[P], found uint8[P]). Not
    synchronised."""
    global KERNEL_LAUNCHES
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
        KERNEL_LAUNCHES += 1
    return out


def ragged_dispatch(gen: "_Generation", u32p: torch.Tensor, i32p: torch.Tensor, out=None):
    """One dispatch over `gen`: K2 for a generation on the card (or a
    raise), the plain version for one on the CPU."""
    if gen.keys.device.type == "cuda":
        return _ragged_lookup_cuda(
            gen.keys, gen.offs, gen.sizes, gen.bloom, u32p, i32p, out=out
        )
    return _ragged_dispatch_torch(
        gen.steps, gen.keys, gen.offs, gen.sizes, gen.bloom, u32p, i32p
    )


class _Generation:
    """One immutable device-resident arena build. Dispatches capture a
    reference and keep using it even if the arena swaps underneath."""

    __slots__ = (
        "gen_id", "keys", "offs", "sizes", "bloom", "steps",
        "seg", "rows", "nbytes", "built_s",
    )

    def __init__(self, gen_id, segments, device: torch.device):
        t0 = time.perf_counter()
        self.gen_id = gen_id
        self.seg = {}  # handle -> (ArenaSegment, base_row, bloom_base_word)
        rows = 0
        bloom_words = 1  # word 0 = sentinel for filterless probes
        steps = 1
        for s in segments:
            base = rows
            bbase = -1
            if s.bloom_words is not None and s.bloom_mbits:
                bbase = bloom_words
                bloom_words += len(s.bloom_words)
            s.buckets()  # refine s.steps before taking the max
            steps = max(steps, s.steps)
            self.seg[s.handle] = (s, base, bbase)
            rows += -(-max(s.count, 1) // PAGE) * PAGE  # page-aligned
        self.rows = rows
        n = max(MIN_ROWS, 1 << max(0, (rows - 1)).bit_length())
        w = 1 << max(0, (bloom_words - 1)).bit_length()
        keys = np.zeros(n, dtype=np.uint64)
        offs = np.zeros(n, dtype=np.uint32)
        sizes = np.zeros(n, dtype=np.uint32)
        bloom = np.zeros(w, dtype=np.uint32)
        for s, base, bbase in self.seg.values():
            keys[base : base + s.count] = np.asarray(s.keys, dtype=np.uint64)
            offs[base : base + s.count] = np.asarray(s.offs, dtype=np.uint32)
            sizes[base : base + s.count] = np.asarray(s.sizes, dtype=np.uint32)
            if bbase >= 0:
                bloom[bbase : bbase + len(s.bloom_words)] = s.bloom_words
        if device.type == "cuda":
            # built on this thread's own stream and complete before the
            # caller swaps it in (the JAX package's block_until_ready)
            stream = thread_stream(device)
            with torch.cuda.stream(stream):
                self._upload(keys, offs, sizes, bloom, device)
            stream.synchronize()
        else:
            self._upload(keys, offs, sizes, bloom, device)
        self.steps = steps
        self.nbytes = (4 * n) * 4 + 4 * w
        self.built_s = time.perf_counter() - t0

    def _upload(self, keys, offs, sizes, bloom, device) -> None:
        self.keys = column_tensor(keys, torch.int64, device)
        self.offs = column_tensor(offs, torch.int32, device)
        self.sizes = column_tensor(sizes, torch.int32, device)
        self.bloom = column_tensor(bloom, torch.int32, device)


def pack_members(gen: _Generation, members, u32p: np.ndarray, i32p: np.ndarray) -> list:
    """Pack a dispatch's probe planes on the host, as the JAX package's
    _dispatch_members does: slot block per (group, segment), rank-major.
    members: [(group index, segments newest-first, keys u64)]; u32p
    uint32[4, total] and i32p int32[5, total] (total = sum of K * R), every
    entry written. Returns [(group index, base slot, K, R)]."""
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
            seg, base, bbase = gen.seg[s.handle]
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


# the probe planes of one dispatch: u32p [4, P] and i32p [5, P]
_PLANES = ((4, torch.int32), (5, torch.int32))


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
                "resident_rows": gen.rows if gen else 0,
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

    def _staging(self, total: int) -> Staging:
        st = getattr(self._local, "staging", None)
        if st is None or st.cap < total:
            st = self._local.staging = Staging(
                self.device, max(total, 64, st.cap if st else 0), _PLANES
            )
        return st

    def _dispatch_members(self, gen, members, results, timings) -> None:
        t0 = time.perf_counter()
        total = sum(len(keys) * len(segments) for _gi, segments, keys in members)
        st = self._staging(total)
        u32_t, i32_t = st.inputs(total)
        blocks = pack_members(gen, members, u32_t.numpy().view(np.uint32), i32_t.numpy())
        t1 = time.perf_counter()
        if self.device.type == "cuda":
            stream = thread_stream(self.device)
            with torch.cuda.stream(stream):
                u32_d, i32_d = st.upload(total)
                if timings is not None:
                    # barrier only when stage walls are being measured
                    stream.synchronize()
                t2 = time.perf_counter()
                ragged_dispatch(gen, u32_d, i32_d, out=st.results(total))
                if timings is not None:
                    stream.synchronize()
                t3 = time.perf_counter()
                off_t, size_t, found_t = st.download(total)
            # `gen` stays referenced until this stream has finished with
            # its columns
            stream.synchronize()
            off_h = off_t.numpy().view(np.uint32)
            size_h = size_t.numpy().view(np.uint32)
            found_h = found_t.numpy().view(bool)
        else:
            t2 = time.perf_counter()
            off_d, size_d, found_d = ragged_dispatch(gen, u32_t, i32_t)
            t3 = time.perf_counter()
            off_h = off_d.numpy().view(np.uint32)
            size_h = size_d.numpy().view(np.uint32)
            found_h = found_d.numpy()
        for gi, base_slot, K, R in blocks:
            fm = found_h[base_slot : base_slot + K * R].reshape(R, K)
            om = off_h[base_slot : base_slot + K * R].reshape(R, K)
            sm = size_h[base_slot : base_slot + K * R].reshape(R, K)
            rank = np.argmax(fm, axis=0)  # first (newest) hit
            cols = np.arange(K)
            results[gi] = {
                "found": fm.any(axis=0),
                "rank": rank.astype(np.int32),
                "off": om[rank, cols],
                "size": sm[rank, cols],
            }
        t4 = time.perf_counter()
        with self._lock:
            self.counters["dispatches"] += 1
            self.counters["probes"] += total
        m = _metrics()
        m.NEEDLE_MAP_DEVICE_DISPATCHES.inc()
        m.NEEDLE_MAP_DEVICE_PROBES.inc(total)
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
