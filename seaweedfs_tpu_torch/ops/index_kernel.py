"""Bulk needle-index probes, fid -> (offset, size): CUDA kernel + plain torch.

Replaces CompactMap's per-request binary search (ref: weed/storage/
needle_map/compact_map.go:145-172) for bulk and EC reads: the sorted index
snapshot is uploaded once, and each batch of probes runs as one search on
the card.

The search is interpolation-bucketed exactly as the JAX package builds it
(seaweedfs_tpu/ops/index_kernel.py:147-174): at build time the key range
is cut into ~2n equal-width buckets (at most 2^25) and `starts =
searchsorted(keys, bucket_boundaries)` is precomputed on the host, so a
probe searches only its bucket's [starts[b], starts[b+1]) range, in
`bsteps` rounds (ceil(log2) of the largest bucket's occupancy, + 1).

Two implementations of the same function live here:

- the kernel K1 (csrc/index_search.cu, built by _build.py): launched for
  tensors on a CUDA device through _index_search_cuda, which counts its
  launches in KERNEL_LAUNCHES. It computes each probe's bucket itself;
- the plain versions (_bulk_lookup_torch, _bulk_lookup_bucketed_torch),
  which run the JAX programs' fixed-step search with torch ops, bucket
  computed on the host as the JAX package does. They are taken only for
  tensors on the CPU; the tests run them against the JAX programs, and
  chip_smoke.py holds the kernel against them on the card.

The snapshot is one table of 16-byte rows, `rows` int64[n, 2]: word 0
holds the key's u64 bits, word 1 the offset in its low and the size in its
high 32 bits, so the kernel's every search step loads a key with its
payload. `keys`, `offsets` and `sizes` are strided views of it, which the
plain versions read as columns.

Keys are u64. torch on the CPU has no unsigned 64-bit comparison, so keys
are int64 tensors holding the u64 bits, and the plain versions compare
them sign-biased (`x ^ (1 << 63)` orders as the unsigned value). Offsets
and sizes are u32 bits in int32 tensors.
"""

from __future__ import annotations

import ctypes
import threading
import warnings
from typing import Optional

import numpy as np
import torch

from .gf256 import resolve_device

_SIGN = -(1 << 63)  # int64 with only the top bit set: x ^ _SIGN biases x

# launches of the CUDA kernel since the process started (or the caller
# last reset it); the plain versions never touch it
KERNEL_LAUNCHES = 0
_LAUNCH_LOCK = threading.Lock()


# --- the plain versions ---
def _search_range_bounded_torch(
    steps: int, keys, offsets, sizes, probes, lo, hi, end, with_index=False
):
    """The shared search body (index_kernel.py::_search_range_bounded):
    `steps` rounds of branchless lower-bound search of each probe in its
    own [lo, hi), found only below its exclusive `end`. Gathers clamp
    their index into the column, as XLA's do. Returns (off, size, found)
    and, with_index, the row each probe landed on."""
    n = keys.shape[0]
    pk = probes ^ _SIGN
    lo = lo.to(torch.int64)
    hi = hi.to(torch.int64)
    for _ in range(steps):
        mid = (lo + hi) // 2
        less = (keys[mid.clamp(max=n - 1)] ^ _SIGN) < pk
        lo, hi = torch.where(less, mid + 1, lo), torch.where(less, hi, mid)
    idx = lo.clamp(max=n - 1)
    found = (lo < end) & (keys[idx] == probes)
    zero = torch.zeros((), dtype=offsets.dtype, device=offsets.device)
    out = (
        torch.where(found, offsets[idx], zero),
        torch.where(found, sizes[idx], zero),
        found,
    )
    return out + (idx,) if with_index else out


def _bulk_lookup_torch(steps: int, keys, offsets, sizes, probes):
    """Plain version of index_kernel.py::_bulk_lookup: the whole table."""
    n = keys.shape[0]
    lo = torch.zeros(probes.shape, dtype=torch.int64, device=probes.device)
    return _search_range_bounded_torch(
        steps, keys, offsets, sizes, probes, lo, torch.full_like(lo, n), n
    )


def _bulk_lookup_bucketed_torch(steps: int, keys, offsets, sizes, starts, probes, bucket):
    """Plain version of index_kernel.py::_bulk_lookup_bucketed: each probe
    in its bucket's [starts[b], starts[b+1])."""
    bucket = bucket.to(torch.int64)
    return _search_range_bounded_torch(
        steps, keys, offsets, sizes, probes,
        starts[bucket], starts[bucket + 1], keys.shape[0],
    )


# --- the CUDA kernel ---
_LIB = None
_LIB_LOCK = threading.Lock()


def _kernel_lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from ._build import load_library

            lib = load_library("index_search")
            lib.index_search.restype = ctypes.c_int
            lib.index_search.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_ulonglong, ctypes.c_ulonglong, ctypes.c_ulonglong,
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.index_search_registers.restype = ctypes.c_int
            lib.index_search_registers.argtypes = []
            _LIB = lib
        return _LIB


def search_steps(rows: int) -> int:
    """Rounds of the fixed-step search over ranges of at most `rows` rows:
    ceil(log2(rows)) + 1, at least 1."""
    return max(1, (max(rows, 1) - 1).bit_length() + 1)


def bucket_step(kmin: int, kmax: int, nb: int) -> int:
    """Keys a bucket spans when nb buckets cover kmin .. kmax: the ceiling
    of the span over nb, at least 1."""
    return max(1, -(-(kmax - kmin + 1) // nb))


def _check_cuda(name: str, t: torch.Tensor, dtype, device) -> None:
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {dtype} tensor on {device}, got "
            f"{t.dtype} on {t.device}"
            + ("" if t.is_contiguous() else " (not contiguous)")
        )


def _check_rows(rows: torch.Tensor) -> int:
    """Refuse what the kernels do not take as a table -> its row count."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {dev}")
    _check_cuda("rows", rows, torch.int64, dev)
    if rows.dim() != 2 or rows.shape[1] != 2 or rows.data_ptr() % 16:
        raise ValueError(f"rows must be a 16-byte aligned int64 [n, 2] table, "
                         f"got shape {tuple(rows.shape)}")
    n = rows.shape[0]
    if not 1 <= n < 1 << 31:
        raise ValueError(f"the kernel takes 1 to 2^31-1 rows, got {n}")
    return n


def _index_search_cuda(
    rows: torch.Tensor,
    starts: Optional[torch.Tensor],
    kmin: int,
    bstep: int,
    nb: int,
    probes: torch.Tensor,
    out: Optional[tuple] = None,
):
    """Launch K1 on the current stream: probes int64[P] (u64 bits) on the
    rows' CUDA device -> (offset int32[P], size int32[P], found uint8[P]).
    `rows` is an IndexSnapshot's int64[n, 2] table; `starts` None searches
    the whole table. Not synchronised."""
    global KERNEL_LAUNCHES
    n = _check_rows(rows)
    dev = rows.device
    _check_cuda("probes", probes, torch.int64, dev)
    if probes.dim() != 1:
        raise ValueError("probes must be 1-D")
    if starts is not None:
        _check_cuda("starts", starts, torch.int32, dev)
        if starts.shape != (nb + 1,) or bstep < 1:
            raise ValueError(f"starts must hold nb + 1 = {nb + 1} rows, bstep >= 1")
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
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.index_search(
            rows.data_ptr(), n, starts.data_ptr() if starts is not None else None,
            kmin, bstep, nb, probes.data_ptr(), p,
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"index_search kernel launch failed: CUDA error {rc}")
    with _LAUNCH_LOCK:
        KERNEL_LAUNCHES += 1
    return out


# --- host staging ---
_STREAMS = threading.local()


def thread_stream(device: torch.device) -> torch.cuda.Stream:
    """This thread's own CUDA stream on `device` (created on first use):
    concurrent lookups from executor threads never wait on each other."""
    streams = getattr(_STREAMS, "by_device", None)
    if streams is None:
        streams = _STREAMS.by_device = {}
    s = streams.get(device.index)
    if s is None:
        s = streams[device.index] = torch.cuda.Stream(device)
    return s


def column_tensor(arr: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A column's bits as a torch tensor on `device`, always a copy that
    owns its memory: callers hand in mmap'd run columns, which close with
    their run."""
    np_dtype = {torch.int64: np.int64, torch.int32: np.int32}[dtype]
    arr = np.ascontiguousarray(arr).view(np_dtype)
    if device.type == "cpu":
        return torch.from_numpy(arr.copy())
    with warnings.catch_warnings():
        # a read-only mmap: the upload copies it, nothing writes through
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(arr).to(device)


_RESULT_DTYPES = (torch.int32, torch.int32, torch.uint8)  # offset, size, found


class Staging:
    """Probe planes and result buffers for one caller at a time, holding up
    to `cap` probes: pinned host planes with device twins and pinned
    (offset, size, found) readback on the card, host planes alone on the
    CPU. `planes` gives each input plane as (rows, dtype); a plane of one
    row is 1-D, others are [rows, P]."""

    def __init__(self, device: torch.device, cap: int, planes):
        self.cap = cap
        self.shapes = tuple(planes)
        pin = device.type == "cuda"
        self.host = [torch.empty(r * cap, dtype=dt, pin_memory=pin) for r, dt in self.shapes]
        if pin:
            self.dev = [torch.empty(r * cap, dtype=dt, device=device) for r, dt in self.shapes]
            self.dev_out = tuple(torch.empty(cap, dtype=dt, device=device) for dt in _RESULT_DTYPES)
            self.host_out = tuple(torch.empty(cap, dtype=dt, pin_memory=True) for dt in _RESULT_DTYPES)

    def _views(self, bufs, p: int) -> list:
        return [b[: r * p].view(r, p) if r > 1 else b[:p] for b, (r, _dt) in zip(bufs, self.shapes)]

    def inputs(self, p: int) -> list:
        """The host planes for p probes, to be written in place."""
        return self._views(self.host, p)

    def upload(self, p: int) -> list:
        """Queue the host planes' copy to the card on the current stream ->
        the device planes."""
        dev = self._views(self.dev, p)
        for d, h in zip(dev, self.inputs(p)):
            d.copy_(h, non_blocking=True)
        return dev

    def results(self, p: int) -> tuple:
        """The device (offset, size, found) buffers for p probes."""
        return tuple(t[:p] for t in self.dev_out)

    def download(self, p: int) -> tuple:
        """Queue the results' copy back on the current stream -> the pinned
        host (offset, size, found), valid once the stream has synchronised."""
        host = tuple(t[:p] for t in self.host_out)
        for h, d in zip(host, self.results(p)):
            h.copy_(d, non_blocking=True)
        return host


_PROBE_PLANES = ((1, torch.int64),)  # u64 probe keys


class IndexSnapshot:
    """Device-resident sorted index for bulk probes.

    Built from a CompactMap/NeedleMap snapshot() (sorted live entries).
    `device` is the card unless the caller asks for the CPU (which runs
    the plain version); it raises when CUDA is asked for and absent.
    """

    # below this size the bucket table isn't worth building
    MIN_BUCKETED = 4096
    MAX_BUCKETS = 1 << 25

    @classmethod
    def bucketable(cls, n: int, kmin: int, kmax: int) -> bool:
        """Whether a sorted table of n keys from kmin to kmax gets a bucket
        table: not a tiny one, and not a key span that would overflow the
        u64 boundary arithmetic (the top boundary is < kmax + 1 + nb)."""
        return (n >= cls.MIN_BUCKETED and 0 < kmax - kmin + 1 < 1 << 62
                and kmax + 1 + cls.MAX_BUCKETS < 1 << 64)

    @staticmethod
    def prepare_host_columns(keys: np.ndarray, offsets: np.ndarray, sizes: np.ndarray):
        """(keys u64, offsets u32, sizes u32) without copying inputs whose
        dtype already matches (a sealed LSM run's mmap'd columns)."""
        return (
            np.ascontiguousarray(keys, dtype=np.uint64),
            np.asarray(offsets, dtype=np.uint32),
            np.asarray(sizes, dtype=np.uint32),
        )

    def __init__(self, keys: np.ndarray, offsets: np.ndarray, sizes: np.ndarray, device=None):
        assert len(keys) == len(offsets) == len(sizes)
        keys, off_u32, sizes_u32 = self.prepare_host_columns(keys, offsets, sizes)
        self._init_common(len(keys), resolve_device(device))
        self.steps = search_steps(self.n)

        # interpolation buckets (skipped for tiny tables and for key spans
        # that would overflow the u64 boundary arithmetic)
        self.kmin = int(keys[0]) if self.n else 0
        kmax = int(keys[-1]) if self.n else 0
        starts = None
        if self.bucketable(self.n, self.kmin, kmax):
            # ~2 buckets per entry keeps each bucket's occupancy, and so
            # the per-probe search chain, short; the cap bounds the starts
            # table at 128 MiB of device memory
            nb = 1 << max(10, int(np.ceil(np.log2(self.n))) + 1)
            nb = min(nb, self.MAX_BUCKETS)
            self.nb = nb
            self.bstep = bucket_step(self.kmin, kmax, nb)
            boundaries = np.uint64(self.kmin) + np.arange(
                nb, dtype=np.uint64
            ) * np.uint64(self.bstep)
            starts = np.searchsorted(keys, boundaries).astype(np.int32)
            starts = np.append(starts, np.int32(self.n))
            self.bsteps = search_steps(int(np.max(np.diff(starts))))
        self._upload(keys, off_u32, sizes_u32, starts)

    def _init_common(self, n: int, device: torch.device) -> None:
        self.n = n
        self.device = device
        self.kmin = 0
        self.bstep = 1
        self.nb = 0
        self.bsteps = 0
        self.starts = None
        # reusable probe staging: one buffer set per snapshot, grown to the
        # largest batch seen, written in place per call; concurrent probers
        # (two gate flushes overlapping in the executor) can't share it, so
        # the loser of the try-lock allocates its own
        self._stage_lock = threading.Lock()
        self._staging: Optional[Staging] = None

    def _upload(self, keys, off_u32, sizes_u32, starts) -> None:
        dev = self.device
        # one 16-byte row per entry (the kernel's table), and the three
        # columns as strided views of it: each column is uploaded, copied
        # into its view and freed
        self.rows = torch.empty((self.n, 2), dtype=torch.int64, device=dev)
        words = self.rows.view(torch.int32)  # [n, 4]: key lo, key hi, offset, size
        self.keys = self.rows[:, 0]
        self.offsets = words[:, 2]
        self.sizes = words[:, 3]
        for view, col in ((self.keys, keys), (self.offsets, off_u32), (self.sizes, sizes_u32)):
            view.copy_(column_tensor(col, view.dtype, dev))
        if starts is not None:
            self.starts = column_tensor(starts, torch.int32, dev)
        if dev.type == "cuda":
            # lookups run on other threads' streams: the columns must have
            # landed before the snapshot is handed out
            torch.cuda.current_stream(dev).synchronize()

    @classmethod
    def from_columns(
        cls, keys, offsets, sizes, starts, kmin, bstep, nb, bsteps, device=None
    ) -> "IndexSnapshot":
        """A snapshot over given columns and bucket parameters, taken as
        they are (starts None: unbucketed)."""
        keys, off_u32, sizes_u32 = cls.prepare_host_columns(keys, offsets, sizes)
        snap = cls.__new__(cls)
        snap._init_common(len(keys), resolve_device(device))
        snap.steps = search_steps(snap.n)
        if starts is not None:
            snap.kmin, snap.bstep, snap.nb = int(kmin), int(bstep), int(nb)
            snap.bsteps = int(bsteps)
            starts = np.asarray(starts, dtype=np.int32)
        snap._upload(keys, off_u32, sizes_u32, starts)
        return snap

    @classmethod
    def from_map(cls, needle_map, device=None) -> "IndexSnapshot":
        keys, offsets, sizes = needle_map.snapshot()
        return cls(keys, offsets, sizes, device=device)

    def _bucket_of(self, probe_keys: np.ndarray) -> np.ndarray:
        """Host-side bucket index per probe (u64 math; clipped into range),
        as the JAX package stages it for the plain version."""
        p = np.ascontiguousarray(probe_keys, dtype=np.uint64)
        out = np.maximum(p, np.uint64(self.kmin))
        np.subtract(out, np.uint64(self.kmin), out=out)
        np.floor_divide(out, np.uint64(self.bstep), out=out)
        return np.minimum(out, np.uint64(self.nb - 1), out=out)

    def _stage(self, cap: int) -> Staging:
        st = self._staging
        if st is None or st.cap < cap:
            st = self._staging = Staging(self.device, max(cap, 64), _PROBE_PLANES)
        return st

    def lookup(self, probe_keys: np.ndarray):
        """probe_keys u64[P] -> (offset_units u32[P], sizes u32[P], found bool[P])."""
        probe_keys = np.ascontiguousarray(probe_keys, dtype=np.uint64)
        p = len(probe_keys)
        if self.n == 0 or p == 0:
            z = np.zeros(p, dtype=np.uint32)
            return z, z.copy(), np.zeros(p, dtype=bool)
        locked = self._stage_lock.acquire(blocking=False)
        try:
            st = self._stage(p) if locked else Staging(self.device, p, _PROBE_PLANES)
            (keys,) = st.inputs(p)
            np.copyto(keys.numpy().view(np.uint64), probe_keys)
            if self.device.type == "cuda":
                return self._lookup_cuda(st, p)
            return self._lookup_cpu(keys)
        finally:
            if locked:
                self._stage_lock.release()

    def _lookup_cpu(self, probes: torch.Tensor):
        if self.starts is not None:
            bucket = self._bucket_of(probes.numpy().view(np.uint64))
            off, size, found = _bulk_lookup_bucketed_torch(
                self.bsteps, self.keys, self.offsets, self.sizes, self.starts,
                probes, torch.from_numpy(bucket.view(np.int64)),
            )
        else:
            off, size, found = _bulk_lookup_torch(
                self.steps, self.keys, self.offsets, self.sizes, probes
            )
        return (
            off.numpy().view(np.uint32),
            size.numpy().view(np.uint32),
            found.numpy(),
        )

    def _lookup_cuda(self, st: Staging, p: int):
        stream = thread_stream(self.device)
        with torch.cuda.stream(stream):
            (dk,) = st.upload(p)
            _index_search_cuda(
                self.rows, self.starts, self.kmin, self.bstep, self.nb, dk,
                out=st.results(p),
            )
            off, size, found = st.download(p)
        # the readback lands in the staging buffers, which the next call
        # reuses: wait for this stream, then hand back copies
        stream.synchronize()
        return (
            off.numpy().view(np.uint32).copy(),
            size.numpy().view(np.uint32).copy(),
            found.numpy().astype(bool),
        )


def snapshot_from_reference(ref, device=None) -> IndexSnapshot:
    """The port's IndexSnapshot over the columns and bucket parameters of
    a JAX package IndexSnapshot (its device arrays read back as numpy:
    khi, klo, offsets, sizes, starts, kmin, bstep, nb, bsteps), so both
    packages search the same table."""
    khi = np.asarray(ref.khi, dtype=np.uint64)
    klo = np.asarray(ref.klo, dtype=np.uint64)
    keys = (khi << np.uint64(32)) | klo
    starts = getattr(ref, "starts", None)
    if starts is None:
        return IndexSnapshot.from_columns(
            keys, np.asarray(ref.offsets), np.asarray(ref.sizes),
            None, 0, 1, 0, 0, device=device,
        )
    return IndexSnapshot.from_columns(
        keys, np.asarray(ref.offsets), np.asarray(ref.sizes),
        np.asarray(starts), ref.kmin, ref.bstep, ref.nb, ref.bsteps,
        device=device,
    )


from .snapshot_cache import SnapshotCache  # noqa: E402,F401  (re-export)
