"""Vacuum (compaction): copy live needles to shadow files, then commit.

Mirrors the reference's two-phase protocol (ref: weed/storage/volume_vacuum.go):
- compact() / compact2() write .cpd/.cpx shadow files while the volume keeps
  serving writes; the super block's compaction revision is bumped in the copy;
- commit_compact() closes the volume, replays writes that raced compaction
  from the old .idx tail into the shadow files (makeup_diff,
  volume_vacuum.go:181-308), renames .cpd/.cpx over .dat/.idx and reloads.

The vacuum-plane fast path (the compaction analogue of the EC rebuild
pipeline): `compact2` does not re-read, re-parse and re-serialize one
needle at a time. It walks the live index in OFFSET order, coalesces
adjacent live records into multi-megabyte extents, and moves them as raw
bytes with a double-buffered readahead ring (or zero-copy mmap source
views — a one-time measured race picks the host structure), emitting the
key-sorted .cpx in one vectorized pass. Per-stage walls land in
`LAST_VACUUM_STAGES` / the `vacuum_stage_seconds` metric and the executed
structure in `LAST_VACUUM_ROUTE`. Optional CRC verification
(`SEAWEEDFS_TPU_VACUUM_VERIFY` / verify=True) re-parses every copied
record through the same CRC-verifying needle parser the scrubber uses, so
a verified vacuum doubles as a scrub pass over the live set. The
per-needle loop survives as `_copy_naive` — the benchmark baseline and
the fallback for TTL volumes (expiry needs the per-needle timestamps).

Crash safety: `commit_compact` renames .cpd over .dat and then .cpx over
.idx. Volume load (`sweep_compaction_shadows`) repairs every interruption
point: shadows from a compaction that never committed are swept; a crash
between the two renames (new .dat, old .idx, orphan .cpx) is completed by
renaming the .cpx into place.

Ported from the JAX package's storage/vacuum.py; the copy runs on the
host in both packages, and for one volume both write byte-identical
.cpd/.cpx files. Differences: the commit reopens the volume on its
`device` (where bulk_lookup's snapshot lives), and it also removes the
`.ldb` and `.sdx` derived from the old .idx — the sqlite map trusts a
`.ldb` newer than its `.idx`, and the renamed `.cpx` is older than the
`.ldb` the close just touched, so the JAX package's reload keeps the old
offsets. Under an installed fault plan (util/faults.py) the copy takes
the pread route extent by extent through the DiskFile seam, as the JAX
package's does, so injected bit flips, EIO and crashes fire on every byte
it reads and writes.
"""

from __future__ import annotations

import os
import threading
import time

from ..types import (
    NEEDLE_CHECKSUM_SIZE,
    NEEDLE_HEADER_SIZE,
    NEEDLE_MAP_ENTRY_SIZE,
    NEEDLE_PADDING_SIZE,
    TIMESTAMP_SIZE,
    TOMBSTONE_FILE_SIZE,
    VERSION3,
    to_actual_offset,
    to_offset_units,
)
from ..util import faults
from ..util.metrics import SCRUB_BYTES, VACUUM_STAGE_SECONDS
from .backend import DiskFile
from .idx import entries_to_bytes, entry_to_bytes, parse_entry, parse_index_bytes
from .needle import Needle, read_needle_blob, read_needle_data
from .needle_map import MemDb
from .super_block import SuperBlock, read_super_block
from .volume import Volume

# coalesced extents are capped so the readahead ring stays a few buffers
# of bounded size (a single over-sized record still moves in one piece)
EXTENT_TARGET = 4 << 20
# readahead depth of the pread ring: reader stays this many extents ahead
RING_DEPTH = 4

# per-stage walls of the LAST COMPLETED compaction copy in this process
# (plan/read/write/verify/idx/total; the pipelined read overlaps write, so
# stage sums can exceed total). Each copy accumulates into a LOCAL dict
# and swaps it in here atomically on completion — concurrent compactions
# (the master dispatches up to vacuum_concurrency per round) cannot
# interleave half-built breakdowns; per-run numbers travel in the report
# dict `compact2`/`_copy_data_based_on_index_file` return.
LAST_VACUUM_STAGES: dict = {}
# executed structure of the last completed copy: {"route":
# "pread"|"mmap"|"naive", "extents": N, "records": N}
LAST_VACUUM_ROUTE: dict = {}
_STAGES_LOCK = threading.Lock()

_VACUUM_HOST_ROUTE: str | None = None
_VACUUM_ROUTE_LOCK = threading.Lock()


def _stage_add(stages: dict, key: str, dt: float) -> None:
    stages[key] = stages.get(key, 0.0) + dt


def _publish_stages(stages: dict, route_info: dict) -> None:
    """Metrics + module-global snapshot, atomically per completed copy."""
    for stage, v in stages.items():
        if stage.endswith("_s"):
            VACUUM_STAGE_SECONDS.observe(v, stage=stage[:-2])
    with _STAGES_LOCK:
        LAST_VACUUM_STAGES.clear()
        LAST_VACUUM_STAGES.update(stages)
        LAST_VACUUM_ROUTE.clear()
        LAST_VACUUM_ROUTE.update(route_info)


def compact2(
    v: Volume, route: str | None = None, verify: bool | None = None
) -> dict:
    """Copy live data based on the .idx (ref Compact2, volume_vacuum.go:66-89)
    through the extent-coalesced fast path; falls back to the per-needle
    loop for TTL volumes (expiry is a per-record decision). Returns the
    copy report ({route, records, extents, live_bytes, stages}), also
    kept on `v.last_vacuum_report`."""
    _begin_compaction(v)
    try:
        base = v.file_name()
        v.last_compact_index_offset = v.index_file_size()
        v.last_compact_revision = v.super_block.compaction_revision
        v.sync()
        try:
            report = _copy_data_based_on_index_file(
                base + ".dat", base + ".idx", base + ".cpd", base + ".cpx",
                v.super_block, v.version, route=route, verify=verify,
            )
        except CorruptLiveRecord as e:
            # a verified vacuum found bit rot in the LIVE set: abandon the
            # compaction (shadows removed) and quarantine like a scrub hit
            cleanup_compact(v)
            v.quarantine(f"vacuum verify: {e}")
            raise
        v.last_vacuum_report = report
        return report
    finally:
        v.is_compacting = False


def _begin_compaction(v: Volume) -> None:
    """Atomic check-and-set of the compaction flag: the master has
    several independent dispatch paths (auto loop, /vol/vacuum, -run),
    and two compact2 threads interleaving writes into one volume's
    shadow pair would corrupt the copy a later commit renames live."""
    with v._lock:
        if v.is_compacting:
            raise RuntimeError(f"volume {v.id} is already compacting")
        if v.scrub_corrupt:
            # quarantined evidence must never be rewritten by vacuum —
            # the repair plane owns this volume
            raise PermissionError(f"volume {v.id} is quarantined")
        v.is_compacting = True


def compact(v: Volume) -> None:
    """Copy live data by scanning the .dat (ref Compact, volume_vacuum.go:37-63)."""
    _begin_compaction(v)
    try:
        _compact_scan(v)
    finally:
        v.is_compacting = False


def _compact_scan(v: Volume) -> None:
    base = v.file_name()
    v.last_compact_index_offset = v.index_file_size()
    v.last_compact_revision = v.super_block.compaction_revision
    v.sync()

    dst = DiskFile(base + ".cpd", create=True)
    dst.truncate(0)
    sb = SuperBlock(
        version=v.super_block.version,
        replica_placement=v.super_block.replica_placement,
        ttl=v.super_block.ttl,
        compaction_revision=v.super_block.compaction_revision + 1,
        extra=v.super_block.extra,
    )
    dst.write_at(sb.to_bytes(), 0)
    new_offset = sb.block_size()
    nm = MemDb()
    now = time.time()

    def visit(n: Needle, offset: int, body: bytes) -> None:
        nonlocal new_offset
        if n.has_ttl() and n.ttl is not None and now >= n.last_modified + v.ttl.minutes * 60:
            return
        nv = v.nm.get(n.id)
        if (
            nv is not None
            and to_actual_offset(nv.offset_units) == offset
            and nv.size > 0
            and nv.size != TOMBSTONE_FILE_SIZE
        ):
            nm.set(n.id, to_offset_units(new_offset), n.size)
            blob, _, actual = n.to_bytes(v.version)
            dst.write_at(blob, new_offset)
            new_offset += actual

    v.scan(visit, read_body=True)
    dst.close()
    nm.save_to_idx(base + ".cpx")


def commit_compact(v: Volume) -> Volume:
    """Swap shadow files in, absorbing racing writes; returns the reloaded
    volume (ref CommitCompact, volume_vacuum.go:91-156). On failure the
    old volume object keeps `is_compacting` CLEARED — a transient commit
    error must not wedge every future `_begin_compaction` retry."""
    base = v.file_name()
    v.is_compacting = True
    try:
        with v._lock:
            v.close()
            try:
                _makeup_diff(
                    v, base + ".cpd", base + ".cpx", base + ".dat",
                    base + ".idx",
                )
            except Exception:
                # .cpx FIRST: a crash between the two removes must never
                # leave ".cpx alone", which the load-time sweep reads as
                # the half-committed state and renames over the real .idx
                for ext in (".cpx", ".cpd"):
                    try:
                        os.remove(base + ext)
                    except FileNotFoundError:
                        pass  # a concurrent cleanup already swept it
                raise
            os.rename(base + ".cpd", base + ".dat")
            os.rename(base + ".cpx", base + ".idx")
            # the .idx was just replaced wholesale: any persisted lsm
            # needle-map snapshot folds a prefix of the OLD log and must
            # not survive the swap (the reload below would otherwise
            # lean on the last-entry binding alone to reject it)
            from .needle_map.lsm_map import invalidate_snapshot

            invalidate_snapshot(base)
            # nor may the sqlite and sorted-file maps' derived files: they
            # count as fresh while their mtime is newer than the .idx's,
            # and the renamed .cpx is older than the .ldb that close() just
            # touched — the reload would serve the old offsets
            for ext in (".ldb", ".sdx"):
                try:
                    os.remove(base + ext)
                except FileNotFoundError:
                    pass
    finally:
        v.is_compacting = False
    return Volume(
        v.dir,
        v.collection,
        v.id,
        create=False,
        needle_map_kind=v.needle_map_kind,
        device=v.device,
    )


def cleanup_compact(v: Volume) -> None:
    base = v.file_name()
    # .cpx before .cpd: ".cpx alone" must stay unambiguous (see
    # sweep_compaction_shadows — it means the commit's first rename ran)
    for ext in (".cpx", ".cpd"):
        try:
            os.remove(base + ext)
        except FileNotFoundError:
            pass


def sweep_compaction_shadows(base: str) -> str | None:
    """Repair the on-disk state a compaction interrupted at ANY point left
    behind (called on volume load, like the EC rebuild's stale `.ecNN.tmp`
    sweep):

    - `.cpd` present (with or without `.cpx`): the compaction never reached
      the first commit rename — the live `.dat`/`.idx` are authoritative
      and the shadows are swept;
    - `.cpx` alone: the process died between `rename(.cpd -> .dat)` and
      `rename(.cpx -> .idx)` — the `.dat` IS the committed copy and the
      old `.idx` describes a file that no longer exists, so the commit is
      completed by renaming the `.cpx` into place.

    Returns "swept", "completed" or None (nothing to do)."""
    cpd, cpx = base + ".cpd", base + ".cpx"
    has_cpd, has_cpx = os.path.exists(cpd), os.path.exists(cpx)
    if not has_cpd and not has_cpx:
        return None
    if has_cpd:
        # .cpx first, so a crash mid-sweep cannot manufacture the
        # ".cpx alone" (= half-committed) state out of dead shadows
        for path in (cpx, cpd):
            try:
                os.remove(path)
            except FileNotFoundError:
                pass
        return "swept"
    # .cpx only: finish the interrupted commit
    os.replace(cpx, base + ".idx")
    return "completed"


class CorruptLiveRecord(Exception):
    """A verified vacuum re-parsed a live record and its CRC failed: the
    LIVE set carries bit rot. Compaction must not silently drop (or
    silently propagate) the record — surface it like a scrub finding."""


class _WriteBatcher:
    """Sequential-write aggregator: the destination of a compaction is
    written strictly in order, so many small extents (a fragmented volume
    where nothing coalesces — alternating live/dead records) can share one
    large write. Small extents are staged into a reused buffer flushed at
    EXTENT_TARGET; an extent already at/over the staging size bypasses the
    copy and writes directly. This is what keeps the fast path fast in the
    WORST coalescing case: syscalls per live byte drop by ~1000x."""

    __slots__ = ("_dst", "_buf", "_fill", "_off")

    def __init__(self, dst, start_off: int):
        self._dst = dst
        self._buf = bytearray(EXTENT_TARGET)
        self._fill = 0
        self._off = start_off

    def add(self, data) -> None:
        width = len(data)
        if self._fill and self._fill + width > EXTENT_TARGET:
            self.flush()
        if width >= EXTENT_TARGET:
            self._dst.write_at(data, self._off)
            self._off += width
            return
        self._buf[self._fill : self._fill + width] = data
        self._fill += width

    def flush(self) -> None:
        if self._fill:
            self._dst.write_at(
                memoryview(self._buf)[: self._fill], self._off
            )
            self._off += self._fill
            self._fill = 0


# ------------------------------------------------ extent-coalesced copy --


def _calibrate_vacuum_route() -> str:
    """Race the two copy structures once per process on a synthetic extent
    set and remember the winner: 'pread' (double-buffered readahead ring
    into reused buffers) or 'mmap' (zero-copy source views). Same
    rationale as the rebuild plane's route race: the ranking is
    hardware-dependent (guest-fault-path cost vs buffer-copy cost) and a
    measured race picks reliably where a point probe flip-flops.
    `SEAWEEDFS_TPU_VACUUM_ROUTE` forces a route without racing."""
    global _VACUUM_HOST_ROUTE
    forced = os.environ.get("SEAWEEDFS_TPU_VACUUM_ROUTE", "")
    if forced in ("pread", "mmap"):
        return forced
    if _VACUUM_HOST_ROUTE is not None:
        return _VACUUM_HOST_ROUTE
    with _VACUUM_ROUTE_LOCK:
        if _VACUUM_HOST_ROUTE is not None:
            return _VACUUM_HOST_ROUTE
        import shutil
        import tempfile

        size = 32 << 20
        use_dir = "/dev/shm" if os.path.isdir("/dev/shm") else None
        if use_dir is not None:
            try:
                if shutil.disk_usage(use_dir).free < size * 3:
                    use_dir = None
            except OSError:
                use_dir = None
        d = None
        try:
            d = tempfile.mkdtemp(prefix="vacuum_cal_", dir=use_dir)
            src_path = os.path.join(d, "src.dat")
            block = b"\xa5\x5a\xc3" * (1 << 20)
            with open(src_path, "wb") as f:
                left = size
                while left > 0:
                    f.write(block[: min(left, len(block))])
                    left -= len(block)
            # synthetic live set mixing both fragmentation regimes: large
            # coalesced runs (1MB extents, 64KB gaps) over the first half
            # and heavy fragmentation (8KB extents, 8KB gaps — nothing
            # coalesces) over the second, so the race rewards the route
            # that handles BOTH shapes
            extents = []
            off = 0
            while off + (1 << 20) <= size // 2:
                extents.append((off, 1 << 20))
                off += (1 << 20) + (64 << 10)
            off = size // 2
            while off + (8 << 10) <= size:
                extents.append((off, 8 << 10))
                off += 16 << 10
            best = ("pread", 0.0)
            for rep in range(2):
                order = ("pread", "mmap") if rep % 2 == 0 else ("mmap", "pread")
                for name in order:
                    dst_path = os.path.join(d, f"dst_{name}.dat")
                    t0 = time.perf_counter()
                    try:
                        dst = DiskFile(dst_path, create=True)
                        try:
                            if name == "pread":
                                _copy_extents_pread(
                                    src_path, dst, extents, 0, None, False,
                                    None, 0,
                                )
                            else:
                                _copy_extents_mmap(
                                    src_path, dst, extents, 0, None, False,
                                    None, 0,
                                )
                        finally:
                            dst.close()
                    except Exception:
                        continue
                    g = sum(w for _o, w in extents) / max(
                        time.perf_counter() - t0, 1e-9
                    )
                    if g > best[1]:
                        best = (name, g)
            _VACUUM_HOST_ROUTE = best[0]
        except Exception:
            _VACUUM_HOST_ROUTE = "pread"
        finally:
            if d is not None:
                shutil.rmtree(d, ignore_errors=True)
        return _VACUUM_HOST_ROUTE


def _live_entries(src_idx: str, version: int):
    """Replay the .idx log (newest entry wins) and return the live set as
    numpy columns plus per-record on-disk lengths: (keys u64[n],
    offsets i64[n] actual bytes, sizes u32[n], rec_bytes i64[n]).
    Fully vectorized: "newest wins" is each key's LAST occurrence, which
    np.unique over the reversed key column hands back directly."""
    import numpy as np

    with open(src_idx, "rb") as f:
        raw = f.read()
    keys, offsets, sizes = parse_index_bytes(raw)
    n = len(keys)
    if n == 0:
        z = np.zeros(0, dtype=np.int64)
        return keys, z, sizes, z
    uniq_keys, rev_first = np.unique(keys[::-1], return_index=True)
    last = n - 1 - rev_first  # index of each key's newest entry
    off_units = offsets[last].astype(np.int64)
    sz = sizes[last]
    alive = (off_units != 0) & (sz != np.uint32(TOMBSTONE_FILE_SIZE))
    k = uniq_keys[alive]
    off_actual = off_units[alive] * NEEDLE_PADDING_SIZE
    sz = sz[alive]
    base = (
        NEEDLE_HEADER_SIZE
        + sz.astype(np.int64)
        + NEEDLE_CHECKSUM_SIZE
        + (TIMESTAMP_SIZE if version == VERSION3 else 0)
    )
    rec = base + (NEEDLE_PADDING_SIZE - base % NEEDLE_PADDING_SIZE)
    return k, off_actual, sz, rec


def _coalesce(src_offs, rec_bytes) -> list[tuple[int, int]]:
    """Merge OFFSET-SORTED adjacent records into extents of up to
    EXTENT_TARGET bytes -> [(src_offset, width)]."""
    extents: list[tuple[int, int]] = []
    start = None
    width = 0
    for off, rec in zip(src_offs.tolist(), rec_bytes.tolist()):
        if start is not None and off == start + width and width < EXTENT_TARGET:
            width += rec
            continue
        if start is not None:
            extents.append((start, width))
        start, width = off, rec
    if start is not None:
        extents.append((start, width))
    return extents


def _verify_extent(
    buf, src_off: int, entries, version: int
) -> None:
    """Re-parse every record inside one copied extent through the
    CRC-verifying needle parser (the scrubber's check, applied to the
    bytes vacuum is about to re-home). `entries` is the (key, src_offset,
    size, rec_bytes) rows that fall inside this extent."""
    mv = memoryview(buf)
    for key, off, size, rec in entries:
        rel = off - src_off
        blob = mv[rel : rel + rec]
        try:
            n = Needle()
            n.read_bytes(blob, off, size, version)
        except Exception as e:
            raise CorruptLiveRecord(
                f"record key {key:#x} at {off} failed verification: {e}"
            ) from None
        if n.id != key:
            raise CorruptLiveRecord(
                f"record at {off} carries id {n.id:#x}, index says {key:#x}"
            )
    SCRUB_BYTES.inc(len(buf), kind="vacuum")


# span planning: dead bytes are worth reading through when that fuses
# syscalls — but never more dead than live (amplification <= 2x) and never
# a single gap beyond this (a truly dead region is just skipped)
SPAN_GAP_TOLERANCE = 1 << 20
SPAN_TARGET = 2 * EXTENT_TARGET


def _span_batches(
    extents: list[tuple[int, int]]
) -> list[tuple[int, int, int, int]]:
    """Group consecutive extents into contiguous READ SPANS ->
    [(span_start, span_width, i_lo, i_hi)] (extent index range, i_hi
    exclusive). A span is pread/faulted in one piece — small dead gaps
    are read through and dropped by the gather — so the syscall count
    scales with spans, not records."""
    spans: list[tuple[int, int, int, int]] = []
    if not extents:
        return spans
    i_lo = 0
    span_start, width = extents[0]
    live = width
    for i in range(1, len(extents)):
        off, w = extents[i]
        gap = off - (span_start + width)
        new_width = off + w - span_start
        dead = new_width - (live + w)
        if (
            gap > SPAN_GAP_TOLERANCE
            or new_width > SPAN_TARGET
            or dead > live
        ):
            spans.append((span_start, width, i_lo, i))
            i_lo, span_start, live = i, off, w
            width = w
            continue
        width = new_width
        live += w
    spans.append((span_start, width, i_lo, len(extents)))
    return spans


def _emit_span(
    span_buf,
    span_start: int,
    extents: list[tuple[int, int]],
    i_lo: int,
    i_hi: int,
    batcher: "_WriteBatcher",
    verify: bool,
    verify_rows,
    version: int,
    stages: dict,
) -> None:
    """Writer-side half of one span: optionally CRC-verify each record in
    place, then squeeze the live bytes out (each extent is one C-level
    slice copy into the batcher's staging buffer — the dead gaps simply
    are not copied) and hand them to the sequential write batcher. A
    gap-free span skips the per-extent loop entirely."""
    mv = memoryview(span_buf)
    try:
        if verify:
            t0 = time.perf_counter()
            for i in range(i_lo, i_hi):
                off, width = extents[i]
                rel = off - span_start
                _verify_extent(
                    mv[rel : rel + width], off, verify_rows[i], version
                )
            _stage_add(stages, "verify_s", time.perf_counter() - t0)
        t0 = time.perf_counter()
        if i_hi - i_lo == 1 and extents[i_lo][1] == len(span_buf):
            batcher.add(mv)  # gap-free span: already the dst byte image
        else:
            for i in range(i_lo, i_hi):
                off, width = extents[i]
                rel = off - span_start
                batcher.add(mv[rel : rel + width])
        _stage_add(stages, "write_s", time.perf_counter() - t0)
    finally:
        mv.release()


def _copy_extents_pread(
    src_path: str,
    dst,
    extents: list[tuple[int, int]],
    dst_start: int,
    verify_rows,
    verify: bool,
    bucket,
    version: int,
    stages: dict | None = None,
) -> None:
    """Double-buffered readahead ring: a reader thread preads whole SPANS
    (consecutive extents plus bounded dead gaps — one syscall per
    multi-MB span instead of one per record) while the main thread
    verifies (optionally), gathers the live bytes in one vectorized pass
    and writes them IN ORDER. With an active fault plan the reader goes
    through the DiskFile read seam extent by extent instead, so injected
    bitflips/EIO/crashes fire exactly as on any other read."""
    import queue as _queue

    if stages is None:
        stages = {}  # calibration runs without a stage sink
    done = object()
    ring: _queue.Queue = _queue.Queue(maxsize=RING_DEPTH)
    stop = threading.Event()
    seam = faults._PLAN is not None
    if seam:
        spans = [
            (extents[i][0], extents[i][1], i, i + 1)
            for i in range(len(extents))
        ]
    else:
        spans = _span_batches(extents)

    def put(item) -> None:
        while not stop.is_set():
            try:
                ring.put(item, timeout=0.05)
                return
            except _queue.Full:
                continue

    def reader() -> None:
        fd = None
        src = None
        try:
            if seam:
                src = DiskFile(src_path, create=False, read_only=True)
            else:
                fd = os.open(src_path, os.O_RDONLY)
            for si, (span_start, width, i_lo, i_hi) in enumerate(spans):
                if stop.is_set():
                    return
                t0 = time.perf_counter()
                if seam:
                    buf = src.read_at(width, span_start)
                    if len(buf) < width:
                        raise IOError(
                            f"short read at {span_start}: "
                            f"{len(buf)} < {width}"
                        )
                else:
                    buf = bytearray(width)
                    mv = memoryview(buf)
                    pos = 0
                    while pos < width:
                        n = os.preadv(fd, [mv[pos:width]], span_start + pos)
                        if n == 0:
                            raise IOError(f"short read at {span_start}")
                        pos += n
                    mv.release()
                _stage_add(stages, "read_s", time.perf_counter() - t0)
                put((si, buf))
            put(done)
        except BaseException as e:  # incl. SimulatedCrash (BaseException)
            put(e)
        finally:
            if src is not None:
                src.close()
            if fd is not None:
                os.close(fd)

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    batcher = _WriteBatcher(dst, dst_start)
    try:
        while True:
            item = ring.get()
            if item is done:
                break
            if isinstance(item, BaseException):
                raise item
            si, buf = item
            span_start, width, i_lo, i_hi = spans[si]
            if bucket is not None:
                bucket.consume(width)
            _emit_span(
                buf, span_start, extents, i_lo, i_hi, batcher, verify,
                verify_rows, version, stages,
            )
        t0 = time.perf_counter()
        batcher.flush()
        _stage_add(stages, "write_s", time.perf_counter() - t0)
    finally:
        stop.set()
        t.join()


def _copy_extents_mmap(
    src_path: str,
    dst,
    extents: list[tuple[int, int]],
    dst_start: int,
    verify_rows,
    verify: bool,
    bucket,
    version: int,
    stages: dict | None = None,
) -> None:
    """Zero-copy source views: the .dat is mmapped and each extent is
    written straight from a memoryview slice (page-cache -> dst with no
    intermediate buffer copy)."""
    import mmap

    if stages is None:
        stages = {}  # calibration runs without a stage sink
    with open(src_path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size == 0:
            return
        mm = mmap.mmap(f.fileno(), size, prot=mmap.PROT_READ)
        mv = memoryview(mm)
        try:
            batcher = _WriteBatcher(dst, dst_start)
            for span_start, width, i_lo, i_hi in _span_batches(extents):
                if bucket is not None:
                    bucket.consume(width)
                view = mv[span_start : span_start + width]
                try:
                    _emit_span(
                        view, span_start, extents, i_lo, i_hi, batcher,
                        verify, verify_rows, version, stages,
                    )
                finally:
                    view.release()
            t0 = time.perf_counter()
            batcher.flush()
            _stage_add(stages, "write_s", time.perf_counter() - t0)
        finally:
            try:
                mv.release()
                mm.close()
            except BufferError:
                # an exception mid-verify can pin slices in live traceback
                # frames; the map closes when the frames are collected
                pass


def _copy_data_based_on_index_file(
    src_dat: str, src_idx: str, dst_dat: str, dst_idx: str,
    sb: SuperBlock, version: int,
    route: str | None = None,
    verify: bool | None = None,
    bucket=None,
) -> dict:
    """Extent-coalesced fast copy (ref copyDataBasedOnIndexFile,
    volume_vacuum.go:381-447, rebuilt in the mold of rebuild_ec_files):

    1. replay the .idx into the live set (vectorized parse, newest wins);
    2. sort by source offset and coalesce adjacent records into extents;
    3. move extents as raw bytes — records are position-independent, so a
       straight byte copy IS the compaction — through the measured-race
       winner (pread ring / mmap views), writes strictly in order;
    4. emit the key-sorted .cpx in one vectorized pass.

    verify=True (or SEAWEEDFS_TPU_VACUUM_VERIFY=1) re-parses every copied
    record through the CRC-verifying parser (vacuum doubles as a scrub
    pass; CorruptLiveRecord aborts the compaction). `bucket` (or the
    shared maintenance budget) rate-shapes the copy. TTL volumes take the
    per-needle `_copy_naive` path — expiry is a per-record decision.
    Returns {route, records, extents, live_bytes, stages}.
    """
    stages: dict = {}
    t_enter = time.perf_counter()
    if verify is None:
        verify = os.environ.get(
            "SEAWEEDFS_TPU_VACUUM_VERIFY", ""
        ).lower() in ("1", "true", "on", "yes")
    if bucket is None:
        from .maintenance import plane_bucket

        bucket = plane_bucket("vacuum")

    if sb.ttl is not None and getattr(sb.ttl, "minutes", 0):
        # TTL expiry needs each record's last_modified: per-needle path
        report = _copy_naive(
            src_dat, src_idx, dst_dat, dst_idx, sb, version, bucket=bucket
        )
        stages["total_s"] = time.perf_counter() - t_enter
        _publish_stages(stages, {"route": "naive", **report})
        return {"route": "naive", "stages": stages, **report}

    import numpy as np

    new_sb = SuperBlock(
        version=sb.version,
        replica_placement=sb.replica_placement,
        ttl=sb.ttl,
        compaction_revision=sb.compaction_revision + 1,
        extra=sb.extra,
    )

    t0 = time.perf_counter()
    keys, src_offs, sizes, rec_bytes = _live_entries(src_idx, version)
    dat_size = os.path.getsize(src_dat)
    # entries whose extent runs past the .dat cannot be copied (the naive
    # loop skipped them via its failed-read except) — drop, don't crash
    ok = (src_offs + rec_bytes) <= dat_size
    keys, src_offs, sizes, rec_bytes = (
        keys[ok], src_offs[ok], sizes[ok], rec_bytes[ok],
    )
    order = np.argsort(src_offs, kind="stable")
    keys, src_offs, sizes, rec_bytes = (
        keys[order], src_offs[order], sizes[order], rec_bytes[order],
    )
    data_start = new_sb.block_size()
    dst_offs = data_start + np.concatenate(
        ([0], np.cumsum(rec_bytes)[:-1])
    ) if len(keys) else np.zeros(0, dtype=np.int64)
    extents = _coalesce(src_offs, rec_bytes)
    verify_rows = None
    if verify and extents:
        rows = list(
            zip(keys.tolist(), src_offs.tolist(), sizes.tolist(),
                rec_bytes.tolist())
        )
        verify_rows = []
        i = 0
        for off, width in extents:
            group = []
            while i < len(rows) and rows[i][1] < off + width:
                group.append(rows[i])
                i += 1
            verify_rows.append(group)
    _stage_add(stages, "plan_s", time.perf_counter() - t0)

    if route is None:
        # an active fault plan must see every byte cross the read/write
        # seams — mmap views would bypass the read seam entirely
        route = (
            "pread"
            if faults._PLAN is not None
            else _calibrate_vacuum_route()
        )
    route_info = {
        "route": route, "extents": len(extents), "records": len(keys),
    }

    dst = DiskFile(dst_dat, create=True)
    try:
        dst.truncate(0)
        dst.write_at(new_sb.to_bytes(), 0)
        copier = _copy_extents_mmap if route == "mmap" else _copy_extents_pread
        copier(
            src_dat, dst, extents, data_start, verify_rows, verify, bucket,
            version, stages,
        )
    except Exception:
        # a FAILED copy tidies its shadow; a killed process leaves the
        # torn .cpd behind — the load-time shadow sweep owns that state
        try:
            os.remove(dst_dat)
        except OSError:
            pass
        raise
    finally:
        dst.close()

    t0 = time.perf_counter()
    korder = np.argsort(keys, kind="stable")
    idx_bytes = entries_to_bytes(
        keys[korder],
        (dst_offs[korder] // NEEDLE_PADDING_SIZE).astype(np.uint64),
        sizes[korder],
    )
    idx_f = DiskFile(dst_idx, create=True)
    try:
        idx_f.truncate(0)
        if idx_bytes:
            idx_f.write_at(idx_bytes, 0)
    finally:
        idx_f.close()
    _stage_add(stages, "idx_s", time.perf_counter() - t0)

    live_bytes = int(rec_bytes.sum()) if len(keys) else 0
    stages["total_s"] = time.perf_counter() - t_enter
    _publish_stages(stages, route_info)
    return {
        "route": route,
        "records": int(len(keys)),
        "extents": len(extents),
        "live_bytes": live_bytes,
        "stages": stages,
    }


def _copy_naive(
    src_dat: str, src_idx: str, dst_dat: str, dst_idx: str,
    sb: SuperBlock, version: int, bucket=None,
) -> dict:
    """The pre-fast-path reference structure (one needle at a time:
    pread + CRC parse + re-serialize + write). Kept as the benchmark
    baseline and the TTL-volume path (per-record expiry)."""
    old_nm = MemDb()
    old_nm.load_from_idx(src_idx)
    src = DiskFile(src_dat, create=False, read_only=True)
    dst = DiskFile(dst_dat, create=True)
    dst.truncate(0)

    new_sb = SuperBlock(
        version=sb.version,
        replica_placement=sb.replica_placement,
        ttl=sb.ttl,
        compaction_revision=sb.compaction_revision + 1,
        extra=sb.extra,
    )
    dst.write_at(new_sb.to_bytes(), 0)
    new_offset = new_sb.block_size()
    new_nm = MemDb()
    now = time.time()
    records = 0

    def visit(value) -> None:
        nonlocal new_offset, records
        if value.offset_units == 0 or value.size == TOMBSTONE_FILE_SIZE:
            return
        try:
            n = read_needle_data(
                src, to_actual_offset(value.offset_units), value.size, version
            )
        except Exception:
            return
        if n.has_ttl() and n.ttl is not None and now >= n.last_modified + sb.ttl.minutes * 60:
            return
        new_nm.set(n.id, to_offset_units(new_offset), n.size)
        blob, _, actual = n.to_bytes(sb.version)
        if bucket is not None:
            bucket.consume(actual)
        dst.write_at(blob, new_offset)
        new_offset += actual
        records += 1

    old_nm.ascending_visit(visit)
    src.close()
    dst.close()
    new_nm.save_to_idx(dst_idx)
    return {"records": records, "live_bytes": new_offset - new_sb.block_size()}


def _makeup_diff(
    v: Volume, new_dat: str, new_idx: str, old_dat: str, old_idx: str
) -> None:
    """Replay idx-tail updates that raced compaction into the shadow files
    (ref makeupDiff, volume_vacuum.go:181-308)."""
    idx_size = os.path.getsize(old_idx)
    if idx_size % NEEDLE_MAP_ENTRY_SIZE != 0:
        raise ValueError(f"old idx size {idx_size} corrupt")
    if idx_size == 0 or idx_size <= v.last_compact_index_offset:
        return

    old_dat_f = DiskFile(old_dat, create=False, read_only=True)
    old_rev = read_super_block(old_dat_f).compaction_revision
    if old_rev != v.last_compact_revision:
        old_dat_f.close()
        raise ValueError(
            f"old dat compact revision {old_rev} != expected {v.last_compact_revision}"
        )

    # newest entry wins per key, walking the tail backwards
    updated: dict[int, tuple[int, int]] = {}
    with open(old_idx, "rb") as f:
        off = idx_size - NEEDLE_MAP_ENTRY_SIZE
        while off >= v.last_compact_index_offset:
            f.seek(off)
            key, offset_units, size = parse_entry(f.read(NEEDLE_MAP_ENTRY_SIZE))
            if key not in updated:
                updated[key] = (offset_units, size)
            off -= NEEDLE_MAP_ENTRY_SIZE
    if not updated:
        old_dat_f.close()
        return

    dst = DiskFile(new_dat, create=False)
    new_rev = read_super_block(dst).compaction_revision
    if old_rev + 1 != new_rev:
        old_dat_f.close()
        dst.close()
        raise ValueError(f"new dat compact revision {new_rev} != old {old_rev}+1")

    idx_f = DiskFile(new_idx, create=False)
    for key, (offset_units, size) in updated.items():
        offset = dst.size()
        if offset % NEEDLE_PADDING_SIZE != 0:
            offset += NEEDLE_PADDING_SIZE - offset % NEEDLE_PADDING_SIZE
        if offset_units != 0 and size != 0 and size != TOMBSTONE_FILE_SIZE:
            blob = read_needle_blob(
                old_dat_f, to_actual_offset(offset_units), size, v.version
            )
            dst.write_at(blob, offset)
            idx_f.append(entry_to_bytes(key, to_offset_units(offset), size))
        else:
            fake = Needle(id=key, cookie=0x12345678)
            fake.append_at_ns = time.time_ns()
            blob, _, _ = fake.to_bytes(v.version)
            dst.write_at(blob, offset)
            idx_f.append(entry_to_bytes(key, 0, size))
    old_dat_f.close()
    dst.close()
    idx_f.close()
