"""EC file pipeline: .dat -> .ec00-.ec13 (+ .ecx sorted index), and rebuild.

Byte-identical to the reference pipeline (ref: weed/storage/erasure_coding/
ec_encoder.go):

- encode streams the .dat through the two-level block layout — shard i's
  bytes for a row starting at P come from dat[P + i*block : P + (i+1)*block],
  zero-filled past EOF (ec_encoder.go:162-192) — and appends one block per
  shard per row, so every shard file is large_rows*1GB + small_rows*1MB;
- rebuild reconstructs the missing shard files from >=10 survivors, one
  volume (rebuild_ec_files) or many through shared wide decode batches
  (rebuild_ec_files_multi);
- decode turns the data shards back into a .dat (write_dat_file) and the
  .ecx plus the .ecj journal back into an .idx
  (write_idx_file_from_ec_index; ref weed/storage/erasure_coding/
  ec_decoder.go).

The codec is pluggable (the CUDA kernel or numpy on the host). The device
codec takes the streamed route (_encode_streamed): chunked reads of the .dat
overlap a pool of workers that each stage, upload, launch and download one
chunk, and a writer thread that appends the shards in order. A `mesh`
(parallel/sharded_ec.py) takes the multi-volume encode's and rebuild's
batches over a (vol, blk) grid of devices instead.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

import numpy as np

from . import (
    DATA_SHARDS_COUNT,
    EC_LARGE_BLOCK_SIZE,
    EC_SMALL_BLOCK_SIZE,
    PARITY_SHARDS_COUNT,
    to_ext,
)
from ...types import TOMBSTONE_FILE_SIZE, to_actual_offset
from ..idx import entry_to_bytes, iter_index
from ..needle import get_actual_size
from ..super_block import SuperBlock

DEFAULT_CHUNK = 4 * 1024 * 1024  # per-shard streaming chunk

# set by write_ec_files after each run: {"route": ..., "input": ...,
# "kernel": ...} — benchmark/diagnostic introspection, not part of the
# encode contract
LAST_ROUTE: dict = {}

# per-stage wall seconds of the last write_ec_files run. The synchronous
# route fills read_s / kernel_s / shard_write_s. The STREAMED pipeline
# route fills read_s / stage_s / kernel_s / write_s / sync_s plus
# pipeline_depth and coverage_of_wall: read/stage/sync are main-thread
# walls that PARTITION the run (their sum over total_s is the disclosed
# coverage), while kernel_s (pool) and write_s (writer thread) are
# overlapped walls whose ratio to total_s discloses overlap efficiency.
LAST_STAGES: dict = {}
_STAGE_LOCK = threading.Lock()

# per-stage wall seconds of the last rebuild_ec_files run (read_s /
# decode_s / write_s / total_s) — the repair-plane mirror of LAST_STAGES.
# On the pipelined route the stages OVERLAP (decode_s is worker wall while
# the main thread reads/writes), so their sum can exceed total_s.
LAST_REBUILD_STAGES: dict = {}
_REBUILD_STAGE_LOCK = threading.Lock()

# which structure the last rebuild_ec_files run took ("pread", pipelined
# or not) — the repair mirror of LAST_ROUTE
LAST_REBUILD_ROUTE: dict = {}


def _stage_add(key: str, dt: float) -> None:
    LAST_STAGES[key] = LAST_STAGES.get(key, 0.0) + dt


def _stage_add_locked(key: str, dt: float) -> None:
    # the streamed pipeline adds kernel_s/write_s from pool and writer
    # threads concurrently with the main thread's read_s/stage_s: lock
    with _STAGE_LOCK:
        LAST_STAGES[key] = LAST_STAGES.get(key, 0.0) + dt


def _rebuild_stage_add(key: str, dt: float) -> None:
    # decode runs on pool workers concurrently with the reader: lock
    with _REBUILD_STAGE_LOCK:
        LAST_REBUILD_STAGES[key] = LAST_REBUILD_STAGES.get(key, 0.0) + dt


def _sweep_stale_tmp(base_file_name: str, total_shards: int) -> None:
    """Remove .ecNN.tmp leftovers a crashed encode/rebuild left behind —
    a torn .tmp must never be mistaken for (or block) a fresh output."""
    for i in range(total_shards):
        tmp = base_file_name + to_ext(i) + ".tmp"
        if os.path.exists(tmp):
            os.remove(tmp)


def _get_codec(codec):
    """No codec given: the card's (raises when CUDA is absent)."""
    if codec is None:
        from ...gpu.coder import get_codec

        codec = get_codec("cuda", DATA_SHARDS_COUNT, PARITY_SHARDS_COUNT)
    return codec


def _read_into(f, out: np.ndarray, offset: int) -> None:
    """Read len(out) bytes at offset directly into `out` (preadv writes
    straight into the numpy buffer), zero-filling past EOF."""
    fd = f.fileno()
    n = 0
    want = len(out)
    while n < want:
        got = os.preadv(fd, [memoryview(out)[n:]], offset + n)
        if got <= 0:
            break
        n += got
    if n < want:
        out[n:] = 0


def _read_exact(f, out: np.ndarray, offset: int) -> None:
    """_read_into that treats a short read as the IO error it is — the
    rebuild path must NOT zero-fill a truncated survivor into the decode
    (that would silently corrupt every rebuilt shard)."""
    fd = f.fileno()
    n = 0
    want = len(out)
    while n < want:
        got = os.preadv(fd, [memoryview(out)[n:]], offset + n)
        if got <= 0:
            raise IOError(f"ec shard short read: {n} != {want}")
        n += got


def _encode_rows(
    dat_f,
    outputs,
    codec,
    start_offset: int,
    block_size: int,
    rows: int,
    chunk: int,
) -> None:
    """The synchronous route: read one chunk of every data shard, encode,
    append — the reference's loop structure, for host codecs."""
    k = codec.data_shards
    data = np.empty((k, chunk), dtype=np.uint8)
    for row in range(rows):
        row_start = start_offset + row * block_size * k
        done = 0
        while done < block_size:
            this = min(chunk, block_size - done)
            buf = data[:, :this] if this != chunk else data
            t0 = time.perf_counter()
            for i in range(k):
                _read_into(dat_f, buf[i], row_start + i * block_size + done)
            t1 = time.perf_counter()
            parity = codec.encode(buf)
            t2 = time.perf_counter()
            # contiguous-row memoryviews: BufferedWriter copies synchronously,
            # so reusing `data` next iteration is safe
            for i in range(k):
                outputs[i].write(buf[i].data)
            for p in range(codec.parity_shards):
                outputs[k + p].write(np.ascontiguousarray(parity[p]).data)
            t3 = time.perf_counter()
            _stage_add("read_s", t1 - t0)
            _stage_add("kernel_s", t2 - t1)
            _stage_add("shard_write_s", t3 - t2)
            done += this


def _stream_items(
    n_large: int, large_block: int, n_small: int, small_block: int,
    chunk: int, k: int, group: bool = True,
) -> list:
    """The streamed pipeline's work list, in shard stream order:
    (start, block, done, width, g) where `start` is the .dat offset of the
    first covered row, `g` rows are grouped into one dispatch (small blocks
    only — GF columns are independent, so G concatenated blocks per shard
    encode identically to G per-row encodes, amortizing per-dispatch
    latency), and `done`/`width` chunk the inside of one large block.

    group=False emits one item per small-block row instead: the zero-copy
    mmap route dispatches strided (k, width) VIEWS of the source mapping,
    and a grouped item's per-shard bytes are not expressible as one such
    view (its g segments per shard are discontiguous)."""
    items = []
    offset = 0
    for rows, block in ((n_large, large_block), (n_small, small_block)):
        if block >= chunk or not group:
            for row in range(rows):
                row_start = offset + row * block * k
                done = 0
                while done < block:
                    width = min(chunk, block - done)
                    items.append((row_start, block, done, width, 1))
                    done += width
        else:
            g_max = max(1, chunk // block)
            row = 0
            while row < rows:
                g = min(g_max, rows - row)
                items.append((offset + row * block * k, block, 0, block, g))
                row += g
        offset += rows * block * k
    return items


def _encode_streamed(
    base_file_name: str,
    dat_f,
    codec,
    n_large: int,
    large_block: int,
    n_small: int,
    small_block: int,
    chunk: int,
    depth: int,
    use_mmap: bool,
) -> str:
    """The streamed, depth-N encode pipeline (the route the device codec
    prefers; any codec runs it with pipeline=True).

    Chunked reads of the .dat feed a bounded ring of depth+2 REUSED host
    staging slots. Two input routes feed the ring:

    - mmap (default): each chunk is a zero-copy strided (k, width) VIEW of
      the mapping — per-shard rows are contiguous segments `block` apart —
      prefetched with madvise(WILLNEED) one item ahead so page population
      overlaps compute; the ring slot is then only a backpressure token.
      Only an item whose source region crosses EOF stages through a copy
      (it needs the zero tail materialized).
    - preadv: every chunk is copied into a staging slot.

    Each chunk's kernel dispatch (the device codec's stage + upload +
    kernel + download) runs on a pool of `depth` workers so it overlaps
    the NEXT chunk's disk read (main thread) and the PREVIOUS chunk's
    shard writes (dedicated writer thread). Output is in-order into
    .ecNN.tmp files renamed into place only when the whole stream succeeds
    — a mid-stream crash leaves only .tmp files for the next run's sweep,
    never a torn shard masquerading as complete.

    Per-stage walls land in LAST_STAGES (see its comment). Returns the
    route that fed the ring ("mmap" or "pread")."""
    import concurrent.futures as cf
    import mmap as mmap_mod
    import queue as queue_mod

    k = codec.data_shards
    m = codec.parity_shards
    total = codec.total_shards

    _sweep_stale_tmp(base_file_name, total)

    t_setup = time.perf_counter()
    dat_size = os.fstat(dat_f.fileno()).st_size
    mm = None
    mm_arr = None
    if use_mmap and dat_size > 0:
        mm = mmap_mod.mmap(dat_f.fileno(), 0, access=mmap_mod.ACCESS_READ)
        mm_arr = np.frombuffer(mm, dtype=np.uint8)

    items = _stream_items(
        n_large, large_block, n_small, small_block, chunk, k,
        group=mm_arr is None,
    )
    full_width = max((w * g for _s, _b, _d, w, g in items), default=0)
    dispatch = getattr(codec, "pipeline_encode", None) or codec.encode
    # the device dispatch keeps one launch width (zero-padded tail, parity
    # sliced on write: zero columns encode to zero parity); host kernels
    # take the narrow tail directly
    pad_tail = getattr(codec, "pipeline_dispatch_kind", "host") == "device"

    def prefetch(index: int) -> None:
        """Async readahead for item `index`'s source range: on disk-backed
        files WILLNEED starts the IO while earlier chunks compute/write."""
        if mm is None or index >= len(items) or not hasattr(mm, "madvise"):
            return
        start, block, done, width, g = items[index]
        first = start + done
        span = (k - 1) * block + width * g
        first_pg = first - (first % mmap_mod.PAGESIZE)
        try:
            mm.madvise(
                mmap_mod.MADV_WILLNEED, first_pg,
                min(first + span, dat_size) - first_pg,
            )
        except (OSError, ValueError):
            pass

    outputs = [
        open(base_file_name + to_ext(i) + ".tmp", "wb") for i in range(total)
    ]
    n_slots = depth + 2
    freeq: queue_mod.Queue = queue_mod.Queue()
    for _ in range(n_slots):
        # slots materialize on first staging use: on the mmap route most
        # items are views and the token is pure backpressure
        freeq.put(None)
    outq: queue_mod.Queue = queue_mod.Queue()
    err: list = [None]

    def run_kernel(view: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        out = np.asarray(dispatch(view))
        _stage_add_locked("kernel_s", time.perf_counter() - t0)
        return out

    def writer() -> None:
        while True:
            entry = outq.get()
            if entry is None:
                return
            buf, used, fut, slot = entry
            try:
                parity = fut.result()
                t0 = time.perf_counter()
                for i in range(k):
                    outputs[i].write(buf[i, :used].data)
                for p in range(m):
                    outputs[k + p].write(parity[p, :used].data)
                _stage_add_locked("write_s", time.perf_counter() - t0)
            except BaseException as e:  # keep consuming: the main thread
                # must never deadlock on a dead writer's unreturned slots
                if err[0] is None:
                    err[0] = e
            finally:
                freeq.put(slot)

    writer_t = threading.Thread(
        target=writer, name="ec-stream-writer", daemon=True
    )
    ok = False
    view = buf = kview = None
    try:
        with cf.ThreadPoolExecutor(depth) as pool:
            writer_t.start()
            # pool/writer/ring setup charges to stage_s: the coverage
            # partition must account for every main-thread second
            _stage_add_locked("stage_s", time.perf_counter() - t_setup)
            prefetch(0)
            for idx, (start, block, done, width, g) in enumerate(items):
                if err[0] is not None:
                    break
                t0 = time.perf_counter()
                slot = freeq.get()
                t1 = time.perf_counter()
                _stage_add_locked("stage_s", t1 - t0)
                used = width * g
                first = start + done
                view = None
                if (
                    mm_arr is not None
                    and g == 1
                    and first + (k - 1) * block + width <= dat_size
                ):
                    view = np.lib.stride_tricks.as_strided(
                        mm_arr[first:], shape=(k, width),
                        strides=(block, 1), writeable=False,
                    )
                    buf = view
                else:
                    if slot is None:
                        slot = np.empty(
                            (k, max(full_width, 1)), dtype=np.uint8
                        )
                    for gi in range(g):
                        row_start = start + gi * block * k
                        sl = slice(gi * width, gi * width + width)
                        for i in range(k):
                            _read_into(
                                dat_f, slot[i, sl],
                                row_start + i * block + done,
                            )
                    buf = slot
                prefetch(idx + 1)
                t2 = time.perf_counter()
                _stage_add_locked("read_s", t2 - t1)
                if view is None:
                    if used < full_width and pad_tail:
                        slot[:, used:] = 0
                        kview = slot
                    else:
                        kview = slot if used == full_width else slot[:, :used]
                else:
                    kview = view
                outq.put((buf, used, pool.submit(run_kernel, kview), slot))
                _stage_add_locked("stage_s", time.perf_counter() - t2)
            t0 = time.perf_counter()
            outq.put(None)
            writer_t.join()
        if err[0] is not None:
            raise err[0]
        for f in outputs:
            f.flush()
            f.close()
        for i in range(total):
            os.replace(
                base_file_name + to_ext(i) + ".tmp", base_file_name + to_ext(i)
            )
        ok = True
        _stage_add_locked("sync_s", time.perf_counter() - t0)
    finally:
        if not ok:
            if writer_t.is_alive():
                outq.put(None)
                writer_t.join()
            for f in outputs:
                try:
                    f.close()
                except OSError:
                    pass
            _sweep_stale_tmp(base_file_name, total)
        if mm is not None:
            mm_arr = view = buf = kview = None  # drop buffer exports
            try:
                mm.close()
            except (BufferError, OSError):
                pass  # a straggling view still exports the buffer: the
                # mapping closes when it is collected
    return "mmap" if mm is not None else "pread"


def write_ec_files(
    base_file_name: str,
    codec=None,
    large_block_size: int = EC_LARGE_BLOCK_SIZE,
    small_block_size: int = EC_SMALL_BLOCK_SIZE,
    chunk: int = DEFAULT_CHUNK,
    pipeline: Optional[bool] = None,
    mmap_input: bool = True,
) -> None:
    """Generate .ec00-.ec13 from .dat (ref WriteEcFiles, ec_encoder.go:57).

    codec=None takes the card's codec (raises when CUDA is absent).
    pipeline=None follows the codec's preference: the device codec takes
    the streamed route (_encode_streamed) with the codec's preferred_chunk
    (when `chunk` is left at its default) and pipeline_workers as depth;
    the host codec keeps the reference's synchronous structure
    (_encode_rows).
    mmap_input=False makes the streamed route copy every chunk with preadv
    instead of handing the codec views of the mapped .dat.
    """
    global LAST_ROUTE
    LAST_STAGES.clear()
    t_enter = time.perf_counter()
    codec = _get_codec(codec)
    if pipeline is None:
        pipeline = getattr(codec, "prefers_pipeline", False)
    if pipeline and chunk == DEFAULT_CHUNK:
        chunk = getattr(codec, "preferred_chunk", chunk)
    k = codec.data_shards
    dat_path = base_file_name + ".dat"
    dat_size = os.path.getsize(dat_path)
    n_large, n_small = _row_counts(
        dat_size, k, large_block_size, small_block_size
    )

    if pipeline:
        depth = max(1, getattr(codec, "pipeline_workers", 2))
        try:
            with open(dat_path, "rb") as dat_f:
                input_kind = _encode_streamed(
                    base_file_name, dat_f, codec,
                    n_large, large_block_size, n_small, small_block_size,
                    chunk, depth, mmap_input,
                )
            LAST_ROUTE = {
                "route": "pipeline",
                "input": input_kind,
                "kernel": getattr(codec, "pipeline_dispatch_kind", "host"),
                "pipeline_depth": depth,
            }
        finally:
            total = time.perf_counter() - t_enter
            LAST_STAGES["total_s"] = total
            LAST_STAGES["pipeline_depth"] = depth
            # coverage = the main-thread (blocking) stages over the wall:
            # kernel_s/write_s are overlapped walls, deliberately NOT summed
            blocking = sum(
                LAST_STAGES.get(s, 0.0) for s in ("read_s", "stage_s", "sync_s")
            )
            LAST_STAGES["coverage_of_wall"] = round(
                blocking / max(total, 1e-9), 3
            )
        return

    LAST_ROUTE = {"route": "pread", "kernel": "host"}
    large_row = large_block_size * k
    outputs = [
        open(base_file_name + to_ext(i), "wb") for i in range(codec.total_shards)
    ]
    try:
        with open(dat_path, "rb") as dat_f:
            _encode_rows(
                dat_f, outputs, codec, 0, large_block_size, n_large, chunk
            )
            _encode_rows(
                dat_f, outputs, codec, n_large * large_row,
                small_block_size, n_small, min(chunk, small_block_size),
            )
    finally:
        for f in outputs:
            f.close()
        LAST_STAGES["total_s"] = time.perf_counter() - t_enter


def _row_counts(
    dat_size: int, k: int, large_block: int, small_block: int
) -> tuple[int, int]:
    """(n_large, n_small) rows for a .dat (ref ec_encoder.go:214-228)."""
    remaining = dat_size
    large_row = large_block * k
    n_large = 0
    while remaining - n_large * large_row > large_row:
        n_large += 1
    remaining -= n_large * large_row
    small_row = small_block * k
    n_small = 0
    while remaining > 0:
        n_small += 1
        remaining -= small_row
    return n_large, n_small


def _piece_iter(
    n_large: int,
    large_block: int,
    n_small: int,
    small_block: int,
    chunk: int,
    k: int,
):
    """Yield (row_start, block_size, done, width) encode pieces in shard
    stream order; a piece never spans a block boundary."""
    processed = 0
    for rows, block in ((n_large, large_block), (n_small, small_block)):
        for row in range(rows):
            row_start = processed + row * block * k
            done = 0
            while done < block:
                width = min(chunk, block - done)
                yield row_start, block, done, width
                done += width
        processed += rows * block * k


def _mesh_encode(codec, mesh, buf: np.ndarray) -> np.ndarray:
    """Encode one wide batch through parallel/sharded_ec's mesh: columns
    pad to the mesh's 4*blk packing unit (zero columns encode to zero
    parity and are stripped), and the batch rides as one [1, k, N] volume
    sharded over (vol, blk). Byte-identical to codec.encode by GF
    linearity."""
    from ...parallel.sharded_ec import sharded_encode

    n = buf.shape[1]
    unit = 4 * mesh.shape["blk"]
    pad = (-n) % unit
    if pad:
        buf = np.concatenate(
            [buf, np.zeros((buf.shape[0], pad), dtype=np.uint8)], axis=1
        )
    out = np.asarray(sharded_encode(codec.parity_matrix, buf[None], mesh))[0]
    return out[:, :n] if pad else out


def write_ec_files_multi(
    base_file_names,
    codec=None,
    large_block_size: int = EC_LARGE_BLOCK_SIZE,
    small_block_size: int = EC_SMALL_BLOCK_SIZE,
    chunk: int = DEFAULT_CHUNK,
    workers: Optional[int] = None,
    mesh=None,
) -> None:
    """Encode MANY volumes' .dat files through shared wide encode batches
    (the JAX package's write_ec_files_multi; VolumeEcShardsGenerateBatch
    calls it).

    GF(2^8) parity is computed column by column, so pieces of different
    volumes concatenated along the column axis and encoded in ONE call are
    byte-identical to per-volume encodes, and one kernel launch serves
    every volume in a round. Each round takes the next piece of every
    unfinished volume, groups by width, and pipelines read -> batched
    encode -> ordered writes. Host codecs encode whole volumes
    concurrently across cores instead. With a device codec, `mesh` sends
    each batch through the (vol, blk) device mesh (_mesh_encode).
    """
    import concurrent.futures as cf
    from collections import deque

    codec = _get_codec(codec)
    k = codec.data_shards

    if not getattr(codec, "is_device", False):
        from ...util import available_cpus

        n_workers = max(
            1, min(len(base_file_names), workers or available_cpus())
        )

        def one(base: str) -> None:
            write_ec_files(
                base, codec=codec,
                large_block_size=large_block_size,
                small_block_size=small_block_size,
                chunk=chunk, pipeline=False,
            )

        if n_workers == 1:
            for base in base_file_names:
                one(base)
            return
        with cf.ThreadPoolExecutor(n_workers) as pool:
            for _ in pool.map(one, base_file_names):
                pass
        return
    width_cap = max(
        small_block_size, getattr(codec, "preferred_chunk", chunk)
    )

    vols = []  # (dat_f, outputs, piece_iter)
    try:
        for base in base_file_names:
            dat_size = os.path.getsize(base + ".dat")
            n_large, n_small = _row_counts(
                dat_size, k, large_block_size, small_block_size
            )
            dat_f = open(base + ".dat", "rb")
            outputs = [
                open(base + to_ext(i), "wb")
                for i in range(codec.total_shards)
            ]
            pieces = _piece_iter(
                n_large, large_block_size, n_small, small_block_size,
                min(chunk, width_cap), k,
            )
            vols.append((dat_f, outputs, pieces))

        def rounds():
            active = list(vols)
            while active:
                produced = []
                for v in active:
                    p = next(v[2], None)
                    if p is not None:
                        produced.append((v, p))
                if not produced:
                    return
                # same-width pieces share batches, capped at the codec's
                # preferred transfer size
                by_width: dict = {}
                for v, p in produced:
                    by_width.setdefault(p[3], []).append((v, p))
                for width, items in sorted(by_width.items()):
                    per_batch = max(1, width_cap // width)
                    for s in range(0, len(items), per_batch):
                        yield width, items[s : s + per_batch]
                active = [v for v, _ in produced]

        def read_batch(width: int, items: list) -> np.ndarray:
            buf = np.zeros((k, len(items) * width), dtype=np.uint8)
            for j, ((dat_f, _outs, _it), (row_start, block, done, w)) in enumerate(
                items
            ):
                c0 = j * width
                for i in range(k):
                    _read_into(
                        dat_f,
                        buf[i, c0 : c0 + w],
                        row_start + i * block + done,
                    )
            return buf

        def drain(entry) -> None:
            width, items, buf, fut = entry
            parity = np.ascontiguousarray(fut.result())
            for j, ((_f, outputs, _it), _p) in enumerate(items):
                sl = slice(j * width, (j + 1) * width)
                for i in range(k):
                    outputs[i].write(buf[i, sl].data)
                for p in range(codec.parity_shards):
                    outputs[k + p].write(parity[p, sl].data)

        if mesh is not None:
            def encode_batch(buf: np.ndarray) -> np.ndarray:
                return _mesh_encode(codec, mesh, buf)
        else:
            encode_batch = codec.encode

        depth = max(1, workers or 2)  # device pipeline depth
        with cf.ThreadPoolExecutor(depth) as pool:
            pending: deque = deque()
            for width, items in rounds():
                buf = read_batch(width, items)
                pending.append(
                    (width, items, buf, pool.submit(encode_batch, buf))
                )
                while len(pending) > depth:
                    drain(pending.popleft())
            while pending:
                drain(pending.popleft())
    finally:
        for dat_f, outputs, _it in vols:
            dat_f.close()
            for f in outputs:
                f.close()


def write_sorted_file_from_idx(base_file_name: str, ext: str = ".ecx") -> None:
    """.idx log -> sorted index file (ref WriteSortedFileFromIdx,
    ec_encoder.go:27-54). Vectorized: one sequential read, one numpy
    newest-wins fold (idx.fold_live_columns), one serialized write."""
    from ..idx import (
        NEEDLE_MAP_ENTRY_SIZE,
        entries_to_bytes,
        fold_live_columns,
        parse_index_bytes,
    )

    with open(base_file_name + ".idx", "rb") as f:
        data = f.read()
    usable = len(data) - (len(data) % NEEDLE_MAP_ENTRY_SIZE)
    keys, offs, sizes = parse_index_bytes(data[:usable])
    lk, lo, ls = fold_live_columns(keys, offs, sizes)
    with open(base_file_name + ext, "wb") as f:
        f.write(entries_to_bytes(lk, lo, ls))


# one rebuild per volume base at a time (process-wide): a retry racing a
# still-running rebuild of the same volume must wait, re-survey, and find
# nothing missing — never interleave writes into the same .ecNN.tmp files
_BASE_REBUILD_LOCKS: dict = {}
_BASE_REBUILD_LOCKS_GUARD = threading.Lock()


def _base_rebuild_lock(base_file_name: str) -> threading.Lock:
    with _BASE_REBUILD_LOCKS_GUARD:
        lock = _BASE_REBUILD_LOCKS.get(base_file_name)
        if lock is None:
            lock = _BASE_REBUILD_LOCKS[base_file_name] = threading.Lock()
        return lock


def _rebuild_survey(base_file_name: str, codec) -> tuple[list[int], list[int]]:
    """(missing, present) shard ids for a rebuild, after sweeping any stale
    .ecNN.tmp torn outputs a crashed rebuild left behind. Raises when fewer
    than k survivors remain or survivors disagree on size (a truncated
    survivor would otherwise zero-fill into every rebuilt shard)."""
    k = codec.data_shards
    _sweep_stale_tmp(base_file_name, codec.total_shards)
    have = [
        os.path.exists(base_file_name + to_ext(i))
        for i in range(codec.total_shards)
    ]
    missing = [i for i, h in enumerate(have) if not h]
    present = [i for i, h in enumerate(have) if h]
    if missing and len(present) < k:
        raise ValueError(
            f"need at least {k} shards, only {len(present)} present"
        )
    sizes = {os.path.getsize(base_file_name + to_ext(i)) for i in present[:k]}
    if len(sizes) > 1:
        raise IOError(
            f"survivor shards disagree on size ({sorted(sizes)}): "
            "refusing to rebuild from a truncated survivor"
        )
    return missing, present


def rebuild_ec_files(
    base_file_name: str,
    codec=None,
    chunk: int = DEFAULT_CHUNK,
    pipeline: Optional[bool] = None,
) -> list[int]:
    """Reconstruct missing .ecNN files from survivors; returns the generated
    shard ids (ref RebuildEcFiles, ec_encoder.go:61,233-287).

    - **missing-rows-only decode** — reconstruct_rows slices the decode
      matrix to the missing ids (4 output rows instead of 14 on a 4-loss
      rebuild; 1 on the common single-loss), with the composed matrix
      cached in galois.DECODE_ROWS_CACHE across chunks AND rebuilds;
    - **only k survivors read**;
    - **pipelined** (pipeline=None -> on with >1 CPU or a device codec):
      reader / decode pool / in-order writer (_rebuild_ring), with preadv
      into reused buffers;
    - **atomic outputs** — rebuilt shards stream to .ecNN.tmp and are
      renamed into place only after the whole rebuild succeeds.

    Per-stage walls land in LAST_REBUILD_STAGES, the structure in
    LAST_REBUILD_ROUTE. Serialized per volume base (process-wide): a
    concurrent second rebuild of the same volume waits, re-surveys, and
    returns [].
    """
    with _base_rebuild_lock(base_file_name):
        return _rebuild_ec_files_unlocked(base_file_name, codec, chunk, pipeline)


def _rebuild_ec_files_unlocked(
    base_file_name: str,
    codec,
    chunk: int,
    pipeline: Optional[bool],
) -> list[int]:
    codec = _get_codec(codec)
    LAST_REBUILD_STAGES.clear()
    t_enter = time.perf_counter()
    missing, present = _rebuild_survey(base_file_name, codec)
    if not missing:
        return []
    k = codec.data_shards
    total = codec.total_shards
    survivors = present[:k]
    shard_size = os.path.getsize(base_file_name + to_ext(survivors[0]))
    if pipeline is None:
        from ...util import available_cpus

        pipeline = available_cpus() > 1 or getattr(codec, "is_device", False)

    def decode_chunk(
        buf: np.ndarray, width: int, out: Optional[np.ndarray] = None
    ) -> list[np.ndarray]:
        t0 = time.perf_counter()
        slots: list[Optional[np.ndarray]] = [None] * total
        for j, i in enumerate(survivors):
            slots[i] = buf[j, :width]
        outs = [
            np.ascontiguousarray(o)
            for o in codec.reconstruct_rows(
                slots, missing,
                out=out[:, :width] if out is not None else None,
            )
        ]
        _rebuild_stage_add("decode_s", time.perf_counter() - t0)
        return outs

    inputs = {i: open(base_file_name + to_ext(i), "rb") for i in survivors}
    outputs = {
        i: open(base_file_name + to_ext(i) + ".tmp", "wb") for i in missing
    }
    LAST_REBUILD_ROUTE.clear()
    LAST_REBUILD_ROUTE.update({"route": "pread", "pipeline": bool(pipeline)})
    ok = False
    try:
        if pipeline and shard_size > chunk:
            _rebuild_pipelined(
                inputs, outputs, survivors, missing, shard_size, chunk,
                decode_chunk, codec,
            )
        else:
            buf_w = min(chunk, max(shard_size, 1))
            buf = np.empty((k, buf_w), dtype=np.uint8)
            out_buf = np.empty((len(missing), buf_w), dtype=np.uint8)
            offset = 0
            while offset < shard_size:
                width = min(chunk, shard_size - offset)
                t0 = time.perf_counter()
                for j, i in enumerate(survivors):
                    _read_exact(inputs[i], buf[j, :width], offset)
                _rebuild_stage_add("read_s", time.perf_counter() - t0)
                outs = decode_chunk(buf, width, out_buf)
                t0 = time.perf_counter()
                for r, i in enumerate(missing):
                    outputs[i].write(outs[r].data)
                _rebuild_stage_add("write_s", time.perf_counter() - t0)
                offset += width
        ok = True
    finally:
        for f in inputs.values():
            f.close()
        for f in outputs.values():
            f.close()
        if ok:
            for i in missing:
                os.replace(
                    base_file_name + to_ext(i) + ".tmp",
                    base_file_name + to_ext(i),
                )
        else:
            for i in missing:
                try:
                    os.remove(base_file_name + to_ext(i) + ".tmp")
                except OSError:
                    pass
        LAST_REBUILD_STAGES["total_s"] = time.perf_counter() - t_enter
        if "sync_s" in LAST_REBUILD_STAGES:
            # streamed ring ran: the blocking (main-thread) stages
            # partition the wall — decode_s/write_s are overlapped walls
            blocking = ("read_s", "stage_s", "sync_s")
            LAST_REBUILD_ROUTE["pipeline_depth"] = LAST_REBUILD_STAGES.get(
                "pipeline_depth"
            )
        else:
            blocking = ("read_s", "decode_s", "write_s")
        LAST_REBUILD_STAGES["coverage_of_wall"] = round(
            sum(LAST_REBUILD_STAGES.get(s, 0.0) for s in blocking)
            / max(LAST_REBUILD_STAGES["total_s"], 1e-9),
            3,
        )
    return missing


def _rebuild_ring(
    shard_size: int, chunk: int, workers: int, allocate, stage, decode,
    write_outs,
) -> None:
    """The streamed rebuild ring (the rebuild mirror of _encode_streamed):
    `allocate()` builds one slot's buffers, `stage(offset, width, bufs)`
    runs in the MAIN thread (survivor reads), `decode(offset, width, bufs)`
    runs on the pool, and a dedicated writer thread calls
    `write_outs(outs)` in stream order — so chunk i+1's survivor read
    overlaps chunk i's decode AND chunk i-1's shard writes. A slot
    recycles only after its decode result is written, bounding memory at
    (workers+2) slots with zero steady-state allocation. stage_s
    (free-slot waits + handoff) and sync_s (final drain) land in
    LAST_REBUILD_STAGES next to the read_s/decode_s/write_s the callbacks
    record; pipeline_depth too."""
    import concurrent.futures as cf
    import queue as queue_mod

    depth = max(1, workers)
    freeq: queue_mod.Queue = queue_mod.Queue()
    for _ in range(depth + 2):
        freeq.put(allocate())
    outq: queue_mod.Queue = queue_mod.Queue()
    err: list = [None]

    def writer() -> None:
        while True:
            entry = outq.get()
            if entry is None:
                return
            bufs, fut = entry
            try:
                write_outs(fut.result())
            except BaseException as e:  # keep consuming: the main thread
                # must never deadlock on a dead writer's unreturned slots
                if err[0] is None:
                    err[0] = e
            finally:
                freeq.put(bufs)

    writer_t = threading.Thread(
        target=writer, name="ec-rebuild-writer", daemon=True
    )
    writer_t.start()
    with _REBUILD_STAGE_LOCK:
        LAST_REBUILD_STAGES["pipeline_depth"] = depth
    try:
        with cf.ThreadPoolExecutor(depth) as pool:
            offset = 0
            while offset < shard_size and err[0] is None:
                width = min(chunk, shard_size - offset)
                t0 = time.perf_counter()
                bufs = freeq.get()
                _rebuild_stage_add("stage_s", time.perf_counter() - t0)
                stage(offset, width, bufs)
                t0 = time.perf_counter()
                outq.put((bufs, pool.submit(decode, offset, width, bufs)))
                _rebuild_stage_add("stage_s", time.perf_counter() - t0)
                offset += width
            t0 = time.perf_counter()
            outq.put(None)
            writer_t.join()
        _rebuild_stage_add("sync_s", time.perf_counter() - t0)
    finally:
        if writer_t.is_alive():
            outq.put(None)
            writer_t.join()
    if err[0] is not None:
        raise err[0]


def _rebuild_pipelined(
    inputs: dict,
    outputs: dict,
    survivors: list[int],
    missing: list[int],
    shard_size: int,
    chunk: int,
    decode_chunk,
    codec,
) -> None:
    """Double-buffered rebuild loop: the main thread streams survivor reads
    (preadv into a recycled buffer ring) while a small pool runs the decode
    matmul and the writer appends the rebuilt shards in order."""
    k = len(survivors)

    def allocate():
        return (
            np.empty((k, chunk), dtype=np.uint8),
            np.empty((len(missing), chunk), dtype=np.uint8),
        )

    def stage(offset: int, width: int, bufs) -> None:
        buf, _out = bufs
        t0 = time.perf_counter()
        for j, i in enumerate(survivors):
            _read_exact(inputs[i], buf[j, :width], offset)
        _rebuild_stage_add("read_s", time.perf_counter() - t0)

    def decode(offset: int, width: int, bufs):
        buf, out = bufs
        return decode_chunk(buf, width, out)

    def write_outs(outs) -> None:
        t0 = time.perf_counter()
        for r, i in enumerate(missing):
            outputs[i].write(outs[r].data)
        _rebuild_stage_add("write_s", time.perf_counter() - t0)

    _rebuild_ring(
        shard_size, chunk, max(2, getattr(codec, "pipeline_workers", 2)),
        allocate, stage, decode, write_outs,
    )


def rebuild_ec_files_multi(
    base_file_names,
    codec=None,
    chunk: int = DEFAULT_CHUNK,
    workers: Optional[int] = None,
    mesh=None,
) -> dict:
    """Rebuild MANY volumes' missing shards; returns {base: rebuilt ids}.

    The repair-plane mirror of write_ec_files_multi. Host codecs rebuild
    whole volumes concurrently across cores. Device codecs concatenate
    same-decode-matrix chunks of different volumes along the column axis
    into ONE wide dispatch, capped at max(chunk, codec.preferred_chunk):
    after a node dies every volume that lost the same shard ids shares one
    matrix, so one kernel launch serves the whole round. `mesh` sends those
    batches through the (vol, blk) device mesh
    (parallel.sharded_ec.sharded_reconstruct_padded). Outputs stream to
    .ecNN.tmp files, renamed into place only when every volume succeeded
    and removed otherwise; the per-base locks are taken in sorted order.
    """
    import concurrent.futures as cf
    import contextlib
    from collections import deque

    from .galois import DECODE_ROWS_CACHE

    codec = _get_codec(codec)
    k = codec.data_shards
    results: dict = {}
    if mesh is None and not getattr(codec, "is_device", False):
        from ...util import available_cpus

        n_workers = max(
            1, min(len(base_file_names), workers or available_cpus())
        )
        # several volumes: one single-thread rebuild per core; a lone
        # volume keeps the per-volume pipelined path
        per_vol_pipeline = None if len(base_file_names) == 1 else False

        def one(base: str):
            return base, rebuild_ec_files(
                base, codec=codec, chunk=chunk, pipeline=per_vol_pipeline
            )

        if n_workers == 1:
            for base in base_file_names:
                results[base] = one(base)[1]
            return results
        with cf.ThreadPoolExecutor(n_workers) as pool:
            for base, ids in pool.map(one, base_file_names):
                results[base] = ids
        return results

    width_cap = max(chunk, getattr(codec, "preferred_chunk", chunk))
    vols = []  # per-volume state dicts
    ok = False
    locks = contextlib.ExitStack()
    # sorted acquisition: two concurrent multi-rebuilds over overlapping
    # volume sets take the per-base locks in the same order
    for base in sorted(set(base_file_names)):
        locks.enter_context(_base_rebuild_lock(base))
    try:
        for base in base_file_names:
            missing, present = _rebuild_survey(base, codec)
            if not missing:
                results[base] = []
                continue
            survivors = present[:k]
            vols.append({
                "base": base,
                "missing": missing,
                "survivors": survivors,
                "shard_size": os.path.getsize(base + to_ext(survivors[0])),
                "offset": 0,
                "inputs": {i: open(base + to_ext(i), "rb") for i in survivors},
                "outputs": {
                    i: open(base + to_ext(i) + ".tmp", "wb") for i in missing
                },
            })

        def rounds():
            active = list(vols)
            while active:
                produced = []
                for v in active:
                    if v["offset"] < v["shard_size"]:
                        width = min(chunk, v["shard_size"] - v["offset"])
                        produced.append((v, v["offset"], width))
                        v["offset"] += width
                if not produced:
                    return
                # one decode matrix per (survivor set, missing set): only
                # same-matrix same-width pieces share a dispatch
                groups: dict = {}
                for v, off, width in produced:
                    key = (tuple(v["survivors"]), tuple(v["missing"]), width)
                    groups.setdefault(key, []).append((v, off))
                for (surv, miss, width), items in sorted(
                    groups.items(), key=lambda kv: kv[0]
                ):
                    per_batch = max(1, width_cap // width)
                    for s in range(0, len(items), per_batch):
                        yield surv, miss, width, items[s : s + per_batch]
                active = [v for v, _off, _w in produced]

        def read_batch(surv, width, items) -> np.ndarray:
            buf = np.empty((k, len(items) * width), dtype=np.uint8)
            for j, (v, off) in enumerate(items):
                c0 = j * width
                for row, i in enumerate(surv):
                    _read_exact(v["inputs"][i], buf[row, c0 : c0 + width], off)
            return buf

        def decode_batch(rows: np.ndarray, buf: np.ndarray, width: int):
            if mesh is not None:
                from ...parallel.sharded_ec import sharded_reconstruct_padded

                g = buf.shape[1] // width
                stacked = np.ascontiguousarray(
                    buf.reshape(k, g, width).transpose(1, 0, 2)
                )
                out = sharded_reconstruct_padded(rows, stacked, mesh)
                # back to the [R, G*width] column layout the writer takes
                return np.ascontiguousarray(
                    out.transpose(1, 0, 2).reshape(rows.shape[0], -1)
                )
            return np.ascontiguousarray(codec.apply_matrix(rows, buf))

        depth = max(1, workers or 2)  # device pipeline depth
        with cf.ThreadPoolExecutor(depth) as pool:
            pending: deque = deque()

            def drain() -> None:
                miss, width, items, fut = pending.popleft()
                out = fut.result()
                for j, (v, _off) in enumerate(items):
                    sl = slice(j * width, (j + 1) * width)
                    for r, i in enumerate(miss):
                        v["outputs"][i].write(out[r, sl].data)

            for surv, miss, width, items in rounds():
                rows = DECODE_ROWS_CACHE.rows_for(
                    codec.matrix, list(surv), list(miss)
                )
                buf = read_batch(surv, width, items)
                pending.append(
                    (miss, width, items,
                     pool.submit(decode_batch, rows, buf, width))
                )
                while len(pending) > depth:
                    drain()
            while pending:
                drain()
        ok = True
    finally:
        for v in vols:
            for f in v["inputs"].values():
                f.close()
            for f in v["outputs"].values():
                f.close()
            for i in v["missing"]:
                tmp = v["base"] + to_ext(i) + ".tmp"
                if ok:
                    os.replace(tmp, v["base"] + to_ext(i))
                else:
                    try:
                        os.remove(tmp)
                    except OSError:
                        pass
        locks.close()
    for v in vols:
        results[v["base"]] = v["missing"]
    return results


# --- decode: EC shards back to a volume (ref ec_decoder.go) ---
def write_dat_file(
    base_file_name: str, dat_file_size: int, data_shards: int = DATA_SHARDS_COUNT
) -> None:
    """Interleave-copy the data shards into the .dat (ref WriteDatFile,
    ec_decoder.go:157-195): whole 1 GiB large rows while at least a full
    row remains, then 1 MiB small blocks, skipping the zero padding of
    the last, short small block of each shard."""
    inputs = [open(base_file_name + to_ext(i), "rb") for i in range(data_shards)]
    # one reused copy buffer for the whole decode
    buf = memoryview(bytearray(4 * 1024 * 1024))
    try:
        with open(base_file_name + ".dat", "wb") as dat:
            remaining = dat_file_size
            while remaining >= data_shards * EC_LARGE_BLOCK_SIZE:
                for i in range(data_shards):
                    _copy_n(inputs[i], dat, EC_LARGE_BLOCK_SIZE, buf=buf)
                    remaining -= EC_LARGE_BLOCK_SIZE
            while remaining > 0:
                for i in range(data_shards):
                    to_read = min(remaining, EC_SMALL_BLOCK_SIZE)
                    if to_read <= 0:
                        break
                    _copy_n(inputs[i], dat, to_read, buf=buf)
                    remaining -= to_read
                    if to_read < EC_SMALL_BLOCK_SIZE:
                        inputs[i].seek(EC_SMALL_BLOCK_SIZE - to_read, 1)
    finally:
        for f in inputs:
            f.close()


def _copy_n(src, dst, n: int, bufsize: int = 4 * 1024 * 1024, buf=None) -> None:
    """Copy exactly n bytes src -> dst through `buf` (a reusable
    memoryview; allocated here when the caller passes none)."""
    if buf is None:
        buf = memoryview(bytearray(min(bufsize, n)))
    while n > 0:
        want = min(len(buf), n)
        got = src.readinto(buf[:want])
        if not got:
            raise IOError("short read during ec decode copy")
        dst.write(buf[:got])
        n -= got


def iterate_ecj_file(base_file_name: str):
    """Yield the deleted needle ids of the .ecj journal (ref
    iterateEcjFile, ec_decoder.go:123-150)."""
    path = base_file_name + ".ecj"
    if not os.path.exists(path):
        return
    from ...types import NEEDLE_ID_SIZE, bytes_to_u64

    with open(path, "rb") as f:
        while True:
            b = f.read(NEEDLE_ID_SIZE)
            if len(b) != NEEDLE_ID_SIZE:
                return
            yield bytes_to_u64(b)


def write_idx_file_from_ec_index(base_file_name: str) -> None:
    """.ecx, then a tombstone per .ecj id -> .idx (ref
    WriteIdxFileFromEcIndex, ec_decoder.go:18-43)."""
    with open(base_file_name + ".ecx", "rb") as src, open(
        base_file_name + ".idx", "wb"
    ) as dst:
        while True:
            b = src.read(1 << 20)
            if not b:
                break
            dst.write(b)
        for key in iterate_ecj_file(base_file_name):
            dst.write(entry_to_bytes(key, 0, TOMBSTONE_FILE_SIZE))


def read_ec_volume_version(base_file_name: str) -> int:
    """Volume version from the .ec00 super block (ref readEcVolumeVersion)."""
    with open(base_file_name + ".ec00", "rb") as f:
        return SuperBlock.parse(f.read(8)).version


def find_dat_file_size(base_file_name: str) -> int:
    """The original .dat's size: the largest end offset over the live
    .ecx entries (ref FindDatFileSize, ec_decoder.go:48-70). A decoded
    .dat is that many bytes of the original, shorter than it when the
    last needles were deleted."""
    version = read_ec_volume_version(base_file_name)
    dat_size = 0
    with open(base_file_name + ".ecx", "rb") as f:
        for _key, offset_units, size in iter_index(f):
            if size == TOMBSTONE_FILE_SIZE:
                continue
            stop = to_actual_offset(offset_units) + get_actual_size(size, version)
            if stop > dat_size:
                dat_size = stop
    return dat_size
