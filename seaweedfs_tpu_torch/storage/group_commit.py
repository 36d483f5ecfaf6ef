"""Group-commit write worker: batched fsync with truncate rollback.

The reference funnels fsync'd writes through a per-volume worker that
batches up to 4MB / 128 requests per fsync and, if the sync fails, truncates
the .dat back and fails every request in the batch
(ref: weed/storage/volume_read_write.go:290-363). This is the asyncio
re-design: writers enqueue (needle, future); the worker appends the whole
batch, fsyncs once, and resolves the futures — one disk flush amortized over
many concurrent writers.

Batch formation is ADAPTIVE, never timed: a batch is flushed the moment the
queue drains, so a lone writer pays zero added latency. The only widening
step is one event-loop yield before draining, taken only while the previous
batch proved there are concurrent writers in flight — that single pass lets
the wakeup's other writers enqueue, growing the batch without a fixed
window (a timed hold was measured strictly worse for the lookup gate at
every concurrency, and the same holds here).

Ported from the JAX package's storage/group_commit.py; its flush span
(`trace.batch_span`) is the port's no-op span.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Optional

from .needle import Needle
from .volume import Volume
from ..util import trace
from ..util.metrics import (
    GROUP_COMMIT_BATCH_SIZE,
    GROUP_COMMIT_FSYNCS,
    WRITE_STAGE_SECONDS,
)

MAX_BATCH_BYTES = 4 * 1024 * 1024
MAX_BATCH_REQUESTS = 128


@dataclass
class _Request:
    needle: Optional[Needle]
    is_write: bool
    future: asyncio.Future
    enqueued_at: float = 0.0
    # sampled trace context of the enqueuer, so the fsync-batch flush can
    # record one span linked to every member trace
    ctx: object = None
    # multi-needle frame: the whole list appends as ONE
    # coalesced .dat extent + ONE .idx extent via write_needle_batch;
    # the future resolves with the per-needle result list
    needles: Optional[list] = None

    def data_bytes(self) -> int:
        if self.needles is not None:
            return sum(len(n.data) for n in self.needles)
        return len(self.needle.data)


class GroupCommitWorker:
    def __init__(self, volume: Volume):
        self.volume = volume
        self.queue: asyncio.Queue[_Request] = asyncio.Queue()
        self._task: Optional[asyncio.Task] = None
        # adaptive coalescing state: did the LAST flush see concurrency?
        self._concurrent = False
        self.stats = {"batches": 0, "requests": 0, "largest_batch": 0}

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.ensure_future(self._run())

    async def stop(self) -> None:
        """Cancel the worker. A batch already handed to the executor still
        lands and resolves its futures; a request taken off the queue but
        not yet handed over, and requests still queued, fail instead of
        waiting forever."""
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None
        while not self.queue.empty():
            _fail_future(self.queue.get_nowait().future,
                         RuntimeError("group-commit worker stopped"))

    async def write(self, n: Needle) -> tuple[int, int, bool]:
        fut = asyncio.get_running_loop().create_future()
        await self.queue.put(
            _Request(
                n, True, fut, enqueued_at=time.perf_counter(),
                ctx=trace.current_sampled(),
            )
        )
        return await fut

    async def delete(self, n: Needle) -> int:
        fut = asyncio.get_running_loop().create_future()
        await self.queue.put(
            _Request(
                n, False, fut, enqueued_at=time.perf_counter(),
                ctx=trace.current_sampled(),
            )
        )
        return await fut

    async def write_many(self, needles: list) -> list:
        """Append a whole multi-needle frame through the worker: the
        frame lands as one .dat extent + one .idx extent
        (Volume.write_needle_batch) inside the shared fsync batch.
        Returns the per-needle result list (tuples or Exceptions)."""
        fut = asyncio.get_running_loop().create_future()
        await self.queue.put(
            _Request(
                None, True, fut, enqueued_at=time.perf_counter(),
                ctx=trace.current_sampled(), needles=needles,
            )
        )
        return await fut

    async def _run(self) -> None:
        while True:
            batch = [await self.queue.get()]
            if self.queue.empty() and self._concurrent:
                # adaptive widening: the previous flush proved writers are
                # arriving concurrently, so yield ONE loop pass to let this
                # wakeup's other writers enqueue before draining. When the
                # queue has already drained to a lone writer the yield is
                # skipped and the flush is immediate — no fixed window.
                try:
                    await asyncio.sleep(0)
                except asyncio.CancelledError:
                    # stop() during the yield: the request already taken
                    # off the queue is not in the executor, so it fails
                    # here rather than wait forever
                    _fail_future(batch[0].future,
                                 RuntimeError("group-commit worker stopped"))
                    raise
            bytes_queued = batch[0].data_bytes()
            # drain whatever is immediately available, bounded like the
            # reference's 4MB/128 limits
            while (
                bytes_queued < MAX_BATCH_BYTES
                and len(batch) < MAX_BATCH_REQUESTS
                and not self.queue.empty()
            ):
                req = self.queue.get_nowait()
                batch.append(req)
                bytes_queued += req.data_bytes()
            self._concurrent = len(batch) > 1 or not self.queue.empty()
            self.stats["batches"] += 1
            self.stats["requests"] += len(batch)
            if len(batch) > self.stats["largest_batch"]:
                self.stats["largest_batch"] = len(batch)
            GROUP_COMMIT_BATCH_SIZE.observe(len(batch))
            GROUP_COMMIT_FSYNCS.inc()
            members = [r.ctx for r in batch if r.ctx is not None]
            with trace.batch_span(
                "group_commit.flush", members,
                vid=self.volume.id, batch=len(batch),
            ):
                await asyncio.get_running_loop().run_in_executor(
                    None, self._commit_batch, batch
                )
            done = time.perf_counter()
            for req in batch:
                if req.enqueued_at:
                    WRITE_STAGE_SECONDS.observe(
                        done - req.enqueued_at, stage="group_commit_wait"
                    )

    def _commit_batch(self, batch: list[_Request]) -> None:
        v = self.volume
        end = v.data_backend.size()
        results: list[tuple[_Request, object]] = []
        for req in batch:
            try:
                if req.needles is not None:
                    out = v.write_needle_batch(req.needles)
                elif req.is_write:
                    out = v.write_needle(req.needle, sync=False)
                else:
                    out = v.delete_needle(req.needle)
                results.append((req, out))
            except Exception as e:  # per-request failure, batch continues
                results.append((req, e))
        try:
            v.data_backend.sync()
        except Exception as sync_err:
            # data past `end` is unreliable: roll back and fail the batch
            # (ref volume_read_write.go:344-355)
            try:
                v.data_backend.truncate(end)
            except Exception:
                pass
            results = [(req, sync_err) for req, _ in results]

        for req, out in results:
            if isinstance(out, Exception):
                req.future.get_loop().call_soon_threadsafe(
                    _fail_future, req.future, out
                )
            else:
                req.future.get_loop().call_soon_threadsafe(
                    _resolve_future, req.future, out
                )


def _resolve_future(fut: asyncio.Future, value) -> None:
    if not fut.done():
        fut.set_result(value)


def _fail_future(fut: asyncio.Future, exc: Exception) -> None:
    if not fut.done():
        fut.set_exception(exc)
