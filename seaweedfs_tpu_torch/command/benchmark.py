"""Load benchmark: concurrent writers then readers of small files, with the
reference's stats report (ref: weed/command/benchmark.go:109-541).

Writers assign a fid from the master (HTTP /dir/assign) and POST a
deterministic payload to the returned volume server; readers look up
cached vid locations and GET. All data-plane requests ride the keep-alive
FastHTTPClient (benchmark.go:281-311). Latencies land in a 0.1ms-bucket
histogram with the same percentile table.

Ported from the JAX package's command/benchmark.py, with its count=N
assign leases (`assign_batch`), the replica read fan-out
(`read_fanout`, client/read_fanout.py) and read-only passes over an
earlier run's file ids. One change: a read counts as failed unless its
body equals the payload written for that fid (the JAX reader checks the
status only), so `fids_in` carries each fid's payload seed. Not ported:
the write-path attribution legs and the early/final sub-phase samples
that bench.py reads from the JAX function.
"""

from __future__ import annotations

import asyncio
import random
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from ..client import MasterClient
from ..client.operation import AssignLease, http_assign
from ..util.fasthttp import FastHTTPClient, build_multipart


def fake_payload(seed_id: int, size: int) -> bytes:
    """Deterministic payload (ref FakeReader, benchmark.go:518-541):
    the id stamped every 8 bytes."""
    block = seed_id.to_bytes(8, "big")
    reps = size // 8 + 1
    return (block * reps)[:size]


@dataclass
class Stats:
    name: str
    start: float = 0.0
    end: float = 0.0
    completed: int = 0
    failed: int = 0
    transferred: int = 0
    # 0.1ms buckets up to 10s (ref benchmark.go:361)
    buckets: list = field(default_factory=lambda: [0] * 100_000)
    latencies_ns_min: int = 1 << 62
    latencies_ns_max: int = 0
    _sum_ms: float = 0.0
    _sumsq_ms: float = 0.0

    def record(self, dt: float, nbytes: int) -> None:
        self.completed += 1
        self.transferred += nbytes
        ms = dt * 1000
        bucket = min(int(ms * 10), len(self.buckets) - 1)
        self.buckets[bucket] += 1
        self._sum_ms += ms
        self._sumsq_ms += ms * ms
        ns = int(dt * 1e9)
        self.latencies_ns_min = min(self.latencies_ns_min, ns)
        self.latencies_ns_max = max(self.latencies_ns_max, ns)

    def percentile(self, p: float) -> float:
        target = self.completed * p / 100
        cum = 0
        for i, c in enumerate(self.buckets):
            cum += c
            if cum >= target and c:
                return i / 10
        return self.latencies_ns_max / 1e6

    def report(self, concurrency: int) -> str:
        elapsed = max(self.end - self.start, 1e-9)
        avg = self._sum_ms / max(self.completed, 1)
        var = self._sumsq_ms / max(self.completed, 1) - avg * avg
        std = var**0.5 if var > 0 else 0.0
        lines = [
            f"\n------------ {self.name} ----------",
            f"Concurrency Level:      {concurrency}",
            f"Time taken for tests:   {elapsed:.3f} seconds",
            f"Complete requests:      {self.completed}",
            f"Failed requests:        {self.failed}",
            f"Total transferred:      {self.transferred} bytes",
            f"Requests per second:    {self.completed / elapsed:.2f} [#/sec]",
            f"Transfer rate:          {self.transferred / 1024 / elapsed:.2f} [Kbytes/sec]",
            "",
            "Connection Times (ms)",
            "              min      avg        max      std",
            f"Total:        {self.latencies_ns_min / 1e6:.1f}      "
            f"{avg:.1f}       {self.latencies_ns_max / 1e6:.1f}      {std:.1f}",
            "",
            "Percentage of the requests served within a certain time (ms)",
        ]
        for p in (50, 66, 75, 80, 90, 95, 98, 99, 100):
            lines.append(f"   {p}%    {self.percentile(p):.1f} ms")
        return "\n".join(lines)


async def run_benchmark(
    master: str,
    num_files: int = 1024,
    file_size: int = 1024,
    concurrency: int = 16,
    collection: str = "",
    do_write: bool = True,
    do_read: bool = True,
    stats_out: Optional[dict] = None,
    fids_in: Optional[dict] = None,
    assign_batch: int = 1,
    read_fanout: bool = False,
) -> str:
    """Returns the human report; when `stats_out` is given it also receives
    {write_qps, write_failed, read_qps, read_failed, write_stats,
    read_stats, fids, seeds, assign_rpcs} for machine use. `fids_in`
    (the `seeds` of an earlier run: fid -> the payload seed it was
    written with) seeds the read phase, so read-only passes
    (do_write=False) re-read a previously written set and check its
    bodies.

    assign_batch > 1 leases file ids in count=N batches through an
    AssignLease (the reference benchmark's fid-reuse trick,
    ref: weed/command/benchmark.go), amortizing the per-write master
    round-trip to 1/N of a request; `assign_rpcs` counts the assigns.

    read_fanout=True routes reads through client.read_fanout.ReplicaReader
    — round-robin across replica locations with hedge-on-p99-timeout — so
    skewed read load spreads across holders instead of pinning one server
    (stats_out then also carries `read_fanout` hedge counters)."""
    out = []
    mc = MasterClient("benchmark", [master])
    await mc.start()
    try:
        await mc.wait_connected()
        # fid -> the payload seed it was written with (reads check bodies)
        seeds: dict[str, int] = dict(fids_in or {})
        fids: list[str] = list(seeds)
        http = FastHTTPClient(pool_per_host=concurrency + 4)
        if do_write:
            stats = Stats("Writing Benchmark")
            # plain deque, not asyncio.Queue: workers only ever pop
            # synchronously
            queue: deque = deque(range(num_files))

            async def fetch_lease(count: int):
                return await http_assign(http, master, count, collection)

            lease = (
                AssignLease(fetch=fetch_lease, batch=assign_batch)
                if assign_batch > 1
                else None
            )
            assigns = [0]

            async def writer() -> None:
                while True:
                    try:
                        i = queue.popleft()
                    except IndexError:
                        return
                    t0 = time.perf_counter()
                    try:
                        if lease is not None:
                            ar = await lease.take()
                        else:
                            assigns[0] += 1
                            ar = await fetch_lease(1)
                        payload, ctype = build_multipart(
                            "file", fake_payload(i, file_size)
                        )
                        headers = (
                            {"Authorization": "Bearer " + ar.auth}
                            if ar.auth
                            else None
                        )
                        st, rbody = await http.request(
                            "POST",
                            ar.url,
                            "/" + ar.fid,
                            body=payload,
                            content_type=ctype,
                            headers=headers,
                        )
                        if st >= 300:
                            raise RuntimeError(
                                f"upload: {st} {rbody[:120]!r}"
                            )
                        stats.record(time.perf_counter() - t0, file_size)
                        fids.append(ar.fid)
                        seeds[ar.fid] = i
                    except Exception:
                        stats.failed += 1

            stats.start = time.perf_counter()
            await asyncio.gather(*(writer() for _ in range(concurrency)))
            stats.end = time.perf_counter()
            if stats_out is not None:
                stats_out["write_qps"] = stats.completed / max(
                    stats.end - stats.start, 1e-9
                )
                stats_out["write_failed"] = stats.failed
                stats_out["write_stats"] = stats
                stats_out["assign_rpcs"] = (
                    lease.assign_rpcs if lease is not None else assigns[0]
                )
                stats_out["assign_batch"] = assign_batch
            out.append(stats.report(concurrency))

        if do_read and fids:
            stats = Stats("Randomly Reading Benchmark")
            reads = deque(random.choice(fids) for _ in range(num_files))
            fan = None
            if read_fanout:
                from ..client.read_fanout import ReplicaReader

                fan = ReplicaReader(http, mc.vid_map)

            async def reader() -> None:
                while True:
                    try:
                        fid = reads.popleft()
                    except IndexError:
                        return
                    t0 = time.perf_counter()
                    try:
                        if fan is not None:
                            # replica fan-out: round-robin + p99 hedging
                            try:
                                st, data = await fan.read(fid)
                            except LookupError:
                                # the vid cache hasn't learned a freshly
                                # grown volume yet: the same master RPC
                                # fallback as the plain path, which also
                                # teaches the vid map for next time
                                url = await mc.lookup_file_id_async(fid)
                                hp = url.removeprefix(
                                    "http://"
                                ).partition("/")[0]
                                st, data = await http.request(
                                    "GET", hp, "/" + fid
                                )
                        else:
                            # cache hit normally; falls back to a master
                            # RPC when the vid cache hasn't learned a
                            # freshly-grown volume yet. The hit path picks
                            # the hostport straight from the vid map.
                            hostport = mc.vid_map.pick(
                                int(fid.split(",")[0])
                            )
                            if hostport is None:
                                url = await mc.lookup_file_id_async(fid)
                                hostport = url.removeprefix(
                                    "http://"
                                ).partition("/")[0]
                            st, data = await http.request(
                                "GET", hostport, "/" + fid
                            )
                        if st != 200:
                            raise RuntimeError(f"read {fid}: {st}")
                        if data != fake_payload(seeds[fid], file_size):
                            raise RuntimeError(f"read {fid}: wrong body")
                        stats.record(time.perf_counter() - t0, len(data))
                    except Exception:
                        stats.failed += 1

            stats.start = time.perf_counter()
            await asyncio.gather(*(reader() for _ in range(concurrency)))
            stats.end = time.perf_counter()
            out.append(stats.report(concurrency))
            if stats_out is not None:
                stats_out["read_qps"] = stats.completed / max(
                    stats.end - stats.start, 1e-9
                )
                stats_out["read_failed"] = stats.failed
                stats_out["read_stats"] = stats
                if fan is not None:
                    stats_out["read_fanout"] = fan.stats()
        if stats_out is not None:
            stats_out["fids"] = fids
            stats_out["seeds"] = seeds
        await http.close()
    finally:
        await mc.stop()
    return "\n".join(out)
