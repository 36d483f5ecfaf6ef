"""Replica read fan-out: round-robin GET routing with tail hedging.

The serving read plane replicates volumes, but the reference client
pinned each GET to one randomly-picked location — under zipfian load the hottest needles all land on whichever
replica the picker favors that second, so one server saturates while its
peers idle. This module spreads reads two ways:

- **round-robin** across the replica set (`VidMap.pick_ordered`): each
  successive read of a vid starts at the next holder, so steady skew
  spreads deterministically;
- **hedge on p99 timeout**: when the primary attempt has not answered
  within the reader's live p99 estimate (clamped to a floor/cap), a
  second request is launched at the next replica and the first response
  wins. A slow replica — GC pause, scrub burst, brownout — costs the
  hedge threshold, not the full stall (the classic tail-at-scale trick).
  Hedges are bounded to one per read and only fire when a second replica
  exists, so worst-case amplification is 2x on the slow tail only.

Ported from the JAX package's client/read_fanout.py. Its `trace.flag`
promotion flags are no-ops in the port, as util/trace.py samples
nothing yet.
"""

from __future__ import annotations

import asyncio
import time
from typing import Optional

from ..ops.loadgen import LogHistogram
from ..util import overload, trace
from ..util.backoff import shared_retry_budget


class ReplicaReader:
    """Round-robin + hedged GETs over a FastHTTPClient.

    `vid_map` is a MasterClient.vid_map (or anything with
    `pick_ordered(vid) -> list[hostport]`). The hedge threshold tracks
    the observed p99 (from this reader's own latency histogram), clamped
    to [hedge_floor_s, hedge_cap_s]; until `min_samples` responses have
    been seen it stays at the cap so a cold start cannot hedge-storm."""

    def __init__(
        self,
        http,
        vid_map,
        hedge_floor_s: float = 0.002,
        hedge_cap_s: float = 0.25,
        min_samples: int = 100,
        cross_dc_hedge_s: float = 0.05,
    ):
        self.http = http
        self.vid_map = vid_map
        self.hedge_floor_s = hedge_floor_s
        self.hedge_cap_s = hedge_cap_s
        self.min_samples = min_samples
        # latency budget before hedging across a DC boundary:
        # a DC-aware vid map orders same-DC replicas first, so when the
        # next hedge target is REMOTE the p99 trigger is floored at this
        # budget — a local blip shorter than the budget waits out the
        # local primary instead of paying a WAN round-trip. Correctness
        # hedges (error cross-check, dead-primary failover) ignore it:
        # a wrong answer is worse than a slow one.
        self.cross_dc_hedge_s = cross_dc_hedge_s
        # how long an ERROR answer (exception / 404 / 5xx) waits for a
        # slower peer that might still produce a 200 before being
        # accepted: generous relative to the hedge cap (the error might
        # be a diverged replica lying), but bounded (a hung peer must
        # not stall a read whose answer is in hand forever)
        self.error_wait_s = max(hedge_cap_s, 1.0)
        self.hist = LogHistogram()
        self.reads = 0  # total reads routed through this reader
        self.hedges = 0  # hedge requests launched
        self.hedge_wins = 0  # reads answered by the hedge, not the primary
        self.hedges_suppressed = 0  # hedges withheld: target pool was
        # shedding / breaker open, or the shared retry budget ran dry
        self.cross_dc_hedges_deferred = 0  # latency hedges whose trigger
        # was raised to the cross-DC budget (remote next-replica)
        self._vid_of: dict[str, int] = {}  # fid -> vid memo (fids are
        # immutable strings; the split+int per read is measurable at
        # serving QPS rates on a shared core)
        self._thresh_cache: tuple[int, float] = (-1, hedge_cap_s)

    def hedge_threshold(self) -> float:
        # the p99 estimate walks the 96-bucket histogram — per-read on
        # the hot path it would be the very overhead this module shaves;
        # refresh every 128 samples instead (the estimate only drifts as
        # the histogram does)
        at, value = self._thresh_cache
        count = self.hist.count
        if count - at < 128 and at >= 0:
            return value
        if count < self.min_samples:
            value = self.hedge_cap_s
        else:
            value = min(
                max(self.hist.percentile(99), self.hedge_floor_s),
                self.hedge_cap_s,
            )
        self._thresh_cache = (count, value)
        return value

    def _vid(self, fid: str) -> int:
        vid = self._vid_of.get(fid)
        if vid is None:
            if len(self._vid_of) > (1 << 20):  # runaway-fid backstop
                self._vid_of.clear()
            vid = self._vid_of[fid] = int(fid.split(",")[0])
        return vid

    def _alive(self, order: list) -> list:
        """Drop replicas whose circuit breaker is open (non-consuming
        peek — probes stay with callers that report outcomes). All-open
        falls back to the original order: the read must still be tried,
        and the breakers' half-open probes are how the pool heals."""
        if len(order) <= 1:
            return order
        reg = overload.BREAKERS
        alive = [u for u in order if not self._blocked(reg, u)]
        return alive or order

    @staticmethod
    def _blocked(reg, url: str) -> bool:
        br = reg.peek(url)
        return br is not None and br.blocked()

    def _cross_dc(self, url: str) -> bool:
        """Whether `url` sits in a different data center than this
        reader's vid map. Duck-typed: plain VidMaps (and the bare stand-ins
        tests use) have no DC labels and always read as local."""
        vm = self.vid_map
        local = getattr(vm, "local_dc", "")
        if not local:
            return False
        dc_of = getattr(vm, "location_dc", None)
        if dc_of is None:
            return False
        dc = dc_of(url)
        return bool(dc) and dc != local

    def _may_hedge(self, peer: str, correctness: bool = False) -> bool:
        """Gate every EXTRA request: paused while the target is shedding
        or breaker-blocked (a hedge into an overloaded pool is retry-storm
        fuel), and — for latency hedges only — capped by the shared retry
        budget so hedges stay a fraction of successful traffic. The error
        cross-check passes ``correctness=True``: it is a WRONG-ANSWER
        guard (a tail-sync-lagging replica 404s needles its peers hold),
        so a retry budget drained by unrelated failures must not suppress
        it — only the target's own breaker/shed state may."""
        br = overload.BREAKERS.peek(peer)
        if br is not None and (br.blocked() or br.shedding()):
            self.hedges_suppressed += 1
            return False
        if correctness:
            return True
        bud = shared_retry_budget()
        if bud is not None and not bud.allow("hedge"):
            self.hedges_suppressed += 1
            return False
        return True

    def read_nowait(self, fid: str):
        """An awaitable for GET /{fid} — the allocation-light form of
        `read()`: for single-holder vids (nothing to hedge to) this
        returns the pooled client's request coroutine DIRECTLY, no extra
        frame; multi-holder vids get the full hedged path. The rotation
        taken here is the one the hedged path uses (it must not rotate
        again, or even replica counts would re-align every read onto one
        primary)."""
        vid = self._vid(fid)
        order = self.vid_map.pick_ordered(vid)
        if len(order) == 1:
            self.reads += 1
            return self.http.request("GET", order[0], "/" + fid)
        return self._read_ordered(fid, vid, order)

    def read(self, fid: str):
        """An awaitable for GET /{fid} from the fid's replica set ->
        (status, body). Raises LookupError when no location is known."""
        vid = self._vid(fid)
        return self._read_ordered(fid, vid, self.vid_map.pick_ordered(vid))

    async def _read_ordered(
        self, fid: str, vid: int, order: list
    ) -> tuple[int, bytes]:
        if not order:
            raise LookupError(f"volume {vid} not found in cache")
        self.reads += 1
        target = "/" + fid
        order = self._alive(order)
        if len(order) == 1:
            # single holder (or every other holder breaker-blocked):
            # nothing to hedge to, and the p99 estimate only feeds the
            # hedge threshold — skip the timing machinery (measurable at
            # serving QPS rates on a shared core)
            return await self.http.request("GET", order[0], target)
        t0 = time.perf_counter()

        threshold = self.hedge_threshold()
        if self._cross_dc(order[1]):
            # next replica is across the WAN: only hedge past the
            # cross-DC latency budget (a local p99 blip is cheaper to
            # wait out than a remote round-trip is to launch)
            if self.cross_dc_hedge_s > threshold:
                threshold = self.cross_dc_hedge_s
                self.cross_dc_hedges_deferred += 1
        primary = asyncio.ensure_future(
            self.http.request("GET", order[0], target)
        )
        fast = None
        try:
            fast = await asyncio.wait_for(
                asyncio.shield(primary), threshold
            )
        except asyncio.TimeoutError:
            pass
        except asyncio.CancelledError:
            primary.cancel()
            raise
        except Exception:
            # primary FAILED fast (dead replica, reset): fail over to the
            # next holder outright — a crashed peer must cost one extra
            # round-trip, not 1/N of all reads until the vid map learns.
            # Bounded by the shared retry budget: a mass-failure event
            # drains it and the failovers stop amplifying the outage.
            bud = shared_retry_budget()
            if bud is not None:
                bud.on_failure()
                if not bud.allow("read_failover"):
                    self.hedges_suppressed += 1
                    raise
            self.hedges += 1
            trace.flag(trace.FLAG_HEDGE)
            st, body = await self.http.request("GET", order[1], target)
            if st == 200:
                self.hedge_wins += 1
            self._record_ok(t0, st)
            return st, body
        if fast is not None:
            st, body = fast
            if st == 200:
                self._record_ok(t0, st)
                return st, body
            # primary answered fast with an ERROR status: one cross-check
            # against the next replica before trusting it — a tail-sync-
            # lagging or diverged replica 404s needles its peers hold.
            # Legit misses pay one extra round-trip; hot-path 200s pay
            # nothing. OUTSIDE the try above: a cross-check failure is
            # the peer's problem, never a reason to re-run the primary
            # failover (the primary's answer is in hand and stands).
            if not self._may_hedge(order[1], correctness=True):
                return st, body  # suppressed: the primary's answer stands
            self.hedges += 1
            trace.flag(trace.FLAG_HEDGE)
            try:
                # bounded: a hung cross-check peer must not stall a read
                # whose answer is already in hand
                st2, body2 = await asyncio.wait_for(
                    self.http.request("GET", order[1], target),
                    self.error_wait_s,
                )
            except asyncio.CancelledError:
                raise
            except Exception:
                return st, body
            if st2 == 200:
                self.hedge_wins += 1
                self._record_ok(t0, st2)
                return st2, body2
            return st, body  # peers agree: the primary's answer stands
        # primary is past p99: race a hedge on the next replica — and a
        # promotion flag, so the trace that had to hedge is kept by the
        # tail sampler even when it was not head-sampled. PAUSED while
        # the hedge target is shedding/breaker-blocked or the shared
        # retry budget is dry: when the pool is overloaded, the hedge
        # that usually shaves the tail is instead the 2x amplifier that
        # turns brownout into collapse — wait out the primary.
        if not self._may_hedge(order[1]):
            try:
                st, body = await primary
            except asyncio.CancelledError:
                primary.cancel()
                raise
            self._record_ok(t0, st)
            return st, body
        self.hedges += 1
        trace.flag(trace.FLAG_HEDGE)
        hedge = asyncio.ensure_future(
            self.http.request("GET", order[1], target)
        )

        def ok(t) -> bool:
            return (
                t.done()
                and not t.cancelled()
                and t.exception() is None
                and t.result()[0] == 200
            )

        try:
            await asyncio.wait(
                {primary, hedge}, return_when=asyncio.FIRST_COMPLETED
            )
            winner = next((t for t in (primary, hedge) if ok(t)), None)
            if winner is None and not (primary.done() and hedge.done()):
                # the first completion was an ERROR — an exception, or a
                # degraded replica's instant 404/503 (tail-sync lag,
                # injected http_error): wait out the other attempt
                # (BOUNDED — a hung peer must not stall past the cap)
                # rather than crowning the error over a healthy-but-slow
                # peer
                await asyncio.wait(
                    {t for t in (primary, hedge) if not t.done()},
                    timeout=self.error_wait_s,
                )
                winner = next(
                    (t for t in (primary, hedge) if ok(t)), None
                )
        except asyncio.CancelledError:
            primary.cancel()
            hedge.cancel()
            raise
        if winner is None:
            # neither attempt produced a 200: surface the PRIMARY's
            # outcome (its holder owns this read's rotation) — error
            # statuses/latencies stay out of the hedge-threshold
            # histogram so instant failures can't shrink the p99. A
            # still-pending attempt at this point hung past the cap:
            # cancel it (drained via wait, see the loser comment below).
            pending = {t for t in (primary, hedge) if not t.done()}
            for t in pending:
                t.cancel()
            if pending:
                await asyncio.wait(pending)
            for t in (primary, hedge):
                if not t.cancelled() and t.exception() is None:
                    return t.result()
            for t in (primary, hedge):
                if not t.cancelled() and t.exception() is not None:
                    raise t.exception()
            raise TimeoutError(
                f"read {fid}: every replica attempt hung past the "
                f"{self.error_wait_s}s error-wait cap"
            )
        if winner is hedge:
            self.hedge_wins += 1
        loser = hedge if winner is primary else primary
        if not loser.done():
            loser.cancel()
            # the losing attempt holds a pooled connection mid-response;
            # let the cancellation unwind before the pool can reuse it.
            # asyncio.wait keeps the LOSER's CancelledError inside its
            # task while an EXTERNAL cancellation of this coroutine still
            # propagates from the await — `await loser` could not tell
            # the two apart (both surface as CancelledError here).
            await asyncio.wait({loser})
        if not loser.cancelled():
            loser.exception()  # retrieved: no "never retrieved" warning
        st, body = winner.result()
        self._record_ok(t0, st)
        return st, body

    def _record_ok(self, t0: float, st: int) -> None:
        """Feed the hedge-threshold histogram from SUCCESSFUL reads only:
        an instant 404/503 is not evidence that reads are fast, and
        letting it shrink the p99 estimate would hedge-storm exactly when
        replicas degrade."""
        if st == 200:
            self.hist.record(time.perf_counter() - t0)

    def stats(self) -> dict:
        return {
            "reads": self.reads,
            "hedges": self.hedges,
            "hedge_wins": self.hedge_wins,
            "hedges_suppressed": self.hedges_suppressed,
            "cross_dc_hedges_deferred": self.cross_dc_hedges_deferred,
            "hedge_threshold_ms": round(self.hedge_threshold() * 1e3, 2),
        }
