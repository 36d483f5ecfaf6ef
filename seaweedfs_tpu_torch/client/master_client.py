"""MasterClient: KeepConnected stream consumer maintaining the vid ->
locations cache (ref: weed/wdclient/masterclient.go, vid_map.go).

Copied from the JAX package's client/master_client.py; the stream and
the LookupVolume calls ride the port's RPC transport (pb/rpc.py), whose
stream read returns EOF (None) at the end of the master's messages."""

from __future__ import annotations

import asyncio
import random
from typing import Optional

from ..pb import grpc_address
from ..pb.rpc import EOF, Stub
from ..util.backoff import (
    BackoffPolicy,
    deadline_after,
    remaining,
    retry_async,
    shared_retry_budget,
)
from ..util.metrics import RETRY_COUNTER


class VidMap:
    """vid -> [urls] with round-robin-ish random picking
    (ref: wdclient/vid_map.go:23-45). With a `local_dc` label the map is
    DC-aware (read affinity): lookup/KeepConnected responses
    carry each holder's data center, and `pick_ordered` serves same-DC
    replicas first — remote DCs stay in the order as late hedge targets,
    never the primary, while any local holder lives."""

    def __init__(self, local_dc: str = ""):
        self._map: dict[int, list[str]] = {}
        self._rr: dict[int, int] = {}
        self.local_dc = local_dc
        self._dc: dict[str, str] = {}  # url -> data center label

    def lookup(self, vid: int) -> list[str]:
        return list(self._map.get(vid, []))

    def pick(self, vid: int) -> Optional[str]:
        locs = self._map.get(vid)
        if not locs:
            return None
        return random.choice(locs)

    def location_dc(self, url: str) -> str:
        return self._dc.get(url, "")

    def _is_local(self, url: str) -> bool:
        dc = self._dc.get(url, "")
        # unlabeled holders count as local: a cluster that never set DC
        # labels must keep plain round-robin, not demote everyone
        return not dc or dc == self.local_dc

    def pick_ordered(self, vid: int) -> list[str]:
        """All replica locations, rotated round-robin per call: element 0
        is the primary this read should try, the rest are hedge targets in
        preference order. Successive calls for one vid walk the replica
        set so skewed load spreads across holders instead of pinning one
        server (random `pick` spreads in expectation; round-robin spreads
        deterministically, which matters when a handful of hot needles
        dominates the offered load). When this map has a `local_dc`,
        same-DC holders are served first (rotation preserved within each
        group) so steady reads never cross the WAN while a local replica
        lives."""
        locs = self._map.get(vid)
        if not locs:
            return []
        if len(locs) == 1:
            return locs  # the live list; callers read, never mutate
        i = self._rr.get(vid, 0)
        self._rr[vid] = (i + 1) % len(locs)
        order = locs[i:] + locs[:i]
        if self.local_dc and self._dc:
            near = [u for u in order if self._is_local(u)]
            if near and len(near) < len(order):
                order = near + [u for u in order if not self._is_local(u)]
        return order

    def add(self, vid: int, url: str, data_center: str = "") -> None:
        locs = self._map.setdefault(vid, [])
        if url not in locs:
            locs.append(url)
        if data_center:
            self._dc[url] = data_center

    def remove(self, vid: int, url: str) -> None:
        locs = self._map.get(vid)
        if locs and url in locs:
            locs.remove(url)
            if not locs:
                del self._map[vid]


class MasterClient:
    # reconnect pacing: starts snappy (leader elections resolve in
    # hundreds of ms), caps at 5s so a dead master quorum costs one
    # connection attempt per master per ~5s instead of a tight spin
    RECONNECT_POLICY = BackoffPolicy(base=0.2, cap=5.0, attempts=1 << 30)
    LOOKUP_POLICY = BackoffPolicy(base=0.05, cap=1.0, attempts=4)

    def __init__(self, name: str, masters: list[str], rng=None):
        self.name = name
        self.masters = masters
        self.current_master = masters[0]
        self.vid_map = VidMap()
        self._task: Optional[asyncio.Task] = None
        self._connected = asyncio.Event()
        self._rng = rng or random.Random()  # injectable for deterministic tests
        # vid-lookup micro-batching gate: concurrent VidMap
        # misses coalesce per event-loop wakeup into ONE LookupVolume
        # RPC (the BatchLookupGate shape applied to the client cache
        # miss path), single-flighted per vid
        self._vid_pending: dict[int, asyncio.Future] = {}
        self._vid_batch: list[int] = []
        self._vid_flush_scheduled = False
        self._vid_loop: Optional[asyncio.AbstractEventLoop] = None
        self._vid_tasks: set = set()
        self.vid_gate_stats = {
            "lookups": 0, "rpcs": 0, "coalesced": 0, "largest_batch": 0,
        }

    async def start(self) -> None:
        self._task = asyncio.ensure_future(self._keep_connected_loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
        # in-flight vid-lookup batches: cancel and AWAIT them, so their
        # pending futures get failed (not stranded for later callers to
        # coalesce onto) before the loop that owns them goes away
        for t in list(self._vid_tasks):
            t.cancel()
        if self._vid_tasks:
            await asyncio.gather(*self._vid_tasks, return_exceptions=True)

    async def wait_connected(self, timeout: float = 10.0) -> None:
        await asyncio.wait_for(self._connected.wait(), timeout)

    async def _keep_connected_loop(self) -> None:
        """(ref masterclient.go:47-121 — follows leader redirects).

        Reconnect attempts back off exponentially with full jitter
        (capped, so a restarted master is re-found within ~5s worst
        case) and the streak resets the moment a stream actually
        reaches connected state — replacing the old flat 0.5s spin
        that hammered a struggling quorum in lockstep.

        This loop must retry forever (it IS the client's connection to
        the cluster), so a drained shared RetryBudget cannot make it
        give up — instead it pins the redial delay at the policy cap:
        during a cluster-wide outage/partition every client converges on
        one attempt per master per ~cap seconds (bounded redial rate),
        and the budget refills from real successes the moment the
        cluster heals."""
        failures = 0
        budget = shared_retry_budget()
        while True:
            for master in self.masters:
                try:
                    await self._consume(master)
                except asyncio.CancelledError:
                    return
                except Exception:
                    pass
                if self._connected.is_set():
                    failures = 0  # the stream made it to the leader
                    budget.on_success()
                else:
                    budget.on_failure()
                self._connected.clear()
                RETRY_COUNTER.inc(op="keep_connected")
                delay = self.RECONNECT_POLICY.delay(failures, self._rng)
                failures = min(failures + 1, 16)  # cap the exponent, not time
                if (
                    failures > 1
                    and not budget.allow("keep_connected")
                ):
                    delay = self.RECONNECT_POLICY.cap
                await asyncio.sleep(delay)

    async def _consume(self, master: str) -> None:
        stub = Stub(grpc_address(master), "master")
        call = stub.bidi_stream("KeepConnected")
        try:
            await self._consume_call(call, master)
        finally:
            call.cancel()

    async def _consume_call(self, call, master: str) -> None:
        await call.write({"name": self.name})
        self.current_master = master
        while True:
            msg = await call.read()
            if msg is EOF:
                return
            url = msg.get("url")
            if url:
                dc = msg.get("data_center", "")
                for vid in msg.get("new_vids", []):
                    self.vid_map.add(int(vid), url, dc)
                for vid in msg.get("deleted_vids", []):
                    self.vid_map.remove(int(vid), url)
            leader = msg.get("leader")
            if "leader" in msg and not leader:
                # this master knows no leader (deposed / mid-election): the
                # stream is about to end; rotate rather than count as
                # connected with an empty vid cache
                return
            if not leader or leader == master:
                # only count as connected when talking to the actual
                # leader — a follower's single redirect message must not
                # satisfy wait_connected() with an empty vid cache
                self._connected.set()
            elif leader not in self.masters:
                self.masters.append(leader)

    async def lookup_file_id_async(
        self, fid: str, timeout: float = 5.0
    ) -> str:
        """Cache lookup with a master-RPC fallback on miss. Misses ride
        the vid-lookup gate: every miss of one event-loop wakeup shares
        ONE LookupVolume RPC (a cold-cache burst costs one master round
        trip, not one per request), and concurrent misses of the SAME
        vid share one in-flight future. The batched RPC keeps the
        bounded retry discipline (capped jittered backoff inside one
        absolute deadline) — a flaky master costs bounded latency,
        never an unbounded error or a bare 30s hang."""
        vid = int(fid.split(",")[0])
        url = self.vid_map.pick(vid)
        if url is None:
            # per-CALLER deadline: a rider coalescing onto a flight
            # opened with a longer budget still returns within its own
            # timeout (the shared flight keeps running for the other
            # riders; wait_for cancels only our shield). TimeoutError
            # PROPAGATES: a timed-out lookup is transient-unavailable
            # (callers retry), only a resolved flight with no holders
            # becomes the authoritative LookupError below
            await asyncio.wait_for(
                self._gated_vid_lookup(vid, timeout), timeout
            )
            url = self.vid_map.pick(vid)
        if url is None:
            raise LookupError(f"volume {vid} not found")
        return f"http://{url}/{fid}"

    # ---------------- vid-lookup gate ----------------
    def _gated_vid_lookup(self, vid: int, timeout: float = 5.0):
        """Awaitable that resolves once the batched LookupVolume round
        covering `vid` has filled (or failed to fill) the vid map."""
        self.vid_gate_stats["lookups"] += 1
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = asyncio.get_event_loop()
        if self._vid_loop is not loop:
            # fresh event loop (restart / embedded reuse — the meta
            # gate's rebind, applied here): state parked on the old
            # loop can never fire; fail it best-effort and start clean
            for stale in self._vid_pending.values():
                try:
                    if not stale.done():
                        stale.set_exception(
                            LookupError("vid gate rebound to a new loop")
                        )
                except RuntimeError:
                    pass
            self._vid_pending = {}
            self._vid_batch = []
            self._vid_flush_scheduled = False
            self._vid_loop = loop
        fut = self._vid_pending.get(vid)
        if fut is not None:
            self.vid_gate_stats["coalesced"] += 1
            return asyncio.shield(fut)  # rider: a caller's cancel must
            # not cancel the shared flight
        fut = loop.create_future()
        self._vid_pending[vid] = fut
        self._vid_batch.append(vid)
        if not self._vid_flush_scheduled:
            self._vid_flush_scheduled = True
            loop.call_soon(self._vid_flush, timeout)
        return asyncio.shield(fut)

    def _vid_flush(self, timeout: float) -> None:
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is not None and running is not self._vid_loop:
            return  # stale flush scheduled on a since-replaced loop
        self._vid_flush_scheduled = False
        batch, self._vid_batch = self._vid_batch, []
        if not batch:
            return
        self.vid_gate_stats["rpcs"] += 1
        if len(batch) > self.vid_gate_stats["largest_batch"]:
            self.vid_gate_stats["largest_batch"] = len(batch)
        t = asyncio.ensure_future(self._vid_lookup_batch(batch, timeout))
        self._vid_tasks.add(t)
        t.add_done_callback(self._vid_tasks.discard)

    async def _vid_lookup_batch(self, vids: list[int], timeout: float):
        deadline = deadline_after(timeout)

        async def one_lookup():
            stub = Stub(grpc_address(self.current_master), "master")
            return await stub.call(
                "LookupVolume",
                {"volume_ids": [str(v) for v in vids]},
                timeout=remaining(deadline, 30.0),
            )

        exc: Optional[BaseException] = None
        try:
            resp = await retry_async(
                one_lookup,
                policy=self.LOOKUP_POLICY,
                deadline=deadline,
                rng=self._rng,
                op="master_lookup",
            )
            for r in resp.get("volume_id_locations", []):
                raw = r.get("volumeId", r.get("volume_id", "0"))
                try:
                    rvid = int(str(raw).split(",")[0])
                except ValueError:
                    continue
                for loc in r.get("locations", []):
                    self.vid_map.add(
                        rvid, loc["url"], loc.get("dataCenter", "")
                    )
        except BaseException as e:
            # BaseException: CancelledError (3.8+) must ALSO resolve the
            # riders — a cancelled batch that strands its futures makes
            # every later lookup of these vids coalesce onto a dead
            # flight and hang forever
            exc = e
        finally:
            for vid in vids:
                fut = self._vid_pending.pop(vid, None)
                if fut is None or fut.done():
                    continue
                if exc is None:
                    # resolved even when the master knows no holders: the
                    # caller's vid_map.pick decides hit vs LookupError
                    fut.set_result(None)
                elif isinstance(exc, asyncio.CancelledError):
                    # riders are shielded from their own cancellation, so
                    # surface the shared flight's death as the documented
                    # failure shape, not a phantom CancelledError
                    fut.set_exception(
                        LookupError("vid lookup batch cancelled")
                    )
                else:
                    fut.set_exception(exc)
        if exc is not None and not isinstance(exc, Exception):
            raise exc  # CancelledError/KeyboardInterrupt/... propagate
