"""Metadata serving fleet: shard-RANGE filer processes.

The prefix-sharded store (sharded_store.py) scales the filer namespace
across threads of ONE process; this module scales it across PROCESSES.
N filer servers each own a contiguous directory range of one crash-safe
FLEETMAP (shadow-write + fsync + atomic rename, versioned,
epoch-stamped), and the map itself routes clients — a `FleetRouter`
picks the owner by directory, and every server double-checks ownership
on arrival, FORWARDING to the true owner when a stale client (or a
mid-move map) lands a request on the wrong process. Zero-misroute
therefore never depends on client map freshness: the server-side hop is
the authority, bounded by a hop count.

Range moves between two LIVE processes ride the delta-window discipline
of the sharded store's rebalance:

    intent  — pending_move recorded in the map (crash-recoverable)
    purge   — destination drops strays from any earlier dead attempt
    copy    — entries page to the destination UNFENCED (live traffic
              keeps mutating the range; the meta-log watermark taken
              before the copy brackets what the delta must replay)
    fence   — mutations to the moving range park on an asyncio event;
              in-flight admitted mutations DRAIN before the delta read,
              so the meta log is quiescent for the range
    delta   — meta-log events since the watermark, filtered to the
              range, replay onto the destination
    commit  — bounds + epoch flip in ONE atomic map rewrite (with the
              source's cleanup obligation recorded); the fence lifts and
              parked mutations re-route themselves to the new owner
    cleanup — the source deletes its local copy of the range

A path can never resolve to two owners: before commit every map (and
every server-side ownership check) routes the range to the source, whose
fence serializes the hand-off; after commit the source's own fresh map
forwards stragglers to the destination.

Directory SPINE entries (the ancestor placeholders `_ensure_parents`
mints) are deliberately replicated fleet-wide: the owner of a leaf's
directory creates the spine locally and broadcasts the newly created
placeholders to every peer (idempotent upserts), so `ListEntries` on any
member sees its subdirectories regardless of which member owns their
contents. File entries live on exactly one owner.

Ported from the JAX package's filer/fleet.py; the FLEETMAP file holds the
same JSON, so either package reads the other's map. Forwarding, the
broadcasts and the move's pages ride the port's RPC tier (`pb/rpc.py`),
and the fence's event and the move's lock live on the serving filer's
event loop. On a destination whose store is an LSM store under the meta
gate, ingested pages land through `insert_many` under the store's lock,
and each run they seal is offered to the gate's arena by the store's
flush-path prefetch hint; until the arena's generation holds every run
of a lookup's view, that lookup is served from the host (counted
`arena_cold`), never answered absent from a stale generation.
"""

from __future__ import annotations

import asyncio
import bisect
import json
import logging
import os
import time
from typing import Optional

from ..pb import grpc_address
from ..pb.rpc import Stub
from ..util.metrics import (
    FLEET_FORWARDED,
    FLEET_INGESTED,
    FLEET_MOVES,
)
from .entry import Entry
from .sharded_store import default_bounds

_LOG = logging.getLogger(__name__)

FLEET_MAP_NAME = "FLEETMAP"
MAX_HOPS = 3  # forward chain bound: client -> stale member -> owner
_INGEST_BATCH = 512


def dir_of(full_path: str) -> str:
    """Routing key of a path: its parent directory ('/' files route to
    the first member, like the sharded store's top-level band)."""
    if full_path == "/":
        return "/"
    d = full_path.rstrip("/").rsplit("/", 1)[0]
    return d or "/"


def ancestor_dirs(full_path: str) -> list[str]:
    """Every ancestor directory of a path, root-first, '/' excluded —
    the spine the owner mints locally and broadcasts fleet-wide."""
    out: list[str] = []
    d = dir_of(full_path)
    while d != "/":
        out.append(d)
        d = dir_of(d)
    out.reverse()
    return out


def in_range(directory: str, lo: str, hi: str) -> bool:
    """[lo, hi) over directory strings; '' means unbounded on that side."""
    return (not lo or directory >= lo) and (not hi or directory < hi)


class FleetMap:
    """One committed fleet routing state. Immutable by convention —
    mutations go through copy + atomic file rewrite, never in place."""

    __slots__ = (
        "version", "epoch", "addresses", "bounds",
        "pending_move", "pending_cleanup",
    )

    def __init__(
        self,
        addresses: list[str],
        bounds: Optional[list[str]] = None,
        epoch: int = 1,
        pending_move: Optional[dict] = None,
        pending_cleanup: Optional[dict] = None,
    ):
        self.version = 1
        self.addresses = list(addresses)
        self.bounds = (
            list(bounds)
            if bounds is not None
            else default_bounds(len(addresses))
        )
        if len(self.bounds) != max(len(self.addresses) - 1, 0):
            raise ValueError(
                f"fleet map: {len(self.addresses)} members need "
                f"{len(self.addresses) - 1} bounds, got {len(self.bounds)}"
            )
        self.epoch = epoch
        self.pending_move = pending_move
        self.pending_cleanup = pending_cleanup

    # ---------------- routing ----------------
    def index_for_dir(self, directory: str) -> int:
        return bisect.bisect_right(self.bounds, directory)

    def owner_for_dir(self, directory: str) -> str:
        return self.addresses[self.index_for_dir(directory)]

    def range_of(self, index: int) -> tuple[str, str]:
        """Member's [lo, hi) directory range; '' = unbounded side."""
        lo = self.bounds[index - 1] if index > 0 else ""
        hi = self.bounds[index] if index < len(self.bounds) else ""
        return lo, hi

    def to_dict(self) -> dict:
        return {
            "version": self.version,
            "epoch": self.epoch,
            "addresses": self.addresses,
            "bounds": self.bounds,
            "pending_move": self.pending_move,
            "pending_cleanup": self.pending_cleanup,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FleetMap":
        return cls(
            addresses=list(d.get("addresses", [])),
            bounds=list(d.get("bounds", [])),
            epoch=int(d.get("epoch", 1)),
            pending_move=d.get("pending_move"),
            pending_cleanup=d.get("pending_cleanup"),
        )


def write_fleet_map(path: str, fmap: FleetMap) -> None:
    """Crash-safe map rewrite: shadow-write + fsync + atomic rename —
    a reader sees the old committed map or the new one, never a torn
    file (the SHARDMAP/fid-refs discipline)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(fmap.to_dict(), f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_fleet_map(path: str) -> FleetMap:
    with open(path) as f:
        return FleetMap.from_dict(json.load(f))


class _MapCache:
    """mtime-checked map reader shared by members and routers: one stat
    per check interval, a full re-read only when the file changed."""

    def __init__(self, path: str, check_interval_s: float = 0.05):
        self.path = path
        self.check_interval_s = check_interval_s
        self._map: Optional[FleetMap] = None
        self._mtime = -1.0
        self._checked = 0.0

    def current(self, force: bool = False) -> FleetMap:
        now = time.monotonic()
        if (
            not force
            and self._map is not None
            and now - self._checked < self.check_interval_s
        ):
            return self._map
        self._checked = now
        try:
            mtime = os.stat(self.path).st_mtime_ns
        except OSError:
            if self._map is not None:
                return self._map
            raise
        if self._map is None or mtime != self._mtime:
            self._map = read_fleet_map(self.path)
            self._mtime = mtime
        return self._map


class FleetRouter:
    """Client-side routing over the fleet map: picks the owning filer
    for a path. Reads the shared map file when one is reachable (the
    single-host shape); otherwise fetches the map from a
    seed member's FleetStatus RPC and caches it by epoch."""

    def __init__(self, map_path: str = "", seed: str = "", ttl_s: float = 0.25):
        if not map_path and not seed:
            raise ValueError("fleet router needs a map path or a seed filer")
        self._cache = _MapCache(map_path) if map_path else None
        self.seed = seed
        self.ttl_s = ttl_s
        self._map: Optional[FleetMap] = None
        self._fetched = 0.0

    def current(self, force: bool = False) -> FleetMap:
        if self._cache is not None:
            return self._cache.current(force=force)
        if self._map is None:
            raise RuntimeError("fleet router: call refresh() first")
        return self._map

    async def refresh(self, force: bool = False) -> FleetMap:
        if self._cache is not None:
            return self._cache.current(force=force)
        now = time.monotonic()
        if self._map is not None and not force and (
            now - self._fetched < self.ttl_s
        ):
            return self._map
        stub = Stub(grpc_address(self.seed), "filer")
        resp = await stub.call("FleetStatus", {}, timeout=10.0)
        if not resp.get("configured"):
            raise RuntimeError(f"filer {self.seed} is not in a fleet")
        self._map = FleetMap.from_dict(resp["map"])
        self._fetched = now
        return self._map

    def route_path(self, full_path: str) -> str:
        """HTTP address of the member owning this path's directory."""
        return self.current().owner_for_dir(dir_of(full_path))

    def route_dir(self, directory: str) -> str:
        return self.current().owner_for_dir(directory)


class FleetMember:
    """The server-side half: ownership checks, forwarding, the fence,
    ingest, and the range-move driver. One per fleet-mode FilerServer."""

    def __init__(self, map_path: str, self_addr: str, filer):
        self.map_path = map_path
        self.self_addr = self_addr
        self.filer = filer
        self._cache = _MapCache(map_path)
        self._fence: Optional[tuple[str, str]] = None
        self._fence_cleared: Optional[asyncio.Event] = None
        self._inflight = 0
        self._move_lock = asyncio.Lock()
        self.counters = {
            "forwarded": 0,
            "ingested": 0,
            "purged": 0,
            "spine_broadcasts": 0,
            "moves_committed": 0,
            "moves_failed": 0,
            "fence_waits": 0,
            "loop_refusals": 0,
        }

    # ---------------- map access ----------------
    def map(self, force: bool = False) -> FleetMap:
        return self._cache.current(force=force)

    def owner_for_dir(self, directory: str) -> str:
        return self.map().owner_for_dir(directory)

    def self_index(self, fmap: Optional[FleetMap] = None) -> int:
        fmap = fmap or self.map()
        return fmap.addresses.index(self.self_addr)

    # ---------------- admission ----------------
    def _fenced(self, directory: str) -> bool:
        f = self._fence
        return f is not None and in_range(directory, f[0], f[1])

    def _fence_event(self) -> asyncio.Event:
        if self._fence_cleared is None:
            self._fence_cleared = asyncio.Event()
            self._fence_cleared.set()
        return self._fence_cleared

    async def admit(
        self, method: str, req: dict, directory: str, mutation: bool = False
    ) -> Optional[dict]:
        """Ownership + fence gate for one RPC request. Returns None to
        serve locally — with the mutation ADMITTED under the fence when
        mutation=True (the caller MUST call finish_mutation() on every
        exit path) — or the response to return (forwarded result /
        routing error)."""
        if req.get("fleet_local"):
            # broadcast/recovery traffic: serve here regardless of the
            # map, but mutations still respect the fence
            while mutation and self._fenced(directory):
                self.counters["fence_waits"] += 1
                await self._fence_event().wait()
            if mutation:
                self._inflight += 1
            return None
        while True:
            owner = self.owner_for_dir(directory)
            if owner != self.self_addr and int(req.get("fleet_hops", 0)) > 0:
                # the sender routed here on a map NEWER than our cached
                # one (a move just committed): force-refresh before
                # bouncing the request back, or two members ping-pong it
                # across the staleness window until the hop bound trips
                owner = self.map(force=True).owner_for_dir(directory)
            if owner != self.self_addr:
                return await self.forward(method, req, owner)
            if mutation and self._fenced(directory):
                # a move of this range is committing: park until the
                # fence lifts, then re-check — ownership usually flipped
                self.counters["fence_waits"] += 1
                await self._fence_event().wait()
                continue
            if mutation:
                self._inflight += 1
            return None

    def finish_mutation(self) -> None:
        self._inflight -= 1

    async def forward(self, method: str, req: dict, owner: str) -> dict:
        hops = int(req.get("fleet_hops", 0))
        if hops >= MAX_HOPS:
            self.counters["loop_refusals"] += 1
            return {"error": "fleet routing loop", "owner": owner}
        out = dict(req)
        out["fleet_hops"] = hops + 1
        self.counters["forwarded"] += 1
        FLEET_FORWARDED.inc(op=method)
        stub = Stub(grpc_address(owner), "filer")
        return await stub.call(method, out, timeout=15.0)

    # ---------------- ingest (dst side of moves + spine broadcast) ----------------
    def ingest(self, req: dict) -> dict:
        """Direct store application: range purges, entry pages, and
        delta deletes land on the LOCAL store without touching the
        Filer (no meta-log events, no chunk frees — the bytes already
        live on this cluster and the move must not look like churn to
        this member's subscribers)."""
        store = self.filer.store
        out: dict = {}
        if "purge_lo" in req:
            n = self._delete_range_local(
                req["purge_lo"], req.get("purge_hi", "")
            )
            self.counters["purged"] += n
            out["purged"] = n
        entries = [Entry.from_dict(d) for d in req.get("entries", [])]
        if entries:
            im = getattr(store, "insert_many", None)
            if im is not None:
                im(entries)
            else:
                for e in entries:
                    store.insert_entry(e)
            self.counters["ingested"] += len(entries)
            FLEET_INGESTED.inc(len(entries))
            out["ingested"] = len(entries)
        deletes = req.get("deletes", [])
        for path in deletes:
            store.delete_folder_children(path)
            store.delete_entry(path)
        if deletes:
            out["deleted"] = len(deletes)
        return out

    async def broadcast_spine(self, entries: list[Entry]) -> None:
        """Replicate freshly minted directory placeholders to every
        other member (idempotent upserts) so any member's ListEntries
        sees its subdirectories. Awaited by the create that minted them
        — a successful create implies a visible spine fleet-wide."""
        if not entries:
            return
        fmap = self.map()
        peers = [a for a in fmap.addresses if a != self.self_addr]
        if not peers:
            return
        body = {
            "entries": [e.to_dict() for e in entries],
            "fleet_local": True,
        }
        self.counters["spine_broadcasts"] += 1

        async def one(addr: str):
            stub = Stub(grpc_address(addr), "filer")
            await stub.call("FleetIngest", body, timeout=10.0)

        results = await asyncio.gather(
            *(one(a) for a in peers), return_exceptions=True
        )
        for addr, r in zip(peers, results):
            if isinstance(r, BaseException):
                # a dead peer misses placeholders, not data: its next
                # restart re-reads the map and serves what it owns; the
                # spine self-heals on the next create under that branch
                _LOG.warning(
                    "fleet spine broadcast to %s failed: %s", addr, r
                )

    async def broadcast(self, method: str, req: dict) -> list[dict]:
        """Send one request to EVERY other member (recursive directory
        delete / directory rename: each member applies its local slice)."""
        fmap = self.map()
        peers = [a for a in fmap.addresses if a != self.self_addr]
        out = dict(req)
        out["fleet_local"] = True

        async def one(addr: str) -> dict:
            stub = Stub(grpc_address(addr), "filer")
            return await stub.call(method, out, timeout=15.0)

        results = await asyncio.gather(
            *(one(a) for a in peers), return_exceptions=True
        )
        resp = []
        for addr, r in zip(peers, results):
            if isinstance(r, BaseException):
                resp.append({"error": str(r), "member": addr})
            else:
                resp.append(r)
        return resp

    # ---------------- local range helpers ----------------
    def _collect_range(self, lo: str, hi: str) -> list[Entry]:
        return [
            e
            for d, _name, e in self.filer.store.iter_all()
            if in_range(d, lo, hi)
        ]

    def _delete_range_local(self, lo: str, hi: str) -> int:
        store = self.filer.store
        doomed = [
            e.full_path
            for d, _name, e in store.iter_all()
            if in_range(d, lo, hi)
        ]
        for path in doomed:
            store.delete_entry(path)
        return len(doomed)

    # ---------------- the range move (runs on the SOURCE) ----------------
    async def move_range(self, dst: str, lo: str, hi: str) -> dict:
        """Move [lo, hi) to the ADJACENT member `dst` under live traffic
        (see the module docstring's step ladder). Serialized per member;
        raises ValueError on a malformed move request."""
        async with self._move_lock:
            fmap = self.map(force=True)
            si = self.self_index(fmap)
            try:
                di = fmap.addresses.index(dst)
            except ValueError:
                raise ValueError(f"fleet move: {dst!r} is not a member")
            if abs(di - si) != 1:
                raise ValueError(
                    "fleet move: ranges move between ADJACENT members "
                    f"(self at {si}, dst at {di})"
                )
            my_lo, my_hi = fmap.range_of(si)
            if not lo or not hi or lo >= hi:
                raise ValueError(f"fleet move: bad range [{lo!r}, {hi!r})")
            if di == si + 1:
                # give our TAIL to the right neighbor
                if hi != my_hi or not in_range(lo, my_lo, my_hi):
                    raise ValueError(
                        f"fleet move right needs [split, {my_hi!r}), got "
                        f"[{lo!r}, {hi!r})"
                    )
            else:
                # give our HEAD to the left neighbor
                if lo != my_lo or not in_range(hi, my_lo, my_hi):
                    raise ValueError(
                        f"fleet move left needs [{my_lo!r}, split), got "
                        f"[{lo!r}, {hi!r})"
                    )
            try:
                return await self._run_move(fmap, si, di, dst, lo, hi)
            except Exception:
                self.counters["moves_failed"] += 1
                FLEET_MOVES.inc(outcome="failed")
                raise

    async def _run_move(
        self, fmap: FleetMap, si: int, di: int, dst: str, lo: str, hi: str
    ) -> dict:
        loop = asyncio.get_event_loop()
        t0 = time.perf_counter()
        # intent: crash-recoverable before any copy lands on dst
        intent = FleetMap(
            fmap.addresses, fmap.bounds, fmap.epoch,
            pending_move={"src": self.self_addr, "dst": dst,
                          "lo": lo, "hi": hi},
            pending_cleanup=fmap.pending_cleanup,
        )
        write_fleet_map(self.map_path, intent)
        ts0 = self.filer.meta_log.last_ts_ns
        dst_stub = Stub(grpc_address(dst), "filer")
        # purge: strays from an earlier dead attempt would shadow the
        # delta's deletes
        await dst_stub.call(
            "FleetIngest",
            {"purge_lo": lo, "purge_hi": hi, "fleet_local": True},
            timeout=30.0,
        )
        # copy (unfenced: live traffic keeps landing; the delta replays it)
        entries = await loop.run_in_executor(
            None, self._collect_range, lo, hi
        )
        copied = len(entries)
        for i in range(0, len(entries), _INGEST_BATCH):
            batch = entries[i : i + _INGEST_BATCH]
            await dst_stub.call(
                "FleetIngest",
                {"entries": [e.to_dict() for e in batch],
                 "fleet_local": True},
                timeout=30.0,
            )
        # fence + drain: park new mutations to the range, let admitted
        # ones finish, so the meta log is quiescent for [lo, hi)
        self._fence = (lo, hi)
        self._fence_event().clear()
        delta_ups = delta_dels = 0
        try:
            waited = 0.0
            while self._inflight > 0:
                await asyncio.sleep(0.005)
                waited += 0.005
                if waited > 10.0:
                    raise TimeoutError(
                        "fleet move: admitted mutations did not drain"
                    )
            events, _wm = self.filer.meta_log.read_since_with_watermark(
                ts0
            )
            ups: dict[str, dict] = {}
            dels: dict[str, bool] = {}
            for ev in events:
                new = ev.new_entry
                old = ev.old_entry
                if new is not None and in_range(
                    dir_of(new["full_path"]), lo, hi
                ):
                    dels.pop(new["full_path"], None)
                    ups[new["full_path"]] = new
                if ev.event_type in ("delete", "rename") and old is not None:
                    op = old["full_path"]
                    if in_range(dir_of(op), lo, hi) and (
                        new is None or new["full_path"] != op
                    ):
                        ups.pop(op, None)
                        dels[op] = True
            delta_ups, delta_dels = len(ups), len(dels)
            if ups or dels:
                await dst_stub.call(
                    "FleetIngest",
                    {"entries": list(ups.values()),
                     "deletes": list(dels),
                     "fleet_local": True},
                    timeout=30.0,
                )
            # commit: bounds + epoch flip atomically; the source's
            # cleanup obligation rides the same write
            bounds = list(fmap.bounds)
            if di == si + 1:
                bounds[si] = lo
            else:
                bounds[si - 1] = hi
            committed = FleetMap(
                fmap.addresses, bounds, fmap.epoch + 1,
                pending_move=None,
                pending_cleanup={"src": self.self_addr, "lo": lo, "hi": hi},
            )
            write_fleet_map(self.map_path, committed)
            self._cache.current(force=True)
        except Exception:
            # abort: dst never owned the range (bounds unchanged), its
            # strays are purged by the next attempt's purge step
            aborted = FleetMap(
                fmap.addresses, fmap.bounds, fmap.epoch,
                pending_move=None, pending_cleanup=fmap.pending_cleanup,
            )
            write_fleet_map(self.map_path, aborted)
            self._cache.current(force=True)
            raise
        finally:
            self._fence = None
            self._fence_event().set()
        # cleanup: our copy of the range is dead weight now; stragglers
        # routed here forward to dst off our own fresh map
        await loop.run_in_executor(None, self._delete_range_local, lo, hi)
        done = self.map(force=True)
        if (
            done.pending_cleanup
            and done.pending_cleanup.get("src") == self.self_addr
        ):
            write_fleet_map(
                self.map_path,
                FleetMap(
                    done.addresses, done.bounds, done.epoch,
                    pending_move=done.pending_move, pending_cleanup=None,
                ),
            )
            self._cache.current(force=True)
        self.counters["moves_committed"] += 1
        FLEET_MOVES.inc(outcome="committed")
        return {
            "copied": copied,
            "delta_upserts": delta_ups,
            "delta_deletes": delta_dels,
            "epoch": fmap.epoch + 1,
            "wall_s": round(time.perf_counter() - t0, 4),
        }

    # ---------------- crash recovery (before serving) ----------------
    def recover(self) -> dict:
        """Finish or roll back whatever a crash left in the map. The
        DESTINATION of an uncommitted move purges its strays (the
        committed map never routed the range to it); the SOURCE clears
        a dangling intent and finishes any committed-but-uncleaned
        local range delete."""
        out = {"purged": 0, "cleaned": 0, "intent_cleared": False}
        try:
            fmap = self.map(force=True)
        except OSError:
            return out
        pm = fmap.pending_move
        if pm and pm.get("dst") == self.self_addr:
            out["purged"] = self._delete_range_local(pm["lo"], pm["hi"])
        if pm and pm.get("src") == self.self_addr:
            write_fleet_map(
                self.map_path,
                FleetMap(
                    fmap.addresses, fmap.bounds, fmap.epoch,
                    pending_move=None,
                    pending_cleanup=fmap.pending_cleanup,
                ),
            )
            out["intent_cleared"] = True
            fmap = self.map(force=True)
        pc = fmap.pending_cleanup
        if pc and pc.get("src") == self.self_addr:
            out["cleaned"] = self._delete_range_local(pc["lo"], pc["hi"])
            write_fleet_map(
                self.map_path,
                FleetMap(
                    fmap.addresses, fmap.bounds, fmap.epoch,
                    pending_move=fmap.pending_move, pending_cleanup=None,
                ),
            )
            self._cache.current(force=True)
        return out

    def status(self) -> dict:
        fmap = self.map()
        return {
            "self": self.self_addr,
            "epoch": fmap.epoch,
            "members": len(fmap.addresses),
            "map": fmap.to_dict(),
            "range": list(fmap.range_of(self.self_index(fmap))),
            "fence": list(self._fence) if self._fence else None,
            "inflight_mutations": self._inflight,
            "counters": dict(self.counters),
        }
