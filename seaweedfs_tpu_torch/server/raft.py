"""Raft-lite: leader election + max-volume-id consensus for multi-master.

The reference embeds chrislusf/raft solely for (a) electing one leader
among the masters and (b) agreeing on MaxVolumeId
(ref: weed/server/raft_server.go, weed/topology/cluster_commands.go,
weed/topology/topology.go:115-122). This module implements exactly that
slice with raft's election rules — randomized follower timeouts, terms,
majority votes — but no replicated log: the single piece of state
(max volume id) is monotonic, so it rides leader heartbeats and vote
replies instead of log entries.

Copied from the JAX package's server/raft.py, with its fault-injection
seam (a peer's outbound calls are tagged `faults.calling_from(address)`,
so pairwise partition rules match both ends); the RPCs ride the port's
transport (pb/rpc.py).

RPCs (registered on the master's gRPC service):
  RaftRequestVote {term, candidate, max_volume_id}
      -> {granted, term, max_volume_id}
  RaftAppendEntries {term, leader, max_volume_id}     # leader heartbeat
      -> {ok, term, max_volume_id}
"""

from __future__ import annotations

import asyncio
import random
import time
from typing import Callable, List, Optional

from ..pb import grpc_address
from ..pb.rpc import Stub
from ..util import faults

HEARTBEAT_INTERVAL = 0.15
ELECTION_TIMEOUT_RANGE = (0.45, 0.9)

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"


class RaftLite:
    def __init__(
        self,
        self_address: str,
        peers: Optional[List[str]] = None,
        get_max_volume_id: Callable[[], int] = lambda: 0,
        adjust_max_volume_id: Callable[[int], None] = lambda vid: None,
        state_file: str = "",
    ):
        self.address = self_address
        # peers includes self (ref raft_server.go peers handling)
        self.peers = sorted(set((peers or [])) | {self_address})
        self.get_max_volume_id = get_max_volume_id
        self.adjust_max_volume_id = adjust_max_volume_id

        self.term = 0
        self.voted_for: Optional[str] = None
        # durable (term, voted_for, max_volume_id): raft's persistence
        # contract — a restarted node must not vote twice in one term or
        # regress the committed id (ref raft's currentTerm/votedFor rules;
        # the reference persists them via its raft log + snapshot dir)
        self.state_file = state_file
        if state_file:
            self._load_state()
        self.state = FOLLOWER if len(self.peers) > 1 else LEADER
        self.leader_address: Optional[str] = (
            self_address if len(self.peers) == 1 else None
        )
        self._last_heartbeat = time.monotonic()
        self._last_quorum_contact = time.monotonic()
        self._task: Optional[asyncio.Task] = None
        self._shutdown = False

    # ---------------- durable state ----------------
    def _load_state(self) -> None:
        import json

        try:
            with open(self.state_file) as f:
                st = json.load(f)
            # parse everything before assigning anything: a malformed file
            # must leave state fully fresh, not half-loaded
            term = int(st.get("term", 0))
            voted_for = st.get("voted_for") or None
            max_vid = int(st.get("max_volume_id", 0))
        except (OSError, ValueError, TypeError, AttributeError):
            return  # unreadable/foreign file: start from fresh state
        self.term = term
        self.voted_for = voted_for
        self.adjust_max_volume_id(max_vid)

    def _persist(self) -> None:
        """Write (term, voted_for, max_volume_id) if anything changed.
        Cheap to call from hot paths: no-op when the snapshot is current."""
        if not self.state_file:
            return
        snap = (self.term, self.voted_for, self.get_max_volume_id())
        if snap == getattr(self, "_persisted_snap", None):
            return
        import json
        import os

        tmp = self.state_file + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(
                    {
                        "term": snap[0],
                        "voted_for": snap[1],
                        "max_volume_id": snap[2],
                    },
                    f,
                )
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.state_file)
            self._persisted_snap = snap
        except OSError as e:
            # degraded to in-memory; say so once, not per heartbeat
            if not getattr(self, "_persist_warned", False):
                self._persist_warned = True
                import logging

                logging.getLogger(__name__).info(
                    "raft state persistence to %s failed (%s); running "
                    "in-memory", self.state_file, e,
                )

    # ---------------- public state ----------------
    @property
    def is_leader(self) -> bool:
        return self.state == LEADER

    @property
    def single_node(self) -> bool:
        return len(self.peers) == 1

    def others(self) -> List[str]:
        return [p for p in self.peers if p != self.address]

    def majority(self) -> int:
        return len(self.peers) // 2 + 1

    # ---------------- lifecycle ----------------
    def start(self) -> None:
        if not self.single_node:
            self._task = asyncio.ensure_future(self._run())

    async def stop(self) -> None:
        self._shutdown = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass

    # ---------------- main loop ----------------
    async def _run(self) -> None:
        while not self._shutdown:
            try:
                if self.state == LEADER:
                    await self._lead()
                else:
                    await self._follow_or_campaign()
            except asyncio.CancelledError:
                return
            except Exception:
                await asyncio.sleep(HEARTBEAT_INTERVAL)

    async def _follow_or_campaign(self) -> None:
        timeout = random.uniform(*ELECTION_TIMEOUT_RANGE)
        await asyncio.sleep(HEARTBEAT_INTERVAL / 2)
        if time.monotonic() - self._last_heartbeat < timeout:
            return
        await self._campaign()

    async def _broadcast(self, method: str, req: dict) -> Optional[List[dict]]:
        """Send a unary RPC to every other peer in parallel. Unreachable
        peers are dropped; None means a peer reported a higher term and
        we stepped down."""

        async def one(peer: str) -> Optional[dict]:
            try:
                # tagged with our own address so pairwise `partition`
                # fault rules can match both endpoints of this hop
                with faults.calling_from(self.address):
                    return await Stub(grpc_address(peer), "master").call(
                        method, req, timeout=1.0
                    )
            except Exception:
                return None

        replies = await asyncio.gather(*(one(p) for p in self.others()))
        alive = [r for r in replies if r is not None]
        for resp in alive:
            if int(resp.get("term", 0)) > self.term:
                self._step_down(int(resp["term"]))
                return None
        return alive

    async def _campaign(self) -> None:
        self.state = CANDIDATE
        self.term += 1
        term = self.term
        self.voted_for = self.address
        self.leader_address = None
        self._persist()
        votes = 1
        replies = await self._broadcast(
            "RaftRequestVote",
            {
                "term": term,
                "candidate": self.address,
                "max_volume_id": self.get_max_volume_id(),
            },
        )
        if replies is None:
            return  # stepped down
        for resp in replies:
            if resp.get("granted"):
                votes += 1
                # voters report their max so a new leader never regresses
                self.adjust_max_volume_id(int(resp.get("max_volume_id", 0)))
        if self.state != CANDIDATE or self.term != term:
            return  # someone else won meanwhile
        if votes >= self.majority():
            self.state = LEADER
            self.leader_address = self.address
            self._last_quorum_contact = time.monotonic()
        else:
            self.state = FOLLOWER
            self._last_heartbeat = time.monotonic()  # back off before retry

    async def _lead(self) -> None:
        replies = await self._broadcast(
            "RaftAppendEntries",
            {
                "term": self.term,
                "leader": self.address,
                "max_volume_id": self.get_max_volume_id(),
            },
        )
        if replies is None:
            return  # stepped down
        for resp in replies:
            self.adjust_max_volume_id(int(resp.get("max_volume_id", 0)))
        # A leader partitioned from the quorum must stop acting as one,
        # or it would keep assigning fids alongside the new leader the
        # majority elects (classic raft leader lease).
        if 1 + len(replies) >= self.majority():
            self._last_quorum_contact = time.monotonic()
        elif (
            time.monotonic() - self._last_quorum_contact
            > ELECTION_TIMEOUT_RANGE[1]
        ):
            self.state = FOLLOWER
            self.leader_address = None
            self._last_heartbeat = time.monotonic()
        await asyncio.sleep(HEARTBEAT_INTERVAL)

    async def commit_max_volume_id(self, vid: int) -> bool:
        """Synchronously replicate a freshly assigned max volume id to a
        majority before it is used, so a leader crash immediately after
        allocation can never roll volume ids back (the reference commits
        MaxVolumeIdCommand through the raft log before the id is handed
        out — topology/cluster_commands.go, topology.go:115-122)."""
        self.adjust_max_volume_id(vid)
        if self.single_node:
            self._persist()
            return True
        if not self.is_leader:
            return False
        replies = await self._broadcast(
            "RaftAppendEntries",
            {
                "term": self.term,
                "leader": self.address,
                "max_volume_id": max(self.get_max_volume_id(), vid),
            },
        )
        if replies is None:
            return False  # stepped down
        acks = 1 + sum(1 for r in replies if r.get("ok"))
        if acks >= self.majority():
            self._persist()  # the committed id must survive a full restart
            return True
        return False

    def _step_down(self, term: int) -> None:
        self.term = term
        self.state = FOLLOWER
        self.voted_for = None
        self._last_heartbeat = time.monotonic()
        self._persist()

    # ---------------- RPC handlers ----------------
    async def handle_request_vote(self, req: dict) -> dict:
        term = int(req.get("term", 0))
        candidate = req.get("candidate", "")
        if term > self.term:
            self._step_down(term)
        granted = term >= self.term and self.voted_for in (None, candidate)
        self.adjust_max_volume_id(int(req.get("max_volume_id", 0)))
        if granted:
            self.term = term
            self.voted_for = candidate
            self._last_heartbeat = time.monotonic()
            self._persist()  # after adjust: the snapshot carries the max id
        return {
            "granted": granted,
            "term": self.term,
            "max_volume_id": self.get_max_volume_id(),
        }

    async def handle_append_entries(self, req: dict) -> dict:
        term = int(req.get("term", 0))
        if term < self.term:
            return {
                "ok": False,
                "term": self.term,
                "max_volume_id": self.get_max_volume_id(),
            }
        if term > self.term or self.state != FOLLOWER:
            self._step_down(term)
        self.term = term
        self.leader_address = req.get("leader", "")
        self._last_heartbeat = time.monotonic()
        self.adjust_max_volume_id(int(req.get("max_volume_id", 0)))
        self._persist()  # no-op unless term/vote/max-id advanced
        return {
            "ok": True,
            "term": self.term,
            "max_volume_id": self.get_max_volume_id(),
        }
