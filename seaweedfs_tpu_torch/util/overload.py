"""Per-peer circuit breakers: the client half of the overload plane.

Ported from the JAX package's util/overload.py (its circuit-breaker
section). A `CircuitBreaker` per peer, shared by every client of the
process through `BREAKERS`: closed -> open on consecutive failures or a
high shed rate (503/429 answers), half-open probes after the open window
(or after the peer's own Retry-After). An open breaker fails calls in
microseconds instead of burning a timeout per attempt, and tells the
read fan-out (client/read_fanout.py) to stop hedging into a peer that is
already shedding.

The admission half of the JAX module (the servers' priority admission
gate, its adaptive concurrency limit and the pressure signal) is not
ported.

Env knob: ``SEAWEEDFS_TPU_BREAKER`` (0 disables circuit breakers).
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Optional

from .metrics import CIRCUIT_OPEN, CIRCUIT_TRANSITIONS

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitOpenError(ConnectionError):
    """Fast-fail for calls to a peer whose breaker is open. A
    ConnectionError on purpose: every existing retry/hedge/failover path
    already treats it as 'peer unavailable' and moves on."""


class CircuitBreaker:
    """Per-peer closed/open/half-open breaker.

    Opens on `fail_threshold` consecutive failures, or when at least
    half of the last `shed_window` outcomes were sheds (503 +
    Retry-After: the peer is alive but actively load-shedding — keep
    hammering it and you ARE the overload). Half-open admits one probe
    after the open window; the probe's outcome closes or re-opens. The
    probe slot leases for `probe_timeout_s`: a probe whose caller never
    reports (cancelled mid-flight, caller died) is reclaimed after the
    lease instead of wedging allow() shut until process restart."""

    def __init__(
        self,
        peer: str,
        fail_threshold: int = 6,
        shed_window: int = 20,
        shed_trip: float = 0.5,
        open_s: float = 0.25,
        probe_timeout_s: float = 5.0,
        clock=time.monotonic,
    ):
        self.peer = peer
        self.fail_threshold = fail_threshold
        self.shed_trip = shed_trip
        self.open_s = open_s
        self.probe_timeout_s = probe_timeout_s
        self._clock = clock
        self.state = CLOSED
        self.opens = 0  # times tripped
        self._consec_fail = 0
        self._ring: deque = deque(maxlen=shed_window)  # True = shed
        self._open_until = 0.0
        self._probe_out = False
        self._probe_deadline = 0.0
        self._last_shed_t = 0.0

    # -- gate --
    def allow(self) -> bool:
        """May a request go to this peer now? Consumes the half-open
        probe slot, so callers must report the outcome via record_*
        (record_cancelled when the request is abandoned outcome-less)."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if self._clock() < self._open_until:
                return False
            self._transition(HALF_OPEN)
            return self._lease_probe()
        if self._probe_out and self._clock() < self._probe_deadline:
            return False  # half-open: one probe at a time
        # no probe out — or the in-flight probe outlived its lease
        # without reporting: reclaim the slot rather than refuse forever
        return self._lease_probe()

    def _lease_probe(self) -> bool:
        self._probe_out = True
        self._probe_deadline = self._clock() + self.probe_timeout_s
        return True

    def blocked(self) -> bool:
        """Non-consuming peek: would allow() refuse right now? (Replica
        ordering uses this so peeking never eats the half-open probe.)"""
        if self.state == CLOSED:
            return False
        if self.state == OPEN:
            return self._clock() < self._open_until
        return self._probe_out and self._clock() < self._probe_deadline

    def shedding(self) -> bool:
        """Is the peer actively load-shedding? True within ~1s of a shed
        answer — the read fan-out pauses hedging into such a pool (a
        hedge into a shedding peer is pure retry-storm fuel)."""
        return self._clock() - self._last_shed_t < 1.0

    # -- outcomes --
    def record_success(self) -> None:
        self._consec_fail = 0
        self._ring.append(False)
        self._probe_out = False
        if self.state != CLOSED:
            self._transition(CLOSED)

    def record_failure(self) -> None:
        self._consec_fail += 1
        self._ring.append(False)
        if self.state == HALF_OPEN:
            self._probe_out = False
            self._trip(self.open_s)  # failed probe: back to open
        elif self.state == CLOSED and (
            self._consec_fail >= self.fail_threshold
        ):
            self._trip(self.open_s)

    def record_cancelled(self) -> None:
        """The caller abandoned its request before an outcome was known
        (hedged reads losing their race are cancelled routinely). Says
        nothing about the peer's health — but if the request held the
        half-open probe slot it MUST be returned here, or allow()
        refuses the peer until the probe lease expires."""
        if self.state == HALF_OPEN:
            self._probe_out = False

    def record_shed(self, retry_after_s: Optional[float] = None) -> None:
        """A 503/429 shed answer (alive peer refusing load). Not a
        failure for the consecutive count — but a shed-heavy window
        trips the breaker for the peer's own Retry-After hint."""
        self._ring.append(True)
        self._last_shed_t = self._clock()
        if self.state == HALF_OPEN:
            self._probe_out = False
            self._trip(retry_after_s or self.open_s)
            return
        ring = self._ring
        if (
            self.state == CLOSED
            and len(ring) >= ring.maxlen // 2
            and sum(ring) >= len(ring) * self.shed_trip
        ):
            self._trip(retry_after_s or self.open_s)

    def _trip(self, open_for: float) -> None:
        self._transition(OPEN)
        self._open_until = self._clock() + open_for
        self.opens += 1
        self._consec_fail = 0
        self._ring.clear()

    def _transition(self, to: str) -> None:
        if to == self.state:
            return
        self.state = to
        CIRCUIT_TRANSITIONS.inc(peer=self.peer, to=to)
        CIRCUIT_OPEN.set(1.0 if to == OPEN else 0.0, peer=self.peer)


class BreakerRegistry:
    """Process-wide per-peer breakers, shared by every client of the
    process so all views of one peer's health feed one breaker."""

    def __init__(self, **breaker_kwargs):
        self._kw = breaker_kwargs
        self._by_peer: dict[str, CircuitBreaker] = {}

    def get(self, peer: str) -> CircuitBreaker:
        br = self._by_peer.get(peer)
        if br is None:
            br = self._by_peer[peer] = CircuitBreaker(peer, **self._kw)
        return br

    def peek(self, peer: str) -> Optional[CircuitBreaker]:
        return self._by_peer.get(peer)

    def reset(self) -> None:
        self._by_peer.clear()

    def stats(self) -> dict:
        return {
            p: {"state": b.state, "opens": b.opens}
            for p, b in self._by_peer.items()
        }


BREAKERS = BreakerRegistry()


def breakers_enabled() -> bool:
    return (os.environ.get("SEAWEEDFS_TPU_BREAKER", "1") or "1") not in (
        "0",
        "",
    )


def peer_breaker(peer: str) -> Optional[CircuitBreaker]:
    """The shared breaker for a peer address, or None when breakers are
    disabled (env) — callers do `br is None or br.allow()`."""
    if not breakers_enabled():
        return None
    return BREAKERS.get(peer)
