"""Capped, jittered exponential backoff with deadline propagation, plus
the shared RetryBudget that keeps retries from amplifying an overload.

Shared by every serving-path retry loop (master-client lookups, EC remote
shard reads, keep-connected reconnects) so they all have the same shape:
full-jitter delays (AWS architecture blog's `random(0, min(cap,
base*2^k))` — the variant that best de-correlates a thundering herd), a
hard attempt cap, and an absolute deadline that both
truncates sleeps and refuses to start attempts it cannot finish. Pass a
seeded `random.Random` for deterministic tests.

The **RetryBudget** (the gRPC retry-throttling shape) is a token bucket
refilled by *successes*: each success deposits `ratio` (default 0.1)
tokens, each retryable failure withdraws one, and retries are permitted
only while the bucket holds more than half its capacity. Under a healthy
peer the bucket stays full and every retry goes through; under a failing
or overloaded peer the bucket drains in ~`max_tokens` failures and
retries are *suppressed* (`retries_suppressed_total{op}`) until real
successes refill it — so the aggregate retry rate is capped at ~`ratio`
of successful traffic and a brownout cannot snowball into a retry storm.
One process-global budget (`shared_retry_budget()`) is consulted by
`retry_async` and by the EC remote-shard reads; loops that must retry
forever (keep-connected) fall back to their capped delay when the budget
says no, instead of giving up.

Copied from the JAX package's util/backoff.py; its callers in the port
are `client/master_client.py` (lookups and the keep-connected loop) and
the remote-shard reads of server/volume_ec.py.
"""

from __future__ import annotations

import asyncio
import random
import threading
import time
from dataclasses import dataclass
from typing import Awaitable, Callable, Optional

from .metrics import RETRIES_SUPPRESSED, RETRY_COUNTER


@dataclass(frozen=True)
class BackoffPolicy:
    base: float = 0.05  # first-retry delay upper bound (seconds)
    cap: float = 2.0  # per-delay ceiling
    multiplier: float = 2.0
    attempts: int = 4  # total tries, including the first

    def delay(self, attempt: int, rng: random.Random) -> float:
        """Full-jitter delay before retry number `attempt` (0-based)."""
        return rng.uniform(0.0, min(self.cap, self.base * self.multiplier**attempt))


DEFAULT_POLICY = BackoffPolicy()


class RetryBudget:
    """Token-bucket retry throttle (the gRPC retryThrottling shape).

    Starts full; `on_success()` deposits `ratio` tokens (capped),
    `on_failure()` withdraws 1, and `allow(op)` permits a retry only
    while the bucket holds more than half its capacity — counting every
    refusal into `retries_suppressed_total{op}`. Thread-safe: consulted
    from the event loop and from maintenance threads alike."""

    def __init__(self, ratio: float = 0.1, max_tokens: float = 100.0):
        self.ratio = ratio
        self.max_tokens = max_tokens
        self.tokens = max_tokens
        self._lock = threading.Lock()

    def on_success(self) -> None:
        with self._lock:
            self.tokens = min(self.max_tokens, self.tokens + self.ratio)

    def on_failure(self) -> None:
        with self._lock:
            self.tokens = max(0.0, self.tokens - 1.0)

    def allow(self, op: str = "") -> bool:
        with self._lock:
            ok = self.tokens > self.max_tokens / 2.0
        if not ok:
            RETRIES_SUPPRESSED.inc(op=op or "unknown")
        return ok

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "tokens": round(self.tokens, 2),
                "max_tokens": self.max_tokens,
                "ratio": self.ratio,
            }


# the process budget's size and refill ratio: retries are capped at about
# a tenth of successful traffic, and a sick peer drains it in ~50 failures
RETRY_BUDGET_TOKENS = 100.0
RETRY_BUDGET_RATIO = 0.1

_SHARED_BUDGET = RetryBudget(ratio=RETRY_BUDGET_RATIO,
                             max_tokens=RETRY_BUDGET_TOKENS)


def shared_retry_budget() -> RetryBudget:
    """The process-wide retry budget every retry loop consults. The
    transports (`FastHTTPClient.request_full`, `Stub.call`) deposit a
    success for every completed response."""
    return _SHARED_BUDGET


def deadline_after(seconds: Optional[float]) -> Optional[float]:
    """Relative budget -> absolute time.monotonic() deadline (None passes
    through: no deadline)."""
    return None if seconds is None else time.monotonic() + seconds


def remaining(deadline: Optional[float], default: Optional[float] = None,
              floor: float = 0.001) -> Optional[float]:
    """Seconds left until an absolute deadline, for per-call timeouts.
    None deadline -> `default`. Never returns less than `floor`, so a
    just-expired deadline yields a timeout that fails fast rather than a
    negative value some APIs treat as infinite."""
    if deadline is None:
        return default
    return max(floor, deadline - time.monotonic())


_SHARED = object()  # sentinel: "use the process-wide retry budget"


async def retry_async(
    fn: Callable[[], Awaitable],
    *,
    policy: BackoffPolicy = DEFAULT_POLICY,
    deadline: Optional[float] = None,
    retry_on: tuple = (Exception,),
    rng: Optional[random.Random] = None,
    op: str = "",
    budget=_SHARED,
) -> object:
    """Run `fn()` (a zero-arg coroutine factory) with backoff.

    `deadline` is absolute (time.monotonic()); sleeps are truncated to it
    and no retry starts past it — the budget propagates into `fn` via
    `remaining(deadline)` at the call site. The last exception is re-raised
    when attempts or deadline run out. Retries count into
    seaweedfs_tpu_retries_total{op=...}.

    `budget` is the shared RetryBudget by default: retryable failures
    withdraw, and a drained budget SUPPRESSES further retries (the last
    exception surfaces immediately) so a sick peer costs each caller one
    attempt, not a storm. Successes deposit ONLY for an explicitly
    passed budget — the shared one is already fed by the transports
    (FastHTTPClient.request_full and Stub.call deposit every completed
    response), and depositing here too would double the effective
    retry-to-success ratio. Pass budget=None to opt a loop out.
    """
    rng = rng or random
    deposit = budget is not _SHARED
    if budget is _SHARED:
        budget = shared_retry_budget()
    last: Optional[BaseException] = None
    for attempt in range(policy.attempts):
        try:
            result = await fn()
        except retry_on as e:
            last = e
            if budget is not None:
                budget.on_failure()
        else:
            if budget is not None and deposit:
                budget.on_success()
            return result
        if attempt == policy.attempts - 1:
            break
        if budget is not None and not budget.allow(op):
            break
        d = policy.delay(attempt, rng)
        if deadline is not None:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            d = min(d, left)
        if op:
            RETRY_COUNTER.inc(op=op)
        await asyncio.sleep(d)
        if deadline is not None and time.monotonic() >= deadline:
            break
    assert last is not None
    raise last
