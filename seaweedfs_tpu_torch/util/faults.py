"""Deterministic, seed-driven fault injection for the serving paths.

A `FaultPlan` is a schedule of `FaultRule`s keyed by (operation, target):
"the 3rd write_at on volume 7's .dat fails with EIO", "10% of
VolumeEcShardRead RPCs to host B see 200ms latency then a reset". The plan
is consulted from these seams:

- the backend-storage file interface (`storage/backend.py`): short/torn
  writes, mid-write crash, EIO, fsync failure, read latency, bit flips;
  the vacuum's copy reads through it whenever a plan is active;
- the RPC client (`pb/rpc.py` Stub.call/server_stream): connection reset,
  latency, hang-until-deadline, partitions;
- the HTTP client (`util/fasthttp.py` FastHTTPClient.request_full):
  connection reset, latency, synthesized 5xx;
- the HTTP server (`server/serving_core.py`): the same faults at request
  arrival.

Every probabilistic decision draws from a per-rule `random.Random` seeded
from (plan seed, rule index, rule key), so a plan replays identically for a
given seed and operation sequence regardless of unrelated interleaving.

Activation: `install_plan()` programmatically, or the environment variable
`SEAWEEDFS_TPU_FAULTS` naming a JSON plan file (or carrying inline JSON)
read once at import. With neither, `_PLAN` stays None and every seam is a
single module-attribute load plus an `is None` check.

Crash semantics: a rule with fault="crash" performs a torn write (a prefix
of the payload) and then marks the plan dead; every later faultable
operation raises `SimulatedCrash`, like syscalls in a killed process. In
particular the write path's truncate-rollback cannot run, so the torn tail
stays on disk for `storage/volume.py`'s load-time recovery to find —
exactly the state a real `kill -9` mid-append leaves. Tests clear or swap
the plan before "restarting" the process (reloading the volume).

Copied from the JAX package's util/faults.py: the same rules, seeds,
events and dict forms, so a plan written by either package loads in the
other. Each package holds its own `_PLAN`: a plan installed in one never
fires in the other.
"""

from __future__ import annotations

import asyncio
import contextlib
import contextvars
import errno
import json
import os
import threading
import time
from dataclasses import dataclass
from fnmatch import fnmatchcase
from random import Random
from typing import Optional

from .metrics import FAULTS_INJECTED

# the address of the node MAKING the current outbound call, when known —
# pairwise `partition` rules need both endpoints, but the client seams
# only see the callee. In-process callers that have an identity (raft
# peers, server-to-server replication) wrap their calls in
# `calling_from(self.address)`; external/anonymous callers leave it None
# and only match a partition side whose pattern is "*".
_CALL_SOURCE: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "faults_call_source", default=None
)


@contextlib.contextmanager
def calling_from(address: str):
    """Tag outbound calls in this (async) context with the caller's own
    address, so pairwise partition rules can match both endpoints."""
    tok = _CALL_SOURCE.set(address)
    try:
        yield
    finally:
        _CALL_SOURCE.reset(tok)


def _source_matches(src: Optional[str], pattern: str) -> bool:
    if pattern == "*":
        return True
    if src is None:
        return False  # anonymous caller: only the wildcard side matches
    return fnmatchcase(src, pattern)


class SimulatedCrash(BaseException):
    """The process 'died' mid-operation. Derives from BaseException so
    per-operation `except Exception` cleanup handlers (e.g. the volume
    write path's truncate-rollback) cannot swallow it and tidy up state a
    real crash would have left torn."""


class InjectedError(OSError):
    """Marker base for injected I/O errors (still an OSError, so existing
    error handling treats it like the real thing)."""


def injected_eio(target: str) -> InjectedError:
    return InjectedError(errno.EIO, f"injected EIO on {target}")


@dataclass
class FaultRule:
    """One scheduled fault.

    op/target are fnmatch patterns: op names the seam ("write_at",
    "read_at", "sync", "truncate", "rpc:<Method>", "http:<METHOD>"), target
    the file path or host:port. Trigger is either `nth` (fire on the nth
    matching call, 1-based) or `probability` (per-match coin flip from the
    rule's seeded RNG); `times` caps total fires (default 1 for nth rules,
    unlimited for probability rules).
    """

    op: str
    target: str = "*"
    # eio|torn|crash|latency|reset|hang|http_error|bitflip|partition
    fault: str = "eio"
    nth: Optional[int] = None
    probability: Optional[float] = None
    times: Optional[int] = None
    delay: float = 0.0  # seconds, for latency/hang (hang: until deadline)
    keep: Optional[int] = None  # bytes written before a torn/crash write
    at_offset: Optional[int] = None  # absolute file offset (crash cut point,
    # or the byte a bitflip corrupts)
    status: int = 503  # synthesized status for http_error
    bits: int = 1  # bits flipped by a bitflip fault
    # time-windowed rules (brownouts): active only while the plan clock is
    # in [from_s, until_s) seconds since install; ramp=True scales a
    # latency rule's delay triangularly over the window (0 at the edges,
    # `delay` at the midpoint — degrade in, peak, recover)
    from_s: Optional[float] = None
    until_s: Optional[float] = None
    ramp: bool = False
    # partition rules: the far end of the cut. The rule fires when the
    # call's (source, target) pair matches (target, peer) in EITHER
    # orientation — traffic is dropped both directions. peer="*" (the
    # default) isolates `target` from everyone, including anonymous
    # callers; a concrete pattern makes the cut pairwise and only
    # matches callers that tagged themselves via `calling_from`.
    peer: Optional[str] = None

    def max_fires(self) -> Optional[int]:
        if self.times is not None:
            return self.times
        return 1 if self.nth is not None else None

    def window_factor(self, t: float) -> Optional[float]:
        """Delay scale at plan-relative time t: None when the rule is
        outside its window (inactive), 1.0 for unwindowed/unramped rules,
        else the triangular ramp position."""
        if self.from_s is None and self.until_s is None:
            return 1.0
        lo = self.from_s or 0.0
        hi = self.until_s if self.until_s is not None else float("inf")
        if not lo <= t < hi:
            return None
        if not self.ramp or hi == float("inf"):
            return 1.0
        mid = (t - lo) / (hi - lo)  # 0..1 across the window
        return 1.0 - abs(2.0 * mid - 1.0)


def brownout(
    op: str = "http:*",
    target: str = "*",
    delay: float = 0.2,
    start: float = 0.0,
    duration: float = 5.0,
    probability: float = 1.0,
) -> FaultRule:
    """Convenience constructor for a brownout: a ramped latency rule over
    a time window. For `duration` seconds beginning `start` seconds after
    the plan is installed, matching operations see injected latency that
    ramps 0 → `delay` → 0 triangularly across the window — the shape of a
    peer degrading (GC storm, thermal throttle, noisy neighbour) and
    recovering, as opposed to the step function a bare latency rule
    injects."""
    return FaultRule(
        op=op,
        target=target,
        fault="latency",
        probability=probability,
        delay=delay,
        from_s=start,
        until_s=start + duration,
        ramp=True,
    )


def partition(
    a: str,
    b: str = "*",
    op: str = "*:*",
    start: float = 0.0,
    duration: Optional[float] = None,
) -> FaultRule:
    """Convenience constructor for a network partition: drop traffic both
    directions between two addresses, windowed like `brownout`. For
    `duration` seconds beginning `start` seconds after the plan is
    installed (forever when duration is None — heal by swapping the
    plan), every matching RPC/HTTP call whose (source, target) pair hits
    (a, b) in either orientation raises ConnectionError at the seam —
    the connection-refused shape of a firewalled peer, not a slow one.
    With b="*" (default) node `a` is isolated from the whole cluster;
    with a concrete `b` the cut is pairwise, and only callers that tag
    their outbound calls via `calling_from(addr)` (raft peers do) can
    match the source side. op="*:*" matches the RPC and HTTP client
    seams but no disk ops."""
    return FaultRule(
        op=op,
        target=a,
        peer=b,
        fault="partition",
        probability=1.0,
        from_s=start if (start or duration is not None) else None,
        until_s=(start + duration) if duration is not None else None,
    )


@dataclass
class FaultEvent:
    """One fired fault, as handed to a seam (and logged on the plan)."""

    rule: FaultRule
    op: str
    target: str
    rng: Random  # rule-scoped; seams draw torn-write cut points from it
    delay: float = 0.0  # effective delay for latency/hang rules: the
    # rule's delay scaled by its window ramp at fire time

    @property
    def kind(self) -> str:
        return self.rule.fault


class FaultPlan:
    def __init__(self, seed: int = 0, rules: Optional[list[FaultRule]] = None):
        self.seed = seed
        self.rules: list[FaultRule] = []
        self._lock = threading.Lock()
        self._match_counts: list[int] = []
        self._fire_counts: list[int] = []
        self._rngs: list[Random] = []
        self._dead = False
        # windowed rules (brownouts) measure time from this epoch;
        # install_plan restarts it so windows are install-relative
        self.epoch = time.monotonic()
        self.events: list[tuple[str, str, str]] = []  # (op, target, kind)
        for r in rules or []:
            self.add(r)

    def restart_clock(self) -> None:
        self.epoch = time.monotonic()

    def add(self, rule: FaultRule) -> "FaultPlan":
        with self._lock:
            i = len(self.rules)
            self.rules.append(rule)
            self._match_counts.append(0)
            self._fire_counts.append(0)
            # rule-scoped stream: firing decisions for one rule are
            # independent of how other rules' matches interleave
            self._rngs.append(Random(f"{self.seed}:{i}:{rule.op}:{rule.target}"))
        return self

    def mark_dead(self) -> None:
        with self._lock:
            self._dead = True

    @property
    def dead(self) -> bool:
        return self._dead

    def fired(self, op_pattern: str = "*") -> int:
        with self._lock:
            return sum(1 for op, _t, _k in self.events if fnmatchcase(op, op_pattern))

    def match(self, op: str, target: str) -> Optional[FaultEvent]:
        """Consult the schedule for one operation; returns the fault to
        apply, or None. Raises SimulatedCrash once the plan is dead."""
        with self._lock:
            if self._dead:
                raise SimulatedCrash(f"{op} on {target} after simulated crash")
            now_rel = time.monotonic() - self.epoch
            src = _CALL_SOURCE.get()
            for i, rule in enumerate(self.rules):
                if not fnmatchcase(op, rule.op):
                    continue
                if rule.fault == "partition":
                    # both directions: (src -> target) matches the cut
                    # (a, b) in either orientation
                    a, b = rule.target, rule.peer or "*"
                    if not (
                        (fnmatchcase(target, a) and _source_matches(src, b))
                        or (
                            fnmatchcase(target, b)
                            and _source_matches(src, a)
                        )
                    ):
                        continue
                elif not fnmatchcase(target, rule.target):
                    continue
                # windowed rules outside their window neither count a
                # match (nth bookkeeping) nor fire
                factor = rule.window_factor(now_rel)
                if factor is None:
                    continue
                self._match_counts[i] += 1
                cap = rule.max_fires()
                if cap is not None and self._fire_counts[i] >= cap:
                    continue
                fire = False
                if rule.nth is not None:
                    fire = self._match_counts[i] == rule.nth
                elif rule.probability is not None:
                    fire = self._rngs[i].random() < rule.probability
                else:
                    fire = True
                if not fire:
                    continue
                self._fire_counts[i] += 1
                self.events.append((op, target, rule.fault))
                FAULTS_INJECTED.inc(op=op.split(":")[0], kind=rule.fault)
                return FaultEvent(
                    rule=rule, op=op, target=target, rng=self._rngs[i],
                    delay=rule.delay * factor,
                )
        return None

    # --- (de)serialization: env-var / JSON-file activation ---
    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        plan = cls(seed=int(d.get("seed", 0)))
        for rd in d.get("rules", []):
            plan.add(FaultRule(**rd))
        return plan

    def to_dict(self) -> dict:
        out = {"seed": self.seed, "rules": []}
        for r in self.rules:
            rd = {"op": r.op, "target": r.target, "fault": r.fault}
            for k in ("nth", "probability", "times", "keep", "at_offset",
                      "from_s", "until_s", "peer"):
                v = getattr(r, k)
                if v is not None:
                    rd[k] = v
            if r.delay:
                rd["delay"] = r.delay
            if r.ramp:
                rd["ramp"] = True
            if r.fault == "http_error":
                rd["status"] = r.status
            if r.fault == "bitflip" and r.bits != 1:
                rd["bits"] = r.bits
            out["rules"].append(rd)
        return out


# process-global plan; seams read the module attribute directly so the
# disabled path costs one load + is-None test
_PLAN: Optional[FaultPlan] = None


def install_plan(plan: Optional[FaultPlan]) -> None:
    global _PLAN
    if plan is not None:
        # windowed rules (brownouts) run install-relative: a plan built
        # ahead of time must not have burned its window before activation
        plan.restart_clock()
    _PLAN = plan


def clear_plan() -> None:
    install_plan(None)


def current_plan() -> Optional[FaultPlan]:
    return _PLAN


def _load_env_plan() -> None:
    spec = os.environ.get("SEAWEEDFS_TPU_FAULTS", "")
    if not spec:
        return
    try:
        if spec.lstrip().startswith("{"):
            data = json.loads(spec)
        else:
            with open(spec) as f:
                data = json.load(f)
        install_plan(FaultPlan.from_dict(data))
    except Exception as e:  # a broken plan must be loud, not silently off
        raise ValueError(f"SEAWEEDFS_TPU_FAULTS unparseable: {e}") from e


_load_env_plan()


# ---------------------------------------------------------------- seams --


def sync_fault(
    plan: FaultPlan, op: str, target: str, allow_partial: bool = False,
    corruptable: bool = False,
) -> Optional[FaultEvent]:
    """Blocking-code seam (disk I/O): applies latency/EIO in place. With
    allow_partial (the write seam), torn/crash events are RETURNED for the
    caller to apply as a partial write; with corruptable (the read/write
    data seams), bitflip events are RETURNED for the caller to apply to
    the buffer via apply_bitflip. On every other seam a fired event must
    never be a counted no-op, so crash kills the plan here and torn /
    bitflip degrade to EIO."""
    ev = plan.match(op, target)
    if ev is None:
        return None
    kind = ev.kind
    if kind == "latency":
        time.sleep(ev.delay)
        return None
    if kind in ("eio", "fsync_fail"):
        raise injected_eio(target)
    if kind == "bitflip":
        if corruptable:
            return ev
        raise injected_eio(target)
    if kind == "partition":
        # a counted fault is never a no-op: on a disk seam the nearest
        # honest shape is an I/O error (network partitions target the
        # RPC/HTTP seams; op="*:*" cannot even match disk ops)
        raise injected_eio(target)
    if not allow_partial:
        if kind == "crash":
            plan.mark_dead()
            raise SimulatedCrash(f"crash in {op} of {target}")
        raise injected_eio(target)
    return ev


def apply_bitflip(ev: FaultEvent, data, file_offset: int = 0) -> bytes:
    """Silent data corruption: flip `rule.bits` bits of `data` (the buffer
    read from / about to be written at `file_offset`). The victim byte is
    `rule.at_offset - file_offset` when the rule pins an absolute file
    offset, else drawn from the rule's seeded RNG — deterministic per plan
    seed either way. A pinned offset that misses this buffer falls back to
    the seeded-random position: the firing was already counted, and a
    counted fault must never be a no-op. Models bit
    rot / a lying disk: no error surfaces, only wrong bytes."""
    buf = bytearray(data)
    if not buf:
        return bytes(buf)
    rule = ev.rule
    pos = None
    if rule.at_offset is not None:
        pos = rule.at_offset - file_offset
        if not 0 <= pos < len(buf):
            pos = None
    if pos is None:
        pos = ev.rng.randrange(len(buf))
    # flip N consecutive bit positions: distinct bits, so flips never cancel
    bitpos = pos * 8 + ev.rng.randrange(8)
    for i in range(max(1, rule.bits)):
        p = (bitpos + i) % (len(buf) * 8)
        buf[p // 8] ^= 1 << (p % 8)
    return bytes(buf)


# ------------------------------------------------ process-level faults --
#
# The seams above fire INSIDE a process; chaos soaks against real
# subprocess clusters (the JAX package's ops/proc_cluster.py) also need faults delivered TO
# processes: SIGKILL (machine loss), SIGSTOP/SIGCONT (a wedged or
# GC-storming peer — the process-level brownout), and kill+respawn
# (restart-with-recovery). A `ProcessFault` is one scheduled delivery; a
# schedule is generated deterministically from a seed with the same
# per-slot RNG discipline as FaultPlan rules, so a soak run's process
# chaos is bit-reproducible from (seed, targets, duration) alone. The
# schedule serializes like a plan (to_dict/from_dict) so the fixture that
# owns the PIDs — never this module — executes it.

PROCESS_FAULT_KINDS = ("kill", "pause", "restart")


@dataclass
class ProcessFault:
    """One scheduled process-level fault.

    kind: "kill" (SIGKILL, no respawn), "pause" (SIGSTOP, SIGCONT after
    duration_s), "restart" (SIGKILL, respawn after duration_s, wait
    ready). target names a process in the owning cluster fixture
    ("volume-1"), at_s is seconds after schedule start."""

    at_s: float
    kind: str
    target: str
    duration_s: float = 0.0

    def to_dict(self) -> dict:
        d = {"at_s": self.at_s, "kind": self.kind, "target": self.target}
        if self.duration_s:
            d["duration_s"] = self.duration_s
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ProcessFault":
        return cls(
            at_s=float(d["at_s"]),
            kind=str(d["kind"]),
            target=str(d["target"]),
            duration_s=float(d.get("duration_s", 0.0)),
        )


def process_fault_schedule(
    seed: int,
    targets: list[str],
    duration_s: float,
    count: int = 3,
    kinds: tuple = PROCESS_FAULT_KINDS,
    start_s: float = 0.0,
    pause_s: float = 1.0,
    restart_s: float = 0.0,
) -> list[ProcessFault]:
    """Deterministic process-fault schedule: `count` faults over
    [start_s, duration_s), each drawn from its OWN seeded stream
    (Random(f"{seed}:proc:{i}")) so fault i's (time, kind, target) is
    independent of how many faults precede it — the FaultPlan per-rule
    discipline applied to the process dimension. Same arguments, same
    schedule, bit-for-bit; kinds cycle so every requested kind appears
    before any repeats (a 2-fault schedule over ("kill", "pause") always
    carries one of each — acceptance gates like ">= 1 SIGKILL" hold by
    construction, with the seed choosing victims and times)."""
    if not targets or count <= 0 or not kinds:
        return []
    faults = []
    span = max(duration_s - start_s, 0.0)
    for i in range(count):
        rng = Random(f"{seed}:proc:{i}")
        at = start_s + span * (i + rng.random()) / count
        kind = kinds[i % len(kinds)]
        f = ProcessFault(
            at_s=round(at, 3),
            kind=kind,
            target=rng.choice(list(targets)),
        )
        if kind == "pause":
            f.duration_s = round(pause_s * (0.5 + rng.random()), 3)
        elif kind == "restart":
            f.duration_s = round(restart_s, 3)
        faults.append(f)
    faults.sort(key=lambda f: (f.at_s, f.target, f.kind))
    return faults


def process_schedule_to_dicts(schedule: list[ProcessFault]) -> list[dict]:
    return [f.to_dict() for f in schedule]


def process_schedule_from_dicts(dicts: list[dict]) -> list[ProcessFault]:
    return [ProcessFault.from_dict(d) for d in dicts]


async def async_fault(
    plan: FaultPlan, op: str, target: str, timeout: Optional[float] = None
) -> Optional[FaultEvent]:
    """Event-loop seam (RPC/HTTP clients). latency sleeps then proceeds;
    reset raises ConnectionResetError; hang sleeps until the CALLER's
    per-call timeout (or the rule's delay, whichever is shorter; 30s when
    neither bounds it) then raises TimeoutError — the shape of a peer
    that accepted the connection and went silent, surfacing through the
    same deadline machinery a real hang would. http_error events are
    returned for the HTTP seam to synthesize a status; other seams treat
    them as resets."""
    ev = plan.match(op, target)
    if ev is None:
        return None
    kind = ev.kind
    if kind == "latency":
        await asyncio.sleep(ev.delay)
        return None
    if kind == "reset":
        raise ConnectionResetError(f"injected reset: {op} to {target}")
    if kind == "partition":
        # dropped both directions: surfaces as connection-refused, the
        # firewalled-peer shape (fast failure — the retry/breaker
        # machinery, not a timeout, decides what happens next)
        raise ConnectionError(f"injected partition: {op} to {target}")
    if kind == "hang":
        # the window-scaled effective delay, like latency (a ramped
        # windowed hang would otherwise silently ignore its ramp)
        bounds = [w for w in (ev.delay or None, timeout) if w is not None]
        await asyncio.sleep(min(bounds) if bounds else 30.0)
        raise TimeoutError(f"injected hang: {op} to {target}")
    if kind in ("eio",):
        raise injected_eio(target)
    return ev
