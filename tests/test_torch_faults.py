"""The port's fault plane (seaweedfs_tpu_torch/util/faults.py) against the
JAX package's, on the CPU:

- plans built from one dict in each package fire on the same operations,
  in the same order, with the same events and the same per-rule random
  streams, over a seeded sequence of operations (nth, probability,
  times, windows, partitions with `calling_from`, bitflips, http_error);
  `to_dict` from either package loads in the other;
- `apply_bitflip` gives the same bytes and `process_fault_schedule` the
  same list for a seed; the async seam raises the same kinds;
- the DiskFile seam: EIO rollback, and torn or crash writes at seeded
  cut points followed by a reload — both packages' `Volume` keep the same
  live set (tests/test_faults.py);
- the RPC, HTTP-client and HTTP-server seams fire the same events as the
  JAX package's for one plan, and with no plan no seam calls into the
  fault module;
- `SEAWEEDFS_TPU_FAULTS` (inline JSON) activates a plan at import.

Each package holds its own plan: one installed in the port never fires
in the JAX package and back. Inputs come from numpy seeds; tolerance:
exact."""

import asyncio
import os
import subprocess
import sys

import numpy as np
import pytest

from seaweedfs_tpu.storage.needle import Needle as JaxNeedle
from seaweedfs_tpu.storage.volume import Volume as JaxVolume
from seaweedfs_tpu.util import faults as jf
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.util import faults as pf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    jf.clear_plan()
    pf.clear_plan()
    yield
    jf.clear_plan()
    pf.clear_plan()


PLAN = {
    "seed": 7,
    "rules": [
        {"op": "read_at", "target": "*.dat", "fault": "eio", "probability": 0.3},
        {"op": "write_at", "target": "*.idx", "fault": "torn", "nth": 3, "keep": 5},
        {"op": "sync", "target": "*", "fault": "eio", "probability": 0.5, "times": 3},
        {"op": "rpc:*", "target": "h:1", "fault": "reset", "probability": 0.4},
        {"op": "http:GET", "target": "*", "fault": "http_error", "status": 429,
         "probability": 0.25},
        {"op": "http:POST", "target": "*", "fault": "latency", "delay": 0.5,
         "from_s": 0.0, "until_s": 3600.0, "probability": 0.6},
        {"op": "*:*", "target": "a:1", "peer": "b:2", "fault": "partition",
         "probability": 1.0},
        {"op": "write_at", "target": "*.dat", "fault": "bitflip", "nth": 2,
         "bits": 3, "at_offset": 100},
        {"op": "truncate", "target": "*", "fault": "crash", "nth": 2},
    ],
}
OPS = ["read_at", "write_at", "sync", "truncate", "rpc:Assign", "rpc:CopyFile",
       "http:GET", "http:POST"]
TARGETS = ["v/1.dat", "v/1.idx", "h:1", "a:1", "b:2", "c:3"]


def _op_sequence(seed: int, n: int = 400):
    rng = np.random.default_rng(seed)
    return [
        (OPS[int(o)], TARGETS[int(t)], [None, "b:2", "a:1"][int(s)])
        for o, t, s in zip(rng.integers(0, len(OPS), n),
                           rng.integers(0, len(TARGETS), n),
                           rng.integers(0, 3, n))
    ]


def _replay(mod, plan, seq) -> list:
    out = []
    for op, target, src in seq:
        if src is None:
            ev = plan.match(op, target)
        else:
            with mod.calling_from(src):
                ev = plan.match(op, target)
        out.append(None if ev is None else (
            ev.kind, ev.op, ev.target, ev.delay, ev.rule.status,
            ev.rng.randrange(1 << 30),
        ))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plans_fire_on_the_same_ops_as_jax(seed):
    jp, pp = jf.FaultPlan.from_dict(PLAN), pf.FaultPlan.from_dict(PLAN)
    seq = _op_sequence(seed)
    got, want = _replay(pf, pp, seq), _replay(jf, jp, seq)
    assert got == want
    assert sum(e is not None for e in got) > 40
    assert {e[0] for e in got if e} == {
        "eio", "torn", "reset", "http_error", "latency", "partition",
        "bitflip", "crash"}
    assert pp.events == jp.events
    assert pp.fired("rpc:*") == jp.fired("rpc:*") > 0
    # the dict forms load across the packages
    assert pp.to_dict() == jp.to_dict()
    assert pf.FaultPlan.from_dict(jp.to_dict()).to_dict() == jp.to_dict()
    assert jf.FaultPlan.from_dict(pp.to_dict()).to_dict() == pp.to_dict()
    # each package keeps its own plan
    pf.install_plan(pp)
    assert jf.current_plan() is None and pf.current_plan() is pp


def test_bitflips_and_process_schedules_equal_jax():
    rng = np.random.default_rng(3)
    for seed in range(12):
        buf = rng.integers(0, 256, int(rng.integers(1, 300)), dtype=np.uint8).tobytes()
        rule = {"op": "write_at", "target": "*", "fault": "bitflip", "nth": 1,
                "bits": int(rng.integers(1, 5))}
        if seed % 3:
            rule["at_offset"] = int(rng.integers(0, 400))  # in or past the buffer
        file_off = int(rng.integers(0, 50))
        d = {"seed": seed, "rules": [rule]}
        jev = jf.FaultPlan.from_dict(d).match("write_at", "x")
        pev = pf.FaultPlan.from_dict(d).match("write_at", "x")
        got = pf.apply_bitflip(pev, buf, file_off)
        assert got == jf.apply_bitflip(jev, buf, file_off) and got != buf
    targets = [f"volume-{i}" for i in range(5)]
    for seed in range(6):
        kw = dict(count=int(seed) + 2, start_s=1.0, pause_s=2.0, restart_s=0.5)
        got = pf.process_fault_schedule(seed, targets, 60.0, **kw)
        want = jf.process_fault_schedule(seed, targets, 60.0, **kw)
        assert pf.process_schedule_to_dicts(got) == jf.process_schedule_to_dicts(want)
        dicts = jf.process_schedule_to_dicts(want)
        assert pf.process_schedule_to_dicts(pf.process_schedule_from_dicts(dicts)) == dicts
    assert pf.process_fault_schedule(1, [], 10.0) == []


@pytest.mark.parametrize("fault,kw,exc", [
    ("reset", {}, ConnectionResetError),
    ("partition", {"peer": "*"}, ConnectionError),
    ("hang", {"delay": 5.0}, TimeoutError),
    ("eio", {}, OSError),
    ("http_error", {"status": 503}, None),
    ("latency", {"delay": 0.001}, None),
])
def test_async_seam_raises_as_jax(fault, kw, exc):
    d = {"seed": 1, "rules": [{"op": "rpc:X", "target": "*", "fault": fault,
                                "nth": 1, **kw}]}

    async def one(mod):
        plan = mod.FaultPlan.from_dict(d)
        try:
            ev = await mod.async_fault(plan, "rpc:X", "h:1", timeout=0.01)
            return ("ok", None if ev is None else ev.kind, plan.events)
        except BaseException as e:  # noqa: BLE001 - compared by kind
            assert exc is not None and isinstance(e, exc), e
            return (type(e).__name__, None, plan.events)

    assert asyncio.run(one(pf)) == asyncio.run(one(jf))


def _events(plan) -> list:
    """The plan's events with each file target cut to its name (the two
    packages' files live in different directories)."""
    return [(op, os.path.basename(t), k) for op, t, k in plan.events]


def _fill(v, needle_cls, rng, n: int) -> dict:
    acked = {}
    for nid in range(1, n + 1):
        data = rng.integers(0, 256, int(rng.integers(8, 200)), dtype=np.uint8).tobytes()
        v.write_needle(needle_cls(cookie=nid, id=nid, data=data))
        acked[nid] = data
    return acked


def _live(v, needle_cls) -> dict:
    keys, _offs, _sizes = v.nm.snapshot()
    out = {}
    for k in keys.tolist():
        n = needle_cls(id=int(k), cookie=int(k))
        v.read_needle(n)
        out[int(k)] = bytes(n.data)
    return out


def test_eio_write_rolls_back_as_jax(tmp_path):
    d = {"seed": 0, "rules": [{"op": "write_at", "target": "*.dat",
                                "fault": "torn", "nth": 1, "keep": 9}]}
    results = []
    for mod, vcls, ncls, sub in ((jf, JaxVolume, JaxNeedle, "j"),
                                 (pf, Volume, Needle, "p")):
        (tmp_path / sub).mkdir()
        v = vcls(str(tmp_path / sub), "", 1)
        v.write_needle(ncls(cookie=1, id=1, data=b"a" * 40))
        mod.install_plan(mod.FaultPlan.from_dict(d))
        with pytest.raises(mod.InjectedError):
            v.write_needle(ncls(cookie=2, id=2, data=b"b" * 40))
        events = _events(mod.current_plan())
        mod.clear_plan()
        # the write path's truncate-rollback ran: the tail is clean
        v.write_needle(ncls(cookie=3, id=3, data=b"c" * 40))
        results.append((events, v.data_file_size(), _live(v, ncls)))
        v.close()
    assert results[0] == results[1]
    assert results[1][2] == {1: b"a" * 40, 3: b"c" * 40}


def test_crash_recovery_keeps_the_jax_live_set(tmp_path):
    """Kill the 'process' at a seeded cut point mid-append (the .dat
    record, the .idx entry or the fsync) in both packages and reload:
    the same live set survives, every acked write reads back, the torn
    needle is whole or gone, and both volumes come back writable."""
    rng = np.random.default_rng(0xFA17)
    for it in range(30):
        n_acked = int(rng.integers(1, 6))
        where = [".dat", ".dat", ".idx", "sync"][int(rng.integers(0, 4))]
        keep = int(rng.integers(0, 300))
        victim = b"V" * int(rng.integers(8, 200))
        delete = bool(rng.random() < 0.3)
        if where == "sync":
            rule = {"op": "sync", "target": "*", "nth": 1, "fault": "crash"}
        else:
            rule = {"op": "write_at", "target": f"*{where}", "nth": 1,
                    "fault": "crash", "keep": keep}
        lives = []
        for mod, vcls, ncls, sub in ((jf, JaxVolume, JaxNeedle, "j"),
                                     (pf, Volume, Needle, "p")):
            d = tmp_path / f"{sub}{it}"
            d.mkdir()
            v = vcls(str(d), "", 1)
            acked = _fill(v, ncls, np.random.default_rng(it), n_acked)
            if delete:
                v.delete_needle(ncls(id=1, cookie=1))
                acked.pop(1)
            mod.install_plan(mod.FaultPlan.from_dict({"seed": it, "rules": [rule]}))
            with pytest.raises(mod.SimulatedCrash):
                v.write_needle(ncls(cookie=99, id=99, data=victim),
                               sync=where == "sync")
            mod.clear_plan()
            v2 = vcls(str(d), "", 1, create=False)
            assert not v2.is_read_only(), (it, sub)
            live = _live(v2, ncls)
            assert {k: b for k, b in live.items() if k != 99} == acked, (it, sub)
            assert live.get(99, victim) == victim, (it, sub)
            v2.write_needle(ncls(cookie=7, id=777, data=b"post"))
            lives.append((live, v2.data_file_size()))
            v2.close()
        assert lives[0] == lives[1], it


def test_disk_seams_fire_the_same_events(tmp_path):
    from seaweedfs_tpu.storage.backend import DiskFile as JaxDiskFile
    from seaweedfs_tpu_torch.storage.backend import DiskFile

    d = {"seed": 5, "rules": [
        {"op": "read_at", "target": "*", "fault": "bitflip", "probability": 0.3},
        {"op": "write_at", "target": "*", "fault": "bitflip", "probability": 0.2,
         "bits": 2},
        {"op": "sync", "target": "*", "fault": "eio", "nth": 2},
        {"op": "truncate", "target": "*", "fault": "latency", "nth": 1},
    ]}
    rng = np.random.default_rng(9)
    steps = [(int(a), int(b)) for a, b in zip(rng.integers(0, 4, 120),
                                              rng.integers(1, 64, 120))]
    outs = []
    for mod, dcls, sub in ((jf, JaxDiskFile, "j"), (pf, DiskFile, "p")):
        mod.install_plan(mod.FaultPlan.from_dict(d))
        (tmp_path / sub).mkdir()
        f = dcls(str(tmp_path / sub / "f.bin"))
        seen = []
        for kind, n in steps:
            try:
                if kind == 0:
                    f.write_at(bytes(range(n)), f.size())
                elif kind == 1:
                    seen.append(f.read_at(n, 0))
                elif kind == 2:
                    f.sync()
                else:
                    f.truncate(max(0, f.size() - n))
            except OSError as e:
                seen.append(type(e).__name__)
        outs.append((seen, _events(mod.current_plan()), f.size()))
        mod.clear_plan()
        f.close()
    assert outs[0] == outs[1]
    assert len(outs[1][1]) > 10


def test_rpc_and_http_seams_fire_the_same_events():
    """Stub.call, Stub.server_stream and FastHTTPClient.request consult
    the plan before the wire in both packages (nothing listens at the
    callee's address); the HTTP server seam answers the same status."""
    from seaweedfs_tpu.pb.rpc import Stub as JaxStub
    from seaweedfs_tpu.server.serving_core import ServingCore as JaxCore
    from seaweedfs_tpu.util.fasthttp import FastHTTPClient as JaxClient
    from seaweedfs_tpu_torch.pb.rpc import Stub
    from seaweedfs_tpu_torch.server.serving_core import ServingCore
    from seaweedfs_tpu_torch.util.fasthttp import FastHTTPClient

    d = {"seed": 2, "rules": [
        {"op": "rpc:Assign", "target": "*", "fault": "reset", "nth": 1},
        {"op": "rpc:CopyFile", "target": "*", "fault": "partition", "peer": "*"},
        {"op": "http:GET", "target": "*", "fault": "http_error", "status": 503,
         "nth": 1},
        {"op": "http:PUT", "target": "*", "fault": "http_error", "status": 418,
         "times": 2, "probability": 1.0},
    ]}

    class Req:
        method = "PUT"
        path = "/x"
        transport = None

    async def drive(mod, stub_cls, client_cls, core_cls):
        mod.install_plan(mod.FaultPlan.from_dict(d))
        out = []
        stub = stub_cls("127.0.0.1:1", "volume")
        try:
            await stub.call("Assign", {}, timeout=1)
        except BaseException as e:  # noqa: BLE001 - compared by kind
            out.append(type(e).__name__)
        try:
            async for _m in stub.server_stream("CopyFile", {}, timeout=1):
                pass
        except BaseException as e:  # noqa: BLE001
            out.append(type(e).__name__)
        client = client_cls()
        st, body = await client.request("GET", "127.0.0.1:1", "/", timeout=1)
        out.append((st, body))
        await client.close()
        core = core_cls("volume", None, "127.0.0.1", 1)
        resp = await core._apply_fault(mod.current_plan(), Req())
        out.append(resp.split(b"\r\n", 1)[0])
        out.append(list(mod.current_plan().events))
        mod.clear_plan()
        return out

    want = asyncio.run(drive(jf, JaxStub, JaxClient, JaxCore))
    got = asyncio.run(drive(pf, Stub, FastHTTPClient, ServingCore))
    assert got == want
    assert got[:3] == ["ConnectionResetError", "ConnectionError",
                       (503, b'{"error":"injected fault"}')]
    assert got[3] == b"HTTP/1.1 418 I'm a teapot" or got[3].startswith(b"HTTP/1.1 418")


def test_no_plan_costs_only_the_none_check(tmp_path, monkeypatch):
    """With no plan installed no seam calls into the fault module."""
    from seaweedfs_tpu_torch.pb.rpc import Stub
    from seaweedfs_tpu_torch.storage.backend import DiskFile
    from seaweedfs_tpu_torch.util.fasthttp import FastHTTPClient

    def boom(*a, **k):
        raise AssertionError("a seam consulted the fault module without a plan")

    for name in ("sync_fault", "async_fault", "apply_bitflip"):
        monkeypatch.setattr(pf, name, boom)
    f = DiskFile(str(tmp_path / "n.bin"))
    f.write_at(b"abc", 0)
    assert f.read_at(3, 0) == b"abc"
    f.sync()
    f.truncate(1)
    f.close()

    async def wire():
        with pytest.raises(Exception) as e:
            await Stub("127.0.0.1:1", "volume").call("Assign", {}, timeout=1)
        assert "AssertionError" not in repr(e.value)
        client = FastHTTPClient()
        with pytest.raises(OSError):
            await client.request("GET", "127.0.0.1:1", "/", timeout=1)
        await client.close()

    asyncio.run(wire())


def test_env_plan_activates_at_import():
    spec = '{"seed": 3, "rules": [{"op": "sync", "target": "*", "nth": 2}]}'
    env = dict(os.environ, SEAWEEDFS_TPU_FAULTS=spec, PYTHONPATH=REPO)
    code = ("import json; from seaweedfs_tpu_torch.util import faults as f; "
            "print(json.dumps(f.current_plan().to_dict()))")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == (
        '{"seed": 3, "rules": [{"op": "sync", "target": "*", "fault": "eio", '
        '"nth": 2}]}'
    )
