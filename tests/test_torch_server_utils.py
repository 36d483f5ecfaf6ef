"""The volume server's small modules against the JAX package's: file ids,
Range parsing, multipart parsing, response rendering, the JWT guard,
the RPC port convention and full-jitter backoff. The same inputs
(seeded) must give the same outputs. Tolerance: exact. Also the port's
RPC streams (pb/rpc.py): server and bidi streams ended by either side,
a handler that raises mid-stream, and a 4 MiB CopyFile, each under a
deadline."""

import random

import pytest

from seaweedfs_tpu import pb as jax_pb
from seaweedfs_tpu.storage.file_id import FileId as JaxFileId
from seaweedfs_tpu.util import fasthttp as jax_fasthttp
from seaweedfs_tpu.util import http_range as jax_http_range
from seaweedfs_tpu.util import security as jax_security
from seaweedfs_tpu_torch import pb
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.util import fasthttp, http_range, security


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:
        return (type(e).__name__, str(e))


FIDS = ["3,01637037d6", "3,0144b9f3d1_2", "7,ffffffffffffffff00000001",
        "0,1234567890", "3,zz", "3", ",0144b9f3d1", "3,01", "12,0a_x",
        "4,ffffffffffffffff00000001_1"]


@pytest.mark.parametrize("fid", FIDS)
def test_file_id_parse_and_format_equal_jax(fid):
    got, want = _outcome(FileId.parse, fid), _outcome(JaxFileId.parse, fid)
    assert got[0] == want[0]
    if got[0] == "ok":
        assert (got[1].volume_id, got[1].key, got[1].cookie) == (
            want[1].volume_id, want[1].key, want[1].cookie)
        assert str(got[1]) == str(want[1])
    else:
        assert got == want


RANGES = ["bytes=0-9", "bytes=-5", "bytes=5-", "bytes=100-", "bytes=a-b",
          "bytes=0-1,3-4", "bytes=-0", "bytes=9-3", "items=0-3", "",
          "bytes=0-", "bytes=-100", "bytes= 2-4", "bytes=2-4 ", "bytes=--1"]


@pytest.mark.parametrize("total", [0, 1, 10, 100])
def test_parse_range_equals_jax(total):
    for rng in RANGES:
        assert http_range.parse_range(rng, total) == jax_http_range.parse_range(
            rng, total), rng


def test_multipart_and_render_equal_jax():
    rng = random.Random(4)
    for i in range(40):
        data = rng.randbytes(rng.randint(0, 300))
        name = rng.choice(["file", "upload", "other"])
        mime = rng.choice(["", "text/x"])
        body, ct = fasthttp.build_multipart(
            name, data, filename=f"n{i}.bin", mime=mime)
        assert (body, ct) == jax_fasthttp.build_multipart(
            name, data, filename=f"n{i}.bin", mime=mime)
        got = fasthttp.parse_multipart(body, ct.encode())
        want = jax_fasthttp.parse_multipart(body, ct.encode())
        norm = lambda r: r and (bytes(r[0]), r[1], r[2])  # noqa: E731
        assert norm(got) == norm(want)
        for status in (200, 201, 404, 416, 501, 599):
            args = (status, data, b"text/plain", b"X-A: 1\r\n",
                    bool(i % 2), bool(i % 3 == 0))
            assert fasthttp.render_response(*args) == jax_fasthttp.render_response(*args)


def test_guard_and_jwt_equal_jax(monkeypatch):
    import time as _time

    monkeypatch.setattr(_time, "time", lambda: 1_700_000_000.0)
    tok = security.gen_jwt("k3y", 10, "3,01637037d6")
    assert tok == jax_security.gen_jwt("k3y", 10, "3,01637037d6")
    cases = [("Bearer " + tok, "3,01637037d6"), ("Bearer " + tok, "3,01637037d7"),
             ("Bearer " + tok, "3/01637037d6"), ("Bearer x.y.z", "3,01637037d6"),
             (tok, "3,01637037d6"), ("", "3,01637037d6"),
             ("Bearer " + tok, "3,01637037d6.jpg")]
    for wl in ((), ("10.0.0.1",), ("10.0.0.0/8", "127.0.0.1")):
        g = security.Guard(white_list=wl, signing_key="k3y")
        j = jax_security.Guard(white_list=wl, signing_key="k3y")
        for ip in ("127.0.0.1", "10.1.2.3", "192.168.0.1", "bad"):
            assert g.check_whitelist(ip) == j.check_whitelist(ip)
        for auth, fid in cases:
            assert g.check_jwt(auth, fid) == j.check_jwt(auth, fid), (auth, fid)


def test_rpc_port_convention_equals_jax():
    for addr in ("127.0.0.1:8080", "host:1", "[::1]:9333"):
        assert pb.grpc_address(addr) == jax_pb.grpc_address(addr)
        rpc = pb.grpc_address(addr)
        assert pb.http_address(rpc) == jax_pb.http_address(rpc) == addr


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_backoff_equals_jax(seed):
    """Full-jitter delays, retry_async's attempts and its retry budget
    against the JAX package's util/backoff.py on one seeded sequence of
    failures."""
    import asyncio

    from seaweedfs_tpu.util import backoff as jax_backoff
    from seaweedfs_tpu_torch.util import backoff

    policies = [(0.05, 2.0, 2.0, 4), (0.2, 5.0, 2.0, 1 << 30),
                (0.02, 0.25, 2.0, 2), (0.1, 1.0, 3.0, 6)]
    for base, cap, mult, attempts in policies:
        mine = backoff.BackoffPolicy(base, cap, mult, attempts)
        ref = jax_backoff.BackoffPolicy(base, cap, mult, attempts)
        r1, r2 = random.Random(seed), random.Random(seed)
        for k in range(12):
            assert mine.delay(k, r1) == ref.delay(k, r2)

    async def run(mod, fails):
        calls = []

        async def fn():
            calls.append(len(calls))
            if len(calls) <= fails:
                raise ConnectionError(f"try {len(calls)}")
            return len(calls)

        budget = mod.RetryBudget(ratio=0.1, max_tokens=4.0)
        try:
            out = await mod.retry_async(
                fn, policy=mod.BackoffPolicy(0.0001, 0.001, 2.0, 5),
                rng=random.Random(seed), budget=budget)
        except ConnectionError as e:
            out = str(e)
        return out, len(calls), budget.snapshot()

    fails = [0, 1, 3, 7][seed]
    assert asyncio.run(run(backoff, fails)) == asyncio.run(run(jax_backoff, fails))


def _port_pair() -> int:
    import socket

    rng = random.Random()
    for _ in range(200):
        p = rng.randrange(12000, 18000)
        try:
            with socket.socket() as s1, socket.socket() as s2:
                s1.bind(("127.0.0.1", p))
                s2.bind(("127.0.0.1", p + 10000))
            return p
        except OSError:
            continue
    raise RuntimeError("no free port pair")


def _stream_service(log: list):
    from seaweedfs_tpu_torch.pb.rpc import Service

    svc = Service("t")

    @svc.server_stream("Count")
    async def count(req, ctx):
        try:
            for i in range(req["n"]):
                if req.get("boom") == i:
                    raise ValueError(f"boom at {i}")
                yield {"i": i}
                if req.get("slow"):
                    import asyncio

                    await asyncio.sleep(0.02)
        finally:
            log.append(("count", req["n"]))

    @svc.bidi_stream("Echo")
    async def echo(requests, ctx):
        try:
            async for m in requests:
                if m.get("end"):
                    return  # the callee ends the stream
                yield {"echo": m["x"]}
        finally:
            log.append(("echo", "ended"))

    return svc


def _with_server(body, svc):
    import asyncio

    from seaweedfs_tpu_torch.pb import grpc_address
    from seaweedfs_tpu_torch.pb.rpc import Stub, serve

    async def run():
        addr = grpc_address(f"127.0.0.1:{_port_pair()}")
        server = await serve(addr, svc)
        try:
            return await body(Stub(addr, "t"), server)
        finally:
            await server.stop()

    return asyncio.run(asyncio.wait_for(run(), 20))


async def _until(cond, deadline_s: float = 5.0) -> None:
    import asyncio
    import time

    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < deadline_s, "condition not met in time"
        await asyncio.sleep(0.01)


def test_rpc_server_stream_ended_by_callee_then_caller():
    """The callee ends a server stream (all messages, then EOF); then the
    caller leaves one early, which cancels the callee's handler."""
    log = []

    async def body(stub, server):
        got = [m async for m in stub.server_stream("Count", {"n": 5})]
        await _until(lambda: ("count", 5) in log)
        async for m in stub.server_stream("Count", {"n": 1000, "slow": 1}):
            if m["i"] == 3:
                break
        await _until(lambda: ("count", 1000) in log)
        return got

    assert _with_server(body, _stream_service(log)) == [{"i": i} for i in range(5)]


def test_rpc_bidi_stream_ended_by_caller_then_callee():
    from seaweedfs_tpu_torch.pb.rpc import EOF

    log = []

    async def body(stub, server):
        out = []
        call = stub.bidi_stream("Echo")
        for x in range(3):
            await call.write({"x": x})
            out.append(await call.read())
        await call.done_writing()  # the caller ends its side
        out.append(await call.read())
        await _until(lambda: len(log) == 1)
        call = stub.bidi_stream("Echo")
        await call.write({"x": 9})
        out.append(await call.read())
        await call.write({"end": True})  # the callee ends the stream
        out.append(await call.read())
        await _until(lambda: len(log) == 2)
        call.cancel()
        # a caller that goes away cancels the callee's handler
        call = stub.bidi_stream("Echo")
        await call.write({"x": 1})
        out.append(await call.read())
        call.cancel()
        await _until(lambda: len(log) == 3)
        return out

    out = _with_server(body, _stream_service(log))
    assert out == [{"echo": 0}, {"echo": 1}, {"echo": 2}, EOF, {"echo": 9}, EOF,
                   {"echo": 1}]


def test_rpc_server_stream_outlives_a_late_end_of_requests():
    """A callee that finishes before the caller's end-of-stream frame
    arrives keeps the connection until the caller has read every message:
    the late frame must not reset the connection under answers that still
    wait, unread, in the caller's socket."""
    import asyncio

    from seaweedfs_tpu_torch.pb.rpc import EOF, Service, StreamCall

    log = []
    svc = Service("t")

    @svc.server_stream("Big")
    async def big(req, ctx):
        for i in range(req["n"]):
            yield {"i": i, "pad": bytes(1 << 20)}
        log.append("big done")

    async def body(stub, server):
        call = StreamCall(stub.address, "t", "Big")
        await call.write({"n": 3})
        await _until(lambda: "big done" in log)
        await asyncio.sleep(0.1)  # the callee has written its end by now
        await call.done_writing()
        await asyncio.sleep(0.1)
        got = []
        while (m := await call.read()) is not EOF:
            got.append((m["i"], len(m["pad"])))
        call.cancel()
        return got

    assert _with_server(body, svc) == [(i, 1 << 20) for i in range(3)]


def test_rpc_stream_errors_reach_the_caller():
    """A handler that raises mid-stream, an unknown stream method and a
    server that stops mid-stream each reach the caller as RpcError."""
    from seaweedfs_tpu_torch.pb.rpc import RpcError

    log = []

    async def body(stub, server):
        got, errs = [], []
        try:
            async for m in stub.server_stream("Count", {"n": 9, "boom": 3}):
                got.append(m["i"])
        except RpcError as e:
            errs.append((e.status, e.message))
        try:
            async for m in stub.server_stream("Nope", {}):
                pass
        except RpcError as e:
            errs.append((e.status, e.message))
        call = stub.bidi_stream("Echo")
        await call.write({"x": 1})
        await call.read()
        await server.stop()
        try:
            await call.read()
        except RpcError as e:
            errs.append((e.status,))
        return got, errs

    got, errs = _with_server(body, _stream_service(log))
    assert got == [0, 1, 2]
    assert errs == [(500, "ValueError: boom at 3"), (501, "not ported: rpc t/Nope"),
                    (0,)]
    assert ("echo", "ended") in log


def test_copy_file_stream_4mib_byte_equal(tmp_path):
    """The volume server's CopyFile stream carries a 4 MiB file byte for
    byte, in 1 MiB messages; a missing file answers an error message."""
    import asyncio

    from seaweedfs_tpu_torch.pb import grpc_address
    from seaweedfs_tpu_torch.pb.rpc import Stub
    from seaweedfs_tpu_torch.server.volume import VolumeServer

    data = random.Random(7).randbytes(4 << 20)
    (tmp_path / "3.bin").write_bytes(data)

    async def body():
        vs = VolumeServer([str(tmp_path)], port=_port_pair(), codec_backend="cpu")
        await vs.start()
        try:
            stub = Stub(grpc_address(vs.address), "volume")
            chunks = [m["file_content"] async for m in stub.server_stream(
                "CopyFile", {"volume_id": 3, "ext": ".bin"})]
            missing = [m async for m in stub.server_stream(
                "CopyFile", {"volume_id": 4, "ext": ".bin"})]
            return chunks, missing
        finally:
            await vs.stop()

    chunks, missing = asyncio.run(asyncio.wait_for(body(), 20))
    assert [len(c) for c in chunks] == [1 << 20] * 4
    assert b"".join(chunks) == data
    assert missing == [{"error": "4.bin not found"}]


def test_rpc_refuses_an_oversized_body():
    """A unary request whose Content-Length exceeds the HTTP tier's 256 MiB
    cap answers 400 before any body is read."""
    import asyncio

    from seaweedfs_tpu_torch.pb import grpc_address
    from seaweedfs_tpu_torch.pb.rpc import Service, serve

    async def body():
        addr = grpc_address(f"127.0.0.1:{_port_pair()}")
        server = await serve(addr, Service("t"))
        try:
            host, _, port = addr.rpartition(":")
            r, w = await asyncio.open_connection(host, int(port))
            w.write(b"POST /t/X HTTP/1.1\r\nContent-Length: %d\r\n\r\n" % (257 << 20))
            head = await r.readuntil(b"\r\n\r\n")
            w.close()
            return head.split(b" ")[1]
        finally:
            await server.stop()

    assert asyncio.run(asyncio.wait_for(body(), 20)) == b"400"


def test_retry_budget_refills_from_completed_responses(monkeypatch):
    """Failed master lookups drain the shared retry budget until retries
    are suppressed; completed unary calls and HTTP responses refill it,
    after which a failing lookup is retried again."""
    import asyncio

    from seaweedfs_tpu_torch.pb import grpc_address
    from seaweedfs_tpu_torch.pb.rpc import Service, Stub, serve
    from seaweedfs_tpu_torch.util import backoff

    budget = backoff.RetryBudget(ratio=backoff.RETRY_BUDGET_RATIO,
                                 max_tokens=backoff.RETRY_BUDGET_TOKENS)
    monkeypatch.setattr(backoff, "_SHARED_BUDGET", budget)
    svc = Service("t")

    @svc.unary("Ping")
    async def ping(req, ctx):
        return {"pong": req["n"]}

    async def run():
        addr = grpc_address(f"127.0.0.1:{_port_pair()}")
        dead = Stub(grpc_address(f"127.0.0.1:{_port_pair()}"), "master")
        policy = backoff.BackoffPolicy(0.0001, 0.001, 2.0, 3)

        async def failed_lookup() -> int:
            tries = []

            async def one():
                tries.append(1)
                return await dead.call("LookupVolume", {}, timeout=2)

            with pytest.raises(pb.rpc.RpcError):
                await backoff.retry_async(one, policy=policy,
                                          op="master_lookup")
            return len(tries)

        first = [await failed_lookup() for _ in range(40)]
        assert first[0] == 3 and first[-1] == 1  # drained: no retries
        assert not budget.allow("master_lookup")
        server = await serve(addr, svc)
        client = fasthttp.FastHTTPClient()
        try:
            stub = Stub(addr, "t")
            for n in range(300):
                assert (await stub.call("Ping", {"n": n}))["pong"] == n
                status, _ = await client.request("GET", addr, "/no/such")
                assert status != 200
        finally:
            await client.close()
            await server.stop()
        assert budget.allow("master_lookup")
        return await failed_lookup()

    assert asyncio.run(asyncio.wait_for(run(), 30)) == 3
