"""Unary RPCs with msgpack bodies over HTTP/1.1, on the standard library.

The JAX package's pb/rpc.py serves named methods over gRPC (grpcio's
dynamic handlers) with msgpack message bodies. The port depends on
neither grpcio nor msgpack, so it keeps the same surface (`Service.unary`, `Stub.call`,
the method names and message dicts of the JAX handlers, and the
`{"error": ...}` reply convention) on a transport of its own:

- one HTTP/1.1 `POST /<service>/<method>` per call, to the RPC port
  (HTTP port + 10000, pb/__init__.py), served by the port's
  `util/fasthttp.py` server (keep-alive, pipelining);
- the request and reply bodies are msgpack maps (`util/mpack.py`,
  byte-equal to `msgpack.packb(obj, use_bin_type=True)`);
- 200 carries the handler's reply, errors included as `{"error": ...}`;
  a handler that raises answers 500 and an unknown method 501, both with
  a `{"error": ...}` body, and `Stub.call` raises `RpcError` for them (as
  a gRPC stub raises for a failed or unimplemented call).

The wire is not gRPC: a port server and a JAX server cannot call each
other. Unary calls only; the server streams (`CopyFile`,
`VolumeEcShardRead`, `BatchRead`, `Query`) and the bidirectional
heartbeat come with later slices. Left out with gRPC: mTLS, keepalive
channels and the overload, tenancy and fault seams.
"""

from __future__ import annotations

import asyncio
from typing import Any, Callable, Dict, Optional

from ..util import mpack
from ..util.fasthttp import FastHTTPServer, render_response
from ..util.http_timeouts import client_timeout

_CONTENT_TYPE = b"application/msgpack"


class RpcError(Exception):
    """A call that failed on the wire or in the callee: `status` is the
    HTTP status (0 when no reply arrived), `message` the callee's error."""

    def __init__(self, status: int, message: str):
        super().__init__(f"rpc status {status}: {message}")
        self.status = status
        self.message = message


class CallContext:
    """What a handler learns about its call (the place of gRPC's context):
    the caller's address."""

    __slots__ = ("peer",)

    def __init__(self, peer: str):
        self.peer = peer


class Service:
    """One named service; register async handlers `fn(request, context)
    -> dict`, then serve it with `serve`."""

    def __init__(self, name: str):
        self.name = name
        self._methods: Dict[str, Callable] = {}

    def unary(self, method_name: str):
        def deco(fn):
            self._methods[method_name] = fn
            return fn

        return deco

    def methods(self) -> Dict[str, Callable]:
        return dict(self._methods)


def _error_body(msg: str) -> bytes:
    return mpack.packb({"error": msg})


class RpcServer:
    """Routes `POST /<service>/<method>` to the registered handlers."""

    def __init__(self, *services: Service):
        self._routes: Dict[str, Callable] = {}
        for svc in services:
            for mname, fn in svc.methods().items():
                self._routes[f"/{svc.name}/{mname}"] = fn
        self._http = FastHTTPServer(self._handle)

    async def start(self, host: str, port: int) -> None:
        await self._http.start(host, port)

    async def stop(self) -> None:
        await self._http.stop()

    async def _handle(self, req) -> bytes:
        if req.method != "POST":
            return render_response(
                405, _error_body("rpc calls are POSTs"),
                content_type=_CONTENT_TYPE,
            )
        fn = self._routes.get(req.path)
        if fn is None:
            return render_response(
                501, _error_body(f"not ported: rpc {req.path.lstrip('/')}"),
                content_type=_CONTENT_TYPE,
            )
        try:
            request = mpack.unpackb(req.body)
        except (ValueError, UnicodeDecodeError) as e:
            return render_response(
                400, _error_body(f"bad msgpack request: {e}"),
                content_type=_CONTENT_TYPE,
            )
        try:
            reply = await fn(request, CallContext(req.peer))
            body = mpack.packb(reply)
        except Exception as e:
            return render_response(
                500, _error_body(f"{type(e).__name__}: {e}"),
                content_type=_CONTENT_TYPE,
            )
        return render_response(200, body, content_type=_CONTENT_TYPE)


async def serve(bind_address: str, *services: Service) -> RpcServer:
    """Start serving `services` on host:port; returns the server (stop()
    it to close the socket and its connections)."""
    host, _, port = bind_address.rpartition(":")
    server = RpcServer(*services)
    await server.start(host, int(port))
    return server


async def _read_reply(reader: asyncio.StreamReader, read_s: float):
    head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), read_s)
    lines = head[:-4].split(b"\r\n")
    parts = lines[0].split(b" ", 2)
    if len(parts) < 2 or not parts[1].isdigit():
        raise RpcError(0, f"malformed status line {lines[0][:80]!r}")
    status = int(parts[1])
    length = None
    for ln in lines[1:]:
        name, _, value = ln.partition(b":")
        if name.strip().lower() == b"content-length":
            length = int(value.strip())
    if length is None:
        raise RpcError(status, "reply without Content-Length")
    body = await asyncio.wait_for(reader.readexactly(length), read_s)
    return status, body


class Stub:
    """Client of one service at an RPC address (`grpc_address` of the
    server's HTTP address). Each call opens its own connection."""

    def __init__(self, address: str, service_name: str):
        self.address = address
        self.service = service_name

    async def call(
        self, method: str, request: Any, timeout: Optional[float] = 30
    ) -> Any:
        """The reply dict of one unary call; raises RpcError when the
        callee raised, does not have the method or cannot be reached in
        time."""
        t = client_timeout()
        host, _, port = self.address.rpartition(":")
        body = mpack.packb(request)
        head = (
            f"POST /{self.service}/{method} HTTP/1.1\r\n"
            f"Host: {self.address}\r\n"
            f"Content-Type: {_CONTENT_TYPE.decode()}\r\n"
            f"Content-Length: {len(body)}\r\n"
            "Connection: close\r\n\r\n"
        ).encode("latin1")

        async def once():
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host, int(port)), t.sock_connect
            )
            try:
                writer.write(head + body)
                await writer.drain()
                return await _read_reply(reader, t.sock_read)
            finally:
                writer.close()

        try:
            status, data = await asyncio.wait_for(once(), timeout)
        except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError) as e:
            raise RpcError(0, f"{self.service}/{method} to {self.address}: "
                              f"{type(e).__name__}: {e}") from e
        reply = mpack.unpackb(data)
        if status != 200:
            msg = reply.get("error", "") if isinstance(reply, dict) else reply
            raise RpcError(status, str(msg))
        return reply
