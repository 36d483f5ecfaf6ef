"""RPCs with msgpack bodies over HTTP/1.1, on the standard library.

The JAX package's pb/rpc.py serves named methods over gRPC (grpcio's
dynamic handlers) with msgpack message bodies. The port depends on
neither grpcio nor msgpack, so it keeps the same surface (`Service.unary`,
`Service.server_stream`, `Service.bidi_stream`, `Stub.call`,
`Stub.server_stream`, `Stub.bidi_stream`, the method names and message
dicts of the JAX handlers, and the `{"error": ...}` reply convention) on
a transport of its own, served on the RPC port (HTTP port + 10000,
pb/__init__.py) by an asyncio stream server:

- **unary**: one HTTP/1.1 `POST /<service>/<method>` per call. The
  request and reply bodies are msgpack maps (`util/mpack.py`, byte-equal
  to `msgpack.packb(obj, use_bin_type=True)`). 200 carries the handler's
  reply, errors included as `{"error": ...}`; a handler that raises
  answers 500 and an unknown method 501, both with an `{"error": ...}`
  body, and `Stub.call` raises `RpcError` for them (as a gRPC stub raises
  for a failed or unimplemented call).
- **streams** (server streams such as `CopyFile` and `VolumeEcShardRead`,
  and the bidirectional `SendHeartbeat` and `KeepConnected`): the same
  POST with `Upgrade: seaweed-stream`, answered `101 Switching Protocols`
  (or the unary error answers above). The connection then carries frames
  in both directions: one kind byte, a big-endian u32 length and that
  many bytes of msgpack. `D` is a message, `E` the end of the sender's
  messages and `X` an error (`{"error": ...}`), which the caller raises
  as `RpcError`. Writers await `drain()`, and received messages wait in a
  bounded queue, so neither side buffers without bound. A server stream
  is a bidi stream whose caller writes one message and `E`.
- When the peer's connection ends, the handler's task is cancelled (as a
  gRPC handler is when its caller goes away), and a caller reading a
  stream that ended without `E` gets `RpcError` with status 0.

The wire is not gRPC: a port server and a JAX server cannot call each
other. Left out with gRPC: mTLS, keepalive channels and the overload,
tenancy and tracing seams. The fault plane's client seam (util/faults.py)
is the JAX one: `Stub.call` and `Stub.server_stream` consult an installed
plan as `rpc:<Method>` against the callee's address before the wire.
"""

from __future__ import annotations

import asyncio
import struct
from typing import Any, AsyncIterator, Dict, Optional

from ..util import faults, mpack
from ..util.backoff import shared_retry_budget
from ..util.fasthttp import _MAX_BODY, render_response
from ..util.http_timeouts import client_timeout

_CONTENT_TYPE = b"application/msgpack"
_UPGRADE = "seaweed-stream"

UNARY_UNARY = "unary_unary"
UNARY_STREAM = "unary_stream"
STREAM_STREAM = "stream_stream"

# a stream read returns EOF once the peer sent its end-of-stream frame
# (the place of grpc.aio.EOF)
EOF = None

_FRAME = struct.Struct(">cI")
_DATA, _END, _ERROR = b"D", b"E", b"X"
_MAX_FRAME = 64 << 20  # the JAX package's max gRPC message length
_QUEUE_DEPTH = 16  # received messages held before reading stops
# how long a finished stream waits for its caller to finish writing and
# close before the server closes the connection itself
_LINGER_S = 2.0
_MAX_HEAD = 64 * 1024


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
    """One named service; register async handlers, then serve it with
    `serve`. A unary handler is `fn(request, context) -> dict`; a
    server-stream handler an async generator `fn(request, context)`; a
    bidi handler an async generator `fn(request_iterator, context)`."""

    def __init__(self, name: str):
        self.name = name
        self._methods: Dict[str, tuple] = {}

    def _register(self, kind: str, method_name: str):
        def deco(fn):
            self._methods[method_name] = (kind, fn)
            return fn

        return deco

    def unary(self, method_name: str):
        return self._register(UNARY_UNARY, method_name)

    def server_stream(self, method_name: str):
        return self._register(UNARY_STREAM, method_name)

    def bidi_stream(self, method_name: str):
        return self._register(STREAM_STREAM, method_name)

    def methods(self) -> Dict[str, tuple]:
        return dict(self._methods)


def _error_body(msg: str) -> bytes:
    return mpack.packb({"error": msg})


def _frame(kind: bytes, obj) -> bytes:
    body = mpack.packb(obj)
    return _FRAME.pack(kind, len(body)) + body


async def _read_frame(reader: asyncio.StreamReader):
    """(kind, message) of the next frame; raises IncompleteReadError when
    the connection ends first."""
    kind, n = _FRAME.unpack(await reader.readexactly(_FRAME.size))
    if n > _MAX_FRAME:
        raise ValueError(f"frame of {n} bytes")
    return kind, (mpack.unpackb(await reader.readexactly(n)) if n else None)


async def _read_head(reader: asyncio.StreamReader):
    """(first line parts, lower-cased headers) of an HTTP/1.1 head."""
    head = await reader.readuntil(b"\r\n\r\n")
    lines = head[:-4].split(b"\r\n")
    headers = {}
    for ln in lines[1:]:
        name, _, value = ln.partition(b":")
        headers[name.strip().lower()] = value.strip()
    return lines[0].split(b" ", 2), headers


class _ServerStream:
    """The server's side of one stream: received messages wait in a
    bounded queue filled by a reader task; `pump` writes the handler's
    messages."""

    def __init__(self, reader, writer):
        self.reader = reader
        self.writer = writer
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=_QUEUE_DEPTH)
        self.pump_task: Optional[asyncio.Task] = None

    async def read_loop(self) -> None:
        """Receive frames until the connection ends; the end of the
        connection cancels the handler (the peer went away)."""
        ended = False
        try:
            while True:
                kind, msg = await _read_frame(self.reader)
                if kind == _DATA and not ended:
                    await self.queue.put(msg)
                elif kind == _END and not ended:
                    ended = True
                    await self.queue.put(EOF)
        except (asyncio.IncompleteReadError, ConnectionError, ValueError):
            pass
        if not ended:
            try:
                self.queue.put_nowait(EOF)
            except asyncio.QueueFull:
                pass
        if self.pump_task is not None and not self.pump_task.done():
            self.pump_task.cancel()

    async def requests(self):
        while True:
            msg = await self.queue.get()
            if msg is EOF:
                return
            yield msg

    async def pump(self, gen) -> None:
        w = self.writer
        try:
            async for item in gen:
                w.write(_frame(_DATA, item))
                await w.drain()
        except (asyncio.CancelledError, ConnectionError):
            raise
        except Exception as e:
            w.write(_frame(_ERROR, {"error": f"{type(e).__name__}: {e}"}))
            await w.drain()
            return
        w.write(_FRAME.pack(_END, 0))
        await w.drain()


class RpcServer:
    """Routes `POST /<service>/<method>` to the registered handlers."""

    def __init__(self, *services: Service):
        self._routes: Dict[str, tuple] = {}
        for svc in services:
            for mname, route in svc.methods().items():
                self._routes[f"/{svc.name}/{mname}"] = route
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()

    async def start(self, host: str, port: int) -> None:
        self._server = await asyncio.start_server(
            self._serve_conn, host, port, reuse_address=True,
            limit=_MAX_HEAD,
        )

    async def stop(self) -> None:
        """Stop listening and end every connection; stream handlers are
        cancelled."""
        if self._server is not None:
            self._server.close()
        tasks = list(self._conns)
        for t in tasks:
            t.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        if self._server is not None:
            try:
                await asyncio.wait_for(self._server.wait_closed(), 5.0)
            except (asyncio.TimeoutError, Exception):
                pass

    async def _serve_conn(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        peer = writer.get_extra_info("peername")
        peer = peer[0] if peer else ""
        try:
            while True:
                try:
                    first, headers = await _read_head(reader)
                    n = int(headers.get(b"content-length", b"0") or 0)
                    if not 0 <= n <= _MAX_BODY:  # the HTTP tier's cap
                        writer.write(render_response(
                            400, _error_body(f"bad request body length {n}"),
                            content_type=_CONTENT_TYPE, keep_alive=False))
                        await writer.drain()
                        return
                    body = await reader.readexactly(n)
                except (asyncio.IncompleteReadError, asyncio.LimitOverrunError,
                        ConnectionError, ValueError):
                    return
                method = first[0].decode("latin1")
                path = first[1].decode("latin1") if len(first) > 1 else ""
                upgrade = headers.get(b"upgrade", b"").decode("latin1")
                if upgrade == _UPGRADE:
                    await self._serve_stream(path, method, reader, writer, peer)
                    return
                writer.write(await self._unary(method, path, body, peer))
                await writer.drain()
                if headers.get(b"connection", b"").lower() == b"close":
                    return
        except (asyncio.CancelledError, ConnectionError):
            pass
        finally:
            self._conns.discard(task)
            writer.close()

    def _refusal(self, method: str, path: str, want_stream: bool):
        """The error answer for a call this server cannot route, or None."""
        if method != "POST":
            return render_response(405, _error_body("rpc calls are POSTs"),
                                   content_type=_CONTENT_TYPE)
        route = self._routes.get(path)
        if route is None:
            return render_response(
                501, _error_body(f"not ported: rpc {path.lstrip('/')}"),
                content_type=_CONTENT_TYPE,
            )
        if (route[0] != UNARY_UNARY) != want_stream:
            return render_response(
                400, _error_body(f"rpc {path.lstrip('/')} is {route[0]}"),
                content_type=_CONTENT_TYPE,
            )
        return None

    async def _unary(self, method: str, path: str, body: bytes, peer: str):
        refused = self._refusal(method, path, want_stream=False)
        if refused is not None:
            return refused
        try:
            request = mpack.unpackb(body)
        except (ValueError, UnicodeDecodeError) as e:
            return render_response(
                400, _error_body(f"bad msgpack request: {e}"),
                content_type=_CONTENT_TYPE,
            )
        try:
            reply = await self._routes[path][1](request, CallContext(peer))
            out = mpack.packb(reply)
        except Exception as e:
            return render_response(
                500, _error_body(f"{type(e).__name__}: {e}"),
                content_type=_CONTENT_TYPE,
            )
        return render_response(200, out, content_type=_CONTENT_TYPE)

    async def _serve_stream(self, path, method, reader, writer, peer) -> None:
        refused = self._refusal(method, path, want_stream=True)
        if refused is not None:
            writer.write(refused)
            await writer.drain()
            return
        kind, fn = self._routes[path]
        writer.write(
            b"HTTP/1.1 101 Switching Protocols\r\n"
            b"Upgrade: " + _UPGRADE.encode() + b"\r\n"
            b"Connection: Upgrade\r\n\r\n"
        )
        stream = _ServerStream(reader, writer)
        reader_task = asyncio.ensure_future(stream.read_loop())
        try:
            ctx = CallContext(peer)
            if kind == UNARY_STREAM:
                request = await stream.queue.get()
                if request is EOF:
                    return
                gen = fn(request, ctx)
            else:
                gen = fn(stream.requests(), ctx)
            stream.pump_task = asyncio.ensure_future(stream.pump(gen))
            try:
                await stream.pump_task
            except (asyncio.CancelledError, ConnectionError):
                pass
            finally:
                await gen.aclose()
            # the caller closes once it has read our end: closing first,
            # while its frames may still be in flight, resets the
            # connection, and a reset can drop our last frames before the
            # caller has read them. A server that stops does not wait.
            if not asyncio.current_task().cancelling():
                try:
                    await asyncio.wait_for(asyncio.shield(reader_task),
                                           _LINGER_S)
                except asyncio.TimeoutError:
                    pass
        finally:
            reader_task.cancel()
            try:
                await reader_task
            except (asyncio.CancelledError, Exception):
                pass


async def serve(bind_address: str, *services: Service) -> RpcServer:
    """Start serving `services` on host:port; returns the server (stop()
    it to close the socket and its connections)."""
    host, _, port = bind_address.rpartition(":")
    server = RpcServer(*services)
    await server.start(host, int(port))
    return server


async def _read_reply(reader: asyncio.StreamReader, read_s: float):
    first, headers = await asyncio.wait_for(_read_head(reader), read_s)
    if len(first) < 2 or not first[1].isdigit():
        raise RpcError(0, f"malformed status line {b' '.join(first)[:80]!r}")
    status = int(first[1])
    if status == 101:
        return status, b""
    if b"content-length" not in headers:
        raise RpcError(status, "reply without Content-Length")
    body = await asyncio.wait_for(
        reader.readexactly(int(headers[b"content-length"])), read_s
    )
    return status, body


def _error_of(status: int, data: bytes) -> RpcError:
    try:
        reply = mpack.unpackb(data)
    except (ValueError, UnicodeDecodeError):
        reply = data
    msg = reply.get("error", "") if isinstance(reply, dict) else reply
    return RpcError(status, str(msg))


class StreamCall:
    """The caller's side of one stream (the place of a grpc.aio stream
    call): `write`, `done_writing`, `read` (EOF at the end) and `cancel`;
    iterating it yields the callee's messages. The connection opens on the
    first `write` or `read`. `timeout` bounds the whole call."""

    def __init__(self, address: str, service: str, method: str,
                 timeout: Optional[float] = None):
        self.address = address
        self.service = service
        self.method = method
        self._deadline = (
            None if timeout is None
            else asyncio.get_running_loop().time() + timeout
        )
        self._opening: Optional[asyncio.Future] = None
        self._reader = None
        self._writer = None
        self._ended = False
        self._writer_task: Optional[asyncio.Task] = None

    def _left(self, default: Optional[float]) -> Optional[float]:
        if self._deadline is None:
            return default
        left = self._deadline - asyncio.get_running_loop().time()
        if left <= 0:
            raise RpcError(0, f"{self.service}/{self.method} to "
                              f"{self.address}: deadline exceeded")
        return left if default is None else min(left, default)

    def _fail(self, e: BaseException) -> RpcError:
        return RpcError(0, f"{self.service}/{self.method} to {self.address}: "
                           f"{type(e).__name__}: {e}")

    async def _open(self) -> None:
        t = client_timeout()
        host, _, port = self.address.rpartition(":")
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host, int(port)),
                self._left(t.sock_connect),
            )
        except (OSError, asyncio.TimeoutError) as e:
            raise self._fail(e) from e
        writer.write((
            f"POST /{self.service}/{self.method} HTTP/1.1\r\n"
            f"Host: {self.address}\r\n"
            f"Upgrade: {_UPGRADE}\r\nConnection: Upgrade\r\n"
            "Content-Length: 0\r\n\r\n"
        ).encode("latin1"))
        try:
            status, body = await _read_reply(reader, self._left(t.sock_read))
        except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError,
                asyncio.LimitOverrunError) as e:
            writer.close()
            raise self._fail(e) from e
        except RpcError:
            writer.close()
            raise
        if status != 101:
            writer.close()
            raise _error_of(status, body)
        self._reader, self._writer = reader, writer

    async def _ensure_open(self) -> None:
        if self._opening is None:
            self._opening = asyncio.ensure_future(self._open())
        await asyncio.shield(self._opening)

    async def write(self, message: Any) -> None:
        await self._ensure_open()
        try:
            self._writer.write(_frame(_DATA, message))
            await self._writer.drain()
        except (OSError, RuntimeError) as e:
            raise self._fail(e) from e

    async def done_writing(self) -> None:
        await self._ensure_open()
        try:
            self._writer.write(_FRAME.pack(_END, 0))
            await self._writer.drain()
        except (OSError, RuntimeError) as e:
            raise self._fail(e) from e

    async def read(self) -> Any:
        """The callee's next message, or EOF after its end-of-stream."""
        if self._ended:
            return EOF
        await self._ensure_open()
        try:
            kind, msg = await asyncio.wait_for(
                _read_frame(self._reader), self._left(None)
            )
        except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError,
                ValueError) as e:
            self.cancel()
            raise self._fail(e) from e
        if kind == _END:
            self._ended = True
            return EOF
        if kind == _ERROR:
            self._ended = True
            self.cancel()
            raise RpcError(500, str(msg.get("error", msg)))
        return msg

    def cancel(self) -> None:
        """End the call: the callee's handler is cancelled."""
        if self._writer_task is not None:
            self._writer_task.cancel()
        if self._opening is not None and not self._opening.done():
            self._opening.cancel()
        if self._writer is not None:
            self._writer.close()

    def __aiter__(self):
        return self

    async def __anext__(self):
        msg = await self.read()
        if msg is EOF:
            raise StopAsyncIteration
        return msg

    def _send_all(self, request_iterator) -> None:
        async def run() -> None:
            async for item in request_iterator:
                await self.write(item)
            await self.done_writing()

        self._writer_task = asyncio.ensure_future(run())


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

        if faults._PLAN is not None:
            # fault-injection seam: reset / latency / hang before the
            # wire; an injected hang honors this call's timeout
            await faults.async_fault(
                faults._PLAN, f"rpc:{method}", self.address, timeout=timeout
            )
        try:
            status, data = await asyncio.wait_for(once(), timeout)
        except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError,
                asyncio.LimitOverrunError) as e:
            raise RpcError(0, f"{self.service}/{method} to {self.address}: "
                              f"{type(e).__name__}: {e}") from e
        if status != 200:
            raise _error_of(status, data)
        # every completed unary call is successful traffic for the shared
        # retry budget, the same deposit the HTTP client makes
        shared_retry_budget().on_success()
        return mpack.unpackb(data)

    async def server_stream(
        self, method: str, request: Any, timeout: Optional[float] = None
    ) -> AsyncIterator[Any]:
        """The callee's messages for one request; raises RpcError as
        `call` does, and when the stream breaks before its end. Leaving
        the loop early cancels the callee's handler."""
        plan = faults._PLAN
        if plan is not None:
            # the injection seam fires before the first item: a reset
            # here looks like a peer that dropped the stream
            await faults.async_fault(
                plan, f"rpc:{method}", self.address, timeout=timeout
            )
        call = StreamCall(self.address, self.service, method, timeout)
        try:
            await call.write(request)
            await call.done_writing()
            async for msg in call:
                yield msg
        finally:
            call.cancel()

    def bidi_stream(self, method: str, request_iterator=None) -> StreamCall:
        """A bidirectional call; with `request_iterator` a task writes its
        messages and the end of stream."""
        call = StreamCall(self.address, self.service, method)
        if request_iterator is not None:
            call._send_all(request_iterator)
        return call
