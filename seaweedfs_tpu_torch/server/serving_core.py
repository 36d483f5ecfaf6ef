"""Shared HTTP serving core: one standard-library HTTP/1.1 server per
server, which serves every request itself.

A subset of the JAX package's server/serving_core.py. There, the public
port is a byte-level fast tier and every request it does not fully
understand is replayed against an aiohttp application on an internal
port. The port has one tier: `ServingCore` owns the listening socket
(util/fasthttp.py), counts requests per method (the counters the JAX core
keeps, `seaweedfs_tpu_request_total{server, operation}`), serves
`/metrics` and the server's own `/debug/...` handlers, and hands every
other request to the server's dispatch. The server-side HTTP fault seam
(util/faults.py) fires here, at request arrival, as in the JAX core:
`http:<METHOD>` against the server's address; with no plan it costs one
module-attribute load and an `is None` check. The other shared debug
surfaces (`/debug/traces`, `/debug/overload`, `/debug/pprof/...`) and the
overload, tenancy and tracing seams are not ported: those paths answer
501.
"""

from __future__ import annotations

import json
from typing import Awaitable, Callable, Optional

from ..util import faults, metrics
from ..util.fasthttp import DETACHED, FastHTTPServer, render_response


def json_body(obj) -> bytes:
    """A JSON reply body in the JAX servers' aiohttp `json_response` form
    (json.dumps with its default separators)."""
    return json.dumps(obj).encode()


def not_ported(what: str, head_only: bool = False) -> bytes:
    """The answer to a request shape the port does not serve yet."""
    return render_response(
        501, json_body({"error": f"not ported: {what}"}), head_only=head_only
    )


class ServingCore:
    def __init__(
        self,
        name: str,
        dispatch: Callable[[object], Awaitable[object]],
        host: str,
        port: int,
        debug_handlers: Optional[dict] = None,
    ):
        self.name = name
        self.handler = dispatch
        self.host = host
        self.port = port
        self.debug_handlers = dict(debug_handlers or {})
        self.address = f"{host}:{port}"
        self.fast_server: Optional[FastHTTPServer] = None

    async def start(self) -> None:
        self.fast_server = FastHTTPServer(self._dispatch)
        await self.fast_server.start(self.host, self.port)

    async def stop(self) -> None:
        if self.fast_server is not None:
            await self.fast_server.stop()

    def count(self, method: str) -> None:
        metrics.REQUEST_COUNTER.inc(server=self.name, operation=method)

    async def _dispatch(self, req):
        plan = faults._PLAN
        if plan is not None:
            out = await self._apply_fault(plan, req)
            if out is not None:
                return out
        path = req.path
        if path == "/metrics":
            self.count(req.method)
            return render_response(
                200, metrics.render().encode(), content_type=b"text/plain"
            )
        if path.startswith("/debug/"):
            self.count(req.method)
            fn = self.debug_handlers.get(path)
            if fn is None:
                return not_ported(f"{path}", head_only=req.method == "HEAD")
            return await fn(req)
        out = await self.handler(req)
        # a DETACHED response counts when its continuation writes it
        if out is not DETACHED:
            self.count(req.method)
        return out

    async def _apply_fault(self, plan, req):
        """Server-side HTTP seam: consult the plan at request arrival.
        Returns response bytes / DETACHED to short-circuit, or None to
        proceed to the handler (latency rules have already slept)."""
        try:
            ev = await faults.async_fault(
                plan, f"http:{req.method}", self.address
            )
        except faults.SimulatedCrash:
            # the 'process' is dead: connections just drop, mid-request
            if req.transport is not None:
                req.transport.close()
            return DETACHED
        except ConnectionError:
            # injected reset or partition: the peer sees a dropped
            # connection, like the client-seam variant
            if req.transport is not None:
                req.transport.close()
            return DETACHED
        except TimeoutError:
            # an injected hang already slept through its window; surface
            # the way a gateway's upstream timeout would
            return render_response(
                500, b'{"error":"injected hang"}', keep_alive=False
            )
        if ev is not None and ev.kind == "http_error":
            # shed-shaped statuses carry Retry-After like a real 503
            extra = (
                b"Retry-After: 1\r\n"
                if ev.rule.status in (503, 429)
                else b""
            )
            return render_response(
                ev.rule.status, b'{"error":"injected fault"}', extra=extra
            )
        return None
