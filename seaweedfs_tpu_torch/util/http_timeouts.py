"""One default set of timeouts for every outbound call in the port.

The JAX package's util/http_timeouts.py gives every aiohttp session one
`ClientTimeout` (connect 10 s, per-read 60 s, no total), so that an
unbounded wait against a hung peer can never wedge a caller. The port
has no aiohttp; its RPC client (pb/rpc.py `Stub.call`) opens a standard
library connection and applies the same bounds:

- `sock_connect=10`: a peer that cannot complete a TCP handshake in 10 s
  is down;
- `sock_read=60`: every read must make progress within 60 s;
- `total=None`: no bound on the whole call beyond the caller's own
  timeout (`Stub.call(timeout=...)`, 30 s by default).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ClientTimeout:
    total: Optional[float] = None
    sock_connect: float = 10.0
    sock_read: float = 60.0


def client_timeout(
    total: float | None = None,
    sock_connect: float = 10.0,
    sock_read: float = 60.0,
) -> ClientTimeout:
    """The default outbound timeouts."""
    return ClientTimeout(
        total=total, sock_connect=sock_connect, sock_read=sock_read
    )
