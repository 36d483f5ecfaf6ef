"""The tenant request context, from the JAX package's util/tenancy.py.

A request's tenant principal rides a context variable for its task tree:
`set_current` / `reset_current` bind it, `current` reads it, and
`tenant_from_request` derives it from a request (an explicit
`X-Seaweed-Tenant` header, else the `collection` query parameter, else
None, the default tenant). The filer's ChunkUploadGate carries each
item's principal into the tenant-tagged `/!batch/put` frame with it.

The rest of the JAX module (per-tenant weights, quotas and the metric
label policy, which the admission gate consumes) is not ported yet.
"""

from __future__ import annotations

from contextvars import ContextVar
from typing import Optional

DEFAULT_TENANT = "default"
TENANT_HEADER = "X-Seaweed-Tenant"
TENANT_HEADER_B = b"x-seaweed-tenant"

# current tenant principal for this task tree (None = default)
_TENANT: ContextVar[Optional[str]] = ContextVar("swfs_tenant", default=None)
current = _TENANT.get
set_current = _TENANT.set
reset_current = _TENANT.reset


def tenant_from_request(req) -> Optional[str]:
    """Explicit header, else collection query parameter, else None (->
    default tenant). `req` is a util/fasthttp.FastRequest (lower-cased
    byte header names)."""
    t = req.headers.get(TENANT_HEADER_B)
    if t:
        return t.decode("latin1")
    q = req.query
    if q:
        idx = q.find("collection=")
        while idx >= 0:
            # parameter-boundary guard — but keep SCANNING past a
            # rejected hit: "?mycollection=a&collection=beta" must find
            # the real parameter, not give up on the substring inside
            # "mycollection="
            if idx == 0 or q[idx - 1] == "&":
                end = q.find("&", idx)
                val = q[idx + 11: end if end >= 0 else len(q)]
                if val:
                    return val
            idx = q.find("collection=", idx + 1)
    return None
