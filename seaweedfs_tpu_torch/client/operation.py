"""Client operations: assign, upload, lookup, delete, submit
(ref: weed/operation/assign_file_id.go, upload_content.go, submit.go,
delete_content.go).

Ported from the JAX package's client/operation.py. Where the JAX
functions take an aiohttp session, the port's take a `FastHTTPClient`
(util/fasthttp.py); `read_url` follows the volume servers' 301 to the
holder of a volume that is not local, as aiohttp does. Not ported:
chunked uploads (`submit_file(chunk_size=...)` over a payload larger
than one chunk raises, as the chunk manifests are not served),
`bulk_lookup`, `batch_read` and `AssignLease` (the benchmark's
`-assignBatch` leases of count=N file ids).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional

from ..pb import grpc_address
from ..pb.rpc import Stub
from ..util.fasthttp import FastHTTPClient, build_multipart, response_header


@dataclass
class AssignResult:
    fid: str
    url: str
    public_url: str
    count: int
    auth: str = ""  # fid-scoped upload JWT when the master signs (jwt.go)


async def http_assign(
    http, master: str, count: int = 1, collection: str = ""
) -> AssignResult:
    """One `/dir/assign` over a FastHTTPClient keep-alive pool, the HTTP
    twin of :func:`assign` (the benchmark's writes). The status is checked
    before parsing, so a non-JSON error body reports its status."""
    target = "/dir/assign"
    if collection:
        target += f"?collection={collection}"
    sep = "&" if "?" in target else "?"
    st, body = await http.request("GET", master, f"{target}{sep}count={count}")
    if st != 200:
        raise RuntimeError(f"assign: {st} {body[:200]!r}")
    ar = json.loads(body)
    if ar.get("error"):
        raise RuntimeError(f"assign: {st} {ar}")
    return AssignResult(
        fid=ar["fid"],
        url=ar["url"],
        public_url=ar.get("publicUrl", ar["url"]),
        count=int(ar.get("count", count)),
        auth=ar.get("auth", ""),
    )


async def assign(
    master: str,
    count: int = 1,
    collection: str = "",
    replication: str = "",
    ttl: str = "",
    data_center: str = "",
) -> AssignResult:
    stub = Stub(grpc_address(master), "master")
    resp = await stub.call(
        "Assign",
        {
            "count": count,
            "collection": collection,
            "replication": replication,
            "ttl": ttl,
            "dataCenter": data_center,
        },
    )
    if resp.get("error"):
        raise RuntimeError(f"assign: {resp['error']}")
    return AssignResult(
        fid=resp["fid"],
        url=resp["url"],
        public_url=resp.get("publicUrl", resp["url"]),
        count=int(resp.get("count", count)),
        auth=resp.get("auth", ""),
    )


async def upload_data(
    http: FastHTTPClient,
    url: str,
    fid: str,
    data: bytes,
    filename: str = "",
    mime: str = "",
    ttl: str = "",
    params: Optional[dict] = None,
    jwt: str = "",
) -> dict:
    target = f"/{fid}"
    query = dict(params or {})
    if ttl:
        query["ttl"] = ttl
    if query:
        target += "?" + "&".join(f"{k}={v}" for k, v in query.items())
    headers = {"Authorization": f"Bearer {jwt}"} if jwt else None
    body, ctype = build_multipart("file", data, filename=filename or "file",
                                  mime=mime)
    status, raw = await http.request("POST", url, target, body, ctype, headers)
    reply = json.loads(raw) if raw else {}
    if status >= 300 or reply.get("error"):
        raise RuntimeError(f"upload {fid}: {status} {reply.get('error')}")
    return reply


async def read_url(http: FastHTTPClient, full_url: str,
                   max_redirects: int = 3) -> bytes:
    """GET http://host:port/path, following redirects."""
    url = full_url
    for _ in range(max_redirects + 1):
        hostport, _, path = url.removeprefix("http://").partition("/")
        status, body, head = await http.request_full("GET", hostport,
                                                     "/" + path)
        if status in (301, 302, 307, 308):
            url = response_header(head, b"location")
            continue
        if status != 200:
            raise RuntimeError(
                f"read {full_url}: status {status} body {body[:200]!r}"
            )
        return body
    raise RuntimeError(f"read {full_url}: too many redirects")


async def delete_file(
    http: FastHTTPClient, url: str, fid: str, jwt: str = ""
) -> dict:
    headers = {"Authorization": f"Bearer {jwt}"} if jwt else None
    _status, raw = await http.request("DELETE", url, f"/{fid}",
                                      headers=headers)
    return json.loads(raw) if raw else {}


async def lookup(master: str, vid: int, collection: str = "") -> list[str]:
    stub = Stub(grpc_address(master), "master")
    resp = await stub.call(
        "LookupVolume", {"volume_ids": [str(vid)], "collection": collection}
    )
    for r in resp.get("volume_id_locations", []):
        if r.get("locations"):
            return [loc["url"] for loc in r["locations"]]
    return []


async def submit_file(
    http: FastHTTPClient,
    master: str,
    data: bytes,
    filename: str = "",
    collection: str = "",
    replication: str = "",
    ttl: str = "",
    mime: str = "",
    chunk_size: int = 0,
) -> tuple[str, dict]:
    """assign + upload in one call (ref operation/submit.go:41)."""
    if 0 < chunk_size < len(data):
        raise NotImplementedError(
            "not ported: chunked uploads (the chunk manifests)"
        )
    ar = await assign(
        master, collection=collection, replication=replication, ttl=ttl
    )
    result = await upload_data(
        http, ar.url, ar.fid, data, filename=filename, mime=mime, ttl=ttl,
        jwt=ar.auth,
    )
    return ar.fid, result
