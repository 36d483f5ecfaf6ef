"""Client operations: assign, upload, lookup, delete, submit
(ref: weed/operation/assign_file_id.go, upload_content.go, submit.go,
delete_content.go).

Ported from the JAX package's client/operation.py, whole: assign and
its count=N lease (`AssignLease`), upload, read, delete, lookup, the
BulkLookup and BatchRead calls, and `submit_file` with its chunked
branch (chunk needles plus a JSON manifest stored with cm=true, the
uploaded chunks deleted again when the upload fails). Where the JAX
functions take an aiohttp session, the port's take a `FastHTTPClient`
(util/fasthttp.py); `read_url` follows the volume servers' 301 to the
holder of a volume that is not local, as aiohttp does.
"""

from __future__ import annotations

import asyncio
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


class AssignLease:
    """Amortizes the per-write assign round-trip: one ``count=N`` assign
    leases N consecutive file ids, and ``take()`` hands them out as the
    ``fid``, ``fid_1`` ... ``fid_{N-1}`` derived forms every server-side
    parser already accepts (FileId.parse's ``_delta`` convention — the
    reference benchmark reuses count-assigned fids the same way,
    ref: weed/command/benchmark.go writeFiles).

    ``fetch`` is any ``async (count) -> AssignResult`` — the gRPC
    :func:`assign` by default, or an HTTP fetcher (the bench client passes
    one riding its keep-alive pool). Refills are single-flight: concurrent
    takers drained the lease await the same in-flight assign instead of
    stampeding the master. When the master signs upload JWTs the token
    covers the base fid only, so the lease detects ``auth`` in the first
    response and clamps itself to width 1 (one signed assign per write)
    instead of handing out unauthenticated derived fids.
    """

    def __init__(self, master: str = "", batch: int = 128, fetch=None, **kw):
        if fetch is None:
            if not master:
                raise ValueError("AssignLease needs a master or a fetch fn")

            async def fetch(count: int) -> AssignResult:
                return await assign(master, count=count, **kw)

        self._fetch = fetch
        self._batch = max(1, batch)
        self._cur: Optional[AssignResult] = None
        self._next_delta = 0
        self._refill: Optional[asyncio.Task] = None
        self._signed = False  # master signs uploads: lease width is 1
        self.assign_rpcs = 0  # refills performed (amortization visibility)

    async def take(self) -> AssignResult:
        while True:
            cur = self._cur
            if cur is not None and self._next_delta < cur.count:
                delta = self._next_delta
                self._next_delta += 1
                return AssignResult(
                    fid=cur.fid if delta == 0 else f"{cur.fid}_{delta}",
                    url=cur.url,
                    public_url=cur.public_url,
                    count=1,
                    auth=cur.auth if delta == 0 else "",
                )
            if self._refill is None:
                self._refill = asyncio.ensure_future(self._do_refill())
            refill = self._refill
            try:
                await refill
            finally:
                if self._refill is refill:
                    self._refill = None

    async def _do_refill(self) -> None:
        res = await self._fetch(1 if self._signed else self._batch)
        self.assign_rpcs += 1
        # a master that honors fewer ids than asked (or a batch=1 lease)
        # still works: count bounds the deltas handed out. A master that
        # SIGNS uploads clamps the lease to its base fid — derived fids
        # would carry no token and fail auth, so each take refills with
        # its own signed assign instead of failing 127 of 128 writes
        if res.auth:
            self._signed = True
            res = AssignResult(
                fid=res.fid, url=res.url, public_url=res.public_url,
                count=1, auth=res.auth,
            )
        self._cur = res
        self._next_delta = 0


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


async def bulk_lookup(server: str, vid: int, keys) -> tuple:
    """Batched fid -> (offset, size) probes against a volume server's
    device-resident index snapshot (BulkLookup RPC; no reference
    equivalent — the Go client probes one file id at a time).

    Returns (offset_units u32[P], sizes u32[P], found bool[P]).
    """
    import numpy as np

    keys = np.ascontiguousarray(np.asarray(keys, dtype=np.uint64), dtype="<u8")
    stub = Stub(grpc_address(server), "volume")
    resp = await stub.call(
        "BulkLookup", {"volume_id": vid, "keys": keys.tobytes()}
    )
    if resp.get("error"):
        raise RuntimeError(f"bulk_lookup: {resp['error']}")
    off_dtype = resp.get("offset_dtype", "<u4")
    return (
        np.frombuffer(resp["offsets"], dtype=off_dtype).astype(
            np.uint64 if off_dtype == "<u8" else np.uint32
        ),
        np.frombuffer(resp["sizes"], dtype="<u4").astype(np.uint32),
        np.frombuffer(resp["found"], dtype=np.uint8).astype(bool),
    )


async def batch_read(server: str, vid: int, keys) -> list[Optional[bytes]]:
    """Bulk needle reads through the BatchRead stream; returns each probe's
    data bytes in order (None for missing/deleted needles)."""
    import numpy as np

    keys = np.ascontiguousarray(np.asarray(keys, dtype=np.uint64), dtype="<u8")
    stub = Stub(grpc_address(server), "volume")
    out: dict[int, Optional[bytes]] = {}
    async for msg in stub.server_stream(
        "BatchRead", {"volume_id": vid, "keys": keys.tobytes()}
    ):
        if msg.get("error") and "key" not in msg:
            raise RuntimeError(f"batch_read: {msg['error']}")
        out[int(msg["key"])] = msg.get("data") if msg.get("found") else None
    return [out.get(int(k)) for k in keys]


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
    """assign + upload in one call (ref operation/submit.go:41).

    With chunk_size > 0 and a larger payload, the file is split into
    chunk needles (each with its own assign) plus a JSON chunk manifest
    stored under the primary fid with the cm=true flag — the path that
    lets a file exceed one needle/volume (ref: submit.go:127-195,
    operation/chunked_file.go:26-73).
    """
    ar = await assign(
        master, collection=collection, replication=replication, ttl=ttl
    )
    if chunk_size <= 0 or len(data) <= chunk_size:
        result = await upload_data(
            http,
            ar.url,
            ar.fid,
            data,
            filename=filename,
            mime=mime,
            ttl=ttl,
            jwt=ar.auth,
        )
        return ar.fid, result

    chunks = []
    chunk_auths: dict[str, str] = {}
    try:
        for i in range(0, -(-len(data) // chunk_size)):
            part = data[i * chunk_size : (i + 1) * chunk_size]
            car = await assign(
                master, collection=collection, replication=replication, ttl=ttl
            )
            await upload_data(
                http,
                car.url,
                car.fid,
                part,
                filename=f"{filename or 'file'}-{i + 1}",
                ttl=ttl,
                jwt=car.auth,
            )
            chunks.append(
                {"fid": car.fid, "offset": i * chunk_size, "size": len(part)}
            )
            chunk_auths[car.fid] = car.auth
        manifest = {
            "name": filename,
            "mime": mime,
            "size": len(data),
            "chunks": chunks,
        }
        result = await upload_data(
            http,
            ar.url,
            ar.fid,
            json.dumps(manifest).encode(),
            filename=filename,
            ttl=ttl,
            params={"cm": "true"},
            jwt=ar.auth,
        )
        result["size"] = len(data)
        return ar.fid, result
    except Exception:
        # best-effort cleanup of already-uploaded chunks
        # (ref submit.go cm.DeleteChunks on error)
        for c in chunks:
            try:
                vid = int(c["fid"].split(",")[0])
                locs = await lookup(master, vid)
                if locs:
                    await delete_file(
                        http, locs[0], c["fid"], jwt=chunk_auths.get(c["fid"], "")
                    )
            except Exception:
                pass
        raise
