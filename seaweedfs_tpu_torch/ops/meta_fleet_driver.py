"""Out-of-process load driver for the metadata fleet's lookups and LISTs.

A fleet's lookup/LIST rate must be measured with a client that is never
the bottleneck — and a Python thread pool in the measuring process is
exactly that (every RPC message encode/decode holds the GIL). Each
driver is therefore its own OS process: the caller spawns K of them via
``python -m seaweedfs_tpu_torch.ops.meta_fleet_driver``, hands each a
JSON spec on stdin, and reads a JSON result from stdout.

Start synchronization is filesystem-based: a driver finishes its setup
(stubs built, spec parsed), drops a ``<go>.ready.<pid>`` marker, and
spins until the parent creates the ``go`` file — so K drivers start
probing together and the measured wall covers probing only, not
process startup. Every probe is identity-checked in-flight (lookup:
the entry's expected etag, or `not found` for an absent path; LIST: the
directory's expected entry count), so the rate can't be bought with
wrong answers.

Ported from the JAX package's ops/meta_fleet_driver.py, on the port's RPC
tier; the spec and the result are the same JSON, with absent-path items
added.
"""

from __future__ import annotations

import asyncio
import bisect
import json
import os
import sys
import time


def drive(spec: dict) -> dict:
    """Run one driver's probe slice; returns counters + wall seconds.

    spec: {kind: lookup|list, addresses, bounds, items, concurrency,
    go_file}. A lookup item whose etag is null names an absent path,
    which must answer `not found`. Items route client-side off the fleet
    map snapshot (addresses+bounds) — correct by construction while no
    move runs; the server-side ownership check would forward strays
    anyway.
    """
    from ..pb import grpc_address
    from ..pb.rpc import Stub

    addresses = spec["addresses"]
    bounds = spec["bounds"]
    items = spec["items"]
    kind = spec["kind"]
    concurrency = int(spec.get("concurrency", 16))
    go_file = spec.get("go_file", "")
    out = {"n": 0, "errors": 0, "mismatches": 0, "wall_s": 0.0}

    async def run() -> None:
        stubs = {a: Stub(grpc_address(a), "filer") for a in addresses}
        next_i = [0]

        async def worker() -> None:
            while True:
                i = next_i[0]
                if i >= len(items):
                    return
                next_i[0] = i + 1
                it = items[i]
                d = it["directory"]
                stub = stubs[addresses[bisect.bisect_right(bounds, d)]]
                try:
                    if kind == "lookup":
                        r = await stub.call(
                            "LookupDirectoryEntry",
                            {"directory": d, "name": it["name"]},
                            timeout=15.0,
                        )
                        e = r.get("entry")
                        if it["etag"] is None:
                            # an absent path: only `not found` is right
                            if e is not None or r.get("error") != "not found":
                                out["mismatches"] += 1
                        elif (
                            e is None
                            or (e.get("extended") or {}).get("etag")
                            != it["etag"]
                        ):
                            out["mismatches"] += 1
                    else:
                        r = await stub.call(
                            "ListEntries",
                            {"directory": d, "limit": 4096},
                            timeout=15.0,
                        )
                        if len(r.get("entries") or []) != it["count"]:
                            out["mismatches"] += 1
                except Exception:
                    out["errors"] += 1
                out["n"] += 1

        if go_file:
            open(f"{go_file}.ready.{os.getpid()}", "w").close()
            while not os.path.exists(go_file):
                await asyncio.sleep(0.005)
        t0 = time.perf_counter()
        await asyncio.gather(*(worker() for _ in range(concurrency)))
        out["wall_s"] = time.perf_counter() - t0

    asyncio.run(run())
    return out


def main() -> int:
    spec = json.load(sys.stdin)
    json.dump(drive(spec), sys.stdout)
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
