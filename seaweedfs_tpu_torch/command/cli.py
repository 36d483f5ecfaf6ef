"""`python -m seaweedfs_tpu_torch <command>` (ref: weed/command/command.go).

Ported from the JAX package's command/cli.py with one command so far,
`volume`: the volume server with the flags of `_add_volume_flags` and
`_build_volume_server` there. `-storageBackend` takes `cuda` (the
default: the card, which must be present), `cpu` and `numpy` (the host);
`adaptive` raises as not ported. `-index` takes `memory` and `lsm`.
`-batchLookup` takes `off`, `auto`, `host`, `device` and `arena`. The
flags that need the parts still to port (`-mserver` and the heartbeat's,
`-tierConfig`, `-config`, the profilers) are not declared, so argparse
refuses them. SIGINT and SIGTERM stop the server: the gate, the arena, the executor and the
sockets close, and the process exits with 0.
"""

from __future__ import annotations

import argparse
import asyncio
import signal
import sys
import threading


def _add_volume_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8080)
    p.add_argument("-dir", default="./data", help="comma-separated data dirs")
    p.add_argument("-max", default="7", help="comma-separated max volume counts")
    p.add_argument(
        "-storageBackend",
        default="cuda",
        choices=["cuda", "cpu", "numpy", "adaptive"],
        help="where the server computes: 'cuda' (the default) runs erasure "
        "coding and index lookups on the card's kernels; 'cpu' and "
        "'numpy' run their plain versions on the host; 'adaptive' is "
        "not ported",
    )
    p.add_argument(
        "-batchLookup",
        default="off",
        choices=["off", "auto", "host", "device", "arena"],
        help="micro-batch concurrent read index probes through one "
        "vectorized bulk lookup; 'arena' answers each wakeup as one "
        "ragged dispatch over the device-resident column arena",
    )
    p.add_argument(
        "-index",
        default="memory",
        choices=["memory", "leveldb", "sorted", "lsm"],
        help="needle map kind (ref NeedleMapKind, weed/storage/needle_map.go:14;"
        " the port has memory and lsm)",
    )
    p.add_argument(
        "-jwtSigningKey",
        default="",
        help="HS256 key gating uploads and deletes (ref security/jwt.go)",
    )
    p.add_argument(
        "-whiteList",
        default="",
        help="comma-separated IPs/CIDRs allowed to write (ref guard.go); "
        "empty = everyone",
    )


def _build_volume_server(args):
    from ..server.volume import VolumeServer

    dirs = args.dir.split(",")
    maxes = [int(m) for m in args.max.split(",")]
    if len(maxes) == 1:
        maxes = maxes * len(dirs)
    return VolumeServer(
        directories=dirs,
        host=args.ip,
        port=args.port,
        max_volume_counts=maxes,
        needle_map_kind=args.index,
        codec_backend=args.storageBackend,
        jwt_signing_key=args.jwtSigningKey,
        white_list=tuple(x for x in args.whiteList.split(",") if x),
        batch_lookup=args.batchLookup,
    )


async def _run_forever(*servers, started=None) -> None:
    """Start the servers and serve until SIGINT or SIGTERM (in the main
    thread) or until `started`'s caller sets the stop event. `started`,
    when given, is called once the servers listen, with (loop, stop event,
    servers), so a caller in another thread can read them and stop them
    with `loop.call_soon_threadsafe(stop.set)`."""
    loop = asyncio.get_running_loop()
    stop = asyncio.Event()
    try:
        for s in servers:
            await s.start()
        if threading.current_thread() is threading.main_thread():
            for sig in (signal.SIGINT, signal.SIGTERM):
                loop.add_signal_handler(sig, stop.set)
        if started is not None:
            started(loop, stop, servers)
        await stop.wait()
    finally:
        for s in servers:
            await s.stop()


def cmd_volume(argv: list[str], started=None) -> int:
    p = argparse.ArgumentParser(prog="seaweedfs_tpu_torch volume")
    _add_volume_flags(p)
    args = p.parse_args(argv)
    vs = _build_volume_server(args)
    print(f"volume server listening on {args.ip}:{args.port} "
          f"(device {vs.device})", flush=True)
    asyncio.run(_run_forever(vs, started=started))
    return 0


COMMANDS = {
    "volume": cmd_volume,
}


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print("usage: python -m seaweedfs_tpu_torch <command> [options]\n"
              "commands: " + " ".join(sorted(COMMANDS)))
        return 0
    cmd = COMMANDS.get(argv[0])
    if cmd is None:
        print(f"unknown command {argv[0]!r} (the port has: "
              f"{', '.join(sorted(COMMANDS))})", file=sys.stderr)
        return 1
    return cmd(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
