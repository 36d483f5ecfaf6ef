"""`python -m seaweedfs_tpu_torch <command>` (ref: weed/command/command.go).

Ported from the JAX package's command/cli.py with the commands
`master`, `volume`, `server` (a master and a volume server in one process,
on one event loop; `-filer` adds a filer), `filer`, `shell` (the semicolon-separated one-shot commands
given as arguments, else a prompt), `benchmark` (with `-assignBatch`
leases), `upload` (with `-maxMB` chunking), `download` and `compact` (an
offline vacuum of one volume). `-storageBackend` takes `cuda` (the default: the
card, which must be present), `cpu` and `numpy` (the host); `adaptive`
raises as not ported. `-index` takes `memory`, `leveldb`, `sorted` and
`lsm`. `-batchLookup` takes `off`, `auto`, `host`, `device` and `arena`.
`-peers` runs a multi-master cluster through RaftLite. `-garbageThreshold`
is the master's vacuum threshold. `-pulseSeconds` sets the volume
server's heartbeat cadence (the JAX package reads it from
SEAWEEDFS_TPU_PULSE_SECONDS). The flags of the parts still to port
(`-tierConfig`, `-config`, the profilers, `-s3` of `server`; the filer's
`-geoSource`, `-geoState`, `-encryptVolumeData`, `-notifySink` and the
other `-notify*` flags) are not declared, so argparse refuses them. The
filer's scale-out flags are: `-shards` (the prefix-sharded store),
`-peers` (the metadata aggregator), `-fleetMap` and `-fleetSelf` (a
member of a range-owning fleet) and `-followSource` (a read replica). The
filer's meta gate runs its lookups on the card unless
SEAWEEDFS_TPU_META_GATE says otherwise (server/filer.py); in `server
-filer` it shares the volume server's arena (`-batchLookup arena`). SIGINT and SIGTERM stop the
servers: the heartbeat ends, the gate, the arena, the executor and the
sockets close, and the process exits with 0.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import signal
import sys
import threading


def _add_master_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=9333)
    p.add_argument("-volumeSizeLimitMB", type=int, default=30_000)
    p.add_argument("-defaultReplication", default="000")
    p.add_argument("-garbageThreshold", type=float, default=0.3)
    p.add_argument(
        "-peers",
        default="",
        help="comma-separated list of all master addresses (incl. self) "
        "for a multi-master raft cluster (ref weed master -peers)",
    )
    p.add_argument(
        "-jwtSigningKey",
        default="",
        help="HS256 key: the master issues fid-scoped upload JWTs and the "
        "volume servers verify them (ref security/jwt.go)",
    )
    p.add_argument(
        "-sequencerFile",
        default="",
        help="persist the file-id sequencer to this path; '' = in-memory",
    )
    p.add_argument(
        "-raftStateFile",
        default="",
        help="persist raft term/vote/max-volume-id to this path; "
        "'' = in-memory",
    )


def _add_backend_flags(p: argparse.ArgumentParser) -> None:
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
        help="needle map kind (ref NeedleMapKind, weed/storage/needle_map.go:14)",
    )
    p.add_argument(
        "-whiteList",
        default="",
        help="comma-separated IPs/CIDRs allowed to write (ref guard.go); "
        "empty = everyone",
    )
    p.add_argument("-dir", default="./data", help="comma-separated data dirs")
    p.add_argument("-max", default="7", help="comma-separated max volume counts")
    p.add_argument("-dataCenter", default="")
    p.add_argument("-rack", default="")


def _add_volume_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8080)
    p.add_argument(
        "-mserver", default="",
        help="comma-separated master addresses; '' = no master (the "
        "server's volumes load from its directories)",
    )
    p.add_argument("-publicUrl", default="")
    p.add_argument(
        "-pulseSeconds", type=float, default=1.0,
        help="seconds between heartbeats to the master",
    )
    p.add_argument(
        "-jwtSigningKey",
        default="",
        help="HS256 key gating uploads and deletes (ref security/jwt.go)",
    )
    _add_backend_flags(p)


def _build_volume_server(args, master, port: int, public_url: str = ""):
    from ..server.volume import VolumeServer

    dirs = args.dir.split(",")
    maxes = [int(m) for m in args.max.split(",")]
    if len(maxes) == 1:
        maxes = maxes * len(dirs)
    return VolumeServer(
        directories=dirs,
        host=args.ip,
        port=port,
        max_volume_counts=maxes,
        needle_map_kind=args.index,
        codec_backend=args.storageBackend,
        jwt_signing_key=args.jwtSigningKey,
        white_list=tuple(x for x in args.whiteList.split(",") if x),
        batch_lookup=args.batchLookup,
        master=master,
        public_url=public_url,
        pulse_seconds=args.pulseSeconds,
        data_center=args.dataCenter,
        rack=args.rack,
    )


def _build_master_server(args):
    from ..server.master import MasterServer

    return MasterServer(
        host=args.ip,
        port=args.port,
        volume_size_limit_mb=args.volumeSizeLimitMB,
        default_replication=args.defaultReplication,
        garbage_threshold=args.garbageThreshold,
        peers=[x for x in args.peers.split(",") if x] or None,
        jwt_signing_key=args.jwtSigningKey,
        sequencer_file=args.sequencerFile,
        raft_state_file=args.raftStateFile,
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


def cmd_master(argv: list[str], started=None) -> int:
    p = argparse.ArgumentParser(prog="seaweedfs_tpu_torch master")
    _add_master_flags(p)
    args = p.parse_args(argv)
    ms = _build_master_server(args)
    print(f"master listening on {args.ip}:{args.port}", flush=True)
    asyncio.run(_run_forever(ms, started=started))
    return 0


def cmd_volume(argv: list[str], started=None) -> int:
    p = argparse.ArgumentParser(prog="seaweedfs_tpu_torch volume")
    _add_volume_flags(p)
    args = p.parse_args(argv)
    vs = _build_volume_server(
        args, [x for x in args.mserver.split(",") if x], args.port,
        args.publicUrl,
    )
    print(f"volume server listening on {args.ip}:{args.port} "
          f"(device {vs.device})", flush=True)
    asyncio.run(_run_forever(vs, started=started))
    return 0


def cmd_server(argv: list[str], started=None) -> int:
    """A master and a volume server in one process, on one event loop
    (ref command/server.go); the volume server heartbeats to the master
    (or to every -peers master)."""
    p = argparse.ArgumentParser(prog="seaweedfs_tpu_torch server")
    _add_master_flags(p)
    p.add_argument("-volumePort", type=int, default=8080)
    p.add_argument(
        "-pulseSeconds", type=float, default=1.0,
        help="seconds between the volume server's heartbeats",
    )
    p.add_argument("-filer", action="store_true", help="also run a filer")
    p.add_argument("-filerPort", type=int, default=8888)
    _add_backend_flags(p)
    args = p.parse_args(argv)
    peers = [x for x in args.peers.split(",") if x]
    ms = _build_master_server(args)
    vs = _build_volume_server(args, peers or f"{args.ip}:{args.port}",
                              args.volumePort)
    servers = [ms, vs]
    desc = (f"server: master on {args.ip}:{args.port}, volume on "
            f"{args.ip}:{args.volumePort} (device {vs.device})")
    if args.filer:
        from ..server.filer import FilerServer

        # one arena in the process: the filer's meta gate takes the volume
        # server's (its byte budget and residency plane) when it has one
        servers.append(FilerServer(
            master=f"{args.ip}:{args.port}",
            host=args.ip,
            port=args.filerPort,
            jwt_signing_key=args.jwtSigningKey,
            arena=vs.lookup_arena,
        ))
        desc += f", filer on {args.ip}:{args.filerPort}"
    print(desc, flush=True)
    asyncio.run(_run_forever(*servers, started=started))
    return 0


def cmd_filer(argv: list[str], started=None) -> int:
    """A filer over a master and its volume servers (ref
    command/filer.go)."""
    p = argparse.ArgumentParser(prog="seaweedfs_tpu_torch filer")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-port", type=int, default=8888)
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument(
        "-store",
        default="",
        help="metadata store: '' = memory, *.flog = append-log, "
        "*.lsm = LSM segments+WAL, anything else = sqlite",
    )
    p.add_argument("-maxMB", type=int, default=4, help="chunk size in MB")
    p.add_argument(
        "-shards",
        type=int,
        default=0,
        help="partition the store into N directory-prefix shards "
        "(crash-safe shard map + heat-driven rebalance; -store then "
        "names a directory — sqlite sub-stores, or LSM when it ends "
        "in .lsm)",
    )
    p.add_argument(
        "-metaLog",
        default="",
        help="directory for the durable segmented meta-log change "
        "feed (resumable per-subscriber cursors); '' = in-memory ring",
    )
    p.add_argument("-collection", default="")
    p.add_argument("-replication", default="")
    p.add_argument("-jwtSigningKey", default="")
    p.add_argument(
        "-peers",
        default="",
        help="comma-separated peer filers (host:port) whose metadata "
        "streams this filer follows and aggregates (ref -peers, "
        "weed/filer2/meta_aggregator.go)",
    )
    p.add_argument(
        "-dataCenter",
        default="",
        help="this filer's data center label: reads prefer same-DC "
        "replicas",
    )
    p.add_argument(
        "-fleetMap",
        default="",
        help="shared FLEETMAP file of a shard-range filer fleet: this "
        "filer serves the directory-prefix range the map assigns it and "
        "forwards/redirects everything else to the owning member",
    )
    p.add_argument(
        "-fleetSelf",
        default="",
        help="this member's address as listed in -fleetMap "
        "(default: <-ip>:<-port>)",
    )
    p.add_argument(
        "-followSource",
        default="",
        help="PRIMARY filer (host:port) to follow as a read-only "
        "meta-log-fed replica: serves eventually-consistent GET/LIST "
        "with a disclosed staleness bound, redirects writes",
    )
    args = p.parse_args(argv)
    from ..server.filer import FilerServer

    fs = FilerServer(
        master=args.master,
        host=args.ip,
        port=args.port,
        store_path=args.store,
        chunk_size=args.maxMB * 1024 * 1024,
        collection=args.collection,
        replication=args.replication,
        jwt_signing_key=args.jwtSigningKey,
        peers=tuple(
            x.strip() for x in args.peers.split(",") if x.strip()
        ),
        shards=args.shards,
        meta_log_path=args.metaLog,
        data_center=args.dataCenter,
        fleet_map_path=args.fleetMap,
        fleet_self=args.fleetSelf,
        follow_source=args.followSource,
    )
    print(f"filer listening on {args.ip}:{args.port} (store "
          f"{args.store or 'memory'}, meta gate {fs.meta_gate_mode})",
          flush=True)
    asyncio.run(_run_forever(fs, started=started))
    return 0


def cmd_shell(argv: list[str]) -> int:
    p = argparse.ArgumentParser(prog="seaweedfs_tpu_torch shell")
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("commands", nargs="*",
                   help="semicolon-separated one-shot commands")
    args = p.parse_args(argv)

    from ..shell import CommandEnv, run_command

    async def repl() -> None:
        env = CommandEnv(args.master)
        try:
            if args.commands:
                for line in " ".join(args.commands).split(";"):
                    out = await run_command(env, line)
                    if out:
                        print(out, flush=True)
                return
            print("seaweedfs-tpu shell; `help` lists commands, ctrl-d exits")
            loop = asyncio.get_running_loop()
            while True:
                try:
                    line = await loop.run_in_executor(None, input, "> ")
                except EOFError:
                    break
                try:
                    out = await run_command(env, line)
                except Exception as e:
                    # one failing command must not end the prompt
                    out = f"error: {e}"
                if out:
                    print(out)
        finally:
            await env.release_lock()

    asyncio.run(repl())
    return 0


def cmd_benchmark(argv: list[str]) -> int:
    p = argparse.ArgumentParser(prog="seaweedfs_tpu_torch benchmark")
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-n", type=int, default=1024 * 1024)
    p.add_argument("-size", type=int, default=1024)
    p.add_argument("-c", type=int, default=16)
    p.add_argument("-collection", default="")
    p.add_argument("-skipRead", action="store_true")
    p.add_argument(
        "-assignBatch", type=int, default=1,
        help="lease file ids in count=N assign batches (amortizes the "
        "per-write master round-trip; keep 1 against JWT-secured "
        "clusters — upload tokens cover the base fid only)",
    )
    args = p.parse_args(argv)
    from .benchmark import run_benchmark

    out = asyncio.run(
        run_benchmark(
            args.master,
            num_files=args.n,
            file_size=args.size,
            concurrency=args.c,
            collection=args.collection,
            do_read=not args.skipRead,
            assign_batch=args.assignBatch,
        )
    )
    print(out, flush=True)
    return 0


def cmd_upload(argv: list[str]) -> int:
    p = argparse.ArgumentParser(prog="seaweedfs_tpu_torch upload")
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-collection", default="")
    p.add_argument("-replication", default="")
    p.add_argument("-ttl", default="")
    p.add_argument(
        "-maxMB",
        type=int,
        default=0,
        help="split larger files into chunks + manifest (0 = never split)",
    )
    p.add_argument("files", nargs="+")
    args = p.parse_args(argv)

    from ..client.operation import submit_file
    from ..util.fasthttp import FastHTTPClient

    async def go() -> None:
        http = FastHTTPClient()
        try:
            for path in args.files:
                with open(path, "rb") as f:
                    data = f.read()
                fid, result = await submit_file(
                    http,
                    args.master,
                    data,
                    filename=os.path.basename(path),
                    collection=args.collection,
                    replication=args.replication,
                    ttl=args.ttl,
                    chunk_size=args.maxMB * 1024 * 1024,
                )
                print(f"{path} -> fid {fid} ({result.get('size')} bytes)",
                      flush=True)
        finally:
            await http.close()

    asyncio.run(go())
    return 0


def cmd_download(argv: list[str]) -> int:
    p = argparse.ArgumentParser(prog="seaweedfs_tpu_torch download")
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-dir", default=".")
    p.add_argument("fids", nargs="+")
    args = p.parse_args(argv)

    from ..client.operation import lookup, read_url
    from ..util.fasthttp import FastHTTPClient

    async def go() -> None:
        http = FastHTTPClient()
        try:
            for fid in args.fids:
                vid = int(fid.split(",")[0])
                locs = await lookup(args.master, vid)
                if not locs:
                    print(f"{fid}: volume not found", file=sys.stderr)
                    continue
                data = await read_url(http, f"http://{locs[0]}/{fid}")
                out = os.path.join(args.dir, fid.replace(",", "_"))
                with open(out, "wb") as f:
                    f.write(data)
                print(f"{fid} -> {out} ({len(data)} bytes)", flush=True)
        finally:
            await http.close()

    asyncio.run(go())
    return 0


def cmd_compact(argv: list[str]) -> int:
    """Offline vacuum (ref command/compact.go): compact2 then commit, on
    the host (the volume's snapshot device is never touched)."""
    p = argparse.ArgumentParser(prog="seaweedfs_tpu_torch compact")
    p.add_argument("-dir", required=True)
    p.add_argument("-volumeId", type=int, required=True)
    p.add_argument("-collection", default="")
    args = p.parse_args(argv)

    from ..storage.vacuum import commit_compact, compact2
    from ..storage.volume import Volume

    v = Volume(args.dir, args.collection, args.volumeId, create=False)
    compact2(v)
    v2 = commit_compact(v)
    print(f"compacted volume {args.volumeId}: {v2.data_file_size()} bytes")
    v2.close()
    return 0


COMMANDS = {
    "master": cmd_master,
    "volume": cmd_volume,
    "server": cmd_server,
    "filer": cmd_filer,
    "shell": cmd_shell,
    "benchmark": cmd_benchmark,
    "upload": cmd_upload,
    "download": cmd_download,
    "compact": cmd_compact,
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
