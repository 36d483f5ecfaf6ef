#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (seaweedfs_tpu_torch) on one GPU.

Drives the port's paths through the entry points a volume server
calls, at full width, then through the port's volume server, its cluster,
its mesh plane, the volume tier under the filer, the filer and its
scale-out, and the self-healing plane (scrub and repair), and holds
each CUDA kernel against its plain PyTorch version: warm-storage erasure coding
(gf_matmul, and gf_verify for the mesh's parity check) and the
needle-index lookup (index_search, ragged_lookup, and the mesh lookup's
index_buckets and bucket_search):

  0  identity: nvidia-smi name and power limit, torch and CUDA versions
  1  build the kernels from the checkout's four sources (one nvcc each,
     all at once; sm_90a), with ptxas's registers and spills for gf256.cu
     and ragged_lookup.cu,
     and beside them host_crc32c.cu (host code only: the needle CRC32C
     where google-crc32c is missing), held to the Python table CRC on
     0 B to 1 MiB and timed on a 1 KiB needle
  2  gf_matmul and gf_verify against plain on the card, at the main path's
     shapes, widths of 1 to 33 words and views the 16-byte route cannot
     take; gf_matmul's median time beside the plain version's, B3's
     bit-sliced torch form (its library yardstick) and the card's bound,
     the bytes it must move (the xtime chain's operation ceiling beside it)
  3  encode: write an 11 GiB version-3 volume (superblock, needles, .idx),
     then write_ec_files on the card, write_sorted_file_from_idx and .vif;
     the .dat's first find_dat_file_size bytes hashed for the decode
  4  rebuild: delete shards 0, 7, 10, 13 and rebuild them on the card;
     the 14 shard files must hash as before
  5  parity at the first chunk, the large-to-small block boundary and the
     ragged last small row, recomputed by the plain version on the card
  6  degraded read: delete shards 1, 5, 11, 12 and read >= 1000 seeded
     needles plus every needle straddling a block boundary through
     EcVolume.read_needle; payloads and checksums must be the written ones;
     then EcVolume.bulk_locate of every needle plus 10 % absent ids, equal
     to find_needle_from_ecx entry by entry
 6b  mesh rebuild and decode (the phase-3 volume, still on disk):
     rebuild_ec_files_multi on a 1x1 mesh of cuda:0 brings back phase 6's
     lost shards, then on a 2x2 grid of cuda:0 (one card in four blocks,
     one stream each) shards 0, 7, 10, 13 removed again; every shard
     hashes as phase 4's; then the decode in place of the original .dat:
     find_dat_file_size, write_dat_file (10 large blocks of 1 GiB, then
     small ones), write_idx_file_from_ec_index; the .dat hashes as the
     original's prefix and the .idx equals the .ecx
 17a scrub at scale (here, after the last phase that reads the shards):
     storage/scrub.py::scrub_ec_volume with CudaRSCodec over the 14
     shards, one gf256_matmul launch a 1 MiB chunk at least: a clean pass
     (bytes, wall, GB/s, launches, the encode round trips' share), then a
     seeded byte flipped in a parity shard and one in a data shard in
     another chunk: the second pass must name exactly those two shards
     (unidentified false); the bytes are put back
  7  volume_lookup (`weed benchmark` scale): 1,048,576 needles of 1 KiB
     through Volume, 1 % deleted and 1 % overwritten, reloaded; bulk_lookup
     of every key plus 10 % absent in batches of 64 .. all, equal to the
     host map; 1,000 located needles read back
  8  index_kernel (one full volume's index, 29,565,112 entries): 10,000,000
     probes through index_search against its plain version and
     torch.searchsorted, with times and the bound; edge-case tables too
  9  arena_gate: 4 LSM maps of 262,144 entries (5 runs + a memtable tail
     each; cut from 1,048,576, the line says why) resident in the arena; >= 200,000 probes through
     BatchLookupGate at concurrency 256 with the identity check; then
     ragged_lookup (K2) against its plain version and against the plane
     kernel it replaced (on contiguous copies of the columns,
     folded newest-wins on the host) at the gate's median batch and at
     65,536 probes, both kernels' device ms from the profiler beside both
     forms' bytes bounds
 10  volume_server (`weed benchmark` scale): volume 1 (LSM map, 1,048,576
     needles of 1 KiB, 1 % deleted, 1 % overwritten) written (by a child
     of this script, `--prep volume1`, while phases 7-9 run), then the
     server started through the CLI's entry function (`volume -index lsm
     -batchLookup arena -storageBackend cuda`) on its own event-loop
     thread; a load client in a child process (this script with
     --client): AllocateVolume, 32,768 POSTs at concurrency 16, 10,000
     warm-up GETs at concurrency 512 through which the server uploads its
     own arena (its host fallbacks reported; any after the warm-up fail),
     50,000 GETs at concurrency 256 over both volumes (10 % absent, 1 %
     wrong cookie) with the gate's identity check on (as in the warm-up),
     then off; BulkLookup of
     every key of volume 1 plus 10 % absent against the host map; EC
     generate through the server held byte for byte to an encode with
     the kernel's plain version on the card; 2,000 degraded GETs with
     shards 0, 3, 10, 13 gone; rebuild; stop within 10 s. All three
     kernels must launch through the server.
 11  cluster (`weed benchmark` scale): phase 10's volume 1 as volume A in
     the first directory of `server -index lsm -batchLookup arena
     -storageBackend cuda -volumeSizeLimitMB 1024` (A, 1,127 MB, is full)
     beside three `volume -mserver ... -storageBackend cuda`, each through
     the CLI's entry function on its own event-loop thread; 10,000
     warm-up GETs of A at concurrency 512 through which the `server`
     uploads its own arena, then 25,000 GETs of A at concurrency 256 with
     the gate's identity check on (ragged_lookup must launch); from the
     warm-up's end on, any host fallback, identity mismatch or device
     error on the `server`'s gate fails; `benchmark -n 16384 -c 16` (cut
     from -n 1048576 for time) and `shell` as child processes: benchmark
     writes and reads (every body checked), 5,000 /dir/assign, `ec.encode
     -volumeId A` (generate and spread timed by the shell) spread 4/4/3/3
     with every shard and .ecx equal to the plain version's encode,
     BulkLookup of A's ids
     on its .ecx, `ec.encode` of two benchmark volumes of one server
     through VolumeEcShardsGenerateBatch (equal to the plain version's),
     2,000 GETs of A over all four servers (remote shards, 10 % absent),
     then a 4-shard server stopped and 1,000 degraded GETs through the
     other three (each must decode on the card), `ec.rebuild` (the lost
     shards come back identical), 100 EC deletes answering 404 from every
     live server, and every server stopped within 10 s. The servers sit
     on racks r0, r1, r2, r3; the stopped server holds shards of A and of
     the batched pair, so `ec.rebuild` sends ONE
     VolumeEcShardsRebuildBatch for the three volumes (its gf_matmul
     launches reported beside the per-volume rounds; 0 retries), rebuilt
     shards equal to the lost ones and to the plain version's; then
     `ec.balance` evens A over the three live racks (at most 5 a rack;
     every shard still
     the plain version's) and `ec.decode -volumeId A` makes A a normal
     volume on one server: no shard left on a live server, no EC
     location at the master, the .dat equal to A's pre-encode .dat up to
     its size, 2,000 GETs through the normal read path equal to what was
     written and the 100 needles deleted while A was EC answering 404.
 12  mesh (at full width): 5 volumes of 10 x 16 MiB (an uneven V) on a
     1x1 mesh of cuda:0 and on a 2x2 grid of cuda:0 repeated (one card
     split into four blocks, not four cards): sharded_encode,
     sharded_verify (0, then the word count after seeded flips, through
     the gf_verify kernel), sharded_reconstruct_step for the loss of
     shards 2 and 12, sharded_reconstruct_padded at a ragged width,
     sharded_bulk_lookup of phase 8's index with 10,000,003 probes (equal
     to the single-device index_search answer) and of phase 8's edge
     tables, entry.entry() and entry.dryrun(); each against the plain
     version, and every kernel's launches on the path checked exactly
     (index_buckets once a bucketable table and mesh, bucket_search once
     a bucketable table and place, index_search once an unbucketable
     table and place); gf_verify's time beside its plain version's, B3's
     torch form with a compare and a sum, and its bytes bound;
     index_buckets and bucket_search against their plain versions on the
     card and K1's whole-table search on phase 8's table, every
     edge table, a run of duplicates, a skewed table and a 2,200,000-row
     table of sequential keys, then timed (A a replica and on the
     sequential keys; B on each mesh, with and without the persisting-L2
     window; K1 over B's table, and the unbucketed K1 route B replaces;
     torch.searchsorted and its gathers), with nb, the card's persisting
     L2 size, the bounds and the probes B bisects after its first group.
 13  vacuum (`weed benchmark` scale, the master's default -garbageThreshold
     0.3): phase 7's volume (kept through hard links) with a seeded 35 %
     of its needles deleted (garbage level >= 0.3; by a child of this
     script, `--prep deletes`, while phases 10-12 run). 13a: compact2 and
     commit on clones of it: the memory map on each copy route (pread,
     mmap) and through `python -m seaweedfs_tpu_torch compact`, lsm and
     leveldb (the first clone of the whole volume, the others of a prefix
     of it: its first eighth of .idx rows with their later tombstones); each new .dat and .idx held to the script's own plain
     reference (the old .idx folded with numpy, the live records read at
     their old offsets: the super block with revision + 1, then the
     padded live records in offset order; the .idx in key order);
     bulk_lookup of every key plus 10 % absent before the commit, and
     after it in batches of 64 .. all on every kind and on a read-only
     sorted load, equal to the reference, and to the host map (every
     probe on the memory map, the first 4,096 on the others); 65,536
     probes through index_search against its plain version on the card.
     13b: `server -index lsm -batchLookup arena -storageBackend cuda
     -garbageThreshold 0.3` on a copy of the volume taken before the last
     40,000 deletes (the cut is in the line), 10,000 warm-up GETs at
     concurrency 512, those deletes through BatchDelete RPCs of 10,000
     fids, then `shell "lock; volume.vacuum
     -garbageThreshold 0.3; unlock"` while a child client keeps GETs at
     concurrency 256 running over live, deleted and absent keys (0 wrong
     bodies, 0 5xx); after the commit a re-warm and 25,000 GETs with the
     identity check on (ragged_lookup must launch in them; no host
     fallback, mismatch or device error after the re-warm), BulkLookup
     equal to the reference and the
     host map, a second /vol/vacuum with no candidate, stop within 10 s.
 14  volume tier (the paths under the filer): (a) `volume -index lsm
     -batchLookup arena -storageBackend cuda` (phase 10's server) takes
     `weed benchmark -size 1024` needles as /!batch/put frames of 64 (the
     filer's ChunkUploadGate) at concurrency 16 through its group-commit
     worker, every reply item checked (fsyncs, mean and largest batch);
     (b) the BatchRead stream of a seeded half of the keys and of 10 %
     absent ones in requests of 65,536 keys, every body held to what was
     written and every absent key to None; index_search must launch at
     least once a request
     (launches and device ms from the profiler); (c) `server
     -defaultReplication 001` over (a)'s directory and a `volume
     -mserver`, both `-index lsm -batchLookup arena`: run_benchmark with -assignBatch 128 and the replica read
     fan-out, a read-only pass at c=256, 16,384 GETs of (a)'s volume at
     c=512 through the fan-out and the `server`'s gate (ragged_lookup must
     launch: the benchmark's small volumes stay in the LSM memtable, which
     the arena does not hold), then reads through the fan-out while the
     `volume` server stops (0 failed or wrong reads; failovers and
     breaker opens reported); (d) `upload -maxMB 4 -replication 000` of
     a 256 MiB file (64 chunks on both servers and a manifest),
     `download` of it whole and three ranges across chunk boundaries
     (one across the two servers), byte-identical, then its delete:
     every chunk answers 404. Children of this script (`--tier-client
     MODE`) are the load clients. The counts of (a) and (c) are cut from
     `weed benchmark -n 1048576`, and the line says why.
 15  the filer on the card: `filer -store <work>/filer.lsm -metaLog
     <work>/mlog -replication 000` through the CLI's entry function on its
     own event-loop thread (its meta gate at the default, `device`: K2 on
     the process's arena, the identity check on), over `server -index lsm
     -batchLookup arena` in a child process started once phase 14 has
     ended (its own interpreter, so the filer keeps this one);
     `weed benchmark -size 1024` bodies as files /bench/d<i // 1024>/f<i>
     (one 4 MiB chunk each). (b) PUTs at c=64 (chunks through the
     ChunkUploadGate and /!batch/put, creates through MetaWriteGate, their
     spines through the meta gate), 1 % of them again (the old chunks are
     freed), a multipart POST and a 2-chunk file; (c) 4,096 warm-up GETs,
     then every file plus 10 % absent paths at c=256, each body held to
     what was written and each absent path to 404 (K2 must launch; from the
     warm-up's end no host fallback, identity mismatch, arena or device
     error; memtable hits are counted apart); (d) every directory listed
     through the directory JSON and ListEntries, paged, against the
     script's record, then AtomicRenameEntry of a directory and GETs of its
     files under the new path; (e) DELETE of 1 % of the files and of one
     directory recursively: the paths answer 404, and once the GC loop has
     drained every freed chunk (overwritten ones too) answers 404 at the
     volume; (f) the filer stopped within 10 s and started again on the
     same store and meta-log (a copy of the store taken while it served
     replays its WAL), 10,000 GETs equal to the record after a warm-up (K2
     must launch), SubscribeMetadata from 0 with one event per create,
     update, rename and delete above; (g) ragged_lookup against its plain
     version and the plane kernel it replaced, as in phase 9, on the
     filer's own generation at the meta gate's largest flush and at 65,536
     probes (hits, misses, paths deleted in the memtable), device ms from
     the profiler beside the bytes bounds (the phase fails if the profiler
     records none; these launches are not the path's and are not counted),
     and a flush's stage walls through probe_groups at both sizes; then 4,096 GETs under the profiler (K2's device ms a
     launch, the card's busy share; their launches are counted). Children of this script
     (`--filer-client MODE`) are the load clients; the file count is cut
     from 1,048,576, and the line says why. Its `server` child stays up for
     phase 16.
 16  the filer's scale-out on the card (bench.py's meta fleet leg at its
     largest fleet): four `filer -fleetMap FLEETMAP -fleetSelf ADDR -store
     <work>/fleet<i>.lsm -metaLog ...` children (each meta gate at the
     default, `device`: K2 in each child's own process, the identity check
     on), a follower (`-followSource` member 0), two `-peers` filers and a
     `-shards 4` filer, their master phase 15's `server`. (b) 65,536
     entries of 64 directories created at c=64 by children of this script
     (`--fleet-client`), 10 % through a member that does not own them,
     whose `forwarded` counters must match; the sharded filer's 16,384
     creates and the peers' beside them; (c) after a warm-up, lookups
     through the port's meta_fleet_driver children (4 at c=24) at each
     member alone and at the fleet together (10 % absent), and LISTs of
     every directory: every answer checked, 0 forwards, K2 device batches
     and launches on every member, 0 host fallbacks, identity mismatches
     or device errors; every entry read back by ListEntries at its owner,
     in key order with its etag; (d) FleetMoveRange of the upper half of
     member 0's range to member 1 while a client creates and reads paths
     in it through both: the new epoch, every entry written before and
     during the move listed with its etag through both members, lookups
     through both (the source forwards them; the destination answers on
     K2), the source's own store empty of the range; (e) the follower at
     member 0's head: every path of member 0 looked up through both, the
     answers equal, a read past its cursor redirected, a write refused
     `read_only_follower`, its staleness bound; (f) a peer's creates in
     the other's SubscribeMetadata and store; a rebalance of the sharded
     filer while writes go on, every entry listed in key order with its
     etag, its gate's flushes all host lookups (`no_arena_view`); (g)
     `shell meta.fleet.status` of member 0. The lookup passes are seeded
     samples, and the line says why; the card's memory with the children
     up and each child's K2 launches are in the line.
 17b self-healing in a cluster (tests/test_scrub_repair.py's end-to-end
     test at scale): `server` and three `volume -mserver`, all
     `-storageBackend cuda -pulseSeconds 0.5`, on event-loop threads of
     this script, the master's background loop off and its repair grace
     2 s; two volumes of 1,091 MB of .dat each, written by `--prep heal`
     while phase 16 runs: a replicated (001) one on two volume servers,
     whose next needle a FaultPlan (util/faults.py) bitflips on one
     holder's .dat only, and an EC one generated on the card, 12 shards
     on the `server` and shards 12, 13 on a volume server holding no
     replica. Driven by the shell's `volume.scrub` and
     `ec.repair.status -run`: (1) the scrub finds the needle, the holder
     quarantines the volume and the scheduler re-copies it
     (VolumeRepairCopy); (2) a seeded data-shard byte flipped, the scrub
     names the shard and moves it to .ecNN.bad, the scheduler rebuilds
     it (VolumeEcShardsRebuildBatch, B1) and drops the survivors it
     pulled; (3) the shard holder stops and its shards are rebuilt on the
     `server`. Two read clients (children, c=32 each, at most 20,000
     GETs in all, paced over 24 s) read both volumes across the repairs:
     0 wrong bodies, failed reads counted, the rate and whether the pass
     lasted through every repair reported. Then every dispatch
     error-free, the queue at 0, a second `volume.scrub` clean, every
     needle of both volumes byte-identical, every shard's sha1 as before
     the damage; detection-to-repair walls, the rebuild rounds' walls and
     launches, B1's launches in each window.

Each phase prints one JSON line; any mismatch or exception exits non-zero
without the final line. The line before last but one is the kernels
summary, then the nvidia-smi identity line, and the last line is
{"ok": true, "device": {...}}. Without CUDA (or without the package beside
this script) it exits non-zero and prints no result.

The kernels line gives each kernel's launches on the main path (counts
set to 0 just before a path runs and read just after; comparison launches
are not counted), its largest difference from the plain version, its
median time, the plain version's, the card's bound and what bounds it, and
the time of a PyTorch call (or, for gf_matmul and gf_verify, B3's
composition of torch calls) computing the same function where one exists.

    python3 chip_smoke.py [--volume-gib 11] [--seed 0] [--workdir DIR]

`--gate-cut-ab ROUNDS` measures the lookup gate's arena cut instead (the
smallest wakeup it sends to ragged_lookup): phases 0-1, phase 10's server
and warm-up, then ROUNDS passes of 25,000 GETs with the cut at 128 and 64
in turns (128, 64, 64, 128, ...), reads/s, p50, p99 and the arena's share
of batches per pass and their medians per cut; it prints no result line.
The whole run's "done" line gives each phase's wall.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
GIB = 1 << 30
MIB = 1 << 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT8_OPS_PER_S = 1.979e15  # H100 SXM data sheet, dense int8 tensor-core peak
INT32_LANES_PER_SM = 64  # INT32 lanes per SM per clock (Hopper)
KERNELS = ("gf256", "index_search", "ragged_lookup", "bucket_search")  # csrc/<name>.cu
# csrc/host_crc32c.cu: no device code, the needle CRC32C of every server
# write and read on a host without google-crc32c (util/crc.py)
HOST_CRC = "host_crc32c"
REBUILD_LOST = (0, 7, 10, 13)
DEGRADED_LOST = (1, 5, 11, 12)
SAMPLED_READS = 1000  # seeded needles read with DEGRADED_LOST gone


T_START = time.perf_counter()


def emit(obj: dict) -> None:
    """One JSON line; a phase's line also says when it ended (`at_s`, the
    seconds since this script started)."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check_host_crc(crc_mod, seed: int) -> dict:
    """util/crc.py's route; where it is the host library, its CRC32C held
    to the Python table forms on seeded inputs of 0 B to 1 MiB at odd
    offsets, and both timed on one 1 KiB needle."""
    import numpy as np

    route = crc_mod.route()
    res: dict = {"route": route}
    if route == "python":
        fail("util/crc.py fell back to the Python CRC32C: the host library "
             f"{HOST_CRC} did not load")
    if route != "native":
        return res
    rng = np.random.default_rng(seed + 1)
    buf = rng.bytes((1 << 20) + 8)
    sizes = [0, 1, 7, 8, 9, 1023, 1024, 1025, 16383, 16384, 70001, 1 << 20]
    for n in sizes:
        for off in (0, 3):
            init = int(rng.integers(0, 1 << 32))
            d = buf[off:off + n]
            want = crc_mod._crc32c_python(d, init)
            if (crc_mod.crc32c(d, init), crc_mod.crc32c(memoryview(d), init)) != (want, want):
                fail(f"host CRC32C differs from the table loop at {n} bytes, offset {off}")
    one = buf[:1024]
    t0 = time.perf_counter()
    for _ in range(2000):
        crc_mod.crc32c(one)
    t1 = time.perf_counter()
    for _ in range(200):
        crc_mod._crc32c_loop(one)
    t2 = time.perf_counter()
    res.update(sizes_checked=sizes, equal_to_table_loop=True,
               us_per_1KiB=(t1 - t0) / 2000 * 1e6, python_us_per_1KiB=(t2 - t1) / 200 * 1e6)
    return res


def nvidia_smi(query: str) -> str:
    proc = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        fail(f"nvidia-smi exited {proc.returncode}: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def sha1_files(paths: list) -> dict:
    import concurrent.futures as cf

    def one(path: str) -> str:
        h = hashlib.sha1()
        with open(path, "rb") as f:
            while True:
                b = f.read(16 * MIB)
                if not b:
                    return h.hexdigest()
                h.update(b)

    with cf.ThreadPoolExecutor(8) as pool:
        return dict(zip(paths, pool.map(one, paths)))


# --- phase 1 -----------------------------------------------------------------
def ptxas_report(log: str) -> dict:
    """Per kernel of an `nvcc -Xptxas -v` log: registers, spill stores and
    loads (bytes) and shared memory, keyed by the kernel's name with its
    template arguments (gf_matmul_kernel<R,VEC>)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"(gf_\w+_kernel)ILi(\d+)ELb([01])E", m.group(1))
            name = f"{k.group(1)}<{k.group(2)},{k.group(3)}>" if k else m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers(?:, (\d+) bytes smem)?", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            out[name]["smem_bytes"] = int(m.group(2) or 0)
    return out


# --- phase 2 -----------------------------------------------------------------
def gf_bounds(G, m, n_bytes: int, moved_bytes: int, sm_clock_hz: float, props) -> dict:
    """The least time the card could take for the GF(2^8) product of
    matrix m over n_bytes byte positions, whatever computes it: the larger
    of the bytes the function must move over 3.35 TB/s and its operations
    as a GF(2) matrix product (2 * N * 8C * 8R int8 operations) over 1,979
    TOP/s. Beside it the xtime chain's i32 operations over the INT32 lanes,
    the ceiling of the kernel the bit-plane design replaced."""
    r_cnt, c_cnt = m.shape
    gf2_ops = 2 * n_bytes * 8 * c_cnt * 8 * r_cnt
    bytes_ms = moved_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = gf2_ops / INT8_OPS_PER_S * 1e3
    xtime_ops = G.count_expr_ops(m, "mul") * (n_bytes // 4)
    int_rate = props.multi_processor_count * INT32_LANES_PER_SM * sm_clock_hz
    return {
        "bytes": moved_bytes, "bytes_bound_ms": bytes_ms,
        "gf2_int8_ops": gf2_ops, "ops_bound_ms": ops_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
        "xtime_int32_ops": xtime_ops,
        "xtime_ops_bound_ms": xtime_ops / int_rate * 1e3,
    }


def verify_against_plain(torch, G, m, x, store, gen, what: str) -> None:
    """gf_verify's count on data x against its plain version's, the stored
    parity the plain product with seeded flipped words (copied into
    `store`, a view, where given)."""
    par = G._gf_matmul_torch_packed(m, x)
    flat = par.view(-1)
    flat[torch.randint(0, flat.numel(), (3,), device="cuda", generator=gen)] ^= 0x01000010
    if store is not None:
        par = store.copy_(par)
    got, want = int(G._gf_verify_cuda(m, x, par)), int(G._gf_verify_torch(m, x, par))
    if got != want or want == 0:
        fail(f"gf_verify != plain on {what}: {got} words, plain {want}")


def kernel_against_plain(torch, G, galois, seed: int, sm_clock_hz: float) -> dict:
    import numpy as np

    rng = np.random.default_rng(seed)
    full = galois.build_matrix(10, 14)
    matrices = {
        "10.4": full[10:],
        "6.3": galois.build_matrix(6, 9)[6:],
        "12.4": galois.build_matrix(12, 16)[12:],
        # 2 data + 2 parity lost, decoded from the first 10 survivors
        "decode4": galois.compose_decode_rows(
            full, [2, 3, 4, 5, 6, 7, 8, 9, 10, 12], [0, 1, 11, 13]
        ),
        "rand7x11": rng.integers(0, 256, (7, 11), dtype=np.uint8),
    }
    chunk_words = 16 * MIB // 4  # the main path's 16 MiB chunk per shard
    widths = (1, 3, 7, 33, 4097, (1 << 20) + 3, chunk_words)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def words(rows, w):
        return torch.randint(-(1 << 31), 1 << 31, (rows, w), dtype=torch.int32,
                             device="cuda", generator=gen)

    def err_of(got, want) -> int:
        diff = (got.contiguous().view(torch.uint8).to(torch.int16)
                - want.contiguous().view(torch.uint8).to(torch.int16))
        return int(diff.abs().max())

    max_err = 0
    checked = 0
    for name, m in matrices.items():
        for w in widths:
            x = words(m.shape[1], w)
            got = G.gf_matmul_packed(m, x)
            want = G._gf_matmul_torch_packed(m, x)
            torch.cuda.synchronize()
            err = err_of(got, want)
            max_err = max(max_err, err)
            checked += 1
            if err != 0:
                fail(f"kernel != plain for {name} at {w} words (max err {err})")
            if w in (7, 33, (1 << 20) + 3):
                verify_against_plain(torch, G, m, x, None, gen, f"{name} at {w} words")
                checked += 1
        # the numpy entry point: host bytes packed, run on the card, unpacked
        data = rng.integers(0, 256, (m.shape[1], 70_001), dtype=np.uint8)
        got = G.gf_matmul_bytes(m, data)
        want = G.gf_matmul_bytes(m, data, device="cpu")
        if not np.array_equal(got, want):
            fail(f"gf_matmul_bytes on the card != plain for {name}")
        checked += 1

    # views the 16-byte route cannot take (the kernel's 4-byte cp.async
    # route): an input and an output 4 bytes past 16-byte alignment, and a
    # pitch of 4,099 words; then a 16-byte aligned view with a pitch of
    # whole pieces, as the EC pipeline passes
    m = matrices["10.4"]
    views = {}
    for w in (7, 33, 4097):
        views[f"input+4B,w{w}"] = (words(10, w + 1)[:, 1:], None)
        views[f"output+4B,w{w}"] = (
            words(10, w), torch.empty((4, w + 1), dtype=torch.int32, device="cuda")[:, 1:])
    views["pitch4099"] = (words(10, 4099)[:, :4097], None)
    views["pitch4100"] = (words(10, 4100)[:, :4097], None)
    for name, (x, out) in views.items():
        got = G._gf_matmul_cuda(m, x, out=out)
        want = G._gf_matmul_torch_packed(m, x)
        torch.cuda.synchronize()
        err = err_of(got, want)
        max_err = max(max_err, err)
        checked += 1
        if err != 0:
            fail(f"kernel != plain on the view {name} (max err {err})")
        # gf_verify on the same view, the stored parity in `out` where given
        verify_against_plain(torch, G, m, x, out, gen, f"the view {name}")
        checked += 1

    # B3's bit-sliced form on the card: the library yardstick, held exact too
    x = words(10, 4097)
    if not torch.equal(G.gf_matmul_bitsliced(m, x), G._gf_matmul_torch_packed(m, x)):
        fail("gf_matmul_bitsliced on the card != plain")

    # time the 10.4 encode at the main path's chunk: per-launch CUDA events
    x = words(10, chunk_words)
    out = torch.empty((4, chunk_words), dtype=torch.int32, device="cuda")
    ms = cuda_median_ms(torch, lambda: G._gf_matmul_cuda(m, x, out=out), 50)
    plain_ms = cuda_median_ms(torch, lambda: G._gf_matmul_torch_packed(m, x), 10)
    library_ms = cuda_median_ms(torch, lambda: G.gf_matmul_bitsliced(m, x), 10)
    props = torch.cuda.get_device_properties(0)
    bound = gf_bounds(G, m, chunk_words * 4, (m.shape[0] + m.shape[1]) * chunk_words * 4,
                      sm_clock_hz, props)
    res = {
        "phase": "kernel_vs_plain",
        "matrices": list(matrices),
        "widths_words": list(widths),
        "views": list(views),
        "compared": checked,
        "equal_to_plain": True,
        "max_abs_err": max_err,
        "tolerance": "exact (byte-equal)",
        "timed": "10.4 encode, [10, 4194304] int32 words (16 MiB per shard)",
        "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "library_call": "gf_matmul_bitsliced: unpack to int8 bits, torch._int_mm by "
                        "_bitslice_matrix, & 1, repack (a composition of torch calls; "
                        "the port's paths never call it)",
        **bound,
        "bound_share": bound["bound_ms"] / ms,
        "achieved_GBps": bound["bytes"] / (ms * 1e-3) / 1e9,
        "data_GBps": 10 * chunk_words * 4 / (ms * 1e-3) / 1e9,
        "int32_ops_per_s_peak": props.multi_processor_count * INT32_LANES_PER_SM * sm_clock_hz,
    }
    emit(res)
    return res


# --- phase 3 -----------------------------------------------------------------
def write_volume(base: str, target_bytes: int, seed: int, needle_mod, idx_mod, sb_mod):
    """A version-3 volume of needles with payloads drawn from a seeded pool
    of blobs (their CRCs computed once): each needle's record is its blob's
    template with the cookie, id and append time patched in."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pool = []
    for _ in range(48):
        size = int(rng.integers(1024, MIB + 1))
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        n = needle_mod.Needle(cookie=0, id=0, data=data)
        record, _, actual = n.to_bytes(3)
        ts_at = 16 + n.size + 4  # header, body, crc, then append_at_ns
        pool.append((record, n.size, n.checksum, ts_at, actual, data))
    needles = {}  # id -> (offset, body size, blob index)
    offset = 0
    with open(base + ".dat", "wb") as dat, open(base + ".idx", "wb") as ix:
        sb = sb_mod.SuperBlock(version=3).to_bytes()
        dat.write(sb)
        offset = len(sb)
        i = 0
        while True:
            b = int(rng.integers(len(pool)))
            record, body, _crc, ts_at, actual, _data = pool[b]
            if offset + actual > target_bytes:
                break
            nid = (i * 2654435761) % (1 << 40) + 1  # distinct, unsorted
            cookie = int(rng.integers(1, 1 << 32))
            mv = memoryview(record)
            dat.write(struct.pack(">IQ", cookie, nid))
            dat.write(mv[12:ts_at])
            dat.write(struct.pack(">Q", 1_700_000_000_000_000_000 + i))
            dat.write(mv[ts_at + 8:])
            ix.write(idx_mod.entry_to_bytes(nid, offset // 8, body))
            needles[nid] = (offset, body, b)
            offset += actual
            i += 1
    return pool, needles, offset


# --- shared --------------------------------------------------------------------
def cuda_median_ms(torch, fn, reps: int, warm: int = 3) -> float:
    """Median CUDA-event time of fn() on the current stream."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


def profile_device(torch, fn, cpu: bool = False) -> dict:
    """Run fn() under torch.profiler (device activity only, or host and
    device with `cpu`) and read the device's busy time: the sum of the self
    device times of every kernel and copy, and per kernel name its launches
    and mean device ms. Keys are None when the profiler records no device
    time; `top` names the events of most device time either way."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = 0.0
    kernels = {}
    top = []
    for ev in prof.key_averages():
        self_us = getattr(ev, "self_device_time_total", None)
        if self_us is None:
            self_us = getattr(ev, "self_cuda_time_total", 0.0)
        busy_us += self_us
        if self_us > 0:
            top.append((self_us, ev.key[:80], ev.count))
        for name in ("index_search_kernel", "ragged_probe_kernel", "ragged_lookup_kernel",
                     "gf_matmul_kernel"):
            if name in ev.key and ev.count:
                k = kernels.setdefault(name, [0, 0.0])
                k[0] += ev.count
                k[1] += self_us / 1e3
    top = [{"name": k, "count": c, "us": us} for us, k, c in sorted(top, reverse=True)[:4]]
    if busy_us <= 0:
        return {"wall_s": wall, "device_busy_s": None, "busy_share": None, "kernels": None,
                "top": top}
    return {
        "wall_s": wall,
        "device_busy_s": busy_us / 1e6,
        "busy_share": busy_us / 1e6 / wall,
        "kernels": {k: {"launches": c, "mean_ms": ms / c} for k, (c, ms) in kernels.items()},
        "top": top,
    }


def kernel_device_ms(torch, fn, name: str, reps: int):
    """Mean device time of one launch of kernel `name` over `reps` calls
    of fn(), from the profiler; None when it records no device time. For
    kernels shorter than their host-side launch, where CUDA events around
    one call measure the launch instead."""
    try:
        prof = profile_device(torch, lambda: [fn() for _ in range(reps)])
    except Exception as e:  # the profiler is optional here, never the result
        print(f"chip_smoke: profiler unavailable: {e}", file=sys.stderr)
        return None
    k = (prof["kernels"] or {}).get(name)
    return k["mean_ms"] if k else None


def _on_worker_stream(torch, fn, reps: int) -> None:
    """reps calls of fn() from a new thread on a stream of its own (as a
    server's executor thread launches), joined."""
    err = []

    def run():
        try:
            s = torch.cuda.Stream()
            with torch.cuda.stream(s):
                for _ in range(reps):
                    fn()
            s.synchronize()
        except BaseException as e:  # raised again on the caller's thread
            err.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join()
    if err:
        raise err[0]


def profiled_kernel_ms(torch, fn, names: tuple, reps: int) -> tuple:
    """Mean device ms of one launch of each kernel in `names`, from the
    profiler, over `reps` calls of fn() (which launches each once):
    launched from this thread, then from a worker thread on its own stream,
    then from this thread with host activity recorded too, until one
    reading names every kernel. -> ({name: ms}, the way that read it, the
    readings that did not); fails when none does, so that no other clock
    stands in for the profiler's. (A short reading can come back empty:
    late in a whole run, 50 launches of ragged_lookup left no record where
    1,000 did.)"""
    ways = (
        ("this thread", lambda: profile_device(torch, lambda: [fn() for _ in range(reps)])),
        ("a worker thread's stream",
         lambda: profile_device(torch, lambda: _on_worker_stream(torch, fn, reps))),
        ("this thread, host activity too",
         lambda: profile_device(torch, lambda: [fn() for _ in range(reps)], cpu=True)),
    )
    missed = []
    for way, read in ways:
        try:
            prof = read()
        except Exception as e:
            missed.append({"way": way, "error": str(e)[:300]})
            continue
        got = prof["kernels"] or {}
        if all(n in got for n in names):
            return {n: got[n]["mean_ms"] for n in names}, way, missed
        missed.append({"way": way, "device_busy_s": prof["device_busy_s"], "top": prof["top"]})
    fail(f"the profiler recorded no {names} launch: {missed}")


def unique_sector_bytes(torch, rows, row_bytes: int) -> int:
    """Bytes of the distinct 32-byte sectors that rows of a column of
    `row_bytes`-wide entries fall in (each read once)."""
    if rows.numel() == 0:
        return 0
    return int(torch.unique(rows // (32 // row_bytes)).numel()) * 32


def max_abs_diff(torch, pairs) -> int:
    """Largest |a - b| over (kernel, plain) output pairs, compared as the
    unsigned values they hold."""
    worst = 0
    for a, b in pairs:
        a = a.to(torch.int64) & 0xFFFFFFFF
        b = b.to(torch.int64) & 0xFFFFFFFF
        if a.numel():
            worst = max(worst, int((a - b).abs().max()))
    return worst


# --- phase 7 -----------------------------------------------------------------
VOLUME_NEEDLES = 1 << 20  # weed benchmark -n 1048576 -size 1024
NEEDLE_BYTES = 1024
LOOKUP_BATCHES = (64, 512, 4096, 65536)
READ_BACK = 1000


def phase_volume_lookup(torch, work: str, seed: int, needle_mod, crc_mod,
                        keep: dict) -> dict:
    """weed benchmark's volume through the port's Volume (memory map) and
    bulk_lookup on the card, every answer held to the host map. `keep`
    gets the volume's files (hard links in a directory of their own) and
    its table for phase 13."""
    import numpy as np

    from seaweedfs_tpu_torch.ops import index_kernel as K
    from seaweedfs_tpu_torch.storage.volume import Volume

    rng = np.random.default_rng(seed + 7)
    # payloads from a seeded pool whose CRCs are computed once: the card's
    # machine has no google_crc32c, and its numpy CRC32C would spend
    # minutes on a million fresh 1 KiB CRCs that check nothing new
    pool = [rng.integers(0, 256, NEEDLE_BYTES, dtype=np.uint8).tobytes()
            for _ in range(64)]
    pool_crc = {d: crc_mod.masked_crc(d) for d in pool}
    real_crc = needle_mod.masked_crc

    def masked_crc(data):
        got = pool_crc.get(bytes(data))
        return real_crc(data) if got is None else got

    ids = np.unique(rng.integers(1, 1 << 48, size=VOLUME_NEEDLES + 4096, dtype=np.uint64))
    ids = rng.permutation(ids)[:VOLUME_NEEDLES]
    cookies = rng.integers(1, 1 << 32, size=VOLUME_NEEDLES, dtype=np.uint64)
    blob_of = rng.integers(0, len(pool), size=VOLUME_NEEDLES)
    vid = 7
    needle_mod.masked_crc = masked_crc
    try:
        t0 = time.perf_counter()
        v = Volume(work, "", vid)
        for c0 in range(0, VOLUME_NEEDLES, 4096):
            batch = [
                needle_mod.Needle(cookie=int(c), id=int(k), data=pool[int(b)])
                for k, c, b in zip(ids[c0:c0 + 4096].tolist(),
                                   cookies[c0:c0 + 4096].tolist(),
                                   blob_of[c0:c0 + 4096].tolist())
            ]
            for r in v.write_needle_batch(batch):
                if isinstance(r, Exception):
                    fail(f"volume write failed: {r!r}")
        write_s = time.perf_counter() - t0
        pick = rng.permutation(VOLUME_NEEDLES)[: VOLUME_NEEDLES // 50]
        deleted = pick[: len(pick) // 2]
        rewritten = pick[len(pick) // 2:]
        for i in deleted.tolist():
            v.delete_needle(needle_mod.Needle(cookie=int(cookies[i]), id=int(ids[i])))
        blob_of[rewritten] = (blob_of[rewritten] + 1) % len(pool)
        for r in v.write_needle_batch([
            needle_mod.Needle(cookie=int(cookies[i]), id=int(ids[i]), data=pool[int(blob_of[i])])
            for i in rewritten.tolist()
        ]):
            if isinstance(r, Exception):
                fail(f"volume overwrite failed: {r!r}")
        v.close()
        dat_bytes = os.path.getsize(os.path.join(work, f"{vid}.dat"))
        t0 = time.perf_counter()
        v = Volume(work, "", vid)  # replays the .idx
        reload_s = time.perf_counter() - t0
        absent = rng.integers(1 << 49, 1 << 50, size=VOLUME_NEEDLES // 10, dtype=np.uint64)
        probes = rng.permutation(np.concatenate([ids, absent]))
        t0 = time.perf_counter()
        want = v.bulk_lookup(probes, use_device=False)  # the host map
        host_s = time.perf_counter() - t0
        live = VOLUME_NEEDLES - len(deleted)
        if int(want[2].sum()) != live:
            fail(f"host map finds {int(want[2].sum())} live needles, expected {live}")
        t0 = time.perf_counter()
        v.bulk_lookup(probes[:64])  # builds and uploads the snapshot
        snapshot_s = time.perf_counter() - t0
        walls = {}
        K.KERNEL_LAUNCHES = 0
        for batch in LOOKUP_BATCHES + (len(probes),):
            parts = []
            t0 = time.perf_counter()
            for c0 in range(0, len(probes), batch):
                parts.append(v.bulk_lookup(probes[c0:c0 + batch]))
            wall = time.perf_counter() - t0
            for j, name in enumerate(("offset", "size", "found")):
                got = np.concatenate([p[j] for p in parts])
                if not np.array_equal(got, want[j]):
                    bad = int(np.count_nonzero(got != want[j]))
                    fail(f"bulk_lookup {name} differs from the host map at "
                         f"{bad} of {len(probes)} probes (batch {batch})")
            # a tail under 64 keys is served by the host map (the policy)
            tail = len(probes) % batch
            walls[str(batch) if batch != len(probes) else "all"] = {
                "calls": -(-len(probes) // batch),
                "device_calls": len(probes) // batch + (tail >= 64),
                "wall_s": wall,
                "probes_per_s": len(probes) / wall,
            }
        launches = K.KERNEL_LAUNCHES
        expect = sum(w["device_calls"] for w in walls.values())
        if launches != expect:
            fail(f"bulk_lookup launched index_search {launches} times, expected {expect}")
        # the device's busy share while bulk_lookup serves (profiled
        # again, outside the counted run)
        busy = {}
        for batch, calls in ((64, 2000), (65536, None)):
            sub = probes if calls is None else probes[: batch * calls]

            def serve(sub=sub, batch=batch):
                for c0 in range(0, len(sub), batch):
                    v.bulk_lookup(sub[c0:c0 + batch])

            try:
                busy[str(batch)] = profile_device(torch, serve)
            except Exception as e:
                busy[str(batch)] = {"error": str(e)}
        # read back located needles
        found_at = np.nonzero(want[2])[0]
        sample = rng.choice(found_at, READ_BACK, replace=False)
        pos = {int(k): i for i, k in enumerate(ids.tolist())}
        t0 = time.perf_counter()
        for j in sample.tolist():
            n = v.read_needle_at(int(want[0][j]), int(want[1][j]))
            i = pos[int(probes[j])]
            data = pool[int(blob_of[i])]
            if n.id != int(probes[j]) or n.cookie != int(cookies[i]):
                fail(f"needle {n.id:x}: id/cookie mismatch")
            if bytes(n.data) != data or n.checksum != pool_crc[data]:
                fail(f"needle {n.id:x}: payload or checksum mismatch")
        read_s = time.perf_counter() - t0
        v.close()
        stash = os.path.join(work, VACUUM_STASH)
        os.makedirs(stash)
        for ext in (".dat", ".idx"):
            os.link(os.path.join(work, f"{vid}{ext}"), os.path.join(stash, f"{vid}{ext}"))
        live = np.ones(VOLUME_NEEDLES, dtype=bool)
        live[deleted] = False
        keep.update(dir=stash, vid=vid, pool=pool, pool_crc=pool_crc, ids=ids,
                    cookies=cookies, blob_of=blob_of, live=live)
    finally:
        needle_mod.masked_crc = real_crc
    res = {
        "phase": "volume_lookup",
        "needles": VOLUME_NEEDLES,
        "needle_bytes": NEEDLE_BYTES,
        "deleted": len(deleted),
        "overwritten": len(rewritten),
        "dat_bytes": dat_bytes,
        "write_s": write_s,
        "reload_s": reload_s,
        "probes": len(probes),
        "absent_probes": len(absent),
        "host_map_s": host_s,
        "snapshot_build_s": snapshot_s,
        "batches": walls,
        "device_busy": busy,
        "all_equal_to_host_map": True,
        "read_back": READ_BACK,
        "read_back_s": read_s,
        "payload_pool": "64 seeded 1 KiB blobs, CRCs computed once",
        "kernel_launches": launches,
        "route": "device",
    }
    emit(res)
    return res


# --- phase 8 -----------------------------------------------------------------
INDEX_ENTRIES = 29_565_112  # a 30000 MB volume of 1 KiB needles
INDEX_PROBES = 10_000_000


def edge_tables(np):
    """Tables where a search that stops on lo < hi could part from a
    fixed-step one: one-row and empty buckets and a bucket of exactly 64
    rows; keys 0 and with the top bit set; just under the bucketed size; a
    span too wide to bucket; one row."""
    spread = np.arange(4096, dtype=np.uint64) * np.uint64(1000) + np.uint64(7)
    top = (1 << 64) - 1
    return {
        "pow2_bucket": np.concatenate([
            spread, spread[-1] + np.uint64(5000) + np.arange(64, dtype=np.uint64)]),
        "top_bits": np.asarray([0, 1, (1 << 32) - 1, 1 << 32, (1 << 63) - 1, 1 << 63,
                                (1 << 63) + 5, top - 1, top], dtype=np.uint64),
        "under_min_bucketed": np.unique(np.random.default_rng(3).integers(
            1, 1 << 45, size=4095, dtype=np.uint64)),
        "wide_span": np.concatenate([np.arange(1, 4097, dtype=np.uint64),
                                     np.asarray([(1 << 63) + 11], dtype=np.uint64)]),
        "one_row": np.asarray([12345], dtype=np.uint64),
    }


def edge_inputs(np, rng) -> dict:
    """The edge tables with offsets and sizes drawn from `rng`, and probes
    of every key, its neighbours, 0, 2^63 and 2^64 - 1."""
    out = {}
    for name, keys in edge_tables(np).items():
        offs = rng.integers(1, 1 << 32, size=len(keys), dtype=np.uint64).astype(np.uint32)
        sizes = rng.integers(1, 1 << 32, size=len(keys), dtype=np.uint64).astype(np.uint32)
        probes = np.concatenate([keys, keys + np.uint64(1), keys - np.uint64(1),
                                 np.asarray([0, 1 << 63, (1 << 64) - 1], dtype=np.uint64)])
        out[name] = (keys, offs, sizes, probes)
    return out


def phase_index_kernel(torch, seed: int, keep: dict) -> dict:
    """K1 against its plain version and torch.searchsorted on one full
    volume's index; `keep` gets the index and probes for phase 12."""
    import numpy as np

    from seaweedfs_tpu_torch.ops import index_kernel as K

    # the edge tables first: the kernel against the plain version
    rng = np.random.default_rng(seed + 8)
    for name, (keys, offs, sizes, probes) in edge_inputs(np, rng).items():
        got = K.IndexSnapshot(keys, offs, sizes).lookup(probes)
        plain = K.IndexSnapshot(keys, offs, sizes, device="cpu").lookup(probes)
        if not all(np.array_equal(a, b) for a, b in zip(got, plain)):
            fail(f"index_search != plain on the edge table {name}")

    gaps = rng.integers(1, 20, size=INDEX_ENTRIES, dtype=np.uint64)
    keys = np.cumsum(gaps).astype(np.uint64)  # sorted, distinct
    offs = rng.integers(1, 1 << 30, size=INDEX_ENTRIES, dtype=np.uint64).astype(np.uint32)
    sizes = rng.integers(1, 1 << 20, size=INDEX_ENTRIES, dtype=np.uint64).astype(np.uint32)
    n_absent = INDEX_PROBES // 10
    cand = rng.integers(0, int(keys[-1]) + 1000, size=2 * n_absent, dtype=np.uint64)
    at = np.minimum(np.searchsorted(keys, cand), INDEX_ENTRIES - 1)
    absent = cand[keys[at] != cand][:n_absent]
    probes = rng.permutation(np.concatenate([
        keys[rng.integers(0, INDEX_ENTRIES, size=INDEX_PROBES - n_absent)], absent]))
    t0 = time.perf_counter()
    snap = K.IndexSnapshot(keys, offs, sizes)
    build_s = time.perf_counter() - t0
    if snap.starts is None:
        fail("the full-volume snapshot is not bucketed")
    dev = snap.rows.device
    pk = torch.from_numpy(probes.view(np.int64)).to(dev)
    bucket = torch.from_numpy(snap._bucket_of(probes).astype(np.int64)).to(dev)
    cols = (snap.keys, snap.offsets, snap.sizes)  # strided views of snap.rows

    def k1_bucketed():
        return K._index_search_cuda(snap.rows, snap.starts, snap.kmin, snap.bstep, snap.nb, pk)

    def k1_flat():
        return K._index_search_cuda(snap.rows, None, 0, 1, 0, pk)

    def plain_bucketed():
        return K._bulk_lookup_bucketed_torch(snap.bsteps, *cols, snap.starts, pk, bucket)

    def plain_flat():
        return K._bulk_lookup_torch(snap.steps, *cols, pk)

    # the one PyTorch call computing the same function: searchsorted over
    # the sign-biased keys (which sort as the unsigned ones), then gathers,
    # over contiguous copies of the columns (its best layout)
    biased = snap.keys ^ K._SIGN
    lib_offs = snap.offsets.contiguous()
    lib_sizes = snap.sizes.contiguous()
    bp = pk ^ K._SIGN
    n = INDEX_ENTRIES

    def library():
        i = torch.searchsorted(biased, bp).clamp_(max=n - 1)
        f = biased[i] == bp
        return (torch.where(f, lib_offs[i], 0), torch.where(f, lib_sizes[i], 0), f)

    worst = 0
    for kern, plain in ((k1_bucketed, plain_bucketed), (k1_flat, plain_flat),
                        (k1_bucketed, library)):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                and torch.equal(got[2].bool(), want[2])):
            fail(f"index_search != {plain.__name__} on the full-volume index")
        worst = max(worst, max_abs_diff(torch, zip(got[:2], want[:2])))
    found = int(got[2].sum())
    if found != INDEX_PROBES - n_absent:
        fail(f"found {found} of {INDEX_PROBES - n_absent} present probes")
    events_ms = cuda_median_ms(torch, k1_bucketed, 30)
    flat_ms = cuda_median_ms(torch, k1_flat, 10)
    plain_ms = cuda_median_ms(torch, plain_bucketed, 5, warm=1)
    plain_flat_ms = cuda_median_ms(torch, plain_flat, 3, warm=1)
    library_ms = cuda_median_ms(torch, library, 10)
    ms = kernel_device_ms(torch, k1_bucketed, "index_search_kernel", 20)
    if ms is None:
        fail("the profiler recorded no device time for index_search_kernel")
    # bound: bytes every probe must move, each once: its key in, its three
    # outputs out, and the distinct 32-byte sectors of its bucket bounds
    # and of its final 16-byte row (key, offset and size together)
    _o, _s, f, idx = K._search_range_bounded_torch(
        snap.bsteps, *cols, pk, snap.starts[bucket], snap.starts[bucket + 1], n,
        with_index=True)
    io_bytes = INDEX_PROBES * (8 + 4 + 4 + 1)
    bounds_bytes = unique_sector_bytes(torch, torch.cat([bucket, bucket + 1]), 4)
    # (unbucketed: the same rows without the bucket bounds)
    nbytes_flat = io_bytes + unique_sector_bytes(torch, idx, 16)
    nbytes = nbytes_flat + bounds_bytes
    # the same count in the column layout before packed rows (an 8-byte key
    # column, 4-byte offset and size columns), to compare across layouts
    nbytes_cols = (
        io_bytes + bounds_bytes + unique_sector_bytes(torch, idx, 8)
        + 2 * unique_sector_bytes(torch, idx[f], 4)
    )
    del _o, _s, f, idx
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    res = {
        "phase": "index_kernel",
        "entries": INDEX_ENTRIES,
        "column_bytes": INDEX_ENTRIES * 16,
        "starts_bytes": (snap.nb + 1) * 4,
        "nb": snap.nb,
        "bsteps": snap.bsteps,
        "steps_unbucketed": snap.steps,
        "snapshot_build_s": build_s,
        "probes": INDEX_PROBES,
        "absent": n_absent,
        "edge_tables": list(edge_tables(np)),
        "equal_to_plain": True,
        "equal_to_library": True,
        "max_abs_err": worst,
        "tolerance": "exact",
        "design": "packed 16-byte rows",
        "registers": K._kernel_lib().index_search_registers(),
        "ms": ms,
        "ms_from": "profiler",
        "ms_events": events_ms,
        "ms_events_note": "median CUDA-event time of one launch",
        "ms_unbucketed": flat_ms,
        "plain_ms": plain_ms,
        "plain_ms_unbucketed": plain_flat_ms,
        "library_ms": library_ms,
        "library_call": "torch.searchsorted on sign-biased int64 keys + 3 gathers "
                        "over contiguous columns",
        "ratio_to_library": ms / library_ms,
        "ratio_to_library_unbucketed": flat_ms / library_ms,
        "bound_bytes": nbytes,
        "bound_ms": bound_ms,
        "bound_ms_unbucketed": nbytes_flat / HBM_BYTES_PER_S * 1e3,
        "bound_bytes_column_layout": nbytes_cols,
        "bound_ms_column_layout": nbytes_cols / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "probes_per_s": INDEX_PROBES / (ms * 1e-3),
    }
    emit(res)
    keep.update(keys=keys, offs=offs, sizes=sizes, probes=probes)
    return res


# --- phase 9 -----------------------------------------------------------------
ARENA_VOLUMES = 4
ARENA_ENTRIES = 1 << 18
ARENA_MEMTABLE = 50_000  # entries: 5 sealed runs and a 12,144-entry tail
ARENA_CUTS = {
    "entries_per_volume": {
        "from": 1 << 20, "to": ARENA_ENTRIES,
        "why": "time for phase 15 within the script's 1,200 s, with room for a host 1.36x slower: the build of the four maps "
               "took 34.2 s of a run of the whole script on an NVIDIA H100 80GB HBM3 at "
               "700.00 W; each map "
               "keeps 5 sealed runs (now of 50,000 entries) and a memtable tail, and the "
               "gate's probes, the identity check and K2's two comparisons stay"},
}
GATE_PROBES = 200_000
ARENA_PROFILED_LAUNCHES = 1_000  # K2's profiler reading at each shape
GATE_CONCURRENCY = 256


class _Vol:
    """The two seams the gate probes: nm (get, arena_view) and the host
    path of Volume.bulk_lookup."""

    def __init__(self, nm, tombstone):
        self.nm = nm
        self.tombstone = tombstone

    def bulk_lookup(self, keys, use_device=None):
        import numpy as np

        offs = np.zeros(len(keys), dtype=np.uint32)
        szs = np.zeros(len(keys), dtype=np.uint32)
        fnd = np.zeros(len(keys), dtype=bool)
        for i, k in enumerate(keys.tolist()):
            nv = self.nm.get(k)
            if nv is not None and nv.offset_units != 0 and nv.size != self.tombstone:
                offs[i], szs[i], fnd[i] = nv.offset_units, nv.size, True
        return offs, szs, fnd


def _pack(torch, np, rl, gen, members):
    """pack_members' planes of `members` on gen's device -> (u32p, i32p,
    slots, pack_members' blocks)."""
    total = sum(len(k) * len(s) for _g, s, k in members)
    u32 = np.zeros((4, total), dtype=np.uint32)
    i32 = np.zeros((5, total), dtype=np.int32)
    blocks = rl.pack_members(gen, members, u32, i32)
    dev = gen.keys.device
    return (torch.from_numpy(u32.view(np.int32)).to(dev),
            torch.from_numpy(i32).to(dev), total, blocks)


PLANE_FLUSHES = 11  # flushes of the replaced plane form, for its stage walls
K2_DESIGN = ("16-byte rows; a bucket table of about 2 rows a bucket per run of 4,096 "
             "rows or more and bloom addressing from the key on the card; R lanes a "
             "key: the bloom test, then the bucket's bounds where it passes, then a "
             "4-row window; the newest run's answer reduced by a warp ballot; one "
             "launch a flush")


def k2_against_plain(torch, np, rl, gen, members, what: str, reps: int) -> dict:
    """K2 at one flush's shape over `gen`: the kernel against its plain
    version on the same launch inputs (exact), and against the plane kernel
    it replaced folded newest-wins on the host (exact); the three timed,
    the two kernels by the profiler in one session; the bytes bound of
    both forms. None of these launches is the path's: the caller puts the
    counts back."""
    plan = rl.LaunchPlan(members)
    keys, blocks, descs = plan.tensors(gen)
    args = (gen.rows, gen.tables, gen.bloom, keys, blocks, descs)
    kern = lambda: rl._ragged_probe_cuda(*args)  # noqa: E731
    plain = lambda: rl._ragged_probe_torch(*args)  # noqa: E731
    a, b = kern(), plain()
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        fail(f"ragged_lookup != plain {what}")
    worst = max_abs_diff(torch, zip(a[1:], b[1:]))
    # the plane kernel on contiguous copies of the columns, made for this
    # comparison only
    u32_d, i32_d, slots, pblocks = _pack(torch, np, rl, gen, members)
    cols = (gen.keys.contiguous(), gen.offs.contiguous(), gen.sizes.contiguous(), gen.bloom)
    old = lambda: rl._ragged_lookup_cuda(*cols, u32_d, i32_d)  # noqa: E731
    o_off, o_size, o_found = old()
    torch.cuda.synchronize()
    folded = dict(rl.fold_newest(o_found.cpu().numpy().view(bool), o_off.cpu().numpy(),
                                 o_size.cpu().numpy(), pblocks))
    got = [t.cpu().numpy() for t in a]
    for gi, k0, n in plan.spans:
        f = folded[gi]
        if not (np.array_equal(got[0][k0:k0 + n].astype(bool), f["found"])
                and np.array_equal(got[1][k0:k0 + n], f["rank"])
                and np.array_equal(got[2][k0:k0 + n], f["off"])
                and np.array_equal(got[3][k0:k0 + n], f["size"])):
            fail(f"ragged_lookup != the plane kernel folded newest-wins {what}, group {gi}")
    # bounds: the probe's inputs and answers once, and the distinct sectors
    # of the bucket starts, bloom words and final rows its slots need
    *_a, slot = rl._ragged_probe_torch(*args, with_index=True)
    t = slot["table"][slot["present"] & (slot["table"] >= 0)]
    bw = torch.cat([slot["bloom0"][slot["bloom0"] >= 0], slot["bloom1"][slot["bloom1"] >= 0]])
    need = slot["present"] & (slot["lo"] < slot["hi"])
    parts = {
        "launch_in": plan.words * 8, "answers_out": 13 * plan.n_keys,
        "bucket_starts": unique_sector_bytes(torch, torch.cat([t, t + 1]), 4),
        "bloom_words": unique_sector_bytes(torch, bw, 4),
        "rows": unique_sector_bytes(torch, slot["row"][need], 16),
    }
    nbytes = sum(parts.values())
    # the plane form's bound: planes in, per-slot answers out,
    # bloom words, the key column at each present slot's final row, and the
    # offset and size at each found slot's
    _o, _s, f, prow, present = rl._ragged_dispatch_torch(
        gen.steps, *cols, u32_d, i32_d, with_index=True)
    pbw = torch.cat([i32_d[3][u32_d[2] != 0], i32_d[4][u32_d[3] != 0]])
    plane_bytes = (slots * (4 * 4 + 5 * 4 + 4 + 4 + 1) + unique_sector_bytes(torch, pbw, 4)
                   + unique_sector_bytes(torch, prow[present], 8)
                   + 2 * unique_sector_bytes(torch, prow[f], 4))
    ms, way, missed = profiled_kernel_ms(
        torch, lambda: (kern(), old()), ("ragged_probe_kernel", "ragged_lookup_kernel"), reps)
    # the plane form's flush, as the path ran it before: pack_members into
    # pinned planes, one copy each way, the plane kernel, the host's fold
    pin_u32 = torch.empty((4, slots), dtype=torch.int32, pin_memory=True)
    pin_i32 = torch.empty((5, slots), dtype=torch.int32, pin_memory=True)
    pin_out = [torch.empty(slots, dtype=dt, pin_memory=True)
               for dt in (torch.int32, torch.int32, torch.uint8)]
    walls = []
    for _ in range(PLANE_FLUSHES):
        t0 = time.perf_counter()
        pb = rl.pack_members(gen, members, pin_u32.numpy().view(np.uint32), pin_i32.numpy())
        t1 = time.perf_counter()
        u32_d.copy_(pin_u32, non_blocking=True)
        i32_d.copy_(pin_i32, non_blocking=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        o = old()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for h, d in zip(pin_out, o):
            h.copy_(d, non_blocking=True)
        torch.cuda.synchronize()
        rl.fold_newest(pin_out[2].numpy().view(bool), pin_out[0].numpy(), pin_out[1].numpy(), pb)
        walls.append((t1 - t0, t2 - t1, t3 - t2, time.perf_counter() - t3))
    plane_walls = {k: sorted(w[i] for w in walls)[len(walls) // 2]
                   for i, k in enumerate(("pack_s", "upload_s", "dispatch_s", "readback_s"))}
    return {
        "keys": plan.n_keys, "groups": len(members), "runs": plan.n_runs,
        "blocks": plan.n_blocks, "slots": plan.slots,
        "found": int(a[0].sum()), "generation_bytes": gen.nbytes,
        "generation_built_s": gen.built_s,
        "ms": ms["ragged_probe_kernel"], "ms_from": f"profiler, launched from {way}",
        "profiler_missed": missed, "ms_events": cuda_median_ms(torch, kern, 50),
        "plain_ms": cuda_median_ms(torch, plain, 10, warm=1),
        "bound_bytes": nbytes, "bound_parts": parts, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "plane_ms": ms["ragged_lookup_kernel"], "plane_ms_events": cuda_median_ms(torch, old, 50),
        "plane_bound_bytes": plane_bytes, "plane_bound_ms": plane_bytes / HBM_BYTES_PER_S * 1e3,
        "plane_flush_walls_s": plane_walls,
        "plane_flush_walls_from": f"median of {PLANE_FLUSHES} flushes of the plane form",
        "max_abs_err": worst,
    }


def phase_arena_gate(torch, work: str, seed: int) -> dict:
    import asyncio

    import numpy as np

    from seaweedfs_tpu_torch.ops import ragged_lookup as rl
    from seaweedfs_tpu_torch.server.lookup_gate import BatchLookupGate
    from seaweedfs_tpu_torch.storage.needle_map.lsm_map import LsmNeedleMap
    from seaweedfs_tpu_torch.types import TOMBSTONE_FILE_SIZE

    rng = np.random.default_rng(seed + 9)
    vols, keys_of = {}, {}
    t0 = time.perf_counter()
    for vid in range(1, ARENA_VOLUMES + 1):
        nm = LsmNeedleMap(os.path.join(work, f"lsm{vid}.idx"),
                          memtable_bytes=ARENA_MEMTABLE * 120)
        keys = rng.choice(np.arange(1, ARENA_ENTRIES * 16, dtype=np.uint64),
                          size=ARENA_ENTRIES, replace=False)
        for c0 in range(0, ARENA_ENTRIES, ARENA_MEMTABLE):
            nm.put_batch((int(k), c0 + j + 1, 100 + (c0 + j) % 900)
                         for j, k in enumerate(keys[c0:c0 + ARENA_MEMTABLE].tolist()))
        for k in keys[::200].tolist():
            nm.delete(int(k), 0)
        vols[vid] = _Vol(nm, TOMBSTONE_FILE_SIZE)
        keys_of[vid] = keys
    build_s = time.perf_counter() - t0
    runs = {vid: len(v.nm._runs) for vid, v in vols.items()}
    tails = {vid: len(v.nm._mem) for vid, v in vols.items()}

    class Store:
        def find_volume(self, vid):
            return vols.get(vid)

    arena = rl.DeviceColumnArena()
    try:
        segs = [s for v in vols.values() for s in v.nm.arena_view([])[1]]
        arena.ensure(segs)
        t0 = time.perf_counter()
        arena.refresh_sync()
        refresh_s = time.perf_counter() - t0
        st = arena.stats()
        if st["resident_segments"] != len(segs) or st["errors"]:
            fail(f"arena did not take every segment: {st}")
        plan_vid = rng.integers(1, ARENA_VOLUMES + 1, size=GATE_PROBES)
        miss = rng.random(GATE_PROBES) < 0.1
        plan = [
            (vid, int(rng.integers(1 << 40, 1 << 41)) if m
             else int(keys_of[vid][rng.integers(0, ARENA_ENTRIES)]))
            for vid, m in zip(plan_vid.tolist(), miss.tolist())
        ]
        def drive(gate, plan):
            """GATE_CONCURRENCY clients on one loop walk the plan, each
            awaiting its lookups one at a time -> the answers."""
            got = [None] * len(plan)

            async def client(i0):
                for i in range(i0, len(plan), GATE_CONCURRENCY):
                    got[i] = await gate.lookup(*plan[i])

            async def main():
                await asyncio.gather(*(client(i) for i in range(GATE_CONCURRENCY)))

            asyncio.run(main())
            gate.close()
            return got

        gate = BatchLookupGate(Store(), arena=arena, identity_check=True)
        rl.KERNEL_LAUNCHES = 0
        t0 = time.perf_counter()
        got = drive(gate, plan)
        drive_s = time.perf_counter() - t0
        launches = rl.KERNEL_LAUNCHES
        for (vid, k), r in zip(plan, got):
            nv = vols[vid].nm.get(k)
            want = (None if nv is None or nv.offset_units == 0
                    or nv.size == TOMBSTONE_FILE_SIZE else (nv.offset_units, nv.size))
            if r != want:
                fail(f"gate answered {r} for ({vid}, {k}), the host map {want}")
        stats = dict(gate.stats)
        if stats["identity_mismatches"] or stats["host_fallbacks"] or arena.counters["errors"]:
            fail(f"gate {stats}, arena errors {arena.counters['errors']} "
                 f"({arena.last_error})")
        if stats["device_probes"] <= 0 or launches <= 0:
            fail(f"no probe reached the device: {stats}, {launches} launches")
        hist = {int(b): c for b, c in sorted(gate.batch_hist.items())}
        # the same traffic as a server runs it, with the identity check off
        gate_off = BatchLookupGate(Store(), arena=arena)
        t0 = time.perf_counter()
        got_off = drive(gate_off, plan)
        drive_off_s = time.perf_counter() - t0
        if got_off != got:
            fail("the gate without the identity check answered otherwise")
        if gate_off.stats["host_fallbacks"] or arena.counters["errors"]:
            fail(f"gate without the identity check {gate_off.stats}, arena "
                 f"errors {arena.counters['errors']} ({arena.last_error})")
        # the device's busy share under the same traffic (a second,
        # profiled drive over the first 50,000 probes)
        try:
            busy = profile_device(torch, lambda: drive(
                BatchLookupGate(Store(), arena=arena, identity_check=True), plan[:50_000]))
        except Exception as e:
            busy = {"error": str(e)}
        flushes = sorted(b for b, c in hist.items() for _ in range(c))
        median_batch = flushes[len(flushes) // 2]

        # ragged_lookup against its plain version and the plane kernel it
        # replaced, at the gate's median batch and at 65,536 probes
        gen = arena.ensure(segs)
        timing = {}
        worst = 0
        counted = rl.KERNEL_LAUNCHES
        for n_probes in (median_batch, 65_536):
            idx = rng.integers(0, len(plan), size=n_probes)
            by_vid = {}
            for i in idx.tolist():
                by_vid.setdefault(plan[i][0], []).append(plan[i][1])
            members = [(vid, vols[vid].nm.arena_view([])[1], np.asarray(ks, dtype=np.uint64))
                       for vid, ks in sorted(by_vid.items())]
            timing[n_probes] = k2_against_plain(torch, np, rl, gen, members,
                                                f"at {n_probes} probes", ARENA_PROFILED_LAUNCHES)
            worst = max(worst, timing[n_probes]["max_abs_err"])
        rl.KERNEL_LAUNCHES = counted
        # and one probe_groups of 65,536 probes through the entry point
        res65 = arena.probe_groups([(s, k) for _v, s, k in members])
        for (vid, _s, ks), r in zip(members, res65):
            mem_hits, _ = vols[vid].nm.arena_view(ks)
            for j, k in enumerate(ks.tolist()):
                hit = mem_hits.get(k) or (
                    (int(r["off"][j]), int(r["size"][j])) if r["found"][j] else None)
                nv = vols[vid].nm.get(k)
                if hit != (None if nv is None else (nv.offset_units, nv.size)):
                    fail(f"probe_groups answer for ({vid}, {k}) differs from the map")
    finally:
        arena.close()
        for v in vols.values():
            v.nm.close()
    res = {
        "phase": "arena_gate",
        "cuts": ARENA_CUTS,
        "volumes": ARENA_VOLUMES,
        "entries_per_volume": ARENA_ENTRIES,
        "runs": runs,
        "memtable_tail": tails,
        "build_s": build_s,
        "arena": {k: st[k] for k in ("resident_segments", "resident_bytes",
                                      "resident_rows", "budget_bytes")},
        "refresh_s": refresh_s,
        "probes": len(plan),
        "absent_share": float(miss.mean()),
        "concurrency": GATE_CONCURRENCY,
        "drive_s": drive_s,
        "probes_per_s": len(plan) / drive_s,
        "identity_check": "on for drive_s and probes_per_s",
        "drive_identity_off_s": drive_off_s,
        "probes_per_s_identity_off": len(plan) / drive_off_s,
        "device_busy": busy,
        "gate": stats,
        "batch_hist": hist,
        "median_batch": median_batch,
        "arena_errors": arena.counters["errors"],
        "all_equal_to_host_maps": True,
        "kernel_launches": launches,
        "ragged_lookup": {str(k): v for k, v in timing.items()},
        "equal_to_plain": True,
        "max_abs_err": worst,
    }
    emit(res)
    return res


# --- phase 10 ----------------------------------------------------------------
SERVER_NEEDLES = 1 << 20  # weed benchmark -n 1048576 -size 1024 -c 16
SERVER_WRITES = 1 << 15  # POSTs into volume 2, cut (SERVER_CUTS)
WRITE_CONCURRENCY = 16
# GETs of each read pass (identity check on, then off), cut (SERVER_CUTS)
SERVER_READS = 50_000
READ_CONCURRENCY = 256
WARMUP_READS = 10_000
# the warm-up's concurrency: at 256 a wakeup holds 65-128 GETs, which the
# gate's 128-probe arena cut keeps on the host maps; at 512 most wakeups
# pass the cut, so the server finds its arena cold and uploads it itself
WARMUP_CONCURRENCY = 512
WRONG_COOKIE_SHARE = 0.01
ABSENT_SHARE = 0.1
DEGRADED_GETS = 2_000
EC_LOST = (0, 3, 10, 13)
SERVER_START_S = 120
SERVER_STOP_S = 10
AB_READS = 25_000  # GETs per pass of --gate-cut-ab
# why a count below is cut: a run of the whole script went past its
# 1,200 s limit on a machine with one H100, where another machine of that
# kind had taken 922.6 s for it with these counts deeper; the cuts and the
# set-up children (--prep) keep room for a host 1.3x slower and more
OVER_LIMIT = ("a run of the whole script at the deeper count went past the script's "
              "1,200 s limit on a machine with one H100, where another machine of that "
              "kind (NVIDIA H100 80GB HBM3, 700.00 W) took 922.6 s")
SERVER_CUTS = {
    "writes": {"from": 1 << 16, "to": SERVER_WRITES,
               "why": "POSTs into volume 2 at c=16; " + OVER_LIMIT + ", 24.4 s of it the "
                      "POSTs; every reply is still checked and every GET pass reads both "
                      "volumes"},
    "reads": {"from": 100_000, "to": SERVER_READS,
              "why": "GETs of each read pass; " + OVER_LIMIT + ", 21.5 s and 23.5 s of it "
                     "the two passes; every check of a pass stays"},
}


def _port_pair(taken: set, start: int = 20000) -> int:
    """A free port whose +10000 (the RPC port) is free too, from `start`."""
    import socket

    for cand in range(start, 30000):
        if cand in taken:
            continue
        try:
            with socket.socket() as s1, socket.socket() as s2:
                s1.bind(("127.0.0.1", cand))
                s2.bind(("127.0.0.1", cand + 10000))
        except OSError:
            continue
        taken.add(cand)
        return cand
    fail("no free port pair")


def _serve_in_thread(fn, argv: list, name: str) -> dict:
    """Run a CLI entry function (cmd_server, cmd_volume) on its own
    event-loop thread; the returned dict gets its loop, stop event and
    servers once they listen."""
    held = {"ready": threading.Event()}

    def started(loop, stop, servers):
        held.update(loop=loop, stop=stop, servers=servers)
        held["ready"].set()

    def run():
        try:
            held["rc"] = fn(argv, started=started)
        except (Exception, SystemExit) as e:  # reported by the caller
            held["error"] = e
            held["ready"].set()

    held["thread"] = threading.Thread(target=run, name=name, daemon=True)
    held["thread"].start()
    return held


def _stop_served(held: dict, timeout: float) -> float:
    t0 = time.perf_counter()
    loop = held.get("loop")
    if loop is not None and not loop.is_closed():
        loop.call_soon_threadsafe(held["stop"].set)
    held["thread"].join(timeout)
    if held["thread"].is_alive():
        fail(f"{held['thread'].name} did not stop in {timeout} s")
    if held.get("rc") != 0:
        fail(f"{held['thread'].name} exited with {held.get('rc')!r}: "
             f"{held.get('error')!r}")
    return time.perf_counter() - t0


def client_main(argv: list) -> int:
    """Child mode of this script: the closed-loop load client of phase
    10 (standard library only). Each of `concurrency` clients keeps one
    keep-alive connection and waits for its own response before sending
    its next request, as `weed benchmark` does. Reads the plan (a pickle
    of the requests and the expected answers), checks every answer and
    writes its counts, latencies and CPU time as JSON."""
    import asyncio
    import pickle

    ap = argparse.ArgumentParser()
    ap.add_argument("--client", required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--concurrency", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--until", default="",
                    help="cycle through the plan until this file exists")
    a = ap.parse_args(argv)
    with open(a.client, "rb") as f:
        plan = pickle.load(f)
    blobs = plan["blobs"]
    reqs = plan["requests"]  # (method, path, blob index | -1, status)
    # a GET that wants 200 may answer 404 (counted apart, not wrong)
    allow_404 = plan.get("allow_404", False)
    # any other status than the wanted one is a failed read (counted), a
    # 200 with another body a wrong one; `max_requests` caps the requests
    # of all clients together
    allow_fail = plan.get("allow_fail", False)
    cap = plan.get("max_requests")
    pace_s = plan.get("pace_s", 0.0)  # each connection's pause after a request
    lat = []
    bad = []
    live_404 = [0]
    failed = [0]
    sent = [0]

    def order(k: int):
        n = 0
        while True:
            for i in range(k, len(reqs), a.concurrency):
                if cap is not None and sent[0] >= cap:
                    return
                sent[0] += 1
                yield i
                n += 1
                if a.until and (pace_s or n % 32 == 0) and os.path.exists(a.until):
                    return
            if not a.until or os.path.exists(a.until):
                return

    async def one_client(k: int) -> None:
        r, w = await asyncio.open_connection("127.0.0.1", a.port)
        try:
            for i in order(k):
                method, path, blob, want_status = reqs[i]
                body = blobs[blob] if method == "POST" else b""
                t0 = time.perf_counter()
                w.write(b"%s %s HTTP/1.1\r\nHost: smoke\r\nContent-Length: %d\r\n\r\n"
                        % (method.encode(), path.encode(), len(body)) + body)
                head = await r.readuntil(b"\r\n\r\n")
                status = int(head[9:12])
                low = head.lower()
                j = low.find(b"content-length:")
                n = int(low[j + 15: low.index(b"\r\n", j)]) if j >= 0 else 0
                got = await r.readexactly(n) if n else b""
                lat.append(time.perf_counter() - t0)
                if allow_404 and status == 404 and want_status == 200:
                    live_404[0] += 1
                elif allow_fail and status != want_status:
                    failed[0] += 1
                elif status != want_status:
                    bad.append((i, path, status, want_status, got[:80].decode("latin1")))
                elif method == "GET" and status == 200 and got != blobs[blob]:
                    bad.append((i, path, "body differs"))
                elif method == "POST":
                    reply = json.loads(got)
                    etag = plan["etags"][blob]
                    if reply.get("size") != len(blobs[blob]) or reply.get("eTag") != etag:
                        bad.append((i, path, "reply", got[:120].decode("latin1")))
                if pace_s:
                    await asyncio.sleep(pace_s)
        finally:
            w.close()

    async def run() -> None:
        await asyncio.gather(*(one_client(k) for k in range(a.concurrency)))

    c0 = os.times()
    t0 = time.perf_counter()
    asyncio.run(run())
    wall = time.perf_counter() - t0
    c1 = os.times()
    cpu = (c1.user - c0.user) + (c1.system - c0.system)
    srt = sorted(lat)
    with open(a.out, "w") as f:
        json.dump({
            "requests": len(lat),
            "wall_s": wall,
            "per_s": len(lat) / wall,
            "live_answered_404": live_404[0],
            "failed": failed[0],
            "p50_ms": srt[len(srt) // 2] * 1e3,
            "p99_ms": srt[min(len(srt) - 1, int(len(srt) * 0.99))] * 1e3,
            "client_cpu_s": cpu,
            "client_cpu_share": cpu / wall,
            "bad": len(bad),
            "bad_examples": bad[:5],
        }, f)
    return 0


def _start_client(work: str, name: str, port: int, plan: dict, concurrency: int,
                  until: str = "") -> dict:
    """Start the load client as a child process over `plan` (with
    `until`, it cycles through the plan until that file exists)."""
    import pickle

    plan_path = os.path.join(work, f"{name}.plan")
    out_path = os.path.join(work, f"{name}.json")
    with open(plan_path, "wb") as f:
        pickle.dump(plan, f, protocol=pickle.HIGHEST_PROTOCOL)
    args = [sys.executable, os.path.abspath(__file__), "--client", plan_path,
            "--port", str(port), "--concurrency", str(concurrency), "--out", out_path]
    if until:
        args += ["--until", until]
    proc = subprocess.Popen(args, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    return {"name": name, "proc": proc, "out": out_path, "plan": plan_path}


def _client_result(held: dict, timeout: float) -> dict:
    """Wait for a load client; fail on any wrong answer."""
    try:
        _out, err = held["proc"].communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        held["proc"].kill()
        held["proc"].wait()
        fail(f"load client {held['name']} ran over {timeout} s")
    if held["proc"].returncode != 0:
        fail(f"load client {held['name']} exited {held['proc'].returncode}: "
             f"{err.decode(errors='replace')[-2000:]}")
    with open(held["out"]) as f:
        res = json.load(f)
    os.remove(held["plan"])
    os.remove(held["out"])
    if res["bad"]:
        fail(f"{held['name']}: {res['bad']} wrong answers, e.g. {res['bad_examples']}")
    return res


def _drive(work: str, name: str, port: int, plan: dict, concurrency: int,
           timeout: float) -> dict:
    """Run the load client as a child process over `plan`; fail on any
    wrong answer."""
    return _client_result(_start_client(work, name, port, plan, concurrency), timeout)


def _http_json(port: int, path: str) -> dict:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
        if resp.status != 200:
            fail(f"GET {path}: {resp.status} {body[:200]!r}")
        return json.loads(body)
    finally:
        conn.close()


def _gate_cut_ab(work: str, port: int, base_plan: dict, read_plan, rounds: int) -> dict:
    """The gate's arena cut (`lookup_gate._ARENA_MIN_WAKEUP`) at the
    reference's 128 against the port's 64, on one warm server: `rounds`
    read passes of AB_READS GETs at READ_CONCURRENCY in the order 128,
    64, 64, 128, 128, 64, ... Each pass sets the cut before its client
    starts; the gate reads it at every flush."""
    from seaweedfs_tpu_torch.server import lookup_gate as LG

    shipped = LG._ARENA_MIN_WAKEUP
    out = []
    try:
        for r in range(rounds):
            cut = (128, 64)[((r + 1) // 2) % 2]
            LG._ARENA_MIN_WAKEUP = cut
            g0 = _http_json(port, "/debug/needle_map")["gate"]
            res = _drive(work, f"ab{r}", port, dict(base_plan, requests=read_plan(AB_READS)),
                         READ_CONCURRENCY, 600)
            g1 = _http_json(port, "/debug/needle_map")["gate"]
            batches = g1["batches"] - g0["batches"]
            out.append({"round": r, "cut": cut, "per_s": res["per_s"],
                        "p50_ms": res["p50_ms"], "p99_ms": res["p99_ms"],
                        "client_cpu_share": res["client_cpu_share"],
                        "arena_batch_share": (g1["device_batches"] - g0["device_batches"])
                        / max(1, batches),
                        "host_fallbacks": g1["host_fallbacks"] - g0["host_fallbacks"]})
    finally:
        LG._ARENA_MIN_WAKEUP = shipped
    med = {}
    for cut in (128, 64):
        mine = [o for o in out if o["cut"] == cut]
        med[str(cut)] = {k: statistics.median(o[k] for o in mine)
                         for k in ("per_s", "p50_ms", "p99_ms", "arena_batch_share")}
    return {"phase": "gate_cut_ab", "reads_per_round": AB_READS,
            "concurrency": READ_CONCURRENCY, "shipped_cut": shipped,
            "rounds": out, "median_by_cut": med}


def benchmark_volume_table(rng, crc_mod) -> dict:
    """The table a reader of volume 1 checks against, drawn from `rng`:
    a pool of SERVER_NEEDLES' 1 KiB payloads whose CRCs are computed once
    (as phase 7), ids, cookies, the pool index of each needle, the 1 %
    deleted, the 1 % overwritten (with their new blobs) and which are
    live. Every draw is here, so the child that writes the volume and
    the phase that reads it draw the same table from the same seed."""
    import numpy as np

    pool = [rng.integers(0, 256, NEEDLE_BYTES, dtype=np.uint8).tobytes()
            for _ in range(128)]  # 0-63 volume 1, 64-127 volume 2
    pool_crc = [crc_mod.masked_crc(b) for b in pool]
    ids = np.unique(rng.integers(1, 1 << 48, size=SERVER_NEEDLES + 4096, dtype=np.uint64))
    ids = rng.permutation(ids)[:SERVER_NEEDLES]
    cookies = rng.integers(1, 1 << 32, size=SERVER_NEEDLES, dtype=np.uint64)
    blob_of = rng.integers(0, 64, size=SERVER_NEEDLES)
    first_blob = blob_of.copy()
    pick = rng.permutation(SERVER_NEEDLES)[: SERVER_NEEDLES // 50]
    deleted = pick[: len(pick) // 2]
    rewritten = pick[len(pick) // 2:]
    blob_of[rewritten] = (blob_of[rewritten] + 1) % 64
    live = np.ones(SERVER_NEEDLES, dtype=bool)
    live[deleted] = False
    return {"pool": pool, "pool_crc": pool_crc, "ids": ids, "cookies": cookies,
            "first_blob": first_blob, "blob_of": blob_of, "live": live,
            "deleted_at": deleted, "rewritten_at": rewritten,
            "deleted": len(deleted), "rewritten": len(rewritten)}


def write_benchmark_volume(d: str, table: dict, needle_mod) -> float:
    """Volume 1 in `d` before a server starts: LSM map, `table`'s needles
    written in batches of 4,096, then its deletes and its overwrites.
    Returns the write wall."""
    pool, ids, cookies = table["pool"], table["ids"], table["cookies"]
    first_blob, blob_of = table["first_blob"], table["blob_of"]
    crc_of = dict(zip(pool, table["pool_crc"]))
    real_crc = needle_mod.masked_crc
    needle_mod.masked_crc = lambda data: crc_of.get(bytes(data)) or real_crc(data)
    try:
        from seaweedfs_tpu_torch.storage.volume import Volume

        t0 = time.perf_counter()
        v = Volume(d, "", 1, needle_map_kind="lsm")
        for c0 in range(0, SERVER_NEEDLES, 4096):
            for r in v.write_needle_batch([
                needle_mod.Needle(cookie=int(c), id=int(k), data=pool[int(b)])
                for k, c, b in zip(ids[c0:c0 + 4096].tolist(),
                                   cookies[c0:c0 + 4096].tolist(),
                                   first_blob[c0:c0 + 4096].tolist())
            ]):
                if isinstance(r, Exception):
                    fail(f"volume 1 write failed: {r!r}")
        for i in table["deleted_at"].tolist():
            v.delete_needle(needle_mod.Needle(cookie=int(cookies[i]), id=int(ids[i])))
        for r in v.write_needle_batch([
            needle_mod.Needle(cookie=int(cookies[i]), id=int(ids[i]), data=pool[int(blob_of[i])])
            for i in table["rewritten_at"].tolist()
        ]):
            if isinstance(r, Exception):
                fail(f"volume 1 overwrite failed: {r!r}")
        v.close()
        return time.perf_counter() - t0
    finally:
        needle_mod.masked_crc = real_crc


# --- set-up children ---------------------------------------------------------
# Set-up that checks nothing runs in a child of this script (`--prep KIND`)
# beside earlier phases, so the phase that needs it waits only for what is
# left: volume 1 of phases 10-11 is written while phases 7-9 run, and
# phase 13's deletes are made on phase 7's volume while phases 10-12 run.
PREP_S = 600


def prep_main(argv: list) -> int:
    """Child mode of this script (`--prep KIND ...`), printing its result
    as one JSON line.

    volume1 DIR SEED: write_benchmark_volume into DIR, the table drawn
        from SEED as phase 10 draws it
    heal ROOT SEED: write_heal_volumes (17(b)'s EC volume and the two
        holders' copies of its replicated volume) under ROOT
    deletes NPZ SRC COPY: on the volume in SRC (vid, ids, cookies and the
        doomed rows in NPZ) delete all but the last `by_rpc` doomed
        needles, copy the .dat and .idx into COPY (13b's volume), then
        delete the rest"""
    import numpy as np

    sys.path.insert(0, HERE)
    from seaweedfs_tpu_torch.storage import needle as needle_mod

    kind = argv[argv.index("--prep") + 1]
    rest = argv[argv.index("--prep") + 2:]
    if kind == "volume1":
        from seaweedfs_tpu_torch.util import crc as crc_mod

        d, seed = rest[0], int(rest[1])
        os.makedirs(d)
        table = benchmark_volume_table(np.random.default_rng(seed + 10), crc_mod)
        print(json.dumps({"write_s": write_benchmark_volume(d, table, needle_mod)}))
        return 0
    if kind == "heal":
        print(json.dumps(write_heal_volumes(rest[0], int(rest[1]), needle_mod)))
        return 0
    if kind == "deletes":
        from seaweedfs_tpu_torch.storage.volume import Volume

        z = np.load(rest[0])
        src, copy = rest[1], rest[2]
        vid, ids, cookies = int(z["vid"]), z["ids"], z["cookies"]
        doomed, n_rpc = z["doomed"], int(z["by_rpc"])
        t0 = time.perf_counter()
        v = Volume(src, "", vid)
        copy_s = 0.0
        for k, part in enumerate((doomed[:len(doomed) - n_rpc], doomed[len(doomed) - n_rpc:])):
            for i in part.tolist():
                if v.delete_needle(needle_mod.Needle(cookie=int(cookies[i]),
                                                     id=int(ids[i]))) <= 0:
                    fail(f"needle {int(ids[i]):x} was not live")
            if k == 0:
                t1 = time.perf_counter()
                v.sync()  # the files as they stand, for 13b's copy
                os.makedirs(copy)
                for ext in (".dat", ".idx"):
                    shutil.copyfile(os.path.join(src, f"{vid}{ext}"),
                                    os.path.join(copy, f"{vid}{ext}"))
                copy_s = time.perf_counter() - t1
        delete_s = time.perf_counter() - t0 - copy_s
        garbage = v.garbage_level()
        v.close()
        print(json.dumps({"delete_s": delete_s, "copy_s": copy_s, "garbage": garbage}))
        return 0
    fail(f"unknown --prep kind {kind!r}")


PREP_DIR = "prep"  # under the work directory: the set-up children's output


def free_disk(work: str, spare: tuple = ()) -> None:
    """Remove what earlier phases left in `work`, but the set-up
    children's directory and the names in `spare`."""
    for fn in os.listdir(work):
        if fn == PREP_DIR or fn in spare:
            continue
        path = os.path.join(work, fn)
        if os.path.isdir(path):
            shutil.rmtree(path)
        else:
            os.remove(path)


def _start_prep(work: str, kind: str, args: list) -> dict:
    """Start a set-up child; its output goes to files under work/prep."""
    os.makedirs(os.path.join(work, PREP_DIR), exist_ok=True)
    out = os.path.join(work, PREP_DIR, f"{kind}.out")
    err = os.path.join(work, PREP_DIR, f"{kind}.err")
    with open(out, "w") as fo, open(err, "w") as fe:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--prep", kind, *map(str, args)],
            stdout=fo, stderr=fe)
    return {"kind": kind, "proc": proc, "out": out, "err": err,
            "started": time.perf_counter()}


def _await_prep(held: dict) -> dict:
    """Wait for a set-up child; fail if it failed. Its JSON gains
    `wall_s` (since its start) and `waited_s` (how long the phase that
    needs it waited)."""
    t0 = time.perf_counter()
    try:
        rc = held["proc"].wait(timeout=PREP_S)
    except subprocess.TimeoutExpired:
        held["proc"].kill()
        held["proc"].wait()
        fail(f"set-up child {held['kind']} ran over {PREP_S} s")
    waited = time.perf_counter() - t0
    with open(held["out"]) as f:
        out = f.read()
    with open(held["err"]) as f:
        err = f.read()
    os.remove(held["out"])
    os.remove(held["err"])
    if rc != 0:
        fail(f"set-up child {held['kind']} exited {rc}: {(out + err)[-2000:]}")
    res = json.loads(out.strip().splitlines()[-1])
    res.update(wall_s=time.perf_counter() - held["started"], waited_s=waited)
    return res


def plain_on_card_codec(torch):
    """CudaRSCodec whose matrix products run the kernel's plain version on
    the card (the reference an encode through the kernel is held to)."""
    import numpy as np

    from seaweedfs_tpu_torch.ops import gf256 as G
    from seaweedfs_tpu_torch.ops.rs_kernel import CudaRSCodec

    class PlainOnCard(CudaRSCodec):
        def _apply(self, matrix, rows, out=None):
            data = np.stack([np.asarray(r, dtype=np.uint8) for r in rows])
            packed = torch.from_numpy(G.pack_bytes_host(data).view(np.int32)).to(
                self.device)
            res = G.unpack_bytes_host(
                G._gf_matmul_torch_packed(np.asarray(matrix, np.uint8), packed).cpu().numpy(),
                data.shape[1])
            if out is not None:
                out[:] = res
                return out
            return res

    return PlainOnCard()


EC_NAMES = [f".ec{i:02d}" for i in range(14)] + [".ecx"]


def plain_encode_sums(torch, work: str, src_base: str, name: str) -> dict:
    """sha1 of .ec00-.ec13 and .ecx of `src_base`'s .dat/.idx encoded by
    the kernel's plain version on the card (in a scratch directory that
    is removed); fails if the kernel launched meanwhile."""
    from seaweedfs_tpu_torch.ops import gf256 as G
    from seaweedfs_tpu_torch.storage.erasure_coding import encoder as enc

    pd = os.path.join(work, f"plain-{name}")
    os.makedirs(pd)
    try:
        for ext in (".dat", ".idx"):
            os.symlink(src_base + ext, os.path.join(pd, name + ext))
        gf_before = G.KERNEL_LAUNCHES
        enc.write_ec_files(os.path.join(pd, name), codec=plain_on_card_codec(torch))
        enc.write_sorted_file_from_idx(os.path.join(pd, name))
        if G.KERNEL_LAUNCHES != gf_before:
            fail("the plain encode launched the kernel")
        sums = sha1_files([os.path.join(pd, name + e) for e in EC_NAMES])
        return {e: sums[os.path.join(pd, name + e)] for e in EC_NAMES}
    finally:
        shutil.rmtree(pd)


def phase_volume_server(torch, work: str, seed: int, needle_mod, crc_mod,
                        cut_ab_rounds: int = 0, keep: dict | None = None,
                        prepared: dict | None = None) -> dict:
    """The port's volume server, started through the CLI's entry function
    on its own event-loop thread, at `weed benchmark` scale; a load
    client in a child process; EC generate, degraded reads and rebuild
    through the server's RPCs. Every answer is checked. With
    `cut_ab_rounds`, it stops after the warm-up and `_gate_cut_ab`.
    `prepared` is the `--prep volume1` child that is writing volume 1
    into work/server; without it the volume is written here."""
    import asyncio
    import socket

    import numpy as np

    from seaweedfs_tpu_torch.command import cli
    from seaweedfs_tpu_torch.ops import gf256 as G
    from seaweedfs_tpu_torch.ops import index_kernel as IK
    from seaweedfs_tpu_torch.ops import ragged_lookup as RL
    from seaweedfs_tpu_torch.pb import grpc_address
    from seaweedfs_tpu_torch.pb.rpc import Stub
    from seaweedfs_tpu_torch.storage.file_id import FileId

    rng = np.random.default_rng(seed + 10)
    d = os.path.join(work, "server")
    table = benchmark_volume_table(rng, crc_mod)
    if prepared is None:
        os.makedirs(d)
        volume1 = {"write_s": write_benchmark_volume(d, table, needle_mod)}
    else:
        volume1 = dict(_await_prep(prepared), written_by="a child of this script "
                       "(--prep volume1) while phases 7-9 ran")
    pool, pool_crc = table["pool"], table["pool_crc"]
    ids, cookies, blob_of, live1 = (table[k] for k in ("ids", "cookies", "blob_of", "live"))
    if keep is not None:
        # phase 11 serves the same volume: its files as written, linked
        # before this server opens them
        stash = os.path.join(work, "cluster-a")
        os.makedirs(stash)
        for fn in os.listdir(d):
            if fn.startswith("1."):
                os.link(os.path.join(d, fn), os.path.join(stash, fn))
        keep.update(table, dir=stash)

    # start the server through the CLI's entry function
    port = _port_pair(set())
    argv = ["-dir", d, "-port", str(port), "-index", "lsm",
            "-batchLookup", "arena", "-storageBackend", "cuda"]
    t0 = time.perf_counter()
    held = _serve_in_thread(cli.cmd_volume, argv, "volume-server")
    if not held["ready"].wait(SERVER_START_S) or "error" in held:
        fail(f"volume server did not start in {SERVER_START_S} s: {held.get('error')!r}")
    while True:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            break
        except OSError:
            if time.perf_counter() - t0 > SERVER_START_S:
                fail(f"volume server accepts no connection in {SERVER_START_S} s")
            time.sleep(0.05)
    start_s = time.perf_counter() - t0
    vs = held["servers"][0]
    stub = Stub(grpc_address(f"127.0.0.1:{port}"), "volume")

    def rpc(method, req, timeout=300):
        t = time.perf_counter()
        out = asyncio.run(stub.call(method, req, timeout=timeout))
        if isinstance(out, dict) and out.get("error"):
            fail(f"{method}: {out['error']}")
        return out, time.perf_counter() - t

    try:
        # the path: every count at 0 now, read after the rebuild
        G.KERNEL_LAUNCHES = IK.KERNEL_LAUNCHES = RL.KERNEL_LAUNCHES = 0
        rpc("AllocateVolume", {"volume_id": 2})
        # writes: SERVER_WRITES POSTs of 1 KiB into volume 2 at concurrency 16
        ids2 = rng.permutation(np.unique(rng.integers(1 << 48, 1 << 49, size=SERVER_WRITES + 512,
                                                     dtype=np.uint64)))[:SERVER_WRITES]
        cookies2 = rng.integers(1, 1 << 32, size=SERVER_WRITES, dtype=np.uint64)
        blob2 = rng.integers(64, 128, size=SERVER_WRITES)
        fid = lambda vid, k, c: "/" + str(FileId(vid, int(k), int(c)))  # noqa: E731
        base_plan = {"blobs": pool, "etags": [f"{c:08x}" for c in pool_crc]}
        wres = _drive(work, "writes", port, dict(base_plan, requests=[
            ("POST", fid(2, k, c), int(b), 201)
            for k, c, b in zip(ids2.tolist(), cookies2.tolist(), blob2.tolist())
        ]), WRITE_CONCURRENCY, 600)

        # reads over both volumes: 10 % absent, 1 % wrong cookie
        def read_plan(n):
            out = []
            which = rng.random(n)
            pick1 = rng.integers(0, SERVER_NEEDLES, size=n)
            pick2 = rng.integers(0, SERVER_WRITES, size=n)
            absent = rng.integers(1 << 50, 1 << 51, size=n, dtype=np.uint64)
            for j in range(n):
                w = which[j]
                if w < ABSENT_SHARE:
                    out.append(("GET", fid(1 + j % 2, absent[j], 7), -1, 404))
                    continue
                wrong = w < ABSENT_SHARE + WRONG_COOKIE_SHARE
                if w < 0.8:
                    i = int(pick1[j])
                    path = fid(1, ids[i], int(cookies[i]) ^ (1 if wrong else 0))
                    ok = live1[i] and not wrong
                    out.append(("GET", path, int(blob_of[i]) if ok else -1,
                                200 if ok else 404))
                else:
                    i = int(pick2[j])
                    path = fid(2, ids2[i], int(cookies2[i]) ^ (1 if wrong else 0))
                    out.append(("GET", path, -1 if wrong else int(blob2[i]),
                                404 if wrong else 200))
            return out

        # the warm-up: the server's own wakeups find the arena cold, serve
        # from the host maps (counted as fallbacks) and queue its upload;
        # the identity check holds every arena answer to the host map
        vs.lookup_gate.identity_check = True
        before_warm = _http_json(port, "/debug/needle_map")
        warm = _drive(work, "warmup", port, dict(base_plan, requests=read_plan(WARMUP_READS)),
                      WARMUP_CONCURRENCY, 600)
        before = _http_json(port, "/debug/needle_map")
        warm_fallbacks = (before["gate"]["host_fallbacks"]
                          - before_warm["gate"]["host_fallbacks"])
        warm_launches = RL.KERNEL_LAUNCHES
        if cut_ab_rounds:
            res = _gate_cut_ab(work, port, base_plan, read_plan, cut_ab_rounds)
            res["host_fallbacks_in_warmup"] = warm_fallbacks
            emit(res)
            return res
        read_plan_main = read_plan(SERVER_READS)
        rres_on = _drive(work, "reads_identity_on", port,
                         dict(base_plan, requests=read_plan_main),
                         READ_CONCURRENCY, 900)
        mid = _http_json(port, "/debug/needle_map")
        vs.lookup_gate.identity_check = False
        cpu0 = time.process_time()
        rres = _drive(work, "reads", port, dict(base_plan, requests=read_plan_main),
                      READ_CONCURRENCY, 900)
        server_cpu_share = (time.process_time() - cpu0) / rres["wall_s"]
        after = _http_json(port, "/debug/needle_map")
        fallbacks = after["gate"]["host_fallbacks"] - before["gate"]["host_fallbacks"]
        mism = {"identity_on": mid["gate"]["identity_mismatches"]
                - before_warm["gate"]["identity_mismatches"],
                "identity_off": after["gate"]["identity_mismatches"] - mid["gate"]["identity_mismatches"]}
        if fallbacks or after["device"]["errors"] or any(mism.values()) or after["device_errors"]:
            fail(f"reads after warm-up: {fallbacks} host fallbacks, arena errors "
                 f"{after['device']['errors']}, mismatches {mism}, device errors "
                 f"{after['device_errors']}")
        read_launches = RL.KERNEL_LAUNCHES - warm_launches

        # BulkLookup of every key of volume 1 plus 10 % absent
        absent = rng.integers(1 << 50, 1 << 51, size=SERVER_NEEDLES // 10, dtype=np.uint64)
        probes = rng.permutation(np.concatenate([ids, absent]))
        reply, bulk_s = rpc("BulkLookup", {"volume_id": 1, "keys": probes.astype("<u8").tobytes()})
        want = vs.store.find_volume(1).bulk_lookup(probes, use_device=False)
        got = (np.frombuffer(reply["offsets"], dtype=reply["offset_dtype"]),
               np.frombuffer(reply["sizes"], dtype="<u4"),
               np.frombuffer(reply["found"], dtype=np.uint8).astype(bool))
        for j, name in enumerate(("offsets", "sizes", "found")):
            if not np.array_equal(got[j], want[j]):
                bad = int(np.count_nonzero(got[j] != want[j]))
                fail(f"BulkLookup {name} differs from the host map at {bad} probes")
        if int(got[2].sum()) != int(live1.sum()):
            fail(f"BulkLookup finds {int(got[2].sum())}, expected {int(live1.sum())}")

        # EC: generate 10.4 through the server, held to the plain version
        rpc("VolumeMarkReadonly", {"volume_id": 1})
        _, gen_s = rpc("VolumeEcShardsGenerate", {"volume_id": 1})
        base = os.path.join(d, "1")
        shard_paths = [base + f".ec{i:02d}" for i in range(14)]
        t0 = time.perf_counter()
        plain = plain_encode_sums(torch, work, base, "1")
        plain_s = time.perf_counter() - t0
        sums = sha1_files([base + e for e in EC_NAMES])
        for e in EC_NAMES:
            if sums[base + e] != plain[e]:
                fail(f"the server's {e} differs from the plain version's")
        if keep is not None:
            keep["shard_sums"] = plain
        rpc("VolumeEcShardsMount", {"volume_id": 1, "shard_ids": list(range(14))})
        rpc("VolumeDelete", {"volume_id": 1, "keep_ec_files": True})
        if os.path.exists(base + ".dat") or vs.store.find_ec_volume(1) is None:
            fail("VolumeDelete left the .dat or the EC volume is not mounted")
        rpc("VolumeEcShardsUnmount", {"volume_id": 1, "shard_ids": list(EC_LOST)})
        for i in EC_LOST:
            os.remove(shard_paths[i])
        live_idx = np.nonzero(live1)[0]
        sample = rng.choice(live_idx, DEGRADED_GETS, replace=False)
        gf_before = G.KERNEL_LAUNCHES
        dres = _drive(work, "degraded", port, dict(base_plan, requests=[
            ("GET", fid(1, ids[i], cookies[i]), int(blob_of[i]), 200) for i in sample.tolist()
        ]), WRITE_CONCURRENCY, 600)
        degraded_launches = G.KERNEL_LAUNCHES - gf_before
        if degraded_launches <= 0:
            fail("the degraded reads decoded nothing on the card")
        reply, rebuild_s = rpc("VolumeEcShardsRebuild", {"volume_id": 1})
        if reply.get("rebuilt_shard_ids") != list(EC_LOST):
            fail(f"rebuild made {reply}, expected {list(EC_LOST)}")
        got_sums = sha1_files([shard_paths[i] for i in EC_LOST])
        for i in EC_LOST:
            if got_sums[shard_paths[i]] != sums[shard_paths[i]]:
                fail(f"rebuilt shard .ec{i:02d} differs from the generated one")
        launches = {"gf_matmul": G.KERNEL_LAUNCHES, "index_search": IK.KERNEL_LAUNCHES,
                    "ragged_lookup": RL.KERNEL_LAUNCHES}
        status = _http_json(port, "/debug/needle_map")
    finally:
        stop_s = _stop_served(held, SERVER_STOP_S)
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} launched no time through the server")
    res = {
        "phase": "volume_server",
        "argv": argv,
        "cuts": SERVER_CUTS,
        "volume1": {"needles": SERVER_NEEDLES, "deleted": table["deleted"],
                    "overwritten": table["rewritten"], **volume1},
        "server_start_s": start_s,
        "writes": {"requests": SERVER_WRITES, "concurrency": WRITE_CONCURRENCY, **wres},
        "warmup_reads": {"requests": WARMUP_READS, "concurrency": WARMUP_CONCURRENCY,
                         "wall_s": warm["wall_s"], "host_fallbacks": warm_fallbacks,
                         "device_batches": before["gate"]["device_batches"]
                         - before_warm["gate"]["device_batches"]},
        "reads": {"requests": SERVER_READS, "concurrency": READ_CONCURRENCY,
                  "absent_share": ABSENT_SHARE, "wrong_cookie_share": WRONG_COOKIE_SHARE,
                  "identity_check": "off (as a server runs)", **rres,
                  "server_process_cpu_share": server_cpu_share},
        "reads_identity_on": rres_on,
        "gate": after["gate"],
        "gate_batch_hist": after["gate_batch_hist"],
        "host_fallbacks_after_warmup": fallbacks,
        "arena_errors": after["device"]["errors"],
        "identity_mismatches": mism,
        "bulk_lookup": {"probes": len(probes), "absent": len(absent), "wall_s": bulk_s,
                        "probes_per_s": len(probes) / bulk_s, "equal_to_host_map": True},
        "ec": {"generate_s": gen_s, "plain_encode_s": plain_s,
               "shards_and_ecx_equal_to_plain": True, "lost": list(EC_LOST),
               "degraded_gets": DEGRADED_GETS, "degraded": dres,
               "degraded_gf_launches": degraded_launches,
               "rebuild_s": rebuild_s, "rebuilt_identical": True},
        "server_stop_s": stop_s,
        "ragged_lookup_launches": {"warmup": warm_launches, "reads": read_launches},
        "read_batches_on_the_arena": [after["gate"]["device_batches"]
                                      - before["gate"]["device_batches"],
                                      after["gate"]["batches"] - before["gate"]["batches"]],
        "kernel_launches": launches,
        "device_errors": status["device_errors"],
    }
    emit(res)
    return res


# --- phase 11 ----------------------------------------------------------------
CLUSTER_VOLUME_SERVERS = 3  # `volume -mserver` beside the `server`
# -rack of the server, then each volume: one rack each, so once a server
# is lost and its shards rebuilt on one of the three left, that server's
# rack holds at least 6 of A's 14 shards, above ceil(14 / 3) = 5, and
# ec.balance always has a move to make
CLUSTER_RACKS = ("r0", "r1", "r2", "r3")
DECODED_GETS = 2_000  # A's GETs through the normal read path after ec.decode
CLUSTER_SIZE_LIMIT_MB = 1024  # volume A (1,127 MB) is full, as ec.encode wants
BENCH_N = 1 << 14  # weed benchmark -n, cut (CLUSTER_CUTS)
BENCH_C = 16
ASSIGNS = 5_000
REMOTE_GETS = 2_000
CLUSTER_DEGRADED_GETS = 1_000
CLUSTER_ARENA_READS = 25_000  # A's GETs on the server after the arena's warm-up
CLUSTER_CUTS = {
    "benchmark_n": {"from": 1 << 20, "to": BENCH_N,
                    "why": "32,768 before, itself cut from weed benchmark's 1,048,576; "
                           + OVER_LIMIT + ", 43.7 s of it the benchmark at 32,768; the "
                           "master still grows its volumes, and the batched encode still "
                           "takes two of them on one server"},
    "arena_reads": {"from": 50_000, "to": CLUSTER_ARENA_READS,
                    "why": "A's GETs after the warm-up; " + OVER_LIMIT + ", 10.7 s of it "
                           "these GETs; ragged_lookup must still launch in them"},
    "degraded_gets": {"from": 2_000, "to": CLUSTER_DEGRADED_GETS,
                      "why": OVER_LIMIT + ", 21.4 s of it the 2,000 GETs (93 a second, "
                             "each decoding on the card); each still must decode"},
}
EC_DELETES = 100
CLUSTER_START_S = 180
CHILD_S = 900  # deadline of each child process (benchmark, shell)


def _port_cli(args: list, timeout: float = CHILD_S) -> tuple:
    """Run `python -m seaweedfs_tpu_torch ARGS` in a child process; fails
    unless it exits 0. -> (stdout, wall seconds)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "seaweedfs_tpu_torch", *args],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=HERE, env=env)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{args} exited {proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout, wall


def _bench_numbers(section: str) -> dict:
    """Requests, failures, rate and p50/p99 of one benchmark report."""
    out = {}
    for line in section.splitlines():
        line = line.strip()
        if line.startswith("Complete requests:"):
            out["completed"] = int(line.split(":")[1])
        elif line.startswith("Failed requests:"):
            out["failed"] = int(line.split(":")[1])
        elif line.startswith("Requests per second:"):
            out["per_s"] = float(line.split(":")[1].split()[0])
        elif line.startswith("50%"):
            out["p50_ms"] = float(line.split()[1])
        elif line.startswith("99%"):
            out["p99_ms"] = float(line.split()[1])
    return out


def _ec_holders(maddr: str, vid: int, want_shards: int, deadline_s: float) -> dict:
    """{url: [shard ids]} of an EC volume from the master's LookupEcVolume,
    once it knows `want_shards` shards (fails past the deadline)."""
    import asyncio

    from seaweedfs_tpu_torch.pb import grpc_address
    from seaweedfs_tpu_torch.pb.rpc import Stub

    stub = Stub(grpc_address(maddr), "master")
    t0 = time.perf_counter()
    while True:
        r = asyncio.run(stub.call("LookupEcVolume", {"volume_id": vid}))
        held = {}
        for e in r.get("shard_id_locations", []):
            for loc in e["locations"]:
                held.setdefault(loc["url"], []).append(int(e["shard_id"]))
        if sum(len(v) for v in held.values()) == want_shards:
            return held
        if time.perf_counter() - t0 > deadline_s:
            fail(f"ec volume {vid}: the master knows {held}, not {want_shards} shards")
        time.sleep(0.1)


def _assign_rate(maddr: str, n: int, concurrency: int) -> dict:
    """n /dir/assign at `concurrency` over keep-alive connections."""
    import asyncio

    from seaweedfs_tpu_torch.util.fasthttp import FastHTTPClient

    async def run():
        http = FastHTTPClient(pool_per_host=concurrency)
        left = [n]
        bad = []

        async def one():
            while left[0] > 0:
                left[0] -= 1
                st, body = await http.request("GET", maddr, "/dir/assign")
                if st != 200 or b'"fid"' not in body:
                    bad.append((st, body[:120]))

        t0 = time.perf_counter()
        await asyncio.gather(*(one() for _ in range(concurrency)))
        wall = time.perf_counter() - t0
        await http.close()
        return wall, bad

    wall, bad = asyncio.run(run())
    if bad:
        fail(f"/dir/assign: {len(bad)} failed, e.g. {bad[:3]}")
    return {"assigns": n, "concurrency": concurrency, "wall_s": wall, "per_s": n / wall}


def phase_cluster(torch, work: str, seed: int, keep: dict) -> dict:
    """The port's cluster at `weed benchmark` scale: `server` (master +
    volume) and three `volume -mserver` through the CLI's entry functions,
    each on its own event-loop thread; `benchmark` and `shell` as child
    processes. Volume A is phase 10's volume 1 (`keep`). Every answer is
    checked.

    The kernel counts are process-wide: each `launches_by_window` entry
    is what they moved while the script drove one server (the other
    servers then serve only its remote shard reads, which launch no
    kernel), not a count kept by that server."""
    import asyncio

    import numpy as np

    from seaweedfs_tpu_torch.command import cli
    from seaweedfs_tpu_torch.ops import gf256 as G
    from seaweedfs_tpu_torch.ops import index_kernel as IK
    from seaweedfs_tpu_torch.ops import ragged_lookup as RL
    from seaweedfs_tpu_torch.pb import grpc_address
    from seaweedfs_tpu_torch.pb.rpc import Stub
    from seaweedfs_tpu_torch.storage.erasure_coding import encoder as enc
    from seaweedfs_tpu_torch.storage.file_id import FileId

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 11)
    root = os.path.join(work, "cluster")
    dirs = [os.path.join(root, f"d{i}") for i in range(1 + CLUSTER_VOLUME_SERVERS)]
    for d in dirs[1:]:
        os.makedirs(d)
    os.rename(keep["dir"], dirs[0])
    pool, pool_crc = keep["pool"], keep["pool_crc"]
    ids, cookies, blob_of, live = (keep[k] for k in ("ids", "cookies", "blob_of", "live"))
    base_a = os.path.join(dirs[0], "1")
    dat_bytes = os.path.getsize(base_a + ".dat")
    shard_sums = keep["shard_sums"]

    taken: set = set()
    mport = _port_pair(taken)
    maddr = f"127.0.0.1:{mport}"
    vports = [_port_pair(taken) for _ in dirs]
    urls = [f"127.0.0.1:{p}" for p in vports]
    server_argv = ["-ip", "127.0.0.1", "-port", str(mport), "-volumePort", str(vports[0]),
                   "-dir", dirs[0], "-index", "lsm", "-batchLookup", "arena",
                   "-storageBackend", "cuda", "-rack", CLUSTER_RACKS[0],
                   "-volumeSizeLimitMB", str(CLUSTER_SIZE_LIMIT_MB)]
    volume_argv = [["-ip", "127.0.0.1", "-port", str(vports[i]), "-dir", dirs[i],
                    "-mserver", maddr, "-storageBackend", "cuda",
                    "-rack", CLUSTER_RACKS[i]]
                   for i in range(1, len(dirs))]
    rack_of = dict(zip(urls, CLUSTER_RACKS))
    fid = lambda vid, k, c: "/" + str(FileId(vid, int(k), int(c)))  # noqa: E731
    base_plan = {"blobs": pool, "etags": [f"{c:08x}" for c in pool_crc]}
    steps = {}  # window -> {driven url: {kernel: launches in the window}}

    def counts():
        return {"gf_matmul": G.KERNEL_LAUNCHES, "index_search": IK.KERNEL_LAUNCHES,
                "ragged_lookup": RL.KERNEL_LAUNCHES}

    def since(c0):
        c1 = counts()
        return {k: c1[k] - c0[k] for k in c1}

    t0 = time.perf_counter()
    served = [_serve_in_thread(cli.cmd_server, server_argv, "cluster-server")]
    served += [_serve_in_thread(cli.cmd_volume, a, f"cluster-volume-{i + 1}")
               for i, a in enumerate(volume_argv)]
    try:
        for h in served:
            if not h["ready"].wait(CLUSTER_START_S) or "error" in h:
                fail(f"{h['thread'].name} did not start: {h.get('error')!r}")
        while True:
            st = _http_json(mport, "/dir/status")
            nodes = [dn["url"] for dc in st["Topology"]["data_centers"]
                     for rack in dc["racks"] for dn in rack["data_nodes"]]
            if len(nodes) == len(dirs):
                break
            if time.perf_counter() - t0 > CLUSTER_START_S:
                fail(f"the master knows {nodes}, not {len(dirs)} data nodes")
            time.sleep(0.1)
        start_s = time.perf_counter() - t0
        vs_of = {urls[0]: served[0]["servers"][1]}
        vs_of.update({urls[i]: served[i]["servers"][0] for i in range(1, len(dirs))})

        # the path: every count at 0 now, read at the end
        G.KERNEL_LAUNCHES = IK.KERNEL_LAUNCHES = RL.KERNEL_LAUNCHES = 0

        # A's reads on the `server` through its lookup gate: a warm-up in
        # which the server uploads its own arena (its host fallbacks
        # reported), then reads with the identity check on; from the
        # warm-up's end to the phase's, any host fallback fails
        vs0 = vs_of[urls[0]]

        def a_reads(n):
            pick = rng.integers(0, SERVER_NEEDLES, size=n)
            absent = rng.integers(1 << 50, 1 << 51, size=n, dtype=np.uint64)
            miss = rng.random(n) < ABSENT_SHARE
            return [("GET", fid(1, absent[k], 7), -1, 404) if miss[k] else
                    ("GET", fid(1, ids[i], cookies[i]), int(blob_of[i]) if live[i] else -1,
                     200 if live[i] else 404)
                    for k, i in enumerate(pick.tolist())]

        vs0.lookup_gate.identity_check = True
        g_cold = _http_json(vports[0], "/debug/needle_map")["gate"]
        c0 = counts()
        arena_warm = _drive(work, "arena_warmup", vports[0],
                            dict(base_plan, requests=a_reads(WARMUP_READS)),
                            WARMUP_CONCURRENCY, 600)
        g_warm = _http_json(vports[0], "/debug/needle_map")["gate"]
        arena_reads = _drive(work, "arena_reads", vports[0],
                             dict(base_plan, requests=a_reads(CLUSTER_ARENA_READS)),
                             READ_CONCURRENCY, 600)
        vs0.lookup_gate.identity_check = False
        steps["arena_reads_a"] = {urls[0]: since(c0)}
        if steps["arena_reads_a"][urls[0]]["ragged_lookup"] <= 0:
            fail("A's reads on the server launched ragged_lookup no time")
        gate_windows = {"warmup": {k: g_warm[k] - g_cold[k] for k in g_warm}}

        def gate_window(name, g0):
            g1 = _http_json(vports[0], "/debug/needle_map")
            gate_windows[name] = {k: g1["gate"][k] - g0[k] for k in g1["gate"]}
            if gate_windows[name]["host_fallbacks"] or gate_windows[name]["identity_mismatches"] \
                    or g1["device"]["errors"] or any(g1["device_errors"].values()):
                fail(f"the server's gate after warm-up ({name}): {gate_windows[name]}, "
                     f"arena errors {g1['device']['errors']}, device errors {g1['device_errors']}")
            return g1["gate"]

        g_now = gate_window("arena_reads", g_warm)

        # weed benchmark through the master: writes, then reads
        out, bench_wall = _port_cli(["benchmark", "-master", maddr, "-n", str(BENCH_N),
                                     "-size", str(NEEDLE_BYTES), "-c", str(BENCH_C)])
        w_part, _, r_part = out.partition("Randomly Reading Benchmark")
        bench = {"writes": _bench_numbers(w_part), "reads": _bench_numbers(r_part)}
        for k, b in bench.items():
            if b.get("failed") != 0 or b.get("completed") != BENCH_N:
                fail(f"benchmark {k}: {b}")
        assign = _assign_rate(maddr, ASSIGNS, BENCH_C)
        g_now = gate_window("benchmark", g_now)

        # A's pre-encode .dat, kept through a hard link for ec.decode's
        # check, and each live needle's end in it from A's .idx
        a_orig = os.path.join(work, "a_pre_encode.dat")
        os.link(base_a + ".dat", a_orig)
        a_keys, a_ends = _live_ends(base_a)

        # ec.encode of A through the shell, held to the plain version
        c0 = counts()
        out, encode_wall = _port_cli(["shell", "-master", maddr, "lock; ec.encode -volumeId 1"])
        timed = re.search(r"volume 1: encoded, .*; generate_s=([0-9.]+) spread_s=([0-9.]+)", out)
        if not timed:
            fail(f"ec.encode -volumeId 1: {out!r}")
        generate_s, spread_s = float(timed.group(1)), float(timed.group(2))
        kernel_stages = dict(enc.LAST_STAGES)  # the server's write_ec_files of A
        steps["encode_a"] = {urls[0]: since(c0)}
        holders = _ec_holders(maddr, 1, 14, 60)
        spread = sorted(len(v) for v in holders.values())
        if spread != [3, 3, 4, 4]:
            fail(f"A's shards spread {holders}, not 4/4/3/3")
        for url, shard_ids in holders.items():
            d = dirs[urls.index(url)]
            got = sha1_files([os.path.join(d, "1" + e)
                              for e in [f".ec{i:02d}" for i in shard_ids] + [".ecx"]])
            for path, h in got.items():
                if h != shard_sums[path[len(os.path.join(d, "1")):]]:
                    fail(f"{path} differs from the plain version's encode")
        if steps["encode_a"][urls[0]]["gf_matmul"] <= 0:
            fail("A's encode launched gf_matmul no time")

        # index_search: BulkLookup of A's ids on the server's EC shards
        c0 = counts()
        reply = asyncio.run(Stub(grpc_address(urls[0]), "volume").call(
            "BulkLookup", {"volume_id": 1, "keys": ids.astype("<u8").tobytes()}, timeout=300))
        found = np.frombuffer(reply["found"], dtype=np.uint8).astype(bool)
        if not np.array_equal(found, live):
            fail(f"BulkLookup on A's .ecx finds {int(found.sum())}, expected {int(live.sum())}")
        steps["bulk_lookup_a"] = {urls[0]: since(c0)}

        # two benchmark volumes on one server through VolumeEcShardsGenerateBatch
        by_url = {}
        for dc in _http_json(mport, "/dir/status")["Topology"]["data_centers"]:
            for rack in dc["racks"]:
                for dn in rack["data_nodes"]:
                    vids = sorted(int(v["id"]) for v in dn.get("volumes", []) if int(v["id"]) != 1)
                    if len(vids) >= 2:
                        by_url[dn["url"]] = vids
        if not by_url:
            fail("no server holds two benchmark volumes")
        src = sorted(by_url)[0]
        pair = by_url[src][:2]
        sd = dirs[urls.index(src)]
        pair_sums = {}
        for v in pair:
            vd = os.path.join(work, f"pair-{v}")
            os.makedirs(vd)
            for ext in (".dat", ".idx"):
                os.link(os.path.join(sd, f"{v}{ext}"), os.path.join(vd, f"{v}{ext}"))
            pair_sums[v] = plain_encode_sums(torch, work, os.path.join(vd, str(v)), str(v))
            shutil.rmtree(vd)
        c0 = counts()
        out, pair_wall = _port_cli(["shell", "-master", maddr,
                                    f"lock; ec.encode -volumeId {pair[0]},{pair[1]}"])
        steps["encode_pair"] = {src: since(c0)}
        for v in pair:
            if f"volume {v}: encoded" not in out:
                fail(f"ec.encode -volumeId {pair}: {out!r}")
            for url, shard_ids in _ec_holders(maddr, v, 14, 60).items():
                d = dirs[urls.index(url)]
                for e in [f".ec{i:02d}" for i in shard_ids] + [".ecx"]:
                    if sha1_files([os.path.join(d, f"{v}{e}")])[os.path.join(d, f"{v}{e}")] \
                            != pair_sums[v][e]:
                        fail(f"batched encode of volume {v}: {e} differs from the plain version's")
        if steps["encode_pair"][src]["gf_matmul"] <= 0:
            fail("the batched encode launched gf_matmul no time")
        pair_holders = {v: _ec_holders(maddr, v, 14, 60) for v in pair}

        # remote-shard GETs of A over all four servers, 10 % absent
        n_each = REMOTE_GETS // len(urls)
        remote = []
        for j, url in enumerate(urls):
            pick = rng.integers(0, SERVER_NEEDLES, size=n_each)
            absent = rng.integers(1 << 50, 1 << 51, size=n_each, dtype=np.uint64)
            reqs = []
            for k in range(n_each):
                if rng.random() < ABSENT_SHARE:
                    reqs.append(("GET", fid(1, absent[k], 7), -1, 404))
                    continue
                i = int(pick[k])
                ok = bool(live[i])
                reqs.append(("GET", fid(1, ids[i], cookies[i]),
                             int(blob_of[i]) if ok else -1, 200 if ok else 404))
            c0 = counts()
            remote.append(_drive(work, f"remote{j}", vports[j],
                                 dict(base_plan, requests=reqs), BENCH_C, 600))
            if since(c0)["gf_matmul"]:
                fail(f"healthy GETs on {url} decoded on the card")
        remote_wall = sum(r["wall_s"] for r in remote)
        g_now = gate_window("remote_gets", g_now)

        # the outage: stop a server (not the master's) that holds shards of
        # A and of both batched volumes, 4 of A's where one does
        cands = sorted((-len(holders.get(u, [])), u) for u in urls[1:]
                       if u in holders and all(u in pair_holders[v] for v in pair))
        if not cands:
            fail(f"no volume server holds shards of A and of {pair}: {holders}, {pair_holders}")
        victim = cands[0][1]
        vi = urls.index(victim)
        lost = sorted(holders[victim])
        lost_sums = sha1_files([os.path.join(dirs[vi], f"1.ec{i:02d}") for i in lost])
        pair_lost = {v: sorted(pair_holders[v][victim]) for v in pair}
        outage_stop_s = _stop_served(served[vi], SERVER_STOP_S)
        t1 = time.perf_counter()
        while True:
            st = _http_json(mport, "/dir/status")
            nodes = [dn["url"] for dc in st["Topology"]["data_centers"]
                     for rack in dc["racks"] for dn in rack["data_nodes"]]
            if victim not in nodes:
                break
            if time.perf_counter() - t1 > 30:
                fail(f"the master still lists {victim} after its stop")
            time.sleep(0.1)
        readers = [u for u in urls if u != victim]
        sample = rng.choice(np.nonzero(live)[0], CLUSTER_DEGRADED_GETS, replace=False)
        degraded = {}
        steps["degraded"] = {}
        for j, url in enumerate(readers):
            part = sample[j::len(readers)]
            c0 = counts()
            degraded[url] = _drive(work, f"degraded{j}", vports[urls.index(url)], dict(
                base_plan, requests=[("GET", fid(1, ids[i], cookies[i]), int(blob_of[i]), 200)
                                     for i in part.tolist()]), BENCH_C, 600)
            steps["degraded"][url] = since(c0)
            if steps["degraded"][url]["gf_matmul"] <= 0:
                fail(f"degraded GETs on {url} decoded nothing on the card")
        degraded_wall = sum(r["wall_s"] for r in degraded.values())

        # ec.rebuild through the shell: ONE VolumeEcShardsRebuildBatch to the
        # rebuilder for A and the pair, each RPC's launches counted inside
        # it (the other servers are idle meanwhile); the lost shards come
        # back identical
        batch_calls, single_calls = [], []

        def counted_rpc(url, method, calls):
            vs = vs_of[url]
            key = f"/volume/{method}"
            kind, real = vs._rpc_server._routes[key]

            async def wrapper(req, context):
                n0 = G.KERNEL_LAUNCHES
                try:
                    return await real(req, context)
                finally:
                    calls.append({"on": url, "volume_ids": sorted(
                        int(v) for v in req.get("volume_ids", [req.get("volume_id")])),
                        "gf_matmul": G.KERNEL_LAUNCHES - n0})

            vs._rpc_server._routes[key] = (kind, wrapper)
            return key, (kind, real)

        restore = []
        for url in readers:
            restore.append((url, *counted_rpc(url, "VolumeEcShardsRebuildBatch", batch_calls)))
            restore.append((url, *counted_rpc(url, "VolumeEcShardsRebuild", single_calls)))
        c0 = counts()
        try:
            out, rebuild_wall = _port_cli(["shell", "-master", maddr, "lock; ec.rebuild"])
        finally:
            for url, key, route in restore:
                vs_of[url]._rpc_server._routes[key] = route
        rebuilt_on = {}
        for line in out.splitlines():
            m = re.match(r"volume (\d+): rebuilt shards \[([0-9, ]*)\] on (\S+)", line)
            if m:
                rebuilt_on[int(m.group(1))] = m.group(3)
        if sorted(rebuilt_on) != sorted([1, *pair]) or len(set(rebuilt_on.values())) != 1:
            fail(f"ec.rebuild: {out!r}")
        rebuilder = rebuilt_on[1]
        if rebuilder not in readers:
            fail(f"ec.rebuild rebuilt on {rebuilder}, not a live server")
        steps["rebuild"] = {rebuilder: since(c0)}
        if len(batch_calls) != 1 or batch_calls[0]["volume_ids"] != sorted([1, *pair]) \
                or single_calls:
            fail(f"ec.rebuild sent {batch_calls} batch and {single_calls} single RPCs")
        if steps["rebuild"][rebuilder]["gf_matmul"] <= 0:
            fail("ec.rebuild launched gf_matmul no time")
        if vs_of[rebuilder].device_errors.get("ec_rebuild_batch"):
            fail(f"the batch rebuild was retried volume by volume: "
                 f"{vs_of[rebuilder].device_errors}")
        rd = dirs[urls.index(rebuilder)]
        got = sha1_files([os.path.join(rd, f"1.ec{i:02d}") for i in lost])
        for i in lost:
            if got[os.path.join(rd, f"1.ec{i:02d}")] != lost_sums[
                    os.path.join(dirs[vi], f"1.ec{i:02d}")]:
                fail(f"rebuilt .ec{i:02d} differs from the lost one")
        for v in pair:
            for i in pair_lost[v]:
                path = os.path.join(rd, f"{v}.ec{i:02d}")
                if sha1_files([path])[path] != pair_sums[v][f".ec{i:02d}"]:
                    fail(f"rebuilt {v}.ec{i:02d} differs from the plain version's")
        # the launches one RPC per volume would have made: each volume's
        # rounds of DEFAULT_CHUNK, one launch per 4 rebuilt rows; volumes
        # that lost the same shards at the same round width share launches
        per_volume = {}
        shapes = {}
        for v, miss in [(1, lost)] + [(v, pair_lost[v]) for v in pair]:
            size = os.path.getsize(os.path.join(rd, f"{v}.ec{miss[0]:02d}"))
            rounds = -(-size // enc.DEFAULT_CHUNK)
            per_volume[v] = rounds * -(-len(miss) // G.kernel_limits()[2])
            widths = {min(enc.DEFAULT_CHUNK, size - r * enc.DEFAULT_CHUNK)
                      for r in range(rounds)}
            shapes[v] = (tuple(miss), widths)
        shared = any(shapes[a][0] == shapes[b][0] and shapes[a][1] & shapes[b][1]
                     for a in shapes for b in shapes if a < b)
        batch_launches = batch_calls[0]["gf_matmul"]
        if batch_launches > sum(per_volume.values()) or (
                shared and batch_launches >= sum(per_volume.values())):
            fail(f"the batch rebuild launched {batch_launches} times against "
                 f"{per_volume} per volume (shared matrix and width: {shared})")
        for v in (1, *pair):
            _ec_holders(maddr, v, 14, 60)

        # EC deletes: each then answers 404 from every live server
        doomed = rng.choice(np.nonzero(live)[0], EC_DELETES, replace=False)
        paths = [fid(1, ids[i], cookies[i]) for i in doomed.tolist()]
        for j, url in enumerate(readers):
            _drive(work, f"delete{j}", vports[urls.index(url)], dict(
                base_plan, requests=[("DELETE", p, -1, 202) for p in paths[j::len(readers)]]),
                BENCH_C, 600)
        for j, url in enumerate(readers):
            _drive(work, f"deleted{j}", vports[urls.index(url)], dict(
                base_plan, requests=[("GET", p, -1, 404) for p in paths]), BENCH_C, 600)

        # ec.balance over the live servers: A's shards even out over their
        # three racks
        c0 = counts()
        out, balance_wall = _port_cli(["shell", "-master", maddr, "lock; ec.balance"])
        moves = [ln for ln in out.splitlines() if "moved shard" in ln]
        dropped = [ln for ln in out.splitlines() if "dropped duplicate" in ln]
        if not moves:
            fail(f"ec.balance moved nothing: {out!r}")
        steps["balance"] = {readers[0]: since(c0)}
        # the master learns of each move's copy and delete a pulse apart:
        # wait until what it lists is what the live servers' disks hold
        t1 = time.perf_counter()
        while True:
            holders = _ec_holders(maddr, 1, 14, 60)
            on_disk = {u: sorted(int(f[4:6]) for f in os.listdir(dirs[urls.index(u)])
                                 if re.fullmatch(r"1\.ec\d\d", f)) for u in readers}
            per_rack = {}
            for u, sids in holders.items():
                per_rack[rack_of[u]] = per_rack.get(rack_of[u], 0) + len(sids)
            if max(per_rack.values()) <= -(-14 // len(readers)) and all(
                    sorted(holders.get(u, [])) == on_disk[u] for u in readers):
                break
            if time.perf_counter() - t1 > 30:
                fail(f"A's shards per rack after ec.balance: {per_rack} ({holders}; "
                     f"on disk {on_disk})")
            time.sleep(0.1)
        for url, shard_ids in holders.items():
            d = dirs[urls.index(url)]
            got = sha1_files([os.path.join(d, f"1.ec{i:02d}") for i in shard_ids])
            for path, h in got.items():
                if h != shard_sums[path[len(os.path.join(d, "1")):]]:
                    fail(f"{path} differs from the plain version's encode after ec.balance")

        # ec.decode of A: a normal volume again, on one server
        c0 = counts()
        out, decode_wall = _port_cli(["shell", "-master", maddr,
                                      "lock; ec.decode -volumeId 1"])
        m = re.search(r"ec volume 1 decoded back to a normal volume on (\S+)", out)
        if not m or m.group(1) not in readers:
            fail(f"ec.decode -volumeId 1: {out!r}")
        decoded_on = m.group(1)
        steps["decode"] = {decoded_on: since(c0)}
        t1 = time.perf_counter()
        while True:
            look = _http_json(mport, "/dir/lookup?volumeId=1")
            ec_left = asyncio.run(Stub(grpc_address(maddr), "master").call(
                "LookupEcVolume", {"volume_id": 1}))
            locs = [loc["url"] for loc in look.get("locations", [])]
            if locs == [decoded_on] and not ec_left.get("shard_id_locations"):
                break
            if time.perf_counter() - t1 > 30:
                fail(f"after ec.decode the master has {look} and EC {ec_left}")
            time.sleep(0.1)
        for url in readers:
            d = dirs[urls.index(url)]
            left = [f for f in os.listdir(d) if f.startswith("1.ec")]
            if left:
                fail(f"{url} keeps {left} after ec.decode")
        dd = dirs[urls.index(decoded_on)]
        # find_dat_file_size over the pre-encode index less the needles
        # deleted while A was EC: the decoded .dat has exactly that many bytes
        dat_size = int(a_ends[~np.isin(a_keys, ids[doomed])].max())
        got_size = os.path.getsize(os.path.join(dd, "1.dat"))
        if got_size != dat_size:
            fail(f"A's decoded .dat has {got_size} bytes, its pre-encode index "
                 f"less the deletions gives {dat_size}")
        if _hash_prefix(os.path.join(dd, "1.dat"), dat_size) != _hash_prefix(a_orig, dat_size):
            fail("A's decoded .dat differs from its pre-encode .dat")
        os.remove(a_orig)
        deleted_now = set(doomed.tolist())
        pick = rng.choice(np.array([i for i in np.nonzero(live)[0] if i not in deleted_now]),
                          DECODED_GETS, replace=False)
        decoded_reads = _drive(work, "decoded", vports[urls.index(decoded_on)], dict(
            base_plan, requests=[("GET", fid(1, ids[i], cookies[i]), int(blob_of[i]), 200)
                                 for i in pick.tolist()]
            + [("GET", p, -1, 404) for p in paths]), BENCH_C, 600)

        device_errors = {u: dict(vs_of[u].device_errors) for u in readers}
        if any(device_errors.values()):
            fail(f"device errors in the cluster: {device_errors}")
        gate_window("to_the_end", g_now)
        launches = counts()
    finally:
        stop_s = {}
        for h, url in zip(served, urls):
            if h["thread"].is_alive():
                stop_s[url] = _stop_served(h, SERVER_STOP_S)
    by_driven = {u: {"gf_matmul": 0, "index_search": 0, "ragged_lookup": 0} for u in urls}
    for by_url in steps.values():
        for u, c in by_url.items():
            for k, n in c.items():
                by_driven[u][k] += n
    res = {
        "phase": "cluster",
        "cuts": CLUSTER_CUTS,
        "device": {"nvidia_smi": nvidia_smi("name,power.limit")},
        "server_argv": server_argv,
        "volume_argv": volume_argv,
        "volume_a": {"needles": SERVER_NEEDLES, "dat_bytes": dat_bytes,
                     "from_phase_10": bool(keep)},
        "cluster_start_s": start_s,
        "arena_reads_a": {
            "warmup": {"requests": WARMUP_READS, "concurrency": WARMUP_CONCURRENCY,
                       "wall_s": arena_warm["wall_s"],
                       "host_fallbacks": gate_windows["warmup"]["host_fallbacks"]},
            "reads": {"requests": CLUSTER_ARENA_READS, "concurrency": READ_CONCURRENCY,
                      "identity_check": True, "wall_s": arena_reads["wall_s"],
                      "per_s": CLUSTER_ARENA_READS / arena_reads["wall_s"],
                      "p50_ms": arena_reads["p50_ms"], "p99_ms": arena_reads["p99_ms"]}},
        "gate_windows_on_server": gate_windows,
        "benchmark": {"n": BENCH_N, "size": NEEDLE_BYTES, "c": BENCH_C,
                      "cut_from_n": 1 << 20, "wall_s": bench_wall, **bench},
        "assign": assign,
        "ec_encode_a": {"shell_wall_s": encode_wall,
                        "generate_s": generate_s, "spread_s": spread_s,
                        "timed_by": "the shell: its VolumeEcShardsGenerate call, then "
                                    "the copies, mounts and the source's deletes",
                        "server_write_ec_files_s": kernel_stages.get("total_s"),
                        "spread": {u: sorted(s) for u, s in holders.items()},
                        "shards_and_ecx_equal_to_plain": True},
        "ec_encode_batch": {"volumes": pair, "server": src, "shell_wall_s": pair_wall,
                            "equal_to_plain": True},
        "remote_gets": {"requests": REMOTE_GETS, "absent_share": ABSENT_SHARE,
                        "wall_s": remote_wall, "per_s": n_each * len(urls) / remote_wall,
                        "p99_ms": max(r["p99_ms"] for r in remote)},
        "outage": {"stopped": victim, "lost": lost, "stop_s": outage_stop_s},
        "degraded_gets": {"requests": CLUSTER_DEGRADED_GETS, "concurrency": BENCH_C,
                          "wall_s": degraded_wall,
                          "per_s": CLUSTER_DEGRADED_GETS / degraded_wall,
                          "p99_ms": max(r["p99_ms"] for r in degraded.values())},
        "ec_rebuild": {"shell_wall_s": rebuild_wall, "on": rebuilder,
                       "volumes": sorted(rebuilt_on), "rebuilt_identical": True,
                       "rebuild_batch_rpcs": batch_calls,
                       "rebuild_single_rpcs": len(single_calls),
                       "batch_gf_matmul_launches": batch_launches,
                       "per_volume_rpc_launches": per_volume,
                       "lost": {"1": lost, **{str(v): pair_lost[v] for v in pair}},
                       "shared_matrix_and_width": shared,
                       "batch_retries": vs_of[rebuilder].device_errors.get(
                           "ec_rebuild_batch", 0)},
        "ec_balance": {"shell_wall_s": balance_wall, "racks": rack_of,
                       "moves": len(moves), "dropped_duplicates": len(dropped),
                       "a_per_rack": per_rack, "shards_equal_to_plain": True},
        "ec_decode_a": {"shell_wall_s": decode_wall, "on": decoded_on,
                        "dat_bytes": dat_size, "dat_equal_to_pre_encode": True,
                        "master_ec_locations": 0,
                        "shards_left_on_live_servers": 0,
                        "gets": DECODED_GETS, "gets_wall_s": decoded_reads["wall_s"],
                        "gets_per_s": (DECODED_GETS + EC_DELETES) / decoded_reads["wall_s"],
                        "deleted_while_ec_404": EC_DELETES},
        "ec_deletes": {"needles": EC_DELETES, "404_on": readers},
        "stop_s": stop_s,
        "launches_by_window": steps,
        "launches_in_windows_driving": by_driven,
        "launches_note": "windows of the process-wide counters, each while "
                         "the script drove the server named",
        "kernel_launches": launches,
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(res)
    return res


# --- after phase 6: the mesh rebuild and the decode of the phase-3 volume ---
def _live_ends(base: str):
    """A volume's live needles from its .idx (each key's newest entry
    wins, tombstones drop out): their keys and the end of each record in
    the .dat, the ends find_dat_file_size takes the largest of."""
    import numpy as np

    from seaweedfs_tpu_torch.storage import idx as idx_mod
    from seaweedfs_tpu_torch.storage.needle import get_actual_size
    from seaweedfs_tpu_torch.types import to_actual_offset

    with open(base + ".idx", "rb") as f:
        data = f.read()
    with open(base + ".dat", "rb") as f:
        version = f.read(1)[0]
    usable = len(data) - len(data) % idx_mod.NEEDLE_MAP_ENTRY_SIZE
    keys, offs, sizes = idx_mod.fold_live_columns(*idx_mod.parse_index_bytes(data[:usable]))
    ends = np.array([to_actual_offset(o) + get_actual_size(z, version)
                     for o, z in zip(offs.tolist(), sizes.tolist())], dtype=np.int64)
    return keys, ends


def _hash_prefix(path: str, n: int) -> str:
    """A digest of the first n bytes of a file (fails when it is
    shorter): the sha1 of the sha1s of its 1 GiB pieces, hashed on 8
    threads."""
    import concurrent.futures as cf

    def piece(start: int) -> bytes:
        h = hashlib.sha1()
        with open(path, "rb") as f:
            f.seek(start)
            left = min(GIB, n - start)
            while left:
                b = f.read(min(16 * MIB, left))
                if not b:
                    fail(f"{path} ends before {n} bytes")
                h.update(b)
                left -= len(b)
        return h.digest()

    with cf.ThreadPoolExecutor(8) as pool:
        return hashlib.sha1(b"".join(pool.map(piece, range(0, n, GIB)))).hexdigest()


def phase_mesh_rebuild_and_decode(torch, base: str, codec, want: dict,
                                  original: dict) -> dict:
    """The phase-3 volume (shards 1, 5, 11, 12 gone after phase 6) through
    rebuild_ec_files_multi on a 1x1 mesh of cuda:0, then with shards 0, 7,
    10, 13 removed again on a 2x2 grid of cuda:0 (one card split into four
    blocks, one stream each); every shard must hash as phase 4's. Then the
    decode back to a volume: find_dat_file_size, write_dat_file (10 large
    blocks of 1 GiB, then small ones), write_idx_file_from_ec_index; the
    .dat must hash as the original's first dat_size bytes (`original`,
    hashed in phase 3; the original is removed first, so the decode needs
    no more disk than the encode did) and the .idx equal the .ecx (no
    .ecj: nothing was deleted)."""
    from seaweedfs_tpu_torch.ops import gf256 as G
    from seaweedfs_tpu_torch.parallel import make_mesh
    from seaweedfs_tpu_torch.storage.erasure_coding import encoder as enc
    from seaweedfs_tpu_torch.storage.erasure_coding import to_ext

    cuda0 = torch.device("cuda", 0)
    meshes = {"1x1": make_mesh(devices=[cuda0]),
              "2x2": make_mesh(devices=[cuda0] * 4)}
    lost_by = {"1x1": list(DEGRADED_LOST), "2x2": list(REBUILD_LOST)}
    launches = {}
    walls = {}
    for name, mesh in meshes.items():
        for i in lost_by[name]:
            if os.path.exists(base + to_ext(i)):
                os.remove(base + to_ext(i))
        G.KERNEL_LAUNCHES = 0
        t0 = time.perf_counter()
        res = enc.rebuild_ec_files_multi([base], codec=codec, mesh=mesh)
        walls[name] = time.perf_counter() - t0
        launches[name] = G.KERNEL_LAUNCHES
        if res != {base: lost_by[name]}:
            fail(f"mesh rebuild ({name}) made {res}, expected {lost_by[name]}")
        paths = [base + to_ext(i) for i in lost_by[name]]
        got = sha1_files(paths)
        for path in paths:
            if got[path] != want[path]:
                fail(f"mesh rebuild ({name}): {path} differs from the encoded shard")
        if launches[name] <= 0:
            fail(f"mesh rebuild ({name}) launched gf_matmul no time")
    shard_bytes = os.path.getsize(base + to_ext(0))

    os.remove(base + ".dat")
    os.remove(base + ".idx")
    G.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    dat_size = enc.find_dat_file_size(base)
    size_s = time.perf_counter() - t0
    enc.write_dat_file(base, dat_size)
    dat_s = time.perf_counter() - t0 - size_s
    enc.write_idx_file_from_ec_index(base)
    decode_s = time.perf_counter() - t0
    decode_launches = G.KERNEL_LAUNCHES
    if (os.path.getsize(base + ".dat"), dat_size) != (dat_size, original["dat_size"]):
        fail(f"the decoded .dat has {os.path.getsize(base + '.dat')} bytes, "
             f"find_dat_file_size {dat_size}, in phase 3 {original['dat_size']}")
    t0 = time.perf_counter()
    h_new = _hash_prefix(base + ".dat", dat_size)
    hash_s = time.perf_counter() - t0
    if h_new != original["sha1"]:
        fail("the decoded .dat differs from the original's first dat_size bytes")
    with open(base + ".idx", "rb") as f1, open(base + ".ecx", "rb") as f2:
        if f1.read() != f2.read():
            fail("the decoded .idx differs from the .ecx (no .ecj to append)")
    res = {
        "phase": "mesh_rebuild_and_decode",
        "mesh_rebuild": {
            name: {"mesh": repr(meshes[name]), "lost": lost_by[name],
                   "wall_s": walls[name],
                   "GBps": 10 * shard_bytes / walls[name] / 1e9,
                   "gf_matmul_launches": launches[name], "identical": True}
            for name in meshes},
        "mesh_note": "one card: the 2x2 grid repeats cuda:0, four blocks on four streams",
        "decode": {"dat_bytes": dat_size,
                   "original_bytes": original["bytes"],
                   "large_rows": dat_size // (10 * GIB),
                   "find_dat_file_size_s": size_s, "write_dat_file_s": dat_s,
                   "write_dat_file_GBps": dat_size / dat_s / 1e9,
                   "total_s": decode_s, "hash_s": hash_s,
                   "dat_equal_to_original_prefix": True, "idx_equal_to_ecx": True,
                   "gf_matmul_launches": decode_launches},
    }
    emit(res)
    return res


# --- phase 12 ----------------------------------------------------------------
MESH_VOLUMES = 5  # an uneven V over the 2x2 grid's vol axis of 2
MESH_SHARD_BYTES = 16 * MIB  # each of the 10 data rows of a volume
MESH_RAGGED = MIB + 13  # sharded_reconstruct_padded's ragged byte width
MESH_LOST = [2, 12]  # one data and one parity shard, as the JAX dryrun
MESH_EXTRA_PROBES = 3  # 10,000,003 probes: uneven over 4 places
DENSE_ROWS = 2_200_000  # search_tables' sequential keys


def search_tables(np, rng) -> dict:
    """Tables the mesh lookup's kernels are held to their plain versions on
    beside the edge tables (the same as tests/test_torch_mesh_search.py's):
    a run of 400 duplicates, a skewed table whose widest bucket holds 300
    rows, and sequential keys, as the sequencer hands out file ids, for a
    2,200,000-needle volume (about one bucket a row, the upper half of the
    table empty); offsets and sizes drawn from `rng`, probes of every key,
    its neighbours, 0, 2^63 and 2^64 - 1."""
    dup = np.cumsum(np.random.default_rng(1).integers(1, 9, size=6000, dtype=np.uint64))
    dup[2000:2400] = dup[2000]
    tables = {
        "duplicates": np.sort(dup).astype(np.uint64),
        "skewed": np.concatenate([
            np.arange(4096, dtype=np.uint64) * np.uint64(1 << 20),
            np.uint64(1 << 33) + np.arange(300, dtype=np.uint64)]),
        "sequential": np.uint64(1 << 20) + np.arange(DENSE_ROWS, dtype=np.uint64),
    }
    out = {}
    for name, keys in tables.items():
        offs = rng.integers(1, 1 << 32, size=len(keys), dtype=np.uint64).astype(np.uint32)
        sizes = rng.integers(1, 1 << 32, size=len(keys), dtype=np.uint64).astype(np.uint32)
        probes = np.concatenate([keys, keys + np.uint64(1), keys - np.uint64(1),
                                 np.asarray([0, 1 << 63, (1 << 64) - 1], dtype=np.uint64)])
        out[name] = (keys, offs, sizes, probes)
    return out


def _buckets_against_plain(torch, np, snap, kmin: int, kmax: int, pk, host_keys=None) -> dict:
    """index_buckets (A) and bucket_search (B) on a snapshot's rows at the
    geometry the mesh lookup gives its table, against their plain versions
    on the card and K1's whole-table search; with `host_keys`, A's table
    also against numpy's searchsorted. Launches here are comparisons."""
    from seaweedfs_tpu_torch.ops import bucket_search as BS
    from seaweedfs_tpu_torch.ops import index_kernel as IK

    dev = snap.rows.device
    nb = BS.table_buckets(snap.n, dev)
    bstep = BS.bucket_step(kmin, kmax, nb)
    starts, max_rows = BS._index_buckets_cuda(snap.rows, kmin, bstep, nb)
    pstarts, prows = BS._index_buckets_torch(snap.keys ^ IK._SIGN, kmin, bstep, nb)
    err = int((starts.long() - pstarts.long()).abs().max())
    err = max(err, abs(int(max_rows) - prows))
    if err:
        fail(f"index_buckets != the plain version ({snap.n} rows): max |diff| {err}")
    if host_keys is not None:
        bounds = np.uint64(kmin) + np.arange(nb, dtype=np.uint64) * np.uint64(bstep)
        if not np.array_equal(starts.cpu().numpy(),
                              np.append(np.searchsorted(host_keys, bounds), snap.n)):
            fail(f"index_buckets != numpy searchsorted ({snap.n} rows)")
    try:
        got = BS._bucket_search_cuda(snap.rows, starts, kmin, bstep, nb, pk)
        plain = BS._bucket_search_torch(BS.search_steps(prows), snap.keys, snap.offsets,
                                        snap.sizes, pstarts, kmin, bstep, nb, pk)
        whole = IK._index_search_cuda(snap.rows, None, 0, 1, 0, pk)
        torch.cuda.synchronize()
    finally:
        BS.release_l2(dev)
    for what, want in (("the plain version", plain), ("K1 over the whole table", whole)):
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                and torch.equal(got[2].bool(), want[2].bool())):
            fail(f"bucket_search != {what} ({snap.n} rows)")
    return {"nb": nb, "bstep": bstep, "max_rows": prows, "starts_err": err,
            "search_err": max_abs_diff(torch, zip(got[:2], plain[:2]))}


def _bucket_sector_bytes(torch, rows_lo, rows_hi, n: int) -> tuple:
    """Bytes of the 32-byte sectors (two 16-byte rows each) that the row
    ranges [lo, hi) cover: the distinct ones, each counted once, and every
    range's own, summed."""
    keep = rows_hi > rows_lo
    first = rows_lo[keep] // 2
    last = (rows_hi[keep] - 1) // 2
    s = (n + 1) // 2
    edge = torch.zeros(s + 1, dtype=torch.int32, device=rows_lo.device)
    ones = torch.ones(first.shape[0], dtype=torch.int32, device=rows_lo.device)
    edge.index_add_(0, first, ones)
    edge.index_add_(0, last + 1, -ones)
    distinct = int((torch.cumsum(edge, 0)[:s] > 0).sum()) * 32
    return distinct, int((last - first + 1).sum()) * 32


def _second_trips(torch, pk, snap, lower) -> int:
    """Probes whose lower bound `lower` lies outside the group of 4 rows
    that bucket_search loads first (the same guess in float64), so that
    the kernel bisects a side of the bucket after it."""
    from seaweedfs_tpu_torch.ops import bucket_search as BS
    from seaweedfs_tpu_torch.ops import index_kernel as IK

    bucket = BS._bucket_torch(pk, snap.kmin, snap.bstep, snap.nb)
    lo = snap.starts[bucket].long()
    hi = snap.starts[bucket + 1].long()
    # the key's place in its bucket, as the kernel's u64 arithmetic gives it
    q = torch.clamp(pk ^ IK._SIGN, min=snap.kmin - (1 << 63)) ^ IK._SIGN
    kmin = snap.kmin - (1 << 64) if snap.kmin >= 1 << 63 else snap.kmin
    off = q - kmin - bucket * snap.bstep  # u64 bits, wraps
    place = off.double() + torch.where(off < 0, 2.0 ** 64, 0.0)
    rows_in = hi - lo
    guess = lo + torch.minimum((rows_in - 1).double(),
                               place / snap.bstep * rows_in.double()).long()
    g0 = guess & ~3
    start, end = torch.maximum(g0, lo), torch.minimum(g0 + 4, hi)
    left = (lower <= start) & (start > lo)
    right = (lower >= end) & (end < hi)
    return int(((rows_in > 0) & (left | right)).sum())


def _mesh_lookup_kernels(torch, np, meshes: dict, keys, offs, sizes, probes,
                         edges: dict, seed: int) -> dict:
    """The mesh lookup's kernels held to their plain versions on phase 8's
    table, on every edge table and on search_tables, then timed with CUDA
    events on phase 8's table: A per replica (and on the sequential keys),
    B on each mesh and with and without the L2 window, K1's bisection over
    A's table (the route without B) and over the whole table (the mesh
    lookup before this pair), the plain versions and the library calls;
    with A's and B's bounds."""
    from seaweedfs_tpu_torch.ops import bucket_search as BS
    from seaweedfs_tpu_torch.ops import index_kernel as IK
    from seaweedfs_tpu_torch.parallel.sharded_lookup import replicate_index, search_blocks

    cuda0 = torch.device("cuda", 0)
    checks = {}
    tables = {**edges, **search_tables(np, np.random.default_rng(seed + 122))}
    for name, (k, of, sz, pr) in tables.items():
        snap = IK.IndexSnapshot.from_columns(k, of, sz, None, 0, 1, 0, 0, device=cuda0)
        pk = torch.from_numpy(pr.view(np.int64)).to(cuda0)
        checks[name] = _buckets_against_plain(torch, np, snap, int(k[0]), int(k[-1]),
                                              pk, host_keys=k)
        if name == "sequential":
            checks[name]["index_buckets_ms"] = cuda_median_ms(torch, lambda: BS._index_buckets_cuda(
                snap.rows, int(k[0]), checks[name]["bstep"], checks[name]["nb"]), 10)
        del snap, pk
    reps = replicate_index(keys, offs, sizes, meshes["1x1"])  # one table: both meshes are cuda:0
    snap = reps[cuda0]
    if snap.starts is None:
        fail("phase 8's table was not bucketed")
    pad = (-len(probes)) % 4
    pk = torch.from_numpy(np.concatenate([probes, np.zeros(pad, np.uint64)]).view(np.int64)
                          ).to(cuda0)
    kmin, kmax = int(keys[0]), int(keys[-1])
    check = _buckets_against_plain(torch, np, snap, kmin, kmax, pk)
    if (check["nb"], check["bstep"]) != (snap.nb, snap.bstep):
        fail("the replica's geometry differs from the card's rule")
    a_starts, _rows = BS._index_buckets_cuda(snap.rows, snap.kmin, snap.bstep, snap.nb)
    if not torch.equal(a_starts, snap.starts):
        fail("the replica's table differs from a second index_buckets run")
    del a_starts, _rows
    persist, window = BS.l2_limits(cuda0)

    # times: B through search_blocks on each mesh, then alone with and
    # without the window, and K1 over the same table (the persisting lines
    # released before each)
    b_ms = {}
    for name, mesh in meshes.items():
        b_ms[name] = cuda_median_ms(torch, lambda: search_blocks(reps, pk, mesh), 10)
    args = (snap.rows, snap.starts, snap.kmin, snap.bstep, snap.nb, pk)
    window_ms, no_window_ms, k1_on_a_ms = [], [], []
    for _ in range(2):
        BS.release_l2(cuda0)
        no_window_ms.append(cuda_median_ms(
            torch, lambda: BS._bucket_search_cuda(*args, l2_window=False), 10))
        k1_on_a_ms.append(cuda_median_ms(torch, lambda: IK._index_search_cuda(*args), 10))
        window_ms.append(cuda_median_ms(torch, lambda: BS._bucket_search_cuda(*args), 10))
    BS.release_l2(cuda0)
    a_ms = cuda_median_ms(
        torch, lambda: BS._index_buckets_cuda(snap.rows, snap.kmin, snap.bstep, snap.nb), 10)
    k1_flat_ms = cuda_median_ms(
        torch, lambda: IK._index_search_cuda(snap.rows, None, 0, 1, 0, pk), 10)
    biased = snap.keys ^ IK._SIGN
    a_plain_ms = cuda_median_ms(
        torch, lambda: BS._index_buckets_torch(biased, snap.kmin, snap.bstep, snap.nb), 3,
        warm=1)
    cols = (snap.keys, snap.offsets, snap.sizes)
    b_plain_ms = cuda_median_ms(torch, lambda: BS._bucket_search_torch(
        snap.bsteps, *cols, snap.starts, snap.kmin, snap.bstep, snap.nb, pk), 3, warm=1)
    # the library calls: searchsorted of the bucket boundaries (A's starts
    # without the occupancy), and searchsorted + 3 gathers over contiguous
    # columns (B's answers), on sign-biased keys
    bounds = (torch.arange(snap.nb, dtype=torch.int64, device=cuda0) * snap.bstep
              + snap.kmin) ^ IK._SIGN
    a_lib_ms = cuda_median_ms(torch, lambda: torch.searchsorted(biased, bounds), 10)
    lib_offs, lib_sizes = snap.offsets.contiguous(), snap.sizes.contiguous()
    bp = pk ^ IK._SIGN
    n = snap.n

    def library():
        i = torch.searchsorted(biased, bp).clamp_(max=n - 1)
        f = biased[i] == bp
        return (torch.where(f, lib_offs[i], 0), torch.where(f, lib_sizes[i], 0), f)

    lib_ms = cuda_median_ms(torch, library, 10)

    # bounds, over 3.35 TB/s. A: every row read once (each 32-byte sector
    # holds two rows' keys) and the table written once. B, the function's
    # own bytes (K1's rule in phase 8): each probe's key in, its 9 bytes of
    # answer out, and the distinct sectors of the rows that answer (each
    # probe's lower bound), each once. Beside it, what B's design reads:
    # the sectors of the bucket rows [starts[b], starts[b + 1]), distinct
    # and summed over the probes; the L2-resident starts reads not counted
    a_bytes = n * 16 + (snap.nb + 1) * 4 + 4
    lower = torch.searchsorted(biased, bp)
    final_bytes = unique_sector_bytes(torch, lower.clamp(max=n - 1), 16)
    second = _second_trips(torch, pk, snap, lower)
    del biased, bounds, lib_offs, lib_sizes, bp, lower
    bucket = BS._bucket_torch(pk, snap.kmin, snap.bstep, snap.nb)
    lo = snap.starts[bucket].long()
    hi = snap.starts[bucket + 1].long()
    row_bytes, fetched_bytes = _bucket_sector_bytes(torch, lo, hi, n)
    wide = int(((hi - lo) > 8).sum())
    del bucket, lo, hi
    io_bytes = pk.shape[0] * (8 + 4 + 4 + 1)
    b_bytes = io_bytes + final_bytes
    del reps, snap
    torch.cuda.empty_cache()
    return {
        "entries": n, "probes": int(pk.shape[0]),
        "nb": check["nb"], "bstep": check["bstep"], "starts_bytes": (check["nb"] + 1) * 4,
        "max_bucket_rows": check["max_rows"], "probes_in_buckets_over_8_rows": wide,
        "probes_with_a_second_trip": second,
        "persisting_l2_max_bytes": persist, "access_window_max_bytes": window,
        "tables": checks,
        "index_buckets": {
            "max_abs_err": max(c["starts_err"] for c in (check, *checks.values())),
            "ms": a_ms, "ms_from": "events",
            "ms_sequential_keys": checks["sequential"]["index_buckets_ms"],
            "plain_ms": a_plain_ms, "library_ms": a_lib_ms,
            "library_call": "torch.searchsorted of the nb boundaries (no occupancy)",
            "bound_bytes": a_bytes, "bound_ms": a_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "registers": BS._kernel_lib().bucket_kernels_registers(0),
        },
        "bucket_search": {
            "max_abs_err": max(c["search_err"] for c in (check, *checks.values())),
            "ms": b_ms["1x1"], "ms_2x2": b_ms["2x2"],
            "ms_from": "events around search_blocks (every place's launch)",
            "ms_alone_window": window_ms, "ms_alone_no_window": no_window_ms,
            "k1_on_the_same_table_ms": k1_on_a_ms,
            "plain_ms": b_plain_ms, "library_ms": lib_ms,
            "library_call": "torch.searchsorted on sign-biased int64 keys + 3 gathers "
                            "over contiguous columns",
            "bound_bytes": b_bytes, "bound_ms": b_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "bound_rule": "probes, answers and the distinct sectors of each probe's "
                          "final row (phase 8's rule for K1)",
            "bucket_row_bytes_distinct": row_bytes,
            "bucket_row_bytes_per_probe_summed": fetched_bytes,
            "bucket_rows_bound_ms": (io_bytes + row_bytes) / HBM_BYTES_PER_S * 1e3,
            "registers": BS._kernel_lib().bucket_kernels_registers(1),
        },
        "unbucketed_k1_ms": k1_flat_ms,
        "unbucketed_k1_note": "the mesh lookup before this kernel pair: K1 over the "
                              "whole table, one launch on the 1x1 mesh's shape",
    }


def phase_mesh(torch, seed: int, index: dict, ires: dict, sm_clock_hz: float) -> dict:
    """The mesh plane on the card at full width: sharded_encode, verify,
    reconstruct_step and reconstruct_padded of 5 volumes of 10 x 16 MiB,
    on a 1x1 mesh of cuda:0 and on a 2x2 grid of cuda:0 repeated (one
    card split into four blocks, one stream each; not four cards); the
    sharded bulk lookup of phase 8's index with 10,000,003 probes and of
    phase 8's edge tables; entry.entry() and entry.dryrun() on both meshes.
    Launch counts are read after the path and before the comparisons with
    the plain versions, which follow; then gf_verify's time beside its
    plain version's, B3's torch form and its bytes bound, and the mesh
    lookup's kernels held to their plain versions and timed
    (_mesh_lookup_kernels)."""
    import numpy as np

    from seaweedfs_tpu_torch import entry
    from seaweedfs_tpu_torch.ops import bucket_search as BS
    from seaweedfs_tpu_torch.ops import gf256 as G
    from seaweedfs_tpu_torch.ops import index_kernel as IK
    from seaweedfs_tpu_torch.parallel import (
        make_mesh,
        sharded_bulk_lookup,
        sharded_encode,
        sharded_reconstruct_padded,
        sharded_reconstruct_step,
        sharded_verify,
    )
    from seaweedfs_tpu_torch.storage.erasure_coding import galois

    t_phase = time.perf_counter()
    cuda0 = torch.device("cuda", 0)
    meshes = {"1x1": make_mesh(devices=[cuda0]),
              "2x2": make_mesh(devices=[cuda0] * 4)}
    full = galois.build_matrix(10, 14)
    pm = full[10:]
    survivors = [i for i in range(14) if i not in MESH_LOST][:10]
    dec_rows = galois.mat_mul(full[np.asarray(MESH_LOST)],
                              galois.reconstruction_matrix(full, survivors))
    gen = torch.Generator(device=cuda0)
    gen.manual_seed(seed + 12)
    data = torch.randint(0, 256, (MESH_VOLUMES, 10, MESH_SHARD_BYTES), dtype=torch.uint8,
                         device=cuda0, generator=gen)
    # seeded flips: two bytes of one parity word, a parity byte, a data byte
    flips = [(3, 12, 76, 0xFF), (3, 12, 77, 0x0F), (0, 13, MESH_SHARD_BYTES - 1, 0x01),
             (4, 2, 1000, 0x80)]
    keys, offs, sizes = index["keys"], index["offs"], index["sizes"]
    rng = np.random.default_rng(seed + 12)
    absent = rng.integers(int(keys[-1]) + 1, 1 << 62, size=MESH_EXTRA_PROBES, dtype=np.uint64)
    probes = np.concatenate([index["probes"], absent])
    edges = edge_inputs(np, np.random.default_rng(seed + 121))
    # launches the path must make: A once a bucketable table and mesh (one
    # distinct device), B once a bucketable table and place, K1 once an
    # unbucketable table and place; the bucketable tables are phase 8's,
    # the dryrun's (65,536 keys) and those edge tables IndexSnapshot buckets
    bucketed = 2 + sum(IK.IndexSnapshot.bucketable(len(k), int(k[0]), int(k[-1]))
                       for k, _o, _s, _p in edges.values())
    places = sum(m.devices.size for m in meshes.values())
    want_launches = {"index_buckets": len(meshes) * bucketed,
                     "bucket_search": places * bucketed,
                     "index_search": places * (len(edges) + 2 - bucketed)}

    G.KERNEL_LAUNCHES = G.VERIFY_LAUNCHES = IK.KERNEL_LAUNCHES = 0
    BS.BUCKETS_LAUNCHES = BS.SEARCH_LAUNCHES = 0
    t_path = time.perf_counter()
    out = {}
    for name, mesh in meshes.items():
        o = out[name] = {}
        o["parity"] = sharded_encode(pm, data, mesh)
        shards = torch.cat([data, o["parity"]], dim=1)
        o["verify_clean"] = sharded_verify(pm, shards, mesh)
        for v, r, b, x in flips:
            shards[v, r, b] ^= x
        o["verify_flipped"] = sharded_verify(pm, shards, mesh)
        o["shards_flipped"] = shards
        clean = torch.cat([data, o["parity"]], dim=1)
        o["rec"] = sharded_reconstruct_step(dec_rows, clean[:, survivors], mesh)
        host = clean[:, survivors, :MESH_RAGGED].cpu().numpy()
        o["padded"] = sharded_reconstruct_padded(dec_rows, host, mesh)
        o["lookup"] = sharded_bulk_lookup(keys, offs, sizes, probes, mesh)
        o["edges"] = {t: sharded_bulk_lookup(*e, mesh) for t, e in edges.items()}
        fn, args = entry.entry()
        o["entry"] = (fn(*args), args[0])
        entry.dryrun(list(mesh.devices.flat))
        del shards, clean
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t_path
    launches = {"gf_matmul": G.KERNEL_LAUNCHES, "gf_verify": G.VERIFY_LAUNCHES,
                "index_search": IK.KERNEL_LAUNCHES, "index_buckets": BS.BUCKETS_LAUNCHES,
                "bucket_search": BS.SEARCH_LAUNCHES}
    for k, n in want_launches.items():
        if launches[k] != n:
            fail(f"phase 12 launched {k} {launches[k]} times, the path makes {n}")

    # the comparisons: the plain versions on the card, then single-device K1
    plain_parity = torch.stack([
        G._gf_matmul_torch_packed(pm, data[v].view(torch.int32)).view(torch.uint8)
        for v in range(MESH_VOLUMES)])
    snap = IK.IndexSnapshot(keys, offs, sizes)
    single = snap.lookup(probes)
    del snap
    clean_plain = torch.cat([data, plain_parity], 1)
    plain_rec = torch.stack([G._gf_matmul_torch_packed(
        dec_rows, clean_plain[v, survivors].view(torch.int32)).view(torch.uint8)
        for v in range(MESH_VOLUMES)])
    del clean_plain
    worst = 0
    verify_err = 0
    for name, o in out.items():
        if not torch.equal(o["parity"], plain_parity):
            fail(f"sharded_encode ({name}) != the plain version")
        want_flipped = sum(int(G._gf_verify_torch(
            pm, o["shards_flipped"][v, :10].view(torch.int32),
            o["shards_flipped"][v, 10:].view(torch.int32))) for v in range(MESH_VOLUMES))
        verify_err = max(verify_err, o["verify_clean"], abs(o["verify_flipped"] - want_flipped))
        if o["verify_clean"] != 0 or o["verify_flipped"] != want_flipped or want_flipped != 6:
            fail(f"sharded_verify ({name}): {o['verify_clean']}, {o['verify_flipped']} "
                 f"(plain {want_flipped}, expected 6 words)")
        if not (torch.equal(o["rec"], plain_rec) and torch.equal(o["rec"][:, 0], data[:, 2])
                and torch.equal(o["rec"][:, 1], plain_parity[:, 2])):
            fail(f"sharded_reconstruct_step ({name}) != the plain version or the lost shards")
        if not (np.array_equal(o["padded"], plain_rec[:, :, :MESH_RAGGED].cpu().numpy())):
            fail(f"sharded_reconstruct_padded ({name}) != the plain version")
        for a, b in zip(o["lookup"], single):
            if not np.array_equal(a, b):
                fail(f"sharded_bulk_lookup ({name}) != single-device index_search")
        for t, (k, of, sz, pr) in edges.items():
            want_single = IK.IndexSnapshot(k, of, sz).lookup(pr)
            want_plain = IK.IndexSnapshot(k, of, sz, device="cpu").lookup(pr)
            for a, b, c in zip(o["edges"][t], want_single, want_plain):
                if not (np.array_equal(a, b) and np.array_equal(a, c)):
                    fail(f"sharded_bulk_lookup ({name}) of the edge table {t} != "
                         "single-device index_search or the plain version")
        got, ex = o["entry"]
        if not torch.equal(got.view(torch.int32), torch.stack([G._gf_matmul_torch_packed(
                pm, ex[v].view(torch.int32)) for v in range(ex.shape[0])])):
            fail(f"entry() ({name}) != the plain version")
        worst = max(worst, max_abs_diff(torch, [(o["parity"].view(torch.int32),
                                                 plain_parity.view(torch.int32))]))
    found = int(single[2].sum())

    # gf_verify alone: one volume's block at the 1x1 shape, events
    d_words = data[0].view(torch.int32)
    p_words = plain_parity[0].view(torch.int32)
    count = torch.zeros(1, dtype=torch.int64, device=cuda0)

    def verify_kernel():
        count.zero_()
        G._gf_verify_cuda(pm, d_words, p_words, count=count)

    def verify_kernel_only():
        G._gf_verify_cuda(pm, d_words, p_words, count=count)

    verify_ms = cuda_median_ms(torch, verify_kernel_only, 50)
    verify_clear_ms = cuda_median_ms(torch, verify_kernel, 20)
    verify_plain_ms = cuda_median_ms(torch, lambda: G._gf_verify_torch(pm, d_words, p_words),
                                     5, warm=1)

    def verify_library():
        return (G.gf_matmul_bitsliced(pm, d_words) != p_words).sum()

    if int(verify_library()) != 0:
        fail("gf_matmul_bitsliced's parity != the plain version's (phase 12)")
    verify_library_ms = cuda_median_ms(torch, verify_library, 5, warm=1)
    words = MESH_SHARD_BYTES // 4
    v_bound = gf_bounds(G, pm, MESH_SHARD_BYTES, (10 + 4) * MESH_SHARD_BYTES + 8,
                        sm_clock_hz, torch.cuda.get_device_properties(0))

    lres = _mesh_lookup_kernels(torch, np, meshes, keys, offs, sizes, probes, edges, seed)
    mesh_ms = {}
    for name, mesh in meshes.items():
        sh = torch.cat([data, plain_parity], dim=1)
        mesh_ms[name] = {
            "sharded_encode": cuda_median_ms(torch, lambda: sharded_encode(pm, data, mesh), 5),
            "sharded_verify": cuda_median_ms(torch, lambda: sharded_verify(pm, sh, mesh), 5),
        }
        del sh
    res = {
        "phase": "mesh",
        "device": {"nvidia_smi": nvidia_smi("name,power.limit")},
        "meshes": {k: repr(m) for k, m in meshes.items()},
        "mesh_note": "one card: the 2x2 grid repeats cuda:0 (four blocks on four "
                     "streams), not four cards",
        "volumes": MESH_VOLUMES, "shard_bytes": MESH_SHARD_BYTES,
        "ragged_width": MESH_RAGGED, "lost": MESH_LOST, "flips": len(flips),
        "verify_words": out["1x1"]["verify_flipped"],
        "equal_to_plain": True, "max_abs_err": worst, "tolerance": "exact",
        "lookup": {"found": found, "edge_tables": list(edges),
                   "equal_to_single_device_index_search": True,
                   "equal_to_plain": True, **lres,
                   "plain_ms_unbucketed": ires["plain_ms_unbucketed"]},
        "mesh_ms": mesh_ms,
        "path_s": path_s,
        "kernel_launches": launches,
        "gf_verify": {
            "max_abs_err": verify_err,
            "shape": f"[10, {words}] data and [4, {words}] parity int32 words",
            "ms": verify_ms, "ms_from": "events",
            "ms_with_counter_zeroing": verify_clear_ms,
            "plain_ms": verify_plain_ms,
            "library_ms": verify_library_ms,
            "library_call": "(gf_matmul_bitsliced(data) != parity).sum(): B3's torch "
                            "form, a compare and a sum (never called on the path)",
            **v_bound,
            "bound_share": v_bound["bound_ms"] / verify_ms,
            "achieved_GBps": v_bound["bytes"] / (verify_ms * 1e-3) / 1e9,
        },
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(res)
    return res

# --- phase 13 ----------------------------------------------------------------
VACUUM_STASH = "vacuum-src"  # phase 7's volume, kept for phase 13
VACUUM_COPY_SUFFIX = "-server"  # beside the stash: 13b's copy, made by the deletes child
# the master's default -garbageThreshold (seaweedfs_tpu/command/cli.py:20,
# upstream `weed master`'s): a seeded 35 % of the needles deleted puts the
# volume just past it
VACUUM_THRESHOLD = 0.3
VACUUM_DELETE_SHARE = 0.35
BATCH_DELETE_FIDS = 10_000
# 13b: the last 40,000 of the deletes go through BatchDelete, the others
# are on the copy the server opens (VACUUM_CUTS)
VACUUM_RPC_DELETES = 4 * BATCH_DELETE_FIDS
VACUUM_RACE_CONCURRENCY = 256
VACUUM_AFTER_READS = 25_000  # cut (VACUUM_CUTS)
VACUUM_PLAIN_PROBES = 65_536
# the host maps of the other kinds answer a probe in 10-300 µs (the LSM
# runs, a sqlite query, a binary search of the .sdx on disk): they are
# held to the first 4,096 probes, the memory map to all; every kind's K1
# answers are held to all of them and to the plain reference
HOST_MAP_SAMPLE = 4_096  # cut (VACUUM_CUTS)
VACUUM_READ_BACK = 1_000
# 13a: the first clone compacts the whole volume; the others a prefix of
# it (its first eighth of the .idx rows and their later tombstones)
VACUUM_PREFIX_SHARE = 1 / 8
VACUUM_CUTS = {
    "after_reads": {"from": 50_000, "to": VACUUM_AFTER_READS,
                    "why": "13b's GETs after the commit's re-warm; " + OVER_LIMIT + ", 9.1 s "
                           "of it these GETs; ragged_lookup must still launch in them"},
    "host_map_sample": {"from": 16_384, "to": HOST_MAP_SAMPLE,
                        "why": "probes held to the host maps of lsm, leveldb and the "
                               "sorted load; " + OVER_LIMIT + ", 9.6 s of it leveldb's "
                               "two passes (sqlite, 290 µs a probe); the memory map still "
                               "takes every probe, and every kind's K1 answers are still "
                               "held to all of them"},
    "clones_after_the_first": {
        "from": "the whole volume (1,048,576 needles, 35 % deleted)",
        "to": "its first 131,072 .idx rows and their later tombstones",
        "why": "time for phase 15 within the script's 1,200 s, with room for a host 1.36x slower: in a run of the whole script "
               "on an NVIDIA H100 80GB HBM3 at 700.00 W 13a took 136.6 s, 62.5 s of it the leveldb "
               "clone (its map's load 33.5 s) and 25.5 s the mmap, cli and lsm clones; "
               "every kind, route, check and kernel launch stays"},
    "batch_delete_fids": {
        "from": "every delete (367,001 fids)",
        "to": f"the last {VACUUM_RPC_DELETES:,}, in {VACUUM_RPC_DELETES // BATCH_DELETE_FIDS} "
              "BatchDelete RPCs of 10,000; the others are made on the volume before "
              "the server opens it, as 13a makes them",
        "why": "time for phase 15 within the script's 880 s: in a run of the whole script on "
               "an NVIDIA H100 80GB HBM3 at 700.00 W the RPCs took 39.2 s (9,400 deletes/s, "
               "the server's per-fid Python), 13a's deletes on the volume 14.2 s; the "
               "server still holds the same tombstones, the same garbage level and every "
               "check after them"},
}
# (clone, needle map kind, copy route): "cli" is `python -m
# seaweedfs_tpu_torch compact`, None the calibrated route
VACUUM_CLONES = (("memory_pread", "memory", "pread"), ("memory_mmap", "memory", "mmap"),
                 ("memory_cli", "memory", "cli"), ("lsm", "lsm", None),
                 ("leveldb", "leveldb", None))


def start_vacuum_deletes(work: str, seed: int, keep: dict) -> None:
    """Draw phase 13's deletes (a seeded VACUUM_DELETE_SHARE of phase 7's
    live needles) and start the `--prep deletes` child that makes them on
    the stash; `keep` gains the draw, the rng to go on drawing from, and
    the child."""
    import numpy as np

    rng = np.random.default_rng(seed + 13)
    ids = keep["ids"]
    doomed = rng.choice(np.nonzero(keep["live"])[0], int(VACUUM_DELETE_SHARE * len(ids)),
                        replace=False)
    npz = os.path.join(work, PREP_DIR, "vacuum-deletes.npz")
    os.makedirs(os.path.dirname(npz), exist_ok=True)
    np.savez(npz, vid=keep["vid"], ids=ids, cookies=keep["cookies"], doomed=doomed,
             by_rpc=VACUUM_RPC_DELETES)
    keep.update(rng=rng, doomed=doomed, deleter=_start_prep(
        work, "deletes", [npz, keep["dir"], keep["dir"] + VACUUM_COPY_SUFFIX]))


def _idx_live(path: str):
    """The plain reference's reading of a .idx, numpy alone: 16-byte
    big-endian rows (key u64, offset units u32, size u32), each key's
    newest row wins, tombstones (size 0xFFFFFFFF) and zero offsets drop
    out -> key-sorted (keys, offset units, sizes) as int64/uint64."""
    import numpy as np

    raw = np.fromfile(path, dtype=np.uint8).reshape(-1, 16)
    keys = raw[:, :8].copy().view(">u8").ravel().astype(np.uint64)
    offs = raw[:, 8:12].copy().view(">u4").ravel().astype(np.int64)
    sizes = raw[:, 12:].copy().view(">u4").ravel().astype(np.int64)
    uk, rev_first = np.unique(keys[::-1], return_index=True)
    last = len(keys) - 1 - rev_first
    off, size = offs[last], sizes[last]
    alive = (off != 0) & (size != 0xFFFFFFFF)
    return uk[alive], off[alive], size[alive]


def _expected_compaction(base: str) -> dict:
    """What a compaction of `base` must write, from its .dat and .idx with
    numpy alone: the super block with its compaction revision + 1, then
    every live record (version 3: 16-byte header, body, CRC, timestamp,
    padded with 1-8 bytes to a multiple of 8) in old-offset order; the
    .idx the live keys in key order at their new offsets."""
    import numpy as np

    keys, old_units, sizes = _idx_live(base + ".idx")
    with open(base + ".dat", "rb") as f:
        head = f.read(8)
        if head[0] != 3:
            fail(f"{base}.dat is version {head[0]}, the reference reads version 3")
        sb = bytearray(head + f.read(int.from_bytes(head[6:8], "big")))
    sb[4:6] = (int.from_bytes(sb[4:6], "big") + 1).to_bytes(2, "big")
    rec = 16 + sizes + 4 + 8
    rec += 8 - rec % 8
    order = np.argsort(old_units, kind="stable")
    starts = old_units[order] * 8
    ends = starts + rec[order]
    new_off = len(sb) + np.concatenate(([0], np.cumsum(rec[order])[:-1]))
    new_units = np.empty_like(old_units)
    new_units[order] = new_off // 8
    h = hashlib.sha1(sb)
    mm = np.memmap(base + ".dat", dtype=np.uint8, mode="r")
    cut = np.nonzero(starts[1:] != ends[:-1])[0] + 1  # contiguous runs
    for a, b in zip(starts[np.concatenate(([0], cut))].tolist(),
                    ends[np.concatenate((cut - 1, [len(ends) - 1]))].tolist()):
        h.update(mm[a:b])
    del mm
    idx = np.empty((len(keys), 16), dtype=np.uint8)
    idx[:, :8] = keys.astype(">u8").view(np.uint8).reshape(-1, 8)
    idx[:, 8:12] = new_units.astype(">u4").view(np.uint8).reshape(-1, 4)
    idx[:, 12:] = sizes.astype(">u4").view(np.uint8).reshape(-1, 4)
    return {"keys": keys, "old_units": old_units, "new_units": new_units, "sizes": sizes,
            "dat_size": len(sb) + int(rec.sum()), "dat_sha1": h.hexdigest(),
            "idx_bytes": idx.tobytes(), "live_bytes": int(rec.sum())}


def _prefix_volume(base: str, dst: str, rows: int) -> int:
    """A smaller volume of the same shape at `dst`, with numpy alone: the
    first `rows` .idx rows of `base` and the .dat up to the record of the
    next row (records and rows are appended in the same order), then the
    tombstone records `base` appended later for keys of that prefix, copied
    after it with their rows. -> (the prefix's distinct keys, those of
    them written again after the prefix: their bodies differ there)."""
    import numpy as np

    raw = np.fromfile(base + ".idx", dtype=np.uint8).reshape(-1, 16)
    offs = raw[:, 8:12].copy().view(">u4").ravel().astype(np.int64)
    sizes = raw[:, 12:].copy().view(">u4").ravel().astype(np.int64)
    keys = raw[:, :8].copy().view(">u8").ravel()
    end = int(offs[rows]) * 8
    later = np.arange(rows, len(keys))
    tomb = later[(sizes[later] == 0xFFFFFFFF) & np.isin(keys[later], keys[:rows])]
    tomb_rec = 32  # a version-3 record of no data: 16 + 4 + 8, padded to 8
    mm = np.memmap(base + ".dat", dtype=np.uint8, mode="r")
    with open(dst + ".dat", "wb") as f:
        f.write(mm[:end].tobytes())
        for r in tomb.tolist():
            f.write(mm[offs[r] * 8: offs[r] * 8 + tomb_rec].tobytes())
    del mm
    moved = raw[tomb].copy()
    moved[:, 8:12] = ((end + tomb_rec * np.arange(len(tomb))) // 8).astype(">u4") \
        .view(np.uint8).reshape(-1, 4)
    with open(dst + ".idx", "wb") as f:
        f.write(raw[:rows].tobytes())
        f.write(moved.tobytes())
    again = later[(sizes[later] != 0xFFFFFFFF) & np.isin(keys[later], keys[:rows])]
    return (np.unique(keys[:rows]).astype(np.uint64),
            np.unique(keys[again]).astype(np.uint64))


def _expect_lookup(exp: dict, units_key: str, probes):
    """(offset units, sizes, found) the lookup of `probes` must answer."""
    import numpy as np

    keys = exp["keys"]
    i = np.minimum(np.searchsorted(keys, probes), len(keys) - 1)
    found = keys[i] == probes
    return (np.where(found, exp[units_key][i], 0).astype(np.uint32),
            np.where(found, exp["sizes"][i], 0).astype(np.uint32), found)


def _check_lookup(got, want, what: str) -> None:
    import numpy as np

    for j, name in enumerate(("offset", "size", "found")):
        if not np.array_equal(np.asarray(got[j]), want[j]):
            bad = int(np.count_nonzero(np.asarray(got[j]) != want[j]))
            fail(f"{what}: {name} differs at {bad} of {len(want[j])} probes")


def _batched_lookup(v, probes, batch: int):
    import numpy as np

    parts = [v.bulk_lookup(probes[c0:c0 + batch]) for c0 in range(0, len(probes), batch)]
    return tuple(np.concatenate([p[j] for p in parts]) for j in range(3))


def _k1_against_plain(torch, v, probes) -> int:
    """K1 and its plain version on the card over `v`'s snapshot, one batch
    of probes; -> the largest difference (0). Not counted on the path."""
    import numpy as np

    from seaweedfs_tpu_torch.ops import index_kernel as K

    counted = K.KERNEL_LAUNCHES
    try:
        snap = K.IndexSnapshot(*v.nm.snapshot())
        pk = torch.from_numpy(probes.view(np.int64)).to(snap.rows.device)
        cols = (snap.keys, snap.offsets, snap.sizes)
        if snap.starts is not None:
            got = K._index_search_cuda(snap.rows, snap.starts, snap.kmin, snap.bstep,
                                       snap.nb, pk)
            bucket = torch.from_numpy(snap._bucket_of(probes).astype(np.int64)).to(pk.device)
            want = K._bulk_lookup_bucketed_torch(snap.bsteps, *cols, snap.starts, pk, bucket)
        else:
            got = K._index_search_cuda(snap.rows, None, 0, 1, 0, pk)
            want = K._bulk_lookup_torch(snap.steps, *cols, pk)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                and torch.equal(got[2].bool(), want[2])):
            fail("index_search != its plain version over a compacted volume's snapshot")
        return max_abs_diff(torch, zip(got[:2], want[:2]))
    finally:
        K.KERNEL_LAUNCHES = counted


def phase_vacuum(torch, work: str, keep: dict) -> dict:
    """The vacuum plane at `weed benchmark` scale on phase 7's volume. 13a,
    the volume layer: a seeded 35 % deleted (by the `--prep deletes` child
    that start_vacuum_deletes started; `keep` holds it), the garbage
    level checked,
    then compact2 and commit on clones (memory on each copy route and
    through `python -m seaweedfs_tpu_torch compact`, lsm, leveldb), every
    clone's .dat and .idx held to the script's own plain reference and
    bulk_lookup before and after the commit (and on a read-only sorted
    load) held to it and to the host map. 13b, the server: `server -index
    lsm -batchLookup arena -storageBackend cuda -garbageThreshold 0.3` on
    a copy of the volume taken before the last 40,000 deletes, those
    through BatchDelete, `shell volume.vacuum` under GETs at concurrency 256, the
    gate re-warmed and checked after the commit, BulkLookup, a second
    /vol/vacuum with no candidate."""
    import asyncio
    import pickle

    import numpy as np

    from seaweedfs_tpu_torch.command import cli
    from seaweedfs_tpu_torch.ops import index_kernel as IK
    from seaweedfs_tpu_torch.ops import ragged_lookup as RL
    from seaweedfs_tpu_torch.pb import grpc_address
    from seaweedfs_tpu_torch.pb.rpc import Stub
    from seaweedfs_tpu_torch.storage import vacuum
    from seaweedfs_tpu_torch.storage.file_id import FileId
    from seaweedfs_tpu_torch.storage.volume import Volume

    t_phase = time.perf_counter()
    rng, doomed = keep["rng"], keep["doomed"]
    # the deletes, made by the `--prep deletes` child on the stash
    deletes = _await_prep(keep["deleter"])
    root = os.path.join(work, "vacuum")
    os.makedirs(root)
    vid = keep["vid"]
    src = os.path.join(root, "src")
    os.rename(keep["dir"], src)
    srv = os.path.join(root, "server")
    os.rename(keep["dir"] + VACUUM_COPY_SUFFIX, srv)
    pool, pool_crc = keep["pool"], keep["pool_crc"]
    ids, cookies, blob_of, live0 = (keep[k] for k in ("ids", "cookies", "blob_of", "live"))
    live = live0.copy()
    live[doomed] = False
    # 13b's volume: a copy with all but the last VACUUM_RPC_DELETES deletes
    # made, the rest sent through BatchDelete
    by_rpc = doomed[len(doomed) - VACUUM_RPC_DELETES:]
    live_srv = live.copy()
    live_srv[by_rpc] = True
    absent = rng.integers(1 << 49, 1 << 50, size=len(ids) // 10, dtype=np.uint64)
    probes = rng.permutation(np.concatenate([ids, absent]))
    fid = lambda k, c: "/" + str(FileId(vid, int(k), int(c)))  # noqa: E731

    # the path: every count at 0 now, read at the phase's end
    IK.KERNEL_LAUNCHES = RL.KERNEL_LAUNCHES = 0

    # --- 13a: the volume layer ---
    base = os.path.join(src, str(vid))
    garbage = deletes["garbage"]
    if garbage < VACUUM_THRESHOLD:
        fail(f"garbage level {garbage} after the deletes, under {VACUUM_THRESHOLD}")
    t0 = time.perf_counter()
    exp = _expected_compaction(base)
    reference_s = time.perf_counter() - t0
    if len(exp["keys"]) != int(live.sum()):
        fail(f"the .idx holds {len(exp['keys'])} live needles, expected {int(live.sum())}")
    want_old = _expect_lookup(exp, "old_units", probes)
    want_new = _expect_lookup(exp, "new_units", probes)
    live_idx = np.nonzero(live)[0]
    sample = rng.choice(live_idx, VACUUM_READ_BACK, replace=False)
    full = {"base": base, "exp": exp, "probes": probes, "want_old": want_old,
            "want_new": want_new, "sample": sample}
    # the clones after the first compact a prefix of the volume (VACUUM_CUTS)
    t0 = time.perf_counter()
    pdir = os.path.join(root, "prefix")
    os.makedirs(pdir)
    pbase = os.path.join(pdir, str(vid))
    pkeys, rewritten = _prefix_volume(base, pbase, int(VACUUM_PREFIX_SHARE * len(ids)))
    pexp = _expected_compaction(pbase)
    in_prefix = np.isin(ids, pkeys)
    pprobes = rng.permutation(np.concatenate([pkeys, absent[:len(pkeys) // 10]]))
    prefix = {"base": pbase, "exp": pexp, "probes": pprobes,
              "want_old": _expect_lookup(pexp, "old_units", pprobes),
              "want_new": _expect_lookup(pexp, "new_units", pprobes),
              "sample": rng.choice(np.nonzero(live & in_prefix & ~np.isin(ids, rewritten))[0],
                                   VACUUM_READ_BACK, replace=False)}
    prefix_s = time.perf_counter() - t0
    if len(pexp["keys"]) != int((live & in_prefix).sum()):
        fail(f"the prefix volume holds {len(pexp['keys'])} live needles, expected "
             f"{int((live & in_prefix).sum())}")

    def read_back(v, what, sample=sample):
        for i in sample.tolist():
            n = v.read_needle_by_key(int(ids[i]))
            data = pool[int(blob_of[i])]
            if n.cookie != int(cookies[i]) or bytes(n.data) != data \
                    or n.checksum != pool_crc[data]:
                fail(f"{what}: needle {int(ids[i]):x} reads back wrong")

    kinds = {}
    plain_err = 0
    dat_sums = {}
    clone_exp = {}
    for k, (name, kind, route) in enumerate(VACUUM_CLONES):
        t_clone = time.perf_counter()
        c = full if k == 0 else prefix
        exp, probes, want_old, want_new = (c[x] for x in ("exp", "probes", "want_old",
                                                           "want_new"))
        d = os.path.join(root, name)
        os.makedirs(d)
        for ext in (".dat", ".idx"):  # compaction only reads them
            os.link(c["base"] + ext, os.path.join(d, f"{vid}{ext}"))
        clone_exp[name] = exp
        row = {"map": kind, "volume": "whole" if k == 0 else "prefix",
               "live_needles": len(exp["keys"])}
        if route == "cli":
            out, row["cli_s"] = _port_cli(["compact", "-dir", d, "-volumeId", str(vid)])
            if f"compacted volume {vid}: {exp['dat_size']} bytes" not in out:
                fail(f"compact: {out!r}")
        else:
            t0 = time.perf_counter()
            v = Volume(d, "", vid, needle_map_kind=kind)
            row["load_s"] = time.perf_counter() - t0
            check = route in ("pread", None)  # the lookups, once per kind
            host_n = len(probes) if kind == "memory" else HOST_MAP_SAMPLE
            if check:
                t0 = time.perf_counter()
                _check_lookup(v.bulk_lookup(probes), want_old, f"{name}: bulk_lookup before")
                row["lookup_before_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                _check_lookup(v.bulk_lookup(probes[:host_n], use_device=False),
                              [w[:host_n] for w in want_old], f"{name}: host map before")
                row["host_map_probes"] = host_n
                row["host_map_before_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            report = vacuum.compact2(v, route=route)
            row["compact_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            v = vacuum.commit_compact(v)
            row["commit_s"] = time.perf_counter() - t0
            row.update(route=report["route"], records=report["records"],
                       extents=report["extents"], live_bytes=report["live_bytes"],
                       live_gb_per_s=report["live_bytes"] / row["compact_s"] / 1e9,
                       stages=report["stages"])
            if report["records"] != len(exp["keys"]) or report["live_bytes"] != exp["live_bytes"]:
                fail(f"{name}: compacted {report['records']} records, "
                     f"{report['live_bytes']} bytes; expected {len(exp['keys'])}, "
                     f"{exp['live_bytes']}")
            if check:
                walls = {}
                for batch in (64, VACUUM_PLAIN_PROBES, len(probes)):
                    t0 = time.perf_counter()
                    got = _batched_lookup(v, probes, batch)
                    walls[str(batch) if batch != len(probes) else "all"] = \
                        time.perf_counter() - t0
                    _check_lookup(got, want_new, f"{name}: bulk_lookup after, batch {batch}")
                row["lookup_after_s"] = walls
                t0 = time.perf_counter()
                _check_lookup(v.bulk_lookup(probes[:host_n], use_device=False),
                              [w[:host_n] for w in want_new], f"{name}: host map after")
                row["host_map_after_s"] = time.perf_counter() - t0
                plain_err = max(plain_err, _k1_against_plain(
                    torch, v, probes[:VACUUM_PLAIN_PROBES]))
                read_back(v, name, c["sample"])
            v.close()
        paths = [os.path.join(d, f"{vid}{e}") for e in (".dat", ".idx")]
        if os.path.getsize(paths[0]) != exp["dat_size"]:
            fail(f"{name}: the new .dat has {os.path.getsize(paths[0])} bytes, "
                 f"expected {exp['dat_size']}")
        with open(paths[1], "rb") as f:
            if f.read() != exp["idx_bytes"]:
                fail(f"{name}: the new .idx differs from the plain reference's")
        dat_sums[name] = paths[0]
        row["s"] = time.perf_counter() - t_clone
        kinds[name] = row
    sums = sha1_files(list(dat_sums.values()))
    for name, path in dat_sums.items():
        if sums[path] != clone_exp[name]["dat_sha1"]:
            fail(f"{name}: the new .dat differs from the plain reference's")
    exp, probes, want_new = full["exp"], full["probes"], full["want_new"]
    # a read-only sorted load of the compacted volume
    d = os.path.join(root, "memory_pread")
    t0 = time.perf_counter()
    v = Volume(d, "", vid, create=False, needle_map_kind="sorted")
    sorted_row = {"load_s": time.perf_counter() - t0, "read_only": v.is_read_only()}
    if not v.is_read_only():
        fail("a sorted load is writable")
    for batch in (64, len(probes)):
        _check_lookup(_batched_lookup(v, probes, batch), want_new,
                      f"sorted: bulk_lookup, batch {batch}")
    _check_lookup(v.bulk_lookup(probes[:HOST_MAP_SAMPLE], use_device=False),
                  [w[:HOST_MAP_SAMPLE] for w in want_new], "sorted: host map")
    read_back(v, "sorted")
    v.close()
    sorted_row["s"] = time.perf_counter() - t0
    ik_13a = IK.KERNEL_LAUNCHES
    t13a = time.perf_counter() - t_phase
    for name in list(dat_sums) + ["src", "prefix"]:
        shutil.rmtree(os.path.join(root, name))

    # --- 13b: through the server ---
    taken: set = set()
    mport, vport = _port_pair(taken), _port_pair(taken)
    argv = ["-ip", "127.0.0.1", "-port", str(mport), "-volumePort", str(vport),
            "-dir", srv, "-index", "lsm", "-batchLookup", "arena",
            "-storageBackend", "cuda", "-garbageThreshold", str(VACUUM_THRESHOLD)]
    t0 = time.perf_counter()
    held = _serve_in_thread(cli.cmd_server, argv, "vacuum-server")
    if not held["ready"].wait(SERVER_START_S) or "error" in held:
        fail(f"server did not start in {SERVER_START_S} s: {held.get('error')!r}")
    stop_file = os.path.join(root, "race.stop")
    race = None
    try:
        ms, vs = held["servers"]
        while not ms.topo.lookup("", vid):
            if time.perf_counter() - t0 > SERVER_START_S:
                fail(f"the master does not know volume {vid}")
            time.sleep(0.1)
        start_s = time.perf_counter() - t0
        stub = Stub(grpc_address(f"127.0.0.1:{vport}"), "volume")
        base_plan = {"blobs": pool, "etags": [f"{pool_crc[b]:08x}" for b in pool]}

        def gets(n, alive):
            pick = rng.integers(0, len(ids), size=n)
            miss = rng.random(n) < ABSENT_SHARE
            out = []
            for k, i in enumerate(pick.tolist()):
                if miss[k]:
                    out.append(("GET", fid(absent[k % len(absent)], 7), -1, 404))
                elif alive[i]:
                    out.append(("GET", fid(ids[i], cookies[i]), int(blob_of[i]), 200))
                else:
                    out.append(("GET", fid(ids[i], cookies[i]), -1, 404))
            return out

        def gate_now():
            return _http_json(vport, "/debug/needle_map")

        vs.lookup_gate.identity_check = True
        warm = _drive(root, "vacuum_warmup", vport,
                      dict(base_plan, requests=gets(WARMUP_READS, live_srv)),
                      WARMUP_CONCURRENCY, 600)
        # the last deletes: BatchDelete RPCs of BATCH_DELETE_FIDS fids each
        t0 = time.perf_counter()
        for c0 in range(0, len(by_rpc), BATCH_DELETE_FIDS):
            part = by_rpc[c0:c0 + BATCH_DELETE_FIDS].tolist()
            reply = asyncio.run(stub.call("BatchDelete", {"file_ids": [
                fid(ids[i], cookies[i])[1:] for i in part]}, timeout=600))
            bad = [r for r in reply["results"] if r["status"] != 202 or r["size"] <= 0]
            if bad:
                fail(f"BatchDelete: {len(bad)} failed, e.g. {bad[:3]}")
        batch_delete_s = time.perf_counter() - t0
        ratio = vs.store.find_volume(vid).garbage_level()
        if ratio < VACUUM_THRESHOLD:
            fail(f"the server's garbage level {ratio} is under {VACUUM_THRESHOLD}")

        # GETs at concurrency 256 in a child client while the shell vacuums
        plan_path = os.path.join(root, "race.plan")
        with open(plan_path, "wb") as f:
            pickle.dump(dict(base_plan, requests=gets(40_000, live), allow_404=True), f,
                        protocol=pickle.HIGHEST_PROTOCOL)
        race_out = os.path.join(root, "race.json")
        race = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--client", plan_path,
             "--port", str(vport), "--concurrency", str(VACUUM_RACE_CONCURRENCY),
             "--out", race_out, "--until", stop_file],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        time.sleep(3)  # the client is up and reading
        g_race = gate_now()
        old_volume = vs.store.find_volume(vid)
        out, vacuum_wall = _port_cli(
            ["shell", "-master", f"127.0.0.1:{mport}",
             f"lock; volume.vacuum -garbageThreshold {VACUUM_THRESHOLD}; unlock"])
        with open(stop_file, "w"):
            pass
        _stdout, err = race.communicate(timeout=600)
        if race.returncode != 0:
            fail(f"the race client exited {race.returncode}: {err[-2000:]}")
        race = None
        with open(race_out) as f:
            during = json.load(f)
        if during["bad"]:
            fail(f"GETs during the vacuum: {during['bad']} wrong bodies or 5xx, "
                 f"e.g. {during['bad_examples']}")
        if f"vacuum: {{'Result': [{{'volume_id': {vid}, 'compacted': True}}]}}" not in out:
            fail(f"volume.vacuum: {out!r}")
        new_volume = vs.store.find_volume(vid)
        if new_volume is old_volume or new_volume.garbage_level() != 0:
            fail("the vacuum did not swap a compacted volume in")
        server_route = dict(vacuum.LAST_VACUUM_ROUTE)
        server_stages = dict(vacuum.LAST_VACUUM_STAGES)
        g_after_race = gate_now()

        # after the commit: a re-warm, then GETs with the identity check on
        rl0 = RL.KERNEL_LAUNCHES
        rewarm = _drive(root, "vacuum_rewarm", vport,
                        dict(base_plan, requests=gets(WARMUP_READS, live)),
                        WARMUP_CONCURRENCY, 600)
        g0 = gate_now()
        rl1 = RL.KERNEL_LAUNCHES
        after = _drive(root, "vacuum_after", vport,
                       dict(base_plan, requests=gets(VACUUM_AFTER_READS, live)),
                       VACUUM_RACE_CONCURRENCY, 600)
        g1 = gate_now()
        window = {k: g1["gate"][k] - g0["gate"][k] for k in g1["gate"]}
        after_launches = RL.KERNEL_LAUNCHES - rl1
        # at concurrency 256 most wakeups stay under the arena's 128-probe
        # cut: as in phase 11, the re-warm at 512 and the reads together
        # must launch it
        if RL.KERNEL_LAUNCHES - rl0 <= 0:
            fail("GETs after the commit (re-warm and reads) launched "
                 "ragged_lookup no time")
        if window["host_fallbacks"] or window["identity_mismatches"] \
                or g1["device"]["errors"] or any(g1["device_errors"].values()):
            fail(f"the gate after the re-warm: {window}, arena errors "
                 f"{g1['device']['errors']}, device errors {g1['device_errors']}")
        vs.lookup_gate.identity_check = False

        # BulkLookup of every key plus 10 % absent
        t0 = time.perf_counter()
        reply = asyncio.run(stub.call("BulkLookup", {
            "volume_id": vid, "keys": probes.astype("<u8").tobytes()}, timeout=300))
        bulk_s = time.perf_counter() - t0
        got = (np.frombuffer(reply["offsets"], dtype=reply["offset_dtype"]),
               np.frombuffer(reply["sizes"], dtype="<u4"),
               np.frombuffer(reply["found"], dtype=np.uint8).astype(bool))
        _check_lookup(got, want_new, "BulkLookup after the vacuum")
        _check_lookup(got, new_volume.bulk_lookup(probes, use_device=False),
                      "BulkLookup against the host map")
        again = _http_json(mport, "/vol/vacuum")
        if again != {"Result": []}:
            fail(f"a second /vol/vacuum found {again}")
        launches = {"index_search": IK.KERNEL_LAUNCHES,
                    "ragged_lookup": RL.KERNEL_LAUNCHES}
    finally:
        if race is not None:
            with open(stop_file, "w"):
                pass
            race.kill()
            race.wait()
        stop_s = _stop_served(held, SERVER_STOP_S)
    if launches["index_search"] <= ik_13a:
        fail("BulkLookup through the server launched index_search no time")
    res = {
        "phase": "vacuum",
        "needles": len(ids),
        "deleted": len(doomed),
        "deleted_through_batch_delete": len(by_rpc),
        "server_copy_s": deletes["copy_s"],
        "deleted_before": int((~live0).sum()),
        "garbage_level": garbage,
        "threshold": VACUUM_THRESHOLD,
        "delete_s": deletes["delete_s"],
        "deletes_made_by": "a child of this script (--prep deletes) while phases 10-12 ran",
        "deletes_child_wall_s": deletes["wall_s"],
        "deletes_waited_s": deletes["waited_s"],
        "reference_s": reference_s,
        "13a_s": t13a,
        "cuts": VACUUM_CUTS,
        "prefix_volume": {"needles": int(in_prefix.sum()), "live": len(pexp["keys"]),
                          "dat_bytes": pexp["dat_size"], "build_s": prefix_s},
        "live_needles": len(exp["keys"]),
        "live_bytes": exp["live_bytes"],
        "new_dat_bytes": exp["dat_size"],
        "kinds": kinds,
        "sorted_load": sorted_row,
        "equal_to_plain_reference": True,
        "k1_plain_probes": VACUUM_PLAIN_PROBES,
        "k1_max_abs_err": plain_err,
        "server": {
            "argv": argv, "start_s": start_s, "warmup": warm,
            "batch_delete_s": batch_delete_s, "garbage_level": ratio,
            "vacuum_wall_s": vacuum_wall, "route": server_route, "stages": server_stages,
            "during": during,
            "gate_during": {k: g_after_race["gate"][k] - g_race["gate"][k]
                            for k in g_race["gate"]},
            "rewarm": rewarm, "after": after, "gate_after": window,
            "ragged_lookup_launches": {"rewarm": rl1 - rl0, "after": after_launches},
            "bulk_lookup_s": bulk_s, "second_vacuum": again, "stop_s": stop_s,
        },
        "kernel_launches": launches,
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(res)
    return res



# --- phase 14 ----------------------------------------------------------------
# (a) weed benchmark -size 1024 (cli.py:746-747) sent as the filer
# ChunkUploadGate's /!batch/put frames of 64 (server/filer.py:78) at c=16;
# -n cut from 1,048,576 (TIER_CUTS)
TIER_NEEDLES = 1 << 18
TIER_FRAME = 64
TIER_CONCURRENCY = 16
TIER_READ_REQUEST = 65_536  # keys a BatchRead request
TIER_READ_SHARE = 0.5  # (b) reads a seeded half of (a)'s keys and the absent ones (TIER_CUTS)
TIER_ABSENT_SHARE = 0.1
# (c) the cluster's benchmark, its read pass at c=256 and the reads across a
# replica's loss; (d) `upload -maxMB 4` (the filer's -maxMB, cli.py:444)
TIER_BENCH_N = 1 << 14
TIER_ASSIGN_BATCH = 128
TIER_WIDE_C = 256
# (a)'s volume served again by the cluster's `server`: GETs through the
# fan-out at the concurrency at which phase 10's wakeups pass the gate's
# 128-probe arena cut
TIER_GATED_GETS = 1 << 14
TIER_GATED_C = 512
TIER_COLLECTION = "tier"  # (a)'s volume: no assign of (c) or (d) picks it
TIER_FAILOVER_READS = 10_000
TIER_FAILOVER_STOP_AFTER = 2_000  # reads before the replica's server stops
TIER_AFTER_STOP = 2_000  # reads at least once the stop has completed
TIER_FILE_BYTES = 256 * MIB
TIER_CHUNK_MB = 4
TIER_MAX_VOLUMES = "30"  # slots for 001 growth, then 000 growth for (d)
_TIER_RATES = ("a calibration run of this phase at these counts on an NVIDIA H100 "
               "80GB HBM3 at 700.00 W put 11,380.3 needles/s, read 9,826.8 keys/s "
               "back and ran the cluster's benchmark at 557.8 writes/s (a replicated "
               "write, bound by per-request Python on the one interpreter the two "
               "servers and the master share), and took 123.5 s")
TIER_CUTS = {
    "batch_put_needles": {
        "from": 1 << 20, "to": TIER_NEEDLES,
        "why": "the phase's budget of about 120 s: " + _TIER_RATES + "; 1,048,576 "
               "needles would take about 3.5 minutes for (a) and (b) alone"},
    "batch_read_keys": {"from": (1 << 20) + 104_858,
                        "to": int((TIER_NEEDLES + int(TIER_NEEDLES * TIER_ABSENT_SHARE))
                                  * TIER_READ_SHARE),
                        "why": "a seeded half of (a)'s keys and of the 10 % absent ones "
                               "(every key before); " + OVER_LIMIT + ", 35.5 s of it (b); "
                               "every body read is still held to what was written, in 3 "
                               "requests, each launching index_search"},
    "benchmark_n": {
        "from": 65_536, "to": TIER_BENCH_N,
        "why": "the phase's budget of about 120 s: " + _TIER_RATES + "; 65,536 "
               "files would take about 2 minutes of writes alone"},
}
_K2_NOTE = ("the benchmark's volumes hold about 1,200 needles each, all in the "
            "LSM memtable (a run is sealed at 34,952 entries), so the arena holds "
            "nothing of them and their GETs stay on the host maps; ragged_lookup "
            "runs in the GETs of (a)'s volume, one sealed run and a memtable, "
            "which the cluster's `server` loads from (a)'s directory")


def _tier_npz(path: str, rng, n: int) -> dict:
    """Needles of (a) and (b): ids, cookies, each one's pool blob, the pool
    and its etags, and the absent ids (b) adds; saved for the children."""
    import numpy as np

    from seaweedfs_tpu_torch.util.crc import masked_crc

    pool = rng.integers(0, 256, (256, NEEDLE_BYTES), dtype=np.uint8)
    ids = rng.permutation(np.unique(rng.integers(1, 1 << 48, n + 4096, dtype=np.uint64)))[:n]
    absent = np.setdiff1d(np.unique(rng.integers(1 << 48, 1 << 49, int(n * TIER_ABSENT_SHARE) + 64,
                                                 dtype=np.uint64)), ids)[:int(n * TIER_ABSENT_SHARE)]
    table = {"ids": ids, "cookies": rng.integers(1, 1 << 32, n, dtype=np.uint64),
             "blob_of": rng.integers(0, len(pool), n), "pool": pool,
             "etags": np.array([f"{masked_crc(b.tobytes()):08x}" for b in pool]),
             "absent": absent}
    np.savez(path, **table)
    return table


def tier_client_main(argv: list) -> int:
    """Child mode of this script (`--tier-client MODE`): the load clients of
    phase 14, each in its own process so the servers' threads keep this
    script's interpreter to themselves. Writes its result as JSON.

    put:      /!batch/put frames of the table's needles at --concurrency,
              every reply item checked (size and etag)
    read:     BatchRead of a seeded TIER_READ_SHARE of the ids and the absent
              ids in requests of TIER_READ_REQUEST keys, every body held to
              the table
    bench:    run_benchmark with -assignBatch and the read fan-out, then a
              read-only pass at TIER_WIDE_C; the fids' seeds go to --seeds
    gets:     --n GETs of the table's needles at --concurrency through
              ReplicaReader, every body held to the table
    failover: --n reads (more if needed, until TIER_AFTER_STOP reads
              have completed after the script creates --stopped) of
              --seeds' fids through ReplicaReader; touches --signal after
              --stop-after reads, and the script then stops a replica's
              server"""
    import asyncio

    import numpy as np

    sys.path.insert(0, HERE)
    ap = argparse.ArgumentParser()
    ap.add_argument("--tier-client", required=True)
    ap.add_argument("--addr", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--table", default="")
    ap.add_argument("--vid", type=int, default=1)
    ap.add_argument("--concurrency", type=int, default=TIER_CONCURRENCY)
    ap.add_argument("--n", type=int, default=0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--signal", default="")
    ap.add_argument("--stopped", default="")
    ap.add_argument("--stop-after", type=int, default=TIER_FAILOVER_STOP_AFTER)
    a = ap.parse_args(argv)
    from seaweedfs_tpu_torch.storage.file_id import FileId
    from seaweedfs_tpu_torch.util.fasthttp import FastHTTPClient

    res: dict = {}
    if a.table:
        t = np.load(a.table)
        ids, cookies, blob_of = t["ids"], t["cookies"], t["blob_of"]
        pool = [b.tobytes() for b in t["pool"]]
        etags = [str(e) for e in t["etags"]]

    async def put() -> None:
        n = len(ids)
        fids = [str(FileId(a.vid, k, c)) for k, c in zip(ids.tolist(), cookies.tolist())]
        frames = []
        for lo in range(0, n, TIER_FRAME):
            parts = [struct.pack("<I", min(TIER_FRAME, n - lo))]
            for i in range(lo, min(lo + TIER_FRAME, n)):
                f = fids[i].encode()
                parts.append(struct.pack("<HI", len(f), NEEDLE_BYTES) + f + pool[blob_of[i]])
            frames.append((lo, b"".join(parts)))
        http = FastHTTPClient(pool_per_host=a.concurrency)
        todo = list(reversed(frames))
        lat, bad = [], []

        async def one() -> None:
            while todo:
                lo, body = todo.pop()
                t0 = time.perf_counter()
                st, got = await http.request("POST", a.addr, "/!batch/put", body,
                                             "application/octet-stream", timeout=120)
                lat.append(time.perf_counter() - t0)
                reply = json.loads(got) if st == 200 else None
                if reply is None or len(reply) != min(TIER_FRAME, n - lo):
                    bad.append((lo, st, got[:120].decode("latin1")))
                    continue
                for j, item in enumerate(reply):
                    i = lo + j
                    if (item.get("f") != fids[i] or item.get("s") != NEEDLE_BYTES
                            or item.get("e") != etags[blob_of[i]]):
                        bad.append((i, item))

        t0 = time.perf_counter()
        await asyncio.gather(*(one() for _ in range(a.concurrency)))
        wall = time.perf_counter() - t0
        await http.close()
        srt = sorted(lat)
        res.update(frames=len(frames), needles=n, wall_s=wall, needles_per_s=n / wall,
                   frame_p50_ms=srt[len(srt) // 2] * 1e3,
                   frame_p99_ms=srt[min(len(srt) - 1, int(len(srt) * 0.99))] * 1e3,
                   bad=len(bad), bad_examples=bad[:5])

    async def read() -> None:
        from seaweedfs_tpu_torch.client.operation import batch_read

        absent = t["absent"]
        keys = np.random.default_rng(len(ids)).permutation(np.concatenate([ids, absent]))
        keys = keys[:int(len(keys) * TIER_READ_SHARE)]
        want = {int(k): pool[b] for k, b in zip(ids.tolist(), blob_of.tolist())}
        wrong = present_absent = missing = 0
        t0 = time.perf_counter()
        for lo in range(0, len(keys), TIER_READ_REQUEST):
            ks = keys[lo:lo + TIER_READ_REQUEST]
            for k, got in zip(ks.tolist(), await batch_read(a.addr, a.vid, ks)):
                w = want.get(k)
                if w is None:
                    present_absent += got is not None
                elif got is None:
                    missing += 1
                elif got != w:
                    wrong += 1
        wall = time.perf_counter() - t0
        res.update(keys=len(keys), absent=int(np.isin(keys, absent).sum()),
                   requests=-(-len(keys) // TIER_READ_REQUEST),
                   wall_s=wall, keys_per_s=len(keys) / wall, wrong=wrong, missing=missing,
                   absent_answered=present_absent,
                   bad=wrong + missing + present_absent)

    async def bench() -> None:
        from seaweedfs_tpu_torch.command.benchmark import run_benchmark

        s1: dict = {}
        await run_benchmark(a.addr, num_files=a.n, file_size=NEEDLE_BYTES, concurrency=TIER_CONCURRENCY,
                            stats_out=s1, assign_batch=TIER_ASSIGN_BATCH, read_fanout=True)
        with open(a.seeds, "w") as f:
            json.dump(s1["seeds"], f)
        s2: dict = {}
        await run_benchmark(a.addr, num_files=a.n, file_size=NEEDLE_BYTES, concurrency=TIER_WIDE_C,
                            stats_out=s2, do_write=False, fids_in=s1["seeds"], read_fanout=True)

        def rates(st):
            return {"completed": st.completed, "failed": st.failed,
                    "per_s": st.completed / max(st.end - st.start, 1e-9),
                    "p50_ms": st.percentile(50), "p99_ms": st.percentile(99)}

        res.update(writes=rates(s1["write_stats"]), reads=rates(s1["read_stats"]),
                   assign_rpcs=s1["assign_rpcs"], read_fanout=s1["read_fanout"],
                   wide_reads=rates(s2["read_stats"]), wide_read_fanout=s2["read_fanout"],
                   bad=s1["write_failed"] + s1["read_failed"] + s2["read_failed"])

    async def gets() -> None:
        from seaweedfs_tpu_torch.client import MasterClient
        from seaweedfs_tpu_torch.client.read_fanout import ReplicaReader

        mc = MasterClient("tier-gets", [a.addr])
        await mc.start()
        await mc.wait_connected()
        http = FastHTTPClient(pool_per_host=a.concurrency + 4)
        reader = ReplicaReader(http, mc.vid_map)
        todo = np.random.default_rng(a.n).integers(0, len(ids), a.n).tolist()
        lat, bad = [], []

        async def one() -> None:
            while todo:
                i = todo.pop()
                fid = str(FileId(a.vid, int(ids[i]), int(cookies[i])))
                t0 = time.perf_counter()
                try:
                    st, data = await reader.read(fid)
                except LookupError:
                    st, data = await http.request(
                        "GET", (await mc.lookup_file_id_async(fid)).removeprefix(
                            "http://").partition("/")[0], "/" + fid)
                lat.append(time.perf_counter() - t0)
                if st != 200 or data != pool[blob_of[i]]:
                    bad.append((fid, st))

        t0 = time.perf_counter()
        await asyncio.gather(*(one() for _ in range(a.concurrency)))
        wall = time.perf_counter() - t0
        srt = sorted(lat)
        res.update(gets=len(lat), wall_s=wall, per_s=len(lat) / wall,
                   p50_ms=srt[len(srt) // 2] * 1e3,
                   p99_ms=srt[min(len(srt) - 1, int(len(srt) * 0.99))] * 1e3,
                   bad=len(bad), bad_examples=bad[:5])
        await http.close()
        await mc.stop()

    async def failover() -> None:
        from seaweedfs_tpu_torch.client import MasterClient
        from seaweedfs_tpu_torch.client.read_fanout import ReplicaReader
        from seaweedfs_tpu_torch.command.benchmark import fake_payload
        from seaweedfs_tpu_torch.util import overload

        with open(a.seeds) as f:
            seeds = json.load(f)
        rng = np.random.default_rng(14)
        fids = list(seeds)
        mc = MasterClient("tier-failover", [a.addr])
        await mc.start()
        await mc.wait_connected()
        http = FastHTTPClient(pool_per_host=a.concurrency + 4)
        reader = ReplicaReader(http, mc.vid_map)
        done = [0, 0]  # reads, reads completed after the stop
        failed, wrong = [], []
        deadline = time.perf_counter() + 300

        async def one() -> None:
            while (done[0] < a.n or done[1] < TIER_AFTER_STOP) and time.perf_counter() < deadline:
                fid = fids[int(rng.integers(len(fids)))]
                try:
                    st, data = await reader.read(fid)
                    if st != 200:
                        failed.append((fid, st))
                    elif data != fake_payload(seeds[fid], NEEDLE_BYTES):
                        wrong.append(fid)
                except Exception as e:
                    failed.append((fid, repr(e)))
                done[0] += 1
                if done[0] == a.stop_after:
                    open(a.signal, "w").close()
                elif done[0] > a.stop_after and os.path.exists(a.stopped):
                    done[1] += 1

        t0 = time.perf_counter()
        await asyncio.gather(*(one() for _ in range(a.concurrency)))
        wall = time.perf_counter() - t0
        res.update(reads=done[0], reads_after_stop=done[1], wall_s=wall, failed=len(failed),
                   failed_examples=failed[:5], wrong=len(wrong), fanout=reader.stats(),
                   breakers=overload.BREAKERS.stats(), bad=len(failed) + len(wrong))
        await http.close()
        await mc.stop()

    asyncio.run({"put": put, "read": read, "bench": bench, "gets": gets,
                 "failover": failover}[a.tier_client]())
    with open(a.out, "w") as f:
        json.dump(res, f)
    return 0


def _tier_child(work: str, mode: str, args: list, timeout: float = 600, wait: bool = True):
    """Run a `--tier-client MODE` child; with wait=False return the Popen
    and the path of its result."""
    out = os.path.join(work, f"tier-{mode}.json")
    cmd = [sys.executable, os.path.abspath(__file__), "--tier-client", mode, "--out", out, *args]
    if not wait:
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), out
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    return _tier_result(mode, proc.returncode, proc.stderr, out)


def _tier_result(mode: str, rc: int, stderr: str, out: str) -> dict:
    if rc != 0:
        fail(f"tier client {mode} exited {rc}: {stderr[-2000:]}")
    with open(out) as f:
        res = json.load(f)
    os.remove(out)
    if res["bad"]:
        fail(f"tier client {mode}: {res}")
    return res


def _start_served(fn, argv: list, name: str) -> dict:
    held = _serve_in_thread(fn, argv, name)
    if not held["ready"].wait(SERVER_START_S) or "error" in held:
        fail(f"{name} did not start in {SERVER_START_S} s: {held.get('error')!r}")
    return held


def _http_get(port: int, path: str, headers: dict | None = None, method: str = "GET"):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def phase_volume_tier(torch, work: str, seed: int) -> dict:
    """The volume tier under the filer. (a) /!batch/put into a `volume
    -index lsm -batchLookup arena` server through its group-commit worker;
    (b) the BatchRead stream of a seeded half of the keys and the absent
    ones (K1 must
    launch); (c) `server -defaultReplication 001` over (a)'s directory and
    a `volume -mserver`: the benchmark with -assignBatch and the read
    fan-out, a read pass at c=256, GETs of (a)'s volume at c=512 through
    the `server`'s gate (K2 must launch), then reads across the loss of
    one replica's server; (d) `upload -maxMB 4` of a 256 MiB file over
    both servers, GETs of it whole and of three ranges, and its delete.
    Every body is checked."""
    import asyncio

    import numpy as np

    from seaweedfs_tpu_torch.command import cli
    from seaweedfs_tpu_torch.ops import index_kernel as IK
    from seaweedfs_tpu_torch.ops import ragged_lookup as RL
    from seaweedfs_tpu_torch.pb import grpc_address
    from seaweedfs_tpu_torch.pb.rpc import Stub

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 14)
    root = os.path.join(work, "tier")
    dirs = [os.path.join(root, f"c{i}") for i in range(2)]
    for d in dirs:
        os.makedirs(d)
    table_path = os.path.join(root, "table.npz")
    table = _tier_npz(table_path, rng, TIER_NEEDLES)
    res: dict = {"phase": "volume_tier", "needles": TIER_NEEDLES, "cuts": TIER_CUTS}

    # the path: every count at 0 now, read at the phase's end
    IK.KERNEL_LAUNCHES = RL.KERNEL_LAUNCHES = 0

    # --- (a) and (b): one volume server ---
    taken: set = set()
    port = _port_pair(taken)
    argv = ["-dir", dirs[0], "-port", str(port), "-index", "lsm", "-batchLookup", "arena",
            "-storageBackend", "cuda"]
    held = _start_served(cli.cmd_volume, argv, "tier-volume")
    try:
        vs = held["servers"][0]
        addr = f"127.0.0.1:{port}"
        reply = asyncio.run(Stub(grpc_address(addr), "volume").call(
            "AllocateVolume", {"volume_id": 1, "collection": TIER_COLLECTION}))
        if reply:
            fail(f"AllocateVolume: {reply}")
        put = _tier_child(work, "put", ["--addr", addr, "--table", table_path])
        gc = vs._group_committers[1].stats
        res["batch_put"] = {"argv": argv, "frame": TIER_FRAME, "concurrency": TIER_CONCURRENCY,
                            **put, "fsyncs": gc["batches"],
                            "mean_batch_frames": gc["requests"] / gc["batches"],
                            "mean_batch_needles": put["needles"] / gc["batches"],
                            "largest_batch_frames": gc["largest_batch"]}
        k1_before = IK.KERNEL_LAUNCHES
        prof: dict = {}

        def read_all():
            prof["res"] = _tier_child(work, "read", ["--addr", addr, "--table", table_path])

        dev = profile_device(torch, read_all)
        k1 = IK.KERNEL_LAUNCHES - k1_before
        if k1 < prof["res"]["requests"]:
            fail(f"{prof['res']['requests']} BatchRead requests launched index_search {k1} times")
        kern = (dev["kernels"] or {}).get("index_search_kernel") or {}
        res["batch_read"] = {**prof["res"], "index_search_launches": k1,
                             "profiler_index_search": kern or None,
                             "device_busy_s": dev["device_busy_s"], "busy_share": dev["busy_share"],
                             "device_errors": dict(vs.device_errors)}
        if vs.device_errors:
            fail(f"volume tier server device errors: {vs.device_errors}")
    finally:
        res["ab_stop_s"] = _stop_served(held, SERVER_STOP_S)
    res["ab_s"] = time.perf_counter() - t_phase

    # --- (c) and (d): `server` + `volume -mserver`, replication 001 ---
    t_c = time.perf_counter()
    mport, vports = _port_pair(taken), [_port_pair(taken) for _ in dirs]
    maddr = f"127.0.0.1:{mport}"
    urls = [f"127.0.0.1:{p}" for p in vports]
    server_argv = ["-ip", "127.0.0.1", "-port", str(mport), "-volumePort", str(vports[0]),
                   "-dir", dirs[0], "-max", TIER_MAX_VOLUMES, "-defaultReplication", "001",
                   "-index", "lsm", "-batchLookup", "arena", "-storageBackend", "cuda"]
    volume_argv = ["-ip", "127.0.0.1", "-port", str(vports[1]), "-dir", dirs[1],
                   "-max", TIER_MAX_VOLUMES, "-mserver", maddr, "-index", "lsm",
                   "-batchLookup", "arena", "-storageBackend", "cuda"]
    served = [_start_served(cli.cmd_server, server_argv, "tier-server")]
    stopped = False
    try:
        served.append(_start_served(cli.cmd_volume, volume_argv, "tier-volume-2"))
        while True:
            st = _http_json(mport, "/dir/status")
            nodes = [dn["url"] for dc in st["Topology"]["data_centers"]
                     for rack in dc["racks"] for dn in rack["data_nodes"]]
            if len(nodes) == 2:
                break
            if time.perf_counter() - t_c > CLUSTER_START_S:
                fail(f"the master knows {nodes}, not 2 data nodes")
            time.sleep(0.1)
        res["cluster_start_s"] = time.perf_counter() - t_c
        seeds_path = os.path.join(root, "seeds.json")
        rl0 = RL.KERNEL_LAUNCHES
        bench = _tier_child(work, "bench", ["--addr", maddr, "--n", str(TIER_BENCH_N),
                                            "--seeds", seeds_path], timeout=900)
        res["cluster"] = {"server_argv": server_argv, "volume_argv": volume_argv, **bench,
                          "ragged_lookup_launches": RL.KERNEL_LAUNCHES - rl0,
                          "ragged_lookup_note": _K2_NOTE}
        rl0 = RL.KERNEL_LAUNCHES
        gets = _tier_child(work, "gets", ["--addr", maddr, "--table", table_path,
                                          "--n", str(TIER_GATED_GETS),
                                          "--concurrency", str(TIER_GATED_C)])
        gate = _http_json(vports[0], "/debug/needle_map")
        res["gated_gets"] = {"concurrency": TIER_GATED_C, **gets,
                             "ragged_lookup_launches": RL.KERNEL_LAUNCHES - rl0,
                             "gate": gate["gate"], "arena_errors": gate["device"]["errors"],
                             "device_errors": gate["device_errors"]}
        if res["gated_gets"]["ragged_lookup_launches"] <= 0:
            fail(f"the GETs of (a)'s volume launched ragged_lookup no time: {gate['gate']}")
        if gate["device"]["errors"] or any(gate["device_errors"].values()):
            fail(f"the server's gate: arena errors {gate['device']['errors']}, "
                 f"device errors {gate['device_errors']}")

        # --- (d) a 256 MiB file in 4 MiB chunks over both servers ---
        t_d = time.perf_counter()
        src = os.path.join(root, "big.bin")
        data = rng.integers(0, 256, TIER_FILE_BYTES, dtype=np.uint8).tobytes()
        with open(src, "wb") as f:
            f.write(data)
        out, up_wall = _port_cli(["upload", "-master", maddr, "-maxMB", str(TIER_CHUNK_MB),
                                  "-replication", "000", src])
        m = re.search(r"-> fid (\S+) \((\d+) bytes\)", out)
        if not m or int(m.group(2)) != TIER_FILE_BYTES:
            fail(f"upload: {out!r}")
        fid = m.group(1)

        def holder(f):
            r = asyncio.run(Stub(grpc_address(maddr), "master").call(
                "LookupVolume", {"volume_ids": [f.split(",")[0]]}))
            return r["volume_id_locations"][0]["locations"][0]["url"]

        mport_of = dict(zip(urls, vports))
        m_port = mport_of[holder(fid)]
        st, _, raw = _http_get(m_port, f"/{fid}?cm=false")
        chunks = json.loads(raw)["chunks"]
        where = [holder(c["fid"]) for c in chunks]
        if len(chunks) != TIER_FILE_BYTES // (TIER_CHUNK_MB * MIB) or len(set(where)) != 2:
            fail(f"the upload made {len(chunks)} chunks on {sorted(set(where))}")
        down = os.path.join(root, "down")
        os.makedirs(down)
        out, get_wall = _port_cli(["download", "-master", maddr, "-dir", down, fid])
        with open(os.path.join(down, fid.replace(",", "_")), "rb") as f:
            if f.read() != data:
                fail("the downloaded 256 MiB file differs from the uploaded one")
        cs = TIER_CHUNK_MB * MIB
        cross = next(k for k in range(len(where) - 1) if where[k] != where[k + 1])
        ranges = [(cs - 100, cs + 99), (10 * cs + 7, 13 * cs - 3),
                  ((cross + 1) * cs - 5000, (cross + 1) * cs + 4999)]
        for lo, hi in ranges:
            st, hd, got = _http_get(m_port, f"/{fid}", {"Range": f"bytes={lo}-{hi}"})
            if (st, hd.get("Content-Range"), got) != (
                    206, f"bytes {lo}-{hi}/{TIER_FILE_BYTES}", data[lo:hi + 1]):
                fail(f"range {lo}-{hi}: {st} {hd.get('Content-Range')}")
        st, _, _ = _http_get(m_port, f"/{fid}", method="DELETE")
        gone = [_http_get(mport_of[w], "/" + c["fid"])[0] for c, w in zip(chunks, where)]
        if st != 202 or gone != [404] * len(chunks):
            fail(f"manifest delete: {st}, chunk GETs after it {sorted(set(gone))}")
        res["chunked"] = {"bytes": TIER_FILE_BYTES, "chunks": len(chunks),
                          "chunks_per_server": {u: where.count(u) for u in urls},
                          "upload_wall_s": up_wall, "upload_GBps": TIER_FILE_BYTES / up_wall / 1e9,
                          "get_wall_s": get_wall, "get_GBps": TIER_FILE_BYTES / get_wall / 1e9,
                          "walls_note": "the CLI child's wall, its start-up included",
                          "ranges": ranges, "ranges_equal": True, "cross_server_boundary": cross + 1,
                          "deleted_chunks_404": len(gone), "d_s": time.perf_counter() - t_d}
        os.remove(src)
        shutil.rmtree(down)

        # --- (c) reads across the loss of one replica's server ---
        signal_path = os.path.join(root, "stop-now")
        stopped_path = os.path.join(root, "stopped")
        proc, out_path = _tier_child(work, "failover", [
            "--addr", maddr, "--n", str(TIER_FAILOVER_READS), "--seeds", seeds_path,
            "--signal", signal_path, "--stopped", stopped_path,
            "--stop-after", str(TIER_FAILOVER_STOP_AFTER)], wait=False)
        t_f = time.perf_counter()
        while not os.path.exists(signal_path):
            if proc.poll() is not None or time.perf_counter() - t_f > 300:
                break
            time.sleep(0.01)
        stop_s = _stop_served(served[1], SERVER_STOP_S)
        stopped = True
        open(stopped_path, "w").close()
        try:
            so, se = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            fail("the failover reads did not end in 600 s")
        fo = _tier_result("failover", proc.returncode, se, out_path)
        if fo["reads_after_stop"] < TIER_AFTER_STOP:
            fail(f"{fo['reads_after_stop']} reads after the replica's server stopped: {fo}")
        res["failover"] = {**fo, "stopped": urls[1], "stop_s": stop_s,
                           "breaker_opens": sum(b["opens"] for b in fo["breakers"].values())}
    finally:
        if len(served) > 1 and not stopped:
            _stop_served(served[1], SERVER_STOP_S)
        _stop_served(served[0], SERVER_STOP_S)
    res["kernel_launches"] = {"index_search": IK.KERNEL_LAUNCHES, "ragged_lookup": RL.KERNEL_LAUNCHES}
    res["phase_s"] = time.perf_counter() - t_phase
    shutil.rmtree(root, ignore_errors=True)
    emit(res)
    return res


# --- phase 15 ----------------------------------------------------------------
# `weed benchmark -size 1024` (cli.py:746-747) as filer files: paths
# /bench/d<i // 1024>/f<i>, 1,024 files a directory, the filer's -maxMB 4
# default (cli.py:444): one chunk a file. n cut from 1,048,576 (FILER_CUTS)
FILER_FILES = 1 << 16
FILER_DIR_FILES = 1024
# PUTs in flight: at 16 a PUT waits on its own chain (the WAL's fsync, its
# chunk's group commit); at 64 the write and upload gates group four times
# as many a flush, and the phase's PUTs take half the time or less
FILER_PUT_C = 64
FILER_GET_C = 256
FILER_ABSENT_SHARE = 0.1
FILER_OVERWRITE_SHARE = 0.01
FILER_DELETE_SHARE = 0.01
FILER_WARMUP_GETS = 4_096
FILER_RESTART_GETS = 10_000
FILER_RESTART_WARMUP = 1_000
FILER_LIST_PAGE = 1000  # the directory JSON's default limit (server/filer.py:1032)
FILER_RPC_PAGE = 1024  # ListEntries' default limit (server/filer.py:1253)
FILER_LIST_C = 8
FILER_DELETE_C = 16
FILER_PLAIN_PROBES = 65_536
FILER_MEMTABLE_DELETES = 64  # (g): deleted after the restart, tombstones in the memtable
FILER_PROFILED_GETS = 4_096  # the last pass, under the profiler
FILER_PROFILED_LAUNCHES = 1_000  # (g)'s profiler reading (50 came back empty)
FILER_STAGE_FLUSHES = 21  # (g)'s flushes through probe_groups, for their stage walls
FILER_GC_S = 60  # the GC loop's drain, bounded
_FILER_RATES = ("a calibration run of the whole script on an NVIDIA H100 80GB HBM3 at "
                "700.00 W put 851.9 files/s at c=16 (p50 15.8 ms a PUT: the write gate's "
                "5 ms linger and two fsyncs, not the card) and read 2,508.5 files/s at "
                "c=256, and took 148.1 s for this phase at 65,536 files")
FILER_CUTS = {
    "files": {
        "from": 1 << 20, "to": FILER_FILES,
        "why": "65,536 is the floor the phase keeps (several sealed runs of more than "
               "4,096 rows, so K2 runs its bucketed search); " + _FILER_RATES
               + ": 1,048,576 files would take over 30 minutes"},
}


def filer_client_main(argv: list) -> int:
    """Child mode of this script (`--filer-client MODE`): the load clients
    of phase 15, each in its own process so the filer keeps this script's
    interpreter to itself. Writes its result as JSON.

    put:       the plan's [path, blob]: PUT of the pool's blob, the reply
               checked
    get:       the plan's [path, blob]: GET, the body held to the blob
               (blob -1: 404 {"error": "not found"})
    status:    the plan's [method, path, status]: only the status checked
               (DELETEs, GETs of freed chunks at a volume server)
    list:      the plan's [directory, names]: the directory JSON paged by
               lastFileName and ListEntries paged by start_from_file_name,
               each equal to the names
    subscribe: SubscribeMetadata from 0 until the plan's last ts, the
               events counted by type and held to the plan's counts"""
    import asyncio

    import numpy as np

    sys.path.insert(0, HERE)
    ap = argparse.ArgumentParser()
    ap.add_argument("--filer-client", required=True,
                    choices=["put", "get", "status", "list", "subscribe"])
    ap.add_argument("--addr", required=True)
    ap.add_argument("--plan", required=True)
    ap.add_argument("--pool", default="")
    ap.add_argument("--out", required=True)
    ap.add_argument("--concurrency", type=int, default=FILER_PUT_C)
    a = ap.parse_args(argv)
    from seaweedfs_tpu_torch.pb import grpc_address
    from seaweedfs_tpu_torch.pb.rpc import Stub
    from seaweedfs_tpu_torch.util.fasthttp import FastHTTPClient

    with open(a.plan) as f:
        plan = json.load(f)
    pool = [b.tobytes() for b in np.load(a.pool)] if a.pool else []
    res: dict = {}
    mode = a.filer_client

    async def request(http, item):
        if mode == "put":
            path, blob = item
            st, got = await http.request("PUT", a.addr, path, pool[blob],
                                         "application/octet-stream", timeout=120)
            return st == 201 and json.loads(got) == {
                "name": path.rsplit("/", 1)[1], "size": len(pool[blob])}, st
        if mode == "get":
            path, blob = item
            st, got = await http.request("GET", a.addr, path, timeout=120)
            if blob < 0:
                return st == 404 and json.loads(got) == {"error": "not found"}, st
            return st == 200 and got == pool[blob], st
        if mode == "status":
            method, path, want = item
            st, _got = await http.request(method, a.addr, path, timeout=120)
            return st == want, st
        dpath, names = item  # list
        stub = Stub(grpc_address(a.addr), "filer")
        got, last, n = [], "", 0
        while True:
            q = f"?limit={FILER_LIST_PAGE}" + (f"&lastFileName={last}" if last else "")
            st, body = await http.request("GET", a.addr, dpath + q, timeout=120)
            n += 1
            page = json.loads(body)["Entries"] if st == 200 else []
            if st != 200 or any(e["Size"] != NEEDLE_BYTES or e["IsDirectory"] for e in page):
                return False, st
            got += [e["FullPath"].rsplit("/", 1)[1] for e in page]
            if len(page) < FILER_LIST_PAGE:
                break
            last = got[-1]
        rgot, start, incl = [], "", True
        while True:
            r = await stub.call("ListEntries", {"directory": dpath, "start_from_file_name": start,
                                                "inclusive_start_from": incl,
                                                "limit": FILER_RPC_PAGE}, timeout=120)
            n += 1
            rgot += [e["full_path"].rsplit("/", 1)[1] for e in r["entries"]]
            if len(r["entries"]) < FILER_RPC_PAGE:
                break
            start, incl = rgot[-1], False
        res["requests"] = res.get("requests", 0) + n - 1  # the caller counts one
        return got == names and rgot == names, 200

    async def run() -> None:
        http = FastHTTPClient(pool_per_host=a.concurrency + 4)
        todo = list(reversed(plan))
        lat, bad = [], []

        async def one() -> None:
            while todo:
                item = todo.pop()
                t0 = time.perf_counter()
                ok, st = await request(http, item)
                lat.append(time.perf_counter() - t0)
                if not ok:
                    bad.append((item if mode != "list" else item[0], st))

        t0 = time.perf_counter()
        await asyncio.gather(*(one() for _ in range(a.concurrency)))
        wall = time.perf_counter() - t0
        await http.close()
        srt = sorted(lat)
        res["requests"] = res.get("requests", 0) + len(lat)
        res.update(items=len(lat), concurrency=a.concurrency, wall_s=wall,
                   per_s=len(lat) / wall, p50_ms=srt[len(srt) // 2] * 1e3,
                   p99_ms=srt[min(len(srt) - 1, int(len(srt) * 0.99))] * 1e3,
                   bad=len(bad), bad_examples=[str(b)[:200] for b in bad[:5]])

    async def subscribe() -> None:
        want, last_ts = plan
        seen: dict = {}
        t0 = time.perf_counter()
        async for ev in Stub(grpc_address(a.addr), "filer").server_stream(
                "SubscribeMetadata", {"since_ns": 0}):
            t = ev["event_notification"]["event_type"]
            seen[t] = seen.get(t, 0) + 1
            if ev["ts_ns"] >= last_ts:
                break
        wall = time.perf_counter() - t0
        res.update(events=sum(seen.values()), by_type=seen, wall_s=wall,
                   events_per_s=sum(seen.values()) / wall,
                   bad=int(seen != want),
                   bad_examples=[f"got {seen}, expected {want}"] if seen != want else [])

    asyncio.run(subscribe() if mode == "subscribe" else run())
    with open(a.out, "w") as f:
        json.dump(res, f)
    return 0


def _filer_child(work: str, mode: str, addr: str, plan, pool_path: str = "",
                 concurrency: int = FILER_PUT_C, timeout: float = 600) -> dict:
    plan_path = os.path.join(work, f"filer-{mode}.plan.json")
    out = os.path.join(work, f"filer-{mode}.json")
    with open(plan_path, "w") as f:
        json.dump(plan, f)
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--filer-client", mode, "--addr", addr,
         "--plan", plan_path, "--pool", pool_path, "--out", out,
         "--concurrency", str(concurrency)],
        capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        fail(f"filer client {mode} exited {proc.returncode}: {proc.stderr[-2000:]}")
    with open(out) as f:
        res = json.load(f)
    os.remove(out)
    os.remove(plan_path)
    if res["bad"]:
        fail(f"filer client {mode}: {res['bad']} wrong answers, e.g. {res['bad_examples']}")
    return res


def _filer_rpc(addr: str, method: str, req: dict):
    import asyncio

    from seaweedfs_tpu_torch.pb import grpc_address
    from seaweedfs_tpu_torch.pb.rpc import Stub

    return asyncio.run(Stub(grpc_address(addr), "filer").call(method, req, timeout=120))


def _filer_fids(store, paths: list) -> dict:
    """path -> its chunks' fids, read from the filer's store (the script's
    bookkeeping; the store is thread-safe)."""
    found = store.find_many(paths)
    if len(found) != len(paths):
        fail(f"{len(paths) - len(found)} of {len(paths)} paths are not in the filer's store")
    return {p: [c.fid for c in e.chunks] for p, e in found.items()}


def _gate_counts(port: int) -> dict:
    g = _http_json(port, "/debug/meta_gate")
    return {"gate": g["gate"], "fallback_reasons": g["fallback_reasons"],
            "arena_errors": g["arena"]["errors"], "arena_last_error": g["arena"]["last_error"],
            "device_errors": g["device_errors"], "segments": g.get("segments"),
            "memtable": g.get("memtable"), "write_gate": g.get("write_gate"),
            "upload_gate": g.get("upload_gate"),
            "chunk_delete_rounds": g["chunk_delete_rounds"],
            "chunk_delete_pending": g["chunk_delete_pending"],
            "chunk_delete_inflight": g["chunk_delete_inflight"],
            # a filer child's own K2 launches and tensors on the card, its fleet
            # counters and its shards (phase 16)
            "ragged_lookup_launches": g.get("ragged_lookup_launches"),
            "device_memory": g.get("device_memory"), "fleet": g.get("fleet"),
            "shards": g.get("shards")}


def _gate_delta(before: dict, after: dict) -> dict:
    return {k: after["gate"][k] - before["gate"].get(k, 0) for k in after["gate"]
            if k != "largest_batch"}


def _check_clean(before: dict, after: dict, what: str) -> dict:
    """No host fallback (memtable hits have their own counter), identity
    mismatch, arena error or device error between two readings."""
    d = _gate_delta(before, after)
    if d["host_fallbacks"] or d["identity_mismatches"] or \
            after["arena_errors"] != before["arena_errors"] or after["device_errors"]:
        fail(f"{what}: gate {d}, fallbacks {after['fallback_reasons']}, arena errors "
             f"{after['arena_errors']} ({after['arena_last_error']}), device errors "
             f"{after['device_errors']}")
    return d


def _start_server_child(root: str, taken: set) -> dict:
    """Start `python -m seaweedfs_tpu_torch server -index lsm -batchLookup
    arena -storageBackend cuda` as a child process over a fresh directory
    (its own interpreter: the filer under test keeps this one); -> its
    Popen, master address and volume port. `_await_server_child` waits
    until the master knows its volume server."""
    sdir = os.path.join(root, "server")
    os.makedirs(sdir)
    # clear of the ports phase 14 picks while this child is still starting
    mport, vport = _port_pair(taken, 25000), _port_pair(taken, 25000)
    argv = ["server", "-ip", "127.0.0.1", "-port", str(mport), "-volumePort", str(vport),
            "-dir", sdir, "-max", "30", "-index", "lsm", "-batchLookup", "arena",
            "-storageBackend", "cuda"]
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    log = open(os.path.join(root, "server.log"), "wb")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "seaweedfs_tpu_torch", *argv], cwd=HERE,
                            env=env, stdout=log, stderr=subprocess.STDOUT)
    return {"proc": proc, "log": log, "argv": argv, "maddr": f"127.0.0.1:{mport}",
            "mport": mport, "vport": vport, "t0": t0, "taken": taken}


def _await_server_child(held: dict) -> None:
    proc, log, mport = held["proc"], held["log"], held["mport"]
    while True:
        if proc.poll() is not None:
            fail(f"the server exited {proc.returncode}: {_tail(log.name)}")
        try:
            st = _http_json(mport, "/dir/status")
            nodes = [dn for dc in st["Topology"]["data_centers"] for rack in dc["racks"]
                     for dn in rack["data_nodes"]]
            if nodes:
                break
        except (OSError, SystemExit):
            pass
        if time.perf_counter() - held["t0"] > SERVER_START_S:
            fail(f"the server did not register its volume server in {SERVER_START_S} s")
        time.sleep(0.2)
    held["ready_s"] = time.perf_counter() - held["t0"]


def _tail(path: str) -> str:
    with open(path, "rb") as f:
        return f.read()[-2000:].decode("latin1")


def _stop_server_child(held: dict) -> float:
    """SIGTERM (unless sent already: a second one could land after the
    child's handler is gone) and wait; fails unless it exits 0 in time."""
    import signal

    t0 = time.perf_counter()
    proc = held["proc"]
    name = held.get("name", "the server")
    if proc.poll() is None:
        if not held.get("signalled"):
            proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(SERVER_STOP_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            fail(f"{name} did not stop in {SERVER_STOP_S} s")
    held["log"].close()
    if proc.returncode != 0:
        fail(f"{name} exited {proc.returncode}: {_tail(held['log'].name)}")
    return time.perf_counter() - t0


def phase_filer(torch, work: str, seed: int, server: dict) -> dict:
    """The filer on the card. `filer -store <work>/filer.lsm -metaLog
    <work>/mlog -replication 000` through the CLI's entry function on an
    event-loop thread of this script (the meta gate at its default,
    `device`, on the process's arena), over `server -index lsm
    -batchLookup arena` in a child process; the load clients are children
    too (`--filer-client`). (b) PUTs, an overwrite of 1 %, a multipart
    POST and a 2-chunk file; (c) a warm-up, then the GETs of every file
    plus 10 % absent paths, K2 in each pass (`server` is the child the
    caller started, which this phase waits for and stops); (d) every
    directory listed
    through the JSON and ListEntries, paged, and a directory renamed; (e)
    1 % of the files and one directory deleted, their chunks freed; (f) a
    restart on the same store and meta-log (and the WAL of a copy taken
    while it served), GETs, SubscribeMetadata from 0; (g) ragged_lookup
    against its plain version on the filer's own generation."""
    import numpy as np

    from seaweedfs_tpu_torch.command import cli
    from seaweedfs_tpu_torch.filer.filer_store import _split
    from seaweedfs_tpu_torch.filer.lsm_store import LsmFilerStore, path_hash64
    from seaweedfs_tpu_torch.ops import index_kernel as IK
    from seaweedfs_tpu_torch.ops import ragged_lookup as RL
    from seaweedfs_tpu_torch.util.fasthttp import build_multipart

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 15)
    root = os.path.join(work, "filer")
    os.makedirs(root)
    n = FILER_FILES
    pool = rng.integers(0, 256, (256, NEEDLE_BYTES), dtype=np.uint8)
    pool_path = os.path.join(root, "pool.npy")
    np.save(pool_path, pool)
    path_of = [f"/bench/d{i // FILER_DIR_FILES}/f{i}" for i in range(n)]
    blob = rng.integers(0, len(pool), n)
    res: dict = {"phase": "filer", "files": n, "file_bytes": NEEDLE_BYTES,
                 "files_a_directory": FILER_DIR_FILES, "cuts": FILER_CUTS}
    # the path: every count at 0 now, read at the phase's end (the K2
    # launches of this process: the filer's meta gate)
    IK.KERNEL_LAUNCHES = RL.KERNEL_LAUNCHES = 0
    taken = server["taken"]
    try:
        t_wait = time.perf_counter()
        _await_server_child(server)
    except BaseException:
        _stop_server_child(server)
        raise
    res["server"] = {"argv": server["argv"], "process": "child",
                     "ready_s_after_its_start": server["ready_s"],
                     "waited_s": time.perf_counter() - t_wait}
    maddr, vport = server["maddr"], server["vport"]
    fport = _port_pair(taken)
    faddr = f"127.0.0.1:{fport}"
    filer_argv = ["-ip", "127.0.0.1", "-port", str(fport), "-master", maddr,
                  "-store", os.path.join(root, "filer.lsm"), "-metaLog", os.path.join(root, "mlog"),
                  "-replication", "000"]
    res["filer_argv"] = filer_argv
    held = None
    try:
        t0 = time.perf_counter()
        held = _start_served(cli.cmd_filer, filer_argv, "filer")
        fs = held["servers"][0]
        res["filer_start_s"] = time.perf_counter() - t0
        if fs.meta_gate_mode != "device" or fs.meta_gate.arena is None \
                or fs.meta_gate.arena.device.type != "cuda" or not fs.meta_gate.identity_check:
            fail(f"the filer's meta gate is {fs.meta_gate_mode}, arena "
                 f"{getattr(fs.meta_gate, 'arena', None)}")
        arena = fs.meta_gate.arena

        # --- (b) PUTs, the overwrite, a multipart POST, a 2-chunk file ---
        t0 = time.perf_counter()
        put = _filer_child(root, "put", faddr, [[path_of[i], int(blob[i])] for i in range(n)],
                           pool_path, FILER_PUT_C, timeout=900)
        g_put = _gate_counts(fport)
        res["put"] = {**put, "meta_gate": g_put["gate"], "fallback_reasons": g_put["fallback_reasons"],
                      "write_gate": g_put["write_gate"], "upload_gate": g_put["upload_gate"]}
        ow = np.sort(rng.choice(n, int(n * FILER_OVERWRITE_SHARE), replace=False))
        old_fids = _filer_fids(fs.filer.store, [path_of[i] for i in ow.tolist()])
        blob[ow] = (blob[ow] + 1) % len(pool)
        res["overwrite"] = _filer_child(root, "put", faddr,
                                        [[path_of[i], int(blob[i])] for i in ow.tolist()],
                                        pool_path, FILER_PUT_C)
        extra = {}
        mp_body, mp_ct = build_multipart("file", pool[3].tobytes(), "mp.bin", "text/plain")
        st, _, got = _http_get_body(fport, "/bench/d2/", "POST", mp_body, {"Content-Type": mp_ct})
        if st != 201 or json.loads(got) != {"name": "mp.bin", "size": NEEDLE_BYTES}:
            fail(f"multipart POST: {st} {got[:200]!r}")
        extra["/bench/d2/mp.bin"] = pool[3].tobytes()
        big = rng.integers(0, 256, 4 * MIB + NEEDLE_BYTES, dtype=np.uint8).tobytes()
        st, _, got = _http_get_body(fport, "/bench/big.bin", "PUT", big)
        if st != 201:
            fail(f"2-chunk PUT: {st} {got[:200]!r}")
        big_fids = _filer_fids(fs.filer.store, ["/bench/big.bin"])["/bench/big.bin"]
        if len(big_fids) != 2:
            fail(f"the 4 MiB + 1 KiB file has {len(big_fids)} chunks, not 2")
        extra["/bench/big.bin"] = big
        for p, want in extra.items():
            st, hd, got = _http_get_body(fport, p)
            if st != 200 or got != want:
                fail(f"GET {p}: {st}, {len(got)} bytes")
        res["b_s"] = time.perf_counter() - t0

        # --- (c) GETs: a warm-up, then every file plus 10 % absent ---
        t0 = time.perf_counter()
        warm = rng.integers(0, n, FILER_WARMUP_GETS)
        res["warmup"] = _filer_child(root, "get", faddr,
                                     [[path_of[i], int(blob[i])] for i in warm.tolist()],
                                     pool_path, FILER_GET_C)
        g0 = _gate_counts(fport)
        n_absent = int(n * FILER_ABSENT_SHARE)
        absent = [f"/bench/d{int(i) // FILER_DIR_FILES}/g{int(i)}"
                  for i in rng.integers(0, n, n_absent)]
        plan = [[path_of[i], int(blob[i])] for i in range(n)] + [[p, -1] for p in absent]
        plan = [plan[i] for i in rng.permutation(len(plan)).tolist()]
        rl0 = RL.KERNEL_LAUNCHES
        get = _filer_child(root, "get", faddr, plan, pool_path, FILER_GET_C)
        k2 = RL.KERNEL_LAUNCHES - rl0
        g1 = _gate_counts(fport)
        d = _check_clean(g0, g1, "the GETs after the warm-up")
        if k2 <= 0:
            fail(f"the GET pass launched ragged_lookup no time: {d}")
        res["get"] = {**get, "absent": n_absent, "identity_check": True,
                      "ragged_lookup_launches": k2, "meta_gate": d,
                      "largest_batch": g1["gate"]["largest_batch"],
                      "segments": g1["segments"], "memtable": g1["memtable"]}
        res["c_s"] = time.perf_counter() - t0

        # --- (d) listings, then a rename ---
        t0 = time.perf_counter()
        dirs = {}
        for i in range(n):
            dirs.setdefault(f"/bench/d{i // FILER_DIR_FILES}", []).append(f"f{i}")
        dirs["/bench/d2"].append("mp.bin")
        lst = _filer_child(root, "list", faddr, [[d_, sorted(names)] for d_, names in dirs.items()],
                           concurrency=FILER_LIST_C)
        res["listings"] = {"directories": len(dirs), "requests": lst["requests"],
                           "concurrency": FILER_LIST_C, "wall_s": lst["wall_s"],
                           "listings_per_s": 2 * len(dirs) / lst["wall_s"],
                           "requests_per_s": lst["requests"] / lst["wall_s"],
                           "note": "a listing is one directory through one API, all its pages"}
        t1 = time.perf_counter()
        r = _filer_rpc(faddr, "AtomicRenameEntry", {"old_directory": "/bench", "old_name": "d0",
                                                    "new_directory": "/bench", "new_name": "r0"})
        if r.get("error"):
            fail(f"AtomicRenameEntry: {r}")
        renamed = list(range(min(n, FILER_DIR_FILES)))
        for i in renamed:
            path_of[i] = f"/bench/r0/f{i}"
        res["rename"] = {"files": len(renamed), "rename_s": time.perf_counter() - t1,
                         **_filer_child(root, "get", faddr,
                                        [[path_of[i], int(blob[i])] for i in renamed]
                                        + [[f"/bench/d0/f{i}", -1] for i in renamed[:100]],
                                        pool_path, FILER_GET_C)}
        res["d_s"] = time.perf_counter() - t0

        # --- (e) deletes: 1 % of the files and one directory ---
        t0 = time.perf_counter()
        gone_dir = "/bench/d1"
        in_gone = [i for i in range(n) if path_of[i].startswith(gone_dir + "/")]
        pickable = np.arange(2 * FILER_DIR_FILES, n)  # not in the renamed or the deleted directory
        dels = np.sort(rng.choice(pickable, int(n * FILER_DELETE_SHARE), replace=False)).tolist()
        fids = _filer_fids(fs.filer.store, [path_of[i] for i in dels + in_gone])
        rounds0 = _gate_counts(fport)["chunk_delete_rounds"]
        res["delete"] = {"files": len(dels), "directory": gone_dir, "directory_files": len(in_gone),
                         "deletes": _filer_child(root, "status", faddr,
                                                 [["DELETE", path_of[i], 204] for i in dels]
                                                 + [["DELETE", gone_dir + "?recursive=true", 204]],
                                                 concurrency=FILER_DELETE_C)}
        deleted = set(dels) | set(in_gone)
        check = _filer_child(root, "get", faddr, [[path_of[i], -1] for i in sorted(deleted)],
                             pool_path, FILER_GET_C)
        t_gc = time.perf_counter()
        while True:
            g = _gate_counts(fport)
            if (g["chunk_delete_pending"] == 0 and not g["chunk_delete_inflight"]
                    and g["chunk_delete_rounds"] > rounds0):
                break
            if time.perf_counter() - t_gc > FILER_GC_S:
                fail(f"the chunk GC did not drain in {FILER_GC_S} s: {g}")
            time.sleep(0.05)
        gc_s = time.perf_counter() - t_gc
        freed = [f for fl in fids.values() for f in fl] + [f for fl in old_fids.values() for f in fl]
        gone = _filer_child(root, "status", f"127.0.0.1:{vport}",
                            [["GET", "/" + fid, 404] for fid in freed], concurrency=FILER_DELETE_C)
        res["delete"].update(gets_404=check["items"], gc_wait_s=gc_s, chunks_freed_404=gone["items"],
                             overwritten_chunks_freed=sum(len(v) for v in old_fids.values()),
                             gc_rounds=g["chunk_delete_rounds"])
        res["e_s"] = time.perf_counter() - t0

        # --- (f) the restart ---
        t0 = time.perf_counter()
        store_dir = os.path.join(root, "filer.lsm")
        crash = os.path.join(root, "crash.lsm")
        os.makedirs(crash)
        for fn in os.listdir(store_dir):  # the files as they stand while it serves
            if fn != "LOCK":
                shutil.copyfile(os.path.join(store_dir, fn), os.path.join(crash, fn))
        wal_n = len(fs.filer.store._mem)
        stop_s = _stop_served(held, SERVER_STOP_S)
        held = None
        t1 = time.perf_counter()
        held = _start_served(cli.cmd_filer, filer_argv, "filer-restarted")
        fs = held["servers"][0]
        res["restart"] = {"stop_s": stop_s, "start_s": time.perf_counter() - t1,
                          "wall_s": time.perf_counter() - t0}
        # the crash image: its WAL replays into the memtable
        t1 = time.perf_counter()
        cs = LsmFilerStore(crash, fsync=False)
        replayed = len(cs._mem)
        sample = rng.choice(n, 1000, replace=False).tolist()
        for i in sample:
            e = cs.find_entry(path_of[i])
            if (e is None) != (i in deleted):
                fail(f"the crash image's {path_of[i]}: {e}")
        cs._flush_memtable = lambda: None  # a crash image: nothing written back
        cs.close()
        if replayed != wal_n:
            fail(f"the crash image's WAL replayed {replayed} entries, the memtable held {wal_n}")
        res["restart"]["crash_image"] = {"memtable_entries_replayed": replayed,
                                         "segments": sum(fn.startswith("seg-")
                                                         for fn in os.listdir(crash)),
                                         "checked": len(sample), "s": time.perf_counter() - t1}
        live = [i for i in range(n) if i not in deleted]
        rw = rng.choice(live, FILER_RESTART_WARMUP).tolist()
        res["restart"]["warmup"] = _filer_child(
            root, "get", faddr, [[path_of[i], int(blob[i])] for i in rw], pool_path, FILER_GET_C)
        g0 = _gate_counts(fport)
        pick = rng.choice(n, FILER_RESTART_GETS, replace=False).tolist()
        rplan = [[path_of[i], -1 if i in deleted else int(blob[i])] for i in pick]
        rl0 = RL.KERNEL_LAUNCHES
        rget = _filer_child(root, "get", faddr, rplan, pool_path, FILER_GET_C)
        g1 = _gate_counts(fport)
        d = _check_clean(g0, g1, "the GETs after the restart's warm-up")
        if RL.KERNEL_LAUNCHES - rl0 <= 0:
            fail(f"the GETs after the restart launched ragged_lookup no time: {d}")
        res["restart"]["get"] = {**rget, "ragged_lookup_launches": RL.KERNEL_LAUNCHES - rl0,
                                 "meta_gate": d}
        # SubscribeMetadata from 0: one event per create, update, rename, delete
        last_ts = _filer_rpc(faddr, "GetFilerConfiguration", {})["last_ts_ns"]
        want = {"create": n + 2, "update": len(ow), "rename": len(renamed) + 1,
                "delete": len(dels) + len(in_gone) + 1}
        res["restart"]["subscribe"] = _filer_child(root, "subscribe", faddr, [want, last_ts])
        res["f_s"] = time.perf_counter() - t0

        # --- (g) ragged_lookup against its plain version on the filer's generation ---
        t0 = time.perf_counter()
        store = fs.filer.store
        # paths deleted now: their tombstones sit in the memtable, their
        # rows in the sealed runs the kernel searches
        mem_dead = [path_of[i] for i in rng.choice(live, FILER_MEMTABLE_DELETES, replace=False).tolist()]
        for p in mem_dead:
            st, _, body = _http_get_body(fport, p, "DELETE")
            if st != 204 or fs.filer.store.find_entry(p) is not None:
                fail(f"DELETE {p}: {st} {body[:200]!r}")
        # the path's launches so far; the comparisons and timings below are
        # not the path's, and the count is put back after them
        counted = RL.KERNEL_LAUNCHES
        largest = max(res["get"]["largest_batch"], 1)
        mem_set = set(mem_dead)
        hits = [path_of[i] for i in live if path_of[i] not in mem_set]
        misses = [f"/bench/d{i % 64}/none{i}" for i in range(len(hits))]
        dead = [path_of[i] for i in sorted(deleted)] + mem_dead
        timing, worst = {}, 0
        for n_probes in (largest, FILER_PLAIN_PROBES):
            k_dead = max(1, n_probes // 20)
            k_miss = max(1, n_probes // 10)
            k_hit = max(0, n_probes - k_dead - k_miss)
            paths = ([hits[i] for i in rng.integers(0, len(hits), k_hit)]
                     + [misses[i] for i in rng.integers(0, len(misses), k_miss)]
                     + [dead[i] for i in rng.integers(0, len(dead), k_dead)])[:n_probes]
            keys = np.fromiter((path_hash64(*_split(p)) for p in paths), dtype=np.uint64,
                               count=len(paths))
            mem_hits, segs = store.arena_view(paths)
            gen = arena.ensure(segs)
            if gen is None:
                arena.refresh_sync()
                gen = arena.ensure(segs)
            if gen is None:
                fail("the filer's segments are not resident after a refresh")
            got = k2_against_plain(torch, np, RL, gen, [(0, segs, keys)],
                                   f"on the filer's generation at {n_probes} probes",
                                   FILER_PROFILED_LAUNCHES)
            worst = max(worst, got["max_abs_err"])
            # a flush's stage walls through the entry point, at this size
            walls, want = [], None
            for _ in range(FILER_STAGE_FLUSHES):
                t = {}
                r = arena.probe_groups([(segs, keys)], timings=t)[0]
                want = want or r
                if any(not np.array_equal(r[k], want[k]) for k in want):
                    fail(f"probe_groups answered otherwise across flushes of {n_probes}")
                walls.append(t)
            if int(want["found"].sum()) != got["found"]:
                fail(f"probe_groups found {int(want['found'].sum())} of {n_probes}, "
                     f"the kernel {got['found']}")
            timing[str(n_probes)] = {
                "probes": len(paths),
                "memtable_tombstones": sum(v is None for v in mem_hits.values()),
                "segments": [s.count for s in segs], **got,
                "stage_walls_s": {k: sorted(w[k] for w in walls)[len(walls) // 2]
                                  for k in ("pack_s", "upload_s", "dispatch_s", "readback_s")},
                "stage_walls_from": f"median of {FILER_STAGE_FLUSHES} probe_groups calls",
            }
        res["ragged_lookup"] = {"on": "the filer's generation", "equal_to_plain": True,
                                "max_abs_err": worst, **timing}
        res["g_s"] = time.perf_counter() - t0
        RL.KERNEL_LAUNCHES = counted
        res["path_launches_before_g"] = counted

        # a last GET pass under the profiler: K2's device ms a launch and the
        # card's busy share while the filer serves
        g0 = _gate_counts(fport)
        rl0 = RL.KERNEL_LAUNCHES
        pick = rng.choice(live, FILER_PROFILED_GETS).tolist()
        prof: dict = {}

        def profiled_gets():
            prof["res"] = _filer_child(root, "get", faddr, [
                [path_of[i], -1 if path_of[i] in mem_set else int(blob[i])] for i in pick],
                pool_path, FILER_GET_C)

        dev = profile_device(torch, profiled_gets)
        d = _check_clean(g0, _gate_counts(fport), "the profiled GETs")
        if RL.KERNEL_LAUNCHES - rl0 <= 0:
            fail(f"the profiled GETs launched ragged_lookup no time: {d}")
        kern = (dev["kernels"] or {}).get("ragged_probe_kernel") or {}
        res["profiled_get"] = {**prof["res"], "ragged_lookup_launches": RL.KERNEL_LAUNCHES - rl0,
                               "profiler_ragged_lookup": kern or None,
                               "device_busy_s": dev["device_busy_s"],
                               "busy_share": dev["busy_share"], "meta_gate": d}
        res["store"] = {"segments": [len(s.keys) for s in store._segments],
                        "memtable": len(store._mem), "arena": arena.stats()}
    finally:
        if held is not None:
            res["stop_s"] = _stop_served(held, SERVER_STOP_S)
    res["server"]["kept_for"] = "phase 16, which stops it"
    res["kernel_launches"] = {"index_search": IK.KERNEL_LAUNCHES, "ragged_lookup": RL.KERNEL_LAUNCHES}
    res["phase_s"] = time.perf_counter() - t_phase
    shutil.rmtree(root, ignore_errors=True)
    emit(res)
    return res


def _http_get_body(port: int, path: str, method: str = "GET", body: bytes = b"",
                   headers: dict | None = None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body or None, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


# --- phase 16: the metadata fleet ---------------------------------------------------------

FLEET_MEMBERS = 4  # the JAX leg's largest fleet (bench.py measure_meta_fleet)
FLEET_DIRS = 64
FLEET_DIR_FILES = 1024  # 65,536 entries: phase 15's namespace size
FLEET_CREATE_CHILDREN = 4
FLEET_CREATE_C = 16  # a create child's creates in flight: 64 in all
FLEET_FORWARD_SHARE = 0.1  # creates sent to a member that does not own the path
FLEET_ABSENT_SHARE = 0.1
FLEET_DRIVERS = 4  # meta_fleet_driver children a pass, at c=24 each (bench.py:7385-7386)
FLEET_DRIVER_C = 24
FLEET_WARMUP = 1_024  # lookups a member (and the follower) before its counted passes
FLEET_ALONE_LOOKUPS = 2_048  # a member's pass alone: a seeded sample of its range (FLEET_CUTS)
FLEET_TOGETHER_LOOKUPS = 16_384  # the fleet's pass: a seeded sample (FLEET_CUTS)
FLEET_MOVE_LOOKUPS = 2_048  # (d)'s lookups through each member: a seeded sample (FLEET_CUTS)
FLEET_COMPARE_CHILDREN = 4  # (e): the follower against member 0, a quarter of the paths each
FLEET_CHURN_C = 8
FLEET_CHURN_S = 1.0  # the move's client runs this long before the move and after its commit
FLEET_CHURN_CREATES = 50_000  # paths the churn clients may create; they stop on a file first
FLEET_PEER_FILES = 256  # creates on each of the two peers
FLEET_SHARD_DIRS = ("/0a", "/0b", "/5a", "/5b", "/aa", "/ab", "/ea", "/eb",
                    "/ka", "/kb", "/na", "/nb", "/ta", "/tb", "/xa", "/xb")  # 4 in each default band
FLEET_SHARD_FILES = 1024  # a directory: 16,384 entries
FLEET_SHARD_HOT = ("/ka", "/kb", "/na", "/nb")  # the band the rebalance client's lookups heat
# the JAX package's rebalance knobs, set so a rebalance comes within one tick of the
# filer's rebalance loop (5 s) while the writes go on
FLEET_SHARD_ENV = {"SEAWEEDFS_TPU_META_REBALANCE_FACTOR": "1.5",
                   "SEAWEEDFS_TPU_META_REBALANCE_MIN_HEAT": "32",
                   "SEAWEEDFS_TPU_META_REBALANCE_INTERVAL": "1"}
FLEET_REBALANCE_S = 60
FLEET_START_S = 120
_FLEET_TIME = ("a first run of this phase alone on an NVIDIA H100 80GB HBM3 at 700.00 W took "
               "301.4 s; the script's earlier phases took 679.3 s in a whole run on another "
               "host of that kind, and the whole script must stay near 780 s")
FLEET_CUTS = {
    "per_member_lookups": {
        "from": "every path of the member's range plus 10 % absent (about 18,000)",
        "to": FLEET_ALONE_LOOKUPS,
        "why": "a member alone answered 942.8-1,344.7 lookups/s, so the four passes took "
               "61.2 s; " + _FLEET_TIME},
    "fleet_lookups": {
        "from": "every path plus 10 % absent (72,089)", "to": FLEET_TOGETHER_LOOKUPS,
        "why": "the four together answered 2,207.4 lookups/s (32.7 s); every entry is still "
               "read back exactly, its name, key order and etag, by ListEntries of every "
               "directory at its owner; " + _FLEET_TIME},
    "move_lookups": {
        "from": "every entry of the moved range (9,425) through each member",
        "to": f"{FLEET_MOVE_LOOKUPS} through each",
        "why": "the destination answered 1,202.7/s (7.8 s), the source, which forwards each, "
               "492.2/s (19.1 s); every moved entry is still read back exactly through both "
               "by ListEntries of the moved directories (the source forwards them); "
               + _FLEET_TIME},
    "sharded_lookups": {
        "from": "every entry by LookupDirectoryEntry (16,456, 10.7 s)",
        "to": "every entry by ListEntries, its name, key order and etag",
        "why": "the listing reads every entry back exactly; " + _FLEET_TIME},
}


def _fleet_entry(path: str, etag: str) -> dict:
    return {"full_path": path, "attr": {"mtime": 1.0, "crtime": 1.0}, "extended": {"etag": etag}}


def fleet_client_main(argv: list) -> int:
    """Child mode of this script (`--fleet-client MODE`): the creating and
    comparing clients of phase 16, each in its own process. Writes its
    result as JSON.

    create:  the plan's [address, path, etag]: CreateEntry, no error
    churn:   {addrs, creates, lookups, stop, ready}: each worker creates the
             next path through one member and looks it up through the next
             (its etag checked), then looks up a preloaded path, until the
             file `stop` exists
    compare: {a, b, paths}: LookupDirectoryEntry of each path at a and at b,
             the two answers equal"""
    import asyncio
    import random

    sys.path.insert(0, HERE)
    ap = argparse.ArgumentParser()
    ap.add_argument("--fleet-client", required=True, choices=["create", "churn", "compare"])
    ap.add_argument("--plan", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--concurrency", type=int, default=FLEET_CREATE_C)
    a = ap.parse_args(argv)
    from seaweedfs_tpu_torch.pb import grpc_address
    from seaweedfs_tpu_torch.pb.rpc import Stub

    with open(a.plan) as f:
        plan = json.load(f)
    mode = a.fleet_client
    stubs: dict = {}
    res: dict = {}
    lat, bad = [], []

    def stub(addr: str):
        if addr not in stubs:
            stubs[addr] = Stub(grpc_address(addr), "filer")
        return stubs[addr]

    async def lookup(addr: str, path: str) -> dict:
        d, name = path.rsplit("/", 1)
        return await stub(addr).call("LookupDirectoryEntry", {"directory": d, "name": name},
                                     timeout=120)

    def etag_ok(r: dict, path: str, etag) -> bool:
        e = r.get("entry")
        if etag is None:
            return e is None and r.get("error") == "not found"
        return e is not None and e["full_path"] == path and \
            (e.get("extended") or {}).get("etag") == etag

    async def run() -> None:
        todo = list(reversed(plan if mode != "compare" else plan["paths"]))
        found = [0]

        async def one() -> None:
            while todo:
                item = todo.pop()
                t0 = time.perf_counter()
                if mode == "create":
                    addr, path, etag = item
                    r = await stub(addr).call("CreateEntry", {"entry": _fleet_entry(path, etag)},
                                              timeout=120)
                    ok = not r.get("error")
                else:
                    ra, rb = await asyncio.gather(lookup(plan["a"], item), lookup(plan["b"], item))
                    ok = ra == rb and (ra.get("entry") is not None
                                       or ra.get("error") == "not found")
                    found[0] += ra.get("entry") is not None
                    r = {"a": ra, "b": rb}
                lat.append(time.perf_counter() - t0)
                if not ok:
                    bad.append((item, r))

        t0 = time.perf_counter()
        await asyncio.gather(*(one() for _ in range(a.concurrency)))
        wall = time.perf_counter() - t0
        srt = sorted(lat) or [0.0]
        res.update(items=len(lat), concurrency=a.concurrency, wall_s=wall,
                   per_s=len(lat) / wall if wall else 0.0, p50_ms=srt[len(srt) // 2] * 1e3,
                   p99_ms=srt[min(len(srt) - 1, int(len(srt) * 0.99))] * 1e3)
        if mode == "compare":
            res["found"] = found[0]

    async def churn() -> None:
        addrs, creates, looks = plan["addrs"], plan["creates"], plan["lookups"]
        rnd = random.Random(len(creates))
        nxt, created, counts = [0], [], {"creates": 0, "lookups": 0}

        async def one() -> None:
            while not os.path.exists(plan["stop"]) and nxt[0] < len(creates):
                i = nxt[0]
                nxt[0] += 1
                path, etag = creates[i]
                w = addrs[i % len(addrs)]
                r = await stub(w).call("CreateEntry", {"entry": _fleet_entry(path, etag)},
                                       timeout=120)
                counts["creates"] += 1
                if r.get("error"):
                    bad.append((path, "create", w, r))
                    continue
                created.append(i)
                # read back through the other member, then a preloaded path
                for addr, (p, t) in ((addrs[(i + 1) % len(addrs)], (path, etag)),
                                     (addrs[rnd.randrange(len(addrs))],
                                      looks[rnd.randrange(len(looks))])):
                    r = await lookup(addr, p)
                    counts["lookups"] += 1
                    if not etag_ok(r, p, t):
                        bad.append((p, "lookup", addr, r))

        open(plan["ready"], "w").close()
        t0 = time.perf_counter()
        await asyncio.gather(*(one() for _ in range(a.concurrency)))
        res.update(created=sorted(created), wall_s=time.perf_counter() - t0, **counts)

    asyncio.run(churn() if mode == "churn" else run())
    res.update(bad=len(bad), bad_examples=[str(b)[:300] for b in bad[:5]])
    with open(a.out, "w") as f:
        json.dump(res, f)
    return 0


def _fleet_client(root: str, mode: str, plan, concurrency: int) -> dict:
    """Start a `--fleet-client MODE` child; `_fleet_client_result` waits."""
    tag = f"{mode}-{len(os.listdir(root))}-{time.perf_counter_ns()}"
    plan_path = os.path.join(root, f"fleet-{tag}.plan.json")
    with open(plan_path, "w") as f:
        json.dump(plan, f)
    out = os.path.join(root, f"fleet-{tag}.json")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--fleet-client", mode, "--plan", plan_path,
         "--out", out, "--concurrency", str(concurrency)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return {"proc": proc, "out": out, "plan": plan_path, "mode": mode}


def _fleet_client_result(held: dict, timeout: float = 600) -> dict:
    proc = held["proc"]
    try:
        _o, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"fleet client {held['mode']} did not end in {timeout} s")
    if proc.returncode != 0:
        fail(f"fleet client {held['mode']} exited {proc.returncode}: {err[-2000:]}")
    with open(held["out"]) as f:
        res = json.load(f)
    os.remove(held["out"])
    os.remove(held["plan"])
    if res["bad"]:
        fail(f"fleet client {held['mode']}: {res['bad']} wrong answers, e.g. {res['bad_examples']}")
    return res


def _fleet_drivers(root: str, kind: str, items: list, addresses: list, bounds: list,
                   tag: str, drivers: int = FLEET_DRIVERS) -> dict:
    """A pass of `python -m seaweedfs_tpu_torch.ops.meta_fleet_driver` children (the
    port's load driver, as bench.py's run_drivers spawns the JAX one): each
    takes a slice of the items, every child parses and connects, then a go
    file starts them together. Every answer is checked by the driver (the
    etag, `not found` for an absent path, a listing's count); any error or
    mismatch fails."""
    go = os.path.join(root, f"go-{tag}")
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    share = (len(items) + drivers - 1) // drivers
    procs = []
    for k in range(drivers):
        spec = os.path.join(root, f"go-{tag}.spec{k}")
        with open(spec, "w") as f:
            json.dump({"kind": kind, "addresses": addresses, "bounds": bounds,
                       "items": items[k * share:(k + 1) * share],
                       "concurrency": FLEET_DRIVER_C, "go_file": go}, f)
        with open(spec) as f:  # the driver reads its spec on stdin
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "seaweedfs_tpu_torch.ops.meta_fleet_driver"], cwd=HERE,
                env=env, stdin=f, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    t0 = time.perf_counter()
    while sum(f.startswith(f"go-{tag}.ready.") for f in os.listdir(root)) < drivers:
        if any(p.poll() is not None for p in procs) or time.perf_counter() - t0 > 120:
            break
        time.sleep(0.01)
    open(go, "w").close()
    n = errors = mismatches = 0
    wall = 0.0
    try:
        for p in procs:
            try:
                raw, err = p.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                fail(f"fleet driver pass {tag} did not end in 600 s")
            if p.returncode != 0:
                fail(f"fleet driver ({tag}) exited {p.returncode}: "
                     f"{err.decode('latin1')[-2000:]}")
            r = json.loads(raw)
            n += r["n"]
            errors += r["errors"]
            mismatches += r["mismatches"]
            wall = max(wall, r["wall_s"])
    finally:
        for q in procs:  # what a failure left running
            if q.poll() is None:
                q.kill()
                q.wait()
    for f in os.listdir(root):
        if f.startswith(f"go-{tag}"):
            os.remove(os.path.join(root, f))
    if errors or mismatches or n != len(items):
        fail(f"fleet driver pass {tag}: {n} of {len(items)} answered, {errors} errors, "
             f"{mismatches} wrong answers")
    return {"n": n, "wall_s": wall, "per_s": n / wall if wall else 0.0, "drivers": drivers,
            "concurrency": FLEET_DRIVER_C}


def _start_filer_child(root: str, name: str, argv: list, extra_env: dict | None = None) -> dict:
    """`python -m seaweedfs_tpu_torch filer ARGV` as a child process (its meta gate at the
    default, `device`, on the child's own arena on cuda:0)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra_env or {})
    log = open(os.path.join(root, f"{name}.log"), "wb")
    port = int(argv[argv.index("-port") + 1])
    proc = subprocess.Popen([sys.executable, "-m", "seaweedfs_tpu_torch", "filer", *argv],
                            cwd=HERE, env=env, stdout=log, stderr=subprocess.STDOUT)
    return {"name": f"filer {name}", "proc": proc, "log": log, "argv": argv, "port": port,
            "addr": f"127.0.0.1:{port}", "t0": time.perf_counter()}


def _await_filer_child(held: dict) -> None:
    while True:
        if held["proc"].poll() is not None:
            fail(f"{held['name']} exited {held['proc'].returncode}: {_tail(held['log'].name)}")
        try:
            g = _http_json(held["port"], "/debug/meta_gate")
            break
        except (OSError, SystemExit):
            pass
        if time.perf_counter() - held["t0"] > FLEET_START_S:
            fail(f"{held['name']} did not answer in {FLEET_START_S} s: "
                 f"{_tail(held['log'].name)}")
        time.sleep(0.1)
    held["ready_s"] = time.perf_counter() - held["t0"]
    if g["mode"] != "device" or not g.get("arena") or not g["arena"]["device"].startswith("cuda"):
        fail(f"{held['name']}'s meta gate is {g['mode']} on {g.get('arena')}")


def _child_gate(held: dict) -> dict:
    return _gate_counts(held["port"])


def _fleet_clean(before: dict, after: dict, what: str) -> dict:
    """`_check_clean` between two readings of a filer child's gate, and at least
    one K2 device batch and launch between them."""
    d = _check_clean(before, after, what)
    d["ragged_lookup_launches"] = after["ragged_lookup_launches"] - before["ragged_lookup_launches"]
    if d["device_batches"] <= 0 or d["ragged_lookup_launches"] <= 0:
        fail(f"{what}: no K2 device batch or launch: {d}")
    return d


def _filer_rpc_many(addr: str, reqs: list) -> list:
    """LookupDirectoryEntry of each request at `addr`, in order."""
    import asyncio

    from seaweedfs_tpu_torch.pb import grpc_address
    from seaweedfs_tpu_torch.pb.rpc import Stub

    async def go() -> list:
        stub = Stub(grpc_address(addr), "filer")
        return [await stub.call("LookupDirectoryEntry", r, timeout=120) for r in reqs]

    return asyncio.run(go())


def _list_dir(addr: str, d: str) -> list:
    """The entries of directory `d` at `addr`: ListEntries paged by
    start_from_file_name, in the order the filer answers."""
    import asyncio

    from seaweedfs_tpu_torch.pb import grpc_address
    from seaweedfs_tpu_torch.pb.rpc import Stub

    async def go() -> list:
        stub = Stub(grpc_address(addr), "filer")
        got, start, incl = [], "", True
        while True:
            r = await stub.call("ListEntries", {
                "directory": d, "start_from_file_name": start, "inclusive_start_from": incl,
                "limit": FILER_RPC_PAGE}, timeout=120)
            if r.get("error"):
                fail(f"ListEntries {d} at {addr}: {r}")
            got += r["entries"]
            if len(r["entries"]) < FILER_RPC_PAGE:
                return got
            start, incl = got[-1]["full_path"].rsplit("/", 1)[1], False

    return asyncio.run(go())


def _by_dir(etag: dict) -> dict:
    """{directory: [(name, etag)] in key order} of path -> etag."""
    out: dict = {}
    for p, t in etag.items():
        d, name = p.rsplit("/", 1)
        out.setdefault(d, []).append((name, t))
    return {d: sorted(v) for d, v in out.items()}


def _check_listings(addr: str, want: dict, dirs, what: str) -> int:
    """Every directory of `dirs` at `addr` lists exactly the (name, etag) pairs
    `want` holds for it, in key order; -> the entries listed."""
    n = 0
    for d in dirs:
        got = [(e["full_path"].rsplit("/", 1)[1], (e.get("extended") or {}).get("etag"))
               for e in _list_dir(addr, d)]
        if got != want.get(d, []):
            fail(f"{what}: {d} lists {len(got)} entries, not the {len(want.get(d, []))} "
                 f"written, in key order with their etags")
        n += len(got)
    return n


def _subscribe_creates(addr: str, prefix: str, want: int, bound_s: float) -> int:
    """SubscribeMetadata from 0 at `addr` until `want` creates under `prefix` have come."""
    import asyncio

    from seaweedfs_tpu_torch.pb import grpc_address
    from seaweedfs_tpu_torch.pb.rpc import Stub

    async def go() -> int:
        seen = 0
        async for ev in Stub(grpc_address(addr), "filer").server_stream(
                "SubscribeMetadata", {"since_ns": 0}):
            n = ev["event_notification"]
            if n["event_type"] == "create" and \
                    (n.get("new_entry") or {}).get("full_path", "").startswith(prefix):
                seen += 1
                if seen >= want:
                    break
        return seen

    try:
        return asyncio.run(asyncio.wait_for(go(), bound_s))
    except asyncio.TimeoutError:
        fail(f"SubscribeMetadata at {addr} did not show {want} creates under {prefix} "
             f"in {bound_s} s")


def phase_fleet(torch, work: str, seed: int, server: dict) -> dict:
    """The filer's scale-out on the card: four `filer -fleetMap` members (LSM
    stores, each meta gate at the default, `device`, on its own process's
    arena: K2 with the identity check on), a follower of member 0, two
    `-peers` filers and a `-shards 4` filer, all children of this script over
    phase 15's `server` child (their master), which this phase stops. (b) the
    preload through CreateEntry, 10 % of it sent to a member that does not own
    the path, with the sharded filer's and the peers' creates beside it; (c)
    lookups and LISTs through the port's meta_fleet_driver, each member alone
    and the fleet together; (d) a live range move under a creating and
    reading client; (e) the follower; (f) the peers and the sharded store's
    rebalance; (g) `shell meta.fleet.status`."""
    import bisect

    import numpy as np

    from seaweedfs_tpu_torch.filer import fleet as FL

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 16)
    root = os.path.join(work, "fleet")
    os.makedirs(root)
    taken = server["taken"]
    maddr = server["maddr"]
    res: dict = {"phase": "fleet", "members": FLEET_MEMBERS, "directories": FLEET_DIRS,
                 "entries": FLEET_DIRS * FLEET_DIR_FILES, "cuts": FLEET_CUTS}
    smi_before = nvidia_smi("memory.used")
    dirs = [f"/fleet/d{i:03d}" for i in range(FLEET_DIRS)]
    # bounds that split the real directory keyspace evenly (bench.py:7457-7460)
    bounds = [dirs[FLEET_DIRS * (i + 1) // FLEET_MEMBERS] for i in range(FLEET_MEMBERS - 1)]
    roles = [f"m{i}" for i in range(FLEET_MEMBERS)] + ["follower", "p0", "p1", "sharded"]
    ports = {r: _port_pair(taken) for r in roles}
    addr = {r: f"127.0.0.1:{p}" for r, p in ports.items()}
    members = [addr[f"m{i}"] for i in range(FLEET_MEMBERS)]
    fmap_path = os.path.join(root, "FLEETMAP")
    fmap = FL.FleetMap(members, bounds)
    FL.write_fleet_map(fmap_path, fmap)
    base = ["-ip", "127.0.0.1", "-master", maddr]
    argvs = {f"m{i}": ["-store", os.path.join(root, f"fleet{i}.lsm"),
                       "-metaLog", os.path.join(root, f"fleet{i}-mlog"),
                       "-fleetMap", fmap_path, "-fleetSelf", members[i]]
             for i in range(FLEET_MEMBERS)}
    argvs["follower"] = ["-store", os.path.join(root, "follower.lsm"), "-followSource", members[0]]
    for i in range(2):
        argvs[f"p{i}"] = ["-store", os.path.join(root, f"peer{i}.lsm"),
                          "-metaLog", os.path.join(root, f"peer{i}-mlog"),
                          "-peers", addr[f"p{1 - i}"]]
    argvs["sharded"] = ["-shards", "4", "-store", os.path.join(root, "sharded.lsm")]
    kids: dict = {}
    spawned: list = []  # the client children, killed at the end if a failure left them

    def client(mode: str, plan, concurrency: int) -> dict:
        spawned.append(_fleet_client(root, mode, plan, concurrency))
        return spawned[-1]

    try:
        # --- (a) the children, started together ---
        t0 = time.perf_counter()
        for r in roles:
            kids[r] = _start_filer_child(root, r, ["-port", str(ports[r]), *base, *argvs[r]],
                                         FLEET_SHARD_ENV if r == "sharded" else None)
        for r in roles:
            _await_filer_child(kids[r])
        res["start"] = {"wall_s": time.perf_counter() - t0,
                        "ready_s": {r: kids[r]["ready_s"] for r in roles},
                        "argv": {r: kids[r]["argv"] for r in roles}, "master": maddr,
                        "fleet_map": {"addresses": members, "bounds": bounds}}
        m = [kids[f"m{i}"] for i in range(FLEET_MEMBERS)]
        sh = kids["sharded"]

        def owner(d: str) -> int:
            return bisect.bisect_right(bounds, d)

        def items_of(ps, tags) -> list:
            return [{"directory": p.rsplit("/", 1)[0], "name": p.rsplit("/", 1)[1],
                     "etag": tags.get(p)} for p in ps]

        # --- (b) the preload: 10 % of the creates through a member that does not own
        # them; the sharded filer's and the peers' creates run beside it ---
        t0 = time.perf_counter()
        paths = [f"{d}/f{j:04d}" for d in dirs for j in range(FLEET_DIR_FILES)]
        etag = {p: p[-9:] for p in paths}  # as bench.py:7450-7455 builds them
        via = np.array([owner(p.rsplit("/", 1)[0]) for p in paths])
        stray = rng.random(len(paths)) < FLEET_FORWARD_SHARE
        via[stray] = (via[stray] + rng.integers(1, FLEET_MEMBERS, int(stray.sum()))) % FLEET_MEMBERS
        order = rng.permutation(len(paths)).tolist()
        plan = [[members[int(via[i])], paths[i], etag[paths[i]]] for i in order]
        sh_paths = [f"{d}/f{j:04d}" for d in FLEET_SHARD_DIRS for j in range(FLEET_SHARD_FILES)]
        sh_etag = {p: f"s{i}" for i, p in enumerate(sh_paths)}
        sh_plan = [[sh["addr"], sh_paths[i], sh_etag[sh_paths[i]]]
                   for i in rng.permutation(len(sh_paths)).tolist()]
        peer_plan = {i: [[addr[f"p{i}"], f"/peer/from{i}/f{j:04d}", f"p{i}-{j}"]
                         for j in range(FLEET_PEER_FILES)] for i in range(2)}
        g_pre = [_child_gate(k) for k in m]
        sh_before = _child_gate(sh)["shards"]
        share = (len(plan) + FLEET_CREATE_CHILDREN - 1) // FLEET_CREATE_CHILDREN
        held = [client("create", plan[k * share:(k + 1) * share], FLEET_CREATE_C)
                for k in range(FLEET_CREATE_CHILDREN)]
        beside = {"sharded": client("create", sh_plan, 64),
                  **{f"p{i}": client("create", peer_plan[i], FLEET_CREATE_C)
                     for i in range(2)}}
        creates = [_fleet_client_result(h) for h in held]
        beside = {k: _fleet_client_result(h) for k, h in beside.items()}
        g_post = [_child_gate(k) for k in m]
        wall = max(c["wall_s"] for c in creates)
        fwd = [g_post[i]["fleet"]["forwarded"] - g_pre[i]["fleet"]["forwarded"]
               for i in range(FLEET_MEMBERS)]
        sent_stray = [int((stray & (via == i)).sum()) for i in range(FLEET_MEMBERS)]
        if fwd != sent_stray:
            fail(f"the preload's forwards by member {fwd}, strays sent to each {sent_stray}")
        res["preload"] = {"creates": len(plan), "children": FLEET_CREATE_CHILDREN,
                          "concurrency": FLEET_CREATE_CHILDREN * FLEET_CREATE_C, "wall_s": wall,
                          "creates_per_s": len(plan) / wall,
                          "p50_ms": statistics.median(c["p50_ms"] for c in creates),
                          "p99_ms": max(c["p99_ms"] for c in creates),
                          "sent_to_non_owner": int(stray.sum()), "forwarded_by_member": fwd,
                          "write_gate": [g["write_gate"] for g in g_post],
                          "segments": [g["segments"] for g in g_post],
                          "memtable": [g["memtable"] for g in g_post],
                          "beside": {k: {kk: v[kk] for kk in ("items", "concurrency", "wall_s",
                                                              "per_s", "p50_ms", "p99_ms")}
                                     for k, v in beside.items()},
                          "note": "the sharded filer's and the peers' creates ran beside the "
                                  "fleet's, at c=64 and 16 each"}
        res["b_s"] = time.perf_counter() - t0

        # --- (c) lookups and LISTs: each member alone, then the fleet together ---
        t0 = time.perf_counter()
        n_absent = int(len(paths) * FLEET_ABSENT_SHARE)
        absent = [f"{dirs[int(i) % FLEET_DIRS]}/g{int(i)}"
                  for i in rng.integers(0, 1 << 30, n_absent)]
        items = items_of(paths, etag) + items_of(absent, {})
        items = [items[i] for i in rng.permutation(len(items)).tolist()]
        lists = [{"directory": d, "count": FLEET_DIR_FILES} for d in dirs]
        mine = [[it for it in items if owner(it["directory"]) == i] for i in range(FLEET_MEMBERS)]
        mine_ls = [[it for it in lists if owner(it["directory"]) == i]
                   for i in range(FLEET_MEMBERS)]
        # one warm-up pass over every member: each gate's arena takes the runs of its store
        _fleet_drivers(root, "lookup", [it for i in range(FLEET_MEMBERS)
                                        for it in mine[i][:FLEET_WARMUP]],
                       members, bounds, "warm")
        g0 = [_child_gate(k) for k in m]
        alone_lk = [_fleet_drivers(root, "lookup", mine[i][-FLEET_ALONE_LOOKUPS:], [members[i]],
                                   [], f"lk{i}") for i in range(FLEET_MEMBERS)]
        alone_ls = [_fleet_drivers(root, "list", mine_ls[i], [members[i]], [], f"ls{i}")
                    for i in range(FLEET_MEMBERS)]
        pick = rng.choice(len(items), min(FLEET_TOGETHER_LOOKUPS, len(items)), replace=False)
        together_lk = _fleet_drivers(root, "lookup", [items[i] for i in pick.tolist()], members,
                                     bounds, "lk")
        together_ls = _fleet_drivers(root, "list", lists, members, bounds, "ls")
        # every entry read back exactly: each directory at its owner
        t1 = time.perf_counter()
        want = _by_dir(etag)
        listed = sum(_check_listings(members[owner(d)], want, [d], "the preload") for d in dirs)
        list_s = time.perf_counter() - t1
        g1 = [_child_gate(k) for k in m]
        gates = [_fleet_clean(g0[i], g1[i], f"member {i}'s lookups after the warm-up")
                 for i in range(FLEET_MEMBERS)]
        fwd = [g1[i]["fleet"]["forwarded"] - g0[i]["fleet"]["forwarded"]
               for i in range(FLEET_MEMBERS)]
        if any(fwd):
            fail(f"members forwarded {fwd} requests during the probes")
        res["probes"] = {
            "lookups": len(pick), "lists": len(lists),
            "listed_with_etags": listed, "listed_s": list_s,
            "warmup_lookups_a_member": FLEET_WARMUP, "identity_check": True,
            "per_member_lookup": alone_lk, "per_member_list": alone_ls,
            "lookup_capacity_per_s": sum(r["per_s"] for r in alone_lk),
            "list_capacity_per_s": sum(r["per_s"] for r in alone_ls),
            "capacity_note": "the sum of each member's rate driven alone, as bench.py's leg "
                             "reports fleet capacity",
            "concurrent_lookup": together_lk, "concurrent_list": together_ls,
            "forwarded_during_probes": fwd, "meta_gate": gates}
        res["c_s"] = time.perf_counter() - t0

        # --- (d) a live range move: the upper half of member 0's range to member 1 ---
        t0 = time.perf_counter()
        half = FLEET_DIRS // FLEET_MEMBERS // 2
        lo, hi = dirs[half], bounds[0]
        moving_dirs = dirs[half:2 * half]
        moving = [p for p in paths if lo <= p.rsplit("/", 1)[0] < hi]
        late = [[f"{moving_dirs[k % half]}/late{k:05d}", f"late{k:05d}"]
                for k in range(FLEET_CHURN_CREATES)]
        stop = os.path.join(root, "churn.stop")
        ready = os.path.join(root, "churn.ready")
        churn = client("churn", {
            "addrs": members[:2], "creates": late, "stop": stop, "ready": ready,
            "lookups": [[p, etag[p]] for p in moving]}, FLEET_CHURN_C)
        while not os.path.exists(ready):
            if churn["proc"].poll() is not None:
                _fleet_client_result(churn)
            time.sleep(0.01)
        time.sleep(FLEET_CHURN_S)
        t1 = time.perf_counter()
        mv = _filer_rpc(members[0], "FleetMoveRange", {"dst": members[1], "lo": lo, "hi": hi})
        move_s = time.perf_counter() - t1
        if mv.get("error"):
            open(stop, "w").close()
            fail(f"FleetMoveRange: {mv}")
        time.sleep(FLEET_CHURN_S)
        open(stop, "w").close()
        ch = _fleet_client_result(churn)
        during = [late[i] for i in ch["created"]]
        for p, t in during:
            etag[p] = t
        moved = moving + [p for p, _t in during]
        st0 = _filer_rpc(members[0], "FleetStatus", {})
        if st0["fleet"]["epoch"] != fmap.epoch + 1 or st0["fleet"]["range"] != ["", lo]:
            fail(f"member 0 after the move: {st0['fleet']}")
        # the source's store holds nothing of the moved range (its cleanup)
        held_local = _filer_rpc_many(members[0], [
            {"directory": p.rsplit("/", 1)[0], "name": p.rsplit("/", 1)[1], "fleet_local": True}
            for p in moving[::64] + [p for p, _t in during[::16]]])
        if any(r.get("entry") is not None for r in held_local):
            fail("the move's source still holds entries of the moved range")
        back = items_of(moved, etag)
        back = [back[i] for i in rng.permutation(len(back)).tolist()]
        _fleet_drivers(root, "lookup", back[:FLEET_WARMUP], [members[1]], [], "warm-dst")
        gd0, gs0 = _child_gate(m[1]), _child_gate(m[0])
        at_dst = _fleet_drivers(root, "lookup", back[-FLEET_MOVE_LOOKUPS:], [members[1]], [],
                                "back-dst")
        at_src = _fleet_drivers(root, "lookup", back[-FLEET_MOVE_LOOKUPS:], [members[0]], [],
                                "back-src")
        t1 = time.perf_counter()
        want = _by_dir({p: etag[p] for p in moved})
        listed = {k: _check_listings(members[i], want, moving_dirs, f"the moved range at {k}")
                  for k, i in (("destination", 1), ("source", 0))}
        list_s = time.perf_counter() - t1
        gd1, gs1 = _child_gate(m[1]), _child_gate(m[0])
        src_fwd = gs1["fleet"]["forwarded"] - gs0["fleet"]["forwarded"]
        if src_fwd < at_src["n"] + len(moving_dirs):
            fail(f"the source forwarded {src_fwd} of the {at_src['n']} lookups and "
                 f"{len(moving_dirs)}+ listings of the moved range")
        res["move"] = {"range": [lo, hi], "from": members[0], "to": members[1],
                       "entries_before": len(moving), "created_during": len(during),
                       "churn": {k: ch[k] for k in ("creates", "lookups", "wall_s")},
                       "churn_concurrency": FLEET_CHURN_C, "reply": mv, "move_s": move_s,
                       "epoch": st0["fleet"]["epoch"], "lost": 0, "misrouted": 0,
                       "read_back_at_destination": at_dst, "read_back_at_source": at_src,
                       "listed_with_etags": listed, "listed_s": list_s,
                       "source_forwarded": src_fwd,
                       "source_local_lookups_absent": len(held_local),
                       "destination_meta_gate": _fleet_clean(
                           gd0, gd1, "the destination's lookups of the moved range"),
                       "ingested_at_destination": gd1["fleet"]["ingested"]}
        res["d_s"] = time.perf_counter() - t0

        # --- (e) the follower of member 0 ---
        t0 = time.perf_counter()
        fol = kids["follower"]
        head = _filer_rpc(members[0], "GetFilerConfiguration", {})["last_ts_ns"]
        while True:
            fst = _filer_rpc(fol["addr"], "FleetStatus", {})["follower"]
            if fst["cursor_ns"] >= head:
                break
            if time.perf_counter() - t0 > 120:
                fail(f"the follower's cursor did not reach member 0's head in 120 s: {fst}")
            time.sleep(0.05)
        caught_s = time.perf_counter() - t0
        own0 = [p for p in paths if p.rsplit("/", 1)[0] < lo]  # member 0's range after the move
        n_own0 = len(own0)
        own0 += [f"{d}/g{k}" for k, d in enumerate(dirs[:half] * 16)]  # absent
        _fleet_drivers(root, "lookup", items_of(own0[:FLEET_WARMUP], etag), [fol["addr"]], [],
                       "warm-fol")
        gf0 = _child_gate(fol)
        share = (len(own0) + FLEET_COMPARE_CHILDREN - 1) // FLEET_COMPARE_CHILDREN
        held = [client("compare", {"a": fol["addr"], "b": members[0],
                                                "paths": own0[k * share:(k + 1) * share]},
                              FLEET_DRIVER_C) for k in range(FLEET_COMPARE_CHILDREN)]
        cmps = [_fleet_client_result(h) for h in held]
        gf1 = _child_gate(fol)
        found = sum(c["found"] for c in cmps)
        if found != n_own0:
            fail(f"the follower and member 0 found {found} of member 0's {n_own0} paths")
        p0_ = own0[0].rsplit("/", 1)
        redirect = _filer_rpc(fol["addr"], "LookupDirectoryEntry", {
            "directory": p0_[0], "name": p0_[1], "min_ts_ns": fst["cursor_ns"] + 10 ** 12})
        write = _filer_rpc(fol["addr"], "CreateEntry", {"entry": _fleet_entry(own0[0] + "x", "x")})
        if redirect.get("error") != "redirect" or redirect.get("primary") != members[0]:
            fail(f"a read ahead of the follower's cursor answered {redirect}")
        if write != {"error": "read_only_follower", "primary": members[0]}:
            fail(f"a write at the follower answered {write}")
        fst = _filer_rpc(fol["addr"], "FleetStatus", {})["follower"]
        cwall = max(c["wall_s"] for c in cmps)
        res["follower"] = {"source": members[0], "caught_up_s": caught_s,
                           "compared": len(own0), "found": found, "equal_to_member_0": True,
                           "compare_children": FLEET_COMPARE_CHILDREN, "wall_s": cwall,
                           "paths_per_s": len(own0) / cwall,
                           "p50_ms": statistics.median(c["p50_ms"] for c in cmps),
                           "p99_ms": max(c["p99_ms"] for c in cmps),
                           "redirect": redirect, "write": write, "status": fst,
                           "staleness_bound_s": fst["staleness_bound_s"],
                           "meta_gate": _fleet_clean(gf0, gf1, "the follower's lookups")}
        res["e_s"] = time.perf_counter() - t0

        # --- (f) the peers, then the sharded store ---
        t0 = time.perf_counter()
        peers = {}
        for i, other in ((0, 1), (1, 0)):
            oaddr = kids[f"p{other}"]["addr"]
            seen = _subscribe_creates(oaddr, f"/peer/from{i}/", FLEET_PEER_FILES, 60)
            t1 = time.perf_counter()
            want = _by_dir({p: t for _a, p, t in peer_plan[i]})[f"/peer/from{i}"]
            while True:
                got = [(e["full_path"].rsplit("/", 1)[1], (e.get("extended") or {}).get("etag"))
                       for e in _list_dir(oaddr, f"/peer/from{i}")]
                if got == want:
                    break
                if time.perf_counter() - t1 > 60:
                    fail(f"peer p{other}'s store lists {len(got)} of p{i}'s {len(want)} creates")
                time.sleep(0.05)
            peers[f"p{i}_to_p{other}"] = {"creates": len(want), "subscribed_creates": seen,
                                          "in_store": len(got),
                                          "replay_s": time.perf_counter() - t1}
        res["peers"] = peers
        t1 = time.perf_counter()
        # a rebalance while writes go on: the preload's, or else this client's
        stop = os.path.join(root, "shard.stop")
        ready = os.path.join(root, "shard.ready")
        hot = [[p, sh_etag[p]] for p in sh_paths if p.rsplit("/", 1)[0] in FLEET_SHARD_HOT]
        extra = [[f"{FLEET_SHARD_DIRS[k % len(FLEET_SHARD_DIRS)]}/late{k:05d}", f"late{k}"]
                 for k in range(FLEET_CHURN_CREATES)]
        churn = client("churn", {"addrs": [sh["addr"]], "creates": extra,
                                               "stop": stop, "ready": ready, "lookups": hot},
                              FLEET_CHURN_C)
        while True:
            now = _child_gate(sh)["shards"]
            if now["stats"]["rebalances"] > sh_before["stats"]["rebalances"]:
                break
            if churn["proc"].poll() is not None or time.perf_counter() - t1 > FLEET_REBALANCE_S:
                open(stop, "w").close()
                _fleet_client_result(churn)
                fail(f"no rebalance of the sharded store in {FLEET_REBALANCE_S} s: {now}")
            time.sleep(0.1)
        rebalance_wait = time.perf_counter() - t1
        time.sleep(FLEET_CHURN_S)
        open(stop, "w").close()
        sch = _fleet_client_result(churn)
        for i in sch["created"]:
            sh_etag[extra[i][0]] = extra[i][1]
        listed = _check_listings(sh["addr"], _by_dir(sh_etag), FLEET_SHARD_DIRS,
                                 "the sharded filer")
        gsh = _child_gate(sh)
        if gsh["gate"]["device_batches"] or not gsh["fallback_reasons"].get("no_arena_view"):
            fail(f"the sharded filer's gate: {gsh['gate']}, {gsh['fallback_reasons']}")
        res["sharded"] = {"shards": 4, "entries": len(sh_paths),
                          "rebalance_env": FLEET_SHARD_ENV,
                          "rebalance_wait_after_the_preload_s": rebalance_wait,
                          "writes_after_the_preload": {k: sch[k] for k in
                                                       ("creates", "lookups", "wall_s")},
                          "lost": 0, "before": sh_before, "after": gsh["shards"],
                          "listed_in_key_order_with_etags": listed,
                          "host_lookups": gsh["gate"]["probes"],
                          "host_flushes": gsh["gate"]["host_fallbacks"],
                          "fallback_reasons": gsh["fallback_reasons"],
                          "note": "the sharded store has no arena_view (nor has the JAX "
                                  "one): every flush of its gate is a host lookup"}
        res["f_s"] = time.perf_counter() - t0

        # --- (g) the shell ---
        t0 = time.perf_counter()
        out, wall = _port_cli(["shell", "-master", maddr, f"meta.fleet.status -filer {members[0]}"],
                              timeout=120)
        lines = out.splitlines()
        moved = ["-inf", lo] + bounds[1:] + ["+inf"]  # the bounds after the move
        want = [f"filer {members[0]}:",
                f"  fleet epoch {fmap.epoch + 1} · {FLEET_MEMBERS} member(s) · self range "
                f"[-inf, {lo})"]
        want += [f"    {a}: [{moved[i]}, {moved[i + 1]}){' (self)' if i == 0 else ''}"
                 for i, a in enumerate(members)]
        if lines[:len(want)] != want:
            fail(f"shell meta.fleet.status printed {lines}, not {want}")
        res["shell"] = {"lines": lines, "wall_s": wall}

        # the card's memory a process, and each child's K2 launches
        used = nvidia_smi("memory.used")
        gates = {r: _child_gate(kids[r]) for r in roles}
        res["card_memory"] = {
            "memory_used_before_the_children": smi_before, "memory_used_with_them": used,
            "per_child_MiB": (int(used.split()[0]) - int(smi_before.split()[0])) / len(roles),
            "per_child_note": "nvidia-smi's memory.used with the children up less before, "
                              "over the children: each one's CUDA context and arena",
            "torch_reserved_bytes": {r: (gates[r]["device_memory"] or {}).get("reserved")
                                     for r in roles}}
        k2 = {r: gates[r]["ragged_lookup_launches"] for r in roles}
        res["ragged_lookup_launches"] = k2
        res["kernel_launches"] = {"ragged_lookup": sum(k2[r] for r in roles
                                                       if r.startswith("m") or r == "follower")}
        if res["kernel_launches"]["ragged_lookup"] <= 0:
            fail("the fleet launched ragged_lookup no time")
    finally:
        import signal

        stop_errors = []
        for c in spawned:
            if c["proc"].poll() is None:
                c["proc"].kill()
                c["proc"].wait()
        for k in kids.values():  # all at once: each takes about a second
            if k["proc"].poll() is None:
                k["proc"].send_signal(signal.SIGTERM)
                k["signalled"] = True
        for k in kids.values():
            try:
                k["stop_s"] = _stop_server_child(k)
            except SystemExit as e:
                stop_errors.append(str(e))
            if k["proc"].poll() is None:
                k["proc"].kill()
                k["proc"].wait()
        try:
            res["server_stop_s"] = _stop_server_child(server)
        except SystemExit as e:
            stop_errors.append(str(e))
        if stop_errors and sys.exc_info()[0] is None:
            fail("; ".join(stop_errors))
    res["stop_s"] = {r: kids[r].get("stop_s") for r in roles}
    res["phase_s"] = time.perf_counter() - t_phase
    shutil.rmtree(root, ignore_errors=True)
    emit(res)
    return res


# --- phase 17 ----------------------------------------------------------------
HEAL_VID = 7  # the EC volume of 17(b), written by `--prep heal`
HEAL_REP_VID = 8  # the replicated (001) volume of 17(b), the same size
HEAL_NEEDLE_BYTES = 64 * 1024
HEAL_NEEDLES = 16_640  # 1,091 MB of .dat a volume: >= 1 GiB
HEAL_READS = 20_000  # the read pass's cap across the repair rounds
HEAL_READ_CONCURRENCY = 64  # split over the two read clients
# the read pass spreads its cap over this span: from the clients' start to
# the last repair's end took 20.6 s on an H100 with unpaced clients, which
# spent the cap at 1,196 GETs/s 4 s before the node-loss repair ended,
# and 16.8 s in the whole script with this pace (PERF.md §6)
HEAL_READ_SPAN_S = 24.0
HEAL_PULSE_S = 0.5  # the volume servers' -pulseSeconds
HEAL_GRACE_S = 2.0  # the master's repair_grace_seconds (its default 20 s)
HEAL_ROUND_S = 0.25  # between two `ec.repair.status -run` rounds
HEAL_DEADLINE_S = 120.0  # per repair, detection to converged


def write_heal_volumes(root: str, seed: int, needle_mod) -> dict:
    """17(b)'s volumes under `root` before a server starts, each
    HEAL_NEEDLES needles of HEAL_NEEDLE_BYTES from a seeded pool of 64
    payloads (CRCs computed once), written in batches: the EC volume
    (HEAL_VID) in d0, the replicated volume (HEAL_REP_VID, placement 001)
    in d1 and a copy of its files in d2; each reader's table in
    `<vid>.npz`."""
    import numpy as np

    from seaweedfs_tpu_torch.storage.super_block import ReplicaPlacement
    from seaweedfs_tpu_torch.storage.volume import Volume

    t0 = time.perf_counter()
    out = {}
    for vid, d, salt, placement in ((HEAL_VID, "d0", 170, None),
                                    (HEAL_REP_VID, "d1", 172, "001")):
        d = os.path.join(root, d)
        os.makedirs(d)
        rng = np.random.default_rng(seed + salt)
        pool = rng.integers(0, 256, (64, HEAL_NEEDLE_BYTES), dtype=np.uint8)
        blobs = [row.tobytes() for row in pool]
        ids = rng.permutation(np.arange(1, HEAL_NEEDLES + 1, dtype=np.uint64) * 7919)
        cookies = rng.integers(1, 1 << 32, size=HEAL_NEEDLES, dtype=np.uint64)
        blob_of = rng.integers(0, 64, size=HEAL_NEEDLES)
        crc_of = {b: needle_mod.masked_crc(b) for b in blobs}
        real_crc = needle_mod.masked_crc
        needle_mod.masked_crc = lambda data: crc_of.get(bytes(data)) or real_crc(data)
        try:
            v = Volume(d, "", vid, replica_placement=(
                ReplicaPlacement.parse(placement) if placement else None))
            for c0 in range(0, HEAL_NEEDLES, 256):
                for r in v.write_needle_batch([
                    needle_mod.Needle(cookie=int(c), id=int(k), data=blobs[int(b)])
                    for k, c, b in zip(ids[c0:c0 + 256].tolist(),
                                       cookies[c0:c0 + 256].tolist(),
                                       blob_of[c0:c0 + 256].tolist())
                ]):
                    if isinstance(r, Exception):
                        fail(f"heal volume {vid} write failed: {r!r}")
            out[f"dat_bytes_{vid}"] = v.data_file_size()
            v.close()
        finally:
            needle_mod.masked_crc = real_crc
        np.savez(os.path.join(root, f"{vid}.npz"), pool=pool, ids=ids,
                 cookies=cookies, blob_of=blob_of)
    os.makedirs(os.path.join(root, "d2"))
    for ext in (".dat", ".idx"):
        shutil.copyfile(os.path.join(root, "d1", f"{HEAL_REP_VID}{ext}"),
                        os.path.join(root, "d2", f"{HEAL_REP_VID}{ext}"))
    out["write_s"] = time.perf_counter() - t0
    return out


class _TimedCodec:
    """A codec whose encode calls are timed: staging, upload, kernel,
    download and the stream's sync, the device side of a scrub pass."""

    def __init__(self, codec):
        self.codec = codec
        self.encode_s = 0.0
        self.encodes = 0

    def __getattr__(self, name):
        return getattr(self.codec, name)

    def encode(self, data):
        t0 = time.perf_counter()
        out = self.codec.encode(data)
        self.encode_s += time.perf_counter() - t0
        self.encodes += 1
        return out


def _flip_byte(path: str, offset: int, mask: int = 0x5A) -> int:
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)[0]
        f.seek(offset)
        f.write(bytes([b ^ mask]))
    return b


def phase_scrub_at_scale(torch, base: str, seed: int) -> dict:
    """17(a): scrub_ec_volume with CudaRSCodec over phase 3's 11 GiB
    RS(10,4) volume, all 14 shards local (after the last phase that
    reads them): a clean pass, then one seeded byte flipped in a parity
    shard and one in a data shard (in another chunk); the second pass
    must name exactly those two shards. The flipped bytes are put back."""
    import numpy as np

    from seaweedfs_tpu_torch.ops import gf256 as G
    from seaweedfs_tpu_torch.ops.rs_kernel import CudaRSCodec
    from seaweedfs_tpu_torch.storage import scrub
    from seaweedfs_tpu_torch.storage.erasure_coding import to_ext

    chunk = scrub.EC_SCRUB_CHUNK
    shard_bytes = os.path.getsize(base + to_ext(0))
    chunks = -(-shard_bytes // chunk)
    passes = {}

    def one_pass(name: str) -> dict:
        codec = _TimedCodec(CudaRSCodec())
        G.KERNEL_LAUNCHES = 0
        t0 = time.perf_counter()
        r = scrub.scrub_ec_volume(base, codec)
        wall = time.perf_counter() - t0
        if r.get("skipped"):
            fail(f"scrub ({name}) skipped the volume: {r['skipped']}")
        passes[name] = {
            "bytes": r["bytes"], "wall_s": wall, "GBps": r["bytes"] / wall / 1e9,
            "gf_matmul_launches": G.KERNEL_LAUNCHES, "encodes": codec.encodes,
            "encode_round_trip_s": codec.encode_s,
            "read_and_compare_s": wall - codec.encode_s,
            "corrupt_shards": r["corrupt_shards"], "unidentified": r["unidentified"],
        }
        if G.KERNEL_LAUNCHES < chunks:
            fail(f"scrub ({name}) launched gf_matmul {G.KERNEL_LAUNCHES} times "
                 f"for {chunks} chunks")
        return passes[name]

    clean = one_pass("clean")
    if clean["corrupt_shards"] or clean["unidentified"]:
        fail(f"the clean scrub found {clean['corrupt_shards']}")
    rng = np.random.default_rng(seed + 17)
    parity = 10 + int(rng.integers(0, 4))
    data = int(rng.integers(0, 10))
    c_par = int(rng.integers(0, chunks))
    c_dat = (c_par + 1 + int(rng.integers(0, chunks - 1))) % chunks
    flips = {}
    for shard, c in ((parity, c_par), (data, c_dat)):
        width = min(chunk, shard_bytes - c * chunk)
        off = c * chunk + int(rng.integers(0, width))
        flips[shard] = (off, _flip_byte(base + to_ext(shard), off))
    try:
        flipped = one_pass("flipped")
    finally:
        for shard, (off, _b) in flips.items():
            _flip_byte(base + to_ext(shard), off)  # the same mask puts it back
    if flipped["corrupt_shards"] != sorted(flips) or flipped["unidentified"]:
        fail(f"the scrub after flips in shards {sorted(flips)} named "
             f"{flipped['corrupt_shards']} (unidentified {flipped['unidentified']})")
    res = {
        "phase": "self_healing_scrub",
        "volume": {"shard_bytes": shard_bytes, "shards": 14, "chunks": chunks,
                   "chunk_bytes": chunk},
        "flips": {str(s): {"offset": off, "chunk": off // chunk}
                  for s, (off, _b) in flips.items()},
        "passes": passes,
        "named_exactly_the_flipped_shards": True,
        "cuts": ["the master's 30,000 MB volume limit cut to phase 3's 11 GiB volume "
                 "(the script's disk and time)"],
    }
    emit(res)
    return res


def _heal_plan(pool, fids, blob_of, cap: int, concurrency: int) -> dict:
    """A read client's plan: GET every fid (its blob must come back), cycled
    until the stop file exists or `cap` requests, paced to spread the cap
    over HEAL_READ_SPAN_S; failures counted, wrong bodies fail."""
    return {"blobs": pool, "requests": [("GET", f, int(b), 200) for f, b in zip(fids, blob_of)],
            "allow_fail": True, "max_requests": cap,
            "pace_s": concurrency * HEAL_READ_SPAN_S / cap}


def phase_self_healing(torch, work: str, seed: int, prepared: dict,
                       scrub_gbps) -> dict:
    """17(b): the self-healing loop in a cluster (the JAX package's
    tests/test_scrub_repair.py::test_cluster_self_healing_end_to_end at
    this size): `server` and three `volume -mserver`, all `-storageBackend
    cuda`, on event-loop threads of this script; the master's background
    loop off. Both volumes are written by `--prep heal`, 1 GiB each: a
    replicated (001) one whose needle is bitflipped on one holder by a
    FaultPlan targeted at that holder's .dat (the plan is process-wide:
    every in-process server consults it); an EC one, generated on the
    card, 12 shards on the `server` (all data shards and two parity: the
    scrub recomputes parity only where the data shards are local, and
    names a data shard only with two parity rows) and shards 12, 13 on a
    volume server that holds no replica. Driven by the shell's
    `volume.scrub` and `ec.repair.status -run` (in this process): the
    replica re-copied; a flipped data shard quarantined and rebuilt
    through VolumeEcShardsRebuildBatch (B1 in the rebuilder), the
    survivors pulled for it dropped again; then the shard holder stopped
    and its shards rebuilt on a survivor. Two read clients (children)
    run across the repair rounds. Then a second scrub, every needle read back and every
    shard's checksum as before the damage."""
    import asyncio

    import numpy as np

    from seaweedfs_tpu_torch.client.operation import assign, upload_data
    from seaweedfs_tpu_torch.command import cli
    from seaweedfs_tpu_torch.ops import gf256 as G
    from seaweedfs_tpu_torch.pb import grpc_address
    from seaweedfs_tpu_torch.pb.rpc import Stub
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command
    from seaweedfs_tpu_torch.storage.erasure_coding import to_ext
    from seaweedfs_tpu_torch.storage.file_id import FileId
    from seaweedfs_tpu_torch.types import NEEDLE_HEADER_SIZE
    from seaweedfs_tpu_torch.util import faults
    from seaweedfs_tpu_torch.util.fasthttp import FastHTTPClient

    t_phase = time.perf_counter()
    prep = _await_prep(prepared)
    root = os.path.join(work, "heal")
    os.rename(os.path.join(work, PREP_DIR, "heal"), root)
    dirs = [os.path.join(root, f"d{i}") for i in range(4)]
    os.makedirs(dirs[3])

    def table(vid: int):
        z = np.load(os.path.join(root, f"{vid}.npz"))
        return ([row.tobytes() for row in z["pool"]],
                [str(FileId(vid, int(k), int(c)))
                 for k, c in zip(z["ids"].tolist(), z["cookies"].tolist())],
                z["blob_of"])

    heal_pool, heal_fids, heal_blob = table(HEAL_VID)
    heal_fids = ["/" + f for f in heal_fids]
    taken: set = set()
    mport = _port_pair(taken, start=24000)
    maddr = f"127.0.0.1:{mport}"
    vports = [_port_pair(taken, start=24000) for _ in dirs]
    urls = [f"127.0.0.1:{p}" for p in vports]
    pulse = ["-pulseSeconds", str(HEAL_PULSE_S)]
    served = [_serve_in_thread(cli.cmd_server, [
        "-ip", "127.0.0.1", "-port", str(mport), "-volumePort", str(vports[0]),
        "-dir", dirs[0], "-storageBackend", "cuda", *pulse], "heal-server")]
    served += [_serve_in_thread(cli.cmd_volume, [
        "-ip", "127.0.0.1", "-port", str(vports[i]), "-dir", dirs[i], "-mserver", maddr,
        "-storageBackend", "cuda", *pulse], f"heal-volume-{i}") for i in range(1, 4)]
    clients = []
    stop_file = os.path.join(work, "heal.stop")
    out: dict = {"phase": "self_healing", "prep": prep,
                 "scrub_GBps_17a": scrub_gbps}
    try:
        t0 = time.perf_counter()
        for h in served:
            if not h["ready"].wait(CLUSTER_START_S) or "error" in h:
                fail(f"{h['thread'].name} did not start: {h.get('error')!r}")
        master = served[0]["servers"][0]
        while len(master.topo.data_nodes()) < len(dirs):
            if time.perf_counter() - t0 > CLUSTER_START_S:
                fail("the heal cluster's volume servers did not register")
            time.sleep(0.05)
        out["start_s"] = time.perf_counter() - t0
        master.repair_grace_seconds = HEAL_GRACE_S
        a_url = urls[0]
        rng = np.random.default_rng(seed + 171)
        env = CommandEnv(maddr)

        # the path: every count at 0 now, read at the end
        G.KERNEL_LAUNCHES = 0
        windows = {}

        def ec_locs():
            locs = master.topo.lookup_ec_shards(HEAL_VID)
            return [] if locs is None else [
                sorted(dn.url for dn in locs.locations[s]) for s in range(14)]

        def corrupt_flags(vid):
            return [r["scrub_corrupt"] for r in master.topo.replica_states().get(vid, [])]

        async def until(pred, what: str, deadline: float = HEAL_DEADLINE_S):
            t = time.perf_counter()
            while not pred():
                if time.perf_counter() - t > deadline:
                    fail(f"17(b): timed out waiting for {what}")
                await asyncio.sleep(0.05)

        async def heal(done, what: str) -> dict:
            """`ec.repair.status -run` rounds until `done()` and an empty
            queue; every round's output free of errors."""
            t = time.perf_counter()
            rounds = []
            while True:
                r0, g0 = time.perf_counter(), G.KERNEL_LAUNCHES
                text = await run_command(env, "ec.repair.status -run")
                if "ERROR" in text:
                    fail(f"17(b) {what}: a repair failed: {text}")
                m = re.search(r"dispatched (\d+)", text)
                rounds.append({"wall_s": time.perf_counter() - r0,
                               "dispatched": int(m.group(1)) if m else 0,
                               "gf_matmul_launches": G.KERNEL_LAUNCHES - g0})
                if done() and "queue depth: 0" in text.splitlines()[0]:
                    return {"wall_s": time.perf_counter() - t, "rounds": rounds}
                if time.perf_counter() - t > HEAL_DEADLINE_S:
                    fail(f"17(b) {what}: no convergence in {HEAL_DEADLINE_S} s: {text}")
                await asyncio.sleep(HEAL_ROUND_S)

        async def drive():
            http = FastHTTPClient(pool_per_host=16)
            try:
                # ---- the replicated volume: a needle bitflipped on one holder ----
                vid = HEAL_REP_VID
                rep_pool, rep_fids, rep_blob = table(vid)
                await until(lambda: len(corrupt_flags(vid)) == 2, "2 replicas registered")
                holders = [r["url"] for r in master.topo.replica_states()[vid]]
                target = holders[0]
                tv = next(h for h in served if
                          h["servers"][-1].address == target)["servers"][-1].store.find_volume(vid)
                at = tv.data_file_size() + NEEDLE_HEADER_SIZE + 16
                faults.install_plan(faults.FaultPlan(seed=seed, rules=[faults.FaultRule(
                    op="write_at", target=tv.file_name() + ".dat", nth=1,
                    fault="bitflip", at_offset=at, bits=3)]))
                victim = rng.integers(0, 256, HEAL_NEEDLE_BYTES, dtype=np.uint8).tobytes()
                victim_fid = str(FileId(vid, 1 << 40, 0xC0FFEE))
                try:
                    await upload_data(http, target, victim_fid, victim)
                    if faults.current_plan().fired() != 1:
                        fail("17(b): the bitflip plan did not fire on the replica")
                finally:
                    faults.clear_plan()
                rep_pool.append(victim)
                rep_fids.append(victim_fid)
                rep_blob = np.append(rep_blob, len(rep_pool) - 1)

                # ---- the EC volume: generated on the card, 12 + 2 shards ----
                a_stub = Stub(grpc_address(a_url), "volume")
                await a_stub.call("VolumeMarkReadonly", {"volume_id": HEAL_VID})
                g0, t = G.KERNEL_LAUNCHES, time.perf_counter()
                r = await a_stub.call("VolumeEcShardsGenerate", {"volume_id": HEAL_VID},
                                      timeout=600)
                if r.get("error"):
                    fail(f"17(b) EC generate: {r['error']}")
                windows["generate"] = {"wall_s": time.perf_counter() - t,
                                       "gf_matmul_launches": G.KERNEL_LAUNCHES - g0}
                if windows["generate"]["gf_matmul_launches"] <= 0:
                    fail("17(b): EC generate launched gf_matmul no time")
                await a_stub.call("VolumeEcShardsMount", {"volume_id": HEAL_VID,
                                                          "shard_ids": list(range(14))})
                await a_stub.call("VolumeDelete", {"volume_id": HEAL_VID,
                                                   "keep_ec_files": True})
                outpost = next(u for u in urls[1:] if u not in holders)
                o_stub = Stub(grpc_address(outpost), "volume")
                t = time.perf_counter()
                r = await o_stub.call("VolumeEcShardsCopy", {
                    "volume_id": HEAL_VID, "shard_ids": [12, 13], "copy_ecx_file": True,
                    "source_data_node": a_url}, timeout=600)
                if r.get("error"):
                    fail(f"17(b) shard copy: {r['error']}")
                await o_stub.call("VolumeEcShardsMount", {"volume_id": HEAL_VID,
                                                          "shard_ids": [12, 13]})
                await a_stub.call("VolumeEcShardsUnmount", {"volume_id": HEAL_VID,
                                                            "shard_ids": [12, 13]})
                await a_stub.call("VolumeEcShardsDelete", {"volume_id": HEAL_VID,
                                                           "shard_ids": [12, 13]})
                out["shard_move_s"] = time.perf_counter() - t
                layout = [[a_url]] * 12 + [[outpost]] * 2
                await until(lambda: ec_locs() == layout, "the EC layout at the master")
                a_base = os.path.join(dirs[0], str(HEAL_VID))
                o_base = os.path.join(dirs[urls.index(outpost)], str(HEAL_VID))
                before = sha1_files([a_base + to_ext(s) for s in range(12)]
                                    + [o_base + to_ext(s) for s in (12, 13)])
                before = {to_ext(i): h for i, h in enumerate(before.values())}
                out["layout"] = {"server": a_url, "shards_on_server": 12,
                                 "outpost": outpost, "shards_on_outpost": [12, 13],
                                 "replica_holders": holders, "flipped_replica": target,
                                 "shard_bytes": os.path.getsize(a_base + to_ext(0)),
                                 "replica_dat_bytes": tv.data_file_size()}

                # ---- the read pass across the repair rounds ----
                # (the flipped needle first: its reads fail until the recopy)
                c = HEAL_READ_CONCURRENCY // 2
                t_reads = time.perf_counter()
                clients.append(_start_client(
                    work, "heal_ec_reads", vports[0],
                    _heal_plan(heal_pool, heal_fids, heal_blob, HEAL_READS // 2, c),
                    c, stop_file))
                clients.append(_start_client(
                    work, "heal_replica_reads", vports[urls.index(target)],
                    _heal_plan(rep_pool, ["/" + f for f in rep_fids[::-1]], rep_blob[::-1],
                               HEAL_READS // 2, c),
                    c, stop_file))

                # the clients read for a second before the first damage
                # is found
                await asyncio.sleep(1.0)

                # ---- 1. recopy ----
                t = time.perf_counter()
                text = await run_command(env, f"volume.scrub -volumeId {vid}")
                scrub_s = time.perf_counter() - t
                if text.count("CORRUPT key") != 1 or "needle_crc" not in text or \
                        f"{target}: QUARANTINED volume of volume {vid}" not in text:
                    fail(f"17(b): volume.scrub did not find the flipped needle: {text}")
                t_detect = time.perf_counter()
                await until(lambda: any(corrupt_flags(vid)), "scrub_corrupt at the master")
                g0 = G.KERNEL_LAUNCHES
                h = await heal(lambda: not any(corrupt_flags(vid)), "recopy")
                windows["recopy"] = {"scrub_s": scrub_s,
                                     "detection_to_repair_s": time.perf_counter() - t_detect,
                                     "rounds": h["rounds"],
                                     "gf_matmul_launches": G.KERNEL_LAUNCHES - g0}

                # ---- 2. a flipped data shard: quarantine and rebuild; the
                # survivors pulled for it (12, 13) leave the rebuilder ----
                shard = int(rng.integers(0, 10))
                size = os.path.getsize(a_base + to_ext(shard))
                off = int(rng.integers(0, size))
                _flip_byte(a_base + to_ext(shard), off)
                g0, t = G.KERNEL_LAUNCHES, time.perf_counter()
                text = await run_command(env, f"volume.scrub -volumeId {HEAL_VID}")
                scrub_s = time.perf_counter() - t
                if f"{a_url} ec volume {HEAL_VID}:" not in text or \
                        f"corrupt shards [{shard}]" not in text or \
                        f"QUARANTINED shard {shard} of volume {HEAL_VID}" not in text:
                    fail(f"17(b): volume.scrub did not name shard {shard}: {text}")
                scrub_launches = G.KERNEL_LAUNCHES - g0
                t_detect = time.perf_counter()
                await until(lambda: ec_locs()[shard] == [], f"shard {shard} unregistered")
                g0 = G.KERNEL_LAUNCHES
                h = await heal(lambda: ec_locs() == layout, "shard rebuild")
                windows["shard_rebuild"] = {
                    "shard": shard, "offset": off, "scrub_s": scrub_s,
                    "scrub_gf_matmul_launches": scrub_launches,
                    "detection_to_repair_s": time.perf_counter() - t_detect,
                    "rounds": h["rounds"], "gf_matmul_launches": G.KERNEL_LAUNCHES - g0}
                if windows["shard_rebuild"]["gf_matmul_launches"] <= 0:
                    fail("17(b): the shard rebuild launched gf_matmul no time")
                left = [s for s in (12, 13) if os.path.exists(a_base + to_ext(s))]
                if left:
                    fail(f"17(b): the survivors pulled for the rebuild stayed: {left}")

                # ---- 3. then a node loss ----
                t_lost = time.perf_counter()
                lost = next(h for h in served if h["servers"][-1].address == outpost)
                out["outpost_stop_s"] = _stop_served(lost, 10)
                served.remove(lost)
                await until(lambda: ec_locs()[12] == [] and ec_locs()[13] == [],
                            "the lost holder's shards unregistered")
                t_unreg = time.perf_counter()
                g0 = G.KERNEL_LAUNCHES
                h = await heal(lambda: ec_locs() == [[a_url]] * 14, "node loss")
                windows["node_loss"] = {
                    "stop_to_unregistered_s": t_unreg - t_lost,
                    "loss_to_repair_s": time.perf_counter() - t_lost,
                    "rounds": h["rounds"], "gf_matmul_launches": G.KERNEL_LAUNCHES - g0}
                if windows["node_loss"]["gf_matmul_launches"] <= 0:
                    fail("17(b): the node-loss rebuild launched gf_matmul no time")

                # ---- the read pass ends; then the checks ----
                with open(stop_file, "w"):
                    pass
                repairs_s = time.perf_counter() - t_reads
                out["reads_across_repairs"] = {c["name"]: _client_result(c, 300)
                                               for c in clients}
                clients.clear()
                reads = out["reads_across_repairs"].values()
                out["read_pass"] = {
                    "clients_start_to_repairs_end_s": repairs_s,
                    "clients_wall_s": max(r["wall_s"] for r in reads),
                    "per_s": sum(r["requests"] for r in reads) / max(
                        r["wall_s"] for r in reads),
                    "cap_reached": sum(r["requests"] for r in reads) >= HEAL_READS,
                    # a client under its cap read on until the stop file
                    "covered_every_repair": all(r["requests"] < HEAL_READS // 2
                                                for r in reads)}
                if master.repair_queue.depth() != 0:
                    fail(f"17(b): the repair queue holds {master.repair_queue.depth()}")
                errs = [t for t in master.repair_log if t.get("error")]
                if errs:
                    fail(f"17(b): dispatches with errors: {errs}")
                out["dispatches"] = [{k: t.get(k) for k in (
                    "kind", "volume_id", "missing", "rebuilder", "rebuilt", "target", "source")}
                    for t in master.repair_log]
                text = await run_command(env, "volume.scrub")
                if "CORRUPT" in text or "QUARANTINED" in text or \
                        f"ec volume {HEAL_VID}: " not in text or "corrupt shards []" not in text:
                    fail(f"17(b): the second scrub is not clean: {text}")
                out["second_scrub_clean"] = True
                return before, rep_pool, rep_fids, rep_blob, target
            finally:
                await http.close()

        before, rep_pool, rep_fids, rep_blob, target = asyncio.run(drive())
        after = sha1_files([os.path.join(dirs[0], str(HEAL_VID)) + to_ext(s)
                            for s in range(14)])
        after = {to_ext(i): h for i, h in enumerate(after.values())}
        if after != before:
            fail(f"17(b): shards differ from before the damage: "
                 f"{[k for k in after if after[k] != before.get(k)]}")
        out["shards_equal_to_before"] = True
        # every needle of both volumes, byte for byte, no failure allowed
        readback = {}
        for name, port, pool, fids, blob in (
                ("ec", vports[0], heal_pool, heal_fids, heal_blob),
                ("replica", vports[urls.index(target)], rep_pool,
                 ["/" + f for f in rep_fids], rep_blob)):
            res = _drive(work, f"heal_readback_{name}", port,
                         {"blobs": pool, "requests": [("GET", f, int(b), 200)
                                                      for f, b in zip(fids, blob)]},
                         HEAL_READ_CONCURRENCY, 600)
            readback[name] = {"needles": len(fids), "wall_s": res["wall_s"],
                              "per_s": res["per_s"]}
        out["readback"] = readback
        out["windows"] = windows
        out["kernel_launches"] = {"gf_matmul": G.KERNEL_LAUNCHES}
        for h in served:
            _stop_served(h, 10)
        served.clear()
    finally:
        for c in clients:
            if c["proc"].poll() is None:
                c["proc"].kill()
                c["proc"].wait()
        for h in served:
            loop = h.get("loop")
            if loop is not None and not loop.is_closed():
                loop.call_soon_threadsafe(h["stop"].set)
        for h in served:
            h["thread"].join(10)
    out["cuts"] = [
        "EC volume: 1,091 MB of .dat (the master's 30,000 MB volume limit cut to "
        ">= 1 GiB for the phase's time; written by `--prep heal`)",
        "replicated volume: 1,091 MB of .dat a holder, cut as the EC volume is and "
        "for the same reason; written by `--prep heal`",
        f"read pass: capped at {HEAL_READS} GETs at c={HEAL_READ_CONCURRENCY}, "
        f"paced over {HEAL_READ_SPAN_S} s",
        f"repair grace {HEAL_GRACE_S} s and -pulseSeconds {HEAL_PULSE_S} "
        "(the JAX master's >= 15 s grace at its 5 s pulse, cut for the phase's time)",
    ]
    w = out.get("windows", {})
    out["summary"] = {
        "scrub_GBps_17a": out["scrub_GBps_17a"],
        "detection_to_repair_s": {
            "recopy": w["recopy"]["detection_to_repair_s"],
            "node_loss": w["node_loss"]["loss_to_repair_s"],
            "shard_rebuild": w["shard_rebuild"]["detection_to_repair_s"]},
        "rebuild_batch_rounds": {
            k: [r for r in w[k]["rounds"] if r["dispatched"]]
            for k in ("node_loss", "shard_rebuild")},
        "recopied_dat_bytes": out["layout"]["replica_dat_bytes"],
        "read_pass": out["read_pass"],
        "failed_reads": sum(r["failed"] for r in out["reads_across_repairs"].values()),
        "reads": sum(r["requests"] for r in out["reads_across_repairs"].values()),
        "wrong_bodies": 0,
    }
    out["wall_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--volume-gib", type=float, default=11.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--workdir", default=os.path.join(HERE, "smoke_work"),
        help="directory under which a fresh scratch directory holds the "
             "volume and its shards (removed at the end)",
    )
    ap.add_argument(
        "--gate-cut-ab", type=int, default=0, metavar="ROUNDS",
        help="measure the gate's arena cut instead: phases 0-1, then phase "
             "10's server and warm-up, then ROUNDS read passes alternating "
             "the cut between 128 and 64; no kernel line and no result line",
    )
    ap.add_argument(
        "--self-healing-only", action="store_true",
        help="phases 0-1, then phase 17(b) alone with its `--prep heal` "
             "child (no 17(a): its scrub GB/s is null); no kernel line and "
             "no result line",
    )
    args = ap.parse_args()

    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    sys.path.insert(0, HERE)
    try:
        from seaweedfs_tpu_torch.gpu.coder import get_codec
        from seaweedfs_tpu_torch.ops import _build
        from seaweedfs_tpu_torch.ops import bucket_search as BS
        from seaweedfs_tpu_torch.ops import gf256 as G
        from seaweedfs_tpu_torch.ops import index_kernel as IK
        from seaweedfs_tpu_torch.ops import ragged_lookup as RL
        from seaweedfs_tpu_torch.storage import idx as idx_mod
        from seaweedfs_tpu_torch.storage import needle as needle_mod
        from seaweedfs_tpu_torch.storage import super_block as sb_mod
        from seaweedfs_tpu_torch.storage.erasure_coding import encoder as enc
        from seaweedfs_tpu_torch.storage.erasure_coding import galois
        from seaweedfs_tpu_torch.storage.erasure_coding import (
            EC_LARGE_BLOCK_SIZE,
            EC_SMALL_BLOCK_SIZE,
            EcVolume,
            to_ext,
        )
        from seaweedfs_tpu_torch.storage.volume_info import (
            VolumeInfo,
            save_volume_info,
        )
        from seaweedfs_tpu_torch.util import crc as crc_mod
    except ImportError as e:
        fail(f"the port (seaweedfs_tpu_torch) is not importable: {e}")
    import numpy as np

    t_start = time.perf_counter()
    walls = []  # (phase, seconds since the start) as each phase begins

    def mark(name: str) -> None:
        walls.append((name, time.perf_counter() - t_start))

    # --- phase 0 ---
    smi = nvidia_smi("name,power.limit")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    emit({
        "phase": "identity",
        "nvidia_smi": smi,
        "sm_clock_max_mhz": clock_mhz,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(),
        "python": sys.version.split()[0],
    })

    # --- phase 1 ---
    mark("build")
    t0 = time.perf_counter()
    built, errors = {}, {}

    def build(name):
        try:
            built[name] = _build.build(name)
        except Exception as e:  # reported below, for every kernel
            errors[name] = str(e)

    threads = [threading.Thread(target=build, args=(k,)) for k in (*KERNELS, HOST_CRC)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        fail(f"kernel build failed: {errors}")
    crc_check = check_host_crc(crc_mod, args.seed)
    limits = G.kernel_limits()
    IK._kernel_lib()
    RL._kernel_lib()
    BS._kernel_lib()
    emit({
        "phase": "build",
        "libraries": {k: os.path.relpath(v, HERE) for k, v in built.items()},
        "nvcc_seconds": dict(_build.BUILD_SECONDS),
        "gf256_ptxas": ptxas_report(_build.BUILD_LOGS.get("gf256", "")),
        "ragged_lookup_ptxas": ptxas_report(_build.BUILD_LOGS.get("ragged_lookup", "")),
        "seconds": time.perf_counter() - t0,
        "gf256_max_rows": limits[0], "gf256_max_cols": limits[1],
        "gf256_rows_per_launch": limits[2],
        "host_crc32c": crc_check,
    })

    if args.gate_cut_ab:
        os.makedirs(args.workdir, exist_ok=True)
        work = tempfile.mkdtemp(prefix="chip_smoke-", dir=args.workdir)
        try:
            phase_volume_server(torch, work, args.seed, needle_mod, crc_mod,
                                cut_ab_rounds=args.gate_cut_ab)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(smi, flush=True)
        return 0

    if args.self_healing_only:
        os.makedirs(args.workdir, exist_ok=True)
        work = tempfile.mkdtemp(prefix="chip_smoke-", dir=args.workdir)
        try:
            prep = _start_prep(work, "heal", [os.path.join(work, PREP_DIR, "heal"),
                                              args.seed])
            phase_self_healing(torch, work, args.seed, prep, None)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(smi, flush=True)
        return 0

    # --- phase 2 ---
    mark("kernel_vs_plain")
    kres = kernel_against_plain(torch, G, galois, args.seed, clock_mhz * 1e6)

    os.makedirs(args.workdir, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke-", dir=args.workdir)
    launches = {}
    ik_launches = {}
    fserver = None  # phase 15's `server` child
    preps = []  # the set-up children
    try:
        # --- phase 3 ---
        mark("encode")
        target = int(args.volume_gib * GIB)
        need = int(target * 2.5) + 2 * GIB  # .dat + 1.4x shards + slack
        free = shutil.disk_usage(work).free
        if free < need:
            fail(
                f"{work} has {free / GIB:.1f} GiB free, {need / GIB:.1f} GiB "
                f"needed for a {args.volume_gib} GiB volume (--volume-gib)"
            )
        vid = 1
        base = os.path.join(work, str(vid))
        t0 = time.perf_counter()
        pool, needles, dat_size = write_volume(
            base, target, args.seed, needle_mod, idx_mod, sb_mod
        )
        gen_s = time.perf_counter() - t0
        n_large, n_small = enc._row_counts(
            dat_size, 10, EC_LARGE_BLOCK_SIZE, EC_SMALL_BLOCK_SIZE
        )
        codec = get_codec("cuda")
        G.KERNEL_LAUNCHES = 0
        t0 = time.perf_counter()
        enc.write_ec_files(base, codec=codec)
        encode_s = time.perf_counter() - t0
        launches["encode"] = G.KERNEL_LAUNCHES
        t1 = time.perf_counter()
        enc.write_sorted_file_from_idx(base)
        save_volume_info(base + ".vif", VolumeInfo(version=3))
        ecx_s = time.perf_counter() - t1
        # the original .dat's first find_dat_file_size bytes, for the decode
        t1 = time.perf_counter()
        original = {"bytes": dat_size, "dat_size": enc.find_dat_file_size(base)}
        original["sha1"] = _hash_prefix(base + ".dat", original["dat_size"])
        original_hash_s = time.perf_counter() - t1
        if enc.LAST_ROUTE.get("kernel") != "device":
            fail(f"encode did not run on the device: {enc.LAST_ROUTE}")
        if launches["encode"] <= 0:
            fail("encode launched the kernel no time")
        emit({
            "phase": "encode",
            "volume_bytes": dat_size,
            "needles": len(needles),
            "payload_pool": {
                "blobs": len(pool),
                "note": "payloads drawn from a seeded pool whose CRCs are "
                        "computed once",
                "crc32c": crc_mod.route(),
            },
            "generate_s": gen_s,
            "rows": {"large": n_large, "small": n_small},
            "route": enc.LAST_ROUTE,
            "encode_s": encode_s,
            "GBps": dat_size / encode_s / 1e9,
            "ecx_vif_s": ecx_s,
            "original_hash_s": original_hash_s,
            "stages": enc.LAST_STAGES,
            "kernel_launches": launches["encode"],
        })

        # --- phase 4 ---
        mark("rebuild")
        shard_paths = [base + to_ext(i) for i in range(14)]
        shard_size = os.path.getsize(shard_paths[0])
        want = sha1_files(shard_paths)
        for i in REBUILD_LOST:
            os.remove(shard_paths[i])
        G.KERNEL_LAUNCHES = 0
        t0 = time.perf_counter()
        rebuilt = enc.rebuild_ec_files(base, codec=codec)
        rebuild_s = time.perf_counter() - t0
        launches["rebuild"] = G.KERNEL_LAUNCHES
        if rebuilt != list(REBUILD_LOST):
            fail(f"rebuild made {rebuilt}, expected {list(REBUILD_LOST)}")
        got = sha1_files([shard_paths[i] for i in REBUILD_LOST])
        for i in REBUILD_LOST:
            if got[shard_paths[i]] != want[shard_paths[i]]:
                fail(f"rebuilt shard {to_ext(i)} differs from the encoded one")
        if launches["rebuild"] <= 0:
            fail("rebuild launched the kernel no time")
        emit({
            "phase": "rebuild",
            "lost": list(REBUILD_LOST),
            "identical": True,
            "shard_bytes": shard_size,
            "rebuild_s": rebuild_s,
            "GBps": 10 * shard_size / rebuild_s / 1e9,
            "GBps_note": "volume bytes (10 data shards) over the rebuild wall",
            "rebuilt_GBps": len(REBUILD_LOST) * shard_size / rebuild_s / 1e9,
            "route": enc.LAST_REBUILD_ROUTE,
            "stages": enc.LAST_REBUILD_STAGES,
            "kernel_launches": launches["rebuild"],
        })

        # --- phase 5 ---
        mark("parity_vs_plain")
        large, small = EC_LARGE_BLOCK_SIZE, EC_SMALL_BLOCK_SIZE
        chunk = codec.preferred_chunk
        places = []  # (name, .dat start of the row, block, inner offset, width, shard offset)
        if n_large:
            places.append(("first_chunk", 0, large, 0, chunk, 0))
            places.append((
                "large_last_chunk", (n_large - 1) * large * 10, large,
                large - chunk, chunk, n_large * large - chunk,
            ))
        small0 = n_large * large * 10
        places.append(("small_first_row", small0, small, 0, small, n_large * large))
        last = n_small - 1
        places.append((
            "small_last_row_ragged", small0 + last * small * 10, small, 0, small,
            n_large * large + last * small,
        ))
        checked = []
        with open(base + ".dat", "rb") as dat:
            for name, row_start, block, inner, width, shard_off in places:
                data = np.zeros((10, width), dtype=np.uint8)
                for i in range(10):
                    enc._read_into(dat, data[i], row_start + i * block + inner)
                packed = torch.from_numpy(G.pack_bytes_host(data).view(np.int32)).cuda()
                parity = G._gf_matmul_torch_packed(codec.parity_matrix, packed)
                parity = G.unpack_bytes_host(parity.cpu().numpy(), width)
                for p in range(4):
                    with open(shard_paths[10 + p], "rb") as f:
                        f.seek(shard_off)
                        on_disk = np.frombuffer(f.read(width), dtype=np.uint8)
                    if not np.array_equal(on_disk, parity[p]):
                        fail(f"parity shard {10 + p} differs at {name}")
                checked.append(name)
        if n_large and n_small:
            checked.append("large_to_small_boundary")
        emit({"phase": "parity_vs_plain", "places": checked, "equal": True})

        # --- phase 6 ---
        mark("degraded_read")
        for i in DEGRADED_LOST:
            os.remove(shard_paths[i])
        ids = np.fromiter(needles, dtype=np.uint64)
        rng = np.random.default_rng(args.seed + 1)
        sample = set(
            int(v) for v in rng.choice(ids, min(SAMPLED_READS, len(ids)), replace=False)
        )
        with EcVolume(work, "", vid) as ev:
            straddling = set()
            for nid, (off, body, _b) in needles.items():
                if len(ev.intervals_for(off // 8, body)) > 1:
                    straddling.add(nid)
            todo = sorted(sample | straddling)
            G.KERNEL_LAUNCHES = 0
            decoded = 0
            t0 = time.perf_counter()
            read_bytes = 0
            for nid in todo:
                off, body, b = needles[nid]
                crc, payload = pool[b][2], pool[b][5]
                n = ev.read_needle(nid, codec)
                if n.id != nid or n.checksum != crc:
                    fail(f"needle {nid:x}: id/checksum mismatch")
                if bytes(n.data) != payload:
                    fail(f"needle {nid:x}: payload mismatch")
                read_bytes += len(n.data)
                decoded += any(
                    iv.to_shard_id_and_offset(large, small)[0] in DEGRADED_LOST
                    for iv in ev.intervals_for(off // 8, body)
                )
            read_s = time.perf_counter() - t0
            launches["degraded_read"] = G.KERNEL_LAUNCHES
            # bulk_locate of every needle plus 10 % absent ids, on the card
            absent = rng.integers(1 << 41, 1 << 42, size=len(ids) // 10, dtype=np.uint64)
            locate_ids = rng.permutation(np.concatenate([ids, absent]))
            IK.KERNEL_LAUNCHES = 0
            t0 = time.perf_counter()
            loc_off, loc_size, loc_found = ev.bulk_locate(locate_ids)
            locate_s = time.perf_counter() - t0
            ik_launches["ec_bulk_locate"] = IK.KERNEL_LAUNCHES
            for j, nid in enumerate(locate_ids.tolist()):
                try:
                    want_loc = ev.find_needle_from_ecx(nid)
                except Exception:
                    want_loc = None
                got_loc = ((int(loc_off[j]), int(loc_size[j]))
                           if loc_found[j] else None)
                if got_loc != want_loc:
                    fail(f"bulk_locate({nid:x}) = {got_loc}, ecx says {want_loc}")
        if launches["degraded_read"] <= 0:
            fail("degraded reads launched the kernel no time")
        if ik_launches["ec_bulk_locate"] <= 0:
            fail("bulk_locate launched index_search no time")
        emit({
            "phase": "degraded_read",
            "lost": list(DEGRADED_LOST),
            "needles_read": len(todo),
            "sampled": len(sample),
            "straddling": len(straddling),
            "needing_decode": decoded,
            "payload_bytes": read_bytes,
            "seconds": read_s,
            "all_equal": True,
            "kernel_launches": launches["degraded_read"],
            "bulk_locate": {
                "ids": len(locate_ids),
                "absent": len(absent),
                "seconds": locate_s,
                "equal_to_ecx_search": True,
                "index_search_launches": ik_launches["ec_bulk_locate"],
            },
        })

        # --- after phase 6: the mesh rebuild and the decode ---
        mark("mesh_rebuild_and_decode")
        dres = phase_mesh_rebuild_and_decode(torch, base, codec, want, original)
        launches["mesh_rebuild"] = sum(
            r["gf_matmul_launches"] for r in dres["mesh_rebuild"].values())
        launches["decode"] = dres["decode"]["gf_matmul_launches"]

        # --- phase 17(a), after the last phase that reads the shards ---
        mark("self_healing_scrub")
        hres_a = phase_scrub_at_scale(torch, base, args.seed)
        launches["self_healing_scrub"] = sum(
            p["gf_matmul_launches"] for p in hres_a["passes"].values())

        # --- phases 7-9 ---
        free_disk(work)  # the EC volume's
        # phase 10's volume 1, written by a child while phases 7-9 run
        preps.append(_start_prep(work, "volume1", [os.path.join(work, "server"), args.seed]))
        vkeep: dict = {}
        mark("volume_lookup")
        vres = phase_volume_lookup(torch, work, args.seed, needle_mod, crc_mod, vkeep)
        ik_launches["volume_lookup"] = vres["kernel_launches"]
        index: dict = {}
        mark("index_kernel")
        ires = phase_index_kernel(torch, args.seed, index)
        mark("arena_gate")
        ares = phase_arena_gate(torch, work, args.seed)

        # --- phase 10 ---
        mark("volume_server")
        free_disk(work, spare=(VACUUM_STASH, "server"))
        # phase 13's deletes, made by a child while phases 10-12 run
        start_vacuum_deletes(work, args.seed, vkeep)
        preps.append(vkeep["deleter"])
        keep: dict = {}
        sres = phase_volume_server(torch, work, args.seed, needle_mod, crc_mod,
                                   keep=keep, prepared=preps[0])
        launches["volume_server"] = sres["kernel_launches"]["gf_matmul"]
        ik_launches["volume_server"] = sres["kernel_launches"]["index_search"]

        # --- phase 11 ---
        mark("cluster")
        shutil.rmtree(os.path.join(work, "server"))  # phase 10's disk
        cres = phase_cluster(torch, work, args.seed, keep)
        launches["cluster"] = cres["kernel_launches"]["gf_matmul"]
        launches["cluster_rebuild_batch"] = cres["ec_rebuild"]["batch_gf_matmul_launches"]
        ik_launches["cluster"] = cres["kernel_launches"]["index_search"]

        # --- phase 12 ---
        mark("mesh")
        mres = phase_mesh(torch, args.seed, index, ires, clock_mhz * 1e6)
        del index
        launches["mesh"] = mres["kernel_launches"]["gf_matmul"]
        ik_launches["mesh"] = mres["kernel_launches"]["index_search"]
        for path, n in (("gf_matmul", launches["mesh"]),
                        ("gf_verify", mres["kernel_launches"]["gf_verify"]),
                        ("index_search", ik_launches["mesh"]),
                        ("index_buckets", mres["kernel_launches"]["index_buckets"]),
                        ("bucket_search", mres["kernel_launches"]["bucket_search"])):
            if n <= 0:
                fail(f"phase 12 launched {path} no time")

        # --- phase 13 ---
        mark("vacuum")
        free_disk(work, spare=(VACUUM_STASH, VACUUM_STASH + VACUUM_COPY_SUFFIX))
        vacres = phase_vacuum(torch, work, vkeep)
        ik_launches["vacuum"] = vacres["kernel_launches"]["index_search"]

        # --- phase 14 ---
        free_disk(work)
        mark("volume_tier")
        tres = phase_volume_tier(torch, work, args.seed)
        ik_launches["volume_tier"] = tres["kernel_launches"]["index_search"]

        # --- phase 15 ---
        # its `server` child starts once phase 14 has ended: started during
        # phase 14, it competes with phase 14's servers and clients for the
        # host's cores
        mark("filer")
        froot = os.path.join(work, "filer-server")
        os.makedirs(froot)
        fserver = _start_server_child(froot, set())
        fres = phase_filer(torch, work, args.seed, server=fserver)
        ik_launches["filer"] = fres["kernel_launches"]["index_search"]

        # --- phase 16 ---
        # the fleet's filers take phase 15's `server` child as their master
        mark("fleet")
        # 17(b)'s EC volume, written by a child while phase 16 runs
        heal_prep = _start_prep(work, "heal", [os.path.join(work, PREP_DIR, "heal"),
                                               args.seed])
        preps.append(heal_prep)
        flres = phase_fleet(torch, work, args.seed, server=fserver)

        # --- phase 17(b) ---
        mark("self_healing")
        hres = phase_self_healing(torch, work, args.seed, heal_prep,
                                  hres_a["passes"]["clean"]["GBps"])
        launches["self_healing"] = hres["kernel_launches"]["gf_matmul"]
        mark("end")
    finally:
        # a phase failed before phase 15 stopped its server, or before a
        # set-up child was waited for
        for child in [fserver] + preps:
            if child is not None and child["proc"].poll() is None:
                child["proc"].kill()
                child["proc"].wait()
        shutil.rmtree(work, ignore_errors=True)
        try:
            os.rmdir(args.workdir)  # only when nothing else is in it
        except OSError:
            pass
    emit({"phase": "done", "total_s": time.perf_counter() - t_start,
          "phase_walls_s": {name: t1 - t0 for (name, t0), (_n, t1) in zip(walls, walls[1:])}})

    k2 = ares["ragged_lookup"]["65536"]
    gv = mres["gf_verify"]
    lk = mres["lookup"]
    kb, ks = lk["index_buckets"], lk["bucket_search"]
    emit({
        "kernels": [{
            "name": "gf_matmul",
            "route": "cuda",
            "source": "seaweedfs_tpu_torch/ops/csrc/gf256.cu",
            "replaces": "seaweedfs_tpu/ops/gf256.py:149",
            "launches": sum(n for k, n in launches.items() if k != "cluster_rebuild_batch"),
            "launches_by_path": launches,
            "launches_note": "cluster_rebuild_batch is the part of cluster inside the "
                             "one VolumeEcShardsRebuildBatch; self_healing_scrub is "
                             "17(a)'s two scrub passes (one launch a 1 MiB chunk, "
                             "and the identification's), self_healing 17(b)'s generate, "
                             "scrubs, rebuilds and degraded reads",
            "equal_to_plain": True,
            "max_abs_err": kres["max_abs_err"],
            "ms": kres["ms"],
            "ms_from": "events",
            "plain_ms": kres["plain_ms"],
            "bound_ms": kres["bound_ms"],
            "bound_by": kres["bound_by"],
            "xtime_ops_bound_ms": kres["xtime_ops_bound_ms"],
            "library_ms": kres["library_ms"],
            "library_call": kres["library_call"],
        }, {
            "name": "gf_verify",
            "route": "cuda",
            "source": "seaweedfs_tpu_torch/ops/csrc/gf256.cu",
            "replaces": "seaweedfs_tpu/parallel/sharded_ec.py:114 (sharded_verify's "
                        "shard_map body, :121-131)",
            "launches": mres["kernel_launches"]["gf_verify"],
            "launches_by_path": {"mesh": mres["kernel_launches"]["gf_verify"]},
            "equal_to_plain": True,
            "max_abs_err": gv["max_abs_err"],
            "shape": gv["shape"],
            "ms": gv["ms"],
            "ms_from": gv["ms_from"],
            "plain_ms": gv["plain_ms"],
            "bound_ms": gv["bound_ms"],
            "bound_by": gv["bound_by"],
            "xtime_ops_bound_ms": gv["xtime_ops_bound_ms"],
            "library_ms": gv["library_ms"],
            "library_call": gv["library_call"],
        }, {
            "name": "index_search",
            "route": "cuda",
            "source": "seaweedfs_tpu_torch/ops/csrc/index_search.cu",
            "replaces": "seaweedfs_tpu/ops/index_kernel.py:80 (_bulk_lookup_bucketed; "
                        "_bulk_lookup at :36)",
            "launches": sum(ik_launches.values()),
            "launches_by_path": ik_launches,
            "equal_to_plain": True,
            "max_abs_err": ires["max_abs_err"],
            "shape": f"{INDEX_ENTRIES} entries, {INDEX_PROBES} probes, bucketed",
            "design": ires["design"],
            "ms": ires["ms"],
            "ms_from": ires["ms_from"],
            "plain_ms": ires["plain_ms"],
            "bound_ms": ires["bound_ms"],
            "bound_by": ires["bound_by"],
            "library_ms": ires["library_ms"],
        }, {
            "name": "ragged_lookup",
            "route": "cuda",
            "source": "seaweedfs_tpu_torch/ops/csrc/ragged_lookup.cu",
            "replaces": "seaweedfs_tpu/ops/ragged_lookup.py:181 (_ragged_dispatch)",
            "launches": ares["kernel_launches"] + sres["kernel_launches"]["ragged_lookup"]
            + cres["kernel_launches"]["ragged_lookup"]
            + vacres["kernel_launches"]["ragged_lookup"]
            + tres["kernel_launches"]["ragged_lookup"]
            + fres["kernel_launches"]["ragged_lookup"]
            + flres["kernel_launches"]["ragged_lookup"],
            "launches_by_path": {
                "arena_gate": ares["kernel_launches"],
                "volume_server": sres["kernel_launches"]["ragged_lookup"],
                "cluster": cres["kernel_launches"]["ragged_lookup"],
                "vacuum": vacres["kernel_launches"]["ragged_lookup"],
                "volume_tier": tres["kernel_launches"]["ragged_lookup"],
                "filer": fres["kernel_launches"]["ragged_lookup"],
                "fleet": flres["kernel_launches"]["ragged_lookup"],
            },
            "fleet_note": "fleet: the K2 launches of the four fleet members' and the "
                          "follower's processes, read from their /debug/meta_gate",
            "design": K2_DESIGN,
            "registers": RL._kernel_lib().ragged_probe_registers(),
            "at": {f"{where} {k}": {kk: v[kk] for kk in (
                "keys", "slots", "ms", "ms_from", "plain_ms", "bound_ms", "plane_ms",
                "plane_bound_ms")}
                for where, res in (("arena_gate", ares["ragged_lookup"]),
                                   ("filer", fres["ragged_lookup"]))
                for k, v in res.items() if isinstance(v, dict)},
            "equal_to_plain": True,
            "max_abs_err": max(ares["max_abs_err"], fres["ragged_lookup"]["max_abs_err"]),
            "shape": f"65536 probes, {k2['slots']} slots over "
                     f"{ares['arena']['resident_segments']} segments",
            "ms": k2["ms"],
            "ms_from": k2["ms_from"],
            "plain_ms": k2["plain_ms"],
            "bound_ms": k2["bound_ms"],
            "plane_ms": k2["plane_ms"],
            "plane_bound_ms": k2["plane_bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
        }, {
            "name": "index_buckets",
            "route": "cuda",
            "source": "seaweedfs_tpu_torch/ops/csrc/bucket_search.cu",
            "replaces": "seaweedfs_tpu/parallel/sharded_lookup.py:29 (_compiled_body, "
                        "with bucket_search: each replica's bucket table)",
            "launches": mres["kernel_launches"]["index_buckets"],
            "launches_by_path": {"mesh": mres["kernel_launches"]["index_buckets"]},
            "equal_to_plain": True,
            "max_abs_err": kb["max_abs_err"],
            "shape": f"{lk['entries']} rows -> {lk['nb']} + 1 starts",
            "ms": kb["ms"],
            "ms_from": kb["ms_from"],
            "plain_ms": kb["plain_ms"],
            "bound_ms": kb["bound_ms"],
            "bound_by": kb["bound_by"],
            "library_ms": kb["library_ms"],
        }, {
            "name": "bucket_search",
            "route": "cuda",
            "source": "seaweedfs_tpu_torch/ops/csrc/bucket_search.cu",
            "replaces": "seaweedfs_tpu/parallel/sharded_lookup.py:29 (_compiled_body; "
                        "sharded_bulk_lookup at :57)",
            "launches": mres["kernel_launches"]["bucket_search"],
            "launches_by_path": {"mesh": mres["kernel_launches"]["bucket_search"]},
            "equal_to_plain": True,
            "max_abs_err": ks["max_abs_err"],
            "shape": f"{lk['entries']} entries, {lk['probes']} probes, 1x1 mesh",
            "ms": ks["ms"],
            "ms_2x2": ks["ms_2x2"],
            "ms_from": ks["ms_from"],
            "plain_ms": ks["plain_ms"],
            "bound_ms": ks["bound_ms"],
            "bound_by": ks["bound_by"],
            "library_ms": ks["library_ms"],
        }],
    })
    print(smi, flush=True)
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    if "--prep" in sys.argv[1:]:
        sys.exit(prep_main(sys.argv[1:]))
    if "--client" in sys.argv[1:]:
        sys.exit(client_main(sys.argv[1:]))
    if "--tier-client" in sys.argv[1:]:
        sys.exit(tier_client_main(sys.argv[1:]))
    if "--filer-client" in sys.argv[1:]:
        sys.exit(filer_client_main(sys.argv[1:]))
    if "--fleet-client" in sys.argv[1:]:
        sys.exit(fleet_client_main(sys.argv[1:]))
    sys.exit(main())
