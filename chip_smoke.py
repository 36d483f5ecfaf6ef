#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (seaweedfs_tpu_torch) on one GPU.

Drives the port's warm-storage erasure-coding path through the entry points
a volume server calls, at full width, and holds its CUDA kernel against the
plain PyTorch version:

  0  identity: nvidia-smi name and power limit, torch and CUDA versions
  1  build the GF(2^8) kernel from the checkout's sources (nvcc, sm_90a)
  2  kernel against plain on the card, at the main path's shapes, and its
     median time beside the plain version's and the card's bound
  3  encode: write an 11 GiB version-3 volume (superblock, needles, .idx),
     then write_ec_files on the card, write_sorted_file_from_idx and .vif
  4  rebuild: delete shards 0, 7, 10, 13 and rebuild them on the card;
     the 14 shard files must hash as before
  5  parity at the first chunk, the large-to-small block boundary and the
     ragged last small row, recomputed by the plain version on the card
  6  degraded read: delete shards 1, 5, 11, 12 and read >= 1000 seeded
     needles plus every needle straddling a block boundary through
     EcVolume.read_needle; payloads and checksums must be the written ones

Each phase prints one JSON line; any mismatch or exception exits non-zero
without the final line. The line before last but one is the kernels
summary, then the nvidia-smi identity line, and the last line is
{"ok": true, "device": {...}}. Without CUDA (or without the package beside
this script) it exits non-zero and prints no result.

    python3 chip_smoke.py [--volume-gib 11] [--seed 0] [--workdir DIR]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
GIB = 1 << 30
MIB = 1 << 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT32_LANES_PER_SM = 64  # INT32 lanes per SM per clock (Hopper)
REBUILD_LOST = (0, 7, 10, 13)
DEGRADED_LOST = (1, 5, 11, 12)
SAMPLED_READS = 1000  # seeded needles read with DEGRADED_LOST gone


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


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


# --- phase 2 -----------------------------------------------------------------
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
    widths = (1, 3, 4097, (1 << 20) + 3, chunk_words)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    max_err = 0
    checked = 0
    for name, m in matrices.items():
        for w in widths:
            x = torch.randint(
                -(1 << 31), 1 << 31, (m.shape[1], w), dtype=torch.int32,
                device="cuda", generator=gen,
            )
            got = G.gf_matmul_packed(m, x)
            want = G._gf_matmul_torch_packed(m, x)
            torch.cuda.synchronize()
            diff = (
                got.contiguous().view(torch.uint8).to(torch.int16)
                - want.contiguous().view(torch.uint8).to(torch.int16)
            )
            err = int(diff.abs().max())
            max_err = max(max_err, err)
            checked += 1
            if err != 0:
                fail(f"kernel != plain for {name} at {w} words (max err {err})")
        # the numpy entry point: host bytes packed, run on the card, unpacked
        data = rng.integers(0, 256, (m.shape[1], 70_001), dtype=np.uint8)
        got = G.gf_matmul_bytes(m, data)
        want = G.gf_matmul_bytes(m, data, device="cpu")
        if not np.array_equal(got, want):
            fail(f"gf_matmul_bytes on the card != plain for {name}")
        checked += 1

    # time the 10.4 encode at the main path's chunk: per-launch CUDA events
    m = matrices["10.4"]
    x = torch.randint(
        -(1 << 31), 1 << 31, (10, chunk_words), dtype=torch.int32,
        device="cuda", generator=gen,
    )
    out = torch.empty((4, chunk_words), dtype=torch.int32, device="cuda")

    def median_ms(fn, reps: int) -> float:
        for _ in range(3):
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

    ms = median_ms(lambda: G._gf_matmul_cuda(m, x, out=out), 50)
    plain_ms = median_ms(lambda: G._gf_matmul_torch_packed(m, x), 10)
    props = torch.cuda.get_device_properties(0)
    nbytes = (m.shape[0] + m.shape[1]) * chunk_words * 4
    ops = G.count_expr_ops(m, "mul") * chunk_words
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    int_rate = props.multi_processor_count * INT32_LANES_PER_SM * sm_clock_hz
    ops_ms = ops / int_rate * 1e3
    res = {
        "phase": "kernel_vs_plain",
        "matrices": list(matrices),
        "widths_words": list(widths),
        "compared": checked,
        "equal_to_plain": True,
        "max_abs_err": max_err,
        "tolerance": "exact (byte-equal)",
        "timed": "10.4 encode, [10, 4194304] int32 words (16 MiB per shard)",
        "ms": ms,
        "plain_ms": plain_ms,
        "bytes": nbytes,
        "int32_ops": ops,
        "bytes_bound_ms": bytes_ms,
        "ops_bound_ms": ops_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "int32_ops_per_s_peak": int_rate,
        "data_GBps": 10 * chunk_words * 4 / (ms * 1e-3) / 1e9,
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--volume-gib", type=float, default=11.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--workdir", default=os.path.join(HERE, "smoke_work"),
        help="directory under which a fresh scratch directory holds the "
             "volume and its shards (removed at the end)",
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
        from seaweedfs_tpu_torch.ops import gf256 as G
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
    t0 = time.perf_counter()
    lib_path = _build.build("gf256")
    limits = G.kernel_limits()
    emit({
        "phase": "build",
        "library": os.path.relpath(lib_path, HERE),
        "nvcc_seconds": _build.BUILD_SECONDS["gf256"],
        "seconds": time.perf_counter() - t0,
        "max_rows": limits[0], "max_cols": limits[1],
        "rows_per_launch": limits[2],
    })

    # --- phase 2 ---
    kres = kernel_against_plain(torch, G, galois, args.seed, clock_mhz * 1e6)

    os.makedirs(args.workdir, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke-", dir=args.workdir)
    launches = {}
    try:
        # --- phase 3 ---
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
                "crc32c": crc_mod.crc32c.__module__ + (
                    " (google_crc32c)" if hasattr(crc_mod, "_gcrc")
                    else " (numpy lanes fallback)"
                ),
            },
            "generate_s": gen_s,
            "rows": {"large": n_large, "small": n_small},
            "route": enc.LAST_ROUTE,
            "encode_s": encode_s,
            "GBps": dat_size / encode_s / 1e9,
            "ecx_vif_s": ecx_s,
            "stages": enc.LAST_STAGES,
            "kernel_launches": launches["encode"],
        })

        # --- phase 4 ---
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
        if launches["degraded_read"] <= 0:
            fail("degraded reads launched the kernel no time")
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
        })
    finally:
        shutil.rmtree(work, ignore_errors=True)
        try:
            os.rmdir(args.workdir)  # only when nothing else is in it
        except OSError:
            pass
    emit({"phase": "done", "total_s": time.perf_counter() - t_start})

    emit({
        "kernels": [{
            "name": "gf_matmul",
            "route": "cuda",
            "source": "seaweedfs_tpu_torch/ops/csrc/gf256.cu",
            "replaces": "seaweedfs_tpu/ops/gf256.py:149",
            "launches": sum(launches.values()),
            "launches_by_path": launches,
            "equal_to_plain": True,
            "max_abs_err": kres["max_abs_err"],
            "ms": kres["ms"],
            "plain_ms": kres["plain_ms"],
            "bound_ms": kres["bound_ms"],
            "bound_by": kres["bound_by"],
            "library_ms": None,
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
    sys.exit(main())
