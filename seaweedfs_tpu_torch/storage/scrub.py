"""Background scrub: continuous verification of data at rest.

The read path only notices corruption when a client happens to ask for the
damaged needle; warm storage (Haystack + f4) needs latent damage found and
repaired BEFORE a second failure makes it unrecoverable. This module is
the detection half of that loop:

- `scrub_volume` walks a volume's live index entries, cross-checks each
  entry's extent against the .dat, and re-reads every record through the
  CRC-verifying needle parser — bit rot, truncation and index/extent skew
  all surface as typed corruption findings;
- `scrub_ec_volume` re-derives parity from the data shards with the same
  RS codec that encoded them (in a volume server, `CudaRSCodec`: one
  `gf256_matmul` launch on the card per chunk) and compares against the
  stored parity shards, identifying WHICH shard is damaged under the
  single-corruption assumption;
- `Scrubber` drives both over a whole Store with a byte/s token bucket
  (`SEAWEEDFS_TPU_SCRUB_MBPS`, or the shared maintenance budget) so
  verification traffic is rate-shaped under serving load, and a persisted
  per-volume resume cursor (`<base>.scrub`) so a restarted server
  continues where it left off.

Quarantine policy: scrub never deletes. A corrupt volume goes read-only
with `scrub_corrupt` raised in its heartbeat message; a corrupt EC shard
is unmounted and renamed to `.ecNN.bad` (evidence intact) so the master's
repair scheduler sees it as missing and rebuilds it through the batched
VolumeEcShardsRebuildBatch.

Ported from the JAX package's storage/scrub.py: the same reports, cursor
files and quarantine. The port has no tiered (remote) .dat, so the JAX
scrubber's skip of volumes with a remote file never applies here. An EC
chunk's shard rows are read straight into one [k, chunk] array per pass
(no per-chunk open or stack).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Callable, Optional

import numpy as np

from ..types import TOMBSTONE_FILE_SIZE, to_actual_offset
from ..util.metrics import SCRUB_BYTES, SCRUB_CORRUPTIONS, SCRUB_PASSES
from .maintenance import TokenBucket, plane_bucket
from .needle import get_actual_size, read_needle_data

_LOG = logging.getLogger(__name__)

# parity verification granularity: bytes per shard per round
EC_SCRUB_CHUNK = 1 << 20


# ---------------------------------------------------------------- cursor --


def _cursor_path(base: str) -> str:
    return base + ".scrub"


def load_cursor(base: str) -> dict:
    try:
        with open(_cursor_path(base)) as f:
            d = json.load(f)
            if isinstance(d, dict):
                return d
    except (OSError, ValueError):
        pass
    return {"resume_key": 0, "passes": 0}


def save_cursor(base: str, cursor: dict) -> None:
    tmp = _cursor_path(base) + ".tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(cursor, f)
        os.replace(tmp, _cursor_path(base))
    except OSError:
        pass  # cursor is an optimization; losing it restarts the pass


# ------------------------------------------------------------ volume scrub --


def scrub_volume(
    v,
    bucket: Optional[TokenBucket] = None,
    resume: bool = True,
    max_entries: Optional[int] = None,
    quarantine: bool = True,
    cursor_every: int = 512,
) -> dict:
    """Verify a volume's live records against their index entries.

    Walks the live (non-tombstoned) index snapshot in key order from the
    persisted resume cursor, and for each entry: cross-checks that the
    record's extent fits the .dat, then re-reads the record through the
    CRC-verifying parser and confirms the stored id matches the index key.
    Rate-shaped by `bucket`; timesliced by `max_entries` (the cursor
    persists, the next call continues). Returns a report dict:
    {volume_id, scanned, bytes, completed, corruptions: [(key, kind,
    detail)]}. With `quarantine`, any finding marks the volume read-only
    (never deletes — see module docstring)."""
    base = v.file_name()
    cursor = load_cursor(base) if resume else {"resume_key": 0, "passes": 0}
    resume_key = int(cursor.get("resume_key", 0))
    report = {
        "volume_id": v.id,
        "scanned": 0,
        "bytes": 0,
        "completed": True,
        "corruptions": [],
    }
    try:
        with v._lock:
            keys, offsets, sizes = v.nm.snapshot()
    except Exception:
        # map kinds without a snapshot: nothing to verify
        report["skipped"] = "no index snapshot"
        return report
    dat_size = v.data_file_size()
    version = v.version
    since_cursor = 0
    for i in range(len(keys)):
        key = int(keys[i])
        if resume_key and key <= resume_key:
            continue
        if max_entries is not None and report["scanned"] >= max_entries:
            report["completed"] = False
            break
        offset_units, size = int(offsets[i]), int(sizes[i])
        if offset_units == 0 or size == TOMBSTONE_FILE_SIZE:
            continue
        record_bytes = get_actual_size(size, version)
        offset = to_actual_offset(offset_units)
        if bucket is not None:
            bucket.consume(record_bytes)
        report["scanned"] += 1
        since_cursor += 1
        kind = None
        if offset + record_bytes > dat_size:
            kind = "idx_extent"
            detail = f"record end {offset + record_bytes} past dat {dat_size}"
        else:
            try:
                with v._lock:
                    n = read_needle_data(v.data_backend, offset, size, version)
                if n.id != key:
                    kind, detail = "needle_id", f"stored id {n.id:#x}"
                else:
                    report["bytes"] += record_bytes
            except Exception as e:
                kind, detail = "needle_crc", str(e)
        if kind is not None:
            report["corruptions"].append((key, kind, detail))
            SCRUB_CORRUPTIONS.inc(kind=kind)
        resume_key = key
        if since_cursor >= cursor_every:
            save_cursor(base, {**cursor, "resume_key": resume_key})
            since_cursor = 0
    SCRUB_BYTES.inc(report["bytes"], kind="dat")
    if report["completed"]:
        save_cursor(
            base, {"resume_key": 0, "passes": int(cursor.get("passes", 0)) + 1}
        )
        SCRUB_PASSES.inc(plane="volume")
    else:
        save_cursor(base, {**cursor, "resume_key": resume_key})
    if quarantine and report["corruptions"]:
        first = report["corruptions"][0]
        v.quarantine(
            f"scrub: {len(report['corruptions'])} corrupt record(s), "
            f"first key {first[0]:#x} ({first[1]})"
        )
    return report


# ---------------------------------------------------------------- EC scrub --


def _read_rows(fds: list, offset: int, out: np.ndarray) -> None:
    """pread row i of `out` from fds[i] at `offset`; bytes past a short
    file read as zero."""
    for fd, row in zip(fds, out):
        mv = memoryview(row)
        got = 0
        while got < len(mv):
            n = os.preadv(fd, [mv[got:]], offset + got)
            if n == 0:
                break
            got += n
        if got < len(mv):
            row[got:] = 0


def _identify_corrupt_data_shard(codec, data_rows, parity_rows, present_parity):
    """Single-corruption identification when EVERY stored parity row
    disagrees with the recomputed parity: try each data shard d as the
    culprit — reconstruct d from the other shards, and if re-encoding with
    the reconstruction makes all stored parity verify, d was the damaged
    shard. Returns the shard id or None (multi-corruption: unidentified)."""
    k = codec.data_shards
    for d in range(k):
        shards = [None] * codec.total_shards
        for i in range(k):
            if i != d:
                shards[i] = data_rows[i]
        for j, pid in enumerate(present_parity):
            shards[k + pid] = parity_rows[j]
        try:
            rows = codec.reconstruct_rows(shards, [d])
        except Exception:
            continue
        if rows[0] is None:
            continue
        candidate = list(data_rows)
        candidate[d] = np.asarray(rows[0], dtype=np.uint8)
        recalced = codec.encode(np.stack(candidate))
        if all(
            np.array_equal(recalced[pid], parity_rows[j])
            for j, pid in enumerate(present_parity)
        ):
            return d
    return None


def scrub_ec_volume(
    base: str,
    codec,
    bucket: Optional[TokenBucket] = None,
    chunk: int = EC_SCRUB_CHUNK,
) -> dict:
    """Verify an EC volume's parity by recomputation: for each aligned
    chunk, re-encode the k data-shard rows through `codec` (the same
    kernel the encode pipeline uses) and compare against every locally
    present parity shard. Needs all k data shards on this server — a
    spread volume reports {"skipped": ...} instead of guessing. Returns
    {base, shard_size, bytes, corrupt_shards: [ids], unidentified: bool};
    corrupt shard ids are established per the single-corruption heuristic
    (a lone disagreeing parity shard is itself damaged; a unanimous
    disagreement is traced back to the data shard whose reconstruction
    restores consistency)."""
    from .erasure_coding import to_ext

    k = codec.data_shards
    present = [
        i for i in range(codec.total_shards) if os.path.exists(base + to_ext(i))
    ]
    report = {
        "base": base,
        "bytes": 0,
        "corrupt_shards": [],
        "unidentified": False,
    }
    if any(i not in present for i in range(k)):
        report["skipped"] = (
            f"data shards {[i for i in range(k) if i not in present]} not "
            "local; parity cannot be recomputed here"
        )
        return report
    present_parity = [i - k for i in present if i >= k]
    if not present_parity:
        report["skipped"] = "no parity shards local"
        return report
    sizes = {i: os.path.getsize(base + to_ext(i)) for i in present}
    shard_size = max(set(sizes.values()), key=lambda s: list(sizes.values()).count(s))
    odd = sorted(i for i, s in sizes.items() if s != shard_size)
    corrupt: set[int] = set(odd)
    for _i in odd:
        SCRUB_CORRUPTIONS.inc(kind="ec_shard_size")
    report["shard_size"] = shard_size
    data_fds = [os.open(base + to_ext(i), os.O_RDONLY) for i in range(k)]
    parity_fds = [os.open(base + to_ext(k + p), os.O_RDONLY) for p in present_parity]
    try:
        data_buf = np.empty((k, min(chunk, shard_size)), dtype=np.uint8)
        parity_buf = np.empty((len(present_parity), data_buf.shape[1]), dtype=np.uint8)
        for off in range(0, shard_size, chunk):
            width = min(chunk, shard_size - off)
            if bucket is not None:
                bucket.consume(width * (k + len(present_parity)))
            data_rows = data_buf[:, :width]
            parity_rows = parity_buf[:, :width]
            _read_rows(data_fds, off, data_rows)
            _read_rows(parity_fds, off, parity_rows)
            calc = codec.encode(data_rows)
            bad = [
                p
                for j, p in enumerate(present_parity)
                if not np.array_equal(calc[p], parity_rows[j])
            ]
            report["bytes"] += width * (k + len(present_parity))
            if not bad:
                continue
            if len(bad) < len(present_parity):
                # some parity rows still verify against the recomputation,
                # so the data shards are intact: the disagreeing parity
                # shards themselves are damaged
                for p in bad:
                    if k + p not in corrupt:
                        corrupt.add(k + p)
                        SCRUB_CORRUPTIONS.inc(kind="ec_parity")
            else:
                d = _identify_corrupt_data_shard(
                    codec, list(data_rows), list(parity_rows), present_parity
                )
                if d is None:
                    report["unidentified"] = True
                    SCRUB_CORRUPTIONS.inc(kind="ec_unidentified")
                elif d not in corrupt:
                    corrupt.add(d)
                    SCRUB_CORRUPTIONS.inc(kind="ec_data")
    finally:
        for fd in data_fds + parity_fds:
            os.close(fd)
    SCRUB_BYTES.inc(report["bytes"], kind="ec")
    SCRUB_PASSES.inc(plane="ec")
    report["corrupt_shards"] = sorted(corrupt)
    return report


# ---------------------------------------------------------------- passes --


class Scrubber:
    """Store-wide scrub: one pass = every volume (resumable via the
    per-volume cursor) + every EC volume with locally verifiable parity.
    Applies the quarantine policy and queues the heartbeat deltas that
    carry findings to the master's repair scheduler.

    `codec_for(data_shards, parity_shards)` gives the EC codec; a volume
    server passes its own (`make_codec`: CudaRSCodec on the card). Without
    one, the scrubber builds a CudaRSCodec, which raises where there is
    no card."""

    def __init__(
        self,
        store,
        rate_mbps: float = 0.0,
        codec_for: Optional[Callable[[int, int], object]] = None,
    ):
        self.store = store
        # an explicit scrub rate wins; otherwise the shared maintenance
        # budget (SEAWEEDFS_TPU_MAINT_MBPS) shapes scrub I/O jointly with
        # vacuum and repair so the planes' SUM stays under one cap
        self.bucket = plane_bucket(
            "scrub",
            TokenBucket(rate_mbps * 1e6)
            if rate_mbps and rate_mbps > 0
            else None,
        )
        self.codec_for = codec_for

    def run_pass(
        self,
        volume_id: Optional[int] = None,
        include_ec: bool = True,
        max_entries_per_volume: Optional[int] = None,
    ) -> dict:
        reports = {"volumes": [], "ec_volumes": [], "quarantined": []}
        for loc in self.store.locations:
            for vid, v in list(loc.volumes.items()):
                if volume_id and vid != volume_id:
                    continue
                if v.is_compacting:
                    continue  # mid-vacuum: nothing verifiable here
                old_msg = self.store._volume_message(v)
                r = scrub_volume(
                    v,
                    self.bucket,
                    max_entries=max_entries_per_volume,
                    quarantine=False,
                )
                if r["corruptions"]:
                    # a vacuum commit may have swapped the Volume object
                    # (new .dat, new offsets) mid-pass, making OUR snapshot
                    # offsets stale — findings must be confirmed against
                    # the CURRENT object before they quarantine anything
                    cur = loc.volumes.get(vid)
                    if cur is not v and cur is not None:
                        r = scrub_volume(
                            cur, self.bucket, resume=False, quarantine=False
                        )
                        v, old_msg = cur, self.store._volume_message(cur)
                reports["volumes"].append(r)
                if r["corruptions"]:
                    first = r["corruptions"][0]
                    v.quarantine(
                        f"scrub: {len(r['corruptions'])} corrupt record(s), "
                        f"first key {first[0]:#x} ({first[1]})"
                    )
                    # push the quarantine to the master on the next pulse
                    self.store.note_volume_changed(
                        old_msg, self.store._volume_message(v)
                    )
                    reports["quarantined"].append({"volume_id": vid})
            if not include_ec:
                continue
            for vid, ev in list(loc.ec_volumes.items()):
                if volume_id and vid != volume_id:
                    continue
                codec = self._codec(ev)
                r = scrub_ec_volume(ev.file_name(), codec, self.bucket)
                r["volume_id"] = vid
                reports["ec_volumes"].append(r)
                for shard_id in r["corrupt_shards"]:
                    if self.quarantine_ec_shard(loc, ev, shard_id):
                        reports["quarantined"].append(
                            {"volume_id": vid, "shard_id": shard_id}
                        )
        return reports

    def _codec(self, ev):
        if self.codec_for is not None:
            return self.codec_for(ev.data_shards, ev.parity_shards)
        from ..gpu.coder import get_codec

        return get_codec("cuda", ev.data_shards, ev.parity_shards)

    def quarantine_ec_shard(self, loc, ev, shard_id: int) -> bool:
        """Corrupt shard: unmount it and move the file aside to `.bad`
        (evidence intact, never deleted). The heartbeat delta reports the
        shard gone, which is exactly the state the master's repair
        scheduler knows how to fix — rebuild from survivors through the
        batched rebuild."""
        from .erasure_coding import to_ext
        from .erasure_coding.ec_volume import ShardBits

        vid, collection = ev.volume_id, ev.collection
        base = ev.file_name()
        path = base + to_ext(shard_id)
        if not os.path.exists(path):
            return False
        loc.unload_ec_shard(vid, shard_id)
        try:
            os.replace(path, path + ".bad")
        except OSError:
            return False
        self.store.note_ec_shards_changed(
            vid, collection, ShardBits(), ShardBits().add(shard_id)
        )
        _LOG.warning(
            "ec volume %d: shard %d failed parity verification, "
            "quarantined to %s.bad", vid, shard_id, path,
        )
        return True
