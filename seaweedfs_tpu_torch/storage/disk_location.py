"""DiskLocation: one data directory of volumes and EC shards
(ref: weed/storage/disk_location.go, disk_location_ec.go).

Ported from the JAX package's storage/disk_location.py. Every volume and
EC volume it opens lives on `device` (their snapshots on the card unless
the caller asks for the CPU). Two differences: a volume the port cannot
open (an unknown needle map kind, a tiered .dat) raises out of the load
instead of being skipped, and an EC volume whose shards sit on the cold
tier (a `.ctm` manifest) raises, as the cold tier is not ported.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Dict, Optional

from .erasure_coding.ec_volume import EcVolume, EcVolumeShard
from .volume import NEEDLE_MAP_KINDS, Volume

_DAT_RE = re.compile(r"^(?:(?P<collection>.+)_)?(?P<vid>\d+)\.dat$")
_VIF_RE = re.compile(r"^(?:(?P<collection>.+)_)?(?P<vid>\d+)\.vif$")
_EC_RE = re.compile(r"^(?:(?P<collection>.+)_)?(?P<vid>\d+)\.ec(?P<shard>[0-9][0-9])$")
_CTM_RE = re.compile(r"^(?:(?P<collection>.+)_)?(?P<vid>\d+)\.ctm$")


class DiskLocation:
    def __init__(
        self,
        directory: str,
        max_volume_count: int = 7,
        needle_map_kind: str = "memory",
        device=None,
    ):
        if needle_map_kind not in NEEDLE_MAP_KINDS:
            raise ValueError(
                f"unknown needle map kind {needle_map_kind!r} "
                f"(the kinds are {', '.join(NEEDLE_MAP_KINDS)})"
            )
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_volume_count = max_volume_count
        self.needle_map_kind = needle_map_kind
        self.device = device
        self.volumes: Dict[int, Volume] = {}
        self.ec_volumes: Dict[int, EcVolume] = {}
        self._lock = threading.RLock()

    # --- normal volumes ---
    def _discover_volume_names(self) -> list[tuple[str, int]]:
        """Candidate (collection, vid) pairs: .dat files plus .vif
        sidecars (a tiered volume has no local .dat; the port's Volume
        then raises that tiered volumes are not ported)."""
        found: list[tuple[str, int]] = []
        seen: set[tuple[str, int]] = set()
        for name in sorted(os.listdir(self.directory)):
            m = _DAT_RE.match(name) or _VIF_RE.match(name)
            if m is None:
                continue
            parsed = (m.group("collection") or "", int(m.group("vid")))
            if parsed not in seen:
                seen.add(parsed)
                found.append(parsed)
        return found

    def load_existing_volumes(self) -> int:
        count = 0
        for collection, vid in self._discover_volume_names():
            with self._lock:
                if vid in self.volumes:
                    continue
                try:
                    v = Volume(
                        self.directory,
                        collection,
                        vid,
                        create=False,
                        needle_map_kind=self.needle_map_kind,
                        device=self.device,
                    )
                except FileNotFoundError:
                    continue  # a .vif beside EC shards, with no .dat
                self.volumes[vid] = v
                count += 1
        return count

    def add_volume(self, v: Volume) -> None:
        with self._lock:
            self.volumes[v.id] = v

    def find_volume(self, vid: int) -> Optional[Volume]:
        with self._lock:
            return self.volumes.get(vid)

    def delete_volume(self, vid: int, keep_ec_files: bool = False) -> bool:
        with self._lock:
            v = self.volumes.pop(vid, None)
        if v is None:
            return False
        v.destroy(keep_ec_files=keep_ec_files)
        return True

    def unmount_volume(self, vid: int) -> bool:
        with self._lock:
            v = self.volumes.pop(vid, None)
        if v is None:
            return False
        v.close()
        return True

    def close(self) -> None:
        with self._lock:
            for v in self.volumes.values():
                v.close()
            for ev in self.ec_volumes.values():
                ev.close()
            self.volumes.clear()
            self.ec_volumes.clear()

    # --- EC shards (ref disk_location_ec.go) ---
    def find_ec_volume(self, vid: int) -> Optional[EcVolume]:
        with self._lock:
            return self.ec_volumes.get(vid)

    def load_ec_shard(self, collection: str, vid: int, shard_id: int) -> EcVolumeShard:
        shard = EcVolumeShard(self.directory, collection, vid, shard_id)
        with self._lock:
            ev = self.ec_volumes.get(vid)
            if ev is None:
                ev = EcVolume(
                    self.directory, collection, vid, device=self.device,
                    shard_ids=(),
                )
                self.ec_volumes[vid] = ev
            if not ev.add_shard(shard):
                shard.close()  # already mounted
        return shard

    def unload_ec_shard(self, vid: int, shard_id: int) -> bool:
        with self._lock:
            ev = self.ec_volumes.get(vid)
            if ev is None:
                return False
            shard = ev.delete_shard(shard_id)
            if shard is None:
                return False
            shard.close()
            if not ev.shards:
                ev.close()
                del self.ec_volumes[vid]
            return True

    def load_all_ec_shards(self) -> int:
        """Discover .ecNN files with a matching .ecx (ref
        disk_location_ec.go:115-161)."""
        count = 0
        for name in sorted(os.listdir(self.directory)):
            if _CTM_RE.match(name):
                raise NotImplementedError(
                    f"{os.path.join(self.directory, name)}: EC shards on the "
                    "cold tier are not ported"
                )
            m = _EC_RE.match(name)
            if not m:
                continue
            collection = m.group("collection") or ""
            vid = int(m.group("vid"))
            shard_id = int(m.group("shard"))
            base = (
                os.path.join(self.directory, f"{collection}_{vid}")
                if collection
                else os.path.join(self.directory, str(vid))
            )
            if not os.path.exists(base + ".ecx"):
                continue
            try:
                self.load_ec_shard(collection, vid, shard_id)
                count += 1
            except OSError:
                continue
        return count
