"""Volume super block — first 8 bytes of every .dat file.

Byte 0: version; byte 1: replica placement; bytes 2-3: TTL; bytes 4-5:
compaction revision; bytes 6-7: extra size (v2+, protobuf payload follows)
(ref: weed/storage/super_block/super_block.go:13-31,41-66).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..types import CURRENT_VERSION, VERSION2, VERSION3, bytes_to_u16, u16_to_bytes
from .ttl import EMPTY_TTL, TTL

SUPER_BLOCK_SIZE = 8


@dataclass(frozen=True)
class ReplicaPlacement:
    """xyz digits: x = other-DC copies, y = other-rack copies, z = same-rack
    copies (ref: weed/storage/super_block/replica_placement.go)."""

    same_rack_count: int = 0
    diff_rack_count: int = 0
    diff_data_center_count: int = 0

    @staticmethod
    def parse(s: str) -> "ReplicaPlacement":
        if len(s) > 3 or not s.isdigit() and s != "":
            raise ValueError(f"unknown replication type: {s!r}")
        s = (s or "000").zfill(3)
        rp = ReplicaPlacement(
            diff_data_center_count=int(s[0]),
            diff_rack_count=int(s[1]),
            same_rack_count=int(s[2]),
        )
        return rp

    @staticmethod
    def from_byte(b: int) -> "ReplicaPlacement":
        return ReplicaPlacement(
            diff_data_center_count=(b // 100) % 10,
            diff_rack_count=(b // 10) % 10,
            same_rack_count=b % 10,
        )

    def to_byte(self) -> int:
        # the xyz decimal encoding only fits a byte for single-digit
        # components summing under 256; the reference's Go byte()
        # conversion silently TRUNCATES larger placements
        # (replica_placement.go Byte()), corrupting e.g. "300" into 44 on
        # disk — raise instead, and reject out-of-digit components that
        # would alias another placement (1 dc + 15 racks reads back as
        # "250")
        for c in (
            self.diff_data_center_count,
            self.diff_rack_count,
            self.same_rack_count,
        ):
            if not 0 <= c <= 9:
                raise ValueError(
                    f"replica placement component out of range: {c}"
                )
        v = (
            self.diff_data_center_count * 100
            + self.diff_rack_count * 10
            + self.same_rack_count
        )
        if v > 255:
            raise ValueError(
                f"replica placement {self} does not fit the byte encoding"
            )
        return v

    def copy_count(self) -> int:
        return (
            self.diff_data_center_count + self.diff_rack_count + self.same_rack_count + 1
        )

    def __str__(self) -> str:
        return (
            f"{self.diff_data_center_count}{self.diff_rack_count}{self.same_rack_count}"
        )


@dataclass
class SuperBlock:
    version: int = CURRENT_VERSION
    replica_placement: ReplicaPlacement = field(default_factory=ReplicaPlacement)
    ttl: TTL = EMPTY_TTL
    compaction_revision: int = 0
    extra: bytes = b""  # opaque protobuf payload

    def block_size(self) -> int:
        if self.version in (VERSION2, VERSION3):
            return SUPER_BLOCK_SIZE + len(self.extra)
        return SUPER_BLOCK_SIZE

    def to_bytes(self) -> bytes:
        header = bytearray(SUPER_BLOCK_SIZE)
        header[0] = self.version
        header[1] = self.replica_placement.to_byte()
        header[2:4] = self.ttl.to_bytes()
        header[4:6] = u16_to_bytes(self.compaction_revision)
        if self.extra:
            if len(self.extra) > 256 * 256 - 2:
                raise ValueError("super block extra too large")
            header[6:8] = u16_to_bytes(len(self.extra))
            return bytes(header) + self.extra
        return bytes(header)

    @staticmethod
    def parse(header: bytes) -> "SuperBlock":
        """Parse from >= 8 bytes; caller supplies extra bytes if extra_size > 0."""
        if len(header) < SUPER_BLOCK_SIZE:
            raise ValueError("cannot read super block: too short")
        version = header[0]
        if version not in (1, 2, 3):
            raise ValueError(f"unsupported super block version {version}")
        sb = SuperBlock(
            version=version,
            replica_placement=ReplicaPlacement.from_byte(header[1]),
            ttl=TTL.from_bytes(header[2:4]),
            compaction_revision=bytes_to_u16(header[4:6]),
        )
        extra_size = bytes_to_u16(header[6:8])
        if extra_size:
            sb.extra = header[SUPER_BLOCK_SIZE : SUPER_BLOCK_SIZE + extra_size]
            if len(sb.extra) != extra_size:
                raise ValueError("truncated super block extra")
        return sb


def read_super_block(backend_file) -> SuperBlock:
    header = backend_file.read_at(SUPER_BLOCK_SIZE, 0)
    sb = SuperBlock.parse(header)
    extra_size = bytes_to_u16(header[6:8])
    if extra_size:
        sb.extra = backend_file.read_at(extra_size, SUPER_BLOCK_SIZE)
    return sb
