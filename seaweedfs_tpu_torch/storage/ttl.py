"""TTL codec — 2 bytes on disk: count byte + unit byte.

Ref: weed/storage/needle/volume_ttl.go (unit constants :8-17, ReadTTL :26-48,
to/from bytes :50-80).
"""

from __future__ import annotations

from dataclasses import dataclass

EMPTY = 0
MINUTE = 1
HOUR = 2
DAY = 3
WEEK = 4
MONTH = 5
YEAR = 6

_UNIT_TO_CHAR = {MINUTE: "m", HOUR: "h", DAY: "d", WEEK: "w", MONTH: "M", YEAR: "y"}
_CHAR_TO_UNIT = {v: k for k, v in _UNIT_TO_CHAR.items()}

_UNIT_MINUTES = {
    EMPTY: 0,
    MINUTE: 1,
    HOUR: 60,
    DAY: 24 * 60,
    WEEK: 7 * 24 * 60,
    MONTH: 31 * 24 * 60,
    YEAR: 365 * 24 * 60,
}


@dataclass(frozen=True)
class TTL:
    count: int = 0
    unit: int = EMPTY

    @staticmethod
    def read(ttl_string: str) -> "TTL":
        """Parse '3m'/'4h'/'5d'/'6w'/'7M'/'8y' (bare number = minutes)."""
        if not ttl_string:
            return EMPTY_TTL
        unit_ch = ttl_string[-1]
        if unit_ch.isdigit():
            count_str, unit_ch = ttl_string, "m"
        else:
            count_str = ttl_string[:-1]
        if unit_ch not in _CHAR_TO_UNIT:
            raise ValueError(f"unrecognized ttl unit: {unit_ch}")
        return TTL(count=int(count_str), unit=_CHAR_TO_UNIT[unit_ch])

    @staticmethod
    def from_bytes(b: bytes) -> "TTL":
        if b[0] == 0 and b[1] == 0:
            return EMPTY_TTL
        return TTL(count=b[0], unit=b[1])

    @staticmethod
    def from_u32(v: int) -> "TTL":
        return TTL.from_bytes(bytes([(v >> 8) & 0xFF, v & 0xFF]))

    def to_bytes(self) -> bytes:
        return bytes([self.count & 0xFF, self.unit & 0xFF])

    def to_u32(self) -> int:
        if self.count == 0:
            return 0
        return ((self.count & 0xFF) << 8) | (self.unit & 0xFF)

    @property
    def minutes(self) -> int:
        return self.count * _UNIT_MINUTES.get(self.unit, 0)

    def __str__(self) -> str:
        if self.count == 0 or self.unit == EMPTY:
            return ""
        return f"{self.count}{_UNIT_TO_CHAR[self.unit]}"


EMPTY_TTL = TTL()
