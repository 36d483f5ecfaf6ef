"""File id = (volume id, needle key, cookie) with the reference string format
``{vid},{key_hex}{cookie_hex8}`` where leading zero bytes of the 12-byte
key+cookie buffer are trimmed (ref: weed/storage/needle/file_id.go:63-73).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..types import (
    COOKIE_SIZE,
    NEEDLE_ID_SIZE,
    cookie_to_bytes,
    needle_id_to_bytes,
)


def parse_volume_id(s: str) -> int:
    """Volume id string -> int; ignores anything after non-digits
    (ref: weed/storage/needle/volume_id.go NewVolumeId uses ParseUint)."""
    return int(s)


def format_needle_id_cookie(key: int, cookie: int) -> str:
    buf = needle_id_to_bytes(key) + cookie_to_bytes(cookie)
    nonzero = 0
    while nonzero < len(buf) - 1 and buf[nonzero] == 0:
        nonzero += 1
    return buf[nonzero:].hex()


def parse_needle_id_cookie(s: str) -> tuple[int, int]:
    """Reverse of format_needle_id_cookie: last 8 hex chars are the cookie."""
    if len(s) <= 8:
        raise ValueError(f"needle id+cookie too short: {s!r}")
    # strip any url-style suffix like ".jpg" the reference tolerates upstream
    key = int(s[:-8], 16)
    cookie = int(s[-8:], 16)
    return key, cookie


@dataclass(frozen=True)
class FileId:
    volume_id: int
    key: int
    cookie: int

    @staticmethod
    def parse(fid: str) -> "FileId":
        # a "_delta" suffix addresses the delta-th key after the base fid —
        # the chunked-upload convention for count-assigned ids
        # (ref: weed/storage/needle/needle.go:123-135)
        delta = 0
        underscore = fid.rfind("_")
        if underscore > 0:
            fid, suffix = fid[:underscore], fid[underscore + 1 :]
            delta = int(suffix)
        comma = fid.find(",")
        if comma <= 0:
            raise ValueError(f"wrong fid format: {fid!r}")
        vid = parse_volume_id(fid[:comma])
        key, cookie = parse_needle_id_cookie(fid[comma + 1 :])
        # Go's NeedleId is uint64: key+delta wraps modulo 2^64 there, and
        # an unmasked Python int would overflow the 8-byte serializers
        return FileId(
            volume_id=vid, key=(key + delta) & 0xFFFFFFFFFFFFFFFF,
            cookie=cookie,
        )

    def __str__(self) -> str:
        return f"{self.volume_id},{format_needle_id_cookie(self.key, self.cookie)}"
