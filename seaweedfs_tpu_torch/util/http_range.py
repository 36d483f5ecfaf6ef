"""RFC 9110 single-range parsing for the volume server's reads, copied
from the JAX package's util/http_range.py (ref: Go net/http ServeContent
range handling used at weed/server/volume_server_handlers_read.go
writeResponseContent)."""

from __future__ import annotations

from typing import Optional, Tuple, Union

RangeResult = Union[Tuple[int, int], str, None]


def parse_range(rng: str, total: int) -> RangeResult:
    """-> (start, end) inclusive | None (serve full body) |
    "invalid-range" (416 unsatisfiable).

    Unparsable or syntactically invalid specs (including end < start,
    RFC 9110 §14.1.1) are ignored -> None; only a well-formed range whose
    start is past EOF yields 416.
    """
    if not rng.startswith("bytes=") or "," in rng:
        return None
    start_s, sep, end_s = rng[len("bytes="):].strip().partition("-")
    if not sep:
        return None
    try:
        if start_s == "":
            if end_s == "":
                return None
            if int(end_s) == 0:
                # 'bytes=-0' is a zero-length suffix: unsatisfiable per
                # RFC 9110 (matches Go http.ServeContent)
                return "invalid-range"
            start, end = max(0, total - int(end_s)), total - 1
        else:
            start = int(start_s)
            end = int(end_s) if end_s else total - 1
    except ValueError:
        return None
    if start < 0 or end < start:
        return None
    if start >= total:
        return "invalid-range"
    return min(start, total - 1), min(end, total - 1)
