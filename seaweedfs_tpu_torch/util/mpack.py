"""Minimal MessagePack codec for the LSM needle map's `.nmm` manifest.

The JAX package writes the manifest with `msgpack.packb(mf,
use_bin_type=True)` and reads it with `msgpack.unpackb(raw=False)`. The
port must read and write the same bytes without that package, so this
module carries the subset of the format the manifest uses: maps, arrays,
str, bytes (bin), int, float, bool and None. `packb` picks the same
(smallest) encoding msgpack-python does, so its bytes equal
`msgpack.packb(obj, use_bin_type=True)` for those types; floats are
always float64, as msgpack-python packs them by default.
"""

from __future__ import annotations

import struct


def _pack_len(out: bytearray, n: int, fix: int, fix_max: int, wide: tuple) -> None:
    """Length header: fix (|n) when n < fix_max, else the first of the
    (marker, struct format, limit) entries that holds n."""
    if n < fix_max:
        out.append(fix | n)
        return
    for marker, fmt, limit in wide:
        if n <= limit:
            out.append(marker)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} too large for msgpack")


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 32, (
            (0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF), (0xDB, ">I", 0xFFFFFFFF),
        ))
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _pack_len(out, len(b), 0, 0, (
            (0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF), (0xC6, ">I", 0xFFFFFFFF),
        ))
        out += b
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, (
            (0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF),
        ))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, (
            (0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF),
        ))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -0x20 <= v < 0:
        out.append(v & 0xFF)
    elif 0 <= v <= 0xFF:
        out += b"\xcc" + struct.pack(">B", v)
    elif -0x80 <= v < 0:
        out += b"\xd0" + struct.pack(">b", v)
    elif 0 <= v <= 0xFFFF:
        out += b"\xcd" + struct.pack(">H", v)
    elif -0x8000 <= v < 0:
        out += b"\xd1" + struct.pack(">h", v)
    elif 0 <= v <= 0xFFFFFFFF:
        out += b"\xce" + struct.pack(">I", v)
    elif -0x80000000 <= v < 0:
        out += b"\xd2" + struct.pack(">i", v)
    elif 0 <= v <= 0xFFFFFFFFFFFFFFFF:
        out += b"\xcf" + struct.pack(">Q", v)
    elif -0x8000000000000000 <= v < 0:
        out += b"\xd3" + struct.pack(">q", v)
    else:
        raise OverflowError(f"int {v} out of msgpack range")


def packb(obj) -> bytes:
    """obj -> bytes, as msgpack.packb(obj, use_bin_type=True)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# marker -> (struct format, kind) for the fixed-width scalars
_SCALARS = {
    0xCA: (">f", "num"), 0xCB: (">d", "num"),
    0xCC: (">B", "num"), 0xCD: (">H", "num"),
    0xCE: (">I", "num"), 0xCF: (">Q", "num"),
    0xD0: (">b", "num"), 0xD1: (">h", "num"),
    0xD2: (">i", "num"), 0xD3: (">q", "num"),
    0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xDC: (">H", "arr"), 0xDD: (">I", "arr"),
    0xDE: (">H", "map"), 0xDF: (">I", "map"),
}


def _take(b: bytes, pos: int, n: int) -> bytes:
    if pos + n > len(b):
        raise ValueError("truncated msgpack")
    return b[pos : pos + n]


def _unpack(b: bytes, pos: int):
    m = b[pos]
    pos += 1
    if m <= 0x7F:
        return m, pos
    if m >= 0xE0:
        return m - 0x100, pos
    if 0xA0 <= m <= 0xBF:
        n = m & 0x1F
        return _take(b, pos, n).decode("utf-8"), pos + n
    if 0x90 <= m <= 0x9F:
        return _unpack_array(b, pos, m & 0x0F)
    if 0x80 <= m <= 0x8F:
        return _unpack_map(b, pos, m & 0x0F)
    if m == 0xC0:
        return None, pos
    if m == 0xC2:
        return False, pos
    if m == 0xC3:
        return True, pos
    spec = _SCALARS.get(m)
    if spec is None:
        raise ValueError(f"unsupported msgpack marker {m:#x}")
    fmt, kind = spec
    (v,) = struct.unpack_from(fmt, b, pos)
    pos += struct.calcsize(fmt)
    if kind == "num":
        return v, pos
    if kind == "bin":
        return _take(b, pos, v), pos + v
    if kind == "str":
        return _take(b, pos, v).decode("utf-8"), pos + v
    if kind == "arr":
        return _unpack_array(b, pos, v)
    return _unpack_map(b, pos, v)


def _unpack_array(b: bytes, pos: int, n: int):
    out = []
    for _ in range(n):
        v, pos = _unpack(b, pos)
        out.append(v)
    return out, pos


def _unpack_map(b: bytes, pos: int, n: int):
    out = {}
    for _ in range(n):
        k, pos = _unpack(b, pos)
        v, pos = _unpack(b, pos)
        out[k] = v
    return out, pos


def unpackb(data: bytes):
    """bytes -> obj, as msgpack.unpackb(data, raw=False); raises
    ValueError on trailing bytes, truncation or an unsupported type."""
    data = bytes(data)
    try:
        obj, pos = _unpack(data, 0)
    except (IndexError, struct.error) as e:
        raise ValueError(f"truncated msgpack: {e}") from e
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} trailing bytes after msgpack object")
    return obj
