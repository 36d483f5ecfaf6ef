"""Minimal MessagePack codec for the files the JAX package writes with
msgpack-python: the LSM needle map's `.nmm` manifest, the filer stores'
WAL and segment frames (`wal.log`, `seg-*.sst`, `*.flog`) and the durable
meta-log's `seg-*.mlog` streams.

The JAX package writes them with `msgpack.packb(obj, use_bin_type=True)`
(or a `Packer(use_bin_type=True)`) and reads them with
`msgpack.unpackb(raw=False)` or a streaming `msgpack.Unpacker(f,
raw=False)`. The port must read and write the same bytes without that
package, so this module carries the subset of the format those files use:
maps, arrays, str, bytes (bin), int, float, bool and None. `packb` picks
the same (smallest) encoding msgpack-python does, so its bytes equal
`msgpack.packb(obj, use_bin_type=True)` for those types; floats are
always float64, as msgpack-python packs them by default. `Unpacker`
iterates a stream of objects as `msgpack.Unpacker` does: a truncated last
object ends the iteration (the valid prefix is kept, `tell()` is the end
of it) and an invalid byte raises ValueError.
"""

from __future__ import annotations

import struct


_PACK_D = struct.Struct(">d").pack
_PACK_H = struct.Struct(">H").pack
_PACK_I = struct.Struct(">I").pack


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


def _pack_str(b: bytes, out: bytearray) -> None:
    n = len(b)
    if n < 32:
        out.append(0xA0 | n)
    elif n <= 0xFF:
        out.append(0xD9)
        out.append(n)
    elif n <= 0xFFFF:
        out.append(0xDA)
        out += _PACK_H(n)
    elif n <= 0xFFFFFFFF:
        out.append(0xDB)
        out += _PACK_I(n)
    else:
        raise ValueError(f"length {n} too large for msgpack")
    out += b


# packed bytes of str map keys seen so far: the records of one kind repeat
# the same keys ("full_path", "attr", "mtime", ...), so each is encoded once
_KEYS: dict = {}
_KEYS_MAX = 4096


def _pack(obj, out: bytearray) -> None:
    # exact-type fast paths first (the metadata records are dicts of str,
    # int and float); subclasses take the isinstance chain below
    t = type(obj)
    if t is str:
        _pack_str(obj.encode("utf-8"), out)
    elif t is dict:
        n = len(obj)
        if n < 16:
            out.append(0x80 | n)
        else:
            _pack_len(out, n, 0x80, 16, ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF)))
        keys = _KEYS
        for k, v in obj.items():
            kb = keys.get(k) if type(k) is str else None
            if kb is None:
                start = len(out)
                _pack(k, out)
                if type(k) is str and len(keys) < _KEYS_MAX:
                    keys[k] = bytes(out[start:])
            else:
                out += kb
            _pack(v, out)
    elif t is int:
        if 0 <= obj < 0x80:
            out.append(obj)
        else:
            _pack_int(obj, out)
    elif t is float:
        out.append(0xCB)
        out += _PACK_D(obj)
    elif obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif t is list or t is tuple:
        n = len(obj)
        if n < 16:
            out.append(0x90 | n)
        else:
            _pack_len(out, n, 0x90, 16, ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += _PACK_D(obj)
    elif isinstance(obj, str):
        _pack_str(str(obj).encode("utf-8"), out)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _pack_len(out, len(b), 0, 0, (
            (0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF), (0xC6, ">I", 0xFFFFFFFF),
        ))
        out += b
    elif isinstance(obj, (list, tuple)):
        _pack(list(obj), out)
    elif isinstance(obj, dict):
        _pack(dict(obj), out)
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
_UNPACK_D = struct.Struct(">d").unpack_from


class OutOfData(ValueError):
    """The stream ends inside an object (msgpack.OutOfData)."""


def _take(b: bytes, pos: int, n: int) -> bytes:
    if pos + n > len(b):
        raise OutOfData("truncated msgpack")
    return b[pos : pos + n]


def _unpack(b: bytes, pos: int):
    m = b[pos]
    pos += 1
    # the frequent markers first: fixstr, positive fixint, fixmap, nil,
    # float64, fixarray
    if 0xA0 <= m <= 0xBF:
        end = pos + (m & 0x1F)
        if end > len(b):
            raise OutOfData("truncated msgpack")
        return b[pos:end].decode("utf-8"), end
    if m <= 0x7F:
        return m, pos
    if 0x80 <= m <= 0x8F:
        out = {}
        for _ in range(m & 0x0F):
            k, pos = _unpack(b, pos)
            v, pos = _unpack(b, pos)
            out[k] = v
        return out, pos
    if m == 0xC0:
        return None, pos
    if m == 0xCB:
        if pos + 8 > len(b):
            raise OutOfData("truncated msgpack")
        return _UNPACK_D(b, pos)[0], pos + 8
    if 0x90 <= m <= 0x9F:
        return _unpack_array(b, pos, m & 0x0F)
    if m >= 0xE0:
        return m - 0x100, pos
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


class Unpacker:
    """The objects of a msgpack stream, one after another, as
    `msgpack.Unpacker(f, raw=False)` yields them. `data` is bytes or a
    binary file (read whole: the streams this reads are a WAL, a segment
    or a meta-log segment). Iteration ends at the end of the data or at a
    truncated last object; `unpack()` raises OutOfData there instead.
    `tell()` is the offset just past the last object returned."""

    def __init__(self, data):
        if hasattr(data, "read"):
            data = data.read()
        self._b = bytes(data)
        self._pos = 0

    def tell(self) -> int:
        return self._pos

    def unpack(self):
        if self._pos >= len(self._b):
            raise OutOfData("end of stream")
        try:
            obj, pos = _unpack(self._b, self._pos)
        except (IndexError, struct.error) as e:
            raise OutOfData(f"truncated msgpack: {e}") from e
        self._pos = pos
        return obj

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return self.unpack()
        except OutOfData:
            raise StopIteration from None
