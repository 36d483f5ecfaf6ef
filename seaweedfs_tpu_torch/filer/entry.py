"""Filer entries: attributes + chunk lists (ref: weed/filer2/entry.go).

Ported whole from the JAX package's filer/entry.py."""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class FileChunk:
    fid: str
    offset: int
    size: int  # LOGICAL (plaintext) size; the stored needle may be larger
    mtime_ns: int = 0  # modification stamp deciding overwrite precedence
    etag: str = ""
    # per-chunk AES-256-GCM key when the content is encrypted client-side
    # (ref filer.proto FileChunk.cipher_key, upload_content.go:30); empty =
    # plaintext chunk
    cipher_key: bytes = b""

    def to_dict(self) -> dict:
        d = {
            "fid": self.fid,
            "offset": self.offset,
            "size": self.size,
            "mtime_ns": self.mtime_ns,
            "etag": self.etag,
        }
        if self.cipher_key:
            import base64

            d["cipher_key"] = base64.b64encode(self.cipher_key).decode()
        return d

    @staticmethod
    def from_dict(d: dict) -> "FileChunk":
        ck = d.get("cipher_key") or b""
        if isinstance(ck, str):
            import base64

            ck = base64.b64decode(ck)
        return FileChunk(
            fid=d["fid"],
            offset=int(d["offset"]),
            size=int(d["size"]),
            mtime_ns=int(d.get("mtime_ns", 0)),
            etag=d.get("etag", ""),
            cipher_key=bytes(ck),
        )


@dataclass
class Attr:
    mtime: float = 0.0
    crtime: float = 0.0
    mode: int = 0o660
    uid: int = 0
    gid: int = 0
    mime: str = ""
    replication: str = ""
    collection: str = ""
    ttl_seconds: int = 0

    @property
    def is_directory(self) -> bool:
        return bool(self.mode & 0o40000)


@dataclass
class Entry:
    full_path: str
    attr: Attr = field(default_factory=Attr)
    chunks: list[FileChunk] = field(default_factory=list)
    extended: dict = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.full_path.rsplit("/", 1)[-1]

    @property
    def parent(self) -> str:
        parent = self.full_path.rsplit("/", 1)[0]
        return parent or "/"

    @property
    def is_directory(self) -> bool:
        return self.attr.is_directory

    def size(self) -> int:
        from .filechunks import total_size

        return total_size(self.chunks)

    def to_dict(self) -> dict:
        return {
            "full_path": self.full_path,
            "is_directory": self.is_directory,
            "attr": {
                "mtime": self.attr.mtime,
                "crtime": self.attr.crtime,
                "mode": self.attr.mode,
                "uid": self.attr.uid,
                "gid": self.attr.gid,
                "mime": self.attr.mime,
                "replication": self.attr.replication,
                "collection": self.attr.collection,
                "ttl_seconds": self.attr.ttl_seconds,
            },
            "chunks": [c.to_dict() for c in self.chunks],
            "extended": self.extended,
        }

    @staticmethod
    def from_dict(d: dict) -> "Entry":
        a = d.get("attr", {})
        return Entry(
            full_path=d["full_path"],
            attr=Attr(
                mtime=a.get("mtime", 0.0),
                crtime=a.get("crtime", 0.0),
                mode=int(a.get("mode", 0o660)),
                uid=int(a.get("uid", 0)),
                gid=int(a.get("gid", 0)),
                mime=a.get("mime", ""),
                replication=a.get("replication", ""),
                collection=a.get("collection", ""),
                ttl_seconds=int(a.get("ttl_seconds", 0)),
            ),
            chunks=[FileChunk.from_dict(c) for c in d.get("chunks", [])],
            extended=d.get("extended", {}),
        )


def new_directory_entry(path: str, mode: int = 0o770) -> Entry:
    now = time.time()
    return Entry(
        full_path=path,
        attr=Attr(mtime=now, crtime=now, mode=mode | 0o40000),
    )
