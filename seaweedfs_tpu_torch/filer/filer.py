"""Filer core: directory-tree invariants over a FilerStore
(ref: weed/filer2/filer.go:29-42, filer_delete_entry.go).

Ported whole from the JAX package's filer/filer.py. The event names the
JAX module imports from notification/ (not ported yet) are copied here;
the notifier hook stays, and the filer server passes None."""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, Iterable, Optional

from .entry import Attr, Entry, FileChunk, new_directory_entry
from .filer_store import FilerStore
from .meta_log import MetaLog

# durable ledger of fids referenced by MORE than one entry (S3
# UploadPartCopy's chunk-aligned fast path shares source fids with the
# copied part instead of re-uploading bytes). Stored as a hidden entry in
# the filer store itself so refcounts survive restarts with the entries
# they protect.
FID_REFS_PATH = "/.seaweedfs/fid_refs"

# the meta-log event types (the JAX package's notification/__init__.py)
EVENT_CREATE = "create"
EVENT_UPDATE = "update"
EVENT_DELETE = "delete"
EVENT_RENAME = "rename"


class Filer:
    def __init__(
        self,
        store: FilerStore,
        on_delete_chunks: Optional[Callable] = None,
        notifier=None,
        meta_log: Optional[MetaLog] = None,
    ):
        self.store = store
        self.on_delete_chunks = on_delete_chunks  # async fid-deletion queue hook
        self.notifier = notifier  # notification.Notifier (ref filer_notify.go)
        # meta change log feeding SubscribeMetadata streams + `weed watch`
        # (ref filer.go:38 LocalMetaLogBuffer); callers needing durable
        # history + resumable cursors pass a DurableMetaLog
        self.meta_log = meta_log if meta_log is not None else MetaLog()
        self._fid_refs_cache: Optional[dict[str, int]] = None
        self._fid_refs_lock = threading.Lock()
        root = self.store.find_entry("/")
        if root is None:
            self.store.insert_entry(new_directory_entry("/", 0o775))

    # --- shared-fid refcount ledger (UploadPartCopy chunk referencing) ---
    def _fid_refs(self) -> dict[str, int]:
        """EXTRA references per shared fid (a fid listed by K entries has
        K-1 extra refs); loaded lazily from the durable ledger entry."""
        if self._fid_refs_cache is None:
            refs: dict[str, int] = {}
            e = self.store.find_entry(FID_REFS_PATH)
            if e is not None:
                try:
                    refs = {
                        k: int(v)
                        for k, v in json.loads(
                            e.extended.get("refs", "{}")
                        ).items()
                        if int(v) > 0
                    }
                except (ValueError, TypeError, AttributeError):
                    refs = {}
            self._fid_refs_cache = refs
        return self._fid_refs_cache

    def _save_fid_refs(self) -> None:
        refs = {k: v for k, v in self._fid_refs().items() if v > 0}
        self._fid_refs_cache = refs
        now = time.time()
        self._ensure_parents(FID_REFS_PATH)
        # internal bookkeeping: no meta-log event, no notification
        self.store.insert_entry(
            Entry(
                full_path=FID_REFS_PATH,
                attr=Attr(mtime=now, crtime=now),
                extended={"refs": json.dumps(refs)},
            )
        )

    def add_fid_refs(self, fids: Iterable[str]) -> None:
        """Register one EXTRA reference per listed fid — called BEFORE a
        second entry starts listing a fid it does not own, so a racing
        delete of the original owner can only decrement, never free."""
        fids = [f for f in fids if f]
        if not fids:
            return
        with self._fid_refs_lock:
            refs = self._fid_refs()
            for fid in fids:
                refs[fid] = refs.get(fid, 0) + 1
            self._save_fid_refs()

    def release_fids(self, fids: Iterable[str]) -> None:
        """The single chunk-release gate: every path that used to hand
        fids straight to `on_delete_chunks` routes here. A fid with extra
        references burns one instead of being enqueued for deletion —
        whichever referencing entry dies LAST actually frees the needle."""
        fids = sorted({f for f in fids if f})
        if not fids:
            return
        free: list[str] = []
        with self._fid_refs_lock:
            refs = self._fid_refs()
            changed = False
            for fid in fids:
                if refs.get(fid, 0) > 0:
                    refs[fid] -= 1
                    changed = True
                else:
                    free.append(fid)
            if changed:
                self._save_fid_refs()
        if free and self.on_delete_chunks:
            self.on_delete_chunks(free)

    def _notify(
        self,
        event_type: str,
        path: str,
        entry: Optional[Entry],
        old_entry: Optional[Entry] = None,
    ) -> None:
        entry_dict = entry.to_dict() if entry else None
        old_dict = old_entry.to_dict() if old_entry else None
        directory = path.rsplit("/", 1)[0] or "/"
        if event_type == EVENT_CREATE:
            old_dict = None
        if event_type == EVENT_DELETE:
            old_dict, entry_dict = old_dict or entry_dict, None
        self.meta_log.append(
            directory, event_type, old_entry=old_dict, new_entry=entry_dict
        )
        if self.notifier is not None:
            sink_dict = entry_dict or old_dict
            if event_type == "rename" and old_entry is not None and sink_dict:
                # replication sinks need the source path to drop the old key
                sink_dict = dict(sink_dict)
                sink_dict["_old_path"] = old_entry.full_path
            self.notifier.notify(event_type, path, sink_dict)

    # --- mkdir -p for parents (ref filer.go CreateEntry ensuring dirs) ---
    def _ensure_parents(self, full_path: str) -> None:
        # fast path: when the DIRECT parent already exists as a directory,
        # its own ancestors exist by construction (directories are only
        # ever created through this walk, and deletes remove whole
        # subtrees), so the per-component probe chain collapses to one
        # store lookup — measurable at gateway PUT rates on deep paths
        parent = full_path.rstrip("/").rpartition("/")[0]
        if parent and parent != "/":
            existing = self.store.find_entry(parent)
            if existing is not None:
                if not existing.is_directory:
                    raise NotADirectoryError(f"{parent} is a file")
                return
        parts = [p for p in full_path.split("/") if p][:-1]
        chain: list[str] = []
        path = ""
        for p in parts:
            path += "/" + p
            chain.append(path)
        if not chain:
            return
        # the whole ancestor spine probes as ONE ragged batch (a deep
        # path costs one find_many, not one store round trip per
        # component); stores without the batched seam keep the per-
        # component walk
        find_many = getattr(self.store, "find_many", None)
        found = find_many(chain) if find_many is not None else None
        missing: list[Entry] = []
        for path in chain:
            existing = (
                found.get(path) if found is not None
                else self.store.find_entry(path)
            )
            if existing is None:
                missing.append(new_directory_entry(path))
            elif not existing.is_directory:
                raise NotADirectoryError(f"{path} is a file")
        if missing:
            # the missing spine inserts as ONE batched round too (the
            # write twin of the probe above), root-first by construction
            self._insert_batch(missing)

    def _insert_batch(self, entries: list[Entry]) -> None:
        im = getattr(self.store, "insert_many", None)
        if im is not None:
            im(entries)
        else:
            for e in entries:
                self.store.insert_entry(e)

    def create_entry(self, entry: Entry, exclusive: bool = False) -> None:
        """exclusive=True is the O_EXCL analogue: refuse to replace any
        existing entry (the replace path frees the old file's chunks, so
        directory-creating callers must never race onto a file)."""
        if entry.full_path != "/":
            self._ensure_parents(entry.full_path)
        existing = self.store.find_entry(entry.full_path)
        if exclusive and existing is not None:
            raise FileExistsError(entry.full_path)
        if existing is not None and existing.chunks:
            old_fids = {c.fid for c in existing.chunks} - {
                c.fid for c in entry.chunks
            }
            if old_fids:
                self.release_fids(old_fids)
        self.store.insert_entry(entry)
        self._notify(
            EVENT_UPDATE if existing is not None else EVENT_CREATE,
            entry.full_path,
            entry,
            old_entry=existing,
        )

    def update_entry(self, entry: Entry) -> None:
        old = self.store.find_entry(entry.full_path)
        self.store.update_entry(entry)
        self._notify(EVENT_UPDATE, entry.full_path, entry, old_entry=old)

    def find_entry(self, full_path: str) -> Optional[Entry]:
        return self.store.find_entry(full_path)

    def delete_entry(
        self, full_path: str, recursive: bool = False, delete_chunks: bool = True
    ) -> list[FileChunk]:
        """Returns the chunks to garbage-collect
        (ref filer_delete_entry.go)."""
        entry = self.store.find_entry(full_path)
        if entry is None:
            return []
        collected: list[FileChunk] = []
        deleted_children: list[Entry] = []
        if entry.is_directory:
            children = self.store.list_directory_entries(full_path, "", True, 2)
            if children and not recursive:
                raise OSError(f"directory {full_path} not empty")
            for child in self.list_entries_recursive(full_path):
                collected.extend(child.chunks)
                deleted_children.append(child)
            self.store.delete_folder_children(full_path)
        else:
            collected.extend(entry.chunks)
        self.store.delete_entry(full_path)
        if delete_chunks and collected:
            self.release_fids({c.fid for c in collected})
        # per-child events so deeper-prefix subscribers see their deletions
        # (ref filer_grpc_server_rename.go / filer_delete_entry.go notify
        # per moved/removed entry)
        for child in deleted_children:
            self._notify(EVENT_DELETE, child.full_path, None, old_entry=child)
        self._notify(EVENT_DELETE, full_path, None, old_entry=entry)
        return collected

    def list_entries(
        self,
        dir_path: str,
        start_file_name: str = "",
        inclusive: bool = True,
        limit: int = 1024,
    ) -> list[Entry]:
        return self.store.list_directory_entries(
            dir_path, start_file_name, inclusive, limit
        )

    def list_entries_recursive(self, dir_path: str):
        stack = [dir_path]
        while stack:
            d = stack.pop()
            last = ""
            while True:
                batch = self.store.list_directory_entries(d, last, False, 1024)
                if not batch:
                    break
                for e in batch:
                    yield e
                    if e.is_directory:
                        stack.append(e.full_path)
                last = batch[-1].name

    def rename(self, old_path: str, new_path: str) -> None:
        """Move a file or directory subtree (ref filer_grpc_server_rename.go)."""
        entry = self.store.find_entry(old_path)
        if entry is None:
            raise FileNotFoundError(old_path)
        if new_path == old_path or new_path.startswith(old_path + "/"):
            # moving a directory into its own subtree would insert the
            # moved children and then prefix-delete them with the source
            raise OSError(f"cannot move {old_path} into itself")
        # validate the destination BEFORE any child is moved — failing
        # mid-loop would leave half-migrated metadata behind
        dest = self.store.find_entry(new_path)
        if dest is not None:
            if dest.is_directory:
                raise IsADirectoryError(new_path)
            if entry.is_directory:
                raise NotADirectoryError(new_path)
        self._ensure_parents(new_path)
        if entry.is_directory:
            # the whole subtree inserts as ONE batched store round
            # (per-child inserts paid a commit/fsync each); per-child
            # rename events still flow so subscribers see every move
            pairs = [
                (
                    child,
                    Entry(
                        full_path=new_path
                        + child.full_path[len(old_path):],
                        attr=child.attr,
                        chunks=child.chunks,
                        extended=child.extended,
                    ),
                )
                for child in self.list_entries_recursive(old_path)
            ]
            if pairs:
                self._insert_batch([moved for _c, moved in pairs])
            for child, moved in pairs:
                self._notify(
                    EVENT_RENAME, moved.full_path, moved, old_entry=child
                )
            self.store.delete_folder_children(old_path)
        # an overwritten destination FILE must free its chunks (mirror of
        # create_entry's replace path)
        if dest is not None and dest.chunks:
            old_fids = {c.fid for c in dest.chunks} - {
                c.fid for c in entry.chunks
            }
            if old_fids:
                self.release_fids(old_fids)
        entry_new = Entry(
            full_path=new_path,
            attr=entry.attr,
            chunks=entry.chunks,
            extended=entry.extended,
        )
        self.store.insert_entry(entry_new)
        self.store.delete_entry(old_path)
        self._notify(EVENT_RENAME, new_path, entry_new, old_entry=entry)

    def touch(self, full_path: str, mime: str, chunks: list[FileChunk], **attrs) -> Entry:
        now = time.time()
        entry = Entry(
            full_path=full_path,
            attr=Attr(mtime=now, crtime=now, mime=mime, **attrs),
            chunks=chunks,
        )
        self.create_entry(entry)
        return entry

    # --- gate-batched write seam ---
    async def create_entry_gated(
        self,
        entry: Entry,
        write_gate,
        lookup_gate=None,
        exclusive: bool = False,
    ) -> None:
        """`create_entry` with both halves coalesced across concurrent
        callers: the ancestor-spine + existing-entry probe rides the
        lookup gate (one `find_many` per event-loop wakeup) and the
        inserts — missing parents + the leaf — ride the write gate (one
        `insert_many` per wakeup), so a burst of S3 PUTs costs
        O(wakeups) store round-trips instead of O(objects).

        exclusive=True keeps the synchronous path: its probe-then-insert
        must stay one atomic block (the O_EXCL contract), which gate
        batching deliberately gives up."""
        if entry.full_path == "/" or exclusive or write_gate is None:
            self.create_entry(entry, exclusive=exclusive)
            return
        parts = [p for p in entry.full_path.split("/") if p][:-1]
        chain: list[str] = []
        path = ""
        for p in parts:
            path += "/" + p
            chain.append(path)
        probe = chain + [entry.full_path]
        if lookup_gate is not None:
            results = await lookup_gate.lookup_many(probe)
        else:
            find_many = getattr(self.store, "find_many", None)
            if find_many is not None:
                found = find_many(probe)
            else:
                found = {
                    p: e
                    for p in probe
                    if (e := self.store.find_entry(p)) is not None
                }
            results = [found.get(p) for p in probe]
        existing = results[-1]
        batch: list[Entry] = []
        for p, got in zip(chain, results[:-1]):
            if got is None:
                batch.append(new_directory_entry(p))
            elif not got.is_directory:
                raise NotADirectoryError(f"{p} is a file")
        if existing is not None and existing.chunks:
            old_fids = {c.fid for c in existing.chunks} - {
                c.fid for c in entry.chunks
            }
            if old_fids:
                self.release_fids(old_fids)
        batch.append(entry)
        # parents enqueue ahead of the leaf in ONE contribution; the
        # await returns only once the whole group is durably stored
        await write_gate.insert_many(batch)
        self._notify(
            EVENT_UPDATE if existing is not None else EVENT_CREATE,
            entry.full_path,
            entry,
            old_entry=existing,
        )

    async def touch_gated(
        self,
        full_path: str,
        mime: str,
        chunks: list[FileChunk],
        write_gate,
        lookup_gate=None,
        **attrs,
    ) -> Entry:
        now = time.time()
        entry = Entry(
            full_path=full_path,
            attr=Attr(mtime=now, crtime=now, mime=mime, **attrs),
            chunks=chunks,
        )
        await self.create_entry_gated(
            entry, write_gate, lookup_gate=lookup_gate
        )
        return entry
