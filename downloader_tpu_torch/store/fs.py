"""Filesystem-backed object store.

A durable local backend with the same interface as the in-memory fake:
objects live at ``<root>/<bucket>/<name>`` with ``/`` in object names mapped
to directories.  Useful for running the full service on one machine without
a MinIO server, and for tests that want to inspect staged bytes on disk.
"""

from __future__ import annotations

import asyncio
import collections
import hashlib
import itertools
import os
import re
import shutil
import time
from typing import AsyncIterator, Optional

from .base import ObjectInfo, ObjectNotFound, ObjectStore
from ..platform import vfs
from ..utils.stale import STALE_GRACE_S as _STALE_GRACE_S
from ..utils.stale import STALE_MAX_AGE_S as _STALE_MAX_AGE_S
from ..utils.stale import probe_stale

# in-flight ingest temp name: <dst>.tmp.<pid>.<counter> (fput_object)
_TMP_RE = re.compile(r"\.tmp\.(\d+)\.\d+$")


def _is_stale_tmp(filename: str, path: str) -> bool:
    """True for an ingest temp whose writer is provably gone.

    A put interrupted by SIGKILL/power loss leaves its per-call-unique
    temp behind with nothing to reclaim it.  Policy (grace for cross-
    host NFS writers, live-pid immunity, day-scale bound on
    inconclusive probes) is shared with the transcoder's part-files —
    see :func:`downloader_tpu_torch.utils.stale.probe_stale`."""
    match = _TMP_RE.search(filename)
    if match is None:
        return False
    stale, _age = probe_stale(path, int(match.group(1)))
    return stale


_warned_foreign: set = set()


def _warn_foreign_key(path: str, age: float) -> None:
    """A temp-patterned file the sweep will never reclaim (its pid field
    probes live, so it never goes stale) yet far older than any real
    ingest could run is almost certainly a foreign object key from a
    store predating the reserved-suffix scheme.  It is hidden from
    listings and unreachable by get/put — surface it once per process so
    operators know to migrate it (advisor r4)."""
    if path in _warned_foreign:
        return
    _warned_foreign.add(path)
    from ..platform.logging import get_logger

    get_logger("store.fs").warn(
        "ignoring temp-suffixed file that looks like a foreign object "
        "key (hidden from listings; rename to migrate)",
        path=path, age_s=round(age),
    )


def _safe_parts(name: str) -> list:
    parts = [p for p in name.split("/") if p not in ("", ".")]
    if any(p == ".." for p in parts):
        raise ValueError(f"object name {name!r} escapes the bucket")
    if parts and _TMP_RE.search(parts[-1]):
        # the ingest-temp suffix is a reserved namespace: without this, a
        # user key matching it would be hidden from list_objects and
        # silently reclaimed by the constructor sweep (review r4)
        raise ValueError(
            f"object name {name!r} uses the reserved ingest-temp suffix"
        )
    return parts


class FilesystemObjectStore(ObjectStore):
    """:meth:`fput_object` can ingest a same-filesystem source by
    hardlink instead of a byte copy — O(1) instead of O(size), which
    roughly halves end-to-end staging time (the upload stage was the
    pipeline's most expensive hop).  Linking requires BOTH the per-call
    ``consume=True`` (the caller's promise it stops mutating the source,
    e.g. the upload stage, which deletes its download directory right
    afterwards — reference lib/upload.js:60-64) AND the store-level
    ``link_puts`` switch (default True); a plain ``fput_object`` always
    byte-copies, so callers that keep using the source cannot silently
    alias the stored object.  Objects themselves are always replaced
    atomically, never edited in place, so linking never aliases
    store-side writes.  Cross-device sources (or filesystems without
    hardlinks) transparently fall back to a copy.

    Object keys whose final segment matches the ingest-temp pattern
    (``*.tmp.<digits>.<digits>``) are a reserved namespace: rejected on
    write, filtered from listings, and reclaimable by the orphan sweep.
    The pipeline itself never produces such names (staged objects are
    ``<id>/original/<base64>`` plus ``done``); a FOREIGN store carrying
    such keys from before this scheme should rename them before
    pointing this driver at it."""

    # etag memo capacity: ~a day of staging churn; FIFO eviction (a miss
    # just re-hashes, so the only cost of an eviction is one read pass)
    _MEMO_CAP = 4096

    def __init__(self, root: str, link_puts: bool = True):
        self.root = os.path.abspath(root)
        self.link_puts = link_puts
        self._tmp_seq = itertools.count()
        # per-directory sweep clocks: the per-put orphan reclaim is
        # rate-limited so a bulk ingest into one big directory pays
        # O(listdir) once per grace period, not per put (review r4)
        self._swept: dict = {}
        # etag memo (hash-on-land): ``path -> ((size, mtime_ns, ino),
        # md5_hex)``.  Objects are only ever replaced atomically, never
        # edited in place, so a matching stat signature proves the bytes
        # are the ones the memoized digest was computed over — stat_object
        # answers without re-reading the whole object (the r3-r5 second
        # pass).  Writers seed it: fput_object from the caller's landed
        # digest (``content_md5``), put_object from the in-memory body.
        self._md5_memo: "collections.OrderedDict" = collections.OrderedDict()
        os.makedirs(self.root, exist_ok=True)

    def _memo_signature(self, path: str) -> Optional[tuple]:
        try:
            st = os.stat(path)
        except OSError:
            return None
        return (st.st_size, st.st_mtime_ns, st.st_ino)

    def _memo_store(self, path: str, md5_hex: str) -> None:
        signature = self._memo_signature(path)
        if signature is None:
            return
        self._md5_memo[path] = (signature, md5_hex)
        self._md5_memo.move_to_end(path)
        while len(self._md5_memo) > self._MEMO_CAP:
            self._md5_memo.popitem(last=False)

    def _memo_lookup(self, path: str) -> Optional[str]:
        entry = self._md5_memo.get(path)
        if entry is None:
            return None
        signature, md5_hex = entry
        if signature != self._memo_signature(path):
            # replaced since memoization (or gone): drop the stale digest
            self._md5_memo.pop(path, None)
            return None
        return md5_hex

    def _should_sweep(self, path: str) -> bool:
        dirpath = os.path.dirname(path)
        now = time.monotonic()
        if now - self._swept.get(dirpath, -_STALE_GRACE_S) < _STALE_GRACE_S:
            return False
        if len(self._swept) >= 1024:
            # the ingest layout mints a directory per object id, so the
            # clock dict would grow forever in a long-lived process —
            # evict expired entries (their absence just means one extra
            # sweep later)
            cutoff = now - _STALE_GRACE_S
            self._swept = {d: t for d, t in self._swept.items()
                           if t > cutoff}
        self._swept[dirpath] = now
        return True

    def _bucket_path(self, bucket: str) -> str:
        (part,) = _safe_parts(bucket) or [""]
        return os.path.join(self.root, part)

    def _object_path(self, bucket: str, name: str) -> str:
        return os.path.join(self._bucket_path(bucket), *_safe_parts(name))

    async def bucket_exists(self, bucket: str) -> bool:
        return await asyncio.to_thread(os.path.isdir, self._bucket_path(bucket))

    async def make_bucket(self, bucket: str) -> None:
        await asyncio.to_thread(os.makedirs, self._bucket_path(bucket), exist_ok=True)

    async def get_object(self, bucket: str, name: str) -> bytes:
        path = self._object_path(bucket, name)
        try:
            return await asyncio.to_thread(_read_file, path)
        except (FileNotFoundError, IsADirectoryError):
            raise ObjectNotFound(bucket, name) from None

    async def put_object(self, bucket: str, name: str, data: bytes) -> None:
        path = self._object_path(bucket, name)
        # same unique reclaimable temp naming as fput_object: a bare
        # '<path>.tmp' orphaned by SIGKILL would be enumerated as an
        # object forever (review r4)
        await asyncio.to_thread(
            _write_file_atomic, path, data,
            f"{os.getpid()}.{next(self._tmp_seq)}",
            self._should_sweep(path),
        )
        # the body is already in memory — hashing it here makes the
        # later stat_object free instead of a full read pass
        self._memo_store(path, hashlib.md5(data).hexdigest())

    async def fget_object(self, bucket: str, name: str, file_path: str,
                          *, progress=None) -> None:
        src = self._object_path(bucket, name)
        if not await asyncio.to_thread(os.path.isfile, src):
            raise ObjectNotFound(bucket, name)
        os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)
        await asyncio.to_thread(shutil.copyfile, src, file_path)
        if progress is not None:
            await progress(
                await asyncio.to_thread(os.path.getsize, file_path))

    async def fput_object(self, bucket: str, name: str, file_path: str,
                          *, consume: bool = False,
                          content_md5: Optional[str] = None) -> None:
        dst = self._object_path(bucket, name)
        await asyncio.to_thread(
            _ingest_file_atomic, file_path, dst,
            self.link_puts and consume,
            # pid+counter: two concurrent puts of the same key in one
            # process must not share a tmp name (unlink/link/replace
            # would race and one put would die with FileNotFoundError)
            f"{os.getpid()}.{next(self._tmp_seq)}",
            self._should_sweep(dst),
        )
        if content_md5:
            # hash-on-land hint: the caller digested these exact bytes
            # at their landing moment (and a hardlinked ingest IS the
            # same inode), so stat_object can answer without ever
            # re-reading the object
            self._memo_store(dst, content_md5)

    async def list_objects(self, bucket: str, prefix: str = "") -> AsyncIterator[ObjectInfo]:
        bucket_path = self._bucket_path(bucket)

        def _walk() -> list:
            found = []
            for dirpath, _dirnames, filenames in os.walk(bucket_path):
                for filename in filenames:
                    full = os.path.join(dirpath, filename)
                    match = _TMP_RE.search(filename)
                    if match:
                        # in-flight/orphaned ingest temp, never an
                        # object; reclaim orphans opportunistically —
                        # piggybacking on this walk keeps the sweep
                        # free (no constructor-time full-tree scan)
                        stale, age = probe_stale(full, int(match.group(1)))
                        if stale:
                            try:
                                os.unlink(full)
                            except OSError:
                                pass
                        elif age is not None and age > _STALE_MAX_AGE_S:
                            # live-probing pid + ancient: foreign key
                            _warn_foreign_key(full, age)
                        continue
                    key = os.path.relpath(full, bucket_path).replace(os.sep, "/")
                    if key.startswith(prefix):
                        found.append(ObjectInfo(name=key, size=os.path.getsize(full)))
            found.sort(key=lambda info: info.name)
            return found

        for info in await asyncio.to_thread(_walk):
            yield info

    async def stat_object(self, bucket: str, name: str) -> ObjectInfo:
        path = self._object_path(bucket, name)
        etag = self._memo_lookup(path)
        if etag is not None:
            try:
                size = await asyncio.to_thread(os.path.getsize, path)
            except OSError:
                raise ObjectNotFound(bucket, name) from None
            return ObjectInfo(name=name, size=size, etag=etag)
        try:
            size, etag = await asyncio.to_thread(_stat_with_md5, path)
        except OSError:
            raise ObjectNotFound(bucket, name) from None
        # memoize the computed digest so the NEXT stat (manifest verify,
        # fleet probe) is free — without this, every verify pass is a
        # full read of every staged object
        self._memo_store(path, etag)
        return ObjectInfo(name=name, size=size, etag=etag)

    def local_object_path(self, bucket: str, name: str) -> Optional[str]:
        """Peer hardlink tier: the object's on-disk path when it exists
        locally, else None.  Co-located readers (fleet shared tier) may
        hardlink/reflink it instead of streaming a copy — safe because
        objects are only ever replaced atomically, never edited in
        place, so an aliased inode can't see store-side writes."""
        path = self._object_path(bucket, name)
        return path if os.path.isfile(path) else None

    async def remove_object(self, bucket: str, name: str) -> None:
        path = self._object_path(bucket, name)
        self._md5_memo.pop(path, None)

        def _remove() -> None:
            try:
                os.unlink(path)
            except FileNotFoundError:
                return
            except OSError:
                raise
            # prune now-empty parent dirs up to (not including) the
            # bucket root, so evicted prefix trees don't leave husks
            parent = os.path.dirname(path)
            stop = self._bucket_path(bucket)
            while parent != stop and os.path.isdir(parent):
                try:
                    os.rmdir(parent)
                except OSError:
                    break  # not empty (or racing): done pruning
                parent = os.path.dirname(parent)

        await asyncio.to_thread(_remove)


def _stat_with_md5(path: str) -> tuple:
    from ..utils.hashing import md5_file_hex

    # graftlint: disable=second-pass-read -- the memo-miss fallback: no landed digest survived for this object (foreign writer, process restart), so one read pass re-derives it and re-seeds the memo
    return os.path.getsize(path), md5_file_hex(path)


def _read_file(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def _reclaim_dir(dirpath: str) -> None:
    """Unlink provably-orphaned ingest temps in ONE directory.

    Called on every put (cheap: one listdir of a typically-small dir)
    so write-only workloads reclaim their orphans too — the list walk
    is the other reclaim point, and a deployment that never lists
    would otherwise accumulate SIGKILLed partials forever (review r4)."""
    try:
        names = os.listdir(dirpath)
    except OSError:
        return
    for name in names:
        if _TMP_RE.search(name):
            full = os.path.join(dirpath, name)
            if _is_stale_tmp(name, full):
                try:
                    os.unlink(full)
                except OSError:
                    pass


def _copy_file(src: str, dst: str) -> None:
    """Byte-copy through the write shim so ENOSPC/EIO/short-write
    drills on ``disk.spill`` exercise the spill byte path, not just
    the rename."""
    with open(src, "rb") as rfh, open(dst, "wb") as wfh:
        while True:
            chunk = rfh.read(1 << 20)
            if not chunk:
                break
            vfs.fh_write_all(wfh, chunk, seam="disk.spill", key=dst,
                             thread_ok=True)


def _write_file_atomic(path: str, data: bytes, suffix: str,
                       sweep: bool = True) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if sweep:
        _reclaim_dir(os.path.dirname(path))
    tmp = f"{path}.tmp.{suffix}"
    try:
        with open(tmp, "wb") as fh:
            vfs.fh_write_all(fh, data, seam="disk.spill", key=path,
                             thread_ok=True)
        # fsync-before-rename: the store's objects are the durable tier
        # the scrubber repairs FROM, so a spilled name must never point
        # at bytes the disk does not hold
        vfs.promote(tmp, path, seam="disk.spill", key=path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _ingest_file_atomic(src: str, dst: str, link_ok: bool, suffix: str,
                        sweep: bool = True) -> None:
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    if sweep:
        _reclaim_dir(os.path.dirname(dst))
    tmp = f"{dst}.tmp.{suffix}"
    try:
        if link_ok:
            try:
                os.link(src, tmp)
            except OSError:
                # cross-device (EXDEV), no-hardlink fs (EPERM), link cap
                # (EMLINK): fall through to the byte copy
                _copy_file(src, tmp)
        else:
            _copy_file(src, tmp)
        # a hardlinked ingest shares the source inode, whose bytes the
        # landing path already fsynced; the copy path's durability comes
        # from promote's fsync-before-rename either way
        vfs.promote(tmp, dst, seam="disk.spill", key=dst)
    except BaseException:
        # tmp names are unique per call, so a failed put (ENOSPC, kill
        # signal unwinding) must remove its own leftover — nothing will
        # ever reuse the name, and list_objects would enumerate it
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
