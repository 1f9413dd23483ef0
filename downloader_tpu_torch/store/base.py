"""Object-store interface: the MinIO surface the pipeline actually uses."""

from __future__ import annotations

import abc
import dataclasses
from typing import AsyncIterator


class ObjectNotFound(KeyError):
    """Raised when a bucket/object does not exist.

    The orchestrator's idempotency probe relies on catching this
    (reference catches the MinIO getObject error at
    upstream lib/main.js:119-124)."""

    def __init__(self, bucket: str, name: str):
        super().__init__(f"{bucket}/{name}")
        self.bucket = bucket
        self.name = name


@dataclasses.dataclass(frozen=True)
class ObjectInfo:
    """Listing entry (reference iterates ``item.name``/``item.size`` from
    ``getObjects``, upstream lib/download.js:217-222).

    ``etag`` is the content hash when the backend knows it (S3-style MD5
    hex for single-part objects), else ``""``.  Consumers must treat an
    empty etag as "unknown", never as "matches".
    """

    name: str
    size: int
    etag: str = ""


class ObjectStore(abc.ABC):
    """Async object-store client."""

    @abc.abstractmethod
    async def bucket_exists(self, bucket: str) -> bool:
        """(reference lib/upload.js:29)"""

    @abc.abstractmethod
    async def make_bucket(self, bucket: str) -> None:
        """(reference lib/upload.js:30)"""

    @abc.abstractmethod
    async def get_object(self, bucket: str, name: str) -> bytes:
        """Fetch an object's bytes; raises :class:`ObjectNotFound`
        (reference lib/main.js:120)."""

    @abc.abstractmethod
    async def put_object(self, bucket: str, name: str, data: bytes) -> None:
        """Store bytes as an object (reference lib/upload.js:55)."""

    @abc.abstractmethod
    async def fget_object(self, bucket: str, name: str, file_path: str,
                          *, progress=None) -> None:
        """Download an object to a local file, creating parent dirs
        (reference lib/download.js:225).

        ``progress`` is an optional ``async (bytes_moved)`` callback for
        live transfer counters; backends that land the file in one step
        may fire it once with the full size."""

    @abc.abstractmethod
    async def fput_object(self, bucket: str, name: str, file_path: str,
                          *, consume: bool = False) -> None:
        """Upload a local file as an object (reference lib/upload.js:45).

        ``consume=True`` is the caller's promise that it will not MUTATE
        ``file_path``'s bytes after the call — backends may then ingest
        by aliasing (e.g. hardlink) instead of copying.  The path itself
        must remain on disk, unchanged, until the caller removes it: the
        streaming pipeline uploads files mid-download and still needs
        them afterwards (the authoritative post-download walk, torrent
        piece serving, cache fills), so a backend must never DELETE or
        move the source.  The default is the safe byte copy."""

    @abc.abstractmethod
    def list_objects(self, bucket: str, prefix: str = "") -> AsyncIterator[ObjectInfo]:
        """Iterate objects under ``prefix`` (reference ``getObjects``,
        lib/download.js:217)."""

    async def remove_object(self, bucket: str, name: str) -> None:
        """Delete one object; idempotent (a missing object is success).

        Added for the fleet GC sweep (fleet/plane.py): evicting aged
        ``.fleet-cache/`` entries and compacting ``.fleet/`` tombstones
        needs real deletion.  Kept OUT of the pipeline's staging path —
        staged media is never deleted by this service.  Backends that
        cannot delete raise NotImplementedError and the GC degrades to a
        no-op (bounded by that backend's own lifecycle policies).
        """
        raise NotImplementedError(
            f"{type(self).__name__} does not support remove_object"
        )

    async def stat_object(self, bucket: str, name: str) -> ObjectInfo:
        """Metadata for one object; raises :class:`ObjectNotFound`.

        Used by the upload stage to skip files that are already staged
        (file-level resume — the reference re-uploads everything on a
        redelivered job, lib/upload.js:34-52).  Default implementation
        scans a prefix listing; backends override with a cheaper probe.
        """
        async for info in self.list_objects(bucket, prefix=name):
            if info.name == name:
                return info
        raise ObjectNotFound(bucket, name)

    async def get_object_versioned(self, bucket: str, name: str):
        """Fetch ``(bytes, etag)`` atomically; raises ObjectNotFound.

        The etag is the token ``put_object_cas`` accepts as ``if_match``
        — together they are the read half of an S3 conditional-write
        (compare-and-swap) loop.  Backends without a native combined
        read fall back to get + stat, which is only best-effort.
        """
        data = await self.get_object(bucket, name)
        try:
            info = await self.stat_object(bucket, name)
            etag = info.etag
        except ObjectNotFound:
            etag = ""
        return data, etag

    async def put_object_cas(self, bucket: str, name: str, data: bytes, *,
                             if_match: "str | None" = None,
                             if_none_match: bool = False) -> "str | None":
        """Conditional put (S3 ``If-Match`` / ``If-None-Match: *``).

        Exactly one of the preconditions must be armed: ``if_none_match=
        True`` succeeds only when the object does NOT exist (create),
        ``if_match=<etag>`` only when the live object's etag still equals
        the one read earlier (replace).  Returns the NEW object's etag on
        success or ``None`` when the precondition failed (someone else
        won the race) — precondition failure is an expected outcome, not
        an error.  Backends that cannot do server-side conditions raise
        NotImplementedError and callers degrade to the best-effort
        nonce-verify discipline (fleet/coord.py BucketCoordStore).
        """
        raise NotImplementedError(
            f"{type(self).__name__} does not support conditional writes"
        )
