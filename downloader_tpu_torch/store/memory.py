"""Hermetic in-memory object store (the test fake for MinIO/S3)."""

from __future__ import annotations

import asyncio
import hashlib
import os
from typing import AsyncIterator, Dict

from .base import ObjectInfo, ObjectNotFound, ObjectStore


class InMemoryObjectStore(ObjectStore):
    def __init__(self) -> None:
        self._buckets: Dict[str, Dict[str, bytes]] = {}
        self._lock = asyncio.Lock()

    async def bucket_exists(self, bucket: str) -> bool:
        return bucket in self._buckets

    async def make_bucket(self, bucket: str) -> None:
        async with self._lock:
            self._buckets.setdefault(bucket, {})

    def _bucket(self, bucket: str, name: str = "") -> Dict[str, bytes]:
        try:
            return self._buckets[bucket]
        except KeyError:
            raise ObjectNotFound(bucket, name) from None

    async def get_object(self, bucket: str, name: str) -> bytes:
        objects = self._bucket(bucket, name)
        try:
            return objects[name]
        except KeyError:
            raise ObjectNotFound(bucket, name) from None

    async def put_object(self, bucket: str, name: str, data: bytes) -> None:
        async with self._lock:
            self._buckets.setdefault(bucket, {})[name] = bytes(data)

    async def fget_object(self, bucket: str, name: str, file_path: str,
                          *, progress=None) -> None:
        data = await self.get_object(bucket, name)
        os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)
        await asyncio.to_thread(_write_file, file_path, data)
        if progress is not None:
            await progress(len(data))

    async def fput_object(self, bucket: str, name: str, file_path: str,
                          *, consume: bool = False) -> None:
        data = await asyncio.to_thread(_read_file, file_path)
        await self.put_object(bucket, name, data)

    async def list_objects(self, bucket: str, prefix: str = "") -> AsyncIterator[ObjectInfo]:
        objects = self._buckets.get(bucket, {})
        for name in sorted(objects):
            if name.startswith(prefix):
                yield ObjectInfo(name=name, size=len(objects[name]))

    async def stat_object(self, bucket: str, name: str) -> ObjectInfo:
        data = await self.get_object(bucket, name)
        return ObjectInfo(
            name=name, size=len(data), etag=hashlib.md5(data).hexdigest()
        )

    async def remove_object(self, bucket: str, name: str) -> None:
        async with self._lock:
            self._buckets.get(bucket, {}).pop(name, None)

    async def get_object_versioned(self, bucket: str, name: str):
        async with self._lock:
            objects = self._bucket(bucket, name)
            try:
                data = objects[name]
            except KeyError:
                raise ObjectNotFound(bucket, name) from None
            return data, hashlib.md5(data).hexdigest()

    async def put_object_cas(self, bucket: str, name: str, data: bytes, *,
                             if_match=None, if_none_match=False):
        # the whole compare+swap under one lock: this fake is the
        # reference semantics the MiniS3 412 path must agree with
        async with self._lock:
            objects = self._buckets.setdefault(bucket, {})
            current = objects.get(name)
            if if_none_match:
                if current is not None:
                    return None
            elif if_match is not None:
                if current is None:
                    return None
                if hashlib.md5(current).hexdigest() != if_match:
                    return None
            objects[name] = bytes(data)
            return hashlib.md5(objects[name]).hexdigest()


def _write_file(path: str, data: bytes) -> None:
    with open(path, "wb") as fh:
        fh.write(data)


def _read_file(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()
