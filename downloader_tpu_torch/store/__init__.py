"""Object-store abstraction.

The reference's bulk-data backend is S3/MinIO via ``triton-core/minio``
(SURVEY.md §5).  This package defines the exact object-store surface the
pipeline uses — ``getObject`` / ``fGetObject`` / ``fPutObject`` /
``putObject`` / ``bucketExists`` / ``makeBucket`` / ``getObjects``
(upstream lib/main.js:120, lib/upload.js:29-55,
lib/download.js:217-225) — with hermetic in-memory and filesystem-backed
implementations.
"""

from .base import ObjectInfo, ObjectNotFound, ObjectStore
from .cache import ContentCache, Singleflight, cache_key
from .fs import FilesystemObjectStore
from .memory import InMemoryObjectStore

__all__ = [
    "ObjectInfo",
    "ObjectNotFound",
    "ObjectStore",
    "ContentCache",
    "Singleflight",
    "cache_key",
    "FilesystemObjectStore",
    "InMemoryObjectStore",
]


def new_client(config) -> ObjectStore:
    """Build the staging object store from config.

    Capability-equivalent to ``minio.newClient(config)``
    (upstream lib/main.js:41, lib/upload.js:20).  The backend is
    selected by ``config.minio.backend``: ``memory`` (default, hermetic) or
    ``fs`` (rooted at ``config.minio.root``).
    """
    minio_cfg = config.get("minio") if config is not None else None
    backend = (minio_cfg.get("backend", "memory") if minio_cfg is not None else "memory")
    if backend == "fs":
        root = minio_cfg.get("root", "object-store")
        return FilesystemObjectStore(root)
    if backend == "memory":
        return InMemoryObjectStore()
    if backend == "s3":
        from ..platform.config import cfg_get
        from .s3 import S3ObjectStore

        # multipart knobs (``store.multipart_part_size`` /
        # ``store.multipart_concurrency``): deployment-tunable instead of
        # the historical hard-coded 64 MiB / 3 — bad values fail here, at
        # boot, with the S3 API's constraints spelled out
        return S3ObjectStore.from_endpoint(
            minio_cfg.get("endpoint", "localhost:9000"),
            minio_cfg.get("access_key", ""),
            minio_cfg.get("secret_key", ""),
            ssl=minio_cfg.get("ssl", False),
            region=minio_cfg.get("region", "us-east-1"),
            multipart_part_size=cfg_get(
                config, "store.multipart_part_size", None
            ),
            multipart_concurrency=cfg_get(
                config, "store.multipart_concurrency", None
            ),
            # zero-copy staging: mmap-fed multipart parts and
            # sendfile single PUTs on plain http; off = byte-exact
            # read() path everywhere
            zero_copy=bool(cfg_get(config, "store.zero_copy", True)),
        )
    raise ValueError(f"unknown object-store backend {backend!r}")
