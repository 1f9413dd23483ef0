"""Content-addressed staging cache with singleflight coalescing.

The reference service treats every ``v1.download`` job as independent:
ten jobs for the same popular episode fetch, filter, and upload the same
bytes ten times (its only dedup is the post-hoc idempotency probe on
*completed* jobs, lib/main.js:119-124).  Under fan-in load the hot path
is redundant network and disk I/O.  This module removes both:

- :class:`ContentCache` — completed downloads kept on disk, keyed by
  content identity (torrent infohash, or URL + RFC-7232 validator).
  Entries materialize into job workdirs by hardlink (O(1)) with a byte
  copy as the cross-device fallback, and are evicted LRU against a
  configurable disk budget.
- :class:`Singleflight` — a job arriving while the same key is already
  mid-download awaits the in-flight fetch instead of starting its own;
  the leader's progress is re-broadcast so each waiter can re-emit it
  through its own telemetry channel.

Crash safety: an entry is only ever visible once its directory — with
the ``.meta.json`` manifest inside — has been atomically renamed into
place.  Fills stage under ``staging/`` with pid-tagged names; a crashed
fill leaves a staging dir that the next construction sweeps via the
shared pid-probe policy (``utils/stale.py``).  Eviction deletes the
manifest first, so a crash mid-evict leaves a manifest-less dir that the
sweep also reclaims — a partial entry is never served.

Eviction while an entry is being read is safe by construction: entries
materialize via hardlink, so unlinking the cache's copy never invalidates
bytes already linked into a workdir; a mid-materialize eviction is
additionally excluded by pinning.
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import itertools
import json
import os
import shutil
import time
from typing import Any, Callable, Dict, List, Optional

from ..utils.disk import free_bytes
from ..utils.stale import probe_stale

META_NAME = ".meta.json"

# default disk budget for cached content (overridable via config/env)
DEFAULT_MAX_BYTES = 10 << 30
# default free-disk floor the orchestrator's admission gate maintains on
# the cache volume before starting a new job
DEFAULT_MIN_FREE_BYTES = 256 << 20


def resolve_cache_path(config) -> str:
    """Where the content cache lives on disk, resolved exactly as
    :meth:`ContentCache.from_config` does: ``CACHE_DIR`` /
    ``instance.cache.path``, defaulting to ``<download_path>/.cache``,
    relative paths anchored at the repo root.

    Shared with the orchestrator's boot workdir sweep, which must
    PROTECT this directory — two divergent copies of the resolution
    would eventually let the sweep rmtree the whole LRU cache.
    """
    from ..platform.config import cfg_get

    path = os.environ.get("CACHE_DIR") or cfg_get(
        config, "instance.cache.path", None
    )
    if not path:
        # default beside the per-job download dirs; dot-prefixed so it
        # can never collide with a media-id workdir
        configured = cfg_get(
            config, "instance.download_path", "downloading"
        )
        path = os.path.join(configured, ".cache")
    if not os.path.isabs(path):
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        path = os.path.join(repo_root, path)
    return path


def cache_key(*parts: str) -> str:
    """Stable content key from identity parts (protocol, locator,
    validator).  SHA-256 so hostile URLs cannot craft path segments."""
    joined = "\x00".join(parts)
    return hashlib.sha256(joined.encode("utf-8", "surrogatepass")).hexdigest()


class _Flight:
    """One in-flight fetch: waiters block on ``wait``; the leader feeds
    ``report`` and finally ``resolve``/``reject``."""

    __slots__ = ("key", "progress", "waiters", "_done", "_error", "_resolved")

    def __init__(self, key: str):
        self.key = key
        self.progress: Optional[int] = None
        self.waiters: int = 0
        self._done = asyncio.Event()
        self._error: Optional[BaseException] = None
        self._resolved = False

    def report(self, percent: int) -> None:
        """Leader-side progress (0-100 of the download band).  Waiters
        observing the change re-emit through their own telemetry."""
        if percent != self.progress:
            self.progress = percent
            # wake waiters without ending the flight: set-and-clear makes
            # Event double as a broadcast condition (every current waiter
            # of .wait() is released on set())
            self._done.set()
            if self._error is None and not self._finished():
                self._done.clear()

    def _finished(self) -> bool:
        return self._error is not None or self._resolved

    def resolve(self) -> None:
        self._resolved = True
        self._done.set()

    def reject(self, err: BaseException) -> None:
        self._error = err
        self._done.set()

    async def wait(
        self, on_progress: Optional[Callable[[int], Any]] = None
    ) -> None:
        """Block until the leader settles; re-emit each progress change
        via ``on_progress`` (may be a coroutine function).  Raises
        :class:`LeaderFailed` when the leader errored — the waiter should
        retry (and may become the new leader)."""
        last = None
        while True:
            await self._done.wait()
            if self.progress is not None and self.progress != last:
                last = self.progress
                if on_progress is not None:
                    result = on_progress(self.progress)
                    if asyncio.iscoroutine(result):
                        await result
            if self._error is not None:
                raise LeaderFailed(self.key) from self._error
            if self._resolved:
                return
            # progress-only wakeup: re-arm and keep waiting
            self._done.clear()


class LeaderFailed(Exception):
    """The in-flight fetch this waiter coalesced onto failed; retry."""


class Singleflight:
    """Per-process fan-in coalescing keyed by content key.

    ``run(key, fetch, on_wait_progress)`` returns True when this caller
    became the leader and ran ``fetch`` (which receives a
    ``report(percent)`` callable), False when it awaited a concurrent
    caller's in-flight fetch.  A leader failure releases the waiters to
    retry — the next one through becomes the new leader, so one
    transient error never fails the whole fan-in.
    """

    def __init__(self):
        self._inflight: Dict[str, _Flight] = {}

    def flight(self, key: str) -> Optional[_Flight]:
        return self._inflight.get(key)

    async def run(
        self,
        key: str,
        fetch: Callable[[Callable[[int], None]], Any],
        on_wait_progress: Optional[Callable[[int], Any]] = None,
    ) -> bool:
        """Coalesce ``fetch`` under ``key``.  Returns True when this
        caller led the fetch, False when it waited on another's."""
        while True:
            flight = self._inflight.get(key)
            if flight is None:
                flight = _Flight(key)
                self._inflight[key] = flight
                try:
                    await fetch(flight.report)
                except BaseException as err:
                    flight.reject(err)
                    raise
                else:
                    flight.resolve()
                    return True
                finally:
                    self._inflight.pop(key, None)
            else:
                flight.waiters += 1
                try:
                    await flight.wait(on_progress=on_wait_progress)
                    return False
                except LeaderFailed:
                    continue  # retry: may become the new leader


class CacheEntry:
    __slots__ = ("key", "size", "files", "digests")

    def __init__(self, key: str, size: int, files: List[str],
                 digests: Optional[Dict[str, str]] = None):
        self.key = key
        self.size = size
        self.files = files  # entry-relative paths
        # per-file landing digests (rel -> md5 hex) when the fill
        # carried them: the integrity scrubber's ground truth, and the
        # shared-tier manifest's provenance for fetch-time verification
        self.digests = digests or {}


class ContentCache:
    """Disk-backed content-addressed cache of completed downloads.

    Layout::

        <root>/entries/<key>/            completed content + .meta.json
        <root>/staging/<key>.<pid>.<n>/  in-flight fill (swept if orphaned)

    All filesystem work runs under ``asyncio.to_thread``; metadata
    decisions (lookup/insert/evict bookkeeping) happen on the event loop
    guarded by one lock, so sizes and pins never race.
    """

    def __init__(self, root: str, max_bytes: int = DEFAULT_MAX_BYTES,
                 min_free_bytes: int = DEFAULT_MIN_FREE_BYTES,
                 logger=None):
        self.root = os.path.abspath(root)
        self.max_bytes = int(max_bytes)
        self.min_free_bytes = int(min_free_bytes)
        self.logger = logger
        # optional Metrics handle (attached by the orchestrator): letting
        # the cache count its own evictions covers EVERY trigger —
        # fill-time budget enforcement as well as admission reclaim
        self.metrics = None
        self.entries_dir = os.path.join(self.root, "entries")
        self.staging_dir = os.path.join(self.root, "staging")
        os.makedirs(self.entries_dir, exist_ok=True)
        os.makedirs(self.staging_dir, exist_ok=True)
        self._seq = itertools.count()
        self._lock = asyncio.Lock()
        self._pins: Dict[str, int] = {}
        self._sweep_orphans()

    # -- config ---------------------------------------------------------
    @classmethod
    def from_config(cls, config, logger=None) -> Optional["ContentCache"]:
        """Build from ``instance.cache.*`` / env; None when disabled.

        Knobs: ``CACHE_DIR``/``instance.cache.path`` (enabling the cache
        by giving it a home), ``instance.cache.enabled`` (explicit
        toggle), ``CACHE_MAX_BYTES``/``instance.cache.max_bytes`` (LRU
        disk budget), ``CACHE_MIN_FREE_BYTES``/
        ``instance.cache.min_free_bytes`` (admission headroom floor).
        """
        from ..platform.config import cfg_get

        enabled = os.environ.get("CACHE_ENABLED")
        if enabled is None:
            enabled = cfg_get(config, "instance.cache.enabled", None)
        else:
            enabled = enabled.lower() in ("1", "true", "yes")
        explicit = os.environ.get("CACHE_DIR") or cfg_get(
            config, "instance.cache.path", None
        )
        # a configured path implies enabled unless explicitly disabled
        if enabled is False or (enabled is None and not explicit):
            return None
        path = resolve_cache_path(config)
        max_bytes = int(
            os.environ.get("CACHE_MAX_BYTES")
            or cfg_get(config, "instance.cache.max_bytes", DEFAULT_MAX_BYTES)
        )
        min_free = int(
            os.environ.get("CACHE_MIN_FREE_BYTES")
            or cfg_get(config, "instance.cache.min_free_bytes",
                       DEFAULT_MIN_FREE_BYTES)
        )
        return cls(path, max_bytes=max_bytes, min_free_bytes=min_free,
                   logger=logger)

    # -- internals ------------------------------------------------------
    def _entry_dir(self, key: str) -> str:
        if not key or any(c not in "0123456789abcdef" for c in key):
            raise ValueError(f"cache key must be lowercase hex, got {key!r}")
        return os.path.join(self.entries_dir, key)

    def _read_meta(self, key: str) -> Optional[dict]:
        try:
            with open(os.path.join(self._entry_dir(key), META_NAME)) as fh:
                meta = json.load(fh)
        except (OSError, ValueError):
            return None
        if not isinstance(meta, dict) or meta.get("state") != "complete":
            return None
        return meta

    def _sweep_orphans(self) -> None:
        """Reclaim crashed fills and half-evicted entries (startup only).

        A staging dir's name carries the pid that owned the fill; the
        shared stale policy (live-pid immunity, NFS grace) judges it.  An
        entries/<key> dir without a valid manifest is a crashed evict or
        a torn rename — never servable, always reclaimable.
        """
        for name in _listdir(self.staging_dir):
            full = os.path.join(self.staging_dir, name)
            parts = name.rsplit(".", 2)
            pid = int(parts[1]) if len(parts) == 3 and parts[1].isdigit() else 0
            stale, _age = probe_stale(full, pid, grace=0.0) if pid else (True, None)
            if stale or not pid:
                shutil.rmtree(full, ignore_errors=True)
        for name in _listdir(self.entries_dir):
            if self._read_meta(name) is None:
                shutil.rmtree(os.path.join(self.entries_dir, name),
                              ignore_errors=True)

    def _entry_from_meta(self, key: str, meta: dict) -> CacheEntry:
        digests = meta.get("digests")
        return CacheEntry(key=key, size=int(meta.get("size", 0)),
                          files=list(meta.get("files", [])),
                          digests=dict(digests)
                          if isinstance(digests, dict) else None)

    # -- introspection --------------------------------------------------
    def total_bytes(self) -> int:
        """Sum of completed entry sizes (manifest figures)."""
        total = 0
        for name in _listdir(self.entries_dir):
            meta = self._read_meta(name)
            if meta:
                total += int(meta.get("size", 0))
        return total

    def free_disk_bytes(self) -> int:
        return free_bytes(self.root)

    def has_headroom(self) -> bool:
        """True when the cache volume holds the admission floor."""
        return self.free_disk_bytes() >= self.min_free_bytes

    def keys(self) -> List[str]:
        """Completed entry keys on disk — the scrubber's walk
        inventory (thread-side; call via ``asyncio.to_thread``)."""
        return [name for name in _listdir(self.entries_dir)
                if self._read_meta(name) is not None]

    async def peek(self, key: str) -> Optional[CacheEntry]:
        """Like :meth:`lookup` but WITHOUT the LRU touch: a scrubber
        walk must not promote every entry it verifies to
        most-recently-used (that would turn eviction order into scan
        order)."""
        meta = await asyncio.to_thread(self._read_meta, key)
        if meta is None:
            return None
        return self._entry_from_meta(key, meta)

    def entry_path(self, key: str) -> str:
        """Absolute directory of entry ``key`` (the fleet shared tier
        reads entry files from here when spilling; existence is the
        caller's problem — pair with :meth:`lookup`/:meth:`pinned`)."""
        return self._entry_dir(key)

    @contextlib.asynccontextmanager
    async def pinned(self, key: str):
        """Hold an eviction pin on ``key`` for the duration of the
        block — the same protection :meth:`materialize` takes while
        hardlinking, exposed for external readers (the fleet tier's
        spill streams entry files to the staging bucket)."""
        async with self._lock:
            self._pins[key] = self._pins.get(key, 0) + 1
        try:
            yield
        finally:
            async with self._lock:
                count = self._pins.get(key, 1) - 1
                if count <= 0:
                    self._pins.pop(key, None)
                else:
                    self._pins[key] = count

    # -- operations -----------------------------------------------------
    async def lookup(self, key: str) -> Optional[CacheEntry]:
        """Completed entry for ``key``, LRU-touched; None on miss."""
        async with self._lock:
            meta = await asyncio.to_thread(self._read_meta, key)
            if meta is None:
                return None
            # LRU clock = manifest mtime; touching it is one utime
            try:
                os.utime(os.path.join(self._entry_dir(key), META_NAME))
            except OSError:
                pass
            return self._entry_from_meta(key, meta)

    async def materialize(self, key: str, dest_dir: str) -> Optional[int]:
        """Hardlink-or-copy entry ``key``'s files into ``dest_dir``;
        returns bytes materialized, None when the entry vanished
        (see :meth:`materialize_entry`)."""
        got = await self.materialize_entry(key, dest_dir)
        return got[0] if got is not None else None

    async def materialize_entry(
        self, key: str, dest_dir: str
    ) -> "Optional[tuple[int, list]]":
        """Hardlink-or-copy entry ``key``'s files into ``dest_dir``.

        Returns ``(bytes, dest_paths)`` — the absolute paths just
        materialized, so a cache-hit job can be served from the known
        list without re-walking the workdir — or None when the entry
        vanished (evicted between lookup and use); the caller treats
        that as a miss.  Never exposes a partial workdir: files land
        under a temp name in ``dest_dir`` and rename into place only
        after every file linked; a lost race leaves only temp droppings
        in the job's own workdir, which the job overwrites or the
        upload-stage cleanup removes with the directory.
        """
        async with self.pinned(key):
            # pin BEFORE the manifest read: once pinned the entry
            # cannot be evicted between the read and the links
            async with self._lock:
                meta = await asyncio.to_thread(self._read_meta, key)
                if meta is None:
                    return None
                entry = self._entry_from_meta(key, meta)
            src_dir = self._entry_dir(key)

            def _link_all() -> bool:
                staged = []
                for rel in entry.files:
                    src = os.path.join(src_dir, *rel.split("/"))
                    dst = os.path.join(dest_dir, *rel.split("/"))
                    os.makedirs(os.path.dirname(dst), exist_ok=True)
                    tmp = f"{dst}.cachetmp.{os.getpid()}.{next(self._seq)}"
                    try:
                        try:
                            os.link(src, tmp)
                        except OSError as err:
                            import errno
                            if err.errno in (errno.EXDEV, errno.EPERM,
                                             errno.EMLINK):
                                shutil.copyfile(src, tmp)
                            else:
                                raise
                    except FileNotFoundError:
                        for t in staged:
                            _unlink_quiet(t[0])
                        return False  # entry evicted under us: miss
                    staged.append((tmp, dst))
                for tmp, dst in staged:
                    os.replace(tmp, dst)
                return True

            ok = await asyncio.to_thread(_link_all)
            if not ok:
                return None
            dests = [os.path.join(dest_dir, *rel.split("/"))
                     for rel in entry.files]
            return entry.size, dests

    async def insert(self, key: str, src_dir: str,
                     digests: Optional[Dict[str, str]] = None
                     ) -> Optional[CacheEntry]:
        """Fill ``key`` from a completed job workdir.

        Hardlinks (or copies) every regular file under ``src_dir`` into a
        staging dir, writes the manifest inside it, then atomically
        renames the whole dir into ``entries/``.  Dotfiles and in-flight
        temp suffixes (``.partial``/``.partial.meta``/segment state) are
        skipped — only verified payload is cacheable.  ``digests``
        (entry-relative path -> md5 hex, from the landing-site hash)
        rides the manifest so the integrity scrubber — and shared-tier
        fetchers — can re-verify these bytes forever without a trusted
        re-read.  Returns the new entry, or None when there was nothing
        to cache or the key lost an insert race (another leader's fill
        is equally valid).
        """
        async with self._lock:
            if await asyncio.to_thread(self._read_meta, key) is not None:
                return None  # already filled
        staging = os.path.join(
            self.staging_dir, f"{key}.{os.getpid()}.{next(self._seq)}"
        )

        def _stage() -> Optional[dict]:
            files: List[str] = []
            size = 0
            for dirpath, _dirnames, filenames in os.walk(src_dir):
                for name in sorted(filenames):
                    if name.startswith(".") or _is_transient(name):
                        continue
                    full = os.path.join(dirpath, name)
                    rel = os.path.relpath(full, src_dir).replace(os.sep, "/")
                    dst = os.path.join(staging, *rel.split("/"))
                    os.makedirs(os.path.dirname(dst), exist_ok=True)
                    try:
                        os.link(full, dst)
                    except OSError:
                        shutil.copyfile(full, dst)
                    files.append(rel)
                    size += os.path.getsize(dst)
            if not files:
                shutil.rmtree(staging, ignore_errors=True)
                return None
            meta = {
                "state": "complete",
                "key": key,
                "size": size,
                "files": files,
                "created": time.time(),
            }
            if digests:
                meta["digests"] = {rel: digests[rel] for rel in files
                                   if rel in digests}
            # manifest rides INSIDE the dir: one rename publishes entry
            # and manifest together, so a torn publish is impossible
            tmp = os.path.join(staging, META_NAME + ".tmp")
            with open(tmp, "w") as fh:
                json.dump(meta, fh)
            os.replace(tmp, os.path.join(staging, META_NAME))
            return meta

        try:
            meta = await asyncio.to_thread(_stage)
        except OSError:
            await asyncio.to_thread(shutil.rmtree, staging, True)
            raise
        if meta is None:
            return None
        async with self._lock:
            entry_dir = self._entry_dir(key)

            def _publish() -> bool:
                try:
                    os.rename(staging, entry_dir)
                    return True
                except OSError:
                    # lost the insert race (or dir exists from a crashed
                    # evict): keep the existing entry, drop ours
                    shutil.rmtree(staging, ignore_errors=True)
                    return False

            if not await asyncio.to_thread(_publish):
                return None
        # budget enforcement AFTER publish: the new entry participates in
        # LRU like any other (and is the most recently used)
        await self.evict_to_budget()
        return self._entry_from_meta(key, meta)

    async def quarantine(self, key: str, dest_dir: Optional[str]) -> bool:
        """Move entry ``key`` out of the cache for triage (integrity
        scrub verdict: corrupt with no healthy replica).  One rename
        retires the whole directory — manifest included, so the
        quarantined copy stays inspectable — and the entry is
        invisible the instant the rename lands (the same one-rename
        discipline as publish/evict).  ``dest_dir`` None just evicts.
        Pinned (mid-materialize) entries are left alone: False."""
        async with self._lock:
            if self._pins.get(key):
                return False
            entry_dir = self._entry_dir(key)

            def _move() -> bool:
                if not os.path.isdir(entry_dir):
                    return False
                if not dest_dir:
                    _unlink_quiet(os.path.join(entry_dir, META_NAME))
                    shutil.rmtree(entry_dir, ignore_errors=True)
                    return True
                dest = os.path.join(dest_dir,
                                    f"{key}.{int(time.time())}")
                try:
                    os.makedirs(dest_dir, exist_ok=True)
                    os.rename(entry_dir, dest)
                    return True
                except OSError:
                    # cross-device quarantine volume: fall back to the
                    # evict discipline (manifest first) rather than
                    # leave corrupt bytes servable
                    _unlink_quiet(os.path.join(entry_dir, META_NAME))
                    shutil.move(entry_dir, dest)
                    return True

            try:
                return await asyncio.to_thread(_move)
            except OSError:
                return False

    async def evict_to_budget(self, extra_needed: int = 0) -> int:
        """LRU-evict until total size fits ``max_bytes - extra_needed``
        AND the volume's free space covers ``min_free_bytes``.  Returns
        bytes evicted.  Pinned (mid-materialize) entries are skipped."""
        async with self._lock:
            def _scan() -> List[tuple]:
                found = []
                for name in _listdir(self.entries_dir):
                    meta = self._read_meta(name)
                    if meta is None:
                        continue
                    try:
                        mtime = os.path.getmtime(
                            os.path.join(self._entry_dir(name), META_NAME))
                    except OSError:
                        mtime = 0.0
                    found.append((mtime, name, int(meta.get("size", 0))))
                found.sort()
                return found

            entries = await asyncio.to_thread(_scan)
            total = sum(size for _m, _n, size in entries)
            budget = max(self.max_bytes - extra_needed, 0)
            evicted = 0
            for _mtime, name, size in entries:
                over_budget = total > budget
                no_headroom = self.free_disk_bytes() < self.min_free_bytes
                if not over_budget and not no_headroom:
                    break
                if self._pins.get(name):
                    continue

                def _remove(name=name) -> None:
                    entry_dir = self._entry_dir(name)
                    # manifest FIRST: the entry turns invisible before
                    # any content byte disappears, so a crash mid-rmtree
                    # can never leave a servable half-entry
                    _unlink_quiet(os.path.join(entry_dir, META_NAME))
                    shutil.rmtree(entry_dir, ignore_errors=True)

                await asyncio.to_thread(_remove)
                total -= size
                evicted += size
                if self.logger is not None:
                    self.logger.info("cache: evicted entry", key=name,
                                     bytes=size)
            if evicted and self.metrics is not None:
                self.metrics.cache_evicted_bytes.inc(evicted)
            return evicted


def _is_transient(name: str) -> bool:
    """In-flight download artifacts that must never be cached."""
    return name.endswith((
        ".partial", ".partial.meta", ".partial-seg", ".partial-seg.state",
        ".resume", ".tmp",
    )) or ".cachetmp." in name or ".scrubtmp." in name


def _listdir(path: str) -> List[str]:
    try:
        return os.listdir(path)
    except OSError:
        return []


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass
