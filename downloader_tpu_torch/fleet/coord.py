"""Coordination store: the fleet's tiny shared key/value substrate.

Every fleet feature — worker liveness, cross-worker leases, shared-tier
manifests — reduces to one primitive: a small JSON document at a key,
written with *conditional-put* semantics (create-if-absent or
compare-and-swap on a write token).  This module provides that primitive
behind :class:`CoordStore` with two backends:

- :class:`MemoryCoordStore` — an in-process dict with truly atomic
  conditional puts.  Tests and single-host multi-orchestrator benches
  share one instance between workers; it is also the hermetic default
  for ``fleet.backend: memory``.
- :class:`BucketCoordStore` — documents stored as objects in the staging
  bucket (default prefix ``.fleet/``), so a fleet needs no coordination
  service beyond the object store it already depends on (the same
  posture as the idempotency marker).  Object stores are last-write-wins,
  so the conditional put is *best-effort*: each write embeds a fresh
  nonce and is verified by reading the key back — the standard
  S3-lock discipline.  A lost race is detected (the read-back shows a
  foreign nonce) in all but a sub-RTT window; the lease layer bounds the
  damage of that window to one duplicate download, and the shared tier's
  manifest-last publish keeps correctness unconditional.

Deletes are tombstones on the bucket backend (the :class:`~..store.base.
ObjectStore` interface has no remove): a deleted key reads as absent and
may be recreated with ``expect=ABSENT``.

Failure posture: every backend error surfaces as :class:`CoordError`
(TRANSIENT under the platform taxonomy).  Callers — the fleet plane —
must treat coordination trouble as *degradation to uncoordinated
operation*, never as job failure: a worker that cannot reach the
coordination store downloads like a pre-fleet worker.  All operations
carry ``coord.*`` fault-injection seams (platform/faults.py) so chaos
plans can blip exactly this dependency.
"""

from __future__ import annotations

import abc
import asyncio
import dataclasses
import itertools
import json
import os
import time
from typing import Dict, List, Optional, Tuple

from ..platform import faults
from ..platform.errors import TRANSIENT
from ..stages.upload import STAGING_BUCKET
from ..store.base import ObjectNotFound

# sentinel for "the key must not exist" conditional puts
ABSENT = "__absent__"
# sentinel for unconditional writes
ANY = "__any__"


class CoordError(RuntimeError):
    """The coordination store could not answer (TRANSIENT: the fleet
    degrades to uncoordinated operation, jobs never fail on this)."""

    fault_class = TRANSIENT


@dataclasses.dataclass(frozen=True)
class WatchEvent:
    """One observed change under a watched prefix.

    ``data is None`` means the key went away (deleted / tombstoned);
    otherwise ``data``/``token`` are the entry's new value and write
    token, exactly what a ``get`` at that instant would have returned.
    """

    key: str
    data: Optional[dict]
    token: Optional[str]


class CoordWatch:
    """Subscription handle returned by :meth:`CoordStore.watch`.

    Etcd-shaped semantics scaled down to this substrate: ``next(
    timeout)`` blocks until something under the prefix changes and
    returns the batched events, or ``[]`` when the timeout lapses with
    nothing new — a *bounded* long-poll, never an unbounded hang, so
    callers' wait budgets stay enforceable.  ``next(0)`` is a
    non-blocking drain.  Store trouble surfaces as :class:`CoordError`
    exactly like the reads a watch replaces; per the degradation
    contract callers fall back to their sleep-poll loop and keep
    working.  ``close()`` detaches the watch; a closed watch returns
    ``[]`` forever.
    """

    prefix: str = ""

    async def next(self, timeout: float) -> List[WatchEvent]:
        raise NotImplementedError

    def close(self) -> None:  # pragma: no cover - trivial default
        pass


class _PollWatch(CoordWatch):
    """Snapshot-diff bounded long-poll: the universal fallback watch.

    Works against any :class:`CoordStore` (one ``list_keys`` + one
    ``get`` per live key per lap), which makes it the degraded path the
    event-driven backends fall back to — and the only path on backends
    with no native change feed (the bucket stores).  The first ``next``
    seeds the snapshot silently: a watch reports *changes after it was
    opened*, not pre-existing state (callers read current state with
    ``get`` before watching, the standard read-then-watch pattern).
    """

    def __init__(self, store: "CoordStore", prefix: str,
                 interval: float = 0.25):
        self.store = store
        self.prefix = prefix
        self.interval = float(interval)
        self._snapshot: Optional[Dict[str, str]] = None
        self._closed = False

    async def _scan(self) -> Dict[str, Tuple[dict, str]]:
        live: Dict[str, Tuple[dict, str]] = {}
        for key in await self.store.list_keys(self.prefix):
            entry = await self.store.get(key)
            if entry is not None:
                live[key] = entry
        return live

    async def next(self, timeout: float) -> List[WatchEvent]:
        if self._closed:
            return []
        deadline = time.monotonic() + max(float(timeout), 0.0)
        if self._snapshot is None:
            self._snapshot = {
                key: entry[1]
                for key, entry in (await self._scan()).items()
            }
        while not self._closed:
            live = await self._scan()
            events: List[WatchEvent] = []
            for key, (data, token) in live.items():
                if self._snapshot.get(key) != token:
                    events.append(WatchEvent(key, data, token))
            for key in self._snapshot:
                if key not in live:
                    events.append(WatchEvent(key, None, None))
            if events:
                self._snapshot = {k: e[1] for k, e in live.items()}
                return events
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return []
            await asyncio.sleep(min(self.interval, remaining))
        return []

    def close(self) -> None:
        self._closed = True


class CoordStore(abc.ABC):
    """Async conditional-put key/value store of small JSON documents.

    Keys are ``/``-separated paths (``workers/<id>``, ``leases/<key>``).
    Every live entry carries an opaque write *token*; ``put`` with
    ``expect=<token>`` succeeds only against that exact version
    (compare-and-swap), ``expect=ABSENT`` only when the key has no live
    entry, ``expect=ANY`` unconditionally.  ``put``/``delete`` return
    falsy on a lost race — losing a conditional write is a normal
    outcome, not an error; :class:`CoordError` is reserved for the
    store itself misbehaving.
    """

    @abc.abstractmethod
    async def get(self, key: str) -> Optional[Tuple[dict, str]]:
        """``(data, token)`` for a live entry, else None."""

    @abc.abstractmethod
    async def put(self, key: str, data: dict,
                  expect: str = ANY) -> Optional[str]:
        """Conditionally write ``data``; new token, or None on conflict."""

    @abc.abstractmethod
    async def delete(self, key: str, expect: str = ANY) -> bool:
        """Conditionally remove; True when the entry is gone."""

    @abc.abstractmethod
    async def list_keys(self, prefix: str) -> List[str]:
        """Keys with a live entry under ``prefix``."""

    def watch(self, prefix: str, *,
              poll_interval: float = 0.25) -> CoordWatch:
        """Subscribe to changes under ``prefix`` (see :class:`CoordWatch`).

        The default is the snapshot-diff bounded long-poll — correct on
        every backend, paying one scan per ``poll_interval``.  Backends
        with a cheaper change feed (the in-memory store's version bump)
        override this with a true event-driven watch; callers cannot
        tell the difference except in wake-up latency.
        """
        return _PollWatch(self, prefix, poll_interval)


class _MemoryWatch(CoordWatch):
    """Event-driven watch: pushed by the store's mutations, no polling."""

    #: buffered-event cap — a watcher that stops draining must not
    #: grow without bound; overflow drops the OLDEST events, which is
    #: safe because every consumer re-reads current state on wake
    MAX_BUFFER = 256

    def __init__(self, store: "MemoryCoordStore", prefix: str):
        self.store = store
        self.prefix = prefix
        self._buffer: List[WatchEvent] = []
        self._wake = asyncio.Event()
        self._closed = False

    def _push(self, event: WatchEvent) -> None:
        self._buffer.append(event)
        if len(self._buffer) > self.MAX_BUFFER:
            del self._buffer[: len(self._buffer) - self.MAX_BUFFER]
        self._wake.set()

    async def next(self, timeout: float) -> List[WatchEvent]:
        if self._closed:
            return []
        if faults.enabled():
            # same seam a poll lap would hit: a coord brownout slows /
            # breaks watch wake-ups too, so chaos plans can rehearse
            # the watch-to-poll fallback
            await faults.fire("coord.get", key=self.prefix)
        if not self._buffer and timeout > 0:
            try:
                await asyncio.wait_for(self._wake.wait(),
                                       max(float(timeout), 0.0))
            except asyncio.TimeoutError:
                pass
        events, self._buffer = self._buffer, []
        self._wake.clear()
        return events

    def close(self) -> None:
        self._closed = True
        self.store._watchers.discard(self)
        self._wake.set()


class MemoryCoordStore(CoordStore):
    """Atomic in-process backend; share ONE instance across workers."""

    def __init__(self):
        self._entries: Dict[str, Tuple[dict, str]] = {}
        self._lock = asyncio.Lock()
        self._seq = itertools.count(1)
        self._watchers: set = set()

    def watch(self, prefix: str, *,
              poll_interval: float = 0.25) -> CoordWatch:
        handle = _MemoryWatch(self, prefix)
        self._watchers.add(handle)
        return handle

    def _notify(self, key: str, data: Optional[dict],
                token: Optional[str]) -> None:
        for handle in list(self._watchers):
            if key.startswith(handle.prefix):
                handle._push(WatchEvent(key, data, token))

    async def get(self, key: str) -> Optional[Tuple[dict, str]]:
        if faults.enabled():
            await faults.fire("coord.get", key=key)
        async with self._lock:
            entry = self._entries.get(key)
            return (dict(entry[0]), entry[1]) if entry else None

    async def put(self, key: str, data: dict,
                  expect: str = ANY) -> Optional[str]:
        if faults.enabled():
            await faults.fire("coord.put", key=key)
        async with self._lock:
            current = self._entries.get(key)
            if expect == ABSENT and current is not None:
                return None
            if expect not in (ABSENT, ANY) and (
                    current is None or current[1] != expect):
                return None
            token = f"m{next(self._seq)}"
            self._entries[key] = (dict(data), token)
            self._notify(key, dict(data), token)
            return token

    async def delete(self, key: str, expect: str = ANY) -> bool:
        if faults.enabled():
            await faults.fire("coord.delete", key=key)
        async with self._lock:
            current = self._entries.get(key)
            if current is None:
                return True
            if expect != ANY and current[1] != expect:
                return False
            del self._entries[key]
            self._notify(key, None, None)
            return True

    async def list_keys(self, prefix: str) -> List[str]:
        if faults.enabled():
            await faults.fire("coord.list", key=prefix)
        async with self._lock:
            return sorted(k for k in self._entries if k.startswith(prefix))


class BucketCoordStore(CoordStore):
    """Staging-bucket-backed coordination (best-effort conditional put).

    One JSON object per key at ``<prefix><key>``: ``{"data": {...},
    "token": <nonce>}``; a tombstone is the same shape with ``data``
    null.  Writes are verified by read-back (see the module docstring
    for the atomicity contract).
    """

    def __init__(self, store, bucket: str = STAGING_BUCKET,
                 prefix: str = ".fleet/", settle_delay: float = 0.05):
        self.store = store
        self.bucket = bucket
        self.prefix = prefix
        # pause between write and verification read: two writers whose
        # pre-write reads both saw the key free race last-write-wins,
        # and without a settle the EARLIER writer can read back its own
        # value before the later write lands — both would think they
        # won.  Settling longer than the (pre-read -> write) gap of any
        # concurrent writer collapses the double-win window to writers
        # more than ``settle_delay`` apart, which the pre-write read
        # already excludes.  Conditional writes are rare (lease ops,
        # heartbeats), so the latency is noise.
        self.settle_delay = float(settle_delay)
        self._seq = itertools.count()
        self._bucket_ready = False

    def _object(self, key: str) -> str:
        return self.prefix + key

    def _nonce(self) -> str:
        return f"{os.getpid():x}.{next(self._seq)}.{os.urandom(6).hex()}"

    async def _ensure_bucket(self) -> None:
        if self._bucket_ready:
            return
        if not await self.store.bucket_exists(self.bucket):
            await self.store.make_bucket(self.bucket)
        self._bucket_ready = True

    async def _read(self, key: str) -> Optional[Tuple[Optional[dict], str]]:
        """Raw entry including tombstones (data None); None = no object."""
        try:
            raw = await self.store.get_object(self.bucket, self._object(key))
        except ObjectNotFound:
            return None
        try:
            doc = json.loads(raw.decode("utf-8"))
            return doc["data"], str(doc["token"])
        except (ValueError, KeyError, UnicodeDecodeError) as err:
            raise CoordError(f"corrupt coordination entry {key}: {err}")

    async def get(self, key: str) -> Optional[Tuple[dict, str]]:
        if faults.enabled():
            await faults.fire("coord.get", key=key)
        try:
            entry = await self._read(key)
        except CoordError:
            raise
        except Exception as err:
            raise CoordError(f"coord get {key}: {err}") from err
        if entry is None or entry[0] is None:
            return None
        return entry[0], entry[1]

    async def _write_verified(self, key: str,
                              data: Optional[dict]) -> Optional[str]:
        """Write with a fresh nonce; token only when the read-back shows
        OUR write survived (last-write-wins race detection).

        ``at`` stamps the write time so the GC sweep (fleet/plane.py)
        can age tombstones; readers ignore it (only data/token matter).
        """
        token = self._nonce()
        body = json.dumps({
            "data": data, "token": token, "at": round(time.time(), 3),
        }).encode("utf-8")
        try:
            await self._ensure_bucket()
            await self.store.put_object(self.bucket, self._object(key), body)
            if self.settle_delay > 0:
                await asyncio.sleep(self.settle_delay)
            raw = await self.store.get_object(self.bucket, self._object(key))
        except Exception as err:
            raise CoordError(f"coord put {key}: {err}") from err
        try:
            survived = json.loads(raw.decode("utf-8")).get("token") == token
        except (ValueError, UnicodeDecodeError):
            survived = False
        return token if survived else None

    async def put(self, key: str, data: dict,
                  expect: str = ANY) -> Optional[str]:
        if faults.enabled():
            await faults.fire("coord.put", key=key)
        try:
            current = await self._read(key)
        except CoordError:
            # corrupt entry: only an unconditional write may repair it
            if expect != ANY:
                raise
            current = None
        except Exception as err:
            raise CoordError(f"coord put {key}: {err}") from err
        live = current is not None and current[0] is not None
        if expect == ABSENT and live:
            return None
        if expect not in (ABSENT, ANY) and (
                not live or current[1] != expect):
            return None
        return await self._write_verified(key, data)

    async def delete(self, key: str, expect: str = ANY) -> bool:
        if faults.enabled():
            await faults.fire("coord.delete", key=key)
        try:
            current = await self._read(key)
        except CoordError:
            raise
        except Exception as err:
            raise CoordError(f"coord delete {key}: {err}") from err
        if current is None or current[0] is None:
            return True
        if expect != ANY and current[1] != expect:
            return False
        # tombstone, not removal: the ObjectStore interface has no delete
        return await self._write_verified(key, None) is not None

    async def list_keys(self, prefix: str) -> List[str]:
        if faults.enabled():
            await faults.fire("coord.list", key=prefix)
        out = []
        try:
            async for info in self.store.list_objects(
                    self.bucket, self.prefix + prefix):
                if info.name.startswith(self.prefix):
                    out.append(info.name[len(self.prefix):])
        except Exception as err:
            raise CoordError(f"coord list {prefix}: {err}") from err
        # tombstones still list here; callers resolve liveness via get()
        return sorted(out)

    async def sweep_tombstones(self, max_age: float) -> int:
        """Physically remove tombstones older than ``max_age`` seconds.

        Deletes on this backend only tombstone (the ObjectStore interface
        historically had no remove), so churning keys — every released
        lease, every deregistered worker — accrete one object each under
        the prefix forever.  Removing an aged tombstone is semantically
        invisible: a tombstoned key already reads as absent, conditional
        puts against its token already fail, and any CAS that could race
        the removal expired with the lease/liveness TTLs long before
        ``max_age``.  Tombstones written before age-stamping (no ``at``)
        are treated as infinitely old.  Returns the number removed.
        """
        removed = 0
        now = time.time()
        for key in await self.list_keys(""):
            obj = self._object(key)
            try:
                raw = await self.store.get_object(self.bucket, obj)
            except ObjectNotFound:
                continue  # already gone
            except Exception as err:
                raise CoordError(f"coord sweep {key}: {err}") from err
            try:
                doc = json.loads(raw.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                continue  # corrupt: repairable only by an operator put
            if doc.get("data") is not None:
                continue  # live document — never touch
            try:
                written_at = float(doc.get("at") or 0.0)
            except (TypeError, ValueError):
                written_at = 0.0
            if now - written_at < max_age:
                continue
            try:
                # re-read immediately before the delete: a fresh LIVE
                # write can land at a churned key between the first read
                # and here, and an unconditional remove would destroy
                # it.  The re-read shrinks the window to sub-RTT — the
                # same best-effort bound as this backend's conditional
                # put, with damage bounded by the lease/liveness TTLs.
                raw2 = await self.store.get_object(self.bucket, obj)
                doc2 = json.loads(raw2.decode("utf-8"))
                if (doc2.get("data") is not None
                        or doc2.get("token") != doc.get("token")):
                    continue  # revived or rewritten: leave it alone
                await self.store.remove_object(self.bucket, obj)
                removed += 1
            except NotImplementedError:
                return removed  # backend cannot delete: nothing to sweep
            except (ValueError, UnicodeDecodeError):
                continue  # rewritten to something unreadable: skip
            except ObjectNotFound:
                continue  # already gone
            except Exception as err:
                raise CoordError(f"coord sweep {key}: {err}") from err
        return removed


class CasBucketCoordStore(BucketCoordStore):
    """Truly-conditional bucket coordination via S3 conditional writes.

    Same document shape, prefix, and tombstone discipline as
    :class:`BucketCoordStore`, but the write token is the object's
    **ETag** and every put is an ``If-Match`` / ``If-None-Match``
    conditional PUT that the *server* arbitrates — no nonce race, no
    settle delay, no read-back window: a lost race is a 412, atomically
    (AWS S3 since 2024-08, MinIO, R2 all implement it; the in-memory
    fake and MiniS3 mirror the semantics).  Select with
    ``fleet.backend: cas``; a store without ``put_object_cas`` raises
    NotImplementedError on first write, surfaced as CoordError, and the
    operator falls back to ``bucket``.
    """

    def __init__(self, store, bucket: str = STAGING_BUCKET,
                 prefix: str = ".fleet/"):
        super().__init__(store, bucket, prefix, settle_delay=0.0)

    #: read-CAS laps for ``expect=ANY`` writes before conceding — ANY
    #: writers are per-key owners (heartbeats, telemetry) in practice,
    #: so one lap is the overwhelmingly common case
    ANY_RETRIES = 8

    def _body(self, data: Optional[dict]) -> bytes:
        # keep the embedded nonce "token" field so documents stay
        # readable by BucketCoordStore peers (mixed fleets) and
        # sweep_tombstones' revival check stays meaningful; the
        # authoritative write token is the etag, not this nonce
        return json.dumps({
            "data": data, "token": self._nonce(),
            "at": round(time.time(), 3),
        }).encode("utf-8")

    async def _read_versioned(
            self, key: str) -> Optional[Tuple[Optional[dict], str]]:
        """``(data|None, etag)`` including tombstones; None = no object."""
        try:
            raw, etag = await self.store.get_object_versioned(
                self.bucket, self._object(key))
        except ObjectNotFound:
            return None
        except Exception as err:
            raise CoordError(f"coord get {key}: {err}") from err
        try:
            doc = json.loads(raw.decode("utf-8"))
            return doc["data"], str(etag)
        except (ValueError, KeyError, UnicodeDecodeError) as err:
            raise CoordError(f"corrupt coordination entry {key}: {err}")

    async def get(self, key: str) -> Optional[Tuple[dict, str]]:
        if faults.enabled():
            await faults.fire("coord.get", key=key)
        entry = await self._read_versioned(key)
        if entry is None or entry[0] is None:
            return None
        return entry[0], entry[1]

    async def _cas_put(self, key: str, body: bytes, *,
                       if_match: Optional[str] = None,
                       if_none_match: bool = False) -> Optional[str]:
        try:
            await self._ensure_bucket()
            return await self.store.put_object_cas(
                self.bucket, self._object(key), body,
                if_match=if_match, if_none_match=if_none_match)
        except Exception as err:
            raise CoordError(f"coord put {key}: {err}") from err

    async def put(self, key: str, data: dict,
                  expect: str = ANY) -> Optional[str]:
        if faults.enabled():
            await faults.fire("coord.put", key=key)
        body = self._body(data)
        if expect == ABSENT:
            token = await self._cas_put(key, body, if_none_match=True)
            if token is not None:
                return token
            # an object exists — but a *tombstone* still counts as
            # absent: retake it by CAS-replacing that exact version
            entry = await self._read_versioned(key)
            if entry is None:
                # removed between attempts (GC sweep): one more create
                return await self._cas_put(key, body, if_none_match=True)
            if entry[0] is not None:
                return None  # genuinely live: lost the race
            return await self._cas_put(key, body, if_match=entry[1])
        if expect != ANY:
            return await self._cas_put(key, body, if_match=expect)
        for _ in range(self.ANY_RETRIES):
            entry = await self._read_versioned(key)
            if entry is None:
                token = await self._cas_put(key, body, if_none_match=True)
            else:
                token = await self._cas_put(key, body, if_match=entry[1])
            if token is not None:
                return token
        return None

    async def delete(self, key: str, expect: str = ANY) -> bool:
        if faults.enabled():
            await faults.fire("coord.delete", key=key)
        body = self._body(None)
        for _ in range(self.ANY_RETRIES):
            entry = await self._read_versioned(key)
            if entry is None or entry[0] is None:
                return True
            if expect != ANY and entry[1] != expect:
                return False
            if await self._cas_put(key, body, if_match=entry[1]) is not None:
                return True
            if expect != ANY:
                return False  # our exact version was replaced: lost
        return False
