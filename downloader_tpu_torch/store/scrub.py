"""Integrity scrubber: re-verify landed bytes forever, self-heal rot.

Hash-on-land proves bytes were the origin's bytes at the
landing moment; nothing re-proves it afterwards — and the zero-copy
staging path now shares inodes aggressively (cache hardlinks into
workdirs, ``consume=True`` spills hardlink into the fs store, the
peer tier hardlinks store objects into peer caches), so one flipped
bit propagates *by inode* to every view of the content.  This module
closes the loop, in two halves:

- **The landing recovery sidecar** (``.landed.json`` in each job
  workdir): basename -> md5 of every promoted output, persisted
  *durably before* the data rename (stages/download.py ``_promote``).
  Boot recovery (:func:`verify_landed`) re-hashes the sidecar-named
  outputs of every resumable workdir and demotes any mismatch — the
  torn-tail crash case, where the file's SIZE still checks out but
  the tail pages never reached the disk — back to re-fetch instead
  of serving the hole.  Only sidecar-named files are judged: a
  workdir's resumable ``.partial``/piece state is verified by its own
  machinery (validators, SHA-1 piece hashes) on resume.

- :class:`Scrubber` — an incremental, rate-limited background walk of
  the local content cache, the shared staging tier (when the store is
  co-located and exposes on-disk paths), and live workdir sidecars,
  re-hashing every object against its landing digest.  A mismatch is
  REPAIRED from a healthy replica when one exists — always into a
  **fresh inode** (copy-on-repair: ``os.replace`` of a verified copy,
  never a re-link), so a peer's corruption can never be "fixed" into
  shared state and every other hardlinked view of the bad inode stays
  detectable — and QUARANTINED otherwise (moved aside for triage;
  quarantined workdir outputs are re-fetched from origin by the job's
  own redelivery).  Hashing is billed to the ``scrub`` hop and paced
  against ``scrub.rate_mb_s`` so a deep cache never steals the
  landing path's disk bandwidth.  Verdicts are counted on
  ``scrub_objects_total{outcome=clean|repaired|quarantined}`` and the
  cumulative state rides the fleet heartbeat digest onto
  ``/v1/fleet/overview`` and ``cli fleet top``.

Knobs (``scrub.*``)::

    scrub:
      enabled: true        # false removes the background scrubber
      interval: 300.0      # seconds between scrub passes
      rate_mb_s: 32.0      # hashing budget; 0 = unpaced
      quarantine_dir: ""   # default <download_root>/.quarantine
"""

from __future__ import annotations

import asyncio
import json
import os
import shutil
import time
from typing import Dict, Optional

from ..platform import vfs
from ..platform.config import cfg_get
from ..utils.hashing import md5_file_hex

#: per-workdir recovery sidecar: {output basename: md5 hex}, written
#: durably BEFORE each output's promote rename
LANDED_SIDECAR = ".landed.json"

DEFAULT_INTERVAL = 300.0
DEFAULT_RATE_MB_S = 32.0


# -- the landing recovery sidecar --------------------------------------
def read_landed(dirpath: str) -> Dict[str, str]:
    """The workdir's recovery sidecar, ``{}`` when absent or torn (an
    unreadable sidecar means nothing was promised, so nothing is
    judged — the job's own resume machinery takes over)."""
    try:
        with open(os.path.join(dirpath, LANDED_SIDECAR)) as fh:
            doc = json.load(fh)
    except (OSError, ValueError):
        return {}
    if not isinstance(doc, dict):
        return {}
    return {str(k): str(v) for k, v in doc.items()
            if isinstance(k, str) and isinstance(v, str)}


def _write_sidecar(dirpath: str, landed: Dict[str, str]) -> None:
    path = os.path.join(dirpath, LANDED_SIDECAR)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(landed, fh)
    # durable BEFORE the caller's data rename — that ordering is the
    # whole recovery contract.  Its own seam so a torn-promote drill
    # aimed at ``disk.promote`` lands on the DATA rename, not here.
    vfs.promote(tmp, path, seam="disk.sidecar", key=path)


def note_landed(dirpath: str, name: str, digest: str) -> None:
    """Record ``name``'s landing digest in the workdir sidecar
    (read-modify-write, idempotent, durable)."""
    landed = read_landed(dirpath)
    if landed.get(name) == digest:
        return
    landed[name] = digest
    _write_sidecar(dirpath, landed)


def drop_landed(dirpath: str, name: str) -> None:
    """Forget ``name``'s sidecar entry (its bytes were demoted or
    quarantined; the note must not outlive them)."""
    landed = read_landed(dirpath)
    if landed.pop(name, None) is None:
        return
    if landed:
        _write_sidecar(dirpath, landed)
    else:
        try:
            os.remove(os.path.join(dirpath, LANDED_SIDECAR))
        except OSError:
            pass


def verify_landed(dirpath: str) -> "tuple[int, int]":
    """Boot-time torn-tail recovery for one resumable workdir
    (thread-side, called from the orchestrator's workdir sweep).

    Re-hashes every output the sidecar names; a mismatch is DEMOTED —
    the file is deleted and its note dropped, so the job's redelivery
    re-fetches instead of serving bytes the disk never durably held.
    A sidecar note without its file (the promote crashed between the
    sidecar write and the data rename) is pruned silently: nothing
    was ever promoted, nothing could have been served.  Returns
    ``(verified, demoted)`` counts.
    """
    landed = read_landed(dirpath)
    if not landed:
        return 0, 0
    verified = demoted = 0
    changed = False
    for name, want in sorted(landed.items()):
        path = os.path.join(dirpath, name)
        try:
            # graftlint: disable=second-pass-read -- boot recovery after a crash: no in-memory digest survived the process, one pass decides serve-vs-refetch
            got = md5_file_hex(path)
        except OSError:
            landed.pop(name)
            changed = True
            continue
        if got == want:
            verified += 1
            continue
        try:
            os.remove(path)
        except OSError:
            pass
        landed.pop(name)
        changed = True
        demoted += 1
    if changed:
        if landed:
            _write_sidecar(dirpath, landed)
        else:
            try:
                os.remove(os.path.join(dirpath, LANDED_SIDECAR))
            except OSError:
                pass
    return verified, demoted


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


# -- the background scrubber -------------------------------------------
class Scrubber:
    """Incremental background integrity walk (module docstring)."""

    def __init__(self, *, cache=None, fleet=None,
                 workdir_root: Optional[str] = None,
                 quarantine_dir: Optional[str] = None,
                 interval: float = DEFAULT_INTERVAL,
                 rate_bytes: float = DEFAULT_RATE_MB_S * 1e6,
                 metrics=None, logger=None):
        if interval <= 0:
            raise ValueError(f"scrub.interval must be > 0, got {interval}")
        self.cache = cache
        self.fleet = fleet
        self.workdir_root = workdir_root
        self.quarantine_dir = quarantine_dir or (
            os.path.join(workdir_root, ".quarantine") if workdir_root
            else None)
        self.interval = float(interval)
        self.rate_bytes = float(rate_bytes)
        self.metrics = metrics
        self.logger = logger
        # cumulative verdicts, carried on the fleet heartbeat digest
        self.state: dict = {
            "passes": 0, "clean": 0, "repaired": 0, "quarantined": 0,
            "lastPassAt": None, "lastPassSeconds": None,
        }
        self._task: Optional[asyncio.Task] = None

    # -- config ---------------------------------------------------------
    @classmethod
    def from_config(cls, config, *, cache=None, fleet=None,
                    workdir_root=None, metrics=None,
                    logger=None) -> Optional["Scrubber"]:
        """Build from ``scrub.*``; None when explicitly disabled."""
        if not bool(cfg_get(config, "scrub.enabled", True)):
            return None
        return cls(
            cache=cache, fleet=fleet, workdir_root=workdir_root,
            quarantine_dir=cfg_get(config, "scrub.quarantine_dir", None),
            interval=float(cfg_get(config, "scrub.interval",
                                   DEFAULT_INTERVAL)),
            rate_bytes=float(cfg_get(config, "scrub.rate_mb_s",
                                     DEFAULT_RATE_MB_S)) * 1e6,
            metrics=metrics, logger=logger,
        )

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._loop(), name="scrubber")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.interval)
            try:
                await self.scan()
            except asyncio.CancelledError:
                raise
            except Exception as err:  # one broken pass must not end them
                if self.logger is not None:
                    self.logger.warn("scrub pass failed",
                                     error=str(err)[:200])

    def snapshot(self) -> dict:
        """JSON state for the SLO digest / fleet overview."""
        return dict(self.state)

    # -- one pass -------------------------------------------------------
    async def scan(self) -> dict:
        """One full scrub pass; returns this pass's verdict counts."""
        counts = {"clean": 0, "repaired": 0, "quarantined": 0}
        mark = time.monotonic()
        await self._scan_cache(counts)
        await self._scan_shared(counts)
        await self._scan_workdirs(counts)
        self.state["passes"] += 1
        for outcome, n in counts.items():
            self.state[outcome] += n
        self.state["lastPassAt"] = round(time.time(), 3)
        self.state["lastPassSeconds"] = round(time.monotonic() - mark, 3)
        if self.logger is not None and (counts["repaired"]
                                        or counts["quarantined"]):
            self.logger.warn("scrub pass found corruption", **counts)
        return counts

    def _note(self, outcome: str, counts: dict) -> None:
        counts[outcome] += 1
        if self.metrics is not None:
            self.metrics.scrub_objects.labels(outcome=outcome).inc()

    async def _hash(self, path: str) -> Optional[str]:
        """md5 of ``path`` off the loop, billed to the ``scrub`` hop and
        paced against the configured bandwidth budget; None when the
        file vanished under the walk (eviction/cleanup races are
        normal, not errors)."""
        try:
            size = os.path.getsize(path)
        except OSError:
            return None
        mark = time.monotonic()
        try:
            # graftlint: disable=second-pass-read -- the scrubber IS the justified second pass: re-verifying cold bytes against their landing digest is this subsystem's entire purpose
            digest = await asyncio.to_thread(md5_file_hex, path)
        except OSError:
            return None
        elapsed = time.monotonic() - mark
        if self.metrics is not None:
            self.metrics.hop_bytes.labels(hop="scrub").inc(size)
            self.metrics.hop_seconds.labels(hop="scrub").inc(elapsed)
        if self.rate_bytes > 0:
            budget = size / self.rate_bytes
            if budget > elapsed:
                await asyncio.sleep(min(budget - elapsed, 5.0))
        return digest

    def _quarantine_file(self, path: str, tag: str) -> bool:
        """Move one corrupt file aside for triage (fresh name per
        incident; cross-device safe)."""
        if not self.quarantine_dir:
            return False
        try:
            os.makedirs(self.quarantine_dir, exist_ok=True)
            dest = os.path.join(
                self.quarantine_dir,
                f"{tag}-{int(time.time())}-{os.path.basename(path)}")
            shutil.move(path, dest)
            return True
        except OSError as err:
            if self.logger is not None:
                self.logger.warn("scrub quarantine failed", path=path,
                                 error=str(err))
            return False

    # -- local cache walk -----------------------------------------------
    async def _scan_cache(self, counts: dict) -> None:
        cache = self.cache
        if cache is None:
            return
        for key in await asyncio.to_thread(cache.keys):
            entry = await cache.peek(key)
            if entry is None or not getattr(entry, "digests", None):
                continue
            bad = False
            async with cache.pinned(key):
                for rel, want in sorted(entry.digests.items()):
                    path = os.path.join(cache.entry_path(key),
                                        *rel.split("/"))
                    got = await self._hash(path)
                    if got is None:
                        continue  # evicted under the walk
                    if got == want:
                        self._note("clean", counts)
                        continue
                    if await self._repair_cache_file(key, rel, want, path):
                        self._note("repaired", counts)
                        if self.logger is not None:
                            self.logger.warn(
                                "scrub: repaired cache file from shared "
                                "tier", key=key[:16], rel=rel)
                    else:
                        bad = True
                        self._note("quarantined", counts)
            if bad:
                # no healthy replica: the whole entry leaves the cache
                # (a later job for this key misses and re-fetches from
                # origin — that IS the repair-from-origin path)
                await cache.quarantine(key, self.quarantine_dir)
                if self.logger is not None:
                    self.logger.warn("scrub: quarantined cache entry",
                                     key=key[:16])

    async def _repair_cache_file(self, key: str, rel: str, want: str,
                                 path: str) -> bool:
        """Re-copy one corrupt cache file from the shared tier.

        The verified copy lands under a temp name and ``os.replace``s
        the corrupt file — ALWAYS a fresh inode (copy-on-repair), so a
        workdir or peer still hardlinked to the corrupt inode keeps
        its own detectable view instead of silently changing under a
        reader."""
        fleet = self.fleet
        if fleet is None or getattr(fleet, "store", None) is None:
            return False
        tmp = f"{path}.scrubtmp.{os.getpid()}"
        try:
            await fleet.store.fget_object(
                fleet.shared_bucket, fleet.shared_name(key, rel), tmp)
        except Exception:
            _unlink_quiet(tmp)
            return False
        got = await self._hash(tmp)
        if got != want:
            _unlink_quiet(tmp)
            return False
        try:
            os.replace(tmp, path)
        except OSError:
            _unlink_quiet(tmp)
            return False
        return True

    # -- shared tier walk -----------------------------------------------
    async def _scan_shared(self, counts: dict) -> None:
        """Scrub the shared staging tier's payload objects — only when
        the store is co-located (exposes ``local_object_path``): a
        remote store's disks are its own scrubber's problem, and
        hashing a remote object would mean streaming it anyway."""
        fleet = self.fleet
        if fleet is None or getattr(fleet, "store", None) is None:
            return
        local_path = getattr(fleet.store, "local_object_path", None)
        if local_path is None:
            return
        from ..fleet.plane import MANIFEST_NAME

        suffix = "/" + MANIFEST_NAME
        names = []
        try:
            async for info in fleet.store.list_objects(
                    fleet.shared_bucket, fleet.shared_prefix):
                name = getattr(info, "name", "")
                if name.endswith(suffix):
                    names.append(name)
        except Exception as err:
            if self.logger is not None:
                self.logger.warn("scrub: shared-tier listing failed",
                                 error=str(err)[:200])
            return
        for mname in sorted(names):
            try:
                doc = json.loads(await fleet.store.get_object(
                    fleet.shared_bucket, mname))
            except Exception:
                continue
            key = doc.get("key")
            digests = doc.get("digests")
            if not key or not isinstance(digests, dict):
                continue
            for rel, want in sorted(digests.items()):
                oname = fleet.shared_name(key, rel)
                path = local_path(fleet.shared_bucket, oname)
                if path is None:
                    continue
                got = await self._hash(path)
                if got is None:
                    continue
                if got == want:
                    self._note("clean", counts)
                    continue
                if await self._repair_shared(key, rel, want, path):
                    self._note("repaired", counts)
                    if self.logger is not None:
                        self.logger.warn(
                            "scrub: repaired shared-tier object from "
                            "local cache", key=key[:16], rel=rel)
                else:
                    # the manifest is the publish: removing it first
                    # makes the entry invisible before the payload
                    # moves, so no peer can fetch a half-quarantined
                    # entry
                    try:
                        await fleet.store.remove_object(
                            fleet.shared_bucket, mname)
                    except Exception:
                        pass
                    await asyncio.to_thread(
                        self._quarantine_file, path,
                        f"shared-{key[:16]}")
                    self._note("quarantined", counts)
                    if self.logger is not None:
                        self.logger.warn(
                            "scrub: quarantined shared-tier object",
                            key=key[:16], rel=rel)

    async def _repair_shared(self, key: str, rel: str, want: str,
                             path: str) -> bool:
        """Repair a shared-tier object from the local cache's copy —
        only when the cache copy is a DIFFERENT inode (a hardlinked
        view shares the corruption by definition) and hash-verifies."""
        cache = self.cache
        if cache is None:
            return False
        src = os.path.join(cache.entry_path(key), *rel.split("/"))
        try:
            if os.path.samestat(os.stat(src), os.stat(path)):
                return False  # same inode: the corruption IS this copy
        except OSError:
            return False
        async with cache.pinned(key):
            got = await self._hash(src)
            if got != want:
                return False

            def _replace() -> bool:
                tmp = f"{path}.scrubtmp.{os.getpid()}"
                try:
                    # copy, never link: the repair must mint a fresh
                    # inode even though source and target sit on the
                    # same volume
                    shutil.copyfile(src, tmp)
                    os.replace(tmp, path)
                    return True
                except OSError:
                    _unlink_quiet(tmp)
                    return False

            return await asyncio.to_thread(_replace)

    # -- workdir sidecar walk -------------------------------------------
    async def _scan_workdirs(self, counts: dict) -> None:
        """Re-verify promoted outputs still staged in live workdirs
        (long BULK queues can hold landed bytes for hours before
        upload).  A corrupt staged output has no healthy replica by
        definition — quarantine it and drop its sidecar note; the
        job's own retry/redelivery re-fetches from origin."""
        root = self.workdir_root
        if not root:
            return
        try:
            names = await asyncio.to_thread(os.listdir, root)
        except OSError:
            return
        for dirname in sorted(names):
            if dirname.startswith("."):
                continue  # .journal / .cache / .quarantine service dirs
            dirpath = os.path.join(root, dirname)
            landed = await asyncio.to_thread(read_landed, dirpath)
            for fname, want in sorted(landed.items()):
                path = os.path.join(dirpath, fname)
                got = await self._hash(path)
                if got is None:
                    continue  # job finished and cleaned up mid-walk
                if got == want:
                    self._note("clean", counts)
                    continue
                await asyncio.to_thread(self._quarantine_file, path,
                                        f"workdir-{dirname}")
                await asyncio.to_thread(drop_landed, dirpath, fname)
                self._note("quarantined", counts)
                if self.logger is not None:
                    self.logger.warn(
                        "scrub: quarantined staged workdir output",
                        workdir=dirname, file=fname)
