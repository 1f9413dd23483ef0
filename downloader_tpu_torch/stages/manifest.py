"""Staged-artifact integrity: the per-job content manifest.

The ``done`` marker is the idempotency probe the whole fleet trusts —
once it exists, the converter (and every redelivered attempt) assumes
the staging set under ``<id>/original/`` is complete and correct.  A
worker crash mid-upload cannot tear a SINGLE object (S3 semantics: an
object appears only when its put completes), but before this module
nothing proved the SET: a marker written against a staging prefix that
lost an object, or whose object was re-written by a buggy peer between
upload and seal, would publish a short or corrupt set downstream.

The manifest closes that window:

- as each file **lands** in the staging store, the uploader records the
  object's name, the local file's size, and the **store-computed
  content hash** (the S3-style etag: plain MD5 for single-part puts,
  ``md5(md5(parts))-N`` for multipart) — captured from the stat the
  upload path already performs, never by re-reading the file;
- the entries persist to ``<workdir>/.manifest.json`` (atomic
  temp+rename per update), so a redelivered attempt after a crash
  inherits what its predecessor proved;
- :meth:`JobManifest.verify_staged` runs **before the done marker is
  written**, re-statting every object in the authoritative file list:
  each must exist, match the recorded size, and carry the recorded
  etag.  Any discrepancy raises :class:`StagedSetMismatch` (classified
  transient — the redelivery re-stages) and the marker is never
  written, so a torn crash can at worst delay a publish, never corrupt
  one.

Backends that do not report etags (``ObjectInfo.etag == ""``) degrade
to size-only verification — documented, and still enough to catch the
short-set case.
"""

from __future__ import annotations

import asyncio
import json
import os
import threading
from typing import Dict, Optional

from ..platform.config import cfg_get
from ..platform.errors import TRANSIENT
from ..store.base import ObjectNotFound

MANIFEST_BASENAME = ".manifest.json"
SCHEMA = 1


class StagedSetMismatch(RuntimeError):
    """The staged objects do not match the per-job content manifest.

    Carries ``fault_class = TRANSIENT``: the failure policy parks and
    nacks, and the redelivered attempt re-stages whatever diverged
    (``_already_staged`` skips the objects that still verify).
    """

    fault_class = TRANSIENT

    def __init__(self, media_id: str, problems: list):
        self.media_id = media_id
        self.problems = problems
        super().__init__(
            f"staged set for {media_id} failed manifest verification: "
            + "; ".join(problems[:5])
            + (f" (+{len(problems) - 5} more)" if len(problems) > 5 else "")
        )


def integrity_enabled(config) -> bool:
    """``integrity.enabled`` (default True): the manifest + pre-seal
    verification.  Off restores the exact pre-manifest upload path."""
    return bool(cfg_get(config, "integrity.enabled", True))


class JobManifest:
    """Content manifest for one job's staging set.

    Entries key on the staged object name; each holds the local size
    and the store's content hash observed when the object landed.  The
    file lives beside the job's own downloads (a dot-file, invisible to
    the media-extension walk) and dies with the workdir — by then the
    set is sealed or swept.
    """

    def __init__(self, workdir: str, media_id: str):
        self.workdir = workdir
        self.media_id = media_id
        self.path = os.path.join(workdir, MANIFEST_BASENAME)
        self.entries: Dict[str, dict] = {}
        # persist() runs on worker threads (the upload path hands it to
        # asyncio.to_thread); concurrent staging workers must not race
        # the temp-file write
        self._io_lock = threading.Lock()

    @classmethod
    def load(cls, workdir: str, media_id: str) -> "JobManifest":
        """Load a prior attempt's manifest (missing/torn file = empty:
        the resume probes repopulate it entry by entry)."""
        manifest = cls(workdir, media_id)
        try:
            with open(manifest.path, "r", encoding="utf-8") as fh:
                raw = json.load(fh)
        except (OSError, ValueError):
            return manifest
        if isinstance(raw, dict) and raw.get("mediaId") == media_id:
            entries = raw.get("entries")
            if isinstance(entries, dict):
                manifest.entries = {
                    str(name): dict(entry)
                    for name, entry in entries.items()
                    if isinstance(entry, dict)
                }
        return manifest

    def note(self, object_name: str, *, size: int, etag: str,
             file: Optional[str] = None) -> None:
        """Record one landed object (memory only — the caller persists
        via :meth:`persist` off-loop after each landing)."""
        self.entries[object_name] = {
            "size": int(size), "etag": etag or "",
            "file": os.path.basename(file) if file else "",
        }

    def persist(self) -> None:
        """Write the manifest (atomic temp + rename — a crash mid-update
        leaves the previous manifest, never a torn one).

        Blocking disk I/O: callers on the event loop wrap it in
        ``asyncio.to_thread`` so a large staging set's per-file updates
        never stall concurrent transfers.  The entries dict is copied
        up front (atomic under the GIL) so loop-side ``note`` calls
        cannot mutate it mid-serialization.
        """
        blob = {"schema": SCHEMA, "mediaId": self.media_id,
                "entries": dict(self.entries)}
        tmp = self.path + ".tmp"
        try:
            with self._io_lock:
                os.makedirs(self.workdir, exist_ok=True)
                with open(tmp, "w", encoding="utf-8") as fh:
                    json.dump(blob, fh, separators=(",", ":"))
                os.replace(tmp, self.path)
        except OSError:
            # the manifest is defense-in-depth: losing an update degrades
            # the verify (the entry re-notes on the next attempt), it
            # must never fail the upload that just succeeded
            pass

    async def verify_staged(self, store, bucket: str, files,
                            object_name_fn):
        """Re-stat every authoritative file's staged object against the
        manifest; raise :class:`StagedSetMismatch` on any divergence.

        ``files`` is the post-download walk's list (the same one the
        done marker seals); ``object_name_fn`` maps a local path to its
        staged object name.  Returns ``(verified, unverifiable)``
        counts.  Only :class:`~..store.base.ObjectNotFound` proves an
        object missing; any OTHER stat failure (write-only credentials
        where HEAD answers 403, a store outage at verify time) makes
        that object unverifiable and skips it — the same best-effort
        posture as ``_already_staged`` and the post-put stat, because
        this layer is defense-in-depth and must never fail a staging
        set the put path itself proved landed.
        """
        # stats are independent metadata round trips: run them
        # concurrently (bounded — a 200-file season must not open 200
        # sockets at once) so the seal pays ~1 RTT, not len(files)
        gate = asyncio.Semaphore(16)

        async def _check(file_path):
            """(problem | None, unverifiable 0|1) for one file."""
            name = object_name_fn(self.media_id, file_path)
            entry = self.entries.get(name)
            if entry is None:
                return f"{name}: no manifest entry", 0
            try:
                async with gate:
                    info = await store.stat_object(bucket, name)
            except ObjectNotFound:
                return f"{name}: missing from store", 0
            except Exception:
                return None, 1
            if int(info.size) != int(entry.get("size", -1)):
                return (f"{name}: size {info.size} != manifest "
                        f"{entry.get('size')}"), 0
            expected = entry.get("etag") or ""
            if expected and info.etag and info.etag != expected:
                return f"{name}: etag {info.etag} != manifest {expected}", 0
            return None, 0

        results = await asyncio.gather(*(_check(f) for f in files))
        problems = [problem for problem, _ in results if problem]
        unverifiable = sum(skipped for _, skipped in results)
        if problems:
            raise StagedSetMismatch(self.media_id, problems)
        return len(files) - unverifiable, unverifiable
