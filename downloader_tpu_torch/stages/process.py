"""Process stage: walk the download directory and select convertible media.

Behavioral parity with upstream lib/process.js:

- extension whitelist ``.mp4 .mkv .mov .webm`` (lib/process.js:15-20,70-72)
- a sole top-level directory is always traversed (lib/process.js:40-48)
- MOVIE mode keeps every directory (lib/process.js:53-55)
- paths containing ``/extras`` or ``/commentary`` (case-insensitive) are
  rejected (lib/process.js:59-61)
- directory names containing ``season`` or ``s<digits>`` (case-insensitive)
  are accepted (lib/process.js:64-66)
- anything else is rejected; rejected directories are not descended into
- zero matches raises ``Failed to find any suitable media files``
  (lib/process.js:109-111)
"""

from __future__ import annotations

import asyncio
import os
import re
import time
from typing import List

from .. import schemas
from ..utils.stale import PART_TEMP_STRICT_RE as _PART_TEMP_RE
from .base import Job, StageContext, StageFn

# (reference lib/process.js:15-20)
MEDIA_EXTS = {".mp4", ".mkv", ".mov", ".webm"}

# The torrent client's fast-resume sidecar (torrent/resume.py RESUME_NAME
# — equality pinned by a test) lives at the download root.  It is the
# framework's own artifact, not downloaded content, so the filter must
# not let it defeat the sole-top-level-directory rule below.
_RESUME_SIDECAR = ".dt-resume"
# our own workdir sidecars, invisible to the sole-top-level-directory
# parity check below: the torrent resume state and the staged-artifact
# content manifest (stages/manifest.py) live beside the payload but are
# not payload
_SIDECARS = frozenset({_RESUME_SIDECAR, ".manifest.json"})

# (reference lib/process.js:59-66) — substring matches, like JS regex.test
_SKIP_PATH_RE = re.compile(r"/extras|/commentary", re.IGNORECASE)
_SEASON_RE = re.compile(r"s\d+|season", re.IGNORECASE)


class NoMediaFilesError(Exception):
    """Raised when the walk finds nothing convertible
    (reference lib/process.js:109-111)."""


def _dir_allowed(root: str, dir_path: str, is_movie: bool, logger) -> bool:
    name = os.path.basename(dir_path)

    # Sole top-level directory is always traversed (lib/process.js:40-48).
    # The reference checks the *name* against the root listing, so a nested
    # directory sharing the sole top-level dir's name is also allowed —
    # preserved as-is for parity.
    try:
        if os.path.exists(os.path.join(root, name)):
            entries = [e for e in os.listdir(root) if e not in _SIDECARS]
            if len(entries) == 1 and entries[0] == name:
                logger.info(
                    "directory allowed: only top level directory", path=dir_path
                )
                return True
    except OSError:
        pass

    # In movie mode, assume the best (lib/process.js:53-55).
    if is_movie:
        return True

    # Explicitly skip extras/commentary anywhere in the path
    # (lib/process.js:59-61).
    if _SKIP_PATH_RE.search(dir_path.replace(os.sep, "/")):
        return False

    # Allow season-like directory names (lib/process.js:64-66).
    return bool(_SEASON_RE.search(name))


# what an HLS-style packager emits per segment: MPEG-TS pieces and fMP4
# fragments.  Only MANIFEST jobs widen the filter to them — a stray .ts
# in a torrent payload stays excluded, exactly the parity behavior.
MANIFEST_EXTS = {".ts", ".m4s"}


def stage_exts(config, source_kind: str = "AUTO"):
    """The extension whitelist the stage actually runs with: the parity
    set, plus raw ``.y4m`` when the upscale stage is enabled (shared by
    the barrier stage below and the streaming pipeline's filter), plus
    the segment-container extensions for MANIFEST-ingest jobs."""
    from .upscale import upscale_enabled

    exts = MEDIA_EXTS | {".y4m"} if upscale_enabled(config) else MEDIA_EXTS
    if (source_kind or "AUTO").upper() == "MANIFEST":
        exts = exts | MANIFEST_EXTS
    return exts


def incremental_filter(root: str, media: schemas.Media, logger,
                       exts=MEDIA_EXTS):
    """Per-file media predicate for the streaming pipeline.

    Returns ``allow(path) -> bool`` giving, for any file under ``root``,
    the same verdict :func:`find_media_files` reaches for it — a file is
    kept iff its extension is whitelisted, it is not a transcode temp,
    and every ancestor directory up to ``root`` passes
    :func:`_dir_allowed`.  Directory verdicts are memoized, which is
    only sound while the tree *shape* is stable; every streaming source
    guarantees that before its first event (torrents preallocate the
    full layout, the bucket method pre-creates all directories from the
    materialized listing, HTTP/file sources are a single file at the
    root).  The authoritative post-download walk reconciles any
    divergence regardless.
    """
    is_movie = media.type == schemas.MediaType.Value("MOVIE")
    root = os.path.abspath(root)
    verdicts = {root: True}

    def _ancestors_allowed(dir_path: str) -> bool:
        dir_path = os.path.abspath(dir_path)
        cached = verdicts.get(dir_path)
        if cached is not None:
            return cached
        if not dir_path.startswith(root + os.sep):
            # outside the job workdir: never ours to stage
            verdicts[dir_path] = False
            return False
        allowed = _ancestors_allowed(os.path.dirname(dir_path)) and (
            _dir_allowed(root, dir_path, is_movie, logger)
        )
        verdicts[dir_path] = allowed
        return allowed

    def allow(path: str) -> bool:
        name = os.path.basename(path)
        if _PART_TEMP_RE.search(name):
            return False
        if os.path.splitext(name)[1] not in exts:
            return False
        return _ancestors_allowed(os.path.dirname(path))

    return allow


def find_media_files(root: str, media: schemas.Media, logger,
                     exts=MEDIA_EXTS) -> List[str]:
    """Depth-first walk honoring the filter; returns kept file paths.

    (reference ``findMediaFiles``, lib/process.js:29-99 — klaw walk with a
    filter callback; only files are collected, directories are traversal
    decisions)
    """
    is_movie = media.type == schemas.MediaType.Value("MOVIE")
    files: List[str] = []

    def _walk(dir_path: str) -> None:
        try:
            entries = sorted(os.scandir(dir_path), key=lambda e: e.name)
        except FileNotFoundError:
            raise
        for entry in entries:
            rel = os.path.relpath(entry.path, root)
            if entry.is_dir(follow_symlinks=False):
                if _dir_allowed(root, entry.path, is_movie, logger):
                    logger.info(f"including directory '{rel}'")
                    _walk(entry.path)
                else:
                    logger.warn(f"skipping directory '{rel}'")
            else:
                ext = os.path.splitext(entry.name)[1]
                if _PART_TEMP_RE.search(entry.name):
                    # an in-flight or SIGKILL-orphaned transcode temp
                    # (<dst>.part-<pid>.<seq><ext>) carries a media
                    # extension but is never content — ingesting a
                    # corrupt partial on redelivery is worse than the
                    # reference's behavior, which has no such temps.
                    # Strict two-number form only, so real content like
                    # "Movie.part-2.mkv" is never swallowed (review r5)
                    logger.warn(f"skipping transcode temp '{rel}'")
                elif ext in exts:
                    logger.info(f"including file '{rel}'")
                    files.append(entry.path)
                else:
                    logger.warn(f"skipping file '{rel}'")

    _walk(root)
    return files


async def stage_factory(ctx: StageContext) -> StageFn:
    logger = ctx.logger

    async def process(job: Job):
        # cooperative cancellation: the walk itself is fast local I/O,
        # so one check before it starts is the stage's whole window
        ctx.cancel.raise_if_cancelled()
        # config-gated divergence: with the upscale stage enabled, raw
        # .y4m streams (what a decode front-end emits) count as media
        # too, and MANIFEST-ingest jobs accept segment containers.  The
        # parity default stays the reference's exact whitelist.
        exts = stage_exts(ctx.config,
                          getattr(job, "source_kind", "AUTO"))
        last = job.last_stage
        download_path = last["path"] if isinstance(last, dict) else last.path
        logger.info("processing directory", path=download_path)

        with ctx.tracer.span("stage.process", path=download_path):
            walk_mark = time.monotonic()
            cache_files = getattr(job, "cache_files", None)
            if cache_files is not None:
                # cache-hit serving: the entry already named its files
                # (stages/download.py materialize_hit), so apply the
                # SAME per-file verdict the walk would reach — without
                # the directory re-walk.  Missing paths (clobbered
                # workdir) fall back to the authoritative walk.
                if all(os.path.exists(p) for p in cache_files):
                    allow = incremental_filter(
                        download_path, job.media, logger, exts)
                    found = sorted(p for p in cache_files if allow(p))
                else:
                    found = await asyncio.to_thread(
                        find_media_files, download_path, job.media,
                        logger, exts)
            else:
                found = await asyncio.to_thread(
                    find_media_files, download_path, job.media, logger, exts
                )
            if ctx.record is not None:
                # the media-filter verdicts, on the hop ledger (barrier
                # dispatch; the streaming pipeline bills its own)
                ctx.record.note_hop("filter", 0,
                                    time.monotonic() - walk_mark)

        if len(found) == 0:
            raise NoMediaFilesError("Failed to find any suitable media files")

        logger.info("found media files", count=len(found))
        if ctx.record is not None:
            ctx.record.event("process", files=len(found))
        return {"files": found, "downloadPath": download_path}

    return process
