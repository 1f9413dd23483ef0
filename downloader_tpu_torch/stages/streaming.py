"""Streaming per-file staging pipeline: download ∥ filter ∥ upload.

The barrier dispatch (orchestrator stage loop) pays
``sum(download, process, upload)`` per job even though ingress and
egress use disjoint network paths, and the upload stage pushes files
one at a time in a serial loop at the very end.  This runner replaces
the stage barrier for the default ``download -> process -> upload``
chain: the download stage announces each durably-complete file into a
:class:`~.base.FileStream` (per-file torrent completion, per-object
bucket completion, HTTP promote time), the media filter runs per event,
and a bounded worker pool (``instance.upload_concurrency``, default 3)
stages files while later files are still downloading — so time-to-staged
trends toward ``max(download, upload)`` instead of the sum.

Invariants preserved from the barrier path:

- the ``done`` marker (the orchestrator's idempotency probe) is written
  only after the **authoritative** post-download walk's every file is
  staged — a crash mid-pipeline leaves staged files but no marker, and
  the redelivery skips them via ``_already_staged``
- per-file resume, egress pacing, metrics, and recorder events are the
  same :class:`~.upload.Uploader` code path the barrier stage drives
- cooperative cancellation unwinds within one file/chunk on every
  worker; the orchestrator's ``token.guard`` is the backstop
- ``NoMediaFilesError`` fires exactly when the authoritative walk finds
  nothing, like the process stage
- the 0-50/50-100 progress bands are recomputed for overlap: the
  download stage's own band (0-50) merges with the staged-file fraction
  (0-50) into one monotone percent
"""

from __future__ import annotations

import asyncio
import os
import time
from typing import List

from .. import schemas
from ..platform.config import cfg_get
# combined RUNNING-stage attribution for the registry/profiler while the
# pipelined dispatch runs (all three logical stages at once); defined in
# platform/obs.py, which cannot import this package (cycle via control)
from ..platform.obs import PIPELINE_STAGE  # graftlint: disable=unused-import -- re-exported for stage consumers
from .base import FileStream, Job, StageContext, get_stage_factory

DEFAULT_UPLOAD_CONCURRENCY = 3


def pipeline_mode(config) -> str:
    """``instance.pipeline`` / ``PIPELINE_MODE``: ``streaming`` (default)
    or ``barrier`` (the exact pre-streaming sequential dispatch).
    Misconfiguration fails loudly, like the rate-limit knobs."""
    mode = os.environ.get("PIPELINE_MODE") or cfg_get(
        config, "instance.pipeline", "streaming"
    )
    if mode not in ("streaming", "barrier"):
        raise ValueError(
            f"instance.pipeline must be 'streaming' or 'barrier', got {mode!r}"
        )
    return mode


def upload_concurrency(config) -> int:
    """``instance.upload_concurrency`` / ``UPLOAD_CONCURRENCY``: size of
    the streaming upload worker pool (default 3)."""
    raw = os.environ.get("UPLOAD_CONCURRENCY") or cfg_get(
        config, "instance.upload_concurrency", DEFAULT_UPLOAD_CONCURRENCY
    )
    try:
        value = int(raw)
    except (TypeError, ValueError):
        raise ValueError(
            f"upload_concurrency must be an integer, got {raw!r}"
        ) from None
    if value < 1 or value > 64:
        raise ValueError(f"upload_concurrency must be in [1, 64], got {value}")
    return value


class _MergedProgress:
    """Telemetry facade recomputing the 0-50/50-100 split for overlap.

    In barrier mode the download stage owns 0-50 and the upload stage
    owns 50-100, sequentially.  Overlapped, raw interleaving would emit
    regressions (download 32 after upload pushed the total to 40), so
    this facade merges the two fractions — download percent capped at 50
    plus ``int(50 * staged/total)`` — and emits only monotone increases.
    Status events and other jobs' progress (coalesced cache waiters emit
    for their own ids) pass through untouched.
    """

    def __init__(self, inner, media_id: str):
        self._inner = inner
        self._media_id = media_id
        self._status = schemas.TelemetryStatus.Value("DOWNLOADING")
        self._download = 0
        self._staged = 0
        self._total = 0
        self._last = -1

    async def emit_status(self, media_id: str, status: int) -> None:
        await self._inner.emit_status(media_id, status)

    async def emit_progress(self, media_id: str, status: int,
                            percent: int) -> None:
        if media_id != self._media_id:
            await self._inner.emit_progress(media_id, status, percent)
            return
        self._download = max(self._download, min(int(percent), 50))
        await self._flush(status)

    async def note_staged(self, staged: int, total: int) -> None:
        self._staged = staged
        self._total = max(total, staged)
        await self._flush(self._status)

    async def finish(self) -> None:
        """Everything staged: land exactly on 100."""
        self._download = 50
        self._staged = self._total = max(self._total, 1)
        await self._flush(self._status)

    async def _flush(self, status: int) -> None:
        fraction = (min(self._staged / self._total, 1.0)
                    if self._total else 0.0)
        # the upload band opens in PROPORTION to the download band:
        # mid-download the eventual file count is unknown (total = files
        # seen so far), so an absolute 50 * staged/total would jump to
        # ~100/2 off the first completed file and then freeze until the
        # download band caught up.  Weighting by the download fraction
        # bounds the merged percent at 2x the download band — smooth,
        # monotone, and exactly 100 once everything is staged.
        merged = min(int(self._download * (1.0 + fraction)), 100)
        if merged <= self._last:
            return
        if self._last < 50 <= self._download and merged > 50:
            # download-complete milestone: consumers (and the coalesced
            # cache waiters' re-broadcast contract) key on an exact 50 —
            # when files staged mid-download would let the merged value
            # leap straight past it, emit the milestone first
            self._last = 50
            await self._inner.emit_progress(self._media_id, status, 50)
        self._last = merged
        await self._inner.emit_progress(self._media_id, status, merged)


async def _await_with_failfast(primary: asyncio.Task,
                               others: List[asyncio.Task]):
    """Await ``primary``, but re-raise immediately if any of ``others``
    dies first — a failed upload worker must abort the download instead
    of letting it run to completion for nothing."""
    watched = [task for task in others if not task.done()]
    while True:
        done, _pending = await asyncio.wait(
            {primary, *watched}, return_when=asyncio.FIRST_COMPLETED
        )
        if primary in done:
            return primary.result()
        for task in done:
            if task.cancelled():
                raise asyncio.CancelledError()
            if task.exception() is not None:
                raise task.exception()
        watched = [task for task in watched if not task.done()]
        if not watched:
            return await primary


async def run_streaming_job(ctx: StageContext, media, mirrors=(),
                            source_kind: str = "AUTO") -> None:
    """Run one job through the eager per-file pipeline.

    Raises exactly what the barrier stage loop would: the download
    stage's own errors (``ERRDLSTALL`` code preserved),
    ``NoMediaFilesError``, upload errors, ``JobCancelled`` — the
    orchestrator's failure policy is unchanged.

    ``mirrors``/``source_kind`` are the origin-plane fields from the
    Download message (downloader_tpu_torch/origins/): mirrors ride into the
    download stage's racing fetch, and a MANIFEST source kind both
    selects the playlist-ingest method and widens the media filter to
    segment containers — each live segment announced into the
    FileStream stages through this pipeline while later segments are
    still being produced.
    """
    import dataclasses

    from .download import job_download_dir
    from .process import NoMediaFilesError, find_media_files, \
        incremental_filter, stage_exts
    from .upload import Uploader

    logger = ctx.logger
    record = ctx.record
    media_id = media.id
    workdir = job_download_dir(ctx.config, media_id)
    concurrency = upload_concurrency(ctx.config)

    progress = _MergedProgress(ctx.telemetry, media_id)
    # the download stage emits its 0-50 band through the merged facade;
    # everything else on the context is shared with the orchestrator's
    dl_ctx = dataclasses.replace(ctx, telemetry=progress)
    download_fn = await get_stage_factory("download")(dl_ctx)

    stream = FileStream()
    job = Job(media=media, last_stage={}, file_stream=stream,
              mirrors=tuple(mirrors or ()), source_kind=source_kind)
    uploader = Uploader(ctx)
    exts = stage_exts(ctx.config, source_kind)
    allow = incremental_filter(workdir, media, logger, exts)

    accepted: asyncio.Queue = asyncio.Queue()
    enqueued: set = set()
    staged = [0]
    total_known = [0]

    async def _enqueue(path: str) -> None:
        path = os.path.abspath(path)
        if path in enqueued:
            return
        enqueued.add(path)
        total_known[0] = max(total_known[0], len(enqueued))
        await accepted.put(path)

    async def _pump() -> None:
        """Consume per-file events: filter each incrementally, hand the
        keepers to the upload pool."""
        while (event := await stream.next()) is not None:
            ctx.cancel.raise_if_cancelled()
            name = os.path.basename(event.path)
            if record is not None:
                record.event("file_complete", file=name, bytes=event.size)
            filter_mark = time.monotonic()
            verdict = await asyncio.to_thread(allow, event.path)
            if record is not None:
                record.note_hop("filter", event.size,
                                time.monotonic() - filter_mark)
            if verdict:
                logger.info("pipeline: file complete, queued for upload",
                            file=name)
                await _enqueue(event.path)
            else:
                logger.info("pipeline: file complete, filtered out",
                            file=name)

    async def _worker() -> None:
        while True:
            path = await accepted.get()
            if path is None:
                return
            ctx.cancel.raise_if_cancelled()
            await uploader.upload_file(
                media_id, path,
                digest=job.landed_digests.get(path))
            staged[0] += 1
            await progress.note_staged(staged[0], total_known[0])

    with ctx.tracer.span("stage.pipeline", mediaId=media_id,
                         workers=concurrency):
        await uploader.ensure_bucket()
        download_task = asyncio.create_task(download_fn(job))
        pump_task = asyncio.create_task(_pump())
        workers = [asyncio.create_task(_worker()) for _ in range(concurrency)]
        try:
            result = await _await_with_failfast(
                download_task, [pump_task, *workers]
            )
            download_path = (
                result["path"] if isinstance(result, dict) else workdir
            )
            # ingress is over: retire the live counters so the transfer
            # profiler's stall gate stops watching them — otherwise a
            # CPU-only phase after the download (the authoritative walk,
            # _already_staged hashing of large resumed files) reads as a
            # flat-lined transfer and flags a spurious stall_suspect.
            # "upload" too: the next part that actually moves reinstalls
            # it (note_transfer), so tail-upload stalls are still caught
            # while the hash-between-files gaps stay exempt — the same
            # granularity the barrier upload stage gets from its
            # stage-key check.
            if record is not None:
                record.transferred.pop("download", None)
                record.transferred.pop("upload", None)
            # drain the stream fully before the authoritative walk so no
            # event races the reconciliation below
            await stream.close()
            await _await_with_failfast(pump_task, workers)

            # the post-download walk is the source of truth, exactly like
            # the process stage: it catches files the stream never
            # announced and decides the zero-matches error.  A cache hit
            # materializes a whole workdir at once AND names every file
            # it placed (job.cache_files), so that case serves from the
            # known list through the same per-file verdicts — no re-walk
            walk_mark = time.monotonic()
            cache_files = job.cache_files
            if cache_files is not None and all(
                    os.path.exists(p) for p in cache_files):
                found = sorted(p for p in cache_files if allow(p))
            else:
                found = await asyncio.to_thread(
                    find_media_files, download_path, media, logger, exts
                )
            if record is not None:
                record.note_hop("filter", 0,
                                time.monotonic() - walk_mark)
                record.event("process", files=len(found))
            if len(found) == 0:
                raise NoMediaFilesError(
                    "Failed to find any suitable media files"
                )
            total_known[0] = max(len(found), len(enqueued))
            for path in found:
                await _enqueue(path)
            for _ in workers:
                await accepted.put(None)
            await asyncio.gather(*workers)

            # done marker ONLY after every authoritative file is staged
            # AND the staged set verifies against the content manifest
            # (stages/manifest.py): it is the idempotency probe the
            # whole fleet trusts
            await uploader.verify_staged_set(media_id, found)
            await uploader.write_done_marker(media_id)
            await progress.finish()
            logger.info("pipeline: all files staged",
                        files=len(found), streamed=staged[0])
        finally:
            for task in (download_task, pump_task, *workers):
                task.cancel()
            await asyncio.gather(download_task, pump_task, *workers,
                                 return_exceptions=True)

        await uploader.cleanup_workdir(download_path)
