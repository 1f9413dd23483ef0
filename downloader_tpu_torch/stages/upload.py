"""Upload stage: push filtered files into the staging object store.

Behavioral parity with upstream lib/upload.js:

- validates ``files`` is a list (lib/upload.js:21-23)
- ensures bucket ``triton-staging`` exists (lib/upload.js:29-31) — now
  memoized per service in the cross-job ``ctx.resources``, so the
  existence round trip is paid once per process, not once per job
- object name = ``<media.id>/original/<base64(basename)>``
  (lib/upload.js:43-44)
- per-file existence check; missing file is an error (lib/upload.js:38-41)
- progress telemetry mapped to 50-100% (lib/upload.js:47-51)
- writes ``<media.id>/original/done`` = ``"true"`` — the idempotency marker
  the orchestrator probes (lib/upload.js:55, lib/main.js:120); fleet-
  coordinated jobs seal with a fenced JSON document instead (see
  :func:`done_marker_body` — existence is still the probe contract)
- best-effort removal of the download directory (lib/upload.js:60-64)

The per-file machinery lives in :class:`Uploader` so the streaming
pipeline (stages/streaming.py) can stage individual files from its
bounded worker pool while the download is still running; the barrier
stage below drives the same object through the reference's serial loop,
so resume (`_already_staged`), pacing, metrics, and recorder events are
one code path in both modes.
"""

from __future__ import annotations

import asyncio
import base64
import inspect
import json
import os
import posixpath
import shutil
import time
from typing import Optional

from .. import schemas
from ..platform import faults
from ..platform.errors import Retrier
from ..utils.hashing import md5_file_hex, multipart_etag_hex
from .base import Job, StageContext, StageFn

STAGING_BUCKET = "triton-staging"
DONE_MARKER = "done"


def object_name(media_id: str, file_path: str) -> str:
    """``<id>/original/<base64(basename)>`` (reference lib/upload.js:43-44)."""
    encoded = base64.b64encode(os.path.basename(file_path).encode("utf-8")).decode("ascii")
    return posixpath.join(media_id, "original", encoded)


def done_marker_name(media_id: str) -> str:
    """``<id>/original/done`` (reference lib/upload.js:55)."""
    return posixpath.join(media_id, "original", DONE_MARKER)


def done_marker_body(fence=None, worker=None) -> bytes:
    """The marker document.  Without a fence context it is the
    reference-parity literal ``b"true"``; a fleet-coordinated job seals
    with a fenced JSON document instead, so a resumed stale leader's
    re-seal is rejectable (every consumer treats marker EXISTENCE as
    "staged" — both shapes satisfy the probe)."""
    if not fence:
        return b"true"
    doc = {"done": True, "fence": int(fence)}
    if worker:
        doc["worker"] = worker
    return json.dumps(doc, sort_keys=True).encode("utf-8")


def parse_done_marker(raw: bytes) -> dict:
    """``{"done": bool, "fence": int}`` from either marker shape
    (legacy ``b"true"`` parses as fence 0 — any fenced writer beats
    it).  Unrecognizable bodies read as not-done, fence 0."""
    if raw == b"true":
        return {"done": True, "fence": 0}
    try:
        doc = json.loads(raw.decode("utf-8"))
        return {"done": bool(doc.get("done")),
                "fence": int(doc.get("fence") or 0)}
    except (ValueError, UnicodeDecodeError, AttributeError, TypeError):
        return {"done": False, "fence": 0}


async def _already_staged(store, name: str, file_path: str, record=None,
                          size=None):
    """The staged object's info when it provably holds this file's
    bytes, else None (truthy/falsy, so it still reads as a predicate).

    Requires both a size match and a content-hash match against the
    backend's etag; a backend that can't report one (empty etag) never
    short-circuits — size equality alone could seal a stale same-size
    object under the done marker.  The probe is best-effort: ANY stat
    failure (not just ObjectNotFound — e.g. write-only credentials where
    HEAD answers 403) means "not staged" so the upload proceeds instead
    of failing a job the plain put path would have handled fine.  On a
    hit the returned ``ObjectInfo`` carries the verified size + etag, so
    the caller's content manifest (stages/manifest.py) records the SAME
    hash the skip decision trusted — no second stat, no re-read.

    Hop-ledger billing lives here because only this function knows
    whether a local re-hash actually ran: the ``hash`` hop gets the
    file's bytes only when md5/multipart-etag computed over them (the
    seconds-per-GB hashing rate the attribution exists for); a probe
    that stopped at stat/size/etag gating bills its wall at ZERO bytes,
    so the common first-upload path can't drag the fleet-wide
    ``hop_seconds_per_gb{hop="hash"}`` rate toward "hashing is free".
    """
    probe_mark = time.monotonic()

    def _bill(hashed_bytes: int) -> None:
        if record is not None:
            record.note_hop("hash", hashed_bytes,
                            time.monotonic() - probe_mark)

    try:
        info = await store.stat_object(STAGING_BUCKET, name)
    except Exception:
        _bill(0)
        return None
    if size is None:
        size = os.path.getsize(file_path)
    if not info.etag or info.size != size:
        _bill(0)
        return None
    if "-" in info.etag:
        # multipart object: its etag is md5-of-part-md5s at the store's
        # part size, which we can recompute locally — without this, every
        # large (multipart) file would re-upload on redelivery, exactly
        # the files resume matters for
        part_size = getattr(store, "multipart_part_size", None)
        if not part_size:
            _bill(0)
            return None
        # graftlint: disable=second-pass-read -- resume probe: a redelivered job has no landed digest (fresh process), so matching the store's multipart etag needs one local pass
        expected = await asyncio.to_thread(
            multipart_etag_hex, file_path, part_size
        )
        _bill(size)
        return info if info.etag == expected else None
    # graftlint: disable=second-pass-read -- resume probe: no landed digest survives a redelivery, one pass decides skip-vs-reupload
    expected = await asyncio.to_thread(md5_file_hex, file_path)
    _bill(size)
    return info if info.etag == expected else None


class Uploader:
    """Per-file staging engine, shared by the barrier stage and the
    streaming pipeline.

    One instance per job context; cross-job state (the egress token
    bucket, the staging-bucket existence memo) lives in the orchestrator's
    shared ``ctx.resources``.
    """

    def __init__(self, ctx: StageContext):
        if ctx.store is None:
            raise ValueError("upload stage requires a StageContext.store")
        self.ctx = ctx
        self.store = ctx.store
        self.logger = ctx.logger
        # service-wide egress cap (bytes/s) to the staging store, the
        # mirror of the download stage's ingress bucket: ONE bucket shared
        # by every job's uploads (memoized in the cross-job ctx.resources),
        # so MinIO egress is cappable per instance
        # (``instance.upload_rate_limit`` / 0 = unlimited, parity default)
        from ..utils.ratelimit import shared_bucket

        self.limiter = shared_bucket(ctx.resources, ctx.config,
                                     "upload_rate_limit")
        # per-tenant egress quota (control/tenancy.py), stacked under
        # the service cap exactly like the download stage's ingress side
        from ..control.tenancy import stage_limiter

        self.limiter = stage_limiter(ctx, "egress", self.limiter)
        # dependency fault tolerance (platform/errors.py): staging-store
        # calls ride the service's shared retry executor + "store"
        # circuit breaker (the orchestrator injects its instance via
        # ctx.resources; standalone stage use builds one from config)
        self.retrier = Retrier.shared(ctx.resources, ctx.config,
                                      metrics=ctx.metrics,
                                      logger=ctx.logger)
        self.uploaded_total = 0
        # staged-artifact integrity (stages/manifest.py): per-job content
        # manifest, loaded lazily on the first upload so a redelivered
        # attempt inherits what its predecessor proved
        from .manifest import integrity_enabled

        self._integrity = integrity_enabled(ctx.config)
        self._manifest = None
        self._manifest_lock = asyncio.Lock()

    async def manifest_for(self, media_id: str):
        """The job's content manifest (None when integrity is off).

        The first call loads a prior attempt's ``.manifest.json`` —
        blocking disk I/O, run off-loop like :meth:`JobManifest.persist`
        for the same reason (a contended or network-backed volume must
        not stall concurrent transfers).  The off-loop load is a real
        suspension point, so the lazy init is locked: without it two
        streaming upload workers can both load, and the loser's
        assignment would discard entries the winner already noted —
        a spurious StagedSetMismatch at seal time."""
        if not self._integrity:
            return None
        if (self._manifest is not None
                and self._manifest.media_id == media_id):
            return self._manifest
        async with self._manifest_lock:
            if self._manifest is None or self._manifest.media_id != media_id:
                from .download import job_download_dir
                from .manifest import JobManifest

                self._manifest = await asyncio.to_thread(
                    JobManifest.load,
                    job_download_dir(self.ctx.config, media_id), media_id,
                )
        return self._manifest

    async def ensure_bucket(self) -> None:
        """Staging-bucket existence, checked once per service.

        The result memoizes in the cross-job ``ctx.resources`` only on
        success, so a transient failure retries on the next job; two jobs
        racing the first check both probe — make_bucket tolerates
        already-exists, so the race is harmless.
        """
        if self.ctx.resources.get("staging_bucket_ready"):
            return

        async def _ensure():
            if faults.enabled():
                await faults.fire("store.bucket", key=STAGING_BUCKET)
            if not await self.store.bucket_exists(STAGING_BUCKET):
                await self.store.make_bucket(STAGING_BUCKET)

        bucket_mark = time.monotonic()
        await self.retrier.run("store.bucket", _ensure,
                               cancel=self.ctx.cancel,
                               record=self.ctx.record, logger=self.logger)
        if self.ctx.record is not None:
            # zero-byte control traffic still bills the upload hop: the
            # ledger's hop seconds should tile the staging wall
            self.ctx.record.note_hop("upload", 0,
                                     time.monotonic() - bucket_mark)
        self.ctx.resources["staging_bucket_ready"] = True

    def _put_supports_progress(self) -> bool:
        """Whether the store's fput_object takes a per-part ``progress``
        callback (store/s3.py does; tests monkeypatch fput freely, so the
        probe runs per call, not at construction)."""
        return self._put_supports("progress")

    def _put_supports(self, parameter: str) -> bool:
        try:
            return parameter in inspect.signature(
                self.store.fput_object
            ).parameters
        except (TypeError, ValueError):
            return False

    async def upload_file(self, media_id: str, file_path: str,
                          *, digest: Optional[str] = None) -> int:
        """Stage one file; returns the bytes uploaded (0 = resume skip).

        Egress pacing is charged per multipart part when the store
        reports upload progress (so a single 10 GiB file cannot burst the
        instance's whole egress budget before the bucket pushes back),
        and after the whole put otherwise.  Either way tokens are charged
        only for bytes that actually moved — no refunds on failure, and
        no up-front charge that a failed put would strand.

        ``digest`` is the file's hash-on-land md5 (Job.landed_digests,
        computed at the download landing moment).  When present it rides
        the put as a ``content_md5`` hint for stores that take one, and —
        for a single-part put, whose store etag IS that md5 — it settles
        the content manifest directly, eliminating the post-put stat
        that on a filesystem store was a full read pass per staged file.
        """
        ctx = self.ctx
        ctx.cancel.raise_if_cancelled()
        basename = os.path.basename(file_path)
        self.logger.info("upload", file=basename)
        if not os.path.exists(file_path):
            self.logger.error("failed to upload file, not found",
                              file=file_path)
            raise FileNotFoundError(f"{file_path} not found.")

        name = object_name(media_id, file_path)
        # size BEFORE the put: consume=True permits the backend to take
        # the path destructively (also the hash hop's byte weight)
        size = os.path.getsize(file_path)
        # file-level resume: a redelivered job (crash/nack before the
        # done marker was written) skips files whose bytes are provably
        # already staged — the reference re-uploads everything from
        # scratch (lib/upload.js:34-52).  The probe bills the ``hash``
        # hop itself: file bytes only when a re-hash actually ran — the
        # "hashing still copies through userspace" slice of ROADMAP
        # item 3's copy floor
        staged = await _already_staged(self.store, name, file_path,
                                       record=ctx.record, size=size)
        if staged is not None:
            self.logger.info("already staged, skipping", file=file_path)
            manifest = await self.manifest_for(media_id)
            if manifest is not None:
                # the skip decision just verified size + content hash:
                # record exactly what it trusted
                manifest.note(name, size=staged.size, etag=staged.etag,
                              file=file_path)
                await asyncio.to_thread(manifest.persist)
            if ctx.record is not None:
                ctx.record.event("upload_done", file=basename, bytes=0,
                                 skipped=True)
            return 0

        if ctx.record is not None:
            ctx.record.event("upload_start", file=basename, bytes=size)
        started = time.monotonic()
        charged = 0

        async def _paced(moved: int) -> None:
            # per-part pacing + live transfer counter: the store calls
            # this after each part (or the single put) lands
            nonlocal charged
            charged += moved
            self.uploaded_total += moved
            if ctx.record is not None:
                ctx.record.note_transfer("upload", self.uploaded_total)
            if self.limiter is not None:
                await self.limiter.consume(moved)

        # consume=True: the file's bytes are final (the download stage
        # only announces durable files; the barrier stage runs last) and
        # the whole download dir is deleted after the job settles
        # (reference lib/upload.js:60-64), so the store may ingest by
        # hardlink instead of a byte copy.  The contract permits
        # aliasing only — the path stays on disk, which the streaming
        # pipeline's post-download walk and the torrent serve path rely
        # on (store/base.py fput_object).
        # hash-on-land hint: stores that take a ``content_md5`` seed
        # their etag/stat path from the digest computed at the landing
        # moment, so nothing downstream re-reads the object to hash it
        extra = ({"content_md5": digest}
                 if digest and self._put_supports("content_md5") else {})

        async def _put():
            if faults.enabled():
                await faults.fire("store.put", key=name)
            if self._put_supports_progress():
                await self.store.fput_object(
                    STAGING_BUCKET, name, file_path, consume=True,
                    progress=_paced, **extra,
                )
            else:
                await self.store.fput_object(
                    STAGING_BUCKET, name, file_path, consume=True,
                    **extra)
                # charge AFTER the successful put: consume() deducts
                # immediately and sleeps off the deficit, pacing the
                # AVERAGE egress rate without hooks inside the store
                # client's transfer loop.  Charging up front would strand
                # service-wide tokens for bytes that never moved whenever
                # a job is cancelled or the put fails mid-wait — debt
                # every OTHER job would then sleep off.
                await _paced(size)

        # transient store failures retry in-process (tokens were only
        # charged for bytes that actually moved, so a retried part is
        # paced again like any other bytes); the store breaker opens on
        # a hard-down backend and parks intake at the orchestrator
        upload_mark = time.monotonic()
        await self.retrier.run("store.put", _put, cancel=ctx.cancel,
                               record=ctx.record, logger=self.logger)
        manifest = await self.manifest_for(media_id)
        if manifest is not None:
            threshold = getattr(self.store, "multipart_threshold", None)
            if digest and (threshold is None or size <= threshold):
                # hash-on-land settles the manifest directly: a
                # single-part object's store etag IS the content md5 the
                # download stage computed while the bytes were hot, so
                # there is nothing left to round-trip (and on a
                # filesystem store, nothing left to re-read)
                manifest.note(name, size=size, etag=digest,
                              file=file_path)
            else:
                # capture the store-computed content hash of what just
                # landed (one metadata round trip; the file itself is
                # never re-read) — the pre-seal verification compares
                # against THIS
                try:
                    info = await self.store.stat_object(STAGING_BUCKET,
                                                        name)
                    manifest.note(name, size=info.size, etag=info.etag,
                                  file=file_path)
                except Exception as err:
                    # integrity is defense-in-depth: an unstattable
                    # backend degrades the verify for this file, never
                    # the upload
                    self.logger.warn("manifest stat after upload failed",
                                     file=basename, error=str(err))
                    manifest.note(name, size=size, etag="",
                                  file=file_path)
            await asyncio.to_thread(manifest.persist)
        if ctx.record is not None:
            # the put + manifest seal, as one egress hop (pacing sleeps
            # inside the limiter are part of the hop here: egress wall
            # is what the attribution answers for uploads)
            ctx.record.note_hop("upload", size,
                                time.monotonic() - upload_mark)
            ctx.record.add_bytes("uploaded", size)
            ctx.record.event(
                "upload_done", file=basename, bytes=size,
                seconds=round(time.monotonic() - started, 3),
            )
        if ctx.metrics is not None:
            ctx.metrics.bytes_uploaded.inc(size)
        return size

    async def verify_staged_set(self, media_id: str, files) -> None:
        """Manifest-vs-staged verification, run BEFORE the done marker.

        Re-stats every authoritative file's object against the per-job
        content manifest (size + store content hash recorded as each
        file landed).  Any divergence raises
        :class:`~.manifest.StagedSetMismatch` (transient: the
        redelivery re-stages), so a torn crash mid-upload can never
        seal a short or corrupt staging set under the marker the whole
        fleet trusts.  No-op when ``integrity.enabled`` is off.
        """
        manifest = await self.manifest_for(media_id)
        if manifest is None or not files:
            return
        from .manifest import StagedSetMismatch

        verify_mark = time.monotonic()
        try:
            verified, unverifiable = await manifest.verify_staged(
                self.store, STAGING_BUCKET, files, object_name
            )
        except StagedSetMismatch as err:
            if self.ctx.metrics is not None:
                self.ctx.metrics.manifest_mismatches.inc()
            if self.ctx.record is not None:
                self.ctx.record.event("manifest_mismatch",
                                      problems=len(err.problems))
            self.logger.error("staged set failed manifest verification",
                              problems=err.problems[:5])
            raise
        if unverifiable:
            self.logger.warn("staged objects unverifiable, sealing on "
                             "put success alone", count=unverifiable)
        if self.ctx.record is not None:
            self.ctx.record.note_hop("upload", 0,
                                     time.monotonic() - verify_mark)
            self.ctx.record.event("manifest_verified", files=verified,
                                  unverifiable=unverifiable)

    def _note_fenced_marker(self, media_id: str, fence: int,
                            newer: int) -> None:
        if self.ctx.metrics is not None:
            self.ctx.metrics.fleet_fenced_writes.labels(
                op="done_marker").inc()
        if self.ctx.record is not None:
            self.ctx.record.event("fenced_write", op="done_marker",
                                  fence=fence, newer=newer)
        self.logger.warn("done marker already sealed by a newer fence; "
                         "stale seal fenced off", mediaId=media_id,
                         fence=fence, newer=newer)

    async def write_done_marker(self, media_id: str) -> None:
        """Seal the staging set: the idempotency marker the orchestrator
        probes — written only once EVERY file is staged.

        Fenced (fleet-coordinated jobs only): the marker carries the
        job's lease fence, an existing higher-fenced marker suppresses
        the write entirely (a stale resumed leader must not re-seal a
        set a newer authority already published — the seal it finds IS
        the completion it wanted, so the job still settles DONE), and a
        read-back after the write detects losing to a concurrent newer
        seal.  Jobs without a fence context write the reference-parity
        ``b"true"`` byte-for-byte.
        """
        name = done_marker_name(media_id)
        record = self.ctx.record
        fence = int(getattr(record, "fleet_fence", 0) or 0) \
            if record is not None else 0
        worker = getattr(record, "worker_id", None) \
            if record is not None else None

        if fence:
            # pre-write fence check (best-effort: any read trouble just
            # proceeds to the write — the read-back still verifies)
            try:
                existing = parse_done_marker(await self.store.get_object(
                    STAGING_BUCKET, name))
            except Exception:
                existing = None
            if (existing is not None and existing["done"]
                    and existing["fence"] > fence):
                self._note_fenced_marker(media_id, fence,
                                         existing["fence"])
                return

        async def _seal():
            if faults.enabled():
                await faults.fire("store.put", key=name)
            await self.store.put_object(
                STAGING_BUCKET, name, done_marker_body(fence, worker))

        seal_mark = time.monotonic()
        await self.retrier.run("store.put", _seal, cancel=self.ctx.cancel,
                               record=self.ctx.record, logger=self.logger)
        if fence:
            # CAS-style read-verify, same posture as the coordination
            # store's nonce read-back: a concurrent newer-fenced seal
            # landing over ours is a lost race we must attribute (the
            # set IS sealed either way — by the newer authority)
            try:
                back = parse_done_marker(await self.store.get_object(
                    STAGING_BUCKET, name))
            except Exception:
                back = None
            if back is not None and back["fence"] > fence:
                self._note_fenced_marker(media_id, fence, back["fence"])
        if self.ctx.record is not None:
            self.ctx.record.note_hop("upload", 0,
                                     time.monotonic() - seal_mark)

    async def cleanup_workdir(self, download_path: str) -> None:
        """Best-effort download-dir removal (reference lib/upload.js:60-64)."""
        try:
            await asyncio.to_thread(shutil.rmtree, download_path)
        except OSError as err:
            self.logger.warn("failed to clean up directory", error=str(err))


async def stage_factory(ctx: StageContext) -> StageFn:
    logger = ctx.logger
    uploader = Uploader(ctx)
    downloading = schemas.TelemetryStatus.Value("DOWNLOADING")

    async def upload(job: Job):
        last = job.last_stage
        files = last["files"] if isinstance(last, dict) else last.files
        download_path = (
            last["downloadPath"] if isinstance(last, dict) else last.downloadPath
        )

        if not isinstance(files, list):
            raise TypeError(
                f"Invalid files data type, expected list, got {type(files).__name__!r}"
            )

        logger.info("starting file upload", count=len(files))
        media_id = job.media.id

        with ctx.tracer.span("stage.upload", mediaId=media_id, files=len(files)):
            await uploader.ensure_bucket()

            landed = getattr(job, "landed_digests", None) or {}
            for i, file_path in enumerate(files, start=1):
                # cooperative cancellation at the per-file loop: already
                # staged files stay staged (redelivery/resume semantics
                # are unchanged), the current file simply never starts
                await uploader.upload_file(
                    media_id, file_path,
                    digest=landed.get(os.path.abspath(file_path)))

                # upload occupies the 50-100% progress band
                # (reference lib/upload.js:48)
                percent = (i / len(files) * 50) + 50
                await ctx.telemetry.emit_progress(media_id, downloading, int(percent))

            # integrity gate: the marker seals only a verified set
            await uploader.verify_staged_set(media_id, files)
            await uploader.write_done_marker(media_id)

        logger.info("finished uploading all files")

        await uploader.cleanup_workdir(download_path)
        return {}

    return upload
