"""The stage plugin contract.

Reference contract: every stage module exports
``async (config, emitter, logger) => async (job) => result``
(upstream lib/download.js:30,230, lib/process.js:101-103,
lib/upload.js:14-17).  The orchestrator loads stages by name from the
``stages`` list, validates the factory returned a callable
(lib/main.js:99-115), and threads each result to the next stage as
``job.lastStage`` (lib/main.js:129-140).

Differences from the reference, per SURVEY.md §7 step 6 (bug fixes):
- telemetry is an explicit ``StageContext`` field, not a ``global.telem``
- the tracer is threaded through and actually used

Streaming hand-off (beyond reference): alongside the ``last_stage``
barrier contract, a job may carry a :class:`FileStream` — the download
stage announces each durably-complete file into it (``FileEvent``) the
moment its bytes are final, so the streaming pipeline
(stages/streaming.py) can filter and upload that file while later files
are still downloading.  Stages that ignore ``job.file_stream`` keep
working unchanged: the pipeline reconciles against the authoritative
directory walk when the download completes.
"""

from __future__ import annotations

import asyncio
import dataclasses
import importlib
import os
from typing import Any, Awaitable, Callable, Dict, Optional

from .. import schemas
from ..control.cancel import CancelToken
from ..platform.logging import Logger
from ..platform.telemetry import NullTelemetry, Telemetry
from ..platform.tracing import NullTracer, Tracer
from ..utils import EventEmitter

# Fixed stage order (reference lib/main.js:28-32).
STAGES = ["download", "process", "upload"]


@dataclasses.dataclass
class FileEvent:
    """One durably-complete file, announced by the download stage while the
    rest of the job may still be transferring.

    "Durable" means the file's bytes are final on disk: torrent files whose
    every overlapping piece is SHA-1-verified and written, HTTP downloads at
    promote time (``.partial`` renamed onto the output name), bucket objects
    after their ``fget`` completes.  Downstream consumers (the streaming
    pipeline's filter + upload pool) may read the file immediately.
    """

    path: str
    size: int = 0


class FileStream:
    """Bounded hand-off channel from the download stage to the streaming
    pipeline (stages/streaming.py).

    ``emit`` applies backpressure when the consumer lags (the producer's
    transfer loop slows instead of buffering unboundedly) and becomes a
    no-op once the stream is closed, so late announcements — e.g. from a
    source that keeps calling back after the consumer gave up — never
    error the producer.  ``next`` returns ``None`` when the stream is
    closed and drained.
    """

    _SENTINEL = object()

    def __init__(self, maxsize: int = 1024):
        self._queue: asyncio.Queue = asyncio.Queue(maxsize)
        self._closed = False

    @property
    def closed(self) -> bool:
        return self._closed

    async def emit(self, path: str, size: Optional[int] = None) -> None:
        if self._closed:
            return
        if size is None:
            try:
                size = os.path.getsize(path)
            except OSError:
                size = 0
        await self._queue.put(FileEvent(path=path, size=int(size)))

    async def close(self) -> None:
        """Append the end-of-stream sentinel (idempotent)."""
        if self._closed:
            return
        self._closed = True
        await self._queue.put(self._SENTINEL)

    async def next(self) -> Optional[FileEvent]:
        """Next event, or None once the stream is closed and drained."""
        item = await self._queue.get()
        if item is self._SENTINEL:
            # keep the sentinel visible for any other reader
            self._queue.put_nowait(self._SENTINEL)
            return None
        return item


@dataclasses.dataclass
class Job:
    """What a stage receives: the decoded message plus the previous stage's
    result (reference ``_.create(msg, {lastStage})``, lib/main.js:131-133)."""

    media: schemas.Media
    last_stage: Any = None
    # set by the download stage while this job LEADS a singleflight fetch
    # (store/cache.py): a ``report(percent)`` callable whose updates are
    # re-emitted through each coalesced waiter's own telemetry
    cache_report: Any = None
    # streaming hand-off (stages/streaming.py): when the orchestrator runs
    # the pipelined dispatch it sets a FileStream here, and the download
    # stage announces each durably-complete file into it the moment its
    # bytes are final — None (barrier mode / standalone stage use) keeps
    # the exact pre-streaming behavior
    file_stream: Optional[FileStream] = None
    # origin plane (downloader_tpu_torch/origins/): redundant origins for the
    # SAME entity from Download.mirrors — http(s) URLs the racing fetch
    # spreads ranges across (or extra webseeds for a torrent source).
    # Empty = the exact single-origin behavior.
    mirrors: tuple = ()
    # Download.source_kind as an enum NAME ("AUTO" | "DIRECT" |
    # "MANIFEST"): MANIFEST ingests an http(s) source_uri as an
    # HLS-style media playlist; AUTO/DIRECT keep the historical
    # whole-entity dispatch on Media.source.
    source_kind: str = "AUTO"
    # cache-hit serving (stages/download.py materialize_hit): the
    # absolute paths the cache entry materialized into the workdir, so
    # the process stage (and the streaming pipeline's authoritative
    # reconcile) can serve straight from the known list instead of
    # re-walking the directory tree.  None = not served from cache;
    # downstream walks as before.
    cache_files: Optional[list] = None
    # hash-on-land (stages/download.py): ``{abspath: md5_hex}`` for files
    # whose content digest was computed while their bytes were still hot
    # in the page cache, at the landing/promote moment.  The upload stage
    # passes these through to the store and the staged manifest so no
    # later step has to re-read a staged file just to hash it.  Empty =
    # no digest known; downstream falls back to stat-side hashing.
    landed_digests: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class StageContext:
    """Everything a stage factory may need.

    ``config``/``emitter``/``logger`` mirror the reference factory args;
    the rest replaces its globals and module-level singletons.
    """

    config: Any
    emitter: EventEmitter
    logger: Logger
    telemetry: Telemetry = dataclasses.field(default_factory=NullTelemetry)
    metrics: Any = None
    store: Any = None
    tracer: Tracer = dataclasses.field(default_factory=NullTracer)
    # Optional override for the download stage's ad-hoc ``bucket://`` client
    # (tests inject a fake; default builds an S3 client).
    bucket_client_factory: Optional[Callable] = None
    # Cross-job shared state: the orchestrator passes the SAME dict/list to
    # every job's context, so stages can memoize long-lived resources (e.g.
    # the download stage's DHT node) and register async teardown callables
    # that run once at orchestrator shutdown.
    resources: dict = dataclasses.field(default_factory=dict)
    cleanups: list = dataclasses.field(default_factory=list)
    # Cooperative cancellation (control/cancel.py): the orchestrator
    # passes the job's token; stages check it in their chunk/file loops
    # (``ctx.cancel.raise_if_cancelled()``).  Standalone stage use gets a
    # fresh never-fired token, so the checks are always safe to call.
    cancel: CancelToken = dataclasses.field(default_factory=CancelToken)
    # The job's control-plane registry record (control/registry.py), for
    # byte-counter sampling (``record.add_bytes``); None outside the
    # orchestrator.
    record: Any = None
    # The job's run-slot handle (control/scheduler.py RunSlot): lets a
    # stage that parks for a long idle wait — the fleet plane's lease
    # waiters — give the concurrency slot back to runnable jobs and
    # reacquire it before resuming.  None outside the orchestrator.
    slot: Any = None

StageFn = Callable[[Job], Awaitable[Any]]
StageFactory = Callable[[StageContext], Awaitable[StageFn]]

_REGISTRY: Dict[str, str] = {
    "download": "downloader_tpu_torch.stages.download",
    "process": "downloader_tpu_torch.stages.process",
    "upload": "downloader_tpu_torch.stages.upload",
    # built-in but not in the default STAGES order: config-gated via
    # ``instance.upscale.enabled`` (see app.py / stages/upscale.py)
    "upscale": "downloader_tpu_torch.stages.upscale",
}


def register_stage(name: str, module: str) -> None:
    """Register an out-of-tree stage module (must expose ``stage_factory``)."""
    _REGISTRY[name] = module


def get_stage_factory(name: str) -> StageFactory:
    """Resolve a stage name to its factory.

    Mirrors the reference's dynamic ``require(path.join(__dirname,
    `${stage}.js`))`` loading (lib/main.js:101-106).
    """
    try:
        module_name = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown stage {name!r}; known: {sorted(_REGISTRY)}") from None
    module = importlib.import_module(module_name)
    return module.stage_factory


async def load_stages(ctx: StageContext, names: Optional[list] = None) -> Dict[str, StageFn]:
    """Instantiate each stage and validate the contract
    (reference lib/main.js:99-115)."""
    table: Dict[str, StageFn] = {}
    for name in names or STAGES:
        factory = get_stage_factory(name)
        fn = await factory(ctx)
        if not callable(fn):
            raise TypeError(
                f"Invalid stage {name!r}: factory return value was not callable"
            )
        table[name] = fn
    return table
