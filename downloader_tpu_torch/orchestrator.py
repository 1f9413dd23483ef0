"""Job orchestrator: consume download jobs, run the stage pipeline, publish
convert jobs.

Capability-equivalent to upstream lib/main.js:40-205:

- consumes ``v1.download`` (lib/main.js:172), decodes protobuf ``Download``
  (lib/main.js:63)
- emits status ``DOWNLOADING`` (=2) on receipt (lib/main.js:68)
- tracks active jobs for the health endpoint (lib/main.js:70-73) — with the
  reference's ``activeJobs.slice`` no-op bug fixed (lib/main.js:169; see
  SURVEY.md §7 step 6): completed jobs are actually removed here
- per-job EventEmitter registered in an emitter table (lib/main.js:26,81)
- loads the stage plugins dynamically by name and validates the contract
  (lib/main.js:99-115)
- idempotency probe against ``triton-staging/<jobId>/original/done``
  (lib/main.js:119-124): if present, skip the stages but still publish the
  convert message (lib/main.js:153-167)
- sequential stage loop threading ``last_stage`` (lib/main.js:126-140)
- error policy: ``ERRDLSTALL`` -> ack (drop job) (lib/main.js:144-146);
  any other stage error -> status ``ERRORED`` (=6) + nack for redelivery
  (lib/main.js:148-150)
- publishes protobuf ``Convert`` to ``v1.convert`` then acks
  (lib/main.js:157-168)
"""

from __future__ import annotations

import asyncio
import os
import shutil
import time
import uuid
from datetime import datetime, timezone
from typing import Dict, List, Optional

from . import control, schemas
from .control.cancel import CancelToken, JobCancelled
from .control.journal import JobJournal, recovery_counters
from .control.registry import JobRecord, JobRegistry
from .control.overload import OverloadController
from .control.scheduler import (PriorityScheduler, RunSlot,
                                aging_from_config, backlog_from_config,
                                priority_name, priority_rank)
from .control.slo import SloTracker
from .control.tenancy import TenantTable
from .fleet.controller import PlacementController
from .fleet.plane import FleetPlane, resolve_worker_id
from .fleet.router import ContentRouter, route_key_for
from .incident.bundle import TRIGGER_BREACH, IncidentStore, build_bundle
from .mq.base import Delivery, MessageQueue
from .platform import faults
from .platform.config import cfg_get
from .platform.errors import (OPEN_DISK, PERMANENT, POISON, BreakerBoard,
                              Retrier, classify)
from .platform.faults import FaultInjector
from .platform.logging import Logger, get_logger
from .platform.metrics import Metrics
from .platform.obs import (DEFAULT_EVENT_LIMIT, DEFAULT_LAG_INTERVAL,
                           DEFAULT_PROFILE_INTERVAL, LoopLagMonitor,
                           TransferProfiler)
from .platform.telemetry import NullTelemetry, Telemetry
from .platform.tracing import (NullTracer, Tracer, format_traceparent,
                               parse_traceparent)
from .stages.base import STAGES, Job, StageContext, load_stages
from .stages.download import job_download_dir
from .stages.streaming import (PIPELINE_STAGE, pipeline_mode,
                               run_streaming_job)
from .stages.upload import STAGING_BUCKET, done_marker_name
from .store.base import ObjectNotFound, ObjectStore
from .store.cache import ContentCache
from .store.scrub import Scrubber, verify_landed
from .utils import EventEmitter, utcnow_iso as _utcnow_iso


def _submission_age_seconds(created_at: str) -> float:
    """Seconds since the submitter stamped ``Download.created_at``.

    Anchors ``ttl_seconds`` to the SUBMISSION, not this delivery's
    receipt: a shed/parked/nacked BULK job keeps the same created_at on
    every redelivery, so its deadline genuinely elapses instead of
    resetting each cycle.  Absent/unparseable stamps (and clock skew
    that would make the age negative) anchor at receipt — the
    conservative pre-anchoring behavior.
    """
    if not created_at:
        return 0.0
    try:
        stamp = datetime.fromisoformat(created_at.replace("Z", "+00:00"))
        if stamp.tzinfo is None:
            stamp = stamp.replace(tzinfo=timezone.utc)
        return max(
            (datetime.now(timezone.utc) - stamp).total_seconds(), 0.0
        )
    except ValueError:
        return 0.0


class _RecordingTelemetry:
    """Per-job telemetry facade: forwards to the real client while
    sampling progress percent into the job's registry record, so
    ``GET /v1/jobs/{id}`` shows live progress without a new event path."""

    def __init__(self, inner: Telemetry, record: JobRecord):
        self._inner = inner
        self._record = record

    async def emit_status(self, media_id: str, status: int) -> None:
        await self._inner.emit_status(media_id, status)

    async def emit_progress(self, media_id: str, status: int,
                            percent: int) -> None:
        if media_id == self._record.job_id:
            self._record.note_progress(percent)
        await self._inner.emit_progress(media_id, status, percent)


class Orchestrator:
    def __init__(
        self,
        config,
        mq: MessageQueue,
        store: ObjectStore,
        telemetry: Optional[Telemetry] = None,
        metrics: Optional[Metrics] = None,
        tracer: Optional[Tracer] = None,
        logger: Optional[Logger] = None,
        stages: Optional[List[str]] = None,
        prefetch: Optional[int] = None,
        poison_threshold: int = 5,
        cache: Optional[ContentCache] = None,
        admission_timeout: float = 30.0,
        fleet: Optional[FleetPlane] = None,
        worker_id: Optional[str] = None,
    ):
        self.config = config
        self.mq = mq
        self.store = store
        self.telemetry = telemetry or NullTelemetry()
        self.metrics = metrics
        self.tracer = tracer or NullTracer()
        # worker identity (fleet/plane.py): bound into the ROOT logger
        # context — every log line this orchestrator (and its per-job
        # child loggers) emits carries workerId, so a fleet's merged
        # log stream joins on (traceId, workerId)
        self.worker_id = worker_id or resolve_worker_id(config)
        self.logger = (logger or get_logger("orchestrator")).child(
            workerId=self.worker_id
        )
        self.stage_names = stages or list(STAGES)
        # Consumer prefetch = max concurrently-processed jobs, now
        # configurable (MAX_CONCURRENT_JOBS / instance.max_concurrent_jobs)
        # instead of hardcoded.  The default of 2 resolves BASELINE.md's
        # ``new AMQP(addr, 1, 2, prom)`` question (lib/main.js:46):
        # triton-core's AMQP signature is (host, connections, prefetch,
        # prom) — one connection (we likewise hold one job connection;
        # telemetry rides its own, app.py), and a consumer prefetch of 2:
        # up to two deliveries in flight, processed CONCURRENTLY (both
        # backends dispatch one handler task per delivery), matching the
        # reference's async consumer behavior under the same qos.  See
        # PARITY.md "AMQP constructor constants".  Fan-in deployments
        # raise it: with the content cache, same-content jobs coalesce
        # onto one fetch, so extra in-flight jobs are nearly free.
        if prefetch is None:
            raw = os.environ.get("MAX_CONCURRENT_JOBS") or cfg_get(
                config, "instance.max_concurrent_jobs", 2
            )
            try:
                prefetch = int(raw)
            except (TypeError, ValueError):
                raise ValueError(
                    f"max_concurrent_jobs must be an integer, got {raw!r}"
                ) from None
        if prefetch < 1:
            raise ValueError(f"max_concurrent_jobs must be >= 1, got {prefetch}")
        self.prefetch = prefetch

        # stage dispatch mode (stages/streaming.py): "streaming" (the
        # default) overlaps download/filter/upload per file for the
        # standard three-stage chain; "barrier" (instance.pipeline /
        # PIPELINE_MODE) keeps the exact sequential stage loop.  Custom
        # stage chains (e.g. the config-gated upscale stage) always run
        # the barrier loop — the streaming runner models only the
        # default download -> process -> upload topology.
        self.pipeline_mode = pipeline_mode(config)
        self.streaming_enabled = (
            self.pipeline_mode == "streaming"
            and self.stage_names == list(STAGES)
        )

        # control plane (control/): every delivery is registered at
        # receipt and steered through the lifecycle state machine;
        # admitted jobs take a run slot from the priority scheduler.
        # scheduler_backlog > 0 widens the consumer prefetch past the run
        # slots so the scheduler has deliveries to reorder (default 0 =
        # exact pre-control-plane behavior).
        # crash-safe durability (control/journal.py): an append-only
        # journal under the work dir records lifecycle transitions,
        # settle modes, and retry counters, and start() replays it —
        # so a SIGKILL costs at most one in-flight attempt's incremental
        # work, never the retry schedule and never disk.
        self._download_root = os.path.dirname(
            job_download_dir(config, "_probe")
        )
        self.journal = JobJournal.from_config(
            config, self._download_root, logger=self.logger
        )
        # populated by start()'s reconciliation: the /readyz "recovery"
        # block + the jobs_recovered_total attribution
        self.recovery: Optional[dict] = None
        # job_id -> {"cancelled": bool, "reason": str} for recovered jobs
        # whose redelivery has not arrived yet (the replay window)
        self._recovered: Dict[str, dict] = {}
        self._recovery_watchers: List[asyncio.Task] = []
        # fleet-settled placeholder reconciliation (the soak harness
        # flushed this out): in a multi-worker fleet, a killed worker's
        # unacked delivery is redelivered to a PEER — the restarted
        # worker's recovery placeholder then waits for a redelivery
        # that will NEVER arrive (the peer acked it), parking a ghost
        # record and keeping its "resumable" workdir until
        # journal.tombstone_ttl (a day).  This loop probes the durable
        # done marker for waiting placeholders every
        # ``journal.staged_probe_interval`` seconds (0 = off) and
        # retires the already-staged ones DONE, sweeping their workdirs.
        self._staged_probe_interval = float(cfg_get(
            config, "journal.staged_probe_interval", 30.0))
        self._staged_probe_task: Optional[asyncio.Task] = None
        # detached per-job trace-digest publishes (fleet/plane.py
        # publish_telemetry): fired after settle so a coordination-store
        # round trip never delays an ack; drained at shutdown
        self._telemetry_tasks: "set[asyncio.Task]" = set()
        self.registry = JobRegistry(
            metrics=metrics, logger=self.logger,
            recorder_events=int(cfg_get(
                config, "obs.recorder_events", DEFAULT_EVENT_LIMIT
            )),
            worker_id=self.worker_id,
            journal=self.journal,
            # per-hop transfer attribution (platform/obs.py HopLedger):
            # on by default, `obs.hop_ledger: false` is the bench A-B leg
            hop_ledger=bool(cfg_get(config, "obs.hop_ledger", True)),
        )
        # runtime introspection (platform/obs.py): loop-lag sampling
        # into /metrics, and the transfer profiler feeding throughput /
        # stall_suspect events into each RUNNING job's flight recorder
        self.loop_monitor = LoopLagMonitor(
            metrics=metrics, logger=self.logger,
            interval=float(cfg_get(
                config, "obs.loop_lag_interval", DEFAULT_LAG_INTERVAL
            )),
        )
        self.profiler = TransferProfiler(
            self.registry, logger=self.logger,
            interval=float(cfg_get(
                config, "obs.profile_interval", DEFAULT_PROFILE_INTERVAL
            )),
        )
        # multi-tenant overload control (control/tenancy.py +
        # control/overload.py): the tenant table resolves
        # ``Download.tenant`` and holds per-tenant weights / concurrency
        # caps / byte quotas; the scheduler apportions run slots across
        # tenants by weighted-fair stride within each priority class.
        # With no ``tenants`` config every delivery is the "default"
        # tenant and the scheduler behaves exactly as before.
        self.tenants = TenantTable(config, logger=self.logger)
        # in-process SLO accounting (control/slo.py, ``slo.*``): every
        # settled delivery classified against its priority class's (and
        # optionally its tenant's) time-to-staged objective; burn rates
        # and error-budget remaining ride /metrics, /readyz, and the
        # fleet heartbeat digest.  None = ``slo.enabled: false``.
        self.slo = SloTracker.from_config(
            config, tenant_names=self.tenants.names())
        self.scheduler = PriorityScheduler(
            prefetch, aging_seconds=aging_from_config(config),
            tenants=self.tenants,
        )
        self.consumer_prefetch = prefetch + backlog_from_config(config)
        # intake pause (POST /v1/intake/pause | /v1/drain): stop pulling
        # deliveries without dropping in-flight work; /readyz -> 503
        self.intake_paused = False
        # telemetry status emitted for a cancelled job: CANCELLED (=7) by
        # default; config `control.errored_on_cancel: true` keeps legacy
        # consumers that only know the reference's enum range on ERRORED
        self._cancel_status = schemas.TelemetryStatus.Value(
            "ERRORED"
            if cfg_get(config, "control.errored_on_cancel", False)
            else "CANCELLED"
        )

        # content-addressed staging cache (store/cache.py): shared with
        # the download stage via stage_resources, consulted by the
        # admission gate below.  None = disabled (the config default).
        self.cache = cache if cache is not None else ContentCache.from_config(
            config, logger=self.logger
        )
        if self.cache is not None and metrics is not None:
            self.cache.metrics = metrics
        # how long admission may hold a job waiting for cache-volume disk
        # headroom before letting it proceed (the download stage's own
        # ensure_disk_space preflight still fails loudly if truly full)
        self.admission_timeout = admission_timeout
        # disk-full graceful degradation: the cache's
        # min_free_bytes discipline extended to the WORKDIR volume —
        # ``download.min_free_bytes`` is the free-space floor admission
        # holds for, ``download.reserve_bytes`` a per-job preflight
        # reservation on top of it.  Both default 0 = off (exactly the
        # prior behavior).  A deadline-forced admission that still
        # fails the workdir floor force-opens the store breaker with
        # the ``disk`` reason (surfaced on /readyz + the fleet
        # overview), because eviction cannot reclaim workdir space.
        self.workdir_min_free = int(cfg_get(
            config, "download.min_free_bytes", 0))
        self.workdir_reserve = int(cfg_get(
            config, "download.reserve_bytes", 0))

        # (reference EmitterTable / activeJobs, lib/main.js:26,34)
        self.emitter_table: Dict[str, EventEmitter] = {}
        self.active_jobs: List[dict] = []

        # shared across every job's StageContext: stage-memoized resources
        # (e.g. the download stage's long-lived DHT node) and their
        # teardown callables, run once at shutdown
        self.stage_resources: dict = {}
        self.stage_cleanups: list = []
        # the download stage probes/fills the same cache instance the
        # admission gate watches (None = disabled; the stage respects it)
        self.stage_resources["content_cache"] = self.cache

        # poison-job guard: the reference nacks failed jobs forever
        # (lib/main.js:148-150), which on RabbitMQ without a dead-letter
        # policy hot-loops a deterministically-failing job at the head of
        # the queue.  After this many failures of one job in this process,
        # drop it (ack + ERRORED) instead of redelivering.  0 disables.
        self.poison_threshold = poison_threshold
        self._failure_counts: Dict[str, int] = {}

        # dependency fault tolerance (platform/errors.py): per-dependency
        # circuit breakers consulted at admission (an open staging-store
        # or convert-publish breaker parks intake instead of burning the
        # poison budget) and a retry executor shared with the stages via
        # stage_resources, so every seam — store puts, the idempotency
        # probe, convert publish, HTTP fetch — rides the same
        # config-driven policies (``retry.<dependency>`` /
        # ``breakers.<dependency>``).
        self.breakers = BreakerBoard(config, metrics=metrics,
                                     logger=self.logger)
        self.retrier = Retrier(config, breakers=self.breakers,
                               metrics=metrics, logger=self.logger)
        self.stage_resources["retrier"] = self.retrier

        # fleet coordination plane (fleet/): worker registry heartbeats,
        # lease-based cross-worker singleflight, and the shared cache
        # tier.  None (the default) = single-worker posture, zero cost.
        # The download stage consults the plane through stage_resources
        # before any origin fetch; the registry handle lets it park a
        # lease-waiting job in the control plane's PARKED state.
        # the shared per-origin throughput table, created eagerly so the
        # fleet plane can share it and boot seeding has a target before
        # the first download stage runs (origins/plan.py lazily shares
        # the same instance through stage_resources)
        from .origins.plan import OriginHealth
        self.origin_health = OriginHealth.shared(self.stage_resources,
                                                 config)
        self.fleet = fleet if fleet is not None else FleetPlane.from_config(
            config, worker_id=self.worker_id, store=store,
            metrics=metrics, logger=self.logger, retrier=self.retrier,
            payload_fn=self.autoscale_signals,
            digest_fn=self.slo_digest,
            origin_fn=self.origin_health.snapshot,
        )
        if self.fleet is not None and self.fleet.payload_fn is None:
            # a plane built by hand (tests/bench) still heartbeats the
            # autoscale trio once an orchestrator adopts it
            self.fleet.payload_fn = self.autoscale_signals
        if self.fleet is not None and self.fleet.digest_fn is None:
            # same adoption for the SLO/health digest the fleet
            # overview aggregates
            self.fleet.digest_fn = self.slo_digest
        if self.fleet is not None and self.fleet.origin_fn is None:
            # and for the fleet-shared origin-health table
            self.fleet.origin_fn = self.origin_health.snapshot
        self.stage_resources["fleet_plane"] = self.fleet
        # fleet data plane v2: the content router steers
        # same-content deliveries to the current lease holder at
        # admission, and the elected placement controller closes the
        # overview->plan loop.  Both are None without a fleet — the
        # lone-worker admission path is untouched.
        self.router = ContentRouter.from_config(
            config, self.fleet, self.tenants,
            metrics=metrics, logger=self.logger,
        )
        self.controller = PlacementController.from_config(
            config, self.fleet, metrics=metrics, logger=self.logger,
        )
        # incident plane: bounded ring of exported forensic
        # bundles, fed by auto-export when a settle burns error budget
        # and by the admin API/CLI on demand.  None (``incident.enabled:
        # false``) keeps the settle path exactly as before.
        self.incidents = IncidentStore.from_config(
            config, metrics=metrics, logger=self.logger,
        )
        self.stage_resources["job_registry"] = self.registry
        # the stages stack each job's per-tenant byte quota under the
        # service-wide rate limiter through this shared table
        self.stage_resources["tenant_table"] = self.tenants
        # saturation-aware shedding (control/overload.py): samples the
        # autoscale trio + event-loop lag; while saturated, BULK
        # deliveries are parked+nacked at admission (never FAILED, never
        # charged poison) so HIGH/NORMAL time-to-staged survives the
        # worker's own overload.  ``overload.enabled: false`` removes it.
        self.overload = OverloadController.from_config(
            config, self.autoscale_signals,
            lambda: getattr(self.loop_monitor, "last_lag", None),
            metrics=metrics, logger=self.logger,
        )
        # integrity scrubber (store/scrub.py): rate-limited background
        # re-hash of cache entries, co-located shared-tier objects, and
        # staged workdir outputs against their landing digests —
        # repairing from healthy replicas (always into a fresh inode)
        # and quarantining the rest.  ``scrub.enabled: false`` removes
        # it; its cumulative verdicts ride the SLO digest onto the
        # fleet overview.
        self.scrubber = Scrubber.from_config(
            config, cache=self.cache, fleet=self.fleet,
            workdir_root=self._download_root,
            metrics=metrics, logger=self.logger,
        )
        # autoscale signal trio on /metrics: the same snapshot the fleet
        # heartbeat carries (ROADMAP item 5's fleet-facing contract)
        if metrics is not None:
            metrics.bind_autoscale(self.autoscale_signals)
            metrics.bind_tenants(self.tenants.names(),
                                 self.registry.tenant_queue_depths)
            if self.slo is not None:
                # slo_burn_rate{class,window} + slo_error_budget_
                # remaining{class}: the live SLO plane on /metrics
                metrics.bind_slo(self.slo)
            if self.fleet is not None:
                # overview staleness: steady state must sit under 2x
                # the heartbeat interval (bench v20 guards it)
                metrics.bind_overview_age(self.fleet.overview_age)
            # per-tenant staging *footprint* (ROADMAP item 5 remaining
            # depth): live workdir bytes per tenant — quotas today cover
            # transfer rate; this gauge is the disk-accounting half
            # (observability only, no enforcement yet)
            metrics.bind_tenant_staging(self.tenants.names(),
                                        self.tenant_staging_bytes)
            if self.journal is not None:
                # journal growth gauges (journal_bytes/journal_lines):
                # the bounded-growth signal the soak harness guards —
                # compaction must hold the file O(live jobs)
                metrics.bind_journal(self.journal)
        self._staging_memo = {"at": 0.0, "snap": None, "busy": False}
        # the dependencies whose open breaker pauses intake: everything a
        # job needs to SETTLE (staging writes + convert publish) — origin
        # fetch trouble stays per-job (a broken origin is one job's
        # problem, not the fleet's)
        self.admission_dependencies = ("store", "publish")
        # delayed redelivery (park-then-nack): a transiently-failed
        # delivery holds its unsettled slot for an exponentially-growing
        # pause before the nack, replacing the reference's instant-nack
        # hot loop.  ``retry.redelivery.base: 0`` restores instant nacks.
        self._redeliver_base = float(
            cfg_get(config, "retry.redelivery.base", 0.25)
        )
        self._redeliver_cap = float(
            cfg_get(config, "retry.redelivery.cap", 15.0)
        )

        # deterministic fault injection (platform/faults.py): installed
        # from ``faults.plan`` / env FAULT_PLAN for chaos drills; None —
        # the production default — keeps every seam's hook a no-op.
        self._fault_injector = FaultInjector.from_config(
            config, logger=self.logger
        )
        if self._fault_injector is not None:
            faults.install(self._fault_injector)

        # readiness: True between a successful start() and shutdown()
        # (surfaced by /readyz, health.py)
        self.consuming = False

    # ------------------------------------------------------------------
    async def start(self) -> None:
        """Connect and begin consuming (reference lib/main.js:47,172)."""
        # reconcile BEFORE the first delivery can arrive: redeliveries
        # must find their restored retry counters and their placeholder
        # records already in place
        await self._recover()
        await self.mq.connect()
        await self.telemetry.connect()
        # route Convert through a fanout exchange bound to the canonical
        # queue where the backend supports it: the downstream converter
        # consumes the same queue as before, and observers (submit --wait)
        # can tap completion events without stealing deliveries
        try:
            await self.mq.bind_queue(
                schemas.CONVERT_QUEUE, schemas.CONVERT_EXCHANGE
            )
            self._convert_fanout = True
        except NotImplementedError:
            self._convert_fanout = False
        await self.mq.listen(
            schemas.DOWNLOAD_QUEUE, self.processor,
            prefetch=self.consumer_prefetch,
        )
        self.consuming = True
        self.loop_monitor.start()
        self.profiler.start()
        if (self.journal is not None
                and self._staged_probe_interval > 0):
            self._staged_probe_task = asyncio.get_running_loop() \
                .create_task(self._staged_probe_loop())
        if self.overload is not None:
            self.overload.start()
        if self.scrubber is not None:
            self.scrubber.start()
        if self.fleet is not None:
            # join the fleet LAST: by the time peers can route around or
            # toward this worker, it is actually consuming
            await self.fleet.start()
            self.logger.info("joined fleet", workerId=self.worker_id)
            # cold-start head start: seed the local origin
            # throughput table from the fleet-shared rows, so the first
            # racing fetch starts from the fleet's observed rates
            # instead of zero.  Best-effort: one bounded read, and any
            # trouble boots cold exactly as before.
            try:
                rows = await self.fleet.fetch_origin_health()
                if rows:
                    seeded = self.origin_health.seed(rows)
                    if seeded:
                        self.logger.info(
                            "seeded origin health from fleet",
                            labels=seeded)
            except asyncio.CancelledError:
                raise
            except Exception as err:
                self.logger.warn("origin-health boot seed failed",
                                 error=str(err)[:200])
            if self.controller is not None:
                # the placement controller only ever acts when this
                # worker wins the election, so every worker starts it
                self.controller.start()
        self.logger.info("successfully connected to queue")

    def _workdir_free_bytes(self) -> Optional[int]:
        """Free bytes on the workdir (download-root) volume, probed at
        the deepest existing ancestor; None when unprobeable — the
        disk gates then stand down rather than block on a blind
        spot."""
        from .utils.disk import free_bytes

        path = self._download_root
        while path and not os.path.isdir(path):
            parent = os.path.dirname(path)
            if parent == path:
                break
            path = parent
        try:
            return free_bytes(path or os.sep)
        except OSError:
            return None

    # -- autoscale signals ----------------------------------------------
    def autoscale_signals(self) -> dict:
        """The scale-out/scale-down trio, one snapshot for BOTH surfaces
        (/metrics gauges and the fleet heartbeat payload): queue depth,
        oldest-queued-job age, and disk headroom on the volumes jobs
        land on (the TIGHTER of cache and workdir volumes when
        caching, the download volume otherwise).
        """
        depth, oldest = self.registry.queued_snapshot()
        workdir_free = self._workdir_free_bytes()
        if self.cache is not None:
            # tightest volume wins: the cache may live on a different
            # volume than the workdirs, and a full WORKDIR volume kills
            # jobs just as surely (the overload controller's
            # disk_headroom shed watches exactly this signal)
            headroom = self.cache.free_disk_bytes()
            if workdir_free is not None:
                headroom = min(headroom, workdir_free)
        else:
            headroom = workdir_free if workdir_free is not None else 0
        return {
            "queue_depth": depth,
            "oldest_queued_seconds": round(oldest, 3),
            "cache_headroom_bytes": headroom,
            "active_jobs": len(self.active_jobs),
        }

    def slo_digest(self) -> dict:
        """The compact SLO/health digest the fleet heartbeat carries
        (fleet/plane.py ``digest_fn``): burn rates + budgets per
        objective, open breakers with reasons, per-hop totals (the
        overview's top-hops + mixed-phase reconcile ratio), and this
        worker's per-tenant queue depths — the fleet-wide tenant
        fairness view is aggregated from exactly these
        (``build_overview``).  Sync and cheap: the SLO snapshot is
        memoized, the rest are dict reads."""
        digest = self.slo.digest() if self.slo is not None else {}
        breakers = getattr(self, "breakers", None)
        if breakers is not None:
            states = breakers.states()
            reasons = breakers.open_reasons()
            open_breakers = {
                dependency: {"state": state,
                             "reason": reasons.get(dependency)}
                for dependency, state in states.items()
                if state != "closed"
            }
            if open_breakers:
                digest["openBreakers"] = open_breakers
        queued = self.registry.tenant_queue_depths()
        if queued:
            digest["tenantQueued"] = queued
        router = getattr(self, "router", None)
        if router is not None and router.last is not None:
            # this worker's last routing action (defer/shed/fairness):
            # the DECISION column on the overview doc / `fleet top`
            digest["lastDecision"] = dict(router.last)
        scrubber = getattr(self, "scrubber", None)
        if scrubber is not None:
            # cumulative scrub verdicts: build_overview sums these
            # fleet-wide (repaired/quarantined climbing = a disk going
            # bad somewhere in the fleet)
            digest["scrub"] = scrubber.snapshot()
        return digest

    async def assemble_trace(self, trace_id: str,
                             remote: bool = True) -> dict:
        """The cross-worker timeline for one trace id (``GET
        /v1/trace/{id}``): local registry segments + tracer spans,
        joined with peer workers' coordination-store digests and live
        admin APIs (control/trace.py).  Coordination trouble degrades
        to the local-only view — never an error."""
        from .control.trace import assemble

        return await assemble(self, trace_id, remote=remote)

    def tenant_staging_bytes(self) -> Dict[str, int]:
        """Live per-tenant staging footprint: bytes on disk under each
        non-terminal job's workdir, attributed to the job's tenant.

        Fed to the ``tenant_staging_bytes`` gauges and ``GET
        /v1/tenants`` — the disk half of per-tenant accounting (quotas
        cover transfer rate only; this is observability, not
        enforcement).  Stale-while-revalidate: callers are sync gauge
        callbacks on the event loop, and the walk stats real workdirs
        (a large torrent is tens of thousands of files — inline it
        would be exactly the loop stall the OverloadController sheds
        on), so a stale snapshot answers immediately and the re-walk
        runs on the executor.  The first call returns ``{}``.
        """
        now = time.monotonic()
        memo = self._staging_memo
        stale = memo["snap"] is None or now - memo["at"] >= 5.0
        if stale and not memo["busy"]:
            memo["busy"] = True
            # capture (job_id, tenant) on the loop side: the walk thread
            # must not touch live registry records
            jobs = []
            seen: set = set()
            for record in self.registry.jobs():
                if record.terminal or record.job_id in seen:
                    continue
                seen.add(record.job_id)
                jobs.append((record.job_id, record.tenant))

            from .utils.disk import dir_bytes

            def _walk() -> None:
                out: Dict[str, int] = {}
                try:
                    for job_id, tenant in jobs:
                        size = dir_bytes(
                            job_download_dir(self.config, job_id))
                        if size:
                            out[tenant] = out.get(tenant, 0) + size
                    memo["snap"] = out
                    memo["at"] = time.monotonic()
                finally:
                    memo["busy"] = False

            try:
                asyncio.get_running_loop().run_in_executor(None, _walk)
            except RuntimeError:
                # no loop (direct sync use in tests): walk inline
                _walk()
        return memo["snap"] or {}

    # -- crash recovery (control/journal.py) ----------------------------
    async def _recover(self) -> None:
        """Startup reconciliation: replay the journal, restore retry
        schedules, open PARKED placeholders for jobs whose redelivery is
        still coming, sweep orphan workdirs, and release any content
        leases a previous incarnation of this worker died holding.

        The outcome is surfaced three ways: the ``recovery`` block on
        ``/readyz``, ``jobs_recovered_total{outcome}``, and a
        ``recovered`` event + flag on each placeholder record.
        """
        if self.journal is None:
            return
        state = await asyncio.to_thread(self.journal.replay)
        live = state.live()
        counters = recovery_counters(state)
        restored = 0
        for job_id, failures in counters.items():
            self._failure_counts[job_id] = failures
            restored += 1
        tombstone_ttl = float(cfg_get(
            self.config, "journal.tombstone_ttl", 86400.0))
        expired: set = set()

        def _retire(job_id: str, why: str) -> None:
            # the redelivery never came (dead-lettered, message TTL,
            # queue purge, completed by a fleet peer): settle-ack the
            # journal so the job stops replaying — and re-counting —
            # on every boot forever
            self.journal.append("settle", job_id, mode="ack", why=why)
            self._failure_counts.pop(job_id, None)
            expired.add(job_id)
            if self.metrics is not None:
                self.metrics.jobs_recovered.labels(
                    outcome="expired").inc()

        for job_id, job in live.items():
            if job.state == control.CANCELLED:
                # an operator-cancelled placeholder from a PREVIOUS
                # recovery window (the CANCELLED transition is journaled,
                # the delivery never settled): the decision is final
                # across any number of restarts — no run placeholder,
                # just the tombstone that settles the eventual
                # redelivery as cancelled the moment it arrives
                if (tombstone_ttl > 0
                        and _submission_age_seconds(job.updated_at)
                        > tombstone_ttl):
                    _retire(job_id, "tombstone_expired")
                    continue
                # no metrics inc here: outcome="cancelled" counted once,
                # when the cancel first settled the placeholder — a
                # crash-looping worker must not re-count the same
                # tombstone every boot
                self._recovered[job_id] = {
                    "cancelled": True,
                    "reason": job.reason or "cancelled",
                    "watcher": None,
                }
                continue
            # the placeholder-retirement clock: recovered_at survives
            # re-registration across boots (clears on adoption/progress),
            # so a placeholder the broker has owed a redelivery for a
            # full TTL is a ghost — retire it instead of parking it,
            # keeping its workdir, and re-counting it at every boot
            if (tombstone_ttl > 0 and job.recovered_at
                    and _submission_age_seconds(job.recovered_at)
                    > tombstone_ttl):
                _retire(job_id, "recovery_expired")
                continue
            record = self.registry.register(
                job_id, job.file_id, priority=job.priority,
                tenant=self.tenants.resolve(job.tenant),
                ttl_seconds=job.ttl_seconds,
                recovered_at=(job.recovered_at or job.updated_at
                              or _utcnow_iso()),
            )
            record.recovered = True
            record.event("recovered", prior_state=job.state,
                         prior_stage=job.stage, failures=job.failures,
                         settle=job.settle)
            if job.failures > 0:
                # GET /v1/jobs answers "how burned is this job's poison
                # budget" before the redelivery even lands
                record.retry = {"why": "recovered",
                                "failures": job.failures}
            self.registry.transition(
                record, control.PARKED,
                reason="recovered: awaiting redelivery",
            )
            watcher = asyncio.create_task(self._watch_recovered(record))
            self._recovered[job_id] = {"cancelled": False, "reason": "",
                                       "watcher": watcher}
            self._recovery_watchers.append(watcher)
            if self.metrics is not None:
                self.metrics.jobs_recovered.labels(outcome="replayed").inc()
        swept, resumed, demoted = await asyncio.to_thread(
            self._sweep_workdirs,
            # cancelled tombstones are never resumable (their workdir,
            # if the kill beat the cancel's own rmtree, is an orphan),
            # and neither are jobs just retired past tombstone_ttl —
            # keeping a retired ghost's workdir would leak it for the
            # whole process lifetime
            {job_id for job_id, job in live.items()
             if job.state != control.CANCELLED and job_id not in expired},
        )
        if self.metrics is not None:
            if swept:
                self.metrics.jobs_recovered.labels(
                    outcome="swept").inc(swept)
            if resumed:
                self.metrics.jobs_recovered.labels(
                    outcome="resumable").inc(resumed)
            if demoted:
                self.metrics.jobs_recovered.labels(
                    outcome="demoted").inc(demoted)
        # compact now that the history is replayed: the journal restarts
        # as one snapshot line of the still-live jobs (self-replaying,
        # so the placeholder lines just appended are part of the basis)
        await asyncio.to_thread(self.journal.compact)
        leases_reclaimed = 0
        if self.fleet is not None:
            try:
                leases_reclaimed = await self.fleet.reclaim_own_leases()
            except Exception as err:
                # coordination trouble degrades, never blocks a boot —
                # the acquire-time own-orphan reclaim still applies
                self.logger.warn("recovery lease reclaim failed",
                                 error=str(err))
        self.recovery = {
            "recoveredJobs": len(live),
            "restoredRetryCounters": restored,
            "sweptWorkdirs": swept,
            "resumableWorkdirs": resumed,
            "demotedOutputs": demoted,
            "tornJournalLines": state.torn_lines,
            "reclaimedLeases": leases_reclaimed,
            "at": _utcnow_iso(),
        }
        if live or swept or state.torn_lines:
            self.logger.info("crash recovery complete", **self.recovery)

    def _sweep_workdirs(self, live_ids: set) -> "tuple[int, int, int]":
        """Reconcile the download root against the journal (thread-side).

        A workdir whose job still expects a redelivery is KEPT — its
        ``.partial``/piece state is content-keyed (validators in
        ``.partial.meta``, SHA-1 piece hashes) so the resumed attempt
        pays only the missing bytes.  Its PROMOTED outputs, though,
        are re-verified against the landing recovery sidecar
        (store/scrub.py): a digest mismatch is the torn-tail crash —
        the rename outlived the data pages — and the output is
        DEMOTED (deleted) so the redelivered job re-fetches instead of
        serving the hole.  Everything else — ack-settled terminal
        jobs, dirs the journal has never heard of — is an orphan and
        is deleted: the journal is authoritative for this root
        (dot-dirs, including the journal's own, are skipped).  Returns
        ``(swept, resumed, demoted)`` counts.
        """
        swept = resumed = demoted = 0
        # service dirs that legitimately live under the download root but
        # are NOT job workdirs: the journal's own dir and a configured
        # content cache (CACHE_DIR/instance.cache.path may point a
        # non-dot-prefixed dir here — sweeping it would silently discard
        # the whole LRU cache at every boot)
        protected = set()
        if self.journal is not None:
            protected.add(os.path.realpath(os.path.dirname(
                self.journal.path)))
        from .store.cache import resolve_cache_path

        # the ONE resolver the cache itself uses — a diverging copy here
        # would eventually sweep the LRU cache as an "orphan"
        protected.add(os.path.realpath(resolve_cache_path(self.config)))
        try:
            entries = os.scandir(self._download_root)
        except OSError:
            return swept, resumed
        with entries:
            for entry in entries:
                if not entry.is_dir(follow_symlinks=False):
                    continue
                if entry.name.startswith("."):
                    continue  # .journal, .cache-style service dirs
                if os.path.realpath(entry.path) in protected:
                    continue
                if entry.name in live_ids:
                    verified, torn = verify_landed(entry.path)
                    if torn:
                        demoted += torn
                        self.logger.warn(
                            "boot recovery: demoted torn outputs for "
                            "re-fetch", workdir=entry.path,
                            demoted=torn, verified=verified)
                    resumed += 1
                    continue
                try:
                    shutil.rmtree(entry.path)
                    swept += 1
                except OSError as err:
                    self.logger.warn("orphan workdir sweep failed",
                                     path=entry.path, error=str(err))
        return swept, resumed, demoted

    async def _watch_recovered(self, record: JobRecord) -> None:
        """Settle a recovered placeholder that is cancelled before its
        redelivery arrives (the cancel-during-reconciliation window).

        The placeholder holds no run slot and no delivery, so nothing
        else will ever settle it: this watcher transitions it to
        CANCELLED, removes the workdir, and leaves a tombstone in
        ``_recovered`` so the eventual redelivery is acked as cancelled
        instead of silently re-running an operator-cancelled job.
        """
        await record.cancel.wait()
        if record.terminal or not (record.state == control.PARKED
                                   and record.recovered):
            return  # adopted by a redelivery first: the normal path owns it
        reason = record.cancel.reason or "cancelled"
        entry = self._recovered.get(record.job_id)
        if entry is not None:
            entry["cancelled"] = True
            entry["reason"] = reason
        self._clear_failures(record.job_id)
        await self._remove_workdir(record.job_id, self.logger)
        record.event("settle", mode="none", why="cancelled_during_recovery",
                     reason=reason)
        self.registry.transition(record, control.CANCELLED, reason=reason)
        if self.metrics is not None:
            self.metrics.jobs_cancelled.inc()
            self.metrics.jobs_recovered.labels(outcome="cancelled").inc()

    async def _staged_probe_loop(self) -> None:
        # a peer SETTLING a job publishes its telemetry digest — the
        # exact moment a done marker may have appeared — so the probe
        # rides the fleet's telemetry watch and wakes on peer activity;
        # the configured interval survives as the bounded long-poll cap
        # and as the whole cadence on the degraded path (no fleet,
        # watch refused, coord brownout): the contract.
        watch = None
        try:
            while True:
                if (watch is None and self.fleet is not None
                        and self.fleet.watch_enabled):
                    watch = self.fleet.telemetry_watch()
                if watch is None:
                    if self.fleet is not None:
                        self.fleet._note_watch_wakeup("poll")
                    await asyncio.sleep(self._staged_probe_interval)
                else:
                    try:
                        events = await watch.next(
                            self._staged_probe_interval)
                    except asyncio.CancelledError:
                        raise
                    except Exception:
                        watch.close()
                        watch = None
                        self.fleet._note_watch_wakeup("poll")
                        await asyncio.sleep(self._staged_probe_interval)
                        events = []
                    else:
                        self.fleet._note_watch_wakeup(
                            "event" if events else "timeout")
                try:
                    if self._recovered:
                        await self._probe_recovered_staged()
                    await self._sweep_peer_staged_workdirs()
                except asyncio.CancelledError:
                    raise
                except Exception as err:
                    # store trouble: the placeholders keep waiting, the
                    # next pass probes again — degradation, never a
                    # crash
                    self.logger.warn(
                        "recovered-placeholder probe failed",
                        error=str(err))
        finally:
            if watch is not None:
                watch.close()

    async def _probe_recovered_staged(self) -> int:
        """Retire PARKED recovery placeholders whose content the fleet
        already staged (done marker present).

        The placeholder's redelivery went to a peer worker (our unacked
        delivery requeued when the previous incarnation died, and
        another consumer won it) — the peer ran the job and acked it,
        so no redelivery is owed to US.  Without this probe the
        placeholder parks until ``journal.tombstone_ttl`` and its
        workdir leaks for just as long.  If a redelivery *does* still
        arrive after retirement (a second requeue), the normal intake
        path's idempotency probe acks it as already staged — retiring
        here is safe either way.
        """
        retired = 0
        for record in self.registry.jobs(control.PARKED):
            if not (record.recovered
                    and (record.reason or "").startswith("recovered")):
                continue
            try:
                await self.store.get_object(
                    STAGING_BUCKET, done_marker_name(record.job_id))
            except ObjectNotFound:
                continue
            except Exception:
                continue  # store trouble: decide nothing this pass
            if not (record.state == control.PARKED and record.recovered
                    and (record.reason or "").startswith("recovered")):
                # the probe's await yielded the loop: a redelivery
                # adopted the placeholder (or a cancel settled it)
                # while we were reading the marker — the normal intake
                # path owns the record now, and its idempotency probe
                # will make the same already-staged call
                continue
            entry = self._recovered.pop(record.job_id, None)
            if entry is not None and entry.get("watcher") is not None:
                entry["watcher"].cancel()
            self._clear_failures(record.job_id)
            record.event("settle", mode="none", why="staged_elsewhere")
            self._journal_settle(record, "ack", "staged_elsewhere")
            self.registry.transition(
                record, control.DONE,
                reason="recovered: staged by a fleet peer")
            await self._remove_workdir(record.job_id, self.logger)
            if self.metrics is not None:
                self.metrics.jobs_recovered.labels(
                    outcome="staged_elsewhere").inc()
            self.logger.info(
                "recovered placeholder already staged by a peer",
                jobId=record.job_id)
            retired += 1
        return retired

    async def _sweep_peer_staged_workdirs(self) -> int:
        """Remove resumable workdirs nobody is coming back for: the
        job's delivery was park-then-NACKED away (transient failure,
        open breaker, overload shed) and a PEER worker completed it.

        A nacked job's workdir is deliberately kept so a redelivery to
        US can resume its ``.partial``/piece state — but when the
        redelivery lands on a peer (the broker owes it to *a* consumer,
        not to this one) and that peer seals the done marker, no
        resume is ever owed here: any late redelivery acks at the
        idempotency probe without touching these bytes.  Flushed out
        by the degraded soak: a breaker-shed job migrating to the
        healthy worker left its partial workdir behind forever.
        """
        swept = 0
        for record in self.registry.jobs(control.FAILED):
            latest = self.registry.get(record.job_id)
            if latest is not record or not latest.terminal:
                continue  # a live redelivery owns this job id right now
            workdir = job_download_dir(self.config, record.job_id)
            if not os.path.isdir(workdir):
                continue
            try:
                await self.store.get_object(
                    STAGING_BUCKET, done_marker_name(record.job_id))
            except ObjectNotFound:
                continue  # not staged anywhere yet: keep the resume state
            except Exception:
                continue  # store trouble: decide nothing this pass
            # re-check after the await: a redelivery may have arrived
            # and re-registered the job while the marker read yielded
            if self.registry.get(record.job_id) is not record:
                continue
            await self._remove_workdir(record.job_id, self.logger)
            record.event("workdir_swept", why="staged_elsewhere")
            if self.metrics is not None:
                self.metrics.jobs_recovered.labels(
                    outcome="staged_elsewhere").inc()
            self.logger.info(
                "swept workdir of a job a peer already staged",
                jobId=record.job_id)
            swept += 1
        return swept

    # -- control plane: intake steering --------------------------------
    async def pause_intake(self) -> None:
        """Stop pulling deliveries; in-flight jobs keep running.

        The prefetch window's unsettled deliveries stay assigned to this
        worker (they are already in ``processor``); nothing new arrives
        until :meth:`resume_intake`.  ``/readyz`` answers 503 while
        paused so load-aware orchestrators stop routing to the replica.
        """
        if self.intake_paused:
            return
        # consumers first, flag after: if the broker-side cancel fails
        # (AMQP stop_consuming propagates protocol errors on a healthy
        # connection), the pause must FAIL — reporting "paused" while
        # deliveries still flow would make /v1/drain lie to operators
        await self.mq.stop_consuming()
        self.intake_paused = True
        self.logger.info("intake paused")

    async def resume_intake(self) -> None:
        if not self.intake_paused:
            return
        await self.mq.resume_consuming()
        self.intake_paused = False
        self.logger.info("intake resumed")

    async def drain(self, grace_seconds: float = 30.0) -> bool:
        """Pause intake and wait (bounded) for in-flight jobs to settle.

        The programmatic form of :meth:`shutdown`'s grace loop, minus the
        teardown: the service stays up (resumable) after a drain.
        Returns True when everything settled within the grace period.
        """
        await self.pause_intake()
        try:
            async with asyncio.timeout(grace_seconds):
                while self.active_jobs:
                    await asyncio.sleep(0.05)
        except TimeoutError:
            self.logger.warn("drain grace period expired with active jobs",
                             active=len(self.active_jobs))
            return False
        return True

    async def shutdown(self, grace_seconds: float = 30.0) -> None:
        """Stop consuming; wait for in-flight jobs to settle.

        The reference's termination closure refuses a clean exit while jobs
        are active (lib/main.js:197-204); here we stop pulling new work
        first, then actually drain the in-flight jobs.
        """
        self.consuming = False
        try:
            await self.mq.stop_consuming()
        except Exception as err:
            # shutdown is best-effort here: close() below tears down the
            # connection (and any consumer with it) regardless
            self.logger.warn("stop_consuming failed during shutdown",
                             error=str(err))
        try:
            async with asyncio.timeout(grace_seconds):
                while self.active_jobs:
                    await asyncio.sleep(0.05)
        except TimeoutError:
            self.logger.warn(
                "shutdown grace period expired with active jobs",
                active=len(self.active_jobs),
            )
        await self.profiler.stop()
        await self.loop_monitor.stop()
        if self.overload is not None:
            await self.overload.stop()
        if self.scrubber is not None:
            await self.scrubber.stop()
        if self.controller is not None:
            # stop planning before leaving the fleet: a departing
            # worker must not publish a plan mid-deregistration
            await self.controller.stop()
        if self.fleet is not None:
            # leave the fleet before the backends close: deregistration
            # and lease release still have a live store to write to
            await self.fleet.stop()
        if self._staged_probe_task is not None:
            self._staged_probe_task.cancel()
            try:
                await self._staged_probe_task
            except asyncio.CancelledError:
                pass
            self._staged_probe_task = None
        for watcher in self._recovery_watchers:
            watcher.cancel()
        if self._recovery_watchers:
            await asyncio.gather(*self._recovery_watchers,
                                 return_exceptions=True)
            self._recovery_watchers.clear()
        if self._telemetry_tasks:
            # give in-flight digest publishes a moment (they are one
            # coordination put), then cut them — digests are best-effort
            pending = list(self._telemetry_tasks)
            try:
                async with asyncio.timeout(2):
                    await asyncio.gather(*pending, return_exceptions=True)
            except TimeoutError:
                for task in pending:
                    task.cancel()
                await asyncio.gather(*pending, return_exceptions=True)
            self._telemetry_tasks.clear()
        await self.mq.close()
        await self.telemetry.close()
        if self.journal is not None:
            # synchronous flush: a clean shutdown's journal is exact
            await asyncio.to_thread(self.journal.close)
        for cleanup in self.stage_cleanups:
            try:
                await cleanup()
            except Exception as err:
                self.logger.warn("stage cleanup failed", error=str(err))
        self.stage_cleanups.clear()
        self.stage_resources.clear()
        # remove only OUR injector: a test that installed its own plan
        # around this orchestrator keeps it
        if self._fault_injector is not None:
            faults.uninstall(self._fault_injector)

    # ------------------------------------------------------------------
    async def processor(self, delivery: Delivery) -> None:
        """Handle one ``v1.download`` delivery (reference lib/main.js:62-170)."""
        try:
            msg = schemas.decode(schemas.Download, delivery.body)
        except Exception as err:
            # malformed delivery: ack + count instead of letting the
            # decode error escape the handler — both MQ backends would
            # nack-requeue it and hot-loop forever (the poison guard
            # needs a job id a body that can't decode can never provide)
            self.logger.error("dropping malformed delivery",
                              error=str(err), bytes=len(delivery.body))
            if self.metrics is not None:
                self.metrics.jobs_failed.labels(reason="malformed").inc()
            await delivery.ack()
            return
        file_id = msg.media.creator_id  # (reference lib/main.js:64)
        job_id = msg.media.id           # (reference lib/main.js:65)
        priority = priority_name(msg.priority)
        # tenant identity (control/tenancy.py): absent/empty and
        # unconfigured names both resolve to "default" (the
        # unknown-priority -> NORMAL posture), so old producers and
        # un-onboarded submitters get exactly the pre-tenancy behavior
        tenant = self.tenants.resolve(getattr(msg, "tenant", ""))
        ttl_seconds = float(getattr(msg, "ttl_seconds", 0.0) or 0.0)

        if self.metrics is not None:
            self.metrics.jobs_consumed.inc()

        job_entry = {"cardId": file_id, "jobId": job_id}

        # correlation ids, allocated at RECEIPT: the job span's W3C
        # trace/span id (inheriting the submitter's trace when the
        # delivery carries a traceparent header) goes into the child
        # logger's bindings, the registry record, and — below — the span
        # itself, so a log line, an OTLP span, and a flight-recorder
        # timeline entry for the same job are joinable on one id
        remote = parse_traceparent(delivery.headers.get("traceparent"))
        trace_id = remote.trace_id if remote is not None else uuid.uuid4().hex
        span_id = uuid.uuid4().hex[:16]
        child = self.logger.child(jobId=job_id, fileId=file_id,
                                  traceId=trace_id, spanId=span_id)
        if tenant != "default":
            # the tenant joins the job's log context only when one is
            # actually named — single-tenant log streams stay unchanged
            child = child.child(tenant=tenant)

        # registered + counted from RECEIPT: a job waiting in admission
        # or the priority queue is visible to /health, GET /v1/jobs,
        # drain, and shutdown (pre-control-plane blind spot).  All
        # bookkeeping after this point is undone in the finally, so a
        # failure anywhere can't leak the gauge or the active-jobs entry.
        # crash-recovery adoption (control/journal.py): a redelivery for
        # a job the startup replay knows about takes over its PARKED
        # placeholder — same record, same cancel token, restored retry
        # schedule — so the attempt resumes its history instead of
        # starting cold.  A placeholder cancelled during the replay
        # window leaves a tombstone: the redelivery is settled as
        # cancelled the moment it arrives (an operator decision is
        # final, the cancel-while-PARKED posture).
        recovered_entry = self._recovered.pop(job_id, None)
        record = None
        if recovered_entry is not None:
            watcher = recovered_entry.get("watcher")
            if watcher is not None and not watcher.done():
                watcher.cancel()
            record = self.registry.adopt_recovered(
                job_id, file_id, priority=priority, tenant=tenant,
                ttl_seconds=ttl_seconds,
            )
            if record is not None and self.metrics is not None:
                self.metrics.jobs_recovered.labels(outcome="adopted").inc()
        if record is None:
            record = self.registry.register(job_id, file_id,
                                            priority=priority,
                                            tenant=tenant,
                                            ttl_seconds=ttl_seconds)
            if recovered_entry is not None:
                # the placeholder is gone (cancelled during the replay
                # window settled it) but the delivery is still this
                # job's: mark provenance on the fresh record
                record.recovered = True
        if recovered_entry is not None and recovered_entry.get("cancelled"):
            record.cancel.cancel(recovered_entry.get("reason")
                                 or "cancelled")
        if record.deadline_mono is not None:
            # the TTL ran from SUBMISSION: shift the cutoff back by the
            # age the message already has, so redeliveries (which carry
            # the same created_at) cannot reset the clock
            record.deadline_mono -= _submission_age_seconds(
                getattr(msg, "created_at", "")
            )
        record.trace_id = trace_id
        record.span_id = span_id
        record.event("delivered", redelivered=delivery.redelivered)
        record.event("span", name="job", traceId=trace_id, spanId=span_id,
                     remoteParent=remote.span_id if remote else None)
        token = record.cancel
        self.active_jobs.append(job_entry)
        if self.metrics is not None:
            self.metrics.jobs_active.inc()
        # keyed by the unique job id — the reference keys its EmitterTable by
        # creator/file id (lib/main.js:81), which collides when two jobs from
        # the same creator run concurrently
        emitter = self.emitter_table[job_id] = EventEmitter()
        # idempotent release (RunSlot): the delayed-redelivery park
        # gives the run slot back BEFORE its backoff sleep (a healthy
        # queued job must not wait behind a parked one), the fleet
        # plane's lease waiters release-and-reacquire around their
        # park, and the finally below must not double-release
        slot = RunSlot(self.scheduler, priority_rank(priority),
                       tenant=tenant)
        release_slot = slot.release

        try:
            # saturation shedding (control/overload.py): while this
            # worker is saturated, BULK deliveries bounce at admission —
            # parked briefly then nacked (never FAILED permanently,
            # never charged poison), so the backlog waits out the
            # pressure or lands on a healthier fleet peer
            if self.overload is not None:
                shed_reason = self.overload.should_shed(priority)
                if shed_reason is not None:
                    await self._shed_delivery(delivery, child, record,
                                              token, shed_reason)
                    return
            # content-aware routing (fleet/router.py): when a live peer
            # already leads this content, or the placement controller's
            # plan sheds/defers this class, hand the delivery back to
            # the broker here — before admission, a run slot, or a
            # parked fleet wait are spent on it.  Pure cached-view
            # reads; "run" (the lone-worker default) costs nothing.
            if self.router is not None:
                source_uri = getattr(msg.media, "source_uri", "") or ""
                decision = self.router.decide(
                    source_uri, priority=priority, tenant=tenant,
                )
                if record is not None:
                    # placement context, stamped BEFORE the settles
                    # check so even a deferred/shed delivery's record
                    # (and any later slo_breach / incident bundle)
                    # carries where the router put it
                    record.route_key = route_key_for(source_uri)
                    record.route_decision = decision.outcome
                    if self.fleet is not None:
                        record.plan_epoch = self.fleet.plan_epoch()
                if decision.settles:
                    await self._route_delivery(delivery, child, record,
                                               token, decision)
                    return
                if decision.outcome != "run" and record is not None:
                    # non-default decisions that still admit (own
                    # lease, router error) are timeline-worthy too
                    record.event("route", outcome=decision.outcome,
                                 reason=decision.reason)
            # submitter deadline (Download.ttl_seconds): a redelivered
            # BULK job that already outlived its TTL is dropped before
            # it consumes anything
            if await self._enforce_deadline(delivery, child, record,
                                            where="receipt"):
                return
            # dependency breakers gate intake BEFORE admission: when the
            # staging store or convert publish is hard-down (breaker
            # open), starting the job would only burn its poison budget
            # against a dependency that cannot answer — park it instead,
            # visibly (jobs_by_state{state="PARKED"}, /readyz 503), until
            # the breaker's half-open window opens
            blocked = self.breakers.blocking_dependencies(
                self.admission_dependencies
            )
            if blocked:
                child.warn("parking job: dependency breaker open",
                           dependencies=blocked)
                record.event("breaker_parked", dependencies=blocked)
                if self.metrics is not None:
                    self.metrics.jobs_parked.labels(reason="breaker").inc()
                self.registry.transition(
                    record, control.PARKED,
                    reason="breaker_open: " + ",".join(blocked),
                )
                await token.guard(
                    self.breakers.wait_ready(self.admission_dependencies)
                )
                record.event("breaker_cleared")
            # admission control: a new job only starts once the cache
            # volume has its configured disk headroom — LRU entries are
            # evicted to make room, and if nothing is evictable the job
            # waits (bounded) for in-flight work to free space.  The
            # delivery stays unsettled while we wait, so the broker's
            # prefetch window provides the backpressure.  The token
            # guard makes a parked job cancellable.
            await token.guard(self._admit_job(child, record))
            # queue wait (RECEIPT -> ADMITTED): An earlier change made it visible
            # per-job via the registry timestamps; the histogram finally
            # aggregates it
            queue_wait = time.monotonic() - record._created_mono
            self.registry.transition(record, control.ADMITTED)
            record.event("queue_wait", seconds=round(queue_wait, 6))
            if self.metrics is not None:
                self.metrics.queue_wait_seconds.observe(queue_wait)
            admitted_mono = time.monotonic()
            # priority scheduling: wait for one of the run slots, queued
            # by class (HIGH before NORMAL before BULK) with aging
            await token.guard(slot.acquire())
            sched_wait = time.monotonic() - admitted_mono
            record.event("sched_wait", seconds=round(sched_wait, 6))
            if self.metrics is not None:
                self.metrics.scheduler_wait_seconds.observe(sched_wait)
            # deadline re-check now that the full queue + scheduler wait
            # is known: expired BULK drops (EXPIRED), expired HIGH/NORMAL
            # is surfaced (event + warn log) but still runs
            if await self._enforce_deadline(delivery, child, record,
                                            where="slot_granted"):
                return
            # set DOWNLOADING status (reference lib/main.js:68) — only
            # once the job actually holds a run slot: a job parked in
            # admission or the priority queue must not tell telemetry
            # consumers it is transferring (its queued/admitted state is
            # visible via GET /v1/jobs instead)
            await self.telemetry.emit_status(
                job_id, schemas.TelemetryStatus.Value("DOWNLOADING")
            )
            # parent the job span to the submitter's span when the
            # message carries W3C trace context (triton's design intent,
            # upstream lib/main.js:20 — unused there; live here),
            # under the ids pre-allocated at receipt so logger bindings
            # and recorder events already reference this exact span
            with self.tracer.span("job", remote_parent=remote,
                                  trace_id=trace_id, span_id=span_id,
                                  jobId=job_id, fileId=file_id):
                await self._run_job(msg, delivery, child, emitter,
                                    record, token, slot)
        except JobCancelled:
            await self._settle_cancelled(msg, delivery, child, record, token)
        finally:
            release_slot()
            # remove the finished job (fixes reference lib/main.js:169,
            # which called Array.slice — a no-op — so activeJobs only grew)
            try:
                self.active_jobs.remove(job_entry)
            except ValueError:
                pass
            self.emitter_table.pop(job_id, None)
            if self.metrics is not None:
                self.metrics.jobs_active.dec()
            if not record.terminal:
                # the handler unwound without settling the record (an
                # unexpected error, or task teardown at shutdown): the
                # MQ layer requeues the delivery; close this record
                self.registry.transition(record, control.FAILED,
                                         reason="handler_exit")
            if self.metrics is not None:
                # per-tenant outcome slice (label set bounded: resolved
                # tenants x lifecycle states)
                self.metrics.tenant_jobs.labels(
                    tenant=record.tenant, outcome=record.state
                ).inc()
            if (self.fleet is not None and record.terminal
                    and record.trace_id):
                # publish the job's trace digest to the coordination
                # store (fleet/plane.py) as a detached task: the settle
                # is already acked, and a store round trip must not
                # extend the handler.  Best-effort by contract.
                task = asyncio.create_task(
                    self.fleet.publish_telemetry(record),
                    name=f"telemetry-digest-{record.job_id[:12]}",
                )
                self._telemetry_tasks.add(task)
                task.add_done_callback(self._telemetry_tasks.discard)

    async def _settle_cancelled(self, msg: schemas.Download,
                                delivery: Delivery, logger: Logger,
                                record: JobRecord,
                                token: CancelToken) -> None:
        """Settle a cooperatively-cancelled job.

        ``ack`` (an operator decision is final — no requeue), telemetry
        CANCELLED (or ERRORED under ``control.errored_on_cancel``),
        partial staging files removed, registry record closed.  A
        cancelled singleflight leader already rejected its flight on the
        way here, so coalesced waiters have failed over.
        """
        job_id = msg.media.id
        logger.warn("job cancelled", reason=token.reason or "cancelled")
        # the job owns <download_path>/<id>: remove partial files BEFORE
        # settling, so "delivery settled" implies "disk reclaimed" (the
        # cancel-latency bench and any operator automation can treat the
        # ack as the single completion signal)
        await self._remove_workdir(job_id, logger)
        record.event("settle", mode="ack", why="cancelled",
                     reason=token.reason or "cancelled")
        self._journal_settle(record, "ack", "cancelled")
        await delivery.ack()
        # terminal state BEFORE the telemetry await: observers woken by
        # the ack (broker join, drain, /v1/jobs pollers) must already
        # see CANCELLED, not a settled-but-ADMITTED limbo — the same
        # an earlier change invariant the EXPIRED path honors (graftlint
        # ack-settle-atomicity)
        self.registry.transition(record, control.CANCELLED,
                                 reason=token.reason or "cancelled")
        self._clear_failures(job_id)
        if self.metrics is not None:
            self.metrics.jobs_cancelled.inc()
        try:
            await self.telemetry.emit_status(job_id, self._cancel_status)
        except Exception as err:
            logger.warn("cancel status emit failed", error=str(err))

    async def _admit_job(self, logger: Logger,
                         record: Optional[JobRecord] = None) -> None:
        """Gate job start on disk headroom.

        Two floors: the cache volume's ``min_free_bytes`` (when
        caching, as before) and the WORKDIR volume's
        ``download.min_free_bytes`` plus the per-job
        ``download.reserve_bytes`` space reservation (when configured
        — both default off).  The order is: evict LRU cache entries
        first (cached bytes are the one reclaimable resource), then
        wait for running jobs to release space, then — after
        ``admission_timeout`` — proceed anyway and let the download
        stage's preflight make the loud per-job call.  A forced
        admission that still fails the WORKDIR floor additionally
        force-opens the store breaker with the ``disk`` reason
        (eviction cannot reclaim workdir space, so this worker is
        degraded until the volume drains): /readyz and the fleet
        overview surface it, and follow-on deliveries park on the
        breaker instead of marching into ENOSPC.
        """
        workdir_need = self.workdir_min_free + self.workdir_reserve
        if self.cache is None and workdir_need <= 0:
            return

        def _floors() -> "tuple[bool, bool]":
            cache_ok = self.cache is None or self.cache.has_headroom()
            workdir_ok = True
            if workdir_need > 0:
                free = self._workdir_free_bytes()
                workdir_ok = free is None or free >= workdir_need
            return cache_ok, workdir_ok

        deadline = time.monotonic() + self.admission_timeout
        warned = False
        while True:
            cache_ok, workdir_ok = await asyncio.to_thread(_floors)
            if cache_ok and workdir_ok:
                return
            if self.cache is not None:
                evicted = await self.cache.evict_to_budget(
                    extra_needed=self.workdir_reserve
                    if not workdir_ok else 0)
                if evicted:
                    continue  # re-check the floors after the reclaim
            free_now = (self.cache.free_disk_bytes()
                        if self.cache is not None
                        else (self._workdir_free_bytes() or 0))
            if time.monotonic() >= deadline:
                logger.warn(
                    "admitting job without disk headroom",
                    free_bytes=free_now,
                    cache_ok=cache_ok, workdir_ok=workdir_ok,
                )
                if record is not None:
                    record.event("admission_forced",
                                 free_bytes=free_now)
                if not workdir_ok and self.breakers is not None:
                    breaker = self.breakers.get("store")
                    if breaker is not None:
                        breaker.force_open(OPEN_DISK)
                return
            if not warned:
                warned = True
                logger.warn(
                    "job admission waiting for disk headroom",
                    free_bytes=free_now,
                    cache_ok=cache_ok, workdir_ok=workdir_ok,
                )
                if record is not None:
                    record.event("admission_wait",
                                 free_bytes=free_now)
            await asyncio.sleep(0.25)

    # -- classified failure settlement ---------------------------------
    def _note_failure(self, job_id: str) -> int:
        """Advance the poison counter for one failed delivery attempt.

        Re-inserts at the back so the bound below evicts the LEAST-
        recently-failing job, never an actively hot one; the 10 000-entry
        cap stops jobs whose redeliveries land on other replicas (or get
        dead-lettered) from leaking one entry each for the process
        lifetime.
        """
        failures = self._failure_counts.pop(job_id, 0) + 1
        self._failure_counts[job_id] = failures
        if len(self._failure_counts) > 10_000:
            self._failure_counts.pop(next(iter(self._failure_counts)))
        if self.journal is not None:
            # the poison counter must survive a worker kill: a job that
            # failed twice before the crash is on its third strike after
            self.journal.append("retry", job_id, failures=failures)
        return failures

    def _clear_failures(self, job_id: str) -> None:
        """Drop the poison counter (and journal the drop, so a restart
        cannot resurrect a count the live process already cleared)."""
        if self._failure_counts.pop(job_id, None) is not None \
                and self.journal is not None:
            self.journal.append("retry_clear", job_id)

    def _journal_settle(self, record: JobRecord, mode: str,
                        why: str) -> None:
        """Record how the delivery settled — the bit recovery uses to
        decide whether a redelivery is still coming (nack) or the job's
        story is over and its workdir is an orphan (ack).

        Also the ONE seam every settle path funnels through, so the
        SLO tracker (control/slo.py) classifies each resolution here:
        acked done/staged inside its objective's latency target is
        good, acked failures and latency breaches burn error budget
        (and stamp an ``slo_breach`` event on the record before it
        retires), nacks and cancels are not resolutions at all.
        """
        if self.journal is not None:
            self.journal.append("settle", record.job_id, mode=mode,
                                why=why)
        breached = False
        if self.slo is not None:
            breached = bool(self.slo.note_settle(record, mode, why))
        if breached and self.incidents is not None \
                and self.incidents.auto_export:
            # auto-export (incident/bundle.py): the breach that was just
            # stamped becomes a forensic bundle in the bounded ring —
            # best-effort, because a full ring or a torn journal must
            # never fail the settle itself
            try:
                bundle = build_bundle(self, record, trigger=TRIGGER_BREACH)
                self.incidents.add(bundle, trigger=TRIGGER_BREACH)
                record.event("incident_export",
                             bundleId=bundle.get("bundleId"),
                             trigger=TRIGGER_BREACH)
            except Exception as err:
                self.logger.warn("incident auto-export failed",
                                 jobId=record.job_id, error=str(err))

    async def _remove_workdir(self, job_id: str, logger: Logger) -> None:
        """Best-effort workdir removal for settles after which no
        redelivery will ever come (ack + terminal): without this, a
        permanently-failed or expired job's partial downloads sat on
        disk until an operator noticed (the crash-recovery sweep now
        catches them at the NEXT boot; this catches them live)."""
        try:
            await asyncio.to_thread(
                shutil.rmtree, job_download_dir(self.config, job_id), True
            )
        except OSError as err:
            logger.warn("terminal workdir cleanup failed", error=str(err))

    def _redelivery_delay(self, failures: int) -> float:
        """Exponential park-then-nack pause for the Nth failure."""
        if self._redeliver_base <= 0:
            return 0.0
        return min(self._redeliver_cap,
                   self._redeliver_base * (2 ** (max(failures, 1) - 1)))

    async def _park(self, record: JobRecord, token: CancelToken,
                    delay: float, release_slot, reason: str,
                    failures: Optional[int] = None) -> None:
        """Hold the unsettled delivery for ``delay`` seconds before its
        nack — the broker's prefetch window is the park bench, so the
        redelivery arrives *after* the backoff instead of instantly.
        The run slot is released first and the wait is cancellable."""
        if delay <= 0:
            return
        if release_slot is not None:
            release_slot()
        retry_info = {"why": reason, "nackDelayS": round(delay, 3)}
        if failures is not None:
            retry_info["failures"] = failures
        record.retry = retry_info
        record.event("park", why=reason, delay_s=round(delay, 3))
        if self.metrics is not None:
            if reason.startswith("breaker"):
                label = "breaker"
            elif reason.startswith("overload"):
                label = "overload"
            else:
                label = "backoff"
            self.metrics.jobs_parked.labels(reason=label).inc()
        self.registry.transition(
            record, control.PARKED,
            reason=f"{reason}: redeliver in {delay:.2f}s",
        )
        await token.guard(asyncio.sleep(delay))

    async def _shed_delivery(self, delivery: Delivery, logger: Logger,
                             record: JobRecord, token: CancelToken,
                             reason: str) -> None:
        """Bounce one BULK delivery while the worker is saturated.

        the park-then-nack discipline, applied to OUR overload
        instead of a dependency's: the unsettled delivery parks for
        ``overload.shed_backoff`` (so the redelivery arrives after the
        pressure sample window, not into it), then nacks for
        redelivery.  The poison counter is NOT advanced — nothing about
        the job failed — and the record closes FAILED with an
        ``overload_shed`` reason, mirroring the breaker-open settle.
        """
        logger.warn("shedding BULK delivery: worker saturated",
                    reason=reason, tenant=record.tenant)
        record.event("shed", why="overload", reason=reason)
        if self.metrics is not None:
            self.metrics.jobs_shed.labels(
                reason=reason, tenant=record.tenant
            ).inc()
        await self._park(record, token, self.overload.shed_backoff, None,
                         reason=f"overload_shed:{reason}")
        record.retry = None
        record.event("settle", mode="nack", why="overload_shed",
                     reason=reason)
        self._journal_settle(record, "nack", "overload_shed")
        await delivery.nack()
        self.registry.transition(
            record, control.FAILED, reason=f"overload_shed: {reason}"
        )

    async def _route_delivery(self, delivery: Delivery, logger: Logger,
                              record: JobRecord, token: CancelToken,
                              decision) -> None:
        """Settle one delivery the content router steered off this
        worker (defer to the lease holder, fleet-fairness defer, or a
        plan-driven BULK shed).

        The an earlier change park-then-nack discipline: the unsettled delivery
        parks for the router's backoff (so the redelivery lands after
        the holder's publish / the next plan beat, not instantly), then
        nacks for redelivery elsewhere.  Poison is NOT charged —
        nothing about the job failed — and the record closes FAILED
        with a ``routed`` reason, mirroring the overload shed.
        """
        logger.info("routing delivery off this worker",
                    outcome=decision.outcome, reason=decision.reason,
                    holder=decision.holder)
        record.event("route", outcome=decision.outcome,
                     reason=decision.reason, holder=decision.holder)
        if decision.outcome == "shed" and self.metrics is not None:
            # the controller's admission shed is an SLO-protective
            # drop, accounted beside the overload layer's sheds
            self.metrics.jobs_shed.labels(
                reason="plan", tenant=record.tenant
            ).inc()
        await self._park(record, token, decision.backoff, None,
                         reason=f"route:{decision.outcome}")
        record.retry = None
        record.event("settle", mode="nack", why="routed",
                     outcome=decision.outcome)
        self._journal_settle(record, "nack", "routed")
        await delivery.nack()
        self.registry.transition(
            record, control.FAILED,
            reason=f"routed: {decision.outcome}"
        )

    async def _enforce_deadline(self, delivery: Delivery, logger: Logger,
                                record: JobRecord, where: str) -> bool:
        """Honor ``Download.ttl_seconds`` at an admission checkpoint.

        Returns True when the delivery was settled here (expired BULK:
        acked + EXPIRED — re-running queue-aged bulk work would burn the
        very capacity the TTL protects).  Expired HIGH/NORMAL work is
        *surfaced* — warn log + ``deadline_exceeded`` event at the
        ``slot_granted`` checkpoint, where the full queueing delay is
        known — but still runs: a user-facing job is never silently
        dropped.
        """
        if not record.deadline_expired():
            return False
        overdue = -(record.deadline_remaining() or 0.0)
        if record.priority != "BULK":
            if where == "slot_granted":
                logger.warn("job deadline exceeded; running anyway "
                            "(non-BULK work is never dropped)",
                            ttlSeconds=record.ttl_seconds,
                            overdueSeconds=round(overdue, 3))
                record.event("deadline_exceeded",
                             overdue_s=round(overdue, 3), where=where)
            return False
        logger.warn("dropping deadline-expired BULK job",
                    ttlSeconds=record.ttl_seconds,
                    overdueSeconds=round(overdue, 3), where=where)
        if self.metrics is not None:
            self.metrics.jobs_shed.labels(
                reason="deadline", tenant=record.tenant
            ).inc()
        # telemetry consumers learn the drop (ERRORED — the same
        # terminal signal the other deliberate drops emit; EXPIRED has
        # no wire enum and legacy consumers only know the reference's
        # range).  Best-effort: a telemetry blip must not block settling.
        try:
            await self.telemetry.emit_status(
                record.job_id, schemas.TelemetryStatus.Value("ERRORED")
            )
        except Exception as err:
            logger.warn("expired-job status emit failed", error=str(err))
        record.event("settle", mode="ack", why="deadline",
                     overdue_s=round(overdue, 3), where=where)
        self._journal_settle(record, "ack", "deadline")
        await delivery.ack()
        self._clear_failures(record.job_id)
        # terminal state BEFORE the workdir removal's await: anything
        # woken by the ack (broker join, drain, /v1/jobs pollers) must
        # already see EXPIRED, not a settled-but-ADMITTED limbo
        self.registry.transition(
            record, control.EXPIRED,
            reason=f"deadline: ttl {record.ttl_seconds:g}s exceeded",
        )
        await self._remove_workdir(record.job_id, logger)
        return True

    async def _settle_failed_attempt(
        self,
        job_id: str,
        delivery: Delivery,
        logger: Logger,
        record: JobRecord,
        token: CancelToken,
        err: Exception,
        release_slot,
        why: str,
        emit_errored: bool = True,
    ) -> None:
        """Settle one failed attempt under the error taxonomy
        (platform/errors.py):

        - breaker-open: park + nack WITHOUT advancing the poison counter
          (the job never reached the dependency)
        - PERMANENT: ack + FAILED immediately — retrying a 4xx/bad-config
          error re-runs the same deterministic outcome
        - POISON (bad content): ack + DROPPED_POISON immediately
        - TRANSIENT/unclassified: advance the poison counter (the seams'
          in-process retry budget is already spent), then park-then-nack
          with exponential backoff so the broker redelivers after the
          blip, not into it
        """
        fault = classify(err)
        seam = getattr(err, "fault_seam", None)
        if getattr(err, "counts_toward_poison", True) is False:
            # the job never got to fail the dependency (BreakerOpen is
            # the in-tree case): park + redeliver WITHOUT charging the
            # poison budget
            dependency = getattr(err, "dependency", None) or seam or "?"
            delay = max(getattr(err, "retry_after", 0.0),
                        self._redeliver_base)
            await self._park(record, token, delay, release_slot,
                             reason=f"breaker_open:{dependency}")
            record.retry = None
            record.event("settle", mode="nack", why="breaker_open",
                         dependency=dependency)
            self._journal_settle(record, "nack", "breaker_open")
            await delivery.nack()
            self.registry.transition(
                record, control.FAILED,
                reason=f"breaker_open: {dependency}",
            )
            return
        if emit_errored:
            await self.telemetry.emit_status(
                job_id, schemas.TelemetryStatus.Value("ERRORED")
            )
        if fault in (PERMANENT, POISON):
            logger.error("dropping job on non-retryable failure",
                         fault=fault, error=str(err)[:200])
            if self.metrics is not None:
                self.metrics.jobs_failed.labels(reason=fault).inc()
            self._clear_failures(job_id)
            # drop any between-attempts retry blob the Retrier left: a
            # terminal record must not read as "waiting for a retry"
            record.retry = None
            record.event("settle", mode="ack", why=fault,
                         type=type(err).__name__)
            self._journal_settle(record, "ack", fault)
            await delivery.ack()
            self.registry.transition(
                record,
                control.FAILED if fault == PERMANENT
                else control.DROPPED_POISON,
                reason=f"{fault}: {type(err).__name__}",
            )
            # no redelivery is coming: the workdir would otherwise leak
            # until the next boot's orphan sweep
            await self._remove_workdir(job_id, logger)
            return
        failures = self._note_failure(job_id)
        record.event("retry", failures=failures,
                     threshold=self.poison_threshold, fault=fault,
                     seam=seam)
        if self.poison_threshold and failures >= self.poison_threshold:
            logger.error(
                "dropping poison job after repeated failures",
                failures=failures,
            )
            # one failure, one count: this attempt is recorded as the
            # drop, not double-counted as a stage_error too
            if self.metrics is not None:
                self.metrics.jobs_failed.labels(reason="poison").inc()
            self._clear_failures(job_id)
            record.retry = None
            record.event("settle", mode="ack", why="poison",
                         failures=failures)
            self._journal_settle(record, "ack", "poison")
            await delivery.ack()
            self.registry.transition(record, control.DROPPED_POISON,
                                     reason=f"{failures} failures")
            await self._remove_workdir(job_id, logger)
            return
        if self.metrics is not None:
            self.metrics.jobs_failed.labels(reason=why).inc()
        delay = self._redelivery_delay(failures)
        await self._park(record, token, delay, release_slot,
                         reason=why, failures=failures)
        record.retry = None
        record.event("settle", mode="nack", why=why,
                     delay_s=round(delay, 3))
        self._journal_settle(record, "nack", why)
        await delivery.nack()
        self.registry.transition(record, control.FAILED, reason=why)

    async def _run_job(
        self,
        msg: schemas.Download,
        delivery: Delivery,
        logger: Logger,
        emitter: EventEmitter,
        record: JobRecord,
        token: CancelToken,
        slot: Optional[RunSlot] = None,
    ) -> None:
        job_id = msg.media.id
        release_slot = slot.release if slot is not None else None

        # build the stage table for this job (reference lib/main.js:99-115)
        ctx = StageContext(
            config=self.config,
            emitter=emitter,
            logger=logger,
            telemetry=_RecordingTelemetry(self.telemetry, record),
            metrics=self.metrics,
            store=self.store,
            tracer=self.tracer,
            resources=self.stage_resources,
            cleanups=self.stage_cleanups,
            cancel=token,
            record=record,
            slot=slot,
        )
        # the streaming dispatch builds what it needs itself (the download
        # stage against a merged-progress facade, the per-file Uploader);
        # only the barrier loop wants the full stage table
        stage_table = (None if self.streaming_enabled
                       else await load_stages(ctx, self.stage_names))

        # idempotency probe (reference lib/main.js:119-124) — a transient
        # store blip here must not decide "not staged" (re-running the
        # stages is merely wasteful) nor escape as a handler crash
        # (instant requeue): it rides the store retry policy, and an
        # exhausted budget settles through the classified path below
        already_staged = True
        try:
            logger.info("checking staging bucket for existing files", jobId=job_id)

            async def _probe():
                if faults.enabled():
                    await faults.fire("store.get", key=job_id)
                return await self.store.get_object(
                    STAGING_BUCKET, done_marker_name(job_id)
                )

            await self.retrier.run("store.get", _probe, cancel=token,
                                   record=record, logger=logger)
        except ObjectNotFound:
            already_staged = False
        except JobCancelled:
            raise
        except Exception as err:
            logger.error("staging probe failed", error=str(err))
            record.event("error", type=type(err).__name__,
                         error=str(err)[:300])
            await self._settle_failed_attempt(
                job_id, delivery, logger, record, token, err,
                release_slot, why="stage_error")
            return

        if not already_staged:
            logger.info("starting main processor after successful stage init")
            last_stage_data: object = {}
            try:
                if self.streaming_enabled:
                    # pipelined dispatch (stages/streaming.py): one
                    # combined RUNNING("pipeline") attribution — the
                    # three logical stages run overlapped, and the
                    # per-file detail rides the flight recorder's
                    # file_complete/upload_start/upload_done events
                    self.registry.transition(record, control.RUNNING,
                                             stage=PIPELINE_STAGE)
                    token.raise_if_cancelled()
                    logger.info("invoking streaming pipeline")
                    started = time.monotonic()
                    try:
                        await token.guard(run_streaming_job(
                            ctx, msg.media,
                            mirrors=tuple(msg.mirrors),
                            source_kind=schemas.enum_to_string(
                                schemas.SourceKind, msg.source_kind
                            ),
                        ))
                    finally:
                        if self.metrics is not None:
                            self.metrics.stage_seconds.labels(
                                stage=PIPELINE_STAGE
                            ).observe(time.monotonic() - started)
                else:
                    for name in self.stage_names:
                        self.registry.transition(record, control.RUNNING,
                                                 stage=name)
                        token.raise_if_cancelled()
                        job = Job(media=msg.media,
                                  last_stage=last_stage_data,
                                  mirrors=tuple(msg.mirrors),
                                  source_kind=schemas.enum_to_string(
                                      schemas.SourceKind,
                                      msg.source_kind,
                                  ))
                        logger.info("invoking stage", stage=name)
                        started = time.monotonic()
                        try:
                            # the guard bounds the whole stage dispatch
                            # by the cancel token: even a stage blocked
                            # somewhere without a cooperative check (DNS,
                            # TLS handshake, a wedged origin) unwinds
                            # promptly
                            last_stage_data = await token.guard(
                                stage_table[name](job)
                            )
                        finally:
                            if self.metrics is not None:
                                self.metrics.stage_seconds.labels(
                                    stage=name
                                ).observe(time.monotonic() - started)
                        # NOTE: the reference emits
                        # ``emitter.emit('progress', 0)`` here
                        # (lib/main.js:139) but no listener exists in
                        # either codebase, and forwarding a hardcoded 0
                        # to telemetry would reset real stage progress —
                        # deliberately dropped (PARITY.md "Reference
                        # bugs fixed").
            except JobCancelled:
                raise  # settled by the processor (ack, cleanup, CANCELLED)
            except Exception as err:
                logger.error("failed to invoke stage", error=str(err))
                record.event("error", stage=record.stage,
                             type=type(err).__name__, error=str(err)[:300])

                # permanent stall -> drop the job (reference lib/main.js:144-146)
                if getattr(err, "code", None) == "ERRDLSTALL":
                    if self.metrics is not None:
                        self.metrics.jobs_failed.labels(reason="stalled").inc()
                    self._clear_failures(job_id)  # job is settled
                    record.event("settle", mode="ack", why="stalled")
                    self._journal_settle(record, "ack", "stalled")
                    await delivery.ack()
                    self.registry.transition(record, control.FAILED,
                                             reason="stalled")
                    await self._remove_workdir(job_id, logger)
                    return

                # anything else settles under the error taxonomy:
                # permanent/poison drop immediately, transients advance
                # the poison counter and park before their nack
                # (replacing the reference's instant ERRORED + redelivery
                # hot loop, lib/main.js:148-150)
                await self._settle_failed_attempt(
                    job_id, delivery, logger, record, token, err,
                    release_slot, why="stage_error")
                return
            logger.info("creating convert job")
        else:
            logger.warn("skipping download due to files existing in triton-staging")
            record.event("idempotent_skip")
            if self.metrics is not None:
                self.metrics.jobs_skipped.inc()

        # publish the convert message even when staging was skipped
        # (reference lib/main.js:153-167).  Cancellation past this point
        # is a no-op by design: the bytes are staged and the cheapest
        # path for everyone is finishing the publish.
        self.registry.transition(record, control.PUBLISHING)
        payload = schemas.Convert(created_at=_utcnow_iso(), media=msg.media)
        # deadline propagation (ROADMAP item 5 remaining depth): the
        # SURVIVING ttl budget rides into the convert pipeline — the
        # downstream converter can apply the same expired-BULK shedding
        # instead of transcoding work nobody is waiting for.  Floor at
        # 1 ms, never 0: proto3 drops a 0.0 from the wire, and the
        # field's contract reads absent/0 as "no deadline" — exactly
        # the overdue jobs (negative remaining) must NOT decode as
        # deadline-free.  Jobs without a TTL leave the field unset, so
        # old consumers decode identically.
        remaining = record.deadline_remaining()
        if remaining is not None:
            payload.deadline_seconds = max(round(remaining, 3), 0.001)
        try:
            # carry the job span's context to the downstream converter so
            # its spans join this trace (submit -> job -> convert); a
            # NullTracer records nothing, so propagating its span ids
            # would hand the converter parents that exist nowhere
            tp = (None if isinstance(self.tracer, NullTracer)
                  else format_traceparent())
            headers = {"traceparent": tp} if tp else None

            async def _publish():
                if faults.enabled():
                    await faults.fire("publish", key=job_id)
                if getattr(self, "_convert_fanout", False):
                    await self.mq.publish_exchange(
                        schemas.CONVERT_EXCHANGE, schemas.encode(payload),
                        headers=headers,
                    )
                else:
                    await self.mq.publish(
                        schemas.CONVERT_QUEUE, schemas.encode(payload),
                        headers=headers,
                    )

            # broker blips ride the publish retry policy in-process; an
            # exhausted budget falls through to the classified settle
            await self.retrier.run("publish", _publish, cancel=token,
                                   record=record, logger=logger)
            record.event("publish", queue=schemas.CONVERT_QUEUE,
                         fanout=bool(getattr(self, "_convert_fanout", False)))
            if self.metrics is not None:
                self.metrics.messages_published.labels(
                    queue=schemas.CONVERT_QUEUE
                ).inc()
        except JobCancelled:
            raise  # cancel fired during a publish retry backoff
        except Exception as err:
            # the reference logs and returns without settling
            # (lib/main.js:161-166), which leaks the delivery.  Settle
            # through the classified path instead — crucially, publish
            # failures now COUNT toward the poison threshold (they
            # previously bypassed it, so a perpetually failing convert
            # publish redelivered forever): the idempotency marker makes
            # each redelivery skip straight to re-publishing, and a
            # hard-down broker trips the publish breaker + parks intake.
            # No ERRORED telemetry here: the media is fully staged, and
            # the reference never emitted one for publish trouble either.
            logger.error("failed to create job", error=str(err))
            record.event("error", type=type(err).__name__,
                         error=str(err)[:300])
            await self._settle_failed_attempt(
                job_id, delivery, logger, record, token, err,
                release_slot, why="publish_error", emit_errored=False)
            return

        # crash point "settle.ack" (platform/faults.py kind: crash): the
        # pre-ack seam — everything staged and published, the delivery
        # not yet settled.  A kill here is the redelivery-of-a-finished-
        # job case the idempotency probe + journal must absorb.
        if faults.enabled():
            await faults.fire("settle.ack", key=job_id)
        record.event("settle", mode="ack", why="done")
        self._journal_settle(record, "ack", "done")
        await delivery.ack()
        # success clears the poison counter: transient-failure retries that
        # eventually succeed must not count against a later redelivery
        self._clear_failures(job_id)
        if self.metrics is not None:
            self.metrics.jobs_completed.inc()
        self.registry.transition(record, control.DONE)
