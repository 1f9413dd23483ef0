"""Prometheus metrics.

Capability-equivalent to ``triton-core/prom``: a named registry
(``Prom.new('downloader')``) and an exposed ``/metrics`` endpoint
(``Prom.expose()``) at upstream lib/main.js:43-44, plus the counters
the platform lib kept for AMQP/telemetry internals (the prom handle is
passed into both at lib/main.js:46,49).

Unlike the reference (whose in-tree code records nothing itself), the
pipeline here records job/stage outcomes, durations, and byte counts.
"""

from __future__ import annotations

import time
from typing import Optional

from prometheus_client import (
    CollectorRegistry,
    Counter,
    Gauge,
    Histogram,
    generate_latest,
)


class Metrics:
    """The downloader's metric set, bound to its own registry."""

    def __init__(self, service: str = "downloader",
                 registry: Optional[CollectorRegistry] = None):
        self.service = service
        self.registry = registry or CollectorRegistry()
        ns = service.replace("-", "_")
        self.jobs_consumed = Counter(
            f"{ns}_jobs_consumed_total",
            "Download jobs consumed from the queue",
            registry=self.registry,
        )
        self.jobs_completed = Counter(
            f"{ns}_jobs_completed_total",
            "Jobs fully staged and acked",
            registry=self.registry,
        )
        self.jobs_failed = Counter(
            f"{ns}_jobs_failed_total",
            "Jobs that errored (nacked or dropped)",
            ["reason"],
            registry=self.registry,
        )
        self.jobs_skipped = Counter(
            f"{ns}_jobs_skipped_total",
            "Jobs skipped via the staging-bucket idempotency marker",
            registry=self.registry,
        )
        self.jobs_active = Gauge(
            f"{ns}_jobs_active",
            "Jobs currently being processed",
            registry=self.registry,
        )
        self.jobs_cancelled = Counter(
            f"{ns}_jobs_cancelled_total",
            "Jobs cancelled via the control plane (acked, not requeued)",
            registry=self.registry,
        )
        self.jobs_by_state = Gauge(
            f"{ns}_jobs_by_state",
            "Jobs known to the control-plane registry, by lifecycle state "
            "(live + the bounded terminal ring)",
            ["state"],
            registry=self.registry,
        )
        self.job_state_transitions = Counter(
            f"{ns}_job_state_transitions_total",
            "Control-plane registry lifecycle transitions",
            ["from_state", "to_state"],
            registry=self.registry,
        )
        self.jobs_parked = Counter(
            f"{ns}_jobs_parked_total",
            "Jobs parked by the fault-tolerance layer instead of failed "
            "(breaker open at admission/mid-job, or a delayed-redelivery "
            "backoff before a nack)",
            ["reason"],
            registry=self.registry,
        )
        self.dependency_retries = Counter(
            f"{ns}_dependency_retries_total",
            "In-process retries of transient dependency failures, by seam "
            "(store.put, http.fetch, publish, ...)",
            ["seam"],
            registry=self.registry,
        )
        self.dependency_request_seconds = Histogram(
            f"{ns}_dependency_request_seconds",
            "Latency of every dependency call made through the Retrier "
            "seams (store put/stat/bucket, publish, http origin, tracker, "
            "coord ops), per attempt: dependency = breaker/policy key, "
            "op = the exact seam, outcome = ok|transient|permanent|"
            "poison|cancelled.  The R.E.D. signal breaker thresholds and "
            "retry budgets are tuned against",
            ["dependency", "op", "outcome"],
            registry=self.registry,
            buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                     1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0),
        )
        self.breaker_state = Gauge(
            f"{ns}_breaker_state",
            "Per-dependency circuit-breaker state: 0=closed, 1=open, "
            "2=half-open",
            ["dependency"],
            registry=self.registry,
        )
        self.breaker_transitions = Counter(
            f"{ns}_breaker_transitions_total",
            "Circuit-breaker state transitions, by dependency and "
            "destination state",
            ["dependency", "to_state"],
            registry=self.registry,
        )
        self.breaker_opened = Counter(
            f"{ns}_breaker_opened_total",
            "Circuit-breaker opens with attribution: reason=failure "
            "(consecutive transient failures hit the threshold) vs "
            "reason=slow (the slow-call policy tripped on a sustained "
            "latency brownout — triage differently: the dependency is "
            "up, just unusable)",
            ["dependency", "reason"],
            registry=self.registry,
        )
        self.dependency_slow = Counter(
            f"{ns}_dependency_slow_total",
            "Answered dependency attempts that exceeded the breaker's "
            "slow_threshold_ms — the brownout signal behind a "
            "reason=slow breaker open",
            ["dependency"],
            registry=self.registry,
        )
        self.stage_seconds = Histogram(
            f"{ns}_stage_seconds",
            "Wall-clock seconds per pipeline stage",
            ["stage"],
            registry=self.registry,
        )
        # -- per-job hop ledger (platform/obs.py HopLedger) ------------
        self.hop_seconds_per_gb = Histogram(
            f"{ns}_hop_seconds_per_gb",
            "Seconds spent per gigabyte moved through each transfer hop "
            "(socket_read/splice/disk_write/hash/filter/upload/"
            "bucket_fetch/cache/h2d/compute/d2h), observed once per job "
            "at settle — the "
            "attribution the zero-copy staging work (ROADMAP item 3) "
            "ratchets against",
            ["hop"],
            registry=self.registry,
            buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0,
                     32.0, 64.0),
        )
        self.hop_bytes = Counter(
            f"{ns}_hop_bytes_total",
            "Bytes moved through each transfer hop (the weight behind "
            "hop_seconds_per_gb)",
            ["hop"],
            registry=self.registry,
        )
        self.hop_seconds = Counter(
            f"{ns}_hop_seconds_total",
            "Seconds spent in each transfer hop (with hop_bytes_total: "
            "fleet-wide where-does-a-gigabyte's-time-go attribution)",
            ["hop"],
            registry=self.registry,
        )
        self.staging_cpu_s_per_gb = Gauge(
            f"{ns}_staging_cpu_s_per_gb",
            "Copy-hop seconds per staged gigabyte for the most recently "
            "settled job (summed COPY_HOPS seconds over the widest "
            "hop's bytes) — the zero-copy staging ratchet's live "
            "headline number",
            registry=self.registry,
        )
        self.staging_hop_s_per_gb = Gauge(
            f"{ns}_staging_hop_s_per_gb",
            "Per-copy-hop seconds per gigabyte from the most recent "
            "settled job that exercised the hop — max() over the hop "
            "label is the current top offender the ratchet should "
            "attack next",
            ["hop"],
            registry=self.registry,
        )
        self.queue_wait_seconds = Histogram(
            f"{ns}_queue_wait_seconds",
            "Seconds from delivery receipt (RECEIVED) to admission "
            "(ADMITTED) — the disk-headroom gate's wait",
            registry=self.registry,
        )
        self.scheduler_wait_seconds = Histogram(
            f"{ns}_scheduler_wait_seconds",
            "Seconds from ADMITTED to acquiring a priority-scheduler "
            "run slot",
            registry=self.registry,
        )
        self.event_loop_lag = Gauge(
            f"{ns}_event_loop_lag_seconds",
            "Most recent event-loop scheduling lag sample (how late the "
            "loop woke the lag monitor's timer)",
            registry=self.registry,
        )
        self.event_loop_lag_hist = Histogram(
            f"{ns}_event_loop_lag",
            "Event-loop scheduling lag distribution, seconds",
            registry=self.registry,
            buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                     1.0, 2.5, 5.0),
        )
        self.tracer_buffer_spans = Gauge(
            f"{ns}_tracer_buffer_spans",
            "Finished spans held in the tracer's in-process buffer",
            registry=self.registry,
        )
        self.otlp_spans_exported = Gauge(
            f"{ns}_otlp_spans_exported",
            "Spans successfully shipped to the OTLP collector "
            "(monotonic; gauge because it is read from the exporter)",
            registry=self.registry,
        )
        self.otlp_spans_dropped = Gauge(
            f"{ns}_otlp_spans_dropped",
            "Spans dropped by the OTLP exporter (full queue or failed "
            "batches) — nonzero means traces are silently missing",
            registry=self.registry,
        )
        self.otlp_export_errors = Gauge(
            f"{ns}_otlp_export_errors",
            "Failed OTLP batch POSTs (collector down/unreachable)",
            registry=self.registry,
        )
        self.otlp_queue_depth = Gauge(
            f"{ns}_otlp_queue_depth",
            "Spans waiting in the OTLP exporter's send queue",
            registry=self.registry,
        )
        self.bytes_downloaded = Counter(
            f"{ns}_bytes_downloaded_total",
            "Bytes fetched by the download stage",
            ["protocol"],
            registry=self.registry,
        )
        self.bytes_uploaded = Counter(
            f"{ns}_bytes_uploaded_total",
            "Bytes staged by the upload stage",
            registry=self.registry,
        )
        self.messages_published = Counter(
            f"{ns}_messages_published_total",
            "Queue messages published",
            ["queue"],
            registry=self.registry,
        )
        self.frames_upscaled = Counter(
            f"{ns}_frames_upscaled_total",
            "Video frames run through the upscale stage's TPU model",
            registry=self.registry,
        )
        self.transcode_bytes_in = Counter(
            f"{ns}_transcode_bytes_in_total",
            "Source bytes (container or raw y4m) consumed by the "
            "upscale stage's transcode",
            registry=self.registry,
        )
        self.transcode_bytes_out = Counter(
            f"{ns}_transcode_bytes_out_total",
            "Output bytes (container or raw y4m) written by the upscale "
            "stage's transcode — out/in quantifies the staging size "
            "effect of the encode back-end",
            registry=self.registry,
        )
        self.cache_hits = Counter(
            f"{ns}_cache_hits_total",
            "Download jobs served from the content-addressed staging cache",
            registry=self.registry,
        )
        self.cache_misses = Counter(
            f"{ns}_cache_misses_total",
            "Cacheable downloads that had to fetch from the network",
            registry=self.registry,
        )
        self.cache_coalesced = Counter(
            f"{ns}_cache_coalesced_waiters_total",
            "Jobs that awaited another job's in-flight fetch of the same "
            "content (singleflight fan-in)",
            registry=self.registry,
        )
        self.cache_bytes_saved = Counter(
            f"{ns}_cache_bytes_saved_total",
            "Bytes served from cache or coalesced fetches instead of "
            "re-downloaded over the network",
            registry=self.registry,
        )
        self.cache_evicted_bytes = Counter(
            f"{ns}_cache_evicted_bytes_total",
            "Bytes LRU-evicted from the staging cache",
            registry=self.registry,
        )
        self.scrub_objects = Counter(
            f"{ns}_scrub_objects_total",
            "Integrity-scrubber verdicts per object scanned (clean = "
            "digest matched; repaired = re-copied from a healthy "
            "replica into a fresh inode; quarantined = no healthy "
            "source, moved aside — never served)",
            ["outcome"],
            registry=self.registry,
        )
        # -- fleet coordination plane (fleet/) ------------------------
        self.fleet_workers_live = Gauge(
            f"{ns}_fleet_workers_live",
            "Workers with a live heartbeat in the fleet registry "
            "(sampled at this worker's own heartbeat)",
            registry=self.registry,
        )
        self.fleet_leases_acquired = Counter(
            f"{ns}_fleet_leases_acquired_total",
            "Cross-worker content leases this worker won, by mode "
            "(fresh, or takeover of a dead leader's expired lease)",
            ["mode"],
            registry=self.registry,
        )
        self.fleet_lease_waits = Counter(
            f"{ns}_fleet_lease_waits_total",
            "Jobs that parked waiting out a peer worker's content lease "
            "instead of duplicating its download",
            registry=self.registry,
        )
        self.fleet_shared_hits = Counter(
            f"{ns}_fleet_shared_tier_hits_total",
            "Cache entries materialized from the fleet shared tier "
            "instead of an origin",
            registry=self.registry,
        )
        self.fleet_shared_fills = Counter(
            f"{ns}_fleet_shared_tier_fills_total",
            "Local cache entries spilled to the fleet shared tier",
            registry=self.registry,
        )
        self.fleet_shared_bytes = Counter(
            f"{ns}_fleet_shared_tier_bytes_total",
            "Bytes moved through the fleet shared tier, by direction "
            "(out = spilled by this worker, in = materialized from peers)",
            ["direction"],
            registry=self.registry,
        )
        self.fleet_coord_errors = Counter(
            f"{ns}_fleet_coord_errors_total",
            "Coordination-store failures, by operation — each one is a "
            "moment this worker degraded toward uncoordinated fetching",
            ["op"],
            registry=self.registry,
        )
        self.fleet_gc_removed = Counter(
            f"{ns}_fleet_gc_removed_total",
            "Objects reclaimed by the fleet GC sweep, by kind "
            "(shared_entry = an evicted .fleet-cache/ entry, tombstone = "
            "a compacted .fleet/ coordination tombstone, telemetry = an "
            "aged .fleet/telemetry/ per-job trace digest)",
            ["kind"],
            registry=self.registry,
        )
        self.fleet_telemetry = Counter(
            f"{ns}_fleet_telemetry_digests_total",
            "Per-job trace-digest traffic through the coordination store, "
            "by op (published = digest written at settle, fetched = "
            "digests read during cross-worker trace assembly, error = "
            "either direction degraded)",
            ["op"],
            registry=self.registry,
        )
        self.fleet_gc_bytes = Counter(
            f"{ns}_fleet_gc_reclaimed_bytes_total",
            "Bytes reclaimed from the fleet shared cache tier by the GC "
            "sweep",
            registry=self.registry,
        )
        self.fleet_fenced_writes = Counter(
            f"{ns}_fleet_fenced_writes_total",
            "Cross-worker writes REJECTED by fencing-token enforcement, "
            "by op (shared_manifest = a stale leader's shared-tier "
            "publish, done_marker = a stale seal of the staging set, "
            "telemetry = a stale trace digest).  Each count is a "
            "split-brain write that did NOT land — nonzero during a "
            "partition/stall incident is the fence doing its job",
            ["op"],
            registry=self.registry,
        )
        self.fleet_watch_wakeups = Counter(
            f"{ns}_fleet_watch_wakeups_total",
            "Watch-plane wake-ups, by mode (event = the watch delivered "
            "changes, timeout = a bounded long-poll lapsed quiet, poll = "
            "degraded to sleep-poll because the watch was unavailable or "
            "broke).  A healthy fleet is event/timeout-dominated; a "
            "poll-dominated worker is running the degraded path",
            ["mode"],
            registry=self.registry,
        )
        self.fleet_origin_health = Counter(
            f"{ns}_fleet_origin_health_total",
            "Fleet-shared origin-health table traffic, by op (published "
            "= this worker CAS-merged its per-origin EWMAs, seeded = a "
            "boot imported fresh fleet rows into its local OriginHealth)",
            ["op"],
            registry=self.registry,
        )
        self.fleet_router_decisions = Counter(
            f"{ns}_fleet_router_decisions_total",
            "Content-router admission decisions, by outcome (run = no "
            "routing concern, defer = handed to the current lease "
            "holder via park+nack, fairness_defer = BULK deferred for "
            "fleet-wide tenant fairness, shed = BULK shed on the "
            "controller's plan, local = routing skipped because the "
            "holder is this worker)",
            ["outcome"],
            registry=self.registry,
        )
        self.fleet_controller_decisions = Counter(
            f"{ns}_fleet_controller_decisions_total",
            "Placement/autoscale controller decisions published on the "
            "fleet plan, by kind (shed_bulk = burn-rate-driven BULK "
            "admission shed, drain = a browning-out worker steered away "
            "from new leases, scale_up/scale_down = queue-depth scale "
            "signal edges, plan = a plan document published)",
            ["kind"],
            registry=self.registry,
        )
        self.fleet_plan_age = Gauge(
            f"{ns}_fleet_plan_age_seconds",
            "Age of the placement-controller plan document this worker "
            "last read (steady state: under 2x fleet.heartbeat_interval;"
            " climbing = the elected controller stopped planning).  -1 "
            "until a plan has been seen",
            registry=self.registry,
        )
        self.fleet_desired_workers = Gauge(
            f"{ns}_fleet_desired_workers",
            "Worker count the placement controller's plan currently "
            "asks for (the queue-depth autoscale signal, exported for "
            "external autoscalers; -1 until a plan has been seen)",
            registry=self.registry,
        )
        # -- SLO plane (control/slo.py) --------------------------------
        # "class" is bounded by the priority-class enum plus the
        # config-bounded tenant-objective names; "window" is the
        # fast|slow literal pair
        self.slo_burn_rate = Gauge(
            f"{ns}_slo_burn_rate",
            "Error-budget burn rate per SLO objective and window "
            "(fast ~5 m / slow ~1 h): bad_fraction / (1 - availability)."
            "  1.0 spends the budget exactly at the allowed rate; "
            "sustained > 1 on BOTH windows is the page condition",
            ["class", "window"],
            registry=self.registry,
        )
        self.slo_budget_remaining = Gauge(
            f"{ns}_slo_error_budget_remaining",
            "Fraction of the error budget left per SLO objective over "
            "slo.budget_window (1 = untouched, 0 = exhausted; clamped "
            "at 0)",
            ["class"],
            registry=self.registry,
        )
        # -- incident plane (downloader_tpu_torch/incident) ------------------
        # "trigger" is bounded by the two code literals breach|manual
        # (incident/bundle.py TRIGGER_BREACH / TRIGGER_MANUAL)
        self.incident_bundles = Counter(
            f"{ns}_incident_bundles_total",
            "Incident bundles exported into the bounded ring, by "
            "trigger (breach = auto-export at a budget-burning settle; "
            "manual = admin API / CLI).  A breach-trigger rate above "
            "the slo_burn_rate page condition means the ring "
            "(incident.max_bundles) is evicting forensics — raise it "
            "or pull bundles off the worker faster",
            ["trigger"],
            registry=self.registry,
        )
        self.incident_replay_signature_match = Gauge(
            f"{ns}_incident_replay_signature_match",
            "1 when the latest incident replay reproduced the original "
            "breach signature (same objective classes, open-breaker "
            "dependency+reason, guilty hop, fencing verdict), 0 when "
            "it diverged; -1 until a replay has run.  Set by the bench "
            "--incident arm and `cli incident replay`",
            registry=self.registry,
        )
        self.incident_replay_signature_match.set(-1.0)
        self.fleet_overview_age = Gauge(
            f"{ns}_fleet_overview_age_seconds",
            "Age of the fleet-overview document this worker last "
            "published or read (steady state: under 2x "
            "fleet.heartbeat_interval; climbing = the elected "
            "aggregator stopped folding, or the coordination store is "
            "unreachable).  -1 until an overview has been seen",
            registry=self.registry,
        )
        # -- multi-tenant overload control (control/tenancy+overload) --
        self.jobs_shed = Counter(
            f"{ns}_jobs_shed_total",
            "Deliveries shed by the overload layer, by reason (loop_lag/"
            "disk_headroom/queue_depth/queue_age = saturation park+nack; "
            "deadline = TTL-expired BULK dropped as EXPIRED) and tenant",
            ["reason", "tenant"],
            registry=self.registry,
        )
        self.tenant_jobs = Counter(
            f"{ns}_tenant_jobs_total",
            "Settled deliveries per tenant, by terminal lifecycle state "
            "(the per-tenant slice of the job outcome counters)",
            ["tenant", "outcome"],
            registry=self.registry,
        )
        self.tenant_queue_depth = Gauge(
            f"{ns}_tenant_queue_depth",
            "Jobs accepted but not yet running, per tenant (the "
            "per-tenant breakdown of queue_depth; label set bounded by "
            "the configured tenants)",
            ["tenant"],
            registry=self.registry,
        )
        self.overload_saturated = Gauge(
            f"{ns}_overload_saturated",
            "1 while the overload controller considers this worker "
            "saturated (BULK work is being shed), else 0",
            registry=self.registry,
        )
        # -- autoscale signal trio (ROADMAP item 5's fleet contract) --
        self.queue_depth = Gauge(
            f"{ns}_queue_depth",
            "Jobs accepted but not yet running (RECEIVED/PARKED/"
            "ADMITTED) — the primary scale-out signal",
            registry=self.registry,
        )
        self.oldest_queued_seconds = Gauge(
            f"{ns}_oldest_queued_job_seconds",
            "Age of the oldest not-yet-running job — queue depth alone "
            "cannot distinguish a burst from a stall",
            registry=self.registry,
        )
        self.cache_headroom_bytes = Gauge(
            f"{ns}_cache_disk_headroom_bytes",
            "Free bytes on the cache (or download) volume — the "
            "scale-DOWN guard: a worker without disk headroom is not "
            "spare capacity",
            registry=self.registry,
        )
        # -- crash-safe durability (control/journal.py) ----------------
        self.jobs_recovered = Counter(
            f"{ns}_jobs_recovered_total",
            "Startup-reconciliation outcomes after a crash, by kind "
            "(replayed = journal job restored as a PARKED placeholder, "
            "resumable = workdir kept for its expected redelivery, "
            "demoted = torn landed output deleted for re-fetch, "
            "swept = orphan workdir deleted, adopted = redelivery took "
            "over its placeholder, cancelled = placeholder cancelled "
            "during the replay window, expired = placeholder or cancel "
            "tombstone retired past journal.tombstone_ttl — its "
            "redelivery never came, staged_elsewhere = placeholder "
            "retired DONE because a fleet peer's done marker proves the "
            "content already staged)",
            ["outcome"],
            registry=self.registry,
        )
        # -- bounded-growth gauges (the soak harness's SLO inputs) -----
        self.journal_bytes = Gauge(
            f"{ns}_journal_bytes",
            "Size of the job journal file on disk — compaction "
            "(journal.max_bytes) must hold this bounded by live-job "
            "count, not process age; a sustained climb means "
            "compaction is stalled or the live set itself is growing",
            registry=self.registry,
        )
        self.journal_lines = Gauge(
            f"{ns}_journal_lines",
            "Lines in the job journal file (one per lifecycle event "
            "since the last compaction snapshot) — the replay cost a "
            "restart would pay right now",
            registry=self.registry,
        )
        self.coord_docs = Gauge(
            f"{ns}_fleet_coord_docs_total",
            "Documents in the fleet coordination store per key prefix "
            "(workers / leases / telemetry), censused by the elected "
            "GC sweeper each fleet.gc_interval — growth here is a GC "
            "stall: telemetry digests and tombstones otherwise accrete "
            "one per job forever",
            ["prefix"],
            registry=self.registry,
        )
        self.recorder_ring_evictions = Counter(
            f"{ns}_recorder_ring_evictions_total",
            "Flight-recorder events evicted from per-job rings "
            "(obs.recorder_events), counted when each job settles — a "
            "high rate means long/chatty jobs are losing their early "
            "timeline and debug bundles show only the tail",
            registry=self.registry,
        )
        self.manifest_mismatches = Counter(
            f"{ns}_staged_manifest_mismatches_total",
            "Jobs whose staged objects failed the pre-done-marker "
            "content-manifest verification (short, missing, or "
            "hash-divergent staging set) — each one is a torn publish "
            "that was caught before the converter could trust it",
            registry=self.registry,
        )
        self.tenant_staging_bytes = Gauge(
            f"{ns}_tenant_staging_bytes",
            "Live staging footprint per tenant: bytes on disk under "
            "non-terminal jobs' workdirs (the disk half of per-tenant "
            "accounting; quotas cover transfer rate only)",
            ["tenant"],
            registry=self.registry,
        )
        # -- origin plane (downloader_tpu_torch/origins/) --------------------
        # label cardinality is bounded by origins.max_labels (overflow
        # collapses to "other"), the tenant-table posture: job payloads
        # must not mint Prometheus series
        self.origin_bytes = Counter(
            f"{ns}_origin_bytes_total",
            "Bytes landed from each origin by the racing fetcher / "
            "manifest ingest (who actually served the fleet's bytes)",
            ["origin"],
            registry=self.registry,
        )
        self.origin_active_ranges = Gauge(
            f"{ns}_origin_active_ranges",
            "Byte ranges currently being fetched from each origin by "
            "the racing scheduler (owners + straggler duplicates)",
            ["origin"],
            registry=self.registry,
        )
        self.origin_race_wins = Counter(
            f"{ns}_origin_race_win_total",
            "Ranges an origin completed, by how it got them: fastest = "
            "work-stealing pull, failover = re-assigned after another "
            "origin died mid-range, straggler_dup = duplicate tail "
            "fetch that beat the original owner (first-byte-wins)",
            ["origin", "reason"],
            registry=self.registry,
        )
        self.torrent_hash_failures = Counter(
            f"{ns}_torrent_piece_hash_failures_total",
            "Torrent pieces that failed SHA-1 verification",
            registry=self.registry,
        )
        self.torrent_bytes_served = Counter(
            f"{ns}_torrent_bytes_served_total",
            "Bytes served back to the swarm while leeching/seeding",
            registry=self.registry,
        )

    def bind_tracer(self, tracer) -> None:
        """Surface tracer/OTLP-exporter internals on ``/metrics``.

        The exporter deliberately swallows failures in-flight (tracing
        must never fail the pipeline), which made them invisible; these
        gauges read its counters at scrape time, so a down collector
        shows up as climbing ``otlp_export_errors``/``otlp_spans_dropped``
        instead of silently missing traces.
        """
        self.tracer_buffer_spans.set_function(
            lambda: float(tracer.buffer_depth())
        )
        exporter = getattr(tracer, "exporter", None)
        if exporter is None:
            return
        self.otlp_spans_exported.set_function(
            lambda: float(exporter.exported))
        self.otlp_spans_dropped.set_function(
            lambda: float(exporter.dropped))
        self.otlp_export_errors.set_function(
            lambda: float(exporter.errors))
        self.otlp_queue_depth.set_function(
            lambda: float(exporter._queue.qsize()))

    def bind_journal(self, journal) -> None:
        """Wire the journal growth gauges to a live
        :class:`~..control.journal.JobJournal`.

        ``journal_bytes`` stats the file at scrape time (one syscall);
        ``journal_lines`` reads the in-memory census the journal
        maintains across appends and compactions.  Together they are
        the bounded-growth signal the soak harness guards on: the file
        must stay O(live jobs) no matter how many jobs have settled.
        """
        self.journal_bytes.set_function(
            lambda: float(journal.size_bytes))
        self.journal_lines.set_function(
            lambda: float(journal.lines))

    def bind_slo(self, tracker) -> None:
        """Wire the SLO gauges to a live
        :class:`~..control.slo.SloTracker`.

        The label set is fixed at bind time (priority classes + the
        config-bounded tenant objectives); every gauge reads the
        tracker's memoized snapshot, so one scrape pays one bounded
        ring scan however many objective/window series exist.
        """
        def entry(name: str) -> dict:
            return tracker.snapshot()["objectives"].get(name) or {}

        for name in tracker.objective_names():
            self.slo_burn_rate.labels(
                **{"class": name, "window": "fast"}).set_function(
                lambda n=name: float(entry(n).get("burnFast", 0.0)))
            self.slo_burn_rate.labels(
                **{"class": name, "window": "slow"}).set_function(
                lambda n=name: float(entry(n).get("burnSlow", 0.0)))
            self.slo_budget_remaining.labels(
                **{"class": name}).set_function(
                lambda n=name: float(
                    entry(n).get("budgetRemaining", 1.0)))

    def bind_overview_age(self, age_fn) -> None:
        """Wire ``fleet_overview_age_seconds`` to the fleet plane's
        last-seen overview stamp (``FleetPlane.overview_age``; None
        until any overview doc has been published or read -> -1)."""
        def _age() -> float:
            age = age_fn()
            return float(age) if age is not None else -1.0

        self.fleet_overview_age.set_function(_age)

    def bind_autoscale(self, signals_fn) -> None:
        """Wire the autoscale trio to a live snapshot callable.

        ``signals_fn`` returns ``{"queue_depth": int,
        "oldest_queued_seconds": float, "cache_headroom_bytes": int}``
        (the orchestrator's :meth:`autoscale_signals`); the gauges read
        it at scrape time, so /metrics and the fleet heartbeat payload
        report the SAME numbers by construction.  One snapshot is
        shared by all three gauges (a sub-second memo): a scrape pays
        one registry scan and one statvfs, not three of each.
        """
        memo = {"at": 0.0, "snap": None}

        def _snapshot() -> dict:
            now = time.monotonic()
            if memo["snap"] is None or now - memo["at"] > 0.5:
                memo["snap"] = signals_fn()
                memo["at"] = now
            return memo["snap"]

        self.queue_depth.set_function(
            lambda: float(_snapshot()["queue_depth"]))
        self.oldest_queued_seconds.set_function(
            lambda: float(_snapshot()["oldest_queued_seconds"]))
        self.cache_headroom_bytes.set_function(
            lambda: float(_snapshot()["cache_headroom_bytes"]))

    def bind_tenants(self, names, depths_fn) -> None:
        """Wire the per-tenant queue-depth gauges to a live snapshot.

        ``names`` is the config-bounded tenant set (so the label
        cardinality is fixed at bind time); ``depths_fn`` returns
        ``{tenant: queued_depth}`` (``JobRegistry.tenant_queue_depths``).
        One memoized snapshot serves every label per scrape, mirroring
        :meth:`bind_autoscale`.
        """
        memo = {"at": 0.0, "snap": None}

        def _snapshot() -> dict:
            now = time.monotonic()
            if memo["snap"] is None or now - memo["at"] > 0.5:
                memo["snap"] = depths_fn()
                memo["at"] = now
            return memo["snap"]

        for name in names:
            self.tenant_queue_depth.labels(tenant=name).set_function(
                lambda n=name: float(_snapshot().get(n, 0))
            )

    def bind_tenant_staging(self, names, footprint_fn) -> None:
        """Wire the per-tenant staging-footprint gauges to a live walk.

        ``footprint_fn`` returns ``{tenant: bytes_on_disk}``
        (``Orchestrator.tenant_staging_bytes`` — itself memoized for a
        few seconds, since the walk stats real workdirs); the label set
        is the config-bounded tenant list, like :meth:`bind_tenants`.
        """
        memo = {"at": 0.0, "snap": None}

        def _snapshot() -> dict:
            now = time.monotonic()
            if memo["snap"] is None or now - memo["at"] > 0.5:
                memo["snap"] = footprint_fn()
                memo["at"] = now
            return memo["snap"]

        for name in names:
            self.tenant_staging_bytes.labels(tenant=name).set_function(
                lambda n=name: float(_snapshot().get(n, 0))
            )

    def render(self) -> bytes:
        """Prometheus text exposition of the registry."""
        return generate_latest(self.registry)


def new(service: str = "downloader") -> Metrics:
    """(reference ``Prom.new('downloader')``, lib/main.js:43)"""
    return Metrics(service)
