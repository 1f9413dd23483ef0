"""Job registry: the control plane's source of truth for job lifecycle.

The reference's only job visibility is the inverted ``/health`` counter
(upstream lib/main.js:174-194): an operator cannot list, inspect,
or intervene in work.  The registry records every delivery from the
moment it is received — *before* admission, closing the pre-r7 blind
spot where a job parked in the admission gate was invisible to
``/health`` and drain — and walks it through a validated state machine:

    RECEIVED -> ADMITTED -> RUNNING(stage) -> PUBLISHING
                                 -> DONE | FAILED | CANCELLED | DROPPED_POISON

``stage`` is the sequential stage name under the barrier dispatch
(download/process/upload[/upscale]); the streaming dispatch runs all
three logical stages overlapped and carries one combined
``RUNNING("pipeline")`` attribution instead — per-file detail rides the
flight recorder's ``file_complete``/``upload_start``/``upload_done``
events, and ``stage_seconds`` accumulates under ``"pipeline"``.

Illegal transitions raise :class:`IllegalTransition` (a lifecycle bug
must fail loudly, not corrupt operator-facing state).  Each record keeps
per-stage wall timing, byte counters sampled from stage progress, and
the cancel token the admin API fires.  Terminal records move to a
bounded ring for post-hoc inspection (``GET /v1/jobs`` keeps answering
for recently finished work without growing forever).

Metrics: ``jobs_by_state`` gauge (every record the registry knows, by
state) and ``job_state_transitions_total`` counter (from/to labels).

Observability (platform/obs.py): every record carries a
:class:`~..platform.obs.FlightRecorder` — a bounded ring of structured
events (state transitions with per-stage timing, throughput samples,
cache/retry/cancel/settle decisions, span references) served live by
``GET /v1/jobs/{id}/events``.  A record closing as FAILED or
DROPPED_POISON logs a debug bundle (the tail of its timeline + its
trace id), so a dead job's post-mortem is one log line away even after
the terminal ring evicts it.
"""

from __future__ import annotations

import collections
import itertools
import time
from typing import Any, Deque, Dict, List, Optional

from ..platform.obs import DEFAULT_EVENT_LIMIT, FlightRecorder, HopLedger
from ..utils import utcnow_iso as _utcnow_iso
from .cancel import CancelToken

# -- lifecycle states ---------------------------------------------------
RECEIVED = "RECEIVED"
PARKED = "PARKED"
ADMITTED = "ADMITTED"
RUNNING = "RUNNING"
PUBLISHING = "PUBLISHING"
DONE = "DONE"
FAILED = "FAILED"
CANCELLED = "CANCELLED"
DROPPED_POISON = "DROPPED_POISON"
# deadline-expired BULK work dropped by the overload layer
# (control/overload.py): distinct from FAILED (nothing errored) and from
# DROPPED_POISON (the content is fine) — the job simply outlived its
# submitter-declared TTL while queued, and re-running it would waste the
# very capacity the deadline exists to protect
EXPIRED = "EXPIRED"

TERMINAL_STATES = frozenset({DONE, FAILED, CANCELLED, DROPPED_POISON,
                             EXPIRED})

# RUNNING -> RUNNING models stage hops (download -> process -> upload);
# ADMITTED -> PUBLISHING is the idempotency skip (done marker already
# staged); FAILED is reachable from anywhere non-terminal (a handler can
# die at any point and the record must still close).  PARKED is the
# fault-tolerance layer's holding state (platform/errors.py): a job
# waiting out an open dependency breaker at admission, or sitting in a
# delayed-redelivery backoff before its nack — visible in
# ``jobs_by_state`` instead of masquerading as stuck RECEIVED/RUNNING.
LEGAL_TRANSITIONS: Dict[str, frozenset] = {
    # EXPIRED is reachable only BEFORE a job runs (RECEIVED/PARKED/
    # ADMITTED): a deadline noticed mid-transfer finishes the work — the
    # bytes are mostly paid for, and the deadline's purpose is to shed
    # *queued* backlog, not to waste a nearly-done transfer
    RECEIVED: frozenset({PARKED, ADMITTED, FAILED, CANCELLED, EXPIRED}),
    # PARKED -> RUNNING: a job parked MID-RUN (waiting out a peer
    # worker's content lease, fleet/plane.py) resumes its stage when
    # the leader publishes; admission-parked jobs still go via ADMITTED.
    # PARKED -> RECEIVED: a crash-recovery placeholder (control/
    # journal.py) is adopted by its redelivery and re-enters the normal
    # intake path from the top — one record carries both incarnations.
    # PARKED -> DONE: a recovery placeholder whose content a fleet PEER
    # already staged (durable done marker observed) is retired without
    # a local run — its redelivery went to the peer and will never
    # arrive here (orchestrator._probe_recovered_staged).
    PARKED: frozenset(
        {RECEIVED, ADMITTED, RUNNING, DONE, FAILED, CANCELLED,
         DROPPED_POISON, EXPIRED}
    ),
    ADMITTED: frozenset(
        {RUNNING, PARKED, PUBLISHING, FAILED, CANCELLED, DROPPED_POISON,
         EXPIRED}
    ),
    RUNNING: frozenset(
        {RUNNING, PARKED, PUBLISHING, FAILED, CANCELLED, DROPPED_POISON}
    ),
    # DROPPED_POISON from PUBLISHING: publish failures count toward the
    # poison threshold too (they used to bypass it and redeliver forever)
    PUBLISHING: frozenset(
        {PARKED, DONE, FAILED, CANCELLED, DROPPED_POISON}
    ),
    DONE: frozenset(),
    FAILED: frozenset(),
    CANCELLED: frozenset(),
    DROPPED_POISON: frozenset(),
    EXPIRED: frozenset(),
}

DEFAULT_TERMINAL_RING = 256
# flight-recorder events kept in a terminal debug bundle log line
DEBUG_BUNDLE_EVENTS = 20


class IllegalTransition(RuntimeError):
    """A lifecycle move the state machine forbids."""


class JobRecord:
    """One delivery's lifecycle, as the control plane sees it."""

    __slots__ = (
        "uid", "job_id", "file_id", "priority", "state", "stage", "reason",
        "percent", "bytes", "cancel", "created_at", "updated_at",
        "stage_seconds", "_entered_mono", "_created_mono",
        "recorder", "trace_id", "span_id", "transferred", "retry",
        "worker_id", "tenant", "ttl_seconds", "deadline_mono",
        "recovered", "hops", "fleet_fence", "fleet_fence_key",
        "fleet_waited_s", "workload",
        "route_key", "route_decision", "plan_epoch",
    )

    def __init__(self, uid: int, job_id: str, file_id: str, priority: str,
                 recorder_events: int = DEFAULT_EVENT_LIMIT,
                 worker_id: Optional[str] = None,
                 tenant: str = "default",
                 ttl_seconds: float = 0.0,
                 hop_ledger: bool = True):
        self.uid = uid
        self.job_id = job_id
        self.file_id = file_id
        self.priority = priority
        # resolved tenant identity (control/tenancy.py): the axis the
        # scheduler's weighted-fair pick, the per-tenant quotas, and the
        # shed metrics attribute this delivery to
        self.tenant = tenant
        # optional deadline: Download.ttl_seconds measured from receipt;
        # 0 = none.  deadline_mono is the absolute monotonic cutoff.
        self.ttl_seconds = float(ttl_seconds or 0.0)
        self.deadline_mono: Optional[float] = None
        # which worker processed this delivery: stamped into the record,
        # every flight-recorder event (recorder context below), the
        # job's child logger, and GET /v1/jobs — the cross-worker join
        # key beside trace_id once a fleet of workers shares traffic
        self.worker_id = worker_id
        self.state = RECEIVED
        self.stage: Optional[str] = None
        self.reason: Optional[str] = None
        self.percent: Optional[int] = None
        self.bytes: Dict[str, int] = {}
        self.cancel = CancelToken(job_id)
        self.created_at = _utcnow_iso()
        self.updated_at = self.created_at
        self.stage_seconds: Dict[str, float] = {}
        self._created_mono = time.monotonic()
        self._entered_mono = self._created_mono
        if self.ttl_seconds > 0:
            self.deadline_mono = self._created_mono + self.ttl_seconds
        # per-job flight recorder (platform/obs.py): the job's bounded
        # event timeline, served by GET /v1/jobs/{id}/events.  The
        # tenant joins the context only when non-default, so a
        # single-tenant deployment's event stream is unchanged.
        context: Dict[str, Any] = {}
        if worker_id:
            context["workerId"] = worker_id
        if tenant and tenant != "default":
            context["tenant"] = tenant
        self.recorder = FlightRecorder(
            recorder_events, context=context or None,
        )
        # correlation ids: the job span's W3C trace/span id, also bound
        # into the job's child logger — one id joins log lines, the
        # OTLP span, and this record's timeline
        self.trace_id: Optional[str] = None
        self.span_id: Optional[str] = None
        # crash-recovery provenance (control/journal.py): True on a
        # record replayed from the journal at boot — first as the PARKED
        # "awaiting redelivery" placeholder, then carried through the
        # adopting redelivery, so GET /v1/jobs?recovered= can list the
        # jobs that survived a worker kill
        self.recovered = False
        # live retry/backoff detail (platform/errors.py): the Retrier
        # sets it while a dependency call is between attempts, the
        # orchestrator while the job is parked for delayed redelivery —
        # so GET /v1/jobs/{id} and `cli jobs show` answer "is this job
        # stuck or deliberately waiting" at a glance
        self.retry: Optional[Dict[str, Any]] = None
        # live mid-transfer byte counters (absolute, per kind), fed by
        # the stages' chunk loops and sampled by the TransferProfiler;
        # unlike ``bytes`` (committed at stage completion) these move
        # WHILE a transfer runs, so a stalled job is visibly flat
        self.transferred: Dict[str, int] = {}
        # per-hop byte+time attribution (platform/obs.py HopLedger), fed
        # by the stages' transfer loops; None (``obs.hop_ledger: false``)
        # makes note_hop a no-op — the bench's disabled/enabled A-B leg
        self.hops: Optional[HopLedger] = HopLedger() if hop_ledger else None
        # fencing context (fleet/plane.py): the content-lease fence this
        # job's origin authority derives from — stamped when the job
        # wins a fleet lease, carried into every cross-worker write
        # (shared-tier manifest, done marker, telemetry digest) so a
        # resumed stale leader's writes are rejectable
        self.fleet_fence: Optional[int] = None
        self.fleet_fence_key: Optional[str] = None
        # cumulative seconds this job has parked on fleet lease waits,
        # carried ACROSS redeliveries/coordination errors so the
        # fleet.max_wait livelock bound holds under a flapping coord
        # store (each re-park used to reset the clock)
        self.fleet_waited_s = 0.0
        # workload class (control/slo.py WORKLOAD_CLASSES): stamped by a
        # stage that ran a chip-bound subsystem (the upscale stage sets
        # "UPSCALE"), so the job ALSO burns that subsystem's SLO budget
        self.workload: Optional[str] = None
        # placement context (fleet/router.py + the controller plan):
        # the content route key, the router's admission outcome, and
        # the plan epoch in force when this delivery was admitted —
        # joined onto slo_breach events and incident bundles so a
        # breach explains WHERE the job was when it burned
        self.route_key: Optional[str] = None
        self.route_decision: Optional[str] = None
        self.plan_epoch: Optional[int] = None

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL_STATES

    def deadline_expired(self, now: Optional[float] = None) -> bool:
        """True once the job's TTL (if any) has elapsed since receipt."""
        if self.deadline_mono is None:
            return False
        return (now if now is not None else time.monotonic()) \
            >= self.deadline_mono

    def deadline_remaining(self) -> Optional[float]:
        """Seconds until the deadline (negative = overdue); None = no TTL."""
        if self.deadline_mono is None:
            return None
        return self.deadline_mono - time.monotonic()

    def event(self, kind: str, **fields: Any) -> None:
        """Append one flight-recorder event to this job's timeline."""
        self.recorder.record(kind, **fields)

    def add_bytes(self, kind: str, count: int) -> None:
        """Stage-side byte sampling (downloaded/uploaded so far)."""
        if count:
            self.bytes[kind] = self.bytes.get(kind, 0) + int(count)

    def note_transfer(self, kind: str, total: int) -> None:
        """Live absolute transfer counter (cheap: called per chunk)."""
        self.transferred[kind] = int(total)

    def note_hop(self, hop: str, nbytes: int, seconds: float) -> None:
        """Accumulate one hop sample (cheap: called per chunk/slice)."""
        if self.hops is not None:
            self.hops.note(hop, nbytes, seconds)

    def note_progress(self, percent: int) -> None:
        self.percent = int(percent)
        self.updated_at = _utcnow_iso()

    def to_dict(self) -> dict:
        """JSON shape served by ``GET /v1/jobs[/{id}]``."""
        remaining = self.deadline_remaining()
        return {
            "id": self.job_id,
            "fileId": self.file_id,
            "priority": self.priority,
            "tenant": self.tenant,
            "ttlSeconds": self.ttl_seconds or None,
            "deadlineRemainingSeconds": (
                round(remaining, 3) if remaining is not None else None
            ),
            "workerId": self.worker_id,
            "state": self.state,
            "stage": self.stage,
            "reason": self.reason,
            "percent": self.percent,
            "bytes": dict(self.bytes),
            "retry": dict(self.retry) if self.retry else None,
            "recovered": self.recovered,
            "cancelRequested": self.cancel.cancelled,
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "createdAt": self.created_at,
            "updatedAt": self.updated_at,
            "ageSeconds": round(time.monotonic() - self._created_mono, 3),
            "stageSeconds": {
                k: round(v, 3) for k, v in self.stage_seconds.items()
            },
            "hopLedger": (self.hops.summary()
                          if self.hops is not None and self.hops else None),
            "fleetFence": self.fleet_fence,
            "placement": ({
                "routeKey": self.route_key,
                "routeDecision": self.route_decision,
                "planEpoch": self.plan_epoch,
            } if (self.route_key or self.route_decision
                  or self.plan_epoch is not None) else None),
        }


class JobRegistry:
    """Registry of live jobs + a bounded ring of terminal ones.

    Single-event-loop discipline (like the orchestrator's other state):
    every mutation happens on the loop, so no lock is needed.
    """

    def __init__(self, metrics=None, terminal_ring: int = DEFAULT_TERMINAL_RING,
                 logger=None, recorder_events: int = DEFAULT_EVENT_LIMIT,
                 worker_id: Optional[str] = None, journal=None,
                 hop_ledger: bool = True):
        self.metrics = metrics
        self.logger = logger
        self.worker_id = worker_id
        # per-hop transfer attribution (``obs.hop_ledger``, default on):
        # False hands records no ledger, so every note_hop is a no-op
        self.hop_ledger = bool(hop_ledger)
        # crash-safe durability (control/journal.py): every register/
        # transition appends one journal line, so a killed worker's
        # replacement can replay the lifecycle it lost.  None = the
        # exact pre-journal in-memory-only registry.
        self.journal = journal
        self.recorder_events = max(int(recorder_events), 1)
        self.terminal_ring = max(int(terminal_ring), 0)
        self._active: "collections.OrderedDict[int, JobRecord]" = (
            collections.OrderedDict()
        )
        self._ring: Deque[JobRecord] = collections.deque()
        self._seq = itertools.count(1)

    # -- metrics helpers -----------------------------------------------
    def _gauge(self, state: str, delta: int) -> None:
        if self.metrics is not None:
            self.metrics.jobs_by_state.labels(state=state).inc(delta)

    # -- lifecycle ------------------------------------------------------
    def register(self, job_id: str, file_id: str,
                 priority: str = "NORMAL", tenant: str = "default",
                 ttl_seconds: float = 0.0,
                 recovered_at: str = "") -> JobRecord:
        """Open a record at delivery receipt (state RECEIVED).

        ``recovered_at`` is set only by startup reconciliation when it
        re-opens a boot placeholder: carried on the journal ``open``
        line so the placeholder-retirement clock (when its redelivery
        never arrives) survives any number of restarts instead of
        resetting with each boot's re-registration.
        """
        record = JobRecord(next(self._seq), job_id, file_id, priority,
                           recorder_events=self.recorder_events,
                           worker_id=self.worker_id,
                           tenant=tenant, ttl_seconds=ttl_seconds,
                           hop_ledger=self.hop_ledger)
        # a redelivery (park-then-nack leaves a FAILED terminal record
        # behind) inherits the job's cumulative fleet lease wait, so
        # fleet.max_wait bounds TOTAL parked time under a flapping
        # coordination store instead of resetting on every re-park.  A
        # DONE/CANCELLED prior is a genuine resubmission: fresh budget.
        prior = self.get(job_id)
        if prior is not None and prior.state in (FAILED, PARKED):
            record.fleet_waited_s = prior.fleet_waited_s
        self._active[record.uid] = record
        self._gauge(RECEIVED, +1)
        record.event("received", priority=priority)
        if self.journal is not None:
            fields = dict(fileId=file_id, priority=priority,
                          tenant=tenant, ttl=ttl_seconds)
            if recovered_at:
                fields["recoveredAt"] = recovered_at
            self.journal.append("open", job_id, **fields)
        return record

    def adopt_recovered(self, job_id: str, file_id: str,
                        priority: str = "NORMAL",
                        tenant: str = "default",
                        ttl_seconds: float = 0.0) -> Optional[JobRecord]:
        """Hand a crash-recovery placeholder to its arriving redelivery.

        A placeholder is a live PARKED record the startup reconciliation
        opened from the journal (``recovered`` flag set, reason
        ``recovered: ...``).  The redelivery re-enters the normal intake
        path with the SAME record — and crucially the same cancel token,
        so an operator cancel fired during the replay window settles the
        redelivery the moment it arrives.  Identity fields are refreshed
        from the delivery (the journal's copy may predate a producer-side
        change).  Returns None when no placeholder is waiting.
        """
        placeholder = None
        for record in self._active.values():
            if (record.job_id == job_id and record.recovered
                    and record.state == PARKED
                    and (record.reason or "").startswith("recovered")):
                placeholder = record
        if placeholder is None:
            return None
        placeholder.file_id = file_id
        placeholder.priority = priority
        placeholder.tenant = tenant
        placeholder.ttl_seconds = float(ttl_seconds or 0.0)
        placeholder.deadline_mono = (
            time.monotonic() + placeholder.ttl_seconds
            if placeholder.ttl_seconds > 0 else None
        )
        if self.journal is not None:
            # journal the refreshed identity too: a crash after adoption
            # must replay the delivery's fields, not the stale pre-crash
            # open line (an open on a live job keeps its poison counter)
            self.journal.append("open", job_id, fileId=file_id,
                                priority=priority, tenant=tenant,
                                ttl=ttl_seconds)
        self.transition(placeholder, RECEIVED,
                        reason="recovered: redelivery arrived")
        placeholder.event("redelivered_after_recovery")
        return placeholder

    def transition(self, record: JobRecord, state: str,
                   stage: Optional[str] = None,
                   reason: Optional[str] = None) -> JobRecord:
        """Move ``record`` to ``state``; illegal moves raise."""
        if state not in LEGAL_TRANSITIONS:
            raise IllegalTransition(f"unknown state {state!r}")
        if state not in LEGAL_TRANSITIONS[record.state]:
            raise IllegalTransition(
                f"job {record.job_id}: {record.state} -> {state} is not a "
                f"legal lifecycle transition"
            )
        now = time.monotonic()
        stage_closed = None
        # close the timing of the stage (or state) being left
        if record.state == RUNNING and record.stage:
            stage_closed = round(now - record._entered_mono, 6)
            record.stage_seconds[record.stage] = (
                record.stage_seconds.get(record.stage, 0.0)
                + (now - record._entered_mono)
            )
        if self.metrics is not None:
            self.metrics.job_state_transitions.labels(
                from_state=record.state, to_state=state
            ).inc()
        event_fields: Dict[str, Any] = {"from": record.state, "to": state}
        if stage_closed is not None:
            # the CLOSED stage rides its own key: on a RUNNING->RUNNING
            # stage hop, "stage" below names the stage being ENTERED, and
            # the closed stage's timing must not be attributed to it
            event_fields["stage_closed"] = record.stage
            event_fields["stage_s"] = stage_closed
        self._gauge(record.state, -1)
        self._gauge(state, +1)
        record.state = state
        if state == RUNNING:
            record.stage = stage
            event_fields["stage"] = stage
        # non-RUNNING states keep the last stage entered: a terminal
        # record should still say which stage the job died/cancelled in
        if reason is not None:
            record.reason = reason
            event_fields["reason"] = reason
        record.updated_at = _utcnow_iso()
        record._entered_mono = now
        record.event("state", **event_fields)
        if self.journal is not None:
            self.journal.append("state", record.job_id, state=state,
                                stage=record.stage, reason=reason)
        if state in TERMINAL_STATES:
            self._retire(record)
        return record

    def _retire(self, record: JobRecord) -> None:
        if record.hops is not None and record.hops:
            # the job's byte/time attribution, sealed into the timeline
            # at settle (one event) and into the fleet-wide
            # hop_seconds_per_gb/hop_bytes metrics — where this
            # gigabyte's wall time actually went, per hop
            record.event("hop_ledger", hops=record.hops.summary())
            if self.metrics is not None:
                record.hops.observe(self.metrics)
        if (record.state in (FAILED, DROPPED_POISON)
                and self.logger is not None):
            # terminal debug bundle: the timeline's tail + correlation
            # ids, in one log line — a dead job stays diagnosable after
            # the terminal ring evicts its record
            self.logger.warn(
                "job debug bundle", jobId=record.job_id, state=record.state,
                reason=record.reason, stage=record.stage,
                traceId=record.trace_id, spanId=record.span_id,
                bytes=dict(record.bytes),
                eventsDropped=record.recorder.dropped,
                events=record.recorder.tail(DEBUG_BUNDLE_EVENTS),
            )
        if record.recorder.dropped and self.metrics is not None:
            # growth-pressure signal: how much per-job timeline the
            # bounded event rings shed (counted once, at settle — the
            # recorder's own drop counter is per-job and dies with it)
            self.metrics.recorder_ring_evictions.inc(
                record.recorder.dropped)
        self._active.pop(record.uid, None)
        self._ring.append(record)
        while len(self._ring) > self.terminal_ring:
            evicted = self._ring.popleft()
            # the gauge counts records the registry still knows about
            self._gauge(evicted.state, -1)
        if self.journal is not None:
            # amortized growth bound: only ever checked when a job ends
            # (one stat), and the rewrite itself runs off-thread so a
            # loop-side settle never pays the replay + fsyncs
            self.journal.maybe_compact_async()

    # -- control --------------------------------------------------------
    def cancel(self, job_id: str, reason: str = "operator") -> List[JobRecord]:
        """Fire the cancel token of every live record for ``job_id``.

        Returns the records whose tokens fired (empty when the job is
        unknown or already terminal).  The *state* moves to CANCELLED
        only when the job actually settles — cancellation is
        cooperative, and the record must reflect reality.
        """
        fired = []
        for record in self._active.values():
            if record.job_id == job_id and record.cancel.cancel(reason):
                record.updated_at = _utcnow_iso()
                record.event("cancel_requested", reason=reason)
                fired.append(record)
        if fired and self.logger is not None:
            self.logger.info("job cancellation requested",
                             jobId=job_id, reason=reason)
        return fired

    # -- introspection --------------------------------------------------
    def get(self, job_id: str) -> Optional[JobRecord]:
        """Most recent record for ``job_id``: live first, then the ring."""
        latest = None
        for record in self._active.values():
            if record.job_id == job_id:
                latest = record
        if latest is not None:
            return latest
        for record in reversed(self._ring):
            if record.job_id == job_id:
                return record
        return None

    def jobs(self, state: Optional[str] = None) -> List[JobRecord]:
        """All known records, live before terminal, newest last."""
        out = list(self._active.values()) + list(self._ring)
        if state:
            out = [r for r in out if r.state == state]
        return out

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for record in self.jobs():
            out[record.state] = out.get(record.state, 0) + 1
        return out

    def queued_snapshot(self) -> "tuple[int, float]":
        """``(depth, oldest_age_seconds)`` over jobs accepted but not
        yet running (RECEIVED / PARKED / ADMITTED) — the autoscale
        signal pair: how much work is waiting and for how long.

        Jobs parked MID-RUN waiting out a peer worker's content lease
        (fleet/plane.py) are excluded: they are coalescing by design,
        not capacity starvation, and counting them would tell an
        autoscaler to add workers that could only join the same wait.
        """
        depth = 0
        oldest = 0.0
        now = time.monotonic()
        for record in self._queued_records():
            depth += 1
            oldest = max(oldest, now - record._created_mono)
        return depth, oldest

    def _queued_records(self):
        """Records accepted but not yet running — the ONE copy of the
        queued predicate both :meth:`queued_snapshot` and
        :meth:`tenant_queue_depths` apply (so the per-tenant gauges can
        never desynchronize from the queue_depth they break down)."""
        for record in self._active.values():
            if record.state not in (RECEIVED, PARKED, ADMITTED):
                continue
            if (record.state == PARKED and record.reason
                    and record.reason.startswith("fleet_lease_wait")):
                continue
            yield record

    def tenant_queue_depths(self) -> Dict[str, int]:
        """Queued-not-yet-running depth per tenant — the per-tenant
        breakdown of :meth:`queued_snapshot`'s depth (same predicate by
        construction), feeding the ``tenant_queue_depth`` gauges and
        ``GET /v1/tenants``."""
        out: Dict[str, int] = {}
        for record in self._queued_records():
            out[record.tenant] = out.get(record.tenant, 0) + 1
        return out
