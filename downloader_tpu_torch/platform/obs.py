"""Runtime observability: per-job flight recorder + event-loop introspection.

The reference plumbed a Jaeger tracer and never opened a span
(upstream index.js:15; SURVEY.md §5 "plumbed-but-unused").  Our
rebuild fixed that at span/metric/log grain, but the four signals were
silos: a failing job's spans, log lines, Prometheus counters, and its
``GET /v1/jobs/{id}`` record could not be joined, and the asyncio
runtime itself (loop lag, stalled transfers, stuck tasks) was a black
box.  This module is the glue:

- :class:`FlightRecorder` — a bounded ring of structured events carried
  by every :class:`~..control.registry.JobRecord`: state transitions,
  queue/scheduler waits, throughput samples, cache decisions, retries,
  cancellation, settlement, and span references.  Retrievable live via
  ``GET /v1/jobs/{id}/events`` and dumped as a debug bundle when a job
  dies (FAILED / DROPPED_POISON).
- :class:`LoopLagMonitor` — samples event-loop scheduling lag into a
  gauge + histogram on ``/metrics`` (a blocked loop is the one failure
  every async service shares and none surface).
- :class:`TransferProfiler` — periodically samples each RUNNING job's
  live transfer counters into ``throughput`` flight-recorder events and
  flags flat-lined transfers (``stall_suspect``) long before the 240 s
  stall watchdog fires.
- :func:`dump_tasks` / :func:`dump_stacks` — live asyncio-task and
  thread-stack snapshots behind ``GET /debug/tasks`` / ``/debug/stacks``
  and the SIGUSR1 dump (app.py), so "what is the worker doing right
  now" never requires attaching a debugger.

Event schema: each event is one flat JSON object
``{"t": <epoch seconds>, "kind": <str>, ...fields}``.  ``t`` is
wall-clock so operators can join events against log timestamps; the
job's ``trace_id``/``span_id`` (also bound into its child logger and
its OTLP span) make the log/span/timeline join exact.
"""

from __future__ import annotations

import asyncio
import collections
import sys
import time
import traceback
from typing import Any, Dict, List, Optional

# default per-job event ring (``obs.recorder_events``): deep enough for a
# full lifecycle plus minutes of throughput samples, bounded so a
# retry-looping or hours-long job can never grow memory
DEFAULT_EVENT_LIMIT = 256

# default sampling cadences (``obs.loop_lag_interval`` /
# ``obs.profile_interval``)
DEFAULT_LAG_INTERVAL = 0.25
DEFAULT_PROFILE_INTERVAL = 5.0
# consecutive flat profiler samples before a RUNNING transfer is flagged
DEFAULT_STALL_SAMPLES = 3

# the streaming dispatch's combined RUNNING-stage attribution
# (stages/streaming.py runs download ∥ process ∥ upload as one stage).
# A string literal here, not an import — this module must not import the
# stages package (stages -> control -> this module would cycle).
PIPELINE_STAGE = "pipeline"


# The hops that are byte-COPY work on the staging path — each staged
# gigabyte pays each of these at most once, so their summed seconds
# over the widest single hop's bytes is the job's staging copy cost
# (``cpu_s_per_gb``), the number the zero-copy ratchet drives down.
# Excluded on purpose: wait hops (``origin_wait`` — stalled, not
# copying) and accelerator hops (``h2d``/``compute``/``d2h`` scale with
# pixels, not staged bytes).
COPY_HOPS = frozenset({
    "socket_read", "splice", "disk_write", "hash", "filter",
    "upload", "bucket_fetch", "shared_fetch", "cache",
})


class HopLedger:
    """Monotonic per-hop byte + time attribution for one job's transfer
    path (socket/splice read, disk write, hashing, filter, upload).

    Each ``note`` is two dict lookups and two adds — cheap enough for
    per-chunk calls on the hot transfer loops (the ``hop_ledger_overhead_ms``
    bench guard keeps it under 1 ms/job).  The summary is read once per
    job: the ``hopLedger`` block on ``GET /v1/jobs/{id}``, a
    ``hop_ledger`` flight-recorder event at settle, and the
    ``hop_seconds_per_gb{hop}`` observations — the attribution data
    ROADMAP item 3's zero-copy work ratchets against.
    """

    __slots__ = ("_hops",)

    # per-GB observations below this weight are noise (a 4 KiB marker
    # write "per GB" says nothing about the copy floor)
    MIN_OBSERVE_BYTES = 1 << 20

    def __init__(self) -> None:
        # hop -> [bytes, seconds], both monotonically accumulated
        self._hops: Dict[str, list] = {}

    def note(self, hop: str, nbytes: int, seconds: float) -> None:
        entry = self._hops.get(hop)
        if entry is None:
            self._hops[hop] = [int(nbytes), float(seconds)]
        else:
            entry[0] += int(nbytes)
            entry[1] += seconds

    def __bool__(self) -> bool:
        return bool(self._hops)

    def iter_hops(self):
        """``(hop, bytes, seconds)`` triples — the public read the SLO
        tracker's hop accumulation rides (the internal ``[bytes,
        seconds]`` list layout is not a contract; named away from the
        mapping protocol's ``items`` because these are triples, not
        key/value pairs)."""
        for hop, (nbytes, seconds) in self._hops.items():
            yield hop, nbytes, seconds

    def total_seconds(self) -> float:
        return sum(entry[1] for entry in self._hops.values())

    def summary(self) -> Dict[str, dict]:
        """``hop -> {bytes, seconds, secondsPerGb}`` (secondsPerGb only
        for hops that moved enough bytes to make the rate meaningful)."""
        out: Dict[str, dict] = {}
        for hop, (nbytes, seconds) in sorted(self._hops.items()):
            entry = {"bytes": nbytes, "seconds": round(seconds, 6)}
            if nbytes >= self.MIN_OBSERVE_BYTES:
                entry["secondsPerGb"] = round(seconds / (nbytes / 1e9), 3)
            out[hop] = entry
        return out

    def copy_seconds_per_gb(self) -> "tuple[float, str] | tuple[None, None]":
        """``(seconds_per_gb, top_hop)`` across the staging COPY_HOPS,
        or ``(None, None)`` when too few bytes moved to mean anything.

        Denominator: the WIDEST copy hop's bytes — the staged payload
        crosses each hop once, so the widest hop is the payload size;
        summing bytes across hops would count the same gigabyte at
        every hop it crossed.  ``top_hop`` is the per-rate worst
        offender among hops past the observation floor.
        """
        seconds = 0.0
        weight = 0
        top_hop, top_rate = None, -1.0
        for hop, (nbytes, secs) in self._hops.items():
            if hop not in COPY_HOPS:
                continue
            seconds += secs
            weight = max(weight, nbytes)
            if nbytes >= self.MIN_OBSERVE_BYTES:
                rate = secs / (nbytes / 1e9)
                if rate > top_rate:
                    top_hop, top_rate = hop, rate
        if weight < self.MIN_OBSERVE_BYTES:
            return None, None
        return seconds / (weight / 1e9), top_hop

    def observe(self, metrics) -> None:
        """Feed the job's totals into the fleet-wide hop metrics."""
        for hop, (nbytes, seconds) in self._hops.items():
            if nbytes:
                metrics.hop_bytes.labels(hop=hop).inc(nbytes)
            if seconds:
                metrics.hop_seconds.labels(hop=hop).inc(seconds)
            if nbytes >= self.MIN_OBSERVE_BYTES:
                metrics.hop_seconds_per_gb.labels(hop=hop).observe(
                    seconds / (nbytes / 1e9)
                )
            # per-hop copy-rate gauge (zero-copy ratchet): last settled
            # job's s/GB per copy hop — max() over the ``hop`` label is
            # the fleet's current top offender.  getattr-guarded so a
            # caller wiring a pre-ratchet metrics object keeps working.
            if (hop in COPY_HOPS and nbytes >= self.MIN_OBSERVE_BYTES
                    and getattr(metrics, "staging_hop_s_per_gb", None)
                    is not None):
                metrics.staging_hop_s_per_gb.labels(hop=hop).set(
                    seconds / (nbytes / 1e9)
                )
        per_gb, _top = self.copy_seconds_per_gb()
        if (per_gb is not None
                and getattr(metrics, "staging_cpu_s_per_gb", None)
                is not None):
            metrics.staging_cpu_s_per_gb.set(per_gb)


class FlightRecorder:
    """Bounded ring of structured events for one job.

    Append is O(1) and allocation-light (one small dict per event) — the
    bench guard (``recorder_overhead_ms`` < 1 ms/job, bench.py v10)
    keeps it honest.  The ring drops the *oldest* events and counts the
    drops, so a long job's tail — where failures live — is always kept.
    """

    __slots__ = ("_events", "dropped", "context")

    def __init__(self, limit: int = DEFAULT_EVENT_LIMIT,
                 context: Optional[Dict[str, Any]] = None):
        self._events: "collections.deque[dict]" = collections.deque(
            maxlen=max(int(limit), 1)
        )
        self.dropped = 0
        # bindings stamped into EVERY event (e.g. the fleet worker id,
        # so cross-worker traces join on (trace_id, worker_id) without
        # each event site threading identity through)
        self.context: Dict[str, Any] = dict(context or {})

    def record(self, kind: str, **fields: Any) -> None:
        if len(self._events) == self._events.maxlen:
            self.dropped += 1
        event = {"t": round(time.time(), 3), "kind": kind}
        if self.context:
            event.update(self.context)
        event.update(fields)
        self._events.append(event)

    def events(self) -> List[dict]:
        """Snapshot, oldest first (each event copied: callers may serve
        it over HTTP while the job keeps appending)."""
        return [dict(event) for event in self._events]

    def tail(self, count: int) -> List[dict]:
        return self.events()[-max(int(count), 0):]

    def __len__(self) -> int:
        return len(self._events)


class LoopLagMonitor:
    """Event-loop scheduling-lag sampler.

    Sleeps ``interval`` and measures how much later than requested the
    loop woke it — the classic lag probe.  Feeds the
    ``event_loop_lag_seconds`` gauge (last sample) and the
    ``event_loop_lag`` histogram on ``/metrics``, warns past
    ``warn_threshold``, and keeps ``last_lag``/``max_lag`` for
    ``GET /debug/tasks``.
    """

    def __init__(self, metrics=None, interval: float = DEFAULT_LAG_INTERVAL,
                 logger=None, warn_threshold: float = 0.5):
        self.metrics = metrics
        self.interval = max(float(interval), 0.01)
        self.logger = logger
        self.warn_threshold = warn_threshold
        self.last_lag = 0.0
        self.max_lag = 0.0
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            started = loop.time()
            await asyncio.sleep(self.interval)
            lag = max(0.0, loop.time() - started - self.interval)
            self.last_lag = lag
            if lag > self.max_lag:
                self.max_lag = lag
            if self.metrics is not None:
                self.metrics.event_loop_lag.set(lag)
                self.metrics.event_loop_lag_hist.observe(lag)
            if lag >= self.warn_threshold and self.logger is not None:
                self.logger.warn("event loop lag", lag_s=round(lag, 3))


class TransferProfiler:
    """Samples per-stage transfer progress into each job's recorder.

    Every ``interval`` seconds, each RUNNING record's live counters
    (``JobRecord.transferred``, fed by the stages' chunk loops, plus the
    telemetry progress percent) are diffed against the previous sample:
    movement becomes a ``throughput`` event (stage, bytes, bytes/s);
    ``stall_samples`` consecutive flat samples become one
    ``stall_suspect`` event + a warn log — minutes before the 240 s
    watchdog would kill the transfer, and visible per job via
    ``GET /v1/jobs/{id}/events``.
    """

    def __init__(self, registry, interval: float = DEFAULT_PROFILE_INTERVAL,
                 stall_samples: int = DEFAULT_STALL_SAMPLES, logger=None):
        self.registry = registry
        self.interval = max(float(interval), 0.01)
        self.stall_samples = max(int(stall_samples), 1)
        self.logger = logger
        # uid -> [monotonic, total_bytes, percent, consecutive_flat]
        self._last: Dict[int, list] = {}
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval)
            self.sample()

    def sample(self) -> None:
        """One sampling pass (sync: also drivable from tests)."""
        now = time.monotonic()
        seen = set()
        for record in list(self.registry._active.values()):
            # string compare, not an import: control.registry imports
            # this module for FlightRecorder (cycle otherwise)
            if record.state != "RUNNING":
                continue
            seen.add(record.uid)
            total = sum(record.transferred.values())
            percent = record.percent
            prev = self._last.get(record.uid)
            if prev is None:
                self._last[record.uid] = [now, total, percent, 0]
                continue
            t_prev, b_prev, p_prev, flat = prev
            elapsed = max(now - t_prev, 1e-9)
            delta = total - b_prev
            if delta > 0 or percent != p_prev:
                record.event(
                    "throughput", stage=record.stage, bytes=delta,
                    bps=round(delta / elapsed, 1), total=total,
                    percent=percent,
                )
                flat = 0
            else:
                flat += 1
                # only flag stages whose live counter was actually
                # flowing (a "download"/"upload" key exists for THIS
                # stage): compute stages (upscale/process) feed no
                # counters and must never read as stalled transfers.
                # The streaming dispatch's combined "pipeline" stage is
                # flagged on any LIVE counter — the runner retires both
                # counters once ingress completes (moving uploads
                # reinstall theirs), so its CPU-only reconciliation
                # phases carry no counters and stay exempt, matching
                # the barrier stages' behavior.
                if (flat == self.stall_samples
                        and (record.stage in record.transferred
                             or (record.stage == PIPELINE_STAGE
                                 and record.transferred))):
                    record.event(
                        "stall_suspect", stage=record.stage, total=total,
                        flat_s=round(self.interval * flat, 2),
                    )
                    if self.logger is not None:
                        # traceId explicitly: this logger is the service
                        # root, not the job's child, and the stall line
                        # must join the job's trace like every other
                        self.logger.warn(
                            "transfer flat-lined", jobId=record.job_id,
                            traceId=record.trace_id,
                            stage=record.stage, total_bytes=total,
                            flat_s=round(self.interval * flat, 2),
                        )
            self._last[record.uid] = [now, total, percent, flat]
        for uid in [u for u in self._last if u not in seen]:
            del self._last[uid]


# ---------------------------------------------------------------------------
# Live task / stack introspection (GET /debug/tasks, /debug/stacks, SIGUSR1)
# ---------------------------------------------------------------------------

def _frame_lines(frames, limit: int = 12) -> List[str]:
    out = []
    for frame in frames[-limit:]:
        code = frame.f_code
        out.append(f"{code.co_filename}:{frame.f_lineno} in {code.co_name}")
    return out


def dump_tasks(limit: int = 512) -> List[dict]:
    """Snapshot of live asyncio tasks: name, coroutine, top stack frames.

    Answers "what is every task blocked on" without a debugger.  Must be
    called from the loop thread (the aiohttp handlers and the SIGUSR1
    handler both are).
    """
    try:
        tasks = asyncio.all_tasks()
    except RuntimeError:
        return []
    out = []
    for task in list(tasks)[: max(int(limit), 1)]:
        coro = task.get_coro()
        qualname = getattr(coro, "__qualname__", None) or repr(coro)[:160]
        out.append({
            "name": task.get_name(),
            "done": task.done(),
            "coro": qualname,
            "stack": _frame_lines(task.get_stack(limit=12)),
        })
    out.sort(key=lambda t: t["name"])
    return out


def dump_stacks() -> dict:
    """Every thread's (and task's) current stack, formatted.

    The SIGUSR1 / ``GET /debug/stacks`` payload: the moral equivalent of
    ``kill -QUIT`` on a JVM — one shot that shows where a wedged worker
    is stuck, including the splice/upload worker threads the event loop
    cannot see.
    """
    import threading

    names = {t.ident: t.name for t in threading.enumerate()}
    threads = []
    for thread_id, frame in sys._current_frames().items():
        threads.append({
            "threadId": thread_id,
            "name": names.get(thread_id, "?"),
            "stack": [
                line.rstrip()
                for line in traceback.format_stack(frame)[-16:]
            ],
        })
    return {"threads": threads, "tasks": dump_tasks()}
