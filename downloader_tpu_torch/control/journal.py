"""Crash-safe job journal: the durability layer under the registry.

``control/registry.py`` is the control plane's source of truth while the
process lives — and nothing more: a SIGKILL/OOM loses every job record,
retry/poison counter, and flight-recorder timeline, leaves orphan
workdirs on disk, and makes redeliveries start cold with no memory that
a prior attempt already failed twice.  The broker's redelivery (the
reference's whole crash story, PAPER.md §1) restores the *message*, not
the *history*.

This module closes that gap with an append-only JSONL journal under the
work dir (``journal.dir``, default ``<download_path>/.journal/``):

- the registry appends one line per lifecycle event (``open`` at
  receipt, ``state`` per transition) and the orchestrator appends the
  retry/poison counter moves (``retry`` / ``retry_clear``) and the
  delivery settle mode (``settle`` ack/nack — the bit that decides
  whether a terminal job's redelivery is still coming);
- appends are a buffered ``write()`` (microseconds — the bench guards
  ``journal_overhead_ms`` < 1 ms/job); durability comes from a
  **batched fsync** every ``journal.fsync_interval`` seconds off-loop,
  so a kill loses at most one interval of tail entries — bounded,
  documented, and safe: the broker redelivers the message regardless,
  the journal only makes the redelivery *warm*;
- :func:`replay` rebuilds the last-known state per job id, tolerating a
  torn final line (the crash can land mid-``write``);
- :meth:`JobJournal.compact` rewrites the file as one ``snapshot`` line
  plus nothing else — run at every boot after replay and whenever the
  file grows past ``journal.max_bytes``, so the journal is bounded by
  live-job count, not process age.

What replay yields (:class:`RecoveredJob`): enough to re-register the
job as a PARKED ``recovered: awaiting redelivery`` placeholder, restore
its retry schedule, and decide the workdir sweep — a job whose last
settle was ``nack`` (or that never settled) has a redelivery in flight
and keeps its resumable ``.partial``/piece state; an ``ack``-settled
terminal job is gone for good and its workdir is an orphan.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ..platform.config import cfg_get
from ..utils import utcnow_iso as _utcnow_iso

DEFAULT_FSYNC_INTERVAL = 0.05
DEFAULT_MAX_BYTES = 4 << 20
JOURNAL_DIRNAME = ".journal"
JOURNAL_FILENAME = "journal.jsonl"

# journal ops (the "op" key of each line)
OP_OPEN = "open"          # record registered at delivery receipt
OP_STATE = "state"        # lifecycle transition
OP_SETTLE = "settle"      # delivery settled (mode: ack | nack)
OP_RETRY = "retry"        # poison counter advanced (failures: n)
OP_RETRY_CLEAR = "retry_clear"
OP_SNAPSHOT = "snapshot"  # compaction: full live state in one line

_TERMINAL = frozenset({"DONE", "FAILED", "CANCELLED", "DROPPED_POISON",
                       "EXPIRED"})


@dataclass
class RecoveredJob:
    """One job's last-known state, rebuilt from the journal at boot."""

    job_id: str
    file_id: str = ""
    priority: str = "NORMAL"
    tenant: str = "default"
    ttl_seconds: float = 0.0
    state: str = "RECEIVED"
    stage: Optional[str] = None
    reason: Optional[str] = None
    failures: int = 0
    settle: Optional[str] = None  # last settle mode: "ack" | "nack"
    updated_at: str = ""
    # when this job FIRST became an unadopted boot placeholder; "" for a
    # job with real delivery activity.  Survives re-registration across
    # boots (the placeholder's open line carries it forward) and clears
    # on any non-PARKED transition (adoption, running), so
    # "now - recovered_at" measures how long the broker has owed a
    # redelivery that never came — the placeholder-retirement clock
    recovered_at: str = ""

    @property
    def terminal(self) -> bool:
        return self.state in _TERMINAL

    @property
    def redelivery_expected(self) -> bool:
        """True when the broker still owes this job a delivery: the job
        never settled (crash mid-run — the unacked delivery requeues) or
        its last settle was a nack (redelivery explicitly requested)."""
        return self.settle != "ack"

    def to_snapshot(self) -> dict:
        return {
            "id": self.job_id, "fileId": self.file_id,
            "priority": self.priority, "tenant": self.tenant,
            "ttl": self.ttl_seconds, "state": self.state,
            "stage": self.stage, "reason": self.reason,
            "failures": self.failures, "settle": self.settle,
            "at": self.updated_at, "recoveredAt": self.recovered_at,
        }

    @classmethod
    def from_snapshot(cls, raw: dict) -> "RecoveredJob":
        return cls(
            job_id=str(raw.get("id", "")),
            file_id=str(raw.get("fileId", "")),
            priority=str(raw.get("priority", "NORMAL")),
            tenant=str(raw.get("tenant", "default")),
            ttl_seconds=float(raw.get("ttl", 0.0) or 0.0),
            state=str(raw.get("state", "RECEIVED")),
            stage=raw.get("stage"),
            reason=raw.get("reason"),
            failures=int(raw.get("failures", 0) or 0),
            settle=raw.get("settle"),
            updated_at=str(raw.get("at", "")),
            recovered_at=str(raw.get("recoveredAt", "") or ""),
        )


@dataclass
class RecoveredState:
    """Everything :func:`replay` learned from the journal."""

    jobs: Dict[str, RecoveredJob] = field(default_factory=dict)
    torn_lines: int = 0
    entries: int = 0

    def live(self) -> Dict[str, RecoveredJob]:
        """Jobs whose redelivery is still coming: the recovery set."""
        return {job_id: job for job_id, job in self.jobs.items()
                if job.redelivery_expected}


def _apply_line(jobs: Dict[str, RecoveredJob], entry: dict) -> None:
    op = entry.get("op")
    if op == OP_SNAPSHOT:
        jobs.clear()
        for raw in entry.get("jobs", []):
            job = RecoveredJob.from_snapshot(raw)
            if job.job_id:
                jobs[job.job_id] = job
        return
    job_id = entry.get("id")
    if not job_id:
        return
    if op == OP_OPEN:
        # a fresh delivery resets per-attempt state but NOT the poison
        # counter: the counter spans redeliveries by design
        prior = jobs.get(job_id)
        job = RecoveredJob(
            job_id=job_id,
            file_id=str(entry.get("fileId", "")),
            priority=str(entry.get("priority", "NORMAL")),
            tenant=str(entry.get("tenant", "default")),
            ttl_seconds=float(entry.get("ttl", 0.0) or 0.0),
            failures=prior.failures if prior is not None else 0,
            updated_at=str(entry.get("t", "")),
            recovered_at=str(entry.get("recoveredAt", "") or ""),
        )
        jobs[job_id] = job
        return
    job = jobs.get(job_id)
    if job is None:
        # state for a job whose open predates the last compaction window
        # (shouldn't happen — compaction snapshots live jobs — but a
        # half-written history must degrade, not crash the boot)
        job = jobs[job_id] = RecoveredJob(job_id=job_id)
    if op == OP_STATE:
        job.state = str(entry.get("state", job.state))
        job.stage = entry.get("stage", job.stage)
        job.reason = entry.get("reason")
        job.updated_at = str(entry.get("t", job.updated_at))
        if job.state != "PARKED":
            # real progress (adoption, running, settling): the job is no
            # longer an unadopted placeholder — restart the retirement
            # clock from whatever happens next
            job.recovered_at = ""
    elif op == OP_SETTLE:
        job.settle = entry.get("mode")
    elif op == OP_RETRY:
        job.failures = int(entry.get("failures", job.failures + 1))
    elif op == OP_RETRY_CLEAR:
        job.failures = 0


def replay(path: str, limit_bytes: Optional[int] = None) -> RecoveredState:
    """Rebuild per-job state from a journal file (missing file = empty).

    A torn final line — the crash landed mid-``write`` — is counted and
    skipped, never fatal: everything before it already replayed.

    ``limit_bytes`` replays only the first N bytes — the compaction's
    snapshot basis: a compaction racing live appends must snapshot
    exactly the prefix it captured, and nothing that landed after (the
    post-``base`` tail is preserved verbatim instead; replaying those
    lines here too would apply them twice).  ``base`` is always
    line-aligned: appends are whole ``write()`` lines and the offset is
    captured under the append lock after a flush.
    """
    state = RecoveredState()
    try:
        fh = open(path, "rb")
    except FileNotFoundError:
        return state
    consumed = 0
    with fh:
        for raw in fh:
            consumed += len(raw)
            if limit_bytes is not None and consumed > limit_bytes:
                break
            raw = raw.strip()
            if not raw:
                continue
            try:
                entry = json.loads(raw)
            except ValueError:
                state.torn_lines += 1
                continue
            if not isinstance(entry, dict):
                state.torn_lines += 1
                continue
            state.entries += 1
            _apply_line(state.jobs, entry)
    return state


class JobJournal:
    """Append-only journal with batched fsync.

    ``append`` is called from the event loop (registry transitions are
    loop-side) and must stay microseconds: it writes one JSON line to
    the buffered file handle and arms the flush timer.  The actual
    ``flush + fsync`` runs on a daemon thread at most once per
    ``fsync_interval``, so per-job durability cost amortizes across
    every job that settled in the window.  ``close`` flushes
    synchronously — a clean shutdown loses nothing.
    """

    def __init__(self, path: str, *, fsync_interval: float = DEFAULT_FSYNC_INTERVAL,
                 max_bytes: int = DEFAULT_MAX_BYTES, logger=None):
        self.path = path
        self.fsync_interval = max(float(fsync_interval), 0.0)
        self.max_bytes = max(int(max_bytes), 1 << 16)
        self.logger = logger
        self.appended = 0
        # snapshot-rewrites performed over this handle's lifetime (the
        # compaction-thrash regression guard reads it)
        self.compactions = 0
        self._lock = threading.Lock()
        self._flusher: Optional[threading.Timer] = None
        self._compacting = False
        # raised past ``max_bytes`` when a compaction could NOT shrink
        # the file under the bound (the live set alone exceeds it):
        # without this floor every terminal settle would re-trigger a
        # full replay+rewrite that cannot help — O(jobs x file) disk
        # churn at exactly the moment the worker is busiest.  Reset to 0
        # the next time a compaction lands under ``max_bytes``.
        self._compact_floor = 0
        self._closed = False
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._fh = open(path, "a", encoding="utf-8")
        # line census for the ``journal_lines`` growth gauge: counted
        # once at open (the file is compaction-bounded), then maintained
        # incrementally by append/compact
        self.lines = self._count_lines()

    def _count_lines(self) -> int:
        try:
            with open(self.path, "rb") as fh:
                return sum(chunk.count(b"\n")
                           for chunk in iter(lambda: fh.read(1 << 16), b""))
        except OSError:
            return 0

    @classmethod
    def from_config(cls, config, download_root: str,
                    logger=None) -> "Optional[JobJournal]":
        """``journal.enabled`` (default True) under
        ``journal.dir`` (default ``<download_root>/.journal``)."""
        if not cfg_get(config, "journal.enabled", True):
            return None
        configured = cfg_get(config, "journal.dir", None)
        directory = configured or os.path.join(download_root, JOURNAL_DIRNAME)
        return cls(
            os.path.join(directory, JOURNAL_FILENAME),
            fsync_interval=float(cfg_get(
                config, "journal.fsync_interval", DEFAULT_FSYNC_INTERVAL
            )),
            max_bytes=int(cfg_get(
                config, "journal.max_bytes", DEFAULT_MAX_BYTES
            )),
            logger=logger,
        )

    # -- appending ------------------------------------------------------
    def append(self, op: str, job_id: str, **fields: Any) -> None:
        """Write one journal line (buffered; fsync is batched)."""
        if self._closed:
            return
        entry = {"op": op, "id": job_id, "t": _utcnow_iso(), **fields}
        line = json.dumps(entry, separators=(",", ":")) + "\n"
        with self._lock:
            if self._closed:
                return
            self._fh.write(line)
            self.appended += 1
            self.lines += 1
            self._arm_flusher()

    def _arm_flusher(self) -> None:
        # under self._lock.  interval 0 = flush inline (tests/benches
        # that want strict durability per append)
        if self.fsync_interval <= 0:
            self._flush_locked()
            return
        if self._flusher is None:
            timer = threading.Timer(self.fsync_interval, self._flush_timer)
            timer.daemon = True
            self._flusher = timer
            timer.start()

    def _flush_timer(self) -> None:
        with self._lock:
            self._flusher = None
            if not self._closed:
                self._flush_locked()

    def _flush_locked(self) -> None:
        try:
            self._fh.flush()
            os.fsync(self._fh.fileno())
        except (OSError, ValueError) as err:
            # journal durability is best-effort by contract (the broker
            # redelivers regardless); a full/yanked volume must not take
            # the pipeline down with it
            if self.logger is not None:
                self.logger.warn("journal flush failed", error=str(err))

    def flush(self) -> None:
        """Synchronous flush + fsync (shutdown, tests)."""
        with self._lock:
            self._flush_locked()

    @property
    def size_bytes(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    # -- replay + compaction -------------------------------------------
    def replay(self) -> RecoveredState:
        """Replay the on-disk history (flushing our own tail first, so a
        same-process replay — tests, the restart bench — sees every
        append)."""
        self.flush()
        return replay(self.path)

    def compact(self, state: Optional[RecoveredState] = None) -> None:
        """Rewrite the journal as one snapshot line of still-live jobs.

        Ack-settled terminal jobs are dropped — their story is over and
        their workdirs are swept by reconciliation; everything else
        (live, or terminal-but-nacked = redelivery coming) survives with
        its retry counter.  Write-temp + rename keeps a crash mid-compact
        from losing the old file.

        Safe to run off-loop while appends continue: the snapshot basis
        is exactly the first ``base`` bytes captured under the lock, and
        lines written after that offset are preserved VERBATIM after the
        snapshot line (replay applies the snapshot first, then the tail
        ops — the same last-write-wins order they had).  A concurrent
        append is therefore never dropped AND never applied twice: the
        prefix lands only in the snapshot, the tail only after it (the
        soak flushed out the old behavior, which replayed the whole file
        for the snapshot and so duplicated any line that landed between
        the offset capture and the replay).  ``state`` is an optional
        pre-computed replay (tests); None replays the captured prefix.
        """
        with self._lock:
            if self._closed:
                return
            self._fh.flush()
            try:
                base = os.path.getsize(self.path)
            except OSError:
                base = 0
        if state is None:
            state = replay(self.path, limit_bytes=base)
        live = state.live()
        snapshot = {
            "op": OP_SNAPSHOT, "id": "", "t": _utcnow_iso(),
            "jobs": [job.to_snapshot() for job in live.values()],
        }
        line = json.dumps(snapshot, separators=(",", ":")) + "\n"
        tmp = self.path + ".compact"
        with self._lock:
            if self._closed:
                return
            self._fh.flush()
            try:
                with open(self.path, "rb") as src:
                    src.seek(base)
                    tail = src.read()
            except OSError:
                tail = b""
            with open(tmp, "wb") as out:
                out.write(line.encode("utf-8") + tail)
                out.flush()
                os.fsync(out.fileno())
            self._fh.close()
            os.replace(tmp, self.path)
            self._fh = open(self.path, "a", encoding="utf-8")
            self.lines = 1 + tail.count(b"\n")
            self.compactions += 1
            try:
                post = os.path.getsize(self.path)
            except OSError:
                post = 0
            # a compaction that could not get under max_bytes (live-set
            # dominated) must not be re-triggered by the very next
            # settle: require real growth past the post-compact size
            # before trying again
            self._compact_floor = post * 2 if post > self.max_bytes else 0

    @property
    def _compact_threshold(self) -> int:
        return max(self.max_bytes, self._compact_floor)

    def maybe_compact(self) -> bool:
        """Compact when the file outgrew ``max_bytes`` (synchronous —
        boot/tests; the registry's settle path uses the async variant)."""
        if self.size_bytes <= self._compact_threshold:
            return False
        self.compact()
        return True

    def maybe_compact_async(self) -> bool:
        """Size check inline (one stat), rewrite on a daemon thread.

        The loop-side terminal settle that trips the size bound must not
        pay the replay + double-fsync itself — on a contended disk that
        is tens of ms of event-loop stall, the exact lag the overload
        controller is armed on.  Single-flight: a compaction already
        running absorbs the growth that triggered this call.
        """
        if self.size_bytes <= self._compact_threshold:
            return False
        with self._lock:
            if self._closed or self._compacting:
                return False
            self._compacting = True
        thread = threading.Thread(target=self._compact_bg, daemon=True,
                                  name="journal-compact")
        thread.start()
        return True

    def _compact_bg(self) -> None:
        try:
            self.compact()
        except Exception as err:
            # same contract as flush trouble: the journal is best-effort,
            # a failed compaction must never take the pipeline down
            if self.logger is not None:
                self.logger.warn("journal compaction failed",
                                 error=str(err))
        finally:
            self._compacting = False

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            if self._flusher is not None:
                self._flusher.cancel()
                self._flusher = None
            self._flush_locked()
            self._closed = True
            self._fh.close()


def recovery_counters(state: RecoveredState) -> Dict[str, int]:
    """``{job_id: failures}`` for the jobs whose retry schedule must
    survive the restart (failures > 0 and a redelivery still coming)."""
    return {job_id: job.failures
            for job_id, job in state.live().items() if job.failures > 0}
