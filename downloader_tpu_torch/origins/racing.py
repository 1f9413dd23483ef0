"""Racing fetch: work-stealing byte ranges across redundant origins.

:class:`RangeScheduler` owns the *policy* of a multi-origin download —
which origin fetches which byte range next — while the byte-moving
*mechanism* (ranged requests, If-Range validation, splice/stream landing
into the shared ``.partial-seg`` file, checkpointing) stays with the
caller (``stages/download.py``), passed in as a ``fetch`` callback.
That split keeps resume, hashing, and the streaming upload overlap
byte-identical with the single-origin path: racing only changes who
serves each range.

Scheduling model:

- one worker per origin; workers *pull* the next pending range
  (work-stealing), so a fast origin naturally serves more bytes —
  no static partitioning to mis-size
- per-origin throughput EWMA (:class:`~.plan.OriginHealth`, fed from
  the same per-chunk progress hook that bills the hop ledger) drives
  the straggler decision: once no pending ranges remain, an idle origin
  whose EWMA beats the owner's by ``origins.dup_factor`` duplicates the
  straggler's remaining tail — first landed byte wins, the loser is
  cancelled (politely at its next chunk; a black-holed loser is task-
  cancelled when the scheduler finishes), and both writers produce
  identical bytes (every request carries the same strong validator), so
  the brief overlap window is harmless
- every range attempt runs under the origin's own Retrier policy and
  CircuitBreaker (dependency ``origin:<label>``, family-config
  ``retry.origin`` / ``breakers.origin``): an exhausted origin is
  marked dead *for this job* and its in-flight range returns to the
  pending pool at its landed position — failover re-fetches zero
  already-landed bytes and the job fails only when every origin died

:class:`SegmentFetcher` is the per-segment variant the manifest ingest
(:mod:`.manifest`) drives: whole small objects instead of ranges, with
EWMA-ordered origin selection, a first-byte hedge timeout, and the same
per-origin breaker/retry seams.
"""

from __future__ import annotations

import asyncio
import time
from typing import Callable, List, Optional

from ..control.cancel import JobCancelled
from ..platform.config import cfg_get
from ..platform.errors import BreakerOpen
from .plan import Origin, OriginHealth

DEFAULT_DUP_FACTOR = 1.25
# a straggler tail smaller than this is cheaper to wait out than to
# duplicate (connection setup would cost more than the overlap saves)
DEFAULT_MIN_DUP_BYTES = 1 << 20
# a range whose writers have landed nothing for this long is STALLED:
# idle origins may then take it over / duplicate it regardless of the
# EWMA and min-tail gates — those gates assume "slow", not "black-
# holed", and only the 240 s job watchdog would otherwise resolve a
# hang (by failing a job a healthy origin could have finished)
DEFAULT_STALL_TAKEOVER = 10.0
# idle-worker re-evaluation cadence while waiting for a dup opportunity
# (also the run() completion-poll cadence: a hung loser must not block
# the finished download)
_WAKE_POLL = 0.05

ASSIGN = "assign"
FAILOVER = "failover"
STRAGGLER_DUP = "straggler_dup"
FASTEST = "fastest"


class _Range:
    """Scheduler-side state for one canonical ``[start, pos, end]``
    triple (the SAME list object the caller's checkpoint snapshots)."""

    __slots__ = ("seg", "index", "owner", "dup", "winner",
                 "failed_over", "done", "last_progress")

    def __init__(self, seg: list, index: int):
        self.seg = seg
        self.index = index
        self.owner: Optional[Origin] = None
        self.dup: Optional[Origin] = None
        # which role's bytes decided the range: None until a duplicate
        # lands its first byte, then "dup"
        self.winner: Optional[str] = None
        self.failed_over = False
        # win-credit latch (metrics fire once per range); COMPLETION is
        # always judged on bytes (``complete``), never on this flag — a
        # range whose final bytes landed is finished no matter which
        # writer's credit bookkeeping got there first
        self.done = False
        self.last_progress = time.monotonic()

    @property
    def complete(self) -> bool:
        return self.seg[1] >= self.seg[2]

    @property
    def remaining(self) -> int:
        return max(self.seg[2] - self.seg[1], 0)

    def stalled(self, now: float, after: float) -> bool:
        """True when this in-flight range has landed nothing for
        ``after`` seconds — its writer(s) are black-holed, not slow."""
        return (not self.complete
                and (self.owner is not None or self.dup is not None)
                and now - self.last_progress > after)


class RangeScheduler:
    """Drive one entity's ranges across an origin set (see module doc).

    ``fetch(origin, triple, guard)`` is the mechanism callback: fetch
    ``[triple[1], triple[2])`` from ``origin.url``, landing bytes at
    their absolute offsets, advancing ``triple[1]`` per chunk, and
    calling ``guard(delta_bytes)`` (sync) after each landed chunk —
    ``False`` means stop fetching now (range finished elsewhere / this
    writer lost the duplicate race).  The triple handed to ``fetch`` is
    PRIVATE to that attempt; the scheduler merges progress into the
    canonical checkpointed triple inside the guard, so concurrent
    owner/duplicate writers never share a cursor — and since both
    streams carry the same strong validator, every byte below the
    merged maximum is on disk no matter which writer put it there.
    """

    def __init__(self, origins: List[Origin], segments: List[list],
                 fetch: Callable, *, retrier, health: OriginHealth,
                 cancel=None, record=None, metrics=None, logger=None,
                 config=None):
        self.origins = origins
        self.ranges = [_Range(seg, i) for i, seg in enumerate(segments)]
        self.fetch = fetch
        self.retrier = retrier
        self.health = health
        self.cancel = cancel
        self.record = record
        self.metrics = metrics
        self.logger = logger
        self.dup_factor = float(cfg_get(
            config, "origins.dup_factor", DEFAULT_DUP_FACTOR
        ))
        self.min_dup_bytes = int(cfg_get(
            config, "origins.min_dup_bytes", DEFAULT_MIN_DUP_BYTES
        ))
        self.stall_takeover = float(cfg_get(
            config, "origins.stall_takeover", DEFAULT_STALL_TAKEOVER
        ))
        self._wake = asyncio.Event()

    # -- observability ---------------------------------------------------
    def _event(self, kind: str, **fields) -> None:
        if self.record is not None:
            self.record.event(kind, **fields)

    def _note_win(self, origin: Origin, reason: str) -> None:
        if self.metrics is not None:
            self.metrics.origin_race_wins.labels(
                origin=origin.label, reason=reason
            ).inc()

    def _active_ranges(self, origin: Origin, delta: int) -> None:
        if self.metrics is not None:
            self.metrics.origin_active_ranges.labels(
                origin=origin.label
            ).inc(delta)

    # -- scheduling ------------------------------------------------------
    def _live(self, exclude: Optional[Origin] = None) -> List[Origin]:
        return [o for o in self.origins
                if not o.dead and o is not exclude]

    def _breaker(self, origin: Origin):
        breakers = getattr(self.retrier, "breakers", None)
        if breakers is None or not breakers.enabled:
            return None
        return breakers.get(f"origin:{origin.label}")

    def _blocked(self, origin: Origin) -> bool:
        """True while the origin's breaker would reject a call — the
        worker idles instead of burning attempts into an open breaker
        (half-open is NOT blocked: the probe may revive it)."""
        breaker = self._breaker(origin)
        return breaker is not None and breaker.blocking

    def _all_done(self) -> bool:
        # byte-completeness, never the credit latch: the final bytes may
        # land through a writer whose credit bookkeeping lost the race
        return all(rng.complete for rng in self.ranges)

    def _pick(self, origin: Origin):
        """Next work item for ``origin``: ``(range, role)`` or None."""
        now = time.monotonic()
        # pending ranges first (work-stealing pull).  A range with live
        # writers is normally NOT pending (a fresh owner would just
        # duplicate their work) — unless the range is STALLED: a
        # black-holed writer cannot be failed over until its own
        # request errors, so a fresh owner takes (or, with BOTH slots
        # held by stalled writers, EVICTS) the owner slot and
        # first-byte-wins re-arbitrates.  Eviction is safe: slot
        # releases are identity-guarded, so the replaced writer becomes
        # a harmless zombie — it writes the same validated bytes if it
        # ever wakes, and the scheduler cancels it at run() end.
        for rng in self.ranges:
            if rng.complete or rng.done:
                continue
            stalled = rng.stalled(now, self.stall_takeover)
            if rng.owner is not None:
                if not (stalled and rng.dup is not None):
                    continue  # a live owner keeps its slot
            elif rng.dup is not None and not stalled:
                continue  # a live dup is already serving it
            rng.owner = origin
            rng.winner = None  # all writers re-race from here
            rng.last_progress = now
            reason = FAILOVER if rng.failed_over else ASSIGN
            self._event("range_assign", origin=origin.label,
                        range=[rng.seg[0], rng.seg[2]],
                        pos=rng.seg[1], reason=reason)
            return rng, "owner"
        # straggler duplication: no pending work left — shadow the
        # biggest in-flight tail whose owner this origin clearly beats,
        # or ANY stalled tail (the EWMA/min-tail gates assume a slow
        # owner; a hung one must not park the job until the watchdog)
        my_bps = self.health.bps(origin.label)
        best = None
        for rng in self.ranges:
            if (rng.complete or rng.done or rng.owner is None
                    or rng.dup is not None or rng.owner is origin):
                continue
            if not rng.stalled(now, self.stall_takeover):
                if rng.remaining < self.min_dup_bytes:
                    continue
                owner_bps = self.health.bps(rng.owner.label)
                if my_bps <= owner_bps * self.dup_factor:
                    continue
            if best is None or rng.remaining > best.remaining:
                best = rng
        if best is not None:
            best.dup = origin
            best.last_progress = now
            self._event("range_assign", origin=origin.label,
                        range=[best.seg[0], best.seg[2]],
                        pos=best.seg[1], reason=STRAGGLER_DUP,
                        owner=best.owner.label)
            return best, "dup"
        return None

    def _release_failed(self, origin: Origin, rng: _Range, role: str,
                        err: BaseException) -> None:
        """One origin's attempt on ``rng`` failed: put the work back.
        The canonical position keeps every landed byte, so the next
        owner resumes instead of re-fetching."""
        if role == "owner" and rng.owner is origin:
            rng.owner = None
            rng.failed_over = True
        if role == "dup" and rng.dup is origin:
            rng.dup = None
            if rng.winner == "dup":
                # the duplicate won the race and then died: whoever
                # picks the range up next is a fresh owner
                rng.winner = None
                rng.failed_over = True
        origin.failures += 1
        self._event("origin_failover", origin=origin.label,
                    range=[rng.seg[0], rng.seg[2]], pos=rng.seg[1],
                    error=str(err)[:160], type=type(err).__name__)
        if self.logger is not None:
            self.logger.warn("origin failed; range returns to pool",
                             origin=origin.label, pos=rng.seg[1],
                             range_end=rng.seg[2], error=str(err)[:200])

    def _release_lost(self, origin: Origin, rng: _Range,
                      role: str) -> None:
        """A writer stopped politely without completing the range (it
        lost the duplicate race): free its slot, no failover marks."""
        if role == "owner" and rng.owner is origin:
            rng.owner = None
        if role == "dup" and rng.dup is origin:
            rng.dup = None

    def _finish(self, origin: Origin, rng: _Range, role: str) -> None:
        if rng.done:
            return
        # the latch ALWAYS closes on completion (bytes are bytes); only
        # the metric credit is role-gated — an owner observing the range
        # complete after its duplicate won the first byte still finishes
        # the range, it just doesn't claim the win
        rng.done = True
        self._wake.set()
        if role == "owner" and rng.winner == "dup":
            return
        if role == "dup" and rng.winner != "dup":
            return
        if role == "dup":
            reason = STRAGGLER_DUP
        elif rng.failed_over:
            reason = FAILOVER
        else:
            reason = FASTEST
        self._note_win(origin, reason)

    async def _run_item(self, origin: Origin, rng: _Range,
                        role: str) -> None:
        seg = rng.seg
        # PRIVATE cursor (see class doc): starts at the canonical
        # position, advances with THIS writer's landed bytes only
        private = [seg[0], seg[1], seg[2]]
        last_mark = time.monotonic()

        def guard(delta: int) -> bool:
            nonlocal last_mark
            now = time.monotonic()
            if delta > 0:
                rng.last_progress = now
                self.health.feed(origin.label, delta, now - last_mark)
                if self.metrics is not None:
                    self.metrics.origin_bytes.labels(
                        origin=origin.label
                    ).inc(delta)
                if role == "dup" and rng.winner is None:
                    # first duplicated byte landed: the dup wins, the
                    # owner stops at its next chunk
                    rng.winner = "dup"
            last_mark = now
            if seg[1] < private[1]:
                seg[1] = private[1]
            self._wake.set()
            if seg[1] >= seg[2]:
                return False  # range complete (possibly via the peer)
            if role == "owner" and rng.winner == "dup":
                return False  # lost the duplicate race: stop politely
            return True

        self._active_ranges(origin, +1)
        try:
            await self.retrier.run(
                f"origin:{origin.label}.fetch",
                lambda: self.fetch(origin, private, guard),
                cancel=self.cancel, record=self.record,
                logger=self.logger,
            )
        except (asyncio.CancelledError, JobCancelled):
            raise
        except Exception as err:
            if getattr(err, "race_abort", False) and origin.primary:
                # the PRIMARY's entity changed mid-flight: the whole
                # attempt is stitched against a dead validator — abort
                # and let the caller restart cleanly
                raise
            if getattr(type(err), "code", None) == "ERRDLSTALL":
                raise
            self._release_failed(origin, rng, role, err)
            origin.dead = True
            if not self._live():
                raise  # every origin is gone: the job's own failure
            return
        finally:
            self._active_ranges(origin, -1)
            self._wake.set()
        if seg[1] >= seg[2]:
            self._finish(origin, rng, role)
        else:
            self._release_lost(origin, rng, role)

    async def _drive(self, origin: Origin) -> None:
        while not self._all_done():
            if origin.dead:
                return
            if self._blocked(origin):
                others = [o for o in self._live(exclude=origin)
                          if not self._blocked(o)]
                if not others:
                    # no origin anywhere can take a call right now:
                    # surface BreakerOpen (parked + redelivered without
                    # a poison charge) instead of idling to the watchdog
                    breaker = self._breaker(origin)
                    raise BreakerOpen(f"origin:{origin.label}",
                                      breaker.retry_after())
                await self._sleep_for_work()
                continue
            item = self._pick(origin)
            if item is None:
                await self._sleep_for_work()
                continue
            await self._run_item(origin, item[0], item[1])

    async def _sleep_for_work(self) -> None:
        self._wake.clear()
        try:
            await asyncio.wait_for(self._wake.wait(), _WAKE_POLL)
        except asyncio.TimeoutError:
            pass

    async def run(self) -> None:
        """Fetch every range; returns when all are complete.  Raises the
        failing origin's error only when NO origin remains alive (or on
        cancel/stall/primary-entity-change, which pass straight
        through).  Completion is polled independently of the workers: a
        duplicate-race loser hung inside a black-holed origin must not
        hold the finished download hostage — it is cancelled here."""
        workers = [
            asyncio.create_task(self._drive(origin),
                                name=f"race-{origin.label}")
            for origin in self.origins
        ]
        try:
            pending = set(workers)
            while pending and not self._all_done():
                done, pending = await asyncio.wait(
                    pending, timeout=_WAKE_POLL,
                    return_when=asyncio.FIRST_COMPLETED,
                )
                for task in done:
                    if task.cancelled():
                        raise asyncio.CancelledError()
                    if task.exception() is not None:
                        raise task.exception()
        finally:
            for task in workers:
                task.cancel()
            await asyncio.gather(*workers, return_exceptions=True)
        if not self._all_done():
            # defensive: every worker exited (all origins dead) without
            # an error reaching the poll loop — a silent partial file
            # must never look complete
            raise RuntimeError("racing fetch ended with pending ranges")


class SegmentFetcher:
    """Per-segment origin selection for the manifest ingest.

    Origins are tried in EWMA-throughput order (ties keep submitter
    order, so the primary leads until the mirrors prove faster); each
    attempt runs under the origin's own ``origin:<label>.segment``
    Retrier/breaker seam, with ``origins.hedge_delay`` bounding the
    wait for the response's FIRST byte — a black-holed origin costs a
    hedge window per attempt, not a watchdog timeout, before the next
    origin gets the segment.  ``fetch_one(origin, hedge_s)`` is the
    mechanism callback (the manifest ingest owns the HTTP + disk
    work); a raised error fails over, exhausting every origin fails
    the segment.
    """

    def __init__(self, origins: List[Origin], *, retrier,
                 health: OriginHealth, cancel=None, record=None,
                 metrics=None, logger=None, config=None):
        self.origins = origins
        self.retrier = retrier
        self.health = health
        self.cancel = cancel
        self.record = record
        self.metrics = metrics
        self.logger = logger
        self.hedge_delay = float(cfg_get(
            config, "origins.hedge_delay", 1.0
        ))

    def _ordered(self) -> List[Origin]:
        live = [o for o in self.origins if not o.dead]
        return sorted(live, key=lambda o: -self.health.bps(o.label))

    def _blocked(self, origin: Origin) -> bool:
        breakers = getattr(self.retrier, "breakers", None)
        if breakers is None or not breakers.enabled:
            return False
        breaker = breakers.get(f"origin:{origin.label}")
        return breaker is not None and breaker.blocking

    async def fetch(self, fetch_one: Callable, *, what: str = "") -> int:
        """Run ``fetch_one(origin, hedge_s)`` against the best origin,
        failing over in EWMA order; returns its result (bytes landed).
        ``hedge_s`` is 0 for the LAST candidate — with nobody left to
        hedge toward, the caller should wait the full stall budget."""
        last_err: Optional[BaseException] = None
        candidates = self._ordered()
        usable = [o for o in candidates if not self._blocked(o)]
        if candidates and not usable:
            # every origin's breaker is open: surface BreakerOpen (the
            # park-without-poison posture, same as the racing path) —
            # a bare error here would charge the poison budget for a
            # condition the breakers already promise will heal
            best = candidates[0]
            breaker = self.retrier.breakers.get(f"origin:{best.label}")
            raise BreakerOpen(f"origin:{best.label}",
                              breaker.retry_after())
        for index, origin in enumerate(usable):
            hedge = (self.hedge_delay
                     if index < len(usable) - 1 else 0.0)
            started = time.monotonic()
            try:
                moved = await self.retrier.run(
                    f"origin:{origin.label}.segment",
                    lambda: fetch_one(origin, hedge),
                    cancel=self.cancel, record=self.record,
                    logger=self.logger,
                )
            except (asyncio.CancelledError, JobCancelled):
                raise
            except Exception as err:
                if getattr(type(err), "code", None) == "ERRDLSTALL":
                    raise
                last_err = err
                if self.record is not None:
                    self.record.event("origin_failover",
                                      origin=origin.label, what=what,
                                      error=str(err)[:160],
                                      type=type(err).__name__)
                if self.logger is not None:
                    self.logger.warn("segment origin failed over",
                                     origin=origin.label, what=what,
                                     error=str(err)[:200])
                continue
            self.health.feed(origin.label, moved,
                             time.monotonic() - started)
            if self.metrics is not None and moved:
                self.metrics.origin_bytes.labels(
                    origin=origin.label
                ).inc(moved)
            return moved
        if last_err is not None:
            raise last_err
        raise RuntimeError(
            f"no usable origin for {what or 'segment'}: "
            "every origin dead or breaker-open"
        )
